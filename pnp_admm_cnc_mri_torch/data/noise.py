"""K-space noise: a copy of the JAX package's ``data/noise.py:29-37``."""

from __future__ import annotations

import numpy as np


def synth_noise(shape: tuple[int, int], std: float = 10.0, seed: int = 0) -> np.ndarray:
    """Circular complex Gaussian k-space noise."""
    rng = np.random.default_rng(seed)
    re = rng.normal(0.0, std, shape)
    im = rng.normal(0.0, std, shape)
    return re + 1j * im
