"""K-space sampling masks: the loaders of the reference's ``.mat`` masks and
numpy generators (DC at the corner, as the unshifted FFT expects). A copy of
the JAX package's ``data/masks.py``; scipy is imported lazily, for the
``.mat`` files only.

The reference ships three fixed 256x256 masks at ~30% sampling
(``CS_MRI/Q_Random30.mat``, ``Q_Radial30.mat``, ``Q_Cartesian30.mat``, key
``Q1``, loaded at reference ``【1】ADMM_L1.py:177-182``).
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from pnp_admm_cnc_mri_torch.data.noise import DEFAULT_DATA_DIR

MASK_FILES = {
    "Q_Random30": "Q_Random30.mat",
    "Q_Radial30": "Q_Radial30.mat",
    "Q_Cartesian30": "Q_Cartesian30.mat",
}


def load_mask(name: str, data_dir: str | None = None) -> np.ndarray:
    """Load one reference mask as float64 0/1 (reference ``【1】:180-182``)."""
    import scipy.io as sio

    if name not in MASK_FILES:
        raise ValueError(
            f"unknown mask {name!r}; available: {sorted(MASK_FILES)} "
            "(or generate one with masks.random_mask/cartesian_mask/radial_mask)"
        )
    data_dir = data_dir or DEFAULT_DATA_DIR
    mat = sio.loadmat(os.path.join(data_dir, MASK_FILES[name]))
    return mat["Q1"].astype(np.float64)


def load_all_masks(
    names: Sequence[str] = ("Q_Random30", "Q_Radial30", "Q_Cartesian30"),
    data_dir: str | None = None,
) -> Dict[str, np.ndarray]:
    return {n: load_mask(n, data_dir) for n in names}


def random_mask(
    shape: tuple[int, int], fraction: float = 0.3, seed: int = 0, center_frac: float = 0.02
) -> np.ndarray:
    """Uniform random point-sampling mask with a fully-sampled center block."""
    h, w = shape
    rng = np.random.default_rng(seed)
    mask = (rng.random(shape) < fraction).astype(np.float64)
    ch = max(1, int(h * center_frac))
    cw = max(1, int(w * center_frac))
    mask[:ch, :cw] = 1.0
    mask[:ch, w - cw :] = 1.0
    mask[h - ch :, :cw] = 1.0
    mask[h - ch :, w - cw :] = 1.0
    return mask


def cartesian_mask(
    shape: tuple[int, int], fraction: float = 0.3, seed: int = 0, center_frac: float = 0.08
) -> np.ndarray:
    """Cartesian (full phase-encode rows) variable-density mask."""
    h, w = shape
    rng = np.random.default_rng(seed)
    n_center = max(1, int(round(h * center_frac)))
    n_rand = max(0, int(round(h * fraction)) - n_center)
    # centered-coordinate probabilities ~ 1/(1+|k|), then unshift
    k = np.minimum(np.arange(h), h - np.arange(h)).astype(np.float64)
    p = 1.0 / (1.0 + k)
    center_rows = np.concatenate([np.arange(n_center // 2 + n_center % 2), h - 1 - np.arange(n_center // 2)])
    p[center_rows] = 0.0
    p /= p.sum()
    rows = rng.choice(h, size=n_rand, replace=False, p=p)
    mask = np.zeros(shape, dtype=np.float64)
    mask[rows, :] = 1.0
    mask[center_rows.astype(int), :] = 1.0
    return mask


def radial_mask(shape: tuple[int, int], n_spokes: int = 60) -> np.ndarray:
    """Golden-angle radial spoke mask."""
    h, w = shape
    mask = np.zeros(shape, dtype=np.float64)
    cy, cx = h // 2, w // 2
    radius = np.hypot(cy, cx)
    golden = np.pi * (3 - np.sqrt(5))
    ts = np.linspace(-1.0, 1.0, 4 * max(h, w))
    for s in range(n_spokes):
        theta = s * golden
        ys = np.round(cy + ts * radius * np.sin(theta)).astype(int)
        xs = np.round(cx + ts * radius * np.cos(theta)).astype(int)
        # drop points outside the image: clipping would smear runs of
        # samples along the borders where spokes exit obliquely
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        mask[ys[keep], xs[keep]] = 1.0
    return np.fft.ifftshift(mask)


def sampling_fraction(mask: np.ndarray) -> float:
    return float(np.count_nonzero(mask)) / mask.size
