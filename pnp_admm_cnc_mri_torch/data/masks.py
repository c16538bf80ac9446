"""K-space sampling masks (numpy generators; DC at the corner, as the
unshifted FFT expects). Copies of the JAX package's ``data/masks.py:56-119``;
the ``.mat`` loaders are not copied."""

from __future__ import annotations

import numpy as np


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
