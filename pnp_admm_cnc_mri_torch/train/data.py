"""Training patches and batches for the denoisers, in numpy.

Port of the JAX package's ``train/data.py``. Patch sampling follows the
standard Gaussian-denoiser recipe the KAIR models were trained with: random
crops, dihedral augmentation, AWGN at a fixed or sampled noise level. The
arithmetic and the draws are the JAX package's, so ``batches`` gives the
same arrays for the same seed.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch


def extract_patches(
    imgs: Sequence[np.ndarray],
    patch: int = 40,
    stride: int = 20,
) -> np.ndarray:
    """Dense patch grid from a list of (H, W) float [0,1] images."""
    out = []
    for img in imgs:
        h, w = img.shape[:2]
        for i in range(0, h - patch + 1, stride):
            for j in range(0, w - patch + 1, stride):
                out.append(img[i : i + patch, j : j + patch])
    return np.stack(out).astype(np.float32)


def extract_patches_multiscale(
    imgs: Sequence[np.ndarray],
    patch: int = 40,
    stride: int = 20,
    scales: Sequence[float] = (1.0, 0.75, 0.5),
) -> np.ndarray:
    """Patches from several MATLAB-bicubic rescalings of each image
    (``ops.resize.imresize``, on the CPU in the image's dtype)."""
    from pnp_admm_cnc_mri_torch.ops import resize

    pools = []
    for s in scales:
        if s == 1.0:
            scaled = list(imgs)
        else:
            scaled = [resize.imresize(torch.from_numpy(np.asarray(im)), s).numpy().clip(0, 1) for im in imgs]
        scaled = [im for im in scaled if min(im.shape[:2]) >= patch]
        if scaled:
            pools.append(extract_patches(scaled, patch, stride))
    if not pools:
        raise ValueError("no scale produced patches >= patch size")
    return np.concatenate(pools, axis=0)


def augment_batch(patches: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random dihedral augmentation per patch (8 modes: rot90 by m % 4, then
    a vertical flip for m >= 4)."""
    modes = rng.integers(0, 8, size=patches.shape[0])
    out = np.empty_like(patches)
    for m in range(8):
        sel = modes == m
        if not sel.any():
            continue
        p = np.rot90(patches[sel], m % 4, axes=(1, 2))
        if m >= 4:
            p = p[:, ::-1, :]
        out[sel] = p
    return out


def batches(
    patches: np.ndarray,
    batch_size: int,
    sigma: float | tuple[float, float],
    seed: int = 0,
    epochs: Optional[int] = None,
    augment: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (noisy, clean, sigma_map) float32 batches, NHWC with C=1 (the
    JAX package's layout; the trainers move them to NCHW).

    ``sigma``: a fixed level or a (lo, hi) range sampled per patch (the
    range trains blind and conditioned models). Values on the [0,1] scale.
    """
    rng = np.random.default_rng(seed)
    n = patches.shape[0]
    if n < batch_size:
        raise ValueError(
            f"only {n} patches available for batch_size={batch_size}; "
            "use more/larger training images or a smaller batch"
        )
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            clean = patches[order[start : start + batch_size]]
            if augment:
                clean = augment_batch(clean, rng)
            if isinstance(sigma, tuple):
                s = rng.uniform(sigma[0], sigma[1], size=(batch_size, 1, 1)).astype(np.float32)
            else:
                s = np.full((batch_size, 1, 1), sigma, dtype=np.float32)
            noisy = clean + s * rng.standard_normal(clean.shape).astype(np.float32)
            yield noisy[..., None], clean[..., None], s[..., None]
        epoch += 1
