"""MATLAB-compatible bicubic resize (antialiased), in torch.

Port of the JAX package's ``ops/resize.py`` (the reference's vendored
``imresize`` / ``imresize_np``, ``utils/utils_image.py:713-856``, KAIR's
port of MATLAB ``imresize``): a 4-tap cubic kernel, widened by 1/scale when
antialiasing a downscale, symmetric boundary extension, applied per axis.
The weight and index tables are host numpy (they depend on the shape
only); the resize is two gathers and two weighted sums, whose products run
at full float32 precision (no TF32).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.ops.fourier import full_precision_matmul


def _cubic(x: np.ndarray) -> np.ndarray:
    absx = np.abs(x)
    absx2 = absx**2
    absx3 = absx**3
    return (1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1) + (
        -0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2
    ) * ((absx > 1) & (absx <= 2))


def _weights_indices(in_length: int, out_length: int, scale: float, antialiasing: bool
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """MATLAB contribution tables: (weights (out, P), indices (out, P)), the
    indices into the symmetrically extended axis, mapped back into range."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p)[None, :]  # 1-based
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # trim the all-zero columns (MATLAB keeps the nonzero support)
    nonzero = ~np.all(weights == 0, axis=0)
    first = int(np.argmax(nonzero))
    last = len(nonzero) - int(np.argmax(nonzero[::-1]))
    weights = weights[:, first:last]
    indices = indices[:, first:last]

    # symmetric (reflect-including-edge) boundary mapping
    idx = indices.astype(np.int64) - 1
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx >= in_length, 2 * in_length - idx - 1, idx)
    idx = np.clip(idx, 0, in_length - 1)
    return weights, idx


def imresize(img: torch.Tensor, scale: float, antialiasing: bool = True) -> torch.Tensor:
    """Resize (..., H, W) by ``scale`` with MATLAB bicubic semantics."""
    h, w = img.shape[-2:]
    out_h, out_w = math.ceil(h * scale), math.ceil(w * scale)
    wh, ih = _weights_indices(h, out_h, scale, antialiasing)
    ww, iw = _weights_indices(w, out_w, scale, antialiasing)
    dev, dt = img.device, img.dtype
    with full_precision_matmul():
        # H axis: out[..., i, :] = sum_t wh[i, t] img[..., ih[i, t], :]
        g = img.index_select(-2, torch.as_tensor(ih.reshape(-1), device=dev))
        g = g.reshape(*img.shape[:-2], *ih.shape, w)  # (..., out_h, P, w)
        out = torch.einsum("...opw,op->...ow", g, torch.as_tensor(wh, dtype=dt, device=dev))
        # W axis
        g = out.index_select(-1, torch.as_tensor(iw.reshape(-1), device=dev))
        g = g.reshape(*out.shape[:-1], *iw.shape)  # (..., out_h, out_w, P)
        return torch.einsum("...op,op->...o", g, torch.as_tensor(ww, dtype=dt, device=dev))
