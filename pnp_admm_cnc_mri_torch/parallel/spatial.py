"""One image's rows over the mesh's ``space`` axis: the distributed 2-D FFT and
ADMM-L1 on it.

Port of the JAX package's ``parallel/spatial.py``. The H axis is split over
``space``, and the 2-D FFT decomposes the SPMD way:

    rows local:  FFT along W on the (..., H/n, W) row shard
    all_to_all:  (..., H/n, W) -> (..., H, W/n), one exchange over ``space``
    cols local:  FFT along H on the (..., H, W/n) column shard

so the spectrum comes out W-split, and the inverse reverses it. The ADMM
x-update runs in the W-split spectrum layout (the mask blend is pointwise),
so an iteration costs two all-to-alls. ``all_to_all_single`` splits along
dim 0 only, so the block axis is moved to the front around it; JAX's
``split_axis``/``concat_axis`` say the same (``spatial.py:34-38, 50-53``).
"""

from __future__ import annotations

import torch

from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.ops import tail_kernels
from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib


def fft2_rows_to_cols(x_local: torch.Tensor, mesh, axis: str = "space") -> torch.Tensor:
    """Row shard (..., H/n, W) -> W-split spectrum (..., H, W/n)."""
    n = mesh.shape[axis]
    f = torch.fft.fft(x_local, dim=-1)  # along W, local
    hs, ws = f.shape[-2], f.shape[-1] // n
    blocks = f.reshape(*f.shape[:-1], n, ws).movedim(-2, 0)  # (n, ..., H/n, W/n): block j goes to rank j
    got = mesh_lib.all_to_all(blocks, mesh, axis)  # (n, ..., H/n, W/n): block i holds rank i's rows
    full = got.movedim(0, -3).reshape(*got.shape[1:-2], n * hs, ws)  # (..., H, W/n)
    return torch.fft.fft(full, dim=-2)  # along H, local


def ifft2_cols_to_rows(f_local: torch.Tensor, mesh, axis: str = "space") -> torch.Tensor:
    """W-split spectrum (..., H, W/n) -> row shard (..., H/n, W)."""
    n = mesh.shape[axis]
    f = torch.fft.ifft(f_local, dim=-2)  # along H, local
    hs, ws = f.shape[-2] // n, f.shape[-1]
    blocks = f.reshape(*f.shape[:-2], n, hs, ws).movedim(-3, 0)  # (n, ..., H/n, W/n): row block i to rank i
    got = mesh_lib.all_to_all(blocks, mesh, axis)  # (n, ..., H/n, W/n): block j holds rank j's columns
    rows = got.movedim(0, -2).reshape(*got.shape[1:-1], n * ws)  # (..., H/n, W)
    return torch.fft.ifft(rows, dim=-1)


def spatial_admm_l1(y, mask, cfg: ADMMConfig, mesh, axis: str = "space", dtype=torch.float32) -> torch.Tensor:
    """ADMM-L1 with the image's H axis split over ``axis``.

    ``y`` (complex k-space) and ``mask`` come whole, (..., H, W) (the mask
    may broadcast); this rank keeps their W-split columns (the spectrum
    layout) on the mesh's device. Each iteration's z/w update is
    ``tail_kernels.l1_tail`` (K1) on the contiguous row shard. Returns x of
    the last iteration, its rows gathered over ``axis`` into the whole
    image on every rank. With a batch split over ``data`` as well, pass
    this rank's ``shard_batch`` of y (JAX's ``tests/test_spatial.py:70``).
    """
    n, s = mesh.shape[axis], mesh.coords[axis]
    y, mask = torch.as_tensor(y), torch.as_tensor(mask)
    ws = y.shape[-1] // n
    y_spec = y[..., s * ws:(s + 1) * ws].to(mesh.device)
    mask_spec = mask[..., s * ws:(s + 1) * ws].to(mesh.device, y.real.dtype)
    la2 = 1.0 / (2.0 * cfg.rho)
    thr = cfg.rho * cfg.lam
    x = torch.abs(ifft2_cols_to_rows(y_spec, mesh, axis)).to(dtype)  # rows
    z, w = x, torch.zeros_like(x)
    for _ in range(cfg.iter_num):
        vf = fft2_rows_to_cols((z - w).to(dtype), mesh, axis)
        xf = torch.where(mask_spec != 0, (la2 * vf + y_spec) / (1.0 + la2), vf)
        x = torch.abs(torch.real(ifft2_cols_to_rows(xf, mesh, axis))).to(dtype)
        z, w = tail_kernels.l1_tail(x, z, w, thr)
    return mesh_lib.all_gather(x, mesh, axis, dim=-2)
