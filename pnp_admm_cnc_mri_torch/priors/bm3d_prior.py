"""BM3D as a PnP prior: ``denoise(v, i)`` callables for the solvers' z-slot.

Port of the JAX package's ``priors/bm3d_prior.py``. Reproduces the
reference usage (``【2】PNP_ADMM_L1_BM3D .py:127``, ``【5】PNP_ADMM_CNC_BM3D
.py:133-136``): the z-update denoises with BM3D at the white-noise sigma of
``get_experiment_noise('gw', 0.03, 0)``, sigma = sqrt(0.03). ``v`` has shape
(..., H, W) and stays on its device; the images are denoised ``batch_chunk``
at a time as one batch of torch ops (the JAX package maps them one by one).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.priors.bm3d import core


def default_batch_chunk() -> int:
    """How many images one BM3D call takes together."""
    return 4


def _chunked(v: torch.Tensor, sigma: float, profile: core.BM3DProfile, stages: str,
             chunk: int) -> torch.Tensor:
    """BM3D of every (H, W) image of ``v``, ``chunk`` images a call (the
    matching fields of a call grow with its images), without the prefilter:
    the reference's full-PSD path does not switch to it."""
    flat = v.reshape(-1, *v.shape[-2:])
    chunk = max(1, int(chunk))
    out = [core.bm3d(flat[i:i + chunk], sigma, profile, stages, prefilter=False, device=v.device)
           for i in range(0, flat.shape[0], chunk)]
    return torch.cat(out).reshape(v.shape)


def make_bm3d_denoiser(
    noise_var: float = 0.03,
    profile: core.BM3DProfile = core.DEFAULT_PROFILE,
    stages: str = "all",
    batch_chunk: Optional[int] = None,
) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """``denoise(v, i)``: two-stage BM3D of each image at sigma =
    sqrt(``noise_var``) on the [0, 1] scale, whatever ``i``. ``batch_chunk``
    images a call (default :func:`default_batch_chunk`)."""
    sigma = float(np.sqrt(noise_var))
    chunk = default_batch_chunk() if batch_chunk is None else batch_chunk

    def denoise(v, i):
        return _chunked(v, sigma, profile, stages, chunk)

    return denoise


def make_bm3d_ladder_denoiser(
    sigmas,
    profile: core.BM3DProfile = core.DEFAULT_PROFILE,
    stages: str = "all",
    batch_chunk: Optional[int] = None,
) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """``denoise(v, i)`` at the i-th sigma of a ladder.

    ``sigmas`` is the [0, 1]-scale ladder of ``schedules.get_rho_sigma``, the
    one that conditions the CNN priors in the DPIR-style solvers (reference
    ``utils/utils_pnp.py:14-23``); PnP-HQS takes it. Batched inputs chunk as
    in :func:`make_bm3d_denoiser`.
    """
    sig = np.asarray(sigmas, np.float64)
    chunk = default_batch_chunk() if batch_chunk is None else batch_chunk

    def denoise(v, i):
        return _chunked(v, float(sig[int(i)]), profile, stages, chunk)

    return denoise
