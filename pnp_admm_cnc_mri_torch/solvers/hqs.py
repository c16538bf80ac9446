"""Half-quadratic splitting (HQS), the DPIR iteration, for the MRI problem.

Port of the JAX package's ``solvers/hqs.py``:

    x_{k+1} = argmin_x ||M F x - y||^2 + alpha_k ||x - z_k||^2
              (the k-space blend of ``fourier.data_consistency`` with
              La2 = alpha_k, i.e. rho = 1 / (2 alpha_k))
    z_{k+1} = D_{sigma_k}(x_{k+1})

with ``alpha_k`` growing along the ``get_rho_sigma`` ladder as the
denoiser's sigma decays. A Python loop in place of ``lax.scan``; the
alphas and ``1 / (2 alpha)`` are formed on the host in the working dtype,
as JAX forms them in its. ``denoise(u, i)`` gets the iteration index.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.ops import fourier, prox, schedules
from pnp_admm_cnc_mri_torch.parallel import reductions
from pnp_admm_cnc_mri_torch.solvers.admm import prepare_inputs
from pnp_admm_cnc_mri_torch.solvers.fista import host_scalar


def host_ladder(alphas, iter_num: int, dtype) -> np.ndarray:
    """``alphas`` as a numpy array of the working dtype, one per iteration."""
    alphas = np.asarray(alphas, dtype=type(host_scalar(0, dtype)))
    if alphas.shape != (iter_num,):
        raise ValueError(f"alphas has shape {alphas.shape}; expected ({iter_num},)")
    return alphas


def run_hqs(y, mask, iter_num: int, denoise: Callable, alphas, clamp: bool = True, dtype=torch.float32,
            collect_residuals: bool = False, device=None, z0=None, start: int = 0):
    """HQS iterations ``start .. iter_num - 1`` from the zero-filled
    magnitude, or from ``z0`` (on the solve's device) taken after ``start``
    iterations, as a checkpoint resumes.

    ``alphas``: the per-iteration data-solve weights (DPIR's ``rhos`` of
    ``schedules.get_rho_sigma``; a larger alpha pulls less toward the data).
    ``y`` and ``mask`` go to ``device`` (None: the CUDA card). Returns
    ``(z_final, residuals)``: ``||x - z||_F`` of each batch element at each
    iteration, shape ``(iter_num - start, *batch)``, or None unless
    ``collect_residuals``.
    """
    y, mask = prepare_inputs(y, mask, device)
    alphas = host_ladder(alphas, iter_num, dtype)
    z = torch.abs(fourier.zero_fill(y)).to(dtype) if z0 is None else z0
    res = []
    for i in range(start, iter_num):
        alpha = alphas[i]
        rho = type(alpha)(1) / (type(alpha)(2) * alpha)
        x = fourier.data_consistency(z, y, mask, float(rho)).to(z.dtype)
        z_new = denoise(x, i).to(z.dtype)
        if clamp:
            z_new = prox.clip01(z_new)
        if collect_residuals:
            res.append(reductions.primal_residual_norm(x, z_new))
        z = z_new
    return z, (torch.stack(res) if collect_residuals else None)


def pnp_hqs(y, mask, iter_num: int, denoise: Callable, sigma255: float = 10.0, model_sigma1: float = 49.0,
            model_sigma2: float = 15.0, clamp: bool = True, dtype=torch.float32, collect_residuals: bool = False,
            device=None):
    """DPIR-style PnP-HQS: the ``get_rho_sigma`` ladder from ``model_sigma1``
    down to ``model_sigma2``, its ``rhos`` (scaled by ``sigma255``, a tuning
    knob here: ``config.TUNED_HQS_D``) as the alphas of ``run_hqs``.

    Build the denoiser with the same ``(iter_num, model_sigma1,
    model_sigma2)`` so that its sigma walks the same ladder as the data solve.
    """
    rhos, _ = schedules.get_rho_sigma(sigma=sigma255 / 255.0, iter_num=iter_num, model_sigma1=model_sigma1,
                                      model_sigma2=model_sigma2)
    return run_hqs(y, mask, iter_num, denoise, rhos, clamp=clamp, dtype=dtype,
                   collect_residuals=collect_residuals, device=device)
