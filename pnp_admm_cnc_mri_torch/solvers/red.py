"""RED, regularization by denoising (Romano, Elad and Milanfar, 2017).

Port of the JAX package's ``solvers/red.py``. The regularizer
``R(x) = (lam/2) x^T (x - D(x))`` has the gradient ``lam (x - D(x))``, so

    x_{k+1} = x_k - mu [grad f(x_k) + lam (x_k - D(x_k))]                 ('gd')
    x_{k+1} = (x_k - mu grad f(x_k) + mu lam D(x_k)) / (1 + mu lam)       ('fp')

with ``f(x) = ||M F x - y||^2 / (2 N)`` (``fourier.data_term_gradient``).
A Python loop in place of ``lax.scan``; ``denoise(u, i)`` gets the
iteration index.
"""

from __future__ import annotations

from typing import Callable

import torch

from pnp_admm_cnc_mri_torch.ops import fourier, prox
from pnp_admm_cnc_mri_torch.parallel import reductions
from pnp_admm_cnc_mri_torch.solvers.admm import prepare_inputs


def run_red(y, mask, iter_num: int, denoise: Callable, lam: float = 0.2, step: float = 1.0, variant: str = "fp",
            clamp: bool = True, dtype=torch.float32, collect_residuals: bool = False, device=None, x0=None,
            start: int = 0):
    """RED iterations ``start .. iter_num - 1`` from the zero-filled
    magnitude, or from ``x0`` (on the solve's device) taken after ``start``
    iterations, as a checkpoint resumes.

    ``variant='gd'`` is explicit gradient descent (stable for
    ``step <= 2 / (1 + lam)``); ``'fp'`` the fixed-point form, in which the
    denoised image enters as a convex combination. ``y`` and ``mask`` go to
    ``device`` (None: the CUDA card). Returns ``(x_final, residuals)``:
    ``||x - D(x)||_F`` of each batch element at each iteration, shape
    ``(iter_num - start, *batch)``, or None unless ``collect_residuals``.
    """
    if variant not in ("gd", "fp"):
        raise ValueError(f"unknown RED variant {variant!r} (want 'gd' or 'fp')")
    y, mask = prepare_inputs(y, mask, device)
    x = torch.abs(fourier.zero_fill(y)).to(dtype) if x0 is None else x0
    res = []
    for i in range(start, iter_num):
        g = torch.real(fourier.data_term_gradient(x, y, mask)).to(dtype)
        dx = denoise(x, i).to(dtype)
        if variant == "gd":
            x_new = x - step * (g + lam * (x - dx))
        else:
            x_new = (x - step * g + step * lam * dx) / (1.0 + step * lam)
        if clamp:
            x_new = prox.clip01(x_new)
        if collect_residuals:
            res.append(reductions.primal_residual_norm(x, dx))
        x = x_new
    return x, (torch.stack(res) if collect_residuals else None)
