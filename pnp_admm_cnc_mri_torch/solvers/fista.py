"""Accelerated proximal-gradient solvers: ISTA/PGD and FISTA.

Port of the JAX package's ``solvers/fista.py``. Forward-backward splitting
on the masked-FFT forward model,

    x_{k+1} = prox_{s g}( v_k - s grad f(v_k) )
    v_{k+1} = x_{k+1} + ((t_k - 1) / t_{k+1}) (x_{k+1} - x_k)      [FISTA]

with ``f(x) = ||M F x - y||^2 / (2 N)``, whose gradient is
``fourier.data_term_gradient`` and whose Lipschitz constant is 1, so
``step = 1`` is the canonical choice. Where JAX runs one ``lax.scan``, this
is a Python loop. The momentum scalar t does not depend on the data: it is
computed on the host as a numpy scalar of the working dtype, which rounds
as JAX's 0-d array does and keeps device reads out of the loop.

Trailing (H, W) axes, any leading batch axes; the prox is
``prox_fn(i, u)`` with the iteration index first (a Python int), so
sigma-ladder denoisers drop in unchanged.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.ops import fourier, prox
from pnp_admm_cnc_mri_torch.solvers.admm import prepare_inputs


class FISTAState(NamedTuple):
    """Iterate x, extrapolated point v, and the momentum t, a numpy scalar
    of the working dtype."""

    x: torch.Tensor
    v: torch.Tensor
    t: np.floating


# prox_fn(iteration_index, u) -> new u
ProxFn = Callable[[int, torch.Tensor], torch.Tensor]


def host_scalar(value, dtype: torch.dtype) -> np.floating:
    """``value`` as a numpy scalar of the numpy type of ``dtype``."""
    return torch.empty(0, dtype=dtype).numpy().dtype.type(value)


def fista_extrapolate(x_old: torch.Tensor, x_new: torch.Tensor, t):
    """One Beck-Teboulle momentum update: ``(t_new, v_new)``. ``t`` and
    ``t_new`` are numpy scalars of x's dtype, computed on the host in that
    dtype. Shared with the consensus variant
    (``parallel/consensus.consensus_fista_iteration``)."""
    t = host_scalar(t, x_new.dtype)
    one = type(t)(1)
    t_new = (one + np.sqrt(one + type(t)(4) * (t * t))) / type(t)(2)
    return t_new, x_new + float((t - one) / t_new) * (x_new - x_old)


def data_objective(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``f(x) = ||M F x - y||^2 / (2 N)`` over the trailing two axes, the
    normalization of ``fourier.data_term_gradient`` (unit Lipschitz
    gradient on the sampled subspace)."""
    res = fourier.fft2(x) * mask
    res = torch.where(mask != 0, res - y, res)
    n = x.shape[-2] * x.shape[-1]
    return torch.sum(torch.abs(res) ** 2, dim=(-2, -1)) / (2.0 * n)


def run_fista(
    y,
    mask,
    iter_num: int,
    prox_fn: ProxFn,
    step: float = 1.0,
    momentum: bool = True,
    dtype=torch.float32,
    collect_objective: bool = False,
    penalty_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    prox_takes_prev: bool = False,
    device=None,
    state: Optional[FISTAState] = None,
    start: int = 0,
):
    """FISTA iterations ``start .. iter_num - 1`` (ISTA/PGD with
    ``momentum=False``) from the zero-filled magnitude (reference
    ``【1】ADMM_L1.py:100-105``), or from ``state`` (tensors on the solve's
    device) taken after ``start`` iterations, as a checkpoint resumes.

    ``y`` and ``mask`` go to ``device`` (None: the CUDA card). Returns
    ``(final_state, objectives)``: the data term at each iterate plus
    ``penalty_fn(x)`` when given, shape ``(iter_num - start, *batch)``, or None
    unless ``collect_objective``. For ISTA with ``step <= 1`` the full
    objective is non-increasing. ``prox_takes_prev`` calls
    ``prox_fn(i, u, x_prev)``, for operators that linearize around the
    previous iterate (``pnp_pgd_cnc``).
    """
    y, mask = prepare_inputs(y, mask, device)
    if state is None:
        x0 = torch.abs(fourier.zero_fill(y)).to(dtype)
        state = FISTAState(x=x0, v=x0, t=host_scalar(1.0, dtype))
    objs = []
    for i in range(start, iter_num):
        g = torch.real(fourier.data_term_gradient(state.v, y, mask)).to(dtype)
        u = state.v - step * g
        x_new = (prox_fn(i, u, state.x) if prox_takes_prev else prox_fn(i, u)).to(dtype)
        if momentum:
            t_new, v_new = fista_extrapolate(state.x, x_new, state.t)
        else:
            t_new, v_new = state.t, x_new
        if collect_objective:
            obj = data_objective(x_new, y, mask)
            objs.append(obj if penalty_fn is None else obj + penalty_fn(x_new))
        state = FISTAState(x=x_new, v=v_new, t=t_new)
    return state, (torch.stack(objs) if collect_objective else None)


def fista_l1(y, mask, iter_num: int = 50, lam: float = 8e-4, step: float = 1.0, momentum: bool = True,
             dtype=torch.float32, collect_objective: bool = False, device=None):
    """FISTA for ``min lam ||x||_1 + ||M F x - y||^2 / (2 N)``: one
    soft-threshold at ``step * lam`` an iteration. The objective collected
    includes the L1 penalty."""
    return run_fista(
        y, mask, iter_num, lambda i, u: prox.soft(u, step * lam), step=step, momentum=momentum, dtype=dtype,
        collect_objective=collect_objective, penalty_fn=lambda x: lam * torch.sum(torch.abs(x), dim=(-2, -1)),
        device=device,
    )


def pnp_fista(y, mask, iter_num: int, denoise: Callable, step: float = 1.0, clamp: bool = True,
              dtype=torch.float32, momentum: bool = True, device=None):
    """PnP-FBS / PnP-FISTA: ``denoise(u, i)`` as the proximal operator
    (``priors.denoiser.build_denoiser``), iterates clamped to [0, 1] with
    ``clamp`` as in the CNN-variant ADMM loops."""

    def prox_fn(i, u):
        z = denoise(u, i)
        return prox.clip01(z) if clamp else z

    return run_fista(y, mask, iter_num, prox_fn, step=step, dtype=dtype, momentum=momentum, device=device)


def pgd_l1(y, mask, iter_num: int = 50, lam: float = 8e-4, step: float = 1.0, dtype=torch.float32,
           collect_objective: bool = False, device=None):
    """Proximal gradient (ISTA) for the L1 problem: ``fista_l1`` without
    momentum; ``step`` is the reference's PGD ``alpha``."""
    return fista_l1(y, mask, iter_num=iter_num, lam=lam, step=step, momentum=False, dtype=dtype,
                    collect_objective=collect_objective, device=device)


def pnp_pgd(y, mask, iter_num: int, denoise: Callable, step: float = 1.0, clamp: bool = True,
            dtype=torch.float32, device=None):
    """PnP-PGD: ``pnp_fista`` without momentum."""
    return pnp_fista(y, mask, iter_num, denoise, step=step, clamp=clamp, dtype=dtype, momentum=False,
                     device=device)


def pnp_pgd_cnc(y, mask, iter_num: int, denoise1: Callable, denoise2: Optional[Callable] = None,
                alpha: float = 1.2, lam: float = 0.02, b: float = 36.0, step: float = 1.0, clamp: bool = True,
                dtype=torch.float32, device=None):
    """PGD with the CNC (GMC) double-denoiser composition as the prox, the
    gradient point u in the ADMM-CNC update's ``x + w`` slot and the
    previous iterate as the linearization point:

        s = D1(x);  t = (1-a) x + a u + a step lam b (x - s);  x' = D2(t)

    ``denoise2`` defaults to ``denoise1``; no momentum.
    """
    d2 = denoise2 if denoise2 is not None else denoise1

    def prox_fn(i, u, x_prev):
        s = denoise1(x_prev, i)
        z = prox.cnc_generalized_update(x_prev, u, s, alpha, step, lam, b, lambda t: d2(t, i))
        return prox.clip01(z) if clamp else z

    return run_fista(y, mask, iter_num, prox_fn, step=step, momentum=False, dtype=dtype, prox_takes_prev=True,
                     device=device)
