"""The ADMM fixed-point driver and the classical L1 / CNC solvers.

Port of the JAX package's ``solvers/admm.py``. Where JAX runs the
iterations as one ``lax.scan``, this driver is a Python loop. Each
iteration (reference ``ADMM_L1.py:111-126``):

    x_{k+1} = DC(z_k - w_k)                 # k-space data-consistency solve
    z_{k+1} = prox(x_{k+1} + w_k)           # L1 / CNC
    w_{k+1} = w_k + x_{k+1} - z_{k+1}       # dual ascent

The z and w updates run as one CUDA kernel (``ops/tail_kernels.py``)
unless ``fused=False``. The JAX package's solvers default to unfused; the
port's default to fused, since on the card the fused solve is faster and
gives the same result (PERF.md). ``fused=False`` is kept as the kernels'
reference. Tolerance stopping (``cfg.tol``), the adaptive-rho variants,
the PnP solvers and ``admm_l1_jit`` are not ported yet (ROADMAP.md, M3).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.ops import fourier, prox, tail_kernels
from pnp_admm_cnc_mri_torch.parallel import reductions


class ADMMState(NamedTuple):
    """Primal x, auxiliary z, scaled dual w: all real, shape (..., H, W)."""

    x: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor


# z_update(iteration_index, x, z, w) -> new z
ZUpdate = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one that raises, and the CPU is
    used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def init_state(y: torch.Tensor, dtype=torch.float32) -> ADMMState:
    """Zero-filled magnitude init (reference ``ADMM_L1.py:100-105``)."""
    x0 = torch.abs(fourier.zero_fill(y)).to(dtype)
    return ADMMState(x=x0, z=x0, w=torch.zeros_like(x0))


def admm_step(
    state: ADMMState,
    i: int,
    y: torch.Tensor,
    mask: torch.Tensor,
    rho,
    z_update: ZUpdate,
    tail=None,
    dc=None,
) -> ADMMState:
    """One ADMM iteration. ``tail(i, x, z, w) -> (z_new, w_new)`` replaces
    the z-update and dual ascent with a fused one; ``dc`` is a precomputed
    data-consistency solve (``fourier.make_rfft_data_consistency``)."""
    if dc is not None:
        x = dc(state.z - state.w)
    else:
        x = fourier.data_consistency(state.z - state.w, y, mask, rho)
    x = x.to(state.z.dtype)
    if tail is not None:
        z, w = tail(i, x, state.z, state.w)
    else:
        z = z_update(i, x, state.z, state.w)
        w = state.w + x - z
    return ADMMState(x=x, z=z, w=w)


def run_admm(
    y: torch.Tensor,
    mask: torch.Tensor,
    iter_num: int,
    rho,
    z_update: ZUpdate,
    dtype=torch.float32,
    collect_residuals: bool = False,
    tail=None,
    use_rfft: bool = True,
    dc_method: str = "auto",
):
    """Run ``iter_num`` fixed iterations.

    ``use_rfft`` takes the half-spectrum data-consistency solve;
    ``dc_method`` is ``'fft'`` (``'auto'`` means the same) or ``'matmul'``.
    Returns ``(final_state, residuals)``: residuals is the per-iteration
    ``||x - z||_F`` of each batch element, shape ``(iter_num, *batch)``, or
    None unless ``collect_residuals``.
    """
    if dc_method not in fourier.DC_METHODS:
        raise ValueError(f"unknown dc_method {dc_method!r}; expected one of {fourier.DC_METHODS}")
    state = init_state(y, dtype)
    dc = fourier.make_rfft_data_consistency(y, mask, rho, method=dc_method) if use_rfft else None
    res = []
    for i in range(iter_num):
        state = admm_step(state, i, y, mask, rho, z_update, tail=tail, dc=dc)
        if collect_residuals:
            res.append(reductions.primal_residual_norm(state.x, state.z))
    return state, (torch.stack(res) if collect_residuals else None)


def _prepare(y, mask, cfg: ADMMConfig, device):
    if cfg.tol is not None:
        raise ValueError(
            "cfg.tol (tolerance stopping, run_admm_tol) is not ported yet: "
            "ROADMAP.md, item M3; use cfg.tol=None"
        )
    device = resolve_device(device)
    return torch.as_tensor(y, device=device), torch.as_tensor(mask, device=device)


def admm_l1(y, mask, cfg: ADMMConfig, dtype=torch.float32, fused: bool = True,
            device=None, **kw):
    """ADMM-L1 (reference ``ADMM_L1.py``): ``z = soft(x + w, rho * lam)``.

    ``y`` (complex k-space, (..., H, W)) and ``mask`` may be numpy arrays or
    tensors; they are moved to ``device`` (None: the CUDA card). ``fused``
    runs the z/w tail as the CUDA kernel ``tail_kernels.l1_tail`` (its
    plain version for CPU tensors); ``fused=False`` is the unfused
    reference. Other keywords go to ``run_admm``. Returns
    ``(final_state, residuals)``.
    """
    y, mask = _prepare(y, mask, cfg, device)
    thr = cfg.rho * cfg.lam

    def z_update(i, x, z, w):
        return prox.soft(x + w, thr)

    tail = None
    if fused:
        tail = lambda i, x, z, w: tail_kernels.l1_tail(x, z, w, thr)  # noqa: E731
    return run_admm(y, mask, cfg.iter_num, cfg.rho, z_update, dtype=dtype, tail=tail, **kw)


def admm_cnc(y, mask, cfg: ADMMConfig, dtype=torch.float32, fused: bool = True,
             device=None, **kw):
    """ADMM-CNC (reference ``ADMM_CNC .py``): GMC firm-threshold z-update;
    ``fused`` runs ``tail_kernels.cnc_tail``. Arguments as ``admm_l1``."""
    y, mask = _prepare(y, mask, cfg, device)

    def z_update(i, x, z, w):
        return prox.cnc_update(z, x + w, cfg.alpha, cfg.rho, cfg.lam, cfg.b)

    tail = None
    if fused:
        tail = lambda i, x, z, w: tail_kernels.cnc_tail(  # noqa: E731
            x, z, w, cfg.alpha, cfg.rho, cfg.lam, cfg.b
        )
    return run_admm(y, mask, cfg.iter_num, cfg.rho, z_update, dtype=dtype, tail=tail, **kw)
