"""The ADMM fixed-point driver, the classical L1 / CNC solvers and PnP-ADMM.

Port of the JAX package's ``solvers/admm.py``. Where JAX runs the
iterations as one ``lax.scan`` (or ``lax.while_loop``), this driver is a
Python loop. Each iteration (reference ``ADMM_L1.py:111-126``):

    x_{k+1} = DC(z_k - w_k)                 # k-space data-consistency solve
    z_{k+1} = prox(x_{k+1} + w_k)           # L1 / CNC / denoiser
    w_{k+1} = w_k + x_{k+1} - z_{k+1}       # dual ascent

The classical z and w updates run as one CUDA kernel
(``ops/tail_kernels.py``) unless ``fused=False``. The JAX package's
solvers default to unfused; the port's default to fused, since on the card
the fused solve is faster and gives the same result (PERF.md). The PnP
solvers put a denoiser (``priors/denoiser.py``) in the z-slot and clamp x,
z and w to [0, 1] after the dual update.
"""

from __future__ import annotations

import math
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
    clamp: bool = False,
    tail=None,
    dc=None,
) -> ADMMState:
    """One ADMM iteration. ``clamp`` is the CNN variants' [0, 1] clamp of x,
    z and the dual w (reference ``【3】PNP_ADMM_L1_D  .py:294-296``).
    ``tail(i, x, z, w) -> (z_new, w_new)`` replaces the z-update and dual
    ascent with a fused one; ``dc`` is a precomputed data-consistency solve
    (``fourier.make_rfft_data_consistency``)."""
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
    if clamp:
        x, z, w = prox.clip01(x), prox.clip01(z), prox.clip01(w)
    return ADMMState(x=x, z=z, w=w)


def _make_dc(y, mask, rho, use_rfft: bool, dc_method: str):
    if dc_method not in fourier.DC_METHODS:
        raise ValueError(f"unknown dc_method {dc_method!r}; expected one of {fourier.DC_METHODS}")
    return fourier.make_rfft_data_consistency(y, mask, rho, method=dc_method) if use_rfft else None


def run_admm(
    y: torch.Tensor,
    mask: torch.Tensor,
    iter_num: int,
    rho,
    z_update: ZUpdate,
    clamp: bool = False,
    dtype=torch.float32,
    collect_residuals: bool = False,
    tail=None,
    use_rfft: bool = True,
    dc_method: str = "auto",
    state: Optional[ADMMState] = None,
    start: int = 0,
):
    """Run iterations ``start .. iter_num - 1``: from the zero-filled start,
    or from ``state`` (a checkpoint's, in its own dtype) taken after
    ``start`` iterations, so that a resumed solve is the uninterrupted one.

    ``use_rfft`` takes the half-spectrum data-consistency solve;
    ``dc_method`` is ``'fft'`` (``'auto'`` means the same) or ``'matmul'``.
    Returns ``(final_state, residuals)``: residuals is the per-iteration
    ``||x - z||_F`` of each batch element, shape ``(iter_num - start,
    *batch)``, or None unless ``collect_residuals``.
    """
    dc = _make_dc(y, mask, rho, use_rfft, dc_method)
    if state is None:
        state = init_state(y, dtype)
    res = []
    for i in range(start, iter_num):
        state = admm_step(state, i, y, mask, rho, z_update, clamp, tail=tail, dc=dc)
        if collect_residuals:
            res.append(reductions.primal_residual_norm(state.x, state.z))
    return state, (torch.stack(res) if collect_residuals else None)


def run_admm_tol(
    y: torch.Tensor,
    mask: torch.Tensor,
    iter_num: int,
    rho,
    z_update: ZUpdate,
    tol: float,
    clamp: bool = False,
    dtype=torch.float32,
    tail=None,
    use_rfft: bool = True,
    dc_method: str = "auto",
):
    """Run until the worst relative primal residual of the batch,
    ``max ||x - z|| / ||x||``, is at most ``tol``, or ``iter_num``
    iterations. The residual is read on the host after every iteration.
    Returns ``(state, iterations_run)``, not ``run_admm``'s pair."""
    dc = _make_dc(y, mask, rho, use_rfft, dc_method)
    state = init_state(y, dtype)
    i, res = 0, math.inf
    while i < iter_num and res > tol:
        state = admm_step(state, i, y, mask, rho, z_update, clamp, tail=tail, dc=dc)
        num = reductions.primal_residual_norm(state.x, state.z)
        den = torch.sqrt(torch.sum(state.x**2, dim=(-2, -1))) + 1e-12
        res = float(torch.max(num / den))
        i += 1
    return state, i


def run_admm_adaptive(
    y: torch.Tensor,
    mask: torch.Tensor,
    iter_num: int,
    rho0,
    z_update,
    gamma: float = 1.2,
    eta: float = 0.95,
    clamp: bool = False,
    dtype=torch.float32,
    collect: bool = False,
):
    """ADMM with the residual-balancing rho continuation of Chan, Wang and
    Elgendy (IEEE TCI 2017), per batch element.

    Each iteration measures ``D = (||dx|| + ||dz|| + ||dw||) / sqrt(n)``;
    where it fails to shrink by ``eta``, that element's rho is divided by
    ``gamma`` (rho is the reference's ``1/beta``, so the paper's penalty
    grows). ``z_update(i, x, z, w, rho_b)`` gets rho as ``(..., 1, 1)``.
    The data-consistency solve is the full-spectrum one, as in JAX. With
    ``gamma=1`` this is ``run_admm``. Returns ``(state, (rhos, deltas))``,
    each ``(iter_num, *batch)``, when ``collect``, else ``(state, None)``.
    """
    state = init_state(y, dtype)
    batch_shape = state.x.shape[:-2]
    n = state.x.shape[-2] * state.x.shape[-1]
    rho = torch.broadcast_to(torch.as_tensor(rho0, dtype=dtype, device=state.x.device), batch_shape)
    delta_prev = torch.full(batch_shape, math.inf, dtype=dtype, device=state.x.device)

    def norm(a):
        return torch.sqrt(torch.sum(a * a, dim=(-2, -1)))

    trace = []
    for i in range(iter_num):
        rho_b = rho[..., None, None]
        x = fourier.data_consistency(state.z - state.w, y, mask, rho_b).to(state.z.dtype)
        z = z_update(i, x, state.z, state.w, rho_b)
        w = state.w + x - z
        if clamp:
            x, z, w = prox.clip01(x), prox.clip01(z), prox.clip01(w)
        delta = (norm(x - state.x) + norm(z - state.z) + norm(w - state.w)) / math.sqrt(n)
        if collect:
            trace.append((rho, delta))
        rho = torch.where(delta >= eta * delta_prev, rho / gamma, rho)
        state, delta_prev = ADMMState(x=x, z=z, w=w), delta
    if not collect:
        return state, None
    return state, (torch.stack([r for r, _ in trace]), torch.stack([d for _, d in trace]))


def prepare_inputs(y, mask, device):
    """k-space ``y`` and ``mask`` (numpy arrays or tensors) as tensors on
    ``resolve_device(device)``, their dtypes kept."""
    device = resolve_device(device)
    return torch.as_tensor(y, device=device), torch.as_tensor(mask, device=device)


def _check_tol_kwargs(kw):
    """Tolerance mode returns (state, iterations_run), not residual traces:
    options it cannot honor raise instead of being dropped."""
    bad = set(kw) - {"use_rfft", "dc_method"}
    if bad:
        raise ValueError(
            f"options {sorted(bad)} are not supported with cfg.tol set "
            "(tolerance mode returns (state, iterations_run); use "
            "cfg.tol=None for residual collection)"
        )


def _solve(y, mask, cfg: ADMMConfig, z_update, tail, dtype, kw):
    """``run_admm``, or ``run_admm_tol`` when ``cfg.tol`` is set."""
    if cfg.tol is not None:
        _check_tol_kwargs(kw)
        return run_admm_tol(y, mask, cfg.iter_num, cfg.rho, z_update, cfg.tol,
                            dtype=dtype, tail=tail, **kw)
    return run_admm(y, mask, cfg.iter_num, cfg.rho, z_update, dtype=dtype, tail=tail, **kw)


def classical_update(algo: str, cfg: ADMMConfig, fused: bool = True):
    """``(z_update, tail)`` of ``admm_l1`` (``algo='admm_l1'``: ``z = soft(x +
    w, rho * lam)``) or ``admm_cnc`` (the GMC firm threshold); ``tail`` runs
    the z/w update as the CUDA kernel of ``ops/tail_kernels.py`` when
    ``fused``, else it is None."""
    if algo == "admm_l1":
        thr = cfg.rho * cfg.lam

        def z_update(i, x, z, w):
            return prox.soft(x + w, thr)

        def tail(i, x, z, w):
            return tail_kernels.l1_tail(x, z, w, thr)
    elif algo == "admm_cnc":
        def z_update(i, x, z, w):
            return prox.cnc_update(z, x + w, cfg.alpha, cfg.rho, cfg.lam, cfg.b)

        def tail(i, x, z, w):
            return tail_kernels.cnc_tail(x, z, w, cfg.alpha, cfg.rho, cfg.lam, cfg.b)
    else:
        raise ValueError(f"unknown classical solver {algo!r} (want 'admm_l1' or 'admm_cnc')")
    return z_update, (tail if fused else None)


def admm_l1(y, mask, cfg: ADMMConfig, dtype=torch.float32, fused: bool = True,
            device=None, **kw):
    """ADMM-L1 (reference ``ADMM_L1.py``): ``z = soft(x + w, rho * lam)``.

    ``y`` (complex k-space, (..., H, W)) and ``mask`` may be numpy arrays or
    tensors; they are moved to ``device`` (None: the CUDA card). ``fused``
    runs the z/w tail as the CUDA kernel ``tail_kernels.l1_tail`` (its
    plain version for CPU tensors); ``fused=False`` is the unfused
    reference. Other keywords go to ``run_admm``. Returns
    ``(final_state, residuals)``, or with ``cfg.tol`` set
    ``run_admm_tol``'s ``(final_state, iterations_run)`` (then only
    ``use_rfft`` and ``dc_method`` are taken).
    """
    y, mask = prepare_inputs(y, mask, device)
    return _solve(y, mask, cfg, *classical_update("admm_l1", cfg, fused), dtype, kw)


def admm_cnc(y, mask, cfg: ADMMConfig, dtype=torch.float32, fused: bool = True,
             device=None, **kw):
    """ADMM-CNC (reference ``ADMM_CNC .py``): GMC firm-threshold z-update;
    ``fused`` runs ``tail_kernels.cnc_tail``. Arguments as ``admm_l1``."""
    y, mask = prepare_inputs(y, mask, device)
    return _solve(y, mask, cfg, *classical_update("admm_cnc", cfg, fused), dtype, kw)


def admm_l1_adaptive(y, mask, cfg: ADMMConfig, gamma: float = 1.2, eta: float = 0.95,
                     dtype=torch.float32, collect: bool = False, device=None):
    """ADMM-L1 with Chan-style rho continuation (``run_admm_adaptive``): the
    soft threshold follows the adapting rho, ``soft(x + w, rho_k * lam)``."""
    y, mask = prepare_inputs(y, mask, device)

    def z_update(i, x, z, w, rho_b):
        return prox.soft(x + w, rho_b * cfg.lam)

    return run_admm_adaptive(y, mask, cfg.iter_num, cfg.rho, z_update,
                             gamma=gamma, eta=eta, dtype=dtype, collect=collect)


def admm_l1_jit(y, mask, iter_num: int, rho, lam, device=None) -> torch.Tensor:
    """ADMM-L1 over a grid of ``(rho, lam)`` in one batched solve; returns x.

    The JAX package jits this and vmaps it over the grid. Here ``rho`` and
    ``lam`` are numbers or tensors whose shape broadcasts with y's batch
    shape: ``rho`` of shape (G, 1) against y of shape (B, H, W) gives x of
    shape (G, B, H, W), as the vmapped JAX function does. The state has
    y's real precision.
    """
    y, mask = prepare_inputs(y, mask, device)
    dt = y.real.dtype
    rho = torch.as_tensor(rho, dtype=dt, device=y.device)[..., None, None]
    lam = torch.as_tensor(lam, dtype=dt, device=y.device)[..., None, None]

    def z_update(i, x, z, w):
        return prox.soft(x + w, rho * lam)

    return run_admm(y, mask, iter_num, rho, z_update, dtype=dt)[0].x


# denoise(v, i) -> denoised v: the PnP z-slot (``priors.denoiser.build_denoiser``)
Denoise = Callable[[torch.Tensor, int], torch.Tensor]


def pnp_admm_l1(y, mask, cfg: ADMMConfig, denoise: Denoise, clamp: bool = True,
                dtype=torch.float32, device=None, **kw):
    """PnP-ADMM with a denoiser prior, ``z = denoise(x + w, i)`` (reference
    ``【3】PNP_ADMM_L1_D  .py``). ``denoise`` gets the iteration index for
    the sigma-scheduled priors (DRUNet, IRCNN). ``clamp`` is the CNN
    variants' [0, 1] clamp of x, z and w. Other keywords go to ``run_admm``.
    """
    y, mask = prepare_inputs(y, mask, device)

    def z_update(i, x, z, w):
        return denoise(x + w, i)

    return run_admm(y, mask, cfg.iter_num, cfg.rho, z_update, clamp=clamp, dtype=dtype, **kw)


def pnp_admm_cnc(y, mask, cfg: ADMMConfig, denoise1: Denoise, denoise2: Optional[Denoise] = None,
                 clamp: bool = True, dtype=torch.float32, device=None, **kw):
    """PnP-CNC with denoisers in both threshold slots (reference
    ``【6】PNP_ADMM_CNC_D .py:300-302``):

        s = D1(z);  t = (1-a) z + a (x+w) + a rho lam b (z - s);  z = D2(t)

    ``denoise2`` defaults to ``denoise1``; two different denoisers are the
    reference's two-checkpoint ``PNP_ADMM_CNC_DnCNN`` (``【6】:372,517-519``).
    """
    y, mask = prepare_inputs(y, mask, device)
    d2 = denoise2 if denoise2 is not None else denoise1

    def z_update(i, x, z, w):
        s = denoise1(z, i)
        return prox.cnc_generalized_update(z, x + w, s, cfg.alpha, cfg.rho, cfg.lam, cfg.b,
                                           lambda t: d2(t, i))

    return run_admm(y, mask, cfg.iter_num, cfg.rho, z_update, clamp=clamp, dtype=dtype, **kw)


def pnp_admm_l1_adaptive(y, mask, cfg: ADMMConfig, denoise: Denoise, gamma: float = 1.2,
                         eta: float = 0.95, clamp: bool = True, dtype=torch.float32,
                         collect: bool = False, device=None):
    """PnP-ADMM with Chan-style rho continuation; the denoiser ignores the
    adapting rho (its strength follows the iteration schedule)."""
    y, mask = prepare_inputs(y, mask, device)

    def z_update(i, x, z, w, rho_b):
        return denoise(x + w, i)

    return run_admm_adaptive(y, mask, cfg.iter_num, cfg.rho, z_update, gamma=gamma, eta=eta,
                             clamp=clamp, dtype=dtype, collect=collect)
