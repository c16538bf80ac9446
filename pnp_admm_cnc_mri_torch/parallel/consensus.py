"""Consensus solvers: one image reconstructed from N observations.

Port of the JAX package's ``parallel/consensus.py``. Each observation has
its own mask; one shared iterate:

- consensus-ADMM: per-observation data-consistency solves and duals, and
  one z-prox of their mean;
- consensus-FISTA: one iterate and a fused gradient over all
  observations, preconditioned by the per-frequency sampling count;
- consensus-HQS: one iterate and the exact joint k-space data solve.

The observation axis is -3: one problem is (N, H, W), and leading axes are
independent problems (a batch of images, each with its N observations).
Python loops replace ``lax.scan``; ``'auto'`` data consistency means
``'fft'`` in this package.

The ``*_sharded`` variants split one problem's N observations over the
mesh's ``data`` axis (``parallel/mesh.py``): each rank owns N/n of them,
the iterate is replicated, and the reductions over observations become
``global_mean``/``global_sum`` (``parallel/reductions.py``): ADMM one a
iteration, FISTA one a iteration, HQS two at setup and none in its loop.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.ops import fourier, prox, schedules
from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib
from pnp_admm_cnc_mri_torch.parallel.reductions import global_mean, global_sum
from pnp_admm_cnc_mri_torch.solvers import fista as fista_mod
from pnp_admm_cnc_mri_torch.solvers.admm import prepare_inputs
from pnp_admm_cnc_mri_torch.solvers.hqs import host_ladder


def _sampled(ys: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``ys`` where the mask indicator ``m`` samples, 0 elsewhere."""
    return torch.where(m != 0, ys, torch.zeros((), dtype=ys.dtype, device=ys.device))


def consensus_admm_step(z, w, dc, z_prox, i, dtype, reduce=None):
    """One consensus-ADMM iteration:

        x_n = DC_n(z - w_n);  z = z_prox(mean_n(x_n + w_n), i);  w_n += x_n - z

    ``reduce`` turns this shard's mean into the mean over all shards (the
    sharded solve's ``global_mean``)."""
    x = dc(z[..., None, :, :] - w).to(dtype)
    v = torch.mean(x + w, dim=-3)
    if reduce is not None:
        v = reduce(v)
    z_new = z_prox(v, i)
    w_new = w + x - z_new[..., None, :, :]
    return z_new, w_new


def run_consensus(ys, masks, cfg: ADMMConfig, z_prox: Optional[Callable] = None, dtype=torch.float32,
                  dc_method: str = "auto", return_state: bool = False, device=None, state=None, start: int = 0):
    """Consensus-ADMM over ``ys``/``masks`` of shape (..., N, H, W) (masks may
    be (N, H, W) and shared by the leading axes), on ``device`` (None: the
    CUDA card). Returns ``(z, x)`` with the per-observation x, or
    ``(z, x, w)`` with ``return_state``. ``z_prox(v, i)`` defaults to the L1
    soft-threshold at ``cfg.rho * cfg.lam``. ``state``: ``(z, w)`` on the
    solve's device after ``start`` iterations, as a checkpoint resumes."""
    ys, masks = prepare_inputs(ys, masks, device)
    if z_prox is None:
        z_prox = lambda v, i: prox.soft(v, cfg.rho * cfg.lam)  # noqa: E731
    if state is None:
        x0 = torch.abs(fourier.zero_fill(ys)).to(dtype)
        state = torch.mean(x0, dim=-3), torch.zeros_like(x0)
    z, w = state
    dtype = z.dtype
    dc = fourier.make_rfft_data_consistency(ys, masks, cfg.rho, method=dc_method)
    for i in range(start, cfg.iter_num):
        z, w = consensus_admm_step(z, w, dc, z_prox, i, dtype)
    x = dc(z[..., None, :, :] - w).to(dtype)
    return (z, x, w) if return_state else (z, x)


def run_consensus_sharded(ys, masks, cfg: ADMMConfig, mesh, axis: str = "data", dtype=torch.float32,
                          z_prox: Optional[Callable] = None, dc_method: str = "auto"):
    """Consensus-ADMM with the N observations of ``ys``/``masks`` (N, H, W)
    split over ``axis`` (JAX's ``consensus.py:85``): this rank solves its
    N/n on the mesh's device; the start ``mean_n |A_n^H y_n|`` and each
    iteration's ``mean_n(x_n + w_n)`` are ``global_mean``s. Returns z,
    replicated on every rank."""
    ys, masks = mesh_lib.shard_batch(ys, mesh, axis), mesh_lib.shard_batch(masks, mesh, axis)
    if z_prox is None:
        z_prox = lambda v, i: prox.soft(v, cfg.rho * cfg.lam)  # noqa: E731
    x0 = torch.abs(fourier.zero_fill(ys)).to(dtype)
    z, w = global_mean(torch.mean(x0, dim=0), mesh, axis), torch.zeros_like(x0)
    dc = fourier.make_rfft_data_consistency(ys, masks, cfg.rho, method=dc_method)
    mean = lambda v: global_mean(v, mesh, axis)  # noqa: E731
    for i in range(cfg.iter_num):
        z, w = consensus_admm_step(z, w, dc, z_prox, i, dtype, reduce=mean)
    return z


def consensus_fista_iteration(state, i, m, ysz, cnt, prox_fn, step, dtype, reduce=None):
    """One consensus-FISTA iteration from the setup of
    ``consensus_fista_setup``: the gradient
    ``ifft2(sum_n (m_n fft2(v) - m_n y_n) / cnt)``, the prox, the momentum.
    ``reduce`` turns this shard's sum over observations into the sum over
    all shards (the sharded solve's ``global_sum``)."""
    vf = fourier.fft2(state.v)
    res = torch.sum(m * vf[..., None, :, :] - ysz * m, dim=-3)
    if reduce is not None:
        res = reduce(res)
    res = res / cnt
    g = torch.real(fourier.ifft2(res)).to(dtype)
    x_new = prox_fn(i, state.v - step * g).to(dtype)
    t_new, v_new = fista_mod.fista_extrapolate(state.x, x_new, state.t)
    return fista_mod.FISTAState(x=x_new, v=v_new, t=t_new)


def consensus_fista_setup(ys, masks, precondition: bool):
    """``(m, ysz, cnt)``: the mask indicator, the data zeroed where not
    sampled, and the per-frequency sampling count ``max(sum_n m_n, 1)``
    with ``precondition``, else the number of observations N (0-d)."""
    m = (masks != 0).to(ys.real.dtype)
    if precondition:
        cnt = torch.clamp_min(torch.sum(m, dim=-3), 1.0)
    else:
        cnt = torch.tensor(float(masks.shape[-3]), dtype=m.dtype, device=m.device)
    return m, _sampled(ys, m), cnt


def run_consensus_fista(ys, masks, iter_num: int, prox_fn, step: float = 1.0, dtype=torch.float32,
                        precondition: bool = True, return_state: bool = False, device=None, state=None,
                        start: int = 0):
    """Multi-observation FISTA: one iterate, one fused gradient over all
    observations. With ``precondition`` the summed k-space residual is
    divided by the per-frequency sampling count, which makes the normal
    operator the orthogonal projection onto the union of the masks
    (Lipschitz 1); without it, by N. ``prox_fn(i, u)`` as in
    ``solvers.fista.run_fista``. Starts from ``mean_n |ifft2(ysz_n)|``.
    Returns x, or the ``FISTAState`` with ``return_state``. ``state``: a
    ``FISTAState`` on the solve's device after ``start`` iterations."""
    ys, masks = prepare_inputs(ys, masks, device)
    m, ysz, cnt = consensus_fista_setup(ys, masks, precondition)
    if state is None:
        x0 = torch.mean(torch.abs(fourier.zero_fill(ysz)), dim=-3).to(dtype)
        state = fista_mod.FISTAState(x=x0, v=x0, t=fista_mod.host_scalar(1.0, dtype))
    for i in range(start, iter_num):
        state = consensus_fista_iteration(state, i, m, ysz, cnt, prox_fn, step, state.x.dtype)
    return state if return_state else state.x


def consensus_hqs_step(z, i, alpha, S, cnt, denoise, clamp, dtype):
    """One consensus-HQS iteration given the summed sampled data ``S`` and
    the per-frequency count ``cnt``: ``Xf = (S + alpha Zf) / (cnt + alpha)``,
    the magnitude projection, the denoiser."""
    zf = fourier.fft2(z)
    xf = (S + alpha * zf) / (cnt + alpha)
    x = torch.abs(torch.real(fourier.ifft2(xf))).to(dtype)
    z_new = denoise(x, i).to(dtype)
    return prox.clip01(z_new) if clamp else z_new


def run_consensus_hqs(ys, masks, iter_num: int, denoise: Callable, sigma255: float = 10.0,
                      model_sigma1: float = 49.0, model_sigma2: float = 15.0, clamp: bool = True,
                      dtype=torch.float32, alphas=None, device=None, z0=None, start: int = 0):
    """Multi-observation HQS: the joint x-subproblem
    ``argmin_x sum_n ||M_n F x - y_n||^2 + alpha_k ||x - z_k||^2`` solved
    exactly per frequency. ``alphas`` overrides the ``get_rho_sigma`` ladder
    (one per iteration). Starts from ``|ifft2(S / max(cnt, 1))|``; at N = 1
    this is ``solvers.hqs.pnp_hqs`` on the masked observation. ``z0``: the
    iterate on the solve's device after ``start`` iterations."""
    ys, masks = prepare_inputs(ys, masks, device)
    m = (masks != 0).to(ys.real.dtype)
    cnt = torch.sum(m, dim=-3)
    S = torch.sum(_sampled(ys, m), dim=-3)
    if alphas is None:
        alphas, _ = schedules.get_rho_sigma(sigma=sigma255 / 255.0, iter_num=iter_num, model_sigma1=model_sigma1,
                                            model_sigma2=model_sigma2)
    alphas = host_ladder(alphas, iter_num, dtype)
    z = torch.abs(fourier.ifft2(S / torch.clamp_min(cnt, 1.0))).to(dtype) if z0 is None else z0
    for i in range(start, iter_num):
        z = consensus_hqs_step(z, i, float(alphas[i]), S, cnt, denoise, clamp, z.dtype)
    return z


def run_consensus_hqs_sharded(ys, masks, iter_num: int, denoise: Callable, mesh, axis: str = "data",
                              sigma255: float = 10.0, model_sigma1: float = 49.0, model_sigma2: float = 15.0,
                              clamp: bool = True, dtype=torch.float32, alphas=None):
    """Consensus-HQS with the observations split over ``axis`` (JAX's
    ``consensus.py:287``): the per-frequency count and the summed sampled
    data are ``global_sum``'d once, then the loop runs replicated with no
    collective. ``alphas`` overrides the ladder as in ``run_consensus_hqs``.
    Returns z, replicated on every rank."""
    ys, masks = mesh_lib.shard_batch(ys, mesh, axis), mesh_lib.shard_batch(masks, mesh, axis)
    if alphas is None:
        alphas, _ = schedules.get_rho_sigma(sigma=sigma255 / 255.0, iter_num=iter_num, model_sigma1=model_sigma1,
                                            model_sigma2=model_sigma2)
    alphas = host_ladder(alphas, iter_num, dtype)
    m = (masks != 0).to(ys.real.dtype)
    cnt = global_sum(torch.sum(m, dim=0), mesh, axis)
    S = global_sum(torch.sum(_sampled(ys, m), dim=0), mesh, axis)
    z = torch.abs(fourier.ifft2(S / torch.clamp_min(cnt, 1.0))).to(dtype)
    for i in range(iter_num):
        z = consensus_hqs_step(z, i, float(alphas[i]), S, cnt, denoise, clamp, z.dtype)
    return z


def run_consensus_fista_sharded(ys, masks, iter_num: int, prox_fn, mesh, axis: str = "data", step: float = 1.0,
                                dtype=torch.float32, precondition: bool = True):
    """Consensus-FISTA with the observations split over ``axis`` (JAX's
    ``consensus.py:340``): the count is ``global_sum``'d once, the start is a
    ``global_mean``, and each iteration's fused k-space residual is one
    ``global_sum``. Returns x, replicated on every rank."""
    n_total = float(torch.as_tensor(masks).shape[0])
    ys, masks = mesh_lib.shard_batch(ys, mesh, axis), mesh_lib.shard_batch(masks, mesh, axis)
    m = (masks != 0).to(ys.real.dtype)
    if precondition:
        cnt = torch.clamp_min(global_sum(torch.sum(m, dim=0), mesh, axis), 1.0)
    else:
        cnt = torch.tensor(n_total, dtype=m.dtype, device=m.device)
    ysz = _sampled(ys, m)
    x0 = global_mean(torch.mean(torch.abs(fourier.zero_fill(ysz)), dim=0), mesh, axis).to(dtype)
    state = fista_mod.FISTAState(x=x0, v=x0, t=fista_mod.host_scalar(1.0, dtype))
    total = lambda r: global_sum(r, mesh, axis)  # noqa: E731
    for i in range(iter_num):
        state = consensus_fista_iteration(state, i, m, ysz, cnt, prox_fn, step, dtype, reduce=total)
    return state.x
