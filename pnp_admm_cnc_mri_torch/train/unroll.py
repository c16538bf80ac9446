"""Unrolled end-to-end training: differentiate through the PnP-FISTA solve.

Port of the JAX package's ``train/unroll.py``. The denoiser is trained
against the reconstruction MSE of the whole FISTA solve
(``solvers/fista.pnp_fista`` with the DRUNet ladder prior of
``priors/denoiser.build_denoiser``; ``tests/test_torch_unroll.py`` holds the
two equal), the deep-unrolling recipe (MoDL / VarNet family).

- Each iteration runs under ``torch.utils.checkpoint`` (``remat=True``, in
  place of ``jax.checkpoint``): the backward recomputes an iteration's
  activations, so peak memory holds one iteration's, not ``iter_num``'s.
  ``remat=False`` keeps them all (the plain path).
- The step (forward, backward with its recomputes, update) runs whole in
  ``trainer.step_numerics``: no TF32 in any convolution.
- The iterate clamp has ``jnp.clip``'s gradient, 1/2 at a bound
  (``jax_clip01``; torch's ``clamp`` gives 1).
- Training images come from a ``train.synth`` generator (and optionally a
  pool of real images mixed in at ``real_fraction``); each sample draws one
  mask from an (M, H, W) stack; the k-space noise is complex Gaussian with
  a per-component std of ``noise_std`` (the reference's fixed field,
  ``CS_MRI/noises.mat`` x3, ~15) jittered by ``noise_jitter``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from pnp_admm_cnc_mri_torch.ops import fourier, schedules
from pnp_admm_cnc_mri_torch.solvers import fista
from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device
from pnp_admm_cnc_mri_torch.train import trainer


class _JaxClip01(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp(x, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inside = (x > 0) & (x < 1)
        tie = (x == 0) | (x == 1)
        return torch.where(inside, g, torch.where(tie, 0.5 * g, torch.zeros_like(g)))


def jax_clip01(x: torch.Tensor) -> torch.Tensor:
    """``clamp(x, 0, 1)`` with ``jnp.clip``'s gradient: 1 inside, 1/2 at 0
    and at 1 (``jnp.clip`` is ``minimum(maximum(x, 0), 1)``, whose gradient
    splits a tie evenly), 0 outside."""
    return _JaxClip01.apply(x)


def make_drunet_ladder_denoise(model: Callable, iter_num: int, nlm255: float = 12.0, model_sigma1: float = 15.0):
    """``denoise(u, i)`` through a sigma-map conditioned UNetRes ``model``
    (trainable), with the ladder ``build_denoiser``'s drunet branch builds:
    (..., H, W) -> (..., H, W)."""
    _, sigmas = schedules.get_rho_sigma(sigma=max(0.255 / 255.0, nlm255 / 255.0), iter_num=iter_num,
                                        model_sigma1=model_sigma1, model_sigma2=nlm255)

    def denoise(u, i):
        x = u.reshape(-1, 1, *u.shape[-2:])
        out = model(torch.cat([x, torch.full_like(x, float(sigmas[i]))], dim=1))
        return out[:, 0].reshape(u.shape)

    return denoise


def make_unrolled_recon(denoise: Callable, iter_num: int, step: float = 1.0, remat: bool = True,
                        dtype=torch.float32):
    """``recon(y, mask) -> x``: the ``pnp_fista`` iteration (clamp on,
    momentum on, the momentum scalar on the host as in ``solvers/fista``),
    differentiable with respect to the denoiser's parameters. The iterates
    are ``dtype`` (the JAX package's are float32)."""

    def recon(y, mask):
        def body(x, v, i, t):
            g = torch.real(fourier.data_term_gradient(v, y, mask)).to(dtype)
            x_new = jax_clip01(denoise(v - step * g, i)).to(dtype)
            t_new, v_new = fista.fista_extrapolate(x, x_new, t)
            return x_new, v_new, t_new

        x = torch.abs(fourier.zero_fill(y)).to(dtype)
        v, t = x, fista.host_scalar(1.0, dtype)
        for i in range(iter_num):
            if remat:
                x, v, t = torch.utils.checkpoint.checkpoint(body, x, v, i, t, use_reentrant=False)
            else:
                x, v, t = body(x, v, i, t)
        return x

    return recon


def unrolled_noise(gen: torch.Generator, shape, noise_std: float, noise_jitter: float, dtype) -> torch.Tensor:
    """(2, B, H, W) k-space noise, real and imaginary parts, each sample's
    std ``noise_std (1 + noise_jitter u)`` with u uniform in [-1, 1]."""
    b = shape[0]
    u = 2.0 * torch.rand((b, 1, 1), generator=gen, device=gen.device, dtype=dtype) - 1.0
    scale = noise_std * (1.0 + noise_jitter * u)
    return scale * torch.randn((2, *shape), generator=gen, device=gen.device, dtype=dtype)


def make_unrolled_step(recon: Callable, optimizer: trainer.Optimizer) -> Callable:
    """``step(clean, mask, noise) -> loss`` for an (B, H, W) batch: y =
    F(clean) mask + noise[0] + i noise[1], the loss 0.5 MSE(recon(y), clean),
    backward and update in ``trainer.step_numerics``."""

    def step(clean, mask, noise):
        cdtype = torch.complex128 if clean.dtype == torch.float64 else torch.complex64
        with trainer.step_numerics():
            optimizer.zero_grad()
            y = (fourier.fft2(clean) * mask + torch.complex(noise[0], noise[1])).to(cdtype)
            loss = 0.5 * torch.mean((recon(y, mask) - clean) ** 2)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


def train_unrolled(
    model,
    recon_denoise: Callable,
    masks: np.ndarray,
    iter_num: int,
    generator: Optional[Callable] = None,
    real_images: Optional[np.ndarray] = None,
    steps: int = 1500,
    batch_size: int = 2,
    learning_rate: float = 2e-5,
    noise_std: float = 15.0,
    noise_jitter: float = 0.3,
    step: float = 1.0,
    params: Any = None,
    seed: int = 0,
    log_every: int = 20,
    ckpt_cb: Optional[Callable[[int, Any], None]] = None,
    ckpt_every: int = 0,
    ema_decay: Optional[float] = None,
    real_fraction: float = 0.5,
    lr_floor: float = 0.1,
    refresh_every: int = 500,
    buffer_images: int = 64,
    dtype=torch.float32,
    device=None,
) -> Tuple[dict, list]:
    """Train ``model`` through the unrolled FISTA solve; returns
    ``(state_dict, losses)`` (the EMA's state with ``ema_decay``).

    ``recon_denoise(u, i)``: the conditioned denoiser around ``model`` (e.g.
    :func:`make_drunet_ladder_denoise`). ``masks``: (M, H, W), one drawn per
    sample. ``generator(gen, n)`` makes (n, H, W) clean images on the
    device (``train/synth.py``), regenerated every ``refresh_every`` steps;
    ``real_images`` (R, H, W) are staged once and mixed in at
    ``real_fraction``; without a generator they are the buffer. The
    optimizer is Adam with optax's global-norm clip at 1 and a cosine
    schedule down to ``lr_floor``; draws come from a generator on the device
    seeded with ``seed + 1``."""
    device = resolve_device(device)
    h, w = masks.shape[-2:]
    model = trainer.prepare_model(model, params, seed, dtype, device)
    cfg = trainer.TrainConfig(learning_rate=learning_rate, grad_clip=1.0, lr_decay="cosine", lr_floor=lr_floor)
    optimizer = trainer.make_optimizer(cfg, model.parameters(), steps)
    step_fn = make_unrolled_step(make_unrolled_recon(recon_denoise, iter_num, step=step, dtype=dtype), optimizer)
    masks_d = torch.as_tensor(np.asarray(masks), dtype=dtype, device=device)
    real_d = None
    if real_images is not None and len(real_images):
        real_d = trainer.stage_to_device(np.asarray(real_images, np.float32), device, dtype)
    gen = torch.Generator(device).manual_seed(seed + 1)
    if generator is not None:
        buffer = generator(gen, buffer_images).to(dtype)
    else:
        if real_d is None:
            raise ValueError("train_unrolled needs a generator or real images")
        buffer, real_d = real_d, None
    ema = [p.detach().clone() for p in optimizer.params] if ema_decay is not None else None
    out = lambda: trainer.state_of(model, ema)  # noqa: E731
    losses, last_refresh = [], 0
    for i in range(steps):
        idx = torch.randint(0, buffer.shape[0], (batch_size,), generator=gen, device=device)
        clean = buffer[idx]
        if real_d is not None:
            ridx = torch.randint(0, real_d.shape[0], (batch_size,), generator=gen, device=device)
            take_real = torch.rand((batch_size, 1, 1), generator=gen, device=device) < real_fraction
            clean = torch.where(take_real, real_d[ridx], clean)
        mk = masks_d[torch.randint(0, masks_d.shape[0], (batch_size,), generator=gen, device=device)]
        loss = step_fn(clean, mk, unrolled_noise(gen, (batch_size, h, w), noise_std, noise_jitter, dtype))
        if ema is not None:
            trainer.ema_update_(ema, optimizer.params, ema_decay)
        if i % log_every == 0 or i == steps - 1:
            losses.append((i, float(loss)))
        if generator is not None and refresh_every and i - last_refresh >= refresh_every:
            buffer = generator(gen, buffer_images).to(dtype)
            last_refresh = i
        if ckpt_cb is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt_cb(i + 1, out())
    if ckpt_cb is not None:
        ckpt_cb(steps, out())
    return out(), losses
