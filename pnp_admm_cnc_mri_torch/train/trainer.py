"""Denoiser training: Adam steps on the card, with optax's arithmetic.

Port of the JAX package's ``train/trainer.py``. A step is the forward, the
backward and the optimizer update of one batch, and it runs whole inside
``step_numerics``: cuDNN without TF32 (as the PnP forwards,
``priors/denoiser.full_precision_convs``), since autograd runs the backward
convolutions at ``loss.backward()``, outside any forward's context.

What differs from torch's defaults, so that a step equals the JAX one:

- the optimizer is optax's ``chain(clip_by_global_norm, adam | adamw)``
  (``Optimizer``): the clip scales by ``g / |g| * max_norm`` only when
  ``|g| >= max_norm``; the cosine schedule is optax's closed form through a
  ``LambdaLR``, its first update at count 0; AdamW decays every parameter,
  biases too, as optax's does;
- the L1 loss's ``|err|`` has JAX's gradient, 1 at 0 (``jax_abs``);
- parameters start from Flax's default init (``convert.flax_init_``) or
  from a Flax tree or state dict given as ``params``.

The trainers return ``(state_dict, losses)``; ``losses`` holds
``(step, loss)`` pairs at the JAX trainer's indices, read from the card
only on logging steps. ``scan_steps > 1`` keeps the JAX package's megastep
accounting (losses sampled inside a megastep, checkpoints at its ends, a
short tail overshot) although nothing here needs the scan.

``train_denoiser(mesh=)`` is the JAX package's data-and-tensor-parallel
trainer over a (data, space) mesh (``parallel/mesh.py``): each rank keeps
its ``data`` slice of the global batch and averages the gradients over
``data``; the convolutions whose out-channels divide the ``space`` axis
keep their slice of those channels (``shard_params_tp``) and all-gather
their outputs over ``space``. JAX's GSPMD inserts these collectives; here
the model's hooks and the optimizer call them.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.models import convert
from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib
from pnp_admm_cnc_mri_torch.parallel.reductions import global_mean
from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    loss: str = "l2"  # 'l2' (DnCNN-style) or 'l1' (FDnCNN-style)
    grad_clip: Optional[float] = 1.0
    lr_decay: Optional[str] = None  # None (constant) or 'cosine'
    lr_floor: float = 0.1  # cosine alpha: final lr = floor * learning_rate


@contextlib.contextmanager
def step_numerics():
    """cuDNN without TF32 and with deterministic algorithms inside the block
    (a whole step: forward, backward, update), the caller's settings after.
    Without the deterministic algorithms two runs from one seed differ on
    the H100 (cuDNN's default weight-gradient algorithms; PERF.md)."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


class _JaxAbs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` whose gradient at 0 is 1, as ``jnp.abs``'s (torch's is 0)."""
    return _JaxAbs.apply(x)


def make_loss_fn(model: Callable, loss: str = "l2", conditioned: bool = False):
    """``loss_fn(noisy, clean, sigma)`` over an NCHW batch, sigma (B, 1, 1, 1).

    ``conditioned``: the model takes a noise-level map channel (FDnCNN,
    DRUNet), concatenated after the image. FFDNet-style models take sigma
    as a separate argument (``ffdnet_loss_fn``)."""

    def loss_fn(noisy, clean, sigma):
        if conditioned:
            pred = model(torch.cat([noisy, sigma.expand_as(noisy)], dim=1))
        else:
            pred = model(noisy)
        err = pred - clean
        if loss == "l1":
            return torch.mean(jax_abs(err))
        return 0.5 * torch.mean(err**2)

    return loss_fn


def ffdnet_loss_fn(model: Callable):
    """The l2 loss of a model called as ``model(noisy, sigma)`` (FFDNet, TDNet)."""

    def loss_fn(noisy, clean, sigma):
        return 0.5 * torch.mean((model(noisy, sigma.reshape(-1)) - clean) ** 2)

    return loss_fn


def cosine_decay(steps: int, alpha: float) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule`` as a factor of the base rate:
    ``(1 - alpha) (1 + cos(pi min(count, steps) / steps)) / 2 + alpha``."""

    def factor(count: int) -> float:
        c = min(count, steps)
        return (1.0 - alpha) * (0.5 * (1.0 + math.cos(math.pi * c / steps))) + alpha

    return factor


def clip_by_global_norm_(grads, max_norm: float, norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the gradients, in place, without a
    host read and in a few multi-tensor launches: ``g / |g| * max_norm``
    where the global norm ``|g|`` is at least ``max_norm``, ``g`` (divided
    and multiplied by 1) where it is less. ``norm``, when given, is ``|g|``
    (a sharded model's, ``MeshOptimizer.global_norm``). Returns the norm."""
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip, one = norm >= max_norm, torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, torch.full_like(norm, max_norm), one))
    return norm


class Optimizer:
    """``make_optimizer``'s chain: the clip, then torch's Adam (AdamW with a
    weight decay) with the cosine schedule when asked for, all parameters in
    one group, optax's constants (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root)."""

    def __init__(self, params, cfg: TrainConfig, steps: Optional[int] = None):
        self.params = [p for p in params if p.requires_grad]
        kind = torch.optim.AdamW if cfg.weight_decay else torch.optim.Adam
        self.opt = kind(self.params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                        weight_decay=cfg.weight_decay)
        factor = cosine_decay(steps, cfg.lr_floor) if cfg.lr_decay == "cosine" and steps else (lambda c: 1.0)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.opt, factor)
        self.grad_clip = cfg.grad_clip

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        if self.grad_clip:
            clip_by_global_norm_([p.grad for p in self.params], self.grad_clip)
        self.opt.step()
        self.schedule.step()


def make_optimizer(cfg: TrainConfig, params, steps: Optional[int] = None) -> Optimizer:
    """The optimizer of ``cfg`` over ``params``; ``steps`` enables the cosine
    schedule (lr -> lr_floor * lr over the run)."""
    return Optimizer(params, cfg, steps)


# -- the dp x tp mesh (JAX's ``train/trainer.py:92-113``) --------------------------


class _ReplicatedInput(torch.autograd.Function):
    """The identity forward; the backward sums the input's gradient over
    ``space``. A split conv's backward gives only its channels' share of
    its input's gradient, and its input is the same on every ``space`` rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh_lib.all_reduce(g, ctx.mesh, "space"), None


class _GatherChannels(torch.autograd.Function):
    """A split conv's output channels all-gathered over ``space`` along C.
    The backward returns this rank's slice of the incoming gradient, not a
    sum over the ranks: every ``space`` rank runs the same computation
    downstream and holds the whole gradient already
    (``torch.distributed.nn.functional.all_gather``'s reduce-scatter would
    make it n times too large)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.c = mesh, x.shape[1]
        return mesh_lib.all_gather(x, mesh, "space", dim=1)

    @staticmethod
    def backward(ctx, g):
        s = ctx.mesh.coords["space"]
        return g.narrow(1, s * ctx.c, ctx.c).contiguous(), None


def _out_dim(m: torch.nn.Module) -> int:
    """The out-channel dim of a conv's weight: 0 (OIHW), 1 for a transposed conv (IOHW)."""
    return 1 if isinstance(m, torch.nn.ConvTranspose2d) else 0


def shard_params_tp(model: torch.nn.Module, mesh, axis: str = "space") -> dict:
    """Tensor-parallel split of ``model`` in place: every conv whose
    out-channels divide the ``axis`` size n (n > 1) keeps its rank's
    contiguous slice of them (weight and bias) and all-gathers its output
    over ``axis``; every other parameter stays whole. Returns
    ``{parameter name: split dim}``.

    JAX's ``shard_params_tp`` places each 4-D kernel on its last axis and
    each 1-D parameter whose size divides n. A Flax conv's last axis is its
    out-channels; a ``ConvTranspose(transpose_kernel=True)`` kernel's is its
    in-channels, where the port takes the out-channels as for the other
    convs (at the models' widths both divide). The models' only 1-D
    parameters are conv biases, so the two splits cover the same tensors."""
    n, s = mesh.shape[axis], mesh.coords[axis]
    split = {}
    if n == 1:
        return split
    for name, m in model.named_modules():
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            continue
        dim = _out_dim(m)
        c = m.weight.shape[dim]
        if c % n or c < n:
            continue
        k = c // n
        with torch.no_grad():
            m.weight = torch.nn.Parameter(m.weight.narrow(dim, s * k, k).clone())
            split[f"{name}.weight"] = dim
            if m.bias is not None:
                m.bias = torch.nn.Parameter(m.bias.narrow(0, s * k, k).clone())
                split[f"{name}.bias"] = 0
        m.register_forward_pre_hook(lambda mod, args: (_ReplicatedInput.apply(args[0], mesh), *args[1:]))
        m.register_forward_hook(lambda mod, args, out: _GatherChannels.apply(out, mesh))
    return split


def gather_params_tp(model: torch.nn.Module, mesh, split: dict, axis: str = "space") -> dict:
    """``model``'s state dict with every split parameter all-gathered whole
    over ``axis`` (copies; JAX's ``np.asarray`` of the sharded tree)."""
    return {k: (mesh_lib.all_gather(v.detach(), mesh, axis, dim=split[k]) if k in split else v.detach()).clone()
            for k, v in model.state_dict().items()}


def shard_batch_dp(batch, mesh, dtype=torch.float32, axis: str = "data") -> tuple:
    """This rank's ``axis`` slice of each NHWC array of ``batch`` (noisy,
    clean, sigma), as NCHW tensors of ``dtype`` on the mesh's device."""
    return tuple(mesh_lib.shard_batch(b, mesh, axis).to(dtype).permute(0, 3, 1, 2) for b in batch)


class MeshOptimizer(Optimizer):
    """``Optimizer`` on a rank's local parameters: the gradients averaged
    over ``data`` first (one all-reduce of them all), the clip on the global
    norm, Adam per element."""

    def __init__(self, named_params, cfg: TrainConfig, steps, mesh, split: dict):
        named = [(k, p) for k, p in named_params if p.requires_grad]
        super().__init__([p for _, p in named], cfg, steps)
        self.mesh, self.is_split = mesh, [k in split for k, _ in named]

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole gradient: each split tensor's squared local
        norms summed over ``space``, so that it counts once, beside the
        whole tensors' norms (the plain rule when nothing is split)."""
        norms = list(torch._foreach_norm([g for g, sp in zip(grads, self.is_split) if not sp]))
        parts = [g for g, sp in zip(grads, self.is_split) if sp]
        if parts:
            sq = torch.sum(torch.stack(torch._foreach_norm(parts)) ** 2)
            norms.append(torch.sqrt(mesh_lib.all_reduce(sq, self.mesh, "space")))
        return torch.linalg.vector_norm(torch.stack(norms))

    def step(self):
        grads = [p.grad for p in self.params]
        flat = mesh_lib.all_reduce(torch.cat([g.reshape(-1) for g in grads]), self.mesh, "data")
        flat = flat / self.mesh.shape["data"]
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)])
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip, norm=self.global_norm(grads))
        self.opt.step()
        self.schedule.step()


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    phase: Callable[[str], Any] = contextlib.nullcontext) -> Callable:
    """``train_step(noisy, clean, sigma) -> loss`` (a 0-d tensor on the
    device, not read): forward, backward and update in ``step_numerics``.
    ``phase(name)`` is a context wrapped around each of the three parts,
    named "forward", "backward" and "optimizer" (a timer's)."""

    def train_step(noisy, clean, sigma):
        with step_numerics():
            optimizer.zero_grad()
            with phase("forward"):
                loss = loss_fn(noisy, clean, sigma)
            with phase("backward"):
                loss.backward()
            with phase("optimizer"):
                optimizer.step()
        return loss.detach()

    return train_step


def prepare_model(model: torch.nn.Module, params, seed: int, dtype, device) -> torch.nn.Module:
    """``model`` in ``dtype`` on ``device``, trainable, from ``params`` (a
    Flax tree ``{"params": ...}`` such as ``convert.load_npz`` gives, or a
    state dict) or, with None, from Flax's default init drawn from a
    generator seeded with ``seed``."""
    model = model.to(dtype)
    if params is None:
        convert.flax_init_(model, torch.Generator().manual_seed(seed))
    elif set(params) == {"params"}:
        model.load_state_dict(convert.state_dict_from_flax(model, params, dtype))
    else:
        model.load_state_dict({k: torch.as_tensor(v).to(dtype) for k, v in params.items()})
    return model.to(device).train().requires_grad_(True)


def state_of(model: torch.nn.Module, ema=None) -> dict:
    """The trained weights as a state dict of copies (``ema``'s tensors in
    parameter order when given)."""
    if ema is None:
        return {k: v.detach().clone() for k, v in model.state_dict().items()}
    return {k: e.clone() for (k, _), e in zip(model.named_parameters(), ema)}


def ema_update_(ema, params, decay: float) -> None:
    """``ema = decay ema + (1 - decay) p``, in place."""
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - decay)


def _nchw(a: np.ndarray, device, dtype) -> torch.Tensor:
    """An NHWC numpy batch with C = 1 as an NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype).permute(0, 3, 1, 2)


def _loss_of(model, cfg: TrainConfig, conditioned: bool, ffdnet_style: bool):
    return ffdnet_loss_fn(model) if ffdnet_style else make_loss_fn(model, cfg.loss, conditioned)


def train_denoiser(
    model,
    patches: np.ndarray,
    sigma,
    steps: int = 1000,
    batch_size: int = 64,
    cfg: TrainConfig = TrainConfig(),
    mesh=None,
    conditioned: bool = False,
    seed: int = 0,
    log_every: int = 100,
    params: Any = None,
    ffdnet_style: bool = False,
    ckpt_cb: Optional[Callable[[int, Any], None]] = None,
    ckpt_every: int = 0,
    dtype=torch.float32,
    device=None,
):
    """Train ``model`` (a module of ``models/``) on host batches of
    ``patches`` (``data.batches``, the JAX package's draws for ``seed``);
    returns ``(state_dict, losses)``. ``ckpt_cb(step, state_dict)`` is called
    every ``ckpt_every`` steps and at the end. ``device`` None is the CUDA
    card.

    With a ``mesh`` (every rank of it calls this, on the mesh's device),
    every rank draws the same global batch and keeps its ``data`` slice
    (the batch size must divide the axis), the convs are split over
    ``space`` (``shard_params_tp``), and the loss logged is the global
    batch's. ``ckpt_cb`` and the result get the whole parameters on every
    rank."""
    from pnp_admm_cnc_mri_torch.train import data as data_mod

    device = mesh.device if mesh is not None else resolve_device(device)
    if mesh is not None:
        model = copy.deepcopy(model)  # shard_params_tp rebuilds the module: leave the caller's whole
    model = prepare_model(model, params, seed, dtype, device)
    loss_fn = _loss_of(model, cfg, conditioned, ffdnet_style)
    host = data_mod.batches(patches, batch_size, sigma, seed=seed)
    if mesh is None:
        step_fn = make_train_step(loss_fn, make_optimizer(cfg, model.parameters(), steps))

        def fused_step():
            return step_fn(*(_nchw(b, device, dtype) for b in next(host)))

        out = lambda: state_of(model)  # noqa: E731
    else:
        split = shard_params_tp(model, mesh)
        step_fn = make_train_step(loss_fn, MeshOptimizer(model.named_parameters(), cfg, steps, mesh, split))

        def fused_step():
            return global_mean(step_fn(*shard_batch_dp(next(host), mesh, dtype)), mesh)

        out = lambda: gather_params_tp(model, mesh, split)  # noqa: E731
    losses = _run(fused_step, out, steps, 1, log_every, ckpt_cb, ckpt_every)
    return out(), losses


def _dihedral(patch: torch.Tensor, mode: int) -> torch.Tensor:
    """Dihedral transform ``mode`` of the trailing (H, W) axes, the modes of
    ``data.augment_batch``: rot90 by ``mode % 4``, then a vertical flip for
    ``mode >= 4``."""
    q = torch.rot90(patch, mode % 4, dims=(-2, -1))
    return torch.flip(q, dims=(-2,)) if mode >= 4 else q


def dihedral_batch(x: torch.Tensor, modes: torch.Tensor) -> torch.Tensor:
    """Each (C, H, W) sample of a square NCHW batch by its own mode
    (``modes``, (B,) on the device), without a host read."""
    out = x
    for m in range(1, 8):
        out = torch.where((modes == m).view(-1, 1, 1, 1), _dihedral(x, m), out)
    return out


def stage_to_device(patches: np.ndarray, device=None, dtype=torch.float32) -> torch.Tensor:
    """The patch corpus on the device in one copy (the JAX package chunked
    it for its TPU link)."""
    return torch.from_numpy(np.asarray(patches)).to(device=resolve_device(device), dtype=dtype)


def _uniform(gen, shape, lo, hi, dtype):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def _run(fused_step, out, steps, scan_steps, log_every, ckpt_cb, ckpt_every, on_step_end=None,
         stream: bool = False):
    """The JAX trainers' loop accounting around ``fused_step() -> loss``:
    single steps (losses every ``log_every``, checkpoints every
    ``ckpt_every``, a final one), or megasteps of ``scan_steps`` (losses
    read once a megastep and sampled every ``log_every`` inside it,
    checkpoints at megastep ends, the tail overshot). ``on_step_end(done)``
    runs after each step or megastep (the stream's buffer refresh). The
    stream trainer's single steps log every ``log_every`` only and always
    save at the end (``stream``), as in the JAX package."""
    losses = []
    if scan_steps > 1:
        done = 0
        while done < steps:
            ls = torch.stack([fused_step() for _ in range(scan_steps)]).cpu().numpy()
            for j in range(0, scan_steps, max(1, log_every)):
                losses.append((done + j, float(ls[j])))
            done += scan_steps
            if on_step_end is not None:
                on_step_end(done)
            if ckpt_cb is not None and ckpt_every and done % max(ckpt_every, scan_steps) < scan_steps:
                ckpt_cb(done, out())
        if ckpt_cb is not None:
            ckpt_cb(done, out())
        return losses
    for i in range(steps):
        loss = fused_step()
        if i % log_every == 0 or (i == steps - 1 and not stream):
            losses.append((i, float(loss)))
        if on_step_end is not None:
            on_step_end(i + 1)
        if ckpt_cb is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt_cb(i + 1, out())
    if ckpt_cb is not None and (stream or not ckpt_every or steps % ckpt_every != 0):
        ckpt_cb(steps, out())
    return losses


def train_denoiser_ondevice(
    model,
    patches: np.ndarray,
    sigma,
    steps: int = 1000,
    batch_size: int = 64,
    cfg: TrainConfig = TrainConfig(),
    conditioned: bool = False,
    ffdnet_style: bool = False,
    seed: int = 0,
    log_every: int = 100,
    params: Any = None,
    ckpt_cb: Optional[Callable[[int, Any], None]] = None,
    ckpt_every: int = 0,
    ema_decay: Optional[float] = None,
    scan_steps: int = 1,
    dtype=torch.float32,
    device=None,
):
    """Train with the patch corpus staged on the device once: each step
    draws its batch, dihedral modes, sigmas and noise on the device from a
    generator seeded with ``seed + 1`` (no host batch, no host read but the
    logged losses). Returns ``(state_dict, losses)``; with ``ema_decay`` the
    state is the parameters' exponential moving average."""
    device = resolve_device(device)
    model = prepare_model(model, params, seed, dtype, device)
    optimizer = make_optimizer(cfg, model.parameters(), steps)
    step_fn = make_train_step(_loss_of(model, cfg, conditioned, ffdnet_style), optimizer)
    corpus = stage_to_device(patches, device, dtype)
    n = corpus.shape[0]
    lo, hi = sigma if isinstance(sigma, tuple) else (sigma, sigma)
    gen = torch.Generator(device).manual_seed(seed + 1)
    ema = [p.detach().clone() for p in optimizer.params] if ema_decay is not None else None

    def fused_step():
        idx = torch.randint(0, n, (batch_size,), generator=gen, device=device)
        modes = torch.randint(0, 8, (batch_size,), generator=gen, device=device)
        clean = dihedral_batch(corpus[idx][:, None], modes)
        sig = _uniform(gen, (batch_size, 1, 1, 1), lo, hi, dtype)
        noisy = clean + sig * torch.randn(clean.shape, generator=gen, device=device, dtype=dtype)
        loss = step_fn(noisy, clean, sig)
        if ema is not None:
            ema_update_(ema, optimizer.params, ema_decay)
        return loss

    out = lambda: state_of(model, ema)  # noqa: E731
    losses = _run(fused_step, out, steps, scan_steps, log_every, ckpt_cb, ckpt_every)
    return out(), losses


def train_denoiser_stream(
    model,
    generator: Callable,
    sigma,
    steps: int = 1000,
    batch_size: int = 64,
    patch: int = 64,
    cfg: TrainConfig = TrainConfig(),
    buffer_images: int = 2048,
    refresh_every: int = 0,
    conditioned: bool = False,
    ffdnet_style: bool = False,
    seed: int = 0,
    log_every: int = 100,
    params: Any = None,
    ckpt_cb: Optional[Callable[[int, Any], None]] = None,
    ckpt_every: int = 0,
    ema_decay: Optional[float] = None,
    scan_steps: int = 1,
    teacher_apply: Optional[Callable] = None,
    teacher_params: Any = None,
    distill_weight: float = 1.0,
    dtype=torch.float32,
    device=None,
    timers=None,
):
    """Train on a procedural corpus made on the device (``train.synth``).

    ``generator(gen, n) -> (n, size, size)`` fills a ``buffer_images``-image
    buffer; each step random-crops ``patch``-sized patches from it, applies
    a dihedral mode, draws sigma in ``sigma`` (a level or a (lo, hi) range)
    and the noise, all on the device from one generator seeded with
    ``seed + 1``. ``refresh_every > 0`` regenerates the buffer every that
    many steps (an unlimited stream); 0 keeps the first buffer.

    Distillation (``teacher_apply(teacher_params, noisy, sigma) -> target``,
    run without gradients on the same noisy batch): the loss is
    ``distill_weight`` x MSE(student, teacher) + ``(1 - distill_weight)`` x
    MSE(student, clean), each halved as the l2 loss.

    ``timers`` (a ``utils.profiling.PhaseTimers``) splits each step into
    batch, forward, backward, optimizer and EMA, and times each buffer
    synthesis, synchronizing the card at each boundary: a measuring mode,
    slower than the plain loop.
    Returns ``(state_dict, losses)``, the EMA state with ``ema_decay``."""
    device = resolve_device(device)
    model = prepare_model(model, params, seed, dtype, device)
    optimizer = make_optimizer(cfg, model.parameters(), steps)
    if ffdnet_style:
        student = lambda noisy, sig: model(noisy, sig.reshape(-1))  # noqa: E731
    elif conditioned:
        student = lambda noisy, sig: model(torch.cat([noisy, sig.expand_as(noisy)], dim=1))  # noqa: E731
    else:
        student = lambda noisy, sig: model(noisy)  # noqa: E731
    if teacher_apply is not None:
        w_d = float(distill_weight)

        def loss_fn(noisy, clean, sig):
            pred = student(noisy, sig)
            with torch.no_grad():
                tgt = teacher_apply(teacher_params, noisy, sig)
            return w_d * (0.5 * torch.mean((pred - tgt) ** 2)) + (1.0 - w_d) * (0.5 * torch.mean((pred - clean) ** 2))
    else:
        loss_fn = _loss_of(model, cfg, conditioned, ffdnet_style)
    phase = functools.partial(_synced_phase, timers, device=device) if timers is not None else contextlib.nullcontext
    step_fn = make_train_step(loss_fn, optimizer, phase)
    lo, hi = sigma if isinstance(sigma, tuple) else (sigma, sigma)
    gen = torch.Generator(device).manual_seed(seed + 1)
    state = {"buffer": generator(gen, buffer_images), "last_refresh": 0}
    ema = [p.detach().clone() for p in optimizer.params] if ema_decay is not None else None
    rows = torch.arange(patch, device=device)

    def batch():
        buf = state["buffer"]
        n_buf, size = buf.shape[0], buf.shape[-1]
        idx = torch.randint(0, n_buf, (batch_size,), generator=gen, device=device)
        tops = torch.randint(0, size - patch + 1, (batch_size,), generator=gen, device=device)
        lefts = torch.randint(0, size - patch + 1, (batch_size,), generator=gen, device=device)
        crop = buf[idx[:, None, None], (tops[:, None] + rows)[:, :, None], (lefts[:, None] + rows)[:, None, :]]
        modes = torch.randint(0, 8, (batch_size,), generator=gen, device=device)
        clean = dihedral_batch(crop[:, None].to(dtype), modes)
        sig = _uniform(gen, (batch_size, 1, 1, 1), lo, hi, dtype)
        return clean + sig * torch.randn(clean.shape, generator=gen, device=device, dtype=dtype), clean, sig

    def fused_step():
        with phase("batch"):
            b = batch()
        loss = step_fn(*b)
        if ema is not None:
            with phase("ema"):
                ema_update_(ema, optimizer.params, ema_decay)
        return loss

    def refresh(done):
        if refresh_every and done - state["last_refresh"] >= refresh_every:
            with phase("synthesis"):
                state["buffer"] = generator(gen, buffer_images)
            state["last_refresh"] = done

    out = lambda: state_of(model, ema)  # noqa: E731
    losses = _run(fused_step, out, steps, scan_steps, log_every, ckpt_cb, ckpt_every, on_step_end=refresh,
                  stream=True)
    return out(), losses


@contextlib.contextmanager
def _synced_phase(timers, name: str, device):
    """``timers.phase(name)`` ending when the card has finished the block's work."""
    with timers.phase(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)

