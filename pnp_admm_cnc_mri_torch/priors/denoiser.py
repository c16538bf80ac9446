"""Denoisers as PnP priors: ``denoise(v, i)`` callables for the ADMM z-slot.

Port of the JAX package's ``priors/denoiser.py`` (reference dispatchers
``denoising_step1``, ``【3】PNP_ADMM_L1_D  .py:19-68``, and
``denoising_step2``, ``【6】PNP_ADMM_CNC_D .py:18-67``). ``v`` has shape
(..., H, W) with values in [0, 1]; ``i`` is the iteration index:

- ``dncnn*``: ``z = model(v)`` (a residual net);
- ``fdncnn``: a second channel, ``|k-space noise| / 255`` (the reference
  feeds the noise magnitude image, not a constant level map; replicated),
  or a constant map of ``noise_level_model / 255``;
- ``drunet``: a second channel holding the iteration's rung of the sigma
  ladder, optionally the dihedral transform ``i % 8`` around the forward
  (``x8``);
- ``ircnn``: 25 stacked weight sets, the iteration's set picked by the
  sigma ladder's bin;
- ``ffdnet``: ``model(v, noise_level / 255)``;
- ``tdnet``: ``model(v, sigma)`` with the iteration's rung of the sigma
  ladder; ``x8`` averages all eight dihedral transforms (``x8_ensemble``).

Every forward folds the batch axes into N, runs NCHW in the working dtype
(``compute_dtype`` or ``param_dtype``), casts back to v's dtype, and runs
with cuDNN's TF32 off (``full_precision_convs``): torch enables TF32 for
float32 convolutions by default, and the JAX package measured that a
reduced-precision pass costs reconstruction PSNR.
"""

from __future__ import annotations

import contextlib
import functools
import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.models import convert
from pnp_admm_cnc_mri_torch.models.dncnn import DnCNN, FDnCNN, IRCNN
from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
from pnp_admm_cnc_mri_torch.models.ffdnet import FFDNet
from pnp_admm_cnc_mri_torch.models.tdnet import TDNet
from pnp_admm_cnc_mri_torch.ops import schedules
from pnp_admm_cnc_mri_torch.priors import tiling
from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device

# ---------------------------------------------------------------------------
# Dihedral transforms (reference ``utils_image.augment_img_tensor4:333-349``)
# ---------------------------------------------------------------------------


def augment(x: torch.Tensor, mode: int, dims=(-2, -1)) -> torch.Tensor:
    """Dihedral transform ``mode`` (0-7, the reference's numbering) of the
    (H, W) ``dims``. Rotations of a non-square image swap H and W."""
    rot = lambda k: torch.rot90(x, k, dims=dims)  # noqa: E731
    flip_h = lambda a: torch.flip(a, dims=(dims[0],))  # noqa: E731
    if mode == 0:
        return x
    if mode == 1:
        return flip_h(rot(1))
    if mode == 2:
        return flip_h(x)
    if mode == 3:
        return rot(3)
    if mode == 4:
        return flip_h(rot(2))
    if mode == 5:
        return rot(1)
    if mode == 6:
        return rot(2)
    return flip_h(rot(3))


INVERSE_MODE = np.array([0, 1, 2, 5, 4, 3, 6, 7], dtype=np.int32)
"""The inverse of each transform: itself, except 3 <-> 5 (reference
``test_x8`` / ``【3】:47-50``)."""


def x8_cycling(denoise_core: Callable, i: int, v: torch.Tensor, dims=(-2, -1)) -> torch.Tensor:
    """Transform by ``i % 8``, denoise, transform back (reference
    ``【3】:41,47-50``, the DRUNet x8 path)."""
    m = int(i) % 8
    return augment(denoise_core(augment(v, m, dims)), int(INVERSE_MODE[m]), dims)


def x8_ensemble(denoise_core: Callable, v: torch.Tensor, dims=(-2, -1)) -> torch.Tensor:
    """The mean of the 8 dihedral branches (reference ``utils_model.test_x8``)."""
    outs = [augment(denoise_core(augment(v, m, dims)), int(INVERSE_MODE[m]), dims) for m in range(8)]
    return sum(outs) / 8.0


@contextlib.contextmanager
def full_precision_convs():
    """cuDNN convolutions without TF32 inside the block, and the caller's
    setting back after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Weight resolution
# ---------------------------------------------------------------------------

DEFAULT_MODEL_ZOO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "model_zoo"))


def nlm_for_model(model_name: str, nlm255: Optional[float]) -> Optional[float]:
    """A noise level on the reference's [0, 255] scale in ``build_denoiser``'s
    ``noise_level_model`` convention: [0, 1] for the sigma-ladder models
    (ircnn, drunet, tdnet), [0, 255] for ffdnet and fdncnn."""
    if nlm255 is None:
        return None
    name = model_name.lower()
    if "ircnn" in name or "drunet" in name or "tdnet" in name:
        return nlm255 / 255.0
    return float(nlm255)


def resolve_weights(model_name: str, weights: Optional[str] = None, model_zoo: Optional[str] = None,
                    clean: bool = False) -> Optional[str]:
    """The weights file of a model name: an explicit ``weights`` wins, else
    ``<model_zoo>/<model_name>.npz``, then ``.pth`` (the reference's KAIR
    checkpoints); ``_clean`` first with ``clean``, the weights trained
    without the evaluation images, falling back to the plain name with a
    warning. None when nothing is found."""
    if weights is not None:
        return weights
    zoo = model_zoo or DEFAULT_MODEL_ZOO
    for name in ([model_name + "_clean"] if clean else []) + [model_name]:
        for ext in (".npz", ".pth"):
            cand = os.path.join(zoo, name + ext)
            if os.path.exists(cand):
                if clean and name == model_name:
                    warnings.warn(f"no clean weights for {model_name}; falling back to the testset-trained {cand}",
                                  stacklevel=2)
                return cand
    return None


def _tree(weights: Optional[str], params, converter):
    """The Flax tree to load: ``params`` as given, else read from
    ``weights``: a ``.npz`` tree as it is, any other file as a torch
    checkpoint through ``converter`` (``models/convert.py``)."""
    if params is not None or weights is None:
        return params
    if weights.endswith(".npz"):
        return convert.load_npz(weights)
    if converter is None:
        raise ValueError(f"{weights!r}: this model has no torch checkpoint layout; give its .npz tree")
    return converter(convert.load_state_dict(weights))


def _random_init_warning(what: str):
    warnings.warn(
        f"no weights given for {what}: using RANDOM initialization (seeded) — reconstruction quality "
        f"will be meaningless. Pass weights= or place <model>.npz in model_zoo/.",
        stacklevel=4,
    )


def _ready(model, tree, allow_random: bool, param_dtype, work_dtype, device):
    """``model`` with the tree's weights (or seeded random ones) in
    ``param_dtype``, then in ``work_dtype`` on ``device``, frozen."""
    model = model.to(param_dtype)
    if tree is not None:
        model.load_state_dict(convert.state_dict_from_flax(model, tree, param_dtype))
    elif allow_random:
        _random_init_warning(type(model).__name__)
        convert.random_init_(model)
    else:
        raise FileNotFoundError(f"weights required for {type(model).__name__}")
    return model.to(device=device, dtype=work_dtype).eval().requires_grad_(False)


def _as_nchw(v: torch.Tensor, work_dtype):
    """(..., H, W) -> (N, 1, H, W) in ``work_dtype``, and the function that
    restores a network output to v's shape and dtype."""
    batch_shape, (h, w) = v.shape[:-2], v.shape[-2:]
    x = v.reshape(-1, 1, h, w).to(work_dtype)
    return x, lambda y: y[:, 0].to(v.dtype).reshape(*batch_shape, h, w)


def _sigma_ladder(iter_num, noise_level_model, model_sigma1):
    nlm = 15.0 / 255.0 if noise_level_model is None else noise_level_model
    _, sigmas = schedules.get_rho_sigma(sigma=max(0.255 / 255.0, nlm), iter_num=iter_num,
                                        model_sigma1=model_sigma1, model_sigma2=nlm * 255.0)
    return sigmas


# ---------------------------------------------------------------------------
# Adapter construction
# ---------------------------------------------------------------------------


def build_denoiser(
    model_name: str,
    weights: Optional[str] = None,
    iter_num: int = 50,
    noise_level_model: Optional[float] = None,
    model_sigma1: float = 49.0,
    x8: Optional[bool] = None,
    noises: Optional[np.ndarray] = None,
    allow_random_init: bool = True,
    param_dtype=torch.float32,
    nc: int = 64,
    nb: Optional[int] = None,
    params=None,
    compute_dtype=None,
    device=None,
) -> Callable[[torch.Tensor, int], torch.Tensor]:
    """``denoise(v, i)`` for a reference model name, on ``device`` (None:
    the CUDA card; the CPU only when asked for).

    ``weights``: a ``.npz`` Flax tree (``model_zoo/``) or the reference's
    KAIR ``.pth`` checkpoint (dncnn, fdncnn, ffdnet, the ircnn bundle of 25,
    drunet; ``models/convert.py``); ``params``: a Flax tree already loaded
    (nested dicts of arrays under ``"params"``). With neither and
    ``allow_random_init``, the weights are drawn from a ``torch.Generator``
    seeded with 0, with a warning. ``noises``: the
    complex k-space noise, fdncnn's map channel when ``noise_level_model``
    is None. ``noise_level_model`` is on [0, 1] for ircnn, drunet and tdnet
    and on [0, 255] for ffdnet and fdncnn (``nlm_for_model``). ``nc``/``nb``
    override width and depth (tdnet's width is 128 unless ``nc`` is given
    as another value than 64). ``x8`` cycles the dihedral transforms by
    iteration for drunet and averages all eight for tdnet.
    ``compute_dtype`` (e.g. bfloat16) runs the network in that type; the
    output keeps v's dtype. The callable carries its network as ``.model``.
    """
    name = model_name.lower()
    device = resolve_device(device)
    work = compute_dtype or param_dtype

    def ready(model, converter):
        return _ready(model, _tree(weights, params, converter), allow_random_init, param_dtype, work, device)

    if "dncnn" in name and "fdncnn" not in name:
        if nb is None:
            nb = 20 if name in ("dncnn_gray_blind", "dncnn_color_blind", "dncnn3") else 17
        model = ready(DnCNN(1, 1, nc=nc, nb=nb), functools.partial(convert.convert_dncnn, nb=nb))

        def denoise(v, i):
            x, restore = _as_nchw(v, work)
            with full_precision_convs():
                return restore(model(x))

    elif "fdncnn" in name:
        if noise_level_model is not None:
            # a constant sigma map on the [0, 255] scale, as ffdnet's
            noise_map, nlm01 = None, noise_level_model / 255.0
        elif noises is None:
            raise ValueError(
                "fdncnn needs noises= (the complex k-space noise, whose magnitude / 255 is the reference's "
                "map channel) or noise_level_model= (a constant map); the port does not read CS_MRI/noises.mat"
            )
        else:
            noise_map = torch.as_tensor(np.abs(noises) / 255.0, dtype=work, device=device)
        model = ready(FDnCNN(2, 1, nc=nc, nb=nb or 20), functools.partial(convert.convert_fdncnn, nb=nb or 20))

        def denoise(v, i):
            x, restore = _as_nchw(v, work)
            nm = torch.full_like(x, nlm01) if noise_map is None else noise_map.expand_as(x)
            with full_precision_convs():
                return restore(model(torch.cat([x, nm], dim=1)))

    elif "ircnn" in name:
        model = IRCNN(1, 1, nc=nc).to(param_dtype)
        idx = schedules.ircnn_sigma_indices(_sigma_ladder(iter_num, noise_level_model, model_sigma1))
        tree = _tree(weights, params, convert.convert_ircnn_bundle)
        if tree is not None:
            sd = convert.state_dict_from_flax(model, tree, param_dtype, lead=(25,))
        elif allow_random_init:
            _random_init_warning("IRCNN")
            sd = {k: torch.stack([v] * 25) for k, v in convert.random_init_(model).state_dict().items()}
        else:
            raise FileNotFoundError("ircnn weights required")
        model = model.to(device=device, dtype=work).eval().requires_grad_(False)
        stacked = {k: v.to(device=device, dtype=work) for k, v in sd.items()}

        def denoise(v, i):
            x, restore = _as_nchw(v, work)
            k = int(idx[i])
            with full_precision_convs():
                return restore(torch.func.functional_call(model, {n: t[k] for n, t in stacked.items()}, (x,)))

    elif "ffdnet" in name:
        model = ready(FFDNet(1, 1, nc=nc, nb=nb or 15), functools.partial(convert.convert_ffdnet, nb=nb or 15))
        nlm = 15.0 if noise_level_model is None else noise_level_model
        sig = torch.tensor(nlm / 255.0, dtype=work, device=device)

        def denoise(v, i):
            x, restore = _as_nchw(v, work)
            with full_precision_convs():
                return restore(model(x, sig))

    elif "drunet" in name:
        model = ready(UNetRes(2, 1, nc=(nc, nc * 2, nc * 4, nc * 8), nb=nb or 4),
                      functools.partial(convert.convert_drunet, nb=nb or 4))
        sigmas = _sigma_ladder(iter_num, noise_level_model, model_sigma1)

        def core(x, i):
            # the sigma map goes in BEFORE tiling; the reference's mode-2
            # tiler is a plain forward at <= 256 x 256 (【3】:43-44)
            x2 = torch.cat([x, torch.full_like(x, float(sigmas[i]))], dim=1)
            return tiling.quad_split(model, x2, refield=32, min_size=256, modulo=16)

        def denoise(v, i):
            x, restore = _as_nchw(v, work)
            with full_precision_convs():
                if x8:
                    return restore(x8_cycling(lambda a: core(a, i), i, x))
                return restore(core(x, i))

    elif "tdnet" in name:
        # nc keeps its 64 default for the reference models; TDNet's own
        # width applies unless another width is asked for
        model = ready(TDNet(1, 1, nc=nc if nc != 64 else 128, nb=nb or 12), None)
        sigmas = torch.as_tensor(_sigma_ladder(iter_num, noise_level_model, model_sigma1), dtype=work,
                                 device=device)

        def denoise(v, i):
            x, restore = _as_nchw(v, work)
            with full_precision_convs():
                if x8:
                    return restore(x8_ensemble(lambda a: model(a, sigmas[i]), x))
                return restore(model(x, sigmas[i]))

    else:
        raise ValueError(f"unknown denoiser model: {model_name}")

    denoise.model = model
    return denoise


def rescaled_denoiser(residual_denoise: Callable[[torch.Tensor], torch.Tensor],
                      sigma: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """Min-max rescaling around a residual denoiser (reference
    ``utils/utils.py:20-47``, ``Denoisingstep``): map each image to [0, 1],
    scale by ``1 + sigma/255/2`` about 0.5, subtract the predicted noise
    ``residual_denoise(x)``, and undo both maps. A constant image passes
    through unchanged."""
    scale_range = 1.0 + sigma / 255.0 / 2.0
    scale_shift = (1.0 - scale_range) / 2.0

    def denoise(x: torch.Tensor) -> torch.Tensor:
        mn = torch.amin(x, dim=(-2, -1), keepdim=True)
        mx = torch.amax(x, dim=(-2, -1), keepdim=True)
        rng = torch.where(mx > mn, mx - mn, torch.ones_like(mx))
        xt = (x - mn) / rng * scale_range + scale_shift
        out = (xt - residual_denoise(xt) - scale_shift) / scale_range
        return out * rng + mn

    return denoise
