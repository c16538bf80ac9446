"""Weights carried across from the JAX package's Flax parameter trees.

The JAX package keeps its trained weights as ``.npz`` files of flattened
Flax trees (``model_zoo/*.npz``; its ``models/convert.py:328-349``): keys
like ``params/body0/conv/kernel``, float16 arrays. This module reads them
with numpy alone and maps a Flax tree (nested dicts of arrays under
``"params"``) onto a port module's ``state_dict``:

- the port's modules carry the Flax modules' names, so the path
  ``a/b/kernel`` is the key ``a.b.weight`` (``bias`` stays ``bias``);
- conv kernels go HWIO -> OIHW, and ``ConvTranspose(transpose_kernel=True)``
  kernels (kH, kW, O, I) -> torch's (I, O, kH, kW): both are the axis
  order (3, 2, 0, 1) of the last four axes;
- leading axes are kept (IRCNN's 25 stacked weight sets);
- arrays are cast to the parameter dtype (the zoo is float16).

A key of the tree that the module lacks, or one the module has that the
tree lacks, raises, as does a shape that does not match.

``save_npz`` runs the map the other way, so weights the port trains load
into the JAX package (its ``convert.load_npz``) and back. ``flax_init_``
draws a module's weights by Flax's default rule, the trainers' start.

The reference's own KAIR ``.pth`` checkpoints come in through the
``convert_*`` functions at the end (the JAX package's converters, BatchNorm
folds included), which give the same Flax tree; ``state_dict_from_flax``
stays the one way weights reach a module.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

_LEAF = {"kernel": "weight", "bias": "bias"}


def load_npz(path: str) -> Dict[str, Any]:
    """A flattened ``.npz`` tree (keys ``a/b/c``) as nested dicts of arrays."""
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        for name in z.files:
            parts = name.split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = z[name]
    return out


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_torch(a: np.ndarray) -> np.ndarray:
    """A Flax conv or transposed-conv kernel (..., kH, kW, A, B) as torch's
    (..., B, A, kH, kW); a bias is unchanged."""
    a = np.asarray(a)
    if a.ndim < 4:
        return a
    lead = tuple(range(a.ndim - 4))
    return a.transpose(*lead, a.ndim - 1, a.ndim - 2, a.ndim - 4, a.ndim - 3)


def state_dict_from_flax(module: nn.Module, variables: Dict[str, Any], dtype=torch.float32,
                         lead: tuple = ()) -> Dict[str, torch.Tensor]:
    """``module``'s state dict from a Flax variables tree ``{"params": ...}``,
    as CPU tensors of ``dtype``. ``lead`` is the shape of leading axes that
    every array carries in front of the module's own (IRCNN's stack: (25,))."""
    if set(variables) != {"params"}:
        raise ValueError(f"expected a Flax tree with the one top key 'params', got {sorted(variables)}")
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    out = {}
    for path, arr in _flatten(variables["params"]):
        if path[-1] not in _LEAF:
            raise ValueError(f"unknown Flax leaf {'/'.join(path)}")
        key = ".".join(path[:-1] + (_LEAF[path[-1]],))
        if key not in want:
            raise ValueError(f"Flax parameter {'/'.join(path)} has no counterpart {key!r} in "
                             f"{type(module).__name__}")
        t = torch.from_numpy(np.array(flax_to_torch(arr))).to(dtype)  # a writable contiguous copy
        if tuple(t.shape) != tuple(lead) + want[key]:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} does not fit {key} "
                             f"{tuple(lead) + want[key]} of {type(module).__name__} (check nc / nb)")
        out[key] = t
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"the Flax tree lacks {missing} of {type(module).__name__}")
    return out


def torch_to_flax(a: np.ndarray) -> np.ndarray:
    """The inverse of ``flax_to_torch``: (..., B, A, kH, kW) -> (..., kH, kW, A, B)."""
    a = np.asarray(a)
    if a.ndim < 4:
        return a
    lead = tuple(range(a.ndim - 4))
    return a.transpose(*lead, a.ndim - 2, a.ndim - 1, a.ndim - 3, a.ndim - 4)


def flax_tree_from_state_dict(state) -> Dict[str, Any]:
    """A module (or its ``state_dict``) as the JAX package's Flax variables
    tree ``{"params": ...}`` of numpy arrays: the key ``a.b.weight`` at the
    path ``a/b/kernel``, kernels back in HWIO, leading axes kept (a stack of
    weight sets stays a stack). The inverse of ``state_dict_from_flax``."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    leaf = {v: k for k, v in _LEAF.items()}
    params: Dict[str, Any] = {}
    for key, t in state.items():
        *path, name = key.split(".")
        if name not in leaf:
            raise ValueError(f"{key}: only conv weights and biases have a Flax counterpart")
        d = params
        for p in path:
            d = d.setdefault(p, {})
        d[leaf[name]] = torch_to_flax(t.detach().cpu().numpy())
    return {"params": params}


def save_npz(module_or_state_dict, path: str) -> None:
    """Write a module's weights as the JAX package's flattened ``.npz``
    (keys ``params/<path>/kernel|bias``, kernels HWIO), in the parameters'
    dtype. The file loads through ``load_npz`` and ``state_dict_from_flax``
    here, and through the JAX package's ``convert.load_npz``."""
    flat = {"/".join(p): np.ascontiguousarray(a) for p, a in _flatten(flax_tree_from_state_dict(module_or_state_dict))}
    np.savez(path, **flat)


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv's parameters by Flax's default rule, in module
    order from ``generator`` (a CPU ``torch.Generator``); returns ``module``.

    Kernels: ``lecun_normal``, a normal truncated to +-2 standard deviations
    and scaled so that the variance is 1 / fan_in, with fan_in counted on
    the Flax kernel (kH kW times its input-feature axis: ``weight.shape[1]``
    for a conv and for a transposed conv alike); biases zero. Draws in
    float32 on the CPU, so every device and dtype gets the same values.
    torch's generator does not replay ``jax.random``: the values differ from
    a Flax init, the distribution is the same."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            with torch.no_grad():
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
    return module


# the standard deviation of a unit normal truncated to [-2, 2] (Flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def random_init_(module: nn.Module) -> nn.Module:
    """Re-draw every conv's parameters from a ``torch.Generator`` seeded with
    0, by torch's default rule (kaiming-uniform with a = sqrt(5), bias
    uniform in +-1/sqrt(fan_in)), in module order; returns ``module``. Draws
    in float32 on the CPU, so every device and parameter dtype gets the same
    values."""
    gen = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=gen)
            with torch.no_grad():
                m.weight.copy_(w)
                if m.bias is not None:
                    bound = 1.0 / math.sqrt(w[0].numel())  # fan_in, as torch counts it
                    m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound, generator=gen))
    return module


# ---------------------------------------------------------------------------
# KAIR / DPIR torch checkpoints -> the Flax tree (the JAX package's
# ``models/convert.py:33-313``). Each converter returns the same
# ``{"params": ...}`` numpy tree as the JAX function of its name;
# ``state_dict_from_flax`` maps it onto the port's module. Torch Sequential
# key layouts (reference checkpoints, ``model_zoo/README.md``):
# - DnCNN / FDnCNN / FFDNet (act 'R'): ``model.{2i}.weight``, convs at even
#   slots; IRCNN: 7 convs at ``model.{0,2,...,12}``, a bundle of 25 sets
#   under the keys "0".."24";
# - DRUNet: ``m_head|m_tail.weight``, ``m_down{k}.{i}.res.{0,2}.weight``
#   for i < nb and ``m_down{k}.{nb}.weight`` the downsampler,
#   ``m_up{k}.0.weight`` the transposed conv, then ResBlocks at 1..nb,
#   ``m_body.{i}.res.{0,2}.weight``.
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    """A torch tensor or an array as a numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def conv_w(t) -> np.ndarray:
    """torch Conv2d OIHW -> Flax HWIO."""
    return _np(t).transpose(2, 3, 1, 0)


def convt_w(t) -> np.ndarray:
    """torch ConvTranspose2d (I, O, kH, kW) -> Flax (kH, kW, O, I) of
    ``ConvTranspose(transpose_kernel=True)``."""
    return _np(t).transpose(2, 3, 1, 0)


def load_state_dict(path: str) -> Dict[str, Any]:
    """A ``.pth`` checkpoint (``torch.load(weights_only=True)``, so no code
    in the file runs) or a flat ``.npz``, as a dict of tensors or arrays."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return torch.load(path, map_location="cpu", weights_only=True)


def _seq_conv_params(sd: Dict[str, Any], nb: int, prefix: str = "model") -> Dict[str, Any]:
    """The DnCNN / FDnCNN / FFDNet trunk: nb convs at even Sequential slots."""

    def entry(i):
        return {"conv": {"kernel": conv_w(sd[f"{prefix}.{2 * i}.weight"]),
                         "bias": _np(sd[f"{prefix}.{2 * i}.bias"])}}

    params: Dict[str, Any] = {"head": entry(0)}
    for i in range(nb - 2):
        params[f"body{i}"] = entry(i + 1)
    params["tail"] = entry(nb - 1)
    return params


def convert_dncnn(sd: Dict[str, Any], nb: int = 17) -> Dict[str, Any]:
    return {"params": _seq_conv_params(sd, nb)}


def convert_fdncnn(sd: Dict[str, Any], nb: int = 20) -> Dict[str, Any]:
    return {"params": _seq_conv_params(sd, nb)}


def convert_ffdnet(sd: Dict[str, Any], nb: int = 15) -> Dict[str, Any]:
    return {"params": _seq_conv_params(sd, nb)}


def convert_ircnn(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {"params": {f"layer{i}": {"conv": {"kernel": conv_w(sd[f"model.{2 * i}.weight"]),
                                              "bias": _np(sd[f"model.{2 * i}.bias"])}}
                       for i in range(7)}}


def _stack_trees(trees):
    """Nested dicts of arrays stacked leaf by leaf along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def convert_ircnn_bundle(bundle: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The 25 IRCNN state dicts of the reference's bundle (keys "0".."24",
    one a noise bin) as one tree with a leading axis of 25."""
    return _stack_trees([convert_ircnn(bundle[str(i)]) for i in range(25)])


def convert_drunet(sd: Dict[str, Any], nb: int = 4) -> Dict[str, Any]:
    params: Dict[str, Any] = {"head": {"kernel": conv_w(sd["m_head.weight"])},
                              "tail": {"kernel": conv_w(sd["m_tail.weight"])}}

    def resblock(prefix):
        return {"conv1": {"kernel": conv_w(sd[f"{prefix}.res.0.weight"])},
                "conv2": {"kernel": conv_w(sd[f"{prefix}.res.2.weight"])}}

    for lvl in range(3):
        t = f"m_down{lvl + 1}"
        for i in range(nb):
            params[f"down{lvl}_res{i}"] = resblock(f"{t}.{i}")
        params[f"down{lvl}_ds"] = {"conv": {"kernel": conv_w(sd[f"{t}.{nb}.weight"])}}
    for i in range(nb):
        params[f"body_res{i}"] = resblock(f"m_body.{i}")
    for lvl in range(3):
        t = f"m_up{lvl + 1}"
        params[f"up{lvl}_us"] = {"conv": {"kernel": convt_w(sd[f"{t}.0.weight"])}}
        for i in range(nb):
            params[f"up{lvl}_res{i}"] = resblock(f"{t}.{i + 1}")
    return {"params": params}


def _fold_bn(kernel: np.ndarray, bias, sd: Dict[str, Any], prefix: str, out_axis: int = 3,
             eps: float = 1e-4) -> tuple:
    """Fold an eval-mode BatchNorm2d (reference ``basicblock.conv:72``: eps
    1e-4, affine) at ``prefix`` into the preceding conv:
    ``w' = w g / sqrt(v + eps)`` along the output-channel axis (3 for a conv,
    2 for a transposed conv), ``b' = (b - mean) g / sqrt(v + eps) + beta``."""
    gamma, beta = _np(sd[f"{prefix}.weight"]), _np(sd[f"{prefix}.bias"])
    mean, var = _np(sd[f"{prefix}.running_mean"]), _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    shape = [1, 1, 1, 1]
    shape[out_axis] = -1
    bias = np.zeros_like(mean) if bias is None else np.asarray(bias)
    return kernel * scale.reshape(shape), (bias - mean) * scale + beta


def _centry(sd: Dict[str, Any], key: str, bias: bool = True, bn: str | None = None,
            transpose: bool = False) -> Dict[str, Any]:
    """One Flax conv entry from ``<key>.weight`` (and ``.bias``), with the
    BatchNorm at ``bn`` folded in."""
    w = (convt_w if transpose else conv_w)(sd[f"{key}.weight"])
    b = _np(sd[f"{key}.bias"]) if bias else None
    if bn is not None:
        w, b = _fold_bn(w, b, sd, bn, out_axis=2 if transpose else 3)
    return {"kernel": w} if b is None else {"kernel": w, "bias": b}


def convert_unet(sd: Dict[str, Any], nb: int = 2) -> Dict[str, Any]:
    """Reference ``UNet`` (``network_unet.py:16-74``): flattened Sequential
    stages, convs at even slots ('CR' pairs), the samplers at a stage's end
    (down) or start (up)."""
    p: Dict[str, Any] = {"head": _centry(sd, "m_head.0"), "tail": _centry(sd, "m_tail")}
    for lvl in range(3):
        t = f"m_down{lvl + 1}"
        for i in range(nb):
            p[f"down{lvl}_conv{i}"] = _centry(sd, f"{t}.{2 * i}")
        p[f"down{lvl}_ds"] = {"conv": _centry(sd, f"{t}.{2 * nb}")}
    for i in range(nb + 1):
        p[f"body_conv{i}"] = _centry(sd, f"m_body.{2 * i}")
    for lvl in range(3):
        t = f"m_up{lvl + 1}"
        p[f"up{lvl}_us"] = {"conv": _centry(sd, f"{t}.0", transpose=True)}
        for i in range(nb):
            p[f"up{lvl}_conv{i}"] = _centry(sd, f"{t}.{2 * (i + 1)}")
    return {"params": p}


def _imd_entry(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """A bias-free IMDBlock (reference ``basicblock.IMDBlock:248-259``):
    conv1-3 are 'CL' Sequentials, conv4 and conv1x1 bare convs."""
    return {**{f"conv{i}": _centry(sd, f"{prefix}.conv{i}.0", bias=False) for i in (1, 2, 3)},
            "conv4": _centry(sd, f"{prefix}.conv4", bias=False),
            "conv1x1": _centry(sd, f"{prefix}.conv1x1", bias=False)}


def convert_resunet(sd: Dict[str, Any], nb: int = 4) -> Dict[str, Any]:
    """Reference ``ResUNet`` (``network_unet.py:139-204``)."""
    p: Dict[str, Any] = {"head": _centry(sd, "m_head", bias=False), "tail": _centry(sd, "m_tail", bias=False)}
    for lvl in range(3):
        t = f"m_down{lvl + 1}"
        for i in range(nb):
            p[f"down{lvl}_imd{i}"] = _imd_entry(sd, f"{t}.{i}")
        p[f"down{lvl}_ds"] = {"conv": _centry(sd, f"{t}.{nb}", bias=False)}
    for i in range(nb):
        p[f"body_imd{i}"] = _imd_entry(sd, f"m_body.{i}")
    for lvl in range(3):
        t = f"m_up{lvl + 1}"
        p[f"up{lvl}_us"] = {"conv": _centry(sd, f"{t}.0", bias=False, transpose=True)}
        for i in range(nb):
            p[f"up{lvl}_imd{i}"] = _imd_entry(sd, f"{t}.{i + 1}")
    return {"params": p}


def convert_unet_res_subp(sd: Dict[str, Any], nb: int = 2) -> Dict[str, Any]:
    """Reference ``UNetResSubP`` (``network_unet.py:207-265``): biased
    ResBlocks; the downsampler at slot nb, the upsampler at slot 0 and the
    up stage's blocks from slot 2."""

    def res(prefix):
        return {"conv1": _centry(sd, f"{prefix}.res.0"), "conv2": _centry(sd, f"{prefix}.res.2")}

    p: Dict[str, Any] = {"head": _centry(sd, "m_head.0"), "tail": _centry(sd, "m_tail", bias=False)}
    for lvl in range(3):
        t = f"m_down{lvl + 1}"
        for i in range(nb):
            p[f"down{lvl}_res{i}"] = res(f"{t}.{i}")
        p[f"down{lvl}_ds"] = {"conv": _centry(sd, f"{t}.{nb}")}
    for i in range(nb + 1):
        p[f"body_res{i}"] = res(f"m_body.{i}")
    for lvl in range(3):
        t = f"m_up{lvl + 1}"
        p[f"up{lvl}_us"] = {"conv": _centry(sd, f"{t}.0", transpose=True)}
        for i in range(nb):
            p[f"up{lvl}_res{i}"] = res(f"{t}.{i + 2}")
    return {"params": p}


def convert_unet_plus(sd: Dict[str, Any], nb: int = 1) -> Dict[str, Any]:
    """Reference ``UNetPlus`` with act_mode 'BR' (the only one its
    ``act_mode[1]`` indexing takes, ``network_unet.py:292-316``); every
    'CBR' BatchNorm folded into its conv."""
    p: Dict[str, Any] = {"head": _centry(sd, "m_head"), "tail": _centry(sd, "m_tail")}
    for lvl in range(3):
        t = f"m_down{lvl + 1}"
        for i in range(nb):
            p[f"down{lvl}_conv{i}"] = _centry(sd, f"{t}.{3 * i}", bn=f"{t}.{3 * i + 1}")
        p[f"down{lvl}_ds"] = {"conv": _centry(sd, f"{t}.{3 * nb}")}
    for i in range(nb + 1):
        p[f"body_conv{i}"] = _centry(sd, f"m_body.{3 * i}", bn=f"m_body.{3 * i + 1}")
    for lvl in range(3):
        t = f"m_up{lvl + 1}"
        p[f"up{lvl}_us"] = {"conv": _centry(sd, f"{t}.0", bn=f"{t}.1", transpose=True)}
        for i in range(nb - 1):
            p[f"up{lvl}_conv{i}"] = _centry(sd, f"{t}.{3 * (i + 1)}", bn=f"{t}.{3 * (i + 1) + 1}")
        p[f"up{lvl}_conv{nb - 1}"] = _centry(sd, f"{t}.{3 * nb}")
    return {"params": p}


def convert_nonlocal_unet(sd: Dict[str, Any], nb: int = 1) -> Dict[str, Any]:
    """Reference ``NonLocalUNet`` (``network_unet.py:342-394``): the
    non-local blocks at slot 0 of m_down3 and the last slot of m_up3, their
    W conv's BatchNorm ('CB') folded."""

    def nonlocal_entry(prefix):
        return {"theta": _centry(sd, f"{prefix}.theta"), "phi": _centry(sd, f"{prefix}.phi"),
                "g": _centry(sd, f"{prefix}.g"), "w": _centry(sd, f"{prefix}.W.0", bn=f"{prefix}.W.1")}

    p: Dict[str, Any] = {"head": _centry(sd, "m_head.0"), "tail": _centry(sd, "m_tail")}
    for lvl in range(3):
        t = f"m_down{lvl + 1}"
        off = 1 if lvl == 2 else 0
        if lvl == 2:
            p["down_nonlocal"] = nonlocal_entry(f"{t}.0")
        for i in range(nb):
            p[f"down{lvl}_conv{i}"] = _centry(sd, f"{t}.{off + 2 * i}")
        p[f"down{lvl}_ds"] = {"conv": _centry(sd, f"{t}.{off + 2 * nb}")}
    for i in range(nb + 1):
        p[f"body_conv{i}"] = _centry(sd, f"m_body.{2 * i}")
    for lvl in range(3):
        t = f"m_up{lvl + 1}"
        p[f"up{lvl}_us"] = {"conv": _centry(sd, f"{t}.0", transpose=True)}
        for i in range(nb):
            p[f"up{lvl}_conv{i}"] = _centry(sd, f"{t}.{2 * (i + 1)}")
        if lvl == 2:
            p["up_nonlocal"] = nonlocal_entry(f"{t}.{2 * (nb + 1)}")
    return {"params": p}


CONVERTERS = {
    "dncnn": convert_dncnn,
    "fdncnn": convert_fdncnn,
    "ffdnet": convert_ffdnet,
    "ircnn": convert_ircnn,
    "ircnn_bundle": convert_ircnn_bundle,
    "drunet": convert_drunet,
    "unet": convert_unet,
    "resunet": convert_resunet,
    "unet_res_subp": convert_unet_res_subp,
    "unet_plus": convert_unet_plus,
    "nonlocal_unet": convert_nonlocal_unet,
}
