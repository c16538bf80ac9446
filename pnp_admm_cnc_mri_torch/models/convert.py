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
