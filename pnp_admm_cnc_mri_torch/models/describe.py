"""Model and parameter pretty-printers.

Port of the JAX package's ``models/describe.py`` (reference
``utils/utils_model.py:253-275``): over a module's parameters (or a state
dict), printed as the JAX package prints its Flax trees, with the Flax path
names (``params.head.conv.kernel``), in its sorted order, kernels in HWIO.
"""

from __future__ import annotations

import numpy as np

from pnp_admm_cnc_mri_torch.models import convert


def _leaves(module_or_state_dict):
    """(Flax path, array) pairs in the sorted order of the JAX package's tree walk."""
    def walk(tree, prefix):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield ".".join(prefix + (k,)), v

    return list(walk(convert.flax_tree_from_state_dict(module_or_state_dict), ()))


def num_params(module_or_state_dict) -> int:
    """Total number of scalar parameters."""
    return sum(int(a.size) for _, a in _leaves(module_or_state_dict))


def describe_model(module_or_state_dict, name: str = "model") -> str:
    """Name, parameter count and per-leaf shapes (reference ``describe_model``)."""
    msg = "\n"
    msg += f"models name: {name}\n"
    msg += f"Params number: {num_params(module_or_state_dict)}\n"
    msg += "Net structure:\n"
    for path, leaf in _leaves(module_or_state_dict):
        msg += f"  {path}: {tuple(leaf.shape)} {leaf.dtype}\n"
    return msg


def describe_params(module_or_state_dict) -> str:
    """Per-tensor mean/min/max/std table (reference ``describe_params``)."""
    msg = "\n"
    msg += " | {:^6s} | {:^6s} | {:^6s} | {:^6s} || {:<20s}".format("mean", "min", "max", "std", "param_name") + "\n"
    for path, leaf in _leaves(module_or_state_dict):
        v = np.asarray(leaf, np.float32)
        std = v.std(ddof=1) if v.size > 1 else 0.0
        msg += " | {:>6.3f} | {:>6.3f} | {:>6.3f} | {:>6.3f} || {:s}".format(
            float(v.mean()), float(v.min()), float(v.max()), float(std), path) + "\n"
    return msg
