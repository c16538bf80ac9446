"""Carrying state across from the JAX package, as plain Python and numpy.

What crosses here is the solver configuration (``dataclasses.asdict`` of
the JAX ``ADMMConfig``) and an ``ADMMState`` given as numpy arrays; the
denoisers' learned weights cross through ``models/convert.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.solvers.admm import ADMMState, resolve_device


def config_from_jax(cfg_fields: dict) -> ADMMConfig:
    """``ADMMConfig`` from the JAX config's fields; unknown fields raise."""
    known = {f.name for f in dataclasses.fields(ADMMConfig)}
    unknown = set(cfg_fields) - known
    if unknown:
        raise ValueError(f"unknown ADMMConfig fields: {sorted(unknown)}")
    return ADMMConfig(**cfg_fields)


def state_from_numpy(x, z, w, device=None) -> ADMMState:
    """``ADMMState`` on ``device`` (None: the CUDA card) from numpy arrays,
    keeping their dtype."""
    device = resolve_device(device)
    return ADMMState(*(torch.from_numpy(np.array(a)).to(device) for a in (x, z, w)))
