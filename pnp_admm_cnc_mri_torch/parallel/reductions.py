"""Convergence reductions (port of the JAX package's ``parallel/reductions.py:41-43``)."""

from __future__ import annotations

import torch


def primal_residual_norm(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Per-element ``||x - z||_F`` over the trailing image axes."""
    return torch.sqrt(torch.sum((x - z) ** 2, dim=(-2, -1)))
