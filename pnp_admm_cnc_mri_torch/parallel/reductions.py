"""Convergence and metric reductions over the mesh (port of the JAX package's
``parallel/reductions.py``).

Where JAX's ``pmean``/``psum`` run inside ``shard_map``, these take the
mesh (``parallel/mesh.py``) and reduce over one of its axes, ``data`` by
default. On the 1 x 1 mesh they are the local values.
"""

from __future__ import annotations

import torch

from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib


def global_mean(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The mean over ``axis`` of per-shard values (``pmean``: the sum over the
    shards divided by their number)."""
    return mesh_lib.all_reduce(x, mesh, axis) / mesh.shape[axis]


def global_sum(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    return mesh_lib.all_reduce(x, mesh, axis)


def converged_fraction(residuals: torch.Tensor, tol: float, mesh, axis: str = "data") -> torch.Tensor:
    """The share of batch elements with residual below ``tol`` over all
    shards: the summed counts over the summed sizes, float32 as in JAX.
    ``residuals``: this shard's per-element residual norms, (B_local,)."""
    counts = torch.stack([torch.sum(residuals < tol), torch.tensor(residuals.numel(), device=residuals.device)])
    total, n = global_sum(counts.to(torch.float32), mesh, axis)
    return total / n


def primal_residual_norm(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Per-element ``||x - z||_F`` over the trailing image axes."""
    return torch.sqrt(torch.sum((x - z) ** 2, dim=(-2, -1)))
