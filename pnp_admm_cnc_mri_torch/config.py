"""Solver configuration: a copy of the JAX package's ``config.py:16-72``
restricted to what the classical ADMM slice uses."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Hyper-parameters shared by every ADMM variant.

    ``rho`` is the reference's ``reo`` (= 1/beta of the CNC paper), ``lam``
    the regularization weight ``lambda1``; ``alpha`` and ``b`` (the paper's
    b^2) are CNC-only. ``tol=None`` runs the fixed ``iter_num`` iterations.
    """

    iter_num: int = 50
    rho: float = 0.015
    lam: float = 0.1
    alpha: float = 0.45
    b: float = 64.0
    tol: Optional[float] = None


ADMM_L1_DEFAULT = ADMMConfig(iter_num=50, lam=0.1, rho=0.015)
ADMM_CNC_DEFAULT = ADMMConfig(iter_num=50, lam=0.5, rho=0.05, alpha=0.45, b=64.0)
