"""Proximal and shrinkage operators of the classical priors.

Port of the JAX package's ``ops/prox.py:16-70``. ``soft`` is
``max(|x| - c, 0) * sign(x)`` (reference ``ADMM_L1.py:18-19``); the CNC
(GMC) z-update is built from two soft-thresholds and a correction term
(reference ``ADMM_CNC .py:126-129``).
"""

from __future__ import annotations

import torch


def soft(x: torch.Tensor, c) -> torch.Tensor:
    """Soft-threshold ``max(|x| - c, 0) * sign(x)``.

    ``torch.maximum`` propagates NaN (as ``jnp.maximum`` does) and
    ``sign(0) = 0``; the threshold ``c`` broadcasts.
    """
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.maximum(torch.abs(x) - c, zero) * torch.sign(x)


def cnc_update(z: torch.Tensor, v: torch.Tensor, alpha, rho, lam, b) -> torch.Tensor:
    """One CNC (GMC) z-update given ``v = x + w``:

        s = soft(z, 1/b)
        t = (1-alpha) z + alpha v + alpha rho lam b (z - s)
        z = soft(t, alpha rho lam)

    ``b`` is the paper's b^2 and ``rho`` the paper's 1/beta.
    """
    s = soft(z, 1.0 / b)
    t = (1.0 - alpha) * z + alpha * v + alpha * rho * lam * b * (z - s)
    return soft(t, alpha * rho * lam)


def cnc_generalized_update(z, v, s, alpha, rho, lam, b, prox2):
    """CNC scheme with arbitrary operators in the two threshold slots: ``s``
    is the first operator applied to ``z``, ``prox2`` the second (the PnP-CNC
    variants put a denoiser in both)."""
    t = (1.0 - alpha) * z + alpha * v + alpha * rho * lam * b * (z - s)
    return prox2(t)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] (the CNN-prior variants clamp x, z and w each
    iteration; load-bearing for parity)."""
    return torch.clamp(x, 0.0, 1.0)
