"""Per-iteration (rho, sigma) ladders for denoiser-prior scheduling.

A copy of the JAX package's ``ops/schedules.py`` (reference
``utils/utils_pnp.py:14-23``, KAIR/DPIR): a log-spaced sigma ladder from
``model_sigma1`` (49) down to ``model_sigma2`` with
``rho_i = 0.23 sigma^2 / sigma_i^2``. Used by the DRUNet and IRCNN priors.
"""

from __future__ import annotations

import numpy as np


def get_rho_sigma(
    sigma: float = 2.55 / 255.0,
    iter_num: int = 15,
    model_sigma1: float = 49.0,
    model_sigma2: float = 2.55,
    w: float = 1.0,
):
    """Return ``(rhos, sigmas)`` arrays of length ``iter_num``.

    The ladder goes through float32 (``np.logspace(...).astype(np.float32)``)
    as the reference does, so IRCNN's per-iteration bin indices
    ``ceil(sigma_i*255/2)-1`` agree with it bit for bit.
    """
    model_sigmas = np.logspace(
        np.log10(model_sigma1), np.log10(model_sigma2), iter_num
    ).astype(np.float32)
    model_sigmas_lin = np.linspace(model_sigma1, model_sigma2, iter_num).astype(
        np.float32
    )
    sigmas = (model_sigmas * w + model_sigmas_lin * (1 - w)) / 255.0
    rhos = 0.23 * (sigma**2) / (sigmas.astype(np.float64) ** 2)
    return np.asarray(rhos), sigmas


def ircnn_sigma_indices(sigmas: np.ndarray) -> np.ndarray:
    """IRCNN's 25-way weight-set index of each rung of a sigma ladder
    (reference ``【3】PNP_ADMM_L1_D  .py:281``:
    ``int(ceil(sigma_i * 255 / 2) - 1)``), clipped to [0, 24]."""
    idx = np.ceil(sigmas.astype(np.float64) * 255.0 / 2.0) - 1
    return np.clip(idx.astype(np.int32), 0, 24)
