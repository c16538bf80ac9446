"""Solver configuration: a copy of the JAX package's ``config.py:16-331``:
ADMM (classical and PnP, with the CNN and BM3D
priors), FISTA and PGD, HQS, RED, consensus, and the DPIR
restoration pipelines (PnP super-resolution and deblurring,
``cli/experiments.py``) with their blur kernels and model names."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """Configuration of a learned denoiser prior (reference 【3】/【6】)."""

    model_name: str = "dncnn_25"
    noise_level_model: float = 15.0  # on the [0,255] scale
    x8: bool = False  # dihedral self-ensemble
    # sigma ladder (DRUNet / IRCNN), reference ``utils/utils_pnp.py:14-23``
    model_sigma1: float = 49.0
    model_sigma2: Optional[float] = None  # default: noise_level_model


# Reference per-model defaults for PnP-ADMM-L1-D (reference
# ``【3】PNP_ADMM_L1_D  .py:339-348``): (iter_num, rho)
PNP_L1_DEFAULTS = {
    "fdncnn_gray": (50, 0.25),
    "dncnn_15": (50, 0.15),
    "dncnn_25": (50, 0.15),
    "dncnn_50": (50, 0.15),
    "ffdnet_gray": (50, 0.25),
    "ircnn_gray": (50, 0.145),
    "drunet_gray": (50, 0.26),
}

# Reference per-model defaults for PnP-ADMM-CNC-D (reference
# ``【6】PNP_ADMM_CNC_D .py:569-578``): (alpha, iter_num, lam, rho, b)
PNP_CNC_DEFAULTS = {
    "fdncnn_gray": (0.9, 50, 0.2, 0.45, 0.3),
    "dncnn_pair": (1.2, 50, 4.0, 0.45, 0.3),
    "ffdnet_gray": (0.9, 50, 1.35, 0.45, 0.3),
    "ircnn_gray": (0.5, 50, 1.3, 0.45, 2.0),
    "drunet_gray": (1.0, 50, 0.8, 0.8, 0.45),
}

# Classical defaults (reference ``【1】ADMM_L1.py:171``, ``【4】ADMM_CNC .py:176``,
# ``【2】PNP_ADMM_L1_BM3D .py:174``, ``【5】PNP_ADMM_CNC_BM3D .py:183``).
ADMM_L1_DEFAULT = ADMMConfig(iter_num=50, lam=0.1, rho=0.015)
ADMM_CNC_DEFAULT = ADMMConfig(iter_num=50, lam=0.5, rho=0.05, alpha=0.45, b=64.0)
PNP_L1_BM3D_DEFAULT = ADMMConfig(iter_num=50, rho=0.8)
PNP_CNC_BM3D_DEFAULT = ADMMConfig(iter_num=50, lam=0.02, rho=0.6, alpha=1.2, b=36.0)

# Tuned settings found by sweep against the self-trained zoo weights
# (the JAX package's docs/USAGE.md): ADMMConfig overrides plus the denoiser
# knobs ``nlm`` ([0,255] scale) and ``x8``.
TUNED_PNP_L1 = {
    "dncnn_15": dict(iter_num=4, rho=1.0),
    "dncnn_25": dict(iter_num=4, rho=1.2),
    "dncnn_50": dict(iter_num=4, rho=3.0),
    "fdncnn_gray": dict(iter_num=4, rho=0.8, nlm=12.0),
    "ffdnet_gray": dict(iter_num=4, rho=0.8, nlm=12.0),
    "ircnn_gray": dict(iter_num=15, rho=0.65, nlm=8.0),
    "drunet_gray": dict(iter_num=4, rho=0.45, nlm=5.0, x8=False),
}
TUNED_PNP_CNC = {
    "fdncnn_gray": dict(iter_num=4, alpha=1.6, nlm=12.0),
    "ffdnet_gray": dict(iter_num=4, alpha=1.8),
    "ircnn_gray": dict(iter_num=6, alpha=1.0, nlm=8.0),
    "drunet_gray": dict(iter_num=4, alpha=1.8),
    "dncnn_pair": dict(iter_num=5, alpha=0.7),
}
# The BM3D pipelines: ADMMConfig overrides of PNP_*_BM3D_DEFAULT, and ``nlm``,
# the BM3D sigma on the [0, 255] scale (``noise_var = (nlm / 255)^2``).
TUNED_BM3D = {
    "pnp_l1_bm3d": dict(iter_num=3, rho=1.0, nlm=15.0),
    "pnp_cnc_bm3d": dict(iter_num=4, alpha=1.6, nlm=25.0),
}

# Multi-mask consensus-ADMM with a denoiser z-prox (parallel/consensus.py).
TUNED_CONSENSUS_D = {
    "drunet_gray": dict(iter_num=4, rho=1.2),
    "ffdnet_gray": dict(iter_num=4, rho=1.8, nlm=12.0),
    "fdncnn_gray": dict(iter_num=4, rho=2.4, nlm=12.0),
    "ircnn_gray": dict(iter_num=4, rho=1.2),
    "dncnn_25": dict(iter_num=4, rho=3.0),
}

# PnP-FISTA (solvers/fista.py): step 1, the data term's Lipschitz constant.
TUNED_FISTA_D = {
    "drunet_gray": dict(iter_num=30, nlm=12.0, model_sigma1=15.0, x8=True),
    "tdnet": dict(iter_num=30, nlm=10.0, model_sigma1=15.0, x8=True),
    "ffdnet_gray": dict(iter_num=30, nlm=11.0),
    "fdncnn_gray": dict(iter_num=30, nlm=10.0),
    "ircnn_gray": dict(iter_num=30, nlm=12.0),
    "dncnn_25": dict(iter_num=30),
    "bm3d": dict(iter_num=10, nlm=15.0),
}

# PnP-HQS (solvers/hqs.py): nlm is the ladder's endpoint (model_sigma2),
# sigma255 the scale of the alpha ladder.
TUNED_HQS_D = {
    "drunet_gray": dict(iter_num=30, nlm=8.0, sigma255=10.0, x8=True),
    "tdnet": dict(iter_num=30, nlm=8.0, sigma255=10.0, x8=True),
    "ffdnet_gray": dict(iter_num=30, nlm=10.0, sigma255=5.0),
    "fdncnn_gray": dict(iter_num=30, nlm=10.0, sigma255=5.0),
    "ircnn_gray": dict(iter_num=30, nlm=8.0, sigma255=5.0),
    "dncnn_25": dict(iter_num=10, sigma255=1.0),
    "bm3d": dict(iter_num=10, nlm=10.0, sigma255=10.0),
}

# RED (solvers/red.py, fixed-point variant): nlm is a constant denoiser
# sigma, so the ladder is flattened with model_sigma1 = nlm.
TUNED_RED_D = {
    "drunet_gray": dict(iter_num=50, lam=0.3, nlm=8.0),
    "tdnet": dict(iter_num=50, lam=0.3, nlm=20.0),
    "ffdnet_gray": dict(iter_num=50, lam=0.3, nlm=10.0),
    "fdncnn_gray": dict(iter_num=50, lam=0.3, nlm=10.0),
    "ircnn_gray": dict(iter_num=50, lam=0.3, nlm=10.0),
    "dncnn_25": dict(iter_num=50, lam=0.3),
    "bm3d": dict(iter_num=20, lam=0.3, nlm=15.0),
}

# Multi-mask consensus-FISTA (parallel/consensus.run_consensus_fista).
TUNED_CONSENSUS_FISTA = {
    "drunet_gray": dict(iter_num=30, nlm=12.0, model_sigma1=15.0, x8=True),
    "tdnet": dict(iter_num=30, nlm=12.0, model_sigma1=15.0, x8=True),
    "ircnn_gray": dict(iter_num=30, nlm=12.0),
    "fdncnn_gray": dict(iter_num=30, nlm=12.0),
    "ffdnet_gray": dict(iter_num=30, nlm=13.0),
    "dncnn_25": dict(iter_num=30),
    "bm3d": dict(iter_num=10, nlm=15.0),
}

# Multi-mask consensus-HQS (parallel/consensus.run_consensus_hqs); keys as
# TUNED_HQS_D.
TUNED_CONSENSUS_HQS = {
    "drunet_gray": dict(iter_num=30, nlm=8.0, sigma255=10.0, x8=True),
    "ffdnet_gray": dict(iter_num=30, nlm=10.0, sigma255=5.0),
    "fdncnn_gray": dict(iter_num=30, nlm=10.0, sigma255=5.0),
    "ircnn_gray": dict(iter_num=30, nlm=8.0, sigma255=5.0),
    "dncnn_25": dict(iter_num=10, sigma255=1.0),
    "bm3d": dict(iter_num=10, nlm=10.0, sigma255=10.0),
}

# PGD / ISTA (momentum-off FISTA, solvers/fista.py).
TUNED_PGD_L1 = dict(iter_num=100, lam=4e-4, step=1.0)
TUNED_PGD_D = {
    "drunet_gray": dict(iter_num=30, nlm=12.0, model_sigma1=15.0, x8=True),
    "tdnet": dict(iter_num=40, nlm=10.0, model_sigma1=15.0, x8=True),
    "ffdnet_gray": dict(iter_num=40, nlm=11.0),
    "fdncnn_gray": dict(iter_num=40, nlm=10.0),
    "ircnn_gray": dict(iter_num=40, nlm=12.0),
    "dncnn_25": dict(iter_num=40),
    "bm3d": dict(iter_num=15, nlm=15.0),
}
# PGD with the CNC (GMC) double-denoiser prox (solvers/fista.pnp_pgd_cnc).
TUNED_PGD_CNC = {
    "bm3d": dict(iter_num=10, alpha=1.0, lam=0.02, b=36.0, nlm=25.0),
    "drunet_gray": dict(iter_num=30, alpha=1.0, lam=0.001, b=36.0, nlm=12.0, model_sigma1=15.0),
    "tdnet": dict(iter_num=30, alpha=1.0, lam=0.001, b=36.0, nlm=10.0, model_sigma1=15.0),
    "ffdnet_gray": dict(iter_num=30, alpha=1.0, lam=0.001, b=36.0, nlm=11.0),
    "fdncnn_gray": dict(iter_num=30, alpha=1.0, lam=0.001, b=36.0, nlm=10.0),
    "ircnn_gray": dict(iter_num=30, alpha=1.0, lam=0.001, b=36.0, nlm=12.0),
    "dncnn_25": dict(iter_num=30, alpha=1.0, lam=0.001, b=36.0),
}

# Settings for the weights trained without the evaluation images
# (model_zoo/<name>_clean.npz), which the CLI's --clean --tuned selects;
# entries absent here fall back to the TUNED_* tables above.
TUNED_PNP_L1_CLEAN: dict = {
    "dncnn_15": dict(iter_num=4, rho=1.0),
    "dncnn_25": dict(iter_num=4, rho=1.5),
    "dncnn_50": dict(iter_num=4, rho=4.0),
    "fdncnn_gray": dict(iter_num=8, rho=0.5, nlm=8.0),
    "ffdnet_gray": dict(iter_num=10, rho=0.5, nlm=8.0),
    "ircnn_gray": dict(iter_num=24, rho=0.45, nlm=5.0),
    "drunet_gray": dict(iter_num=50, rho=0.5, nlm=8.0, x8=False),
}
TUNED_PNP_CNC_CLEAN: dict = {
    "drunet_gray": dict(iter_num=4, alpha=1.4, nlm=8.0),
    "ffdnet_gray": dict(iter_num=8, alpha=1.4, nlm=12.0),
    "fdncnn_gray": dict(iter_num=8, alpha=1.0, nlm=8.0),
    "ircnn_gray": dict(iter_num=10, alpha=0.7, nlm=5.0),
    "dncnn_pair": dict(iter_num=6, alpha=0.5),
}

# Consensus-ADMM settings for the weights trained without the evaluation
# images (model_zoo/<name>_clean.npz).
TUNED_CONSENSUS_D_CLEAN: dict = {
    "ffdnet_gray": dict(iter_num=4, rho=1.8, nlm=12.0),
    "fdncnn_gray": dict(iter_num=4, rho=1.8, nlm=12.0),
    "ircnn_gray": dict(iter_num=4, rho=0.8, nlm=8.0),
    "dncnn_25": dict(iter_num=4, rho=3.0),
    "drunet_gray": dict(iter_num=4, rho=0.8, nlm=8.0),
}

# DPIR-style restoration pipelines (pnp_sr / pnp_deblur): per-model tuned
# (iter_num, nlm[, model_sigma1]) swept on set1 by the JAX package. The conditioned models (ffdnet/fdncnn) need a LOW
# sigma-ladder start on deblurring: the default model_sigma1=49 start
# over-smooths past what the weak deblur data term can recover
# (measured 19-20 dB at 49 vs ~32 dB at 10).
TUNED_SR: dict = {
    "drunet_gray": dict(iter_num=8, nlm=2.0),             # 35.07
    "ffdnet_gray": dict(iter_num=8, nlm=8.0),             # 32.08
    "fdncnn_gray": dict(iter_num=12, nlm=8.0),            # 32.29
    "ircnn_gray": dict(iter_num=12, nlm=2.0),             # 32.38
    "dncnn_25": dict(iter_num=8, nlm=8.0),                # 29.91
}
TUNED_DEBLUR: dict = {
    "drunet_gray": dict(iter_num=8, nlm=2.0),             # 35.13
    "ffdnet_gray": dict(iter_num=8, nlm=8.0, model_sigma1=10.0),  # 32.28
    "fdncnn_gray": dict(iter_num=12, nlm=8.0, model_sigma1=10.0),  # 32.37
    "ircnn_gray": dict(iter_num=12, nlm=2.0),             # 32.51
    "dncnn_25": dict(iter_num=8, nlm=8.0),                # 29.97
}
TUNED_SR_CLEAN: dict = {
    "drunet_gray": dict(iter_num=12, nlm=4.0),            # 32.44
    "ffdnet_gray": dict(iter_num=8, nlm=8.0),             # 31.91
    "fdncnn_gray": dict(iter_num=8, nlm=8.0),             # 31.96
    "ircnn_gray": dict(iter_num=12, nlm=2.0),             # 32.24
    "dncnn_25": dict(iter_num=8, nlm=8.0),                # 29.24
}
TUNED_DEBLUR_CLEAN: dict = {
    "drunet_gray": dict(iter_num=12, nlm=4.0),            # 32.54
    "ffdnet_gray": dict(iter_num=8, nlm=8.0, model_sigma1=10.0),  # 31.99
    "fdncnn_gray": dict(iter_num=8, nlm=8.0, model_sigma1=10.0),  # 32.04
    "ircnn_gray": dict(iter_num=12, nlm=2.0),             # 32.35
    "dncnn_25": dict(iter_num=8, nlm=8.0),                # 29.30
}

# The reference's three sampling masks (data/masks.MASK_FILES), in the order
# of the scenario sweep's grid (cli/sweep.py --masks all).
MASK_NAMES: Tuple[str, ...] = ("Q_Random30", "Q_Radial30", "Q_Cartesian30")

# The named blur kernels of the deblurring pipeline
# (cli/experiments.make_blur_kernel), and the model-zoo names.
DEBLUR_KERNELS: Tuple[str, ...] = ("aniso", "gauss", "box")
MODEL_NAMES: Tuple[str, ...] = (
    "fdncnn_gray",
    "drunet_gray",
    "ircnn_gray",
    "ffdnet_gray",
    "dncnn_15",
    "dncnn_25",
    "dncnn_50",
)
