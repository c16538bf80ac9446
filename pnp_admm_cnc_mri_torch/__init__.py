"""PyTorch/CUDA port of ``pnp_admm_cnc_mri_tpu``.

The JAX package beside this one is the reference; this package imports
nothing of it (and no JAX) and keeps its own copy of what it needs. Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``. The fused ADMM tails and the fused ADMM-L1 iteration
run as hand-written CUDA kernels (``csrc/admm_tail.cu``,
``csrc/admm_iteration.cu``, ``csrc/admm_iteration_cluster.cu``, built
with nvcc at first use). The PnP solvers take the CNN denoisers of
``priors/denoiser.py``, whose convolutions run in cuDNN without TF32, or
BM3D (``priors/bm3d/``: white and colored noise, and its API). The DPIR
restoration pipelines (``cli/experiments.py``: PnP deblurring and
super-resolution) run on the SR operators of ``ops/sisr.py`` and
``ops/resize.py``. The MRI experiment runners and the scenario sweep
(``cli/experiments.py``, ``cli/sweep.py``) load testsets, masks and noise
from files (``data/images.py``, ``data/masks.py``), score and log in the
reference's format (``utils/logger.py``), and ``utils/checkpoint.py``
saves and resumes every solver family. ``parallel/`` runs them over
several processes with torch.distributed (one process a device): the
sharded consensus solvers, the spatially split ADMM solve, the sweep
split over the ranks, ``cli/multihost.py`` and the dp x tp trainer.
"""

from pnp_admm_cnc_mri_torch.config import (  # noqa: F401
    ADMM_CNC_DEFAULT,
    ADMM_L1_DEFAULT,
    ADMMConfig,
)
