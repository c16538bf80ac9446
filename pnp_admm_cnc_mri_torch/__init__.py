"""PyTorch/CUDA port of ``pnp_admm_cnc_mri_tpu``.

The JAX package beside this one is the reference; this package imports
nothing of it (and no JAX) and keeps its own copy of what it needs. Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``. The fused ADMM tails and the fused ADMM-L1 iteration
run as hand-written CUDA kernels (``csrc/admm_tail.cu``,
``csrc/admm_iteration.cu``, built with nvcc at first use).
"""

from pnp_admm_cnc_mri_torch.config import (  # noqa: F401
    ADMM_CNC_DEFAULT,
    ADMM_L1_DEFAULT,
    ADMMConfig,
)
