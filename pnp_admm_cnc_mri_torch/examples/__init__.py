"""The six example programs of the port, each run as
``python -m pnp_admm_cnc_mri_torch.examples.<name>``:

- ``mri_reconstruction``: ADMM-L1, ADMM-CNC, FISTA-L1 and PnP with a
  model-zoo denoiser on one undersampled acquisition;
- ``super_resolution``: x sf PnP super-resolution (HQS with the closed-form
  data solution and a CNN prior);
- ``bm3d_grayscale``, ``bm3d_rgb``, ``bm3d_multichannel``,
  ``bm3d_deblurring``: the BM3D demos (colored noise, opponent-color RGB,
  shared matching over channels, deblurring).

Each keeps the flags, defaults and printed lines of the JAX package's
example of the same name, and its ``main(argv)`` returns the printed PSNRs
unrounded. They run on the CUDA card and raise without one; ``--cpu``
runs on the CPU. ``--f64`` computes in float64 (default float32, the JAX
examples' type).
"""

from __future__ import annotations

import argparse
import os

import torch

from pnp_admm_cnc_mri_torch.data import noise
from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device


def add_device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card; raises without one)")
    p.add_argument("--f64", action="store_true", help="compute in float64 (default: float32)")


def device_and_dtype(args: argparse.Namespace) -> tuple[torch.device, torch.dtype]:
    """The device the flags ask for (the card unless ``--cpu``; raises
    without one) and the working dtype."""
    return resolve_device("cpu" if args.cpu else None), (torch.float64 if args.f64 else torch.float32)


def reference_example_file(name: str) -> str:
    """A file of the reference's BM3D examples folder, which lies beside its
    ``CS_MRI`` folder (``PNPADMM_DATA``)."""
    root = os.path.dirname(os.path.normpath(noise.DEFAULT_DATA_DIR))
    return os.path.join(root, "bm3d307", "examples", name)
