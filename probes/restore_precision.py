#!/usr/bin/env python3
"""The restoration pipelines with DRUNet in float32 against float64.

    python3 probes/restore_precision.py [cpu|cuda] [seeded|zoo]
                                        (default: cuda seeded)

Runs ``deblur_batch`` and ``sr_batch`` (x2) on the inputs of ``chip_smoke.py``'s
restore phase (phantoms seed 0, the first 2 of 4 x 256 x 256; noise numpy
seeds 3 and 4) with full-width DRUNet (nc 64..512, nb 4) over 2 iterations
at nlm 2, once in float32 and once in float64, and prints the max absolute
difference of the restored images per pipeline. ``seeded``: the weights drawn
from the seed, as the smoke builds them; ``zoo``: the trained
``model_zoo/drunet_gray.npz``, whose larger gap is why the smoke never reads
the zoo.
"""

from __future__ import annotations

import os
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_admm_cnc_mri_torch.cli import experiments  # noqa: E402
from pnp_admm_cnc_mri_torch.data import phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.priors import denoiser  # noqa: E402

N, ITERS, NLM = 256, 2, 2.0


def drunet(weights: str, dtype, dev):
    """DRUNet at nlm 2 in ``dtype``: seeded, or the zoo's trained weights."""
    path = None
    if weights == "zoo":
        path = denoiser.resolve_weights("drunet_gray")
        if path is None:
            raise FileNotFoundError("model_zoo/drunet_gray.npz is not in this checkout")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the seeded random init warns
        return denoiser.build_denoiser("drunet_gray", iter_num=ITERS, weights=path,
                                       noise_level_model=denoiser.nlm_for_model("drunet_gray", NLM),
                                       param_dtype=dtype, device=dev)


def main() -> None:
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    weights = sys.argv[2] if len(sys.argv) > 2 else "seeded"
    if weights not in ("seeded", "zoo"):
        raise SystemExit(f"weights: seeded or zoo, not {weights!r}")
    x = torch.from_numpy(phantom.mri_phantoms(4, N, seed=0)[:2])
    noise = {"deblur": np.random.default_rng(3).standard_normal((4, N, N)).astype(np.float32)[:2],
             "sr": np.random.default_rng(4).standard_normal((4, N // 2, N // 2)).astype(np.float32)[:2]}
    for name, fn in (("deblur", experiments.deblur_batch), ("sr", experiments.sr_batch)):
        t = time.perf_counter()
        outs = [fn(x, denoise=drunet(weights, dt, dev), iter_num=ITERS, nlm=NLM, noise=noise[name], dtype=dt,
                   device=dev)[1] for dt in (torch.float32, torch.float64)]
        err = float((outs[0].double() - outs[1]).abs().max())
        print(f"{name} on {dev.type}, {weights} weights: float32 vs float64 max abs {err!r} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
