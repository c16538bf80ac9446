#!/usr/bin/env python3
"""The full-width DRUNet forward against the batch size, on the card.

    python3 probes/drunet_batch_probe.py [BATCH ...]      (default: 1 4 8 12 16)

Builds DRUNet (nc 64..512, nb 4) with seeded weights in float32, as the
sweep's ``--algo pnp_fista_d`` builds it (no x8), and times one forward at
256 x 256 for each batch size (CUDA events, the median of 5 after a warm-up),
with cuDNN's autotuner off (the default) and then on. Prints the card's name
and power limit and one JSON line: ms a forward and ms an image, per batch
and setting.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_admm_cnc_mri_torch.data import phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.priors import denoiser  # noqa: E402


def forward_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("drunet_batch_probe: needs a CUDA card")
    batches = [int(b) for b in sys.argv[1:]] or [1, 4, 8, 12, 16]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded random init warns
        d = denoiser.build_denoiser("drunet_gray", weights=None, iter_num=30)
    x = torch.from_numpy(phantom.mri_phantoms(max(batches), 256, seed=0)).cuda()
    out = {}
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for b in batches:
            v = x[:b].contiguous()
            ms = forward_ms(lambda: d(v, 0))
            out[f"batch{b}_autotune_{'on' if bench else 'off'}"] = {"ms": ms, "ms_per_image": ms / b}
    torch.backends.cudnn.benchmark = False
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
