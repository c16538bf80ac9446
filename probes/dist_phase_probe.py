#!/usr/bin/env python3
"""``chip_smoke.py``'s distributed phase alone, on the card.

    python3 probes/dist_phase_probe.py

Builds the tail kernels, makes the smoke's 512 phantoms and writes them
with the masks and ``noises.mat`` to a temporary directory, runs the
one-device sweeps of the 4,608-scenario grid (ADMM-L1 and ADMM-CNC) that
the phase holds its sharded sweeps to, then ``chip_smoke.phase_distributed``
(world 1 on NCCL in this process, worlds 2 and 4 over gloo on this card),
which prints its checks and times. About two minutes on the H100.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    import torch

    from pnp_admm_cnc_mri_torch.cli import sweep
    from pnp_admm_cnc_mri_torch.data import images, masks, noise, phantom
    from pnp_admm_cnc_mri_torch.ops import tail_kernels

    if not torch.cuda.is_available():
        raise SystemExit("dist_phase_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smoke.log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    tail_kernels.load_library()
    img_np = phantom.mri_phantoms(smoke.B, smoke.H, seed=0)
    tmp = tempfile.mkdtemp(prefix="dist_phase_")
    try:
        tdir, ddir = smoke.write_mri_assets(tmp, img_np, (smoke.H, smoke.W))
        images.DEFAULT_TESTSETS = tdir
        masks.DEFAULT_DATA_DIR = noise.DEFAULT_DATA_DIR = ddir
        sweep_res = {"summary": {}}
        for algo in ("admm_l1", "admm_cnc"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                sweep.main(["--algo", algo, "--testset", "phantoms", "--sigmas", ",".join(map(str, smoke.SIGMAS)),
                            "--out", os.path.join(tmp, f"sweep_{algo}.jsonl")])
            sweep_res["summary"][algo] = json.loads(buf.getvalue().strip().splitlines()[-1])
        smoke.log(f"one-device sweeps {json.dumps(sweep_res)}; setup {time.perf_counter() - t0:.1f} s")
        t = time.perf_counter()
        smoke.phase_distributed(dev, tmp, tdir, ddir, img_np, sweep_res)
        smoke.phase("distributed", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
