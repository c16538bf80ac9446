#!/usr/bin/env python3
"""Where the time of one BM3D call goes, on one CUDA card.

    python3 probes/bm3d_probe.py

At the bm3d phase's scale of ``chip_smoke.py`` (4 x 256 x 256 float32,
phantoms seed 0 with white noise of sigma sqrt(0.03), profile 'np', both
stages, no prefilter), times each step of each stage alone (CUDA-event
medians, inputs precomputed): the 2-D transform of every block, the block
distances, the top-k (the stable sort), the rest of the matching (group
sizes and positions), the group gather, the Haar-tree stack filter, the
inverse 2-D transform and the aggregation, beside the whole stage. Then
traces one call with ``torch.profiler`` and prints the device time by
kernel and the device's busy share of the window. Needs a CUDA card;
builds nothing.
"""

from __future__ import annotations

import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_admm_cnc_mri_torch.data import phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.ops.fourier import full_precision_matmul  # noqa: E402
from pnp_admm_cnc_mri_torch.priors.bm3d import core, transforms  # noqa: E402
from pnp_admm_cnc_mri_torch.solvers.fista import host_scalar  # noqa: E402

B, H, W = 4, 256, 256
SIGMA = math.sqrt(0.03)


def cuda_ms(fn, reps=5, inner=3):
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def stage_steps(z, pilot, stage, prof):
    """{step: thunk} for one stage, each on precomputed inputs, and the whole stage."""
    ht = stage == "ht"
    bs, k = (prof.bs_ht, prof.max_3d_ht) if ht else (prof.bs_wie, prof.max_3d_wie)
    tau = (prof.tau_match_ht if ht else prof.tau_match_wie) * prof.tau_scale * bs * bs / 255.0**2
    ref, offs = core._ref_grid(H - bs + 1, prof.step_ht if ht else prof.step_wie), core._offsets(39, bs)
    nw = W - bs + 1
    k2f, k2i = core._kron_pair(bs, prof.transform_ht if ht else prof.transform_wie, prof.dec_level if ht else 0, z)
    sig = host_scalar(SIGMA, z.dtype)
    match_img = z if ht else pilot
    t2b = core._extract_blocks(z, bs) @ k2f.T
    t2b_p = None if ht else core._extract_blocks(pilot, bs) @ k2f.T
    d = core._block_distances(match_img, ref, offs, bs)
    d2 = d.reshape(B, len(ref) ** 2, -1)
    pos, counts = core._match(match_img, ref, offs, bs, k, tau)
    groups = core._group_coeffs(t2b, pos, nw)
    if ht:
        thr, s2 = float(host_scalar(prof.lambda_thr3d, z.dtype) * sig), float(sig * sig)
        filt = lambda: core._tree_filter_ht(groups, counts, thr, s2, k)  # noqa: E731
        gather = lambda: core._group_coeffs(t2b, pos, nw)  # noqa: E731
        whole = lambda: core.ht_stage(z, SIGMA, prof, prefilter=False)  # noqa: E731
        beta = prof.beta
    else:
        gp = core._group_coeffs(t2b_p, pos, nw)
        sw = sig * host_scalar(np.sqrt(prof.mu2), z.dtype)
        filt = lambda: core._tree_filter_wiener(groups, gp, counts, float(sw * sw), k)  # noqa: E731
        gather = lambda: (core._group_coeffs(t2b, pos, nw), core._group_coeffs(t2b_p, pos, nw))  # noqa: E731
        whole = lambda: core.wiener_stage(z, pilot, SIGMA, prof)  # noqa: E731
        beta = prof.beta_wie
    hat, wts = filt()
    hat_sp = hat @ k2i.T
    window = transforms.kaiser_window(bs, beta)
    two_d = (lambda: core._extract_blocks(z, bs) @ k2f.T) if ht else (
        lambda: (core._extract_blocks(z, bs) @ k2f.T, core._extract_blocks(pilot, bs) @ k2f.T))
    steps = {
        "2-D transform of every block": two_d,
        "distances": lambda: core._block_distances(match_img, ref, offs, bs),
        "top-k (stable sort)": lambda: torch.sort(d2, dim=-1, stable=True),
        "matching in all (distances, sort, sizes, positions)": lambda: core._match(match_img, ref, offs, bs, k, tau),
        "group gather": gather,
        "stack filter (Haar tree)": filt,
        "inverse 2-D transform": lambda: hat @ k2i.T,
        "aggregation": lambda: core._aggregate((H, W), hat_sp, wts, pos, window),
    }
    return steps, whole, d.numel() * d.element_size()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bm3d_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    img = phantom.mri_phantoms(B, H, seed=0)
    rng = np.random.default_rng(0)
    z = torch.from_numpy((img + SIGMA * rng.standard_normal(img.shape)).astype(np.float32)).to(dev)
    prof = core.DEFAULT_PROFILE
    with full_precision_matmul():
        pilot = core.ht_stage(z, SIGMA, prof, prefilter=False)
        call_ms = cuda_ms(lambda: core.bm3d(z, SIGMA, prof, prefilter=False, device=dev))
        for stage in ("ht", "wiener"):
            steps, whole, d_bytes = stage_steps(z, pilot, stage, prof)
            ms = {k: cuda_ms(f) for k, f in steps.items()}
            whole_ms = cuda_ms(whole)
            for k, m in ms.items():
                print(f"{stage}: {k}: {m:.4f} ms ({m / whole_ms:.1%} of the stage)")
            parts = sum(v for k, v in ms.items() if k not in ("distances", "top-k (stable sort)"))
            print(f"{stage}: the steps without the matching's parts sum to {parts:.4f} ms; the whole stage "
                  f"{whole_ms:.4f} ms; the distances' output {d_bytes / 2**20:.1f} MiB")
    print(f"one call (both stages) {call_ms:.4f} ms at {B} x {H} x {W}")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        core.bm3d(z, SIGMA, prof, prefilter=False, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = p.key_averages()
    dev_attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    kernels = [e for e in events if getattr(e, dev_attr, 0) > 0 and e.device_type.name == "CUDA"]
    if not kernels:
        print("profiler: no device time recorded")
        return
    busy_ms = sum(getattr(e, dev_attr) for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    for e in sorted(kernels, key=lambda e: -getattr(e, dev_attr))[:15]:
        print(f"profiler: {getattr(e, dev_attr) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:110]}")
    print(f"profiler: one call {wall_ms:.3f} ms on the host clock, {launches} kernel launches, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}; the profiler's own overhead included)")


if __name__ == "__main__":
    main()
