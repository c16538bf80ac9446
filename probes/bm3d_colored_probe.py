#!/usr/bin/env python3
"""Where the time of one exact colored-noise BM3D call goes, on one CUDA card.

    python3 probes/bm3d_colored_probe.py

At the bm3d_colored phase's scale of ``chip_smoke.py`` (4 x 256 x 256
float32: phantoms seed 0 plus the g1 family's colored noise of variance
0.02, realization r for image r; its PSD at 256 x 256; profile 'np' at its
explicit parameters, both stages, exact variances), splits one call
(``core.bm3d_colored_auto(..., auto_params=False)``) by step:

- on the host's clock: the coefficient stds and the covariance fields of
  both transforms (numpy FFTs);
- CUDA-event medians, each step alone on precomputed inputs: the 2-D
  transforms, the matching, the group gather, the exact-variance gather and
  products of each stack size, the inverse 2-D transform and the
  aggregation, beside the whole stage; the rest of the stage (the per-size
  stack transforms, thresholds or Wiener shrinkage and weights) is the
  stage less those steps.

Then traces one call with ``torch.profiler`` and prints the device time by
kernel, the launches and the device's busy share of the window, and the
call's peak memory. Needs a CUDA card; builds nothing.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_admm_cnc_mri_torch.data import noise, phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.ops.fourier import full_precision_matmul  # noqa: E402
from pnp_admm_cnc_mri_torch.priors.bm3d import core, transforms  # noqa: E402

B, H, W = 4, 256, 256
FAMILY, VAR = "g1", 0.02


def cuda_ms(fn, reps=5, inner=1):
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


def host_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stage_steps(z, pilot, stage, prof, stds, covf_np, match_sigma):
    """{step: thunk} of one stage on precomputed inputs, and the whole stage."""
    ht = stage == "ht"
    bs, k = (prof.bs_ht, prof.max_3d_ht) if ht else (prof.bs_wie, prof.max_3d_wie)
    tau = (prof.tau_match_ht if ht else prof.tau_match_wie) * prof.tau_scale * bs * bs / 255.0**2
    ref = core._ref_grid(H - bs + 1, prof.step_ht if ht else prof.step_wie)
    offs = core._offsets(prof.search_ht if ht else prof.search_wie, bs)
    nw = W - bs + 1
    k2f, k2i = core._kron_pair(bs, prof.transform_ht if ht else prof.transform_wie, prof.dec_level if ht else 0, z)
    match_img = z if ht else pilot
    t2b = core._extract_blocks(z, bs) @ k2f.T
    t2b_p = None if ht else core._extract_blocks(pilot, bs) @ k2f.T
    pos, counts = core._match(match_img, ref, offs, bs, k, tau)
    covf = torch.as_tensor(covf_np, device=z.device).to(z.dtype)
    sizes, fwd, _ = core._haar_bank(k, z)
    groups = core._group_coeffs(t2b, pos, nw)
    g_k = groups.shape[:-1] + (bs * bs,)
    hat_sp = torch.randn(g_k, device=z.device)
    wts = torch.rand(groups.shape[:-1], device=z.device)
    window = transforms.kaiser_window(bs, prof.beta if ht else prof.beta_wie)
    if ht:
        two_d = lambda: core._extract_blocks(z, bs) @ k2f.T  # noqa: E731
        gather = lambda: core._group_coeffs(t2b, pos, nw)  # noqa: E731
        whole = lambda: core.ht_stage_colored(z, stds, match_sigma, prof, cov_field=covf_np)  # noqa: E731
    else:
        two_d = lambda: (core._extract_blocks(z, bs) @ k2f.T, core._extract_blocks(pilot, bs) @ k2f.T)  # noqa: E731
        gather = lambda: (core._group_coeffs(t2b, pos, nw), core._group_coeffs(t2b_p, pos, nw))  # noqa: E731
        whole = lambda: core.wiener_stage_colored(z, pilot, stds, prof, cov_field=covf_np)  # noqa: E731
    steps = {
        "2-D transforms": two_d,
        "matching (distances, sort, sizes, positions)": lambda: core._match(match_img, ref, offs, bs, k, tau),
        "group gather": gather,
    }
    for s, hf in zip(sizes, fwd):
        steps[f"exact variances, stack size {s}"] = (
            lambda s=s, hf=hf: core._exact_group_vars(pos[..., :s, :], covf, hf, 32))
    steps["inverse 2-D transform"] = lambda: hat_sp @ k2i.T
    steps["aggregation"] = lambda: core._aggregate((H, W), hat_sp, wts, pos, window)
    return steps, whole


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bm3d_colored_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    img = phantom.mri_phantoms(B, H, seed=0)
    kern = noise.get_experiment_kernel(FAMILY, VAR, (H, W))
    psd = noise.experiment_psd(kern, (H, W))
    z_np = np.stack([img[r] + noise.synth_colored_noise((H, W), kern, seed=r) for r in range(B)])
    z = torch.from_numpy(z_np.astype(np.float32)).to(dev)
    prof = core.DEFAULT_PROFILE
    psd_g = np.maximum(psd, float(np.mean(psd)) * 1e-3 + 1e-20)
    match_sigma = float(np.sqrt(psd_g.mean() / (H * W)))
    host = {
        "coefficient stds (both transforms)": lambda: (core.psd_to_coeff_stds(psd_g, prof.transform_ht),
                                                       core.psd_to_coeff_stds(psd_g, prof.transform_wie)),
        "covariance fields (both transforms)": lambda: (core.coeff_cov_field(psd_g, prof.transform_ht),
                                                        core.coeff_cov_field(psd_g, prof.transform_wie)),
    }
    for k, f in host.items():
        print(f"host: {k}: {host_ms(f):.3f} ms")
    stds = {"ht": core.psd_to_coeff_stds(psd_g, prof.transform_ht),
            "wiener": core.psd_to_coeff_stds(psd_g, prof.transform_wie)}
    covs = {"ht": core.coeff_cov_field(psd_g, prof.transform_ht),
            "wiener": core.coeff_cov_field(psd_g, prof.transform_wie)}
    call = lambda: core.bm3d_colored_auto(z, psd, prof, auto_params=False)  # noqa: E731
    with full_precision_matmul():
        pilot = core.ht_stage_colored(z, stds["ht"], match_sigma, prof, cov_field=covs["ht"])
        call_ms = cuda_ms(call, reps=3)
        for stage in ("ht", "wiener"):
            steps, whole = stage_steps(z, pilot, stage, prof, stds[stage], covs[stage], match_sigma)
            ms = {k: cuda_ms(f, reps=3) for k, f in steps.items()}
            whole_ms = cuda_ms(whole, reps=3)
            for k, m in ms.items():
                print(f"{stage}: {k}: {m:.4f} ms ({m / whole_ms:.1%} of the stage)")
            var_ms = sum(v for k, v in ms.items() if k.startswith("exact variances"))
            rest = whole_ms - sum(ms.values())
            print(f"{stage}: exact variances in all {var_ms:.4f} ms ({var_ms / whole_ms:.1%}); the rest (stack "
                  f"transforms, shrinkage, weights, selection) {rest:.4f} ms ({rest / whole_ms:.1%}); the whole "
                  f"stage {whole_ms:.4f} ms")
    print(f"one call (both stages, the host's PSD work included) {call_ms:.4f} ms at {B} x {H} x {W}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    print(f"peak memory of one call above what was allocated {(torch.cuda.max_memory_allocated() - base) / 2**20:.1f}"
          " MiB")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        call()
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
        print(f"profiler: {getattr(e, dev_attr) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    print(f"profiler: one call {wall_ms:.3f} ms on the host clock, {launches} kernel launches, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}; the profiler's own overhead included)")


if __name__ == "__main__":
    main()
