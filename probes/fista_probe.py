#!/usr/bin/env python3
"""Where the time of a ``fista_l1`` iteration goes, on one CUDA card.

    python3 probes/fista_probe.py

At chip_smoke.py's classical scenario (512 x 256 x 256 float32, 30% random
mask, noise std 3, lam 8e-4, step 1) and from the state after 10
iterations, times each step of one ``solvers/fista.run_fista`` iteration
alone (CUDA-event medians) beside the whole iteration and the iteration's
byte bound, then traces three iterations with ``torch.profiler`` and prints
the device time by kernel and the device's busy share of the window.
Needs a CUDA card; builds nothing.
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
from pnp_admm_cnc_mri_torch.data import masks, noise, phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.ops import fourier, prox  # noqa: E402
from pnp_admm_cnc_mri_torch.solvers import fista  # noqa: E402

B, H, W = 512, 256, 256
LAM, STEP = 8e-4, 1.0
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps=7, inner=10):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("fista_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    img = torch.from_numpy(phantom.mri_phantoms(B, H, seed=0)).to(dev)
    mask = torch.from_numpy(masks.random_mask((H, W), fraction=0.3, seed=1)).to(dev, torch.float32)
    y = fourier.observe(img, mask, torch.from_numpy(noise.synth_noise((H, W), std=3.0, seed=2)
                                                    .astype(np.complex64)).to(dev))
    st = fista.fista_l1(y, mask, 10, lam=LAM, step=STEP)[0]
    x, v, t = st.x, st.v, st.t
    vf = fourier.fft2(v)
    res = torch.where(mask != 0, vf * mask - y, vf * mask)
    g = torch.real(fourier.ifft2(res))
    u = v - STEP * g
    x_new = prox.soft(u, STEP * LAM)

    def whole():
        gg = torch.real(fourier.data_term_gradient(v, y, mask))
        xn = prox.soft(v - STEP * gg, STEP * LAM)
        return fista.fista_extrapolate(x, xn, t)

    steps = {
        "fft2 (real in, full complex out)": lambda: fourier.fft2(v),
        "masked residual (mask multiply, != 0, subtract, where)": lambda: torch.where(
            mask != 0, vf * mask - y, vf * mask),
        "ifft2 (complex to complex)": lambda: fourier.ifft2(res),
        "gradient step v - step real(g)": lambda: v - STEP * g,
        "soft-threshold (5 torch ops)": lambda: prox.soft(u, STEP * LAM),
        "momentum (3 torch ops)": lambda: fista.fista_extrapolate(x, x_new, t),
    }
    ms = {k: cuda_ms(f) for k, f in steps.items()}
    whole_ms = cuda_ms(whole)
    n = B * H * W
    bound_ms = (4 * 4 * n + 8 * n) / HBM_BYTES_PER_S * 1e3  # v, x, y in; x', v' out
    for k, m in ms.items():
        print(f"{k}: {m:.4f} ms ({m / whole_ms:.1%} of the iteration)")
    print(f"sum of the steps {sum(ms.values()):.4f} ms; the whole iteration {whole_ms:.4f} ms; "
          f"its byte bound {bound_ms:.4f} ms ({bound_ms / whole_ms:.1%})")

    # the profiler's view of three iterations: device time by kernel, busy share
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fista.fista_l1(y, mask, 3, lam=LAM, step=STEP)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    kernels = [e for e in events if getattr(e, dev_attr, 0) > 0 and e.device_type.name == "CUDA"]
    busy_ms = sum(getattr(e, dev_attr) for e in kernels) / 1e3
    if not kernels:
        print("profiler: no device time recorded")
        return
    for e in sorted(kernels, key=lambda e: -getattr(e, dev_attr))[:12]:
        print(f"profiler: {getattr(e, dev_attr) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:110]}")
    print(f"profiler: 3 iterations (and the zero-filled start) {wall_ms:.3f} ms on the host clock, "
          f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}; the profiler's own overhead included)")


if __name__ == "__main__":
    main()
