#!/usr/bin/env python3
"""Probe of the fused ADMM-L1 step (K3) on one CUDA card.

    python3 probes/k3_probe.py errors     per-row errors of both designs and of
                                          the float32 plain step against a
                                          float64 plain step, at the card
                                          tests' shapes
    python3 probes/k3_probe.py time [NAME[=P[,S]] ...]
                                          the cluster step at 512 x 256 x 256,
                                          each NAME built with the kernel's
                                          probe knobs -D ADMM_CLUSTER_PHASES=P
                                          (P < 3 stops after phase P) and
                                          ADMM_CLUSTER_SHORTCUT=S (1: no
                                          distributed shared memory), or with
                                          the source's defaults, timed in turns
                                          (forward, then backward), with the
                                          cuFFT path's iteration beside them

Prints one line per shape, design or build. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_admm_cnc_mri_torch.ops import _build, fourier, fused_dc, tail_kernels  # noqa: E402

C_L1 = 0.015 * 0.1
SHAPES = [(4, 256, 256), (3, 128, 256), (5, 8, 16), (2, 512, 64), (2, 1024, 64)]


def case(dev, b, h, w, seed=0):
    """The card tests' scenario (tests/test_torch_cuda.py::_fused_case), and
    its k-space and mask."""
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w))
    mask = (rng.random((h, w)) < 0.3).astype(np.float32)
    noise = 3.0 * (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))
    y = torch.from_numpy((np.fft.fft2(img) * mask + noise).astype(np.complex64)).to(dev)
    a, c = fourier.rfft_blend_fields(y, torch.from_numpy(mask).to(dev), 0.015)
    z = torch.from_numpy(img.astype(np.float32)).to(dev)
    wd = torch.from_numpy((0.01 * rng.normal(size=(b, h, w))).astype(np.float32)).to(dev)
    return z, wd, (a, c.real.contiguous(), c.imag.contiguous()), (a, c)


def errors(dev):
    for b, h, w in SHAPES:
        z, wd, fields, _ = case(dev, b, h, w)
        ref64 = fused_dc.fused_iteration_plain(z.double(), wd.double(), *(f.double() for f in fields), C_L1)
        plain = fused_dc.fused_iteration_plain(z, wd, *fields, C_L1)
        outs = {"plain_f32": plain}
        for design in fused_dc.DESIGNS:
            if fused_dc.pick_design(h, w)[0] == "cluster" or design == "strips":
                outs[design] = fused_dc.make_fused_iteration(*fields, h, w, C_L1, design=design)(z, wd)
        torch.cuda.synchronize()
        for name, out in outs.items():
            d64 = torch.stack([(o.double() - r).abs() for o, r in zip(out, ref64)]).amax(dim=(0, 1))  # (H, W)
            rows = d64.amax(dim=1)
            worst = torch.topk(rows, min(3, h))
            vs_plain = max(float((o - p).abs().max()) for o, p in zip(out, plain))
            print(f"{b}x{h}x{w} {name:9s}: vs f64 max {float(d64.max()):.3e} mean {float(d64.mean()):.3e}; "
                  f"worst rows {worst.indices.tolist()} {[f'{v:.2e}' for v in worst.values.tolist()]}; "
                  f"vs plain f32 {vs_plain:.3e}", flush=True)


def cuda_ms(fn, reps=5, inner=5):
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls, per call."""
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


KNOBS = ("PHASES", "SHORTCUT")


def build_variant(name, *values):
    """lib<...>.so of csrc/admm_iteration_cluster.cu with -D ADMM_CLUSTER_<knob>=value."""
    out = _build.BUILD_DIR / f"libadmm_iteration_cluster_{name}.so"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    defs = [f"-DADMM_CLUSTER_{k}={v}" for k, v in zip(KNOBS, values)]
    cmd = [_build.nvcc(), *_build.flags("admm_iteration_cluster"), *defs, "-Xptxas", "-v", "-o", str(out),
           str(_build.CSRC_DIR / "admm_iteration_cluster.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    regs = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    return out, regs[-2:]


def time_variants(dev, specs):
    b, h, w = 512, 256, 256
    z, wd, fields, (a, c) = case(dev, b, h, w)
    ref64 = fused_dc.fused_iteration_plain(z.double(), wd.double(), *(f.double() for f in fields), C_L1)
    variants = {}
    for spec in specs or ["default"]:
        name, _, vals = spec.partition("=")
        values = vals.split(",") if vals else []
        path, regs = build_variant(name, *values)
        regs = [vals or "source defaults", *regs]
        fused_dc._CLUSTER_LIB = None
        real_build = _build.build
        _build.build = lambda n, p=path: p
        try:
            lib = fused_dc.load_cluster_library()
        finally:
            _build.build = real_build
        step = fused_dc.make_fused_iteration(*fields, h, w, C_L1)
        err = max(float((o.double() - r).abs().max()) for o, r in zip(step(z, wd), ref64))
        variants[name] = (lib, step, err, regs)

    def runner(lib, step):
        def run():
            fused_dc._CLUSTER_LIB = lib
            return step(z, wd)
        return run

    dc = lambda v: torch.abs(torch.fft.irfft2(a * torch.fft.rfft2(v) + c, s=(h, w)))  # noqa: E731
    contenders = {k: runner(v[0], v[1]) for k, v in variants.items()}
    contenders["cufft_iteration"] = lambda: tail_kernels.l1_tail(dc(z - wd), z, wd, C_L1)
    runs = {k: [] for k in contenders}
    for k in [*contenders, *reversed(contenders)]:
        runs[k].append(cuda_ms(contenders[k]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for k, v in runs.items():
        extra = "" if k not in variants else f"; vs f64 plain {variants[k][2]:.3e}; {variants[k][3]}"
        print(f"{b}x{h}x{w} {k}: ms {v} mean {statistics.mean(v):.4f}{extra}", flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("k3_probe: needs a CUDA card")
    dev = torch.device("cuda")
    mode = sys.argv[1] if len(sys.argv) > 1 else "errors"
    if mode == "time":
        time_variants(dev, sys.argv[2:])
    else:
        errors(dev)
