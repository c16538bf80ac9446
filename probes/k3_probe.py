#!/usr/bin/env python3
"""Probe of the fused ADMM-L1 step (K3) on one CUDA card.

    python3 probes/k3_probe.py errors [BxHxW ...]
        per-row errors of every design that takes each shape (forced with
        ``design=``) and of the float32 plain step against a float64 plain
        step; by default the card tests' shapes

    python3 probes/k3_probe.py time [design=cluster|mixed] [shape=BxHxW ...] [q=Q] [NAME[=P[,S]] ...]
        the one-launch step of ``design`` (default cluster) at each shape
        (default 512x256x256), with Q blocks a cluster if given (else the
        rule's), each NAME a build of its source with the
        kernel's probe knobs: for the cluster design -D
        ADMM_CLUSTER_PHASES=P (P < 3 stops after phase P) and
        ADMM_CLUSTER_SHORTCUT=S (1: no distributed shared memory), for the
        mixed design -D ADMM_MIXED_PHASES=P; no NAME: the source's defaults.
        Timed in turns (forward, then backward) with the strip design
        (forced), the cuFFT path's iteration (cuFFT and l1_tail) and the
        plain step beside them; prints Q, the resident clusters and the
        byte bound

Prints one line per shape, design or build, and the card's name and power
limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_admm_cnc_mri_torch.ops import _build, fourier, fused_dc, tail_kernels  # noqa: E402

C_L1 = 0.015 * 0.1
SHAPES = [(4, 256, 256), (3, 128, 256), (5, 8, 16), (2, 512, 64), (2, 1024, 64),
          (2, 300, 256), (2, 320, 320), (2, 384, 384), (2, 512, 512), (2, 640, 320)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
KNOBS = {"cluster": ("PHASES", "SHORTCUT"), "mixed": ("PHASES",)}


def case(dev, b, h, w, seed=0):
    """The card tests' scenario (tests/test_torch_cuda.py::_fused_case),
    made on the card: images in [0, 1), a 30% random mask, noise of
    standard deviation 3 in k-space. Returns z, w and the blend fields."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    img = torch.rand((b, h, w), generator=gen, device=dev)
    mask = (torch.rand((h, w), generator=gen, device=dev) < 0.3).float()
    noise = 3.0 * torch.complex(torch.randn((h, w), generator=gen, device=dev),
                                torch.randn((h, w), generator=gen, device=dev))
    y = torch.fft.fft2(img) * mask + noise
    a, c = fourier.rfft_blend_fields(y, mask, 0.015)
    wd = 0.01 * torch.randn((b, h, w), generator=gen, device=dev)
    return img, wd, (a, c.real.contiguous(), c.imag.contiguous()), (a, c)


def designs_of(h, w):
    """Every design that takes (H, W), as ``pick_design`` takes them when asked."""
    out = []
    for design in fused_dc.DESIGNS:
        try:
            fused_dc.pick_design(h, w, design)
            out.append(design)
        except ValueError:
            pass
    return out


def plain64(z, wd, fields):
    return fused_dc.fused_iteration_plain(z.double(), wd.double(), *(f.double() for f in fields), C_L1)


def errors(dev, shapes):
    for b, h, w in shapes:
        z, wd, fields, _ = case(dev, b, h, w)
        ref64 = plain64(z, wd, fields)
        outs = {"plain_f32": (fused_dc.fused_iteration_plain(z, wd, *fields, C_L1), None)}
        plain = outs["plain_f32"][0]
        for design in designs_of(h, w):
            step = fused_dc.make_fused_iteration(*fields, h, w, C_L1, design=design)
            outs[design] = (step(z, wd), step.fields.q)
        torch.cuda.synchronize()
        for name, (out, q) in outs.items():
            d64 = torch.stack([(o.double() - r).abs() for o, r in zip(out, ref64)]).amax(dim=(0, 1))  # (H, W)
            rows = d64.amax(dim=1)
            worst = torch.topk(rows, min(3, h))
            vs_plain = max(float((o - p).abs().max()) for o, p in zip(out, plain))
            print(f"{b}x{h}x{w} {name:9s}{'' if q is None else f' Q {q}'}: vs f64 max {float(d64.max()):.3e} "
                  f"mean {float(d64.mean()):.3e}; worst rows {worst.indices.tolist()} "
                  f"{[f'{v:.2e}' for v in worst.values.tolist()]}; vs plain f32 {vs_plain:.3e}", flush=True)


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


def build_variant(design, name, *values):
    """lib<...>.so of csrc/admm_iteration_<design>.cu with -D ADMM_<DESIGN>_<knob>=value."""
    source = f"admm_iteration_{design}"
    out = _build.BUILD_DIR / f"lib{source}_{name}.so"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    defs = [f"-DADMM_{design.upper()}_{k}={v}" for k, v in zip(KNOBS[design], values)]
    cmd = [_build.nvcc(), *_build.flags(source), *defs, "-Xptxas", "-v", "-o", str(out),
           str(_build.CSRC_DIR / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    # per kernel (the mixed source has one per set of odd radices): its name, registers and spills
    regs = [ln.split("Compiling entry function")[-1].strip(" '") if "Compiling" in ln else
            ln.split(":")[-1].strip() for ln in proc.stderr.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    return out, regs


def load_variant(design, path):
    """The design's library loaded from ``path`` (and left as the module's library)."""
    attr = {"cluster": "_CLUSTER_LIB", "mixed": "_MIXED_LIB"}[design]
    setattr(fused_dc, attr, None)
    real_build = _build.build
    _build.build = lambda n, p=path: p
    try:
        return {"cluster": fused_dc.load_cluster_library, "mixed": fused_dc.load_mixed_library}[design]()
    finally:
        _build.build = real_build


def time_shape(dev, design, shape, variants, q_forced=None):
    b, h, w = shape
    z, wd, fields, (a, c) = case(dev, b, h, w)
    ref64 = plain64(z, wd, fields)
    attr = {"cluster": "_CLUSTER_LIB", "mixed": "_MIXED_LIB"}[design]
    steps = {}
    for name, (lib, regs) in variants.items():
        setattr(fused_dc, attr, lib)
        step = fused_dc.make_fused_iteration(*fields, h, w, C_L1, design=design)
        if q_forced:
            step.fields.q = q_forced
        err = max(float((o.double() - r).abs().max()) for o, r in zip(step(z, wd), ref64))
        steps[name] = (lib, step, err, regs)
    del ref64

    def runner(lib, step):
        def run():
            setattr(fused_dc, attr, lib)
            return step(z, wd)
        return run

    strip_step = fused_dc.make_fused_iteration(*fields, h, w, C_L1, design="strips")
    dc = lambda v: torch.abs(torch.fft.irfft2(a * torch.fft.rfft2(v) + c, s=(h, w)))  # noqa: E731
    contenders = {k: runner(v[0], v[1]) for k, v in steps.items()}
    contenders["strips"] = lambda: strip_step(z, wd)
    contenders["cufft_iteration"] = lambda: tail_kernels.l1_tail(dc(z - wd), z, wd, C_L1)
    contenders["plain"] = lambda: fused_dc.fused_iteration_plain(z, wd, *fields, C_L1, strip_step.fields.mats)
    runs = {k: [] for k in contenders}
    for k in [*contenders, *reversed(contenders)]:
        runs[k].append(cuda_ms(contenders[k], inner=5 if k not in ("strips", "plain") else 2))
    q = next(iter(steps.values()))[1].fields.q
    lib = next(iter(steps.values()))[0]
    active = getattr(lib, f"admm_iteration_{design}_active")(h, w, q)
    wh = w // 2 + 1
    k3_bytes = 4 * (4 * b * h * w + 2 * b * h * wh + h * wh)
    bound = k3_bytes / HBM_BYTES_PER_S * 1e3
    for k, v in runs.items():
        mean = statistics.mean(v)
        extra = "" if k not in steps else f"; vs f64 plain {steps[k][2]:.3e}; {steps[k][3]}"
        print(f"{b}x{h}x{w} {k}: ms {v} mean {mean:.5f}; {bound / mean:.1%} of the {bound:.4f} ms byte bound "
              f"({k3_bytes / 1e9:.3f} GB){extra}", flush=True)
    print(f"{b}x{h}x{w} {design}: Q {q}, {active} clusters resident, {getattr(fused_dc, design + '_smem')(h, w, q)} "
          f"B a block", flush=True)


def time_variants(dev, args):
    design, shapes, specs, q = "cluster", [], [], None
    for arg in args:
        if arg.startswith("design="):
            design = arg.split("=", 1)[1]
        elif arg.startswith("q="):
            q = int(arg.split("=", 1)[1])
        elif arg.startswith("shape="):
            shapes.append(tuple(int(v) for v in arg.split("=", 1)[1].split("x")))
        else:
            specs.append(arg)
    if design not in KNOBS:
        raise SystemExit(f"k3_probe: design must be one of {tuple(KNOBS)}, got {design!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    variants = {}
    for spec in specs or ["default"]:
        name, _, vals = spec.partition("=")
        path, regs = build_variant(design, name, *(vals.split(",") if vals else []))
        variants[name] = (load_variant(design, path), [vals or "source defaults", *regs])
    for shape in shapes or [(512, 256, 256)]:
        time_shape(dev, design, shape, variants, q)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("k3_probe: needs a CUDA card")
    device = torch.device("cuda")
    mode = sys.argv[1] if len(sys.argv) > 1 else "errors"
    if mode == "time":
        time_variants(device, sys.argv[2:])
    else:
        errors(device, [tuple(int(v) for v in s.split("x")) for s in sys.argv[2:]] or SHAPES)
