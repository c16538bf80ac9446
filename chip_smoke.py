#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from any directory; needs one CUDA card and nvcc)

Phases, each timed and each fatal on failure:

- build:   compiles the port's two CUDA libraries from
           ``pnp_admm_cnc_mri_torch/csrc``, one nvcc each, in parallel (while
           the phantom batch is made on the host);
- kernels: holds each kernel against its plain PyTorch version on the card at
           the main path's shape (512 x 256 x 256 float32, with exact zeros and
           NaNs planted), and on the scalar, misaligned and float64 paths;
- solve:   drives the main path, ``admm_l1`` and ``admm_cnc`` with
           ``fused=True`` at 256 x 256, batch 512, 50 iterations, with every
           launch count set to 0 just before and read just after; checks the
           fused solves against the unfused ones, PSNR against the zero-filled
           start, and a float64 solve on the card against a numpy reference;
- fused_iteration: holds the fused ADMM-L1 iteration (three launches of
           ``csrc/admm_iteration.cu``) against its plain version at 512 x 256
           x 256 and 3 x 128 x 256, from the scenario's initial state and its
           state after 10 iterations, with a NaN planted in one image; then
           drives ``admm_l1_fused_kernel`` at 512 x 256 x 50 with the launch
           count set to 0 just before and read just after, against the
           unfused matmul solver and the fused fft solve;
- timing:  CUDA-event medians of the solves and of each kernel against its
           plain version and its bound (bytes or operations).

Prints the card's name and power limit (nvidia-smi), one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``. Exits
non-zero and prints no result if there is no CUDA card, if the port is not
next to this file, or if any phase fails.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B, H, W, ITERS = 512, 256, 256, 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
FUSED_ATOL = 1e-5  # fused step vs plain: 256-term float32 sums, FMA vs cuBLAS; soft is 1-Lipschitz
# Operations per element of each tail (adds, multiplies, compares), and the
# float planes each moves (inputs read once, outputs written once).
TAILS = {
    "l1_tail": dict(flops=8, planes=4, replaces="pnp_admm_cnc_mri_tpu/ops/pallas_kernels.py:68"),
    "cnc_tail": dict(flops=19, planes=5, replaces="pnp_admm_cnc_mri_tpu/ops/pallas_kernels.py:119"),
}
SOURCE = "pnp_admm_cnc_mri_torch/csrc/admm_tail.cu"
FUSED_SOURCE = "pnp_admm_cnc_mri_torch/csrc/admm_iteration.cu"
FUSED_REPLACES = "pnp_admm_cnc_mri_tpu/ops/pallas_dc.py:83"
_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase(name: str, t_start: float) -> None:
    import torch

    torch.cuda.synchronize()
    log(f"phase {name}: ok in {time.perf_counter() - t_start:.1f} s "
        f"(total {time.perf_counter() - _T0:.1f} s)")


def cuda_ms(fn, reps: int = 5, inner: int = 1, warmup: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls, per call."""
    import torch

    for _ in range(warmup):
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


def same(got, ref, what: str) -> float:
    """Exact agreement of two tensor tuples, NaN where NaN; returns the max
    absolute error over the other entries (0.0 when they agree; an infinity
    on one side only counts as an infinite error)."""
    import torch

    err = 0.0
    for a, b in zip(got, ref):
        nan_a = torch.isnan(a)
        check(torch.equal(nan_a, torch.isnan(b)), f"{what}: NaN positions differ")
        a, b = a[~nan_a], b[~nan_a]
        d = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
        check(torch.equal(a, b), f"{what}: max abs error {err} against the plain version")
    return err


def numpy_admm_l1(img, mask, noise, iters, lam, rho):
    """Straight-line numpy ADMM-L1 (reference ADMM_L1.py:111-126), float64."""
    import numpy as np

    y = np.fft.fft2(img) * mask + noise
    x = np.abs(np.fft.ifft2(y))
    z, w = x.copy(), np.zeros_like(x)
    la2 = 1.0 / (2.0 * rho)
    for _ in range(iters):
        xf = np.fft.fft2(z - w)
        xf = np.where(mask != 0, (la2 * xf + y) / (1.0 + la2), xf)
        x = np.abs(np.real(np.fft.ifft2(xf)))
        v = x + w
        z = np.fmax(np.abs(v) - rho * lam, 0) * np.sign(v)
        w = w + x - z
    return x


def main() -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    if not os.path.isdir(os.path.join(ROOT, "pnp_admm_cnc_mri_torch")):
        raise SystemExit("chip_smoke: the package pnp_admm_cnc_mri_torch is not next to this script")
    sys.path.insert(0, ROOT)
    from pnp_admm_cnc_mri_torch import ADMM_CNC_DEFAULT, ADMM_L1_DEFAULT, ADMMConfig
    from pnp_admm_cnc_mri_torch.data import masks, noise, phantom
    from pnp_admm_cnc_mri_torch.ops import fourier, fused_dc, metrics, tail_kernels
    from pnp_admm_cnc_mri_torch.solvers import admm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    log(f"nvidia-smi: {smi[0]}")
    dev = torch.device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- build (one nvcc per library, in threads) while the inputs are made ---
    t = time.perf_counter()
    built: dict = {}

    def build(name, load):
        t_b = time.perf_counter()
        try:
            load()
            built[name] = time.perf_counter() - t_b
        except BaseException as e:  # re-raised in the main thread below
            built[name] = e

    threads = [threading.Thread(target=build, args=(name, mod.load_library))
               for name, mod in (("admm_tail", tail_kernels), ("admm_iteration", fused_dc))]
    for th in threads:
        th.start()
    img_np = phantom.mri_phantoms(B, H, seed=0)
    mask_np = masks.random_mask((H, W), fraction=0.3, seed=1)
    noise_np = noise.synth_noise((H, W), std=3.0, seed=2).astype(np.complex64)
    for th in threads:
        th.join()
    for v in built.values():
        if isinstance(v, BaseException):
            raise v
    log("build: " + ", ".join(f"nvcc {k} {v:.1f} s" for k, v in built.items()) + " (in parallel); inputs made alongside")
    phase("build", t)

    # -- kernels against their plain versions ---------------------------------
    t = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def operand(shape=(B, H, W), dtype=torch.float32):
        scale = 10.0 ** (-4.0 * torch.rand(shape, generator=gen, device=dev, dtype=dtype))
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype) * scale

    x, z, w = operand(), operand(), operand()
    c = ADMM_L1_DEFAULT.rho * ADMM_L1_DEFAULT.lam
    flat = [a.view(-1) for a in (x, z, w)]
    flat[0][:4096] = 0.0  # x + w == 0 exactly
    flat[2][:4096] = 0.0
    flat[1][4096:8192] = 0.0  # z == 0 exactly
    flat[0][8192:12288] = c  # |x + w| == c exactly
    flat[2][8192:12288] = 0.0
    for a, i in zip(flat, (20001, 20002, 20003)):
        a[i] = float("nan")
    cnc_args = (ADMM_CNC_DEFAULT.alpha, ADMM_CNC_DEFAULT.rho, ADMM_CNC_DEFAULT.lam, ADMM_CNC_DEFAULT.b)
    errs = {
        "l1_tail": same(tail_kernels.l1_tail(x, z, w, c), tail_kernels.l1_tail_plain(x, z, w, c), "l1_tail"),
        "cnc_tail": same(tail_kernels.cnc_tail(x, z, w, *cnc_args),
                         tail_kernels.cnc_tail_plain(x, z, w, *cnc_args), "cnc_tail"),
    }
    zk, wk = tail_kernels.cnc_tail(x, z, w, *cnc_args)
    check(bool(torch.isnan(zk.view(-1)[20001:20004]).all() and torch.isnan(wk.view(-1)[20001:20004]).all()),
          "cnc_tail: NaN input did not give NaN output")
    # the scalar path (odd size, then a misaligned start) and the float64 path
    small = [operand((3, 7, 33)) for _ in range(3)]
    base = [operand((B * H * W + 1,)) for _ in range(3)]
    shifted = [a[1:].view(B, H, W) for a in base]
    f64 = [operand((2, 16, 256), torch.float64) for _ in range(3)]
    for tag, ops in (("odd size", small), ("misaligned", shifted), ("float64", f64)):
        same(tail_kernels.l1_tail(*ops, c), tail_kernels.l1_tail_plain(*ops, c), f"l1_tail {tag}")
        same(tail_kernels.cnc_tail(*ops, *cnc_args), tail_kernels.cnc_tail_plain(*ops, *cnc_args),
             f"cnc_tail {tag}")
    del small, base, shifted, f64
    log("kernels: l1_tail and cnc_tail equal their plain versions exactly "
        "(512x256x256 f32 with zeros and NaNs; odd-size, misaligned and f64 paths)")
    phase("kernels", t)

    # -- the main path ---------------------------------------------------------
    t = time.perf_counter()
    img = torch.from_numpy(img_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev, torch.float32)
    y = fourier.observe(img, mask, torch.from_numpy(noise_np).to(dev))
    check(y.dtype == torch.complex64 and tuple(y.shape) == (B, H, W), f"y is {y.dtype} {tuple(y.shape)}")
    solvers = {"admm_l1": (admm.admm_l1, ADMM_L1_DEFAULT), "admm_cnc": (admm.admm_cnc, ADMM_CNC_DEFAULT)}
    unfused = {k: f(y, mask, cfg, fused=False, dc_method="fft")[0] for k, (f, cfg) in solvers.items()}
    torch.cuda.synchronize()
    tail_kernels.reset_launches()
    fused = {k: f(y, mask, cfg, fused=True, dc_method="fft")[0] for k, (f, cfg) in solvers.items()}
    torch.cuda.synchronize()
    launches = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches}
    check(launches == {"l1_tail": ITERS, "cnc_tail": ITERS}, f"launches on the main path: {launches}")
    zf_psnr = metrics.psnr(torch.abs(fourier.zero_fill(y)) * 255.0, img * 255.0)
    quality = {}
    for k in solvers:
        xk = fused[k].x
        check(tuple(xk.shape) == (B, H, W) and xk.dtype == torch.float32, f"{k}: x is {xk.dtype} {tuple(xk.shape)}")
        check(bool(torch.isfinite(xk).all()), f"{k}: non-finite output")
        d = (xk - unfused[k].x).abs()
        check(float(d.max()) < 5e-3 and float(d.mean()) < 1e-5,
              f"{k}: fused vs unfused max {float(d.max())} mean {float(d.mean())}")
        p = metrics.psnr(xk * 255.0, img * 255.0)
        check(bool(torch.isfinite(p).all()) and bool((p > zf_psnr).all()),
              f"{k}: PSNR {float(p.min())} not above the zero-filled PSNR on every image")
        quality[k] = {"psnr_db": float(p.mean()), "fused_vs_unfused_max": float(d.max())}
    quality["zero_filled_psnr_db"] = float(zf_psnr.mean())
    del unfused, fused
    # an independent float64 reference on a small input, through the f64 kernel
    rng = np.random.default_rng(3)
    img_s = rng.random((2, 64, 64))
    mask_s = masks.random_mask((64, 64), fraction=0.3, seed=4)
    noise_s = 0.5 * (rng.normal(size=(64, 64)) + 1j * rng.normal(size=(64, 64)))
    cfg_s = ADMMConfig(iter_num=10, lam=0.1, rho=0.015)
    y_s = np.fft.fft2(img_s) * mask_s + noise_s
    x_s = admm.admm_l1(y_s, mask_s, cfg_s, dtype=torch.float64, fused=True, use_rfft=False)[0].x
    ref_s = np.stack([numpy_admm_l1(im, mask_s, noise_s, 10, 0.1, 0.015) for im in img_s])
    err_s = float(np.abs(x_s.cpu().numpy() - ref_s).max())
    check(err_s < 1e-9, f"float64 solve on the card vs numpy reference: {err_s}")
    log(f"solve: launches {launches}; quality {json.dumps(quality)}; f64 vs numpy {err_s:.3g}")
    phase("solve", t)

    # -- the fused iteration: kernel against its plain version, then its path --
    t = time.perf_counter()
    cfg_l1 = ADMM_L1_DEFAULT
    thr = cfg_l1.rho * cfg_l1.lam
    cfg_10 = ADMMConfig(iter_num=10, lam=cfg_l1.lam, rho=cfg_l1.rho)
    h3 = 128
    y3 = fourier.observe(img[:3, :h3].contiguous(), mask[:h3].contiguous(),
                         torch.from_numpy(noise_np[:h3].copy()).to(dev))
    fused_err = 0.0
    steps = {}
    for tag, (ys, ms) in {"512x256x256": (y, mask), "3x128x256": (y3, mask[:h3].contiguous())}.items():
        a_s, c_s = fourier.rfft_blend_fields(ys, ms, cfg_l1.rho)
        step = fused_dc.make_fused_iteration(a_s, c_s.real.contiguous(), c_s.imag.contiguous(),
                                             *ms.shape, thr)
        fields = (step.fields.a_half, step.fields.cr, step.fields.ci, thr, step.fields.mats)
        steps[tag] = step, fields
        init = admm.init_state(ys)
        later = admm.admm_l1(ys, ms, cfg_10, dc_method="fft")[0]
        for state_tag, (z0, w0) in (("init", (init.z, init.w)), ("after 10 iterations", (later.z, later.w))):
            got = step(z0, w0)
            ref = fused_dc.fused_iteration_plain(z0, w0, *fields)
            for name, a_, r_ in zip(("z'", "w'"), got, ref):
                check(bool(torch.isfinite(a_).all()), f"fused_iteration {tag} {state_tag}: non-finite {name}")
                e = float((a_ - r_).abs().max())
                check(e < FUSED_ATOL, f"fused_iteration {tag} {state_tag}: {name} max abs error {e}")
                fused_err = max(fused_err, e)
            again = step(z0, w0)
            check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
                  f"fused_iteration {tag} {state_tag}: two launches differ")
    # a NaN in image 7 fills that image, and only it, in both versions
    step, fields = steps["512x256x256"]
    a_s, cr_s, ci_s = fields[:3]
    init = admm.init_state(y)
    z_nan = init.z.clone()
    z_nan[7, 100, 100] = float("nan")
    got, ref = step(z_nan, init.w), fused_dc.fused_iteration_plain(z_nan, init.w, *fields)
    others = torch.arange(B, device=dev) != 7
    for name, a_, r_ in zip(("z'", "w'"), got, ref):
        check(bool(torch.isnan(a_[7]).all() and torch.isnan(r_[7]).all()),
              f"fused_iteration: {name} of the image with a NaN is not all NaN")
        e = float((a_[others] - r_[others]).abs().max())
        check(e < FUSED_ATOL, f"fused_iteration with a NaN in image 7: {name} max abs error {e} elsewhere")
    for bad, what in ((lambda: step(init.z.double(), init.w.double()), "a float64 state"),
                      (lambda: fused_dc.make_fused_iteration(a_s.double(), cr_s.double(), ci_s.double(),
                                                             H, W, thr), "float64 fields"),
                      (lambda: fused_dc.make_fused_iteration(a_s[:, :-1], cr_s[..., :-1], ci_s[..., :-1],
                                                             H, W - 1, thr), "an odd W")):
        try:
            bad()
        except (TypeError, ValueError):
            pass
        else:
            raise AssertionError(f"fused_iteration took {what}")
    log(f"fused_iteration: max abs error {fused_err:.3g} against the plain version "
        f"(512x256x256 and 3x128x256, initial state and after 10 iterations); NaN stays in its image; "
        f"launches bitwise repeatable; float64 and odd W refused")
    # the path: admm_l1_fused_kernel at 512 x 256 x 256, 50 iterations
    torch.cuda.synchronize()
    tail_kernels.reset_launches()
    fused_dc.reset_launches()
    x_k, z_k, w_k = fused_dc.admm_l1_fused_kernel(y, mask, cfg_l1)
    torch.cuda.synchronize()
    launches["fused_iteration"] = fused_dc.fused_iteration.launches
    check(launches["fused_iteration"] == ITERS - 1, f"fused iterations on the path: {launches['fused_iteration']}")
    check(tail_kernels.l1_tail.launches == 0 and tail_kernels.cnc_tail.launches == 0,
          "admm_l1_fused_kernel launched a tail kernel")
    check(tuple(x_k.shape) == (B, H, W) and x_k.dtype == torch.float32, f"x is {x_k.dtype} {tuple(x_k.shape)}")
    check(bool(torch.isfinite(x_k).all()), "admm_l1_fused_kernel: non-finite output")
    ref_x = admm.admm_l1(y, mask, cfg_l1, fused=False, dc_method="matmul")[0].x
    d = (x_k - ref_x).abs()
    check(float(d.max()) < 5e-3 and float(d.mean()) < 1e-5,
          f"admm_l1_fused_kernel vs unfused matmul solver: max {float(d.max())} mean {float(d.mean())}")
    p = metrics.psnr(x_k * 255.0, img * 255.0)
    check(bool(torch.isfinite(p).all()) and bool((p > zf_psnr).all()),
          f"admm_l1_fused_kernel: PSNR {float(p.min())} not above the zero-filled PSNR on every image")
    dp = float(p.mean()) - quality["admm_l1"]["psnr_db"]
    check(abs(dp) < 0.05, f"admm_l1_fused_kernel mean PSNR {float(p.mean())} vs fft solve: {dp} dB")
    quality["admm_l1_fused_kernel"] = {"psnr_db": float(p.mean()), "vs_matmul_max": float(d.max()),
                                       "vs_matmul_mean": float(d.mean()), "vs_fft_psnr_db": dp}
    del ref_x, d, z_nan, got, ref, init, later, y3, steps
    log(f"fused_iteration: launches {launches['fused_iteration']}; "
        f"quality {json.dumps(quality['admm_l1_fused_kernel'])}")
    phase("fused_iteration", t)

    # -- timing ----------------------------------------------------------------
    t = time.perf_counter()
    rates = {}
    for k, (f, cfg) in solvers.items():
        for label, kw in (("fused", dict(fused=True, dc_method="fft")),
                          ("unfused", dict(fused=False, dc_method="fft")),
                          ("fused_matmul", dict(fused=True, dc_method="matmul"))):
            ms = cuda_ms(lambda: f(y, mask, cfg, **kw), reps=5 if label != "fused_matmul" else 3)
            rates[f"{k}_{label}"] = {"solve_ms": ms, "image_iters_per_s": B * ITERS / (ms / 1e3)}
    kernels = []
    n = B * H * W
    for name, spec in TAILS.items():
        kern = getattr(tail_kernels, name)
        plain = getattr(tail_kernels, name + "_plain")
        args = (x, z, w, c) if name == "l1_tail" else (x, z, w, *cnc_args)
        ms = cuda_ms(lambda: kern(*args), inner=20)
        plain_ms = cuda_ms(lambda: plain(*args), inner=20)
        bytes_ms = spec["planes"] * n * 4 / HBM_BYTES_PER_S * 1e3
        ops_ms = spec["flops"] * n / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": spec["replaces"],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        })
    # the fused iteration at the path's shape, from the scenario's initial state
    ms = cuda_ms(lambda: fused_dc.admm_l1_fused_kernel(y, mask, cfg_l1), reps=5)
    rates["admm_l1_fused_kernel"] = {"solve_ms": ms, "image_iters_per_s": B * ITERS / (ms / 1e3)}
    init = admm.init_state(y)
    z0, w0 = init.z, init.w
    it = step.fields
    k3_ms = cuda_ms(lambda: step(z0, w0), inner=5)
    k3_plain_ms = cuda_ms(lambda: fused_dc.fused_iteration_plain(z0, w0, *fields), inner=5)
    z1, w1 = torch.empty_like(z0), torch.empty_like(z0)
    stages = {name.split("_")[2]: cuda_ms(lambda: fused_dc.launch(name, dev, *args), inner=5)
              for name, args in fused_dc.stage_launches(it, z0, w0, z1, w1)}
    wh = W // 2 + 1
    # the least work of the function: two half-spectrum FFTs (5 H W log2(H W)
    # flops for both), the blend (4 a bin), v = z - w, |.|, soft and the dual
    # (10 a pixel); bytes: z, w in, z', w' out, Cr, Ci in, A once
    k3_flops = B * (5 * H * W * math.log2(H * W) + 4 * H * wh + 10 * H * W)
    k3_bytes = 4 * (4 * B * H * W + 2 * B * H * wh + H * wh)
    k3_bytes_ms, k3_ops_ms = k3_bytes / HBM_BYTES_PER_S * 1e3, k3_flops / FP32_FLOPS * 1e3
    # the floor of the dense-DFT design itself: its twelve products, rows
    # 2 x (H W Wh), columns 8 x (H H Wh), synthesis 2 x (H Wh W), 2 flops each
    dense_ms = B * (8 * H * W * wh + 16 * H * H * wh) / FP32_FLOPS * 1e3
    log(f"timing: fused_iteration {k3_ms:.4f} ms per step (plain {k3_plain_ms:.4f} ms; stages "
        f"{json.dumps(stages)}; bound {max(k3_bytes_ms, k3_ops_ms):.4f} ms: {k3_bytes / 1e9:.3f} GB, "
        f"{k3_flops / 1e9:.2f} GFLOP; the dense products' own floor {dense_ms:.4f} ms; strip {it.strip})")
    kernels.append({
        "name": "fused_iteration", "route": "cuda", "source": FUSED_SOURCE, "replaces": FUSED_REPLACES,
        "launches": launches["fused_iteration"], "max_abs_err": fused_err,
        "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": max(k3_bytes_ms, k3_ops_ms),
        "bound_by": "bytes" if k3_bytes_ms >= k3_ops_ms else "operations",
        "library_ms": None,
    })
    log(f"timing: {json.dumps(rates)}")
    phase("timing", t)
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


if __name__ == "__main__":
    try:
        device = main()
    except Exception:
        import traceback

        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": device}), flush=True)
