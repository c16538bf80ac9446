"""Scenario-grid sweep: images x masks x noise levels, solved on one device.

Port of the JAX package's ``cli/sweep.py`` (BASELINE.json config 5: a
512-image x 3-mask x noise-level grid). It builds the whole scenario grid
on the host, solves every scenario in one batched call on one device (the
CUDA card, or the CPU with ``--cpu``), scores it there and reports the
converged fraction of the final relative residuals. The JAX package shards
the grid over a device mesh; the sharded form is not ported.

    python -m pnp_admm_cnc_mri_torch.cli.sweep --algo admm_l1 \\
        --testset set --masks all --sigmas 1,3,5 --tol 1e-3

The testset, masks and noise come from ``data.images.DEFAULT_TESTSETS``
and ``data.masks`` / ``data.noise``'s ``DEFAULT_DATA_DIR``
(``PNPADMM_TESTSETS``, ``PNPADMM_DATA``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


CHUNK = 16  # images a step of build_grid: bounds its complex128 temporaries to a few MB


def build_grid(imgs01, masks_dict, sigma_scales, base_noise):
    """Cartesian scenario grid -> ys (S, H, W) complex64, masks (S, H, W)
    float32, truth_idx (S,) and labels, S = n_sigmas * n_masks * n_images,
    sigma outermost and image innermost.

    The grid is filled ``CHUNK`` images at a time: their FFT (the same per
    image as the batch's), then for each (sigma, mask) block ``fimg * mask
    + base_noise * scale`` in complex128, cast into the preallocated
    complex64 grid. These are the JAX package's elementwise operations in
    its order, so the grid is bit-equal to its scenario-at-a-time list,
    without its complex128 copy of the whole grid.
    """
    n = imgs01.shape[0]
    mask_items = list(masks_dict.items())
    blocks = [(scale, mname, mask) for scale in sigma_scales for mname, mask in mask_items]
    ys = np.empty((len(blocks) * n, *imgs01.shape[-2:]), dtype=np.complex64)
    ms = np.empty(ys.shape, dtype=np.float32)
    noise_at = {scale: base_noise * scale for scale in sigma_scales}
    for c in range(0, n, CHUNK):
        fimg = np.fft.fft2(imgs01[c:c + CHUNK], axes=(-2, -1))
        for b, (scale, _, mask) in enumerate(blocks):
            part = np.multiply(fimg, mask)
            part += noise_at[scale]
            ys[b * n + c:b * n + c + len(fimg)] = part
    for b, (_, _, mask) in enumerate(blocks):
        ms[b * n:(b + 1) * n] = mask
    labels = [f"img{ii}_{mname}_s{scale}" for scale, mname, _ in blocks for ii in range(n)]
    return ys, ms, np.tile(np.arange(n), len(blocks)), labels


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", default="admm_l1",
                   choices=["admm_l1", "admm_cnc", "pnp_l1_d", "pnp_cnc_d",
                            "pnp_fista_d", "pnp_hqs_d", "red_d"])
    p.add_argument("--model", default="dncnn_25")
    p.add_argument("--weights", default=None)
    p.add_argument("--testset", default="set")
    p.add_argument("--masks", default="all")
    p.add_argument("--sigmas", default="1.0", help="comma list of noise scales")
    p.add_argument("--iter_num", type=int, default=None,
                   help="iterations (default: 50 classical, per-model PnP)")
    p.add_argument("--tol", type=float, default=1e-3,
                   help="residual tolerance for converged-fraction reporting")
    p.add_argument("--repeat", type=int, default=1,
                   help="replicate the grid to scale the benchmark")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    p.add_argument("--out", default=None, help="write JSONL records here")
    return p


def _solver(args, device):
    """``(run(y, m) -> (x, per-iteration signal), iterations)`` of ``--algo``,
    with the JAX package's configurations (``cli/sweep.py:107-180``)."""
    import torch

    from pnp_admm_cnc_mri_torch import config as cfg_mod
    from pnp_admm_cnc_mri_torch.solvers import admm

    if args.algo in ("admm_l1", "admm_cnc"):
        cfg = cfg_mod.ADMM_L1_DEFAULT if args.algo == "admm_l1" else cfg_mod.ADMM_CNC_DEFAULT
        iters = args.iter_num if args.iter_num is not None else cfg.iter_num
        cfg = type(cfg)(**{**cfg.__dict__, "iter_num": iters})
        solver = {"admm_l1": admm.admm_l1, "admm_cnc": admm.admm_cnc}[args.algo]

        def run(y, m):
            final, res = solver(y, m, cfg, dtype=torch.float32, collect_residuals=True, device=device)
            return final.x, res

        return run, iters

    from pnp_admm_cnc_mri_torch.priors import denoiser as dn_mod

    if args.algo in ("pnp_fista_d", "pnp_hqs_d", "red_d"):
        tuned = {"pnp_fista_d": cfg_mod.TUNED_FISTA_D,
                 "pnp_hqs_d": cfg_mod.TUNED_HQS_D,
                 "red_d": cfg_mod.TUNED_RED_D}[args.algo].get(args.model, {})
        iters = args.iter_num if args.iter_num is not None else tuned.get("iter_num", 30)
        cfg = cfg_mod.ADMMConfig(iter_num=iters)
    elif args.algo == "pnp_l1_d":
        it, rho = cfg_mod.PNP_L1_DEFAULTS.get(args.model, (50, 0.25))
        cfg = cfg_mod.ADMMConfig(iter_num=args.iter_num if args.iter_num is not None else it, rho=rho)
    else:
        a, it, lam, rho, b = cfg_mod.PNP_CNC_DEFAULTS.get(args.model, (0.9, 50, 0.2, 0.45, 0.3))
        cfg = cfg_mod.ADMMConfig(iter_num=args.iter_num if args.iter_num is not None else it, lam=lam, rho=rho,
                                 alpha=a, b=b)
    denoise = dn_mod.build_denoiser(args.model, weights=dn_mod.resolve_weights(args.model, args.weights),
                                    iter_num=cfg.iter_num, device=device)

    def run(y, m):
        if args.algo == "pnp_fista_d":
            # gradient-form PnP; the signal is the per-iteration k-space data
            # residual ||M F x - y||_F = sqrt(2 N data_objective)
            from pnp_admm_cnc_mri_torch.solvers import fista as fista_mod

            st, objs = fista_mod.run_fista(y, m, cfg.iter_num, lambda i, u: torch.clamp(denoise(u, i), 0.0, 1.0),
                                           collect_objective=True, device=device)
            return st.x, torch.sqrt(2.0 * (y.shape[-2] * y.shape[-1]) * objs)
        if args.algo == "pnp_hqs_d":  # the DPIR ladder; signal ||x - z||
            from pnp_admm_cnc_mri_torch.solvers import hqs as hqs_mod

            return hqs_mod.pnp_hqs(y, m, cfg.iter_num, denoise, collect_residuals=True, device=device)
        if args.algo == "red_d":  # signal ||x - D(x)||
            from pnp_admm_cnc_mri_torch.solvers import red as red_mod

            return red_mod.run_red(y, m, cfg.iter_num, denoise, collect_residuals=True, device=device)
        pnp = admm.pnp_admm_l1 if args.algo == "pnp_l1_d" else admm.pnp_admm_cnc
        final, res = pnp(y, m, cfg, denoise, dtype=torch.float32, collect_residuals=True, device=device)
        return final.x, res

    return run, cfg.iter_num


def main(argv=None, timings: dict | None = None) -> int:
    """Run the sweep of ``argv`` (``sys.argv[1:]`` when None): print the
    one-line JSON summary and, with ``--out``, append one JSONL record a
    scenario. ``timings``, when given, receives the split of the run in
    seconds: ``load`` (testset, masks, noise), ``grid`` (``build_grid``),
    ``h2d`` (y and the masks to the device), ``solve`` (the summary's
    ``wall_s``: the batched solve and the relative residuals, to their end
    on the device), ``score`` (PSNR and the converged fraction) and
    ``records``."""
    args = _parser().parse_args(argv)

    import torch

    from pnp_admm_cnc_mri_torch import config as cfg_mod
    from pnp_admm_cnc_mri_torch.data import images, masks as masks_mod, noise as noise_mod
    from pnp_admm_cnc_mri_torch.ops import metrics as metrics_mod
    from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device
    from pnp_admm_cnc_mri_torch.utils import logger as logger_mod

    device = resolve_device("cpu" if args.cpu else None)
    split = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t = time.perf_counter()
    imgs01, truth, _ = images.load_testset(os.path.join(images.DEFAULT_TESTSETS, args.testset))
    mask_names = list(cfg_mod.MASK_NAMES) if args.masks == "all" else args.masks.split(",")
    masks_dict = {n: masks_mod.load_mask(n) for n in mask_names}
    base_noise = noise_mod.load_noise()
    sigma_scales = [float(s) for s in args.sigmas.split(",")]
    split["load"] = time.perf_counter() - t

    t = time.perf_counter()
    ys, ms, idxs, labels = build_grid(imgs01, masks_dict, sigma_scales, base_noise)
    if args.repeat > 1:
        ys = np.concatenate([ys] * args.repeat)
        ms = np.concatenate([ms] * args.repeat)
        idxs = np.concatenate([idxs] * args.repeat)
        labels = labels * args.repeat
    split["grid"] = time.perf_counter() - t
    run, iters = _solver(args, device)

    t = time.perf_counter()
    y_d, m_d = torch.as_tensor(ys, device=device), torch.as_tensor(ms, device=device)
    sync()
    split["h2d"] = time.perf_counter() - t
    del ys, ms

    t0 = time.perf_counter()
    x, res = run(y_d, m_d)
    # per-scenario relative residual at the last iteration
    rel = res[-1] / (torch.sqrt(torch.sum(x**2, dim=(-2, -1))) + 1e-12)
    sync()
    dt = time.perf_counter() - t0
    split["solve"] = dt

    t = time.perf_counter()
    truth_d = torch.as_tensor(truth, device=device)[torch.as_tensor(idxs, device=device)]
    psnr = metrics_mod.psnr(x * 255.0, truth_d).cpu().numpy()
    rel = rel.cpu().numpy()
    converged = float((rel < args.tol).mean())
    split["score"] = time.perf_counter() - t
    n = len(labels)
    summary = {
        "scenarios": n,
        "devices": 1,
        "iters": iters,
        "wall_s": round(dt, 3),
        "scenario_iters_per_s": round(n * iters / dt, 1),
        "avg_psnr": round(float(psnr.mean()), 3),
        "converged_fraction": round(converged, 4),
        "tol": args.tol,
    }
    print(json.dumps(summary))
    t = time.perf_counter()
    if args.out:
        # the sweep's argv on every row: a row is reproducible from its own record
        prov = list(argv) if argv is not None else sys.argv[1:]
        for lbl, p_, r_ in zip(labels, psnr, rel):
            logger_mod.append_record(args.out, {"scenario": lbl, "psnr": float(p_), "residual": float(r_),
                                                "argv": prov})
    split["records"] = time.perf_counter() - t
    if timings is not None:
        timings.update(split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
