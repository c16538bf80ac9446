"""Scenario-grid sweep: images x masks x noise levels, split over the ranks.

Port of the JAX package's ``cli/sweep.py`` (BASELINE.json config 5: a
512-image x 3-mask x noise-level grid). The grid is padded to a multiple of
the mesh's ``data`` axis (``parallel/mesh.py``), and each rank builds,
solves and scores only its own rows, in one batched call on its device (the
CUDA card, or the CPU with ``--cpu``). Rank 0 gathers the PSNRs and the
final relative residuals, drops the padding, prints the summary with the
converged fraction and writes the records. Without a launched world it is
one rank on one device.

    python -m pnp_admm_cnc_mri_torch.cli.sweep --algo admm_l1 \\
        --testset set --masks all --sigmas 1,3,5 --tol 1e-3
    torchrun --nproc_per_node N -m pnp_admm_cnc_mri_torch.cli.sweep ...

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


def build_grid(imgs01, masks_dict, sigma_scales, base_noise, rows=None):
    """Cartesian scenario grid -> ys (S, H, W) complex64, masks (S, H, W)
    float32, truth_idx (S,) and labels, S = n_sigmas * n_masks * n_images,
    sigma outermost and image innermost. ``rows`` (indices into that grid)
    builds only those scenarios, in that order.

    The grid is filled ``CHUNK`` images at a time: their FFT (the same per
    image as the batch's), then for each (sigma, mask) block ``fimg * mask
    + base_noise * scale`` in complex128, cast into the preallocated
    complex64 grid. These are the JAX package's elementwise operations in
    its order, so any row is bit-equal to its scenario-at-a-time list,
    without its complex128 copy of the whole grid.
    """
    n = imgs01.shape[0]
    mask_items = list(masks_dict.items())
    blocks = [(scale, mname, mask) for scale in sigma_scales for mname, mask in mask_items]
    rows = np.arange(len(blocks) * n) if rows is None else np.asarray(rows)
    block_of, img_of = rows // n, rows % n
    ys = np.empty((len(rows), *imgs01.shape[-2:]), dtype=np.complex64)
    ms = np.empty(ys.shape, dtype=np.float32)
    noise_at = {scale: base_noise * scale for scale in sigma_scales}
    for c in range(0, n, CHUNK):
        in_chunk = (img_of >= c) & (img_of < c + CHUNK)
        if not in_chunk.any():
            continue
        fimg = np.fft.fft2(imgs01[c:c + CHUNK], axes=(-2, -1))
        for b, (scale, _, mask) in enumerate(blocks):
            sel = np.flatnonzero(in_chunk & (block_of == b))
            if len(sel):
                src = img_of[sel] - c
                if np.array_equal(src, np.arange(src[0], src[0] + len(src))):
                    src = slice(src[0], src[0] + len(src))  # a view, no copy
                part = np.multiply(fimg[src], mask)
                part += noise_at[scale]
                ys[sel] = part
    for b, (_, _, mask) in enumerate(blocks):
        ms[block_of == b] = mask
    return ys, ms, img_of, grid_labels(list(masks_dict), sigma_scales, n, rows)


def grid_labels(mask_names, sigma_scales, n_images: int, rows=None) -> list:
    """``build_grid``'s scenario labels, ``img{i}_{mask}_s{scale}``."""
    blocks = [(scale, mname) for scale in sigma_scales for mname in mask_names]
    rows = range(len(blocks) * n_images) if rows is None else rows
    return [f"img{r % n_images}_{blocks[r // n_images][1]}_s{blocks[r // n_images][0]}" for r in rows]


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
    """Run the sweep of ``argv`` (``sys.argv[1:]`` when None): rank 0 prints
    the one-line JSON summary and, with ``--out``, appends one JSONL record
    a scenario. Launched by torchrun, the process joins the world first
    (``mesh.init_from_env``); in a world already initialized it takes the
    world as it is. ``timings``, when given, receives this rank's split of
    the run in seconds: ``load`` (testset, masks, noise), ``grid``
    (``build_grid`` of its rows), ``h2d`` (y and the masks to the device),
    ``solve`` (the summary's ``wall_s``: the batched solve and the relative
    residuals, to their end on the device, and their gather over the
    ranks), ``score`` (PSNR, its gather and the converged fraction) and
    ``records``."""
    args = _parser().parse_args(argv)

    import torch
    import torch.distributed as dist

    from pnp_admm_cnc_mri_torch import config as cfg_mod
    from pnp_admm_cnc_mri_torch.data import images, masks as masks_mod, noise as noise_mod
    from pnp_admm_cnc_mri_torch.ops import metrics as metrics_mod
    from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib
    from pnp_admm_cnc_mri_torch.utils import logger as logger_mod

    device = mesh_lib.mesh_device("cpu" if args.cpu else None)
    if mesh_lib.launched() and not dist.is_initialized():
        mesh_lib.init_from_env(device)
    mesh = mesh_lib.make_mesh(device=device)
    n_dev = mesh.shape["data"]
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
    # the grid repeated --repeat times, padded to a multiple of the ranks
    # (JAX's pad_to_multiple: index i % n); this rank's rows of it
    n_grid = len(sigma_scales) * len(masks_dict) * imgs01.shape[0]
    true_n = n_grid * args.repeat
    padded, _ = mesh_lib.pad_to_multiple(np.arange(true_n), n_dev)
    per = len(padded) // n_dev
    mine = padded[mesh.coords["data"] * per:(mesh.coords["data"] + 1) * per] % n_grid
    ys, ms, idxs, _ = build_grid(imgs01, masks_dict, sigma_scales, base_noise, rows=mine)
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
    rel = mesh_lib.gather_batch(rel, mesh)[:true_n]
    sync()
    dt = time.perf_counter() - t0
    split["solve"] = dt

    t = time.perf_counter()
    truth_d = torch.as_tensor(truth, device=device)[torch.as_tensor(idxs, device=device)]
    psnr = mesh_lib.gather_batch(metrics_mod.psnr(x * 255.0, truth_d), mesh)[:true_n].cpu().numpy()
    rel = rel.cpu().numpy()
    converged = float((rel < args.tol).mean())
    split["score"] = time.perf_counter() - t
    t = time.perf_counter()
    if mesh.coords["data"] == 0:
        print(json.dumps({
            "scenarios": true_n,
            "devices": n_dev,
            "iters": iters,
            "wall_s": round(dt, 3),
            "scenario_iters_per_s": round(true_n * iters / dt, 1),
            "avg_psnr": round(float(psnr.mean()), 3),
            "converged_fraction": round(converged, 4),
            "tol": args.tol,
        }))
        if args.out:
            # the sweep's argv on every row: a row is reproducible from its own record
            prov = list(argv) if argv is not None else sys.argv[1:]
            labels = grid_labels(list(masks_dict), sigma_scales, imgs01.shape[0]) * args.repeat
            for lbl, p_, r_ in zip(labels, psnr, rel):
                logger_mod.append_record(args.out, {"scenario": lbl, "psnr": float(p_), "residual": float(r_),
                                                    "argv": prov})
    split["records"] = time.perf_counter() - t
    if timings is not None:
        timings.update(split)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
