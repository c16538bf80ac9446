"""Command-line entry point of the PyTorch port.

Port of the JAX package's ``cli/main.py``: the same nineteen algorithms,
every flag with its default and ``dest``, and the same JSON result line
(mirroring the reference's experiment scripts with real flags instead of
integer indices edited in module bodies, reference ``【3】:375-378``):

    python -m pnp_admm_cnc_mri_torch.cli.main admm_l1  --mask Q_Random30 --testset set1
    python -m pnp_admm_cnc_mri_torch.cli.main admm_cnc --mask Q_Cartesian30 --alpha 0.45 --b 64
    python -m pnp_admm_cnc_mri_torch.cli.main pnp_l1_d   --model dncnn_25 --weights model_zoo/dncnn_25.npz
    python -m pnp_admm_cnc_mri_torch.cli.main pnp_cnc_d  --model drunet_gray ...
    python -m pnp_admm_cnc_mri_torch.cli.main pnp_l1_bm3d / pnp_cnc_bm3d

Every run takes the CUDA card; without one it stops, unless ``--cpu`` asks
for the CPU. ``--f64`` runs in float64 (complex128), on the card or the
CPU; ``--bf16`` runs the denoisers' convolutions in bfloat16. Weights are
the ``.npz`` trees of ``model_zoo/`` (``--weights``, ``--clean``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import warnings

from pnp_admm_cnc_mri_torch.config import DEBLUR_KERNELS

ALGOS = (
    "admm_l1", "admm_cnc", "pnp_l1_bm3d", "pnp_cnc_bm3d", "pnp_l1_d", "pnp_cnc_d", "consensus_l1", "consensus_d",
    "consensus_fista_d", "consensus_hqs_d", "pnp_sr", "pnp_deblur", "fista_l1", "pnp_fista_d", "pnp_hqs_d", "red_d",
    "pgd_l1", "pnp_pgd_d", "pnp_pgd_cnc",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pnp_admm_cnc_mri_torch")
    p.add_argument("algo", choices=list(ALGOS))
    p.add_argument("--red_variant", default="fp", choices=["fp", "gd"],
                   help="red_d only: fixed-point (implicit, default) or explicit gradient-descent RED iteration")
    p.add_argument("--step", type=float, default=None,
                   help="fista_l1/pnp_fista_d/consensus_fista_d: gradient step size (the data-term Lipschitz "
                        "constant is exactly 1, so 1.0 is canonical; default: tuned registry value under --tuned, "
                        "else 1.0)")
    p.add_argument("--sf", type=int, default=2, help="pnp_sr only: super-resolution factor")
    p.add_argument("--kernel", default="aniso", choices=list(DEBLUR_KERNELS), help="pnp_deblur only: blur kernel")
    p.add_argument("--noise_sigma", type=float, default=None,
                   help="pnp_sr/pnp_deblur: degradation noise sigma on the [0,255] scale (defaults: sr 1.5, "
                        "deblur 2.55); pnp_hqs_d: the alpha-ladder scale (default 10)")
    p.add_argument("--testset", default="set1")
    p.add_argument("--images", default=None,
                   help="comma-separated image stems (e.g. '05,11') to restrict the testset; observations match "
                        "the full-set batch slots exactly")
    p.add_argument("--mask", default="Q_Random30")
    p.add_argument("--iter_num", type=int, default=None)
    p.add_argument("--lambda1", dest="lam", type=float, default=None)
    p.add_argument("--reo", dest="rho", type=float, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--b", type=float, default=None)
    p.add_argument("--tol", type=float, default=None, help="optional stop tolerance")
    p.add_argument("--model", default="dncnn_25", help="denoiser model name")
    p.add_argument("--model2", default=None, help="second denoiser (CNC slot 2)")
    p.add_argument("--weights", default=None, help=".npz weights path")
    p.add_argument("--weights2", default=None)
    p.add_argument("--testsets_dir", default=None)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--results_dir", default="results")
    p.add_argument("--no_save", action="store_true")
    p.add_argument("--bf16", action="store_true", help="run the denoiser conv stack in bfloat16")
    p.add_argument("--clean", action="store_true",
                   help="use the leakage-free model_zoo/<name>_clean.npz weights (trained on a corpus disjoint "
                        "from the evaluation testsets) and, with --tuned, the TUNED_*_CLEAN settings swept for them")
    p.add_argument("--tuned", action="store_true",
                   help="apply the framework's tuned settings for this algorithm/model (config.TUNED_*) instead "
                        "of the reference defaults; explicit flags still override")
    p.add_argument("--nlm", type=float, default=None,
                   help="denoiser noise-level / sigma-ladder endpoint on the reference's [0,255] scale "
                        "(default: per-model 15)")
    p.add_argument("--model_sigma1", type=float, default=None,
                   help="sigma-ladder start for drunet/ircnn schedules (reference utils_pnp.py:14 default 49)")
    p.add_argument("--x8", action="store_true",
                   help="x8 dihedral augmentation for the denoiser prior (default ON for pnp_l1_d drunet, like "
                        "the reference)")
    p.add_argument("--no_x8", action="store_true", help="force x8 off")
    p.add_argument("--f64", action="store_true", help="float64 (complex128), on the card or the CPU")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the CUDA card)")
    p.add_argument("--nc", type=int, default=None,
                   help="override the denoiser conv width (custom-width checkpoints, e.g. tdnet variants)")
    p.add_argument("--nb", type=int, default=None, help="override the denoiser depth (custom-depth checkpoints)")
    return p


def _arch_overrides(args) -> dict:
    """--nc/--nb overrides for build_denoiser (custom-architecture
    checkpoints; parity models keep their fixed defaults when unset)."""
    kw = {}
    if getattr(args, "nc", None):
        kw["nc"] = args.nc
    if getattr(args, "nb", None):
        kw["nb"] = args.nb
    return kw


def _resolve_step(args, tuned=None) -> float:
    """Explicit --step always wins (even --step 1.0); otherwise the tuned
    registry's step, else the canonical 1.0 (L=1 data term)."""
    if args.step is not None:
        return args.step
    return (tuned or {}).get("step", 1.0)


def _warn_bm3d_ignored(args) -> None:
    """Warn on CNN-only knobs passed with --model bm3d (same policy as the
    restoration pipelines' _restoration_prior)."""
    ignored = [name for name, v in
               (("--weights", args.weights), ("--x8", args.x8), ("--bf16", args.bf16), ("--clean", args.clean),
                ("--model_sigma1", args.model_sigma1), ("--model2", args.model2), ("--weights2", args.weights2))
               if v]
    if ignored:
        warnings.warn(f"--model bm3d ignores {', '.join(ignored)} (CNN-only knobs)", stacklevel=2)


def _merge_cfg(base, args):
    updates = {}
    for field in ("iter_num", "lam", "rho", "alpha", "b", "tol"):
        v = getattr(args, field)
        if v is not None:
            updates[field] = v
    return dataclasses.replace(base, **updates)


def _apply_tuned(base, tuned, args):
    """Apply a config.TUNED_* entry: ADMMConfig fields replace the base, the
    denoiser knob ``nlm`` backfills the flag (explicit flags win)."""
    from pnp_admm_cnc_mri_torch import config as cfg_mod

    cfg_keys = {f.name for f in dataclasses.fields(cfg_mod.ADMMConfig)}
    base = dataclasses.replace(base, **{k: v for k, v in tuned.items() if k in cfg_keys})
    if args.nlm is None:
        args.nlm = tuned.get("nlm")
    return base


def _x8(args, tuned) -> bool:
    """--x8 wins, then --no_x8, then the tuned registry's x8."""
    return args.x8 or (not args.no_x8 and tuned.get("x8", False))


def _bm3d_denoiser(nlm):
    """The white BM3D prox at sigma ``nlm`` on the [0, 255] scale (15 by default)."""
    from pnp_admm_cnc_mri_torch.priors import bm3d_prior

    return bm3d_prior.make_bm3d_denoiser(noise_var=((nlm if nlm is not None else 15.0) / 255.0) ** 2)


def _bm3d_ladder(sigma255, iter_num, ms1, ms2):
    """BM3D along the ``get_rho_sigma`` ladder of the HQS solvers."""
    from pnp_admm_cnc_mri_torch.ops import schedules
    from pnp_admm_cnc_mri_torch.priors import bm3d_prior

    _, sigmas = schedules.get_rho_sigma(sigma=sigma255 / 255.0, iter_num=iter_num, model_sigma1=ms1,
                                        model_sigma2=ms2)
    return bm3d_prior.make_bm3d_ladder_denoiser(sigmas)


def _consensus(args, dtype, device, build) -> dict:
    """The four multi-mask algorithms: one shared z across all three masks,
    the whole testset solved as one batch (the observation axis is -3)."""
    import numpy as np
    import torch

    from pnp_admm_cnc_mri_torch import config as cfg_mod
    from pnp_admm_cnc_mri_torch.cli import experiments
    from pnp_admm_cnc_mri_torch.data import images, masks as masks_mod, noise as noise_mod
    from pnp_admm_cnc_mri_torch.parallel import consensus

    imgs01, truth, names = images.load_testset(
        os.path.join(args.testsets_dir or images.DEFAULT_TESTSETS, args.testset))
    if args.images:
        idx = experiments._filter_only(names, args.images)
        imgs01, truth, names = imgs01[idx], truth[idx], [names[i] for i in idx]
    all_masks = np.stack(list(masks_mod.load_all_masks(data_dir=args.data_dir).values()))
    kn = noise_mod.load_noise(args.data_dir)
    z_prox, algo_tag, iters = None, args.algo, None
    clip = lambda d: (lambda v, i: torch.clamp(d(v, i), 0.0, 1.0))  # noqa: E731
    if args.algo == "consensus_fista_d":
        # union-preconditioned multi-mask FISTA with a denoiser prox
        tuned = cfg_mod.TUNED_CONSENSUS_FISTA.get(args.model, {}) if args.tuned else {}
        iters = args.iter_num or tuned.get("iter_num", 30)
        nlm = args.nlm if args.nlm is not None else tuned.get("nlm")
        if args.model == "bm3d":
            _warn_bm3d_ignored(args)
            denoise = _bm3d_denoiser(nlm)
        else:
            ms1 = args.model_sigma1 if args.model_sigma1 is not None else tuned.get("model_sigma1")
            denoise = build(args.model, args.weights, iters, _x8(args, tuned), nlm,
                            {} if ms1 is None else {"model_sigma1": ms1})
        z_prox = clip(denoise)
        algo_tag = f"consensus_fista_{args.model}"
        base = cfg_mod.ADMM_L1_DEFAULT  # unused by the FISTA path
    elif args.algo == "consensus_hqs_d":
        # multi-mask HQS: the exact joint k-space data solve and the DPIR ladder denoiser
        tuned = cfg_mod.TUNED_CONSENSUS_HQS.get(args.model, {}) if args.tuned else {}
        iters = args.iter_num or tuned.get("iter_num", 30)
        nlm = args.nlm if args.nlm is not None else tuned.get("nlm")
        hqs_sigma255 = args.noise_sigma if args.noise_sigma is not None else tuned.get("sigma255", 10.0)
        hqs_ms1 = args.model_sigma1 if args.model_sigma1 is not None else tuned.get("model_sigma1", 49.0)
        hqs_ms2 = nlm if nlm is not None else 15.0
        if args.model == "bm3d":
            _warn_bm3d_ignored(args)
            denoise = _bm3d_ladder(hqs_sigma255, iters, hqs_ms1, hqs_ms2)
        else:
            denoise = build(args.model, args.weights, iters, _x8(args, tuned), nlm, {"model_sigma1": hqs_ms1})
        algo_tag = f"consensus_hqs_{args.model}"
        base = cfg_mod.ADMM_L1_DEFAULT  # unused by the HQS path
    elif args.algo == "consensus_d":
        it, rho = cfg_mod.PNP_L1_DEFAULTS.get(args.model, (50, 0.25))
        base = cfg_mod.ADMMConfig(iter_num=it, rho=rho)
        if args.tuned:
            treg = cfg_mod.TUNED_CONSENSUS_D_CLEAN if args.clean else {}
            entry = treg.get(args.model) or cfg_mod.TUNED_CONSENSUS_D.get(args.model)
            if entry:
                base = _apply_tuned(base, entry, args)
        cfg0 = _merge_cfg(base, args)
        extra = {} if args.model_sigma1 is None else {"model_sigma1": args.model_sigma1}
        z_prox = clip(build(args.model, args.weights, cfg0.iter_num, args.x8, args.nlm, extra))
        algo_tag = f"consensus_d_{args.model}"
    else:
        base = cfg_mod.ADMM_L1_DEFAULT
    cfg = _merge_cfg(base, args)

    t0 = time.perf_counter()
    # the observations on the host in complex128, cast there to the working
    # type and copied to the device once, as the JAX package does
    ys_all = np.fft.fft2(imgs01, axes=(-2, -1))[:, None] * all_masks + kn
    ys = experiments.device_complex(ys_all, dtype, device)
    m = torch.as_tensor(all_masks.astype(experiments._HOST_TYPES[dtype][0]), device=device)
    if args.algo == "consensus_fista_d":
        # the consensus z_prox is (v, i); the FISTA prox_fn is (i, u)
        z = consensus.run_consensus_fista(ys, m, iters, lambda i, u: z_prox(u, i), step=_resolve_step(args),
                                          dtype=dtype, device=device)
    elif args.algo == "consensus_hqs_d":
        z = consensus.run_consensus_hqs(ys, m, iters, denoise, sigma255=hqs_sigma255, model_sigma1=hqs_ms1,
                                        model_sigma2=hqs_ms2, dtype=dtype, device=device)
    else:
        z, _ = consensus.run_consensus(ys, m, cfg, z_prox=z_prox, dtype=dtype, device=device)
    # scored where z lies, as the JAX package scores on its default device
    out = experiments.score_and_log(z, truth, names, f"{args.testset}_dn_{algo_tag}_all_masks", args.results_dir,
                                    not args.no_save)
    out["wall_s"] = time.perf_counter() - t0
    out["images"] = len(names)
    out["iters"] = iters or cfg.iter_num
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from pnp_admm_cnc_mri_torch import config as cfg_mod
    from pnp_admm_cnc_mri_torch.cli import experiments
    from pnp_admm_cnc_mri_torch.priors import denoiser as denoiser_mod
    from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    dtype = torch.float64 if args.f64 else torch.float32
    common = dict(
        testset=args.testset,
        mask_name=args.mask,
        testsets_dir=args.testsets_dir,
        data_dir=args.data_dir,
        results_dir=args.results_dir,
        save_images=not args.no_save,
        only=args.images,
        device=device,
    )

    def build(name, weights, iter_num, x8, nlm, extra):
        """A model-zoo denoiser in the run's dtype on its device."""
        return denoiser_mod.build_denoiser(
            name,
            weights=denoiser_mod.resolve_weights(name, weights, clean=args.clean),
            iter_num=iter_num, x8=x8,
            compute_dtype=torch.bfloat16 if args.bf16 else None,
            noise_level_model=denoiser_mod.nlm_for_model(name, nlm),
            param_dtype=dtype, device=device,
            **extra,
            **_arch_overrides(args),
        )

    if args.algo in ("consensus_l1", "consensus_d", "consensus_fista_d", "consensus_hqs_d"):
        out = _consensus(args, dtype, device, build)
    elif args.algo in ("pnp_sr", "pnp_deblur"):
        runner = experiments.run_sr if args.algo == "pnp_sr" else experiments.run_deblur
        extra = {"sf": args.sf} if args.algo == "pnp_sr" else {"kernel": args.kernel}
        if args.noise_sigma is not None:
            extra["noise_sigma255"] = args.noise_sigma
        tuned = {}
        if args.tuned:
            if args.algo == "pnp_sr":
                treg, creg = cfg_mod.TUNED_SR, cfg_mod.TUNED_SR_CLEAN
            else:
                treg, creg = cfg_mod.TUNED_DEBLUR, cfg_mod.TUNED_DEBLUR_CLEAN
            tuned = (creg.get(args.model) if args.clean else None) or treg.get(args.model, {})
        # float32 whatever --f64 says, as in the JAX package
        out = runner(
            model_name=args.model,
            iter_num=args.iter_num or tuned.get("iter_num", 8),
            nlm=args.nlm if args.nlm is not None else tuned.get("nlm"),
            testset=args.testset,
            **extra,
            testsets_dir=args.testsets_dir,
            results_dir=args.results_dir,
            save_images=not args.no_save,
            weights=args.weights,
            x8=args.x8,
            model_sigma1=args.model_sigma1 if args.model_sigma1 is not None else tuned.get("model_sigma1"),
            bf16=args.bf16,
            clean=args.clean,
            only=args.images,
            device=device,
        )
    elif args.algo in ("fista_l1", "pgd_l1"):
        momentum = args.algo == "fista_l1"
        tuned = cfg_mod.TUNED_PGD_L1 if (args.tuned and not momentum) else {}
        out = experiments.run_fista_l1(
            iter_num=args.iter_num or tuned.get("iter_num", 50),
            lam=args.lam if args.lam is not None else tuned.get("lam", 1e-4),
            step=_resolve_step(args, tuned),
            momentum=momentum, dtype=dtype, **common,
        )
    elif args.algo in ("pnp_fista_d", "pnp_pgd_d"):
        reg = cfg_mod.TUNED_FISTA_D if args.algo == "pnp_fista_d" else cfg_mod.TUNED_PGD_D
        tuned = reg.get(args.model, {}) if args.tuned else {}
        it = args.iter_num or tuned.get("iter_num", 30)
        nlm = args.nlm if args.nlm is not None else tuned.get("nlm")
        if args.model == "bm3d":
            # the weight-free BM3D prox; --nlm is its sigma on the [0,255] scale
            _warn_bm3d_ignored(args)
            denoise = _bm3d_denoiser(nlm)
        else:
            ms1 = args.model_sigma1 if args.model_sigma1 is not None else tuned.get("model_sigma1")
            denoise = build(args.model, args.weights, it, _x8(args, tuned), nlm,
                            {} if ms1 is None else {"model_sigma1": ms1})
        tag = "pnp_fista" if args.algo == "pnp_fista_d" else "pnp_pgd"
        out = experiments.run_pnp_fista(
            denoise, it, step=_resolve_step(args, tuned), dtype=dtype, momentum=args.algo == "pnp_fista_d",
            result_tag=f"{tag}_{args.model}", **common,
        )
    elif args.algo == "pnp_pgd_cnc":
        tuned = cfg_mod.TUNED_PGD_CNC.get(args.model, {}) if args.tuned else {}
        it = args.iter_num or tuned.get("iter_num", 30)
        nlm = args.nlm if args.nlm is not None else tuned.get("nlm")
        alpha = args.alpha if args.alpha is not None else tuned.get("alpha", 1.2)
        lam = args.lam if args.lam is not None else tuned.get("lam", 0.02)
        b = args.b if args.b is not None else tuned.get("b", 36.0)
        if args.model == "bm3d":
            _warn_bm3d_ignored(args)
            denoise, denoise2 = _bm3d_denoiser(nlm), None
        else:
            ms1 = args.model_sigma1 if args.model_sigma1 is not None else tuned.get("model_sigma1")
            extra = {} if ms1 is None else {"model_sigma1": ms1}
            x8 = _x8(args, tuned)
            denoise = build(args.model, args.weights, it, x8, nlm, extra)
            denoise2 = build(args.model2, args.weights2, it, x8, nlm, extra) if args.model2 else None
        out = experiments.run_pnp_pgd_cnc(
            denoise, it, denoise2=denoise2, alpha=alpha, lam=lam, b=b, step=_resolve_step(args, tuned),
            dtype=dtype, result_tag=f"pnp_pgd_cnc_{args.model}", **common,
        )
    elif args.algo == "pnp_hqs_d":
        tuned = cfg_mod.TUNED_HQS_D.get(args.model, {}) if args.tuned else {}
        it = args.iter_num or tuned.get("iter_num", 30)
        nlm = args.nlm if args.nlm is not None else tuned.get("nlm")
        sigma255 = args.noise_sigma if args.noise_sigma is not None else tuned.get("sigma255", 10.0)
        ms1 = args.model_sigma1 if args.model_sigma1 is not None else tuned.get("model_sigma1", 49.0)
        ms2 = nlm if nlm is not None else 15.0
        if args.model == "bm3d":
            # BM3D along the ladder, sigma_k decaying as the restoration pipelines' bm3d prior
            _warn_bm3d_ignored(args)
            denoise = _bm3d_ladder(sigma255, it, ms1, ms2)
        else:
            denoise = build(args.model, args.weights, it, _x8(args, tuned), nlm, {"model_sigma1": ms1})
        out = experiments.run_pnp_hqs(
            denoise, it, sigma255=sigma255, model_sigma1=ms1, model_sigma2=ms2, dtype=dtype,
            result_tag=f"pnp_hqs_{args.model}", **common,
        )
    elif args.algo == "red_d":
        tuned = cfg_mod.TUNED_RED_D.get(args.model, {}) if args.tuned else {}
        it = args.iter_num or tuned.get("iter_num", 50)
        lam = args.lam if args.lam is not None else tuned.get("lam", 0.3)
        nlm = args.nlm if args.nlm is not None else tuned.get("nlm")
        if args.model == "bm3d":
            _warn_bm3d_ignored(args)
            denoise = _bm3d_denoiser(nlm)
        else:
            # RED uses a constant-strength denoiser: the sigma ladder starts at
            # its endpoint (model_sigma1 = nlm) unless a decaying ladder is asked for
            ms1 = args.model_sigma1
            if ms1 is None and nlm is not None:
                ms1 = nlm
            denoise = build(args.model, args.weights, it, _x8(args, tuned), nlm,
                            {} if ms1 is None else {"model_sigma1": ms1})
        out = experiments.run_red(
            denoise, it, lam=lam, step=_resolve_step(args, tuned), variant=args.red_variant, dtype=dtype,
            result_tag=f"red_{args.model}", **common,
        )
    elif args.algo in ("admm_l1", "admm_cnc"):
        base = cfg_mod.ADMM_L1_DEFAULT if args.algo == "admm_l1" else cfg_mod.ADMM_CNC_DEFAULT
        out = experiments.run_classical(args.algo, cfg=_merge_cfg(base, args), dtype=dtype, **common)
    elif args.algo in ("pnp_l1_bm3d", "pnp_cnc_bm3d"):
        from pnp_admm_cnc_mri_torch.priors import bm3d_prior

        base = cfg_mod.PNP_L1_BM3D_DEFAULT if args.algo == "pnp_l1_bm3d" else cfg_mod.PNP_CNC_BM3D_DEFAULT
        if args.tuned:
            base = _apply_tuned(base, cfg_mod.TUNED_BM3D[args.algo], args)
        cfg = _merge_cfg(base, args)
        # --nlm is the BM3D sigma on the reference's [0,255] scale (default:
        # the reference's get_experiment_noise var 0.03, sigma sqrt(0.03))
        if args.nlm is not None:
            denoise = bm3d_prior.make_bm3d_denoiser(noise_var=(args.nlm / 255.0) ** 2)
        else:
            denoise = bm3d_prior.make_bm3d_denoiser()
        out = experiments.run_pnp(
            denoise, cfg, scheme="l1" if args.algo == "pnp_l1_bm3d" else "cnc", clamp=False,
            result_tag=args.algo, dtype=dtype, **common,
        )
    else:
        if args.algo == "pnp_l1_d":
            it, rho = cfg_mod.PNP_L1_DEFAULTS.get(args.model, (50, 0.25))
            base = cfg_mod.ADMMConfig(iter_num=it, rho=rho)
            treg, creg = cfg_mod.TUNED_PNP_L1, cfg_mod.TUNED_PNP_L1_CLEAN
            key = args.model
        else:
            key = "dncnn_pair" if (args.model2 and "dncnn" in args.model) else args.model
            a, it, lam, rho, b = cfg_mod.PNP_CNC_DEFAULTS.get(key, (0.9, 50, 0.2, 0.45, 0.3))
            base = cfg_mod.ADMMConfig(iter_num=it, lam=lam, rho=rho, alpha=a, b=b)
            treg, creg = cfg_mod.TUNED_PNP_CNC, cfg_mod.TUNED_PNP_CNC_CLEAN
        tuned = {}
        if args.tuned:
            tuned = (creg.get(key) if args.clean else None) or treg.get(key, {})
        if tuned:
            base = _apply_tuned(base, tuned, args)
        cfg = _merge_cfg(base, args)
        # the reference runs DRUNet with per-iteration x8 cycling in 【3】
        # (x8 survives only its drunet branch) and without it in 【6】 (CNC)
        x8 = args.x8 or (args.algo == "pnp_l1_d" and "drunet" in args.model)
        if tuned and not args.x8:
            x8 = tuned.get("x8", x8)
        if args.no_x8:
            x8 = False
        extra = {} if args.model_sigma1 is None else {"model_sigma1": args.model_sigma1}
        denoise = build(args.model, args.weights, cfg.iter_num, x8, args.nlm, extra)
        denoise2 = build(args.model2, args.weights2, cfg.iter_num, x8, args.nlm, extra) if args.model2 else None
        out = experiments.run_pnp(
            denoise, cfg, scheme="l1" if args.algo == "pnp_l1_d" else "cnc", denoise2=denoise2, clamp=True,
            round_uint8=args.algo == "pnp_cnc_d", result_tag=f"{args.algo}_{args.model}", dtype=dtype, **common,
        )

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
