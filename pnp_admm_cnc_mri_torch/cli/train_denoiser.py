"""CLI: train a denoiser prior and save its npz weights.

Port of the JAX package's ``cli/train_denoiser.py``, every flag:

    python -m pnp_admm_cnc_mri_torch.cli.train_denoiser \
        --model dncnn --sigma 15 --steps 2000 --out model_zoo/dncnn_15.npz

It trains on the CUDA card, or on the CPU with ``--cpu`` (without a card
and without ``--cpu`` it stops). The npz holds the JAX package's Flax keys
(``models/convert.save_npz``), so it loads into the PnP pipelines of both
packages: here ``priors/denoiser.build_denoiser(name, weights=...)``,
there ``convert.load_npz``. ``--mesh`` (the sharded trainer) waits for the
port's ``torch.distributed`` slice.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a denoiser prior (PyTorch port) and save npz weights.")
    p.add_argument("--model", default="dncnn", choices=["dncnn", "fdncnn", "ircnn", "ffdnet", "drunet", "tdnet"])
    p.add_argument("--sigma", type=float, default=15.0, help="noise level /255")
    p.add_argument("--sigma_max", type=float, default=None, help="if set, sample sigma in [--sigma, --sigma_max]")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--patch", type=int, default=40)
    p.add_argument("--multiscale", action="store_true", help="extract patches at scales (1.0, 0.75, 0.5)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--trainset", default=None, help="dir of training images")
    p.add_argument("--exclude", default=None,
                   help="comma list of image basenames to EXCLUDE from training (leakage-free evaluation)")
    p.add_argument("--out", required=True)
    p.add_argument("--cpu", action="store_true", help="train on the CPU (default: the CUDA card)")
    p.add_argument("--nc", type=int, default=64)
    p.add_argument("--nb", type=int, default=None)
    p.add_argument("--mesh", action="store_true", help="shard over all devices (not ported yet: raises)")
    p.add_argument("--lr_decay", choices=["cosine"], default=None, help="anneal the learning rate over the run")
    p.add_argument("--ckpt_every", type=int, default=0, help="save the npz every N steps")
    p.add_argument("--bundle", action="store_true",
                   help="ircnn only: train all 25 noise-bin models (sigma255 = 1,3,...,49), warm-starting each bin "
                        "from its neighbor, and save one stacked npz for the ircnn_gray PnP adapter")
    p.add_argument("--bundle_steps", type=int, default=800, help="fine-tune steps per non-center bin (--bundle)")
    p.add_argument("--scan_steps", type=int, default=1,
                   help="--ondevice/--synth: optimizer steps per megastep (losses read once a megastep, "
                        "checkpoints at its end; the JAX package's lax.scan accounting)")
    p.add_argument("--ondevice", action="store_true",
                   help="stage the patch corpus on the device once and draw each batch, augmentation and noise "
                        "there")
    p.add_argument("--resume", default=None, help="npz checkpoint to warm-start from")
    p.add_argument("--ema", type=float, default=None,
                   help="EMA decay for weight averaging (e.g. 0.999); the averaged weights are saved "
                        "(--ondevice, --synth)")
    p.add_argument("--extra_images", default=None,
                   help="comma list of extra grayscale image files for the patch corpus (PNGs; .mat loads its "
                        "first variable)")
    p.add_argument("--synth", type=int, default=0,
                   help="train on a procedural corpus of this many images made on the device (train/synth.py: "
                        "dead leaves, 1/f fields, MRI phantoms, elastic warps). Replaces --trainset.")
    p.add_argument("--synth_size", type=int, default=128, help="generated image side (--synth)")
    p.add_argument("--synth_refresh", type=int, default=0,
                   help="regenerate the corpus every N steps (0 = a fixed corpus)")
    p.add_argument("--synth_disks", type=int, default=600, help="dead-leaves disk count per image (--synth)")
    p.add_argument("--distill", default=None,
                   help="npz of a DRUNet (UNetRes) teacher: the student regresses the teacher's output on the same "
                        "noisy batch (--synth only)")
    p.add_argument("--distill_weight", type=float, default=0.7,
                   help="loss blend: w*MSE(student,teacher) + (1-w)*MSE(student,clean)")
    return p


def _corpus(args):
    """The patch corpus of ``--trainset`` (minus ``--exclude``) and ``--extra_images``."""
    import numpy as np

    from pnp_admm_cnc_mri_torch.data import images
    from pnp_admm_cnc_mri_torch.train import data as data_mod

    trainset = args.trainset or os.path.join(images.DEFAULT_TESTSETS, "set")
    imgs01, names = images.load_images_dir(trainset)
    if args.exclude:
        skip = set(args.exclude.split(","))
        imgs01 = [im for im, n in zip(imgs01, names) if n not in skip]
    corpus_imgs = list(imgs01)
    if args.extra_images:
        for path in args.extra_images.split(","):
            path = path.strip()
            if path.endswith(".mat"):
                import scipy.io as sio

                arrs = {k: v for k, v in sio.loadmat(path).items() if not k.startswith("__")}
                arr = np.abs(np.asarray(next(iter(arrs.values())), np.float64))
                if arr.ndim == 3:
                    arr = arr.mean(axis=-1)
                arr = arr / max(float(arr.max()), 1e-12)
            else:
                arr = images.uint2single(images.imread_gray(path))
            corpus_imgs.append(np.asarray(arr, np.float32))
    if args.multiscale:
        return data_mod.extract_patches_multiscale(corpus_imgs, patch=args.patch)
    return data_mod.extract_patches(corpus_imgs, patch=args.patch)


def _model(args):
    """(module, conditioned, ffdnet_style) of ``--model``."""
    from pnp_admm_cnc_mri_torch.models.dncnn import DnCNN, FDnCNN, IRCNN
    from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
    from pnp_admm_cnc_mri_torch.models.ffdnet import FFDNet
    from pnp_admm_cnc_mri_torch.models.tdnet import TDNet

    if args.model == "dncnn":
        return DnCNN(1, 1, nc=args.nc, nb=args.nb or 17), False, False
    if args.model == "ircnn":
        return IRCNN(1, 1, nc=args.nc), False, False
    if args.model == "fdncnn":
        return FDnCNN(2, 1, nc=args.nc, nb=args.nb or 20), True, False
    if args.model == "ffdnet":
        return FFDNet(1, 1, nc=args.nc, nb=args.nb or 15), False, True
    if args.model == "tdnet":
        # TDNet's own width unless another is asked for; the same (x, sigma) call as FFDNet
        return TDNet(1, 1, nc=args.nc if args.nc != 64 else 128, nb=args.nb or 12), False, True
    return UNetRes(2, 1, nc=(64, 128, 256, 512), nb=args.nb or 4), True, False


def main(argv=None, timings=None) -> int:
    """Run the CLI. ``timings``, a dict, receives the run's split in seconds:
    ``setup_s`` (corpus, model, weights), ``train_s`` (the trainer call),
    within it ``synthesis_s`` (``--synth`` buffers) and ``checkpoint_s``
    (``--ckpt_every`` saves), and ``save_s`` (the final npz); the card is
    synchronized at each edge. ``--bundle`` runs fill nothing."""
    t0 = time.perf_counter()
    args = _parser().parse_args(argv)
    if args.mesh:
        from pnp_admm_cnc_mri_torch.train.trainer import MESH_TODO

        raise NotImplementedError(MESH_TODO)

    import numpy as np
    import torch

    from pnp_admm_cnc_mri_torch.models import convert
    from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device
    from pnp_admm_cnc_mri_torch.train import trainer

    device = resolve_device("cpu" if args.cpu else None)
    split = {"synthesis_s": 0.0, "checkpoint_s": 0.0}

    def sync_clock() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    patches = None if args.synth else _corpus(args)
    model, conditioned, ffdnet_style = _model(args)
    sigma = args.sigma / 255.0
    if args.sigma_max is not None:
        sigma = (sigma, args.sigma_max / 255.0)
    cfg = trainer.TrainConfig(learning_rate=args.lr, loss="l1" if args.model == "fdncnn" else "l2",
                              lr_decay=args.lr_decay)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save = convert.save_npz

    ckpt_cb = None
    if args.ckpt_every:
        def ckpt_cb(step, p, _path=args.out):
            t = sync_clock()
            save(p, _path)
            split["checkpoint_s"] += time.perf_counter() - t
            print(json.dumps({"ckpt": _path, "step": step}), flush=True)

    if args.bundle:
        if args.model != "ircnn":
            raise SystemExit("--bundle is only meaningful for --model ircnn")
        if args.synth:
            raise SystemExit("--bundle does not support --synth yet")
        # The reference's ircnn_gray checkpoint is 25 weight sets, one per noise
        # bin (bin i serves sigma255 in (2i, 2i+2], centre 2i+1). Train the middle
        # bin fully, then walk outward warm-starting each bin from its neighbour.
        center = 12
        bins: dict = {}

        def run_train(sig, steps, params=None, seed=0, ckpt_cb=None, ckpt_every=0):
            kw = dict(steps=steps, batch_size=args.batch, cfg=cfg, params=params, seed=seed, ckpt_cb=ckpt_cb,
                      ckpt_every=ckpt_every, device=device)
            if args.ondevice:
                return trainer.train_denoiser_ondevice(model, patches, sig, scan_steps=args.scan_steps, **kw)
            return trainer.train_denoiser(model, patches, sig, **kw)

        def stacked(states):
            return {k: torch.stack([s[k].detach().cpu() for s in states]) for k in states[0]}

        def save_bundle_ckpt(step, p, _path=args.out):
            # the one trained state in all 25 bins, so the file always loads as a bundle
            save(stacked([p] * 25), _path)
            print(json.dumps({"ckpt": _path, "step": step, "bin": center}), flush=True)

        p_c, losses = run_train((2 * center + 1) / 255.0, args.steps,
                                ckpt_cb=save_bundle_ckpt if args.ckpt_every else None, ckpt_every=args.ckpt_every)
        bins[center] = p_c
        print(json.dumps({"bin": center, "losses": losses[-2:]}), flush=True)
        for direction in (-1, 1):
            prev = p_c
            b = center + direction
            while 0 <= b <= 24:
                prev, losses = run_train((2 * b + 1) / 255.0, args.bundle_steps, params=prev, seed=b)
                bins[b] = prev
                print(json.dumps({"bin": b, "losses": losses[-1:]}), flush=True)
                # the partial bundle: a missing bin takes its nearest trained neighbour's weights
                full = [bins.get(i) or bins[min(bins, key=lambda k: abs(k - i))] for i in range(25)]
                save(stacked(full), args.out)
                b += direction
        print(json.dumps({"out": args.out, "bins": sorted(bins), "patches": len(patches)}))
        return 0

    init_params = None
    if args.resume:
        # zoo checkpoints may be float16; training runs in float32
        init_params = _cast_tree(convert.load_npz(args.resume), np.float16, np.float32)

    if args.synth:
        from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
        from pnp_admm_cnc_mri_torch.train import synth as synth_mod

        teacher_apply = None
        if args.distill:
            teacher = UNetRes(2, 1, nc=(64, 128, 256, 512), nb=4)
            teacher.load_state_dict(convert.state_dict_from_flax(teacher, convert.load_npz(args.distill)))
            teacher = teacher.to(device).eval().requires_grad_(False)

            def teacher_apply(tp, noisy, sig):
                return teacher(torch.cat([noisy, sig.expand_as(noisy)], dim=1))

        make = synth_mod.make_generator(size=args.synth_size, seeds=synth_mod.load_warp_seeds(device=device),
                                        n_disks=args.synth_disks)

        def generator(gen, n):
            t = sync_clock()
            imgs = make(gen, n)
            split["synthesis_s"] += sync_clock() - t
            return imgs

        t_train = sync_clock()
        params, losses = trainer.train_denoiser_stream(
            model, generator, sigma, steps=args.steps, batch_size=args.batch, patch=args.patch, cfg=cfg,
            buffer_images=args.synth, refresh_every=args.synth_refresh, conditioned=conditioned,
            ffdnet_style=ffdnet_style, params=init_params, ckpt_cb=ckpt_cb, ckpt_every=args.ckpt_every,
            ema_decay=args.ema, scan_steps=args.scan_steps, teacher_apply=teacher_apply,
            distill_weight=args.distill_weight, device=device)
    elif args.ondevice:
        t_train = sync_clock()
        params, losses = trainer.train_denoiser_ondevice(
            model, patches, sigma, steps=args.steps, batch_size=args.batch, cfg=cfg, conditioned=conditioned,
            ffdnet_style=ffdnet_style, params=init_params, ckpt_cb=ckpt_cb, ckpt_every=args.ckpt_every,
            ema_decay=args.ema, scan_steps=args.scan_steps, device=device)
    else:
        t_train = sync_clock()
        params, losses = trainer.train_denoiser(
            model, patches, sigma, steps=args.steps, batch_size=args.batch, cfg=cfg, conditioned=conditioned,
            ffdnet_style=ffdnet_style, params=init_params, ckpt_cb=ckpt_cb, ckpt_every=args.ckpt_every,
            device=device)
    t_save = sync_clock()
    save(params, args.out)
    if timings is not None:
        timings.update(split, setup_s=t_train - t0, train_s=t_save - t_train, save_s=time.perf_counter() - t_save)
    print(json.dumps({"out": args.out, "losses": losses[-3:],
                      "patches": (f"synth:{args.synth}" if args.synth else len(patches))}))
    return 0


def _cast_tree(tree, src, dst):
    """The nested dict ``tree`` with its ``src``-typed arrays cast to ``dst``."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: _cast_tree(v, src, dst) for k, v in tree.items()}
    return np.asarray(tree, dst) if np.asarray(tree).dtype == src else tree


if __name__ == "__main__":
    raise SystemExit(main())
