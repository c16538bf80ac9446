#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from any directory; needs one CUDA card and nvcc)

Phases, each timed and each fatal on failure:

- build:   compiles the port's four CUDA libraries from
           ``pnp_admm_cnc_mri_torch/csrc``, one nvcc each, in parallel (while
           the phantom batch is made on the host);
- kernels: holds each tail kernel against its plain PyTorch version on the
           card at the main path's shape (512 x 256 x 256 float32, with exact
           zeros and NaNs planted), and on the scalar, misaligned and float64
           paths;
- solve:   drives the main path, ``admm_l1`` and ``admm_cnc`` with
           ``fused=True`` at 256 x 256, batch 512, 50 iterations, with every
           launch count set to 0 just before and read just after; checks the
           fused solves against the unfused ones, PSNR against the zero-filled
           start, and a float64 solve on the card against a numpy reference;
- fused_iteration: holds the three designs of the fused ADMM-L1 iteration
           (the one-launch cluster kernel of ``csrc/admm_iteration_cluster.cu``,
           the one-launch mixed-radix kernel of ``csrc/admm_iteration_mixed.cu``
           and the three-launch strip kernels of ``csrc/admm_iteration.cu``)
           against the plain version at 512 x 256 x 256 and 3 x 128 x 256,
           from the scenario's initial state and its state after 10
           iterations, at 2 x 512 x 64 and 2 x 1024 x 64 (errors printed); the
           mixed design at the shapes the rule gives it (2 x 300 x 256, 2 x
           320², 2 x 384², 2 x 512², 2 x 640 x 320; 2 x 320² after 10
           iterations too) and at 2 x 300 x 256 with 75 rows a block; the
           strip design at 2 x 256 x 254, which only it takes; a NaN planted
           in one image. Then drives ``admm_l1_fused_kernel`` with the counts
           set to 0 just before and read just after: at 512 x 256 x 256 x 50
           (49 cluster launches, no other) against the unfused matmul solver
           and the fused fft solve, at 512 x 320 x 320 x 50 (the main path's
           phantoms in a 320² field of view; 49 mixed launches) likewise, at
           2 x 300 x 256 x 5 (4 mixed launches) and at 2 x 256 x 254 x 5 (4
           strip launches);
- pnp:     builds DRUNet (nc 64..512, nb 4) and DnCNN (nb 17) at full width
           with seeded weights; holds the DRUNet forward (batch 1) and a
           4-iteration PnP-CNC solve (batch 2) in float32 against float64 on
           the card, with cuDNN's TF32 on in the process (the denoisers turn
           it off for their forwards); drives ``pnp_admm_cnc`` with DRUNet in
           both slots (``PNP_CNC_DEFAULTS["drunet_gray"]``) and
           ``pnp_admm_l1`` with DnCNN, 4 x 256 x 256 x 50, with the classical
           kernels' counts set to 0 just before and read just after (they
           stay 0: no Pallas kernel of the JAX package is on this path);
           times both solves, the forwards and the data-consistency solve,
           and the forward's rate from its layer shapes;
- solvers: the FISTA, HQS, RED and consensus solvers. ``fista_l1`` at 512 x
           256 x 256 x 50 (PSNR above the zero-filled start on every image)
           and in float64 at 2 x 256 x 256 against a numpy FISTA; PnP-FISTA
           and consensus-FISTA (3 observations an image: random, radial and
           Cartesian masks) with DRUNet at full width, seeded weights, on
           ``TUNED_FISTA_D`` / ``TUNED_CONSENSUS_FISTA``, each held in
           float32 against float64 over 4 iterations; then, with the
           classical kernels' counts set to 0 just before and read just after
           (they stay 0), 4 x 256 x 256 runs of PnP-FISTA, consensus-FISTA,
           PnP-HQS, RED and consensus-HQS with DRUNet and PnP-FISTA with
           TDNet (nc 128, nb 12, x8 ensemble), outputs finite and in [0, 1];
           times ``fista_l1`` beside ``admm_l1(fused=True)``, the two FISTA
           solves, their iterations without the forwards, and the TDNet
           forward with its rate;
- bm3d:    BM3D's white-noise core and its PnP prior (torch ops, no kernel of
           its own). Float64 on the card against the port's CPU run at 2 x
           64 x 64 (outputs and matched positions); two calls at 4 x 256 x 256
           bit-equal; float32 against float64 there (max, mean, share of
           groups whose used matches differ); the same call with TF32 set on
           in the process; then, with the classical kernels' counts set to 0
           just before and read just after (they stay 0), the reference's
           PnP-ADMM-L1-BM3D and PnP-ADMM-CNC-BM3D at 4 x 256 x 256 x 50 and at
           ``TUNED_BM3D`` (every image above its zero-filled PSNR; image 0 of
           each 50-iteration solve within 0.5 dB of the JAX package's value),
           and single runs of PnP-FISTA, PnP-PGD-CNC, PnP-HQS (the ladder
           denoiser), RED and consensus-FISTA with BM3D at their tuned
           settings; times a call at 1 and 4 images by stage, batch_chunk 1
           against 4, the solves, the rest of an iteration, and peak memory;
- restore: the DPIR restoration pipelines (``cli/experiments.py``) at 4 x 256
           x 256, 8 iterations, with the classical kernels' counts set to 0
           at the phase's start and read at its end (they stay 0): PnP
           deblurring (``make_blur_kernel('aniso')``, 2.55/255 noise) and
           PnP super-resolution x2 (9 x 9 anisotropic Gaussian, 1.5/255
           noise), each with the BM3D ladder prior (every image within 0.1
           dB of the JAX package's PSNR, and the degraded inputs too) and
           with full-width DRUNet at ``TUNED_DEBLUR`` / ``TUNED_SR`` (seeded
           weights, whether or not ``model_zoo/`` is in the checkout);
           DRUNet's runs in float32 against float64 over 2 iterations; ``wrap_convolve``, ``deblur_solution`` and
           ``data_solution`` in float32 on the card against float64 on the
           CPU; times each solve and one iteration's data solve against the
           denoiser call;
- bm3d_colored: the colored-noise BM3D and the BM3D API, the counts at 0
           as above. Float64 on the card against the port's CPU run at 4 x
           64 x 64 (exact variances; outputs and matches); at 4 x 256 x 256,
           float32, ``bm3d_colored_auto`` at explicit parameters (exact
           variances) for the g1, g2, g4 and gw noise families and
           ``bm3d_colored(exact=False)`` for g1 (image 0 within 0.1 dB of the
           JAX package's PSNR), two calls bit-equal, TF32 set on in the
           process changing nothing; single runs of ``api.bm3d`` (a flat PSD;
           ``stage_arg``), ``bm3d_with_blockmatches`` reused,
           ``bm3d_refilter``, ``bm3d_rgb`` and ``bm3d_multichannel`` on a
           3-channel stack of phantoms, and ``bm3d_deblurring`` (white; each
           image within 0.1 dB of the JAX package's PSNR); times a call by
           stage, the host's PSD work, and its peak memory;
- experiments: the MRI experiment runners (``cli/experiments.py``) through
           the real loaders, on files written to a temporary directory: the
           512 phantoms as 8-bit PNGs (the port's writer), the three masks
           as ``Q_*30.mat`` and ``noises.mat``. ``run_classical`` for
           ``admm_l1`` and ``admm_cnc`` at 512 x 256 x 256 x 50, float32,
           with K1's and K2's counts set to 0 just before each and read just
           after (50 launches of its kernel), every image above its
           zero-filled PSNR and the per-image PSNR equal to a direct
           ``admm_l1``/``admm_cnc(fused=True)`` solve's; ``run_fista_l1`` at
           the same shape; ``run_pnp`` (DRUNet in both CNC slots),
           ``run_pnp_fista``, ``run_pnp_pgd_cnc``, ``run_pnp_hqs`` and
           ``run_red`` with full-width seeded DRUNet on 4 images (the
           classical counts stay 0); one small run's ``.log`` and PNGs read
           back against a direct solve's pixels;
- sweep:   ``cli/sweep.py``'s ``main`` on the grid of 512 phantoms x 3 masks
           x sigma scales 1, 3, 5 (4,608 scenarios), ``--algo admm_l1`` and
           ``--algo admm_cnc``, 50 iterations, float32, with the counts set
           to 0 just before and read just after (50 launches of K1, of K2);
           4,608 JSONL rows with the labels in order; 8 scenarios picked by a
           seed against the port's own CPU solve of them; K1 and K2 against
           their plain versions at (4608, 256, 256); ``--algo pnp_fista_d``
           with seeded full-width DRUNet on 4 phantoms x 3 masks (12
           scenarios, 30 iterations); ADMM-L1 at 512 x 256 x 256 and FISTA-L1
           at 4 x 256 x 256 stopped at iteration 20, saved, loaded and
           resumed to 50, bit-equal to the uninterrupted solves; prints the
           summaries, the split of each sweep's time (host load and grid
           build, H2D, solve, scoring, records) and the peak device memory;
- train:   the denoiser trainers (``train/``, ``cli/train_denoiser.py``),
           with K1-K3's counts set to 0 at the phase's start and read at its
           end (they stay 0: no Pallas kernel of the JAX package is on this
           path). Full-width DRUNet through ``cli.train_denoiser.main`` at the
           JAX package's round-15 stream config cut to 200 steps (its npz
           loaded through ``build_denoiser`` into a 4 x 256 x 256 PnP-FISTA
           solve, finite and in [0, 1]); the step's split, FLOPs, share of
           the float32 peak and peak memory; DnCNN on host and on-device
           batches of the phantom PNGs, the IRCNN 25-bin bundle, FFDNet
           distilled from the DRUNet npz; ``train.unroll.train_unrolled`` with
           full-width DRUNet through 10 PnP-FISTA iterations at 2 x 256 x 256
           (4 steps; checkpointed and plain gradients compared); float64 on
           the card against the CPU (3 DnCNN steps, one unrolled step),
           float32 against float64 (full-width DRUNet, 2 steps), two 20-step
           runs from one seed bit-equal, and TF32 set on changing nothing;
- cli:     the port's command line (``cli/main.py``, ``cli/eval_folds.py``)
           on a testset ``set`` of 15 phantoms at 256 x 256 (``01``-``15``)
           and ``set1`` (its ``05``), the experiments phase's masks and
           ``noises.mat``, and one seeded full-width npz per reference model
           name (dncnn_25, fdncnn_gray, ffdnet_gray, the ircnn_gray bundle,
           drunet_gray, tdnet; every CNN run passes ``--weights``). All 19
           algorithms through ``cli.main.main`` in this process: the classical
           five at their default depth, the CNN and BM3D ones at 4 iterations
           (the DnCNN pair, one ``--bf16`` and one ``--tuned`` run among
           them), each with the launch counts set to 0 just before and read
           just after (``admm_l1`` 50 K1 launches, ``admm_cnc`` 50 K2, the
           others 0); the result line's keys equal to the JAX CLI's, every
           per-image PSNR finite, the classical ones above their zero-filled
           PSNR, 15 image lines and the average in each ``.log``; K1 and K2
           equal to their plain versions at the path's (15, 256, 256) in
           float32 with ``admm_l1``'s and ``admm_cnc``'s scalars.
           ``admm_l1`` and ``pnp_deblur`` with ``--f64`` on the card against
           ``--cpu --f64`` on ``set1`` (1e-9 dB; ``pnp_deblur`` is float32 in
           both packages, held to 1e-3 dB, which a control run with its
           denoiser's convolutions in TF32 must exceed); ``python -m
           pnp_admm_cnc_mri_torch.cli.main admm_l1`` as a cold subprocess
           from outside the repository (``PYTHONPATH`` this directory), equal
           to the in-process run; ``cli.eval_folds.main`` on 5 seeded DRUNet
           fold files that partition the 15 images (``--select_nlm 12,15``,
           4 iterations), its composite the mean of its held-out PSNRs;
           prints each run's ``wall_s`` and call time;
- catalog: the rest of the JAX package. (a) The five U-Net variants of
           ``models/unet_variants.py`` at full width and their default
           depths, seeded Flax-rule weights, 4 x 1 x 256 x 256 (ResUNet also
           252 x 252), float32 with cuDNN's TF32 off against float64 of the
           same weights, with forward times, FLOPs, float32-peak share and
           peak memory; (b) a full-width DRUNet written as a KAIR ``.pth``
           in the reference's key layout: ``build_denoiser`` and
           ``cli.main pnp_cnc_d`` bit-equal to its npz; UNetPlus and
           NonLocalUNet with random BatchNorm statistics converted (folded)
           against the unfolded nets with ``F.batch_norm``, float64, 1e-12;
           (c) ``admm_l1`` at 512 x 256 x 256 x 50 with the matmul DC solve
           (Nyquist-packed, Karatsuba products) against the fft solve (mean
           PSNR, max and mean |dx|), in float64 at 4 x 256 x 256 and, in the
           unpacked form, at 4 x 256 x 255 within 1e-9, timed in turns, K1
           50 launches a solve; (d) ``resolve_dc_method('auto')`` on the
           card at 256 and 2048; (e) the image readers: the fixtures of
           ``tests/torch_image_fixtures`` decoded to their stored cv2
           pixels, and a 15-image testset of ``.png``-named BMP (written
           here) and JPEG (the fixtures) payloads through ``cli.main
           admm_l1`` with PSNR lines equal to those of a PNG copy of the
           pixels cv2 gives (the BMPs' by OpenCV's rule, the JPEGs' stored).
           Each run's K1-K3 counts are set to 0 just before it and read just
           after;
- examples: the six example programs of ``pnp_admm_cnc_mri_torch/examples``
           through their ``main`` at their published arguments (the BM3D
           demos at 128 x 128, the colored defaults against a synthetic
           parameter database; MRI at 256 x 256 x 50 and SR x2 at 256 x 256 x
           8 on a phantom written as the testset's ``05.png``, DRUNet the
           train phase's 200-step network), float32 on the card, each with
           K1-K3's counts set to 0 just before and read just after (MRI: 50
           K1 and 50 K2 launches, the others 0), run twice and timed, its
           PSNRs printed and finite (the BM3D outputs above their inputs,
           the classical MRI reconstructions above zero-filled); each held
           against its ``--f64`` run on the card and, where no CNN weights
           reach a line, against the JAX package's float32 PSNR; float32 and
           float64 on the card against ``--cpu --f64`` (the BM3D demos at
           their published arguments, MRI and SR on a 64 x 64 phantom, MRI at
           4 iterations); one ``python -m`` cold process of
           ``bm3d_multichannel`` printing the in-process run's lines;
- distributed: the multi-device path of ``parallel/`` (mesh, reductions,
           spatial FFT-ADMM, sharded consensus), the sharded sweep, the
           multihost worker and the dp x tp trainer. At world 1 on NCCL in
           this process (the 1 x 1 mesh with its groups): the sweep's
           4,608-scenario grid with ADMM-L1 and ADMM-CNC, the three sharded
           consensus solves on one phantom through 4 masks (ADMM in float64
           at ``ADMM_L1_DEFAULT``, FISTA and HQS with seeded full-width
           DRUNet at ``TUNED_CONSENSUS_*`` cut to 4 iterations),
           ``spatial_admm_l1`` at 4 x 256 x 256 x 50 in float64,
           ``multihost.worker`` at 512 scenarios, and 3 steps of
           ``train_denoiser(mesh=)`` with full-width DRUNet at 16 x 64 x 64,
           each equal to its one-device run (bit for bit; the spatial solve,
           whose FFT runs as two 1-D passes, within 1e-9), with K1-K3's
           counts set to 0 just before each and read just after, its
           CUDA-event time and the share of that in collectives. Then worlds
           of 2 and 4 spawned processes over gloo, all on ``cuda:0`` (NCCL
           takes one rank per card): the consensus solves at both, the
           spatial solve at space 2, space 4 and data 2 x space 2, the sweep
           at world 2, the trainer at data 2 x space 2, held to the
           one-device results (float64 within 1e-9, float32 within the
           limits below); K1 and K2 against their plain versions at the row
           shards' and the half grid's shapes;
- timing:  CUDA-event medians of the solves, of each tail kernel against its
           plain version and its bound, of the cluster and strip steps and
           the cuFFT path's iteration at 512 x 256 x 256, and of the mixed
           and strip steps and the cuFFT iteration at 512 x 320 x 320, each
           on one state, in turns.

Prints the card's name and power limit (nvidia-smi), one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``. Exits
non-zero and prints no result if there is no CUDA card, if the port is not
next to this file, or if any phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
B, H, W, ITERS = 512, 256, 256, 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PNP_B = 4  # the PnP phase's batch
# PnP phase, float32 against float64 on the card with cuDNN's TF32 off: the
# DRUNet forward showed 5.1e-7 and the 4-iteration PnP-CNC solve 3.7e-6 (PERF.md);
# the forward with TF32 on errs 2.7e-4, which the first limit refuses
DRUNET_ATOL = 5e-6
PNP_ATOL = 5e-5
FUSED_ATOL = 1e-5  # fused step vs plain: 256-term float32 sums, FMA vs cuBLAS; soft is 1-Lipschitz
# Operations per element of each tail (adds, multiplies, compares), and the
# float planes each moves (inputs read once, outputs written once).
TAILS = {
    "l1_tail": dict(flops=8, planes=4, replaces="pnp_admm_cnc_mri_tpu/ops/pallas_kernels.py:68"),
    "cnc_tail": dict(flops=19, planes=5, replaces="pnp_admm_cnc_mri_tpu/ops/pallas_kernels.py:119"),
}
SOURCE = "pnp_admm_cnc_mri_torch/csrc/admm_tail.cu"
FUSED_SOURCE = "pnp_admm_cnc_mri_torch/csrc/admm_iteration.cu"
CLUSTER_SOURCE = "pnp_admm_cnc_mri_torch/csrc/admm_iteration_cluster.cu"
MIXED_SOURCE = "pnp_admm_cnc_mri_torch/csrc/admm_iteration_mixed.cu"
MIXED_SIDE = 320  # the mixed design's path and timing: fastMRI's image size
FUSED_REPLACES = "pnp_admm_cnc_mri_tpu/ops/pallas_dc.py:83"
# The JAX package's PSNRs (dB) on the bm3d phase's scenario (the first 4
# images: phantoms seed 0, random_mask(0.3, seed 1), synth_noise(3.0, seed 2)):
# its pnp_admm_l1 / pnp_admm_cnc with make_bm3d_denoiser, clamp=False,
# float32 on the CPU, y formed by the port's fourier.observe on the CPU
# (measured once for PR 9).
JAX_BM3D_PSNR = {
    "zero_filled": [22.12395529165549, 19.565282325608408, 21.453331130311334, 21.655239432027503],
    "pnp_l1_bm3d": [23.433990565465454, 22.868420083629807, 23.283684286471143, 22.598501955588574],
    "pnp_cnc_bm3d": [24.04999555227151, 24.5256190015893, 24.537814224863517, 24.986576022209576],
    "pnp_l1_bm3d_tuned": [26.409124482075864, 23.662537460289368, 26.463342851453078, 25.351799261676756],
    "pnp_cnc_bm3d_tuned": [28.128437785416768, 24.910459657766715, 28.313730357227914, 26.53097628798077],
}
# The 50-iteration solves are chaotic: a 1e-6 nudge of the images moves image
# 0's PSNR over this band in the JAX package (min, max over 6 runs, the
# unnudged one included; ``probes/bm3d_chaos.py jax 6``, PR 9), and over a
# band as wide in the port (PERF.md). Image 0 of the port's solve is held to
# within 0.5 dB of the JAX package's band, not of its one unnudged run.
JAX_BM3D_BAND = {"pnp_l1_bm3d": (20.9329, 23.434), "pnp_cnc_bm3d": (24.05, 25.0092)}
BM3D_50_DB = 0.5
BM3D_TUNED_DB = 0.1  # each image of the 3- and 4-iteration solves against JAX
# float32 against float64, one BM3D call at 4 x 256 x 256 (phantoms plus
# numpy noise, seed 5): max 4.80e-4, mean 4.37e-7, and 0.17% of the Wiener
# groups with other used matches, on the CPU and on the card alike; over
# three other noise draws up to 1.49e-3, 1.47e-6 and 1.17%, where float32
# rounding flips a few hard-threshold decisions and the Wiener matching
# follows the moved pilot (probes/bm3d_precision.py, PERF.md, PR 9). The
# limits, 4-7x the largest, take that spread and catch a reduced-precision
# product, which would move every distance.
BM3D_F32 = dict(max=1e-2, mean=1e-5, share=0.05)
# The JAX package's PSNRs (dB, outputs clipped to [0, 1]) on the restore and
# bm3d_colored phases' scenarios, float32 on the CPU (measured once, PERF.md):
# mri_phantoms(4, 256, seed 0); deblurring with make_blur_kernel('aniso') and
# 2.55/255 times default_rng(3) noise, SR x2 with the 9 x 9 anisotropic
# Gaussian and 1.5/255 times default_rng(4) noise, the BM3D ladder prior, 8
# iterations; colored BM3D on image 0, variance 0.02, realization 0, the
# kernel and PSD of get_experiment_noise at 256 x 256, explicit parameters.
JAX_RESTORE_PSNR = {
    "deblur_degraded": [33.634, 31.255, 33.463, 32.553],
    "deblur_bm3d": [43.882, 43.292, 44.938, 43.353],
    "sr_kron": [30.866, 28.104, 30.465, 29.773],
    "sr_bm3d": [43.187, 38.092, 42.778, 42.332],
}
COLORED_FAMILIES = ("g1", "g2", "g4", "gw")
JAX_COLORED_PSNR = {
    "noisy_g1": 18.757, "noisy_g2": 18.853, "noisy_g4": 18.828, "noisy_gw": 18.779,
    "exact_g1": 29.112, "exact_g2": 35.477, "exact_g4": 30.108, "exact_gw": 37.255,
    "approx_g1": 20.446,
}
# api.bm3d_deblurring(colored=False) at its default reg 1e-2 on the four
# phantoms blurred by make_blur_kernel('aniso') plus 0.01 times default_rng(11)
# noise (float32): below the blurred input's PSNR, in the JAX package too
JAX_DEBLURRING_WHITE_PSNR = [30.283, 27.784, 30.802, 29.792]
RESTORE_DB = 0.1
# restoration with full-width DRUNet (seeded weights), float32 against float64,
# 2 iterations, on this phase's inputs (2 x 256 x 256): 3.6e-7 (deblurring) and
# 4.0e-6 (SR) on the CPU (PERF.md); the limit is about 12x the larger.
# SR's first rung has rho ~2e-4, whose 1/rho amplifies float32 roundings. The
# trained model_zoo/drunet_gray.npz widens the gap to 1.5e-4 (SR, CPU), so the
# phase builds its DRUNet from the seed and never from the zoo.
RESTORE_DRUNET_ATOL = 5e-5
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


def event_ms(fn):
    """(fn's result, its CUDA-event time in ms) of one call."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


def conv_flops(denoise, v) -> int:
    """Operations of the convolutions in one ``denoise(v, 0)``, from the
    layer shapes: 2 per multiply-add, counted over each conv's outputs (each
    transposed conv's inputs)."""
    import torch

    total = 0

    def hook(m, inputs, out):
        nonlocal total
        k = m.weight[0].numel()  # in/groups x kH x kW for a conv, out x kH x kW for a transposed conv
        total += 2 * k * (out.numel() if isinstance(m, torch.nn.Conv2d) else inputs[0].numel())

    handles = [m.register_forward_hook(hook) for m in denoise.model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    try:
        denoise(v, 0)
    finally:
        for h_ in handles:
            h_.remove()
    return total


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


def numpy_fista_l1(img, mask, noise, iters, lam, step):
    """Straight-line numpy FISTA-L1 (Beck and Teboulle), float64, with the
    gradient ifft2(mask fft2(v) - y) read where the mask samples."""
    import numpy as np

    y = np.fft.fft2(img) * mask + noise
    x = np.abs(np.fft.ifft2(y))
    v, t = x.copy(), 1.0
    for _ in range(iters):
        r = np.fft.fft2(v) * mask
        r = np.where(mask != 0, r - y, r)
        u = v - step * np.real(np.fft.ifft2(r))
        x_new = np.fmax(np.abs(u) - step * lam, 0) * np.sign(u)
        t_new = (1.0 + np.sqrt(1.0 + 4.0 * t * t)) / 2.0
        v = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


# experiments and sweep phases: the card against the port's own CPU run on 8
# scenarios of the 4,608-scenario grid picked by a seed, float32 both (cuFFT
# against the CPU's FFT over 50 iterations): PSNR within SWEEP_PSNR_DB and the
# relative residual within SWEEP_RES_ATOL + SWEEP_RES_RTOL |residual|
SWEEP_PSNR_DB = 1e-3
SWEEP_RES_ATOL, SWEEP_RES_RTOL = 1e-6, 1e-3
SIGMAS = (1.0, 3.0, 5.0)
PNP_RUN_ITERS = 10  # the PnP runners' iterations with seeded DRUNet (quality is not claimed)
LOG_LINE = r"^\d\d-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3} : (\S+\.png) - PSNR: (\d+\.\d\d) dB; SSIM: (-?\d\.\d{4}) ; RE: (\d\.\d{4})\.$"


def write_mri_assets(root: str, imgs, mask_shape) -> tuple:
    """The testset ``phantoms`` (``imgs`` as 8-bit PNGs through the port's
    writer), ``phantoms4`` (its first 4), the three masks as ``Q_*30.mat``
    and ``noises.mat`` (unit-std noise, which ``load_noise`` scales by 3)
    under ``root``; returns (testsets_dir, data_dir)."""
    import numpy as np
    import scipy.io as sio

    from pnp_admm_cnc_mri_torch.data import images, masks, noise

    tdir, ddir = os.path.join(root, "testsets"), os.path.join(root, "CS_MRI")
    for k, im in enumerate(imgs):
        images.imsave(im * 255.0, os.path.join(tdir, "phantoms", f"{k:03d}.png"))
        if k < 4:
            images.imsave(im * 255.0, os.path.join(tdir, "phantoms4", f"{k:03d}.png"))
    os.makedirs(ddir)
    gens = {"Q_Random30": masks.random_mask(mask_shape, fraction=0.3, seed=1),
            "Q_Radial30": masks.radial_mask(mask_shape),
            "Q_Cartesian30": masks.cartesian_mask(mask_shape, fraction=0.3, seed=1)}
    for name, m in gens.items():
        sio.savemat(os.path.join(ddir, masks.MASK_FILES[name]), {"Q1": m.astype(np.uint8)})
    sio.savemat(os.path.join(ddir, "noises.mat"), {"noises": noise.synth_noise(mask_shape, std=1.0, seed=2)})
    return tdir, ddir


def phase_experiments(dev, tmp: str, tdir: str, ddir: str) -> dict:
    """The seven MRI experiment runners through the real loaders; returns their rates."""
    import re
    import warnings

    import numpy as np
    import torch

    from pnp_admm_cnc_mri_torch.cli import experiments
    from pnp_admm_cnc_mri_torch.config import ADMM_CNC_DEFAULT, ADMM_L1_DEFAULT, PNP_CNC_DEFAULTS, ADMMConfig
    from pnp_admm_cnc_mri_torch.data import images
    from pnp_admm_cnc_mri_torch.ops import fourier, fused_dc, metrics, tail_kernels
    from pnp_admm_cnc_mri_torch.priors import denoiser
    from pnp_admm_cnc_mri_torch.solvers import admm

    common = dict(testset="phantoms", testsets_dir=tdir, data_dir=ddir, results_dir=os.path.join(tmp, "results"),
                  save_images=False, dtype=torch.float32)
    batch = experiments.prepare_batch(os.path.join(tdir, "phantoms"), "Q_Random30", ddir)
    n_img = len(batch["names"])
    check(n_img == B and batch["y"].shape == (B, H, W), f"the testset loaded as {batch['y'].shape}")
    truth = torch.as_tensor(batch["truth"], device=dev).float()
    y_b = torch.as_tensor(batch["y"].astype(np.complex64), device=dev)
    m_b = torch.as_tensor(batch["mask"].astype(np.float32), device=dev)
    zf = metrics.psnr(torch.abs(fourier.zero_fill(y_b)) * 255.0, truth).cpu().numpy()
    out, launches = {}, {}
    for algo in ("admm_l1", "admm_cnc"):
        torch.cuda.synchronize()
        tail_kernels.reset_launches()
        out[algo] = experiments.run_classical(algo, **common)
        torch.cuda.synchronize()
        launches[algo] = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches}
        want = {"l1_tail": ITERS, "cnc_tail": 0} if algo == "admm_l1" else {"l1_tail": 0, "cnc_tail": ITERS}
        check(launches[algo] == want, f"run_classical({algo}) launches {launches[algo]}, expected {want}")
        p = np.array([out[algo]["per_image_psnr"][n] for n in batch["names"]])
        check(out[algo]["images"] == B and bool(np.all(p > zf)),
              f"run_classical({algo}): {int(np.sum(p <= zf))} images not above their zero-filled PSNR")
        cfg = ADMM_L1_DEFAULT if algo == "admm_l1" else ADMM_CNC_DEFAULT
        x_direct = getattr(admm, algo)(y_b, m_b, cfg, fused=True)[0].x
        direct = metrics.psnr(x_direct * 255.0, truth).cpu().numpy()
        d = float(np.abs(p - direct).max())
        check(d < 1e-9, f"run_classical({algo}) per-image PSNR vs a direct fused solve: {d} dB")
        out[algo]["psnr_vs_direct_db"] = d
    tail_kernels.reset_launches()
    fused_dc.reset_launches()
    out["fista_l1"] = experiments.run_fista_l1(**common)
    p = np.array([out["fista_l1"]["per_image_psnr"][n] for n in batch["names"]])
    check(bool(np.all(np.isfinite(p))) and float(p.mean()) > float(zf.mean()),
          f"run_fista_l1: mean PSNR {p.mean()} vs zero-filled {zf.mean()}")
    # the PnP runners with full-width DRUNet, seeded whatever model_zoo/ holds, on 4 images
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded random init warns
        dru = denoiser.build_denoiser("drunet_gray", weights=None, iter_num=PNP_RUN_ITERS, device=dev)
    alpha, _, lam, rho, b_ = PNP_CNC_DEFAULTS["drunet_gray"]
    cfg_cnc = ADMMConfig(iter_num=PNP_RUN_ITERS, rho=rho, lam=lam, alpha=alpha, b=b_)
    four = dict(common, only="000,001,002,003")
    it = PNP_RUN_ITERS
    out["pnp_cnc_drunet"] = experiments.run_pnp(dru, cfg_cnc, scheme="cnc", result_tag="pnp_cnc", **four)
    out["pnp_fista_drunet"] = experiments.run_pnp_fista(dru, it, **four)
    out["pnp_pgd_cnc_drunet"] = experiments.run_pnp_pgd_cnc(dru, it, **four)
    out["pnp_hqs_drunet"] = experiments.run_pnp_hqs(dru, it, **four)
    out["red_drunet"] = experiments.run_red(dru, it, **four)
    torch.cuda.synchronize()
    pnp_launches = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                    "fused_iteration": fused_dc.fused_iteration.launches}
    check(pnp_launches == dict.fromkeys(pnp_launches, 0), f"FISTA and the PnP runners launched {pnp_launches}")
    for k in ("pnp_cnc_drunet", "pnp_fista_drunet", "pnp_pgd_cnc_drunet", "pnp_hqs_drunet", "red_drunet"):
        check(out[k]["images"] == 4 and all(np.isfinite(v) for v in out[k]["per_image_psnr"].values()),
              f"{k}: {out[k]}")
    # one small run's log and PNGs, read back (another mask: a result name's
    # logger keeps the file it was first given, as in the JAX package)
    small = dict(common, only="000,001", save_images=True, results_dir=os.path.join(tmp, "small"))
    r = experiments.run_classical("admm_l1", mask_name="Q_Radial30", **small)
    result_name = "phantoms_dn_ADMM_L1_Q_Radial30"
    e_path = os.path.join(tmp, "small", result_name)
    with open(os.path.join(e_path, result_name + ".log")) as f:
        lines = f.read().splitlines()
    check(len(lines) == 3 and lines[2].endswith("Average PSNR:({:.3f})dB, Average ssim : ({:.3f}), Average re : "
                                                 "({:.3f})".format(r["psnr"], r["ssim"], r["re"])),
          f"the log: {lines}")
    b2 = experiments.prepare_batch(os.path.join(tdir, "phantoms"), "Q_Radial30", ddir, only="000,001")
    x2 = admm.admm_l1(b2["y"].astype(np.complex64), b2["mask"].astype(np.float32), ADMM_L1_DEFAULT)[0].x
    want_png = np.uint8((x2 * 255.0).cpu().numpy().clip(0, 255).round())
    for k, (line, name) in enumerate(zip(lines[:2], ("000", "001"))):
        mt = re.match(LOG_LINE, line)
        check(mt is not None and mt.group(1) == name + ".png"
              and mt.group(2) == f"{r['per_image_psnr'][name]:.2f}", f"log line {line!r}")
        png = images.imread_gray(os.path.join(e_path, f"{name}_{result_name}.png"))
        check(np.array_equal(png, want_png[k]), f"saved PNG {name} differs from the direct solve's pixels")
    rates = {k: {"wall_s": v["wall_s"], "images": v["images"], "iters": v["iters"],
                 "image_iters_per_s": v["images"] * v["iters"] / v["wall_s"], "psnr_db": v["psnr"]}
             for k, v in out.items()}
    log(f"experiments: run_classical launches {json.dumps(launches)}; every image above its zero-filled PSNR "
        f"(mean {float(zf.mean()):.3f} dB); per-image PSNR vs a direct admm_l1/admm_cnc(fused=True) solve "
        f"{out['admm_l1']['psnr_vs_direct_db']:.3g}, {out['admm_cnc']['psnr_vs_direct_db']:.3g} dB; FISTA and the PnP "
        f"runners (DRUNet seeded, {PNP_RUN_ITERS} iterations, 4 images) launched {json.dumps(pnp_launches)}; "
        f"the small run's .log and PNGs read back")
    log(f"timing experiments (float32, the runners' own wall_s: the solve to its end on the card): "
        f"{json.dumps(rates)}")
    return rates


def phase_sweep(dev, tmp: str, tdir: str, ddir: str, y, mask) -> dict:
    """The 4,608-scenario grid (512 phantoms x 3 masks x 3 sigmas) through
    ``cli/sweep.py``'s entry point for ADMM-L1 and ADMM-CNC, the kernels at
    its shape, PnP-FISTA at 12 scenarios, and checkpoint resumes."""
    import contextlib
    import io
    import warnings

    import numpy as np
    import torch

    from pnp_admm_cnc_mri_torch.cli import sweep
    from pnp_admm_cnc_mri_torch.config import ADMM_CNC_DEFAULT, ADMM_L1_DEFAULT, MASK_NAMES, TUNED_FISTA_D
    from pnp_admm_cnc_mri_torch.data import images, masks, noise
    from pnp_admm_cnc_mri_torch.ops import fused_dc, metrics, prox, tail_kernels
    from pnp_admm_cnc_mri_torch.priors import denoiser
    from pnp_admm_cnc_mri_torch.solvers import admm, fista
    from pnp_admm_cnc_mri_torch.utils import checkpoint

    images.DEFAULT_TESTSETS = tdir
    masks.DEFAULT_DATA_DIR = noise.DEFAULT_DATA_DIR = ddir
    s_total = B * len(MASK_NAMES) * len(SIGMAS)
    labels = [f"img{i}_{m}_s{s}" for s in SIGMAS for m in MASK_NAMES for i in range(B)]
    imgs01, truth, _ = images.load_testset(os.path.join(tdir, "phantoms"))
    mask_np = {n: masks.load_mask(n) for n in MASK_NAMES}
    base = noise.load_noise()
    picks = np.sort(np.random.default_rng(11).choice(s_total, 8, replace=False))
    res = {"launches": {}, "summary": {}, "split_s": {}, "card_vs_cpu": {}}

    def run(argv, timings=None):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(sweep.main(argv, timings=timings) == 0, f"sweep {argv} returned non-zero")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    for algo, cfg in (("admm_l1", ADMM_L1_DEFAULT), ("admm_cnc", ADMM_CNC_DEFAULT)):
        out = os.path.join(tmp, f"sweep_{algo}.jsonl")
        split = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        tail_kernels.reset_launches()
        fused_dc.reset_launches()
        summ = run(["--algo", algo, "--testset", "phantoms", "--sigmas", ",".join(map(str, SIGMAS)), "--out", out],
                   timings=split)
        torch.cuda.synchronize()
        res["launches"][algo] = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                                 "fused_iteration": fused_dc.fused_iteration.launches}
        res["peak_gib_" + algo] = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        want = dict(l1_tail=ITERS if algo == "admm_l1" else 0, cnc_tail=ITERS if algo == "admm_cnc" else 0,
                    fused_iteration=0)
        check(res["launches"][algo] == want, f"sweep {algo}: launches {res['launches'][algo]}, expected {want}")
        with open(out) as f:
            rows = [json.loads(ln) for ln in f]
        check(summ["scenarios"] == len(rows) == s_total and [r_["scenario"] for r_ in rows] == labels,
              f"sweep {algo}: {summ['scenarios']} scenarios, {len(rows)} rows, labels in order: "
              f"{[r_['scenario'] for r_ in rows] == labels}")
        check(summ["iters"] == ITERS and summ["devices"] == 1 and math.isfinite(summ["avg_psnr"])
              and math.isfinite(summ["converged_fraction"]), f"sweep {algo}: summary {summ}")
        # the seeded picks, solved by the port on the CPU in float32
        blocks = [(sc, m) for sc in SIGMAS for m in MASK_NAMES]
        y8 = np.stack([np.fft.fft2(imgs01[s_ % B]) * mask_np[blocks[s_ // B][1]] + base * blocks[s_ // B][0]
                       for s_ in picks]).astype(np.complex64)
        m8 = np.stack([mask_np[blocks[s_ // B][1]] for s_ in picks]).astype(np.float32)
        solver = getattr(admm, algo)
        st, r8 = solver(y8, m8, cfg, dtype=torch.float32, collect_residuals=True, device="cpu")
        rel8 = (r8[-1] / (torch.sqrt(torch.sum(st.x**2, dim=(-2, -1))) + 1e-12)).numpy()
        p8 = metrics.psnr(st.x * 255.0, torch.from_numpy(truth[picks % B])).numpy()
        dp = max(abs(rows[s_]["psnr"] - float(p8[k])) for k, s_ in enumerate(picks))
        dr = max(abs(rows[s_]["residual"] - float(rel8[k])) for k, s_ in enumerate(picks))
        ok = all(abs(rows[s_]["residual"] - float(rel8[k])) <= SWEEP_RES_ATOL + SWEEP_RES_RTOL * abs(float(rel8[k]))
                 for k, s_ in enumerate(picks))
        check(dp < SWEEP_PSNR_DB and ok, f"sweep {algo}: card vs CPU on the picks {picks.tolist()}: PSNR {dp} dB, "
              f"residual {dr}")
        res["card_vs_cpu"][algo] = {"psnr_db": dp, "residual": dr,
                                    "residuals": [float(v) for v in rel8]}
        res["summary"][algo], res["split_s"][algo] = summ, split
        del rows
    # K1 and K2 against their plain versions at the grid's shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    shape = (s_total, H, W)
    ops = [torch.randn(shape, generator=gen, device=dev) * 10.0 ** (-4.0 * torch.rand(shape, generator=gen, device=dev))
           for _ in range(3)]
    c = ADMM_L1_DEFAULT.rho * ADMM_L1_DEFAULT.lam
    cnc = (ADMM_CNC_DEFAULT.alpha, ADMM_CNC_DEFAULT.rho, ADMM_CNC_DEFAULT.lam, ADMM_CNC_DEFAULT.b)
    res["kernels_at_grid"] = {
        "l1_tail": same(tail_kernels.l1_tail(*ops, c), tail_kernels.l1_tail_plain(*ops, c), "l1_tail at the grid"),
        "cnc_tail": same(tail_kernels.cnc_tail(*ops, *cnc), tail_kernels.cnc_tail_plain(*ops, *cnc),
                         "cnc_tail at the grid"),
    }
    n = s_total * H * W
    res["kernel_ms_at_grid"] = {
        "l1_tail": cuda_ms(lambda: tail_kernels.l1_tail(*ops, c), inner=5),
        "cnc_tail": cuda_ms(lambda: tail_kernels.cnc_tail(*ops, *cnc), inner=5),
        "l1_tail_bound": 4 * n * 4 / HBM_BYTES_PER_S * 1e3, "cnc_tail_bound": 5 * n * 4 / HBM_BYTES_PER_S * 1e3,
    }
    del ops
    torch.cuda.empty_cache()
    # PnP-FISTA, DRUNet seeded (no file in an empty model zoo), 4 phantoms x 3 masks x 1 sigma
    zoo = denoiser.DEFAULT_MODEL_ZOO
    denoiser.DEFAULT_MODEL_ZOO = os.path.join(tmp, "empty_zoo")
    tail_kernels.reset_launches()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the seeded random init warns
            t_p = time.perf_counter()
            summ = run(["--algo", "pnp_fista_d", "--model", "drunet_gray", "--testset", "phantoms4",
                        "--out", os.path.join(tmp, "sweep_pnp.jsonl")])
            res["pnp_fista_d_total_s"] = time.perf_counter() - t_p
    finally:
        denoiser.DEFAULT_MODEL_ZOO = zoo
    check(summ["scenarios"] == 12 and summ["iters"] == TUNED_FISTA_D["drunet_gray"]["iter_num"]
          and math.isfinite(summ["avg_psnr"]) and tail_kernels.l1_tail.launches == 0
          and tail_kernels.cnc_tail.launches == 0, f"sweep pnp_fista_d: {summ}")
    res["summary"]["pnp_fista_d"] = summ
    # checkpoint resumes on the card: ADMM-L1 at 512 x 256 x 256, FISTA-L1 at 4 x 256 x 256, stopped at 20 of 50
    cfg = ADMM_L1_DEFAULT
    full, _ = admm.admm_l1(y, mask, cfg)
    part, _ = admm.admm_l1(y, mask, dataclasses.replace(cfg, iter_num=20))
    checkpoint.save_state(os.path.join(tmp, "admm.npz"), part, 20, cfg)
    z_update, tail = admm.classical_update("admm_l1", cfg)
    got, _ = checkpoint.resume_admm(os.path.join(tmp, "admm.npz"), y, mask, z_update, tail=tail)
    check(all(torch.equal(a_, b_) for a_, b_ in zip(got, full)), "ADMM-L1 resumed on the card differs from the "
          "uninterrupted solve")
    lam_f = 8e-4
    y4 = y[:4].contiguous()
    full_f, _ = fista.fista_l1(y4, mask, iter_num=ITERS, lam=lam_f)
    part_f, _ = fista.fista_l1(y4, mask, iter_num=20, lam=lam_f)
    checkpoint.save_fista_state(os.path.join(tmp, "fista.npz"), part_f, 20, meta={"iter_num": ITERS, "step": 1.0})
    got_f, _ = checkpoint.resume_fista(os.path.join(tmp, "fista.npz"), y4, mask, lambda i, u: prox.soft(u, 1.0 * lam_f))
    check(torch.equal(got_f.x, full_f.x) and torch.equal(got_f.v, full_f.v) and got_f.t == full_f.t,
          "FISTA resumed on the card differs from the uninterrupted solve")
    sp = res["split_s"]["admm_l1"]
    log(f"sweep: {s_total} scenarios ({B} phantoms x {len(MASK_NAMES)} masks x sigmas {list(SIGMAS)}), {H} x {W}, "
        f"{ITERS} iterations, float32; the sweep's own kernel launches {json.dumps(res['launches'])}; JSONL rows "
        f"{s_total} with the labels in order; card vs the port's CPU run on 8 seeded scenarios "
        f"{json.dumps(res['card_vs_cpu'])} (limits {SWEEP_PSNR_DB} dB, {SWEEP_RES_ATOL} + {SWEEP_RES_RTOL} |r|); "
        f"K1, K2 equal their plain versions at {shape} ({json.dumps(res['kernels_at_grid'])}); ADMM-L1 (512) and "
        f"FISTA-L1 (4) stopped at 20, saved, loaded and resumed to {ITERS}: bit-equal to the uninterrupted solves")
    log(f"timing sweep (summaries as printed: {json.dumps(res['summary'])}); split of each run in s (host load, "
        f"host grid build, H2D, solve = wall_s, scoring, JSONL records): {json.dumps(res['split_s'])}; admm_l1 solve "
        f"share of load+grid+h2d+solve+score {sp['solve'] / (sp['load'] + sp['grid'] + sp['h2d'] + sp['solve'] + sp['score']):.1%}; "
        f"peak device memory above what was allocated: admm_l1 {res['peak_gib_admm_l1']:.2f} GiB, admm_cnc "
        f"{res['peak_gib_admm_cnc']:.2f} GiB; pnp_fista_d total {res['pnp_fista_d_total_s']:.2f} s; K1/K2 at the grid "
        f"(CUDA events, ms; byte bounds): {json.dumps(res['kernel_ms_at_grid'])}")
    return res


# -- train: the denoiser trainers (no kernel of the JAX package is on this path) --
# The JAX package's round-15 stream config (scripts/train_round15_synth.sh, part B:
# full-width DRUNet, batch 16, 64^2 patches, sigma in [0, 50]/255, a 4096-image
# 128^2 buffer, cosine, EMA 0.999), cut: 150,000 -> 200 steps, scan_steps 200 ->
# 100, synth_refresh 2,000 -> 100 (the refresh runs), ckpt_every 10,000 -> 100,
# and no warp seeds where no sample image is installed (the warp share goes to the phantoms).
TRAIN_STEPS, TRAIN_BUFFER = 200, 4096
TRAIN_ARGV = ["--model", "drunet", "--sigma", "0", "--sigma_max", "50", "--batch", "16", "--patch", "64",
              "--synth", str(TRAIN_BUFFER), "--synth_size", "128", "--lr_decay", "cosine", "--ema", "0.999",
              "--steps", str(TRAIN_STEPS), "--scan_steps", "100", "--synth_refresh", "100", "--ckpt_every", "100"]
TRAIN_F64_ATOL = 1e-9  # float64 on the card against the port's CPU run: parameters after the steps
# full-width DRUNet, float32 against float64 on the card, 2 Adam steps (lr 1e-4) on one injected
# batch (16 x 64^2), both read relative to float64's (precision_readings). On three batches
# (probes/train_probe.py precision; PERF.md): the first step's gradient, its largest difference
# over its largest entry, 2.29e-5 to 5.60e-5 in float32 and 7.30e-4 to 8.14e-4 with TF32
# convolutions; the parameters' change over the 2 steps, the norm of its difference over its norm,
# 8.20e-3 to 1.02e-2 in float32 and 6.79e-2 to 6.95e-2 with TF32. Each limit lies between the two.
TRAIN_GRAD_RTOL = 1e-4
TRAIN_STEP_RTOL = 2.5e-2
UNROLL_ITERS, UNROLL_B, UNROLL_HW = 10, 2, 256


def _cli_json(argv, timings=None) -> list:
    """Run the training CLI's ``main(argv, timings)`` in this process; its JSON lines."""
    import contextlib
    import io

    from pnp_admm_cnc_mri_torch.cli import train_denoiser

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_denoiser.main(argv, timings)
    check(rc == 0, f"train_denoiser {argv} returned {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def _max_diff(a: dict, b: dict) -> float:
    check(set(a) == set(b), "the two states have other keys")
    return max(float((a[k].double().cpu() - b[k].double().cpu()).abs().max()) for k in a)


def precision_readings(dev, noisy, clean, sig) -> tuple:
    """Full-width DRUNet (Flax init, seed 0) trained 2 steps on one batch in
    float32 and in float64 on the card: the norm of the difference of the
    parameters' change over the norm of float64's change, and the largest
    difference of the first step's (clipped) gradient over float64's
    largest entry."""
    import torch

    from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
    from pnp_admm_cnc_mri_torch.train import trainer

    change, g1 = {}, {}
    for dt in (torch.float32, torch.float64):
        m = trainer.prepare_model(UNetRes(2, 1), None, 0, dt, dev)
        p0 = trainer.state_of(m)
        sf = trainer.make_train_step(trainer.make_loss_fn(m, "l2", True),
                                     trainer.make_optimizer(trainer.TrainConfig(), m.parameters(), 2))
        sf(noisy.to(dt), clean.to(dt), sig.to(dt))
        g1[dt] = {k: p.grad.to(torch.float64, copy=True) for k, p in m.named_parameters()}
        sf(noisy.to(dt), clean.to(dt), sig.to(dt))
        change[dt] = {k: v.double() - p0[k].double() for k, v in trainer.state_of(m).items()}
    f32, f64 = change[torch.float32], change[torch.float64]
    norm = lambda d: math.sqrt(sum(float((v * v).sum()) for v in d.values()))  # noqa: E731
    step_rel = norm({k: f32[k] - f64[k] for k in f64}) / norm(f64)
    grad_rel = _max_diff(g1[torch.float32], g1[torch.float64]) / max(
        float(g.abs().max()) for g in g1[torch.float64].values())
    return step_rel, grad_rel


def _finite_losses(lines, what):
    losses = [l for d in lines for _, l in d.get("losses", [])]
    check(bool(losses) and all(math.isfinite(l) for l in losses), f"{what}: losses {losses}")
    return losses


def phase_train(dev, tmp: str, tdir: str) -> dict:
    """The denoiser trainers on the card: full-width DRUNet on the synthetic
    stream through the CLI (its npz loaded into a PnP-FISTA solve), DnCNN on
    host and on-device batches, the IRCNN bundle, FFDNet distillation, the
    unrolled trainer, and the held numbers (float64 card vs CPU, float32 vs
    float64, two runs bit-equal, TF32 set on changing nothing)."""
    import warnings

    import numpy as np
    import torch

    from pnp_admm_cnc_mri_torch.data import masks
    from pnp_admm_cnc_mri_torch.models import describe
    from pnp_admm_cnc_mri_torch.models.dncnn import DnCNN
    from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
    from pnp_admm_cnc_mri_torch.ops import fused_dc, tail_kernels
    from pnp_admm_cnc_mri_torch.priors import denoiser
    from pnp_admm_cnc_mri_torch.solvers import fista
    from pnp_admm_cnc_mri_torch.train import data as data_mod, synth, trainer, unroll
    from pnp_admm_cnc_mri_torch.utils import flops, profiling

    torch.cuda.synchronize()
    tail_kernels.reset_launches()
    fused_dc.reset_launches()
    out_dir = os.path.join(tmp, "train")
    res = {}

    # 1. full-width DRUNet at the published stream config (batch 16, 64^2 patches): 3 steps to pay
    # the process's first-use cost of these convolutions (PERF.md: ~8 s), then the step's split (20
    # steps synchronized at each part), FLOPs and time, then the CLI run, all warm
    gen = synth.make_generator(size=128)
    cfg = trainer.TrainConfig(learning_rate=1e-4, lr_decay="cosine")
    stream = dict(batch_size=16, patch=64, cfg=cfg, buffer_images=64, conditioned=True, ema_decay=0.999,
                  log_every=100, device=dev)
    trainer.train_denoiser_stream(UNetRes(2, 1), lambda g, n: gen(g, 64), (0.0, 50 / 255), steps=3, **stream)
    timers = profiling.PhaseTimers()
    g0 = torch.Generator(dev).manual_seed(0)
    with timers.phase("synthesis"):
        gen(g0, TRAIN_BUFFER)
        torch.cuda.synchronize()
    trainer.train_denoiser_stream(UNetRes(2, 1), lambda g, n: gen(g, 64), (0.0, 50 / 255), steps=20, timers=timers,
                                  **stream)
    split = {k: v["mean_s"] * 1e3 for k, v in timers.report().items()}
    model = trainer.prepare_model(UNetRes(2, 1), None, 0, torch.float32, dev)
    step_fn = trainer.make_train_step(trainer.make_loss_fn(model, "l2", True),
                                      trainer.make_optimizer(cfg, model.parameters(), 10))
    bt = torch.rand((16, 1, 64, 64), device=dev)
    sig = torch.full((16, 1, 1, 1), 25 / 255, device=dev)
    noisy = bt + sig * torch.randn_like(bt)
    step_flops = flops.matmul_flops(step_fn, noisy, bt, sig)
    step_ms = cuda_ms(lambda: step_fn(noisy, bt, sig), reps=5, inner=5)
    res["drunet_step"] = {"split_ms": split, "flops": step_flops, "step_ms": step_ms,
                          "fp32_peak_share": step_flops / (step_ms / 1e3) / FP32_FLOPS}
    # then through the CLI, at the published stream config cut to 200 steps
    dru_npz = os.path.join(out_dir, "drunet.npz")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cli_split = {}
    t0 = time.perf_counter()
    lines = _cli_json(TRAIN_ARGV + ["--out", dru_npz], cli_split)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = _finite_losses(lines, "drunet stream")
    ckpts = [d["step"] for d in lines if "ckpt" in d]
    check(ckpts == [100, 200, 200], f"drunet stream checkpoints at {ckpts}")
    steps_s = cli_split["train_s"] - cli_split["synthesis_s"] - cli_split["checkpoint_s"]  # the steps alone
    res["drunet_cli"] = {"steps": TRAIN_STEPS, "wall_s": wall, "steps_per_s": TRAIN_STEPS / wall,
                         "patches_per_s": 16 * TRAIN_STEPS / wall, "steps_only_per_s": TRAIN_STEPS / steps_s,
                         "patches_only_per_s": 16 * TRAIN_STEPS / steps_s, "split_s": cli_split,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                         "loss_first": losses[0], "loss_last": losses[-1]}
    d = denoiser.build_denoiser("drunet_gray", weights=dru_npz, iter_num=8, device=dev)
    check(describe.num_params(d.model) == 32_638_656, f"DRUNet has {describe.num_params(d.model)} parameters")
    rng = np.random.default_rng(3)
    gen_cpu = torch.Generator().manual_seed(3)
    img = synth.mri_phantoms(gen_cpu, 4, 256)
    mk = torch.from_numpy(masks.random_mask((256, 256), fraction=0.3, seed=1)).float()
    y = torch.fft.fft2(img) * mk + torch.from_numpy(
        (3.0 * (rng.standard_normal((4, 256, 256)) + 1j * rng.standard_normal((4, 256, 256)))).astype(np.complex64))
    x = fista.pnp_fista(y.to(dev), mk.to(dev), 8, d)[0].x
    check(bool(torch.isfinite(x).all()) and float(x.min()) >= 0.0 and float(x.max()) <= 1.0,
          "PnP-FISTA with the trained DRUNet: not finite or outside [0, 1]")
    log(f"train: DRUNet (32,638,656 parameters) through the CLI at the round-15 stream config cut to "
        f"{TRAIN_STEPS} steps: {json.dumps(res['drunet_cli'])}; checkpoints at {ckpts}; the npz loads through "
        f"build_denoiser and a 4 x 256^2 PnP-FISTA solve with it is finite in [0, 1]")
    log(f"timing train: DRUNet step at 16 x 64^2 {step_ms:.3f} ms (CUDA events, float32, TF32 off), "
        f"{step_flops / 1e9:.2f} GFLOP ({res['drunet_step']['fp32_peak_share']:.1%} of the float32 peak); split of "
        f"a synchronized step and a 4096-image buffer synthesis (ms): {json.dumps(split)}")

    # 2. DnCNN on host batches and on the device, the IRCNN bundle, FFDNet distilled from the DRUNet
    small = ["--trainset", os.path.join(tdir, "phantoms4"), "--sigma", "15", "--batch", "64", "--patch", "40"]
    for tag, extra in (("dncnn_host", []), ("dncnn_ondevice", ["--ondevice", "--scan_steps", "10", "--ema", "0.999"])):
        npz = os.path.join(out_dir, f"{tag}.npz")
        t0 = time.perf_counter()
        lines = _cli_json(["--model", "dncnn", "--steps", "30", *small, *extra, "--out", npz])
        torch.cuda.synchronize()
        res[tag] = {"steps": 30, "wall_s": time.perf_counter() - t0,
                    "losses": _finite_losses(lines, tag)[-2:]}
        dn = denoiser.build_denoiser("dncnn_15", weights=npz, device=dev)
        check(bool(torch.isfinite(dn(img[:2].to(dev), 0)).all()), f"{tag}: the trained DnCNN's output")
    ir_npz = os.path.join(out_dir, "ircnn.npz")
    t0 = time.perf_counter()
    lines = _cli_json(["--model", "ircnn", "--bundle", "--steps", "20", "--bundle_steps", "2", *small,
                       "--out", ir_npz])
    torch.cuda.synchronize()
    check(lines[-1]["bins"] == list(range(25)), f"ircnn bundle bins {lines[-1]}")
    with np.load(ir_npz) as z:
        check(z["params/layer0/conv/kernel"].shape == (25, 3, 3, 1, 64), "the IRCNN bundle's stack")
    di = denoiser.build_denoiser("ircnn_gray", weights=ir_npz, iter_num=8, device=dev)
    check(bool(torch.isfinite(di(img[:2].to(dev), 3)).all()), "the trained IRCNN bundle's output")
    res["ircnn_bundle"] = {"steps": 20 + 24 * 2, "wall_s": time.perf_counter() - t0}
    ff_npz = os.path.join(out_dir, "ffdnet.npz")
    t0 = time.perf_counter()
    lines = _cli_json(["--model", "ffdnet", "--synth", "256", "--synth_size", "128", "--patch", "64",
                       "--batch", "32", "--lr", "5e-5", "--sigma", "0", "--sigma_max", "50", "--steps", "20",
                       "--scan_steps", "10", "--ema", "0.999", "--lr_decay", "cosine", "--distill", dru_npz,
                       "--distill_weight", "0.7", "--out", ff_npz])
    torch.cuda.synchronize()
    res["ffdnet_distill"] = {"steps": 20, "wall_s": time.perf_counter() - t0,
                             "losses": _finite_losses(lines, "ffdnet distill")[-2:]}
    dff = denoiser.build_denoiser("ffdnet_gray", weights=ff_npz, device=dev)
    check(bool(torch.isfinite(dff(img[:2].to(dev), 0)).all()), "the distilled FFDNet's output")
    log(f"train: DnCNN (nb 17) on host and on-device batches of the phantom PNGs, the IRCNN 25-bin bundle and "
        f"FFDNet distilled from the DRUNet npz trained, saved and loaded through build_denoiser: "
        f"{json.dumps({k: res[k] for k in ('dncnn_host', 'dncnn_ondevice', 'ircnn_bundle', 'ffdnet_distill')})}")

    # 3. the unrolled trainer: full-width DRUNet through 10 PnP-FISTA iterations at 2 x 256^2
    hw = (UNROLL_HW, UNROLL_HW)
    mstack = np.stack([masks.random_mask(hw, fraction=0.3, seed=1), masks.radial_mask(hw),
                       masks.cartesian_mask(hw, fraction=0.3, seed=1)]).astype(np.float32)
    umodel = UNetRes(2, 1)
    uden = unroll.make_drunet_ladder_denoise(umodel, UNROLL_ITERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, ulosses = unroll.train_unrolled(umodel, uden, mstack, UNROLL_ITERS, generator=synth.make_generator(size=UNROLL_HW),
                                       steps=4, batch_size=UNROLL_B, noise_std=15.0, noise_jitter=0.3,
                                       ema_decay=0.999, log_every=1, buffer_images=8, device=dev)
    torch.cuda.synchronize()
    uwall = time.perf_counter() - t0
    check(len(ulosses) == 4 and all(math.isfinite(l) for _, l in ulosses), f"unrolled losses {ulosses}")
    # one step's time, peak memory and gradients, checkpointed and plain, on one batch
    clean = synth.mri_phantoms(torch.Generator(dev).manual_seed(5), UNROLL_B, UNROLL_HW)
    mkb = torch.from_numpy(mstack[:UNROLL_B]).to(dev)
    nz = unroll.unrolled_noise(torch.Generator(dev).manual_seed(6), (UNROLL_B, *hw), 15.0, 0.3, torch.float32)
    grads, ustep = {}, {}
    for remat in (True, False):
        m = trainer.prepare_model(UNetRes(2, 1), None, 0, torch.float32, dev)
        opt = trainer.make_optimizer(trainer.TrainConfig(learning_rate=2e-5), m.parameters(), 4)
        rec = unroll.make_unrolled_recon(unroll.make_drunet_ladder_denoise(m, UNROLL_ITERS), UNROLL_ITERS, remat=remat)
        stepf = unroll.make_unrolled_step(rec, opt)
        torch.cuda.reset_peak_memory_stats()
        _, ms = event_ms(lambda: stepf(clean, mkb, nz))
        grads[remat] = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        ustep[remat] = {"step_ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    gdiff = _max_diff(grads[True], grads[False])
    gscale = max(float(g.abs().max()) for g in grads[False].values())
    check(gdiff <= 1e-5 * gscale, f"unrolled gradients, checkpointed vs plain: {gdiff} (scale {gscale})")
    res["unroll"] = {"steps": 4, "wall_s": uwall, "step_ms_remat": ustep[True]["step_ms"],
                     "peak_gib_remat": ustep[True]["peak_gib"], "step_ms_plain": ustep[False]["step_ms"],
                     "peak_gib_plain": ustep[False]["peak_gib"], "grad_diff": gdiff, "grad_scale": gscale}
    log(f"train: train_unrolled, full-width DRUNet, {UNROLL_ITERS} PnP-FISTA iterations, {UNROLL_B} x "
        f"{UNROLL_HW}^2, random/radial/Cartesian masks, noise std 15 jitter 0.3, EMA: 4 steps finite; "
        f"checkpointed vs plain gradients {gdiff:.3g} (largest gradient {gscale:.3g}); {json.dumps(res['unroll'])}")

    # 4. held numbers
    # float64 on the card against the port's CPU run: 3 DnCNN steps on host batches, one unrolled step
    pt = data_mod.extract_patches([im.numpy() for im in synth.mri_phantoms(torch.Generator().manual_seed(7), 2, 96)],
                                  patch=40, stride=20)
    f64, cpu = {}, torch.device("cpu")
    for where in (dev, cpu):
        f64[where], _ = trainer.train_denoiser(DnCNN(1, 1, nc=64, nb=17), pt, 15 / 255, steps=3, batch_size=8,
                                               dtype=torch.float64, device=where)
    err_dn = _max_diff(f64[dev], f64[cpu])
    check(err_dn <= TRAIN_F64_ATOL, f"DnCNN float64 card vs CPU after 3 steps: {err_dn}")
    un64, ns = {}, np.random.default_rng(8)
    c64 = ns.random((2, 64, 64))
    m64 = np.stack([masks.random_mask((64, 64), fraction=0.3, seed=1)] * 2).astype(np.float64)
    n64 = 2.0 * ns.standard_normal((2, 2, 64, 64))
    for where in (dev, cpu):
        m = trainer.prepare_model(UNetRes(2, 1, nc=(8, 16, 32, 64), nb=1), None, 0, torch.float64, where)
        opt = trainer.make_optimizer(trainer.TrainConfig(learning_rate=1e-3), m.parameters(), 1)
        stepf = unroll.make_unrolled_step(unroll.make_unrolled_recon(unroll.make_drunet_ladder_denoise(m, 3), 3,
                                                                     dtype=torch.float64), opt)
        stepf(*(torch.from_numpy(a).to(where) for a in (c64, m64, n64)))
        un64[where] = trainer.state_of(m)
    err_un = _max_diff(un64[dev], un64[cpu])
    check(err_un <= TRAIN_F64_ATOL, f"unrolled step float64 card vs CPU: {err_un}")
    # full-width DRUNet, float32 against float64 on the card: 2 steps on one injected batch
    step_32, grad_32 = precision_readings(dev, noisy, bt, sig)
    check(grad_32 <= TRAIN_GRAD_RTOL, f"DRUNet float32 vs float64, the first step's gradient: {grad_32} of its largest")
    check(step_32 <= TRAIN_STEP_RTOL, f"DRUNet float32 vs float64, the change over 2 steps: {step_32} of its norm")
    # two 20-step runs from one seed, and a third with TF32 set on in the process: bit-equal
    runs = []
    prev_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    for tf32 in (False, False, True):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        runs.append(trainer.train_denoiser_stream(UNetRes(2, 1), lambda g, n: gen(g, 64), (0.0, 50 / 255), steps=20,
                                                  scan_steps=10, seed=4, **stream))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    rep, tf = _max_diff(runs[0][0], runs[1][0]), _max_diff(runs[0][0], runs[2][0])
    check(rep == 0.0 and runs[0][1] == runs[1][1], f"two 20-step DRUNet runs from one seed differ by {rep}")
    check(tf == 0.0 and runs[0][1] == runs[2][1], f"the run with TF32 set on differs by {tf}")
    res["held"] = {"dncnn_f64_card_vs_cpu": err_dn, "unroll_f64_card_vs_cpu": err_un, "drunet_f32_vs_f64_step_rel": step_32,
                   "drunet_f32_vs_f64_grad_rel": grad_32,
                   "repeat_diff": rep, "tf32_on_diff": tf}
    torch.cuda.synchronize()
    launches = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                "fused_iteration": fused_dc.fused_iteration.launches}
    check(launches == dict.fromkeys(launches, 0), f"the train phase launched {launches}")
    log(f"train: held: {json.dumps(res['held'])} (limits: float64 {TRAIN_F64_ATOL}, float32 vs float64 "
        f"{TRAIN_GRAD_RTOL} of the largest gradient and {TRAIN_STEP_RTOL} of the 2 steps' change, repeats and TF32 "
        f"bit-equal); K1-K3 launches on the phase {json.dumps(launches)}")
    return res


# the cli phase: the JAX CLI's result keys; the CNN and BM3D algorithms' depth
# (cut from their 30-50 iterations); one run of each algorithm beyond the
# classical five, covering every reference model name, the DnCNN pair, one
# --bf16 and one --tuned run
CLI_KEYS = {"psnr", "ssim", "re", "per_image_psnr", "wall_s", "images", "iters"}
CLI_CLASSICAL = ("admm_l1", "admm_cnc", "fista_l1", "pgd_l1", "consensus_l1")
CLI_DEPTH = 4
CLI_RUNS = (
    ("pnp_l1_bm3d", None, []), ("pnp_cnc_bm3d", None, []), ("pnp_l1_d", "drunet_gray", []),
    ("pnp_cnc_d", "dncnn_25", ["--model2", "dncnn_25"]), ("consensus_d", "ffdnet_gray", ["--tuned"]),
    ("consensus_fista_d", "drunet_gray", []), ("consensus_hqs_d", "ircnn_gray", []),
    ("pnp_sr", "drunet_gray", ["--bf16"]), ("pnp_deblur", "fdncnn_gray", []), ("pnp_fista_d", "tdnet", []),
    ("pnp_pgd_d", "ffdnet_gray", []), ("pnp_pgd_cnc", "drunet_gray", []), ("pnp_hqs_d", "ircnn_gray", []),
    ("red_d", "dncnn_25", []),
)
CLI_F64_DB = 1e-9  # admm_l1 --f64, the card against the CPU, per image
# pnp_deblur (float32 in both packages), the card against the CPU on set1: probes/cli_deblur_precision.py read
# 3.5e-5 to 2.49e-4 dB over 4 phantom/weight seeds, and 2.88e-3 to 1.00e-2 dB with the convolutions in TF32
CLI_DEBLUR_DB = 1e-3
CLI_FOLD_NLM = "12,15"


def write_cli_assets(tdir: str, root: str) -> dict:
    """The testset ``set`` (15 phantoms at 256 x 256, ``01``-``15``), ``set1``
    (its ``05``) under ``tdir``, and one seeded full-width npz per reference
    model name under ``root`` (``save_npz`` of a Flax-rule init; IRCNN as the
    25-bin bundle); returns {model name: path}."""
    import torch

    from pnp_admm_cnc_mri_torch.data import images, phantom
    from pnp_admm_cnc_mri_torch.models import convert, dncnn, drunet, ffdnet, tdnet

    for k, im in enumerate(phantom.mri_phantoms(15, H, seed=7)):
        images.imsave(im * 255.0, os.path.join(tdir, "set", f"{k + 1:02d}.png"))
        if k == 4:
            images.imsave(im * 255.0, os.path.join(tdir, "set1", "05.png"))
    make = {"dncnn_25": lambda: dncnn.DnCNN(1, 1), "fdncnn_gray": lambda: dncnn.FDnCNN(2, 1),
            "ffdnet_gray": lambda: ffdnet.FFDNet(1, 1), "drunet_gray": lambda: drunet.UNetRes(2, 1),
            "tdnet": lambda: tdnet.TDNet(1, 1)}
    paths = {}
    for k, name in enumerate([*make, "ircnn_gray"]):
        gen = torch.Generator().manual_seed(100 + k)
        paths[name] = os.path.join(root, f"{name}.npz")
        if name == "ircnn_gray":
            sds = [convert.flax_init_(dncnn.IRCNN(1, 1), gen).state_dict() for _ in range(25)]
            convert.save_npz({n: torch.stack([sd[n] for sd in sds]) for n in sds[0]}, paths[name])
        else:
            convert.save_npz(convert.flax_init_(make[name](), gen), paths[name])
    return paths


@contextlib.contextmanager
def _denoiser_convs_in_tf32():
    """The port's denoisers with cuDNN's TF32 on inside the block (they turn
    it off through ``denoiser.full_precision_convs``): a control."""
    import torch

    from pnp_admm_cnc_mri_torch.priors import denoiser

    @contextlib.contextmanager
    def tf32_convs():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    sound, denoiser.full_precision_convs = denoiser.full_precision_convs, tf32_convs
    try:
        yield
    finally:
        denoiser.full_precision_convs = sound


def _run_main(main, argv) -> list:
    """``main(argv)`` in this process; its stdout lines (return code 0 held)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # BM3D's ignored CNN knobs and the like
        rc = main(argv)
    check(rc == 0, f"{argv} returned {rc}")
    return buf.getvalue().strip().splitlines()


def phase_cli(dev, tmp: str, tdir: str, ddir: str) -> dict:
    """The port's command line: the 19 algorithms through ``cli.main.main``
    on the 15-phantom testset with the launch counts set to 0 before and read
    after each; K1 and K2 against their plain versions at that shape;
    ``--f64`` on the card against ``--cpu --f64``; the real entry
    point as a cold subprocess; ``cli.eval_folds.main`` on 5 fold files."""
    import numpy as np
    import torch

    from pnp_admm_cnc_mri_torch.cli import eval_folds, experiments, main as cli_main
    from pnp_admm_cnc_mri_torch.models import convert, drunet
    from pnp_admm_cnc_mri_torch.ops import fourier, fused_dc, metrics, tail_kernels

    t = time.perf_counter()
    weights = write_cli_assets(tdir, tmp)
    t_assets = time.perf_counter() - t
    files = ["--testsets_dir", tdir, "--data_dir", ddir]
    # the zero-filled PSNR of each phantom, which the classical algorithms must beat: under Q_Random30,
    # and (consensus_l1) the consensus start, the mean of the three masks' zero-filled magnitudes
    starts = []
    for mname in ("Q_Random30", "Q_Radial30", "Q_Cartesian30"):
        b = experiments.prepare_batch(os.path.join(tdir, "set"), mname, ddir)
        starts.append(torch.abs(fourier.zero_fill(torch.as_tensor(b["y"], device=dev))))
        truth, names = torch.as_tensor(b["truth"], device=dev), b["names"]
    zf = {"single": metrics.psnr(starts[0] * 255.0, truth).cpu().numpy(),
          "consensus": metrics.psnr(torch.stack(starts).mean(0) * 255.0, truth).cpu().numpy()}
    check(names == [f"{k:02d}" for k in range(1, 16)], f"the testset's names {names}")
    runs = [(a, None, []) for a in CLI_CLASSICAL] + list(CLI_RUNS)
    check(sorted({a for a, _, _ in runs}) == sorted(cli_main.ALGOS), "the phase does not run every algorithm")
    out, launches, call_s = {}, {}, {}
    for k, (algo, model, extra) in enumerate(runs):
        argv = [algo, "--testset", "set", *files, "--results_dir", os.path.join(tmp, "cli", str(k))]
        if model is not None:
            argv += ["--model", model, "--weights", weights[model], "--iter_num", str(CLI_DEPTH)]
            if "--model2" in extra:
                argv += ["--weights2", weights[extra[extra.index("--model2") + 1]]]
        elif algo not in CLI_CLASSICAL:
            argv += ["--iter_num", str(CLI_DEPTH)]  # the BM3D pipelines
        argv += extra
        tag = "_".join(x for x in (algo, model, *[e for e in extra if e.startswith("--") and e != "--model2"]) if x)
        torch.cuda.synchronize()
        tail_kernels.reset_launches()
        fused_dc.reset_launches()
        t_call = time.perf_counter()
        lines = _run_main(cli_main.main, argv)
        torch.cuda.synchronize()
        call_s[tag] = time.perf_counter() - t_call
        launches[tag] = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                         "fused_iteration": fused_dc.fused_iteration.launches}
        res = out[tag] = json.loads(lines[-1])
        check(set(res) == CLI_KEYS, f"{tag}: the result line's keys {sorted(res)}")
        want = {"l1_tail": 0, "cnc_tail": 0, "fused_iteration": 0}
        if algo in ("admm_l1", "admm_cnc"):
            want["l1_tail" if algo == "admm_l1" else "cnc_tail"] = ITERS
        check(launches[tag] == want, f"{tag}: launches {launches[tag]}, expected {want}")
        p = np.array([res["per_image_psnr"][n] for n in names])
        check(res["images"] == 15 and list(res["per_image_psnr"]) == names and bool(np.all(np.isfinite(p))),
              f"{tag}: {res}")
        if algo in CLI_CLASSICAL:
            base = zf["consensus" if algo == "consensus_l1" else "single"]
            check(bool(np.all(p > base)), f"{tag}: {int(np.sum(p <= base))} images not above their zero-filled PSNR")
        [res_dir] = os.listdir(os.path.join(tmp, "cli", str(k)))
        with open(os.path.join(tmp, "cli", str(k), res_dir, res_dir + ".log")) as f:
            log_lines = f.read().splitlines()
        check(len(log_lines) == 16 and "Average PSNR" in log_lines[-1]
              and all(re.match(LOG_LINE, line) for line in log_lines[:15]), f"{tag}: the .log {log_lines[:2]} ...")
    # K1 and K2 against their plain versions at the CLI's shape, float32, with admm_l1's and admm_cnc's scalars
    from pnp_admm_cnc_mri_torch.config import ADMM_CNC_DEFAULT, ADMM_L1_DEFAULT

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    shape = (len(names), H, W)
    ops = [torch.randn(shape, generator=gen, device=dev) * 10.0 ** (-4.0 * torch.rand(shape, generator=gen, device=dev))
           for _ in range(3)]
    c = ADMM_L1_DEFAULT.rho * ADMM_L1_DEFAULT.lam
    cnc = (ADMM_CNC_DEFAULT.alpha, ADMM_CNC_DEFAULT.rho, ADMM_CNC_DEFAULT.lam, ADMM_CNC_DEFAULT.b)
    tail_err = {
        "l1_tail": same(tail_kernels.l1_tail(*ops, c), tail_kernels.l1_tail_plain(*ops, c), "l1_tail at the CLI's"),
        "cnc_tail": same(tail_kernels.cnc_tail(*ops, *cnc), tail_kernels.cnc_tail_plain(*ops, *cnc),
                         "cnc_tail at the CLI's"),
    }
    del ops
    # --f64: the card against the CPU on set1 (pnp_deblur runs float32 in either, as in the JAX package)
    # and, as a control, pnp_deblur on the card with its denoiser's convolutions in TF32, which the limit must see
    f64 = {}
    for algo, extra in (("admm_l1", []), ("pnp_deblur", ["--model", "drunet_gray", "--weights", weights["drunet_gray"],
                                                          "--iter_num", str(CLI_DEPTH)])):
        got = {}
        for where in ("card", "cpu", "tf32") if algo == "pnp_deblur" else ("card", "cpu"):
            argv = [algo, "--f64", "--testset", "set1", *files, "--no_save", *extra,
                    "--results_dir", os.path.join(tmp, "cli_f64", where)] + (["--cpu"] if where == "cpu" else [])
            with _denoiser_convs_in_tf32() if where == "tf32" else contextlib.nullcontext():
                got[where] = json.loads(_run_main(cli_main.main, argv)[-1])["per_image_psnr"]["05"]
        f64[algo] = abs(got["card"] - got["cpu"])
        if "tf32" in got:
            f64["pnp_deblur_tf32"] = abs(got["tf32"] - got["cpu"])
    check(f64["admm_l1"] < CLI_F64_DB, f"admm_l1 --f64, card vs CPU: {f64['admm_l1']} dB")
    check(f64["pnp_deblur"] < CLI_DEBLUR_DB, f"pnp_deblur (float32), card vs CPU: {f64['pnp_deblur']} dB")
    check(f64["pnp_deblur_tf32"] > CLI_DEBLUR_DB, f"pnp_deblur with TF32 convolutions, card vs CPU: "
          f"{f64['pnp_deblur_tf32']} dB, within the limit {CLI_DEBLUR_DB} dB, which therefore cannot see TF32")
    # the real entry point, cold, from outside the repository
    sub_dir = os.path.join(tmp, "cli_sub")
    os.makedirs(sub_dir)
    t_sub = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pnp_admm_cnc_mri_torch.cli.main", "admm_l1", "--testset", "set",
                           *files, "--no_save", "--results_dir", sub_dir], cwd=sub_dir, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    sub_s = time.perf_counter() - t_sub
    check(proc.returncode == 0, f"the CLI subprocess exited {proc.returncode}: {proc.stderr[-2000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    d_sub = max(abs(sub["per_image_psnr"][n] - out["admm_l1"]["per_image_psnr"][n]) for n in names)
    check(set(sub) == CLI_KEYS and d_sub < CLI_F64_DB, f"the subprocess's admm_l1 vs in-process: {d_sub} dB")
    # eval_folds on 5 seeded DRUNet fold files that partition 01-15
    folds = {}
    for f in range(5):
        path = os.path.join(tmp, f"fold{f}.npz")
        convert.save_npz(convert.flax_init_(drunet.UNetRes(2, 1), torch.Generator().manual_seed(200 + f)), path)
        folds[f"fold{f}"] = {"weights": path, "held_out": [f"{3 * f + i:02d}" for i in (1, 2, 3)]}
    manifest = os.path.join(tmp, "folds.json")
    with open(manifest, "w") as fh:
        json.dump({"model": "drunet_gray", "folds": folds}, fh)
    t_folds = time.perf_counter()
    prev_tmp, tempfile.tempdir = tempfile.tempdir, tmp  # the CLI runs' logs go under the temporary directory
    try:
        lines = _run_main(eval_folds.main, ["--manifest", manifest, "--select_nlm", CLI_FOLD_NLM, "--out",
                                            os.path.join(tmp, "folds.jsonl"),
                                            "--extra", " ".join([*files, "--iter_num", str(CLI_DEPTH)])])
    finally:
        tempfile.tempdir = prev_tmp
    folds_s = time.perf_counter() - t_folds
    summary = json.loads(lines[-1])
    held = {}
    for line in lines[:-1]:
        rec = json.loads(line)
        held.update(rec.get("held_out", {}))
    check(sorted(held) == names and sorted(summary["per_image"]) == names, f"eval_folds: {lines}")
    comp_err = abs(summary["composite_fold_exclusion_psnr"] - sum(held.values()) / 15)
    check(comp_err < 1e-3, f"eval_folds composite {summary['composite_fold_exclusion_psnr']} vs its held-out mean")
    with open(os.path.join(tmp, "folds.jsonl")) as fh:
        n_rows = len(fh.read().splitlines())
    check(n_rows == 11, f"eval_folds wrote {n_rows} JSONL rows, expected 11")
    walls = {k: v["wall_s"] for k, v in out.items()}
    log(f"cli: 19 algorithms through cli.main.main on 15 x {H} x {W} (classical at their default depth, CNN and BM3D "
        f"at {CLI_DEPTH} iterations, full-width seeded weights); launches per run {json.dumps(launches)}; K1 and K2 "
        f"against their plain versions at {shape} float32 with the CLI's scalars, max abs error "
        f"{json.dumps(tail_err)}; every "
        f"classical image above its zero-filled PSNR; 15 log lines and the average in each .log; --f64 card vs CPU "
        f"on set1: admm_l1 {f64['admm_l1']:.3g} dB, pnp_deblur (float32) {f64['pnp_deblur']:.3g} dB (limit "
        f"{CLI_DEBLUR_DB:g}; with TF32 convolutions {f64['pnp_deblur_tf32']:.3g} dB); the cold "
        f"subprocess's admm_l1 vs in-process {d_sub:.3g} dB; eval_folds selected {json.dumps(summary['selected_nlm'])}, "
        f"composite {summary['composite_fold_exclusion_psnr']} (its held-out mean within {comp_err:.2g})")
    log(f"timing cli (s): wall_s (the solve, the CLI's own) {json.dumps(walls)}; each in-process call "
        f"{json.dumps({k: round(v, 4) for k, v in call_s.items()})}; the cold subprocess {sub_s:.3f}; eval_folds "
        f"(10 CLI runs) {folds_s:.3f}; assets (PNGs, 6 npz) {t_assets:.3f}; mean PSNR (dB) "
        f"{json.dumps({k: round(v['psnr'], 3) for k, v in out.items()})}")
    return {"wall_s": walls, "call_s": call_s, "subprocess_s": sub_s, "eval_folds_s": folds_s, "tail_err": tail_err}


# -- catalog: the U-Net catalog, KAIR .pth weights, the matmul DC solve, the image readers --
# full-width U-Net variants, float32 (cuDNN TF32 off) against float64 of the same weights: the largest
# difference over the largest output read at most 1.34e-6 on the CPU over 3 seeds at 64 x 64
# (probes/catalog_precision.py cpu 64 1 3); the limit is ~11x that (TF32 convolutions err ~1e-3)
CATALOG_RTOL = 1.5e-5
CATALOG_VARIANTS = ("UNet", "ResUNet", "UNetResSubP", "UNetPlus", "NonLocalUNet")
CATALOG_B = 4
# the matmul DC solve: against the fft solve within the fused kernel's precedent (mean PSNR 0.05 dB);
# float64 at 4 x 256 x 256 (packed) and 4 x 256 x 255 (unpacked) within 1e-9 of the fft solve
DC_PSNR_DB = 0.05
DC_F64_ATOL = 1e-9
FOLD_ATOL = 1e-12  # the folded BatchNorm against the unfolded net, float64
FIXTURES = os.path.join("tests", "torch_image_fixtures")


def kair_key(arch: str, mod: str, nb: int):
    """The reference checkpoint's prefix of the port module ``mod`` of
    ``arch`` (drunet, unet_plus, nonlocal_unet; the converters' layouts),
    and that of the BatchNorm after it (None where there is none)."""
    if mod in ("head", "tail"):
        return ("m_head.0" if mod == "head" and arch == "nonlocal_unet" else f"m_{mod}"), None
    m = re.fullmatch(r"(down|up)_nonlocal\.(theta|phi|g|w)", mod)
    if m:
        t = "m_down3.0" if m.group(1) == "down" else f"m_up3.{2 * (nb + 1)}"
        return (f"{t}.W.0", f"{t}.W.1") if m.group(2) == "w" else (f"{t}.{m.group(2)}", None)
    m = re.fullmatch(r"(?:(down|up)(\d)|body)_(res|conv|ds|us)(\d*)(?:\.conv(\d)?)?", mod)
    kind, lvl, blk, i, c = m.group(1) or "body", int(m.group(2) or 0), m.group(3), int(m.group(4) or 0), m.group(5)
    t = "m_body" if kind == "body" else f"m_{kind}{lvl + 1}"
    if arch == "drunet":
        if blk in ("ds", "us"):
            return (f"{t}.{nb}" if blk == "ds" else f"{t}.0"), None
        return f"{t}.{i + (kind == 'up')}.res.{2 * (int(c) - 1)}", None
    if arch == "unet_plus":
        if blk == "ds":
            return f"{t}.{3 * nb}", None
        if blk == "us":
            return f"{t}.0", f"{t}.1"
        slot = 3 * (i + (kind == "up"))
        return f"{t}.{slot}", (None if kind == "up" and i == nb - 1 else f"{t}.{slot + 1}")
    off = 1 if (kind, lvl) == ("down", 2) else 0  # nonlocal_unet
    if blk in ("ds", "us"):
        return (f"{t}.{off + 2 * nb}" if blk == "ds" else f"{t}.0"), None
    return (f"{t}.{off + 2 * i}" if kind in ("down", "body") else f"{t}.{2 * (i + 1)}"), None


def kair_state_dict(arch: str, module, nb: int, seed: int):
    """A reference-layout state dict of ``module``'s shapes (seeded normal
    weights of variance 1 / fan-in and biases; random BatchNorm statistics
    after the convs the layout folds), and {port module: (prefix, BatchNorm)}."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd, where = {}, {}
    for key, p in module.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        pre, bn = where[mod] = kair_key(arch, mod, nb)
        sd[f"{pre}.{leaf}"] = torch.randn(p.shape, generator=g, dtype=torch.float64) * (
            p[0].numel() ** -0.5 if leaf == "weight" else 0.1)
        if bn is not None and leaf == "weight":
            n = p.shape[1] if isinstance(module.get_submodule(mod), torch.nn.ConvTranspose2d) else p.shape[0]
            sd.update({f"{bn}.weight": torch.rand(n, generator=g, dtype=torch.float64) + 0.5,
                       f"{bn}.bias": torch.randn(n, generator=g, dtype=torch.float64) * 0.1,
                       f"{bn}.running_mean": torch.randn(n, generator=g, dtype=torch.float64) * 0.3,
                       f"{bn}.running_var": torch.rand(n, generator=g, dtype=torch.float64) + 0.5,
                       f"{bn}.num_batches_tracked": torch.tensor(7)})
    return sd, where


def unfolded_net(module, sd, where):
    """``module`` with the checkpoint's own conv weights and each BatchNorm
    applied after its conv by ``F.batch_norm(training=False)`` (eps 1e-4),
    before any activation: the reference's eval-mode graph."""
    import torch
    import torch.nn.functional as F

    module.load_state_dict({f"{mod}.{leaf}": sd[f"{pre}.{leaf}"] for mod, (pre, _) in where.items()
                            for leaf in ("weight", "bias") if f"{mod}.{leaf}" in module.state_dict()})
    for mod, (_, bn) in where.items():
        if bn is None:
            continue
        conv = module.get_submodule(mod)

        def with_bn(y, bn=bn):
            st = {k: sd[f"{bn}.{k}"].to(y.device) for k in ("running_mean", "running_var", "weight", "bias")}
            return F.batch_norm(y, st["running_mean"], st["running_var"], st["weight"], st["bias"],
                                training=False, eps=1e-4)

        if isinstance(conv, torch.nn.ConvTranspose2d):  # its parent applies the activation after it
            conv.register_forward_hook(lambda m, a, out, f=with_bn: f(out))
        else:
            conv._conv_forward = lambda x, w, b, inner=conv._conv_forward, f=with_bn: f(inner(x, w, b))
    return module


def write_bmp(path: str, rgb) -> None:
    """A bottom-up BMP: 8-bit with a gray palette for (H, W), 24-bit for (H, W, 3) RGB uint8."""
    import struct

    import numpy as np

    h, w = rgb.shape[:2]
    if rgb.ndim == 2:
        px, bpp = rgb, 8
        pal = np.zeros((256, 4), np.uint8)
        pal[:, :3] = np.arange(256)[:, None]
    else:
        px, bpp, pal = rgb[..., ::-1].reshape(h, -1), 24, np.zeros((0, 4), np.uint8)
    stride = (w * bpp + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : px.shape[1]] = px
    off = 14 + 40 + pal.size
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", off + rows.size, 0, 0, off)
                + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0, rows.size, 2835, 2835, len(pal), 0)
                + pal.tobytes() + rows[::-1].tobytes())


def phase_catalog(dev, tmp: str, tdir: str, ddir: str, img, y, mask) -> dict:
    """(a) the five U-Net variants at full width, float32 against float64,
    timed; (b) KAIR .pth weights: DRUNet through ``build_denoiser`` and the
    CLI bit-equal to its npz, the BatchNorm folds of UNetPlus and
    NonLocalUNet against the unfolded nets; (c) the matmul DC solve of
    ``admm_l1`` at the main path's shape against the fft solve, timed in
    turns, and in float64 at even and odd W; (d) ``resolve_dc_method`` on
    the card; (e) the image readers: the fixtures, and a testset of
    ``.png``-named BMP and JPEG payloads through ``cli.main admm_l1``.
    Returns its numbers, the launch counts of each run among them."""
    import copy
    import glob

    import numpy as np
    import torch

    from pnp_admm_cnc_mri_torch.cli import main as cli_main
    from pnp_admm_cnc_mri_torch.config import ADMM_L1_DEFAULT
    from pnp_admm_cnc_mri_torch.data import images, phantom
    from pnp_admm_cnc_mri_torch.models import convert, drunet, unet_variants as uv
    from pnp_admm_cnc_mri_torch.ops import fourier, metrics
    from pnp_admm_cnc_mri_torch.priors import denoiser
    from pnp_admm_cnc_mri_torch.solvers import admm
    from pnp_admm_cnc_mri_torch.utils import flops

    res: dict = {"launches": {}}

    def counted(tag, fn):
        dist_reset()
        out = fn()
        torch.cuda.synchronize()
        res["launches"][tag] = dist_counts()
        return out

    # (a) the U-Net variants at full width
    x32 = torch.from_numpy(img[:CATALOG_B, None]).to(dev)
    nets = {}
    for k, name in enumerate(CATALOG_VARIANTS):
        model = convert.flax_init_(getattr(uv, name)(), torch.Generator().manual_seed(k))
        check(model.nb == {"UNet": 2, "ResUNet": 4, "UNetResSubP": 2, "UNetPlus": 1, "NonLocalUNet": 1}[name],
              f"{name}: nb {model.nb}")
        m32, m64 = model.float().to(dev).eval(), copy.deepcopy(model).double().to(dev).eval()
        for size in ((256, 252) if name == "ResUNet" else (256,)):
            xs = x32[..., :size, :size].contiguous()
            with torch.no_grad(), denoiser.full_precision_convs():
                y32, y64 = counted(f"unet_{name}@{size}", lambda: (m32(xs), m64(xs.double())))
                check(tuple(y32.shape) == tuple(xs.shape) and bool(torch.isfinite(y32).all()),
                      f"{name}@{size}: output {tuple(y32.shape)}, finite {bool(torch.isfinite(y32).all())}")
                rel = float((y32.double() - y64).abs().max() / y64.abs().max())
                check(rel < CATALOG_RTOL, f"{name}@{size}: float32 vs float64 {rel} of the largest output")
                ms = cuda_ms(lambda: m32(xs), reps=5)
                fl = flops.matmul_flops(m32, xs)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base_mem = torch.cuda.memory_allocated()
                m32(xs)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base_mem
            nets[f"{name}@{size}"] = {"f32_vs_f64_rel": rel, "forward_ms": ms, "gflop": fl / 1e9,
                                      "fp32_peak_share": fl / (ms / 1e3) / FP32_FLOPS, "peak_mib": peak / 2**20,
                                      "params_m": sum(p.numel() for p in model.parameters()) / 1e6}
        del m32, m64
    res["unets"] = nets
    log(f"catalog (a): U-Net variants at nc (64, 128, 256, 512), {CATALOG_B} x 1 x 256 x 256 (ResUNet also 252): "
        + json.dumps(nets))

    # (b) KAIR .pth: full-width DRUNet through build_denoiser and the CLI, bit-equal to its npz
    net = drunet.UNetRes(2, 1)
    sd, _ = kair_state_dict("drunet", net, 4, seed=21)
    pth, npz = os.path.join(tmp, "drunet_kair.pth"), os.path.join(tmp, "drunet_kair.npz")
    torch.save({k: v.float() for k, v in sd.items()}, pth)
    tree = convert.convert_drunet({k: v.float() for k, v in sd.items()})
    net.load_state_dict(convert.state_dict_from_flax(net, tree))
    convert.save_npz(net, npz)
    v = torch.from_numpy(img[:CATALOG_B]).to(dev)
    d_pth, d_npz = (denoiser.build_denoiser("drunet_gray", weights=p, iter_num=8) for p in (pth, npz))
    for i in (0, 7):
        check(torch.equal(d_pth(v, i), d_npz(v, i)), f"DRUNet from the .pth differs from its npz at iteration {i}")
    cli_lines = {}
    for tag, wpath in (("pth", pth), ("npz", npz)):
        argv = ["pnp_cnc_d", "--model", "drunet_gray", "--weights", wpath, "--iter_num", "4", "--testset", "set1",
                "--testsets_dir", tdir, "--data_dir", ddir, "--results_dir", os.path.join(tmp, "catalog_cli", tag)]
        cli_lines[tag] = json.loads(counted(f"cli_pnp_cnc_d_{tag}", lambda: _run_main(cli_main.main, argv))[-1])
    check(cli_lines["pth"]["per_image_psnr"] == cli_lines["npz"]["per_image_psnr"],
          f"the CLI with the .pth {cli_lines['pth']['per_image_psnr']} vs its npz {cli_lines['npz']['per_image_psnr']}")
    # the BatchNorm folds against the unfolded nets, float64
    folds = {}
    for arch, cls in (("unet_plus", uv.UNetPlus), ("nonlocal_unet", uv.NonLocalUNet)):
        folded = cls().double()
        sd, where = kair_state_dict(arch, folded, 1, seed=22)
        folded.load_state_dict(convert.state_dict_from_flax(folded, convert.CONVERTERS[arch](sd, nb=1),
                                                            torch.float64))
        ref = unfolded_net(cls().double(), sd, where)
        with torch.no_grad():
            x64 = x32.double()
            folds[arch] = float((folded.to(dev).eval()(x64) - ref.to(dev).eval()(x64)).abs().max())
        check(folds[arch] < FOLD_ATOL, f"{arch}: folded BatchNorm vs unfolded {folds[arch]}")
        check(sum(bn is not None for _, bn in where.values()) >= 2, f"{arch}: no BatchNorm to fold")
    res["bn_fold_max_abs"] = folds
    log(f"catalog (b): full-width DRUNet from a KAIR .pth through build_denoiser bit-equal to its npz (iterations "
        f"0, 7); pnp_cnc_d through the CLI with --weights .pth equal to the npz run ({cli_lines['pth']['psnr']} dB);"
        f" BatchNorm folds against F.batch_norm, float64 at {CATALOG_B} x 256 x 256: {json.dumps(folds)}")

    # (c) the matmul DC solve at the main path's shape against the fft solve, then in turns
    forms = ("fft", "matmul")

    def solve(form, yy, mm, dtype=torch.float32):
        return admm.admm_l1(yy, mm, ADMM_L1_DEFAULT, dtype=dtype, dc_method=form)[0].x

    xs_dc = {f: counted(f"admm_l1_{f}", lambda: solve(f, y, mask)) for f in forms}
    truth = torch.from_numpy(img).to(dev) * 255.0
    psnr = {f: float(metrics.psnr(x * 255.0, truth).mean()) for f, x in xs_dc.items()}
    dc_q = {}
    for f, x in xs_dc.items():
        check(bool(torch.isfinite(x).all()), f"admm_l1 {f}: non-finite output")
        d = (x - xs_dc["fft"]).abs()
        dc_q[f] = {"max_abs_vs_fft": float(d.max()), "mean_abs_vs_fft": float(d.mean()),
                   "psnr_db": psnr[f], "psnr_vs_fft_db": psnr[f] - psnr["fft"]}
        check(abs(psnr[f] - psnr["fft"]) < DC_PSNR_DB, f"admm_l1 {f}: mean PSNR {psnr[f]} vs fft {psnr['fft']}")
        want = {"l1_tail": ITERS, "cnc_tail": 0, "fused_iteration": 0}
        check(res["launches"][f"admm_l1_{f}"] == want, f"admm_l1 {f}: launches {res['launches'][f'admm_l1_{f}']}")
    del xs_dc
    f64 = {}
    for w in (W, W - 1):  # even W: the packed form; odd W: the unpacked one
        y4, m4 = y[:4, :, :w].to(torch.complex128).contiguous(), mask[:, :w].double().contiguous()
        f64[f"{H}x{w}"] = float((solve("matmul", y4, m4, torch.float64) - solve("fft", y4, m4, torch.float64))
                                .abs().max())
    check(max(f64.values()) < DC_F64_ATOL, f"the matmul DC solve in float64 vs the fft solve: {f64}")
    runs = {f: [] for f in forms}
    for f in (*forms, *reversed(forms)):
        runs[f].append(cuda_ms(lambda: solve(f, y, mask), reps=2))
    dc_ms = {f: statistics.mean(v) for f, v in runs.items()}
    res["dc_forms"] = {"quality": dc_q, "f64_vs_fft": f64, "solve_ms": dc_ms, "runs_ms": runs}
    log(f"catalog (c): admm_l1 at {B} x {H} x {W} x {ITERS}, float32 (K1 {ITERS} launches a solve): "
        f"{json.dumps(dc_q)}; float64 at 4 x {H} x W against the fft solve: {json.dumps(f64)}; ms a solve "
        f"(CUDA events, in turns fft, matmul, matmul, fft): {json.dumps(runs)}")

    # (d) resolve_dc_method on the card
    resolved = {f"{n}x{n}": fourier.resolve_dc_method("auto", torch.zeros(1, n, n, dtype=torch.complex64,
                                                                           device=dev)) for n in (256, 2048)}
    check(resolved == {"256x256": "fft", "2048x2048": "fft"}, f"resolve_dc_method('auto') on the card: {resolved}")
    res["resolve_dc_method"] = resolved
    log(f"catalog (d): resolve_dc_method('auto') on the card: {json.dumps(resolved)}")

    # (e) the image readers: the fixtures, then a testset of .png-named BMP and JPEG payloads through the CLI
    fix = os.path.join(ROOT, FIXTURES)
    with np.load(os.path.join(fix, "pixels.npz")) as zf:
        stored = {k: zf[k] for k in zf.files}
    names = sorted({k.split("/")[0] for k in stored})
    for name in names:
        path = os.path.join(fix, name)
        check(np.array_equal(images.imread_gray(path), stored[f"{name}/gray"]), f"fixture {name}: gray pixels differ")
        if f"{name}/rgb" in stored:
            check(np.array_equal(images.imread_uint(path, 3), stored[f"{name}/rgb"]), f"fixture {name}: RGB differs")
    mixed, plain = os.path.join(tdir, "mixed"), os.path.join(tdir, "mixed_png")
    os.makedirs(mixed)
    ph = phantom.mri_phantoms(10, H, seed=24)
    want = {}  # each file's pixels as cv2 reads it: the BMPs' by OpenCV's rule, the JPEGs' stored
    for k in range(10):
        u8 = np.uint8(np.clip(ph[k] * 255.0, 0, 255).round())
        # five colour BMPs (gray by OpenCV's rule) and five gray-palette ones
        rgb = np.stack([u8, np.uint8(u8 * 0.9), np.uint8(u8 * 0.8)], axis=-1).astype(np.int32)
        want[f"{k + 1:02d}.png"] = u8 if k % 2 else np.uint8(
            (1868 * rgb[..., 2] + 9617 * rgb[..., 1] + 4899 * rgb[..., 0] + 8192) >> 14)
        write_bmp(os.path.join(mixed, f"{k + 1:02d}.png"), u8 if k % 2 else rgb.astype(np.uint8))
    jpegs = sorted(n for n in names if n.startswith("testset"))
    check(len(jpegs) == 5, f"the JPEG fixtures of the testset: {jpegs}")
    for k, name in enumerate(jpegs):
        shutil.copyfile(os.path.join(fix, name), os.path.join(mixed, f"{k + 11:02d}.png"))
        want[f"{k + 11:02d}.png"] = stored[f"{name}/gray"]
    t_r = time.perf_counter()
    decoded = {os.path.basename(p): images.imread_gray(p) for p in sorted(glob.glob(os.path.join(mixed, "*.png")))}
    read_s = time.perf_counter() - t_r
    check(decoded.keys() == want.keys() and all(np.array_equal(decoded[n], want[n]) for n in want),
          "the BMP/JPEG testset does not read as cv2 reads it")
    for n, u8 in want.items():
        images.imsave(u8.astype(np.float64), os.path.join(plain, n))
    lines = {}
    for tag, ts in (("mixed", "mixed"), ("png", "mixed_png")):
        argv = ["admm_l1", "--testset", ts, "--testsets_dir", tdir, "--data_dir", ddir,
                "--results_dir", os.path.join(tmp, "catalog_readers", tag)]
        lines[tag] = json.loads(counted(f"cli_admm_l1_{tag}", lambda: _run_main(cli_main.main, argv))[-1])
        check(res["launches"][f"cli_admm_l1_{tag}"] == {"l1_tail": ITERS, "cnc_tail": 0, "fused_iteration": 0},
              f"cli admm_l1 on {ts}: launches {res['launches'][f'cli_admm_l1_{tag}']}")
    check(lines["mixed"]["images"] == 15 and lines["mixed"]["per_image_psnr"] == lines["png"]["per_image_psnr"],
          f"admm_l1 on the BMP/JPEG testset {lines['mixed']['per_image_psnr']} vs its PNG copy "
          f"{lines['png']['per_image_psnr']}")
    logs = {}
    for tag in lines:
        [path] = glob.glob(os.path.join(tmp, "catalog_readers", tag, "*", "*.log"))
        with open(path) as f:
            logs[tag] = [re.match(LOG_LINE, ln).groups() for ln in f.read().splitlines()[:15]]
    check(logs["mixed"] == logs["png"], "the .log's PSNR lines differ between the BMP/JPEG testset and its PNGs")
    res["readers"] = {"fixtures": len(names), "testset_read_s": read_s, "psnr_db": lines["mixed"]["psnr"],
                      "wall_s": lines["mixed"]["wall_s"]}
    log(f"catalog (e): {len(names)} fixtures decode to their stored cv2 pixels; a 15-image testset of .png-named "
        f"BMP (10) and JPEG (5) payloads read in {read_s:.3f} s as cv2 reads them and solved by cli.main admm_l1 "
        f"on the card: PSNR lines equal to those of its cv2 pixels as PNG ({lines['mixed']['psnr']:.4f} dB)")
    return res


# -- examples: the port's six example programs at their published sizes ------
EXAMPLES = ("bm3d_grayscale", "bm3d_rgb", "bm3d_multichannel", "bm3d_deblurring", "mri_reconstruction",
            "super_resolution")
EXAMPLE_PHANTOM_SEED = 11
# The examples run at their published arguments, their defaults (MRI: ITERS
# iterations). The two CNN examples' float64 CPU run is cut to a 64 x 64
# phantom (MRI also to 4 iterations): the CPU's float64 DRUNet forward at 256
# x 256 takes ~4.4 s, and MRI's published run makes 100 of them.
EXAMPLE_CPU_CUT = {"mri_reconstruction": ["--iters", "4"], "super_resolution": []}
EXAMPLE_DEVICE_DB = 1e-6  # float64 on the card against float64 on the CPU, each PSNR
# Float32 against float64 (the card's float64, and the CPU's at the cut), and
# the card against the JAX package's float32 run: the lines no CNN reaches
# within 1e-3 dB (measured at most 5.2e-5, PERF.md); the DRUNet lines within
# 0.25 dB: the train phase's 200-step network brings no PnP line above 7 dB,
# and on such outputs float32 against float64 measured 8.4e-3 (MRI) and
# 1.7e-2 dB (SR) at the published arguments, 4.4e-2 dB at SR's CPU cut.
EXAMPLE_F32_DB = 1e-3
EXAMPLE_CNN_F32_DB = 0.25
CNN_LINES = ("PnP-drunet_gray", "FISTA-drunet_gray", "PnP")  # the MRI and SR lines DRUNet reaches
# The JAX examples' PSNRs (dB, unrounded) on these inputs, float32 on the CPU
# (python3 probes/examples_jax_psnr.py): the lines that no CNN weights reach.
JAX_EXAMPLE_PSNR = {
    "bm3d_grayscale": {"noisy": 16.22137347865354, "denoised": 35.551093421771924},
    "bm3d_rgb": {"noisy": 19.987949753442447, "denoised": 32.171210586487206},
    "bm3d_multichannel": {"noisy": 15.127188779716555, "denoised": 32.869073458028},
    "bm3d_deblurring": {"blurred+noisy": 26.8308127963121, "deblurred": 31.687599735510364},
    "mri_reconstruction": {"zero-fill": 20.838123321533203, "ADMM-L1": 24.29286003112793,
                           "ADMM-CNC": 24.625234603881836, "FISTA-L1": 24.568586349487305},
    "super_resolution": {"zero-fill": 31.22062873840332},
}


def write_example_assets(root: str) -> dict:
    """The examples' inputs under ``root``: the testset ``set1/05.png`` (a
    256 x 256 phantom, which the MRI and SR examples read by default), the
    same phantom at 64 x 64, a synthetic BM3D parameter database (the
    reference's ``param_matching_data.mat`` is not in the repository: the
    20 x 60 features and parameter indices 1..21 of the CPU tests, from
    ``default_rng(3)``), and an empty data directory (no masks, noise or
    BM3D example images: the examples draw their own). Returns the paths."""
    import numpy as np
    import scipy.io as sio

    from pnp_admm_cnc_mri_torch.data import images, phantom

    paths = {"testsets": os.path.join(root, "testsets"), "small": os.path.join(root, "phantom64.png"),
             "db": os.path.join(root, "param_matching_data.mat"), "data": os.path.join(root, "data")}
    images.imsave(phantom.mri_phantoms(1, H, seed=EXAMPLE_PHANTOM_SEED)[0] * 255.0,
                  os.path.join(paths["testsets"], "set1", "05.png"))
    images.imsave(phantom.mri_phantoms(1, 64, seed=EXAMPLE_PHANTOM_SEED)[0] * 255.0, paths["small"])
    rng = np.random.default_rng(3)
    sio.savemat(paths["db"], {"features": rng.random((20, 60)) * 10.0,
                              "maxes": rng.integers(1, 22, size=(60, 4)).astype(np.float64)})
    os.makedirs(paths["data"], exist_ok=True)
    return paths


@contextlib.contextmanager
def example_defaults(paths: dict, zoo: str):
    """The port's default asset paths pointed at ``paths`` and the model zoo
    at ``zoo`` inside the block."""
    from pnp_admm_cnc_mri_torch.data import images, masks, noise
    from pnp_admm_cnc_mri_torch.priors import denoiser
    from pnp_admm_cnc_mri_torch.priors.bm3d import psd_params

    targets = [(images, "DEFAULT_TESTSETS", paths["testsets"]), (masks, "DEFAULT_DATA_DIR", paths["data"]),
               (noise, "DEFAULT_DATA_DIR", paths["data"]), (psd_params, "DEFAULT_DB", paths["db"]),
               (denoiser, "DEFAULT_MODEL_ZOO", zoo)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for mod, attr, value in targets:
        setattr(mod, attr, value)
    try:
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def run_example(name: str, argv: list) -> tuple:
    """An example's ``main(argv)`` in this process: (its PSNRs, its stdout lines)."""
    import importlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = importlib.import_module(f"pnp_admm_cnc_mri_torch.examples.{name}").main(argv)
    return out, buf.getvalue().strip().splitlines()


def _gap(a: dict, b: dict, cnn: bool = False):
    """The largest PSNR difference over the lines DRUNet reaches (``cnn``)
    or over the others; None where there is no such line."""
    check(list(a) == list(b), f"the PSNR lines differ: {list(a)} against {list(b)}")
    return max((abs(a[k] - b[k]) for k in a if (k in CNN_LINES) == cnn), default=None)


def phase_examples(tmp: str) -> dict:
    """The six examples of ``pnp_admm_cnc_mri_torch/examples`` through their
    ``main`` at their published arguments, on the card, float32: each
    counted (K1-K3 at 0 just before, read just after) and timed twice; held
    against its ``--f64`` run on the card, and the lines no CNN weights
    reach against the JAX package's run; the BM3D demos' float32 and
    float64 card runs against ``--cpu --f64`` at the same arguments, the CNN
    examples' at the CPU cut. DRUNet (``drunet_gray``, the MRI and SR
    examples' default) is the train phase's 200-step network. Then one cold
    ``python -m`` process of ``bm3d_multichannel``, equal to the in-process
    run. Returns the PSNRs, gaps, times and launch counts."""
    import numpy as np
    import torch

    root = os.path.join(tmp, "examples")
    paths = write_example_assets(root)
    zoo = os.path.join(root, "zoo")
    os.makedirs(zoo)
    trained = os.path.join(tmp, "train", "drunet.npz")
    check(os.path.exists(trained), f"examples: the train phase's DRUNet {trained} is missing")
    shutil.copy(trained, os.path.join(zoo, "drunet_gray.npz"))
    res: dict = {"launches": {}, "psnr": {}, "gaps": {}, "wall_s": {}}
    printed_lines = {}
    with example_defaults(paths, zoo):
        for name in EXAMPLES:
            dist_reset()
            t0 = time.perf_counter()
            out, lines = run_example(name, [])
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            res["launches"][name] = dist_counts()
            t0 = time.perf_counter()
            run_example(name, [])
            torch.cuda.synchronize()
            res["wall_s"][name] = {"first": first_s, "warm": time.perf_counter() - t0}
            want = {"l1_tail": 0, "cnc_tail": 0, "fused_iteration": 0}
            if name == "mri_reconstruction":
                want.update(l1_tail=ITERS, cnc_tail=ITERS)
            check(res["launches"][name] == want, f"{name}: launches {res['launches'][name]}, expected {want}")
            printed = [float(v) for v in re.findall(r"(-?\d+\.\d\d) dB", "\n".join(lines))]
            check(len(printed) == len(out) and all(np.isfinite(v) and abs(p - v) <= 0.005 + 1e-9
                                                   for p, v in zip(printed, out.values())), f"{name}: {lines}")
            if name.startswith("bm3d"):
                src, dst = list(out.values())
                check(dst > src, f"{name}: the output's PSNR {dst} is not above the input's {src}")
                cut = []
            else:
                cut = ["--image", paths["small"], *EXAMPLE_CPU_CUT[name]]
            if name == "mri_reconstruction":
                for k in ("ADMM-L1", "ADMM-CNC", "FISTA-L1"):
                    check(out[k] > out["zero-fill"], f"{name}: {k} {out[k]} not above zero-fill {out['zero-fill']}")
                check(len(out) == 6, f"{name}: the PnP stage did not run: {lines}")
            out64, _ = run_example(name, ["--f64"])
            cpu64, _ = run_example(name, cut + ["--cpu", "--f64"])
            cut32, cut64 = (out, out64) if not cut else (run_example(name, cut)[0],
                                                         run_example(name, cut + ["--f64"])[0])
            jax_ref = JAX_EXAMPLE_PSNR.get(name, {})
            gaps = res["gaps"][name] = {
                "f32_vs_f64": _gap(out, out64), "cut_f32_vs_cpu_f64": _gap(cut32, cpu64),
                "cnn_f32_vs_f64": _gap(out, out64, True), "cnn_cut_f32_vs_cpu_f64": _gap(cut32, cpu64, True),
                "cut_f64_vs_cpu_f64": max(_gap(cut64, cpu64), _gap(cut64, cpu64, True) or 0.0),
                "vs_jax": max((abs(out[k] - v) for k, v in jax_ref.items()), default=None)}
            res["psnr"][name], printed_lines[name] = out, lines
            log(f"examples {name} (defaults): " + " | ".join(lines)
                + f"; PSNRs {json.dumps(out)}; float32 vs float64 and the JAX package's (dB): {json.dumps(gaps)}; "
                f"launches {json.dumps(res['launches'][name])}; wall s {json.dumps(res['wall_s'][name])}")
            check(gaps["f32_vs_f64"] <= EXAMPLE_F32_DB and gaps["cut_f32_vs_cpu_f64"] <= EXAMPLE_F32_DB
                  and all(gaps[k] is None or gaps[k] <= EXAMPLE_CNN_F32_DB
                          for k in ("cnn_f32_vs_f64", "cnn_cut_f32_vs_cpu_f64")),
                  f"{name}: float32 against float64 {gaps}")
            check(gaps["cut_f64_vs_cpu_f64"] <= EXAMPLE_DEVICE_DB,
                  f"{name}: the card's float64 against the CPU's {gaps}")
            check(gaps["vs_jax"] is None or gaps["vs_jax"] <= EXAMPLE_F32_DB, f"{name}: against JAX {gaps}")

    # a cold process of an example's module entry, from outside the repository
    env = dict(os.environ, PYTHONPATH=ROOT, PNPADMM_DATA=paths["data"])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pnp_admm_cnc_mri_torch.examples.bm3d_multichannel"],
                          capture_output=True, text=True, timeout=300, cwd=root, env=env)
    res["wall_s"]["cold_process_bm3d_multichannel"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m ...examples.bm3d_multichannel failed: {proc.stderr[-2000:]}")
    check(proc.stdout.strip().splitlines() == printed_lines["bm3d_multichannel"],
          f"the cold process printed {proc.stdout!r}, in process {printed_lines['bm3d_multichannel']}")
    log(f"examples: python -m pnp_admm_cnc_mri_torch.examples.bm3d_multichannel as a cold process: "
        f"{res['wall_s']['cold_process_bm3d_multichannel']:.1f} s, its lines equal to the in-process run's")
    return res


# -- distributed: the multi-device path (parallel/, the sharded sweep, multihost, the dp x tp trainer) --
DIST_TIMEOUT_S = 300.0  # every process group's and every spawned world's limit: a hung rank fails the run
DIST_DEPTH = 4  # the CNN consensus solves' iterations (the cli phase's cut)
DIST_SPATIAL_B = 4
DIST_MULTIHOST_SCENARIOS = 512
DIST_TRAIN_STEPS, DIST_TRAIN_BATCH, DIST_TRAIN_PATCH = 3, 16, 64
DIST_F64_ATOL = 1e-9
# consensus-ADMM at its tuned 50 iterations multiplies a perturbation ~1.4x an iteration: a
# 1e-15 relative nudge of y moves z by 6.2e-9 in one process (CPU, float64), so the sums over
# ranks in another order moved it by 6.19e-8 at world 2 (probes/dist_phase_probe.py, measured on
# one NVIDIA H100 80GB HBM3, 700.00 W); the 50-iteration
# solve is held within this limit, and a 10-iteration one (nudge 1e-14) within DIST_F64_ATOL
DIST_CONSENSUS_ATOL = 1e-6
DIST_SHORT_ITERS = 10
# float32 at worlds 2 and 4 against one device (the sums over ranks run in another order): the
# DRUNet consensus solves within PNP_ATOL (the float32-vs-float64 limit of 4 such iterations;
# read: FISTA 4.1e-7 and 3.6e-7, HQS 0), the sweep's rows within the card-vs-CPU limits
# (SWEEP_PSNR_DB, SWEEP_RES_*; read: 0, the rows bit-equal), the trainer's losses within
# DIST_LOSS_RTOL and its parameters' change within DIST_STEP_RTOL of one device's (the norm of the
# difference over the norm, as precision_readings reads it; the larger of the two read 2.89e-3 at
# data 2 x space 2, below float32-vs-float64's 8.2e-3 to 1.02e-2). Readings: probes/dist_phase_probe.py,
# measured on one NVIDIA H100 80GB HBM3, 700.00 W.
DIST_LOSS_RTOL = 1e-4
DIST_STEP_RTOL = 1e-2


@contextlib.contextmanager
def timed_collectives(events: list):
    """Record CUDA events around every collective of ``parallel/mesh.py``
    (``all_reduce``, ``all_gather``, ``all_to_all``) into ``events``."""
    import torch

    from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib

    names = ("all_reduce", "all_gather", "all_to_all")
    orig = {n: getattr(mesh_lib, n) for n in names}

    def timed(fn):
        def call(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events.append((start, end))
            return out
        return call

    for n in names:
        setattr(mesh_lib, n, timed(orig[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(mesh_lib, n, orig[n])


def dist_consensus_setup(dev):
    """(FISTA's prox, HQS's denoiser, HQS's ladder): seeded full-width DRUNet at
    TUNED_CONSENSUS_FISTA / _HQS["drunet_gray"], cut to DIST_DEPTH iterations."""
    import warnings

    import torch

    from pnp_admm_cnc_mri_torch.config import TUNED_CONSENSUS_FISTA, TUNED_CONSENSUS_HQS
    from pnp_admm_cnc_mri_torch.priors import denoiser

    tf, th = TUNED_CONSENSUS_FISTA["drunet_gray"], TUNED_CONSENSUS_HQS["drunet_gray"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded random init warns
        d_f = denoiser.build_denoiser("drunet_gray", iter_num=DIST_DEPTH, noise_level_model=tf["nlm"] / 255.0,
                                      model_sigma1=tf["model_sigma1"], x8=tf["x8"], device=dev)
        d_h = denoiser.build_denoiser("drunet_gray", iter_num=DIST_DEPTH, noise_level_model=th["nlm"] / 255.0,
                                      x8=th["x8"], device=dev)
    prox_f = lambda i, u: torch.clamp(d_f(u, i), 0.0, 1.0)  # noqa: E731
    return prox_f, d_h, dict(sigma255=th["sigma255"], model_sigma1=49.0, model_sigma2=th["nlm"])


def dist_counts():
    from pnp_admm_cnc_mri_torch.ops import fused_dc, tail_kernels

    return {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
            "fused_iteration": fused_dc.fused_iteration.launches}


def dist_reset():
    import torch

    from pnp_admm_cnc_mri_torch.ops import fused_dc, tail_kernels

    torch.cuda.synchronize()
    tail_kernels.reset_launches()
    fused_dc.reset_launches()


def _mesh_of(name: str, mesh):
    """The mesh of an entry named ``<kind>_<n_data>x<n_space>``: ``mesh``
    itself where the shape matches, else a new one (every rank makes it)."""
    from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib

    n_data, n_space = map(int, name.rsplit("_", 1)[1].split("x"))
    if (n_data, n_space) == (mesh.shape["data"], mesh.shape["space"]):
        return mesh
    return mesh_lib.make_mesh(n_data, n_space, device=mesh.device)


def dist_entries(mesh, inp: dict, tmp: str, tdir: str, ddir: str, which: tuple) -> dict:
    """Run the entry points ``which`` (every rank of ``mesh``'s world calls
    this with the same ``which``): {name: (result on the host, K1-K3
    launches, times)}. The times: host seconds to the card's end, CUDA-event
    ms, and the CUDA-event ms inside the collectives of ``parallel/mesh.py``."""
    import io

    import torch

    from pnp_admm_cnc_mri_torch import ADMM_L1_DEFAULT
    from pnp_admm_cnc_mri_torch.cli import sweep
    from pnp_admm_cnc_mri_torch.data import images, masks, noise
    from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
    from pnp_admm_cnc_mri_torch.parallel import consensus, spatial
    from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib
    from pnp_admm_cnc_mri_torch.train import trainer

    images.DEFAULT_TESTSETS = tdir
    masks.DEFAULT_DATA_DIR = noise.DEFAULT_DATA_DIR = ddir
    out = {}

    def run(name, fn):
        dist_reset()
        events = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        with timed_collectives(events):
            start.record()
            r = fn()
            end.record()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        ms, coll = start.elapsed_time(end), sum(a.elapsed_time(b) for a, b in events)
        out[name] = (r, dist_counts(), {"s": secs, "ms": ms, "collective_ms": coll, "collectives": len(events),
                                        "share": coll / ms})

    for name in which:
        if name == "consensus":
            prox_f, d_h, ladder = dist_consensus_setup(mesh.device)
            run("consensus_admm", lambda: consensus.run_consensus_sharded(
                inp["ys64"], inp["masks4"], ADMM_L1_DEFAULT, mesh, dtype=torch.float64).cpu())
            run("consensus_admm_short", lambda: consensus.run_consensus_sharded(
                inp["ys64"], inp["masks4"], dataclasses.replace(ADMM_L1_DEFAULT, iter_num=DIST_SHORT_ITERS), mesh,
                dtype=torch.float64).cpu())
            run("consensus_fista", lambda: consensus.run_consensus_fista_sharded(
                inp["ys32"], inp["masks4"], DIST_DEPTH, prox_f, mesh).cpu())
            run("consensus_hqs", lambda: consensus.run_consensus_hqs_sharded(
                inp["ys32"], inp["masks4"], DIST_DEPTH, d_h, mesh, **ladder).cpu())
        elif name.startswith("spatial"):
            m = _mesh_of(name, mesh)

            def solve(m=m):
                x = spatial.spatial_admm_l1(mesh_lib.shard_batch(inp["y_sp"], m), inp["mask"], ADMM_L1_DEFAULT, m,
                                            dtype=torch.float64)
                return mesh_lib.gather_batch(x, m).cpu()

            run(name, solve)
        elif name.startswith("sweep"):
            algo = name[len("sweep_"):]

            def solve_grid(algo=algo):
                buf, split = io.StringIO(), {}
                with contextlib.redirect_stdout(buf):
                    check(sweep.main(["--algo", algo, "--testset", "phantoms", "--sigmas",
                                      ",".join(map(str, SIGMAS)), "--out",
                                      os.path.join(tmp, f"dist_sweep_{algo}_w{mesh.shape['data']}.jsonl")],
                                     timings=split) == 0, f"sweep {algo} returned non-zero")
                lines = buf.getvalue().strip().splitlines()
                return {"summary": json.loads(lines[-1]) if lines else None, "split": split}

            run(name, solve_grid)
        elif name.startswith("train"):
            m = _mesh_of(name, mesh)

            def train(m=m):
                state, losses = trainer.train_denoiser(
                    UNetRes(2, 1), inp["patches"], (0.0, 50 / 255), steps=DIST_TRAIN_STEPS,
                    batch_size=DIST_TRAIN_BATCH, conditioned=True, mesh=m, log_every=1)
                return {"state": {k: v.cpu() for k, v in state.items()}, "losses": losses}

            run(name, train)
        else:
            raise ValueError(f"unknown entry {name!r}")
    return out


def dist_rank(tmp: str, tdir: str, ddir: str, which: tuple) -> None:
    """One rank of a spawned gloo world on cuda:0: the entry points ``which``
    on the world's mesh (all ranks on ``data``; the spatial and train
    entries name their own); writes ``dist_w<world>_rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    inp = torch.load(os.path.join(tmp, "dist_inputs.pt"), weights_only=False)
    out = dist_entries(mesh_lib.make_mesh(device=dev), inp, tmp, tdir, ddir, which)
    for k in [k for k in out if k.startswith("train") and dist.get_rank()]:
        out[k] = ({"losses": out[k][0]["losses"]}, *out[k][1:])  # the gathered parameters: rank 0's suffice
    torch.save(out, os.path.join(tmp, f"dist_w{dist.get_world_size()}_rank{dist.get_rank()}.pt"))


def phase_distributed(dev, tmp: str, tdir: str, ddir: str, img_np, sweep_res: dict) -> dict:
    """The multi-device path at world 1 on NCCL, then at worlds 2 and 4 over
    gloo on this card, each entry point held to its one-device run."""
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from pnp_admm_cnc_mri_torch import ADMM_CNC_DEFAULT, ADMM_L1_DEFAULT
    from pnp_admm_cnc_mri_torch.cli import multihost
    from pnp_admm_cnc_mri_torch.data import images, masks, noise
    from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
    from pnp_admm_cnc_mri_torch.ops import tail_kernels
    from pnp_admm_cnc_mri_torch.parallel import consensus
    from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib
    from pnp_admm_cnc_mri_torch.solvers import admm
    from pnp_admm_cnc_mri_torch.train import data as data_mod, trainer

    res = {"errors": {}, "launches": {}, "times": {}, "summaries": {}, "train_readings": {}}
    # inputs: one phantom through the experiments phase's three masks and random_mask(0.3, seed 3)
    # with the main noise; 4 phantoms through the first mask for the spatial solve; the trainer's
    # 64 x 64 patches of 16 phantoms
    masks4 = np.stack([masks.random_mask((H, W), fraction=0.3, seed=1), masks.radial_mask((H, W)),
                       masks.cartesian_mask((H, W), fraction=0.3, seed=1),
                       masks.random_mask((H, W), fraction=0.3, seed=3)]).astype(np.float64)
    nz = noise.synth_noise((H, W), std=3.0, seed=2)
    ys = np.fft.fft2(img_np[0].astype(np.float64)) * masks4 + nz
    inp = {"ys64": torch.from_numpy(ys), "ys32": torch.from_numpy(ys.astype(np.complex64)),
           "masks4": torch.from_numpy(masks4),
           "y_sp": torch.from_numpy(np.fft.fft2(img_np[:DIST_SPATIAL_B].astype(np.float64)) * masks4[0] + nz),
           "mask": torch.from_numpy(masks4[0]),
           "patches": data_mod.extract_patches(list(img_np[:16]), patch=DIST_TRAIN_PATCH, stride=DIST_TRAIN_PATCH)}
    torch.save(inp, os.path.join(tmp, "dist_inputs.pt"))

    # -- the one-device runs ---------------------------------------------------------
    prox_f, d_h, ladder = dist_consensus_setup(dev)
    ys32, m4 = inp["ys32"].to(dev), inp["masks4"].to(dev)
    short = dataclasses.replace(ADMM_L1_DEFAULT, iter_num=DIST_SHORT_ITERS)
    ref = {
        "consensus_admm": consensus.run_consensus(inp["ys64"], inp["masks4"], ADMM_L1_DEFAULT, dtype=torch.float64,
                                                  device=dev)[0].cpu(),
        "consensus_admm_short": consensus.run_consensus(inp["ys64"], inp["masks4"], short, dtype=torch.float64,
                                                        device=dev)[0].cpu(),
        "consensus_fista": consensus.run_consensus_fista(ys32, m4, DIST_DEPTH, prox_f).cpu(),
        "consensus_hqs": consensus.run_consensus_hqs(ys32, m4, DIST_DEPTH, d_h, **ladder).cpu(),
        "spatial": admm.admm_l1(inp["y_sp"], inp["mask"], ADMM_L1_DEFAULT, dtype=torch.float64,
                                use_rfft=False, device=dev)[0].x.cpu(),
    }
    nudged = {it: consensus.run_consensus(inp["ys64"] * (1 + 1e-15), inp["masks4"], cfg, dtype=torch.float64,
                                          device=dev)[0].cpu() for it, cfg in ((ITERS, ADMM_L1_DEFAULT),
                                                                               (DIST_SHORT_ITERS, short))}
    res["consensus_admm_nudge_1e-15"] = {
        it: float((nudged[it] - ref["consensus_admm" if it == ITERS else "consensus_admm_short"]).abs().max())
        for it in nudged}
    del ys32, m4, nudged
    train_kw = dict(batch_size=DIST_TRAIN_BATCH, conditioned=True, device=dev)
    start = {k: v.cpu().double() for k, v in trainer.train_denoiser(UNetRes(2, 1), inp["patches"], (0.0, 50 / 255),
                                                                     steps=0, **train_kw)[0].items()}
    st, ls = trainer.train_denoiser(UNetRes(2, 1), inp["patches"], (0.0, 50 / 255), steps=DIST_TRAIN_STEPS,
                                    log_every=1, **train_kw)
    ref["train"] = {"state": {k: v.cpu() for k, v in st.items()}, "losses": ls}
    del st
    sweep_rows = {}
    for algo in ("admm_l1", "admm_cnc"):
        with open(os.path.join(tmp, f"sweep_{algo}.jsonl")) as f:
            sweep_rows[algo] = [json.loads(ln) for ln in f]

    def change_rel(state) -> float:
        """The norm of the difference of the parameters' change from one
        device's, over the norm of one device's change."""
        d0 = {k: ref["train"]["state"][k].double() - start[k] for k in start}
        norm = lambda d: math.sqrt(sum(float((v * v).sum()) for v in d.values()))  # noqa: E731
        return norm({k: state[k].double() - start[k] - d0[k] for k in d0}) / norm(d0)

    fails = []

    def want(cond: bool, msg: str) -> None:
        if not cond:
            fails.append(msg)

    def held(name, got, world) -> float:
        """Entry ``name``'s result at ``world`` against its one-device run
        (a miss goes to ``fails``, reported with every error at the end); its error."""
        if name.startswith("spatial"):
            err = float((got - ref["spatial"]).abs().max())
            want(got.shape == ref["spatial"].shape and err < DIST_F64_ATOL,
                 f"{name} at world {world} vs admm_l1 in float64: {err}")
            return err
        if name.startswith("consensus"):
            err = float((got.double() - ref[name].double()).abs().max())
            lim = 0.0 if world == 1 else {"consensus_admm": DIST_CONSENSUS_ATOL,
                                          "consensus_admm_short": DIST_F64_ATOL}.get(name, PNP_ATOL)
            want(got.shape == (H, W) and err <= lim, f"{name} at world {world} vs one device: {err} (limit {lim})")
            return err
        if name.startswith("sweep"):
            algo = name[len("sweep_"):]
            with open(os.path.join(tmp, f"dist_sweep_{algo}_w{world}.jsonl")) as f:
                rows = [json.loads(ln) for ln in f]
            want_rows = sweep_rows[algo]
            want([r_["scenario"] for r_ in rows] == [r_["scenario"] for r_ in want_rows],
                 f"{name} at world {world}: {len(rows)} rows, not the one-device run's labels in order")
            dp = max(abs(a["psnr"] - b["psnr"]) for a, b in zip(rows, want_rows))
            dr = max(abs(a["residual"] - b["residual"]) for a, b in zip(rows, want_rows))
            ok = all(abs(a["residual"] - b["residual"]) <= SWEEP_RES_ATOL + SWEEP_RES_RTOL * abs(b["residual"])
                     for a, b in zip(rows, want_rows))
            want(dp < SWEEP_PSNR_DB and ok and (world > 1 or dp == dr == 0.0),
                 f"{name} at world {world} vs one device: PSNR {dp} dB, residual {dr}")
            summ = got["summary"]
            want(summ is not None and summ["devices"] == world and summ["scenarios"] == len(want_rows)
                 and (world > 1 or summ["converged_fraction"] == sweep_res["summary"][algo]["converged_fraction"]),
                 f"{name} at world {world}: summary {summ}")
            res["summaries"][f"{name}_w{world}"] = summ
            return dp
        steps_, losses = [i for i, _ in got["losses"]], [v for _, v in got["losses"]]
        want_l = [v for _, v in ref["train"]["losses"]]
        want(steps_ == [i for i, _ in ref["train"]["losses"]], f"{name}: logged steps {steps_}")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_l))
        rel = change_rel(got["state"]) if "state" in got else 0.0
        res["train_readings"][f"w{world}"] = {"loss_rel": max(loss_err, res["train_readings"].get(
            f"w{world}", {}).get("loss_rel", 0.0)), "change_rel": max(rel, res["train_readings"].get(
            f"w{world}", {}).get("change_rel", 0.0))}
        if world == 1:
            want(losses == want_l and all(torch.equal(got["state"][k], ref["train"]["state"][k]) for k in start),
                 f"{name} at world 1 differs from one device: losses {losses} vs {want_l}, change {rel}")
        want(loss_err < DIST_LOSS_RTOL and rel < DIST_STEP_RTOL,
             f"{name} at world {world}: losses {loss_err} (limit {DIST_LOSS_RTOL}), parameters' change {rel} "
             f"(limit {DIST_STEP_RTOL})")
        return max(loss_err, rel)

    def record(world, out, rank=0):
        for k, (got, launches, times) in out.items():
            if not (rank and k.startswith("sweep")):  # rank 0 alone writes the rows and the summary
                errs = res["errors"].setdefault(f"w{world}", {})
                errs[k] = max(errs.get(k, 0.0), held(k, got, world))
            res["launches"].setdefault(f"w{world}", {}).setdefault(k, []).append(launches)
            res["times"].setdefault(f"w{world}", {}).setdefault(k, []).append(times)

    # -- world 1: NCCL, this process -------------------------------------------------
    mesh_lib.init_process_group(dev, f"file://{tmp}/dist_store_w1", 0, 1, DIST_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_mesh(device=dev)
        check(mesh.distributed and dist.get_backend() == "nccl", "world 1 is not an NCCL group")
        record(1, dist_entries(mesh, inp, tmp, tdir, ddir,
                               ("consensus", "spatial_1x1", "sweep_admm_l1", "sweep_admm_cnc", "train_1x1")))
        # multihost.worker in this process at its defaults, scaled to 512 scenarios
        args = multihost._parser().parse_args(["--testset", "phantoms", "--scenarios_per_device",
                                               str(DIST_MULTIHOST_SCENARIOS)])
        buf, events = io.StringIO(), []
        dist_reset()
        with timed_collectives(events), contextlib.redirect_stdout(buf):
            rc, mh_ms = event_ms(lambda: multihost.worker(args))
        check(rc == 0, "multihost.worker returned non-zero")
        res["launches"]["w1"]["multihost"] = [dist_counts()]
        coll = sum(a.elapsed_time(b) for a, b in events)
        res["times"]["w1"]["multihost"] = [{"ms": mh_ms, "collective_ms": coll, "collectives": len(events),
                                            "share": coll / mh_ms}]
        mh = res["summaries"]["multihost_w1"] = json.loads(buf.getvalue().strip().splitlines()[-1])
    finally:
        dist.destroy_process_group()
    imgs01, _, _ = images.load_testset(os.path.join(tdir, "phantoms"))
    mask_q = masks.load_mask("Q_Random30")
    idx = np.arange(DIST_MULTIHOST_SCENARIOS) % imgs01.shape[0]
    y_mh = (np.fft.fft2(imgs01[idx], axes=(-2, -1)) * mask_q + noise.load_noise()).astype(np.complex64)
    fin, r_mh = admm.admm_l1(y_mh, mask_q.astype(np.float32), dataclasses.replace(ADMM_L1_DEFAULT,
                                                                                  iter_num=args.iter_num),
                             collect_residuals=True)
    rel = r_mh[-1] / (torch.sqrt(torch.sum(fin.x**2, dim=(-2, -1))) + 1e-12)
    check(mh["mean_rel_residual"] == float(torch.mean(rel)) and mh["max_rel_residual"] == float(torch.max(rel))
          and mh["global_devices"] == 1 and mh["scenarios"] == DIST_MULTIHOST_SCENARIOS,
          f"multihost at world 1 vs one device: {mh} vs mean {float(torch.mean(rel))} max {float(torch.max(rel))}")
    del y_mh, fin, r_mh, rel
    w1 = {k: v[0] for k, v in res["launches"]["w1"].items()}
    k1_want = {"consensus_admm": 0, "consensus_admm_short": 0, "consensus_fista": 0, "consensus_hqs": 0,
               "train_1x1": 0, "spatial_1x1": ITERS, "sweep_admm_l1": ITERS, "multihost": 2 * args.iter_num}
    check(set(w1) == set(k1_want) | {"sweep_admm_cnc"} and all(w1[k]["l1_tail"] == n for k, n in k1_want.items())
          and w1["sweep_admm_cnc"]["cnc_tail"] == ITERS and sum(v["cnc_tail"] for v in w1.values()) == ITERS
          and all(v["fused_iteration"] == 0 for v in w1.values()), f"world 1 launches {json.dumps(w1)}")
    log(f"distributed: world 1 (NCCL, this process) against one device: errors {json.dumps(res['errors']['w1'])} "
        f"(0 is bit for bit; the spatial solve's FFT runs as two 1-D passes); K1-K3 launches {json.dumps(w1)}")

    # the one-device runs again, warm, timed beside the world-1 entry points (CUDA events, ms)
    ys32, m4 = inp["ys32"].to(dev), inp["masks4"].to(dev)
    res["one_device_ms"] = {name: event_ms(fn)[1] for name, fn in {
        "consensus_admm": lambda: consensus.run_consensus(inp["ys64"], inp["masks4"], ADMM_L1_DEFAULT,
                                                          dtype=torch.float64, device=dev),
        "consensus_fista": lambda: consensus.run_consensus_fista(ys32, m4, DIST_DEPTH, prox_f),
        "consensus_hqs": lambda: consensus.run_consensus_hqs(ys32, m4, DIST_DEPTH, d_h, **ladder),
        "spatial (admm_l1, use_rfft=False)": lambda: admm.admm_l1(inp["y_sp"], inp["mask"], ADMM_L1_DEFAULT,
                                                                  dtype=torch.float64, use_rfft=False, device=dev),
        "train": lambda: trainer.train_denoiser(UNetRes(2, 1), inp["patches"], (0.0, 50 / 255),
                                                steps=DIST_TRAIN_STEPS, log_every=1, **train_kw),
    }.items()}
    del ys32, m4

    # -- worlds 2 and 4: gloo, every rank on this card -----------------------------------
    torch.cuda.empty_cache()
    res["spawned_s"] = {}
    for world, which in ((2, ("consensus", "spatial_1x2", "sweep_admm_l1", "sweep_admm_cnc")),
                         (4, ("consensus", "spatial_1x4", "spatial_2x2", "train_2x2"))):
        t = time.perf_counter()
        mesh_lib.launch_local(dist_rank, world, (tmp, tdir, ddir, which), timeout_s=DIST_TIMEOUT_S)
        res["spawned_s"][world] = time.perf_counter() - t
        for r in range(world):
            record(world, torch.load(os.path.join(tmp, f"dist_w{world}_rank{r}.pt"), weights_only=False), r)
    for world, name, k1 in ((2, "spatial_1x2", ITERS), (2, "sweep_admm_l1", ITERS), (4, "spatial_1x4", ITERS),
                            (4, "spatial_2x2", ITERS)):
        got = [c["l1_tail"] for c in res["launches"][f"w{world}"][name]]
        check(got == [k1] * world, f"{name} at world {world}: K1 {got}")
    check(res["launches"]["w2"]["sweep_admm_cnc"] == [{"l1_tail": 0, "cnc_tail": ITERS, "fused_iteration": 0}] * 2,
          f"sweep_admm_cnc at world 2: {res['launches']['w2']['sweep_admm_cnc']}")
    # K1 and K2 against their plain versions at the shard shapes
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    half = B * len(SIGMAS) * 3 // 2
    shard_shapes = [("l1_tail", (DIST_SPATIAL_B, H // 2, W), torch.float64),
                    ("l1_tail", (DIST_SPATIAL_B, H // 4, W), torch.float64),
                    ("l1_tail", (DIST_SPATIAL_B // 2, H // 2, W), torch.float64),
                    ("l1_tail", (half, H, W), torch.float32), ("cnc_tail", (half, H, W), torch.float32)]
    c = ADMM_L1_DEFAULT.rho * ADMM_L1_DEFAULT.lam
    cnc = (ADMM_CNC_DEFAULT.alpha, ADMM_CNC_DEFAULT.rho, ADMM_CNC_DEFAULT.lam, ADMM_CNC_DEFAULT.b)
    res["kernels_at_shards"] = {}
    for name, shape, dt in shard_shapes:
        ops = [torch.randn(shape, generator=gen, device=dev, dtype=dt) for _ in range(3)]
        args_k = (*ops, c) if name == "l1_tail" else (*ops, *cnc)
        res["kernels_at_shards"][f"{name} {'x'.join(map(str, shape))} {str(dt)[6:]}"] = same(
            getattr(tail_kernels, name)(*args_k), getattr(tail_kernels, name + "_plain")(*args_k),
            f"{name} at {shape}")
        del ops, args_k
    torch.cuda.empty_cache()
    log(f"distributed: worlds 2 and 4 over gloo, all ranks on this card, held to one device: errors "
        f"{json.dumps(res['errors'])} (float64 limit {DIST_F64_ATOL}; DRUNet consensus {PNP_ATOL}; the sweep's "
        f"PSNR {SWEEP_PSNR_DB} dB and residual {SWEEP_RES_ATOL} + {SWEEP_RES_RTOL} |r|; the trainer's losses "
        f"{DIST_LOSS_RTOL} relative and parameters' change {DIST_STEP_RTOL}; consensus-ADMM at {ITERS} "
        f"iterations {DIST_CONSENSUS_ATOL}, where one device moves by "
        f"{json.dumps(res['consensus_admm_nudge_1e-15'])} under a 1e-15 relative nudge of y, by iterations); "
        f"the trainer's loss and change readings {json.dumps(res['train_readings'])}; "
        f"failed: {fails or 'none'}; K1-K3 launches by rank "
        f"{json.dumps({w: res['launches'][w] for w in ('w2', 'w4')})}; K1/K2 equal their plain versions at the "
        f"shard shapes {json.dumps(res['kernels_at_shards'])}; summaries {json.dumps(res['summaries'])}")
    check(not fails, "distributed: " + "; ".join(fails))
    log(f"timing distributed (CUDA events over each entry point, ms, the part inside collectives, and host s; "
        f"gloo on one shared card measures nothing of multi-GPU scaling): {json.dumps(res['times'])}; one "
        f"device, warm, after world 1 (ms): {json.dumps(res['one_device_ms'])}; one "
        f"device's sweep wall_s admm_l1 {sweep_res['summary']['admm_l1']['wall_s']}, admm_cnc "
        f"{sweep_res['summary']['admm_cnc']['wall_s']}; spawned worlds, spawn to join (s) "
        f"{json.dumps(res['spawned_s'])}")
    return res


def main() -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    if not os.path.isdir(os.path.join(ROOT, "pnp_admm_cnc_mri_torch")):
        raise SystemExit("chip_smoke: the package pnp_admm_cnc_mri_torch is not next to this script")
    sys.path.insert(0, ROOT)
    from pnp_admm_cnc_mri_torch import ADMM_CNC_DEFAULT, ADMM_L1_DEFAULT, ADMMConfig
    from pnp_admm_cnc_mri_torch.cli import experiments
    from pnp_admm_cnc_mri_torch.config import (
        PNP_CNC_BM3D_DEFAULT,
        PNP_CNC_DEFAULTS,
        PNP_L1_BM3D_DEFAULT,
        PNP_L1_DEFAULTS,
        TUNED_BM3D,
        TUNED_CONSENSUS_FISTA,
        TUNED_CONSENSUS_HQS,
        TUNED_DEBLUR,
        TUNED_FISTA_D,
        TUNED_HQS_D,
        TUNED_PGD_CNC,
        TUNED_RED_D,
        TUNED_SR,
    )
    from pnp_admm_cnc_mri_torch.data import masks, noise, phantom
    from pnp_admm_cnc_mri_torch.ops import fourier, fused_dc, metrics, prox, schedules, sisr, tail_kernels
    from pnp_admm_cnc_mri_torch.priors import bm3d_prior, denoiser
    from pnp_admm_cnc_mri_torch.priors.bm3d import api as bm3d_api
    from pnp_admm_cnc_mri_torch.priors.bm3d import core as bm3d_core
    from pnp_admm_cnc_mri_torch.parallel import consensus
    from pnp_admm_cnc_mri_torch.solvers import admm, fista, hqs, red

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

    threads = [threading.Thread(target=build, args=(name, load))
               for name, load in (("admm_tail", tail_kernels.load_library),
                                  ("admm_iteration", fused_dc.load_library),
                                  ("admm_iteration_cluster", fused_dc.load_cluster_library),
                                  ("admm_iteration_mixed", fused_dc.load_mixed_library))]
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

    # -- the fused iteration: both designs against their plain versions, then the path --
    t = time.perf_counter()
    cfg_l1 = ADMM_L1_DEFAULT
    thr = cfg_l1.rho * cfg_l1.lam
    cfg_10 = ADMMConfig(iter_num=10, lam=cfg_l1.lam, rho=cfg_l1.rho)
    big = phantom.mri_phantoms(2, 1024, seed=5)

    def scenario(b, h, w):
        """k-space and mask of b phantoms cut to (h, w), with the main path's mask and noise recipe."""
        m = torch.from_numpy(masks.random_mask((h, w), fraction=0.3, seed=1)).to(dev, torch.float32)
        nz = torch.from_numpy(noise.synth_noise((h, w), std=3.0, seed=2).astype(np.complex64)).to(dev)
        return fourier.observe(torch.from_numpy(big[:b, :h, :w].copy()).to(dev), m, nz), m

    def field_of_view(images, side=MIXED_SIDE):
        """The main path's phantoms centred in a side x side field of view,
        observed with the main path's mask and noise recipe at that size:
        (images, k-space, mask)."""
        top, left = (side - images.shape[-2]) // 2, (side - images.shape[-1]) // 2
        padded = torch.nn.functional.pad(
            images, (left, side - images.shape[-1] - left, top, side - images.shape[-2] - top))
        m = torch.from_numpy(masks.random_mask((side, side), fraction=0.3, seed=1)).to(dev, torch.float32)
        nz = torch.from_numpy(noise.synth_noise((side, side), std=3.0, seed=2).astype(np.complex64)).to(dev)
        return padded, fourier.observe(padded, m, nz), m

    def make(ys, ms, design=None):
        a_s, c_s = fourier.rfft_blend_fields(ys, ms, cfg_l1.rho)
        return fused_dc.make_fused_iteration(a_s, c_s.real.contiguous(), c_s.imag.contiguous(),
                                             *ms.shape, thr, design=design)

    def plain_step(step, z0, w0, dtype=torch.float32):
        f = step.fields
        return fused_dc.fused_iteration_plain(z0.to(dtype), w0.to(dtype), f.a_half.to(dtype), f.cr.to(dtype),
                                              f.ci.to(dtype), thr, None if dtype != torch.float32 else f.mats)

    def held(step, z0, w0, what):
        """Max abs errors of one step against the plain version in float64 and
        in float32. The cluster and mixed designs are held to the first (their
        FFTs are more accurate than the plain version's dense float32
        products, whose row 0 errs by up to 1.7e-5 at H = 1024), the strip
        design to the second (it runs those products). Checks finiteness, the
        limit, bitwise repeats."""
        got = step(z0, w0)
        errs = {}
        for ref_name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            ref = plain_step(step, z0, w0, dtype)
            errs[ref_name] = max(float((a_ - r_).abs().max()) for a_, r_ in zip(got, ref))
        for name, a_ in zip(("z'", "w'"), got):
            check(bool(torch.isfinite(a_).all()), f"fused_iteration {what}: non-finite {name}")
        e = errs["f32" if step.fields.design == "strips" else "f64"]
        check(e < FUSED_ATOL, f"fused_iteration {what}: max abs error {e} against the plain version")
        again = step(z0, w0)
        check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)), f"fused_iteration {what}: two launches differ")
        return e, errs

    h3 = 128
    y3 = fourier.observe(img[:3, :h3].contiguous(), mask[:h3].contiguous(),
                         torch.from_numpy(noise_np[:h3].copy()).to(dev))
    fused_err = dict.fromkeys(fused_dc.DESIGNS, 0.0)
    steps = {}
    for tag, (ys, ms) in {"512x256x256": (y, mask), "3x128x256": (y3, mask[:h3].contiguous())}.items():
        init = admm.init_state(ys)
        later = admm.admm_l1(ys, ms, cfg_10, dc_method="fft")[0]
        for design in fused_dc.DESIGNS:
            step = make(ys, ms, design)
            check(step.fields.design == design, f"{tag}: asked for {design}, got {step.fields.design}")
            steps[tag, design] = step
            for state_tag, (z0, w0) in (("init", (init.z, init.w)), ("after 10 iterations", (later.z, later.w))):
                e, _ = held(step, z0, w0, f"{design} {tag} {state_tag}")
                fused_err[design] = max(fused_err[design], e)
        check(make(ys, ms).fields.design == "cluster", f"{tag}: the rule did not take the cluster design")
    q_main = steps["512x256x256", "cluster"].fields.q
    check(q_main == 8, f"Q at 256 x 256 is {q_main}")
    # the mixed design at the shapes the rule gives it, against the plain step in float64
    t_mixed = time.perf_counter()
    mixed = {}
    for bb, hh, ww in ((2, 300, 256), (2, MIXED_SIDE, MIXED_SIDE), (2, 384, 384), (2, 512, 512), (2, 640, 320)):
        tag = f"{bb}x{hh}x{ww}"
        ys, ms = scenario(bb, hh, ww)
        step = make(ys, ms)
        check(step.fields.design == "mixed", f"{tag} took {step.fields.design}")
        init = admm.init_state(ys)
        mixed[tag] = {"q": step.fields.q, "err": held(step, init.z, init.w, f"mixed {tag}")[0]}
        if hh == ww == MIXED_SIDE:
            later = admm.admm_l1(ys, ms, cfg_10, dc_method="fft")[0]
            mixed[tag]["err_after_10"] = held(step, later.z, later.w, f"mixed {tag} after 10 iterations")[0]
            # a NaN in image 1 fills that image, and only it
            z_nan = init.z.clone()
            z_nan[1, 100, 100] = float("nan")
            got, ref = step(z_nan, init.w), plain_step(step, z_nan, init.w, torch.float64)
            for name, a_, r_ in zip(("z'", "w'"), got, ref):
                check(bool(torch.isnan(a_[1]).all() and torch.isnan(r_[1]).all()),
                      f"fused_iteration mixed {tag}: {name} of the image with a NaN is not all NaN")
                e = float((a_[0] - r_[0]).abs().max())
                check(e < FUSED_ATOL, f"fused_iteration mixed {tag} with a NaN in image 1: {name} error {e} in image 0")
        if (hh, ww) == (300, 256):
            y300, m300 = ys, ms
            forced = make(ys, ms, "mixed")
            forced.fields.q = 4  # 75 rows a block: the last of each goes through the row FFTs alone
            mixed[tag]["err_q4"] = held(forced, init.z, init.w, f"mixed {tag} at Q 4")[0]
        fused_err["mixed"] = max(fused_err["mixed"], *(v for k, v in mixed[tag].items() if k != "q"))
    t_mixed = time.perf_counter() - t_mixed
    log(f"fused_iteration: the mixed design against the plain version in float64, Q and max abs errors "
        f"{json.dumps(mixed)} ({t_mixed:.1f} s)")
    # a shape that only the strip design takes (W = 254 = 2 x 127), and tall images
    y254, m254 = scenario(2, 256, 254)
    step254 = make(y254, m254)
    check(step254.fields.design == "strips", f"2x256x254 took {step254.fields.design}")
    init = admm.init_state(y254)
    fused_err["strips"] = max(fused_err["strips"], held(step254, init.z, init.w, "strips 2x256x254")[0])
    tall = {}
    for hh in (512, 1024):
        ys, ms = scenario(2, hh, 64)
        init = admm.init_state(ys)
        for design in fused_dc.DESIGNS:
            e, tall[f"{design} 2x{hh}x64"] = held(make(ys, ms, design), init.z, init.w, f"{design} 2x{hh}x64")
            fused_err[design] = max(fused_err[design], e)
    log("fused_iteration: max abs errors at H = 512 and 1024 against the plain version in float64 and float32: "
        + json.dumps(tall))
    # a NaN in image 7 fills that image, and only it, in every design and the plain version
    init = admm.init_state(y)
    z_nan = init.z.clone()
    z_nan[7, 100, 100] = float("nan")
    others = torch.arange(B, device=dev) != 7
    for design in fused_dc.DESIGNS:
        step = steps["512x256x256", design]
        got = step(z_nan, init.w)
        ref = plain_step(step, z_nan, init.w, torch.float32 if design == "strips" else torch.float64)
        for name, a_, r_ in zip(("z'", "w'"), got, ref):
            check(bool(torch.isnan(a_[7]).all() and torch.isnan(r_[7]).all()),
                  f"fused_iteration {design}: {name} of the image with a NaN is not all NaN")
            e = float((a_[others] - r_[others]).abs().max())
            check(e < FUSED_ATOL, f"fused_iteration {design} with a NaN in image 7: {name} max abs error {e} elsewhere")
    a_s, cr_s, ci_s = (getattr(steps["512x256x256", "cluster"].fields, k) for k in ("a_half", "cr", "ci"))
    for bad, what in ((lambda: steps["512x256x256", "cluster"](init.z.double(), init.w.double()), "a float64 state"),
                      (lambda: fused_dc.make_fused_iteration(a_s.double(), cr_s.double(), ci_s.double(),
                                                             H, W, thr), "float64 fields"),
                      (lambda: fused_dc.make_fused_iteration(a_s[:, :-1], cr_s[..., :-1], ci_s[..., :-1],
                                                             H, W - 1, thr), "an odd W"),
                      (lambda: make(y300, m300, "cluster"), "the cluster design at H = 300"),
                      (lambda: make(y254, m254, "mixed"), "the mixed design at W = 254")):
        try:
            bad()
        except (TypeError, ValueError):
            pass
        else:
            raise AssertionError(f"fused_iteration took {what}")
    log(f"fused_iteration: max abs error against the plain version {json.dumps(fused_err)} (cluster and mixed: the "
        f"plain version in float64; strips: in float32; 512x256x256 and 3x128x256 from the initial state and after 10 "
        f"iterations, the mixed shapes above, 2x256x254 strips only, 2x512x64, 2x1024x64); Q {q_main} at 256x256; "
        f"NaN stays in its image; launches bitwise repeatable; float64, odd W, the cluster design at H = 300 and the "
        f"mixed design at W = 254 refused")

    def fused_path(ys, ms, cfg, want, img_ref=None):
        """admm_l1_fused_kernel with every count set to 0 just before and read
        just after; its launches by design must be ``want``. Checks x against
        the unfused matmul solver and, given the images, its PSNR against the
        zero-filled start and the fused fft solve. Returns (launches by
        design, numbers)."""
        torch.cuda.synchronize()
        tail_kernels.reset_launches()
        fused_dc.reset_launches()
        x_k = fused_dc.admm_l1_fused_kernel(ys, ms, cfg)[0]
        torch.cuda.synchronize()
        got = dict(fused_dc.fused_iteration.by_design)
        tag = "x".join(map(str, ys.shape))
        check(got == want and fused_dc.fused_iteration.launches == sum(want.values()),
              f"admm_l1_fused_kernel at {tag}: {fused_dc.fused_iteration.launches} fused iterations, by design {got}")
        check(tail_kernels.l1_tail.launches == 0 and tail_kernels.cnc_tail.launches == 0,
              f"admm_l1_fused_kernel at {tag} launched a tail kernel")
        check(tuple(x_k.shape) == tuple(ys.shape) and x_k.dtype == torch.float32, f"x is {x_k.dtype} {tuple(x_k.shape)}")
        check(bool(torch.isfinite(x_k).all()), f"admm_l1_fused_kernel at {tag}: non-finite output")
        d = (x_k - admm.admm_l1(ys, ms, cfg, fused=False, dc_method="matmul")[0].x).abs()
        res = {"vs_matmul_max": float(d.max()), "vs_matmul_mean": float(d.mean())}
        check(res["vs_matmul_max"] < 5e-3 and (img_ref is None or res["vs_matmul_mean"] < 1e-5),
              f"admm_l1_fused_kernel at {tag} vs unfused matmul solver: {json.dumps(res)}")
        if img_ref is not None:
            p = metrics.psnr(x_k * 255.0, img_ref * 255.0)
            zf = metrics.psnr(torch.abs(fourier.zero_fill(ys)) * 255.0, img_ref * 255.0)
            check(bool(torch.isfinite(p).all()) and bool((p > zf).all()),
                  f"admm_l1_fused_kernel at {tag}: PSNR {float(p.min())} not above the zero-filled PSNR on every image")
            x_fft = admm.admm_l1(ys, ms, cfg, fused=True, dc_method="fft")[0].x
            dp = float(p.mean()) - float(metrics.psnr(x_fft * 255.0, img_ref * 255.0).mean())
            check(abs(dp) < 0.05, f"admm_l1_fused_kernel at {tag}: mean PSNR {float(p.mean())} vs fft solve: {dp} dB")
            res.update({"psnr_db": float(p.mean()), "vs_fft_psnr_db": dp})
        return got, res

    # the paths: the cluster design at 512 x 256 x 256, the mixed design at 512
    # x 320 x 320 and 2 x 300 x 256, the strip design at 2 x 256 x 254
    by_design, quality["admm_l1_fused_kernel"] = fused_path(
        y, mask, cfg_l1, {"cluster": ITERS - 1, "mixed": 0, "strips": 0}, img)
    launches["fused_iteration"] = sum(by_design.values())
    launches["fused_iteration_cluster"] = by_design["cluster"]
    img320, y320, mask320 = field_of_view(img)
    by_320, quality[f"admm_l1_fused_kernel_{MIXED_SIDE}"] = fused_path(
        y320, mask320, cfg_l1, {"cluster": 0, "mixed": ITERS - 1, "strips": 0}, img320)
    launches["fused_iteration_mixed"] = by_320["mixed"]
    del img320, y320, mask320
    cfg_5 = ADMMConfig(iter_num=5, lam=cfg_l1.lam, rho=cfg_l1.rho)
    by_300, d300 = fused_path(y300, m300, cfg_5, {"cluster": 0, "mixed": 4, "strips": 0})
    by_254, d254 = fused_path(y254, m254, cfg_5, {"cluster": 0, "mixed": 0, "strips": 4})
    launches["fused_iteration_strips"] = by_254["strips"]
    del z_nan, got, ref, init, later, y3, y300, m300, y254, m254, big
    log(f"fused_iteration: launches by design {json.dumps(by_design)} at 512x256x256 x {ITERS}, "
        f"{json.dumps(by_320)} at 512x{MIXED_SIDE}x{MIXED_SIDE} x {ITERS}, {json.dumps(by_300)} at 2x300x256 x 5 "
        f"(x within {d300['vs_matmul_max']:.3g} of the matmul solver), {json.dumps(by_254)} at 2x256x254 x 5 "
        f"(within {d254['vs_matmul_max']:.3g}); quality {json.dumps(quality['admm_l1_fused_kernel'])} and "
        f"{json.dumps(quality[f'admm_l1_fused_kernel_{MIXED_SIDE}'])}")
    phase("fused_iteration", t)

    # -- PnP: DRUNet-CNC and DnCNN-L1 at full width, seeded weights ------------
    t = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded random init warns
        drunet = {dt: denoiser.build_denoiser("drunet_gray", iter_num=ITERS, param_dtype=dt, device=dev)
                  for dt in (torch.float32, torch.float64)}
        dncnn = denoiser.build_denoiser("dncnn_25", iter_num=ITERS, device=dev)
    check(torch.backends.cudnn.allow_tf32, "TF32 was already off for cuDNN: the checks below would prove nothing")
    alpha, _, lam, rho, b_cnc = PNP_CNC_DEFAULTS["drunet_gray"]
    cfg_cnc = ADMMConfig(iter_num=ITERS, rho=rho, lam=lam, alpha=alpha, b=b_cnc)
    cfg_pnp_l1 = ADMMConfig(iter_num=ITERS, rho=PNP_L1_DEFAULTS["dncnn_25"][1])
    y4, img4 = y[:PNP_B].contiguous(), img[:PNP_B]
    # the forward, float32 against float64, batch 1, the first and last rungs of the sigma ladder
    v1 = img[:1].contiguous()
    fwd_err = max(float((drunet[torch.float32](v1, i).double() - drunet[torch.float64](v1.double(), i)).abs().max())
                  for i in (0, ITERS - 1))
    check(fwd_err < DRUNET_ATOL, f"DRUNet forward float32 vs float64: {fwd_err}")
    # a 4-iteration PnP-CNC solve, float32 against float64, batch 2
    cfg_4 = ADMMConfig(iter_num=4, rho=rho, lam=lam, alpha=alpha, b=b_cnc)
    s32 = admm.pnp_admm_cnc(y[:2], mask, cfg_4, drunet[torch.float32])[0]
    s64 = admm.pnp_admm_cnc(y[:2].to(torch.complex128), mask, cfg_4, drunet[torch.float64], dtype=torch.float64)[0]
    solve_err = max(float((a_.double() - r_).abs().max()) for a_, r_ in zip(s32, s64))
    check(solve_err < PNP_ATOL, f"PnP-CNC 4 iterations float32 vs float64: {solve_err}")
    # the path: the classical kernels' counts set to 0 just before, read just after
    torch.cuda.synchronize()
    tail_kernels.reset_launches()
    fused_dc.reset_launches()
    pnp = {"pnp_admm_cnc_drunet": admm.pnp_admm_cnc(y4, mask, cfg_cnc, drunet[torch.float32])[0],
           "pnp_admm_l1_dncnn": admm.pnp_admm_l1(y4, mask, cfg_pnp_l1, dncnn)[0]}
    torch.cuda.synchronize()
    pnp_launches = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                    "fused_iteration": fused_dc.fused_iteration.launches}
    check(pnp_launches == dict.fromkeys(pnp_launches, 0), f"the PnP path launched a classical kernel: {pnp_launches}")
    pnp_quality = {}
    for k, st in pnp.items():
        for name, a_ in zip("xzw", st):
            check(tuple(a_.shape) == (PNP_B, H, W) and a_.dtype == torch.float32, f"{k}: {name} is {a_.dtype} "
                  f"{tuple(a_.shape)}")
            check(bool(torch.isfinite(a_).all()) and float(a_.min()) >= 0.0 and float(a_.max()) <= 1.0,
                  f"{k}: {name} not finite or outside [0, 1]")
        pnp_quality[k] = float(metrics.psnr(st.x * 255.0, img4 * 255.0).mean())
    log(f"pnp: DRUNet (nc 64..512, nb 4) forward float32 vs float64 {fwd_err:.3g} (batch 1, rungs 0 and "
        f"{ITERS - 1}; tolerance {DRUNET_ATOL:g}); PnP-CNC 4 iterations float32 vs float64 {solve_err:.3g} (batch 2; "
        f"tolerance {PNP_ATOL:g}); "
        f"outputs finite and in [0, 1]; classical kernel launches on the PnP path {json.dumps(pnp_launches)}; "
        f"mean PSNR with random weights (no quality claim) {json.dumps(pnp_quality)}")
    # timing: the solves, the forward at the solve's batch, and the rest of an iteration
    v4 = img4.contiguous()
    flops = conv_flops(drunet[torch.float32], v4)
    pnp_ms = {
        "pnp_admm_cnc_drunet_solve": cuda_ms(lambda: admm.pnp_admm_cnc(y4, mask, cfg_cnc, drunet[torch.float32]),
                                             reps=3, warmup=0),
        "pnp_admm_l1_dncnn_solve": cuda_ms(lambda: admm.pnp_admm_l1(y4, mask, cfg_pnp_l1, dncnn), reps=3, warmup=0),
        "drunet_forward": cuda_ms(lambda: drunet[torch.float32](v4, 0), reps=5, inner=2),
        "dncnn_forward": cuda_ms(lambda: dncnn(v4, 0), reps=5, inner=5),
    }
    # the rest of an iteration: the same solve with the identity in both slots
    pnp_ms["pnp_admm_cnc_identity_solve"] = cuda_ms(lambda: admm.pnp_admm_cnc(y4, mask, cfg_cnc, lambda v, i: v),
                                                    reps=5)
    dc4 = fourier.make_rfft_data_consistency(y4, mask, rho, method="fft")
    st = pnp["pnp_admm_cnc_drunet"]
    pnp_ms["dc_solve"] = cuda_ms(lambda: dc4(st.z - st.w), reps=5, inner=20)
    per_iter = pnp_ms["pnp_admm_cnc_drunet_solve"] / ITERS
    rest = pnp_ms["pnp_admm_cnc_identity_solve"] / ITERS
    # the network alone with cuDNN's TF32 on (the process default, which the
    # port does not use), for information: its error against float64 and its time
    x2 = torch.cat([v4[:, None], torch.full_like(v4[:, None], 49.0 / 255.0)], dim=1)
    tf32_err = float((drunet[torch.float32].model(x2[:1]).double()
                      - drunet[torch.float64].model(x2[:1].double())).abs().max())
    tf32_ms = cuda_ms(lambda: drunet[torch.float32].model(x2), reps=5, inner=2)
    log(f"timing pnp ({PNP_B} x {H} x {W}, {ITERS} iterations, CUDA-event medians, ms): {json.dumps(pnp_ms)}; "
        f"PnP-CNC {per_iter:.3f} ms an iteration; 2 DRUNet forwards {2 * pnp_ms['drunet_forward']:.3f} "
        f"({2 * pnp_ms['drunet_forward'] / per_iter:.1%}); the iteration without them (identity denoisers) "
        f"{rest:.3f} ({rest / per_iter:.1%}), of which the DC solve {pnp_ms['dc_solve']:.3f}; "
        f"DRUNet forward {flops / 1e9:.1f} GFLOP "
        f"at batch {PNP_B} ({flops / PNP_B / 1e9:.1f} a {H}x{W} image, convolutions only) = "
        f"{flops / (pnp_ms['drunet_forward'] * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{flops / (pnp_ms['drunet_forward'] * 1e-3) / FP32_FLOPS:.1%} of the {FP32_FLOPS / 1e12:.0f} TFLOP/s float32 "
        f"peak; with cuDNN's TF32 on (not used by the port): {tf32_ms:.3f} ms, error vs float64 {tf32_err:.3g}")
    del pnp, s32, s64, st, drunet, dncnn, dc4
    phase("pnp", t)

    # -- solvers: FISTA, consensus, HQS, RED; DRUNet and TDNet at full width --
    t = time.perf_counter()
    rates = {}
    fl1 = dict(lam=8e-4, step=1.0)
    # classical FISTA-L1 on the main scenario, and in float64 against numpy;
    # the classical kernels' counts set to 0 here and read after the driven runs
    torch.cuda.synchronize()
    tail_kernels.reset_launches()
    fused_dc.reset_launches()
    x_f = fista.fista_l1(y, mask, ITERS, **fl1)[0].x
    check(tuple(x_f.shape) == (B, H, W) and x_f.dtype == torch.float32, f"fista_l1: x is {x_f.dtype} {tuple(x_f.shape)}")
    check(bool(torch.isfinite(x_f).all()), "fista_l1: non-finite output")
    p = metrics.psnr(x_f * 255.0, img * 255.0)
    check(bool(torch.isfinite(p).all()) and bool((p > zf_psnr).all()),
          f"fista_l1: PSNR {float(p.min())} not above the zero-filled PSNR on every image")
    sq = {"fista_l1_psnr_db": float(p.mean())}
    img2 = img_np[:2].astype(np.float64)
    y2 = np.fft.fft2(img2) * mask_np + noise_np.astype(np.complex128)
    x2_f = fista.fista_l1(y2, mask_np, ITERS, dtype=torch.float64, **fl1)[0].x
    ref2 = np.stack([numpy_fista_l1(im, mask_np, noise_np.astype(np.complex128), ITERS, **fl1) for im in img2])
    fista_f64_err = float(np.abs(x2_f.cpu().numpy() - ref2).max())
    check(fista_f64_err < 1e-9, f"float64 fista_l1 on the card vs numpy reference: {fista_f64_err}")
    # DRUNet at full width on the tuned ladders, seeded weights
    tf, th, tr = TUNED_FISTA_D["drunet_gray"], TUNED_HQS_D["drunet_gray"], TUNED_RED_D["drunet_gray"]
    check(TUNED_CONSENSUS_FISTA["drunet_gray"] == tf and TUNED_CONSENSUS_HQS["drunet_gray"] == th,
          "the consensus tables no longer share the single-mask DRUNet settings: build their own denoisers")
    nlm01 = lambda row: row["nlm"] / 255.0  # noqa: E731
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the seeded random init warns
        d_fista = {dt: denoiser.build_denoiser("drunet_gray", iter_num=tf["iter_num"], noise_level_model=nlm01(tf),
                                               model_sigma1=tf["model_sigma1"], x8=tf["x8"], param_dtype=dt,
                                               device=dev)
                   for dt in (torch.float32, torch.float64)}
        d_hqs = denoiser.build_denoiser("drunet_gray", iter_num=th["iter_num"], noise_level_model=nlm01(th),
                                        x8=th["x8"], device=dev)
        # RED's constant-strength denoiser: the ladder flattened at nlm
        d_red = denoiser.build_denoiser("drunet_gray", iter_num=tr["iter_num"], noise_level_model=nlm01(tr),
                                        model_sigma1=tr["nlm"], device=dev)
        ttd = TUNED_FISTA_D["tdnet"]
        d_td, d_td1 = (denoiser.build_denoiser("tdnet", iter_num=ttd["iter_num"], noise_level_model=nlm01(ttd),
                                               model_sigma1=ttd["model_sigma1"], x8=x8, device=dev)
                       for x8 in (ttd["x8"], False))
    check(torch.backends.cudnn.allow_tf32, "TF32 was already off for cuDNN: the checks below would prove nothing")
    hqs_ladder = dict(sigma255=th["sigma255"], model_sigma1=49.0, model_sigma2=th["nlm"])
    # 3 observations of each image, with the same noise
    masks3 = torch.from_numpy(np.stack([mask_np, masks.radial_mask((H, W)),
                                        masks.cartesian_mask((H, W), fraction=0.3, seed=1)])).to(dev, torch.float32)
    ys4 = fourier.observe(img4[:, None], masks3, torch.from_numpy(noise_np).to(dev))
    check(tuple(ys4.shape) == (PNP_B, 3, H, W), f"consensus observations of shape {tuple(ys4.shape)}")

    def prox_of(d):
        return lambda i, u: prox.clip01(d(u, i))

    # 4 iterations, float32 against float64, batch 2
    fista_err = {}
    for k, run in {
        "pnp_fista": lambda yy, d, dt: fista.pnp_fista(yy, mask, 4, d, dtype=dt)[0],
        "consensus_fista": lambda yy, d, dt: consensus.run_consensus_fista(yy, masks3, 4, prox_of(d), dtype=dt,
                                                                          return_state=True),
    }.items():
        yy = y[:2] if k == "pnp_fista" else ys4[:2]
        a_, r_ = run(yy, d_fista[torch.float32], torch.float32), run(yy.to(torch.complex128), d_fista[torch.float64],
                                                                   torch.float64)
        fista_err[k] = max(float((a_.x.double() - r_.x).abs().max()), float((a_.v.double() - r_.v).abs().max()))
        check(fista_err[k] < PNP_ATOL, f"{k} 4 iterations float32 vs float64: {fista_err[k]}")
    # the paths (the classical kernels' counts were set to 0 at the phase's start)
    out = {
        "pnp_fista_drunet": fista.pnp_fista(y4, mask, tf["iter_num"], d_fista[torch.float32])[0].x,
        "consensus_fista_drunet": consensus.run_consensus_fista(ys4, masks3, tf["iter_num"],
                                                                prox_of(d_fista[torch.float32])),
        "pnp_hqs_drunet": hqs.pnp_hqs(y4, mask, th["iter_num"], d_hqs, **hqs_ladder)[0],
        "red_drunet": red.run_red(y4, mask, tr["iter_num"], d_red, lam=tr["lam"])[0],
        "consensus_hqs_drunet": consensus.run_consensus_hqs(ys4, masks3, th["iter_num"], d_hqs, **hqs_ladder),
        "pnp_fista_tdnet": fista.pnp_fista(y4, mask, ttd["iter_num"], d_td)[0].x,
    }
    torch.cuda.synchronize()
    solver_launches = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                       "fused_iteration": fused_dc.fused_iteration.launches}
    check(solver_launches == dict.fromkeys(solver_launches, 0),
          f"the solvers' paths launched a classical kernel: {solver_launches}")
    for k, xk in out.items():
        check(tuple(xk.shape) == (PNP_B, H, W) and xk.dtype == torch.float32, f"{k}: x is {xk.dtype} {tuple(xk.shape)}")
        check(bool(torch.isfinite(xk).all()) and float(xk.min()) >= 0.0 and float(xk.max()) <= 1.0,
              f"{k}: not finite or outside [0, 1]")
        sq[k] = float(metrics.psnr(xk * 255.0, img4 * 255.0).mean())
    log(f"solvers: fista_l1 {B}x{H}x{W}x{ITERS} PSNR above zero-filled on every image; float64 fista_l1 vs numpy "
        f"{fista_f64_err:.3g}; DRUNet (nc 64..512, nb 4) 4 iterations float32 vs float64 {json.dumps(fista_err)} "
        f"(batch 2; tolerance {PNP_ATOL:g}); outputs finite and in [0, 1]; classical kernel launches on these paths "
        f"{json.dumps(solver_launches)}; mean PSNR (random denoiser weights: no quality claim) {json.dumps(sq)}")
    # timing: fista_l1 beside admm_l1(fused=True), the two FISTA solves, the
    # rest of their iterations (identity denoiser), and the TDNet forward
    ident = lambda v, i: v  # noqa: E731
    solver_ms = {
        "fista_l1_solve": cuda_ms(lambda: fista.fista_l1(y, mask, ITERS, **fl1)),
        "admm_l1_fused_solve": cuda_ms(lambda: admm.admm_l1(y, mask, ADMM_L1_DEFAULT, fused=True, dc_method="fft")),
        "pnp_fista_drunet_solve": cuda_ms(lambda: fista.pnp_fista(y4, mask, tf["iter_num"], d_fista[torch.float32]),
                                          reps=3, warmup=0),
        "consensus_fista_drunet_solve": cuda_ms(lambda: consensus.run_consensus_fista(
            ys4, masks3, tf["iter_num"], prox_of(d_fista[torch.float32])), reps=3, warmup=0),
        "pnp_fista_identity_solve": cuda_ms(lambda: fista.pnp_fista(y4, mask, tf["iter_num"], ident)),
        "consensus_fista_identity_solve": cuda_ms(lambda: consensus.run_consensus_fista(
            ys4, masks3, tf["iter_num"], prox_of(ident))),
        "tdnet_forward": cuda_ms(lambda: d_td1(v4, 0), reps=5, inner=5),
    }
    td_flops = conv_flops(d_td1, v4)
    rates["fista_l1"] = {"solve_ms": solver_ms["fista_l1_solve"],
                         "image_iters_per_s": B * ITERS / (solver_ms["fista_l1_solve"] / 1e3)}
    n_it = tf["iter_num"]
    log(f"timing solvers (CUDA-event medians, ms): {json.dumps(solver_ms)}; fista_l1 {B}x{H}x{W}x{ITERS}: "
        f"{solver_ms['fista_l1_solve'] / ITERS:.3f} ms an iteration, {rates['fista_l1']['image_iters_per_s']:.0f} "
        f"image-iters/s (admm_l1 fused {solver_ms['admm_l1_fused_solve'] / ITERS:.3f} ms an iteration); "
        f"PnP-FISTA {solver_ms['pnp_fista_drunet_solve'] / n_it:.3f} ms an iteration, without the forward "
        f"{solver_ms['pnp_fista_identity_solve'] / n_it:.3f}; consensus-FISTA "
        f"{solver_ms['consensus_fista_drunet_solve'] / n_it:.3f}, without the forward "
        f"{solver_ms['consensus_fista_identity_solve'] / n_it:.3f}; DRUNet forward (pnp phase) "
        f"{pnp_ms['drunet_forward']:.3f}; TDNet (nc 128, nb 12) forward at batch {PNP_B} {td_flops / 1e9:.1f} GFLOP "
        f"({td_flops / PNP_B / 1e9:.2f} a {H}x{W} image, convolutions only) = "
        f"{td_flops / (solver_ms['tdnet_forward'] * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{td_flops / (solver_ms['tdnet_forward'] * 1e-3) / FP32_FLOPS:.1%} of the {FP32_FLOPS / 1e12:.0f} TFLOP/s "
        f"float32 peak")
    del out, d_fista, d_hqs, d_red, d_td, d_td1, ys4, x_f
    phase("solvers", t)

    # -- bm3d: the white-noise core, and the reference's PnP-ADMM-BM3D pipelines --
    t = time.perf_counter()
    sig = math.sqrt(0.03)  # make_bm3d_denoiser's default
    prof = bm3d_core.DEFAULT_PROFILE
    bs = prof.bs_ht  # the 'np' profile's stages share block size, step and search window
    taus = {k: tm * prof.tau_scale * bs * bs / 255.0**2 for k, tm in (("ht", prof.tau_match_ht),
                                                                      ("wiener", prof.tau_match_wie))}
    offs = bm3d_core._offsets(prof.search_ht, bs)

    def matches(a, k, tau):
        ref = bm3d_core._ref_grid(a.shape[-1] - bs + 1, prof.step_ht)
        return bm3d_core._match(a, ref, offs, bs, k, tau)

    # 1. the card against the port's CPU run, float64, 2 x 64 x 64, sigma 0.1
    rng_b = np.random.default_rng(11)
    z_s = torch.from_numpy(img_np[:2, 96:160, 96:160].astype(np.float64) + 0.1 * rng_b.standard_normal((2, 64, 64)))
    on_card, on_cpu = bm3d_core.bm3d(z_s, 0.1, device=dev), bm3d_core.bm3d(z_s, 0.1, device="cpu")
    card_vs_cpu = float((on_card.cpu() - on_cpu).abs().max())
    check(card_vs_cpu < 1e-9, f"bm3d float64 on the card vs the CPU: {card_vs_cpu}")
    pilots = {d_: bm3d_core.ht_stage(z_s.to(d_), 0.1) for d_ in (dev, torch.device("cpu"))}
    for stage, src, k in (("ht", lambda d_: z_s.to(d_), prof.max_3d_ht),
                          ("wiener", lambda d_: pilots[d_], prof.max_3d_wie)):
        got = matches(src(dev), k, taus[stage])
        want = matches(src(torch.device("cpu")), k, taus[stage])
        check(all(torch.equal(a_.cpu(), b_) for a_, b_ in zip(got, want)),
              f"bm3d float64: the {stage} stage's matches differ between the card and the CPU")
    # 2. two calls at 4 x 256 x 256 are bit-equal
    den = bm3d_prior.make_bm3d_denoiser()
    z4 = torch.from_numpy((img_np[:PNP_B] + sig * np.random.default_rng(5).standard_normal((PNP_B, H, W)))
                          .astype(np.float32)).to(dev)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for cuBLAS before the bm3d phase")
    out_a = den(z4, 0)
    check(torch.equal(out_a, den(z4, 0)), "bm3d: two calls at 4 x 256 x 256 differ")
    check(tuple(out_a.shape) == (PNP_B, H, W) and bool(torch.isfinite(out_a).all()), "bm3d: output not finite")
    # 3. float32 against float64 at 4 x 256 x 256
    z4d = z4.double()
    d32 = (out_a.double() - den(z4d, 0)).abs()
    share = {}
    for stage, a32, a64, k in (("ht", z4, z4d, prof.max_3d_ht),
                               ("wiener", bm3d_core.ht_stage(z4, sig, prefilter=False),
                                bm3d_core.ht_stage(z4d, sig, prefilter=False), prof.max_3d_wie)):
        (p32, c32), (p64, c64) = matches(a32, k, taus[stage]), matches(a64, k, taus[stage])
        used = torch.arange(k, device=dev) < torch.minimum(c32, c64)[..., None]
        share[stage] = float((((p32 != p64).any(-1) & used).any(-1) | (c32 != c64)).double().mean())
    f32_err = {"max": float(d32.max()), "mean": float(d32.mean()), "share": max(share.values())}
    check(all(f32_err[k] < BM3D_F32[k] for k in BM3D_F32), f"bm3d float32 vs float64: {f32_err} (limits {BM3D_F32})")
    del z4d, d32
    # 4. TF32 set on in the process changes nothing
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out_tf32 = den(z4, 0)
        check(torch.backends.cuda.matmul.allow_tf32, "bm3d did not give the caller's TF32 setting back")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.equal(out_tf32, out_a), "bm3d: TF32 on in the process changed the output")
    log(f"bm3d: float64 card vs CPU {card_vs_cpu:.3g} (2x64x64, sigma 0.1; HT and Wiener matches identical); two "
        f"calls at {PNP_B}x{H}x{W} bit-equal; float32 vs float64 max {f32_err['max']:.3g} mean {f32_err['mean']:.3g}, "
        f"groups with other used matches: HT {share['ht']:.4%}, Wiener {share['wiener']:.4%} (limits {BM3D_F32}); "
        f"TF32 on in the process: output bit-equal")
    # 5, 6. the pipelines and the single runs, the classical kernels' counts at 0
    y4, mask_b = y[:PNP_B].contiguous(), mask
    zf4 = metrics.psnr(torch.abs(fourier.zero_fill(y4)) * 255.0, img4 * 255.0)

    def var(nlm):
        return (nlm / 255.0) ** 2

    def tuned_cfg(key):
        row = dict(TUNED_BM3D[key])
        base_cfg = PNP_L1_BM3D_DEFAULT if key == "pnp_l1_bm3d" else PNP_CNC_BM3D_DEFAULT
        return dataclasses.replace(base_cfg, **{k: v for k, v in row.items() if k != "nlm"}), row["nlm"]

    (cfg_l1t, nlm_l1t), (cfg_cnct, nlm_cnct) = tuned_cfg("pnp_l1_bm3d"), tuned_cfg("pnp_cnc_bm3d")
    rf, rp, rh, rr, rc = (TUNED_FISTA_D["bm3d"], TUNED_PGD_CNC["bm3d"], TUNED_HQS_D["bm3d"], TUNED_RED_D["bm3d"],
                          TUNED_CONSENSUS_FISTA["bm3d"])
    hqs_sigmas = schedules.get_rho_sigma(sigma=rh["sigma255"] / 255.0, iter_num=rh["iter_num"], model_sigma1=49.0,
                                         model_sigma2=rh["nlm"])[1]
    bm3d_ms = {}

    def timed(name, fn):
        res, bm3d_ms[name] = event_ms(fn)
        return res

    ys4_b = fourier.observe(img4[:, None], masks3, torch.from_numpy(noise_np).to(dev))  # 3 observations an image
    torch.cuda.synchronize()
    tail_kernels.reset_launches()
    fused_dc.reset_launches()
    pipes = {
        "pnp_l1_bm3d": timed("pnp_l1_bm3d_solve", lambda: admm.pnp_admm_l1(
            y4, mask_b, PNP_L1_BM3D_DEFAULT, den, clamp=False)[0].x),
        "pnp_cnc_bm3d": timed("pnp_cnc_bm3d_solve", lambda: admm.pnp_admm_cnc(
            y4, mask_b, PNP_CNC_BM3D_DEFAULT, den, clamp=False)[0].x),
        "pnp_l1_bm3d_tuned": admm.pnp_admm_l1(y4, mask_b, cfg_l1t, bm3d_prior.make_bm3d_denoiser(var(nlm_l1t)),
                                              clamp=False)[0].x,
        "pnp_cnc_bm3d_tuned": admm.pnp_admm_cnc(y4, mask_b, cfg_cnct, bm3d_prior.make_bm3d_denoiser(var(nlm_cnct)),
                                                clamp=False)[0].x,
    }
    singles = {
        "pnp_fista_bm3d": fista.pnp_fista(y4, mask_b, rf["iter_num"],
                                          bm3d_prior.make_bm3d_denoiser(var(rf["nlm"])))[0].x,
        "pnp_pgd_cnc_bm3d": fista.pnp_pgd_cnc(y4, mask_b, rp["iter_num"], bm3d_prior.make_bm3d_denoiser(var(rp["nlm"])),
                                              alpha=rp["alpha"], lam=rp["lam"], b=rp["b"])[0].x,
        "pnp_hqs_bm3d": hqs.pnp_hqs(y4, mask_b, rh["iter_num"], bm3d_prior.make_bm3d_ladder_denoiser(hqs_sigmas),
                                    sigma255=rh["sigma255"], model_sigma1=49.0, model_sigma2=rh["nlm"])[0],
        "red_bm3d": red.run_red(y4, mask_b, rr["iter_num"], bm3d_prior.make_bm3d_denoiser(var(rr["nlm"])),
                                lam=rr["lam"])[0],
        "consensus_fista_bm3d": consensus.run_consensus_fista(
            ys4_b, masks3, rc["iter_num"], prox_of(bm3d_prior.make_bm3d_denoiser(var(rc["nlm"])))),
    }
    torch.cuda.synchronize()
    bm3d_launches = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                     "fused_iteration": fused_dc.fused_iteration.launches}
    check(bm3d_launches == dict.fromkeys(bm3d_launches, 0),
          f"the BM3D paths launched a classical kernel: {bm3d_launches}")
    bq = {"zero_filled": zf4.tolist()}
    for k, xk in {**pipes, **singles}.items():
        check(tuple(xk.shape) == (PNP_B, H, W) and xk.dtype == torch.float32, f"{k}: x is {xk.dtype} {tuple(xk.shape)}")
        check(bool(torch.isfinite(xk).all()), f"{k}: non-finite output")
        bq[k] = metrics.psnr(xk * 255.0, img4 * 255.0).tolist()
    zf_mean = statistics.mean(bq["zero_filled"])
    above_zf = {}
    for k in pipes:
        above = [a_ > b_ for a_, b_ in zip(bq[k], bq["zero_filled"])]
        if k == "pnp_l1_bm3d":
            # a 1e-6 nudge takes image 0 of the JAX package's own solve below its
            # zero-filled PSNR (20.93 < 22.12 dB, the band above), so the batch mean
            # is held above the zero-filled mean, and the images are printed
            check(statistics.mean(bq[k]) > zf_mean, f"{k}: mean PSNR {bq[k]} not above the zero-filled mean {zf_mean}")
        else:
            check(all(above), f"{k}: PSNR {bq[k]} not above the zero-filled {bq['zero_filled']} on every image")
        if k.endswith("tuned"):
            check(all(abs(a_ - b_) < BM3D_TUNED_DB for a_, b_ in zip(bq[k], JAX_BM3D_PSNR[k])),
                  f"{k}: PSNR {bq[k]} vs the JAX package's {JAX_BM3D_PSNR[k]}")
        else:
            lo, hi = JAX_BM3D_BAND[k]
            check(lo - BM3D_50_DB < bq[k][0] < hi + BM3D_50_DB,
                  f"{k}: image 0 at {bq[k][0]} dB, outside the JAX package's band {lo}..{hi} +- {BM3D_50_DB}")
        above_zf[k] = sum(above)
    log(f"bm3d: classical kernel launches on the BM3D paths {json.dumps(bm3d_launches)}; PSNR per image (dB; JAX "
        f"package on the CPU in brackets) " + "; ".join(
            f"{k} {[round(v, 3) for v in bq[k]]}" + (f" [{[round(v, 3) for v in JAX_BM3D_PSNR[k]]}]"
                                                     if k in JAX_BM3D_PSNR else "") for k in bq)
        + f"; images above their zero-filled PSNR {json.dumps(above_zf)} of {PNP_B}; JAX package's image-0 bands "
        f"{json.dumps(JAX_BM3D_BAND)}"
        + f"; no iteration cut (PnP-FISTA {rf['iter_num']}, PnP-PGD-CNC {rp['iter_num']}, PnP-HQS {rh['iter_num']}, "
        f"RED {rr['iter_num']}, consensus-FISTA {rc['iter_num']} iterations)")
    # 7. timing: a call by stage at 1 and 4 images, the chunking, the rest of an iteration, peak memory
    z1 = z4[:1].contiguous()
    for tag, zz in (("1", z1), (str(PNP_B), z4)):
        pilot = bm3d_core.ht_stage(zz, sig, prefilter=False)
        bm3d_ms[f"ht_stage_x{tag}"] = cuda_ms(lambda: bm3d_core.ht_stage(zz, sig, prefilter=False))
        bm3d_ms[f"wiener_stage_x{tag}"] = cuda_ms(lambda: bm3d_core.wiener_stage(zz, pilot, sig))
        bm3d_ms[f"call_x{tag}"] = cuda_ms(lambda: bm3d_core.bm3d(zz, sig, prefilter=False, device=dev))
    for chunk in (1, PNP_B):
        d_c = bm3d_prior.make_bm3d_denoiser(batch_chunk=chunk)
        bm3d_ms[f"denoiser_x{PNP_B}_chunk{chunk}"] = cuda_ms(lambda: d_c(z4, 0))
    ident = lambda v, i: v  # noqa: E731
    bm3d_ms["pnp_l1_identity_solve"] = cuda_ms(lambda: admm.pnp_admm_l1(y4, mask_b, PNP_L1_BM3D_DEFAULT, ident,
                                                                         clamp=False))
    bm3d_ms["pnp_cnc_identity_solve"] = cuda_ms(lambda: admm.pnp_admm_cnc(y4, mask_b, PNP_CNC_BM3D_DEFAULT, ident,
                                                                           clamp=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    den(z4, 0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_mem
    it_l1, it_cnc = PNP_L1_BM3D_DEFAULT.iter_num, PNP_CNC_BM3D_DEFAULT.iter_num
    per_l1 = bm3d_ms["pnp_l1_bm3d_solve"] / it_l1
    per_cnc = bm3d_ms["pnp_cnc_bm3d_solve"] / it_cnc
    rest_l1 = bm3d_ms["pnp_l1_identity_solve"] / it_l1
    rest_cnc = bm3d_ms["pnp_cnc_identity_solve"] / it_cnc
    log(f"timing bm3d ({PNP_B} x {H} x {W}, float32, profile 'np', CUDA events, ms; the 50-iteration solves once, "
        f"on their driven runs): {json.dumps(bm3d_ms)}; PnP-L1-BM3D {per_l1:.3f} ms an iteration, of which all "
        f"but the rest (the solve with an identity denoiser) {rest_l1:.4f} ({rest_l1 / per_l1:.2%}) is BM3D; "
        f"PnP-CNC-BM3D {per_cnc:.3f} ms an iteration, the rest {rest_cnc:.4f} ({rest_cnc / per_cnc:.2%}); "
        f"batch_chunk 1 vs {PNP_B}: "
        f"{bm3d_ms[f'denoiser_x{PNP_B}_chunk1']:.3f} vs {bm3d_ms[f'denoiser_x{PNP_B}_chunk{PNP_B}']:.3f} (default "
        f"{bm3d_prior.default_batch_chunk()}); peak memory of one call at {PNP_B} x {H} x {W} above what was "
        f"allocated {peak / 2**20:.1f} MiB")
    del pipes, singles, out_a, out_tf32, z4, z1, ys4_b, pilots
    phase("bm3d", t)

    # -- restore: the DPIR restoration pipelines (PnP deblurring and SR x2) ----
    t = time.perf_counter()
    tail_kernels.reset_launches()
    fused_dc.reset_launches()
    x4 = torch.from_numpy(phantom.mri_phantoms(PNP_B, H, seed=0)).to(dev)
    noise_deblur = np.random.default_rng(3).standard_normal((PNP_B, H, W)).astype(np.float32)
    noise_sr = np.random.default_rng(4).standard_normal((PNP_B, H // 2, W // 2)).astype(np.float32)

    def seeded_drunet(iter_num, nlm, dtype=torch.float32):
        # DRUNet as experiments._restoration_prior builds it, but with seeded weights whatever model_zoo/ holds
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the seeded random init warns
            return denoiser.build_denoiser("drunet_gray", iter_num=iter_num,
                                           noise_level_model=denoiser.nlm_for_model("drunet_gray", nlm),
                                           param_dtype=dtype, device=dev)

    # TUNED_DEBLUR and TUNED_SR give DRUNet the same row (8 iterations, nlm 2), so one network serves both
    check(TUNED_DEBLUR["drunet_gray"] == TUNED_SR["drunet_gray"], "the tuned DRUNet rows differ")
    row = TUNED_DEBLUR["drunet_gray"]
    den_dru = seeded_drunet(row["iter_num"], row["nlm"])
    runs = {
        "deblur_bm3d": (experiments.deblur_batch, dict(model_name="bm3d", iter_num=8, noise=noise_deblur)),
        "sr_bm3d": (experiments.sr_batch, dict(model_name="bm3d", sf=2, iter_num=8, noise=noise_sr)),
        "deblur_drunet": (experiments.deblur_batch, dict(denoise=den_dru, noise=noise_deblur, **row)),
        "sr_drunet": (experiments.sr_batch, dict(denoise=den_dru, sf=2, noise=noise_sr, **row)),
    }
    restore_ms, restored, degraded = {}, {}, {}
    for k, (fn, kw) in runs.items():
        fn(x4, **{**kw, "iter_num": 1})  # warm-up
        (degraded[k], restored[k]), restore_ms[k] = event_ms(lambda: fn(x4, **kw))
    torch.cuda.synchronize()
    restore_launches = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                        "fused_iteration": fused_dc.fused_iteration.launches}
    check(restore_launches == dict.fromkeys(restore_launches, 0),
          f"the restoration paths launched a classical kernel: {restore_launches}")

    def psnr01(a):
        return metrics.psnr(a.clamp(0.0, 1.0) * 255.0, x4 * 255.0).tolist()

    rq = {"deblur_degraded": psnr01(degraded["deblur_bm3d"]),
          "sr_kron": psnr01(degraded["sr_bm3d"].repeat_interleave(2, -2).repeat_interleave(2, -1))}
    for k, zk in restored.items():
        check(tuple(zk.shape) == (PNP_B, H, W) and zk.dtype == torch.float32, f"{k}: {zk.dtype} {tuple(zk.shape)}")
        check(bool(torch.isfinite(zk).all()), f"{k}: non-finite output")
        rq[k] = psnr01(zk)
    for k in ("deblur_degraded", "sr_kron", "deblur_bm3d", "sr_bm3d"):
        check(all(abs(a_ - b_) < RESTORE_DB for a_, b_ in zip(rq[k], JAX_RESTORE_PSNR[k])),
              f"{k}: PSNR {rq[k]} vs the JAX package's {JAX_RESTORE_PSNR[k]} (+- {RESTORE_DB} dB)")
    for k, base in (("deblur_bm3d", "deblur_degraded"), ("sr_bm3d", "sr_kron")):
        check(all(a_ > b_ for a_, b_ in zip(rq[k], rq[base])), f"{k}: PSNR {rq[k]} not above {base} {rq[base]}")
    # float32 against float64 on the card: DRUNet (seeded weights), 2 iterations, 2 images
    f3264 = {}
    for k, fn, nz in (("deblur", experiments.deblur_batch, noise_deblur), ("sr", experiments.sr_batch, noise_sr)):
        outs = [fn(x4[:2], denoise=seeded_drunet(2, 2.0, dt_), iter_num=2, nlm=2.0, noise=nz[:2], dtype=dt_)[1]
                for dt_ in (torch.float32, torch.float64)]
        f3264[k] = float((outs[0].double() - outs[1]).abs().max())
    check(all(v < RESTORE_DRUNET_ATOL for v in f3264.values()),
          f"restoration with DRUNet, float32 vs float64 on the card: {f3264} (limit {RESTORE_DRUNET_ATOL})")
    # the operators, float32 on the card against float64 on the CPU, at the last rung's rho
    k_ani = experiments.make_blur_kernel("aniso")
    k_sr = sisr.anisotropic_gaussian(ksize=9, theta=0.7, l1=2.5, l2=1.0)
    y_d, y_s = degraded["deblur_bm3d"], degraded["sr_bm3d"]
    rho_d = float(schedules.get_rho_sigma(sigma=2.55 / 255.0, iter_num=8, model_sigma2=2.55)[0][-1])
    rho_s = float(schedules.get_rho_sigma(sigma=1.5 / 255.0, iter_num=8, model_sigma2=2.0)[0][-1])
    op_err = {}
    for name, fn in (
        ("wrap_convolve", lambda yy, zz, k_: sisr.wrap_convolve(zz, torch.as_tensor(k_ani, dtype=zz.dtype,
                                                                                    device=zz.device))),
        ("deblur_solution", lambda yy, zz, k_: sisr.deblur_solution(zz, *sisr.pre_calculate(yy, k_, 1)[2:], rho_d)),
        ("data_solution", lambda yy, zz, k_: sisr.data_solution(zz, *sisr.pre_calculate(yy, k_, 2), rho_s, 2)),
    ):
        yy = y_s if name == "data_solution" else y_d
        k_ = torch.as_tensor(k_sr if name == "data_solution" else k_ani)
        on_card = fn(yy, x4, k_.float().to(dev))
        on_cpu = fn(yy.double().cpu(), x4.double().cpu(), k_.double())
        op_err[name] = float((on_card.double().cpu() - on_cpu).abs().max())
    check(all(v < 1e-5 for v in op_err.values()), f"sisr operators, float32 card vs float64 CPU: {op_err}")
    # one iteration's data solve against the denoiser call
    f2b_d, fbfy_d = sisr.pre_calculate(y_d, torch.as_tensor(k_ani, dtype=torch.float32, device=dev), 1)[2:]
    spectra_s = sisr.pre_calculate(y_s, torch.as_tensor(k_sr, dtype=torch.float32, device=dev), 2)
    lad_d = schedules.get_rho_sigma(sigma=2.55 / 255.0, iter_num=8, model_sigma2=2.55)[1]
    den_bm3d = bm3d_prior.make_bm3d_ladder_denoiser(lad_d)
    xin = restored["deblur_bm3d"]
    restore_ms["deblur_solution"] = cuda_ms(lambda: sisr.deblur_solution(xin, f2b_d, fbfy_d, rho_d), inner=10)
    restore_ms["data_solution_sr2"] = cuda_ms(lambda: sisr.data_solution(xin, *spectra_s, rho_s, 2), inner=10)
    restore_ms["bm3d_ladder_call"] = cuda_ms(lambda: den_bm3d(xin, 7))
    restore_ms["drunet_call"] = cuda_ms(lambda: den_dru(xin, 7))
    log(f"restore: classical kernel launches {json.dumps(restore_launches)}; PSNR per image (dB, clipped to [0, 1]; "
        "the JAX package on the CPU, float32, in brackets) " + "; ".join(
            f"{k} {[round(v, 3) for v in rq[k]]}" + (f" [{JAX_RESTORE_PSNR[k]}]" if k in JAX_RESTORE_PSNR else "")
            for k in rq) + f" (DRUNet: seeded weights, no quality claimed); DRUNet float32 vs float64 on the card, "
        f"2 iterations, 2 x {H} x {W}: {json.dumps(f3264)} (limit {RESTORE_DRUNET_ATOL}); sisr operators float32 "
        f"card vs float64 CPU at the last rung's rho: {json.dumps(op_err)}")
    log(f"timing restore ({PNP_B} x {H} x {W}, float32, 8 iterations, CUDA events, ms): {json.dumps(restore_ms)}; "
        f"an iteration: deblur BM3D {restore_ms['deblur_bm3d'] / 8:.3f} (data solve "
        f"{restore_ms['deblur_solution']:.4f} = {restore_ms['deblur_solution'] / restore_ms['bm3d_ladder_call']:.2%} "
        f"of the BM3D call), deblur DRUNet {restore_ms['deblur_drunet'] / 8:.3f} (data solve "
        f"{restore_ms['deblur_solution'] / restore_ms['drunet_call']:.2%} of the forward), SR BM3D "
        f"{restore_ms['sr_bm3d'] / 8:.3f}, SR DRUNet {restore_ms['sr_drunet'] / 8:.3f} (SR data solve "
        f"{restore_ms['data_solution_sr2']:.4f})")
    del restored, degraded, den_bm3d, den_dru, xin
    phase("restore", t)

    # -- bm3d_colored: the colored-noise core and the BM3D API -----------------
    t = time.perf_counter()
    tail_kernels.reset_launches()
    fused_dc.reset_launches()
    kernels_fam = {f: noise.get_experiment_kernel(f, 0.02, (H, W)) for f in COLORED_FAMILIES}
    psds = {f: noise.experiment_psd(k_, (H, W)) for f, k_ in kernels_fam.items()}
    x4np = phantom.mri_phantoms(PNP_B, H, seed=0)

    def colored_batch(fam, n=H):
        return np.stack([x4np[r, :n, :n] + noise.synth_colored_noise((n, n), kernels_fam[fam], seed=r)
                         for r in range(PNP_B)])

    # 1. float64 on the card against the port's CPU run, 4 x 64 x 64 (g1, exact, explicit parameters)
    zc_s = colored_batch("g1", 64)
    psd_s = noise.experiment_psd(kernels_fam["g1"], (64, 64))
    col_card = bm3d_core.bm3d_colored_auto(torch.from_numpy(zc_s).to(dev), psd_s, auto_params=False)
    col_cpu = bm3d_core.bm3d_colored_auto(torch.from_numpy(zc_s), psd_s, auto_params=False, device="cpu")
    col_f64 = float((col_card.cpu() - col_cpu).abs().max())
    check(col_f64 < 1e-9, f"bm3d_colored float64 on the card vs the CPU: {col_f64}")
    p_ = bm3d_core.DEFAULT_PROFILE
    stds_s = bm3d_core.psd_to_coeff_stds(psd_s, p_.transform_ht)
    cov_s = bm3d_core.coeff_cov_field(psd_s, p_.transform_ht)
    ms_s = float(np.sqrt(psd_s.mean() / 64**2))
    col_pilots = {d_: bm3d_core.ht_stage_colored(torch.from_numpy(zc_s).to(d_), stds_s, ms_s, cov_field=cov_s)
                  for d_ in (dev, torch.device("cpu"))}
    for stage, src, k in (("ht", lambda d_: torch.from_numpy(zc_s).to(d_), p_.max_3d_ht),
                          ("wiener", lambda d_: col_pilots[d_], p_.max_3d_wie)):
        got, want = matches(src(dev), k, taus[stage]), matches(src(torch.device("cpu")), k, taus[stage])
        check(all(torch.equal(a_.cpu(), b_) for a_, b_ in zip(got, want)),
              f"bm3d_colored float64: the {stage} stage's matches differ between the card and the CPU")
    # 2.-4. the colored runs at 4 x 256 x 256, float32, the classical kernels' counts at 0
    zc = {f: torch.from_numpy(colored_batch(f).astype(np.float32)).to(dev) for f in COLORED_FAMILIES}
    col_ms = {}

    def timed_c(name, fn):
        res, col_ms[name] = event_ms(fn)
        return res

    col_out = {f: timed_c(f"exact_{f}", lambda f=f: bm3d_core.bm3d_colored_auto(zc[f], psds[f], auto_params=False))
               for f in COLORED_FAMILIES}
    col_out["g1_approx"] = timed_c("approx_g1", lambda: bm3d_core.bm3d_colored(zc["g1"], psds["g1"], exact=False))
    check(torch.equal(bm3d_core.bm3d_colored_auto(zc["g1"], psds["g1"], auto_params=False), col_out["g1"]),
          "bm3d_colored: two calls at 4 x 256 x 256 differ")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        col_tf32 = bm3d_core.bm3d_colored_auto(zc["g1"], psds["g1"], auto_params=False)
        check(torch.backends.cuda.matmul.allow_tf32, "bm3d_colored did not give the caller's TF32 setting back")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(torch.equal(col_tf32, col_out["g1"]), "bm3d_colored: TF32 on in the process changed the output")
    x4c = torch.from_numpy(x4np).to(dev)

    def psnr0(a):
        return float(metrics.psnr(a[0].clamp(0.0, 1.0) * 255.0, x4c[0] * 255.0))

    cq = {f"noisy_{f}": psnr0(zc[f]) for f in COLORED_FAMILIES}
    cq.update({f"exact_{f}": psnr0(col_out[f]) for f in COLORED_FAMILIES})
    cq["approx_g1"] = psnr0(col_out["g1_approx"])
    for k, v in cq.items():
        check(abs(v - JAX_COLORED_PSNR[k]) < RESTORE_DB, f"bm3d_colored {k}: image 0 at {v} dB vs the JAX "
              f"package's {JAX_COLORED_PSNR[k]} (+- {RESTORE_DB} dB)")
    for k_, out in col_out.items():
        check(tuple(out.shape) == (PNP_B, H, W) and bool(torch.isfinite(out).all()), f"bm3d_colored {k_}: bad output")
    # 5. the API routes, single runs on the phantoms with white noise
    sig_w = 0.1
    zw = torch.from_numpy((x4np + sig_w * np.random.default_rng(9).standard_normal(x4np.shape))
                          .astype(np.float32)).to(dev)
    rgb = torch.from_numpy(np.stack([x4np[c] for c in range(3)], axis=-1)
                           + sig_w * np.random.default_rng(10).standard_normal((H, W, 3))).float().to(dev)
    psf = experiments.make_blur_kernel("aniso")
    zb = (sisr.wrap_convolve(x4c, torch.as_tensor(psf, dtype=torch.float32, device=dev))
          + 0.01 * torch.from_numpy(np.random.default_rng(11).standard_normal((PNP_B, H, W))).float().to(dev))
    pilot_w = bm3d_core.ht_stage(zw, sig_w)
    y_bm, bm_ht, bm_wie = bm3d_api.bm3d_with_blockmatches(zw, sig_w)
    routes = {
        "bm3d_flat_psd": timed_c("api_bm3d_flat_psd",
                                 lambda: bm3d_api.bm3d(zw, noise.white_noise_psd((H, W), sig_w**2))),
        "bm3d_stage_arg": bm3d_api.bm3d(zw, sig_w, stage_arg=pilot_w),
        "bm3d_with_blockmatches": y_bm,
        "bm3d_with_blockmatches_reused": timed_c("api_blockmatches_reused", lambda: bm3d_api.bm3d_with_blockmatches(
            zw, sig_w, bm_ht=bm_ht, bm_wie=bm_wie)[0]),
        "bm3d_refilter": timed_c("api_refilter", lambda: bm3d_api.bm3d_refilter(zw, sig_w)),
        "bm3d_deblurring": bm3d_api.bm3d_deblurring(zb, 0.01, psf, colored=False),
    }
    check(torch.equal(routes["bm3d_with_blockmatches_reused"], y_bm), "bm3d_with_blockmatches: reuse changed the output")
    check(torch.equal(routes["bm3d_flat_psd"], bm3d_core.bm3d(zw, sig_w)), "api.bm3d: a flat PSD is not the white path")
    rgb_out = {"bm3d_rgb": bm3d_api.bm3d_rgb(rgb, sig_w), "bm3d_multichannel": bm3d_api.bm3d_multichannel(rgb, sig_w)}
    torch.cuda.synchronize()
    col_launches = {"l1_tail": tail_kernels.l1_tail.launches, "cnc_tail": tail_kernels.cnc_tail.launches,
                    "fused_iteration": fused_dc.fused_iteration.launches}
    check(col_launches == dict.fromkeys(col_launches, 0), f"the colored BM3D paths launched a classical kernel: "
          f"{col_launches}")
    rgb_truth = rgb.new_tensor(np.stack([x4np[c] for c in range(3)], axis=-1))
    api_q = {}
    for k, out in routes.items():
        ref_in = zb if k == "bm3d_deblurring" else zw
        check(out.shape == ref_in.shape and bool(torch.isfinite(out).all()), f"{k}: bad output")
        api_q[k] = float(metrics.psnr(out.clamp(0, 1) * 255.0, x4c * 255.0).mean())
    api_q["noisy"] = float(metrics.psnr(zw.clamp(0, 1) * 255.0, x4c * 255.0).mean())
    api_q["blurred"] = float(metrics.psnr(zb.clamp(0, 1) * 255.0, x4c * 255.0).mean())
    for k, out in rgb_out.items():
        check(out.shape == rgb.shape and bool(torch.isfinite(out).all()), f"{k}: bad output")
        api_q[k] = float(metrics.psnr(out.movedim(-1, 0).clamp(0, 1) * 255.0, rgb_truth.movedim(-1, 0) * 255.0).mean())
    api_q["noisy_rgb"] = float(metrics.psnr(rgb.movedim(-1, 0).clamp(0, 1) * 255.0,
                                            rgb_truth.movedim(-1, 0) * 255.0).mean())
    for k in routes:
        if k != "bm3d_deblurring":
            check(api_q[k] > api_q["noisy"], f"{k}: mean PSNR {api_q[k]} not above its input's")
    deb_q = metrics.psnr(routes["bm3d_deblurring"].clamp(0, 1) * 255.0, x4c * 255.0).tolist()
    check(all(abs(a_ - b_) < RESTORE_DB for a_, b_ in zip(deb_q, JAX_DEBLURRING_WHITE_PSNR)),
          f"bm3d_deblurring: PSNR {deb_q} vs the JAX package's {JAX_DEBLURRING_WHITE_PSNR}")
    for k in rgb_out:
        check(api_q[k] > api_q["noisy_rgb"], f"{k}: mean PSNR {api_q[k]} not above its input's")
    # 6. a call by stage and its peak memory (g1, exact)
    zg1, psd_g1 = zc["g1"], np.maximum(psds["g1"], float(np.mean(psds["g1"])) * 1e-3 + 1e-20)
    t_h = time.perf_counter()
    stds_ht = bm3d_core.psd_to_coeff_stds(psd_g1, p_.transform_ht)
    stds_wie = bm3d_core.psd_to_coeff_stds(psd_g1, p_.transform_wie)
    cov_ht = bm3d_core.coeff_cov_field(psd_g1, p_.transform_ht)
    cov_wie = bm3d_core.coeff_cov_field(psd_g1, p_.transform_wie)
    col_ms["host_stds_and_covariance_fields"] = (time.perf_counter() - t_h) * 1e3
    ms_g1 = float(np.sqrt(psd_g1.mean() / (H * W)))
    pilot_c = bm3d_core.ht_stage_colored(zg1, stds_ht, ms_g1, cov_field=cov_ht)
    col_ms["ht_stage_colored_exact"] = cuda_ms(lambda: bm3d_core.ht_stage_colored(zg1, stds_ht, ms_g1,
                                                                                    cov_field=cov_ht), reps=3)
    col_ms["wiener_stage_colored_exact"] = cuda_ms(lambda: bm3d_core.wiener_stage_colored(zg1, pilot_c, stds_wie,
                                                                                            cov_field=cov_wie), reps=3)
    col_ms["call_exact_g1"] = cuda_ms(lambda: bm3d_core.bm3d_colored_auto(zg1, psds["g1"], auto_params=False), reps=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    bm3d_core.bm3d_colored_auto(zg1, psds["g1"], auto_params=False)
    torch.cuda.synchronize()
    col_peak = torch.cuda.max_memory_allocated() - base_mem
    log(f"bm3d_colored: float64 card vs CPU {col_f64:.3g} (4x64x64, g1, exact; HT and Wiener matches identical); "
        f"two calls at {PNP_B}x{H}x{W} bit-equal; TF32 on in the process: bit-equal; classical kernel launches "
        f"{json.dumps(col_launches)}; image 0 PSNR (dB, clipped; the JAX package on the CPU in brackets) "
        + ", ".join(f"{k} {v:.3f} [{JAX_COLORED_PSNR[k]}]" for k, v in cq.items())
        + f"; API routes, mean PSNR over the batch (dB): {json.dumps({k: round(v, 3) for k, v in api_q.items()})}"
        + f"; bm3d_deblurring per image {[round(v, 3) for v in deb_q]} [{JAX_DEBLURRING_WHITE_PSNR}]")
    log(f"timing bm3d_colored ({PNP_B} x {H} x {W}, float32, profile 'np', explicit parameters, CUDA events, ms; "
        f"the host's PSD work on its clock): {json.dumps(col_ms)}; peak memory of one exact call above what was "
        f"allocated {col_peak / 2**20:.1f} MiB")
    del zc, col_out, col_tf32, routes, rgb_out, pilot_c, col_pilots, col_card
    phase("bm3d_colored", t)

    # -- experiments and sweep: the MRI workflow from files, in a temporary directory --
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t = time.perf_counter()
        tdir, ddir = write_mri_assets(tmp, img_np, (H, W))
        log(f"experiments: wrote {B} PNGs, 3 masks and noises.mat in {time.perf_counter() - t:.2f} s")
        rates.update({f"run_{k}": v for k, v in phase_experiments(dev, tmp, tdir, ddir).items()})
        phase("experiments", t)
        t = time.perf_counter()
        sweep_res = phase_sweep(dev, tmp, tdir, ddir, y, mask)
        phase("sweep", t)
        t = time.perf_counter()
        rates["train"] = phase_train(dev, tmp, tdir)
        phase("train", t)
        t = time.perf_counter()
        rates["cli"] = phase_cli(dev, tmp, tdir, ddir)
        phase("cli", t)
        t = time.perf_counter()
        cat_res = phase_catalog(dev, tmp, tdir, ddir, img_np, y, mask)
        rates["catalog"] = {k: v for k, v in cat_res.items() if k != "launches"}
        phase("catalog", t)
        t = time.perf_counter()
        ex_res = phase_examples(tmp)
        rates["examples"] = {k: ex_res[k] for k in ("wall_s", "psnr")}
        phase("examples", t)
        t = time.perf_counter()
        dist_res = phase_distributed(dev, tmp, tdir, ddir, img_np, sweep_res)
        phase("distributed", t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- timing ----------------------------------------------------------------
    t = time.perf_counter()
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
            "distributed_launches": {k: v[0][name] for k, v in dist_res["launches"]["w1"].items()},
            "catalog_launches": {k: v[name] for k, v in cat_res["launches"].items()},
            "examples_launches": {k: v[name] for k, v in ex_res["launches"].items()},
        })
    # the fused iteration at the path's shape, from the scenario's initial state
    for label, design in (("admm_l1_fused_kernel", None), ("admm_l1_fused_kernel_strips", "strips")):
        ms = cuda_ms(lambda: fused_dc.admm_l1_fused_kernel(y, mask, cfg_l1, design=design),
                     reps=5 if design is None else 3)
        rates[label] = {"solve_ms": ms, "image_iters_per_s": B * ITERS / (ms / 1e3)}
    init = admm.init_state(y)
    z0, w0 = init.z, init.w
    cluster_step, strip_step = steps["512x256x256", "cluster"], steps["512x256x256", "strips"]
    dc = fourier.make_rfft_data_consistency(y, mask, cfg_l1.rho, method="fft")
    # the yardstick: one iteration of admm_l1(fused=True), cuFFT and the l1_tail kernel
    contenders = {
        "cluster": lambda: cluster_step(z0, w0),
        "strips": lambda: strip_step(z0, w0),
        "cufft_iteration": lambda: tail_kernels.l1_tail(dc(z0 - w0), z0, w0, thr),
    }
    order = [*contenders, *reversed(contenders)]  # in turns: cluster, strips, cuFFT, cuFFT, strips, cluster
    runs = {k: [] for k in contenders}
    for k in order:
        runs[k].append(cuda_ms(contenders[k], inner=5 if k != "strips" else 2))
    step_ms = {k: statistics.mean(v) for k, v in runs.items()}
    k3_plain_ms = cuda_ms(lambda: plain_step(cluster_step, z0, w0), inner=2)
    z1, w1 = torch.empty_like(z0), torch.empty_like(z0)
    stages = {name.split("_")[2]: cuda_ms(lambda: fused_dc.launch(name, dev, *args), inner=2)
              for name, args in fused_dc.stage_launches(strip_step.fields, z0, w0, z1, w1)}
    active = fused_dc.load_cluster_library().admm_iteration_cluster_active(H, W, q_main)
    wh = W // 2 + 1
    # the least work of the function: two half-spectrum FFTs (5 H W log2(H W)
    # flops for both), the blend (4 a bin), v = z - w, |.|, soft and the dual
    # (10 a pixel); bytes: z, w in, z', w' out, Cr, Ci in, A once
    k3_flops = B * (5 * H * W * math.log2(H * W) + 4 * H * wh + 10 * H * W)
    k3_bytes = 4 * (4 * B * H * W + 2 * B * H * wh + H * wh)
    k3_bytes_ms, k3_ops_ms = k3_bytes / HBM_BYTES_PER_S * 1e3, k3_flops / FP32_FLOPS * 1e3
    k3_bound = max(k3_bytes_ms, k3_ops_ms)
    # the floor of the strip design's dense DFT products: rows 2 x (H W Wh),
    # columns 8 x (H H Wh), synthesis 2 x (H Wh W), 2 flops each
    dense_ms = B * (8 * H * W * wh + 16 * H * H * wh) / FP32_FLOPS * 1e3
    log(f"timing: fused_iteration per step at 512x256x256 (ms, two passes in turns): {json.dumps(runs)}; "
        f"cluster {step_ms['cluster']:.4f} ms = {k3_bytes / step_ms['cluster'] / 1e6:.1f} GB/s, "
        f"{k3_bound / step_ms['cluster']:.1%} of the {k3_bound:.4f} ms bound ({k3_bytes / 1e9:.3f} GB, "
        f"{k3_flops / 1e9:.2f} GFLOP), Q {q_main}, {active} clusters resident; strips {step_ms['strips']:.4f} ms "
        f"(stages {json.dumps(stages)}; strip {strip_step.fields.strip}; its dense products' floor "
        f"{dense_ms:.4f} ms); cuFFT iteration {step_ms['cufft_iteration']:.4f} ms; plain {k3_plain_ms:.4f} ms")
    # the mixed design at 512 x 320 x 320, from that path's initial state, with
    # the strip design and the cuFFT iteration at the same shape
    _, y320, mask320 = field_of_view(img)
    init320 = admm.init_state(y320)
    z3, w3 = init320.z, init320.w
    mixed_step, strip320 = make(y320, mask320), make(y320, mask320, "strips")
    dc320 = fourier.make_rfft_data_consistency(y320, mask320, cfg_l1.rho, method="fft")
    contenders = {
        "mixed": lambda: mixed_step(z3, w3),
        "strips": lambda: strip320(z3, w3),
        "cufft_iteration": lambda: tail_kernels.l1_tail(dc320(z3 - w3), z3, w3, thr),
    }
    runs320 = {k: [] for k in contenders}
    for k in [*contenders, *reversed(contenders)]:
        runs320[k].append(cuda_ms(contenders[k], inner=5 if k != "strips" else 2))
    step320_ms = {k: statistics.mean(v) for k, v in runs320.items()}
    mixed_plain_ms = cuda_ms(lambda: plain_step(mixed_step, z3, w3), inner=2)
    side, q320 = MIXED_SIDE, mixed_step.fields.q
    active320 = fused_dc.mixed_active(dev, side, side, q320)
    wh3 = side // 2 + 1
    m_flops = B * (5 * side * side * math.log2(side * side) + 4 * side * wh3 + 10 * side * side)
    m_bytes = 4 * (4 * B * side * side + 2 * B * side * wh3 + side * wh3)
    m_bytes_ms, m_ops_ms = m_bytes / HBM_BYTES_PER_S * 1e3, m_flops / FP32_FLOPS * 1e3
    m_bound = max(m_bytes_ms, m_ops_ms)
    m_dense_ms = B * (8 * side * side * wh3 + 16 * side * side * wh3) / FP32_FLOPS * 1e3
    log(f"timing: fused_iteration per step at 512x{side}x{side} (ms, two passes in turns): {json.dumps(runs320)}; "
        f"mixed {step320_ms['mixed']:.4f} ms = {m_bytes / step320_ms['mixed'] / 1e6:.1f} GB/s, "
        f"{m_bound / step320_ms['mixed']:.1%} of the {m_bound:.4f} ms bound ({m_bytes / 1e9:.3f} GB, "
        f"{m_flops / 1e9:.2f} GFLOP), Q {q320}, {active320} clusters resident, "
        f"{fused_dc.mixed_smem(side, side, q320)} B a block; strips {step320_ms['strips']:.4f} ms (their dense "
        f"products' floor {m_dense_ms:.4f} ms); cuFFT iteration {step320_ms['cufft_iteration']:.4f} ms; "
        f"plain {mixed_plain_ms:.4f} ms")
    del y320, mask320, init320, z3, w3, mixed_step, strip320, dc320, contenders
    k3 = {"cluster": (CLUSTER_SOURCE, step_ms["cluster"], k3_plain_ms, k3_bytes_ms, k3_ops_ms),
          "mixed": (MIXED_SOURCE, step320_ms["mixed"], mixed_plain_ms, m_bytes_ms, m_ops_ms),
          "strips": (FUSED_SOURCE, step_ms["strips"], k3_plain_ms, k3_bytes_ms, k3_ops_ms)}
    for design, (source, ms, plain_ms, bytes_ms, ops_ms) in k3.items():
        kernels.append({
            "name": f"fused_iteration_{design}", "route": "cuda", "source": source, "replaces": FUSED_REPLACES,
            "launches": launches[f"fused_iteration_{design}"], "max_abs_err": fused_err[design],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "distributed_launches": {k: v[0]["fused_iteration"] for k, v in dist_res["launches"]["w1"].items()},
            "catalog_launches": {k: v["fused_iteration"] for k, v in cat_res["launches"].items()},
            "examples_launches": {k: v["fused_iteration"] for k, v in ex_res["launches"].items()},
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
