#!/usr/bin/env python3
"""How far the 50-iteration PnP-ADMM-BM3D solves move under a 1e-6 nudge.

    python3 probes/bm3d_chaos.py port [RUNS]     (on a CUDA card: the port)
    python3 probes/bm3d_chaos.py jax [RUNS]      (on the CPU: the JAX package)

The scenario of ``chip_smoke.py``'s bm3d phase: phantoms seed 0,
``random_mask(0.3, seed 1)``, ``synth_noise(3.0, seed 2)``, float32,
``PNP_L1_BM3D_DEFAULT`` and ``PNP_CNC_BM3D_DEFAULT`` with
``make_bm3d_denoiser()``, ``clamp=False``. Run 0 solves the scenario as it
is; run s > 0 adds 1e-6 N(0, 1) (numpy seed 100 + s) to the images before
the k-space is formed. Prints each run's PSNR per image and, per pipeline
and image, the spread over the runs. ``port`` solves the 4 images of the
smoke's batch on the card; ``jax`` solves image 0 alone (the JAX package
takes about a minute a solve on the CPU). The k-space of both is formed by
the port's ``fourier.observe`` on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_admm_cnc_mri_torch import config  # noqa: E402
from pnp_admm_cnc_mri_torch.data import masks, noise, phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.ops import fourier  # noqa: E402

H = W = 256
EPS = 1e-6


def scenario(n_img: int, run: int):
    """(clean images in float64, mask, k-space) of one run."""
    img = phantom.mri_phantoms(n_img, H, seed=0)
    nudged = img
    if run:
        nudged = (img + EPS * np.random.default_rng(100 + run).standard_normal(img.shape)).astype(np.float32)
    mask = masks.random_mask((H, W), fraction=0.3, seed=1).astype(np.float32)
    nz = noise.synth_noise((H, W), std=3.0, seed=2).astype(np.complex64)
    y = fourier.observe(torch.from_numpy(nudged), torch.from_numpy(mask), torch.from_numpy(nz)).numpy()
    return img.astype(np.float64), mask, y


def psnr(x, ref):
    d = (np.asarray(x, np.float64) - ref) * 255.0
    return [float(20 * np.log10(255.0 / np.sqrt(np.mean(di * di)))) for di in d]


def solve_port(y, mask, scheme):
    from pnp_admm_cnc_mri_torch.priors import bm3d_prior
    from pnp_admm_cnc_mri_torch.solvers import admm

    den = bm3d_prior.make_bm3d_denoiser()
    if scheme == "l1":
        st = admm.pnp_admm_l1(y, mask, config.PNP_L1_BM3D_DEFAULT, den, clamp=False)[0]
    else:
        st = admm.pnp_admm_cnc(y, mask, config.PNP_CNC_BM3D_DEFAULT, den, clamp=False)[0]
    return st.x.cpu().numpy()


def solve_jax(y, mask, scheme):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from pnp_admm_cnc_mri_tpu import config as jconfig
    from pnp_admm_cnc_mri_tpu.priors import bm3d_prior
    from pnp_admm_cnc_mri_tpu.solvers import admm

    den = bm3d_prior.make_bm3d_denoiser()
    cfg = jconfig.PNP_L1_BM3D_DEFAULT if scheme == "l1" else jconfig.PNP_CNC_BM3D_DEFAULT
    run = admm.pnp_admm_l1 if scheme == "l1" else admm.pnp_admm_cnc
    st = run(jnp.asarray(y), jnp.asarray(mask), cfg, den, clamp=False, dtype=jnp.float32)[0]
    return np.asarray(jax.block_until_ready(st.x))


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "port"
    n_runs = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    if which == "port":
        if not torch.cuda.is_available():
            raise SystemExit("bm3d_chaos: 'port' needs a CUDA card")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(f"nvidia-smi: {smi}; torch {torch.__version__}")
        n_img, solve = 4, solve_port
    elif which == "jax":
        print("the JAX package on the CPU, image 0")
        n_img, solve = 1, solve_jax
    else:
        raise SystemExit(f"bm3d_chaos: unknown target {which!r}; 'port' or 'jax'")
    runs = {"l1": [], "cnc": []}
    for scheme, rs in runs.items():
        for run in range(n_runs):
            ref, mask, y = scenario(n_img, run)
            t0 = time.perf_counter()
            rs.append(psnr(solve(y, mask, scheme), ref))
            print(f"{which} {scheme} run {run}: PSNR {[round(v, 4) for v in rs[-1]]} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for scheme, rs in runs.items():
        a = np.array(rs)
        for i in range(n_img):
            print(f"{which} {scheme} image {i}: run 0 {a[0, i]:.4f} dB; over {n_runs} runs min {a[:, i].min():.4f} "
                  f"max {a[:, i].max():.4f} spread {a[:, i].max() - a[:, i].min():.4f} mean {a[:, i].mean():.4f}")


if __name__ == "__main__":
    main()
