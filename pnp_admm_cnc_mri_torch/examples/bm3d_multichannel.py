"""Multichannel BM3D demo: block matching on the first channel only.

Counterpart of the reference's
``bm3d307/examples/bm3d_demo_multichannel.py`` (BrainWeb slice stack when
the reference assets are mounted; synthetic channels otherwise).

    python -m pnp_admm_cnc_mri_torch.examples.bm3d_multichannel [--sigma 0.14] [--size 128] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.examples import add_device_flags, device_and_dtype, reference_example_file
from pnp_admm_cnc_mri_torch.examples.bm3d_grayscale import load_scene


def load_channels(size: int) -> np.ndarray:
    mat = reference_example_file("brainslice.mat")
    if os.path.exists(mat):
        import scipy.io as sio

        y = np.asarray(sio.loadmat(mat)["slice_sample"], np.float64)
        y = y / max(y.max(), 1e-9)
        return y[:size, :size]
    base = load_scene(size)
    return np.stack([base, 0.6 * base + 0.2, 1.0 - base], axis=-1)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--sigma", type=float, default=0.14)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p)
    args = p.parse_args(argv)
    device, dtype = device_and_dtype(args)

    from pnp_admm_cnc_mri_torch.priors.bm3d import api

    rng = np.random.default_rng(args.seed)
    y = load_channels(args.size)
    z = y + args.sigma * rng.standard_normal(y.shape)

    y_est = api.bm3d_multichannel(torch.as_tensor(z, dtype=dtype, device=device), args.sigma,
                                  device=device).cpu().numpy()

    def psnr(a, b):
        return float(10 * np.log10(np.ptp(y) ** 2 / np.mean((a - b) ** 2)))

    out = {"noisy": psnr(z, y), "denoised": psnr(y_est, y)}
    print(f"channels: {y.shape[-1]}")
    print(f"noisy PSNR:    {out['noisy']:.2f} dB")
    print(f"denoised PSNR: {out['denoised']:.2f} dB")
    return out


if __name__ == "__main__":
    main()
