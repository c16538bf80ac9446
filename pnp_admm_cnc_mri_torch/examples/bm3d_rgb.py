"""Color BM3D demo (opponent-space, shared luminance matching).

Counterpart of the reference's ``bm3d307/examples/bm3d_demo_rgb.py`` on
the white-noise path.

    python -m pnp_admm_cnc_mri_torch.examples.bm3d_rgb [--sigma 0.1] [--size 128] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.examples import add_device_flags, device_and_dtype, reference_example_file
from pnp_admm_cnc_mri_torch.examples.bm3d_grayscale import psnr


def load_rgb(size: int) -> np.ndarray:
    """The reference's Lena (through PIL) when its assets are mounted, else
    three synthetic channels."""
    lena = reference_example_file("image_Lena512rgb.png")
    if os.path.exists(lena):
        try:
            from PIL import Image

            y = np.asarray(Image.open(lena), np.float64)[:size, :size] / 255.0
            if y.ndim == 3 and y.shape[2] >= 3:
                return y[..., :3]
        except (ImportError, OSError):
            pass
    yy, xx = np.mgrid[:size, :size] / size
    return np.stack([
        0.4 + 0.3 * np.sin(6 * yy),
        0.5 + 0.3 * np.cos(4 * xx),
        0.3 + 0.4 * ((yy + xx) % 0.3 > 0.15),
    ], axis=-1)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--sigma", type=float, default=0.1)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p)
    args = p.parse_args(argv)
    device, dtype = device_and_dtype(args)

    from pnp_admm_cnc_mri_torch.priors.bm3d import api

    rng = np.random.default_rng(args.seed)
    y = load_rgb(args.size)
    z = y + args.sigma * rng.standard_normal(y.shape)

    y_est = api.bm3d_rgb(torch.as_tensor(z, dtype=dtype, device=device), args.sigma, device=device).cpu().numpy()

    out = {"noisy": psnr(z, y), "denoised": psnr(y_est, y)}
    print(f"noisy PSNR:    {out['noisy']:.2f} dB")
    print(f"denoised PSNR: {out['denoised']:.2f} dB")
    return out


if __name__ == "__main__":
    main()
