"""Grayscale BM3D demo with spatially correlated noise.

Counterpart of the reference's ``bm3d307/examples/bm3d_demo_grayscale.py``:
generate stationary colored noise from one of the g* experiment kernels,
denoise with the full PSD (exact-variance colored core), report PSNR. The
colored families (g1-g4 and their w mixes) need the reference's
``param_matching_data.mat`` (``PNPADMM_BM3D_PARAMS``); gw and g0 are white.

    python -m pnp_admm_cnc_mri_torch.examples.bm3d_grayscale [--noise g3] [--var 0.02] [--size 128] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.examples import add_device_flags, device_and_dtype, reference_example_file


def load_scene(size: int) -> np.ndarray:
    """cameraman256 when the reference assets are mounted, else a synthetic
    piecewise scene."""
    cam = reference_example_file("cameraman256.png")
    if os.path.exists(cam):
        from pnp_admm_cnc_mri_torch.data import images

        y = images.imread_gray(cam).astype(np.float64) / 255.0
        return y[:size, :size]
    yy, xx = np.mgrid[:size, :size] / size
    y = 0.3 + 0.4 * (np.sin(7 * yy) * np.cos(5 * xx) > 0)
    y[size // 4: size // 2, size // 4: size // 2] += 0.2
    return y


def psnr(a, b) -> float:
    return float(10 * np.log10(1.0 / np.mean((a - b) ** 2)))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--noise", default="g3",
                   help="gw/g0/g1/g2/g3/g4 or g1w..g4w (experiment kernels)")
    p.add_argument("--var", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--size", type=int, default=128)
    add_device_flags(p)
    args = p.parse_args(argv)
    device, dtype = device_and_dtype(args)

    from pnp_admm_cnc_mri_torch.data import noise as noise_mod
    from pnp_admm_cnc_mri_torch.priors.bm3d import api

    y = load_scene(args.size)
    kernel = noise_mod.get_experiment_kernel(args.noise, args.var, (args.size, args.size))
    n = noise_mod.synth_colored_noise(y.shape, kernel, seed=args.seed)
    psd = noise_mod.experiment_psd(kernel, y.shape)
    z = y + n

    y_est = api.bm3d(torch.as_tensor(z, dtype=dtype, device=device), psd, device=device).cpu().numpy()

    out = {"noisy": psnr(z, y), "denoised": psnr(y_est, y)}
    print(f"noise={args.noise} var={args.var}")
    print(f"noisy PSNR:    {out['noisy']:.2f} dB")
    print(f"denoised PSNR: {out['denoised']:.2f} dB")
    return out


if __name__ == "__main__":
    main()
