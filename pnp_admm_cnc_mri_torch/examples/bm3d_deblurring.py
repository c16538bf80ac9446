"""BM3D deblurring demo (regularized inverse + colored-residual BM3D).

Counterpart of the reference's ``bm3d307/examples/bm3d_demo_deblurring.py``
experiment 4 (separable [1,4,6,4,1] blur, sigma = 7/255). The colored
residual's parameters come from the reference's ``param_matching_data.mat``
(``PNPADMM_BM3D_PARAMS``); without it the run raises.

    python -m pnp_admm_cnc_mri_torch.examples.bm3d_deblurring [--size 128] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.examples import add_device_flags, device_and_dtype
from pnp_admm_cnc_mri_torch.examples.bm3d_grayscale import load_scene, psnr


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p)
    args = p.parse_args(argv)
    device, dtype = device_and_dtype(args)

    from pnp_admm_cnc_mri_torch.ops import sisr
    from pnp_admm_cnc_mri_torch.priors.bm3d import api

    y = load_scene(args.size)
    v = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float64)
    v /= v.sum()
    sigma = 7.0 / 255.0

    rng = np.random.default_rng(args.seed)
    # the circular correlation on the host, in float64 (scipy.ndimage.correlate(mode="wrap"))
    z = sisr.wrap_correlate(torch.from_numpy(y), v).numpy() + sigma * rng.standard_normal(y.shape)

    y_est = api.bm3d_deblurring(torch.as_tensor(z, dtype=dtype, device=device), sigma,
                                torch.as_tensor(v, dtype=dtype), device=device).cpu().numpy()

    out = {"blurred+noisy": psnr(z, y), "deblurred": psnr(y_est, y)}
    print(f"blurred+noisy PSNR: {out['blurred+noisy']:.2f} dB")
    print(f"deblurred PSNR:     {out['deblurred']:.2f} dB")
    return out


if __name__ == "__main__":
    main()
