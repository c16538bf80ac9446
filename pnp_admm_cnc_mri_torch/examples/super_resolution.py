"""Plug-and-play super-resolution with the closed-form solve.

Demonstrates the ``ops/sisr`` forward models: degrade a ground-truth image
with an anisotropic Gaussian blur + sf-fold decimation, then reconstruct it
HQS-style, alternating the frequency-domain data solution
(``sisr.data_solution``) with a model-zoo denoiser prior — the DPIR recipe.
The noise is the JAX example's ``jax.random.normal(PRNGKey(0))`` draw
(``utils/jax_random.normal``). Without the model's weights in
``model_zoo/`` the denoiser is seeded at random, with a warning.

    python -m pnp_admm_cnc_mri_torch.examples.super_resolution [--sf 2] [--model drunet_gray] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from pnp_admm_cnc_mri_torch.examples import add_device_flags, device_and_dtype


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--image", default=None, help="grayscale PNG (defaults "
                   "to the reference testset's 05.png when mounted)")
    p.add_argument("--sf", type=int, default=2, help="downscale factor")
    p.add_argument("--model", default="drunet_gray")
    p.add_argument("--iters", type=int, default=8)
    add_device_flags(p)
    args = p.parse_args(argv)
    device, dtype = device_and_dtype(args)

    from pnp_admm_cnc_mri_torch.data import images
    from pnp_admm_cnc_mri_torch.ops import metrics, schedules, sisr
    from pnp_admm_cnc_mri_torch.priors import denoiser as dn
    from pnp_admm_cnc_mri_torch.utils import jax_random

    path = args.image or os.path.join(images.DEFAULT_TESTSETS, "set1", "05.png")
    truth_u8 = images.modcrop(images.imread_gray(path), args.sf * 8)
    x_true = torch.as_tensor(images.uint2single(truth_u8), dtype=dtype, device=device)
    truth = torch.as_tensor(truth_u8, dtype=dtype, device=device)

    # Forward model: anisotropic Gaussian blur + sf-fold decimation
    # (sisr.classical_degradation), plus mild Gaussian noise.
    k = torch.as_tensor(sisr.anisotropic_gaussian(ksize=9, theta=0.7, l1=2.5, l2=1.0), dtype=dtype, device=device)
    y = sisr.classical_degradation(x_true, k, args.sf)
    y = y + 1.5 / 255.0 * torch.as_tensor(jax_random.normal(0, tuple(y.shape)), dtype=dtype, device=device)

    # Zero-fill baseline: nearest-style upsample of the LR observation.
    x0 = torch.kron(y, torch.ones((args.sf, args.sf), dtype=dtype, device=device))
    psnr0 = float(metrics.psnr(x0 * 255.0, truth))

    # HQS: x-update = closed-form data solution, z-update = denoiser.
    # ONE get_rho_sigma ladder drives both the rho weights and the
    # denoiser's sigma conditioning — the DPIR recipe
    # (modelSigma2 = max(sf, noise*255)); a mismatched pair over-smooths.
    nlm = float(max(args.sf, 1.5))
    denoise = dn.build_denoiser(args.model, iter_num=args.iters, weights=dn.resolve_weights(args.model),
                                noise_level_model=dn.nlm_for_model(args.model, nlm), param_dtype=dtype,
                                device=device)
    fb, fbc, f2b, fbfy = sisr.pre_calculate(y, k, args.sf)
    rhos, _sigmas = schedules.get_rho_sigma(sigma=1.5 / 255.0, iter_num=args.iters, model_sigma2=nlm)

    z = x0
    for i in range(args.iters):
        x = sisr.data_solution(z, fb, fbc, f2b, fbfy, float(rhos[i]), args.sf)
        z = torch.clamp(denoise(x, i), 0.0, 1.0)

    psnr = float(metrics.psnr(z * 255.0, truth))
    print(f"x{args.sf} SR with {args.model}: zero-fill {psnr0:.2f} dB -> "
          f"PnP {psnr:.2f} dB")
    return {"zero-fill": psnr0, "PnP": psnr}


if __name__ == "__main__":
    main()
