"""End-to-end MRI reconstruction walkthrough (the framework's core task).

Reconstructs an undersampled single-coil acquisition several ways —
ADMM-L1, ADMM-CNC, FISTA-L1, and PnP-ADMM and PnP-FISTA with a model-zoo
denoiser — and prints the PSNR ladder. Without the reference's mask and
noise files (``PNPADMM_DATA``) it draws a 30% random mask and synthetic
k-space noise; without the model's weights in ``model_zoo/`` it skips the
PnP stage.

    python -m pnp_admm_cnc_mri_torch.examples.mri_reconstruction [--image path.png] [--model drunet_gray] [--cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.examples import add_device_flags, device_and_dtype


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--image", default=None, help="grayscale PNG (defaults "
                   "to the reference testset's 05.png when mounted)")
    p.add_argument("--mask", default="Q_Random30")
    p.add_argument("--model", default="drunet_gray")
    p.add_argument("--iters", type=int, default=50)
    add_device_flags(p)
    args = p.parse_args(argv)
    device, dtype = device_and_dtype(args)

    from pnp_admm_cnc_mri_torch.config import ADMMConfig
    from pnp_admm_cnc_mri_torch.data import images, masks, noise
    from pnp_admm_cnc_mri_torch.ops import fourier, metrics
    from pnp_admm_cnc_mri_torch.priors import denoiser
    from pnp_admm_cnc_mri_torch.solvers import admm, fista

    path = args.image or os.path.join(images.DEFAULT_TESTSETS, "set1", "05.png")
    if os.path.exists(path):
        img = images.uint2single(images.modcrop(images.imread_gray(path)))
    else:  # synthetic phantom fallback
        yy, xx = np.mgrid[:256, :256]
        img = (((yy - 128) ** 2 + (xx - 128) ** 2) < 90**2).astype(np.float64)
        img *= 0.8 - 0.3 * (((yy - 110) ** 2 + 2 * (xx - 140) ** 2) < 40**2)

    try:
        mask, n = masks.load_mask(args.mask), noise.load_noise()
    except FileNotFoundError:  # no reference assets: generate equivalents
        mask = masks.random_mask(img.shape, fraction=0.30)
        n = noise.synth_noise(img.shape)
    n = np.asarray(n, np.complex128 if args.f64 else np.complex64)

    mask = torch.as_tensor(mask, dtype=dtype, device=device)
    x0 = torch.as_tensor(img, dtype=dtype, device=device)
    y = fourier.observe(x0, mask, torch.as_tensor(n, device=device))
    truth255 = x0 * 255.0
    out = {}

    def report(name, x):
        out[name] = float(metrics.psnr(x * 255.0, truth255))
        print(f"{name:>12}: {out[name]:.2f} dB")

    report("zero-fill", torch.abs(fourier.ifft2(y)))

    st, _ = admm.admm_l1(y, mask, ADMMConfig(iter_num=args.iters, lam=0.1, rho=0.015),
                         dtype=dtype, device=device)
    report("ADMM-L1", st.x)

    st, _ = admm.admm_cnc(y, mask, ADMMConfig(iter_num=args.iters, lam=0.5, rho=0.05, alpha=0.45, b=64.0),
                          dtype=dtype, device=device)
    report("ADMM-CNC", st.x)

    st, _ = fista.fista_l1(y, mask, iter_num=args.iters, lam=1e-4, dtype=dtype, device=device)
    report("FISTA-L1", st.x)

    weights = denoiser.resolve_weights(args.model)
    if weights:
        dn = denoiser.build_denoiser(args.model, weights=weights, iter_num=args.iters, noises=n,
                                     param_dtype=dtype, device=device)
        st, _ = admm.pnp_admm_l1(y, mask, ADMMConfig(iter_num=args.iters, rho=0.7), denoise=dn,
                                 dtype=dtype, device=device)
        report(f"PnP-{args.model}", st.x)
        # the gradient-form PnP family (best clean-weights quality;
        # solvers/fista.pnp_fista, TUNED_FISTA_D)
        st, _ = fista.pnp_fista(y, mask, args.iters, dn, dtype=dtype, device=device)
        report(f"FISTA-{args.model}", st.x)
    else:
        print(f"(no weights for {args.model}; skipping the PnP stage)")
    return out


if __name__ == "__main__":
    main()
