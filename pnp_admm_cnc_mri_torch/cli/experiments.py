"""The DPIR restoration pipelines: PnP deblurring and PnP super-resolution.

A partial counterpart of the JAX package's ``cli/experiments.py``: the blur
kernels, the restoration prior and the bodies of ``run_deblur`` and
``run_sr``, from the ground truth to the restored batch, as functions of
arrays. Loading a testset, scoring, logging and saving are not here (the
port has no ``data/images.py`` yet), so both take ``x_true`` and return
``(degraded, restored)``.

Each runs DPIR-style HQS (reference ``utils/utils_pnp.py:14-23``): the
closed-form frequency-domain data solution of ``ops/sisr.py`` alternates
with a denoiser, both driven by one ``get_rho_sigma`` ladder; the whole
batch restores at once.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.config import DEBLUR_KERNELS
from pnp_admm_cnc_mri_torch.ops import schedules, sisr
from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device


def make_blur_kernel(kernel: str = "aniso") -> np.ndarray:
    """A named blur kernel of the deblurring pipeline (host numpy): 'aniso',
    an anisotropic Gaussian (reference ``utils_sisr.py:692-711``); 'gauss',
    an isotropic one (``utils_sisr.py:714-724``); 'box', a 9x9 uniform blur."""
    if kernel == "aniso":
        return sisr.anisotropic_gaussian(ksize=15, theta=0.25 * np.pi, l1=3.0, l2=1.0)
    if kernel == "gauss":
        return sisr.gm_blur_kernel(mean=[0.0, 0.0], cov=[[2.0, 0.0], [0.0, 2.0]], size=15)
    if kernel == "box":
        return np.full((9, 9), 1.0 / 81.0)
    raise ValueError(f"unknown blur kernel '{kernel}' (want one of {DEBLUR_KERNELS})")


def _restoration_prior(model_name, iter_num, eff_nlm, sigmas, weights, x8, model_sigma1, bf16, clean=False,
                       dtype=torch.float32, device=None):
    """The denoiser of the restoration pipelines: a model-zoo CNN in
    ``dtype`` on ``device``, or BM3D along the sigma ladder when
    ``model_name == 'bm3d'`` (the iterative counterpart of
    ``priors.bm3d.api.bm3d_deblurring``)."""
    from pnp_admm_cnc_mri_torch.priors import denoiser as denoiser_mod

    if model_name == "bm3d":
        from pnp_admm_cnc_mri_torch.priors import bm3d_prior

        ignored = [name for name, v in (("weights", weights), ("x8", x8), ("bf16", bf16)) if v]
        if ignored:
            warnings.warn(f"the bm3d prior ignores {', '.join(ignored)} (CNN-only knobs)", stacklevel=2)
        return bm3d_prior.make_bm3d_ladder_denoiser(sigmas)
    extra = {} if model_sigma1 is None else {"model_sigma1": model_sigma1}
    return denoiser_mod.build_denoiser(
        model_name, iter_num=iter_num,
        weights=denoiser_mod.resolve_weights(model_name, weights, clean=clean),
        noise_level_model=denoiser_mod.nlm_for_model(model_name, eff_nlm),
        x8=x8, param_dtype=dtype, compute_dtype=torch.bfloat16 if bf16 else None, device=device, **extra,
    )


def _truth(x_true, m: int, dtype, device) -> torch.Tensor:
    """The ground truth on the device in ``dtype``, cropped to a multiple of
    ``m`` (so that decimation and the denoisers' pads stay aligned)."""
    x = torch.as_tensor(x_true, device=resolve_device(device)).to(dtype)
    h, w = x.shape[-2:]
    return x[..., : h - h % m, : w - w % m]


def _add_noise(y: torch.Tensor, noise_sigma255: float, noise, generator, seed: int) -> torch.Tensor:
    """y plus ``noise_sigma255 / 255`` times unit Gaussian noise: ``noise`` as
    given (an array of y's shape), else drawn from ``generator`` (default: a
    ``torch.Generator`` on y's device seeded with ``seed``)."""
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=y.device).manual_seed(seed)
        noise = torch.randn(y.shape, generator=generator, device=y.device, dtype=y.dtype)
    noise = torch.as_tensor(noise, device=y.device).to(y.dtype)
    return y + (noise_sigma255 / 255.0) * noise


def _restore(z, iter_num: int, data_step: Callable, denoise: Callable) -> torch.Tensor:
    """The HQS loop: the data solution at the i-th rho, then the denoiser at
    the i-th sigma, clipped to [0, 1]."""
    for i in range(iter_num):
        z = torch.clamp(denoise(data_step(z, i), i), 0.0, 1.0)
    return z


def run_deblur(x_true, model_name: str = "drunet_gray", kernel: str = "aniso", iter_num: int = 8,
               nlm: Optional[float] = None, noise_sigma255: float = 2.55, noise=None,
               generator: Optional[torch.Generator] = None, seed: int = 0, weights: Optional[str] = None,
               x8: bool = False, model_sigma1: Optional[float] = None, bf16: bool = False, clean: bool = False,
               denoise: Optional[Callable] = None, dtype=torch.float32, device=None):
    """PnP non-blind deblurring of a batch x_true (..., H, W) in [0, 1]; the
    body of the JAX package's ``run_deblur``. Returns ``(y, z)``: the
    blurred noisy images and the restored ones.

    Degradation: circular blur with ``make_blur_kernel(kernel)``
    (``sisr.wrap_convolve``) plus Gaussian noise of std ``noise_sigma255 /
    255`` (``noise``: unit-variance noise of y's shape; default from a
    ``torch.Generator`` seeded with ``seed``). Solver: HQS alternating the
    diagonal data solve (``sisr.deblur_solution``) with the prior of
    ``model_name`` (a model-zoo CNN, or 'bm3d'), or ``denoise(v, i)`` when
    given. ``device``: None for the CUDA card.
    """
    x = _truth(x_true, 8, dtype, device)
    k = torch.as_tensor(make_blur_kernel(kernel), device=x.device).to(dtype)
    y = _add_noise(sisr.wrap_convolve(x, k), noise_sigma255, noise, generator, seed)
    eff_nlm = float(max(1.0, noise_sigma255)) if nlm is None else float(nlm)
    _fb, _fbc, f2b, fbfy = sisr.pre_calculate(y, k, 1)
    rhos, sigmas = schedules.get_rho_sigma(
        sigma=max(noise_sigma255, 0.1) / 255.0, iter_num=iter_num,
        model_sigma1=model_sigma1 if model_sigma1 is not None else 49.0, model_sigma2=eff_nlm)
    if denoise is None:
        denoise = _restoration_prior(model_name, iter_num, eff_nlm, sigmas, weights, x8, model_sigma1, bf16,
                                     clean=clean, dtype=dtype, device=x.device)
    return y, _restore(y, iter_num, lambda z, i: sisr.deblur_solution(z, f2b, fbfy, float(rhos[i])), denoise)


def run_sr(x_true, model_name: str = "drunet_gray", sf: int = 2, iter_num: int = 8, nlm: Optional[float] = None,
           noise_sigma255: float = 1.5, noise=None, generator: Optional[torch.Generator] = None, seed: int = 0,
           weights: Optional[str] = None, x8: bool = False, model_sigma1: Optional[float] = None, bf16: bool = False,
           clean: bool = False, denoise: Optional[Callable] = None, dtype=torch.float32, device=None):
    """PnP super-resolution (x ``sf``) of a batch x_true (..., H, W) in [0,
    1]; the body of the JAX package's ``run_sr``. Returns ``(y, z)``: the
    low-resolution noisy images and the restored ones.

    Degradation: an anisotropic Gaussian blur (9x9, theta 0.7, l1 2.5, l2
    1.0), sf-fold decimation (``sisr.classical_degradation``) and Gaussian
    noise as in :func:`run_deblur`. Solver: from ``kron(y, ones(sf, sf))``,
    HQS alternating the closed-form data solution (``sisr.data_solution``)
    with the prior; the ladder ends at ``max(sf, noise_sigma255)`` unless
    ``nlm`` is given.
    """
    x = _truth(x_true, sf * 8, dtype, device)
    k = torch.as_tensor(sisr.anisotropic_gaussian(ksize=9, theta=0.7, l1=2.5, l2=1.0), device=x.device).to(dtype)
    y = _add_noise(sisr.classical_degradation(x, k, sf), noise_sigma255, noise, generator, seed)
    x0 = y.repeat_interleave(sf, dim=-2).repeat_interleave(sf, dim=-1)  # kron(y, ones(sf, sf))
    eff_nlm = float(max(sf, noise_sigma255)) if nlm is None else float(nlm)
    fb, fbc, f2b, fbfy = sisr.pre_calculate(y, k, sf)
    # the sigma floor keeps rhos above 0 for noiseless SR, as in run_deblur
    rhos, sigmas = schedules.get_rho_sigma(
        sigma=max(noise_sigma255, 0.1) / 255.0, iter_num=iter_num,
        model_sigma1=model_sigma1 if model_sigma1 is not None else 49.0, model_sigma2=eff_nlm)
    if denoise is None:
        denoise = _restoration_prior(model_name, iter_num, eff_nlm, sigmas, weights, x8, model_sigma1, bf16,
                                     clean=clean, dtype=dtype, device=x.device)
    return y, _restore(x0, iter_num, lambda z, i: sisr.data_solution(z, fb, fbc, f2b, fbfy, float(rhos[i]), sf),
                       denoise)
