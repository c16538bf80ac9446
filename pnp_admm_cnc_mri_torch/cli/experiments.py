"""The MRI experiment runners and the DPIR restoration pipelines.

Port of the JAX package's ``cli/experiments.py``. The MRI runners
reproduce the reference's entry scripts (``【1】ADMM_L1.py`` ...
``【6】PNP_ADMM_CNC_D .py``) and the other solver families: each loads a
testset, a mask and the fixed noise (``prepare_batch``), solves the whole
testset as one batch on the device, scores it there and logs PSNR, SSIM and
RE per image and on average in the reference's format, saving the PNGs
(``score_and_log``). Their signatures are the JAX package's plus
``device`` (None: the CUDA card; ``'cpu'`` only when asked for); their
dtype default is ``torch.get_default_dtype()`` for the classical solvers,
as the JAX package's follows ``jax_enable_x64``, and float32 for PnP.

The restoration half holds the blur kernels, the restoration prior and the
DPIR pipelines. ``run_deblur`` and ``run_sr`` take the JAX package's
keyword signature (plus ``noise``, ``dtype`` and ``device``): each loads a
testset, degrades it with the JAX package's noise (``utils/jax_random.py``
replays ``jax.random.normal(PRNGKey(seed))``), restores it and scores and
logs it. Their bodies, from the ground truth to the restored batch, are
``deblur_batch`` and ``sr_batch``: functions of arrays that return
``(degraded, restored)``. Each runs DPIR-style HQS (reference
``utils/utils_pnp.py:14-23``): the closed-form frequency-domain data
solution of ``ops/sisr.py`` alternates with a denoiser, both driven by one
``get_rho_sigma`` ladder; the whole batch restores at once.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.config import ADMM_CNC_DEFAULT, ADMM_L1_DEFAULT, DEBLUR_KERNELS, ADMMConfig
from pnp_admm_cnc_mri_torch.data import images, masks, noise
from pnp_admm_cnc_mri_torch.ops import metrics as metrics_mod
from pnp_admm_cnc_mri_torch.ops import schedules, sisr
from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device
from pnp_admm_cnc_mri_torch.utils import jax_random
from pnp_admm_cnc_mri_torch.utils import logger as logger_mod


def prepare_batch(
    testset_dir: str,
    mask_name: str = "Q_Random30",
    data_dir: Optional[str] = None,
    use_clip: bool = True,
    only: Optional[str] = None,
):
    """Load a testset, a mask and the noise and form the observations (host
    numpy). Returns a dict: imgs01 (B, H, W) float64, truth (B, H, W)
    float64 on the 0-255 scale, y (B, H, W) complex128, mask (H, W), names.

    ``only`` (comma-separated image stems, e.g. ``"05,11"``) keeps those
    images, in testset order, and reads no other; each keeps its
    observation of the full-set batch (same mask, same fixed noise, the
    same per-image FFT), so its PSNR equals its slot of the full run's.
    """
    paths = images.get_image_paths(testset_dir)
    if not paths:
        raise FileNotFoundError(f"no images under {testset_dir}")
    if only:
        stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        paths = [paths[i] for i in _filter_only(stems, only)]
    imgs01, truth, names = images.load_files(paths, use_clip=use_clip)
    mask = masks.load_mask(mask_name, data_dir)
    kn = noise.load_noise(data_dir)
    y = np.fft.fft2(imgs01, axes=(-2, -1)) * mask + kn
    return {"imgs01": imgs01, "truth": truth, "y": y, "mask": mask, "names": names}


def _filter_only(names, only: str):
    """Indices of the ``only`` images (comma-separated stems) in ``names``."""
    want = [w.strip() for w in only.split(",")]
    missing = [w for w in want if w not in names]
    if missing:
        raise ValueError(f"--images {missing} not in testset {sorted(names)}")
    return [i for i, n in enumerate(names) if n in want]


def score_and_log(
    x,
    truth,
    names,
    result_name: str,
    results_dir: str = "results",
    save_images: bool = True,
    round_uint8: bool = False,
    log=None,
) -> Dict[str, float]:
    """Per-image and average PSNR/SSIM/RE in the reference's log format.

    ``x``: the [0, 1] reconstructions (B, H, W), a tensor (scored on its
    device, in its dtype) or a numpy array. ``round_uint8`` mirrors
    ``【6】:315``, which rounds to uint8 before scoring (the other scripts
    score the float ``x * 255``). Without ``log`` the lines go to
    ``results_dir/result_name/result_name.log`` through a logger that is
    released when they are written, so each call logs into its own
    ``results_dir``.
    """
    if log is None:
        log = logger_mod.logger_info(result_name, os.path.join(results_dir, result_name, result_name + ".log"))
        try:
            return score_and_log(x, truth, names, result_name, results_dir, save_images, round_uint8, log)
        finally:
            logger_mod.release(log)
    e_path = os.path.join(results_dir, result_name)
    x = torch.as_tensor(x)
    img_e = x * 255.0
    if round_uint8:
        img_e = torch.round(img_e).clamp(0, 255).to(torch.uint8).to(x.dtype)
    truth_t = torch.as_tensor(np.asarray(truth), device=x.device).to(x.dtype)
    psnr = metrics_mod.psnr(img_e, truth_t).cpu().numpy()
    ssim = metrics_mod.ssim(img_e, truth_t).cpu().numpy()
    re = metrics_mod.relative_error(img_e, truth_t).cpu().numpy()
    img_host = img_e.cpu().numpy() if save_images else None
    for i, name in enumerate(names):
        log.info(
            "{:s} - PSNR: {:.2f} dB; SSIM: {:.4f} ; RE: {:.4f}.".format(
                name + ".png", psnr[i], ssim[i], re[i]
            )
        )
        if save_images:
            images.imsave(img_host[i], os.path.join(e_path, f"{name}_{result_name}.png"))
    avg = {
        "psnr": float(psnr.mean()),
        "ssim": float(ssim.mean()),
        "re": float(re.mean()),
        "per_image_psnr": {n: float(p) for n, p in zip(names, psnr)},
    }
    log.info(
        "------> Average PSNR:({:.3f})dB, Average ssim : ({:.3f}), Average re : ({:.3f})".format(
            avg["psnr"], avg["ssim"], avg["re"]
        )
    )
    return avg


# the host types of y and the mask for each working dtype: cast on the host, as the JAX package casts
_HOST_TYPES = {torch.float32: (np.float32, np.complex64), torch.float64: (np.float64, np.complex128)}


def device_complex(arr, dtype, device) -> torch.Tensor:
    """A host complex array on ``device`` in the complex type of the real
    ``dtype``: cast on the host (complex64 or complex128), then one copy, as
    the JAX package's ``_device_complex`` casts before its transfer."""
    return torch.as_tensor(np.asarray(arr).astype(_HOST_TYPES[dtype][1]), device=device)


def _drive(solve: Callable, testset: str, mask_name: str, testsets_dir, data_dir, results_dir: str,
           save_images: bool, only, dtype, device, result_name: str, iters: int,
           round_uint8: bool = False) -> Dict[str, float]:
    """The common body of the MRI runners: load and observe on the host,
    move y and the mask to the device in ``dtype``, time ``solve(y, mask) ->
    x`` to its end on the device, score and log."""
    device = resolve_device(device)
    batch = prepare_batch(os.path.join(testsets_dir or images.DEFAULT_TESTSETS, testset), mask_name, data_dir,
                          only=only)
    y = device_complex(batch["y"], dtype, device)
    mask = torch.as_tensor(np.asarray(batch["mask"]).astype(_HOST_TYPES[dtype][0]), device=device)
    t0 = time.perf_counter()
    x = solve(y, mask)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    dt = time.perf_counter() - t0
    avg = score_and_log(x, batch["truth"], batch["names"], f"{testset}_dn_{result_name}_{mask_name}", results_dir,
                        save_images, round_uint8)
    avg.update(wall_s=dt, images=len(batch["names"]), iters=iters)
    return avg


def run_classical(
    algo: str = "admm_l1",
    testset: str = "set1",
    mask_name: str = "Q_Random30",
    cfg: Optional[ADMMConfig] = None,
    testsets_dir: Optional[str] = None,
    data_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    dtype=None,
    device=None,
) -> Dict[str, float]:
    """ADMM-L1 or ADMM-CNC over a testset, batched (reference 【1】/【4】).
    The port's solvers run their z/w tails as the CUDA kernels of
    ``ops/tail_kernels.py`` on the card (``fused=True``)."""
    from pnp_admm_cnc_mri_torch.solvers import admm

    if cfg is None:
        cfg = ADMM_L1_DEFAULT if algo == "admm_l1" else ADMM_CNC_DEFAULT
    solver = {"admm_l1": admm.admm_l1, "admm_cnc": admm.admm_cnc}[algo]
    dtype = dtype or torch.get_default_dtype()
    return _drive(lambda y, m: solver(y, m, cfg, dtype=dtype, device=y.device)[0].x, testset, mask_name,
                  testsets_dir, data_dir, results_dir, save_images, only, dtype, device, algo.upper(), cfg.iter_num)


def run_pnp(
    denoise: Callable,
    cfg: ADMMConfig,
    scheme: str = "l1",
    testset: str = "set1",
    mask_name: str = "Q_Random30",
    denoise2: Optional[Callable] = None,
    clamp: bool = True,
    testsets_dir: Optional[str] = None,
    data_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    round_uint8: bool = False,
    result_tag: str = "pnp",
    dtype=None,
    device=None,
) -> Dict[str, float]:
    """A PnP-ADMM variant with a denoiser callable (refs 【2】/【3】/【5】/【6】):
    ``scheme='l1'`` is ``pnp_admm_l1``, any other ``pnp_admm_cnc`` with
    ``denoise`` and ``denoise2`` in its two slots."""
    from pnp_admm_cnc_mri_torch.solvers import admm

    dtype = dtype or torch.float32

    def solve(y, m):
        if scheme == "l1":
            return admm.pnp_admm_l1(y, m, cfg, denoise, clamp=clamp, dtype=dtype, device=y.device)[0].x
        return admm.pnp_admm_cnc(y, m, cfg, denoise, denoise2, clamp=clamp, dtype=dtype, device=y.device)[0].x

    return _drive(solve, testset, mask_name, testsets_dir, data_dir, results_dir, save_images, only, dtype, device,
                  result_tag, cfg.iter_num, round_uint8)


def run_fista_l1(
    testset: str = "set1",
    mask_name: str = "Q_Random30",
    iter_num: int = 50,
    lam: float = 1e-4,
    step: float = 1.0,
    testsets_dir: Optional[str] = None,
    data_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    dtype=None,
    momentum: bool = True,
    result_tag: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """FISTA-L1 (or, with ``momentum=False``, the reference's deleted PGD-L1
    pipeline) over a testset (``solvers/fista.py``)."""
    from pnp_admm_cnc_mri_torch.solvers import fista

    dtype = dtype or torch.get_default_dtype()

    def solve(y, m):
        return fista.fista_l1(y, m, iter_num=iter_num, lam=lam, step=step, momentum=momentum, dtype=dtype,
                              device=y.device)[0].x

    return _drive(solve, testset, mask_name, testsets_dir, data_dir, results_dir, save_images, only, dtype, device,
                  result_tag or ("FISTA_L1" if momentum else "PGD_L1"), iter_num)


def run_pnp_fista(
    denoise: Callable,
    iter_num: int,
    step: float = 1.0,
    clamp: bool = True,
    testset: str = "set1",
    mask_name: str = "Q_Random30",
    testsets_dir: Optional[str] = None,
    data_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    result_tag: str = "pnp_fista",
    dtype=None,
    momentum: bool = True,
    device=None,
) -> Dict[str, float]:
    """PnP-FISTA (``solvers/fista.pnp_fista``) over a testset;
    ``momentum=False`` is the reference's deleted PNP-PGD pipeline."""
    from pnp_admm_cnc_mri_torch.solvers import fista

    dtype = dtype or torch.float32

    def solve(y, m):
        return fista.pnp_fista(y, m, iter_num, denoise, step=step, clamp=clamp, dtype=dtype, momentum=momentum,
                               device=y.device)[0].x

    return _drive(solve, testset, mask_name, testsets_dir, data_dir, results_dir, save_images, only, dtype, device,
                  result_tag, iter_num)


def run_pnp_pgd_cnc(
    denoise: Callable,
    iter_num: int,
    denoise2: Optional[Callable] = None,
    alpha: float = 1.2,
    lam: float = 0.02,
    b: float = 36.0,
    step: float = 1.0,
    clamp: bool = True,
    testset: str = "set1",
    mask_name: str = "Q_Random30",
    testsets_dir: Optional[str] = None,
    data_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    result_tag: str = "pnp_pgd_cnc",
    dtype=None,
    device=None,
) -> Dict[str, float]:
    """PGD with the CNC double-denoiser prox (``solvers/fista.pnp_pgd_cnc``),
    the reference's deleted PNP_PGD_CNC_* pipelines."""
    from pnp_admm_cnc_mri_torch.solvers import fista

    dtype = dtype or torch.float32

    def solve(y, m):
        return fista.pnp_pgd_cnc(y, m, iter_num, denoise, denoise2=denoise2, alpha=alpha, lam=lam, b=b, step=step,
                                 clamp=clamp, dtype=dtype, device=y.device)[0].x

    return _drive(solve, testset, mask_name, testsets_dir, data_dir, results_dir, save_images, only, dtype, device,
                  result_tag, iter_num)


def run_pnp_hqs(
    denoise: Callable,
    iter_num: int,
    sigma255: float = 10.0,
    model_sigma1: float = 49.0,
    model_sigma2: float = 15.0,
    clamp: bool = True,
    testset: str = "set1",
    mask_name: str = "Q_Random30",
    testsets_dir: Optional[str] = None,
    data_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    result_tag: str = "pnp_hqs",
    dtype=None,
    device=None,
) -> Dict[str, float]:
    """PnP-HQS (``solvers/hqs.pnp_hqs``) over a testset. The ladder
    ``(iter_num, model_sigma1, model_sigma2)`` must match the denoiser's
    (``TUNED_HQS_D`` keeps them coupled)."""
    from pnp_admm_cnc_mri_torch.solvers import hqs

    dtype = dtype or torch.float32

    def solve(y, m):
        return hqs.pnp_hqs(y, m, iter_num, denoise, sigma255=sigma255, model_sigma1=model_sigma1,
                           model_sigma2=model_sigma2, clamp=clamp, dtype=dtype, device=y.device)[0]

    return _drive(solve, testset, mask_name, testsets_dir, data_dir, results_dir, save_images, only, dtype, device,
                  result_tag, iter_num)


def run_red(
    denoise: Callable,
    iter_num: int,
    lam: float = 0.2,
    step: float = 1.0,
    variant: str = "fp",
    clamp: bool = True,
    testset: str = "set1",
    mask_name: str = "Q_Random30",
    testsets_dir: Optional[str] = None,
    data_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    result_tag: str = "red",
    dtype=None,
    device=None,
) -> Dict[str, float]:
    """RED, regularization by denoising (``solvers/red.run_red``), over a
    testset."""
    from pnp_admm_cnc_mri_torch.solvers import red

    dtype = dtype or torch.float32

    def solve(y, m):
        return red.run_red(y, m, iter_num, denoise, lam=lam, step=step, variant=variant, clamp=clamp, dtype=dtype,
                           device=y.device)[0]

    return _drive(solve, testset, mask_name, testsets_dir, data_dir, results_dir, save_images, only, dtype, device,
                  result_tag, iter_num)


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


def _deblur_problem(x_true, model_name, kernel, iter_num, nlm, noise_sigma255, noise, generator, seed, weights, x8,
                    model_sigma1, bf16, clean, denoise, dtype, device):
    """The degraded batch y, the start z0, the data step and the prior of
    :func:`deblur_batch`."""
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
    return y, y, lambda z, i: sisr.deblur_solution(z, f2b, fbfy, float(rhos[i])), denoise


def _sr_problem(x_true, model_name, sf, iter_num, nlm, noise_sigma255, noise, generator, seed, weights, x8,
                model_sigma1, bf16, clean, denoise, dtype, device):
    """The degraded batch y, the start z0, the data step and the prior of
    :func:`sr_batch`."""
    x = _truth(x_true, sf * 8, dtype, device)
    k = torch.as_tensor(sisr.anisotropic_gaussian(ksize=9, theta=0.7, l1=2.5, l2=1.0), device=x.device).to(dtype)
    y = _add_noise(sisr.classical_degradation(x, k, sf), noise_sigma255, noise, generator, seed)
    x0 = y.repeat_interleave(sf, dim=-2).repeat_interleave(sf, dim=-1)  # kron(y, ones(sf, sf))
    eff_nlm = float(max(sf, noise_sigma255)) if nlm is None else float(nlm)
    fb, fbc, f2b, fbfy = sisr.pre_calculate(y, k, sf)
    # the sigma floor keeps rhos above 0 for noiseless SR, as in deblurring
    rhos, sigmas = schedules.get_rho_sigma(
        sigma=max(noise_sigma255, 0.1) / 255.0, iter_num=iter_num,
        model_sigma1=model_sigma1 if model_sigma1 is not None else 49.0, model_sigma2=eff_nlm)
    if denoise is None:
        denoise = _restoration_prior(model_name, iter_num, eff_nlm, sigmas, weights, x8, model_sigma1, bf16,
                                     clean=clean, dtype=dtype, device=x.device)
    return y, x0, lambda z, i: sisr.data_solution(z, fb, fbc, f2b, fbfy, float(rhos[i]), sf), denoise


def deblur_batch(x_true, model_name: str = "drunet_gray", kernel: str = "aniso", iter_num: int = 8,
                 nlm: Optional[float] = None, noise_sigma255: float = 2.55, noise=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0, weights: Optional[str] = None,
                 x8: bool = False, model_sigma1: Optional[float] = None, bf16: bool = False, clean: bool = False,
                 denoise: Optional[Callable] = None, dtype=torch.float32, device=None):
    """PnP non-blind deblurring of a batch x_true (..., H, W) in [0, 1]: the
    body of :func:`run_deblur`, from the ground truth to the restored batch.
    Returns ``(y, z)``: the blurred noisy images and the restored ones.

    Degradation: circular blur with ``make_blur_kernel(kernel)``
    (``sisr.wrap_convolve``) plus Gaussian noise of std ``noise_sigma255 /
    255`` (``noise``: unit-variance noise of y's shape; default from a
    ``torch.Generator`` seeded with ``seed``). Solver: HQS alternating the
    diagonal data solve (``sisr.deblur_solution``) with the prior of
    ``model_name`` (a model-zoo CNN, or 'bm3d'), or ``denoise(v, i)`` when
    given. ``device``: None for the CUDA card.
    """
    y, z0, data_step, denoise = _deblur_problem(x_true, model_name, kernel, iter_num, nlm, noise_sigma255, noise,
                                                generator, seed, weights, x8, model_sigma1, bf16, clean, denoise,
                                                dtype, device)
    return y, _restore(z0, iter_num, data_step, denoise)


def sr_batch(x_true, model_name: str = "drunet_gray", sf: int = 2, iter_num: int = 8, nlm: Optional[float] = None,
             noise_sigma255: float = 1.5, noise=None, generator: Optional[torch.Generator] = None, seed: int = 0,
             weights: Optional[str] = None, x8: bool = False, model_sigma1: Optional[float] = None,
             bf16: bool = False, clean: bool = False, denoise: Optional[Callable] = None, dtype=torch.float32,
             device=None):
    """PnP super-resolution (x ``sf``) of a batch x_true (..., H, W) in [0,
    1]: the body of :func:`run_sr`. Returns ``(y, z)``: the low-resolution
    noisy images and the restored ones.

    Degradation: an anisotropic Gaussian blur (9x9, theta 0.7, l1 2.5, l2
    1.0), sf-fold decimation (``sisr.classical_degradation``) and Gaussian
    noise as in :func:`deblur_batch`. Solver: from ``kron(y, ones(sf, sf))``,
    HQS alternating the closed-form data solution (``sisr.data_solution``)
    with the prior; the ladder ends at ``max(sf, noise_sigma255)`` unless
    ``nlm`` is given.
    """
    y, z0, data_step, denoise = _sr_problem(x_true, model_name, sf, iter_num, nlm, noise_sigma255, noise, generator,
                                            seed, weights, x8, model_sigma1, bf16, clean, denoise, dtype, device)
    return y, _restore(z0, iter_num, data_step, denoise)


def _run_restoration(problem, crop: int, out_shape, result_name: str, iter_num: int, testset: str, testsets_dir,
                     results_dir: str, save_images: bool, only, seed: int, noise, dtype, device, **kw):
    """The testset runners' common body: load, keep ``only``, crop to
    ``crop``, degrade with ``noise`` (default: JAX's normals of ``seed``),
    restore on the device (timed to its end there), score and log."""
    imgs01, _, names = images.load_testset(os.path.join(testsets_dir or images.DEFAULT_TESTSETS, testset))
    if only:
        idx = _filter_only(names, only)
        imgs01, names = imgs01[idx], [names[i] for i in idx]
    h, w = imgs01.shape[-2:]
    imgs01 = imgs01[..., : h - h % crop, : w - w % crop]
    if noise is None:
        noise = jax_random.normal(seed, out_shape(imgs01.shape))
    _y, z0, data_step, denoise = problem(imgs01, noise=noise, generator=None, seed=seed, dtype=dtype,
                                         device=device, iter_num=iter_num, **kw)
    t0 = time.perf_counter()
    z = _restore(z0, iter_num, data_step, denoise)
    if z.is_cuda:
        torch.cuda.synchronize(z.device)
    dt = time.perf_counter() - t0
    avg = score_and_log(z, imgs01 * 255.0, names, result_name, results_dir, save_images)
    avg.update(wall_s=dt, images=len(names), iters=iter_num)
    return avg


def run_deblur(
    model_name: str = "drunet_gray",
    kernel: str = "aniso",
    iter_num: int = 8,
    nlm: Optional[float] = None,
    noise_sigma255: float = 2.55,
    testset: str = "set1",
    testsets_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    weights: Optional[str] = None,
    seed: int = 0,
    x8: bool = False,
    model_sigma1: Optional[float] = None,
    bf16: bool = False,
    clean: bool = False,
    noise=None,
    dtype=torch.float32,
    device=None,
) -> Dict[str, float]:
    """PnP non-blind deblurring over a testset (the JAX package's
    ``run_deblur``): load, keep ``only``, modcrop to 8, blur and add noise of
    ``noise_sigma255 / 255`` times ``jax_random.normal(seed, y.shape)`` (the
    JAX package's ``jax.random.normal(PRNGKey(seed))``) unless ``noise`` is
    given, restore with :func:`deblur_batch`'s HQS, and score and log under
    ``{testset}_deblur_{kernel}_{model_name}``. ``wall_s`` times the
    restoration loop. The JAX package runs it in float32, whatever x64 says."""
    return _run_restoration(
        _deblur_problem, 8, lambda s: s, f"{testset}_deblur_{kernel}_{model_name}", iter_num, testset,
        testsets_dir, results_dir, save_images, only, seed, noise, dtype, device, model_name=model_name,
        kernel=kernel, nlm=nlm, noise_sigma255=noise_sigma255, weights=weights, x8=x8, model_sigma1=model_sigma1,
        bf16=bf16, clean=clean, denoise=None)


def run_sr(
    model_name: str = "drunet_gray",
    sf: int = 2,
    iter_num: int = 8,
    nlm: Optional[float] = None,
    noise_sigma255: float = 1.5,
    testset: str = "set1",
    testsets_dir: Optional[str] = None,
    results_dir: str = "results",
    save_images: bool = True,
    only: Optional[str] = None,
    weights: Optional[str] = None,
    seed: int = 0,
    x8: bool = False,
    model_sigma1: Optional[float] = None,
    bf16: bool = False,
    clean: bool = False,
    noise=None,
    dtype=torch.float32,
    device=None,
) -> Dict[str, float]:
    """PnP super-resolution over a testset (the JAX package's ``run_sr``):
    as :func:`run_deblur`, with a modcrop to ``sf * 8``, the degradation and
    solver of :func:`sr_batch`, the noise drawn at the low resolution, and
    the result name ``{testset}_sr{sf}_{model_name}``."""
    return _run_restoration(
        _sr_problem, sf * 8, lambda s: (*s[:-2], s[-2] // sf, s[-1] // sf), f"{testset}_sr{sf}_{model_name}",
        iter_num, testset, testsets_dir, results_dir, save_images, only, seed, noise, dtype, device,
        model_name=model_name, sf=sf, nlm=nlm, noise_sigma255=noise_sigma255, weights=weights, x8=x8,
        model_sigma1=model_sigma1, bf16=bf16, clean=clean, denoise=None)
