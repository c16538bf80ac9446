"""Reference-compatible BM3D API: staged calls, block-match reuse, PSD
inputs, refiltering, multichannel and RGB images, and deblurring.

Port of the JAX package's ``priors/bm3d/api.py``, which mirrors the public
functions of ``bm3d307/bm3d/__init__.py``:

- ``bm3d(z, sigma, stage_arg=...)``: a scalar std or a 2-D PSD; an HT
  estimate in ``stage_arg`` runs the Wiener stage only (reference
  ``:216-224``); refiltering and ``exact_white`` profiles route as there;
- ``bm3d_with_blockmatches``: compute block matching once and reuse it
  (reference ``blockmatches=(True, True)``, ``bm3d_ctypes.py:242-255``);
- ``bm3d_multichannel`` and ``bm3d_rgb``: matching on one channel (the
  first, or the opponent-color luminance) shared by all (reference
  ``:391-438``);
- ``bm3d_deblurring``: a regularized inverse, then collaborative filtering
  of its colored residual noise (reference ``:335-388``);
- ``bm3d_refilter``: the reference's ``denoise_residual`` path.

Images have shape (..., H, W) (multichannel and RGB: (..., H, W, C)); the
leading axes run as one batch and each image equals its single-image call.
The entry points take ``device`` (None: the CUDA card). PSDs and the
parameters estimated from them are host numpy, shared by the batch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.ops.fourier import full_precision_matmul
from pnp_admm_cnc_mri_torch.priors.bm3d import core
from pnp_admm_cnc_mri_torch.priors.bm3d import transforms as tr
from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device
from pnp_admm_cnc_mri_torch.solvers.fista import host_scalar


class BlockMatches(NamedTuple):
    """Reusable block-matching result of one stage."""

    pos: torch.Tensor  # (..., G, K, 2) matched top-left positions
    counts: torch.Tensor  # (..., G) power-of-two group sizes


# Opponent color transform (reference __init__.py rgb handling)
_OPP = np.array(
    [
        [1 / 3, 1 / 3, 1 / 3],
        [0.5, 0.0, -0.5],
        [0.25, -0.5, 0.25],
    ]
)
_OPP_INV = np.linalg.inv(_OPP)


def _on(z, device) -> torch.Tensor:
    return torch.as_tensor(z, device=resolve_device(device))


def _is_flat(psd: np.ndarray) -> bool:
    """The white-PSD test of the JAX package: peak-to-peak within 1e-9 of the max."""
    return np.ptp(psd) <= 1e-9 * max(float(psd.max()), 1e-30)


def _stage_params(p: core.BM3DProfile, stage: str):
    """(bs, step, search, k_max, tau) of a stage."""
    if stage == "ht":
        bs, step, search, k_max, tau_match = p.bs_ht, p.step_ht, p.search_ht, p.max_3d_ht, p.tau_match_ht
    else:
        bs, step, search, k_max, tau_match = p.bs_wie, p.step_wie, p.search_wie, p.max_3d_wie, p.tau_match_wie
    return bs, step, search, k_max, tau_match * p.tau_scale * (bs * bs) / (255.0**2)


def compute_blockmatches(img, profile: core.BM3DProfile, stage: str = "ht", device=None) -> BlockMatches:
    """Only the block matching of a stage ('ht' or 'wie'), on ``img``."""
    img = _on(img, device)
    bs, step, search, k_max, tau = _stage_params(profile, stage)
    ref = core._ref_grid(img.shape[-2] - bs + 1, step)
    pos, counts = core._match(img, ref, core._offsets(search, bs), bs, k_max, tau)
    return BlockMatches(pos, counts)


def bm3d(z, sigma, profile=core.DEFAULT_PROFILE, stage_arg=None, prefilter: Optional[bool] = None,
         device=None) -> torch.Tensor:
    """The reference-style entry.

    ``sigma``: a scalar std, or a 2-D PSD of the image's shape (the
    reference's ``bm3d(z, sigma_psd)``): flat PSDs take the white-noise
    path, others the exact-variance colored core
    (``core.bm3d_colored_auto``, whose parameter estimation needs the
    reference's database for a colored PSD). ``stage_arg``: an HT estimate,
    to run the Wiener stage only. ``profile``: a ``BM3DProfile`` or a name
    of ``core.PROFILES``; a refiltering profile routes a scalar sigma
    without ``stage_arg`` through :func:`bm3d_refilter`, and one with
    ``exact_white`` a scalar sigma through the exact colored core.
    """
    profile = core.get_profile(profile)
    z = _on(z, device)
    sig_np = np.asarray(sigma)
    if profile.denoise_residual and sig_np.ndim < 2 and stage_arg is None:
        return bm3d_refilter(z, sigma, profile=dataclasses.replace(profile, denoise_residual=False),
                             device=z.device)
    h, w = z.shape[-2:]
    pilot = None if stage_arg is None else torch.as_tensor(stage_arg, device=z.device).to(z.dtype)
    if sig_np.ndim >= 2:
        if sig_np.shape[-2:] != (h, w):
            raise ValueError(
                f"PSD shape {sig_np.shape[-2:]} must match the image shape {(h, w)} (the var*H*W "
                "convention ties the PSD to the image grid)")
        flat = _is_flat(sig_np)
        if pilot is not None:
            if flat:
                return core.wiener_stage(z, pilot, np.sqrt(sig_np.mean() / (h * w)), profile)
            psd_g, prof = _auto_profile(sig_np, profile)
            stds_wie = core.psd_to_coeff_stds(psd_g, prof.transform_wie, prof.bs_wie)
            cov_wie = core.coeff_cov_field(psd_g, prof.transform_wie, prof.bs_wie)
            return core.wiener_stage_colored(z, pilot, stds_wie, prof, cov_field=cov_wie)
        if flat:
            return core.bm3d(z, float(np.sqrt(sig_np.mean() / (h * w))), profile, prefilter=prefilter,
                             device=z.device)
        return core.bm3d_colored_auto(z, sig_np, profile, device=z.device)
    if pilot is not None:
        return core.wiener_stage(z, pilot, float(sig_np), profile)
    if profile.exact_white:
        sv = float(sig_np)
        return core.bm3d_colored(z, np.full((h, w), sv**2 * h * w), profile, exact=True, device=z.device)
    return core.bm3d(z, float(sig_np), profile, prefilter=prefilter, device=z.device)


def _auto_profile(psd: np.ndarray, profile: core.BM3DProfile):
    """The guarded PSD and the profile with PSD-estimated (lambda, mu^2),
    the preprocessing ``core.bm3d_colored_auto`` shares (reference parameter
    estimation ``__init__.py:633-717``)."""
    from pnp_admm_cnc_mri_torch.priors.bm3d import psd_params

    floor = float(np.mean(psd)) * 1e-3 + 1e-20
    psd_g = np.maximum(np.asarray(psd, np.float64), floor)
    lam, mu2, _, _ = psd_params.estimate_parameters_for_psd(psd_params.shrink_and_normalize_psd(psd_g))
    return psd_g, dataclasses.replace(profile, lambda_thr3d=lam, mu2=mu2)


def bm3d_with_blockmatches(z, sigma, profile: core.BM3DProfile = core.DEFAULT_PROFILE,
                           bm_ht: Optional[BlockMatches] = None, bm_wie: Optional[BlockMatches] = None,
                           device=None) -> Tuple[torch.Tensor, BlockMatches, BlockMatches]:
    """Two-stage BM3D that returns, and can take, its block matches (the
    reference's ``blockmatches`` feature): reused on correlated inputs, or
    across the channels of one image, they save the matching."""
    z = _on(z, device)
    sig = host_scalar(sigma, z.dtype)
    if bm_ht is None:
        bm_ht = compute_blockmatches(z, profile, "ht", device=z.device)
    yb = _stage_with_matches(z, None, sig, profile, bm_ht, mode="ht")
    if bm_wie is None:
        bm_wie = compute_blockmatches(yb, profile, "wie", device=z.device)
    return _stage_with_matches(z, yb, sig, profile, bm_wie, mode="wie"), bm_ht, bm_wie


def _stage_with_matches(z: torch.Tensor, pilot, sigma, p: core.BM3DProfile, bm: BlockMatches, mode: str):
    """A filtering stage ('ht' or 'wie') with supplied matches, by the
    per-size matrix loop, as the JAX package has it on every backend.

    ``sigma``: a scalar std (white noise), or a (bs*bs,) vector of
    per-coefficient stds from ``core.psd_to_coeff_stds`` (a colored PSD:
    the position-independent thresholds, Wiener variances and group
    weights of ``core.ht_stage_colored`` / ``wiener_stage_colored``).
    """
    h, w = z.shape[-2:]
    bs = p.bs_ht if mode == "ht" else p.bs_wie
    nw = w - bs + 1
    dt, dev = z.dtype, z.device
    k_max = p.max_3d_ht if mode == "ht" else p.max_3d_wie
    colored = np.ndim(sigma) >= 1
    if colored:
        stds = torch.as_tensor(np.asarray(sigma), dtype=dt, device=dev)
    else:
        sig = host_scalar(sigma, dt)
    with full_precision_matmul():
        k2f, k2i = core._kron_pair(bs, p.transform_ht if mode == "ht" else p.transform_wie,
                                   p.dec_level if mode == "ht" else 0, z)
        gz = core._group_coeffs(core._extract_blocks(z, bs) @ k2f.T, bm.pos, nw)
        hat = torch.zeros_like(gz)
        wts = gz.new_zeros(*gz.shape[:-2], k_max)
        if mode == "wie":
            gp = core._group_coeffs(core._extract_blocks(pilot, bs) @ k2f.T, bm.pos, nw)
            mu2 = host_scalar(p.mu2, dt)
            if colored:
                vars_w = stds * stds * float(mu2)
            else:
                sw = sig * host_scalar(p.mu2**0.5, dt)
                sw2 = float(sw * sw)
        else:
            lam = float(host_scalar(p.lambda_thr3d, dt))
            if colored:
                thr = lam * stds
                vars_d = stds * stds
                floor = vars_d.mean()
            else:
                thr = float(host_scalar(lam, dt) * sig)
                s2 = float(sig * sig)
        for s, hf, hi in zip(*core._haar_bank(k_max, z)):
            cz = hf @ gz[..., :s, :]
            if mode == "ht":
                keep = cz.abs() > thr
                cz = torch.where(keep, cz, torch.zeros_like(cz))
                if colored:
                    w_g = 1.0 / torch.maximum((keep * vars_d).sum(dim=(-2, -1)), floor + 1e-12)
                else:
                    w_g = 1.0 / (s2 * keep.sum(dim=(-2, -1)).to(dt).clamp_min(1.0))
            else:
                cp = hf @ gp[..., :s, :]
                if colored:
                    wien = cp * cp / (cp * cp + vars_w)
                    w_g = 1.0 / (wien * wien * vars_w).sum(dim=(-2, -1)).clamp_min(1e-10)
                else:
                    wien = cp * cp / (cp * cp + sw2)
                    w_g = 1.0 / (sw2 * (wien * wien).sum(dim=(-2, -1)).clamp_min(1e-10))
                cz = cz * wien
            hat, wts = core._select_size(hat, wts, hi @ cz, w_g, bm.counts, s, k_max)
        hat_spatial = hat @ k2i.T
    window = tr.kaiser_window(bs, p.beta if mode == "ht" else p.beta_wie)
    return core._aggregate((h, w), hat_spatial, wts, bm.pos, window)


def bm3d_multichannel(z, sigma, profile: core.BM3DProfile = core.DEFAULT_PROFILE, device=None) -> torch.Tensor:
    """Multichannel BM3D of (..., H, W, C) images: block matching on the
    first channel only, shared by every channel in both stages (the
    reference's multichannel path, ``bm3d307/examples/
    bm3d_demo_multichannel.py:5-7``).

    ``sigma``: a scalar std, a length-C vector of per-channel stds, or a
    PSD, (H, W) shared by the channels or (H, W, C) one a channel (the
    reference's ``sigma_psd: either MxN or MxNxC``, ``__init__.py:171-173``).
    A colored PSD runs with PSD-estimated (lambda, mu^2) and
    per-coefficient variances (its estimation needs the reference's
    database); the matching stays shared.
    """
    z = _on(z, device)
    if z.dim() < 3:
        raise ValueError("bm3d_multichannel expects (..., H, W, C)")
    h, w, c = z.shape[-3:]
    sig_np = np.asarray(sigma, np.float64)

    chan: list = []  # per channel: (scalar std or guarded PSD, profile)
    if sig_np.ndim >= 2:
        if sig_np.ndim == 2:
            psds = [sig_np] * c
        elif sig_np.shape == (h, w, c):
            psds = [sig_np[..., ch] for ch in range(c)]
        else:
            raise ValueError(f"PSD shape {sig_np.shape} must be (H, W) or (H, W, C) for image shape {(h, w, c)}")
        for psd in psds:
            if _is_flat(psd):
                chan.append((float(np.sqrt(psd.mean() / (h * w))), profile))
            else:
                chan.append(_auto_profile(psd, profile))
    else:
        chan = [(float(s), profile) for s in np.broadcast_to(np.atleast_1d(sig_np), (c,))]

    def stds(entry, stage):
        s, prof = entry
        if isinstance(s, np.ndarray):  # a guarded PSD
            if stage == "ht":
                return core.psd_to_coeff_stds(s, prof.transform_ht, prof.bs_ht, dec_level=prof.dec_level)
            return core.psd_to_coeff_stds(s, prof.transform_wie, prof.bs_wie)
        return s

    zc = z.movedim(-1, 0)  # (C, ..., H, W)
    bm_ht = compute_blockmatches(zc[0], profile, "ht", device=z.device)
    pilots = [_stage_with_matches(zc[ch], None, stds(chan[ch], "ht"), chan[ch][1], bm_ht, "ht") for ch in range(c)]
    bm_wie = compute_blockmatches(pilots[0], profile, "wie", device=z.device)
    outs = [_stage_with_matches(zc[ch], pilots[ch], stds(chan[ch], "wie"), chan[ch][1], bm_wie, "wie")
            for ch in range(c)]
    return torch.stack(outs, dim=-1)


def bm3d_rgb(z_rgb, sigma, profile: core.BM3DProfile = core.DEFAULT_PROFILE, device=None) -> torch.Tensor:
    """Color BM3D of (..., H, W, 3) images in [0, 1] at one std per RGB
    channel: the opponent color transform, block matching on the
    luminance shared by the three channels (reference ``bm3d_rgb``)."""
    z_rgb = _on(z_rgb, device)
    dt, dev = z_rgb.dtype, z_rgb.device
    with full_precision_matmul():
        opp = z_rgb @ torch.as_tensor(_OPP, dtype=dt, device=dev).T
    # the noise std of each opponent channel scales with the row norms
    row_scales = np.sqrt((_OPP**2).sum(axis=1))
    sig = np.float64(host_scalar(sigma, dt))
    oc = opp.movedim(-1, 0)
    bm_ht = compute_blockmatches(oc[0], profile, "ht", device=dev)
    pilots = [_stage_with_matches(oc[c], None, sig * row_scales[c], profile, bm_ht, "ht") for c in range(3)]
    bm_wie = compute_blockmatches(pilots[0], profile, "wie", device=dev)
    outs = [_stage_with_matches(oc[c], pilots[c], sig * row_scales[c], profile, bm_wie, "wie") for c in range(3)]
    with full_precision_matmul():
        return torch.stack(outs, dim=-1) @ torch.as_tensor(_OPP_INV, dtype=dt, device=dev).T


def bm3d_deblurring(z, sigma, psf, profile: core.BM3DProfile = core.DEFAULT_PROFILE, reg: Optional[float] = None,
                    colored: bool = True, device=None) -> torch.Tensor:
    """Deblurring of (..., H, W) images by a regularized inverse and
    collaborative filtering (reference ``bm3d_deblurring:92-135``).

    z = blurred + noise; psf: the blur kernel. The inverse's residual noise
    is colored (PSD ``sigma^2 H W |inv|^2``): by default it feeds the
    exact-variance colored core (whose parameter estimation needs the
    reference's database); ``colored=False`` takes the white core at the
    band-average std. ``reg`` scales the Tikhonov term ``reg sigma^2 H W``;
    by default 4e-4 (the reference's ``regularization_alpha_ri``,
    ``__init__.py:120``) for the colored core and 1e-2 for the white one.
    """
    from pnp_admm_cnc_mri_torch.ops import sisr

    if reg is None:
        reg = 4e-4 if colored else 1e-2
    z = _on(z, device)
    h, w = z.shape[-2:]
    otf = sisr.psf2otf(torch.as_tensor(np.asarray(psf), device=z.device).to(z.dtype), (h, w))
    sig = host_scalar(sigma, z.dtype)
    inv = torch.conj(otf) / (torch.abs(otf) ** 2 + float(reg * sig**2 * h * w))
    zi = torch.real(torch.fft.ifft2(torch.fft.fft2(z) * inv))
    if colored:
        psd_col = np.float64(sig) ** 2 * h * w * np.abs(inv.cpu().numpy()) ** 2
        return core.bm3d_colored_auto(zi, psd_col, profile, device=z.device)
    # the residual noise PSD |inv|^2 sigma^2: its average std for the white core
    sigma_eff = float(sig) * torch.sqrt(torch.mean(torch.abs(inv) ** 2))
    return core.bm3d(zi, sigma_eff, profile, prefilter=False, device=z.device)


def estimate_parameters_for_psd(psd: np.ndarray):
    """(lambda_thr3d, mu2, lambda_re, mu2_re) from an image-size PSD:
    ``psd_params.estimate_parameters_for_image_psd`` (the canonical 65x65
    normalization and the feature-database matching; white PSDs give
    (3.0, 0.4, 2.5, 3.6)), with the white constants for a flat PSD when
    scipy's pieces fail; a colored PSD without the database raises
    ``FileNotFoundError``."""
    from pnp_admm_cnc_mri_torch.priors.bm3d import psd_params

    try:
        return psd_params.estimate_parameters_for_image_psd(np.asarray(psd, np.float64))
    except FileNotFoundError:
        raise
    except Exception:
        if float(np.std(psd) / (np.mean(psd) + 1e-12)) < 0.1:
            return 3.0, 0.4, 2.5, 3.6
        raise


def get_filtered_residual(z: torch.Tensor, y_hat: torch.Tensor, sigma, residual_thr: float = 3.0):
    """The significant structure left in ``z - y_hat`` (reference
    ``get_filtered_residual:337-388``, the white-noise circular path):
    Fourier bins above ``residual_thr`` noise stds, dilated by a small
    wrap-around Gaussian. ``sigma``: a number or one std an image (a tensor
    of shape z.shape[:-2]). Returns (remains, remains_psd): the retained
    structure and the white PSD masked to the detected band.
    """
    h, w = z.shape[-2:]
    dt, dev = z.dtype, z.device
    if torch.is_tensor(sigma):
        sig = sigma.to(dtype=dt, device=dev).reshape(*sigma.shape, 1, 1)
    else:
        sig = host_scalar(sigma, dt)
    resid = torch.fft.fft2(z - y_hat)
    psd = sig**2 * h * w  # the white PSD of each bin, rounded as the JAX package rounds it
    thr = residual_thr * (torch.sqrt(psd) if torch.is_tensor(psd) else float(np.sqrt(psd)))
    exceed = (torch.abs(resid) > thr).to(dt)
    # dilate the detection mask with a small wrap-around Gaussian
    ks = int(np.ceil(h / 150))
    ks += 1 - ks % 2
    g1 = np.exp(-np.arange(-(ks // 2), ks // 2 + 1) ** 2 / (2.0 * max(h / 500, 0.5) ** 2))
    kern = np.roll(np.pad(np.outer(g1, g1), ((0, h - ks), (0, w - ks))), (-(ks // 2), -(ks // 2)), axis=(0, 1))
    kern_f = torch.fft.fft2(torch.as_tensor(kern, device=dev).to(dt))
    msk = torch.real(torch.fft.ifft2(torch.fft.fft2(exceed) * kern_f)) > 0.01
    remains = torch.real(torch.fft.ifft2(resid * msk))
    return remains, psd * msk.to(dt)


def bm3d_refilter(z, sigma, profile: core.BM3DProfile = core.DEFAULT_PROFILE, residual_thr: float = 3.0,
                  lambda_re: float = 2.5, mu2_re: float = 3.6, colored: bool = False, device=None) -> torch.Tensor:
    """Two-stage BM3D with residual refiltering (the reference's
    ``denoise_residual=True`` path, ``:276-318``): the structure the first
    pass removed is found in the Fourier residual, added back and denoised
    again at the refiltering parameters (the reference's white-PSD values
    lambda 2.5, mu^2 3.6).

    The second pass takes each image's band-average std of the remains (at
    least 1e-4) as a per-image tensor, never read on the host.
    ``colored=True`` feeds each image's colored PSD of the remains to the
    exact-variance core instead, one image at a time on the host.
    """
    z = _on(z, device)
    sig = float(host_scalar(sigma, z.dtype))
    y1 = core.bm3d(z, sig, profile, device=z.device)
    remains, remains_psd = get_filtered_residual(z, y1, sig, residual_thr)
    prof_re = dataclasses.replace(profile, lambda_thr3d=lambda_re, mu2=mu2_re)
    z2 = y1 + remains
    if colored:
        h, w = z.shape[-2:]
        outs = []
        for y1_i, z2_i, psd_i in zip(y1.reshape(-1, h, w), z2.reshape(-1, h, w),
                                     remains_psd.broadcast_to(z.shape).reshape(-1, h, w)):
            psd_np = psd_i.cpu().numpy().astype(np.float64)
            if psd_np.max() <= 0.0:
                outs.append(y1_i)  # nothing significant remained
            else:
                outs.append(core.bm3d_colored(z2_i, np.maximum(psd_np, psd_np.max() * 1e-4), prof_re, exact=True,
                                              device=z.device))
        return torch.stack(outs).reshape(z.shape)
    h, w = z.shape[-2:]
    sigma_re = torch.sqrt(remains_psd.mean(dim=(-2, -1)) / (h * w))
    # nothing significant left: sigma_re ~ 0 and the second pass is near the identity
    sigma_re = sigma_re.clamp_min(1e-4)
    return core.bm3d(z2, sigma_re, prof_re, "all", prefilter=False, device=z.device)
