"""Closed-form super-resolution and deblurring data solution (SISR).

Port of the JAX package's ``ops/sisr.py`` (the reference's vendored
``utils/utils_sisr.py``, KAIR/DPIR: ``data_solution:243``,
``pre_calculate:255``), with torch's complex FFTs. Solves, in closed form
per HQS iteration,

    x* = argmin_x ||S H x - y||^2 + alpha ||x - z||^2

where H is circular convolution with kernel k and S the sf-fold
down-sampler (the top-left pixel of each sf x sf block), by the
frequency-domain Woodbury identity over the sf x sf aliasing blocks.
Tensors have shape (..., H, W); the leading axes are independent images.
The kernel generators and the shift-tolerant scoring stay host numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def psf2otf(psf: torch.Tensor, shape) -> torch.Tensor:
    """Zero-pad the PSF to ``shape``, circularly center it, then FFT (MATLAB
    ``psf2otf``; reference ``utils_sisr.psf2otf``)."""
    kh, kw = psf.shape[-2:]
    h, w = shape
    pad = psf.new_zeros(*psf.shape[:-2], h, w)
    pad[..., :kh, :kw] = psf
    pad = torch.roll(pad, shifts=(-(kh // 2), -(kw // 2)), dims=(-2, -1))
    return torch.fft.fft2(pad)


def upsample_zeros(x: torch.Tensor, sf: int) -> torch.Tensor:
    """S^T: zero-insertion upsampling keeping the top-left position
    (reference ``utils_sisr.upsample``)."""
    h, w = x.shape[-2:]
    out = x.new_zeros(*x.shape[:-2], h * sf, w * sf)
    out[..., ::sf, ::sf] = x
    return out


def downsample(x: torch.Tensor, sf: int) -> torch.Tensor:
    """S: the top-left pixel of each sf x sf block."""
    return x[..., ::sf, ::sf]


def _block_mean(a: torch.Tensor, sf: int) -> torch.Tensor:
    """Mean over the sf x sf aliasing blocks of a spectrum (reference
    ``splits`` + mean): (..., H, W) -> (..., H/sf, W/sf). H splits into
    (sf, H/sf), so entry (i, j) averages the bins (i + p H/sf, j + q W/sf):
    the aliasing quadrants, not a pooling of neighbouring bins."""
    h, w = a.shape[-2:]
    hs, ws = h // sf, w // sf
    return a.reshape(*a.shape[:-2], sf, hs, sf, ws).mean(dim=(-4, -2))


def _tile(a: torch.Tensor, sf: int) -> torch.Tensor:
    return a.repeat(*([1] * (a.dim() - 2)), sf, sf)


def pre_calculate(y: torch.Tensor, k: torch.Tensor, sf: int):
    """Iteration-invariant spectra (reference ``pre_calculate:255``).

    y: (..., h, w) low-res observation; k: blur kernel (kh, kw) of y's
    dtype. Returns (FB, FBC, F2B, FBFy) on the (h sf, w sf) grid.
    """
    h, w = y.shape[-2:]
    fb = psf2otf(torch.as_tensor(k, dtype=y.dtype, device=y.device), (h * sf, w * sf))
    fbc = torch.conj(fb)
    f2b = torch.abs(fb) ** 2
    fbfy = fbc * torch.fft.fft2(upsample_zeros(y, sf))
    return fb, fbc, f2b, fbfy


def data_solution(z, fb, fbc, f2b, fbfy, alpha, sf: int) -> torch.Tensor:
    """One closed-form x-update (reference ``data_solution:243``). z: (...,
    H, W), the prior's output; alpha: a number. Returns the real solution."""
    fr = fbfy + torch.fft.fft2(alpha * z)
    fbr = _block_mean(fb * fr, sf)
    invw = _block_mean(f2b, sf)
    invwbr = fbr / (invw + alpha)
    fx = (fr - fbc * _tile(invwbr, sf)) / alpha
    return torch.real(torch.fft.ifft2(fx))


def deblur_solution(z, f2b, fbfy, alpha) -> torch.Tensor:
    """The closed-form x-update for pure (sf = 1) deblurring,
    ``Fx = (FBC Fy + alpha Fz) / (|FB|^2 + alpha)``, the diagonal solve that
    :func:`data_solution` collapses to without decimation."""
    fr = fbfy + alpha * torch.fft.fft2(z)
    return torch.real(torch.fft.ifft2(fr / (f2b + alpha)))


def _block_sum(a: torch.Tensor, sf: int) -> torch.Tensor:
    """Sum over the sf x sf aliasing blocks (reference ``BlockMM:50``): the
    block mean times the block count."""
    return _block_mean(a, sf) * (sf * sf)


def invls(fb, fbc, f2b, fr, tau, sf: int) -> torch.Tensor:
    """The MATLAB-style solve (reference ``INVLS:66`` / ``BlockMM:50``): the
    Woodbury identity of :func:`data_solution` with block sums and the
    denominator ``invW + tau Nb``."""
    nb = sf * sf
    fbr = _block_sum(fb * fr, sf)
    invw = _block_sum(f2b, sf)
    invwbr = fbr / (invw + tau * nb)
    fx = (fr - fbc * _tile(invwbr, sf)) / tau
    return torch.real(torch.fft.ifft2(fx))


# ---------------------------------------------------------------------------
# Circular filtering and the G / G^T degradation pair
# ---------------------------------------------------------------------------


def wrap_convolve(x: torch.Tensor, k) -> torch.Tensor:
    """Circular convolution with an odd-sized centered kernel, as
    ``scipy.ndimage.convolve(x, k, mode='wrap')`` (the reference's
    ``imfilter_np``, ``utils_sisr.py:397-403``), in the Fourier domain."""
    otf = psf2otf(torch.as_tensor(k, dtype=x.dtype, device=x.device), x.shape[-2:])
    return torch.real(torch.fft.ifft2(torch.fft.fft2(x) * otf))


def wrap_correlate(x: torch.Tensor, k) -> torch.Tensor:
    """Circular cross-correlation (the reference's torch ``imfilter``:
    circular pad and ``conv2d``, ``utils_sisr.py:489-496``)."""
    otf = psf2otf(torch.as_tensor(k, dtype=x.dtype, device=x.device), x.shape[-2:])
    return torch.real(torch.fft.ifft2(torch.fft.fft2(x) * torch.conj(otf)))


def G(x: torch.Tensor, k, sf: int = 3) -> torch.Tensor:
    """Forward degradation: circular filter, then sf-fold downsampling
    (reference ``G``, ``utils_sisr.py:499-511``; correlation, as the torch
    original)."""
    return downsample(wrap_correlate(x, k), sf)


def Gt(x: torch.Tensor, k, sf: int = 3) -> torch.Tensor:
    """The transpose direction: zero-insertion upsampling, then the
    circular filter (reference ``Gt``, ``utils_sisr.py:514-526``)."""
    return wrap_correlate(upsample_zeros(x, sf), k)


def interpolation_down(x: torch.Tensor, sf: int, center: bool = False):
    """Decimation observation triple (reference ``utils_sisr.py:529-543``):
    ``(lr, y, mask)``, the kept samples, the zero-filled full-size image and
    the sampling mask."""
    mask = torch.zeros_like(x)
    start = (sf - 1) // 2 if center else 0
    mask[..., start::sf, start::sf] = 1
    return x[..., start::sf, start::sf], x * mask, mask


# ---------------------------------------------------------------------------
# Degradation models (SRMD / DPSR / classical; reference :550-628)
# ---------------------------------------------------------------------------


def bicubic_degradation(x: torch.Tensor, sf: int = 3) -> torch.Tensor:
    """MATLAB-bicubic downscaling (reference ``utils_sisr.py:550-560``), of
    (..., H, W) batches."""
    from pnp_admm_cnc_mri_torch.ops import resize

    return resize.imresize(x, 1.0 / sf)


def srmd_degradation(x: torch.Tensor, k, sf: int = 3) -> torch.Tensor:
    """Circular blur, then bicubic downsampling (SRMD; reference
    ``utils_sisr.py:563-585``)."""
    return bicubic_degradation(wrap_convolve(x, k), sf)


def dpsr_degradation(x: torch.Tensor, k, sf: int = 3) -> torch.Tensor:
    """Bicubic downsampling, then the circular blur (DPSR; reference
    ``utils_sisr.py:588-610``)."""
    return wrap_convolve(bicubic_degradation(x, sf), k)


def classical_degradation(x: torch.Tensor, k, sf: int = 3) -> torch.Tensor:
    """Circular blur, then sf-fold decimation from position 0 (reference
    ``utils_sisr.py:614-628``)."""
    return downsample(wrap_convolve(x, k), sf)


# ---------------------------------------------------------------------------
# Blur-kernel generators (host numpy; reference :692-726, :819-880)
# ---------------------------------------------------------------------------


def gm_blur_kernel(mean, cov, size: int = 15) -> np.ndarray:
    """Gaussian-density blur kernel on the reference's off-by-half grid
    (``utils_sisr.py:714-724``: ``center = size/2 + 0.5``, ``c = idx -
    center + 1``), normalized to sum 1."""
    center = size / 2.0 + 0.5
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    cy = yy - center + 1
    cx = xx - center + 1
    z = np.stack([cx - mean[0], cy - mean[1]], axis=-1)
    icov = np.linalg.inv(np.asarray(cov, np.float64))
    quad = np.einsum("...i,ij,...j->...", z, icov, z)
    k = np.exp(-0.5 * quad)
    return k / k.sum()


def anisotropic_gaussian(ksize: int = 15, theta: float = np.pi, l1: float = 6.0, l2: float = 6.0) -> np.ndarray:
    """Anisotropic Gaussian kernel with eigenvalues ``l1 >= l2`` rotated by
    ``theta`` (reference ``anisotropic_Gaussian``, ``utils_sisr.py:692-711``:
    covariance ``V diag(l1, l2) V^{-1}`` with ``V = [[cos, sin], [sin, -cos]]``)."""
    v = np.array([math.cos(theta), math.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    sigma = V @ np.diag([l1, l2]) @ np.linalg.inv(V)
    return gm_blur_kernel(mean=[0.0, 0.0], cov=sigma, size=ksize)


def gen_kernel(k_size=(15, 15), scale_factor=(4, 4), min_var: float = 0.6, max_var: float = 10.0,
               noise_level: float = 0.0, rng: np.random.Generator | None = None) -> np.ndarray:
    """Random shifted anisotropic Gaussian kernel for blind-SR data
    (reference ``gen_kernel``, ``utils_sisr.py:819-880``); the mean is
    shifted by ``-0.5 (sf - 1)`` to align the downsampled grid."""
    rng = np.random.default_rng() if rng is None else rng
    k_size = np.asarray(k_size)
    scale_factor = np.asarray(scale_factor)
    lambda_1 = min_var + rng.random() * (max_var - min_var)
    lambda_2 = min_var + rng.random() * (max_var - min_var)
    theta = rng.random() * np.pi
    noise = -noise_level + rng.random(tuple(k_size)) * noise_level * 2

    Q = np.array([[math.cos(theta), -math.sin(theta)], [math.sin(theta), math.cos(theta)]])
    inv_sigma = np.linalg.inv(Q @ np.diag([lambda_1, lambda_2]) @ Q.T)

    mu = k_size // 2 - 0.5 * (scale_factor - 1)
    X, Y = np.meshgrid(np.arange(k_size[0]), np.arange(k_size[1]))
    zz = np.stack([X, Y], axis=-1).astype(np.float64) - mu
    quad = np.einsum("...i,ij,...j->...", zz, inv_sigma, zz)
    raw = np.exp(-0.5 * quad) * (1 + noise)
    return raw / raw.sum()


def _bilinear_grid_sample(img: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """``img`` on the separable grid ``ys x xs``, bilinear, edge-clamped
    (scipy ``interp2d(..., kind='linear')`` on in-range points)."""
    ys = np.clip(ys, 0, img.shape[0] - 1)
    xs = np.clip(xs, 0, img.shape[1] - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, img.shape[0] - 1)
    x1 = np.minimum(x0 + 1, img.shape[1] - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return (1 - wy) * ((1 - wx) * a + wx * b) + wy * ((1 - wx) * c + wx * d)


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """Half-grid pixel shift aligning SR kernels and images across scale
    factors (reference ``shift_pixel``, ``utils_sisr.py:782-812``)."""
    x = np.asarray(x, np.float64)
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5 if upper_left else -(sf - 1) * 0.5
    xs = np.arange(w, dtype=np.float64) + shift
    ys = np.arange(h, dtype=np.float64) + shift
    if x.ndim == 2:
        return _bilinear_grid_sample(x, ys, xs)
    out = np.empty_like(x)
    for c in range(x.shape[-1]):
        out[..., c] = _bilinear_grid_sample(x[..., c], ys, xs)
    return out


def comp_upto_shift(i1: np.ndarray, i2: np.ndarray, maxshift: int = 5, border: int = 15,
                    min_interval: float = 0.25):
    """Shift-tolerant PSNR and SSIM (reference ``comp_upto_shift``,
    ``utils_sisr.py:636-688``) of grayscale (H, W) images on the [0, 255]
    scale: the best sub-pixel translation of ``i1`` against ``i2`` by SSD.
    Returns ``(psnr, ssim, (dy, dx))``."""
    from pnp_admm_cnc_mri_torch.ops import metrics

    i2c = np.asarray(i2, np.float64)[border:-border, border:-border]
    i1c = np.asarray(i1, np.float64)[border - maxshift:-border + maxshift, border - maxshift:-border + maxshift]
    n1, n2 = i2c.shape
    shifts = np.linspace(-maxshift, maxshift, int(2 * maxshift / min_interval + 1))
    base_y = np.arange(n1, dtype=np.float64) + maxshift
    base_x = np.arange(n2, dtype=np.float64) + maxshift
    best = (np.inf, 0.0, 0.0, None)
    for sy in shifts:
        for sx in shifts:
            t = _bilinear_grid_sample(i1c, base_y + sy, base_x + sx)
            ssd = float(np.sum((t - i2c) ** 2))
            if ssd < best[0]:
                best = (ssd, sy, sx, t)
    _, sy, sx, t = best
    t_t, ref_t = torch.from_numpy(t), torch.from_numpy(i2c)
    return float(metrics.psnr(t_t, ref_t)), float(metrics.ssim(t_t, ref_t)), (sy, sx)


# ---------------------------------------------------------------------------
# PCA kernel projection (reference :734-779)
# ---------------------------------------------------------------------------


def get_pca_matrix(x: np.ndarray, dim_pca: int = 15) -> np.ndarray:
    """Top-``dim_pca`` eigenvector projection of a (d, N) kernel sample
    matrix (reference ``get_pca_matrix``, ``utils_sisr.py:734-747``)."""
    _, v = np.linalg.eigh(x @ x.T)
    return v[:, -dim_pca:].T


def cal_pca_matrix(ksize: int = 15, l_max: float = 12.0, dim_pca: int = 15, num_samples: int = 500,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """The PCA projection of random anisotropic Gaussians (reference
    ``cal_pca_matrix``, ``utils_sisr.py:759-779``; column-major kernel
    flattening), as a (dim_pca, ksize^2) matrix."""
    rng = np.random.default_rng() if rng is None else rng
    kernels = np.zeros((ksize * ksize, num_samples), np.float64)
    for i in range(num_samples):
        theta = np.pi * rng.random()
        l1 = 0.1 + l_max * rng.random()
        l2 = 0.1 + (l1 - 0.1) * rng.random()
        kernels[:, i] = anisotropic_gaussian(ksize, theta, l1, l2).flatten(order="F")
    return get_pca_matrix(kernels, dim_pca=dim_pca)
