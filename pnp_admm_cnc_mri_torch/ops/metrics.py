"""Image quality metrics on the [0, 255] scale, in float64.

Port of the JAX package's ``ops/metrics.py`` (reference
``utils_image.py:543-636``): PSNR, the complex-tolerant PSNR,
MATLAB-compatible SSIM (11x11 Gaussian window, sigma 1.5, valid region),
the relative error, and all three of a [0, 1] reconstruction at once. Inputs of shape
(..., H, W) reduce over the trailing two axes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _crop(img: torch.Tensor, border: int) -> torch.Tensor:
    return img[..., border:-border, border:-border] if border else img


def psnr(img1: torch.Tensor, img2: torch.Tensor, border: int = 0) -> torch.Tensor:
    diff = _crop(img1, border).to(torch.float64) - _crop(img2, border).to(torch.float64)
    mse = torch.mean(diff * diff, dim=(-2, -1))
    return 20.0 * torch.log10(255.0 / torch.sqrt(mse))


def psnr_complex(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The reference's second PSNR (``utils/utils.py:12-17``): built on
    ``|x - ref|^2``, so it takes the complex zero-filled start too."""
    diff = torch.abs(x - ref)
    mse = torch.mean(diff * diff, dim=(-2, -1))
    return 10.0 * torch.log10(255.0**2 / mse)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """Normalized 2-D Gaussian window, ``outer(k, k)`` of OpenCV's
    ``getGaussianKernel(11, 1.5)``."""
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(coords**2) / (2.0 * sigma**2))
    k /= k.sum()
    return np.outer(k, k)


def _filter2_valid(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Valid-region 2-D correlation over the trailing axes, batched."""
    batch_shape = img.shape[:-2]
    h, w = img.shape[-2:]
    out = F.conv2d(img.reshape(-1, 1, h, w), window[None, None])
    return out.reshape(*batch_shape, *out.shape[-2:])


def ssim(img1: torch.Tensor, img2: torch.Tensor, border: int = 0) -> torch.Tensor:
    img1 = _crop(img1, border).to(torch.float64)
    img2 = _crop(img2, border).to(torch.float64)
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    window = torch.as_tensor(_gaussian_window(11, 1.5), device=img1.device)
    mu1 = _filter2_valid(img1, window)
    mu2 = _filter2_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2_valid(img1 * img1, window) - mu1_sq
    sigma2_sq = _filter2_valid(img2 * img2, window) - mu2_sq
    sigma12 = _filter2_valid(img1 * img2, window) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map, dim=(-2, -1))


def relative_error(img1: torch.Tensor, img2: torch.Tensor, border: int = 0) -> torch.Tensor:
    """``||img2 - img1||_F / ||img2||_F`` (img2 is the ground truth)."""
    img1 = _crop(img1, border).to(torch.float64)
    img2 = _crop(img2, border).to(torch.float64)
    num = torch.sqrt(torch.sum((img2 - img1) ** 2, dim=(-2, -1)))
    den = torch.sqrt(torch.sum(img2**2, dim=(-2, -1)))
    return num / den


def all_metrics(recon01: torch.Tensor, truth_uint: torch.Tensor, border: int = 0) -> dict:
    """PSNR, SSIM and RE of a [0, 1] reconstruction scored as ``x * 255``
    against a [0, 255] ground truth (reference ``ADMM_L1.py:133-146``)."""
    img_e = recon01 * 255.0
    return {
        "psnr": psnr(img_e, truth_uint, border),
        "ssim": ssim(img_e, truth_uint, border),
        "re": relative_error(img_e, truth_uint, border),
    }
