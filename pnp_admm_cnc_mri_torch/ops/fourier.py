"""Masked 2-D Fourier forward model and the ADMM data-consistency solve.

Port of the JAX package's ``ops/fourier.py``. The physics (reference
``ADMM_L1.py:97-120``):

    y = fft2(img) * mask + noise
    xf = fft2(z - w); xf[mask] = (La2 * xf[mask] + y[mask]) / (1 + La2)
    x = |real(ifft2(xf))|          with La2 = 1/(2 rho)

Every function treats the trailing two axes as the image plane and
broadcasts over leading axes. Transforms use ``torch.fft``'s default
``norm="backward"``, which is numpy's and JAX's convention.
"""

from __future__ import annotations

import contextlib
import math

import torch

DC_METHODS = ("auto", "fft", "matmul")


def fft2(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized 2-D FFT over the trailing two axes."""
    return torch.fft.fft2(x, dim=(-2, -1))


def ifft2(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized-forward 2-D inverse FFT (scaled by 1/(H W))."""
    return torch.fft.ifft2(x, dim=(-2, -1))


def observe(img: torch.Tensor, mask: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """K-space observations ``y = F(img) * mask + noise`` (noise over the
    full plane; the solves read y only where the mask samples)."""
    return fft2(img) * mask + noise


def zero_fill(y: torch.Tensor) -> torch.Tensor:
    """Zero-filled complex reconstruction ``ifft2(y)``."""
    return ifft2(y)


def data_term_gradient(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The complex gradient ``A^H (A x - y)`` of the data term (reference
    ``utils/utils.py:50-55``, ``Df``): ``ifft2(mask fft2(x) - y)``, with y
    read only where the mask samples. Full complex spectrum, as in JAX."""
    res = fft2(x) * mask
    res = torch.where(mask != 0, res - y, res)
    return ifft2(res)


def data_consistency(v: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, rho) -> torch.Tensor:
    """ADMM x-update on the full spectrum: the pointwise k-space blend at
    sampled frequencies, then ``|real(ifft2(.))|`` (the magnitude projection
    is part of the reference's algorithm, kept for parity)."""
    vf = fft2(v)
    la2 = 1.0 / (2.0 * rho)
    blended = (la2 * vf + y) / (1.0 + la2)
    xf = torch.where(mask != 0, blended, vf)
    return torch.abs(torch.real(ifft2(xf)))


@contextlib.contextmanager
def full_precision_matmul():
    """Float32 matrix products at full precision inside the block, and the
    caller's setting back after it.

    The 'matmul' data-consistency path runs its DFTs as float32 matrix
    products. TF32 keeps ~10 mantissa bits; on the TPU a single-pass bf16
    DFT cost 0.5 dB of reconstruction PSNR, so reduced-precision products
    stay off there until a measurement shows them harmless, whatever
    precision the caller chose for the rest of the process.

    Only cuBLAS's flag is read and set: torch's process-wide
    ``get_float32_matmul_precision`` raises once the caller has set the
    per-backend flags apart (``allow_tf32`` after a
    ``set_float32_matmul_precision``).
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dft_mats(n: int, dtype: torch.dtype, device=None):
    """(cos, sin) DFT matrices ``M[k, j] = trig(2 pi k j / n)``.

    The phase product is reduced mod n in integers before the float scale,
    so angles stay in [0, 2 pi) and float32 matrices stay accurate
    (unreduced k*j reaches (n-1)^2).
    """
    trig_dtype = torch.promote_types(dtype, torch.float32)
    k = torch.arange(n, dtype=torch.int64, device=device)
    kj = torch.outer(k, k) % n
    ang = (2.0 * math.pi / n) * kj.to(trig_dtype)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def matmul_rfft2(x: torch.Tensor, mats=None):
    """rfft2 over the trailing (H, W) axes as matrix products.

    Returns (real, imag) of shape (..., H, W//2+1). ``mats``: optional
    precomputed ``(cw, sw, ch, sh)`` from ``_dft_mats``.
    """
    h, w = x.shape[-2], x.shape[-1]
    wh = w // 2 + 1
    if mats is None:
        cw, sw = _dft_mats(w, x.dtype, x.device)
        ch, sh = _dft_mats(h, x.dtype, x.device)
    else:
        cw, sw, ch, sh = mats
    # rows (W axis), half spectrum: X = x @ (cos - i sin)^T
    xr = x @ cw[:, :wh]
    xi = -(x @ sw[:, :wh])
    # columns (H axis), full complex DFT: (c - i s)(xr + i xi)
    yr = ch @ xr + sh @ xi
    yi = ch @ xi - sh @ xr
    return yr, yi


def matmul_irfft2(yr: torch.Tensor, yi: torch.Tensor, h: int, w: int, mats=None) -> torch.Tensor:
    """Inverse of ``matmul_rfft2`` for a Hermitian half-spectrum:
    (real, imag) of shape (..., H, W//2+1) -> real (..., H, W)."""
    wh = w // 2 + 1
    if mats is None:
        cw, sw = _dft_mats(w, yr.dtype, yr.device)
        ch, sh = _dft_mats(h, yr.dtype, yr.device)
    else:
        cw, sw, ch, sh = mats
    # columns first: inverse complex DFT along H (conjugate transform / H)
    xr = (ch.mT @ yr - sh.mT @ yi) / h
    xi = (ch.mT @ yi + sh.mT @ yr) / h
    # rows: real synthesis from the half spectrum. Interior bins count twice
    # (their conjugate twins are implicit); DC and, for even W, Nyquist once.
    wk = torch.full((wh,), 2.0, dtype=yr.dtype, device=yr.device)
    wk[0] = 1.0
    if w % 2 == 0:
        wk[wh - 1] = 1.0
    return ((xr * wk) @ cw[:wh, :] - (xi * wk) @ sw[:wh, :]) / w


def rfft_blend_fields(y: torch.Tensor, mask: torch.Tensor, rho):
    """The blend fields ``(A, C)`` of the half-spectrum solve on the rfft
    half-grid (closed form in ``make_rfft_data_consistency``): A real, of
    the mask's shape with W//2+1 columns; C complex, of y's. Both in y's
    precision, contiguous."""
    w = mask.shape[-1]
    la2 = 1.0 / (2.0 * rho)
    # sampled means mask != 0, and y is read only at sampled entries (zero it
    # elsewhere so NaN or garbage there cannot leak in)
    m = (mask != 0).to(y.real.dtype)
    y = torch.where(m != 0, y, torch.zeros((), dtype=y.dtype, device=y.device))
    m_neg = torch.roll(torch.flip(m, dims=(-2, -1)), shifts=(1, 1), dims=(-2, -1))
    y_neg_conj = torch.conj(
        torch.roll(torch.flip(y, dims=(-2, -1)), shifts=(1, 1), dims=(-2, -1))
    ).resolve_conj()
    half = w // 2 + 1
    a_full = (2.0 - m - m_neg) / 2.0 + la2 * (m + m_neg) / (2.0 * (1.0 + la2))
    c_full = (m * y + m_neg * y_neg_conj) / (2.0 * (1.0 + la2))
    return a_full[..., :half].contiguous(), c_full[..., :half].contiguous()


def make_rfft_data_consistency(y: torch.Tensor, mask: torch.Tensor, rho, method: str = "fft"):
    """Half-spectrum (rfft) data-consistency solve: half the FFT work.

    Only the real part of ``ifft2(F)`` survives, so only the Hermitian part
    of the blended spectrum matters. On the rfft half-grid it is

        H = A .* V_half + C,
        A = (2 - m - m~)/2 + La2 (m + m~) / (2 (1 + La2))        (real)
        C = (m .* y + m~ .* conj(y(-k))) / (2 (1 + La2))         (complex)

    with ``m~(k) = m(-k)`` (``rfft_blend_fields``). A and C are computed once; each iteration is
    rfft2, one multiply-add and irfft2. ``method='matmul'`` runs the
    transforms as matrix products (``matmul_rfft2``/``matmul_irfft2``,
    under ``full_precision_matmul``); ``'auto'`` means ``'fft'`` in this
    package.

    Returns ``dc(v) -> x`` for real v of shape (..., H, W).
    """
    if method not in DC_METHODS:
        raise ValueError(f"unknown dc_method {method!r}; expected one of {DC_METHODS}")
    h, w = mask.shape[-2:]
    a_half, c_half = rfft_blend_fields(y, mask, rho)

    if method == "matmul":
        dt = y.real.dtype
        cr, ci = c_half.real.contiguous(), c_half.imag.contiguous()
        cw, sw = _dft_mats(w, dt, y.device)
        mats = (cw, sw, cw, sw) if h == w else (cw, sw, *_dft_mats(h, dt, y.device))

        def dc(v: torch.Tensor) -> torch.Tensor:
            m4 = tuple(t.to(v.dtype) for t in mats)
            a = a_half.to(v.dtype)
            with full_precision_matmul():
                vr, vi = matmul_rfft2(v, m4)
                x = matmul_irfft2(a * vr + cr.to(v.dtype), a * vi + ci.to(v.dtype), h, w, m4)
            return torch.abs(x)

        return dc

    def dc(v: torch.Tensor) -> torch.Tensor:
        vf = torch.fft.rfft2(v, dim=(-2, -1))
        hf = a_half * vf + c_half
        return torch.abs(torch.fft.irfft2(hf, s=(h, w), dim=(-2, -1)))

    return dc
