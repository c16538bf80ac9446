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


def _packed_dc_mats(h: int, w: int, dtype: torch.dtype, device=None):
    """The DFT matrices of the Nyquist-packed matmul solve (even W).

    The rfft half-grid is ``w // 2 + 1`` wide (129 at 256²). For even W the
    row transform's DC (k = 0) and Nyquist (k = W/2) outputs are both real,
    and the sine matrix's DC column (``sin 0 = 0``) computes nothing, so the
    Nyquist column rides in that slot through edits made once:

    - forward: ``swf[:, 0] = -(-1)^j`` makes ``xi[..., 0]`` the real Nyquist
      column, so the H-axis complex DFT of column 0 computes
      ``DFT(DC + i Nyq)``, two real transforms in one, split again by
      Hermitian symmetry;
    - inverse: ``swi[0, :] = -(-1)^w`` makes the otherwise dead imaginary
      slot of column 0 synthesize the Nyquist term ``x~_nyq (-1)^w``.

    Also returns ``ch - sh`` and ``ch + sh`` for the 3-product (Karatsuba)
    complex products along H: ``(C - iS)(xr + i xi)`` needs only ``C xr``,
    ``S xi`` and ``(C - S)(xr + xi)``.
    """
    cw, sw = _dft_mats(w, dtype, device)
    ch, sh = (cw, sw) if h == w else _dft_mats(h, dtype, device)
    whp = w // 2
    alt = cw[:, whp]  # cos(pi j) = (-1)^j
    swf = sw[:, :whp].clone()
    swf[:, 0] = -alt
    swi = sw[:whp, :].clone()
    swi[0, :] = -alt
    return cw[:, :whp], swf, ch, sh, ch - sh, ch + sh, cw[:whp, :], swi


def resolve_dc_method(method: str, y) -> str:
    """The data-consistency method that ``method`` names: ``'auto'`` gives
    ``'fft'``, on the CPU as in the JAX package and on the card too; any
    other name of ``DC_METHODS`` is returned as it is. ``y`` (the
    observations) keeps the JAX signature; the port's rule needs nothing of it.

    The JAX package's rule on an accelerator ('matmul' up to 1024 pixels a
    side: the DFT as matrix products on the TPU's matrix unit, faster than
    the TPU's FFT there) does not carry over: on the H100 the matmul forms
    are float32 products on the CUDA cores (TF32 stays off), against cuFFT.
    ``chip_smoke.py``'s catalog phase timed ``admm_l1`` at 512 x 256² x 50,
    float32, on an NVIDIA H100 80GB HBM3 at 700 W: 65.8 ms a solve with
    'fft', 207.5 to 211.3 ms with 'matmul' (the packed Karatsuba form).
    """
    if method not in DC_METHODS:
        raise ValueError(f"unknown dc_method {method!r}; expected one of {DC_METHODS}")
    return "fft" if method == "auto" else method


def make_rfft_data_consistency(y: torch.Tensor, mask: torch.Tensor, rho, method: str = "fft"):
    """Half-spectrum (rfft) data-consistency solve: half the FFT work.

    Only the real part of ``ifft2(F)`` survives, so only the Hermitian part
    of the blended spectrum matters. On the rfft half-grid it is

        H = A .* V_half + C,
        A = (2 - m - m~)/2 + La2 (m + m~) / (2 (1 + La2))        (real)
        C = (m .* y + m~ .* conj(y(-k))) / (2 (1 + La2))         (complex)

    with ``m~(k) = m(-k)`` (``rfft_blend_fields``). A and C are computed once; each iteration is
    rfft2, one multiply-add and irfft2. ``method='matmul'`` runs the
    transforms as matrix products under ``full_precision_matmul``: for even
    W the Nyquist-packed form with Karatsuba products
    (``_make_packed_matmul_dc``), for odd W, which has no Nyquist bin, the
    unpacked ``matmul_rfft2``/``matmul_irfft2``. ``'auto'`` means ``'fft'``
    (``resolve_dc_method``).

    Returns ``dc(v) -> x`` for real v of shape (..., H, W).
    """
    method = resolve_dc_method(method, y)
    h, w = mask.shape[-2:]
    a_half, c_half = rfft_blend_fields(y, mask, rho)

    if method == "matmul":
        dt = y.real.dtype
        cr, ci = c_half.real.contiguous(), c_half.imag.contiguous()
        if w % 2 == 0:
            return _make_packed_matmul_dc(a_half, cr, ci, h, w, dt)
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


def _make_packed_matmul_dc(a_half, cr, ci, h: int, w: int, dt):
    """The Nyquist-packed matmul solve (even W; ``_packed_dc_mats``), with
    the H-axis complex products in 3 matrix products instead of 4
    (Karatsuba). The same math as the unpacked matmul path, equal in exact
    arithmetic.

    Column 0 of the half-grid arrays carries the packed pair
    ``DC + i Nyquist``; the blend unpacks it by Hermitian split (both blended
    columns are Hermitian along H: ``a(-k) = a(k)``, ``c(-k) = conj(c(k))``
    there), so the inverse H-transform of the re-packed column is exactly
    ``x~_dc + i x~_nyq`` with both parts real.
    """
    whp = w // 2
    pmats = _packed_dc_mats(h, w, dt, a_half.device)
    a_w, cr_w, ci_w = a_half[..., :whp], cr[..., :whp], ci[..., :whp]
    a0, an = a_half[..., 0], a_half[..., -1]
    c0r, c0i, cnr, cni = cr[..., 0], ci[..., 0], cr[..., -1], ci[..., -1]

    def rev(p):  # the index m -> (-m) mod h along the trailing axis
        return torch.roll(torch.flip(p, dims=(-1,)), 1, -1)

    def dc(v: torch.Tensor) -> torch.Tensor:
        cwf, swf, ch, sh, cms, cps, cwi, swi = (m.to(v.dtype) for m in pmats)
        with full_precision_matmul():
            # W axis: the real DFT on W/2 columns; xi[..., 0] is the Nyquist column
            xr = v @ cwf
            xi = -(v @ swf)
            # H axis: y = (C - iS)(xr + i xi)
            m1, m2, m3 = ch @ xr, -(sh @ xi), cms @ (xr + xi)
            yr, yi = m1 - m2, m3 - m1 - m2
            # unpack column 0, P = DC + i Nyq, by Hermitian split along H
            pr, pi = yr[..., 0], yi[..., 0]
            prr, pir = rev(pr), rev(pi)
            dcr, dci = 0.5 * (pr + prr), 0.5 * (pi - pir)
            nqr, nqi = 0.5 * (pi + pir), 0.5 * (prr - pr)
            # blend both real-pair columns and re-pack Q = H0 + i HN
            h0r, h0i = a0 * dcr + c0r, a0 * dci + c0i
            hnr, hni = an * nqr + cnr, an * nqi + cni
            br = (a_w * yr + cr_w).to(v.dtype)
            bi = (a_w * yi + ci_w).to(v.dtype)
            br[..., 0] = h0r - hni
            bi[..., 0] = h0i + hnr
            # inverse H axis: x~ = (C^T + iS^T)(br + i bi) / h
            n1, n2, n3 = ch.mT @ br, sh.mT @ bi, cps.mT @ (br + bi)
            tr, ti = (n1 - n2) / h, (n3 - n1 - n2) / h
            # W synthesis: interior bins count twice; slot 0 holds DC in tr
            # (row 0 of cwi is ones) and Nyquist in ti (the swi edit, through
            # the minus sign)
            wk = torch.full((whp,), 2.0, dtype=v.dtype, device=v.device)
            wk[0] = 1.0
            out = ((tr * wk) @ cwi - (ti * wk) @ swi) / w
        return torch.abs(out)

    return dc
