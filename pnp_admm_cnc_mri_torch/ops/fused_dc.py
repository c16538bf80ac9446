"""A whole ADMM-L1 iteration as one fused step: CUDA kernels and their
plain PyTorch version, and the solver that runs through them.

Replaces the Pallas kernel ``make_fused_iteration`` of the JAX package's
``ops/pallas_dc.py`` and its solver ``admm_l1_fused_kernel``. One step is
``v = z - w``, the half-spectrum DFT as matrix products, the blend
``A .* V + C``, the inverse DFT, ``x = |.|``, ``z' = soft(x + w, thr)`` and
``w' = (w + x) - z'``. On the card it runs as three launches of
``csrc/admm_iteration.cu`` (where their bound and design are stated), built
with nvcc at first use and called through ctypes, over two scratch planes
allocated once per ``make_fused_iteration``.

The step takes the plain version for tensors on the CPU (any float dtype),
launches the kernels for float32 CUDA tensors and raises for anything else.
``fused_iteration.launches`` counts the fused iterations run on the card
(three kernel launches each); the plain path does not count.

Only even W is taken: the TPU kernel weighs the last bin once, which is the
Nyquist bin only for even W (``fourier.matmul_irfft2`` handles odd W).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from pnp_admm_cnc_mri_torch.ops import _build, fourier, prox
from pnp_admm_cnc_mri_torch.solvers import admm

_LIB = None
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    # z, w, E, Xr, Xi, rows, W, Wh, stream
    "admm_iteration_rows_f32": [_PTR] * 5 + [_I64, _INT, _INT, _PTR],
    # planes 0/1, ch, sh, A, Cr, Ci, columns, H, Wh, stream
    "admm_iteration_columns_f32": [_PTR] * 7 + [_I64, _INT, _INT, _PTR],
    # Ir, Ii, F, w, z', w', thr, rows, W, Wh, stream
    "admm_iteration_synthesis_f32": [_PTR] * 6 + [ctypes.c_float, _I64, _INT, _INT, _PTR],
}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load ``libadmm_iteration.so``; idempotent."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build("admm_iteration")))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.admm_iteration_column_strip.argtypes = [_INT]
        lib.admm_iteration_column_strip.restype = _INT
        _LIB = lib
    return _LIB


def reset_launches() -> None:
    fused_iteration.launches = 0


@dataclass
class FusedIteration:
    """What a fused step needs beside the state, built once: the blend
    fields, the DFT matrices and, on the card, the stacked row operands and
    the scratch planes."""

    h: int
    w: int
    thr: float
    a_half: torch.Tensor  # (H, Wh)
    cr: torch.Tensor  # (..., H, Wh)
    ci: torch.Tensor
    mats: tuple  # (cw, sw, ch, sh): the plain version's, and ch, sh for the column stage
    e: Optional[torch.Tensor] = None  # (W, 2Wh)  [cw | -sw][:, :Wh]
    f: Optional[torch.Tensor] = None  # (2Wh, W)  [wk cw; -wk sw][:Wh, :]
    planes: Optional[torch.Tensor] = None  # (2, ..., H, Wh) scratch
    strip: int = 0  # spectral columns per block of the column stage, as the library picks it


def fused_iteration_plain(z, w, a_half, cr, ci, thr, mats=None):
    """Plain version of one step: ``fourier.matmul_rfft2``/``matmul_irfft2``
    at full float32 precision, the blend, ``prox.soft`` and the dual."""
    h, wd = z.shape[-2:]
    with fourier.full_precision_matmul():
        vr, vi = fourier.matmul_rfft2(z - w, mats)
        x = torch.abs(fourier.matmul_irfft2(a_half * vr + cr, a_half * vi + ci, h, wd, mats))
    z_new = prox.soft(x + w, thr)
    return z_new, (w + x) - z_new


def row_operands(cw, sw):
    """The row stages' stacked operands from the DFT matrices (W even):

    - E = [cw | -sw][:, :Wh] (W x 2Wh): ``v E = [Xr | Xi]``;
    - F = [wk cw; -wk sw][:Wh, :] (2Wh x W), bin weights wk = [1, 2, ..., 2, 1]:
      ``[Ir | Ii] F = (Ir wk) cw - (Ii wk) sw``.

    Negation and the weights 1 and 2 are exact, so E and F hold the same
    numbers as the products of ``fourier.matmul_rfft2``/``matmul_irfft2``.
    The column stage multiplies by ch and sh themselves.
    """
    wh = cw.shape[0] // 2 + 1
    wk = torch.full((wh, 1), 2.0, dtype=cw.dtype, device=cw.device)
    wk[0] = wk[wh - 1] = 1.0
    e = torch.cat([cw[:, :wh], -sw[:, :wh]], dim=1).contiguous()
    f = torch.cat([wk * cw[:wh, :], -(wk * sw[:wh, :])], dim=0).contiguous()
    return e, f


def make_fused_iteration(a_half, cr, ci, h: int, w: int, thr: float, device=None):
    """-> ``step(z, w) -> (z_new, w_new)``, one fused ADMM-L1 iteration.

    ``a_half`` (H, W//2+1), ``cr``/``ci`` (..., H, W//2+1): the blend fields
    of ``fourier.rfft_blend_fields`` (numpy arrays or tensors; they keep
    their dtype and go to ``device``, None meaning the CUDA card).
    ``thr = rho * lam``. The state ``(z, w)`` given to the step has shape
    (..., H, W) with cr's leading shape, and the fields' dtype and device.
    ``step.fields`` is the ``FusedIteration`` the step runs with.
    """
    if w % 2:
        raise ValueError(
            f"the fused iteration needs an even W, got {w}: its bin weights count "
            "the last half-spectrum bin once, which is right only for a Nyquist bin"
        )
    device = admm.resolve_device(device)
    a_half, cr, ci = (torch.as_tensor(t, device=device).contiguous() for t in (a_half, cr, ci))
    wh = w // 2 + 1
    dtype = cr.dtype
    if not (dtype.is_floating_point and a_half.dtype == dtype and ci.dtype == dtype):
        raise TypeError(f"the fields must share one float dtype: {a_half.dtype}, {cr.dtype}, {ci.dtype}")
    if tuple(a_half.shape) != (h, wh) or cr.shape != ci.shape or tuple(cr.shape[-2:]) != (h, wh):
        raise ValueError(
            f"fields of shapes {tuple(a_half.shape)}, {tuple(cr.shape)}, {tuple(ci.shape)} "
            f"do not fit H={h}, W={w}: expected A ({h}, {wh}) and C (..., {h}, {wh})"
        )
    cw, sw = fourier._dft_mats(w, dtype, device)
    ch, sh = (cw, sw) if h == w else fourier._dft_mats(h, dtype, device)
    it = FusedIteration(h, w, float(thr), a_half, cr, ci, (cw, sw, ch, sh))
    if device.type == "cuda":
        if dtype != torch.float32:
            raise TypeError(f"the fused iteration runs in float32 on the card, got {dtype}")
        it.e, it.f = row_operands(cw, sw)
        it.planes = torch.empty((2, *cr.shape), dtype=dtype, device=device)
        with torch.cuda.device(device):
            it.strip = load_library().admm_iteration_column_strip(h)
        if it.strip < 0:
            raise RuntimeError(f"device query failed: cudaError {-it.strip}")
        if it.strip == 0:
            raise ValueError(f"H={h} is too tall for the column stage's shared memory")

    def step(z, wdual):
        return fused_iteration(z, wdual, it)

    step.fields = it
    return step


def _check(it: FusedIteration, z, w) -> str:
    """Validate the state against the fields; returns ``'cpu'`` or ``'cuda'``."""
    shape = (*it.cr.shape[:-1], it.w)
    for t in (z, w):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected tensors, got {type(t).__name__}")
        if t.dtype != it.cr.dtype:
            raise TypeError(f"state dtype {t.dtype} does not match the fields' {it.cr.dtype}")
        if t.device != it.cr.device or tuple(t.shape) != shape:
            raise ValueError(
                f"state {str(t.device)} {tuple(t.shape)} does not match the fields: "
                f"expected {str(it.cr.device)} {shape}"
            )
        if not t.is_contiguous():
            raise ValueError("the state must be contiguous")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {z.device} not supported")
    return z.device.type


def launch(name: str, device, *args) -> None:
    """Call one entry point of the library on the current stream; raises
    if the launch failed."""
    fn = getattr(load_library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def stage_launches(it: FusedIteration, z, w, z_new, w_new) -> list:
    """The three launches of one step on the card, as ``(entry point,
    arguments)`` in order: rows, columns, synthesis."""
    rows = z.numel() // it.w
    wh = it.w // 2 + 1
    p0, p1 = (t.data_ptr() for t in it.planes)
    e, f, ch, sh, a, cr, ci, zp, wp, zo, wo = (
        t.data_ptr() for t in (it.e, it.f, *it.mats[2:], it.a_half, it.cr, it.ci, z, w, z_new, w_new))
    return [
        ("admm_iteration_rows_f32", (zp, wp, e, p0, p1, rows, it.w, wh)),
        ("admm_iteration_columns_f32", (p0, p1, ch, sh, a, cr, ci, rows // it.h * wh, it.h, wh)),
        ("admm_iteration_synthesis_f32", (p0, p1, f, wp, zo, wo, it.thr, rows, it.w, wh)),
    ]


def fused_iteration(z: torch.Tensor, w: torch.Tensor, it: FusedIteration) -> tuple:
    """One fused ADMM-L1 iteration; returns ``(z_new, w_new)``."""
    if _check(it, z, w) == "cpu":
        return fused_iteration_plain(z, w, it.a_half, it.cr, it.ci, it.thr, it.mats)
    z_new, w_new = torch.empty_like(z), torch.empty_like(z)
    if z.numel():
        for name, args in stage_launches(it, z, w, z_new, w_new):
            launch(name, z.device, *args)
        fused_iteration.launches += 1
    return z_new, w_new


fused_iteration.launches = 0


def admm_l1_fused_kernel(y, mask, cfg, dtype=torch.float32, device=None):
    """ADMM-L1 through the fused iteration; returns ``(x, z, w)``.

    Same math as ``admm.admm_l1(..., dc_method='matmul', fused=False)``.
    ``y`` (complex k-space, (..., H, W)) and ``mask`` (H, W) may be numpy
    arrays or tensors; they go to ``device`` (None: the CUDA card). The
    solver's final x comes from the (z, w) entering the last iteration, so
    ``iter_num - 1`` fused steps run, then one matmul data-consistency
    solve; z and w are that entering state.
    """
    y, mask = admm._prepare(y, mask, cfg, device)
    h, w = mask.shape[-2:]
    a_half, c_half = fourier.rfft_blend_fields(y, mask, cfg.rho)
    step = make_fused_iteration(a_half.to(dtype), c_half.real.to(dtype), c_half.imag.to(dtype),
                                h, w, cfg.rho * cfg.lam, device=y.device)
    state = admm.init_state(y, dtype)
    z, wd = state.z, state.w
    for _ in range(max(cfg.iter_num - 1, 0)):
        z, wd = step(z, wd)
    dc = fourier.make_rfft_data_consistency(y, mask, cfg.rho, method="matmul")
    return dc(z - wd).to(dtype), z, wd
