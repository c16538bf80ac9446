"""A whole ADMM-L1 iteration as one fused step: CUDA kernels and their
plain PyTorch version, and the solver that runs through them.

Replaces the Pallas kernel ``make_fused_iteration`` of the JAX package's
``ops/pallas_dc.py`` and its solver ``admm_l1_fused_kernel``. One step is
``v = z - w``, the half-spectrum transform, the blend ``A .* V + C``, the
inverse transform, ``x = |.|``, ``z' = soft(x + w, thr)`` and
``w' = (w + x) - z'``. On the card it runs as one of three designs,
each built with nvcc at first use and called through ctypes:

- ``"cluster"`` (``csrc/admm_iteration_cluster.cu``): one launch a step,
  one thread-block cluster of Q blocks per image, the transforms as FFTs in
  shared memory. It takes H and W powers of two whose half spectrum fits
  the cluster's shared memory (``cluster_size``).
- ``"mixed"`` (``csrc/admm_iteration_mixed.cu``): the same one-launch
  cluster step with mixed-radix (4, 2, 3, 5, 7) FFTs, for H and W whose
  only prime factors are 2, 3, 5 and 7 and whose half spectrum fits a
  cluster of up to 16 blocks (``mixed_size``): 320², 384², 448², 512²,
  640 x 320, 300 x 256.
- ``"strips"`` (``csrc/admm_iteration.cu``): three launches a step, the
  transforms as dense DFT products over two scratch planes allocated once
  per ``make_fused_iteration``. It takes any H up to its shared-memory
  limit and any even W.

``make_fused_iteration`` takes the cluster design wherever it takes the
shape, then the mixed design, then the strip design (``pick_design``),
unless ``design=`` names one. All are hand-written kernels; none catches
another's failure.

The step takes the plain version for tensors on the CPU (any float dtype),
launches its design's kernels for float32 CUDA tensors and raises for
anything else. ``fused_iteration.launches`` counts the fused iterations run
on the card and ``fused_iteration.by_design`` counts them per design; the
plain path does not count.

Only even W is taken: the TPU kernel weighs the last bin once, which is the
Nyquist bin only for even W (``fourier.matmul_irfft2`` handles odd W).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from pnp_admm_cnc_mri_torch.ops import _build, fourier, prox
from pnp_admm_cnc_mri_torch.solvers import admm

_LIB = None
_CLUSTER_LIB = None
_MIXED_LIB = None
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
DESIGNS = ("cluster", "mixed", "strips")
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


# z, w, tw_w, tw_h, A, Cr, Ci, z', w', thr, batch, H, W, Q, stream
_CLUSTER_SIGNATURE = [_PTR] * 9 + [ctypes.c_float, _I64, _INT, _INT, _INT, _PTR]


def _load_one_launch_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``, a one-launch design
    with the C interface ``<name>_f32``, ``_limits``, ``_smem``, ``_active``."""
    lib = ctypes.CDLL(str(_build.build(name)))
    for suffix, argtypes, restype in (("f32", _CLUSTER_SIGNATURE, _INT),
                                      ("limits", [ctypes.POINTER(_INT)] * 3, _INT),
                                      ("smem", [_INT] * 3, _I64),
                                      ("active", [_INT] * 3, _INT)):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_cluster_library() -> ctypes.CDLL:
    """Build (if needed) and load ``libadmm_iteration_cluster.so``; idempotent."""
    global _CLUSTER_LIB
    if _CLUSTER_LIB is None:
        _CLUSTER_LIB = _load_one_launch_library("admm_iteration_cluster")
    return _CLUSTER_LIB


def load_mixed_library() -> ctypes.CDLL:
    """Build (if needed) and load ``libadmm_iteration_mixed.so``; idempotent."""
    global _MIXED_LIB
    if _MIXED_LIB is None:
        _MIXED_LIB = _load_one_launch_library("admm_iteration_mixed")
    return _MIXED_LIB


def reset_launches() -> None:
    fused_iteration.launches = 0
    fused_iteration.by_design = dict.fromkeys(DESIGNS, 0)


# -- the cluster design's shape rule ------------------------------------------

# Shared memory of an H100 (bytes): a block's opt-in limit, an SM's, and what
# the system keeps per block. The rule reads the card's own limits on the
# card; on the CPU it names the design an H100 would take.
H100_SMEM = (232448, 233472, 1024)
CLUSTER_SIZES = (1, 2, 4, 8)  # blocks per cluster, the portable sizes
WORK = 4096 + 64  # complex values of the work buffer (csrc: kWork + kPad)
MAX_SIDE = 2048  # H and W at most (csrc: kWork / 2)


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def cluster_smem(h: int, w: int, q: int) -> int:
    """Dynamic shared memory of one block of the cluster design (bytes): an
    mbarrier, its H/Q rows of the half spectrum (complex), its rows of w,
    and its work buffer (``admm_iteration_cluster.cu``'s layout)."""
    r, wh = h // q, w // 2 + 1
    return 16 + r * wh * 8 + r * w * 4 + WORK * 8


def cluster_size(h: int, w: int, smem=H100_SMEM) -> int:
    """Blocks per cluster for (H, W), or 0 where the cluster design does not
    take the shape. ``smem``: (block opt-in, SM, reserved per block) bytes.

    The design takes H and W powers of two, 8 <= H, W <= 2048. Q is the
    smallest of 1, 2, 4, 8 (with at least two rows and one column slot a
    block) whose blocks fit two to an SM; failing that, the smallest whose
    block fits at all.
    """
    if not (_pow2(h) and _pow2(w) and 8 <= min(h, w) and max(h, w) <= MAX_SIDE):
        return 0
    block, sm, reserved = smem
    sizes = [q for q in CLUSTER_SIZES if h >= 2 * q and w // 2 >= q]
    for limit in (sm // 2 - reserved, block):
        for q in sizes:
            if cluster_smem(h, w, q) <= limit:
                return q
    return 0


# -- the mixed design's shape rule ---------------------------------------------

MIXED_SIZES = tuple(range(1, 17))  # blocks per cluster; above 8 a non-portable size
RADICES = (4, 2, 3, 5, 7)  # the FFT's stages, in this order (csrc: fft_plan_of)


def fft_plan(n: int) -> list:
    """The radices of the mixed design's FFT of length n, in stage order:
    radix 4 while 4 divides what is left, one radix 2, then 3, 5 and 7;
    [] where n has a prime factor above 7 (or n < 2)."""
    plan = []
    for r in RADICES:
        while n % r == 0:  # after the 4s, 2 divides at most once
            plan.append(r)
            n //= r
    return plan if n == 1 and plan else []


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def mixed_smem(h: int, w: int, q: int) -> int:
    """Dynamic shared memory of one block of the mixed design (bytes): an
    mbarrier; its R = H/Q rows of the half spectrum, sized so that the rows
    of z can land 16-byte aligned at its tail; its rows of w, or the Cr and
    Ci of its ceil(W/2/Q) column slots if larger; the work buffer
    (``admm_iteration_mixed.cu``'s layout)."""
    r, nk = h // q, -(-(w // 2) // q)
    spec = _round16(8 * (r + r % 2) + 4 * w * r)
    wbuf = _round16(4 * max(r * w, 2 * h * nk))
    return 16 + spec + wbuf + WORK * 8


def mixed_size(h: int, w: int, smem=H100_SMEM, active=None) -> int:
    """Blocks per cluster of the mixed design for (H, W), or 0 where it does
    not take the shape. ``smem`` as in ``cluster_size``; ``active(q)``, where
    given, is the device's count of resident clusters of q blocks.

    The design takes H and W whose prime factors are 2, 3, 5 and 7, W even,
    8 <= H, W <= 2048. Q is one of 1..16 that divides H, with at most W/2
    blocks (one column slot each at least): the smallest whose blocks fit
    two to an SM, failing that the smallest whose block fits at all; a Q
    of which the device holds no cluster is passed over.
    """
    if not (w % 2 == 0 and 8 <= min(h, w) and max(h, w) <= MAX_SIDE and fft_plan(h) and fft_plan(w)):
        return 0
    block, sm, reserved = smem
    sizes = [q for q in MIXED_SIZES if h % q == 0 and q <= w // 2]
    for limit in (sm // 2 - reserved, block):
        for q in sizes:
            if mixed_smem(h, w, q) <= limit and (active is None or active(q) > 0):
                return q
    return 0


def pick_design(h: int, w: int, design=None, smem=H100_SMEM, active=None) -> tuple:
    """-> ``(design, q)``: the cluster design wherever ``cluster_size`` takes
    the shape, else the mixed design wherever ``mixed_size`` takes it, else
    the strip design (q = 0). ``design`` asks for one; it raises if the
    cluster or the mixed design cannot take the shape. ``active`` as in
    ``mixed_size``."""
    if design is not None and design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; expected one of {DESIGNS}")
    if design == "strips":
        return "strips", 0
    if design in (None, "cluster"):
        q = cluster_size(h, w, smem)
        if q:
            return "cluster", q
        if design == "cluster":
            raise ValueError(
                f"the cluster design does not take H={h}, W={w}: it needs H and W powers of two, "
                f"8 <= H, W <= {MAX_SIDE}, and a half spectrum that fits a cluster's shared memory"
            )
    q = mixed_size(h, w, smem, active)
    if q:
        return "mixed", q
    if design == "mixed":
        raise ValueError(
            f"the mixed design does not take H={h}, W={w}: it needs H and W with no prime factor "
            f"above 7, W even, 8 <= H, W <= {MAX_SIDE}, and a half spectrum that fits a cluster "
            "of at most 16 blocks"
        )
    return "strips", 0


def twiddles(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """The FFT twiddle table ``exp(-2 pi i t / n)``, t in [0, n), as (n, 2)
    pairs (re, im) of ``dtype``: the angle from integer t in float64, then
    the cast. The kernel indexes it by phases q·k·(n / (ns r)) < n, products
    of integers, so no angle is ever formed from a large float."""
    t = torch.arange(n, dtype=torch.int64, device=device) % n
    ang = (2.0 * math.pi / n) * t.to(torch.float64)
    return torch.stack([torch.cos(ang), -torch.sin(ang)], dim=-1).to(dtype).contiguous()


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
    design: str = "strips"  # "cluster", "mixed" or "strips"
    q: int = 0  # blocks per cluster of the cluster or mixed design
    tw: Optional[tuple] = None  # (tw_w, tw_h): the one-launch designs' twiddle tables


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


def make_fused_iteration(a_half, cr, ci, h: int, w: int, thr: float, device=None, design=None):
    """-> ``step(z, w) -> (z_new, w_new)``, one fused ADMM-L1 iteration.

    ``a_half`` (H, W//2+1), ``cr``/``ci`` (..., H, W//2+1): the blend fields
    of ``fourier.rfft_blend_fields`` (numpy arrays or tensors; they keep
    their dtype and go to ``device``, None meaning the CUDA card).
    ``thr = rho * lam``. The state ``(z, w)`` given to the step has shape
    (..., H, W) with cr's leading shape, and the fields' dtype and device.
    ``design``: None (``pick_design``'s rule), ``"cluster"``, ``"mixed"``
    or ``"strips"``; a design that cannot take the shape raises. On the CPU
    all run the plain version. ``step.fields`` is the ``FusedIteration``
    the step runs with (``.design``, ``.q``).
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
    if device.type != "cuda":
        it.design, it.q = pick_design(h, w, design)
    else:
        if dtype != torch.float32:
            raise TypeError(f"the fused iteration runs in float32 on the card, got {dtype}")
        it.design, it.q = pick_design(h, w, design, device_smem(device),
                                      active=lambda q: mixed_active(device, h, w, q))
        if it.design in ("cluster", "mixed"):
            it.tw = (twiddles(w, device), twiddles(h, device))
        else:
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


def device_smem(device) -> tuple:
    """(block opt-in, SM, reserved per block) shared memory of a CUDA
    device, in bytes, as the cluster library reads it (once per device)."""
    lib = load_cluster_library()
    vals = [_INT() for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.admm_iteration_cluster_limits(*(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"device query failed: cudaError {err}")
    return tuple(v.value for v in vals)


def mixed_active(device, h: int, w: int, q: int) -> int:
    """Clusters of q blocks of the mixed design resident at once on a CUDA
    device (``cudaOccupancyMaxActiveClusters``); raises if the query fails."""
    with torch.cuda.device(device):
        n = load_mixed_library().admm_iteration_mixed_active(h, w, q)
    if n < 0:
        raise RuntimeError(f"cluster occupancy query failed: cudaError {-n}")
    return n


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
    """Call one entry point of a library on the current stream; raises if
    the launch failed."""
    lib = {"admm_iteration_cluster_f32": load_cluster_library,
           "admm_iteration_mixed_f32": load_mixed_library}.get(name, load_library)()
    fn = getattr(lib, name)
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


def cluster_launch(it: FusedIteration, z, w, z_new, w_new) -> tuple:
    """The one launch of a step of the cluster or the mixed design, as
    ``(entry point, arguments)``."""
    ptrs = (t.data_ptr() for t in (z, w, *it.tw, it.a_half, it.cr, it.ci, z_new, w_new))
    return f"admm_iteration_{it.design}_f32", (*ptrs, it.thr, z.numel() // (it.h * it.w), it.h, it.w, it.q)


def fused_iteration(z: torch.Tensor, w: torch.Tensor, it: FusedIteration) -> tuple:
    """One fused ADMM-L1 iteration; returns ``(z_new, w_new)``."""
    if _check(it, z, w) == "cpu":
        return fused_iteration_plain(z, w, it.a_half, it.cr, it.ci, it.thr, it.mats)
    z_new, w_new = torch.empty_like(z), torch.empty_like(z)
    if z.numel():
        if it.design in ("cluster", "mixed"):
            launches = [cluster_launch(it, z, w, z_new, w_new)]
        else:
            launches = stage_launches(it, z, w, z_new, w_new)
        for name, args in launches:
            launch(name, z.device, *args)
        fused_iteration.launches += 1
        fused_iteration.by_design[it.design] += 1
    return z_new, w_new


reset_launches()


def admm_l1_fused_kernel(y, mask, cfg, dtype=torch.float32, device=None, design=None):
    """ADMM-L1 through the fused iteration; returns ``(x, z, w)``.

    Same math as ``admm.admm_l1(..., dc_method='matmul', fused=False)``.
    ``y`` (complex k-space, (..., H, W)) and ``mask`` (H, W) may be numpy
    arrays or tensors; they go to ``device`` (None: the CUDA card). The
    solver's final x comes from the (z, w) entering the last iteration, so
    ``iter_num - 1`` fused steps run, then one matmul data-consistency
    solve; z and w are that entering state. ``design`` as in
    ``make_fused_iteration``.
    """
    if cfg.tol is not None:
        raise ValueError("admm_l1_fused_kernel runs cfg.iter_num iterations; cfg.tol must be None")
    y, mask = admm.prepare_inputs(y, mask, device)
    h, w = mask.shape[-2:]
    a_half, c_half = fourier.rfft_blend_fields(y, mask, cfg.rho)
    step = make_fused_iteration(a_half.to(dtype), c_half.real.to(dtype), c_half.imag.to(dtype),
                                h, w, cfg.rho * cfg.lam, device=y.device, design=design)
    state = admm.init_state(y, dtype)
    z, wd = state.z, state.w
    for _ in range(max(cfg.iter_num - 1, 0)):
        z, wd = step(z, wd)
    dc = fourier.make_rfft_data_consistency(y, mask, cfg.rho, method="matmul")
    return dc(z - wd).to(dtype), z, wd
