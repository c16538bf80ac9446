"""Fused z/w tails of the classical ADMM iteration: CUDA kernels and their
plain PyTorch versions.

Replaces the Pallas kernels ``l1_tail`` and ``cnc_tail`` of the JAX
package's ``ops/pallas_kernels.py``. The kernels are in
``csrc/admm_tail.cu`` (where their bound and design are stated), built
with nvcc at first use and called through ctypes.

A wrapper takes the plain version for tensors on the CPU, launches the
kernel for CUDA tensors and raises for anything else. Each wrapper counts
its kernel launches in ``<wrapper>.launches``; the plain path does not
count.
"""

from __future__ import annotations

import ctypes

import torch

from pnp_admm_cnc_mri_torch.ops import _build, prox

_LIB = None
_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "admm_l1_tail_f32": [_PTR] * 4 + [ctypes.c_float, _I64, _PTR],
    "admm_l1_tail_f64": [_PTR] * 4 + [ctypes.c_double, _I64, _PTR],
    "admm_cnc_tail_f32": [_PTR] * 5 + [ctypes.c_float] * 5 + [_I64, _PTR],
    "admm_cnc_tail_f64": [_PTR] * 5 + [ctypes.c_double] * 5 + [_I64, _PTR],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load ``libadmm_tail.so``; idempotent."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build.build("admm_tail")))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def reset_launches() -> None:
    l1_tail.launches = 0
    cnc_tail.launches = 0


def _check(*tensors: torch.Tensor) -> str:
    """Validate the operands; returns ``'cpu'`` or ``'cuda'``."""
    x = tensors[0]
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected tensors, got {type(t).__name__}")
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(
                "operands must share device, dtype and shape: "
                f"{[(str(u.device), u.dtype, tuple(u.shape)) for u in tensors]}"
            )
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"dtype {x.dtype} not supported; expected float32 or float64")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {x.device} not supported")
    return x.device.type


def _launch(name: str, x: torch.Tensor, pointers, scalars) -> None:
    fn = getattr(load_library(), f"{name}_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in pointers), *scalars, x.numel(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def l1_tail_plain(x, z, w, c):
    """Plain version: ``z' = soft(x + w, c)``, ``w' = w + x - z'``."""
    z_new = prox.soft(x + w, c)
    w_new = w + x - z_new
    return z_new, w_new


def cnc_tail_plain(x, z, w, alpha, rho, lam, b):
    """Plain version: ``z' = cnc_update(z, x + w, ...)``, ``w' = w + x - z'``."""
    z_new = prox.cnc_update(z, x + w, alpha, rho, lam, b)
    w_new = w + x - z_new
    return z_new, w_new


def l1_tail(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor, c) -> tuple:
    """Fused L1 z/w update; returns ``(z_new, w_new)``. ``z`` is checked but
    not read (the L1 prox does not depend on it)."""
    if _check(x, z, w) == "cpu":
        return l1_tail_plain(x, z, w, c)
    z_new, w_new = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        _launch("admm_l1_tail", x, (x, w, z_new, w_new), (float(c),))
        l1_tail.launches += 1
    return z_new, w_new


def cnc_tail(x, z, w, alpha, rho, lam, b) -> tuple:
    """Fused CNC z/w update; returns ``(z_new, w_new)``."""
    if _check(x, z, w) == "cpu":
        return cnc_tail_plain(x, z, w, alpha, rho, lam, b)
    z_new, w_new = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        # the scalars are formed in double as prox.cnc_update forms them
        scalars = (1.0 / b, 1.0 - alpha, float(alpha), alpha * rho * lam * b, alpha * rho * lam)
        _launch("admm_cnc_tail", x, (x, z, w, z_new, w_new), tuple(float(s) for s in scalars))
        cnc_tail.launches += 1
    return z_new, w_new


l1_tail.launches = 0
cnc_tail.launches = 0
