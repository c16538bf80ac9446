"""Matmul-class FLOP counts of a function, from the ops that actually run.

Port of the JAX package's ``utils/flops.py``, which walks a jaxpr: here a
``TorchDispatchMode`` sees every aten op a call runs (the backward's too)
and sums, with the JAX file's rules:

- ``convolution``: 2 x out elements x (C_in / groups) x kernel taps; for a
  transposed convolution "out" is its output, as in JAX, whose transposed
  conv is a convolution of the input dilated by the stride;
- ``convolution_backward``: the input gradient 2 x input elements x
  (C_out / groups) x taps, the weight gradient the forward's count, each
  only when asked for (JAX transposes a convolution into two convolutions
  of those sizes);
- ``mm``, ``addmm``, ``bmm``, ``baddbmm``: 2 x batch x M x N x K;
- FFTs: 5 N log2 N for each transform of N points (the product of the
  transformed lengths), times the batch.

Elementwise and reduction ops are not counted.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def _conv_flops(out_shape, w_shape, transposed: bool, groups: int) -> float:
    """2 x out elements x (C_in / groups) x taps (torch's weight layout:
    (C_out, C_in / g, ...) for a conv, (C_in, C_out / g, ...) transposed)."""
    cin_per_group = w_shape[0] / groups if transposed else w_shape[1]
    return 2.0 * math.prod(out_shape) * cin_per_group * math.prod(w_shape[2:])


def _conv_backward_flops(grad_out_shape, in_shape, w_shape, transposed: bool, groups: int, mask) -> float:
    total = 0.0
    if mask[0]:
        cout_per_group = w_shape[1] if transposed else w_shape[0] / groups
        total += 2.0 * math.prod(in_shape) * cout_per_group * math.prod(w_shape[2:])
    if mask[1]:
        total += _conv_flops(grad_out_shape, w_shape, transposed, groups)
    return total


def _fft_flops(x_shape, dims, lengths) -> float:
    n = float(math.prod(lengths))
    batch = math.prod(x_shape) / max(math.prod(x_shape[d] for d in dims), 1)
    return 5.0 * n * math.log2(max(n, 2.0)) * batch


def _op_flops(func, args, out) -> float:
    if func is aten.convolution.default:
        return _conv_flops(out.shape, args[1].shape, bool(args[6]), int(args[8]))
    if func is aten.convolution_backward.default:
        return _conv_backward_flops(args[0].shape, args[1].shape, args[2].shape, bool(args[7]), int(args[9]),
                                    args[10])
    if func in (aten.mm.default, aten.addmm.default):
        a, b = (args[0], args[1]) if func is aten.mm.default else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if func in (aten.bmm.default, aten.baddbmm.default):
        a, b = (args[0], args[1]) if func is aten.bmm.default else (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if func in (aten._fft_r2c.default, aten._fft_c2c.default):
        x, dims = args[0], [d % args[0].dim() for d in args[1]]
        return _fft_flops(x.shape, dims, [x.shape[d] for d in dims])
    if func is aten._fft_c2r.default:
        x, dims = args[0], [d % args[0].dim() for d in args[1]]
        return _fft_flops(x.shape, dims, [x.shape[d] for d in dims[:-1]] + [int(args[3])])
    return 0.0


class FlopCounter(TorchDispatchMode):
    """Sums ``_op_flops`` over the ops run inside the mode (``.total``)."""

    def __init__(self):
        super().__init__()
        self.total = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += _op_flops(func, args, out)
        return out


def matmul_flops(fn, *args, **kwargs) -> float:
    """Total conv, matmul and FFT FLOPs of one ``fn(*args, **kwargs)`` call
    (which runs; a backward inside it is counted too)."""
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total
