"""A numpy replica of ``jax.random.normal(jax.random.PRNGKey(seed), shape)``.

The JAX package's restoration pipelines (``cli/experiments.py``'s ``run_deblur``
and ``run_sr``) draw their degradation noise from JAX's counter-based
generator. The port draws the same numbers on the host, once a run, so that
its command line gives the JAX command line's results on the same files.

This reproduces the stream of jax 0.9 with its default partitionable
threefry (``jax_threefry_partitionable=True``), float32 only, as XLA
computes it on an x86 CPU with FMA:

- ``PRNGKey(seed)`` is the key pair ``(0, seed)`` for ``0 <= seed < 2**32``;
- the bits of element ``n`` (the row-major flat index) are threefry2x32 of
  the key over the counter pair ``(n >> 32, n & 0xFFFFFFFF)``, the two output
  words xor-ed (``jax/_src/prng.py``, ``_threefry_random_bits_partitionable``);
- the uniform on ``[nextafter(-1, 0), 1)`` comes from the mantissa trick of
  ``jax/_src/random.py::_uniform``: the top 23 bits under the exponent of
  1.0, minus 1, scaled by 2, shifted by the lower end and clamped there;
- the normal is ``sqrt(2) * erfinv(u)`` with XLA's float32 erfinv (the
  Giles polynomial in ``w = -log1p(-u * u)``), whose ``log1p`` is XLA's
  CPU one: a Cephes rational below sqrt(2) - 1, else Eigen's float32 log of
  ``1 + x``. XLA contracts each multiply-add into an FMA; ``_fma`` does the
  same in float64, which holds a float32 product exactly.

Host numpy, with no device work. The bits are exact, and so are the normals
on the shapes the tests draw.
"""

from __future__ import annotations

import numpy as np

_F32, _U32 = np.float32, np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's float32 erfinv coefficients, highest degree first (w < 5, w >= 5)
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                          -0.00125372503, -0.00417768164, 0.246640727, 1.50140941], dtype=_F32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                          -0.0076224613, 0.00943887047, 1.00167406, 2.83297682], dtype=_F32)
# XLA's log1p below sqrt(2) - 1: x - x^2 / 2 + x^3 P(x) / Q(x) (Cephes), highest degree first
_LOG1P_P = np.array([4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
                     2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
                     2.0039553499201281259648e1], dtype=_F32)
_LOG1P_Q = np.array([1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
                     3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1],
                    dtype=_F32)
_LOG1P_SMALL = _F32(float.fromhex("0x1.a8279ap-2"))  # sqrt(2) - 1
# Eigen's float32 log: the mantissa in [sqrt(1/2), sqrt(2)), a degree-8 polynomial and ln 2 split in two
_LOG_C = [_F32(float.fromhex(h)) for h in (
    "0x1.204376p-4", "-0x1.d7a37p-4", "-0x1.fcba9ep-4", "0x1.23d37ep-3", "0x1.999d58p-3", "-0x1.fffff8p-3",
    "0x1.de4a34p-4", "-0x1.555cap-3", "0x1.555554p-2")]
_SQRT_HALF = _F32(float.fromhex("0x1.6a09e6p-1"))
_LN2_LO, _LN2_HI = _F32(float.fromhex("-0x1.bd0106p-13")), _F32(0.693359375)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32, 20 rounds, of the counter words ``x1``, ``x2`` (uint32
    arrays) under the key ``(k1, k2)``; the two output words."""
    ks = (_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _U32(0x1BD11BDA))
    x = [x1.astype(_U32) + ks[0], x2.astype(_U32) + ks[1]]
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(block + 1) % 3]
        x[1] = x[1] + ks[(block + 2) % 3] + _U32(block + 1)
    return x[0], x[1]


def bits(seed: int, shape) -> np.ndarray:
    """``jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed}: the replica covers PRNGKey(seed) for 0 <= seed < 2**32 only")
    shape = tuple(int(s) for s in shape)
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    b1, b2 = threefry2x32(0, seed, (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (b1 ^ b2).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(_F32)


def _horner(coefs: np.ndarray, x: np.ndarray) -> np.ndarray:
    p = x * _F32(0)
    for c in coefs:
        p = _fma(p, x, c)
    return p


def _log32(a: np.ndarray) -> np.ndarray:
    """Eigen's float32 log (``plog_float``) for positive finite ``a``."""
    a = np.maximum(a, np.finfo(_F32).tiny)
    b = a.view(_U32)
    e = ((b >> _U32(23)).astype(np.int32) - 127).astype(_F32) + _F32(1)
    m = ((b & _U32(0x7FFFFF)) | _U32(0x3F000000)).view(_F32)  # in [0.5, 1)
    low = m < _SQRT_HALF
    e = e - np.where(low, _F32(1), _F32(0))
    x = (m + _F32(-1)) + np.where(low, m, _F32(0))
    x2 = x * x
    x3 = x2 * x
    c = _LOG_C
    y0 = _fma(_fma(x, c[0], c[1]), x, c[6])
    y1 = _fma(_fma(x, c[2], c[3]), x, c[7])
    y2 = _fma(_fma(x, c[4], c[5]), x, c[8])
    y = _fma(_fma(y0, x3, y1), x3, y2)
    y = _fma(-x2, _F32(0.5), x) + _fma(y, x3, e * _LN2_LO)
    return _fma(e, _LN2_HI, y)


def _log1p32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU, for ``x`` in (-1, 0]."""
    x2 = x * x
    small = x + _fma(x2, _F32(-0.5), (x * x2) * (_horner(_LOG1P_P, x) / _horner(_LOG1P_Q, x)))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, _log32(x + _F32(1)))


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv of ``x`` in (-1, 1)."""
    w = -_log1p32(-x * x)
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.where(lt, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(lt, cs, cl))
    return p * x


def uniform(seed: int, shape) -> np.ndarray:
    """The float32 uniform on ``[nextafter(-1, 0), 1)`` that ``normal`` maps."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0), dtype=_F32)
    fbits = (bits(seed, shape) >> _U32(32 - 23)) | _F32(1.0).view(_U32)
    floats = fbits.view(_F32) - _F32(1.0)
    return np.maximum(lo, _fma(floats, _F32(1.0) - lo, lo))


def normal(seed: int, shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, dtype)`` for
    float32 and ``0 <= seed < 2**32``, as a numpy array."""
    if np.dtype(dtype) != _F32:
        raise ValueError(f"the replica draws float32 normals only, not {np.dtype(dtype)}")
    return _F32(np.sqrt(2)) * _erfinv32(uniform(seed, shape))
