"""Transform matrices for BM3D: DCT, DST, Haar, bior1.5 and the Kaiser window.

The port's own copy of the JAX package's ``priors/bm3d/transforms.py``, in
numpy (the matrices are built once on the host, in float64, and cast to the
working dtype where they are used):

- DCT-II and DST-II with orthonormal scaling (the DST as ``scipy.fftpack.dst
  (eye, norm='ortho')`` gives it, written out here so the port needs no scipy).
- Dyadic periodized wavelet analysis matrices from filter taps (the pywt
  ``wavedec(mode='periodization')`` construction), full decomposition, row
  order [cA_L, cD_L, ..., cD_1].
- Forward transforms are row-normalized to unit l2 norm, except the 8x8
  bior1.5 matrix, which is the reference's MATLAB-compatible table kept
  unnormalized; inverses are matrix inverses.
- The per-size stack transforms along the group axis.
- The 2-D Kaiser aggregation window.
"""

from __future__ import annotations

import numpy as np

# Biorthogonal 1.5 analysis filters (reversed-for-convolution pywt convention).
_BIOR15_DEC_LO = np.array(
    [
        0.01657281518405971,
        -0.01657281518405971,
        -0.12153397801643787,
        0.12153397801643787,
        0.7071067811865476,
        0.7071067811865476,
        0.12153397801643787,
        -0.12153397801643787,
        -0.01657281518405971,
        0.01657281518405971,
    ]
)
_BIOR15_DEC_HI = np.array(
    [0.0, 0.0, 0.0, 0.0, -0.7071067811865476, 0.7071067811865476, 0.0, 0.0, 0.0, 0.0]
)

_HAAR_DEC_LO = np.array([0.7071067811865476, 0.7071067811865476])
_HAAR_DEC_HI = np.array([-0.7071067811865476, 0.7071067811865476])

# The 8x8 bior1.5 analysis matrix is a table, not a construction: the
# reference hardcodes it for MATLAB compatibility (``bm3d307/bm3d/
# __init__.py:491-504``) and its C binaries consume exactly these values.
_BIOR15_8x8_MATLAB = np.array([
    [0.343550200747110, 0.343550200747110, 0.343550200747110,
     0.343550200747110, 0.343550200747110, 0.343550200747110,
     0.343550200747110, 0.343550200747110],
    [-0.225454819240296, -0.461645582253923, -0.461645582253923,
     -0.225454819240296, 0.225454819240296, 0.461645582253923,
     0.461645582253923, 0.225454819240296],
    [0.569359398342840, 0.402347308162280, -0.402347308162280,
     -0.569359398342840, -0.083506045090280, 0.083506045090280,
     -0.083506045090280, 0.083506045090280],
    [-0.083506045090280, 0.083506045090280, -0.083506045090280,
     0.083506045090280, 0.569359398342840, 0.402347308162280,
     -0.402347308162280, -0.569359398342840],
    [0.707106781186550, -0.707106781186550, 0, 0, 0, 0, 0, 0],
    [0, 0, 0.707106781186550, -0.707106781186550, 0, 0, 0, 0],
    [0, 0, 0, 0, 0.707106781186550, -0.707106781186550, 0, 0],
    [0, 0, 0, 0, 0, 0, 0.707106781186550, -0.707106781186550],
])

FILTERS = {
    "bior1.5": (_BIOR15_DEC_LO, _BIOR15_DEC_HI),
    "haar": (_HAAR_DEC_LO, _HAAR_DEC_HI),
}


def _analysis_step(x: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """One periodized analysis level: c[k] = sum_t f[t] x[(2k+1-t) mod m]."""
    m = x.shape[0]
    ks = np.arange(m // 2)
    idx = (2 * ks[:, None] + 1 - np.arange(lo.size)[None, :]) % m
    ca = (x[idx] * lo[None, :]).sum(axis=1)
    cd = (x[idx] * hi[None, :]).sum(axis=1)
    return ca, cd


def wavedec_vector(x: np.ndarray, wavelet: str, level: int | None = None):
    """Full periodized wavedec of a 1-D signal: [cA_L, cD_L, ..., cD_1]."""
    lo, hi = FILTERS[wavelet]
    n = x.shape[0]
    if level is None:
        level = int(np.log2(n))
    ca = x.astype(np.float64)
    details = []
    for _ in range(level):
        ca, cd = _analysis_step(ca, lo, hi)
        details.append(cd)
    return [ca] + details[::-1]


def wavelet_matrix(n: int, wavelet: str) -> np.ndarray:
    """Analysis matrix W (n x n): W @ x == hstack(wavedec_vector(x))."""
    w = np.zeros((n, n))
    for i in range(n):
        delta = np.zeros(n)
        delta[i] = 1.0
        w[:, i] = np.hstack(wavedec_vector(delta, wavelet))
    return w


def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix."""
    k = np.arange(n)[:, None]
    t = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * t + 1) / (2 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return m


def dst_matrix(n: int) -> np.ndarray:
    """``scipy.fftpack.dst(np.eye(n), norm='ortho')``, the reference's DST
    (``__init__.py:589-590``, the 'deb' profile): entry (i, k) is the
    orthonormal DST-II coefficient k of the unit impulse at i."""
    i = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    scale = np.where(k == n - 1, np.sqrt(1.0 / (4 * n)), np.sqrt(1.0 / (2 * n)))
    return 2.0 * np.sin(np.pi * (k + 1) * (2 * i + 1) / (2 * n)) * scale


def transform_pair(
    n: int, kind: str, dec_level: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """(forward, inverse) transform matrices with the reference's normalization.

    Forward rows are scaled to unit l2 norm, except the 8x8 bior1.5 table
    (reference ``__init__.py:615-620``). Inverse = inv(forward).
    ``dec_level`` is the reference's ``profiles.py:67`` field: for generated
    wavelet matrices it advances the columns cyclically by ``dec_level``
    (``__init__.py:608``); the hardcoded 8x8 tables ignore it.
    """
    if n == 1:
        return np.ones((1, 1)), np.ones((1, 1))
    if kind == "bior1.5" and n == 8:
        t = _BIOR15_8x8_MATLAB
        return t, np.linalg.inv(t)
    if kind == "dct":
        t = dct_matrix(n)
    elif kind == "dst":
        t = dst_matrix(n)
    elif kind in FILTERS:
        t = wavelet_matrix(n, kind)
        if dec_level:
            t = np.roll(t, -int(dec_level), axis=1)
        norms = np.sqrt((t**2).sum(axis=1))
        t = t / norms[:, None]
    else:
        raise ValueError(kind)
    return t, np.linalg.inv(t)


def stack_transforms(max_size: int, kind: str = "haar"):
    """(forward, inverse) stack transforms for the sizes 1, 2, 4, ..., max, as
    the reference precomputes them (``_get_transforms``)."""
    fwd, inv = {}, {}
    s = 1
    while s <= max_size:
        fwd[s], inv[s] = transform_pair(s, kind)
        s *= 2
    return fwd, inv


def kaiser_window(n: int = 8, beta: float = 2.0) -> np.ndarray:
    """2-D separable Kaiser aggregation window (reference ``:944-962``)."""
    k = np.kaiser(n, beta)
    return np.outer(k, k)
