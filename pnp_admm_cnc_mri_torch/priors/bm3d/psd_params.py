"""PSD -> BM3D parameter auto-selection (feature matching).

A copy of the JAX package's ``priors/bm3d/psd_params.py`` (numpy and
scipy), the reference's ``_estimate_parameters_for_psd`` pipeline
(``bm3d307/bm3d/__init__.py:633-811``): characterize a 65x65 PSD by
integrals along its principal axes, then find the 20 nearest PSDs in a
500-sample database (``param_matching_data.mat``) in a whitened PCA space
and interpolate their optimal (lambda, mu^2) indices.

The database is a reference data asset read at run time (path from
``PNPADMM_BM3D_PARAMS``, read at import as ``DEFAULT_DB``); without it flat
PSDs get the white-noise golden constants and colored PSDs raise
``FileNotFoundError``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

DEFAULT_DB = os.environ.get(
    "PNPADMM_BM3D_PARAMS",
    "/root/reference/bm3d307/bm3d/param_matching_data.mat",
)

_EPS = 1e-16
_INDICES_TO_TAKE = [1, 3, 5, 7, 9, 12, 17, 22, 27, 32]
_LAMBDA_GRID = np.linspace(2.5, 4.5, 21)
_MU2_GRID = np.linspace(0.2, 4.2, 21)


def _trapz_axis(y: np.ndarray, axis: int) -> np.ndarray:
    """Unit-spaced trapezoidal integral along ``axis``."""
    return np.trapezoid(y, axis=axis) if hasattr(np, "trapezoid") else np.trapz(y, axis=axis)


def _principal_axis_integrals(psd: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Integrals of the (periodically tiled) PSD along its two principal
    axes (reference ``_pcax:744-795``)."""
    from scipy.interpolate import interpn
    from scipy.linalg import svd

    n = psd.shape[0]
    g2, g1 = np.meshgrid(np.arange(1, n + 1), np.arange(1, n + 1))

    total = _trapz_axis(_trapz_axis(psd, 1), 0)
    p_n = psd / total

    m2 = _trapz_axis(_trapz_axis(p_n * g2, 1), 0)
    m1 = _trapz_axis(_trapz_axis(p_n * g1, 1), 0)

    c = np.zeros(4)
    q1 = [2, 1, 1, 0]
    q2 = [0, 1, 1, 2]
    for jj in (0, 1, 3):
        c[jj] = _trapz_axis(
            _trapz_axis(p_n * (g2 - m2) ** q1[jj] * (g1 - m1) ** q2[jj], 1), 0
        )
    c[2] = c[1]
    u, _, _ = svd(c.reshape(2, 2))

    n3 = 3 * n
    coords = np.arange(1, n3 + 1) - (n3 + 1) / 2
    g2_n3, g1_n3 = np.meshgrid(coords, coords)
    psd_rep = np.tile(psd, (3, 3))

    def rotated_integral(theta):
        g2c = g2_n3[n:2 * n, n:2 * n]
        g1c = g1_n3[n:2 * n, n:2 * n]
        g2_rot = g2c * np.cos(theta) - g1c * np.sin(theta)
        g1_rot = g1c * np.cos(theta) + g2c * np.sin(theta)
        rot = interpn((coords, coords), psd_rep, (g1_rot, g2_rot))
        return _trapz_axis(rot, 0)

    theta1 = np.angle(u[0, 0] + 1j * u[0, 1])
    theta2 = np.angle(u[1, 0] + 1j * u[1, 1])
    return rotated_integral(theta1), rotated_integral(theta2)


def psd_features(psd65: np.ndarray) -> np.ndarray:
    """Feature vector (20,) from banded sums of the principal-axis
    integrals (reference ``_get_features:719-741``)."""
    sz = psd65.shape[0]
    int1, int2 = _principal_axis_integrals(psd65)
    k = len(_INDICES_TO_TAKE)
    f = np.zeros(2 * k)
    center = int(np.ceil(sz / 2))
    for ii, upper in enumerate(_INDICES_TO_TAKE):
        if ii == 0:
            idx = np.asarray([center + upper - 1 - 1])
        else:
            lo = _INDICES_TO_TAKE[ii - 1]
            idx = center + np.arange(lo, upper) - 1
        f[ii] = int1[idx].sum() / len(idx)
        f[k + ii] = int2[idx].sum() / len(idx)
    return f


def _load_db(path: Optional[str] = None):
    import scipy.io as sio

    path = path or DEFAULT_DB
    if not os.path.exists(path):
        return None
    data = sio.loadmat(path)
    return data["features"], data["maxes"]


def estimate_parameters_for_psd(
    psd65: np.ndarray, db_path: Optional[str] = None
) -> Tuple[float, float, float, float]:
    """(lambda_thr3d, mu2, lambda_re, mu2_re) for a 65x65 PSD.

    Mirrors reference ``:633-717``: whitened-PCA distance to the feature
    database, inverse-distance weighting of the 20 nearest samples'
    optimal parameter indices, linear interpolation on the parameter grids.
    Falls back to the white-noise golden constants if the database asset is
    unavailable and the PSD is flat.
    """
    from numpy.fft import fftshift
    from scipy.linalg import svd

    psd65 = np.asarray(psd65, np.float64)
    db = _load_db(db_path)
    if db is None:
        flat = float(psd65.std() / (psd65.mean() + _EPS))
        if flat < 0.1:
            return 3.0, 0.4, 2.5, 3.6
        raise FileNotFoundError(
            "param_matching_data.mat unavailable and PSD is colored; set "
            "PNPADMM_BM3D_PARAMS or pass explicit profile parameters"
        )
    features, maxes = db
    data_sz = features.shape[1]

    pcaxa = psd_features(fftshift(psd65))

    mm = features.mean(axis=1)
    f2 = features - mm[:, None]
    c = (f2 @ f2.T) / data_sz
    pcax2 = pcaxa - mm
    u, s, _ = svd(c)
    f2 = u @ f2
    pcax2 = u @ pcax2
    f2 = f2 * np.sqrt(s)[:, None]
    pcax2 = pcax2 * np.sqrt(s)

    diff = np.sqrt(np.sum((f2 - pcax2[:, None]) ** 2, axis=0))
    order = np.argsort(diff)[:20]
    inv = 1.0 / (diff + _EPS)
    wts = inv[order] / inv[order].sum()
    param_idxs = (wts * maxes[order, :].T).sum(axis=1)

    def interp(grid, idx):
        idx = max(1.0, idx) - 1.0
        lo = grid[int(np.floor(idx))]
        hi = grid[int(min(np.ceil(idx), grid.size - 1))]
        t = idx - np.floor(idx)
        return float(hi * t + lo * (1 - t))

    lam = interp(_LAMBDA_GRID, param_idxs[0])
    mu2 = interp(_MU2_GRID, param_idxs[1])
    lam_re = interp(_LAMBDA_GRID, param_idxs[2])
    mu2_re = interp(_MU2_GRID, param_idxs[3])
    return lam, mu2, lam_re, mu2_re


def shrink_and_normalize_psd(psd: np.ndarray, new_size: int = 65) -> np.ndarray:
    """Image-size PSD -> canonical 65x65 PSD for parameter estimation.

    Reference ``_get_kernel_from_psd:811-822`` + ``_shrink_and_normalize_
    psd:825-841``: recover the correlation kernel
    ``fftshift(real(ifft2(sqrt(P/(H W)))))``, crop its center to 65x65,
    l2-normalize, and take ``|fft2|^2 * 65 * 65``. A flat (white) PSD of
    ANY size and scale maps to the constant 65*65 — the normalization the
    feature database was built with (the reference's own golden test:
    white PSDs then estimate to exactly (3.0, 0.4, 2.5, 3.6)).
    """
    psd = np.asarray(psd, np.float64)
    h, w = psd.shape[-2:]
    sig = np.sqrt(psd / (h * w))
    kernel = np.fft.fftshift(np.real(np.fft.ifft2(sig)))
    ms = np.maximum(np.ceil((np.array([h, w]) - new_size) / 2).astype(int), 0)
    k = kernel[ms[0]:ms[0] + new_size, ms[1]:ms[1] + new_size].copy()
    k /= np.sqrt((k**2).sum())
    return np.abs(np.fft.fft2(k, s=(new_size, new_size))) ** 2 * new_size * new_size


def estimate_parameters_for_image_psd(
    psd: np.ndarray, db_path: Optional[str] = None
) -> Tuple[float, float, float, float]:
    """Parameter auto-selection from an image-size PSD (any H, W):
    canonical 65x65 normalization then feature matching. White PSDs of any
    size/scale yield exactly (3.0, 0.4, 2.5, 3.6) like the reference."""
    return estimate_parameters_for_psd(shrink_and_normalize_psd(psd), db_path)
