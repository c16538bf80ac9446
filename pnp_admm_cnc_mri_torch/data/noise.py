"""K-space noise, and the colored-noise families of the BM3D experiments.

A copy of the JAX package's ``data/noise.py`` (numpy and scipy). The
reference loads one fixed 256x256 complex128 noise field scaled x3
(``CS_MRI/noises.mat``, reference ``【1】ADMM_L1.py:185-186``) and, for the
BM3D variants, a PSD from ``get_experiment_noise`` (reference
``utils/experiment_funcs.py:94-127``), which *ignores* the generated noise
and returns the fixed .mat realization, but still returns the requested
kernel's PSD (the quirk at ``:121-125``). Without ``noises.mat`` it
synthesizes the colored noise instead.
"""

from __future__ import annotations

import os

import numpy as np

DEFAULT_DATA_DIR = os.environ.get("PNPADMM_DATA", "/root/reference/CS_MRI")

NOISE_TYPES = ("gw", "g0", "g1", "g2", "g3", "g4", "g1w", "g2w", "g3w", "g4w")


def load_noise(data_dir: str | None = None, scale: float = 3.0) -> np.ndarray:
    """The fixed complex noise realization, x3 as the reference loads it."""
    import scipy.io as sio

    data_dir = data_dir or DEFAULT_DATA_DIR
    mat = sio.loadmat(os.path.join(data_dir, "noises.mat"))
    return mat["noises"].astype(np.complex128) * scale


def synth_noise(shape: tuple[int, int], std: float = 10.0, seed: int = 0) -> np.ndarray:
    """Circular complex Gaussian k-space noise."""
    rng = np.random.default_rng(seed)
    re = rng.normal(0.0, std, shape)
    im = rng.normal(0.0, std, shape)
    return re + 1j * im


def white_noise_psd(shape: tuple[int, int], noise_var: float = 0.03) -> np.ndarray:
    """PSD of white Gaussian noise as the BM3D variants consume it: the
    constant ``var * H * W`` of ``get_experiment_noise('gw', var, ...)``'s
    delta kernel (reference ``utils/experiment_funcs.py:25-46, 125``)."""
    h, w = shape
    return np.full(shape, noise_var * h * w, dtype=np.float64)


def _gaussian_kernel(size, std, std2=None):
    """Separable 2-D Gaussian window (reference ``bm3d307.bm3d.gaussian_kernel``)."""
    from scipy.signal.windows import gaussian

    g1 = gaussian(int(size[0]), std=std).reshape(int(size[0]), 1)
    g2 = gaussian(int(size[1]), std=std if std2 is None else std2).reshape(1, int(size[1]))
    return g1 * g2


def get_experiment_kernel(noise_type: str, noise_var: float, sz=(101, 101)) -> np.ndarray:
    """Noise-shaping kernels g0-g4 and their 'w' white-mix variants
    (reference ``utils/experiment_funcs.get_experiment_kernel:25-91``): the
    ten stationary noise families of the BM3D experiments (white, line,
    circular, diagonal, pink, each optionally mixed with a white floor),
    normalized to l2 energy ``sqrt(noise_var)``."""
    from numpy.fft import fft2, fftshift, ifft2, ifftshift

    kernel = np.array([[1.0]])
    if noise_type not in NOISE_TYPES:
        raise ValueError(f"noise type must be one of {list(NOISE_TYPES)}")

    if noise_type not in ("g4", "g4w"):
        sz = np.array([101, 101])
    else:
        sz = np.array(sz)

    sz2 = -(1 - (sz % 2)) * 1 + np.floor(sz / 2)
    sz1 = np.floor(sz / 2)
    uu, vv = np.meshgrid(
        np.arange(-int(sz1[0]), int(sz2[0]) + 1),
        np.arange(-int(sz1[1]), int(sz2[1]) + 1),
    )
    beta = 0.8

    if noise_type.startswith("g1"):
        kernel = np.atleast_2d(16 - np.abs(np.linspace(1, 31, 31) - 16))
    elif noise_type.startswith("g2"):
        kernel = np.cos(np.sqrt(uu**2 + vv**2)) * _gaussian_kernel((sz[0], sz[1]), 10)
    elif noise_type.startswith("g3"):
        kernel = np.cos(uu + vv) * _gaussian_kernel((sz[0], sz[1]), 10)
    elif noise_type.startswith("g4"):
        n = sz[0] * sz[1]
        dist = uu**2 + vv**2
        spec = np.sqrt((np.sqrt(n) * 1e-2) / (np.sqrt(dist) + np.sqrt(n) * 1e-2))
        kernel = fftshift(ifft2(ifftshift(spec)))
    else:  # gw / g0
        beta = 0

    if len(noise_type) > 2 and noise_type[2] == "w":
        kernel = kernel / np.sqrt(np.sum(kernel**2))
        kalpha = np.sqrt((1 - beta) + beta * np.abs(fft2(kernel, (sz[0], sz[1]))) ** 2)
        kernel = fftshift(ifft2(kalpha))

    kernel = np.real(kernel)
    return kernel / np.sqrt(np.sum(kernel**2)) * np.sqrt(noise_var)


def experiment_psd(kernel: np.ndarray, shape) -> np.ndarray:
    """The PSD of the noise a kernel shapes, on an (H, W) grid, in the
    ``var * H * W`` convention (reference ``get_experiment_noise:125``)."""
    return np.abs(np.fft.fft2(kernel, (shape[0], shape[1]))) ** 2 * shape[0] * shape[1]


def get_experiment_noise(noise_type: str, noise_var: float, realization: int, sz, data_dir: str | None = None):
    """(noise, psd, kernel) for an experiment configuration.

    Faithful to the reference's modified ``get_experiment_noise:94-127``: it
    ignores the generated convolution noise and returns the fixed
    ``noises.mat`` x3 realization, while still returning the PSD of the
    requested kernel. Without the file the noise is synthesized
    (``synth_colored_noise``).
    """
    np.random.seed(realization)
    kernel = get_experiment_kernel(noise_type, noise_var, sz)
    try:
        noise = load_noise(data_dir)
    except Exception:
        noise = synth_colored_noise(sz[:2], kernel, seed=realization)
    return noise, experiment_psd(kernel, sz), kernel


def synth_colored_noise(shape, kernel: np.ndarray, seed: int = 0) -> np.ndarray:
    """Stationary colored noise by kernel convolution (what the unmodified
    upstream helper would produce)."""
    from scipy.signal import fftconvolve

    rng = np.random.default_rng(seed)
    kh, kw = np.asarray(kernel.shape) // 2 + 1
    big = rng.standard_normal((shape[0] + 2 * kh, shape[1] + 2 * kw))
    return fftconvolve(big, np.atleast_2d(kernel), mode="same")[kh:kh + shape[0], kw:kw + shape[1]]
