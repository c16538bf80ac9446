"""Deterministic MRI-like phantoms in numpy, made from a seed.

After the JAX package's ``train/synth.py::mri_phantoms``: a skull ellipse,
nested random-contrast ellipses inside it, a smooth bias field and a light
texture, blurred and clipped to [0, 1]. Built with numpy's generator, so
the images differ from the JAX ones, but a seed always gives the same batch.
"""

from __future__ import annotations

import numpy as np

MAX_ELLIPSES = 12
CHUNK = 32  # images made together; bounds the (CHUNK, size, size) temporaries


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Periodic Gaussian blur of the trailing (H, W) axes through the FFT."""
    h, w = img.shape[-2:]
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    ker = np.exp(-2.0 * (np.pi * sigma) ** 2 * (fy**2 + fx**2)).astype(np.float32)
    return np.fft.irfft2(np.fft.rfft2(img) * ker, s=(h, w)).astype(np.float32)


def mri_phantoms(n: int, size: int = 256, seed: int = 0) -> np.ndarray:
    """(n, size, size) float32 phantoms in [0, 1]; image i depends only on
    ``(seed, i)``."""
    grid = np.arange(size, dtype=np.float32)
    c = (size - 1) / 2.0
    out = np.empty((n, size, size), np.float32)

    def ellipse(ecy, ecx, a, b, th):
        """Inside test for k ellipses, parameters of shape (k,) -> (k, H, W).

        The rotated quadratic form splits into a row term, a column term
        and one outer product, so only that product is computed per pixel.
        """
        cos, sin = np.cos(th), np.sin(th)
        qa = (cos / a) ** 2 + (sin / b) ** 2
        qc = (sin / a) ** 2 + (cos / b) ** 2
        qb = 2.0 * cos * sin * (1.0 / b**2 - 1.0 / a**2)
        dy = (grid[None, :] - ecy[:, None]).astype(np.float32)
        dx = (grid[None, :] - ecx[:, None]).astype(np.float32)
        q = (qb[:, None].astype(np.float32) * dy)[:, :, None] * dx[:, None, :]
        q += (qa[:, None].astype(np.float32) * dy * dy)[:, :, None]
        q += (qc[:, None].astype(np.float32) * dx * dx)[:, None, :]
        return q <= 1.0

    # every image's parameters and noise fields come from its own generator
    gens = [np.random.default_rng((seed, i)) for i in range(n)]
    for lo in range(0, n, CHUNK):
        g = gens[lo:lo + CHUNK]
        k = len(g)
        draw = lambda f: np.stack([f(r) for r in g])  # noqa: E731
        centre = np.full(k, c)
        skull = ellipse(centre, centre, size * draw(lambda r: r.uniform(0.33, 0.45)),
                        size * draw(lambda r: r.uniform(0.28, 0.40)), draw(lambda r: r.uniform(0.0, np.pi)))
        img = np.where(skull, draw(lambda r: r.uniform(0.55, 0.85))[:, None, None], 0.0).astype(np.float32)
        n_ell = draw(lambda r: r.integers(MAX_ELLIPSES // 2, MAX_ELLIPSES + 1))
        ep = draw(lambda r: r.random((MAX_ELLIPSES, 6))).transpose(1, 2, 0)
        for i, p in enumerate(ep):
            m = ellipse(c + (p[2] - 0.5) * 0.44 * size, c + (p[3] - 0.5) * 0.44 * size,
                        size * (0.03 + 0.19 * p[0]), size * (0.03 + 0.19 * p[1]), p[4] * np.pi)
            m &= skull
            m &= (i < n_ell)[:, None, None]
            shift = ((p[5] - 0.5) * 0.9).astype(np.float32)[:, None, None]
            np.copyto(img, np.clip(img + shift, 0.05, 1.0), where=m)
        fields = draw(lambda r: r.standard_normal((2, size, size), np.float32))
        bias = _blur(fields[:, 0], size / 6.0)
        bias = 1.0 + 0.25 * bias / np.maximum(np.abs(bias).max(axis=(-2, -1), keepdims=True), 1e-12)
        tex = _blur(fields[:, 1], 1.2)
        img = img * bias + 0.015 * tex * skull
        out[lo:lo + k] = np.clip(_blur(img, 0.8), 0.0, 1.0)
    return out
