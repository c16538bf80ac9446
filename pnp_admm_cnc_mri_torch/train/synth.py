"""Procedural training corpora made on the device: unlimited leakage-free data.

Port of the JAX package's ``train/synth.py``: dead leaves, 1/f Gaussian
fields, MRI ellipse phantoms and elastic warps of seed images, each a
``generator(gen, n) -> (n, size, size)`` float32 tensor on the device of
the ``torch.Generator`` ``gen``. The stream trainer regenerates its buffer
from them without moving an image across the host link.

torch's generator cannot replay ``jax.random``, so the draws differ from
the JAX package's; the families' formulas are the same, and the tests hold
their statistics and their determinism under a seed. The elastic warp's
bilinear resampling is ``jax.scipy.ndimage.map_coordinates(order=1,
mode="reflect")`` written as a gather (``map_coordinates_reflect``): it
reflects the integer neighbour indices, which ``grid_sample``'s reflection
padding (it reflects the coordinates) does not.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

# elements of the (images, disks, H, W) coverage block dead_leaves builds at once
_COVER_BLOCK = 1 << 25


def _grid(size: int, device):
    r = torch.arange(size, device=device, dtype=torch.float32)
    return r.view(size, 1), r.view(1, size)  # yy, xx (broadcast to size x size)


def _uniform(gen, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _gauss_blur_fft(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of the trailing (H, W) axes through the FFT (periodic
    edges, irrelevant for training data)."""
    h, w = img.shape[-2:]
    fy = torch.fft.fftfreq(h, device=img.device, dtype=torch.float64)[:, None]
    fx = torch.fft.fftfreq(w, device=img.device, dtype=torch.float64)[None, :]
    ker = torch.exp(-2.0 * (math.pi * sigma) ** 2 * (fy**2 + fx**2)).to(img.dtype)
    return torch.fft.ifft2(torch.fft.fft2(img) * ker).real.to(img.dtype)


# ---------------------------------------------------------------------------
# Dead leaves (occlusion statistics; Achddou et al. 2021)


def dead_leaves(gen: torch.Generator, n: int, size: int = 128, rmin: float = 2.0, rmax: float = 40.0,
                alpha: float = 3.0, n_disks: int = 600, sigma_blur: float = 0.7) -> torch.Tensor:
    """(n, size, size) float32 dead-leaves images: power-law radii r^-alpha
    (inverse-CDF sampled), uniform gray disks painted front to back (a pixel
    takes the first disk, in draw order, that covers it), a light blur.

    The painting is vectorised as "first covering disk" over blocks of
    images and disks instead of a loop over the ``n_disks`` disks."""
    yy, xx = _grid(size, gen.device)
    a1 = 1.0 - alpha
    u = _uniform(gen, (n, n_disks))
    r = (rmin**a1 + u * (rmax**a1 - rmin**a1)) ** (1.0 / a1)
    c = _uniform(gen, (n, n_disks, 2), 0.0, float(size))
    g = _uniform(gen, (n, n_disks))
    bg = _uniform(gen, (n,), 0.2, 0.8)
    imgs = bg.view(n, 1, 1).expand(n, size, size).clone()
    r2, cy, cx = r * r, c[..., 0], c[..., 1]
    n_img = max(1, min(n, _COVER_BLOCK // (min(n_disks, 32) * size * size)))
    n_dsk = max(1, _COVER_BLOCK // (n_img * size * size))
    for i in range(0, n, n_img):
        img, sl = imgs[i:i + n_img], slice(i, i + n_img)
        filled = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
        for k in range(0, n_disks, n_dsk):
            ks = slice(k, k + n_dsk)
            dx2 = (xx - cx[sl, ks, None, None]) ** 2  # (m, K, 1, size)
            dy2 = (yy - cy[sl, ks, None, None]) ** 2  # (m, K, size, 1)
            cover = (dx2 + dy2) <= r2[sl, ks, None, None]
            first = cover.to(torch.uint8).argmax(dim=1)  # the first covering disk of the block
            val = torch.gather(g[sl, ks], 1, first.flatten(1)).view_as(img)
            hit = cover.any(dim=1)
            img.copy_(torch.where(hit & ~filled, val, img))
            filled |= hit
    if sigma_blur > 0:
        imgs = _gauss_blur_fft(imgs, sigma_blur)
    return imgs.clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# 1/f^beta Gaussian random fields (multiscale-texture statistics)


def gaussian_fields(gen: torch.Generator, n: int, size: int = 128, beta_range=(1.0, 2.5)) -> torch.Tensor:
    """(n, size, size) float32 power-law-spectrum fields, min-max
    normalized per image."""
    fy = torch.fft.fftfreq(size, device=gen.device)[:, None]
    fx = torch.fft.fftfreq(size, device=gen.device)[None, :]
    rad = torch.sqrt(fy**2 + fx**2)
    rad[0, 0] = 1.0 / size
    beta = _uniform(gen, (n, 1, 1), *beta_range)
    re = torch.randn((n, size, size), generator=gen, device=gen.device)
    im = torch.randn((n, size, size), generator=gen, device=gen.device)
    img = torch.fft.ifft2(torch.complex(re, im) * rad ** (-beta / 2.0)).real
    lo, hi = img.amin(dim=(-2, -1), keepdim=True), img.amax(dim=(-2, -1), keepdim=True)
    return ((img - lo) / torch.clamp(hi - lo, min=1e-12)).float()


# ---------------------------------------------------------------------------
# MRI-like ellipse phantoms (piecewise-smooth anatomy)


def mri_phantoms(gen: torch.Generator, n: int, size: int = 128, max_ellipses: int = 12) -> torch.Tensor:
    """(n, size, size) float32 Shepp-Logan-style random phantoms: a skull
    ellipse, up to ``max_ellipses`` nested random-contrast ellipses, a
    smooth bias field and light texture, all inside the skull."""
    yy, xx = _grid(size, gen.device)
    cy, cx = (size - 1) / 2.0, (size - 1) / 2.0

    def ellipse(ecy, ecx, a, b, th):
        yr = (yy - ecy) * torch.cos(th) - (xx - ecx) * torch.sin(th)
        xr = (yy - ecy) * torch.sin(th) + (xx - ecx) * torch.cos(th)
        return (yr / a) ** 2 + (xr / b) ** 2 <= 1.0

    def per_image(lo, hi):
        return _uniform(gen, (n, 1, 1), lo, hi)

    skull = ellipse(cy, cx, size * per_image(0.33, 0.45), size * per_image(0.28, 0.40), per_image(0.0, math.pi))
    img = torch.where(skull, per_image(0.55, 0.85), 0.0)
    n_ell = torch.randint(max_ellipses // 2, max_ellipses + 1, (n, 1, 1), generator=gen, device=gen.device)
    ep = _uniform(gen, (max_ellipses, 6, n, 1, 1))
    for k in range(max_ellipses):
        p = ep[k]
        a = size * (0.03 + 0.19 * p[0])
        b = size * (0.03 + 0.19 * p[1])
        ecy = cy + (p[2] - 0.5) * 0.44 * size
        ecx = cx + (p[3] - 0.5) * 0.44 * size
        m = ellipse(ecy, ecx, a, b, p[4] * math.pi) & skull & (k < n_ell)
        img = torch.where(m, torch.clamp(img + (p[5] - 0.5) * 0.9, 0.05, 1.0), img)
    bias = _gauss_blur_fft(torch.randn((n, size, size), generator=gen, device=gen.device), size / 6.0)
    bias = 1.0 + 0.25 * bias / torch.clamp(bias.abs().amax(dim=(-2, -1), keepdim=True), min=1e-12)
    tex = _gauss_blur_fft(torch.randn((n, size, size), generator=gen, device=gen.device), 1.2)
    img = img * bias + 0.015 * tex * skull
    return torch.clamp(_gauss_blur_fft(img, 0.8), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Elastic warps of seed images (in-domain MRI statistics)


def _reflect_index(index: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.scipy.ndimage``'s 'reflect' index fixer: the triangular wave
    ``|(i + s) mod 2s - s|`` at i = 2 index + 1, s = 2 size, then
    ``floor((. - 1) / 2)``: an index past an edge maps to its mirror
    image, the edge pixel repeated (..., 1, 0 | 0, 1, ...)."""
    s = 2 * size
    tri = torch.abs(torch.remainder(2 * index + 1 + s, 2 * s) - s)
    return torch.div(tri - 1, 2, rounding_mode="floor")


def map_coordinates_reflect(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the (N, h, w) images at the (N, ...) coordinates
    (y, x), ``jax.scipy.ndimage.map_coordinates(img[i], [y[i], x[i]],
    order=1, mode="reflect")`` for each i: the four neighbours' indices
    reflected, their weights ``w_y w_x``, summed in JAX's order."""
    n, h, w = img.shape
    nodes = []
    for c, size in ((y, h), (x, w)):
        lower = torch.floor(c)
        upper_w = c - lower
        i0 = lower.to(torch.int64)
        nodes.append(((_reflect_index(i0, size), 1 - upper_w), (_reflect_index(i0 + 1, size), upper_w)))
    flat = img.reshape(-1)
    base = (torch.arange(n, device=img.device) * (h * w)).view(n, *([1] * (y.dim() - 1)))
    out = None
    for iy, wy in nodes[0]:
        for ix, wx in nodes[1]:
            term = (wy * wx) * flat[base + iy * w + ix]
            out = term if out is None else out + term
    return out


def elastic_warps(gen: torch.Generator, seeds: torch.Tensor, n: int, size: int = 128, amp: float = 8.0,
                  smooth: float = 16.0) -> torch.Tensor:
    """(n, size, size) float32 warps of ``seeds`` ((K, H, W) on the
    generator's device): FFT-low-passed white-noise displacements plus a
    small random rotation and scale, bilinear resampling with reflected
    edges (``map_coordinates_reflect``)."""
    k_seeds, h, w = seeds.shape
    yy, xx = _grid(size, gen.device)
    scy, scx = (h - 1) / 2.0, (w - 1) / 2.0
    which = torch.randint(0, k_seeds, (n,), generator=gen, device=gen.device)

    def field():
        d = _gauss_blur_fft(torch.randn((n, size, size), generator=gen, device=gen.device), smooth)
        return d * (amp / torch.clamp(d.abs().amax(dim=(-2, -1), keepdim=True), min=1e-12))

    dx, dy = field(), field()
    th = _uniform(gen, (n, 1, 1), -0.35, 0.35)
    sc = _uniform(gen, (n, 1, 1), 0.85, 1.15)
    # the output grid (size x size) onto the seed's coordinates (h x w), scaled to cover the whole seed
    gy = (yy - (size - 1) / 2.0) * (h / size)
    gx = (xx - (size - 1) / 2.0) * (w / size)
    xr = (torch.cos(th) * gx - torch.sin(th) * gy) / sc + scx
    yr = (torch.sin(th) * gx + torch.cos(th) * gy) / sc + scy
    out = map_coordinates_reflect(seeds[which].float(), yr + dy, xr + dx)
    return torch.clamp(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Mixture


def family_counts(n: int, mix) -> tuple:
    """(dead leaves, Gaussian fields, phantoms, warps) images of an n-image
    draw: ``round(n mix)`` each, the phantoms taking the rest."""
    n_dl = int(round(n * mix[0]))
    n_gf = int(round(n * mix[1]))
    n_wp = int(round(n * mix[3]))
    return n_dl, n_gf, n - n_dl - n_gf - n_wp, n_wp


def make_generator(size: int = 128, mix=(0.35, 0.2, 0.3, 0.15), seeds: Optional[torch.Tensor] = None,
                   n_disks: int = 600) -> Callable[[torch.Generator, int], torch.Tensor]:
    """``generator(gen, n) -> (n, size, size)`` drawing the four families in
    the proportions ``mix`` = (dead_leaves, gaussian_fields, phantoms,
    warps). Without ``seeds`` the warp share goes to the phantoms. The
    counts are fixed for each n (``family_counts``); a permutation
    interleaves the families."""
    mix = list(mix)
    if seeds is None:
        mix = [mix[0], mix[1], mix[2] + mix[3], 0.0]
    tot = sum(mix)
    mix = [m / tot for m in mix]

    def generator(gen: torch.Generator, n: int) -> torch.Tensor:
        n_dl, n_gf, n_ph, n_wp = family_counts(n, mix)
        parts = []
        if n_dl:
            parts.append(dead_leaves(gen, n_dl, size, n_disks=n_disks))
        if n_gf:
            parts.append(gaussian_fields(gen, n_gf, size))
        if n_ph:
            parts.append(mri_phantoms(gen, n_ph, size))
        if n_wp:
            parts.append(elastic_warps(gen, seeds, n_wp, size))
        imgs = torch.cat(parts, dim=0)
        return imgs[torch.randperm(n, generator=gen, device=gen.device)]

    generator.mix = tuple(mix)
    return generator


def warp_seed_stack(imgs: dict, include_photos: bool = True, side: int = 256) -> Optional[np.ndarray]:
    """The (K, side, side) float32 stack of ``load_warp_seeds`` from the
    sample images ``imgs`` (name -> (H, W)): the two MRI slices first, then
    the photos in name order, each centre-cropped square and resized
    bilinearly in numpy (the JAX package's host resize). None when empty."""
    names = [n for n in ("s1045_mri", "brainslice") if n in imgs]
    if include_photos:
        names += [n for n in sorted(imgs) if n not in names]
    if not names:
        return None
    seeds = []
    for n in names:
        im = np.asarray(imgs[n], np.float32)
        h, w = im.shape[:2]
        s = min(h, w)
        im = im[(h - s) // 2:(h - s) // 2 + s, (w - s) // 2:(w - s) // 2 + s]
        yi = np.linspace(0, s - 1, side)
        xi = np.linspace(0, s - 1, side)
        y0 = np.clip(yi.astype(int), 0, s - 2)
        x0 = np.clip(xi.astype(int), 0, s - 2)
        wy = (yi - y0)[:, None]
        wx = (xi - x0)[None, :]
        a = im[np.ix_(y0, x0)]
        b = im[np.ix_(y0, x0 + 1)]
        c = im[np.ix_(y0 + 1, x0)]
        d = im[np.ix_(y0 + 1, x0 + 1)]
        seeds.append((a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx)
                     .astype(np.float32))
    return np.stack(seeds)


def load_warp_seeds(include_photos: bool = True, side: int = 256, device=None) -> Optional[torch.Tensor]:
    """The leakage-free warp seeds (``train.corpus.local_sample_images``: the
    two non-testset MRI slices and, with ``include_photos``, the other
    sample photos) as a (K, side, side) tensor on ``device`` (None: the CUDA
    card), or None where no sample image is installed."""
    from pnp_admm_cnc_mri_torch.solvers.admm import resolve_device
    from pnp_admm_cnc_mri_torch.train import corpus

    stack = warp_seed_stack(corpus.local_sample_images(), include_photos, side)
    return None if stack is None else torch.from_numpy(stack).to(resolve_device(device))
