"""Leakage-free training corpus for the denoiser priors, in numpy.

Port of the JAX package's ``train/corpus.py``: images with no overlap with
the evaluation testsets.

1. **Local sample images** shipped with installed packages (sklearn's
   china/flower, matplotlib's grace_hopper and the s1045 MRI head slice,
   pygame's demo photos) or with the reference's BM3D examples
   (cameraman, Lena, brainslice.mat). The packages' folders are found with
   ``importlib.util.find_spec``, without importing them; a package that is
   not installed contributes nothing.
2. **Dead-leaves synthetics**: occluding disks with power-law radii
   (Achddou et al. 2021).
3. **Elastic-warp clones** of the two in-domain MRI slices.
4. **1/f Gaussian fields and ellipse phantoms** (the spectral-diversity
   families).

The numpy families draw and compute as the JAX package's, so they give the
same arrays for the same seed.
"""

from __future__ import annotations

import gzip
import importlib.util
import os
from typing import Dict, List, Optional

import numpy as np

from pnp_admm_cnc_mri_torch.data import images
from pnp_admm_cnc_mri_torch.data.noise import DEFAULT_DATA_DIR

# ---------------------------------------------------------------------------
# 1. Local sample images


def _package_dir(name: str) -> Optional[str]:
    """The folder of an installed package, or None; the package is not imported."""
    try:
        spec = importlib.util.find_spec(name)
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.origin:
        return None
    return os.path.dirname(spec.origin)


def _candidate_paths() -> Dict[str, str]:
    """name -> path for every locally available clean sample image."""
    out: Dict[str, str] = {}
    cands = []
    sk = _package_dir("sklearn")
    if sk:
        cands += [(n, os.path.join(sk, "datasets", "images", f"{n}.jpg")) for n in ("china", "flower")]
    pg = _package_dir("pygame")
    if pg:
        cands += [(n, os.path.join(pg, "docs", "generated", "_images", f"{n}.jpg"))
                  for n in ("camera_rgb", "camera_background", "intro_freedom", "intro_blade")]
    mpl = _package_dir("matplotlib")
    if mpl:
        sample = os.path.join(mpl, "mpl-data", "sample_data")
        cands += [("grace_hopper", os.path.join(sample, "grace_hopper.jpg")),
                  ("s1045_mri", os.path.join(sample, "s1045.ima.gz"))]
    # the reference's BM3D example images, beside its CS_MRI folder (PNPADMM_DATA)
    ref_ex = os.path.join(os.path.dirname(os.path.normpath(DEFAULT_DATA_DIR)), "bm3d307", "examples")
    cands += [(n, os.path.join(ref_ex, f)) for n, f in (("cameraman", "cameraman256.png"),
                                                       ("lena", "image_Lena512rgb.png"),
                                                       ("brainslice", "brainslice.mat"))]
    for n, p in cands:
        if os.path.exists(p):
            out[n] = p
    return out


def _from_pil(path: str) -> np.ndarray:
    from PIL import Image  # ImportError when PIL is not installed: the candidate is skipped

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float32) / 255.0


def _load_one(path: str) -> np.ndarray:
    if path.endswith(".ima.gz"):
        # matplotlib's s1045.ima.gz: a raw 256 x 256 uint16 big-endian MRI slice
        with gzip.open(path, "rb") as fh:
            raw = np.frombuffer(fh.read(), dtype=">u2").reshape(256, 256)
        arr = raw.astype(np.float32)
        return arr / max(float(arr.max()), 1e-12)
    if path.endswith(".mat"):
        import scipy.io as sio

        arrs = {k: v for k, v in sio.loadmat(path).items() if not k.startswith("__")}
        arr = np.abs(np.asarray(next(iter(arrs.values())), np.float64))
        if arr.ndim == 3:
            arr = arr.mean(axis=-1)
        return (arr / max(float(arr.max()), 1e-12)).astype(np.float32)
    if path.endswith(".png"):
        try:
            return images.imread_gray(path).astype(np.float32) / 255.0
        except ValueError:  # a PNG form the port's codec refuses (RGB, palette, ...)
            return _from_pil(path)
    return _from_pil(path)


def local_sample_images(min_side: int = 96) -> Dict[str, np.ndarray]:
    """All locally available clean sample images as (H, W) float32 [0,1].
    A candidate that cannot be read (no PIL for a JPEG, a damaged file) is
    skipped, as in the JAX package."""
    out = {}
    for name, path in _candidate_paths().items():
        try:
            img = _load_one(path)
        except Exception:  # noqa: BLE001 - any unreadable candidate is skipped
            continue
        if min(img.shape[:2]) >= min_side:
            out[name] = img
    return out


# ---------------------------------------------------------------------------
# 2. Dead-leaves synthetics


def dead_leaves(
    n: int,
    size: int = 256,
    seed: int = 0,
    rmin: float = 2.0,
    rmax: float = 80.0,
    alpha: float = 3.0,
    sigma_blur: float = 0.7,
) -> np.ndarray:
    """(n, size, size) float32 dead-leaves images: disks with power-law
    radii r^-alpha, uniform gray levels, painted front to back (a pixel
    keeps the first disk that covers it), then a light Gaussian blur."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = np.empty((n, size, size), np.float32)
    a1 = 1.0 - alpha  # inverse-CDF sampling of r ~ r^-alpha on [rmin, rmax]
    for i in range(n):
        img = np.full((size, size), rng.uniform(0.2, 0.8), np.float32)
        filled = np.zeros((size, size), bool)
        for _ in range(4000):
            u = rng.uniform()
            r = (rmin ** a1 + u * (rmax ** a1 - rmin ** a1)) ** (1.0 / a1)
            cx, cy = rng.uniform(0, size, 2)
            g = rng.uniform()
            m = ((xx - cx) ** 2 + (yy - cy) ** 2) <= r * r
            img[m & ~filled] = g
            filled |= m
            if filled.all():
                break
        if sigma_blur > 0:
            img = gaussian_filter(img, sigma_blur)
        imgs[i] = img
    return imgs.clip(0.0, 1.0)


# ---------------------------------------------------------------------------
# 3. Elastic-warp clones of in-domain MRI slices


def elastic_warp(
    img: np.ndarray,
    n: int,
    seed: int = 0,
    amp: float = 12.0,
    smooth: float = 24.0,
) -> np.ndarray:
    """(n, H, W) smooth random warps of one image: Gaussian-smoothed white
    noise displacements (amplitude ``amp`` px, correlation ``smooth`` px)
    plus a small random rotation and scale, cubic resampling."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(seed)
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w), np.float32)
    for i in range(n):
        dx = gaussian_filter(rng.standard_normal((h, w)), smooth)
        dy = gaussian_filter(rng.standard_normal((h, w)), smooth)
        for d in (dx, dy):
            m = np.abs(d).max()
            if m > 0:
                d *= amp / m
        th = rng.uniform(-0.35, 0.35)
        sc = rng.uniform(0.85, 1.15)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        xr = (np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy)) / sc + cx
        yr = (np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy)) / sc + cy
        out[i] = map_coordinates(img, [yr + dy, xr + dx], order=3, mode="reflect").astype(np.float32)
    return out.clip(0.0, 1.0)


# ---------------------------------------------------------------------------
# Assembly


def build_clean_corpus(
    n_dead_leaves: int = 24,
    n_mri_warps: int = 16,
    seed: int = 0,
    min_side: int = 96,
) -> Dict[str, np.ndarray]:
    """The full leakage-free corpus: name -> (H, W) float32 [0,1]: the local
    sample images, ``n_mri_warps`` warps of each MRI slice and
    ``n_dead_leaves`` dead-leaves images."""
    corpus = local_sample_images(min_side=min_side)
    mri_names = [n for n in ("s1045_mri", "brainslice") if n in corpus]
    for j, name in enumerate(mri_names):
        warps = elastic_warp(corpus[name], n_mri_warps, seed=seed + 101 * j)
        for i in range(n_mri_warps):
            corpus[f"{name}_warp{i:02d}"] = warps[i]
    dl = dead_leaves(n_dead_leaves, size=256, seed=seed + 7)
    for i in range(n_dead_leaves):
        corpus[f"deadleaves{i:02d}"] = dl[i]
    return corpus


def materialize(out_dir: str, **kwargs) -> List[str]:
    """Write the corpus as 8-bit grayscale PNGs to ``out_dir``; returns the
    written paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, img in sorted(build_clean_corpus(**kwargs).items()):
        p = os.path.join(out_dir, f"{name}.png")
        with open(p, "wb") as f:
            f.write(images.encode_png_gray8((img * 255.0 + 0.5).astype(np.uint8)))
        paths.append(p)
    return paths


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="scripts/clean_corpus")
    p.add_argument("--n_dead_leaves", type=int, default=24)
    p.add_argument("--n_mri_warps", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    paths = materialize(args.out, n_dead_leaves=args.n_dead_leaves, n_mri_warps=args.n_mri_warps, seed=args.seed)
    print(f"wrote {len(paths)} images to {args.out}")
    return 0


# ---------------------------------------------------------------------------
# 4. Spectral-diversity synthetics


def gaussian_fields(n: int, size: int = 256, seed: int = 0, beta_range: tuple = (1.0, 2.5)) -> np.ndarray:
    """(n, size, size) float32 1/f^beta Gaussian random fields, beta drawn
    per image, min-max normalized."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(size)[:, None]
    fx = np.fft.fftfreq(size)[None, :]
    rad = np.sqrt(fy**2 + fx**2)
    rad[0, 0] = 1.0 / size
    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        beta = rng.uniform(*beta_range)
        spec = (rng.standard_normal((size, size)) + 1j * rng.standard_normal((size, size))) * rad ** (-beta / 2.0)
        img = np.fft.ifft2(spec).real
        lo, hi = img.min(), img.max()
        out[i] = ((img - lo) / max(hi - lo, 1e-12)).astype(np.float32)
    return out


def mri_phantoms(n: int, size: int = 256, seed: int = 0, n_ellipses: tuple = (6, 14)) -> np.ndarray:
    """(n, size, size) float32 random multi-ellipse MRI-like phantoms: a skull
    ellipse, nested random-contrast ellipses, a smooth bias field and light
    texture inside the support."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy, cx = (size - 1) / 2.0, (size - 1) / 2.0

    def ellipse_mask(ecy, ecx, a, b, th):
        yr = (yy - ecy) * np.cos(th) - (xx - ecx) * np.sin(th)
        xr = (yy - ecy) * np.sin(th) + (xx - ecx) * np.cos(th)
        return (yr / a) ** 2 + (xr / b) ** 2 <= 1.0

    out = np.empty((n, size, size), np.float32)
    for i in range(n):
        img = np.zeros((size, size), np.float32)
        skull = ellipse_mask(cy, cx, size * rng.uniform(0.33, 0.45), size * rng.uniform(0.28, 0.4),
                             rng.uniform(0, np.pi))
        img[skull] = rng.uniform(0.55, 0.85)
        for _ in range(rng.integers(*n_ellipses)):
            a = size * rng.uniform(0.03, 0.22)
            b = size * rng.uniform(0.03, 0.22)
            ecy = cy + rng.uniform(-0.22, 0.22) * size
            ecx = cx + rng.uniform(-0.22, 0.22) * size
            m = ellipse_mask(ecy, ecx, a, b, rng.uniform(0, np.pi)) & skull
            img[m] = np.clip(img[m] + rng.uniform(-0.45, 0.45), 0.05, 1.0)  # blend: nested contrasts
        bias = gaussian_filter(rng.standard_normal((size, size)), size / 6.0)
        bias = 1.0 + 0.25 * bias / max(np.abs(bias).max(), 1e-12)
        tex = gaussian_filter(rng.standard_normal((size, size)), 1.2)
        img = img * bias + 0.015 * tex * skull
        img = gaussian_filter(img, 0.8)
        out[i] = img.clip(0.0, 1.0)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
