"""Write the image fixtures of ``tests/torch_image_fixtures/`` with cv2.

    python3 probes/make_image_fixtures.py [OUT_DIR]

Encodes a few small files per format with cv2 (BMP, PGM/PPM, TIFF with
each compression, JPEG at each sampling and with restart intervals) and
a 1-bit and a 4-bit BMP with a writer of its own (cv2 writes neither),
each under 64 KB, and stores what cv2 reads from each in ``pixels.npz``:
``<file>/gray`` from ``cv2.imread(path, IMREAD_GRAYSCALE)`` and
``<file>/rgb`` from ``IMREAD_UNCHANGED`` with ``cvtColor`` to RGB (gray
replicated), the JAX package's ``imread_uint(path, 3)``. The 256 x 256
JPEGs (``testset*``, gray pixels only) are the JPEG payloads of
``chip_smoke.py``'s testset: the script reads no cv2. Needs cv2 and numpy; the images are made from
seed 0, so a rerun with the same cv2 writes the same files.
"""

from __future__ import annotations

import os
import struct
import sys

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "torch_image_fixtures")


def scene(rng, h, w, c, dtype=np.uint8, noise=0.15):
    """Smooth bands and texture with noise: every gray level and colour varies."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0) * np.cos(yy / 5.0) + 1) / 2
    top = 255 if dtype == np.uint8 else 65535
    a = np.stack([(base * (k + 1) / c + noise * rng.random((h, w))) % 1 for k in range(c)], -1)
    a = (a * top).astype(dtype)
    return a[..., 0] if c == 1 else a


def bmp_palette(idx: np.ndarray, palette: np.ndarray, bpp: int) -> bytes:
    """A bottom-up BMP of palette indices at 1, 4 or 8 bits (palette RGB)."""
    h, w = idx.shape
    stride = (w * bpp + 31) // 32 * 4
    bits = np.unpackbits(idx.astype(np.uint8)[..., None], axis=-1)[..., 8 - bpp:].reshape(h, -1)
    rows = np.packbits(bits, axis=1)
    px = np.zeros((h, stride), np.uint8)
    px[:, : rows.shape[1]] = rows
    pal = np.zeros((len(palette), 4), np.uint8)
    pal[:, :3] = palette[:, ::-1]
    off = 14 + 40 + pal.size
    head = struct.pack("<2sIHHI", b"BM", off + px.size, 0, 0, off)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bpp, 0, px.size, 2835, 2835, len(palette), 0)
    return head + info + pal.tobytes() + px[::-1].tobytes()


def main(out: str = OUT) -> None:
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    files = {}
    jpeg_sampling = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                     "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
    enc = {
        "gray8.bmp": (scene(rng, 45, 38, 1), []),
        "rgb24.bmp": (scene(rng, 41, 50, 3), []),
        "gray8.pgm": (scene(rng, 40, 33, 1), []),
        "rgb8.ppm": (scene(rng, 35, 42, 3), []),
        "gray16_ascii.pgm": (scene(rng, 20, 23, 1, np.uint16), [cv2.IMWRITE_PXM_BINARY, 0]),
        "rgb16.ppm": (scene(rng, 30, 27, 3, np.uint16), []),
        "gray8_none.tif": (scene(rng, 40, 52, 1), [cv2.IMWRITE_TIFF_COMPRESSION, 1]),
        "rgb8_lzw.tif": (scene(rng, 44, 39, 3), [cv2.IMWRITE_TIFF_COMPRESSION, 5]),
        "rgba8_deflate.tif": (scene(rng, 33, 47, 4), [cv2.IMWRITE_TIFF_COMPRESSION, 32946]),
        "gray16_packbits.tif": (scene(rng, 37, 29, 1, np.uint16), [cv2.IMWRITE_TIFF_COMPRESSION, 32773]),
        "rgb16_lzw.tif": (scene(rng, 26, 31, 3, np.uint16), [cv2.IMWRITE_TIFF_COMPRESSION, 5]),
        "gray_q75.jpg": (scene(rng, 37, 53, 1), [cv2.IMWRITE_JPEG_QUALITY, 75]),
    }
    for s, flag in jpeg_sampling.items():
        enc[f"ycc{s}_rst.jpg"] = (scene(rng, 43, 61, 3), [cv2.IMWRITE_JPEG_QUALITY, 85,
                                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
                                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    # the 256 x 256 JPEG payloads of chip_smoke.py's testset
    for k, s in enumerate(("444", "420", "422", "440", "420")):
        img = scene(rng, 256, 256, 1 if k == 0 else 3, noise=0.02)
        enc[f"testset{k}_{s}.jpg"] = (img, [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                            jpeg_sampling[s], cv2.IMWRITE_JPEG_RST_INTERVAL, 4 * k])
    for name, (img, params) in enc.items():
        ok, buf = cv2.imencode(os.path.splitext(name)[1], img, params)
        if not ok:
            raise RuntimeError(f"cv2 could not encode {name}")
        files[name] = buf.tobytes()
    for bpp in (1, 4):
        pal = rng.integers(0, 256, (1 << bpp, 3)).astype(np.uint8)
        files[f"pal{bpp}.bmp"] = bmp_palette(rng.integers(0, 1 << bpp, (29, 35)), pal, bpp)
    pixels = {}
    for name, data in files.items():
        if len(data) >= 64 * 1024:
            raise RuntimeError(f"{name} is {len(data)} bytes, over 64 KB")
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        rgb = cv2.cvtColor(raw, cv2.COLOR_GRAY2RGB if raw.ndim == 2 else cv2.COLOR_BGR2RGB)
        pixels[f"{name}/gray"] = gray
        if not name.startswith("testset"):  # the testset is read gray; small files hold the colour cases
            pixels[f"{name}/rgb"] = rgb
    np.savez_compressed(os.path.join(out, "pixels.npz"), **pixels)
    print(f"{len(files)} files, {sum(map(len, files.values()))} bytes, in {out}")


if __name__ == "__main__":
    main(*sys.argv[1:])
