"""Image I/O and conversions of the reference's per-image pipeline (numpy).

A copy of the JAX package's ``data/images.py`` with its cv2 calls replaced
by readers of the standard library (``zlib``, ``struct``), numpy and PIL.
Reference pipeline (``【1】ADMM_L1.py:85-90``): read an image as grayscale,
``modcrop(·, 8)``, uint8 to [0, 1] float, and the uint8 clip round-trip
(``use_clip``); conversions as ``utils/utils_image.py:145-194``.

``imread_gray`` gives the pixels of ``cv2.imread(path, IMREAD_GRAYSCALE)``
(cv2 5.0) and ``imread_uint(path, 3)`` those of ``IMREAD_UNCHANGED`` plus
``cvtColor`` to RGB, for a file of any of these formats, told by its first
bytes and never by its name (the reference's testsets hold BMP and JPEG
payloads under ``.png`` names):

- PNG, every standard form: grayscale at 1, 2, 4, 8 and 16 bits, palette
  (with or without ``tRNS``), RGB, RGBA and grayscale with alpha at 8 and
  16 bits, every row filter, plain or Adam7-interlaced. Sub-byte gray scales
  to 0-255, 16 bits keep their high byte, alpha and ``tRNS`` are dropped,
  and colour goes to gray as libpng's ``png_set_rgb_to_gray`` does
  (``_rgb_to_gray_png``);
- JPEG and BMP (through PIL), PPM/PGM and TIFF (``data/formats.py``),
  where colour goes to gray by OpenCV's own fixed-point rule.

Kinds the readers do not take (arithmetic-coded, lossless or 12-bit JPEG,
tiled or JPEG-compressed TIFF, RLE BMP, PBM, ...) raise a
``ValueError`` that names them. ``channel_convert`` has cv2's
``COLOR_BGR2GRAY``. The writer writes 8-bit grayscale PNG, all that
``imsave`` writes.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from typing import List, NamedTuple, Optional

import numpy as np

from pnp_admm_cnc_mri_torch.data.formats import Raster, decode_bmp, decode_jpeg, decode_pnm, decode_tiff
from pnp_admm_cnc_mri_torch.data.noise import DEFAULT_DATA_DIR

IMG_EXTENSIONS = (
    ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG",
    ".ppm", ".PPM", ".bmp", ".BMP", ".tif",
)  # the reference's exact list (utils_image.py:22): uppercase variants
#    for all but .tif

# the reference's asset tree holds testsets/ beside CS_MRI/
DEFAULT_TESTSETS = os.environ.get(
    "PNPADMM_TESTSETS", os.path.normpath(os.path.join(DEFAULT_DATA_DIR, os.pardir, "testsets")))

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale with alpha", 6: "RGBA"}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# the seven Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

class PNG(NamedTuple):
    """A decoded PNG: ``samples`` (H, W, C) uint8 (depth <= 8, sub-byte
    samples unscaled) or uint16, C the channels of ``color`` (palette
    indices for colour type 3); ``palette`` (N, 3) uint8 or None."""

    samples: np.ndarray
    color: int
    depth: int
    palette: Optional[np.ndarray]


def _png_chunks(data: bytes, what: str):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            break
        body = data[pos + 8:end]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"{what}: CRC mismatch in the {ctype.decode('latin-1')} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{what}: truncated PNG (no IEND chunk)")


def _unfilter_sequential(ftype: int, line: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4) reconstruction of one row: each byte depends
    on the reconstructed byte ``bpp`` to its left."""
    line, up = line.tolist(), up.tolist()
    out = [0] * len(line)
    for x, (f, b) in enumerate(zip(line, up)):
        a = out[x - bpp] if x >= bpp else 0
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (f + pred) & 0xFF
    return np.asarray(out, dtype=np.uint8)


def _unfilter(raw: bytes, pos: int, h: int, stride: int, bpp: int, what: str):
    """The h reconstructed rows of ``stride`` bytes at ``raw[pos:]`` (each
    after its filter byte), and the position after them."""
    end = pos + h * (stride + 1)
    if end > len(raw):
        raise ValueError(f"{what}: PNG data holds {len(raw)} bytes, too few for its size")
    rows = np.frombuffer(raw, dtype=np.uint8, count=h * (stride + 1), offset=pos).reshape(h, stride + 1)
    ftypes, data = rows[:, 0], rows[:, 1:]
    if np.any(ftypes > 4):
        raise ValueError(f"{what}: unknown PNG row filter {int(ftypes.max())}")
    img = np.empty((h, stride), dtype=np.uint8)
    # None (0) and Sub (1, a running sum mod 256 over each byte of a pixel)
    # rows depend on no other row: all at once; then Up (2), Average (3) and
    # Paeth (4) in row order
    img[ftypes == 0] = data[ftypes == 0]
    sub = data[ftypes == 1]
    if len(sub):
        img[ftypes == 1] = np.cumsum(sub.reshape(len(sub), -1, bpp), axis=1, dtype=np.uint8).reshape(sub.shape)
    for r in np.flatnonzero(ftypes >= 2):
        up = img[r - 1] if r else np.zeros(stride, dtype=np.uint8)
        img[r] = data[r] + up if ftypes[r] == 2 else _unfilter_sequential(int(ftypes[r]), data[r], up, bpp)
    return img, end


def _unpack(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """The first ``n`` samples of each row of bytes, MSB first."""
    if depth == 16:
        return rows.view(">u2")[:, :n].astype(np.uint16)
    if depth == 8:
        return rows[:, :n]
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :n]


def decode_png(data: bytes, what: str = "PNG") -> PNG:
    """Decode a PNG of any standard form: every colour type and bit depth,
    every row filter, plain or Adam7-interlaced."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, body in _png_chunks(data, what):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{what}: PNG without an IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"{what}: invalid PNG colour type {color} at bit depth {depth}")
    if compression or filter_method or interlace > 1:
        raise ValueError(f"{what}: unknown PNG compression, filter or interlace method")
    if color == 3 and palette is None:
        raise ValueError(f"{what}: palette PNG without a PLTE chunk")
    ch = _PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    img = np.empty((h, w, ch), dtype=np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:  # an empty pass has no rows, not even filter bytes
            rows, pos = _unfilter(raw, pos, ph, -(-pw * ch * depth // 8), bpp, what)
            img[y0::dy, x0::dx] = _unpack(rows, pw * ch, depth).reshape(ph, pw, ch)
    if pos != len(raw):
        raise ValueError(f"{what}: PNG data holds {len(raw)} bytes, expected {pos}")
    if color == 3 and int(img.max(initial=0)) >= len(palette):
        raise ValueError(f"{what}: palette index beyond the PLTE chunk")
    return PNG(img, color, depth, palette)


def _rgb_to_gray_png(rgb: np.ndarray, depth: int) -> np.ndarray:
    """libpng's ``png_set_rgb_to_gray(1, 0.299, 0.587)`` as cv2 reads a colour
    PNG as grayscale: coefficients 9797, 19234, 3737 over 2^15, truncated at
    8 bits, rounded at 16 bits and then cut to the high byte."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    if depth == 16:
        return (((9797 * r + 19234 * g + 3737 * b + 16384) >> 15) >> 8).astype(np.uint8)
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _gray8(png: PNG) -> np.ndarray:
    """What ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives for a PNG."""
    s = png.samples
    if png.color == 3:
        return _rgb_to_gray_png(png.palette[s[..., 0]], 8)
    if png.color in (2, 6):
        return _rgb_to_gray_png(s[..., :3], png.depth)
    g = s[..., 0]  # grayscale, with alpha dropped
    if png.depth == 16:
        return (g >> 8).astype(np.uint8)
    return g * np.uint8(255 // ((1 << png.depth) - 1))


def encode_png_gray8(img: np.ndarray) -> bytes:
    """Encode a uint8 (H, W) array as an 8-bit grayscale PNG (no row filter)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    raw = np.zeros((h, w + 1), dtype=np.uint8)
    raw[:, 1:] = img

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))

    return (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def get_image_paths(dirpath: str) -> List[str]:
    """Sorted image paths in a directory (reference ``utils_image.py:66-82``)."""
    paths = []
    for ext in IMG_EXTENSIONS:
        paths.extend(glob.glob(os.path.join(dirpath, f"*{ext}")))
    return sorted(paths)


def _png_raster(png: PNG) -> Raster:
    s = png.samples
    if png.color == 3:
        rgb = png.palette[s[..., 0]]
    elif png.color in (2, 6):
        rgb = s[..., :3].copy()
    else:
        rgb = s[..., :1] if png.depth >= 8 else s[..., :1] * np.uint8(255 // ((1 << png.depth) - 1))
    return Raster(rgb, _gray8(png))


def decode_image(data: bytes, what: str = "image", gray: bool = True) -> np.ndarray:
    """Decode an image file's bytes by its first bytes, never its name: PNG,
    JPEG, BMP, PPM/PGM or TIFF (the reference's testsets hold BMP and JPEG
    payloads under ``.png`` names). For ``gray``, the (H, W) uint8 pixels of
    ``IMREAD_GRAYSCALE``; else the (H, W, 1) or (H, W, 3) samples of
    ``IMREAD_UNCHANGED`` in RGB order, alpha dropped, uint8 or uint16. Kinds
    the readers do not take raise a ``ValueError`` that names them."""
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data, what, gray)
    if data[:2] == b"BM":
        return decode_bmp(data, what, gray)
    if data[:8] == _PNG_SIGNATURE:
        raster = _png_raster(decode_png(data, what))
    elif data[:4] in (b"II*\x00", b"MM\x00*"):
        raster = decode_tiff(data, what)
    elif data[:1] == b"P" and data[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6", b"7"):
        raster = decode_pnm(data, what)
    else:
        raise ValueError(f"{what}: not an image file of a known format (PNG, JPEG, BMP, PPM/PGM, TIFF)")
    return raster.gray if gray else raster.samples


def _read(path: str, gray: bool) -> np.ndarray:
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        return decode_image(f.read(), path, gray)


def imread_gray(path: str) -> np.ndarray:
    """Read one image as uint8 grayscale (H, W): the reference's
    ``cv2.imread(path, 0)`` (``utils_image.py:145-151``), to the same pixels
    for every form the readers take (see the module docstring)."""
    return _read(path, gray=True)


def modcrop(img: np.ndarray, scale: int = 8) -> np.ndarray:
    """Crop H and W down to multiples of ``scale`` (``utils_image.py:495-508``)."""
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale, ...]


def uint2single(img: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float [0,1] (``utils_image.py:181-183``)."""
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with clip+round (``utils_image.py:190-192``)."""
    return np.uint8((img.clip(0, 1) * 255.0).round())


def _load(paths: List[str], scale: int, use_clip: bool):
    """(float64 [0, 1] images, uint8 images, names) of image files."""
    imgs, uints, names = [], [], []
    for p in paths:
        u = modcrop(imread_gray(p), scale)
        f = uint2single(u)
        if use_clip:
            f = uint2single(single2uint(f))
        imgs.append(np.float64(f))
        uints.append(u)
        names.append(os.path.splitext(os.path.basename(p))[0])
    return imgs, uints, names


def load_testset(
    dirpath: str, scale: int = 8, use_clip: bool = True
) -> tuple[np.ndarray, np.ndarray, List[str]]:
    """Load a testset directory as a batch.

    Returns ``(imgs01, imgs_uint, names)``: ``imgs01`` the float64 [0, 1]
    batch fed to the forward model and ``imgs_uint`` the uint8-scale ground
    truth (as float64) used for metrics (reference ``【1】:85-90``).
    ``use_clip`` applies the reference's uint8 clip round-trip.
    """
    paths = get_image_paths(dirpath)
    if not paths:
        raise FileNotFoundError(f"no images under {dirpath}")
    return load_files(paths, scale, use_clip)


def load_files(paths: List[str], scale: int = 8, use_clip: bool = True):
    """:func:`load_testset` of the image files ``paths``, in their order."""
    imgs, uints, names = _load(paths, scale, use_clip)
    return np.stack(imgs), np.stack(uints).astype(np.float64), names


def load_images_dir(
    dirpath: str, scale: int = 8, use_clip: bool = True
) -> tuple[List[np.ndarray], List[str]]:
    """Like :func:`load_testset` but returns a *list* of float [0, 1]
    images, so directories of heterogeneous sizes load without stacking."""
    paths = get_image_paths(dirpath)
    if not paths:
        raise FileNotFoundError(f"no images under {dirpath}")
    imgs, _, names = _load(paths, scale, use_clip)
    return imgs, names


def imsave(img255: np.ndarray, path: str) -> None:
    """Save a [0, 255] float grayscale image (H, W) or (H, W, 1) as PNG
    (reference ``utils_image.py:160-164``)."""
    img = np.uint8(np.asarray(img255).clip(0, 255).round())
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim != 2:
        raise ValueError(f"imsave writes grayscale images only, got shape {img.shape}")
    if not path.lower().endswith(".png"):
        raise ValueError(f"imsave writes PNG only, got {path!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png_gray8(img))


def is_image_file(filename: str) -> bool:
    """Extension test (reference ``utils_image.py:25-26``)."""
    return filename.endswith(IMG_EXTENSIONS)


def imread_uint(path: str, n_channels: int = 3) -> np.ndarray:
    """Read as HxWx1 grayscale or HxWx3 RGB (gray replicated to GGG),
    reference ``utils_image.py:145-157``: for 3 channels, what
    ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` and ``cv2.cvtColor`` to RGB
    give, alpha dropped, 16-bit samples kept as uint16."""
    if n_channels == 1:
        return imread_gray(path)[..., None]
    s = _read(path, gray=False)
    return np.repeat(s, 3, axis=-1) if s.shape[-1] == 1 else s


def uint162single(img: np.ndarray) -> np.ndarray:
    """uint16 -> [0,1] float32 (reference ``utils_image.py:189-190``)."""
    return np.float32(img / 65535.0)


def single2uint16(img: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint16 (reference ``utils_image.py:193-194``, which
    casts to uint8 by mistake; uint16 here, as in the JAX package)."""
    return np.uint16((np.asarray(img).clip(0, 1) * 65535.0).round())


def shave(img: np.ndarray, border: int = 0) -> np.ndarray:
    """Crop a ``border``-wide frame (reference ``utils_image.py:510-515``)."""
    h, w = img.shape[:2]
    return img[border:h - border, border:w - border]


def augment_img(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """The 8-mode dihedral augmentation on HxW(xC) numpy images
    (reference ``utils_image.py:315-331``; exact mode correspondence)."""
    if mode == 0:
        return img
    if mode == 1:
        return np.flipud(np.rot90(img))
    if mode == 2:
        return np.flipud(img)
    if mode == 3:
        return np.rot90(img, k=3)
    if mode == 4:
        return np.flipud(np.rot90(img, k=2))
    if mode == 5:
        return np.rot90(img)
    if mode == 6:
        return np.rot90(img, k=2)
    if mode == 7:
        return np.flipud(np.rot90(img, k=3))
    raise ValueError(f"mode must be 0..7, got {mode}")


# ---------------------------------------------------------------------------
# MATLAB-compatible YCbCr conversions (reference utils_image.py:427-516)
# ---------------------------------------------------------------------------

_Y_FROM_RGB = np.array([65.481, 128.553, 24.966])
_YCBCR_FROM_RGB = np.array([
    [65.481, -37.797, 112.0],
    [128.553, -74.203, -93.786],
    [24.966, 112.0, -18.214],
])
_RGB_FROM_YCBCR = np.array([
    [0.00456621, 0.00456621, 0.00456621],
    [0.0, -0.00153632, 0.00791071],
    [0.00625893, -0.00318811, 0.0],
])


def _ycbcr_common(img: np.ndarray, mat, offset):
    """uint8 stays on the [0, 255] scale and rounds; float works on [0, 1]
    and rescales. The input is never changed in place (the reference's
    ``img *= 255.`` writes through to the caller's array)."""
    in_type = img.dtype
    x = np.asarray(img, np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    rlt = x @ mat + offset
    if in_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.0
    return rlt.astype(in_type)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """MATLAB ``rgb2ycbcr`` (reference ``utils_image.py:427-449``)."""
    if only_y:
        return _ycbcr_common(img, _Y_FROM_RGB / 255.0, 16.0)
    return _ycbcr_common(img, _YCBCR_FROM_RGB / 255.0,
                         np.array([16.0, 128.0, 128.0]))


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR-ordered ``rgb2ycbcr`` (reference ``utils_image.py:471-493``)."""
    if only_y:
        return _ycbcr_common(img, _Y_FROM_RGB[::-1] / 255.0, 16.0)
    return _ycbcr_common(img, _YCBCR_FROM_RGB[::-1] / 255.0,
                         np.array([16.0, 128.0, 128.0]))


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """MATLAB ``ycbcr2rgb`` (reference ``utils_image.py:451-468``)."""
    return _ycbcr_common(img, _RGB_FROM_YCBCR * 255.0,
                         np.array([-222.921, 135.576, -276.836]))


def _bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)``: for uint8 and uint16,
    cv2's fixed point, ``(3735 B + 19235 G + 9798 R + 2^14) >> 15``; for
    floats, ``0.114 B + 0.587 G + 0.299 R`` in float32 (cv2 orders its
    multiply-adds otherwise: within an ulp)."""
    b, g, r = (img[..., k] for k in range(3))
    if img.dtype in (np.uint8, np.uint16):
        wide = [c.astype(np.int64) for c in (b, g, r)]
        return ((3735 * wide[0] + 19235 * wide[1] + 9798 * wide[2] + (1 << 14)) >> 15).astype(img.dtype)
    f = np.float32
    return (b * f(0.114) + g * f(0.587) + r * f(0.299)).astype(img.dtype)


def channel_convert(in_c: int, tar_type: str, img_list):
    """BGR / gray / y list conversion (reference ``utils_image.py:519-530``)."""
    if in_c == 3 and tar_type == "gray":
        return [_bgr_to_gray(img)[..., None] for img in img_list]
    if in_c == 3 and tar_type == "y":
        return [bgr2ycbcr(img, only_y=True)[..., None] for img in img_list]
    if in_c == 1 and tar_type == "RGB":
        return [np.repeat(img.reshape(*img.shape[:2], 1), 3, axis=-1) for img in img_list]
    return img_list
