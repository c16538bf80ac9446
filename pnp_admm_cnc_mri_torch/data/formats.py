"""BMP, JPEG, PPM/PGM and TIFF readers of ``data/images.py``.

Each gives the pixels cv2 (5.0) gives (``cv2.imread``): ``IMREAD_UNCHANGED``
in RGB order with alpha dropped, and ``IMREAD_GRAYSCALE``, where colour goes
to gray by OpenCV's own fixed-point rule (``_gray_from_rgb8``), not libpng's.

- JPEG and BMP are decoded by PIL (imported at first use), which gives
  cv2's pixels there: both decode JPEG with libjpeg-turbo. A gray JPEG read
  asks libjpeg for its grayscale output (``draft('L')``: the Y plane, with
  no chroma work) and applies the EXIF orientation, as cv2's
  ``IMREAD_GRAYSCALE`` does; a colour read takes libjpeg's RGB output with
  the orientation ignored, as ``IMREAD_UNCHANGED`` does. Baseline,
  extended-sequential and progressive Huffman JPEG, 8-bit, gray or YCbCr.
  BMP: 1-, 4- and 8-bit palette, 24- and 32-bit, bottom-up or top-down,
  uncompressed (32-bit also with the standard bit-field masks).
- PPM/PGM and TIFF are read here (numpy, ``zlib``, ``struct``), because
  PIL's pixels differ from cv2's there: PIL cuts 16-bit colour samples to
  8 bits, scales ASCII samples of a maxval below 255 otherwise, and reads a
  palette TIFF's colour map otherwise.
- PPM/PGM: P2, P3 (ASCII), P5, P6 (binary), maxval up to 65535. As cv2
  does: binary samples are taken as stored; ASCII samples are clipped to
  maxval and, at maxval below 256, scaled by ``255 // maxval`` in integers
  (``v * 255 // maxval``); 16-bit samples go to 8 bits as ``v >> 8``.
- TIFF: baseline strips, uncompressed, PackBits, LZW or Deflate, with or
  without the horizontal predictor; 8- and 16-bit gray and RGB (an extra
  sample such as alpha is dropped) and 8-bit palette. A gray read of
  16-bit gray takes ``v >> 8``; of colour it goes through libtiff's RGBA
  reader, as cv2's does: 16-bit samples become ``(v + 128) // 257``, a
  16-bit colour map ``v >> 8``.

Other kinds (arithmetic-coded, lossless, hierarchical, 12-bit or CMYK JPEG,
RLE or 16-bit BMP, PBM and PAM, tiled, planar, JPEG-compressed or float
TIFF, ...) raise a ``ValueError`` that names them.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import NamedTuple

import numpy as np


class Raster(NamedTuple):
    """A decoded image as cv2 reads it: ``samples`` (H, W, 1) gray or
    (H, W, 3) RGB, uint8 or uint16, the pixels of ``IMREAD_UNCHANGED`` in RGB
    order with alpha dropped; ``gray`` (H, W) uint8, the pixels of
    ``IMREAD_GRAYSCALE``."""

    samples: np.ndarray
    gray: np.ndarray


def _gray_from_rgb8(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's fixed-point BGR-to-gray of its readers (``icvCvt_BGR2Gray``,
    14 bits): ``(1868 B + 9617 G + 4899 R + 2^13) >> 14`` of 8-bit samples.
    Exact on gray (R = G = B): the weights sum to 2^14."""
    r, g, b = (rgb[..., k].astype(np.int32) for k in range(3))
    return ((1868 * b + 9617 * g + 4899 * r + 8192) >> 14).astype(np.uint8)


def _raster8(samples: np.ndarray) -> Raster:
    """A Raster of 8-bit gray (H, W, 1) or RGB (H, W, 3) samples."""
    gray = samples[..., 0] if samples.shape[-1] == 1 else _gray_from_rgb8(samples)
    return Raster(samples, gray)


def _pil_open(data: bytes, what: str):
    from PIL import Image

    try:
        return Image.open(io.BytesIO(data))
    except Exception as e:  # PIL's UnidentifiedImageError, OSError, SyntaxError
        raise ValueError(f"{what}: {e}") from None


def _pil_pixels(what: str, decode) -> np.ndarray:
    """The pixels of ``decode()``, a PIL image: a truncated or corrupt file
    fails there, with whichever error PIL raises for it."""
    try:
        return np.asarray(decode())
    except Exception as e:
        raise ValueError(f"{what}: {e}") from None


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

_SOF_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
                0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
                0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
                0xCE: "arithmetic-coded hierarchical progressive", 0xCF: "arithmetic-coded hierarchical lossless"}


def _check_jpeg_frame(data: bytes, what: str) -> None:
    """Refuse, by the frame header, the kinds not held to cv2 here."""
    pos = 2
    while pos + 4 < len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if marker in _SOF_REFUSED:
                raise ValueError(f"{what}: {_SOF_REFUSED[marker]} JPEG is not supported")
            if data[pos + 4] != 8:
                raise ValueError(f"{what}: {data[pos + 4]}-bit JPEG is not supported")
            return
        if marker == 0xDA:
            break
        pos += 2 + struct.unpack_from(">H", data, pos + 2)[0]
    raise ValueError(f"{what}: JPEG without a frame header before its first scan")


def decode_jpeg(data: bytes, what: str = "JPEG", gray: bool = True) -> np.ndarray:
    """(H, W) uint8 for ``gray``, else (H, W, 1) or (H, W, 3) RGB uint8."""
    from PIL import ImageOps

    _check_jpeg_frame(data, what)
    im = _pil_open(data, what)
    if im.mode not in ("L", "RGB"):
        raise ValueError(f"{what}: {im.mode} JPEG is not supported")
    if not gray:
        a = _pil_pixels(what, lambda: im)
        return a[..., None] if a.ndim == 2 else a
    im.draft("L", im.size)  # libjpeg's JCS_GRAYSCALE output: the Y plane of a YCbCr file
    return _pil_pixels(what, lambda: ImageOps.exif_transpose(im))


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def decode_bmp(data: bytes, what: str = "BMP", gray: bool = True) -> np.ndarray:
    """(H, W) uint8 for ``gray``, else (H, W, 3) RGB uint8."""
    if len(data) < 30 or data[:2] != b"BM":
        raise ValueError(f"{what}: truncated or not a BMP file")
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize == 12:  # OS/2 core header
        bpp, compression = struct.unpack_from("<H", data, 24)[0], 0
    elif hsize >= 40 and len(data) >= 14 + hsize:
        bpp, compression = struct.unpack_from("<HI", data, 28)
    else:
        raise ValueError(f"{what}: BMP with an unknown {hsize}-byte header")
    if compression in (1, 2):
        raise ValueError(f"{what}: RLE-compressed BMP is not supported")
    if compression == 3:  # bit fields: the masks follow a 40-byte header, or sit inside a longer one
        masks = struct.unpack_from("<III", data, 54)
        if bpp != 32 or masks != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"{what}: BMP with bit-field masks {masks} at {bpp} bits is not supported")
    elif compression != 0:
        raise ValueError(f"{what}: BMP compression {compression} is not supported")
    if bpp not in (1, 4, 8, 24, 32):
        raise ValueError(f"{what}: {bpp}-bit BMP is not supported")
    im = _pil_open(data, what)
    rgb = _pil_pixels(what, lambda: im if im.mode == "RGB" else im.convert("RGB"))
    return _gray_from_rgb8(rgb) if gray else rgb


# ---------------------------------------------------------------------------
# PPM / PGM
# ---------------------------------------------------------------------------


def _pnm_header(data: bytes, what: str):
    """(width, height, maxval, offset of the samples) after the magic."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and (data[pos:pos + 1].isspace() or data[pos:pos + 1] == b"#"):
            if data[pos:pos + 1] == b"#":
                end = data.find(b"\n", pos)
                pos = len(data) if end < 0 else end
            pos += 1
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError(f"{what}: malformed PPM/PGM header")
        fields.append(int(data[start:pos]))
    if pos >= len(data) or not data[pos:pos + 1].isspace():
        raise ValueError(f"{what}: malformed PPM/PGM header")
    return fields[0], fields[1], fields[2], pos + 1


def decode_pnm(data: bytes, what: str = "PPM") -> Raster:
    magic = data[:2]
    if magic in (b"P1", b"P4"):
        raise ValueError(f"{what}: PBM (Netpbm bitmap) files are not supported")
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"{what}: Netpbm {magic.decode('latin-1')} (PAM) files are not supported")
    w, h, maxval, pos = _pnm_header(data, what)
    if w <= 0 or h <= 0 or not 1 <= maxval <= 65535:
        raise ValueError(f"{what}: PPM/PGM of size {w} x {h}, maxval {maxval}")
    ch = 3 if magic in (b"P3", b"P6") else 1
    n = w * h * ch
    if magic in (b"P5", b"P6"):
        dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
        if pos + n * dt.itemsize > len(data):
            raise ValueError(f"{what}: truncated PPM/PGM")
        s = np.frombuffer(data, dt, n, pos).astype(dt.newbyteorder("="))
    else:
        words = data[pos:].split()
        if len(words) < n:
            raise ValueError(f"{what}: PPM/PGM holds {len(words)} samples, expected {n}")
        try:
            v = np.minimum(np.array([int(t) for t in words[:n]], dtype=np.int64), maxval)
        except ValueError:
            raise ValueError(f"{what}: a PPM/PGM sample is not a number") from None
        s = (v * 255 // maxval).astype(np.uint8) if maxval < 256 else v.astype(np.uint16)
    s = s.reshape(h, w, ch)
    s8 = s if s.dtype == np.uint8 else (s >> 8).astype(np.uint8)
    return Raster(s, s8[..., 0] if ch == 1 else _gray_from_rgb8(s8))


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i"}
_TIFF_COMPRESSION = {1: None, 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_TIFF_REFUSED = {2: "CCITT", 3: "CCITT fax 3", 4: "CCITT fax 4", 6: "JPEG", 7: "JPEG", 34712: "JPEG 2000",
                 34887: "LERC", 50000: "ZSTD", 34925: "LZMA", 50001: "WebP"}


def _tiff_tags(data: bytes, what: str):
    """The tags of the first IFD: {tag: tuple of values}, and the byte order."""
    bo = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(bo + "I", data, 4)
    if ifd < 8 or ifd + 2 > len(data):
        raise ValueError(f"{what}: truncated or malformed TIFF (directory at {ifd})")
    (count,) = struct.unpack_from(bo + "H", data, ifd)
    tags = {}
    for k in range(count):
        tag, typ, n, val = struct.unpack_from(bo + "HHI4s", data, ifd + 2 + 12 * k)
        if typ not in _TIFF_TYPES:
            continue  # rationals, doubles: no tag read here needs them
        size = struct.calcsize(_TIFF_TYPES[typ]) * n
        raw = val[:size] if size <= 4 else data[struct.unpack(bo + "I", val)[0]:][:size]
        if len(raw) < size:
            raise ValueError(f"{what}: truncated TIFF tag {tag}")
        tags[tag] = raw if typ == 2 else struct.unpack(bo + _TIFF_TYPES[typ] * n, raw)
    return tags, bo


def _packbits(buf: bytes, what: str) -> bytes:
    out, pos = bytearray(), 0
    while pos < len(buf):
        n = buf[pos]
        pos += 1
        if n < 128:
            out += buf[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            out += buf[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out)


def _lzw(buf: bytes, what: str) -> bytes:
    """TIFF's LZW: MSB-first codes of 9 to 12 bits, widened one code early."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    acc = nacc = pos = 0
    width, prev = 9, None
    while True:
        while nacc < width and pos < len(buf):
            acc, nacc, pos = (acc << 8) | buf[pos], nacc + 8, pos + 1
        if nacc < width:
            break
        nacc -= width
        code = acc >> nacc
        acc &= (1 << nacc) - 1
        if code == 257:  # end of information
            break
        if code == 256:  # clear
            del table[258:]
            width, prev = 9, None
            continue
        if code < len(table):
            entry = table[code]
            if prev is not None and len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"{what}: corrupt LZW data in a TIFF strip")
        out += entry
        prev = entry
        width = 9 if len(table) < 511 else 10 if len(table) < 1023 else 11 if len(table) < 2047 else 12
    return bytes(out)


def decode_tiff(data: bytes, what: str = "TIFF") -> Raster:
    try:
        tags, bo = _tiff_tags(data, what)
    except struct.error:
        raise ValueError(f"{what}: truncated or malformed TIFF directory") from None

    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]

    w, h = one(256), one(257)
    if w is None or h is None or w <= 0 or h <= 0:
        raise ValueError(f"{what}: TIFF without a valid image size")
    if 322 in tags or 324 in tags:
        raise ValueError(f"{what}: tiled TIFF is not supported")
    comp = one(259, 1)
    if comp in _TIFF_REFUSED:
        raise ValueError(f"{what}: {_TIFF_REFUSED[comp]}-compressed TIFF is not supported")
    if comp not in _TIFF_COMPRESSION:
        raise ValueError(f"{what}: TIFF compression {comp} is not supported")
    photometric, spp = one(262), one(277, 1)
    bps = tags.get(258, (1,) * spp)
    if one(339, 1) != 1:
        raise ValueError(f"{what}: TIFF with sample format {one(339)} (not unsigned integers) is not supported")
    if one(284, 1) != 1:
        raise ValueError(f"{what}: planar (separate-plane) TIFF is not supported")
    if one(274, 1) != 1:
        raise ValueError(f"{what}: TIFF with orientation {one(274)} is not supported")
    bits = bps[0]
    kinds = {0: "WhiteIsZero", 4: "transparency mask", 5: "CMYK", 6: "YCbCr", 8: "CIELab"}
    if photometric in kinds:
        raise ValueError(f"{what}: {kinds[photometric]} TIFF is not supported")
    color = {1: 1, 2: 3, 3: 1}.get(photometric)
    if color is None or spp < color or len(set(bps)) != 1 or bits not in ((8,) if photometric == 3 else (8, 16)):
        raise ValueError(f"{what}: TIFF of photometric {photometric} with {spp} samples of {bps} bits "
                         f"is not supported")
    offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None or len(offsets) != len(counts):
        raise ValueError(f"{what}: TIFF without strips")
    raw = bytearray()
    for off, cnt in zip(offsets, counts):
        strip = data[off:off + cnt]
        if len(strip) < cnt:
            raise ValueError(f"{what}: truncated TIFF strip")
        kind = _TIFF_COMPRESSION[comp]
        raw += (strip if kind is None else _packbits(strip, what) if kind == "PackBits"
                else _lzw(strip, what) if kind == "LZW" else zlib.decompress(strip))
    dt = np.dtype(np.uint8) if bits == 8 else np.dtype(bo + "u2")
    n = w * h * spp
    if len(raw) < n * dt.itemsize:
        raise ValueError(f"{what}: TIFF strips hold {len(raw)} bytes, expected {n * dt.itemsize}")
    s = np.frombuffer(bytes(raw), dt, n).astype(dt.newbyteorder("=")).reshape(h, w, spp)
    # libtiff applies a predictor only inside the codecs that take one (LZW,
    # Deflate); the tag is ignored on uncompressed and PackBits strips
    predictor = one(317, 1) if _TIFF_COMPRESSION[comp] in ("LZW", "Deflate") else 1
    if predictor == 2:  # horizontal differencing, per sample, modulo 2^bits
        s = np.cumsum(s, axis=1, dtype=s.dtype)
    elif predictor != 1:
        raise ValueError(f"{what}: TIFF predictor {predictor} is not supported")
    if photometric == 3:
        cmap = np.asarray(tags.get(320, ()), dtype=np.uint16)
        if cmap.size != 3 * 256:
            raise ValueError(f"{what}: palette TIFF without a colour map of 256 entries")
        cmap = cmap.reshape(3, 256).T
        # libtiff takes a map whose entries all fit 8 bits as an 8-bit map
        cmap8 = (cmap if int(cmap.max()) < 256 else cmap >> 8).astype(np.uint8)
        return _raster8(np.ascontiguousarray(cmap8[s[..., 0]]))
    s = np.ascontiguousarray(s[..., :color])
    if bits == 8:
        return _raster8(s)
    if color == 1:
        return Raster(s, (s[..., 0] >> 8).astype(np.uint8))
    return Raster(s, _gray_from_rgb8(((s.astype(np.uint32) + 128) // 257).astype(np.uint8)))
