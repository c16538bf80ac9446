"""The port's BMP, PPM/PGM, TIFF and JPEG readers against cv2 through the JAX package.

Files are encoded by cv2 in ``tmp_path`` in every form cv2 writes (and, for
the forms cv2 does not write, by small writers here), and each must decode
bit-equal to the JAX package's ``imread_gray`` (``cv2.imread(path,
IMREAD_GRAYSCALE)``) and ``imread_uint(path, 3)`` (``IMREAD_UNCHANGED`` and
``cvtColor`` to RGB). The readers go by a file's first bytes, so a testset
laid out as the reference's (``.png`` names over BMP and JPEG payloads)
loads as the JAX package loads it. The kinds the readers refuse raise a
``ValueError`` that names them. The committed fixtures
(``tests/torch_image_fixtures``, written by ``probes/make_image_fixtures.py``)
decode to the cv2 pixels stored beside them.
"""

import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from pnp_admm_cnc_mri_tpu.data import images as jimages
from pnp_admm_cnc_mri_torch.data import images

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_image_fixtures")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def scene(seed, h, w, c, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0) * np.cos(yy / 5.0) + 1) / 2
    top = 255 if dtype == np.uint8 else 65535
    a = (np.stack([(base * (k + 1) / c + 0.15 * rng.random((h, w))) % 1 for k in range(c)], -1) * top).astype(dtype)
    return a[..., 0] if c == 1 else a


def assert_reads_as_cv2(path):
    gray = images.imread_gray(path)
    want = jimages.imread_gray(path)
    assert gray.dtype == want.dtype and gray.shape == want.shape
    np.testing.assert_array_equal(gray, want)
    rgb, want = images.imread_uint(path, 3), jimages.imread_uint(path, 3)
    assert rgb.dtype == want.dtype and rgb.shape == want.shape
    np.testing.assert_array_equal(rgb, want)
    np.testing.assert_array_equal(images.imread_uint(path, 1), jimages.imread_uint(path, 1))


def write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def cv2_file(tmp_path, name, img, params=()):
    ok, buf = cv2.imencode(os.path.splitext(name)[1], img, list(params))
    assert ok
    return write(tmp_path, name, buf.tobytes())


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------


def bmp(pixels, bpp, palette=None, top_down=False, compression=0, masks=None):
    """A BMP of palette indices (bpp 1, 4, 8, palette RGB) or of RGB pixels (24, 32)."""
    h, w = pixels.shape[:2]
    stride = (w * bpp + 31) // 32 * 4
    if bpp <= 8:
        bits = np.unpackbits(pixels.astype(np.uint8)[..., None], axis=-1)[..., 8 - bpp:].reshape(h, -1)
        rows = np.packbits(bits, axis=1)
    else:
        bgr = pixels[..., ::-1]
        if bpp == 32:
            bgr = np.concatenate([bgr, np.full((h, w, 1), 77, np.uint8)], axis=-1)
        rows = bgr.reshape(h, -1)
    px = np.zeros((h, stride), np.uint8)
    px[:, : rows.shape[1]] = rows
    pal = b""
    if palette is not None:
        p4 = np.zeros((len(palette), 4), np.uint8)
        p4[:, :3] = palette[:, ::-1]
        pal = p4.tobytes()
    extra = struct.pack("<III", *masks) if masks else b""
    off = 14 + 40 + len(extra) + len(pal)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, compression, px.size, 2835, 2835,
                       0 if palette is None else len(palette), 0)
    body = px if top_down else px[::-1]
    return struct.pack("<2sIHHI", b"BM", off + px.size, 0, 0, off) + info + extra + pal + body.tobytes()


@pytest.mark.parametrize("c", [1, 3])
def test_bmp_written_by_cv2(tmp_path, c):
    assert_reads_as_cv2(cv2_file(tmp_path, "a.bmp", scene(c, 45, 37, c)))


@pytest.mark.parametrize("bpp", [1, 4, 8])
@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
def test_bmp_palette_forms(tmp_path, bpp, top_down):
    rng = np.random.default_rng(bpp)
    palette = rng.integers(0, 256, (1 << bpp, 3)).astype(np.uint8)
    idx = rng.integers(0, 1 << bpp, (23, 31))
    assert_reads_as_cv2(write(tmp_path, "p.bmp", bmp(idx, bpp, palette, top_down)))


def test_bmp_gray_palette(tmp_path):
    gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    idx = np.random.default_rng(9).integers(0, 256, (19, 22))
    assert_reads_as_cv2(write(tmp_path, "g.bmp", bmp(idx, 8, gray)))


@pytest.mark.parametrize("bpp,masks", [(24, None), (32, None), (32, (0xFF0000, 0xFF00, 0xFF))],
                         ids=["24", "32", "32_bitfields"])
@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
def test_bmp_true_colour_forms(tmp_path, bpp, masks, top_down):
    img = scene(bpp, 21, 26, 3)
    data = bmp(img, bpp, top_down=top_down, compression=3 if masks else 0, masks=masks)
    assert_reads_as_cv2(write(tmp_path, "t.bmp", data))


# ---------------------------------------------------------------------------
# PPM / PGM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("binary", [1, 0], ids=["binary", "ascii"])
@pytest.mark.parametrize("c,dtype", [(1, np.uint8), (3, np.uint8), (1, np.uint16), (3, np.uint16)],
                         ids=["gray8", "rgb8", "gray16", "rgb16"])
def test_pnm_written_by_cv2(tmp_path, binary, c, dtype):
    name = "a.pgm" if c == 1 else "a.ppm"
    assert_reads_as_cv2(cv2_file(tmp_path, name, scene(c, 19, 23, c, dtype), [cv2.IMWRITE_PXM_BINARY, binary]))


@pytest.mark.parametrize("magic,maxval", [(b"P5", 100), (b"P2", 100), (b"P6", 200), (b"P3", 60), (b"P2", 1000),
                                          (b"P5", 1000)])
def test_pnm_maxval_comments_and_clipping(tmp_path, magic, maxval):
    rng = np.random.default_rng(maxval)
    ch = 3 if magic in (b"P3", b"P6") else 1
    v = rng.integers(0, maxval + 1, (7, 9, ch))
    if magic in (b"P2", b"P3"):
        v[0, 0, 0] = maxval + 17  # ASCII samples above maxval are clipped
        body = " ".join(map(str, v.ravel())).encode() + b"\n"
    else:
        body = v.astype(np.uint8 if maxval < 256 else ">u2").tobytes()
    data = magic + b" # a comment\n9\t7\n# another\n" + str(maxval).encode() + b"\n" + body
    assert_reads_as_cv2(write(tmp_path, "m.pnm", data))


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773], ids=["none", "lzw", "deflate", "adobe_deflate",
                                                                        "packbits"])
@pytest.mark.parametrize("c,dtype", [(1, np.uint8), (3, np.uint8), (4, np.uint8), (1, np.uint16), (3, np.uint16)],
                         ids=["gray8", "rgb8", "rgba8", "gray16", "rgb16"])
def test_tiff_written_by_cv2(tmp_path, compression, c, dtype):
    img = scene(c, 37, 53, c, dtype)
    assert_reads_as_cv2(cv2_file(tmp_path, "a.tif", img, [cv2.IMWRITE_TIFF_COMPRESSION, compression]))


def tiff(samples, bits, photometric, colormap=None, predictor=1, tiled=False, compression=1, big_endian=False):
    """A one-strip TIFF of (H, W, C) samples (little- or big-endian),
    uncompressed or (compression 8) Deflate."""
    bo = ">" if big_endian else "<"
    h, w, c = samples.shape
    px = samples.astype(bo + ("u1" if bits == 8 else "u2"))
    if predictor == 2:
        px = px.copy()
        px[:, 1:] = (samples[:, 1:].astype(np.int64) - samples[:, :-1].astype(np.int64)) % (1 << bits)
    data = zlib.compress(px.tobytes()) if compression == 8 else px.tobytes()
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c), (259, 3, [compression]), (262, 3, [photometric]),
               (273, 4, [0]), (277, 3, [c]), (278, 4, [h]), (279, 4, [len(data)]), (317, 3, [predictor])]
    if colormap is not None:
        entries.append((320, 3, list(colormap.T.ravel())))
    if tiled:
        entries += [(322, 3, [16]), (323, 3, [16])]
    entries.sort()
    n = len(entries)
    ifd_size = 2 + 12 * n + 4
    extra_at = 8 + ifd_size
    extra, ifd = b"", struct.pack(bo + "H", n)
    fmt = {3: "H", 4: "I"}
    strip_at = extra_at + sum(len(v) * struct.calcsize(fmt[t]) for _, t, v in entries
                              if len(v) * struct.calcsize(fmt[t]) > 4)
    for tag, typ, vals in entries:
        if tag == 273:
            vals = [strip_at]
        raw = struct.pack(bo + fmt[typ] * len(vals), *vals)
        if len(raw) <= 4:
            ifd += struct.pack(bo + "HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(bo + "HHII", tag, typ, len(vals), extra_at + len(extra))
            extra += raw
    head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(bo + "I", 8)
    return head + ifd + b"\0\0\0\0" + extra + data


@pytest.mark.parametrize("big_endian", [False, True], ids=["II", "MM"])
def test_tiff_palette_predictor_and_byte_order(tmp_path, big_endian):
    rng = np.random.default_rng(5)
    cmap16 = rng.integers(0, 65536, (256, 3)).astype(np.uint16)
    idx = rng.integers(0, 256, (13, 17, 1))
    assert_reads_as_cv2(write(tmp_path, "pal16.tif", tiff(idx, 8, 3, cmap16, big_endian=big_endian)))
    cmap8 = rng.integers(0, 256, (256, 3)).astype(np.uint16)  # libtiff's 8-bit colour map guess
    assert_reads_as_cv2(write(tmp_path, "pal8.tif", tiff(idx, 8, 3, cmap8, big_endian=big_endian)))
    for c, bits, phot in ((1, 8, 1), (3, 8, 2), (1, 16, 1), (3, 16, 2)):
        s = scene(c + bits, 11, 14, c, np.uint8 if bits == 8 else np.uint16).reshape(11, 14, c)
        for pred in (1, 2):  # libtiff ignores the predictor of an uncompressed strip
            for comp in (1, 8):
                assert_reads_as_cv2(write(tmp_path, f"p{c}_{bits}_{pred}_{comp}.tif",
                                          tiff(s, bits, phot, predictor=pred, compression=comp,
                                               big_endian=big_endian)))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(37, 53), (64, 64), (17, 9)])
@pytest.mark.parametrize("form", ["gray", "444", "422", "420", "440"])
@pytest.mark.parametrize("quality,restart", [(50, 0), (95, 3), (90, 1)])
def test_jpeg_written_by_cv2(tmp_path, hw, form, quality, restart):
    c = 1 if form == "gray" else 3
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if c == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[form]]
    assert_reads_as_cv2(cv2_file(tmp_path, "a.jpg", scene(quality + restart, *hw, c), params))


def test_jpeg_with_optimized_huffman_tables(tmp_path):
    params = [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]]
    assert_reads_as_cv2(cv2_file(tmp_path, "o.jpg", scene(3, 40, 48, 3), params))


def test_jpeg_one_scan_a_component(tmp_path):
    """A sequential file of three scans, one a component (cv2 writes only
    interleaved scans): assembled here from the tables and scans of three
    gray encodings, each component under its own quantization table."""
    y, cb, cr = (scene(s, 24, 32, 1) for s in (1, 2, 3))
    parts = [cv2.imencode(".jpg", p, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes() for p in (y, cb, cr)]

    def segments(data):
        pos, out = 2, []
        while True:
            marker = data[pos + 1]
            if marker == 0xDA:
                end = data.rfind(b"\xff\xd9")
                out.append((marker, data[pos:end]))
                return out
            length = struct.unpack_from(">H", data, pos + 2)[0]
            out.append((marker, data[pos:pos + 2 + length]))
            pos += 2 + length

    segs = [{m: b"".join(s for mm, s in segments(p) if mm == m) for m in (0xDB, 0xC4, 0xC0, 0xDA)} for p in parts]
    sof = bytearray(segs[0][0xC0])
    sof[2:4] = struct.pack(">H", 8 + 3 * 3)
    sof[9] = 3
    sof = bytes(sof[:10]) + b"".join(bytes([k + 1, 0x11, k]) for k in range(3))
    out = b"\xff\xd8" + segs[0][0xDB] + sof
    for k in range(3):
        q = bytearray(segs[k][0xDB])
        q[4] = k  # each scan's table under its own number
        h = bytearray(segs[k][0xC4])
        scan = bytearray(segs[k][0xDA])
        scan[5] = k + 1
        out += bytes(q) + bytes(h) + bytes(scan)
    out += b"\xff\xd9"
    path = write(tmp_path, "s.jpg", out)
    assert_reads_as_cv2(path)


@pytest.mark.parametrize("c", [1, 3])
def test_progressive_jpeg(tmp_path, c):
    path = cv2_file(tmp_path, "p.jpg", scene(7, 37, 53, c), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert_reads_as_cv2(path)


def test_jpeg_sampled_4x1(tmp_path):
    path = cv2_file(tmp_path, "f.jpg", scene(8, 37, 53, 3), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    assert_reads_as_cv2(path)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("c", [1, 3])
def test_jpeg_exif_orientation(tmp_path, orientation, c):
    """cv2 applies the EXIF orientation to a gray read and ignores it in an
    ``IMREAD_UNCHANGED`` read; the reader does the same."""
    path = write(tmp_path, "o.png", _exif_jpeg(orientation, scene(9, 21, 34, c)))
    assert_reads_as_cv2(path)
    assert images.imread_gray(path).shape == ((34, 21) if orientation >= 5 else (21, 34))


# ---------------------------------------------------------------------------
# Refused kinds, testsets, fixtures
# ---------------------------------------------------------------------------


def _patched_jpeg(marker_from, marker_to=None, precision=None):
    data = bytearray(cv2.imencode(".jpg", scene(0, 16, 16, 1))[1].tobytes())
    at = data.find(bytes([0xFF, marker_from]))
    if marker_to is not None:
        data[at + 1] = marker_to
    if precision is not None:
        data[at + 4] = precision
    return bytes(data)


def _pil_bytes(im, fmt):
    buf = io.BytesIO()
    im.save(buf, fmt)
    return buf.getvalue()


def _exif_jpeg(orientation, img):
    data = cv2.imencode(".jpg", img)[1].tobytes()
    tiff_ = b"II*\x00" + struct.pack("<IH", 8, 1) + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + b"\0" * 4
    app1 = b"Exif\x00\x00" + tiff_
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


REFUSED = {
    "arithmetic-coded": lambda: _patched_jpeg(0xC0, 0xC9),
    "lossless": lambda: _patched_jpeg(0xC0, 0xC3),
    "12-bit": lambda: _patched_jpeg(0xC0, precision=12),
    "CMYK JPEG": lambda: _pil_bytes(Image.new("CMYK", (8, 8), (10, 20, 30, 40)), "JPEG"),
    "tiled TIFF": lambda: tiff(np.zeros((16, 16, 1), np.uint8), 8, 1, tiled=True),
    "JPEG-compressed TIFF": lambda: tiff(np.zeros((4, 4, 1), np.uint8), 8, 1, compression=7),
    "RLE-compressed BMP": lambda: bmp(np.zeros((4, 4), np.uint8), 8, np.zeros((256, 3), np.uint8), compression=1),
    "16-bit BMP": lambda: bmp(np.zeros((4, 4, 3), np.uint8), 24)[:28] + b"\x10\x00"
                          + bmp(np.zeros((4, 4, 3), np.uint8), 24)[30:],
    "PBM": lambda: cv2.imencode(".pbm", np.zeros((8, 8), np.uint8))[1].tobytes(),
    "not an image file": lambda: b"GIF89a" + bytes(40),
}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refused_kinds_raise_naming_them(tmp_path, kind):
    path = write(tmp_path, "r.png", REFUSED[kind]())
    with pytest.raises(ValueError, match=kind):
        images.imread_gray(path)
    with pytest.raises(ValueError, match=kind):
        images.imread_uint(path, 3)


def test_testset_of_png_named_bmp_and_jpeg_payloads_loads_as_jax(tmp_path):
    """The reference's testsets mix PNG, BMP and JPEG payloads under .png names."""
    for k in range(6):
        img = scene(k, 64, 64, 1 if k % 2 else 3)
        ext, params = ((".bmp", []), (".jpg", [cv2.IMWRITE_JPEG_QUALITY, 90]), (".png", []))[k % 3]
        cv2_file(tmp_path, f"{k:02d}.png", img, params) if ext == ".png" else write(
            tmp_path, f"{k:02d}.png", cv2.imencode(ext, img, params)[1].tobytes())
    for use_clip in (True, False):
        got, want = images.load_testset(str(tmp_path), use_clip=use_clip), jimages.load_testset(str(tmp_path),
                                                                                              use_clip=use_clip)
        assert got[2] == want[2] == [f"{k:02d}" for k in range(6)]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_fixtures_decode_to_their_stored_cv2_pixels():
    with np.load(os.path.join(FIXTURES, "pixels.npz")) as z:
        stored = {k: z[k] for k in z.files}
    names = sorted({k.split("/")[0] for k in stored})
    assert len(names) >= 20 and all(os.path.getsize(os.path.join(FIXTURES, n)) < 64 * 1024 for n in names)
    for name in names:
        path = os.path.join(FIXTURES, name)
        np.testing.assert_array_equal(images.imread_gray(path), stored[f"{name}/gray"], err_msg=name)
        if f"{name}/rgb" in stored:
            np.testing.assert_array_equal(images.imread_uint(path, 3), stored[f"{name}/rgb"], err_msg=name)
