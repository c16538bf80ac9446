"""The port's image I/O and conversions (``data/images.py``) against the JAX
package's, on the CPU.

The array helpers must be bit-equal. The port's PNG codec stands in for
cv2: PNGs written here with ``cv2.imwrite`` (its default filters, and all five
chosen adaptively row by row) must decode to exactly what
``cv2.imread`` gives; the port's ``imsave`` must decode with ``cv2.imread``
to the JAX ``imsave``'s pixels; every other PNG form (palette, sub-byte and
16-bit gray, RGB, RGBA, gray with alpha, ``tRNS``, Adam7), written here by
an encoder of the test's own, must read as cv2 reads it, and
``channel_convert`` must equal cv2's; JPEG, BMP, PPM and TIFF raise a
``ValueError`` naming the format; and ``load_testset`` / ``load_images_dir``
on a directory written here must equal the JAX package's exactly.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from pnp_admm_cnc_mri_torch.data import images
from pnp_admm_cnc_mri_tpu.data import images as jimages


def _scene(h, w, seed):
    """An 8-bit scene with smooth ramps, edges and noise, so that libpng's
    adaptive filter choice (over all five filters) meets every type."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    smooth = 127 + 100 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    edges = np.where((xx - w / 2) ** 2 + (yy - h / 3) ** 2 < (h / 4) ** 2, 60.0, 0.0)
    noisy = rng.integers(0, 40, (h, w)) * (yy > h // 2)
    return np.uint8(np.clip(smooth + edges + noisy, 0, 255))


def _row_filters(data: bytes):
    """The filter type of each row of an 8-bit grayscale PNG."""
    chunks = list(images._png_chunks(data, "test"))
    w, h = struct.unpack(">II", chunks[0][1][:8])
    raw = zlib.decompress(b"".join(b for t, b in chunks if t == b"IDAT"))
    return {raw[r * (w + 1)] for r in range(h)}


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def test_cv2_pngs_decode_as_cv2_reads_them(tmp_path):
    seen = set()
    shapes = [(64, 64), (37, 53), (1, 9), (9, 1)]
    flags = [[], [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS], [cv2.IMWRITE_PNG_COMPRESSION, 9]]
    for seed, ((h, w), flag) in enumerate((s, f) for s in shapes for f in flags):
        img = _scene(h, w, seed)
        path = str(tmp_path / f"s{seed}.png")
        assert cv2.imwrite(path, img, flag)
        with open(path, "rb") as f:
            seen |= _row_filters(f.read())
        got = images.imread_gray(path)
        assert got.dtype == np.uint8 and np.array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        assert np.array_equal(got, img)
    assert seen == {0, 1, 2, 3, 4}, seen


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_each_filter_type_alone(tmp_path, ftype):
    """One PNG per filter type, every row filtered with it (written here by
    the spec), decodes as cv2 decodes it."""
    img = _scene(16, 23, ftype).astype(np.int64)
    h, w = img.shape
    rows = []
    for r in range(h):
        up = img[r - 1] if r else np.zeros(w, np.int64)
        out = []
        for x in range(w):
            a = img[r, x - 1] if x else 0
            b, c = up[x], (up[x - 1] if x else 0)
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((img[r, x] - pred) % 256)
        rows.append(bytes([ftype] + out))
    path = tmp_path / f"f{ftype}.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                     + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))
    assert np.array_equal(images.imread_gray(str(path)), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    assert np.array_equal(images.imread_gray(str(path)), img.astype(np.uint8))


def test_imsave_decodes_with_cv2_to_the_jax_pixels(tmp_path):
    rng = np.random.default_rng(3)
    img255 = rng.uniform(-20.0, 275.0, (24, 40))
    img255[0, :4] = [0.5, 1.5, 2.5, 254.5]  # ties of the rounding
    images.imsave(img255, str(tmp_path / "port" / "a.png"))
    jimages.imsave(img255, str(tmp_path / "jax" / "a.png"))
    port = cv2.imread(str(tmp_path / "port" / "a.png"), cv2.IMREAD_UNCHANGED)
    jax_ = cv2.imread(str(tmp_path / "jax" / "a.png"), cv2.IMREAD_UNCHANGED)
    assert port.dtype == np.uint8 and port.ndim == 2 and np.array_equal(port, jax_)
    assert np.array_equal(images.imread_gray(str(tmp_path / "port" / "a.png")), jax_)
    images.imsave(img255[..., None], str(tmp_path / "c.png"))
    assert np.array_equal(images.imread_gray(str(tmp_path / "c.png")), jax_)
    for bad, what in ((np.zeros((4, 4, 3)), "grayscale images only"), (img255, "PNG only")):
        with pytest.raises(ValueError, match=what):
            images.imsave(bad, str(tmp_path / ("d.png" if what != "PNG only" else "d.jpg")))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filtered(rows: np.ndarray, bpp: int, ftype: int) -> bytes:
    """PNG rows of bytes with the filter ``ftype`` applied to each."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])[:len(r)]
        if ftype == 4:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = [0 * r, left, prev, (left + prev) // 2][ftype]
        out.append(bytes([ftype]) + ((r - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = r
    return b"".join(out)


def _encode(samples, color, depth, interlace=False, plte=None, trns=None, ftype=4) -> bytes:
    """Any PNG form, written independently of the port's codec: ``samples``
    (H, W, C) (palette indices for colour type 3), MSB-first sub-byte
    packing, big-endian 16-bit samples, one filter for every row, Adam7
    passes when ``interlace``, the data split over two IDAT chunks."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)

    def rows(sub):
        sh, sw = sub.shape[:2]
        if not sh or not sw:
            return b""
        flat = sub.reshape(sh, sw * ch)
        if depth == 16:
            packed = flat.astype(">u2").view(np.uint8).reshape(sh, -1)
        else:
            per = 8 // depth
            pad = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per))).astype(np.uint8).reshape(sh, -1, per)
            packed = sum((pad[:, :, k].astype(np.int64) << (8 - depth * (k + 1))) for k in range(per))
        return _filtered(np.asarray(packed), bpp, ftype)

    data = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)))
    z = zlib.compress(data)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes()) if plte is not None else b""
    out += _chunk(b"tRNS", trns) if trns is not None else b""
    return out + _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b"")


# (colour type, bit depth, tRNS): every form cv2 reads
FORMS = {
    "palette": (3, 8, False), "palette 1-bit": (3, 1, False), "palette 2-bit": (3, 2, False),
    "palette 4-bit": (3, 4, False), "palette with tRNS": (3, 8, True), "palette 4-bit with tRNS": (3, 4, True),
    "grayscale 1-bit": (0, 1, False), "grayscale 2-bit": (0, 2, False), "grayscale 4-bit": (0, 4, False),
    "grayscale 16-bit": (0, 16, False), "grayscale with tRNS": (0, 8, True), "grayscale 16-bit with tRNS": (0, 16, True),
    "RGB": (2, 8, False), "RGB 16-bit": (2, 16, False), "RGB with tRNS": (2, 8, True), "RGBA": (6, 8, False),
    "RGBA 16-bit": (6, 16, False), "grayscale with alpha": (4, 8, False), "grayscale with alpha 16-bit": (4, 16, False),
}


def _form_png(form, h, w, interlace, ftype, rng):
    color, depth, with_trns = FORMS[form]
    ch = _CHANNELS[color]
    samples = rng.integers(0, 2 ** depth, (h, w, ch))
    plte = rng.integers(0, 256, (2 ** depth, 3)) if color == 3 else None
    trns = None
    if with_trns:
        trns = (bytes(rng.integers(0, 256, 2 ** depth).astype(np.uint8)) if color == 3
                else struct.pack(">" + "H" * ch, *(int(v) for v in samples[0, 0])))
    return _encode(samples, color, depth, interlace, plte, trns, ftype)


@pytest.mark.parametrize("form", list(FORMS))
def test_png_forms_decode_as_cv2(tmp_path, form):
    """Each form, plain and interlaced, with each of the five row filters,
    at 13 x 11, 3 x 5 (Adam7 passes left empty), 1 x 1 and 9 x 17: the port's
    ``imread_gray`` equals ``cv2.imread(path, IMREAD_GRAYSCALE)`` and its
    ``imread_uint`` the JAX package's (cv2's ``IMREAD_UNCHANGED`` and
    ``cvtColor``), dtype and shape included."""
    rng = np.random.default_rng(len(form))
    path = str(tmp_path / "f.png")
    for (h, w), interlace, ftype in ((s, i, f) for s in ((13, 11), (3, 5), (1, 1), (9, 17))
                                     for i in (False, True) for f in range(5)):
        with open(path, "wb") as f:
            f.write(_form_png(form, h, w, interlace, ftype, rng))
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        got = images.imread_gray(path)
        assert want is not None and got.dtype == np.uint8 and np.array_equal(got, want), (h, w, interlace, ftype)
        for n in (1, 3):
            a, b = images.imread_uint(path, n), jimages.imread_uint(path, n)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), (h, w, interlace, ftype, n)


def test_cv2_written_forms_decode_as_cv2(tmp_path):
    """The forms ``cv2.imwrite`` writes itself: RGB, RGBA, 16-bit gray and
    RGB, and 1-bit (``IMWRITE_PNG_BILEVEL``)."""
    rng = np.random.default_rng(3)
    cases = [(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8), []),
             (rng.integers(0, 256, (20, 30, 4), dtype=np.uint8), []),
             (rng.integers(0, 65536, (20, 30), dtype=np.uint16), []),
             (rng.integers(0, 65536, (20, 30, 3), dtype=np.uint16), []),
             (_scene(20, 30, 4), [cv2.IMWRITE_PNG_BILEVEL, 1])]
    for k, (img, flags) in enumerate(cases):
        path = str(tmp_path / f"w{k}.png")
        assert cv2.imwrite(path, img, flags)
        assert np.array_equal(images.imread_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE)), k
        for n in (1, 3):
            a, b = images.imread_uint(path, n), jimages.imread_uint(path, n)
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, n)


def test_channel_convert_as_cv2():
    rng = np.random.default_rng(5)
    for dtype, hi in ((np.uint8, 256), (np.uint16, 65536)):
        bgr = [rng.integers(0, hi, (40, 50, 3)).astype(dtype) for _ in range(2)]
        gray = [rng.integers(0, hi, (6, 7)).astype(dtype), rng.integers(0, hi, (6, 7, 1)).astype(dtype)]
        for args in ((3, "gray", bgr), (3, "y", bgr), (1, "RGB", gray), (1, "gray", gray)):
            for a, b in zip(images.channel_convert(*args), jimages.channel_convert(*args)):
                assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), args[:2]
    # float32: cv2 orders its multiply-adds otherwise, within an ulp of [0, 1] values
    bgr = [rng.random((40, 50, 3)).astype(np.float32)]
    a, b = images.channel_convert(3, "gray", bgr)[0], jimages.channel_convert(3, "gray", bgr)[0]
    assert a.dtype == b.dtype and a.shape == b.shape and float(np.abs(a - b).max()) <= 1.2e-7


# the ids are the names these cases had when the reader took PNG only; the
# kinds are those the readers still refuse
@pytest.mark.parametrize("form,write", [
    pytest.param("not an image file", lambda p: open(p, "wb").write(b"GIF89a" + bytes(60)),
                 id="not a PNG file-<lambda>"),
    pytest.param("arithmetic-coded JPEG", lambda p: open(p, "wb").write(cv2.imencode(
        ".jpg", np.zeros((8, 8), np.uint8))[1].tobytes().replace(b"\xff\xc0", b"\xff\xc9", 1)),
        id="JPEG-<lambda>"),
    pytest.param("BMP", lambda p: open(p, "wb").write(b"BM" + bytes(60)), id="BMP-<lambda>"),
    pytest.param("TIFF", lambda p: open(p, "wb").write(b"II*\x00" + bytes(4)), id="TIFF-<lambda>"),
    pytest.param("PBM", lambda p: open(p, "wb").write(cv2.imencode(".pbm", np.zeros((8, 8), np.uint8))[1].tobytes()),
                 id="PPM-<lambda>"),
])
def test_unsupported_forms_raise(tmp_path, form, write):
    path = str(tmp_path / "u.png")
    write(path)
    with pytest.raises(ValueError, match=form):
        images.imread_gray(path)
    with pytest.raises(ValueError, match=form):
        images.imread_uint(path)


def test_corrupt_and_missing_files_raise(tmp_path):
    good = images.encode_png_gray8(np.zeros((4, 4), np.uint8))
    (tmp_path / "crc.png").write_bytes(good[:-5] + bytes([good[-5] ^ 1]) + good[-4:])
    (tmp_path / "cut.png").write_bytes(good[:40])
    with pytest.raises(ValueError, match="CRC"):
        images.imread_gray(str(tmp_path / "crc.png"))
    with pytest.raises(ValueError, match="truncated"):
        images.imread_gray(str(tmp_path / "cut.png"))
    with pytest.raises(FileNotFoundError):
        images.imread_gray(str(tmp_path / "none.png"))


def test_imread_uint_as_cv2(tmp_path):
    path = str(tmp_path / "g.png")
    cv2.imwrite(path, _scene(16, 24, 1))
    for n in (1, 3):
        assert np.array_equal(images.imread_uint(path, n), jimages.imread_uint(path, n))


def test_loaders_equal_the_jax_packages(tmp_path):
    for i, (h, w) in enumerate([(70, 67), (64, 64), (66, 71)]):
        cv2.imwrite(str(tmp_path / f"{i:02d}.png"), _scene(h, w, 10 + i))
    (tmp_path / "notes.txt").write_text("not an image")
    for scale in (8, 1):
        got = images.load_images_dir(str(tmp_path), scale=scale)
        want = jimages.load_images_dir(str(tmp_path), scale=scale)
        assert got[1] == want[1] == ["00", "01", "02"]
        for a, b in zip(got[0], want[0]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    same = tmp_path / "same"
    same.mkdir()
    for i in range(3):
        cv2.imwrite(str(same / f"{i:02d}.png"), _scene(64, 64, 20 + i))
    for use_clip in (True, False):
        got = images.load_testset(str(same), use_clip=use_clip)
        want = jimages.load_testset(str(same), use_clip=use_clip)
        assert got[2] == want[2]
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="no images"):
        images.load_testset(str(tmp_path / "empty"))


def test_array_helpers_bit_equal():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)
    f = rng.uniform(-0.1, 1.1, (13, 21, 3))
    for name in ("IMG_EXTENSIONS",):
        assert getattr(images, name) == getattr(jimages, name)
    assert images.get_image_paths is not None
    cases = [
        ("modcrop", (u8, 8)), ("modcrop", (u8, 3)), ("uint2single", (u8,)), ("single2uint", (f,)),
        ("uint162single", (rng.integers(0, 65536, (5, 6), dtype=np.uint16),)), ("single2uint16", (f,)),
        ("shave", (u8, 2)), ("shave", (u8, 0)),
        ("rgb2ycbcr", (u8,)), ("rgb2ycbcr", (f.astype(np.float32),)), ("rgb2ycbcr", (u8, False)),
        ("bgr2ycbcr", (u8,)), ("bgr2ycbcr", (f, False)), ("ycbcr2rgb", (u8,)), ("ycbcr2rgb", (f,)),
    ] + [("augment_img", (u8, m)) for m in range(8)]
    for name, args in cases:
        a, b = getattr(images, name)(*args), getattr(jimages, name)(*args)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    with pytest.raises(ValueError, match="0..7"):
        images.augment_img(u8, 8)
    for fn in ("a.png", "b.PNG", "c.tif", "d.TIF", "e.jpeg", "f.txt"):
        assert images.is_image_file(fn) == jimages.is_image_file(fn)


def test_image_paths_sorted_over_extensions(tmp_path):
    for fn in ("b.png", "a.PNG", "c.bmp", "d.txt"):
        (tmp_path / fn).write_bytes(b"")
    assert images.get_image_paths(str(tmp_path)) == jimages.get_image_paths(str(tmp_path))
    assert os.path.basename(images.get_image_paths(str(tmp_path))[0]) == "a.PNG"
