"""The port's image I/O and conversions (``data/images.py``) against the JAX
package's, on the CPU.

The array helpers must be bit-equal. The port's PNG codec stands in for
cv2: PNGs written here with ``cv2.imwrite`` (its default filters, and all five
chosen adaptively row by row) must decode to exactly what
``cv2.imread`` gives; the port's ``imsave`` must decode with ``cv2.imread``
to the JAX ``imsave``'s pixels; the forms the reader does not take raise
a ``ValueError`` naming them; and ``load_testset`` / ``load_images_dir``
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


@pytest.mark.parametrize("form,write", [
    ("RGB PNG", lambda p: cv2.imwrite(p, np.zeros((8, 8, 3), np.uint8))),
    ("RGBA PNG", lambda p: cv2.imwrite(p, np.zeros((8, 8, 4), np.uint8))),
    ("16-bit grayscale PNG", lambda p: cv2.imwrite(p, np.zeros((8, 8), np.uint16))),
    ("1-bit grayscale PNG", lambda p: cv2.imwrite(p, np.zeros((8, 8), np.uint8), [cv2.IMWRITE_PNG_BILEVEL, 1])),
    ("palette PNG", "palette"),
    ("interlaced", "interlaced"),
    ("grayscale with alpha PNG", "gray_alpha"),
    ("not a PNG file", lambda p: open(p, "wb").write(b"BM" + bytes(60))),
])
def test_unsupported_forms_raise(tmp_path, form, write):
    path = str(tmp_path / "u.png")
    if callable(write):
        write(path)
    else:
        color, interlace = {"palette": (3, 0), "interlaced": (0, 1), "gray_alpha": (4, 0)}[write]
        png = bytearray(images.encode_png_gray8(np.zeros((4, 4), np.uint8)))
        ihdr = struct.pack(">IIBBBBB", 4, 4, 8, color, 0, 0, interlace)
        png[16:29] = ihdr
        png[29:33] = struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
        open(path, "wb").write(bytes(png))
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
