"""The port's Fourier model (``pnp_admm_cnc_mri_torch.ops.fourier``) against
the JAX package's ``ops/fourier.py`` on the same numpy inputs, on the CPU.

Tolerances: image-domain results agree to 1e-10 in float64 and 1e-4 in
float32. K-space results scale with the number of pixels, so they are held
to the same bounds relative to their largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_admm_cnc_mri_tpu.ops import fourier as jf
from pnp_admm_cnc_mri_torch.ops import fourier

ATOL = {np.float64: 1e-10, np.float32: 1e-4}
CPLX = {np.float64: np.complex128, np.float32: np.complex64}
DTYPES = [np.float64, np.float32]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scenario(dtype, b=2, h=32, w=48, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w)).astype(dtype)
    mask = (rng.random((h, w)) < 0.3).astype(dtype)
    mask[0, 0] = 1.0
    noise = (0.5 * (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))).astype(CPLX[dtype])
    y = (np.fft.fft2(img) * mask + noise).astype(CPLX[dtype])
    return img, mask, noise, y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, dtype, kspace=False):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    scale = max(1.0, float(np.abs(ref).max())) if kspace else 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype] * scale)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fft2_ifft2_observe_match_jax(dtype):
    img, mask, noise, y = _scenario(dtype)
    _close(fourier.fft2(_t(img)).numpy(), jf.fft2(jnp.asarray(img)), dtype, kspace=True)
    _close(fourier.ifft2(_t(y)).numpy(), jf.ifft2(jnp.asarray(y)), dtype)
    _close(fourier.observe(_t(img), _t(mask), _t(noise)).numpy(),
           jf.observe(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(noise)), dtype, kspace=True)


@pytest.mark.parametrize("dtype", DTYPES)
def test_zero_fill_matches_jax(dtype):
    *_, y = _scenario(dtype)
    _close(fourier.zero_fill(_t(y)).numpy(), jf.zero_fill(jnp.asarray(y)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_data_consistency_matches_jax(dtype):
    img, mask, _, y = _scenario(dtype, seed=1)
    v = np.random.default_rng(5).random(img.shape).astype(dtype)
    got = fourier.data_consistency(_t(v), _t(y), _t(mask), 0.015).numpy()
    ref = jf.data_consistency(jnp.asarray(v), jnp.asarray(y), jnp.asarray(mask), 0.015)
    _close(got, ref, dtype)


@pytest.mark.parametrize("method", ["fft", "matmul"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rfft_data_consistency_matches_jax(dtype, method):
    img, mask, _, y = _scenario(dtype, seed=2)
    v = np.random.default_rng(6).random(img.shape).astype(dtype)
    got = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.05, method=method)(_t(v)).numpy()
    ref = jf.make_rfft_data_consistency(jnp.asarray(y), jnp.asarray(mask), 0.05, method=method)(
        jnp.asarray(v))
    _close(got, ref, dtype)


@pytest.mark.parametrize("method", ["fft", "matmul"])
def test_rfft_data_consistency_equals_full_spectrum_solve(method):
    img, mask, _, y = _scenario(np.float64, b=3, h=16, w=17, seed=3)
    v = _t(np.random.default_rng(7).random(img.shape))
    half = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.015, method=method)(v)
    full = fourier.data_consistency(v, _t(y), _t(mask), 0.015)
    np.testing.assert_allclose(half.numpy(), full.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n", [8, 17, 256])
def test_dft_mats_match_jax(n):
    for dtype in DTYPES:
        got = fourier._dft_mats(n, torch.float64 if dtype is np.float64 else torch.float32)
        ref = jf._dft_mats(n, jnp.float64 if dtype is np.float64 else jnp.float32)
        for a, b in zip(got, ref):
            _close(a.numpy(), b, dtype)


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 12, 20), (3, 9, 7)])
def test_matmul_transforms_match_torch_fft(shape):
    x = _t(np.random.default_rng(8).random(shape))
    yr, yi = fourier.matmul_rfft2(x)
    ref = torch.fft.rfft2(x)
    np.testing.assert_allclose(yr.numpy(), ref.real.numpy(), atol=1e-10)
    np.testing.assert_allclose(yi.numpy(), ref.imag.numpy(), atol=1e-10)
    back = fourier.matmul_irfft2(ref.real.contiguous(), ref.imag.contiguous(), *shape[-2:])
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-10)


def test_auto_means_fft_and_unknown_methods_raise():
    img, mask, _, y = _scenario(np.float32, seed=4)
    v = _t(img)
    auto = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.05, method="auto")(v)
    fft = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.05, method="fft")(v)
    assert torch.equal(auto, fft)
    with pytest.raises(ValueError, match="dc_method"):
        fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.05, method="fast")


def test_tf32_is_off_for_the_dft_products(monkeypatch):
    """The matmul DC's DFT products run at full float32 precision even when
    the caller allows TF32, in both forms (packed at even W, unpacked at odd
    W), and the caller's setting is back afterwards."""
    seen = []
    orig = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return orig(a, b)

    for w in (48, 47):
        img, mask, _, y = _scenario(np.float32, w=w, seed=5)
        dc = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.05, method="matmul")
        seen.clear()
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
        try:
            dc(_t(img))
            after = torch.backends.cuda.matmul.allow_tf32
        finally:
            monkeypatch.undo()
            torch.backends.cuda.matmul.allow_tf32 = prev
        assert len(seen) >= 8 and not any(seen), (w, seen)
        assert after is True


def test_precision_guard_takes_flags_set_apart_by_the_caller():
    """A caller that set the process-wide precision and then cuBLAS's flag
    alone (torch's getter of the process-wide value raises then) still gets
    full precision inside and its own flags back."""
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.set_float32_matmul_precision("high")
        for caller in (False, True, False):
            torch.backends.cuda.matmul.allow_tf32 = caller
            with fourier.full_precision_matmul():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is caller
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = prev


def _jax_form(packed, karatsuba, fn):
    """``fn()`` with the JAX package's packed / Karatsuba flags set, and its
    own values back after (``tests/test_ops.py``'s pattern)."""
    old = jf._MATMUL_PACKED, jf._MATMUL_K3
    try:
        jf._MATMUL_PACKED, jf._MATMUL_K3 = packed, karatsuba
        return fn()
    finally:
        jf._MATMUL_PACKED, jf._MATMUL_K3 = old


@pytest.mark.parametrize("packed,karatsuba", [(False, False), (True, False), (True, True)],
                         ids=["unpacked", "packed", "packed_karatsuba"])
def test_packed_matmul_dc_forms_equal_the_rfft_path(packed, karatsuba):
    """The port's matmul solve at even W (Nyquist-packed, Karatsuba
    products) is the rfft solve reassociated: 1e-12 in float64 at 24 x 32,
    and within 1e-12 of each of the JAX package's three matmul forms."""
    rng = np.random.default_rng(11)
    h, w = 24, 32
    v = rng.random((3, h, w))
    mask = (rng.random((h, w)) < 0.3).astype(np.float64)
    y = np.fft.fft2(rng.random((h, w))) * mask + (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))
    ref = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.015)(_t(v))
    got = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.015, method="matmul")(_t(v))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    jax_got = _jax_form(packed, karatsuba, lambda: np.asarray(
        jf.make_rfft_data_consistency(jnp.asarray(y), jnp.asarray(mask), 0.015, method="matmul")(jnp.asarray(v))))
    np.testing.assert_allclose(got.numpy(), jax_got, rtol=0, atol=1e-12)


def test_packed_matmul_dc_in_float32_matches_jax():
    img, mask, _, y = _scenario(np.float32, seed=12)
    got = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.05, method="matmul")(_t(img))
    ref = _jax_form(True, True, lambda: jf.make_rfft_data_consistency(
        jnp.asarray(y), jnp.asarray(mask), 0.05, method="matmul")(jnp.asarray(img)))
    _close(got.numpy(), ref, np.float32)


def test_packed_matmul_dc_takes_the_unpacked_form_at_odd_width():
    """Odd W has no Nyquist bin: the matmul solve is the unpacked form,
    within 1e-12 of the rfft path and of the JAX package's matmul solve,
    which falls back the same way with its packing flags on."""
    rng = np.random.default_rng(13)
    h, w = 24, 31
    v = rng.random((h, w))
    mask = (rng.random((h, w)) < 0.4).astype(np.float64)
    y = np.fft.fft2(rng.random((h, w))) * mask
    got = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.1, method="matmul")(_t(v))
    ref = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.1)(_t(v))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    for packed in (False, True):
        jax_got = _jax_form(packed, packed, lambda: np.asarray(
            jf.make_rfft_data_consistency(jnp.asarray(y), jnp.asarray(mask), 0.1, method="matmul")(jnp.asarray(v))))
        np.testing.assert_allclose(got.numpy(), jax_got, rtol=0, atol=1e-12)
    cw, sw = fourier._dft_mats(w, torch.float64)
    ch, sh = fourier._dft_mats(h, torch.float64)
    a, c = fourier.rfft_blend_fields(_t(y), _t(mask), 0.1)
    vr, vi = fourier.matmul_rfft2(_t(v), (cw, sw, ch, sh))
    unpacked = torch.abs(fourier.matmul_irfft2(a * vr + c.real, a * vi + c.imag, h, w, (cw, sw, ch, sh)))
    assert torch.equal(got, unpacked)


def test_resolve_dc_method_on_the_cpu():
    y = torch.zeros(2, 16, 16, dtype=torch.complex64)
    assert fourier.resolve_dc_method("auto", y) == "fft" == jf.resolve_dc_method("auto", jnp.zeros((2, 16, 16)))
    assert fourier.resolve_dc_method("auto", torch.zeros(1, 2048, 2048, dtype=torch.complex64)) == "fft"
    assert fourier.resolve_dc_method("matmul", y) == "matmul" == jf.resolve_dc_method("matmul", y)
    assert fourier.resolve_dc_method("fft", y) == "fft"
    with pytest.raises(ValueError, match="dc_method"):
        fourier.resolve_dc_method("fast", y)


def test_admm_l1_auto_equals_fft():
    from pnp_admm_cnc_mri_torch.config import ADMMConfig
    from pnp_admm_cnc_mri_torch.solvers import admm

    img, mask, _, y = _scenario(np.float64, seed=14)
    cfg = ADMMConfig(iter_num=6)
    runs = {m: admm.admm_l1(_t(y), _t(mask), cfg, dtype=torch.float64, dc_method=m, device="cpu")[0]
            for m in ("auto", "fft")}
    assert torch.equal(runs["auto"].x, runs["fft"].x) and torch.equal(runs["auto"].z, runs["fft"].z)
