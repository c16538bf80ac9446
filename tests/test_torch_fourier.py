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
    the caller allows TF32, and the caller's setting is back afterwards."""
    img, mask, _, y = _scenario(np.float32, seed=5)
    dc = fourier.make_rfft_data_consistency(_t(y), _t(mask), 0.05, method="matmul")
    seen = []
    for name in ("matmul_rfft2", "matmul_irfft2"):
        orig = getattr(fourier, name)

        def spy(*a, _orig=orig, **k):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return _orig(*a, **k)

        monkeypatch.setattr(fourier, name, spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dc(_t(img))
        after = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False, False]
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
