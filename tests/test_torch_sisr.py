"""The SR/deblurring operators (``ops/sisr.py``) and the MATLAB bicubic
resize (``ops/resize.py``) against the JAX package, on the CPU.

The same numpy inputs (seeded, 32 x 32 high-resolution images, batch 2) go
through ``pnp_admm_cnc_mri_tpu.ops.{sisr,resize}`` and the port. Tolerances
(max abs): float64 1e-9 (measured at most 1.2e-14: the FFTs differ in
their last bits only); float32 5e-6 (measured 3e-7), except the data
solutions at alpha 2.5e-3, held to 1e-4: their 1/alpha scaling cancels
spectra ~400x the result, and each package's float32 solve is 6e-6 to
2.7e-5 from its float64 one (measured 3.0e-5 apart at 32 x 32). The
host-numpy half (kernel generators, pixel shift, PCA) is compared at 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.ops import resize as jresize
from pnp_admm_cnc_mri_tpu.ops import sisr as jsisr
from pnp_admm_cnc_mri_torch.ops import resize, sisr

JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
ATOL = {torch.float64: 1e-9, torch.float32: 5e-6}
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
N = 32


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(seed, shape):
    return np.random.default_rng(seed).random(shape)


def _pair(a, dtype):
    """The same array for JAX and for the port, in one dtype."""
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(np.asarray(a)).to(dtype)


def _close(got, want, dtype, atol=None):
    got = got.detach().resolve_conj().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[dtype] if atol is None else atol)


def _kernel(ksize=9):
    return jsisr.anisotropic_gaussian(ksize=ksize, theta=0.7, l1=2.5, l2=1.0)


@DTYPES
@pytest.mark.parametrize("ksize", [3, 9, 15])
def test_psf2otf(dtype, ksize):
    kj, kt = _pair(_kernel(ksize), dtype)
    _close(sisr.psf2otf(kt, (N, N)), jsisr.psf2otf(kj, (N, N)), dtype)


@DTYPES
@pytest.mark.parametrize("sf", [2, 4])
def test_up_and_down_sampling(dtype, sf):
    xj, xt = _pair(_np(1, (2, N, N)), dtype)
    _close(sisr.upsample_zeros(xt, sf), jsisr.upsample_zeros(xj, sf), dtype, atol=0)
    _close(sisr.downsample(xt, sf), jsisr.downsample(xj, sf), dtype, atol=0)
    for center in (False, True):
        for got, want in zip(sisr.interpolation_down(xt, sf, center), jsisr.interpolation_down(xj, sf, center)):
            _close(got, want, dtype, atol=0)


@DTYPES
@pytest.mark.parametrize("sf", [2, 4])
def test_block_mean_averages_the_aliasing_quadrants(dtype, sf):
    """``_block_mean`` splits H into (sf, H/sf): entry (i, j) averages the
    bins (i + p H/sf, j + q W/sf), which a pooling of neighbouring bins would
    not; checked against JAX and against that definition."""
    a = _np(2, (2, N, N)) + 1j * _np(3, (2, N, N))
    aj = jnp.asarray(a, jnp.complex128 if dtype == torch.float64 else jnp.complex64)
    at = torch.from_numpy(a).to(torch.complex128 if dtype == torch.float64 else torch.complex64)
    got = sisr._block_mean(at, sf)
    _close(got, jsisr._block_mean(aj, sf), dtype)
    hs = N // sf
    want = sum(a[:, p * hs:(p + 1) * hs, q * hs:(q + 1) * hs] for p in range(sf) for q in range(sf)) / sf**2
    _close(got, want, dtype)
    pooled = torch.nn.functional.avg_pool2d(at.real, sf)
    assert not torch.allclose(got.real, pooled)


@DTYPES
@pytest.mark.parametrize("sf", [1, 2, 3])
def test_pre_calculate_and_data_solution(dtype, sf):
    n = 24 if sf == 3 else N
    yj, yt = _pair(_np(4, (2, n // sf, n // sf)), dtype)
    zj, zt = _pair(_np(5, (2, n, n)), dtype)
    kj, kt = _pair(_kernel(), dtype)
    pj, pt = jsisr.pre_calculate(yj, kj, sf), sisr.pre_calculate(yt, kt, sf)
    for got, want in zip(pt, pj):
        _close(got, want, dtype)
    for alpha, f32_atol in ((0.37, None), (2.5e-3, 1e-4)):
        _close(sisr.data_solution(zt, *pt, alpha, sf), jsisr.data_solution(zj, *pj, alpha, sf), dtype,
               atol=f32_atol if dtype == torch.float32 else None)
    if sf == 1:
        _close(sisr.deblur_solution(zt, pt[2], pt[3], 0.37), jsisr.deblur_solution(zj, pj[2], pj[3], 0.37), dtype)


@DTYPES
@pytest.mark.parametrize("sf", [2, 4])
def test_invls(dtype, sf):
    yj, yt = _pair(_np(6, (2, N // sf, N // sf)), dtype)
    zj, zt = _pair(_np(7, (2, N, N)), dtype)
    kj, kt = _pair(_kernel(), dtype)
    fb_j, fbc_j, f2b_j, fbfy_j = jsisr.pre_calculate(yj, kj, sf)
    fb_t, fbc_t, f2b_t, fbfy_t = sisr.pre_calculate(yt, kt, sf)
    tau = 0.2
    fr_j = fbfy_j + jnp.fft.fft2(tau * zj, axes=(-2, -1))
    fr_t = fbfy_t + torch.fft.fft2(tau * zt)
    _close(sisr.invls(fb_t, fbc_t, f2b_t, fr_t, tau, sf), jsisr.invls(fb_j, fbc_j, f2b_j, fr_j, tau, sf), dtype)


@DTYPES
def test_wrap_filters_and_the_degradation_pair(dtype):
    xj, xt = _pair(_np(8, (2, N, N)), dtype)
    kj, kt = _pair(_kernel(), dtype)
    _close(sisr.wrap_convolve(xt, kt), jsisr.wrap_convolve(xj, kj), dtype)
    _close(sisr.wrap_correlate(xt, kt), jsisr.wrap_correlate(xj, kj), dtype)
    _close(sisr.G(xt, kt, 2), jsisr.G(xj, kj, 2), dtype)
    lj, lt = _pair(_np(9, (2, N // 2, N // 2)), dtype)
    _close(sisr.Gt(lt, kt, 2), jsisr.Gt(lj, kj, 2), dtype)


@DTYPES
def test_degradations(dtype):
    xj, xt = _pair(_np(10, (2, N, N)), dtype)
    kj, kt = _pair(_kernel(), dtype)
    for name in ("srmd_degradation", "dpsr_degradation", "classical_degradation"):
        _close(getattr(sisr, name)(xt, kt, 2), getattr(jsisr, name)(xj, kj, 2), dtype)
    _close(sisr.bicubic_degradation(xt, 2), jsisr.bicubic_degradation(xj, 2), dtype)


@DTYPES
@pytest.mark.parametrize("scale", [0.5, 0.25, 2.0, 1.5, 0.75])
def test_imresize(dtype, scale):
    xj, xt = _pair(_np(11, (2, N, N)), dtype)
    got = resize.imresize(xt, scale)
    _close(got, jresize.imresize(xj, scale), dtype)
    _close(got[1], jresize.imresize(xj[1], scale), dtype)  # each image equals its single-image call


def test_imresize_tables_equal_the_jax_packages():
    for args in ((32, 16, 0.5, True), (32, 64, 2.0, True), (30, 23, 0.75, False)):
        for got, want in zip(resize._weights_indices(*args), jresize._weights_indices(*args)):
            np.testing.assert_array_equal(got, want)


def test_host_kernel_generators_equal_the_jax_packages():
    np.testing.assert_allclose(sisr.anisotropic_gaussian(15, 0.25 * np.pi, 3.0, 1.0),
                               jsisr.anisotropic_gaussian(15, 0.25 * np.pi, 3.0, 1.0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sisr.gm_blur_kernel([0.0, 0.0], [[2.0, 0.0], [0.0, 2.0]], 15),
                               jsisr.gm_blur_kernel([0.0, 0.0], [[2.0, 0.0], [0.0, 2.0]], 15), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sisr.gen_kernel(rng=np.random.default_rng(3), noise_level=0.1),
                               jsisr.gen_kernel(rng=np.random.default_rng(3), noise_level=0.1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sisr.cal_pca_matrix(ksize=7, num_samples=40, dim_pca=5, rng=np.random.default_rng(2)),
                               jsisr.cal_pca_matrix(ksize=7, num_samples=40, dim_pca=5, rng=np.random.default_rng(2)),
                               rtol=0, atol=1e-12)
    img = _np(12, (20, 18))
    for sf in (2, 3):
        np.testing.assert_allclose(sisr.shift_pixel(img, sf), jsisr.shift_pixel(img, sf), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sisr.shift_pixel(_np(13, (12, 10, 3)), 2, upper_left=False),
                               jsisr.shift_pixel(_np(13, (12, 10, 3)), 2, upper_left=False), rtol=0, atol=1e-12)


def test_comp_upto_shift():
    rng = np.random.default_rng(14)
    ref = 255.0 * rng.random((48, 48))
    est = np.roll(ref, 1, axis=1) + rng.normal(0, 2.0, ref.shape)
    got = sisr.comp_upto_shift(est, ref, maxshift=2, border=6, min_interval=0.5)
    want = jsisr.comp_upto_shift(est, ref, maxshift=2, border=6, min_interval=0.5)
    assert got[2] == want[2]
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-9)


def test_entry_points_keep_cpu_tensors_on_the_cpu():
    x = torch.rand(2, N, N, dtype=torch.float64)
    out = sisr.wrap_convolve(x, torch.from_numpy(_kernel()))
    assert out.device.type == "cpu" and out.dtype == torch.float64
