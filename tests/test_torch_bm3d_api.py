"""The BM3D API (``priors/bm3d/api.py``) and the PSD parameter estimation
(``priors/bm3d/psd_params.py``) against the JAX package, on the CPU.

The same numpy images (32 x 32; batches of two for the batched cases) go
through ``pnp_admm_cnc_mri_tpu.priors.bm3d.{api,psd_params}`` and the port.
The white-noise core runs the Haar tree in the port on every device, so
the JAX package is switched to its tree form for this module
(``core._STACK_FILTER_TREE``, its compiled caches cleared around it); the
staged, multichannel and RGB paths run the per-size matrix loop in both.
The colored routes use the JAX package with its covariance field cast to
float64 (see ``test_torch_bm3d_colored.py``). The parameter estimation
needs the reference's ``param_matching_data.mat``, which is not in the
repository: a synthetic ``features``/``maxes`` database is written to
``tmp_path`` and both packages' ``DEFAULT_DB`` point at it.

Tolerances (max abs): float64 1e-9 (measured at most 1e-15); float32
2e-5. Matches are compared for equality.
"""

import dataclasses

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.data import noise as jnoise
from pnp_admm_cnc_mri_tpu.priors.bm3d import api as japi
from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore
from pnp_admm_cnc_mri_tpu.priors.bm3d import psd_params as jpsd
from pnp_admm_cnc_mri_torch.priors.bm3d import api, core, psd_params

N = 32
CPU = "cpu"
ATOL = 1e-9
F32_ATOL = 2e-5
SIGMA = 0.1


@pytest.fixture(scope="module", autouse=True)
def setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    jax.clear_caches()
    jcore._STACK_FILTER_TREE = True
    yield
    jcore._STACK_FILTER_TREE = None
    jax.clear_caches()
    torch.set_num_threads(prev)


@pytest.fixture
def jax_f64_cov(monkeypatch):
    orig = jcore.coeff_cov_field
    monkeypatch.setattr(jcore, "coeff_cov_field", lambda *a, **k: orig(*a, **k).astype(np.float64))


@pytest.fixture
def param_db(tmp_path, monkeypatch):
    """A synthetic parameter database (20 features x 60 samples, optimal
    parameter indices 1..21), read by both packages."""
    rng = np.random.default_rng(3)
    path = tmp_path / "param_matching_data.mat"
    sio.savemat(path, {"features": rng.random((20, 60)) * 10.0,
                       "maxes": rng.integers(1, 22, size=(60, 4)).astype(np.float64)})
    monkeypatch.setattr(jpsd, "DEFAULT_DB", str(path))
    monkeypatch.setattr(psd_params, "DEFAULT_DB", str(path))
    return str(path)


@pytest.fixture
def no_db(tmp_path, monkeypatch):
    missing = str(tmp_path / "absent.mat")
    monkeypatch.setattr(jpsd, "DEFAULT_DB", missing)
    monkeypatch.setattr(psd_params, "DEFAULT_DB", missing)


def _clean(n=N):
    yy, xx = np.mgrid[:n, :n]
    x = 0.5 + 0.3 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    return np.where((xx - n / 2) ** 2 + (yy - n / 2) ** 2 < (n / 3) ** 2, x, 0.1)


def _scene(n=N, seed=0):
    return _clean(n) + SIGMA * np.random.default_rng(seed).standard_normal((n, n))


def _colored(fam="g1"):
    k = jnoise.get_experiment_kernel(fam, 0.02)
    return _clean() + jnoise.synth_colored_noise((N, N), k, seed=1), np.abs(np.fft.fft2(k, (N, N))) ** 2 * N * N


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# api.bm3d, route by route
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def z():
    return _scene()


@pytest.fixture(scope="module")
def pilot(z):
    """An HT estimate to pass as ``stage_arg`` (the port's; its JAX twin is
    within 1e-15)."""
    return core.ht_stage(torch.from_numpy(z), SIGMA).numpy()


def test_route_scalar_sigma(z):
    _close(api.bm3d(z, SIGMA, device=CPU), japi.bm3d(jnp.asarray(z), SIGMA))


def test_route_scalar_sigma_float32(z):
    got = api.bm3d(z.astype(np.float32), SIGMA, device=CPU)
    assert got.dtype == torch.float32
    _close(got, japi.bm3d(jnp.asarray(z, jnp.float32), SIGMA), F32_ATOL)


def test_route_scalar_sigma_with_stage_arg(z, pilot):
    _close(api.bm3d(z, SIGMA, stage_arg=pilot, device=CPU), japi.bm3d(jnp.asarray(z), SIGMA, stage_arg=pilot))


def test_route_flat_psd(z):
    psd = jnoise.white_noise_psd((N, N), SIGMA**2)
    _close(api.bm3d(z, psd, device=CPU), japi.bm3d(jnp.asarray(z), psd))
    _close(api.bm3d(z, psd, device=CPU), api.bm3d(z, SIGMA, device=CPU), 1e-15)


def test_route_flat_psd_with_stage_arg(z, pilot):
    psd = jnoise.white_noise_psd((N, N), SIGMA**2)
    _close(api.bm3d(z, psd, stage_arg=pilot, device=CPU), japi.bm3d(jnp.asarray(z), psd, stage_arg=pilot))


def test_route_colored_psd(param_db, jax_f64_cov):
    zc, psd = _colored()
    _close(api.bm3d(zc, psd, device=CPU), japi.bm3d(jnp.asarray(zc), psd))


def test_route_colored_psd_with_stage_arg(param_db, jax_f64_cov, pilot):
    zc, psd = _colored()
    _close(api.bm3d(zc, psd, stage_arg=pilot, device=CPU), japi.bm3d(jnp.asarray(zc), psd, stage_arg=pilot))


def test_route_colored_psd_without_the_database_raises(no_db):
    zc, psd = _colored()
    for fn in (japi.bm3d, lambda a, p: api.bm3d(a, p, device=CPU)):
        with pytest.raises(FileNotFoundError):
            fn(zc, psd)


def test_route_psd_of_another_shape_raises(z):
    with pytest.raises(ValueError, match="PSD shape"):
        api.bm3d(z, np.ones((N, N + 1)), device=CPU)


def test_route_refilter_profile(z):
    _close(api.bm3d(z, SIGMA, profile="refilter", device=CPU), japi.bm3d(jnp.asarray(z), SIGMA, profile="refilter"))


def test_route_exact_white_profile(z, jax_f64_cov):
    """A scalar sigma through the exact colored core; the 'np' geometry with
    ``exact_white`` set (the named profiles 'vn', 'vn_old', 'high' and 'deb'
    set it too)."""
    prof = dataclasses.replace(core.DEFAULT_PROFILE, exact_white=True)
    jprof = dataclasses.replace(jcore.DEFAULT_PROFILE, exact_white=True)
    _close(api.bm3d(z, SIGMA, profile=prof, device=CPU), japi.bm3d(jnp.asarray(z), SIGMA, profile=jprof))


def test_batch_equals_single_images():
    zs = np.stack([_scene(seed=s) for s in range(2)])
    got = api.bm3d(zs, SIGMA, device=CPU)
    for i in range(2):
        assert torch.equal(got[i], api.bm3d(zs[i], SIGMA, device=CPU))
        _close(got[i], japi.bm3d(jnp.asarray(zs[i]), SIGMA))


# ---------------------------------------------------------------------------
# block matches, multichannel, RGB
# ---------------------------------------------------------------------------


def test_blockmatches_and_their_reuse(z):
    p = core.DEFAULT_PROFILE
    for stage in ("ht", "wie"):
        got = api.compute_blockmatches(z, p, stage, device=CPU)
        want = japi.compute_blockmatches(jnp.asarray(z), p, stage)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y, bm_ht, bm_wie = api.bm3d_with_blockmatches(z, SIGMA, device=CPU)
    jy, jbm_ht, jbm_wie = japi.bm3d_with_blockmatches(jnp.asarray(z), SIGMA)
    _close(y, jy)
    for a, b in zip(bm_ht + bm_wie, jbm_ht + jbm_wie):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    z2 = _scene(seed=4)
    y2 = api.bm3d_with_blockmatches(z2, SIGMA, bm_ht=bm_ht, bm_wie=bm_wie, device=CPU)[0]
    _close(y2, japi.bm3d_with_blockmatches(jnp.asarray(z2), SIGMA, bm_ht=jbm_ht, bm_wie=jbm_wie)[0])
    assert torch.equal(api.bm3d_with_blockmatches(z, SIGMA, bm_ht=bm_ht, bm_wie=bm_wie, device=CPU)[0], y)


@pytest.fixture(scope="module")
def stack3():
    return np.stack([_scene(seed=s) for s in (5, 6, 7)], axis=-1)  # (H, W, 3)


@pytest.mark.parametrize("sigma", [SIGMA, [0.08, 0.1, 0.12], "flat_psd"], ids=["scalar", "per_channel", "flat_psd"])
def test_multichannel(stack3, sigma):
    if sigma == "flat_psd":
        sigma = jnoise.white_noise_psd((N, N), SIGMA**2)
    _close(api.bm3d_multichannel(stack3, sigma, device=CPU), japi.bm3d_multichannel(jnp.asarray(stack3), sigma))


@pytest.mark.parametrize("per_channel", [False, True], ids=["shared_psd", "psd_per_channel"])
def test_multichannel_colored_psd(stack3, per_channel, param_db):
    _, psd = _colored()
    if per_channel:
        psd = np.stack([psd, jnoise.white_noise_psd((N, N), 0.01), psd * 2.0], axis=-1)
    _close(api.bm3d_multichannel(stack3, psd, device=CPU), japi.bm3d_multichannel(jnp.asarray(stack3), psd))


def test_multichannel_batch_equals_single_images(stack3):
    zs = np.stack([stack3, stack3[::-1]])
    got = api.bm3d_multichannel(zs, SIGMA, device=CPU)
    for i in range(2):
        assert torch.equal(got[i], api.bm3d_multichannel(zs[i], SIGMA, device=CPU))


def test_rgb(stack3):
    _close(api.bm3d_rgb(stack3, SIGMA, device=CPU), japi.bm3d_rgb(jnp.asarray(stack3), SIGMA))


# ---------------------------------------------------------------------------
# deblurring, refiltering, parameter estimation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blurred():
    from pnp_admm_cnc_mri_tpu.ops import sisr as jsisr

    psf = jsisr.anisotropic_gaussian(ksize=9, theta=0.7, l1=2.5, l2=1.0)
    zb = np.asarray(jsisr.wrap_convolve(jnp.asarray(_clean()), jnp.asarray(psf)))
    return zb + 0.02 * np.random.default_rng(8).standard_normal((N, N)), psf


def test_deblurring_white(blurred):
    zb, psf = blurred
    _close(api.bm3d_deblurring(zb, 0.02, psf, colored=False, device=CPU),
           japi.bm3d_deblurring(jnp.asarray(zb), 0.02, psf, colored=False))


def test_deblurring_colored(blurred, param_db, jax_f64_cov):
    zb, psf = blurred
    _close(api.bm3d_deblurring(zb, 0.02, psf, device=CPU), japi.bm3d_deblurring(jnp.asarray(zb), 0.02, psf))


def test_filtered_residual_per_image_sigma():
    zs = np.stack([_scene(seed=s) for s in range(2)])
    y_hat = zs - 0.05 * np.sin(np.arange(N) / 2.0)  # leave structure in the residual
    sig = np.array([0.01, 0.1])
    rem, rpsd = api.get_filtered_residual(torch.from_numpy(zs), torch.from_numpy(y_hat), torch.from_numpy(sig))
    for i in range(2):
        jrem, jrpsd = japi.get_filtered_residual(jnp.asarray(zs[i]), jnp.asarray(y_hat[i]), jnp.asarray(sig[i]))
        _close(rem[i], jrem)
        _close(rpsd[i], jrpsd)
    assert float(rpsd[0].max()) > 0.0


@pytest.mark.parametrize("colored", [False, True], ids=["band_average", "colored"])
def test_refilter_batch_with_per_image_sigma(colored, jax_f64_cov):
    """The second pass takes each image's own std of the remains; each image
    of the batch equals the JAX package's single-image call."""
    zs = np.stack([_scene(seed=s) for s in range(2)])
    got = api.bm3d_refilter(zs, SIGMA, colored=colored, device=CPU)
    for i in range(2):
        _close(got[i], japi.bm3d_refilter(jnp.asarray(zs[i]), SIGMA, colored=colored))


def test_estimate_parameters(param_db):
    _, psd = _colored()
    got = api.estimate_parameters_for_psd(psd)
    assert got == pytest.approx(japi.estimate_parameters_for_psd(psd), abs=1e-12)
    white = jnoise.white_noise_psd((N, N), 0.01)
    assert api.estimate_parameters_for_psd(white) == pytest.approx(japi.estimate_parameters_for_psd(white), abs=1e-12)
    p65 = psd_params.shrink_and_normalize_psd(psd)
    np.testing.assert_allclose(p65, jpsd.shrink_and_normalize_psd(psd), rtol=1e-12)
    np.testing.assert_allclose(psd_params.psd_features(np.fft.fftshift(p65)),
                               jpsd.psd_features(np.fft.fftshift(p65)), rtol=1e-12)


def test_estimate_parameters_without_the_database(no_db):
    assert api.estimate_parameters_for_psd(jnoise.white_noise_psd((N, N), 0.03)) == (3.0, 0.4, 2.5, 3.6)
    with pytest.raises(FileNotFoundError):
        api.estimate_parameters_for_psd(_colored()[1])


def test_profiles_by_name():
    assert core.get_profile("np") is core.DEFAULT_PROFILE
    assert dataclasses.asdict(core.get_profile("refilter")) == dataclasses.asdict(jcore.get_profile("refilter"))
    with pytest.raises(ValueError):
        api.bm3d(_scene(), SIGMA, profile="nope", device=CPU)


def test_entry_points_need_the_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    zs = _scene()
    for fn in (lambda: api.bm3d(zs, SIGMA), lambda: api.bm3d_rgb(np.stack([zs] * 3, -1), SIGMA),
               lambda: api.compute_blockmatches(zs, core.DEFAULT_PROFILE)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
