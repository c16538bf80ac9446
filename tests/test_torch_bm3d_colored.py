"""BM3D's colored-noise half and the noise families against the JAX
package, on the CPU.

The same numpy images (32 x 32; a batch of three for the batched cases) and
PSDs go through ``pnp_admm_cnc_mri_tpu.priors.bm3d.core`` and the port's
``priors/bm3d/core.py``. The colored stages filter the stacks by the
per-size matrix loop in both packages (JAX runs it on every backend), with
the Haar matrices rounded to float32 and cast to the working dtype.

The exact-variance path: JAX's ``coeff_cov_field`` returns float32 and its
Haar bank is float32, so its per-group variances are float32 arithmetic in
every dtype. The port computes them in the working dtype from the same
float32-rounded values. So in float64 the port is held to 1e-9 against the
JAX package with its covariance field cast to float64 (a test-side
wrapper, which makes JAX's own products float64; measured 8e-16); the
comparisons with the JAX package as it is, and in float32, are in
``test_torch_bm3d_colored_f32.py``. Tolerance (max abs): float64 1e-9 (the
approximate path: measured 4.4e-16). Matched positions are compared for
equality, a tie image included.
"""

import dataclasses

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.data import noise as jnoise
from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore
from pnp_admm_cnc_mri_tpu.priors.bm3d import transforms as jtr
from pnp_admm_cnc_mri_torch.data import noise
from pnp_admm_cnc_mri_torch.priors.bm3d import core, transforms as tr

N = 32
CPU = "cpu"
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
ATOL = {torch.float64: 1e-9, torch.float32: 2e-5}
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
FAMILIES = ["g1", "g2", "g4", "gw"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_f64_cov(monkeypatch):
    """The JAX package with its covariance field cast to float64, so that its
    exact variances are float64 products of the same float32-rounded values."""
    orig = jcore.coeff_cov_field
    monkeypatch.setattr(jcore, "coeff_cov_field", lambda *a, **k: orig(*a, **k).astype(np.float64))


def _scene(n=N):
    """A smooth disc on a flat background."""
    yy, xx = np.mgrid[:n, :n]
    x = 0.5 + 0.3 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    return np.where((xx - n / 2) ** 2 + (yy - n / 2) ** 2 < (n / 3) ** 2, x, 0.1)


def _family(fam, var=0.02, seed=0, n=N):
    """(noisy image, PSD) of a noise family, the PSD computed as
    ``get_experiment_noise`` computes it."""
    k = jnoise.get_experiment_kernel(fam, var)
    return _scene(n) + jnoise.synth_colored_noise((n, n), k, seed=seed), np.abs(np.fft.fft2(k, (n, n))) ** 2 * n * n


def _narrowband(n=N):
    """A PSD with most of its energy in two bins away from DC (triggers the
    adaptive pilot), and a patch-sparse sinusoid and a textured image: the
    pilot goes hard (lambda 8) on the first only."""
    psd = np.full((n, n), 0.01 * n * n)
    for a, b in ((6, 9), (-6, -9)):
        psd[a % n, b % n] += 0.05 * n**4 / 4
    yy, xx = np.mgrid[:n, :n]
    sparse = 0.5 + 0.3 * np.cos(2 * np.pi * (3 * xx + 2 * yy) / n)
    textured = np.clip(0.5 + 0.2 * np.random.default_rng(0).standard_normal((n, n)), 0, 1)
    return psd, np.stack([sparse, textured, sparse[::-1]])


def _close(got, want, atol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# data/noise.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", list(noise.NOISE_TYPES))
def test_experiment_kernel_of_every_family(fam):
    got = noise.get_experiment_kernel(fam, 0.02)
    np.testing.assert_array_equal(got, jnoise.get_experiment_kernel(fam, 0.02))
    np.testing.assert_allclose(np.sqrt((got**2).sum()), np.sqrt(0.02), rtol=1e-12)


def test_experiment_kernel_refuses_unknown_families():
    with pytest.raises(ValueError):
        noise.get_experiment_kernel("g5", 0.02)


def test_white_psd_and_colored_noise():
    np.testing.assert_array_equal(noise.white_noise_psd((12, 20), 0.03), jnoise.white_noise_psd((12, 20), 0.03))
    k = noise.get_experiment_kernel("g2", 0.02)
    np.testing.assert_array_equal(noise.synth_colored_noise((40, 36), k, seed=3),
                                  jnoise.synth_colored_noise((40, 36), k, seed=3))


@pytest.mark.parametrize("with_file", [False, True], ids=["synthesized", "noises_mat"])
def test_experiment_noise_both_branches(tmp_path, with_file):
    """With ``noises.mat`` present both return its realization x3 whatever
    the family (the reference's quirk); without it, synthesized colored
    noise. The PSD is the family's either way."""
    data_dir = str(tmp_path)
    if with_file:
        rng = np.random.default_rng(1)
        sio.savemat(tmp_path / "noises.mat", {"noises": rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))})
    got = noise.get_experiment_noise("g1", 0.02, 2, (N, N), data_dir=data_dir)
    want = jnoise.get_experiment_noise("g1", 0.02, 2, (N, N), data_dir=data_dir)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.iscomplexobj(got[0]) == with_file
    np.testing.assert_array_equal(got[1], noise.experiment_psd(got[2], (N, N)))


# ---------------------------------------------------------------------------
# transforms, Haar bank, coefficient variances
# ---------------------------------------------------------------------------


def test_stack_transforms_and_the_haar_bank():
    for k in (16, 32):
        got, want = tr.stack_transforms(k), jtr.stack_transforms(k)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for s in a:
                np.testing.assert_array_equal(a[s], b[s])
        for dtype in (torch.float64, torch.float32):
            sizes, fwd, inv = core._haar_bank(k, torch.zeros(1, dtype=dtype))
            j_sizes, j_fwd, j_inv = jcore._haar_bank(k)
            assert sizes == j_sizes
            for a, b in zip(fwd + inv, j_fwd + j_inv):
                assert a.dtype == dtype
                np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.float64))


@pytest.mark.parametrize("fam", FAMILIES)
@pytest.mark.parametrize("kind", ["bior1.5", "dct", "dst"])
def test_coefficient_stds_and_covariance_field(fam, kind):
    """Equal for the tabled and the DCT transforms; the port writes the DST
    out without scipy, whose matrix differs in the last bits (2e-16)."""
    _, psd = _family(fam)
    got_s, want_s = core.psd_to_coeff_stds(psd, kind), jcore.psd_to_coeff_stds(psd, kind)
    got = core.coeff_cov_field(psd, kind, radius=8)
    want = jcore.coeff_cov_field(psd, kind, radius=8)
    assert got.dtype == np.float32
    if kind == "dst":
        np.testing.assert_allclose(got_s, want_s, rtol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    else:
        np.testing.assert_array_equal(got_s, want_s)
        np.testing.assert_array_equal(got, want)


@DTYPES
def test_exact_group_vars(dtype):
    _, psd = _family("g2")
    covf = core.coeff_cov_field(psd, "dct")
    rng = np.random.default_rng(2)
    pos = rng.integers(0, N - 7, size=(40, 8, 2))
    hf = core._haar_bank(8, torch.zeros(1, dtype=dtype))[1][-1]
    got = core._exact_group_vars(torch.from_numpy(pos), torch.from_numpy(covf).to(dtype), hf, 32)
    want = jcore._exact_group_vars(jnp.asarray(pos), jnp.asarray(covf, JNP[dtype]),
                                   jnp.asarray(hf.numpy()), 32, chunk=16)
    _close(got, want, 1e-15 if dtype == torch.float64 else 1e-9)  # variances ~1e-3


# ---------------------------------------------------------------------------
# the colored core
# ---------------------------------------------------------------------------


def _jax_colored(z, psd, dtype, **kw):
    return np.asarray(jcore.bm3d_colored(jnp.asarray(z, JNP[dtype]), psd, **kw))


@pytest.mark.parametrize("fam, exact", [(f, True) for f in FAMILIES] + [("g1", False)],
                         ids=[f"exact-{f}" for f in FAMILIES] + ["approx-g1"])
def test_bm3d_colored_f64(fam, exact, jax_f64_cov):
    z, psd = _family(fam)
    got = core.bm3d_colored(torch.from_numpy(z), psd, exact=exact, device=CPU)
    _close(got, _jax_colored(z, psd, torch.float64, exact=exact), ATOL[torch.float64])


def test_stages_and_their_matches(jax_f64_cov):
    """Each stage alone (exact variances), and the matches it uses, equal."""
    z, psd = _family("g2")
    p = core.DEFAULT_PROFILE
    stds_ht, stds_wie = core.psd_to_coeff_stds(psd, p.transform_ht), core.psd_to_coeff_stds(psd, p.transform_wie)
    cov_ht, cov_wie = core.coeff_cov_field(psd, p.transform_ht), core.coeff_cov_field(psd, p.transform_wie)
    ms = float(np.sqrt(psd.mean() / N**2))
    zt = torch.from_numpy(z)
    yb = core.ht_stage_colored(zt, stds_ht, ms, p, cov_field=cov_ht)
    jyb = jcore.ht_stage_colored(jnp.asarray(z), stds_ht, ms, p, cov_field=jnp.asarray(cov_ht, jnp.float64))
    _close(yb, jyb, ATOL[torch.float64])
    out = core.wiener_stage_colored(zt, yb, stds_wie, p, cov_field=cov_wie)
    jout = jcore.wiener_stage_colored(jnp.asarray(z), jyb, stds_wie, p, cov_field=jnp.asarray(cov_wie, jnp.float64))
    _close(out, jout, ATOL[torch.float64])
    bs = p.bs_ht
    ref, offs = core._ref_grid(N - bs + 1, p.step_ht), core._offsets(p.search_ht, bs)
    for img, k, tau_m in ((z, p.max_3d_ht, p.tau_match_ht), (np.asarray(jyb), p.max_3d_wie, p.tau_match_wie)):
        tau = tau_m * p.tau_scale * bs * bs / 255.0**2
        pos, cnt = core._match(torch.from_numpy(np.array(img)), ref, offs, bs, k, tau)
        jpos, jcnt = jcore._match(jnp.asarray(img), ref, offs, bs, k, tau)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_prefiltered_matching_above_40_over_255():
    """At a mean std above 40/255 the HT stage matches on hard-thresholded
    2-D coefficients (thresholds from the coefficient stds)."""
    z, psd = _family("gw", var=0.04)
    assert np.sqrt(psd.mean() / N**2) > 40 / 255
    got = core.bm3d_colored(torch.from_numpy(z), psd, device=CPU)
    _close(got, _jax_colored(z, psd, torch.float64), ATOL[torch.float64])


def test_tie_image_gives_identical_matches(jax_f64_cov):
    """A piecewise-constant image with dyadic levels and no noise: exact
    distance ties everywhere; the colored core keeps JAX's order."""
    img = np.zeros((N, N))
    img[4:20, 6:26] = 0.5
    img[12:28, 2:14] = 0.25
    _, psd = _family("g1")
    got = core.bm3d_colored(torch.from_numpy(img), psd, exact=True, device=CPU)
    _close(got, _jax_colored(img, psd, torch.float64, exact=True), ATOL[torch.float64])


def test_batch_equals_single_images(jax_f64_cov):
    """Two images as one batch equal their single-image calls (the port's
    bit for bit, the JAX package's within 1e-9)."""
    _, psd = _family("g1")
    zs = np.stack([_family("g1", seed=s)[0] for s in range(2)])
    got = core.bm3d_colored(torch.from_numpy(zs), psd, exact=True, device=CPU)
    for i in range(2):
        single = core.bm3d_colored(torch.from_numpy(zs[i]), psd, exact=True, device=CPU)
        assert torch.equal(got[i], single)
        _close(got[i], _jax_colored(zs[i], psd, torch.float64, exact=True), ATOL[torch.float64])


# ---------------------------------------------------------------------------
# host decisions: the adaptive pilot, the spectral gate, the auto entry
# ---------------------------------------------------------------------------


def test_adaptive_pilot_lambda():
    psd, imgs = _narrowband()
    got = [core.adaptive_pilot_lambda(img, psd) for img in imgs]
    assert got == [jcore.adaptive_pilot_lambda(img, psd) for img in imgs] == [8.0, None, 8.0]
    _, psd_w = _family("gw")
    assert core.adaptive_pilot_lambda(imgs[0], psd_w) is None


def test_auto_with_per_image_pilots_equals_per_image_jax_calls(jax_f64_cov):
    """A batch whose images take different pilot thresholds (8 on the
    sparse one, the profile's on the textured one) equals the JAX package's
    single-image calls."""
    psd, imgs = _narrowband()
    rng = np.random.default_rng(5)
    zs = imgs[:2] + 0.05 * rng.standard_normal(imgs[:2].shape)
    assert [core.adaptive_pilot_lambda(z, psd) for z in zs] == [8.0, None]
    got = core.bm3d_colored_auto(torch.from_numpy(zs), psd, auto_params=False, device=CPU)
    for i in range(2):
        want = np.asarray(jcore.bm3d_colored_auto(jnp.asarray(zs[i]), psd, auto_params=False))
        _close(got[i], want, ATOL[torch.float64])


def test_spectral_gate_single_and_batched():
    """The gate in float64: each image equals JAX's, and for a batch the
    returned PSD is image 0's gate, as the JAX package returns it."""
    psd, imgs = _narrowband()
    yy, xx = np.mgrid[:N, :N]
    in_band = imgs[1] + 0.4 * np.cos(2 * np.pi * (6 * yy + 9 * xx) / N)  # signal in the hot bins
    zs = np.stack([imgs[1], in_band]) + 0.05 * np.random.default_rng(6).standard_normal((2, N, N))
    for dtype in (torch.float64, torch.float32):
        zg, psd_new = core.spectral_gate(torch.from_numpy(zs).to(dtype), psd, concentration=8.0)
        assert zg.dtype == dtype
        jzg, jpsd = jcore.spectral_gate(jnp.asarray(zs, JNP[dtype]), psd, concentration=8.0)
        _close(zg, jzg, ATOL[dtype])
        np.testing.assert_allclose(psd_new, jpsd, rtol=1e-12)
        for i in range(2):
            jzi, jpi = jcore.spectral_gate(jnp.asarray(zs[i], JNP[dtype]), psd, concentration=8.0)
            _close(zg[i], jzi, ATOL[dtype])
            if i == 0:
                np.testing.assert_allclose(psd_new, jpi, rtol=1e-12)
            else:
                assert not np.allclose(psd_new, jpi)


def test_auto_with_the_gate(jax_f64_cov):
    psd, imgs = _narrowband()
    z = imgs[1] + 0.05 * np.random.default_rng(7).standard_normal((N, N))
    got = core.bm3d_colored_auto(torch.from_numpy(z), psd, auto_params=False, gate_concentration=8.0, device=CPU)
    want = jcore.bm3d_colored_auto(jnp.asarray(z), psd, auto_params=False, gate_concentration=8.0)
    _close(got, want, ATOL[torch.float64])


def test_profile_fields_still_equal_the_jax_packages():
    for name in core.PROFILES:
        assert dataclasses.asdict(core.PROFILES[name]) == dataclasses.asdict(jcore.PROFILES[name])


def test_entry_points_need_the_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    z, psd = _family("gw")
    for fn in (lambda: core.bm3d_colored(z, psd), lambda: core.bm3d_colored_auto(z, psd, auto_params=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
