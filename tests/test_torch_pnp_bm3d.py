"""BM3D as a PnP prior, and the solvers that take it, against the JAX package.

The same numpy k-space, mask and images go through both packages at
2 x 48 x 48 with 3 iterations, ``clamp=False`` for PnP-ADMM as the
reference's BM3D pipelines run it. JAX's BM3D is run in its tree form
(``core._STACK_FILTER_TREE``, compiled caches cleared around it), the form
the port runs; its CPU default, the matrix form, keeps its Haar matrices in
float32 (``tests/test_torch_bm3d.py``). Tolerances (max abs): one denoiser
call 1e-9 in float64 and 2e-5 in float32; 3-iteration solves 1e-8 in
float64, and 5e-4 (max) with 5e-6 (mean) in float32, where a float32
rounding can flip a threshold decision in any of the solve's BM3D calls
(measured: 1.3e-4 on 2 of 4,608 pixels of the PnP-CNC solve, two calls an
iteration). PnP-ADMM-L1-BM3D is precision-chaotic (a rounding grows about
2.7x an iteration), so whole solves are compared at 3 iterations.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu import config as jconfig
from pnp_admm_cnc_mri_tpu.ops import schedules as jschedules
from pnp_admm_cnc_mri_tpu.parallel import consensus as jcons
from pnp_admm_cnc_mri_tpu.priors import bm3d_prior as jbp
from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore
from pnp_admm_cnc_mri_tpu.solvers import admm as jadmm
from pnp_admm_cnc_mri_tpu.solvers import fista as jfista
from pnp_admm_cnc_mri_tpu.solvers import hqs as jhqs
from pnp_admm_cnc_mri_tpu.solvers import red as jred
from pnp_admm_cnc_mri_torch import config
from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.ops import prox, schedules
from pnp_admm_cnc_mri_torch.parallel import consensus
from pnp_admm_cnc_mri_torch.priors import bm3d_prior
from pnp_admm_cnc_mri_torch.solvers import admm, fista, hqs, red

CPU = "cpu"
N = 48
ITERS = 3
DENOISE_ATOL = {torch.float64: 1e-9, torch.float32: 2e-5}
SOLVE_ATOL = {torch.float64: 1e-8, torch.float32: 5e-4}
SOLVE_MEAN = {torch.float64: 1e-8, torch.float32: 5e-6}
CPLX = {torch.float64: np.complex128, torch.float32: np.complex64}
REAL = {torch.float64: np.float64, torch.float32: np.float32}
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def jax_tree_form():
    jax.clear_caches()
    jcore._STACK_FILTER_TREE = True
    yield
    jcore._STACK_FILTER_TREE = None
    jax.clear_caches()


def _images(b=2, n=N, seed=0):
    """Smooth discs on a flat background, in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    out = []
    for _ in range(b):
        f1, f2 = rng.uniform(4.0, 8.0, size=2)
        x = 0.5 + 0.3 * np.sin(xx / f1) * np.cos(yy / f2)
        out.append(np.where((xx - n / 2) ** 2 + (yy - n / 2) ** 2 < (n / 3) ** 2, x, 0.1))
    return np.stack(out)


def _scenario(b=2, seed=0, dtype=torch.float64, n_obs=None):
    rng = np.random.default_rng(seed + 100)
    img = _images(b, seed=seed)
    shape = (N, N) if n_obs is None else (n_obs, N, N)
    mask = (rng.random(shape) < 0.4).astype(np.float64)
    noise = 2.0 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    x = img if n_obs is None else img[:, None]
    y = np.fft.fft2(x, axes=(-2, -1)) * mask + noise
    return img, mask.astype(REAL[dtype]), y.astype(CPLX[dtype])


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


def _solve_close(got, ref, dtype, what=""):
    _close(got, ref, SOLVE_ATOL[dtype], what)
    assert float(np.abs(got.numpy() - np.asarray(ref)).mean()) <= SOLVE_MEAN[dtype], what


def _jcfg(cfg):
    return jconfig.ADMMConfig(**dataclasses.asdict(cfg))


def _noisy(dtype, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return (_images(b, seed=seed) + 0.1 * rng.standard_normal((b, N, N))).astype(REAL[dtype])


# -- the denoisers ------------------------------------------------------------------


@DTYPES
def test_bm3d_denoiser_matches_jax(dtype):
    v = _noisy(dtype)
    ours, theirs = bm3d_prior.make_bm3d_denoiser(noise_var=0.01), jbp.make_bm3d_denoiser(noise_var=0.01)
    got = ours(torch.as_tensor(v), 0)
    assert got.dtype == dtype and tuple(got.shape) == v.shape
    _close(got, theirs(jnp.asarray(v), 0), DENOISE_ATOL[dtype])
    _close(ours(torch.as_tensor(v[1]), 5), theirs(jnp.asarray(v[1]), 5), DENOISE_ATOL[dtype], "one image")
    ht = bm3d_prior.make_bm3d_denoiser(noise_var=0.01, stages="ht")
    _close(ht(torch.as_tensor(v), 0), jbp.make_bm3d_denoiser(noise_var=0.01, stages="ht")(jnp.asarray(v), 0),
           DENOISE_ATOL[dtype], "ht only")


@DTYPES
def test_bm3d_ladder_denoiser_matches_jax(dtype):
    v = _noisy(dtype, seed=2)
    _, sigmas = schedules.get_rho_sigma(sigma=10 / 255.0, iter_num=5, model_sigma1=49.0, model_sigma2=10.0)
    _, jsigmas = jschedules.get_rho_sigma(sigma=10 / 255.0, iter_num=5, model_sigma1=49.0, model_sigma2=10.0)
    np.testing.assert_array_equal(np.asarray(sigmas), np.asarray(jsigmas))
    ours, theirs = bm3d_prior.make_bm3d_ladder_denoiser(sigmas), jbp.make_bm3d_ladder_denoiser(jsigmas)
    for i in (0, 4):
        _close(ours(torch.as_tensor(v), i), theirs(jnp.asarray(v), i), DENOISE_ATOL[dtype], f"rung {i}")


@pytest.mark.parametrize("chunk", [1, 2, 3, 4])
def test_chunked_batches_equal_single_image_calls(chunk):
    """3 images (2 x 3 leading axes for the ladder), ``batch_chunk`` at a
    time, padding-free: every image equals its own call."""
    v = torch.as_tensor(_noisy(torch.float32, b=3, seed=3))
    one = bm3d_prior.make_bm3d_denoiser(noise_var=0.01, batch_chunk=1)
    den = bm3d_prior.make_bm3d_denoiser(noise_var=0.01, batch_chunk=chunk)
    out = den(v, 0)
    for i in range(3):
        assert float((out[i] - one(v[i], 0)).abs().max()) <= 2e-6
    lad = bm3d_prior.make_bm3d_ladder_denoiser([0.12, 0.08], batch_chunk=chunk)
    v2 = torch.cat([v, v.flip(-1)]).reshape(2, 3, N, N)
    out2 = lad(v2, 1)
    assert tuple(out2.shape) == (2, 3, N, N)
    assert float((out2[1, 0] - lad(v2[1, 0], 1)).abs().max()) <= 2e-6


def test_default_batch_chunk_is_a_positive_int():
    assert isinstance(bm3d_prior.default_batch_chunk(), int) and bm3d_prior.default_batch_chunk() >= 1


# -- PnP-ADMM, the reference's two BM3D pipelines -------------------------------------


@DTYPES
@pytest.mark.parametrize("scheme", ["l1", "cnc"])
def test_pnp_admm_bm3d_matches_jax(dtype, scheme):
    """``PNP_L1_BM3D_DEFAULT`` / ``PNP_CNC_BM3D_DEFAULT`` (the same denoiser
    in both CNC slots) at 3 iterations, the default sigma sqrt(0.03),
    ``clamp=False``; the whole state."""
    _, mask, y = _scenario(seed=4 if scheme == "l1" else 5, dtype=dtype)
    base = config.PNP_L1_BM3D_DEFAULT if scheme == "l1" else config.PNP_CNC_BM3D_DEFAULT
    cfg = dataclasses.replace(base, iter_num=ITERS)
    ours, theirs = bm3d_prior.make_bm3d_denoiser(), jbp.make_bm3d_denoiser()
    if scheme == "l1":
        got, _ = admm.pnp_admm_l1(y, mask, cfg, ours, clamp=False, dtype=dtype, device=CPU)
        ref, _ = jadmm.pnp_admm_l1(jnp.asarray(y), jnp.asarray(mask), _jcfg(cfg), theirs, clamp=False,
                                   dtype=JNP[dtype])
    else:
        got, _ = admm.pnp_admm_cnc(y, mask, cfg, ours, clamp=False, dtype=dtype, device=CPU)
        ref, _ = jadmm.pnp_admm_cnc(jnp.asarray(y), jnp.asarray(mask), _jcfg(cfg), theirs, clamp=False,
                                    dtype=JNP[dtype])
    assert got.x.dtype == dtype and tuple(got.x.shape) == (2, N, N)
    for name in ("x", "z", "w"):
        _solve_close(getattr(got, name), getattr(ref, name), dtype, name)


@pytest.mark.parametrize("key", ["pnp_l1_bm3d", "pnp_cnc_bm3d"])
def test_tuned_bm3d_pipelines_match_jax(key):
    """``TUNED_BM3D``: 3 and 4 iterations at nlm 15 and 25, float64."""
    _, mask, y = _scenario(seed=6)
    row = dict(config.TUNED_BM3D[key])
    nlm = row.pop("nlm")
    base = config.PNP_L1_BM3D_DEFAULT if key == "pnp_l1_bm3d" else config.PNP_CNC_BM3D_DEFAULT
    cfg = dataclasses.replace(base, **row)
    var = (nlm / 255.0) ** 2
    ours, theirs = bm3d_prior.make_bm3d_denoiser(noise_var=var), jbp.make_bm3d_denoiser(noise_var=var)
    f, jf = (admm.pnp_admm_l1, jadmm.pnp_admm_l1) if key == "pnp_l1_bm3d" else (admm.pnp_admm_cnc, jadmm.pnp_admm_cnc)
    got, _ = f(y, mask, cfg, ours, clamp=False, dtype=torch.float64, device=CPU)
    ref, _ = jf(jnp.asarray(y), jnp.asarray(mask), _jcfg(cfg), theirs, clamp=False, dtype=jnp.float64)
    _solve_close(got.x, ref.x, torch.float64)


# -- the other solver families with BM3D ------------------------------------------


@DTYPES
def test_pnp_fista_bm3d_matches_jax(dtype):
    """``TUNED_FISTA_D['bm3d']``'s sigma (nlm 15), 3 iterations."""
    _, mask, y = _scenario(seed=7, dtype=dtype)
    var = (config.TUNED_FISTA_D["bm3d"]["nlm"] / 255.0) ** 2
    got, _ = fista.pnp_fista(y, mask, ITERS, bm3d_prior.make_bm3d_denoiser(noise_var=var), dtype=dtype, device=CPU)
    ref, _ = jfista.pnp_fista(jnp.asarray(y), jnp.asarray(mask), ITERS, jbp.make_bm3d_denoiser(noise_var=var),
                              dtype=JNP[dtype])
    _solve_close(got.x, ref.x, dtype, "x")
    _solve_close(got.v, ref.v, dtype, "v")


@DTYPES
def test_pnp_hqs_bm3d_ladder_matches_jax(dtype):
    """``TUNED_HQS_D['bm3d']`` (nlm 10, sigma255 10) with the ladder denoiser."""
    _, mask, y = _scenario(seed=8, dtype=dtype)
    row = config.TUNED_HQS_D["bm3d"]
    ladder = dict(sigma255=row["sigma255"], model_sigma1=49.0, model_sigma2=row["nlm"])
    _, sigmas = schedules.get_rho_sigma(sigma=row["sigma255"] / 255.0, iter_num=ITERS, model_sigma1=49.0,
                                        model_sigma2=row["nlm"])
    z, _ = hqs.pnp_hqs(y, mask, ITERS, bm3d_prior.make_bm3d_ladder_denoiser(sigmas), dtype=dtype, device=CPU,
                       **ladder)
    jz, _ = jhqs.pnp_hqs(jnp.asarray(y), jnp.asarray(mask), ITERS, jbp.make_bm3d_ladder_denoiser(sigmas),
                         dtype=JNP[dtype], **ladder)
    _solve_close(z, jz, dtype)


def test_pnp_pgd_cnc_bm3d_matches_jax():
    """``TUNED_PGD_CNC['bm3d']`` (alpha 1, lam 0.02, b 36, nlm 25), float64."""
    _, mask, y = _scenario(seed=9)
    row = config.TUNED_PGD_CNC["bm3d"]
    var = (row["nlm"] / 255.0) ** 2
    kw = dict(alpha=row["alpha"], lam=row["lam"], b=row["b"])
    got, _ = fista.pnp_pgd_cnc(y, mask, ITERS, bm3d_prior.make_bm3d_denoiser(noise_var=var), device=CPU,
                               dtype=torch.float64, **kw)
    ref, _ = jfista.pnp_pgd_cnc(jnp.asarray(y), jnp.asarray(mask), ITERS, jbp.make_bm3d_denoiser(noise_var=var),
                                dtype=jnp.float64, **kw)
    _solve_close(got.x, ref.x, torch.float64)


def test_red_bm3d_matches_jax():
    """``TUNED_RED_D['bm3d']`` (lam 0.3, nlm 15), float64."""
    _, mask, y = _scenario(seed=10)
    row = config.TUNED_RED_D["bm3d"]
    var = (row["nlm"] / 255.0) ** 2
    got, _ = red.run_red(y, mask, ITERS, bm3d_prior.make_bm3d_denoiser(noise_var=var), lam=row["lam"],
                         dtype=torch.float64, device=CPU)
    ref, _ = jred.run_red(jnp.asarray(y), jnp.asarray(mask), ITERS, jbp.make_bm3d_denoiser(noise_var=var),
                          lam=row["lam"], dtype=jnp.float64)
    _solve_close(got, ref, torch.float64)


def test_consensus_fista_bm3d_matches_jax():
    """``TUNED_CONSENSUS_FISTA['bm3d']`` (nlm 15), 3 observations an image,
    the clamped prox, float64."""
    _, masks, ys = _scenario(seed=11, n_obs=3)
    var = (config.TUNED_CONSENSUS_FISTA["bm3d"]["nlm"] / 255.0) ** 2
    ours, theirs = bm3d_prior.make_bm3d_denoiser(noise_var=var), jbp.make_bm3d_denoiser(noise_var=var)
    x = consensus.run_consensus_fista(ys, masks, ITERS, lambda i, u: prox.clip01(ours(u, i)), dtype=torch.float64,
                                      device=CPU)
    jx = jcons.run_consensus_fista(jnp.asarray(ys), jnp.asarray(masks), ITERS,
                                   lambda i, u: jnp.clip(theirs(u, i), 0.0, 1.0), dtype=jnp.float64)
    assert tuple(x.shape) == (2, N, N)
    _solve_close(x, jx, torch.float64)


def test_bm3d_settings_equal_the_jax_packages():
    for name in ("PNP_L1_BM3D_DEFAULT", "PNP_CNC_BM3D_DEFAULT"):
        assert dataclasses.asdict(getattr(config, name)) == dataclasses.asdict(getattr(jconfig, name)), name
    assert config.TUNED_BM3D == jconfig.TUNED_BM3D
    assert isinstance(config.PNP_L1_BM3D_DEFAULT, ADMMConfig)
