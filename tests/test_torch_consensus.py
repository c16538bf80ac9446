"""Single-device consensus solvers (ADMM, FISTA, HQS) against the JAX package.

Each of 2 images has 3 observations through 3 masks (2 x 3 x 32 x 32),
3-7 iterations; the priors are the L1 soft-threshold and Flax-initialised
narrow DRUNet weights carried by ``models/convert.py``. Tolerances:
float64 1e-9, float32 1e-4 (the JAX inputs are cast explicitly, since the
test configuration enables x64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu import config as jconfig
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.ops import prox as jprox
from pnp_admm_cnc_mri_tpu.parallel import consensus as jcons
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdn
from pnp_admm_cnc_mri_torch import config
from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.ops import prox
from pnp_admm_cnc_mri_torch.parallel import consensus
from pnp_admm_cnc_mri_torch.priors import denoiser as dn
from pnp_admm_cnc_mri_torch.solvers import hqs

CPU = "cpu"
ATOL = {torch.float64: 1e-9, torch.float32: 1e-4}
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


def _scenario(b=2, n=3, h=32, w=32, seed=0, dtype=torch.float64):
    """``b`` images, each seen through ``n`` masks with one noise draw:
    ys (b, n, h, w), masks (n, h, w)."""
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w))
    masks = (rng.random((n, h, w)) < 0.35).astype(np.float64)
    masks[:, 0, 0] = 1.0
    noise = 0.5 * (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))
    ys = np.fft.fft2(img, axes=(-2, -1))[:, None] * masks + noise
    return img, masks.astype(REAL[dtype]), ys.astype(CPLX[dtype])


def _drunet(dtype, iter_num, **kw):
    tree = jax.tree.map(np.asarray, dict(jdrunet.UNetRes(out_nc=1, nc=(8, 16, 32, 64), nb=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 2), jnp.float32))))
    args = dict(nc=8, nb=1, iter_num=iter_num, params=tree, **kw)
    return (dn.build_denoiser("drunet_gray", param_dtype=dtype, device=CPU, **args),
            jdn.build_denoiser("drunet_gray", param_dtype=JNP[dtype], **args))


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


# -- consensus-ADMM ---------------------------------------------------------------


@pytest.mark.parametrize("dc_method", ["auto", "matmul"])
@DTYPES
def test_run_consensus_with_state_matches_jax(dtype, dc_method):
    _, masks, ys = _scenario(seed=1, dtype=dtype)
    cfg = ADMMConfig(iter_num=6, rho=0.5, lam=0.1)
    z, x, w = consensus.run_consensus(ys, masks, cfg, dtype=dtype, dc_method=dc_method, return_state=True,
                                      device=CPU)
    ref = jcons.run_consensus(jnp.asarray(ys), jnp.asarray(masks), jconfig.ADMMConfig(iter_num=6, rho=0.5, lam=0.1),
                              dtype=JNP[dtype], dc_method=dc_method, return_state=True)
    assert tuple(z.shape) == (2, 32, 32) and tuple(x.shape) == tuple(w.shape) == (2, 3, 32, 32)
    for name, a, b in zip("zxw", (z, x, w), ref):
        _close(a, b, ATOL[dtype], name)
    z2, x2 = consensus.run_consensus(ys, masks, cfg, dtype=dtype, dc_method=dc_method, device=CPU)
    assert torch.equal(z2, z) and torch.equal(x2, x)


@DTYPES
def test_run_consensus_with_a_denoiser_prox_matches_jax(dtype):
    """TUNED_CONSENSUS_D's DRUNet setting (rho 1.2) with the clamped prox."""
    _, masks, ys = _scenario(seed=2, dtype=dtype)
    ours, theirs = _drunet(dtype, 4)
    rho = config.TUNED_CONSENSUS_D["drunet_gray"]["rho"]
    z, x = consensus.run_consensus(ys, masks, ADMMConfig(iter_num=4, rho=rho), dtype=dtype, device=CPU,
                                   z_prox=lambda v, i: prox.clip01(ours(v, i)))
    jz, jx = jcons.run_consensus(jnp.asarray(ys), jnp.asarray(masks), jconfig.ADMMConfig(iter_num=4, rho=rho),
                                 dtype=JNP[dtype], z_prox=lambda v, i: jnp.clip(theirs(v, i), 0.0, 1.0))
    _close(z, jz, ATOL[dtype], "z")
    _close(x, jx, ATOL[dtype], "x")


# -- consensus-FISTA --------------------------------------------------------------


@pytest.mark.parametrize("precondition", [True, False], ids=["precondition", "mean"])
@DTYPES
def test_run_consensus_fista_matches_jax(dtype, precondition):
    """The slice's path: DRUNet on TUNED_CONSENSUS_FISTA's ladder with the x8
    cycle, the clamped prox; the whole state with ``return_state``."""
    _, masks, ys = _scenario(seed=3, dtype=dtype)
    tuned = config.TUNED_CONSENSUS_FISTA["drunet_gray"]
    ours, theirs = _drunet(dtype, 4, x8=True, model_sigma1=tuned["model_sigma1"],
                           noise_level_model=tuned["nlm"] / 255.0)
    st = consensus.run_consensus_fista(ys, masks, 4, lambda i, u: prox.clip01(ours(u, i)), dtype=dtype,
                                       precondition=precondition, return_state=True, device=CPU)
    jst = jcons.run_consensus_fista(jnp.asarray(ys), jnp.asarray(masks), 4,
                                    lambda i, u: jnp.clip(theirs(u, i), 0.0, 1.0), dtype=JNP[dtype],
                                    precondition=precondition, return_state=True)
    assert tuple(st.x.shape) == (2, 32, 32) and st.x.dtype == dtype
    _close(st.x, jst.x, ATOL[dtype], "x")
    _close(st.v, jst.v, ATOL[dtype], "v")
    assert type(st.t) is REAL[dtype] and st.t == np.asarray(jst.t)
    x = consensus.run_consensus_fista(ys, masks, 4, lambda i, u: prox.clip01(ours(u, i)), dtype=dtype,
                                      precondition=precondition, device=CPU)
    assert torch.equal(x, st.x)


@pytest.mark.parametrize("precondition", [True, False], ids=["precondition", "mean"])
def test_consensus_fista_setup_matches_jax(precondition):
    _, masks, ys = _scenario(seed=4)
    ys[..., masks == 0] = np.nan  # read only where sampled
    got = consensus.consensus_fista_setup(torch.from_numpy(ys), torch.from_numpy(masks), precondition)
    ref = jcons.consensus_fista_setup(jnp.asarray(ys), jnp.asarray(masks), precondition)
    for name, a, b in zip(("m", "ysz", "cnt"), got, ref):
        assert tuple(a.shape) == np.shape(b), name
        _close(a, b, 0.0, name)
    assert not bool(torch.isnan(got[1]).any())


def test_run_consensus_fista_with_step_and_soft_prox_matches_jax():
    _, masks, ys = _scenario(seed=5)
    st = consensus.run_consensus_fista(ys, masks, 7, lambda i, u: prox.soft(u, 3e-3), step=0.7,
                                       dtype=torch.float64, return_state=True, device=CPU)
    jst = jcons.run_consensus_fista(jnp.asarray(ys), jnp.asarray(masks), 7, lambda i, u: jprox.soft(u, 3e-3),
                                    step=0.7, dtype=jnp.float64, return_state=True)
    _close(st.x, jst.x, 1e-9)
    _close(st.v, jst.v, 1e-9)


# -- consensus-HQS ----------------------------------------------------------------


@DTYPES
def test_run_consensus_hqs_matches_jax(dtype):
    """DRUNet on TUNED_CONSENSUS_HQS's ladder (nlm 8, sigma255 10) with x8."""
    _, masks, ys = _scenario(seed=6, dtype=dtype)
    tuned = config.TUNED_CONSENSUS_HQS["drunet_gray"]
    ours, theirs = _drunet(dtype, 4, x8=True, noise_level_model=tuned["nlm"] / 255.0)
    kw = dict(sigma255=tuned["sigma255"], model_sigma1=49.0, model_sigma2=tuned["nlm"])
    z = consensus.run_consensus_hqs(ys, masks, 4, ours, dtype=dtype, device=CPU, **kw)
    jz = jcons.run_consensus_hqs(jnp.asarray(ys), jnp.asarray(masks), 4, theirs, dtype=JNP[dtype], **kw)
    assert tuple(z.shape) == (2, 32, 32) and bool(((z >= 0) & (z <= 1)).all())
    _close(z, jz, ATOL[dtype])


@DTYPES
def test_run_consensus_hqs_with_given_alphas_matches_jax(dtype):
    _, masks, ys = _scenario(seed=7, dtype=dtype)
    alphas = np.linspace(0.9, 0.1, 7)
    z = consensus.run_consensus_hqs(ys, masks, 7, lambda u, i: prox.soft(u, 2e-3), alphas=alphas, clamp=False,
                                    dtype=dtype, device=CPU)
    jz = jcons.run_consensus_hqs(jnp.asarray(ys), jnp.asarray(masks), 7, lambda u, i: jprox.soft(u, 2e-3),
                                 alphas=alphas, clamp=False, dtype=JNP[dtype])
    _close(z, jz, ATOL[dtype])
    with pytest.raises(ValueError, match="alphas"):
        consensus.run_consensus_hqs(ys, masks, 6, lambda u, i: u, alphas=alphas, dtype=dtype, device=CPU)


def test_single_observation_consensus_hqs_is_run_hqs():
    """At N = 1 the joint solve is the single-mask HQS solve on the masked
    observation (consensus reads y only where sampled)."""
    _, masks, ys = _scenario(b=2, n=1, seed=8)
    den = lambda u, i: prox.soft(u, 2e-3)  # noqa: E731
    kw = dict(sigma255=12.0, model_sigma1=40.0, model_sigma2=10.0)
    z_c = consensus.run_consensus_hqs(ys, masks, 10, den, dtype=torch.float64, device=CPU, **kw)
    z_h, _ = hqs.pnp_hqs(ys[:, 0] * masks[0], masks[0], 10, den, dtype=torch.float64, device=CPU, **kw)
    _close(z_c, z_h.numpy(), 1e-9)


# -- leading batch axes -----------------------------------------------------------


@pytest.mark.parametrize("solver", ["admm", "fista", "hqs"])
def test_batched_solves_equal_per_image_solves(solver):
    _, masks, ys = _scenario(b=3, seed=9)
    den = lambda u, i: prox.soft(u, 2e-3)  # noqa: E731
    run = {
        "admm": lambda a: consensus.run_consensus(a, masks, ADMMConfig(iter_num=5, rho=0.5, lam=0.1),
                                                  dtype=torch.float64, device=CPU)[0],
        "fista": lambda a: consensus.run_consensus_fista(a, masks, 5, lambda i, u: den(u, i), dtype=torch.float64,
                                                         device=CPU),
        "hqs": lambda a: consensus.run_consensus_hqs(a, masks, 5, den, dtype=torch.float64, device=CPU),
    }[solver]
    both = run(ys)
    assert tuple(both.shape) == (3, 32, 32)
    for k in range(3):
        _close(both[k], run(ys[k]).numpy(), 1e-12, f"image {k}")


def test_consensus_solvers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, masks, ys = _scenario(b=1, h=8, w=8)
    for call in (lambda: consensus.run_consensus(ys, masks, ADMMConfig(iter_num=1)),
                 lambda: consensus.run_consensus_fista(ys, masks, 1, lambda i, u: u),
                 lambda: consensus.run_consensus_hqs(ys, masks, 1, lambda u, i: u)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
