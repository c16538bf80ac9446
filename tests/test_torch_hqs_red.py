"""HQS and RED against the JAX package.

The same numpy k-space, mask and Flax-initialised narrow denoiser weights
go through both packages at 2 x 32 x 32 with 3-6 iterations. Tolerances:
float64 1e-9, float32 1e-4 (the JAX inputs are cast explicitly, since the
test configuration enables x64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdn
from pnp_admm_cnc_mri_tpu.solvers import hqs as jhqs
from pnp_admm_cnc_mri_tpu.solvers import red as jred
from pnp_admm_cnc_mri_torch import config
from pnp_admm_cnc_mri_torch.ops import prox, schedules
from pnp_admm_cnc_mri_torch.priors import denoiser as dn
from pnp_admm_cnc_mri_torch.solvers import hqs, red

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


def _scenario(b=2, h=32, w=32, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w))
    mask = (rng.random((h, w)) < 0.4).astype(np.float64)
    noise = 0.5 * (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))
    y = np.fft.fft2(img, axes=(-2, -1)) * mask + noise
    return img, mask.astype(REAL[dtype]), y.astype(CPLX[dtype])


def flax_tree(model, *inputs):
    variables = model.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))
    return jax.tree.map(np.asarray, dict(variables))


TREES = {
    "dncnn_25": (dict(nc=8, nb=3), lambda: flax_tree(jdncnn.DnCNN(out_nc=1, nc=8, nb=3),
                                                     np.zeros((1, 16, 16, 1), np.float32))),
    "drunet_gray": (dict(nc=8, nb=1), lambda: flax_tree(jdrunet.UNetRes(out_nc=1, nc=(8, 16, 32, 64), nb=1),
                                                        np.zeros((1, 16, 16, 2), np.float32))),
}


def _denoisers(name, dtype, iter_num, **kw):
    small, tree = TREES[name]
    args = dict(small, iter_num=iter_num, params=tree(), **kw)
    return (dn.build_denoiser(name, param_dtype=dtype, device=CPU, **args),
            jdn.build_denoiser(name, param_dtype=JNP[dtype], **args))


def _close(got, ref, atol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=what)


# -- HQS ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["drunet_gray", "dncnn_25"])
@DTYPES
def test_pnp_hqs_with_residuals_matches_jax(dtype, name):
    """DRUNet on TUNED_HQS_D's ladder (nlm 8, sigma255 10) with the x8 cycle,
    and DnCNN; the residuals ``||x - z||`` of each iteration too."""
    _, mask, y = _scenario(seed=1, dtype=dtype)
    it = 5
    tuned = config.TUNED_HQS_D["drunet_gray"]
    kw = dict(x8=True, noise_level_model=tuned["nlm"] / 255.0) if name == "drunet_gray" else {}
    ours, theirs = _denoisers(name, dtype, it, **kw)
    ladder = dict(sigma255=tuned["sigma255"], model_sigma1=49.0, model_sigma2=tuned["nlm"])
    z, res = hqs.pnp_hqs(y, mask, it, ours, dtype=dtype, collect_residuals=True, device=CPU, **ladder)
    jz, jres = jhqs.pnp_hqs(jnp.asarray(y), jnp.asarray(mask), it, theirs, dtype=JNP[dtype], collect_residuals=True,
                            **ladder)
    assert z.dtype == dtype and tuple(res.shape) == (it, 2)
    assert bool(((z >= 0) & (z <= 1)).all())
    _close(z, jz, ATOL[dtype], "z")
    _close(res, jres, ATOL[dtype] * 32, "residuals")


@DTYPES
def test_run_hqs_with_given_alphas_and_no_clamp_matches_jax(dtype):
    _, mask, y = _scenario(seed=2, dtype=dtype)
    alphas = np.linspace(0.05, 2.0, 6)
    den = lambda u, i: 1.3 * u - 0.01 * i  # noqa: E731 (leaves [0, 1] without the clamp)
    for clamp in (True, False):
        z, none = hqs.run_hqs(y, mask, 6, den, alphas, clamp=clamp, dtype=dtype, device=CPU)
        jz, _ = jhqs.run_hqs(jnp.asarray(y), jnp.asarray(mask), 6, den, alphas, clamp=clamp, dtype=JNP[dtype])
        assert none is None
        _close(z, jz, ATOL[dtype], f"clamp {clamp}")
    assert float(z.max()) > 1.0
    with pytest.raises(ValueError, match="alphas"):
        hqs.run_hqs(y, mask, 5, den, alphas, dtype=dtype, device=CPU)


def test_hqs_leading_batch_axes_equal_per_image_solves():
    _, mask, y = _scenario(b=4, seed=3)
    y = y.reshape(2, 2, 32, 32)
    den = lambda u, i: prox.soft(u, 2e-3)  # noqa: E731
    z, res = hqs.pnp_hqs(y, mask, 5, den, dtype=torch.float64, collect_residuals=True, device=CPU)
    assert tuple(z.shape) == (2, 2, 32, 32) and tuple(res.shape) == (5, 2, 2)
    for idx in ((0, 1), (1, 0)):
        one, one_res = hqs.pnp_hqs(y[idx], mask, 5, den, dtype=torch.float64, collect_residuals=True, device=CPU)
        _close(z[idx], one.numpy(), 1e-12)
        _close(res[(slice(None), *idx)], one_res.numpy(), 1e-12)


# -- RED ------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fp", "gd"])
@DTYPES
def test_run_red_with_residuals_matches_jax(dtype, variant):
    """DRUNet on TUNED_RED_D's constant sigma (model_sigma1 = nlm, as the
    CLI flattens the ladder), both variants, residuals ``||x - D(x)||``."""
    _, mask, y = _scenario(seed=4, dtype=dtype)
    nlm = config.TUNED_RED_D["drunet_gray"]["nlm"]
    ours, theirs = _denoisers("drunet_gray", dtype, 4, noise_level_model=nlm / 255.0, model_sigma1=nlm)
    kw = dict(lam=config.TUNED_RED_D["drunet_gray"]["lam"], step=0.9 if variant == "gd" else 1.0, variant=variant)
    x, res = red.run_red(y, mask, 4, ours, dtype=dtype, collect_residuals=True, device=CPU, **kw)
    jx, jres = jred.run_red(jnp.asarray(y), jnp.asarray(mask), 4, theirs, dtype=JNP[dtype], collect_residuals=True,
                            **kw)
    assert x.dtype == dtype and tuple(res.shape) == (4, 2)
    assert bool(((x >= 0) & (x <= 1)).all())
    _close(x, jx, ATOL[dtype], "x")
    _close(res, jres, ATOL[dtype] * 32, "residuals")


@pytest.mark.parametrize("variant", ["fp", "gd"])
def test_run_red_unclamped_batched_matches_jax(variant):
    _, mask, y = _scenario(b=3, seed=5)
    y = y.reshape(3, 1, 32, 32)
    den = lambda u, i: 0.8 * u + 0.05  # noqa: E731 (torch and jnp alike)
    x, res = red.run_red(y, mask, 6, den, lam=2.0, variant=variant, clamp=False, dtype=torch.float64,
                         collect_residuals=True, device=CPU)
    jx, jres = jred.run_red(jnp.asarray(y), jnp.asarray(mask), 6, den, lam=2.0, variant=variant, clamp=False,
                            dtype=jnp.float64, collect_residuals=True)
    assert tuple(res.shape) == (6, 3, 1)
    _close(x, jx, 1e-9)
    _close(res, jres, 1e-9)
    one, _ = red.run_red(y[1], mask, 6, den, lam=2.0, variant=variant, clamp=False, dtype=torch.float64, device=CPU)
    _close(x[1], one.numpy(), 1e-12)


def test_run_red_refuses_an_unknown_variant():
    _, mask, y = _scenario(b=1, h=8, w=8)
    with pytest.raises(ValueError, match="unknown RED variant 'admm'"):
        red.run_red(y, mask, 1, lambda u, i: u, variant="admm", device=CPU)
    with pytest.raises(ValueError, match="unknown RED variant"):
        jred.run_red(jnp.asarray(y), jnp.asarray(mask), 1, lambda u, i: u, variant="admm")


def test_hqs_ladder_is_dpir_rhos_in_the_working_dtype():
    rhos, _ = schedules.get_rho_sigma(sigma=10 / 255, iter_num=30, model_sigma1=49.0, model_sigma2=8.0)
    for dtype in (torch.float32, torch.float64):
        a = hqs.host_ladder(rhos, 30, dtype)
        assert a.dtype == REAL[dtype]
        np.testing.assert_array_equal(a, np.asarray(jnp.asarray(rhos, JNP[dtype])))
    assert a[0] < a[-1]  # the data pull weakens as the denoiser's sigma decays


def test_hqs_and_red_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, mask, y = _scenario(b=1, h=8, w=8)
    ident = lambda v, i: v  # noqa: E731
    for call in (lambda: hqs.pnp_hqs(y, mask, 1, ident), lambda: hqs.run_hqs(y, mask, 1, ident, [0.1]),
                 lambda: red.run_red(y, mask, 1, ident)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

