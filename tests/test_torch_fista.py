"""FISTA, PGD and their PnP variants against the JAX package.

The same numpy k-space, mask and Flax-initialised narrow denoiser weights
(carried by ``models/convert.py``) go through both packages at 2 x 32 x 32
with 3-8 iterations. Tolerances: float64 1e-9, float32 1e-4 (the JAX
inputs are cast explicitly, since the test configuration enables x64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu import config as jconfig
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.ops import fourier as jfourier
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdn
from pnp_admm_cnc_mri_tpu.solvers import fista as jfista
from pnp_admm_cnc_mri_torch import config
from pnp_admm_cnc_mri_torch.ops import fourier
from pnp_admm_cnc_mri_torch.priors import denoiser as dn
from pnp_admm_cnc_mri_torch.solvers import fista

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


def _assert_states(got, ref, atol):
    _close(got.x, ref.x, atol, "x")
    _close(got.v, ref.v, atol, "v")
    assert type(got.t) is REAL[got.x.dtype]
    np.testing.assert_allclose(got.t, np.asarray(ref.t), rtol=1e-15 if got.x.dtype == torch.float64 else 1e-7)


@DTYPES
def test_data_term_gradient_matches_jax(dtype):
    _, mask, y = _scenario(seed=1, dtype=dtype)
    x = np.random.default_rng(1).random((2, 32, 32)).astype(REAL[dtype])
    got = fourier.data_term_gradient(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    ref = jfourier.data_term_gradient(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    assert got.dtype == torch.from_numpy(y).dtype and tuple(got.shape) == (2, 32, 32)
    _close(got, ref, ATOL[dtype] * 1e-3 if dtype == torch.float64 else 1e-5)
    # y is read only where the mask samples: NaN elsewhere changes nothing
    y_nan = y.copy()
    y_nan[..., mask == 0] = np.nan
    again = fourier.data_term_gradient(torch.from_numpy(x), torch.from_numpy(y_nan), torch.from_numpy(mask))
    assert torch.equal(again, got)


@pytest.mark.parametrize("momentum", [True, False], ids=["fista", "ista"])
@DTYPES
def test_fista_l1_with_objective_matches_jax(dtype, momentum):
    _, mask, y = _scenario(seed=2, dtype=dtype)
    got, obj = fista.fista_l1(y, mask, 8, lam=1e-2, momentum=momentum, dtype=dtype, collect_objective=True,
                              device=CPU)
    ref, jobj = jfista.fista_l1(jnp.asarray(y), jnp.asarray(mask), 8, lam=1e-2, momentum=momentum, dtype=JNP[dtype],
                                collect_objective=True)
    assert got.x.dtype == dtype and tuple(obj.shape) == (8, 2)
    _assert_states(got, ref, ATOL[dtype])
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), rtol=1e-12 if dtype == torch.float64 else 1e-5)
    assert fista.fista_l1(y, mask, 2, dtype=dtype, device=CPU)[1] is None


@pytest.mark.parametrize("step", [0.6, 1.0])
def test_pgd_l1_matches_jax_and_its_objective_descends(step):
    """ISTA's full objective (data term plus L1 penalty) is non-increasing
    at step <= 1, as the JAX package's tests pin."""
    _, mask, y = _scenario(seed=3)
    got, obj = fista.pgd_l1(y, mask, 8, lam=2e-2, step=step, dtype=torch.float64, collect_objective=True, device=CPU)
    ref, jobj = jfista.pgd_l1(jnp.asarray(y), jnp.asarray(mask), 8, lam=2e-2, step=step, dtype=jnp.float64,
                              collect_objective=True)
    _assert_states(got, ref, 1e-9)
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), rtol=1e-12)
    assert got.t == 1.0
    assert bool((obj[1:] <= obj[:-1] * (1 + 1e-12)).all()), obj
    same, _ = fista.fista_l1(y, mask, 8, lam=2e-2, step=step, momentum=False, dtype=torch.float64, device=CPU)
    assert torch.equal(same.x, got.x)


def test_fista_momentum_sequence_and_extrapolation_match_jax():
    rng = np.random.default_rng(4)
    x_old, x_new = rng.random((2, 3, 8, 8))
    for dtype in (torch.float64, torch.float32):
        t, jt = fista.host_scalar(1.0, dtype), jnp.asarray(1.0, JNP[dtype])
        a, b = torch.from_numpy(x_old).to(dtype), torch.from_numpy(x_new).to(dtype)
        for _ in range(30):
            t_new, v = fista.fista_extrapolate(a, b, t)
            jt_new, jv = jfista.fista_extrapolate(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jt)
            assert t_new.dtype == REAL[dtype] and t_new == np.asarray(jt_new), (t_new, jt_new)
            _close(v, jv, 1e-15 if dtype == torch.float64 else 1e-6)
            t, jt = t_new, jt_new


def test_data_objective_matches_jax():
    _, mask, y = _scenario(seed=5)
    x = np.random.default_rng(5).random((2, 32, 32))
    got = fista.data_objective(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    ref = jfista.data_objective(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


@pytest.mark.parametrize("name,dtype", [("dncnn_25", torch.float64), ("drunet_gray", torch.float64),
                                        ("dncnn_25", torch.float32), ("drunet_gray", torch.float32)])
def test_pnp_fista_matches_jax(name, dtype):
    """The slice's path: DRUNet with the x8 cycle on TUNED_FISTA_D's ladder
    (model_sigma1 15, nlm 12), and DnCNN."""
    _, mask, y = _scenario(seed=6, dtype=dtype)
    tuned = config.TUNED_FISTA_D[name]
    kw = dict(x8=True, model_sigma1=tuned["model_sigma1"], noise_level_model=tuned["nlm"] / 255.0) \
        if name == "drunet_gray" else {}
    ours, theirs = _denoisers(name, dtype, 4, **kw)
    got, _ = fista.pnp_fista(y, mask, 4, ours, dtype=dtype, device=CPU)
    ref, _ = jfista.pnp_fista(jnp.asarray(y), jnp.asarray(mask), 4, theirs, dtype=JNP[dtype])
    assert bool(((got.x >= 0) & (got.x <= 1)).all())
    _assert_states(got, ref, ATOL[dtype])


@DTYPES
def test_pnp_pgd_matches_jax(dtype):
    _, mask, y = _scenario(seed=7, dtype=dtype)
    ours, theirs = _denoisers("dncnn_25", dtype, 4)
    for clamp in (True, False):
        got, _ = fista.pnp_pgd(y, mask, 4, ours, step=0.8, clamp=clamp, dtype=dtype, device=CPU)
        ref, _ = jfista.pnp_pgd(jnp.asarray(y), jnp.asarray(mask), 4, theirs, step=0.8, clamp=clamp,
                                dtype=JNP[dtype])
        _assert_states(got, ref, ATOL[dtype])
        assert torch.equal(got.x, got.v)


@pytest.mark.parametrize("two", [False, True], ids=["one_denoiser", "two_denoisers"])
@DTYPES
def test_pnp_pgd_cnc_matches_jax(dtype, two):
    _, mask, y = _scenario(seed=8, dtype=dtype)
    d1, j1 = _denoisers("drunet_gray", dtype, 3)
    d2, j2 = _denoisers("dncnn_25", dtype, 3) if two else (None, None)
    kw = dict(alpha=1.0, lam=0.05, b=36.0, step=1.0)
    got, _ = fista.pnp_pgd_cnc(y, mask, 3, d1, d2, dtype=dtype, device=CPU, **kw)
    ref, _ = jfista.pnp_pgd_cnc(jnp.asarray(y), jnp.asarray(mask), 3, j1, j2, dtype=JNP[dtype], **kw)
    _assert_states(got, ref, ATOL[dtype])


def test_leading_batch_axes_equal_per_image_solves():
    _, mask, y = _scenario(b=6, seed=9)
    y = y.reshape(2, 3, 32, 32)
    both, obj = fista.fista_l1(y, mask, 6, lam=1e-2, dtype=torch.float64, collect_objective=True, device=CPU)
    assert tuple(both.x.shape) == (2, 3, 32, 32) and tuple(obj.shape) == (6, 2, 3)
    for idx in ((0, 0), (1, 2)):
        one, one_obj = fista.fista_l1(y[idx], mask, 6, lam=1e-2, dtype=torch.float64, collect_objective=True,
                                      device=CPU)
        _close(both.x[idx], one.x.numpy(), 1e-12)
        _close(obj[(slice(None), *idx)], one_obj.numpy(), 1e-12)


@pytest.mark.parametrize("name", ["TUNED_FISTA_D", "TUNED_HQS_D", "TUNED_RED_D", "TUNED_PGD_L1", "TUNED_PGD_D",
                                  "TUNED_PGD_CNC", "TUNED_CONSENSUS_D", "TUNED_CONSENSUS_D_CLEAN",
                                  "TUNED_CONSENSUS_FISTA", "TUNED_CONSENSUS_HQS"])
def test_solver_tables_equal_the_jax_packages(name):
    assert getattr(config, name) == getattr(jconfig, name)


def test_fista_solvers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, mask, y = _scenario(b=1, h=8, w=8)
    ident = lambda v, i: v  # noqa: E731
    for call in (lambda: fista.fista_l1(y, mask, 1), lambda: fista.pgd_l1(y, mask, 1),
                 lambda: fista.pnp_fista(y, mask, 1, ident), lambda: fista.pnp_pgd(y, mask, 1, ident),
                 lambda: fista.pnp_pgd_cnc(y, mask, 1, ident), lambda: fista.run_fista(y, mask, 1, lambda i, u: u)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
