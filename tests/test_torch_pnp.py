"""PnP-ADMM and the rest of the classical solver against the JAX package.

End-to-end solves on the same numpy k-space, mask and Flax-initialised
denoiser weights (reduced widths, 2 x 32 x 32, 3-5 iterations), and the
classical remainder: adaptive rho, the (rho, lam)
grid solve, the complex PSNR and ``all_metrics``, the configuration
tables. Tolerances: float64 1e-9, float32 1e-4 (float32 convs round
differently in XLA and in torch's CPU backend; the [0, 1] clamps keep the
difference from growing over the iterations).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu import config as jconfig
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.models import ffdnet as jffdnet
from pnp_admm_cnc_mri_tpu.ops import metrics as jmetrics
from pnp_admm_cnc_mri_tpu.ops import prox as jprox
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdn
from pnp_admm_cnc_mri_tpu.solvers import admm as jadmm
from pnp_admm_cnc_mri_torch import config
from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.ops import metrics, prox
from pnp_admm_cnc_mri_torch.priors import denoiser as dn
from pnp_admm_cnc_mri_torch.solvers import admm

CPU = "cpu"
ATOL = {torch.float64: 1e-9, torch.float32: 1e-4}
CPLX = {torch.float64: np.complex128, torch.float32: np.complex64}
REAL = {torch.float64: np.float64, torch.float32: np.float32}
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
ITERS = 4


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
    return img, mask.astype(REAL[dtype]), y.astype(CPLX[dtype]), noise


def _jcfg(cfg):
    return jconfig.ADMMConfig(**dataclasses.asdict(cfg))


def flax_tree(model, *inputs):
    variables = model.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))
    return jax.tree.map(np.asarray, dict(variables))


def _zeros(c):
    return np.zeros((1, 16, 16, c), np.float32)


TREES = {
    "dncnn_25": (dict(nc=8, nb=3), lambda: flax_tree(jdncnn.DnCNN(out_nc=1, nc=8, nb=3), _zeros(1))),
    "dncnn_15": (dict(nc=8, nb=3), lambda: jax.tree.map(lambda a: 0.7 * a, flax_tree(
        jdncnn.DnCNN(out_nc=1, nc=8, nb=3), _zeros(1)))),
    "fdncnn_gray": (dict(nc=8, nb=4), lambda: flax_tree(jdncnn.FDnCNN(out_nc=1, nc=8, nb=4), _zeros(2))),
    "ircnn_gray": (dict(nc=4), lambda: jax.tree.map(
        lambda a: np.stack([a * (1.0 + 0.02 * k) for k in range(25)]),
        flax_tree(jdncnn.IRCNN(out_nc=1, nc=4), _zeros(1)))),
    "ffdnet_gray": (dict(nc=8, nb=4), lambda: flax_tree(jffdnet.FFDNet(out_nc=1, nc=8, nb=4), _zeros(1),
                                                        np.float32(0.1))),
    "drunet_gray": (dict(nc=8, nb=1), lambda: flax_tree(jdrunet.UNetRes(out_nc=1, nc=(8, 16, 32, 64), nb=1),
                                                        _zeros(2))),
}


def _denoisers(name, dtype, **kw):
    small, tree = TREES[name]
    args = dict(small, iter_num=ITERS, params=tree(), **kw)
    return (dn.build_denoiser(name, param_dtype=dtype, device=CPU, **args),
            jdn.build_denoiser(name, param_dtype=JNP[dtype], **args))


def _assert_states(got, ref, atol):
    for name, a, b in zip("xzw", got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("name,dtype", [(n, torch.float64) for n in TREES if n != "dncnn_15"]
                         + [("dncnn_25", torch.float32), ("drunet_gray", torch.float32)])
def test_pnp_admm_l1_matches_jax(name, dtype):
    _, mask, y, noise = _scenario(dtype=dtype)
    ours, theirs = _denoisers(name, dtype, noises=noise)
    cfg = ADMMConfig(iter_num=ITERS, rho=config.PNP_L1_DEFAULTS[name][1])
    got, _ = admm.pnp_admm_l1(y, mask, cfg, ours, dtype=dtype, device=CPU)
    ref, _ = jadmm.pnp_admm_l1(jnp.asarray(y), jnp.asarray(mask), _jcfg(cfg), theirs, dtype=JNP[dtype])
    assert got.x.dtype == dtype and bool(((got.x >= 0) & (got.x <= 1)).all())
    _assert_states(got, ref, ATOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_pnp_admm_cnc_drunet_x8_matches_jax(dtype):
    """The slice's path: DRUNet in both threshold slots, the x8 cycle, the
    reference's 【6】 DRUNet defaults."""
    _, mask, y, _ = _scenario(seed=1, dtype=dtype)
    ours, theirs = _denoisers("drunet_gray", dtype, x8=True)
    alpha, _, lam, rho, b = config.PNP_CNC_DEFAULTS["drunet_gray"]
    cfg = ADMMConfig(iter_num=ITERS, rho=rho, lam=lam, alpha=alpha, b=b)
    got, res = admm.pnp_admm_cnc(y, mask, cfg, ours, dtype=dtype, device=CPU, collect_residuals=True)
    ref, jres = jadmm.pnp_admm_cnc(jnp.asarray(y), jnp.asarray(mask), _jcfg(cfg), theirs, dtype=JNP[dtype],
                                   collect_residuals=True)
    _assert_states(got, ref, ATOL[dtype])
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=0, atol=ATOL[dtype] * 32)


def test_pnp_admm_cnc_two_checkpoints_match_jax():
    """``denoise2`` differs from ``denoise1`` (the reference's two-checkpoint
    DnCNN pair), and without the clamp."""
    _, mask, y, _ = _scenario(seed=2)
    d1, j1 = _denoisers("dncnn_25", torch.float64)
    d2, j2 = _denoisers("dncnn_15", torch.float64)
    alpha, _, lam, rho, b = config.PNP_CNC_DEFAULTS["dncnn_pair"]
    cfg = ADMMConfig(iter_num=3, rho=rho, lam=lam, alpha=alpha, b=b)
    for clamp in (True, False):
        got, _ = admm.pnp_admm_cnc(y, mask, cfg, d1, d2, clamp=clamp, dtype=torch.float64, device=CPU)
        ref, _ = jadmm.pnp_admm_cnc(jnp.asarray(y), jnp.asarray(mask), _jcfg(cfg), j1, j2, clamp=clamp,
                                    dtype=jnp.float64)
        _assert_states(got, ref, 1e-9)
    one, _ = admm.pnp_admm_cnc(y, mask, cfg, d1, dtype=torch.float64, device=CPU)
    assert not torch.equal(one.x, admm.pnp_admm_cnc(y, mask, cfg, d1, d2, dtype=torch.float64, device=CPU)[0].x)


def test_pnp_admm_l1_adaptive_matches_jax():
    _, mask, y, _ = _scenario(seed=3)
    ours, theirs = _denoisers("ircnn_gray", torch.float64)
    cfg = ADMMConfig(iter_num=ITERS, rho=0.3)
    got, (rhos, deltas) = admm.pnp_admm_l1_adaptive(y, mask, cfg, ours, gamma=1.5, eta=0.9,
                                                    dtype=torch.float64, collect=True, device=CPU)
    ref, (jrhos, jdeltas) = jadmm.pnp_admm_l1_adaptive(jnp.asarray(y), jnp.asarray(mask), _jcfg(cfg), theirs,
                                                       gamma=1.5, eta=0.9, dtype=jnp.float64, collect=True)
    _assert_states(got, ref, 1e-9)
    np.testing.assert_allclose(rhos.numpy(), np.asarray(jrhos), rtol=0, atol=1e-12)
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jdeltas), rtol=0, atol=1e-9)


def test_admm_step_clamps_x_z_and_w_as_jax():
    _, mask, y, _ = _scenario(b=1, seed=4)
    state = admm.ADMMState(*(torch.from_numpy(a) for a in np.random.default_rng(4).normal(size=(3, 1, 32, 32))))
    jstate = jadmm.ADMMState(*(jnp.asarray(a.numpy()) for a in state))
    yt, mt = torch.from_numpy(y), torch.from_numpy(mask)
    got = admm.admm_step(state, 0, yt, mt, 0.5, lambda i, x, z, w: 1.5 * (x + w), clamp=True)
    ref = jadmm.admm_step(jstate, 0, jnp.asarray(y), jnp.asarray(mask), 0.5, lambda i, x, z, w: 1.5 * (x + w),
                          clamp=True)
    _assert_states(got, ref, 1e-12)
    assert all(float(a.min()) >= 0.0 and float(a.max()) <= 1.0 for a in got)


# -- the classical remainder ---------------------------------------------------


def test_adaptive_rho_matches_jax_and_reduces_to_fixed_rho():
    _, mask, y, _ = _scenario(b=3, seed=6)
    cfg = dataclasses.replace(config.ADMM_L1_DEFAULT, iter_num=8)
    got, (rhos, deltas) = admm.admm_l1_adaptive(y, mask, cfg, gamma=1.3, eta=0.9, dtype=torch.float64,
                                                collect=True, device=CPU)
    ref, (jrhos, jdeltas) = jadmm.admm_l1_adaptive(jnp.asarray(y), jnp.asarray(mask), _jcfg(cfg), gamma=1.3,
                                                   eta=0.9, dtype=jnp.float64, collect=True)
    _assert_states(got, ref, 1e-9)
    assert tuple(rhos.shape) == (8, 3) and float(rhos[-1].min()) < cfg.rho  # rho moved
    np.testing.assert_allclose(rhos.numpy(), np.asarray(jrhos), rtol=0, atol=1e-15)
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jdeltas), rtol=0, atol=1e-9)
    fixed, _ = admm.admm_l1_adaptive(y, mask, cfg, gamma=1.0, dtype=torch.float64, device=CPU)
    plain, _ = admm.admm_l1(y, mask, cfg, dtype=torch.float64, fused=False, use_rfft=False, device=CPU)
    _assert_states(fixed, plain, 1e-12)
    assert admm.admm_l1_adaptive(y, mask, cfg, dtype=torch.float64, device=CPU)[1] is None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_grid_solve_matches_vmapped_jax(dtype):
    """A (rho, lam) grid of 3 over a batch of 2: (3, 2, H, W) in one solve."""
    _, mask, y, _ = _scenario(seed=7, dtype=dtype)
    rhos = np.array([0.015, 0.05, 0.2], REAL[dtype])
    lams = np.array([0.1, 0.3, 0.05], REAL[dtype])
    got = admm.admm_l1_jit(y, mask, 6, torch.from_numpy(rhos)[:, None], torch.from_numpy(lams)[:, None],
                           device=CPU)
    grid = jax.vmap(lambda r, l: jadmm.admm_l1_jit(jnp.asarray(y), jnp.asarray(mask), 6, r, l))
    ref = np.asarray(grid(jnp.asarray(rhos), jnp.asarray(lams)))
    assert tuple(got.shape) == (3, 2, 32, 32) and got.dtype == dtype
    atol = 1e-9 if dtype == torch.float64 else 5e-3  # float32: test_pallas.py's solver budget
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)
    one = admm.admm_l1_jit(y, mask, 6, float(rhos[1]), float(lams[1]), device=CPU)
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=0, atol=1e-12 if dtype == torch.float64 else 1e-6)


def test_complex_psnr_and_all_metrics_match_jax():
    rng = np.random.default_rng(8)
    truth = np.round(rng.random((2, 24, 20)) * 255)
    recon = np.clip(truth / 255 + 0.05 * rng.normal(size=truth.shape), 0, 1)
    zf = truth + 3.0 * (rng.normal(size=truth.shape) + 1j * rng.normal(size=truth.shape))
    got = metrics.psnr_complex(torch.from_numpy(zf), torch.from_numpy(truth)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmetrics.psnr_complex(jnp.asarray(zf), jnp.asarray(truth))),
                               rtol=1e-12)
    for border in (0, 3):
        got = metrics.all_metrics(torch.from_numpy(recon), torch.from_numpy(truth), border)
        ref = jmetrics.all_metrics(jnp.asarray(recon), jnp.asarray(truth), border)
        assert got.keys() == ref.keys()
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12, atol=1e-12, err_msg=k)


def test_config_tables_equal_the_jax_packages():
    for name in ("PNP_L1_DEFAULTS", "PNP_CNC_DEFAULTS", "TUNED_PNP_L1", "TUNED_PNP_CNC", "TUNED_PNP_L1_CLEAN",
                 "TUNED_PNP_CNC_CLEAN", "TUNED_BM3D", "MASK_NAMES"):
        assert getattr(config, name) == getattr(jconfig, name), name
    for name in ("ADMM_L1_DEFAULT", "ADMM_CNC_DEFAULT"):
        assert dataclasses.asdict(getattr(config, name)) == dataclasses.asdict(getattr(jconfig, name)), name
    assert dataclasses.asdict(config.DenoiserConfig()) == dataclasses.asdict(jconfig.DenoiserConfig())
    cfg = config.DenoiserConfig(model_name="drunet_gray", x8=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfig.DenoiserConfig(model_name="drunet_gray", x8=True))


def test_cnc_generalized_update_matches_jax():
    z, v, s = np.random.default_rng(9).normal(size=(3, 2, 8, 8))
    got = prox.cnc_generalized_update(torch.from_numpy(z), torch.from_numpy(v), torch.from_numpy(s),
                                      1.2, 0.45, 4.0, 0.3, lambda t: 0.5 * t)
    ref = jprox.cnc_generalized_update(jnp.asarray(z), jnp.asarray(v), jnp.asarray(s), 1.2, 0.45, 4.0, 0.3,
                                       lambda t: 0.5 * t)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_pnp_solvers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, mask, y, _ = _scenario(b=1, h=8, w=8)
    cfg = ADMMConfig(iter_num=1)
    ident = lambda v, i: v  # noqa: E731
    for call in (lambda: admm.pnp_admm_l1(y, mask, cfg, ident), lambda: admm.pnp_admm_cnc(y, mask, cfg, ident),
                 lambda: admm.pnp_admm_l1_adaptive(y, mask, cfg, ident), lambda: admm.admm_l1_adaptive(y, mask, cfg),
                 lambda: admm.admm_l1_jit(y, mask, 1, 0.1, 0.1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
