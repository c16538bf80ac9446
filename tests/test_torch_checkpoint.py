"""Solver checkpoints (``utils/checkpoint.py``) of both packages, on the CPU.

For each family (ADMM, FISTA, HQS, RED, consensus-ADMM, -FISTA and -HQS):

- a port solve stopped after k iterations, saved, loaded and resumed
  equals the uninterrupted port solve bit for bit (float64 and float32);
- a file the JAX package wrote resumes in the port to the JAX package's
  own resume of it (float64, within 1e-9; measured at most 1.2e-15, in
  consensus-ADMM);
- a file the port wrote loads in the JAX package to the same arrays,
  iteration and configuration, and resumes there to the port's resume
  (float64, within 1e-9; measured at most 8.9e-16);
- a path without the ``.npz`` suffix raises.

Inputs: two 32 x 32 images (numpy, seeded), a random mask and complex
noise; consensus takes three observations of each image. The priors are a
soft threshold and a 3 x 3 circular box blur, the same function in both
packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu import config as jconfig
from pnp_admm_cnc_mri_tpu.ops import prox as jprox
from pnp_admm_cnc_mri_tpu.parallel import consensus as jcons
from pnp_admm_cnc_mri_tpu.solvers import admm as jadmm
from pnp_admm_cnc_mri_tpu.solvers import fista as jfista
from pnp_admm_cnc_mri_tpu.solvers import hqs as jhqs
from pnp_admm_cnc_mri_tpu.solvers import red as jred
from pnp_admm_cnc_mri_tpu.utils import checkpoint as jckpt
from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.data import masks
from pnp_admm_cnc_mri_torch.ops import prox, schedules
from pnp_admm_cnc_mri_torch.parallel import consensus
from pnp_admm_cnc_mri_torch.solvers import admm, fista, hqs, red
from pnp_admm_cnc_mri_torch.utils import checkpoint as ckpt

from test_torch_experiments import _box, _jbox

CPU = "cpu"
N, K = 8, 3  # total iterations, the iteration the solve is stopped at
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
CPLX = {torch.float64: np.complex128, torch.float32: np.complex64}
REAL = {torch.float64: np.float64, torch.float32: np.float32}
CFG = ADMMConfig(iter_num=N, rho=0.05, lam=0.2)
ALPHAS = schedules.get_rho_sigma(sigma=5.0 / 255.0, iter_num=N, model_sigma1=30.0, model_sigma2=10.0)[0]
RED_META = {"iter_num": N, "lam": 0.3, "step": 0.8, "variant": "fp", "clamp": True}
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(dtype=torch.float64, n_obs=None, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((2, 32, 32))
    noise = 0.5 * (rng.normal(size=(32, 32)) + 1j * rng.normal(size=(32, 32)))
    if n_obs is None:
        mask = masks.random_mask((32, 32), 0.35, seed=seed + 1)
        y = np.fft.fft2(img) * mask + noise
    else:
        mask = np.stack([masks.random_mask((32, 32), 0.3, seed=seed + 1 + k) for k in range(n_obs)])
        y = np.fft.fft2(img)[:, None] * mask + noise
    return y.astype(CPLX[dtype]), mask.astype(REAL[dtype])


def _soft(i, u):
    return prox.soft(u, 1e-3)


def _jsoft(i, u):
    return jprox.soft(u, 1e-3)


def _jcfg(cfg):
    return jconfig.ADMMConfig(**dataclasses.asdict(cfg))


def _equal(a, b):
    a, b = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (a, b))
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _close(a, b, atol=1e-9):
    a, b = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (a, b))
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# -- the port's own stop, save and resume -----------------------------------


@DTYPES
@pytest.mark.parametrize("algo", ["admm_l1", "admm_cnc"])
def test_admm_resume_bit_equal(tmp_path, dtype, algo):
    y, mask = _data(dtype)
    cfg = ADMMConfig(iter_num=N) if algo == "admm_l1" else ADMMConfig(iter_num=N, lam=0.5, rho=0.05, b=64.0)
    solver = getattr(admm, algo)
    full, _ = solver(y, mask, cfg, dtype=dtype, device=CPU)
    part, _ = solver(y, mask, dataclasses.replace(cfg, iter_num=K), dtype=dtype, device=CPU)
    ckpt.save_state(str(tmp_path / "a.npz"), part, K, cfg)
    state, it, cfg2 = ckpt.load_state(str(tmp_path / "a.npz"))
    assert it == K and cfg2 == cfg and state.x.dtype == dtype
    z_update, tail = admm.classical_update(algo, cfg)
    got, cfg3 = ckpt.resume_admm(str(tmp_path / "a.npz"), y, mask, z_update, tail=tail, device=CPU)
    assert cfg3 == cfg
    for a, b in zip(got, full):
        _equal(a, b)


def test_pnp_admm_resume_bit_equal(tmp_path):
    y, mask = _data()
    cfg = ADMMConfig(iter_num=N, rho=0.3)
    full, _ = admm.pnp_admm_l1(y, mask, cfg, _box, dtype=torch.float64, device=CPU)
    part, _ = admm.pnp_admm_l1(y, mask, dataclasses.replace(cfg, iter_num=K), _box, dtype=torch.float64, device=CPU)
    ckpt.save_state(str(tmp_path / "p.npz"), part, K, cfg)
    got, _ = ckpt.resume_admm(str(tmp_path / "p.npz"), y, mask, lambda i, x, z, w: _box(x + w, i), clamp=True,
                              device=CPU)
    for a, b in zip(got, full):
        _equal(a, b)


@DTYPES
def test_fista_resume_bit_equal(tmp_path, dtype):
    y, mask = _data(dtype)
    full, _ = fista.run_fista(y, mask, N, _soft, dtype=dtype, device=CPU)
    part, _ = fista.run_fista(y, mask, K, _soft, dtype=dtype, device=CPU)
    ckpt.save_fista_state(str(tmp_path / "f.npz"), part, K, meta={"iter_num": N, "step": 1.0})
    state, it, meta = ckpt.load_fista_state(str(tmp_path / "f.npz"))
    assert it == K and meta == {"iter_num": N, "step": 1.0} and state.t == part.t and type(state.t) is type(part.t)
    got, _ = ckpt.resume_fista(str(tmp_path / "f.npz"), y, mask, _soft, device=CPU)
    _equal(got.x, full.x)
    _equal(got.v, full.v)
    assert got.t == full.t


@DTYPES
def test_hqs_resume_bit_equal(tmp_path, dtype):
    y, mask = _data(dtype)
    full, _ = hqs.run_hqs(y, mask, N, _box, ALPHAS, dtype=dtype, device=CPU)
    part, _ = hqs.run_hqs(y, mask, K, _box, ALPHAS[:K], dtype=dtype, device=CPU)
    ckpt.save_hqs(str(tmp_path / "h.npz"), part, K, ALPHAS)
    got, meta = ckpt.resume_hqs(str(tmp_path / "h.npz"), y, mask, _box, device=CPU)
    assert meta["clamp"] is True and len(meta["alphas"]) == N
    _equal(got, full)
    with pytest.raises(ValueError, match="'hqs' checkpoint, not 'red'"):
        ckpt.resume_red(str(tmp_path / "h.npz"), y, mask, _box, device=CPU)


@DTYPES
def test_red_resume_bit_equal(tmp_path, dtype):
    y, mask = _data(dtype)
    kw = {k: RED_META[k] for k in ("lam", "step", "variant", "clamp")}
    full, _ = red.run_red(y, mask, N, _box, dtype=dtype, device=CPU, **kw)
    part, _ = red.run_red(y, mask, K, _box, dtype=dtype, device=CPU, **kw)
    ckpt.save_iterate_state(str(tmp_path / "r.npz"), part, K, "red", meta=RED_META)
    got, _ = ckpt.resume_red(str(tmp_path / "r.npz"), y, mask, _box, device=CPU)
    _equal(got, full)


@DTYPES
def test_consensus_admm_resume_bit_equal(tmp_path, dtype):
    ys, ms = _data(dtype, n_obs=3)
    z_full, x_full = consensus.run_consensus(ys, ms, CFG, dtype=dtype, device=CPU)
    z, _, w = consensus.run_consensus(ys, ms, dataclasses.replace(CFG, iter_num=K), dtype=dtype, return_state=True,
                                      device=CPU)
    ckpt.save_consensus_state(str(tmp_path / "c.npz"), z, w, K, CFG)
    gz, gx, cfg = ckpt.resume_consensus_admm(str(tmp_path / "c.npz"), ys, ms, device=CPU)
    assert cfg == CFG
    _equal(gz, z_full)
    _equal(gx, x_full)
    ckpt.save_state(str(tmp_path / "plain.npz"), admm.ADMMState(z, z, z), K, CFG)
    with pytest.raises(ValueError, match="not a consensus-ADMM checkpoint"):
        ckpt.load_consensus_state(str(tmp_path / "plain.npz"))


@DTYPES
def test_consensus_fista_resume_bit_equal(tmp_path, dtype):
    ys, ms = _data(dtype, n_obs=3)
    full = consensus.run_consensus_fista(ys, ms, N, _soft, dtype=dtype, return_state=True, device=CPU)
    part = consensus.run_consensus_fista(ys, ms, K, _soft, dtype=dtype, return_state=True, device=CPU)
    ckpt.save_consensus_fista(str(tmp_path / "cf.npz"), part, K, iter_num=N)
    got, meta = ckpt.resume_consensus_fista(str(tmp_path / "cf.npz"), ys, ms, _soft, device=CPU)
    assert meta["family"] == "consensus_fista"
    _equal(got.x, full.x)
    _equal(got.v, full.v)
    with pytest.raises(ValueError, match="use resume_consensus_fista"):
        ckpt.resume_fista(str(tmp_path / "cf.npz"), ys[:, 0], ms[0], _soft, device=CPU)


@DTYPES
def test_consensus_hqs_resume_bit_equal(tmp_path, dtype):
    ys, ms = _data(dtype, n_obs=3)
    full = consensus.run_consensus_hqs(ys, ms, N, _box, alphas=ALPHAS, dtype=dtype, device=CPU)
    part = consensus.run_consensus_hqs(ys, ms, K, _box, alphas=ALPHAS[:K], dtype=dtype, device=CPU)
    ckpt.save_consensus_hqs(str(tmp_path / "ch.npz"), part, K, ALPHAS, clamp=True)
    got, _ = ckpt.resume_consensus_hqs(str(tmp_path / "ch.npz"), ys, ms, _box, device=CPU)
    _equal(got, full)


# -- files crossing between the packages --------------------------------------


def _jax_files(tmp_path):
    """Each family's checkpoint written by the JAX package after K of N
    iterations (float64), with the JAX package's resume of it."""
    y, mask = _data(seed=3)
    ys, ms = _data(n_obs=3, seed=4)
    jy, jm, jys, jms = (jnp.asarray(a) for a in (y, mask, ys, ms))
    f64 = jnp.float64
    out = {}
    p = str(tmp_path / "admm.npz")
    part, _ = jadmm.admm_l1(jy, jm, _jcfg(dataclasses.replace(CFG, iter_num=K)), dtype=f64)
    jckpt.save_state(p, part, K, _jcfg(CFG))
    thr = CFG.rho * CFG.lam
    out["admm"] = (p, jckpt.resume_admm(p, jy, jm, lambda i, x, z, w: jprox.soft(x + w, thr))[0].x,
                   lambda p=p: ckpt.resume_admm(p, y, mask, lambda i, x, z, w: prox.soft(x + w, thr), device=CPU)[0].x)
    p = str(tmp_path / "fista.npz")
    part, _ = jfista.run_fista(jy, jm, K, _jsoft, dtype=f64)
    jckpt.save_fista_state(p, part, K, meta={"iter_num": N, "step": 1.0})
    out["fista"] = (p, jckpt.resume_fista(p, jy, jm, _jsoft)[0].x,
                    lambda p=p: ckpt.resume_fista(p, y, mask, _soft, device=CPU)[0].x)
    p = str(tmp_path / "hqs.npz")
    part, _ = jhqs.run_hqs(jy, jm, K, _jbox, ALPHAS[:K], dtype=f64)
    jckpt.save_hqs(p, part, K, ALPHAS)
    out["hqs"] = (p, jckpt.resume_hqs(p, jy, jm, _jbox)[0], lambda p=p: ckpt.resume_hqs(p, y, mask, _box, device=CPU)[0])
    p = str(tmp_path / "red.npz")
    part, _ = jred.run_red(jy, jm, K, _jbox, dtype=f64, **{k: RED_META[k] for k in ("lam", "step", "variant")})
    jckpt.save_iterate_state(p, part, K, "red", meta=RED_META)
    out["red"] = (p, jckpt.resume_red(p, jy, jm, _jbox)[0], lambda p=p: ckpt.resume_red(p, y, mask, _box, device=CPU)[0])
    p = str(tmp_path / "cadmm.npz")
    z, _, w = jcons.run_consensus(jys, jms, _jcfg(dataclasses.replace(CFG, iter_num=K)), dtype=f64,
                                  return_state=True)
    jckpt.save_consensus_state(p, z, w, K, _jcfg(CFG))
    out["consensus_admm"] = (p, jckpt.resume_consensus_admm(p, jys, jms)[1],
                             lambda p=p: ckpt.resume_consensus_admm(p, ys, ms, device=CPU)[1])
    p = str(tmp_path / "cfista.npz")
    st = jcons.run_consensus_fista(jys, jms, K, _jsoft, dtype=f64, return_state=True)
    jckpt.save_consensus_fista(p, st, K, iter_num=N)
    out["consensus_fista"] = (p, jckpt.resume_consensus_fista(p, jys, jms, _jsoft)[0].x,
                              lambda p=p: ckpt.resume_consensus_fista(p, ys, ms, _soft, device=CPU)[0].x)
    p = str(tmp_path / "chqs.npz")
    z = jcons.run_consensus_hqs(jys, jms, K, _jbox, alphas=ALPHAS[:K], dtype=f64)
    jckpt.save_consensus_hqs(p, z, K, ALPHAS)
    out["consensus_hqs"] = (p, jckpt.resume_consensus_hqs(p, jys, jms, _jbox)[0],
                            lambda p=p: ckpt.resume_consensus_hqs(p, ys, ms, _box, device=CPU)[0])
    return out


def test_jax_files_resume_in_the_port(tmp_path):
    files = _jax_files(tmp_path)
    assert len(files) == 7
    for family, (path, ref, resume) in files.items():
        got = resume()
        assert got.dtype == torch.float64, family
        _close(got, ref)


def test_port_files_load_and_resume_in_jax(tmp_path):
    y, mask = _data(seed=5)
    ys, ms = _data(n_obs=3, seed=6)
    jy, jm, jys, jms = (jnp.asarray(a) for a in (y, mask, ys, ms))
    part, _ = admm.admm_l1(y, mask, dataclasses.replace(CFG, iter_num=K), dtype=torch.float64, device=CPU)
    ckpt.save_state(str(tmp_path / "a.npz"), part, K, CFG)
    state, it, cfg = jckpt.load_state(str(tmp_path / "a.npz"))
    assert it == K and dataclasses.asdict(cfg) == dataclasses.asdict(CFG)
    for a, b in zip(state, part):
        _equal(a, b)
    z_update, tail = admm.classical_update("admm_l1", CFG)
    thr = CFG.rho * CFG.lam
    _close(jckpt.resume_admm(str(tmp_path / "a.npz"), jy, jm, lambda i, x, z, w: jprox.soft(x + w, thr))[0].x,
           ckpt.resume_admm(str(tmp_path / "a.npz"), y, mask, z_update, tail=tail, device=CPU)[0].x)

    part, _ = fista.run_fista(y, mask, K, _soft, dtype=torch.float64, device=CPU)
    ckpt.save_fista_state(str(tmp_path / "f.npz"), part, K, meta={"iter_num": N})
    st, it, meta = jckpt.load_fista_state(str(tmp_path / "f.npz"))
    assert it == K and meta == {"iter_num": N} and float(st.t) == float(part.t) and st.t.dtype == np.float64
    _close(jckpt.resume_fista(str(tmp_path / "f.npz"), jy, jm, _jsoft)[0].x,
           ckpt.resume_fista(str(tmp_path / "f.npz"), y, mask, _soft, device=CPU)[0].x)

    for kind, save, jresume, resume in (
            ("hqs", lambda p, z: ckpt.save_hqs(p, z, K, ALPHAS), lambda p: jckpt.resume_hqs(p, jy, jm, _jbox)[0],
             lambda p: ckpt.resume_hqs(p, y, mask, _box, device=CPU)[0]),
            ("red", lambda p, z: ckpt.save_iterate_state(p, z, K, "red", meta=RED_META),
             lambda p: jckpt.resume_red(p, jy, jm, _jbox)[0], lambda p: ckpt.resume_red(p, y, mask, _box, device=CPU)[0])):
        p = str(tmp_path / f"{kind}.npz")
        part, _ = hqs.run_hqs(y, mask, K, _box, ALPHAS[:K], dtype=torch.float64, device=CPU)
        save(p, part)
        x, it, meta = jckpt.load_iterate_state(p, kind=kind)
        assert it == K
        _equal(x, part)
        _close(jresume(p), resume(p))

    z, _, w = consensus.run_consensus(ys, ms, dataclasses.replace(CFG, iter_num=K), dtype=torch.float64,
                                      return_state=True, device=CPU)
    ckpt.save_consensus_state(str(tmp_path / "c.npz"), z, w, K, CFG)
    jz, jw, it, _ = jckpt.load_consensus_state(str(tmp_path / "c.npz"))
    _equal(jz, z)
    _equal(jw, w)
    _close(jckpt.resume_consensus_admm(str(tmp_path / "c.npz"), jys, jms)[0],
           ckpt.resume_consensus_admm(str(tmp_path / "c.npz"), ys, ms, device=CPU)[0])
    st = consensus.run_consensus_fista(ys, ms, K, _soft, dtype=torch.float64, return_state=True, device=CPU)
    ckpt.save_consensus_fista(str(tmp_path / "cf.npz"), st, K, iter_num=N)
    _close(jckpt.resume_consensus_fista(str(tmp_path / "cf.npz"), jys, jms, _jsoft)[0].x,
           ckpt.resume_consensus_fista(str(tmp_path / "cf.npz"), ys, ms, _soft, device=CPU)[0].x)
    z = consensus.run_consensus_hqs(ys, ms, K, _box, alphas=ALPHAS[:K], dtype=torch.float64, device=CPU)
    ckpt.save_consensus_hqs(str(tmp_path / "ch.npz"), z, K, ALPHAS)
    _close(jckpt.resume_consensus_hqs(str(tmp_path / "ch.npz"), jys, jms, _jbox)[0],
           ckpt.resume_consensus_hqs(str(tmp_path / "ch.npz"), ys, ms, _box, device=CPU)[0])


def test_files_have_the_jax_keys_and_dtypes(tmp_path):
    """Both packages write the same keys, dtypes and bytes of metadata."""
    x = np.random.default_rng(7).random((2, 4, 4))
    st = admm.ADMMState(*(torch.from_numpy(x + k) for k in range(3)))
    fst = fista.FISTAState(torch.from_numpy(x), torch.from_numpy(x + 1), np.float64(1.75))
    pairs = [
        (lambda p: ckpt.save_state(p, st, 4, CFG), lambda p: jckpt.save_state(p, jadmm.ADMMState(
            *(np.asarray(a) for a in st)), 4, _jcfg(CFG))),
        (lambda p: ckpt.save_fista_state(p, fst, 2, meta={"iter_num": 9}),
         lambda p: jckpt.save_fista_state(p, jfista.FISTAState(x, x + 1, np.float64(1.75)), 2, meta={"iter_num": 9})),
        (lambda p: ckpt.save_hqs(p, torch.from_numpy(x), 1, ALPHAS), lambda p: jckpt.save_hqs(p, x, 1, ALPHAS)),
        (lambda p: ckpt.save_consensus_fista(p, fst, 2, 9, step=0.5),
         lambda p: jckpt.save_consensus_fista(p, jfista.FISTAState(x, x + 1, np.float64(1.75)), 2, 9, step=0.5)),
        (lambda p: ckpt.save_consensus_state(p, torch.from_numpy(x[0]), torch.from_numpy(x), 3, CFG),
         lambda p: jckpt.save_consensus_state(p, x[0], x, 3, _jcfg(CFG))),
    ]
    for k, (ours, theirs) in enumerate(pairs):
        ours(str(tmp_path / f"p{k}.npz"))
        theirs(str(tmp_path / f"j{k}.npz"))
        with np.load(tmp_path / f"p{k}.npz") as a, np.load(tmp_path / f"j{k}.npz") as b:
            assert sorted(a.files) == sorted(b.files), k
            for key in a.files:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), (k, key)


@pytest.mark.parametrize("save", [
    lambda p: ckpt.save_state(p, admm.ADMMState(*(torch.zeros(2, 2),) * 3), 1),
    lambda p: ckpt.save_fista_state(p, fista.FISTAState(torch.zeros(2, 2), torch.zeros(2, 2), np.float32(1)), 1),
    lambda p: ckpt.save_iterate_state(p, torch.zeros(2, 2), 1, "red"),
    lambda p: ckpt.save_hqs(p, torch.zeros(2, 2), 1, [1.0]),
    lambda p: ckpt.save_consensus_hqs(p, torch.zeros(2, 2), 1, [1.0]),
    lambda p: ckpt.save_consensus_state(p, torch.zeros(2, 2), torch.zeros(1, 2, 2), 1),
    lambda p: ckpt.save_consensus_fista(p, fista.FISTAState(torch.zeros(2, 2), torch.zeros(2, 2), np.float32(1)),
                                        1, 4),
])
def test_a_path_without_npz_raises(tmp_path, save):
    for bad in ("a.npy", "a", "a.npz.bak"):
        with pytest.raises(ValueError, match="must end in .npz"):
            save(str(tmp_path / bad))
    save(str(tmp_path / "a.npz"))


def test_resume_without_config_raises(tmp_path):
    y, mask = _data()
    ckpt.save_state(str(tmp_path / "n.npz"), admm.ADMMState(*(torch.zeros(2, 32, 32, dtype=torch.float64),) * 3), 1)
    with pytest.raises(ValueError, match="no embedded config"):
        ckpt.resume_admm(str(tmp_path / "n.npz"), y, mask, lambda i, x, z, w: x, device=CPU)
    ckpt.save_fista_state(str(tmp_path / "m.npz"), fista.FISTAState(*(torch.zeros(2, 32, 32),) * 2, np.float32(1)),
                          1)
    with pytest.raises(ValueError, match="no embedded iter_num"):
        ckpt.resume_fista(str(tmp_path / "m.npz"), y, mask, _soft, device=CPU)
