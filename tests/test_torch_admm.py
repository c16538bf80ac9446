"""The port's classical ADMM slice against the JAX package, on the CPU.

Covers the solvers (``admm_l1``/``admm_cnc``, fused and unfused, and their
``cfg.tol`` branch), one ``admm_step`` from a JAX state, metrics, the
numpy data generators, the interop helpers, the device rule of the entry points, the import boundary
of the port, and ``chip_smoke.py``'s refusal to run without a card.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_admm_cnc_mri_tpu import config as jconfig
from pnp_admm_cnc_mri_tpu.data import masks as jmasks
from pnp_admm_cnc_mri_tpu.data import noise as jnoise
from pnp_admm_cnc_mri_tpu.ops import fourier as jfourier
from pnp_admm_cnc_mri_tpu.ops import metrics as jmetrics
from pnp_admm_cnc_mri_tpu.ops import pallas_kernels as pk
from pnp_admm_cnc_mri_tpu.ops import prox as jprox
from pnp_admm_cnc_mri_tpu.solvers import admm as jadmm
from pnp_admm_cnc_mri_torch import ADMM_CNC_DEFAULT, ADMM_L1_DEFAULT, ADMMConfig, interop
from pnp_admm_cnc_mri_torch.data import masks, noise, phantom
from pnp_admm_cnc_mri_torch.ops import metrics, tail_kernels
from pnp_admm_cnc_mri_torch.solvers import admm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
SOLVERS = {"l1": (admm.admm_l1, jadmm.admm_l1), "cnc": (admm.admm_cnc, jadmm.admm_cnc)}
CFG = ADMMConfig(iter_num=10, rho=0.015, lam=0.1, alpha=0.45, b=64.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def force_interpret():
    pk.FORCE_INTERPRET = True
    yield
    pk.FORCE_INTERPRET = False


def _scenario(b=2, h=32, w=128, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w))
    mask = (rng.random((h, w)) < 0.3).astype(np.float64)
    noise_ = 0.2 * (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))
    y = np.fft.fft2(img, axes=(-2, -1)) * mask + noise_
    return img, mask, y


def _jax_cfg(cfg):
    return jconfig.ADMMConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("solver", ["l1", "cnc"])
def test_solver_matches_jax_f64(force_interpret, solver, fused):
    _, mask, y = _scenario()
    ours, theirs = SOLVERS[solver]
    got, _ = ours(y, mask, CFG, dtype=torch.float64, fused=fused, device=CPU)
    ref, _ = theirs(jnp.asarray(y), jnp.asarray(mask), _jax_cfg(CFG), dtype=jnp.float64, fused=fused)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("solver", ["l1", "cnc"])
def test_solver_matches_jax_f32(force_interpret, solver, fused):
    """The budget of tests/test_pallas.py::test_solver_fused_equals_unfused:
    a 1-ulp difference at a threshold may flip an element."""
    _, mask, y = _scenario(seed=1)
    y32, m32 = y.astype(np.complex64), mask.astype(np.float32)
    ours, theirs = SOLVERS[solver]
    got, _ = ours(y32, m32, CFG, dtype=torch.float32, fused=fused, device=CPU)
    ref, _ = theirs(jnp.asarray(y32), jnp.asarray(m32), _jax_cfg(CFG), dtype=jnp.float32, fused=fused)
    assert got.x.dtype == torch.float32
    d = np.abs(got.x.numpy() - np.asarray(ref.x))
    assert d.max() < 5e-3 and d.mean() < 1e-5, (d.max(), d.mean())


@pytest.mark.parametrize("kw", [dict(dc_method="matmul"), dict(use_rfft=False)])
def test_solver_dc_variants_match_jax_f64(kw):
    _, mask, y = _scenario(h=16, w=24, seed=2)
    got, _ = admm.admm_cnc(y, mask, CFG, dtype=torch.float64, device=CPU, **kw)
    ref, _ = jadmm.admm_cnc(jnp.asarray(y), jnp.asarray(mask), _jax_cfg(CFG), dtype=jnp.float64, **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-9)


def test_collected_residuals_match_jax():
    _, mask, y = _scenario(b=3, h=16, w=16, seed=3)
    _, res = admm.admm_l1(y, mask, CFG, dtype=torch.float64, device=CPU, collect_residuals=True)
    _, ref = jadmm.admm_l1(jnp.asarray(y), jnp.asarray(mask), _jax_cfg(CFG), dtype=jnp.float64,
                           collect_residuals=True)
    assert tuple(res.shape) == (CFG.iter_num, 3)
    np.testing.assert_allclose(res.numpy(), np.asarray(ref), rtol=0, atol=1e-9)
    assert admm.admm_l1(y, mask, CFG, dtype=torch.float64, device=CPU)[1] is None


@pytest.mark.parametrize("use_rfft", [True, False])
def test_one_step_from_a_jax_state(use_rfft):
    _, mask, y = _scenario(h=16, w=32, seed=4)
    yj, mj = jnp.asarray(y), jnp.asarray(mask)
    jcfg = _jax_cfg(ADMM_CNC_DEFAULT)
    start, _ = jadmm.admm_cnc(yj, mj, dataclasses.replace(jcfg, iter_num=3), dtype=jnp.float64)
    state = interop.state_from_numpy(*(np.asarray(a) for a in start), device=CPU)
    assert state.x.dtype == torch.float64
    cfg = interop.config_from_jax(dataclasses.asdict(jcfg))

    def z_t(i, x, z, w):
        from pnp_admm_cnc_mri_torch.ops import prox

        return prox.cnc_update(z, x + w, cfg.alpha, cfg.rho, cfg.lam, cfg.b)

    def z_j(i, x, z, w):
        return jprox.cnc_update(z, x + w, cfg.alpha, cfg.rho, cfg.lam, cfg.b)

    from pnp_admm_cnc_mri_torch.ops import fourier

    yt, mt = torch.from_numpy(y), torch.from_numpy(mask)
    dc_t = fourier.make_rfft_data_consistency(yt, mt, cfg.rho) if use_rfft else None
    dc_j = jfourier.make_rfft_data_consistency(yj, mj, cfg.rho) if use_rfft else None
    got = admm.admm_step(state, 3, yt, mt, cfg.rho, z_t, dc=dc_t)
    ref = jadmm.admm_step(start, 3, yj, mj, cfg.rho, z_j, dc=dc_j)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_fused_equals_unfused_on_the_cpu():
    _, mask, y = _scenario(seed=5)
    for f, cfg in ((admm.admm_l1, ADMM_L1_DEFAULT), (admm.admm_cnc, ADMM_CNC_DEFAULT)):
        cfg = dataclasses.replace(cfg, iter_num=5)
        a, _ = f(y.astype(np.complex64), mask, cfg, fused=True, device=CPU)
        b, _ = f(y.astype(np.complex64), mask, cfg, fused=False, device=CPU)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.parametrize("tol", [1e-2, 1e-30])
@pytest.mark.parametrize("solver", ["l1", "cnc"])
def test_tolerance_stopping_matches_jax(solver, tol):
    """``cfg.tol`` (``run_admm_tol``), stopped early (1e-2) and run to the
    cap (1e-30): the same state and the same count of iterations run."""
    _, mask, y = _scenario(b=3, h=16, w=32, seed=8)
    cfg = dataclasses.replace(ADMM_L1_DEFAULT if solver == "l1" else ADMM_CNC_DEFAULT, iter_num=12, tol=tol)
    ours, theirs = SOLVERS[solver]
    got, n = ours(y, mask, cfg, dtype=torch.float64, device=CPU)
    ref, jn = theirs(jnp.asarray(y), jnp.asarray(mask), _jax_cfg(cfg), dtype=jnp.float64)
    assert n == int(jn) and (n < 12) == (tol == 1e-2)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="collect_residuals"):
        ours(y, mask, cfg, device=CPU, collect_residuals=True)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, mask, y = _scenario(h=8, w=8)
    for f in (admm.admm_l1, admm.admm_cnc):
        with pytest.raises(RuntimeError, match="CUDA"):
            f(y, mask, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.state_from_numpy(np.zeros(2), np.zeros(2), np.zeros(2))


def test_unknown_dc_method_raises():
    _, mask, y = _scenario(h=8, w=8)
    with pytest.raises(ValueError, match="dc_method"):
        admm.admm_l1(y, mask, CFG, device=CPU, dc_method="fast")


def test_config_copies_and_interop():
    for ours, theirs in ((ADMM_L1_DEFAULT, jconfig.ADMM_L1_DEFAULT), (ADMM_CNC_DEFAULT, jconfig.ADMM_CNC_DEFAULT),
                         (ADMMConfig(), jconfig.ADMMConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert interop.config_from_jax(dataclasses.asdict(theirs)) == ours
    with pytest.raises(ValueError, match="unknown"):
        interop.config_from_jax({"rho": 1.0, "sigma": 2.0})


@pytest.mark.parametrize("name", ["psnr", "ssim", "relative_error"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(6)
    a, b = rng.random((2, 24, 20)) * 255, rng.random((2, 24, 20)) * 255
    for border in (0, 2):
        got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b), border).numpy()
        ref = np.asarray(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b), border))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_data_generators_equal_the_jax_packages():
    for shape in ((32, 32), (17, 40)):
        for fraction, seed in ((0.3, 0), (0.15, 4)):
            np.testing.assert_array_equal(masks.random_mask(shape, fraction, seed),
                                          jmasks.random_mask(shape, fraction, seed))
            np.testing.assert_array_equal(masks.cartesian_mask(shape, fraction, seed),
                                          jmasks.cartesian_mask(shape, fraction, seed))
        np.testing.assert_array_equal(masks.radial_mask(shape, 20), jmasks.radial_mask(shape, 20))
        np.testing.assert_array_equal(noise.synth_noise(shape, 3.0, 7), jnoise.synth_noise(shape, 3.0, 7))
    m = masks.random_mask((64, 64), 0.3, 1)
    assert masks.sampling_fraction(m) == jmasks.sampling_fraction(m)


def test_phantoms_are_deterministic_images():
    a = phantom.mri_phantoms(5, 48, seed=0)
    assert a.shape == (5, 48, 48) and a.dtype == np.float32
    assert a.min() >= 0.0 and a.max() <= 1.0 and a.std() > 0.05
    np.testing.assert_array_equal(a, phantom.mri_phantoms(5, 48, seed=0))
    np.testing.assert_array_equal(a[:3], phantom.mri_phantoms(3, 48, seed=0))
    assert not np.array_equal(a, phantom.mri_phantoms(5, 48, seed=1))


def test_smoke_scenario_beats_zero_fill_at_small_size():
    """The smoke run's scenario (phantoms, 30% random mask, noise std 3) at
    two 64 x 64 images: both solvers improve on the zero-filled start."""
    img = torch.from_numpy(phantom.mri_phantoms(2, 64, seed=0))
    m = torch.from_numpy(masks.random_mask((64, 64), 0.3, seed=1)).float()
    n = torch.from_numpy(noise.synth_noise((64, 64), 3.0, seed=2).astype(np.complex64))
    from pnp_admm_cnc_mri_torch.ops import fourier

    y = fourier.observe(img, m, n)
    zf = metrics.psnr(torch.abs(fourier.zero_fill(y)) * 255, img * 255)
    for f, cfg in ((admm.admm_l1, ADMM_L1_DEFAULT), (admm.admm_cnc, ADMM_CNC_DEFAULT)):
        x = f(y, m, cfg, fused=True, device=CPU)[0].x
        p = metrics.psnr(x * 255, img * 255)
        assert torch.isfinite(p).all() and (p > zf).all(), (p, zf)


# ``examples`` is the JAX package's top-level examples folder (the port's own are
# ``pnp_admm_cnc_mri_torch.examples``)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cv2", "pnp_admm_cnc_mri_tpu", "examples"}


def _port_sources():
    root = os.path.join(REPO, "pnp_admm_cnc_mri_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 10
    example_dir = os.path.join(REPO, "pnp_admm_cnc_mri_torch", "examples")
    assert {os.path.join(example_dir, f"{n}.py") for n in (
        "mri_reconstruction", "super_resolution", "bm3d_grayscale", "bm3d_deblurring", "bm3d_rgb",
        "bm3d_multichannel")} <= set(files)
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
                mods = [str(node.args[0].value)]
            else:
                continue
            bad += [f"{path}:{node.lineno} {m}" for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_imports_scipy_only_lazily():
    """scipy and matplotlib are taken inside the functions that need them
    (the ``.mat`` loaders and the colored-noise helpers; ``imshow`` and
    ``surf``), never at a module's import."""
    top = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        lazy = {id(n) for f in ast.walk(tree) if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                for n in ast.walk(f)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            top += [f"{path}:{node.lineno} {m}" for m in mods
                    if m.split(".")[0] in ("scipy", "matplotlib") and id(node) not in lazy]
    assert not top, top


def test_launch_counters_start_from_reset():
    tail_kernels.l1_tail.launches, tail_kernels.cnc_tail.launches = 3, 4
    tail_kernels.reset_launches()
    assert tail_kernels.l1_tail.launches == 0 and tail_kernels.cnc_tail.launches == 0


def _run_smoke(script, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    proc = _run_smoke(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    assert proc.returncode != 0 and proc.stdout == "", proc


def test_chip_smoke_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout, proc
