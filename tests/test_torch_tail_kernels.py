"""The port's fused ADMM tails (``pnp_admm_cnc_mri_torch.ops.tail_kernels``)
against the JAX package's Pallas kernels, on the CPU.

The Pallas kernels run in interpret mode, as ``tests/test_pallas.py`` runs
them; the port's wrappers take their plain versions for CPU tensors. The
CUDA kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_admm_cnc_mri_tpu.ops import pallas_kernels as pk
from pnp_admm_cnc_mri_tpu.ops import prox as jprox
from pnp_admm_cnc_mri_torch.ops import _build, prox, tail_kernels

CNC = (0.45, 0.05, 0.5, 64.0)
C_L1 = 0.015 * 0.1


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


def _operands(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(3, 8, 128), (2, 16, 256)])
def test_l1_tail_matches_pallas(force_interpret, shape):
    x, z, w = _operands(shape)
    z_j, w_j = pk.l1_tail(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w), C_L1)
    z_t, w_t = tail_kernels.l1_tail(*(torch.from_numpy(a) for a in (x, z, w)), C_L1)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 8, 128), (2, 16, 256)])
def test_cnc_tail_matches_pallas(force_interpret, shape):
    x, z, w = _operands(shape, seed=1)
    z_j, w_j = pk.cnc_tail(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w), *CNC)
    z_t, w_t = tail_kernels.cnc_tail(*(torch.from_numpy(a) for a in (x, z, w)), *CNC)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)


def test_soft_matches_jnp_on_edge_values():
    """NaN stays NaN (jnp.maximum propagates it), sign(0) = 0, |x| == c gives 0."""
    c = 0.25
    v = np.array([np.nan, 0.0, -0.0, c, -c, 1.0, -1.0, np.inf, -np.inf, 1e-30], np.float32)
    got = prox.soft(torch.from_numpy(v), c).numpy()
    ref = np.asarray(jprox.soft(jnp.asarray(v), c))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got[~np.isnan(got)], ref[~np.isnan(ref)])
    assert np.isnan(got[0])


def test_cnc_update_matches_jax_f64():
    rng = np.random.default_rng(2)
    z, v = rng.normal(size=(2, 16, 32)), rng.normal(size=(2, 16, 32))
    got = prox.cnc_update(torch.from_numpy(z), torch.from_numpy(v), *CNC).numpy()
    ref = np.asarray(jprox.cnc_update(jnp.asarray(z), jnp.asarray(v), *CNC))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_cnc_generalized_update_and_clip01_match_jax():
    rng = np.random.default_rng(3)
    z, v, s = (rng.normal(size=(8, 8)) for _ in range(3))
    got = prox.cnc_generalized_update(
        *(torch.from_numpy(a) for a in (z, v, s)), *CNC, prox2=lambda t: prox.soft(t, 0.1)).numpy()
    ref = np.asarray(jprox.cnc_generalized_update(
        *(jnp.asarray(a) for a in (z, v, s)), *CNC, prox2=lambda t: jprox.soft(t, 0.1)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(prox.clip01(torch.from_numpy(v)).numpy(),
                                  np.asarray(jprox.clip01(jnp.asarray(v))))


def test_cpu_tensors_take_the_plain_version_and_do_not_count(monkeypatch):
    def no_library():
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")

    monkeypatch.setattr(tail_kernels, "load_library", no_library)
    tail_kernels.reset_launches()
    x, z, w = (torch.from_numpy(a) for a in _operands((2, 8, 16)))
    for got, ref in ((tail_kernels.l1_tail(x, z, w, C_L1), tail_kernels.l1_tail_plain(x, z, w, C_L1)),
                     (tail_kernels.cnc_tail(x, z, w, *CNC), tail_kernels.cnc_tail_plain(x, z, w, *CNC))):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert tail_kernels.l1_tail.launches == 0 and tail_kernels.cnc_tail.launches == 0


@pytest.mark.parametrize("case", ["dtype", "half", "shape", "contiguity", "type"])
def test_wrappers_reject_bad_operands(case):
    x = torch.zeros(2, 8, 16)
    ops = {
        "dtype": (x.to(torch.int32),) * 3,
        "half": (x.half(),) * 3,
        "shape": (x, x, torch.zeros(2, 8, 8)),
        "contiguity": (x, x, torch.zeros(2, 16, 8).mT),
        "type": (x, x, x.numpy()),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        tail_kernels.l1_tail(*ops, C_L1)
    with pytest.raises((TypeError, ValueError)):
        tail_kernels.cnc_tail(*ops, *CNC)


def test_c_signatures_pass_pointers_and_sizes_at_full_width():
    for name, argtypes in tail_kernels._SIGNATURES.items():
        n_ptr = 4 if "l1" in name else 5
        assert argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr, name
        assert argtypes[-2:] == [ctypes.c_int64, ctypes.c_void_p], name


def test_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'admm_tail.cu(1): error: no such thing' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such thing"):
        _build.build("admm_tail")
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_build_reuses_a_library_whose_hash_matches(tmp_path, monkeypatch):
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return type("P", (), {"returncode": 0, "stderr": "", "stdout": ""})()

    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    lib = _build.build("admm_tail")
    assert lib == tmp_path / "libadmm_tail.so" and lib.is_file()
    assert _build.build("admm_tail") == lib and len(calls) == 1
    (tmp_path / "libadmm_tail.sha256").write_text("stale")
    _build.build("admm_tail")
    assert len(calls) == 2
    assert "arch=compute_90a,code=sm_90a" in calls[0]
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
