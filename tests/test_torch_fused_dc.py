"""The port's fused ADMM-L1 iteration (``pnp_admm_cnc_mri_torch.ops.fused_dc``)
against the JAX package's ``ops/pallas_dc.py``, on the CPU.

The Pallas kernel runs in interpret mode with ``block=2``, as
``tests/test_pallas.py`` runs it; the port's step takes its plain version
for CPU tensors. Float32 comparisons use ``test_pallas.py``'s 2e-6: the two
sides sum the same 64-term float32 products in different orders. The CUDA
kernels are held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_admm_cnc_mri_tpu import config as jconfig
from pnp_admm_cnc_mri_tpu.ops import pallas_dc
from pnp_admm_cnc_mri_torch import ADMMConfig
from pnp_admm_cnc_mri_torch.ops import _build, fourier, fused_dc
from pnp_admm_cnc_mri_torch.solvers import admm

CFG = ADMMConfig(iter_num=8, lam=0.1, rho=0.015)
THR = CFG.rho * CFG.lam


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scenario(b, h, w, dtype=np.float32, seed=0):
    """Images, mask and k-space ``y`` (complex of ``dtype``'s width)."""
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w))
    mask = (rng.random((h, w)) < 0.3).astype(dtype)
    noise = 0.5 * (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))
    cplx = np.complex64 if dtype == np.float32 else np.complex128
    y = (np.fft.fft2(img, axes=(-2, -1)) * mask + noise).astype(cplx)
    return img.astype(dtype), mask, y


def _fields(y, mask):
    a, c = fourier.rfft_blend_fields(torch.from_numpy(y), torch.from_numpy(mask), CFG.rho)
    return a.numpy(), c.real.contiguous().numpy(), c.imag.contiguous().numpy()


@pytest.mark.parametrize("shape", [(4, 64, 64), (2, 32, 64)])
def test_plain_step_matches_pallas(shape):
    b, h, w = shape
    img, mask, y = _scenario(b, h, w)
    a, cr, ci = _fields(y, mask)
    rng = np.random.default_rng(1)
    z = img + 0.05 * rng.normal(size=img.shape).astype(np.float32)
    wd = (0.01 * rng.normal(size=img.shape)).astype(np.float32)
    step_j = pallas_dc.make_fused_iteration(*(jnp.asarray(t, jnp.float32) for t in (a, cr, ci)), h, w, THR,
                                            block=2, interpret=True)
    z_j, w_j = step_j(jnp.asarray(z, jnp.float32), jnp.asarray(wd, jnp.float32))
    z_t, w_t = fused_dc.fused_iteration_plain(*(torch.from_numpy(t) for t in (z, wd, a, cr, ci)), THR)
    assert z_t.dtype == torch.float32
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=2e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=2e-6)
    # the step made by make_fused_iteration takes the same plain version on the CPU
    step = fused_dc.make_fused_iteration(a, cr, ci, h, w, THR, device="cpu")
    for got, ref in zip(step(torch.from_numpy(z), torch.from_numpy(wd)), (z_t, w_t)):
        assert torch.equal(got, ref)


def test_solver_matches_pallas():
    _, mask, y = _scenario(4, 64, 64)
    jcfg = jconfig.ADMMConfig(iter_num=CFG.iter_num, lam=CFG.lam, rho=CFG.rho)
    ref = pallas_dc.admm_l1_fused_kernel(jnp.asarray(y, jnp.complex64), jnp.asarray(mask, jnp.float32), jcfg,
                                         block=2, interpret=True)
    got = fused_dc.admm_l1_fused_kernel(y, mask, CFG, device="cpu")
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == (4, 64, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-6)


def test_solver_takes_any_batch_f64():
    """B = 3 is not a multiple of the TPU kernel's block; the JAX solver
    would leave the last image unwritten, so the reference is the port's
    own unfused matmul solver."""
    _, mask, y = _scenario(3, 32, 64, dtype=np.float64)
    x, z, w = fused_dc.admm_l1_fused_kernel(y, mask, CFG, dtype=torch.float64, device="cpu")
    ref = admm.admm_l1(y, mask, CFG, dtype=torch.float64, fused=False, dc_method="matmul", device="cpu")[0]
    # z and w are the state entering the last iteration
    cfg_prev = ADMMConfig(iter_num=CFG.iter_num - 1, lam=CFG.lam, rho=CFG.rho)
    prev = admm.admm_l1(y, mask, cfg_prev, dtype=torch.float64, fused=False, dc_method="matmul", device="cpu")[0]
    for got, r in ((x, ref.x), (z, prev.z), (w, prev.w)):
        assert got.dtype == torch.float64 and tuple(got.shape) == (3, 32, 64)
        np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=0, atol=1e-9)


def test_one_iteration_is_a_plain_data_consistency_solve():
    _, mask, y = _scenario(2, 16, 32, dtype=np.float64)
    cfg = ADMMConfig(iter_num=1, lam=CFG.lam, rho=CFG.rho)
    x, z, w = fused_dc.admm_l1_fused_kernel(y, mask, cfg, dtype=torch.float64, device="cpu")
    init = admm.init_state(torch.from_numpy(y), torch.float64)
    assert torch.equal(z, init.z) and torch.equal(w, init.w)
    ref = admm.admm_l1(y, mask, cfg, dtype=torch.float64, fused=False, dc_method="matmul", device="cpu")[0]
    np.testing.assert_allclose(x.numpy(), ref.x.numpy(), rtol=0, atol=1e-12)


def test_rfft_blend_fields_match_the_closed_form():
    """The closed form that ``pallas_dc.admm_l1_fused_kernel`` writes out
    (``pallas_dc.py:149-163``), in float64."""
    _, mask, y = _scenario(2, 16, 32, dtype=np.float64)
    mask[3, 5] = 0.5  # "sampled" means mask != 0
    rho, w = CFG.rho, 32
    la2 = 1.0 / (2.0 * rho)
    yj, mj_in = jnp.asarray(y), jnp.asarray(mask)
    m = (mj_in != 0).astype(yj.real.dtype)
    yz = jnp.where(m != 0, yj, 0.0)
    m_neg = jnp.roll(jnp.flip(m, axis=(-2, -1)), shift=(1, 1), axis=(-2, -1))
    y_neg_conj = jnp.conj(jnp.roll(jnp.flip(yz, axis=(-2, -1)), shift=(1, 1), axis=(-2, -1)))
    half = w // 2 + 1
    a_full = (2.0 - m - m_neg) / 2.0 + la2 * (m + m_neg) / (2.0 * (1.0 + la2))
    c_full = (m * yz + m_neg * y_neg_conj) / (2.0 * (1.0 + la2))
    a, c = fourier.rfft_blend_fields(torch.from_numpy(y), torch.from_numpy(mask), rho)
    assert a.dtype == torch.float64 and c.dtype == torch.complex128
    np.testing.assert_allclose(a.numpy(), np.asarray(a_full[..., :half]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_full[..., :half]), rtol=0, atol=1e-12)


def test_odd_width_raises():
    _, mask, y = _scenario(2, 16, 33, dtype=np.float64)
    a, cr, ci = _fields(y, mask)
    with pytest.raises(ValueError, match="even W"):
        fused_dc.make_fused_iteration(a, cr, ci, 16, 33, THR, device="cpu")
    with pytest.raises(ValueError, match="even W"):
        fused_dc.admm_l1_fused_kernel(y, mask, CFG, dtype=torch.float64, device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, mask, y = _scenario(2, 16, 32)
    a, cr, ci = _fields(y, mask)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_dc.make_fused_iteration(a, cr, ci, 16, 32, THR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fused_dc.admm_l1_fused_kernel(y, mask, CFG)


def test_tolerance_stopping_is_refused():
    _, mask, y = _scenario(2, 16, 32)
    cfg = ADMMConfig(iter_num=4, tol=1e-3)
    with pytest.raises(ValueError, match="tol"):
        fused_dc.admm_l1_fused_kernel(y, mask, cfg, device="cpu")


def test_counter_counts_only_on_cuda_and_resets(monkeypatch):
    def no_library():
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")

    monkeypatch.setattr(fused_dc, "load_library", no_library)
    fused_dc.reset_launches()
    _, mask, y = _scenario(2, 16, 32)
    fused_dc.admm_l1_fused_kernel(y, mask, CFG, device="cpu")
    assert fused_dc.fused_iteration.launches == 0
    fused_dc.fused_iteration.launches = 5
    fused_dc.reset_launches()
    assert fused_dc.fused_iteration.launches == 0


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "type", "fields"])
def test_step_rejects_bad_operands(case):
    _, mask, y = _scenario(2, 16, 32)
    a, cr, ci = _fields(y, mask)
    if case == "fields":
        with pytest.raises(ValueError):
            fused_dc.make_fused_iteration(a[:, :-1], cr, ci, 16, 32, THR, device="cpu")
        with pytest.raises(TypeError):
            fused_dc.make_fused_iteration(a.astype(np.float64), cr, ci, 16, 32, THR, device="cpu")
        return
    step = fused_dc.make_fused_iteration(a, cr, ci, 16, 32, THR, device="cpu")
    z = torch.zeros(2, 16, 32)
    bad = {
        "dtype": z.double(),
        "shape": torch.zeros(3, 16, 32),
        "contiguity": torch.zeros(2, 32, 16).mT,
        "type": z.numpy(),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        step(z, bad)


def test_c_signatures_pass_pointers_and_sizes_at_full_width():
    for name, argtypes in fused_dc._SIGNATURES.items():
        n_ptr = {"rows": 5, "columns": 7, "synthesis": 6}[name.split("_")[2]]
        assert argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr, name
        assert ctypes.c_int64 in argtypes and argtypes[-1] == ctypes.c_void_p, name


def test_each_library_has_its_own_flags(tmp_path, monkeypatch):
    """admm_tail keeps --fmad=false (its kernels are compared bit for bit);
    admm_iteration contracts multiply-adds; each stamp hashes its own flags."""
    assert "--fmad=false" in _build.flags("admm_tail")
    assert "--fmad=false" not in _build.flags("admm_iteration")
    assert "arch=compute_90a,code=sm_90a" in _build.flags("admm_iteration")
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return type("P", (), {"returncode": 0, "stderr": "", "stdout": ""})()

    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    for name in ("admm_tail", "admm_iteration"):
        _build.build(name)
    assert ("--fmad=false" in calls[0]) and ("--fmad=false" not in calls[1])
    stamps = {n: (tmp_path / f"lib{n}.sha256").read_text() for n in ("admm_tail", "admm_iteration")}
    # a change of one library's flags makes that library, and only it, stale
    monkeypatch.setitem(_build.SOURCE_FLAGS, "admm_iteration", ("-lineinfo",))
    _build.build("admm_tail")
    _build.build("admm_iteration")
    assert len(calls) == 3 and "-lineinfo" in calls[2]
    assert (tmp_path / "libadmm_tail.sha256").read_text() == stamps["admm_tail"]
    assert (tmp_path / "libadmm_iteration.sha256").read_text() != stamps["admm_iteration"]


@pytest.mark.parametrize("shape", [(3, 16, 32), (2, 24, 16)])
def test_stage_algebra_gives_the_plain_step(shape):
    """The CUDA stages' algebra reproduces the plain step, stage by stage as
    the kernels order it, in float64: the rows against E = [cw | -sw], the
    columns as complex products with the symmetric ch and sh (forward
    ch - i sh, inverse ch + i sh, each read along its rows), the blend, the
    synthesis against F = [wk cw; -wk sw]."""
    b, h, w = shape
    wh = w // 2 + 1
    img, mask, y = _scenario(b, h, w, dtype=np.float64)
    a, cr, ci = (torch.from_numpy(t) for t in _fields(y, mask))
    rng = np.random.default_rng(2)
    z = torch.from_numpy(img + 0.05 * rng.normal(size=img.shape))
    wd = torch.from_numpy(0.01 * rng.normal(size=img.shape))
    cw, sw = fourier._dft_mats(w, torch.float64)
    ch, sh = fourier._dft_mats(h, torch.float64)
    assert torch.equal(ch, ch.T) and torch.equal(sh, sh.T)
    e, f = fused_dc.row_operands(cw, sw)
    assert e.shape == (w, 2 * wh) and f.shape == (2 * wh, w)
    xs = (z - wd) @ e                                      # stage A: [Xr | Xi]
    xr, xi = xs[..., :wh], xs[..., wh:]
    yr, yi = ch @ xr + sh @ xi, ch @ xi - sh @ xr          # stage B, forward
    hr, hi = a * yr + cr, a * yi + ci
    ir, ii = (ch @ hr - sh @ hi) / h, (ch @ hi + sh @ hr) / h  # stage B, inverse
    x = torch.abs(torch.cat([ir, ii], dim=-1) @ f / w)     # stage C
    z_new = torch.maximum(torch.abs(x + wd) - THR, torch.zeros(())) * torch.sign(x + wd)
    ref = fused_dc.fused_iteration_plain(z, wd, a, cr, ci, THR, (cw, sw, ch, sh))
    np.testing.assert_allclose(z_new.numpy(), ref[0].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(((wd + x) - z_new).numpy(), ref[1].numpy(), rtol=0, atol=1e-12)
