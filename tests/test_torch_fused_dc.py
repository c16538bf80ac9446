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
    fused_dc.fused_iteration.by_design["cluster"] = 5
    fused_dc.reset_launches()
    assert fused_dc.fused_iteration.launches == 0
    assert fused_dc.fused_iteration.by_design == {"cluster": 0, "mixed": 0, "strips": 0}


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
    # the cluster design: z, w, tw_w, tw_h, A, Cr, Ci, z', w', thr, batch, H, W, Q, stream
    sig = fused_dc._CLUSTER_SIGNATURE
    assert sig[:9] == [ctypes.c_void_p] * 9
    assert sig[9] == ctypes.c_float and sig[10] == ctypes.c_int64
    assert sig[11:14] == [ctypes.c_int] * 3 and sig[-1] == ctypes.c_void_p


def test_each_library_has_its_own_flags(tmp_path, monkeypatch):
    """admm_tail keeps --fmad=false (its kernels are compared bit for bit);
    admm_iteration, admm_iteration_cluster and admm_iteration_mixed contract
    multiply-adds; each stamp hashes its own flags."""
    assert "--fmad=false" in _build.flags("admm_tail")
    for name in ("admm_iteration", "admm_iteration_cluster", "admm_iteration_mixed"):
        assert "--fmad=false" not in _build.flags(name)
        assert "arch=compute_90a,code=sm_90a" in _build.flags(name)
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
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


# -- the one-launch designs (csrc/admm_iteration_cluster.cu, _mixed.cu) ------

def _stockham(x, tw, inverse):
    """The kernels' FFT over the last axis, stage by stage: Stockham
    autosort over ``fused_dc.fft_plan(n)`` (radix 4 while 4 divides, one 2,
    then 3, 5, 7: for a power of two the cluster kernel's radix-4 stages and
    one radix-2 stage where log2(n) is odd), twiddle tw[q k (n / (ns r))]
    (conjugate for the inverse), output index (j // ns) ns r + k + q ns. The
    3-, 5- and 7-point DFTs as the mixed kernel runs them: sums and
    differences of the inputs q and r - q, weighed by cos and sin of
    2 pi t / r in the working precision."""
    n = x.shape[-1]
    real = x.real.dtype.type
    if inverse:
        tw = np.conj(tw)
    ns = 1
    for r in fused_dc.fft_plan(n):
        m = n // r
        j = np.arange(m)
        k = j % ns
        v = [x[..., j + q * m] * tw[q * k * (n // (ns * r))] for q in range(r)]
        if r == 4:
            rot = (1j if inverse else -1j) * (v[1] - v[3])
            s02, d02, s13 = v[0] + v[2], v[0] - v[2], v[1] + v[3]
            y = [s02 + s13, d02 + rot, s02 - s13, d02 - rot]
        elif r == 2:
            y = [v[0] + v[1], v[0] - v[1]]
        else:
            half = r // 2
            sums = [v[q] + v[r - q] for q in range(1, half + 1)]
            diffs = [v[q] - v[r - q] for q in range(1, half + 1)]
            y = [v[0] + sum(sums)] + [None] * (r - 1)
            for kk in range(1, half + 1):
                a = v[0] + sum(real(np.cos(2 * np.pi * q * kk / r)) * sums[q - 1] for q in range(1, half + 1))
                b = sum(real(np.sin(2 * np.pi * q * kk / r)) * diffs[q - 1] for q in range(1, half + 1))
                minus, plus = a - 1j * b, a + 1j * b
                y[kk], y[r - kk] = (plus, minus) if inverse else (minus, plus)
        out = np.empty_like(x)
        d = (j // ns) * ns * r + k
        for q in range(r):
            out[..., d + q * ns] = y[q]
        x, ns = out, ns * r
    return x


def _row_units(h, q):
    """The rows a kernel transforms together: block b of q owns rows
    [b R, (b + 1) R), R = H / q, paired in order as v_a + i v_b; the last
    row of an odd R goes alone (its partner is -1)."""
    r = h // q
    ia = np.array([blk * r + u for blk in range(q) for u in range(0, r, 2)])
    ib = np.array([blk * r + u + 1 if u + 1 < r else -1 for blk in range(q) for u in range(0, r, 2)])
    return ia, ib


def _cluster_mirror(z, wd, a, cr, ci, thr, dtype, q=1):
    """The one-launch kernels' algebra in numpy, in the order they run it,
    in ``dtype`` (float32 or float64), with q blocks an image: packed rows
    v_a + i v_b (``_row_units``), the row FFT and its separation, the column
    FFTs of W/2 slots (slot 0 packs the real bins 0 and W/2), the blend
    (slot 0: separated, blended, the Hermitian parts kept and packed again),
    the inverse column FFTs / H, the packed Hermitian inverse of the rows /
    W, |.|, soft and the dual. The cluster kernel is q = 1's pairing (its
    blocks hold an even count of rows); how the slots split over the blocks
    does not change the algebra."""
    cplx = np.complex64 if dtype == np.float32 else np.complex128
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    z, wd, a, cr, ci = (np.asarray(t, dtype) for t in (z, wd, a, cr, ci))
    _, h, w = z.shape
    wh = w // 2 + 1
    ia, ib = _row_units(h, q)
    pair = ib >= 0

    def table(n):
        t = fused_dc.twiddles(n, dtype=tdt).numpy()
        return (t[:, 0] + 1j * t[:, 1]).astype(cplx)

    def packed(rows):
        second = np.where(pair[:, None], rows[:, np.maximum(ib, 0)], 0)
        return (rows[:, ia] + 1j * second).astype(cplx)

    tw_w, tw_h = table(w), table(h)
    v = z - wd
    c = _stockham(packed(v), tw_w, False)
    u, m = c[..., :wh], c[..., (w - np.arange(wh)) % w]
    spec = np.empty((*z.shape[:2], wh), cplx)
    spec[:, ia] = (u + np.conj(m)) * dtype(0.5)
    spec[:, ib[pair]] = ((u - np.conj(m)) * cplx(-0.5j))[:, pair]
    # the columns: W/2 slots, slot 0 packing bins 0 and W/2 (real) as bin0 + i bin(W/2)
    cplx_c = (cr + 1j * ci).astype(cplx)
    slots = spec[..., :w // 2].copy()
    slots[..., 0] = spec[..., 0].real + 1j * spec[..., w // 2].real
    y_ = np.swapaxes(_stockham(np.swapaxes(slots, -1, -2), tw_h, False), -1, -2)  # (B, H, W/2)
    hb = a[:, :w // 2] * y_ + cplx_c[..., :w // 2]
    fp = y_[..., 0]
    fn = fp[..., (h - np.arange(h)) % h]
    y0, yn = (fp + np.conj(fn)) * dtype(0.5), (fp - np.conj(fn)) * cplx(-0.5j)
    h0 = a[:, 0] * y0 + cplx_c[..., 0]
    hn = a[:, w // 2] * yn + cplx_c[..., w // 2]
    e0 = (h0 + np.conj(h0[..., (h - np.arange(h)) % h])) * dtype(0.5)
    en = (hn + np.conj(hn[..., (h - np.arange(h)) % h])) * dtype(0.5)
    hb[..., 0] = e0 + 1j * en
    inv = np.swapaxes(_stockham(np.swapaxes(hb, -1, -2), tw_h, True), -1, -2) * dtype(1.0 / h)
    spec = np.empty_like(spec)
    spec[..., :w // 2] = inv
    spec[..., 0] = inv[..., 0].real
    spec[..., w // 2] = inv[..., 0].imag
    full = np.concatenate([spec, np.conj(spec[..., w // 2 - 1:0:-1])], axis=-1)
    xs = _stockham(packed(full), tw_w, True)
    x = np.empty_like(z)
    x[:, ia] = np.abs(xs.real * dtype(1.0 / w))
    x[:, ib[pair]] = np.abs(xs.imag * dtype(1.0 / w))[:, pair]
    u = x + wd
    z_new = np.sign(u) * np.maximum(np.abs(u) - dtype(thr), dtype(0))
    return z_new, (wd + x) - z_new


def _state(img, seed=1):
    rng = np.random.default_rng(seed)
    return img + 0.05 * rng.normal(size=img.shape), 0.01 * rng.normal(size=img.shape)


@pytest.mark.parametrize("shape", [(3, 16, 32), (2, 32, 16), (2, 8, 8), (1, 64, 128)])
def test_cluster_algebra_gives_the_plain_step(shape):
    """In float64 the kernel's FFT algebra equals the plain dense step."""
    b, h, w = shape
    img, mask, y = _scenario(b, h, w, dtype=np.float64)
    a, cr, ci = _fields(y, mask)
    z, wd = _state(img)
    got = _cluster_mirror(z, wd, a, cr, ci, THR, np.float64)
    ref = fused_dc.fused_iteration_plain(*(torch.from_numpy(t) for t in (z, wd, a, cr, ci)), THR)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 64, 64), (2, 32, 64), (2, 64, 16)])
def test_cluster_algebra_matches_pallas(shape):
    """In float32 the kernel's FFT algebra agrees with the Pallas kernel
    (interpret mode, block 2) within 1e-5, the card's budget for the step."""
    b, h, w = shape
    img, mask, y = _scenario(b, h, w)
    a, cr, ci = _fields(y, mask)
    z, wd = (t.astype(np.float32) for t in _state(img))
    step_j = pallas_dc.make_fused_iteration(*(jnp.asarray(t, jnp.float32) for t in (a, cr, ci)), h, w, THR,
                                            block=2, interpret=True)
    ref = step_j(jnp.asarray(z), jnp.asarray(wd))
    got = _cluster_mirror(z, wd, a, cr, ci, THR, np.float32)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-5)


def test_twiddle_table_is_exact_to_its_type():
    for n in (8, 256, 1024):
        t = fused_dc.twiddles(n, dtype=torch.float64).numpy()
        ref = np.exp(-2j * np.pi * np.arange(n) / n)
        np.testing.assert_allclose(t[:, 0] + 1j * t[:, 1], ref, rtol=0, atol=1e-15)
        assert fused_dc.twiddles(n).dtype == torch.float32


@pytest.mark.parametrize("shape, design, q", [
    ((256, 256), "cluster", 8), ((128, 256), "cluster", 4), ((8, 16), "cluster", 1),
    ((512, 64), "cluster", 4), ((1024, 64), "cluster", 8), ((64, 64), "cluster", 1),
    ((512, 256), "cluster", 8),  # one block an SM: 164 KB a block
    ((1024, 256), "mixed", 16),  # 289 KB a block even at Q = 8: past the cluster design, one an SM at 16
    ((300, 256), "mixed", 10), ((256, 300), "mixed", 8),
    ((320, 320), "mixed", 10), ((384, 384), "mixed", 16), ((448, 448), "mixed", 14), ((512, 512), "mixed", 16),
    ((640, 320), "mixed", 10),
    ((256, 254), "strips", 0), ((640, 368), "strips", 0), ((1024, 1024), "strips", 0),  # 127, 23; too large
    ((256, 4), "strips", 0),
    ((4096, 8), "strips", 0), ((4, 64), "strips", 0)])  # taller than half a work buffer; shorter than 8
def test_shape_rule_picks_the_design(shape, design, q):
    h, w = shape
    assert fused_dc.pick_design(h, w) == (design, q)
    assert fused_dc.cluster_size(h, w) == (q if design == "cluster" else 0)
    if design != "cluster":
        assert fused_dc.mixed_size(h, w) == q
    block, sm, reserved = fused_dc.H100_SMEM
    if design == "cluster":
        assert fused_dc.cluster_smem(h, w, q) <= block
        two_an_sm = fused_dc.cluster_smem(h, w, q) <= sm // 2 - reserved
        assert two_an_sm == ((h, w) != (512, 256))
    if design == "mixed":
        # the smallest Q (dividing H) whose block fits two an SM, else one an SM
        smem = fused_dc.mixed_smem(h, w, q)
        assert h % q == 0 and smem <= block
        limit = sm // 2 - reserved if smem <= sm // 2 - reserved else block
        assert all(fused_dc.mixed_smem(h, w, p) > limit for p in range(1, q) if h % p == 0)
    assert fused_dc.pick_design(h, w, "strips") == ("strips", 0)


def test_main_path_block_fits_two_an_sm():
    # 256 x 256 at Q = 8: 33,024 B of spectrum, 32,768 of w, 33,280 of work
    assert fused_dc.cluster_smem(256, 256, 8) == 16 + 33024 + 32768 + 33280
    assert 2 * (fused_dc.cluster_smem(256, 256, 8) + fused_dc.H100_SMEM[2]) <= fused_dc.H100_SMEM[1]


@pytest.mark.parametrize("h, w", [(300, 256), (1024, 256), (16, 4)])
def test_asking_for_a_design_that_cannot_take_the_shape_raises(h, w):
    with pytest.raises(ValueError, match="cluster design does not take"):
        fused_dc.pick_design(h, w, "cluster")
    if w % 2 == 0 and w >= 8:
        img, mask, y = _scenario(1, h, w)
        a, cr, ci = _fields(y, mask)
        with pytest.raises(ValueError, match="cluster design does not take"):
            fused_dc.make_fused_iteration(a, cr, ci, h, w, THR, device="cpu", design="cluster")
    with pytest.raises(ValueError, match="unknown design"):
        fused_dc.pick_design(h, w, "dense")


def test_step_names_its_design_and_both_run_the_plain_version_on_the_cpu():
    _, mask, y = _scenario(2, 16, 32)
    a, cr, ci = _fields(y, mask)
    z, wd = (torch.from_numpy(t.astype(np.float32)) for t in _state(np.zeros((2, 16, 32))))
    steps = {d: fused_dc.make_fused_iteration(a, cr, ci, 16, 32, THR, device="cpu", design=d)
             for d in (None, "cluster", "mixed", "strips")}
    assert (steps[None].fields.design, steps[None].fields.q) == ("cluster", 1)
    assert (steps["mixed"].fields.design, steps["mixed"].fields.q) == ("mixed", 1)
    assert (steps["strips"].fields.design, steps["strips"].fields.q) == ("strips", 0)
    before = dict(fused_dc.fused_iteration.by_design)
    outs = [s(z, wd) for s in steps.values()]
    for o in outs[1:]:
        assert all(torch.equal(g, r) for g, r in zip(o, outs[0]))
    assert fused_dc.fused_iteration.by_design == before  # the plain path does not count



# -- the mixed design (csrc/admm_iteration_mixed.cu) ---------------------------

@pytest.mark.parametrize("n, plan, group", [
    (8, [4, 2], 1), (256, [4, 4, 4, 4], 32), (320, [4, 4, 4, 5], 64), (384, [4, 4, 4, 2, 3], 64),
    (448, [4, 4, 4, 7], 64), (300, [4, 3, 5, 5], 64), (42, [2, 3, 7], 8), (2048, [4, 4, 4, 4, 4, 2], 256),
    (2000, [4, 4, 5, 5, 5], 512), (254, [], 0), (368, [], 0), (1, [], 0)])
def test_fft_plan_and_group(n, plan, group):
    """The plan, and the threads a sequence as the kernel picks them
    (csrc: fft_plan_of): a thread holds at most 8 values a stage (4
    butterflies of radix 2, 2 of radix 3 or 4, 1 of radix 5 or 7), and g is
    the least power of two that holds every stage, so a block's 512 / g
    sequences fill at most the 4096 values of its work buffer."""
    assert fused_dc.fft_plan(n) == plan
    if plan:
        per = {2: 4, 3: 2, 4: 2, 5: 1, 7: 1}
        need = max(-(-(n // r) // per[r]) for r in plan)
        g = 1 << (need - 1).bit_length()
        assert g == group and (512 // g) * n <= 4096


@pytest.mark.parametrize("n", [8, 12, 20, 30, 42, 48, 60, 96, 105, 225, 320, 343, 384, 448, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_mixed_stockham_is_the_dft(n, inverse):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    t = fused_dc.twiddles(n, dtype=torch.float64).numpy()
    got = _stockham(x, t[:, 0] + 1j * t[:, 1], inverse)
    ref = np.fft.ifft(x, axis=-1) * n if inverse else np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * n)


@pytest.mark.parametrize("h, q, units", [(30, 1, [(0, 1), (28, 29)]), (30, 2, [(0, 1), (14, -1), (15, 16), (29, -1)]),
                                         (9, 3, [(0, 1), (2, -1), (3, 4), (8, -1)])])
def test_row_units_pair_within_a_block_and_leave_a_lone_row(h, q, units):
    ia, ib = _row_units(h, q)
    got = list(zip(ia.tolist(), ib.tolist()))
    assert len(got) == q * ((h // q + 1) // 2)
    assert got[0] == units[0] and got[-1] == units[-1]
    assert all(u in got for u in units)
    covered = sorted([*ia.tolist(), *ib[ib >= 0].tolist()])
    assert covered == list(range(h))


# (shape, q): the rule's Q and forced ones that leave an odd count of rows a
# block (a lone row) and slots that split unevenly over the blocks
MIXED_CASES = [((2, 24, 40), 1), ((2, 24, 40), 8), ((1, 60, 48), 4), ((1, 60, 48), 1), ((2, 30, 20), 2),
               ((2, 30, 20), 5), ((1, 20, 42), 4), ((1, 20, 42), 1), ((1, 45, 28), 9)]


@pytest.mark.parametrize("shape, q", MIXED_CASES)
def test_mixed_algebra_gives_the_plain_step(shape, q):
    """In float64 the mixed kernel's algebra equals the plain dense step."""
    b, h, w = shape
    assert h % q == 0 and q <= w // 2 and fused_dc.fft_plan(h) and fused_dc.fft_plan(w)
    img, mask, y = _scenario(b, h, w, dtype=np.float64)
    a, cr, ci = _fields(y, mask)
    z, wd = _state(img)
    got = _cluster_mirror(z, wd, a, cr, ci, THR, np.float64, q)
    ref = fused_dc.fused_iteration_plain(*(torch.from_numpy(t) for t in (z, wd, a, cr, ci)), THR)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape, q", [((2, 24, 40), 8), ((2, 30, 20), 2), ((2, 20, 42), 4), ((2, 60, 48), 4)])
def test_mixed_algebra_matches_pallas(shape, q):
    """In float32 the mixed kernel's algebra agrees with the Pallas kernel
    (interpret mode, block 2) within 1e-5, the card's budget for the step."""
    b, h, w = shape
    img, mask, y = _scenario(b, h, w)
    a, cr, ci = _fields(y, mask)
    z, wd = (t.astype(np.float32) for t in _state(img))
    step_j = pallas_dc.make_fused_iteration(*(jnp.asarray(t, jnp.float32) for t in (a, cr, ci)), h, w, THR,
                                            block=2, interpret=True)
    ref = step_j(jnp.asarray(z), jnp.asarray(wd))
    got = _cluster_mirror(z, wd, a, cr, ci, THR, np.float32, q)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-5)


@pytest.mark.parametrize("h, w", [(256, 254), (640, 368), (368, 320), (1024, 1024), (300, 255), (16, 4)])
def test_asking_for_the_mixed_design_where_it_cannot_take_the_shape_raises(h, w):
    assert fused_dc.mixed_size(h, w) == 0
    with pytest.raises(ValueError, match="mixed design does not take"):
        fused_dc.pick_design(h, w, "mixed")
    if w % 2 == 0 and w >= 8:
        a, cr, ci = (np.zeros(s, np.float32) for s in ((h, w // 2 + 1), (1, h, w // 2 + 1), (1, h, w // 2 + 1)))
        with pytest.raises(ValueError, match="mixed design does not take"):
            fused_dc.make_fused_iteration(a, cr, ci, h, w, THR, device="cpu", design="mixed")


def test_mixed_design_takes_powers_of_two_when_asked():
    # the rule gives 256 x 256 to the cluster design; asked for, the mixed one takes it
    assert fused_dc.pick_design(256, 256) == ("cluster", 8)
    assert fused_dc.pick_design(256, 256, "mixed") == ("mixed", 8)


def test_mixed_rule_passes_over_a_q_the_device_cannot_hold():
    # 320 x 320: Q = 10 fits two an SM; a device with no room for a cluster of
    # 10 gets the next Q that fits two an SM, 16
    assert fused_dc.mixed_size(320, 320) == 10
    assert fused_dc.mixed_size(320, 320, active=lambda q: 0 if q == 10 else 3) == 16
    assert fused_dc.mixed_size(320, 320, active=lambda q: 0) == 0
    assert fused_dc.pick_design(320, 320, active=lambda q: 0) == ("strips", 0)


def test_mixed_block_layout():
    # 320 x 320 at Q = 10 (R = 32): 41,216 B of spectrum with z at its tail,
    # 40,960 of w, 33,280 of work: two blocks an SM
    assert fused_dc.mixed_smem(320, 320, 10) == 16 + 41216 + 40960 + 33280
    assert 2 * (fused_dc.mixed_smem(320, 320, 10) + fused_dc.H100_SMEM[2]) <= fused_dc.H100_SMEM[1]
    # an odd R (75 at 300 x 256, Q = 4): z starts 16-byte aligned, 8 * 76 bytes in
    r, w = 75, 256
    assert fused_dc.mixed_smem(300, 256, 4) == 16 + (8 * 76 + 4 * w * r) + 4 * r * w + 33280
    # Cr and Ci of unevenly split slots can outgrow w's rows: 256 x 300 at Q = 8
    # holds 2 x 256 x 19 floats of C against 32 x 300 of w
    assert fused_dc.mixed_smem(256, 300, 8) == 16 + (8 * 32 + 4 * 300 * 32) + 4 * 2 * 256 * 19 + 33280
