"""CUDA kernels (the ADMM tails and the fused iteration) against their
plain PyTorch versions, and the denoisers, a PnP-CNC step and the FISTA,
HQS, RED and consensus solvers in float32 against float64, on the card;
BM3D and PnP-ADMM with BM3D on the card against the CPU in float64, its
repeatability and its guard against TF32; the colored-noise BM3D, the BM3D
API routes and the restoration pipelines on the card against the CPU in
float64, and the SR operators in float32; a small scenario sweep on the
card against the CPU, and checkpoint resumes on the card bit-equal to the
uninterrupted solves; the command line in float64 on the card against the
CPU; denoiser training steps (host batches and the unrolled
step) on the card against the CPU in float64, training runs bit-equal and
blind to TF32, and the elastic warp's reflect gather on the card.

These tests need a CUDA device (the kernels also nvcc), and skip without
one. The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

import warnings

from pnp_admm_cnc_mri_torch.config import PNP_CNC_BM3D_DEFAULT, PNP_L1_BM3D_DEFAULT, ADMMConfig, PNP_CNC_DEFAULTS
from pnp_admm_cnc_mri_torch.ops import fourier, fused_dc, prox, tail_kernels
from pnp_admm_cnc_mri_torch.parallel import consensus
from pnp_admm_cnc_mri_torch.priors import bm3d_prior, denoiser
from pnp_admm_cnc_mri_torch.cli import experiments as bm3d_experiments
from pnp_admm_cnc_mri_torch.data import noise as noise_mod
from pnp_admm_cnc_mri_torch.priors.bm3d import api as bm3d_api
from pnp_admm_cnc_mri_torch.priors.bm3d import core as bm3d_core
from pnp_admm_cnc_mri_torch.solvers import admm, fista, hqs, red

pytestmark = pytest.mark.cuda

CNC = (0.45, 0.05, 0.5, 64.0)
C_L1 = 0.015 * 0.1


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels are compiled with nvcc for sm_90a")
    tail_kernels.load_library()
    return torch.device("cuda")


def _operands(device, shape, dtype, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(3):
        scale = 10.0 ** (-4.0 * torch.rand(shape, generator=gen, device=device, dtype=dtype))
        out.append(torch.randn(shape, generator=gen, device=device, dtype=dtype) * scale)
    out[0].view(-1)[:8] = 0.0
    out[2].view(-1)[:8] = 0.0
    out[1].view(-1)[8:16] = 0.0
    out[0].view(-1)[16] = float("nan")
    out[1].view(-1)[17] = float("nan")
    return out


def _assert_same(got, ref):
    for a, b in zip(got, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        fin = ~torch.isnan(a)
        assert torch.equal(a[fin], b[fin])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(4, 256, 256), (3, 7, 33)])
def test_kernels_equal_plain(cuda, shape, dtype):
    x, z, w = _operands(cuda, shape, dtype)
    before = (tail_kernels.l1_tail.launches, tail_kernels.cnc_tail.launches)
    _assert_same(tail_kernels.l1_tail(x, z, w, C_L1), tail_kernels.l1_tail_plain(x, z, w, C_L1))
    _assert_same(tail_kernels.cnc_tail(x, z, w, *CNC), tail_kernels.cnc_tail_plain(x, z, w, *CNC))
    assert (tail_kernels.l1_tail.launches, tail_kernels.cnc_tail.launches) == (before[0] + 1, before[1] + 1)


def test_misaligned_operands_take_the_scalar_path(cuda):
    base = _operands(cuda, (4 * 64 * 64 + 1,), torch.float32)
    x, z, w = (a[1:].view(4, 64, 64) for a in base)
    _assert_same(tail_kernels.l1_tail(x, z, w, C_L1), tail_kernels.l1_tail_plain(x, z, w, C_L1))
    _assert_same(tail_kernels.cnc_tail(x, z, w, *CNC), tail_kernels.cnc_tail_plain(x, z, w, *CNC))


def test_nan_in_gives_nan_out(cuda):
    x, z, w = _operands(cuda, (2, 8, 128), torch.float32)
    zn, wn = tail_kernels.l1_tail(x, z, w, C_L1)
    assert torch.isnan(zn.view(-1)[16]) and torch.isnan(wn.view(-1)[16])
    zn, wn = tail_kernels.cnc_tail(x, z, w, *CNC)
    assert torch.isnan(zn.view(-1)[16:18]).all() and torch.isnan(wn.view(-1)[16:18]).all()


def test_mixed_devices_raise(cuda):
    x = torch.zeros(2, 8, 8, device=cuda)
    with pytest.raises(ValueError):
        tail_kernels.l1_tail(x, x, x.cpu(), C_L1)


# The fused step against its plain version: 256-term float32 sums, FMA
# contraction in the kernel against cuBLAS's products; soft is 1-Lipschitz.
FUSED_ATOL = 1e-5


def _plain(design, z, wd, fields):
    """The plain step that a design is held against. The strip design runs
    the plain version's dense float32 DFT products, so it is held against
    the plain version in float32, whose rounding it shares. The cluster and
    mixed designs' FFTs are more accurate than those products (the float32
    plain step is 1.7e-5 off its float64 self in row 0 at H = 1024, the FFT
    step 5e-7), so they are held against the plain version run in float64
    on the same inputs."""
    if design != "strips":
        return fused_dc.fused_iteration_plain(z.double(), wd.double(), *(f.double() for f in fields), C_L1)
    return fused_dc.fused_iteration_plain(z, wd, *fields, C_L1)


@pytest.fixture(scope="module")
def cuda_iteration(cuda):
    fused_dc.load_library()
    fused_dc.load_cluster_library()
    fused_dc.load_mixed_library()
    return cuda


def _fused_case(device, b, h, w, seed=0):
    """Image-scale state and the blend fields of a masked, noisy scenario."""
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w))
    mask = (rng.random((h, w)) < 0.3).astype(np.float32)
    noise = 3.0 * (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))
    y = torch.from_numpy((np.fft.fft2(img) * mask + noise).astype(np.complex64)).to(device)
    a, c = fourier.rfft_blend_fields(y, torch.from_numpy(mask).to(device), 0.015)
    z = torch.from_numpy(img.astype(np.float32)).to(device)
    wd = torch.from_numpy((0.01 * rng.normal(size=(b, h, w))).astype(np.float32)).to(device)
    return z, wd, (a, c.real.contiguous(), c.imag.contiguous())


@pytest.mark.parametrize(
    "shape", [(4, 256, 256), (3, 128, 256), (2, 300, 256), (5, 8, 16), (2, 512, 64), (2, 1024, 64),
              (2, 320, 320), (2, 384, 384), (2, 512, 512)])
def test_fused_iteration_matches_plain(cuda_iteration, shape):
    b, h, w = shape
    z, wd, fields = _fused_case(cuda_iteration, b, h, w)
    step = fused_dc.make_fused_iteration(*fields, h, w, C_L1)
    # the rule takes the cluster design at the power-of-two shapes that fit
    # 8 blocks, the mixed design at the others here
    assert step.fields.design == ("mixed" if h in (300, 320, 384) or w == 512 else "cluster")
    before = fused_dc.fused_iteration.launches
    by_design = dict(fused_dc.fused_iteration.by_design)
    got = step(z, wd)
    assert fused_dc.fused_iteration.launches == before + 1
    by_design[step.fields.design] += 1
    assert fused_dc.fused_iteration.by_design == by_design
    ref = _plain(step.fields.design, z, wd, fields)
    for a, r in zip(got, ref):
        assert float((a - r).abs().max()) < FUSED_ATOL
    again = step(z, wd)
    assert all(torch.equal(a, r) for a, r in zip(got, again))  # no atomics: bitwise repeatable


@pytest.mark.parametrize("h, strip", [(128, 32), (384, 32), (385, 16), (512, 16), (776, 16), (777, 8), (1024, 8)])
def test_column_strip_narrows_as_height_grows(cuda_iteration, h, strip):
    # the library takes the widest strip whose shared memory fits a block
    # (227 KB on the H100), so the matching cases above run all three widths
    _, _, fields = _fused_case(cuda_iteration, 1, h, 16)
    step = fused_dc.make_fused_iteration(*fields, h, 16, C_L1, design="strips")
    assert step.fields.strip == strip


def test_fused_iteration_refuses_too_tall_images(cuda_iteration):
    _, _, fields = _fused_case(cuda_iteration, 1, 1553, 16)
    with pytest.raises(ValueError):
        fused_dc.make_fused_iteration(*fields, 1553, 16, C_L1)


def test_fused_iteration_keeps_a_nan_in_its_image(cuda_iteration):
    z, wd, fields = _fused_case(cuda_iteration, 9, 64, 64)
    z[7, 10, 20] = float("nan")
    step = fused_dc.make_fused_iteration(*fields, 64, 64, C_L1)
    assert step.fields.design == "cluster"
    got = step(z, wd)
    ref = _plain("cluster", z, wd, fields)
    for a, r in zip(got, ref):
        assert torch.isnan(a[7]).all() and torch.isnan(r[7]).all()
        others = [i for i in range(9) if i != 7]
        assert float((a[others] - r[others]).abs().max()) < FUSED_ATOL


def test_fused_iteration_refuses_float64_and_odd_width(cuda_iteration):
    z, wd, fields = _fused_case(cuda_iteration, 2, 16, 32)
    step = fused_dc.make_fused_iteration(*fields, 16, 32, C_L1)
    with pytest.raises(TypeError):
        step(z.double(), wd.double())
    with pytest.raises(TypeError):
        fused_dc.make_fused_iteration(*(f.double() for f in fields), 16, 32, C_L1)
    with pytest.raises(ValueError, match="even W"):
        fused_dc.make_fused_iteration(fields[0][:, :-1], fields[1][..., :-1], fields[2][..., :-1], 16, 31, C_L1)


@pytest.mark.parametrize("design, shape", [
    *(("cluster", s) for s in [(4, 256, 256), (3, 128, 256), (5, 8, 16), (2, 512, 64), (2, 1024, 64)]),
    *(("mixed", s) for s in [(4, 256, 256), (3, 128, 256), (5, 8, 16), (2, 512, 64), (2, 1024, 64), (2, 448, 448),
                             (2, 640, 320), (2, 256, 300), (2, 1024, 256), (3, 24, 40)]),
    *(("strips", s) for s in [(4, 256, 256), (3, 128, 256), (5, 8, 16), (2, 512, 64), (2, 1024, 64),
                              (2, 256, 254)])])
def test_each_design_matches_plain(cuda_iteration, design, shape):
    b, h, w = shape
    z, wd, fields = _fused_case(cuda_iteration, b, h, w, seed=1)
    step = fused_dc.make_fused_iteration(*fields, h, w, C_L1, design=design)
    assert step.fields.design == design
    before = fused_dc.fused_iteration.by_design[design]
    got = step(z, wd)
    assert fused_dc.fused_iteration.by_design[design] == before + 1
    ref = _plain(design, z, wd, fields)
    for a, r in zip(got, ref):
        assert float((a - r).abs().max()) < FUSED_ATOL
    again = step(z, wd)
    assert all(torch.equal(a, r) for a, r in zip(got, again))


def test_strip_design_keeps_a_nan_in_its_image(cuda_iteration):
    z, wd, fields = _fused_case(cuda_iteration, 9, 64, 64)
    z[7, 10, 20] = float("nan")
    got = fused_dc.make_fused_iteration(*fields, 64, 64, C_L1, design="strips")(z, wd)
    ref = fused_dc.fused_iteration_plain(z, wd, *fields, C_L1)
    others = [i for i in range(9) if i != 7]
    for a, r in zip(got, ref):
        assert torch.isnan(a[7]).all() and torch.isnan(r[7]).all()
        assert float((a[others] - r[others]).abs().max()) < FUSED_ATOL


@pytest.mark.parametrize("h, w, q", [(256, 256, 8), (128, 256, 4), (8, 16, 1), (512, 64, 4), (1024, 64, 8),
                                     (512, 256, 8)])
def test_cluster_size_fits_the_card(cuda_iteration, h, w, q):
    """Q as the rule picks it from the card's own shared memory, the
    library's block layout equal to the rule's, and clusters resident."""
    smem = fused_dc.device_smem(cuda_iteration)
    assert fused_dc.cluster_size(h, w, smem) == q
    lib = fused_dc.load_cluster_library()
    assert lib.admm_iteration_cluster_smem(h, w, q) == fused_dc.cluster_smem(h, w, q)
    assert lib.admm_iteration_cluster_active(h, w, q) > 0
    _, _, fields = _fused_case(cuda_iteration, 1, h, w)
    step = fused_dc.make_fused_iteration(*fields, h, w, C_L1)
    assert (step.fields.design, step.fields.q) == ("cluster", q)


def test_cluster_design_refuses_shapes_it_does_not_take(cuda_iteration):
    _, _, fields = _fused_case(cuda_iteration, 1, 300, 256)
    with pytest.raises(ValueError, match="cluster design does not take"):
        fused_dc.make_fused_iteration(*fields, 300, 256, C_L1, design="cluster")
    assert fused_dc.make_fused_iteration(*fields, 300, 256, C_L1).fields.design == "mixed"


def test_mixed_design_refuses_shapes_it_does_not_take(cuda_iteration):
    _, _, fields = _fused_case(cuda_iteration, 1, 256, 254)
    with pytest.raises(ValueError, match="mixed design does not take"):
        fused_dc.make_fused_iteration(*fields, 256, 254, C_L1, design="mixed")
    assert fused_dc.make_fused_iteration(*fields, 256, 254, C_L1).fields.design == "strips"


# (shape, Q): the rule's Q and forced ones; 75, 25, 15, 5 and 3 rows a block
# leave a lone row to the row FFTs, and 128 slots split unevenly over 10, 12, 15
@pytest.mark.parametrize("shape, q", [((2, 300, 256), 10), ((2, 300, 256), 4), ((2, 300, 256), 12),
                                      ((2, 300, 256), 15), ((2, 60, 48), 4), ((2, 45, 28), 9), ((3, 24, 40), 8),
                                      ((2, 320, 320), 16), ((2, 512, 512), 16)])
def test_mixed_design_at_every_q_matches_plain_bitwise_repeatably(cuda_iteration, shape, q):
    b, h, w = shape
    z, wd, fields = _fused_case(cuda_iteration, b, h, w, seed=2)
    step = fused_dc.make_fused_iteration(*fields, h, w, C_L1, design="mixed")
    step.fields.q = q
    got = step(z, wd)
    ref = _plain("mixed", z, wd, fields)
    for a, r in zip(got, ref):
        assert float((a - r).abs().max()) < FUSED_ATOL
    again = step(z, wd)
    assert all(torch.equal(a, r) for a, r in zip(got, again))  # no atomics: bitwise repeatable


def test_mixed_design_launches_the_non_portable_cluster_of_16(cuda_iteration):
    # 512 x 512 takes Q = 16, above the 8 blocks a cluster may hold without
    # cudaFuncAttributeNonPortableClusterSizeAllowed
    smem = fused_dc.device_smem(cuda_iteration)
    assert fused_dc.pick_design(512, 512, smem=smem) == ("mixed", 16)
    assert fused_dc.mixed_active(cuda_iteration, 512, 512, 16) > 0
    z, wd, fields = _fused_case(cuda_iteration, 3, 512, 512)
    step = fused_dc.make_fused_iteration(*fields, 512, 512, C_L1)
    assert (step.fields.design, step.fields.q) == ("mixed", 16)
    before = fused_dc.fused_iteration.by_design["mixed"]
    got = step(z, wd)
    torch.cuda.synchronize()
    assert fused_dc.fused_iteration.by_design["mixed"] == before + 1
    ref = _plain("mixed", z, wd, fields)
    assert max(float((a - r).abs().max()) for a, r in zip(got, ref)) < FUSED_ATOL


def test_mixed_design_keeps_a_nan_in_its_image(cuda_iteration):
    z, wd, fields = _fused_case(cuda_iteration, 9, 320, 320)
    z[7, 10, 20] = float("nan")
    step = fused_dc.make_fused_iteration(*fields, 320, 320, C_L1)
    assert step.fields.design == "mixed"
    got = step(z, wd)
    ref = _plain("mixed", z, wd, fields)
    others = [i for i in range(9) if i != 7]
    for a, r in zip(got, ref):
        assert torch.isnan(a[7]).all() and torch.isnan(r[7]).all()
        assert float((a[others] - r[others]).abs().max()) < FUSED_ATOL


def test_mixed_design_takes_a_misaligned_state(cuda_iteration):
    # a state one float off 16-byte alignment goes through plain loads, not bulk copies
    z, wd, fields = _fused_case(cuda_iteration, 2, 320, 320)
    zm, wm = (torch.cat([torch.zeros(1, device=t.device), t.view(-1)])[1:].view(t.shape) for t in (z, wd))
    assert zm.data_ptr() % 16 and zm.is_contiguous()
    step = fused_dc.make_fused_iteration(*fields, 320, 320, C_L1)
    got = step(zm, wm)
    ref = _plain("mixed", z, wd, fields)
    for a, r in zip(got, ref):
        assert float((a - r).abs().max()) < FUSED_ATOL


@pytest.mark.parametrize("h, w, q", [(320, 320, 10), (384, 384, 16), (448, 448, 14), (512, 512, 16), (640, 320, 10),
                                     (300, 256, 10), (1024, 256, 16)])
def test_mixed_size_fits_the_card(cuda_iteration, h, w, q):
    """Q as the rule picks it from the card's own shared memory and resident
    clusters, the library's block layout and limits equal to the rule's."""
    smem = fused_dc.device_smem(cuda_iteration)
    lib = fused_dc.load_mixed_library()
    vals = [ctypes.c_int() for _ in range(3)]
    assert lib.admm_iteration_mixed_limits(*(ctypes.byref(v) for v in vals)) == 0
    assert tuple(v.value for v in vals) == smem
    assert fused_dc.mixed_size(h, w, smem, lambda p: fused_dc.mixed_active(cuda_iteration, h, w, p)) == q
    assert lib.admm_iteration_mixed_smem(h, w, q) == fused_dc.mixed_smem(h, w, q)
    assert lib.admm_iteration_mixed_smem(h, w + 1, q) == -1


# The denoisers on the card, float32 against float64 on the same seeded
# weights, with torch's default TF32 setting for convolutions left on in
# the caller (the denoiser turns it off for its own forward). At full width
# the DRUNet forward is 5.1e-7 off in float32 and 2.7e-4 off with TF32
# (PERF.md); these narrow nets sum fewer terms.
DENOISER_ATOL = 1e-5
SMALL_DENOISERS = {"dncnn_25": dict(nc=16, nb=5), "fdncnn_gray": dict(nc=16, nb=5), "ircnn_gray": dict(nc=16),
                   "ffdnet_gray": dict(nc=16, nb=5), "drunet_gray": dict(nc=16, nb=2, x8=True),
                   "tdnet": dict(nc=16, nb=4, x8=True)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _seeded_denoiser(name, dtype, device, **kw):
    noises = 20.0 * np.random.default_rng(1).normal(size=(64, 64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random init warns
        return denoiser.build_denoiser(name, iter_num=8, noises=noises, param_dtype=dtype, device=device,
                                       **SMALL_DENOISERS[name], **kw)


@pytest.mark.parametrize("name", list(SMALL_DENOISERS))
def test_denoiser_float32_matches_float64(card, name):
    assert torch.backends.cudnn.allow_tf32  # the caller's default, which the denoiser must not use
    d32 = _seeded_denoiser(name, torch.float32, card)
    d64 = _seeded_denoiser(name, torch.float64, card)
    v = torch.from_numpy(np.random.default_rng(2).random((2, 64, 64))).to(card)
    for i in (0, 5):
        a, b = d32(v.float(), i), d64(v, i)
        assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
        err = float((a.double() - b).abs().max())
        assert err < DENOISER_ATOL, (name, i, err)
    assert torch.backends.cudnn.allow_tf32


def test_pnp_cnc_step_float32_matches_float64(card):
    """One PnP-CNC iteration with DRUNet in both slots at the reference's
    DRUNet defaults (PNP_CNC_DEFAULTS), float32 against float64."""
    rng = np.random.default_rng(3)
    img = rng.random((2, 64, 64))
    mask = (rng.random((64, 64)) < 0.3).astype(np.float64)
    y = np.fft.fft2(img) * mask + 3.0 * (rng.normal(size=(64, 64)) + 1j * rng.normal(size=(64, 64)))
    alpha, _, lam, rho, b = PNP_CNC_DEFAULTS["drunet_gray"]
    cfg = ADMMConfig(iter_num=1, rho=rho, lam=lam, alpha=alpha, b=b)
    states = {}
    for dtype, cplx in ((torch.float32, np.complex64), (torch.float64, np.complex128)):
        d = _seeded_denoiser("drunet_gray", dtype, card)
        states[dtype] = admm.pnp_admm_cnc(y.astype(cplx), mask, cfg, d, dtype=dtype, device=card)[0]
    for a, r in zip(states[torch.float32], states[torch.float64]):
        assert bool(((a >= 0) & (a <= 1)).all())
        err = float((a.double() - r).abs().max())
        assert err < DENOISER_ATOL, err


# Multi-iteration solves, float32 against float64: chip_smoke.py's limit for
# its 4-iteration PnP solves (PnP-CNC showed 3.7e-6 at full width, PERF.md).
SOLVE_ATOL = 5e-5


def _observations(n_obs, rng):
    img = rng.random((2, 64, 64))
    masks = (rng.random((n_obs, 64, 64)) < 0.3).astype(np.float64)
    masks[:, 0, 0] = 1.0
    noise = 3.0 * (rng.normal(size=(64, 64)) + 1j * rng.normal(size=(64, 64)))
    return np.fft.fft2(img)[:, None] * masks + noise, masks


SOLVERS = {
    "pnp_fista": lambda y, m, d, dt, dev: fista.pnp_fista(y[:, 0], m[0], 4, d, dtype=dt, device=dev)[0].x,
    "pnp_pgd_cnc": lambda y, m, d, dt, dev: fista.pnp_pgd_cnc(y[:, 0], m[0], 4, d, lam=0.01, dtype=dt,
                                                              device=dev)[0].x,
    "pnp_hqs": lambda y, m, d, dt, dev: hqs.pnp_hqs(y[:, 0], m[0], 4, d, dtype=dt, device=dev)[0],
    "red": lambda y, m, d, dt, dev: red.run_red(y[:, 0], m[0], 4, d, lam=0.3, dtype=dt, device=dev)[0],
    "consensus_admm": lambda y, m, d, dt, dev: consensus.run_consensus(
        y, m, ADMMConfig(iter_num=4, rho=1.2), z_prox=lambda v, i: prox.clip01(d(v, i)), dtype=dt, device=dev)[0],
    "consensus_fista": lambda y, m, d, dt, dev: consensus.run_consensus_fista(
        y, m, 4, lambda i, u: prox.clip01(d(u, i)), dtype=dt, device=dev),
    "consensus_hqs": lambda y, m, d, dt, dev: consensus.run_consensus_hqs(y, m, 4, d, dtype=dt, device=dev),
}


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_float32_matches_float64(card, solver):
    """Each new solver with narrow DRUNet (x8 cycling), 4 iterations: three
    observations an image for consensus, the first alone for the others."""
    ys, masks = _observations(3, np.random.default_rng(4))
    out = {}
    for dtype, cplx in ((torch.float32, np.complex64), (torch.float64, np.complex128)):
        d = _seeded_denoiser("drunet_gray", dtype, card)
        out[dtype] = SOLVERS[solver](ys.astype(cplx), masks, d, dtype, card)
    a, r = out[torch.float32], out[torch.float64]
    assert a.dtype == torch.float32 and tuple(a.shape) == (2, 64, 64) and a.device.type == "cuda"
    assert bool(((a >= 0) & (a <= 1)).all())
    err = float((a.double() - r).abs().max())
    assert err < SOLVE_ATOL, err


def test_fista_l1_on_the_card_matches_the_cpu(card):
    """cuFFT against the CPU's FFT, float64, 20 iterations, with objectives."""
    ys, masks = _observations(1, np.random.default_rng(5))
    runs = {dev: fista.fista_l1(ys[:, 0], masks[0], 20, lam=2e-3, dtype=torch.float64, collect_objective=True,
                                device=dev) for dev in (card, "cpu")}
    (gpu, gobj), (cpu, cobj) = runs[card], runs["cpu"]
    assert gpu.x.device.type == "cuda" and gpu.t == cpu.t
    assert float((gpu.x.cpu() - cpu.x).abs().max()) < 1e-12
    assert float((gobj.cpu() - cobj).abs().max() / cobj.abs().max()) < 1e-12


# -- BM3D ------------------------------------------------------------------------


def _bm3d_images(b, n, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    base = np.where((xx - n / 2) ** 2 + (yy - n / 2) ** 2 < (n / 3) ** 2, 0.5 + 0.3 * np.sin(xx / 5.0), 0.0)
    return base + noise * rng.standard_normal((b, n, n))


def test_bm3d_on_the_card_matches_the_cpu_in_float64(card):
    """2 x 64 x 64 at sigma 0.1: the distances are the same sums on both
    devices, so the HT stage's matches are identical, and so are the Wiener
    stage's on each device's own pilot; the outputs agree to rounding."""
    z = torch.from_numpy(_bm3d_images(2, 64, 6))
    ref, offs = bm3d_core._ref_grid(57, 3), bm3d_core._offsets(39, 8)
    p = bm3d_core.DEFAULT_PROFILE
    tau_ht = p.tau_match_ht * p.tau_scale * 64 / 255.0**2
    tau_wie = p.tau_match_wie * p.tau_scale * 64 / 255.0**2
    on_card = bm3d_core._match(z.to(card), ref, offs, 8, 16, tau_ht)
    on_cpu = bm3d_core._match(z, ref, offs, 8, 16, tau_ht)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    ht_gpu, ht_cpu = bm3d_core.ht_stage(z.to(card), 0.1), bm3d_core.ht_stage(z, 0.1)
    assert float((ht_gpu.cpu() - ht_cpu).abs().max()) < 1e-12
    on_card = bm3d_core._match(ht_gpu, ref, offs, 8, 32, tau_wie)
    on_cpu = bm3d_core._match(ht_cpu, ref, offs, 8, 32, tau_wie)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    gpu, cpu = bm3d_core.bm3d(z, 0.1, device=card), bm3d_core.bm3d(z, 0.1, device="cpu")
    assert gpu.device.type == "cuda" and gpu.dtype == torch.float64
    assert float((gpu.cpu() - cpu).abs().max()) < 1e-12


def test_bm3d_repeated_calls_are_bit_equal_on_the_card(card):
    z = torch.from_numpy(_bm3d_images(4, 128, 7, noise=0.17)).float().to(card)
    den = bm3d_prior.make_bm3d_denoiser()
    a, b = den(z, 0), den(z, 0)
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b)


def test_bm3d_ignores_tf32_set_in_the_process(card):
    z = torch.from_numpy(_bm3d_images(2, 128, 8, noise=0.17)).float().to(card)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = bm3d_core.bm3d(z, 0.17, device=card)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = bm3d_core.bm3d(z, 0.17, device=card)
        assert torch.backends.cuda.matmul.allow_tf32  # the call gives the caller's setting back
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert torch.equal(on, off)


@pytest.mark.parametrize("scheme", ["l1", "cnc"])
def test_pnp_admm_bm3d_on_the_card_matches_the_cpu(card, scheme):
    """The reference's BM3D pipelines at their defaults, 3 iterations,
    ``clamp=False``, float64."""
    ys, masks = _observations(1, np.random.default_rng(9))
    base = PNP_L1_BM3D_DEFAULT if scheme == "l1" else PNP_CNC_BM3D_DEFAULT
    cfg = ADMMConfig(iter_num=3, rho=base.rho, lam=base.lam, alpha=base.alpha, b=base.b)
    solve = admm.pnp_admm_l1 if scheme == "l1" else admm.pnp_admm_cnc
    runs = {dev: solve(ys[:, 0], masks[0], cfg, bm3d_prior.make_bm3d_denoiser(), clamp=False, dtype=torch.float64,
                       device=dev)[0] for dev in (card, "cpu")}
    for a, b in zip(runs[card], runs["cpu"]):
        assert float((a.cpu() - b).abs().max()) < 1e-9


# ---------------------------------------------------------------------------
# colored-noise BM3D, the BM3D API and the restoration pipelines
# ---------------------------------------------------------------------------


def _colored_images(b, n, fam="g1"):
    k = noise_mod.get_experiment_kernel(fam, 0.02, (n, n))
    clean = _bm3d_images(b, n, 12, noise=0.0)
    return clean + np.stack([noise_mod.synth_colored_noise((n, n), k, seed=r) for r in range(b)]), \
        noise_mod.experiment_psd(k, (n, n))


@pytest.mark.parametrize("exact", [False, True], ids=["approx", "exact"])
def test_bm3d_colored_on_the_card_matches_the_cpu_in_float64(card, exact):
    z, psd = _colored_images(2, 64)
    z = torch.from_numpy(z)
    gpu = bm3d_core.bm3d_colored_auto(z, psd, auto_params=False, exact=exact, device=card)
    cpu = bm3d_core.bm3d_colored_auto(z, psd, auto_params=False, exact=exact, device="cpu")
    assert gpu.device.type == "cuda" and gpu.dtype == torch.float64
    assert float((gpu.cpu() - cpu).abs().max()) < 1e-9


def test_bm3d_colored_repeated_calls_are_bit_equal_and_ignore_tf32(card):
    z, psd = _colored_images(4, 128, "g2")
    z = torch.from_numpy(z).float().to(card)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        a = bm3d_core.bm3d_colored_auto(z, psd, auto_params=False)
        b = bm3d_core.bm3d_colored_auto(z, psd, auto_params=False)
        torch.backends.cuda.matmul.allow_tf32 = True
        c = bm3d_core.bm3d_colored_auto(z, psd, auto_params=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b) and torch.equal(a, c)


def test_bm3d_api_routes_on_the_card_match_the_cpu_in_float64(card):
    z = _bm3d_images(2, 64, 13)
    rgb = np.stack([_bm3d_images(1, 64, s)[0] for s in (14, 15, 16)], axis=-1)
    psf = bm3d_experiments.make_blur_kernel("gauss")
    pilot = bm3d_core.ht_stage(torch.from_numpy(z), 0.1).numpy()
    calls = {
        "flat_psd": lambda dev: bm3d_api.bm3d(z, noise_mod.white_noise_psd((64, 64), 0.01), device=dev),
        "stage_arg": lambda dev: bm3d_api.bm3d(z, 0.1, stage_arg=pilot, device=dev),
        "refilter": lambda dev: bm3d_api.bm3d_refilter(z, 0.1, device=dev),
        "rgb": lambda dev: bm3d_api.bm3d_rgb(rgb, 0.1, device=dev),
        "multichannel": lambda dev: bm3d_api.bm3d_multichannel(rgb, [0.08, 0.1, 0.12], device=dev),
        "deblurring": lambda dev: bm3d_api.bm3d_deblurring(z, 0.02, psf, colored=False, device=dev),
    }
    for name, fn in calls.items():
        gpu, cpu = fn(card), fn("cpu")
        assert gpu.device.type == "cuda", name
        assert float((gpu.cpu() - cpu).abs().max()) < 1e-9, name


@pytest.mark.parametrize("kind", ["deblur", "sr"])
def test_restoration_on_the_card_matches_the_cpu_in_float64(card, kind):
    x = _bm3d_images(2, 64, 17, noise=0.0)
    n = 64 if kind == "deblur" else 32
    nz = np.random.default_rng(18).standard_normal((2, n, n))
    fn = bm3d_experiments.deblur_batch if kind == "deblur" else bm3d_experiments.sr_batch
    runs = {dev: fn(x, model_name="bm3d", iter_num=3, noise=nz, dtype=torch.float64, device=dev)[1]
            for dev in (card, "cpu")}
    # cuFFT and the CPU's FFT differ in the last bits, and SR's first rung
    # (rho ~2e-4) scales its data solution's spectra by 1/rho: the card
    # measured 1.6e-9 for SR (deblurring: below 1e-12)
    assert float((runs[card].cpu() - runs["cpu"]).abs().max()) < 1e-8


def test_sisr_operators_in_float32_on_the_card(card):
    """float32 on the card against float64 on the CPU, at a moderate alpha."""
    from pnp_admm_cnc_mri_torch.ops import sisr

    x = _bm3d_images(2, 64, 19, noise=0.0)
    k = bm3d_experiments.make_blur_kernel("aniso")
    for sf in (1, 2):
        y = sisr.classical_degradation(torch.from_numpy(x), torch.from_numpy(k), sf)
        outs = []
        for dev, dt in ((card, torch.float32), ("cpu", torch.float64)):
            spectra = sisr.pre_calculate(y.to(dev, dt), torch.from_numpy(k).to(dev, dt), sf)
            outs.append(sisr.data_solution(torch.from_numpy(x).to(dev, dt), *spectra, 0.1, sf))
        assert float((outs[0].double().cpu() - outs[1]).abs().max()) < 1e-5


def _write_assets(root, n=64, n_images=2):
    """A testset ``set1`` of PNG phantoms (the port's writer), the three
    masks as ``Q_*30.mat`` and ``noises.mat`` under ``root``."""
    import os

    import scipy.io as sio

    from pnp_admm_cnc_mri_torch.data import images, masks, phantom

    tdir, ddir = os.path.join(root, "testsets"), os.path.join(root, "CS_MRI")
    for k, img in enumerate(phantom.mri_phantoms(n_images, n, seed=3)):
        images.imsave(img * 255.0, os.path.join(tdir, "set1", f"{k:02d}.png"))
    os.makedirs(ddir)
    gens = {"Q_Random30": masks.random_mask((n, n), 0.3, seed=1), "Q_Radial30": masks.radial_mask((n, n), 20),
            "Q_Cartesian30": masks.cartesian_mask((n, n), 0.3, seed=2)}
    for name, m in gens.items():
        sio.savemat(os.path.join(ddir, masks.MASK_FILES[name]), {"Q1": m.astype(np.uint8)})
    sio.savemat(os.path.join(ddir, "noises.mat"), {"noises": noise_mod.synth_noise((n, n), std=1.0, seed=2)})
    return tdir, ddir


@pytest.mark.parametrize("algo", ["admm_l1", "admm_cnc"])
def test_sweep_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch, capsys, algo):
    """A 2-mask x 2-sigma sweep of 2 images: the card (K1 or K2 once an
    iteration) against the CPU, float32 both."""
    import json

    from pnp_admm_cnc_mri_torch.cli import sweep
    from pnp_admm_cnc_mri_torch.data import images, masks

    tdir, ddir = _write_assets(str(tmp_path))
    monkeypatch.setattr(images, "DEFAULT_TESTSETS", tdir)
    monkeypatch.setattr(masks, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(noise_mod, "DEFAULT_DATA_DIR", ddir)
    argv = ["--algo", algo, "--testset", "set1", "--masks", "Q_Random30,Q_Radial30", "--sigmas", "1,3",
            "--iter_num", "20"]
    rows = {}
    tail_kernels.reset_launches()
    for dev, extra in (("card", []), ("cpu", ["--cpu"])):
        out = str(tmp_path / f"{dev}.jsonl")
        assert sweep.main(argv + extra + ["--out", out]) == 0
        capsys.readouterr()
        with open(out) as f:
            rows[dev] = [json.loads(ln) for ln in f]
    launches = getattr(tail_kernels, "l1_tail" if algo == "admm_l1" else "cnc_tail").launches
    assert launches == 20
    assert [r["scenario"] for r in rows["card"]] == [r["scenario"] for r in rows["cpu"]] and len(rows["cpu"]) == 8
    for a, b in zip(rows["card"], rows["cpu"]):
        # float32 cuFFT against the CPU's FFT, 20 iterations
        assert abs(a["psnr"] - b["psnr"]) < 1e-3 and abs(a["residual"] - b["residual"]) < 1e-6 + 1e-3 * b["residual"]


@pytest.mark.parametrize("algo", ["admm_l1", "admm_cnc", "consensus_l1"])
def test_cli_on_the_card_matches_the_cpu_in_float64(cuda, tmp_path, capsys, algo):
    """``cli.main`` with ``--f64`` on the card (K1 or K2 once an iteration for
    ADMM) against ``--cpu --f64``: the same result keys, per-image PSNR
    within 1e-9 dB."""
    import json

    from pnp_admm_cnc_mri_torch.cli import main as cli_main

    tdir, ddir = _write_assets(str(tmp_path))
    argv = [algo, "--f64", "--testset", "set1", "--testsets_dir", tdir, "--data_dir", ddir, "--iter_num", "20"]
    res = {}
    for dev, extra in (("card", []), ("cpu", ["--cpu"])):
        tail_kernels.reset_launches()
        assert cli_main.main(argv + extra + ["--results_dir", str(tmp_path / dev)]) == 0
        res[dev] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        if dev == "card":
            counts = (tail_kernels.l1_tail.launches, tail_kernels.cnc_tail.launches)
            assert counts == {"admm_l1": (20, 0), "admm_cnc": (0, 20), "consensus_l1": (0, 0)}[algo]
    assert set(res["card"]) == set(res["cpu"]) and res["card"]["images"] == res["cpu"]["images"] == 2
    for k, v in res["cpu"]["per_image_psnr"].items():
        assert abs(res["card"]["per_image_psnr"][k] - v) < 1e-9


def test_checkpoint_resume_on_the_card_is_bit_equal(cuda, tmp_path):
    """ADMM-L1 (K1) and FISTA stopped at iteration 3 of 8, saved, loaded and
    resumed on the card, against the uninterrupted solve on the card."""
    import dataclasses

    from pnp_admm_cnc_mri_torch.utils import checkpoint

    img = np.random.default_rng(4).random((3, 64, 64))
    mask = (np.random.default_rng(5).random((64, 64)) < 0.3).astype(np.float32)
    y = (np.fft.fft2(img) * mask + noise_mod.synth_noise((64, 64), 1.0, 6)).astype(np.complex64)
    cfg = ADMMConfig(iter_num=8)
    full, _ = admm.admm_l1(y, mask, cfg)
    part, _ = admm.admm_l1(y, mask, dataclasses.replace(cfg, iter_num=3))
    checkpoint.save_state(str(tmp_path / "a.npz"), part, 3, cfg)
    z_update, tail = admm.classical_update("admm_l1", cfg)
    got, _ = checkpoint.resume_admm(str(tmp_path / "a.npz"), y, mask, z_update, tail=tail)
    assert got.x.is_cuda and all(torch.equal(a, b) for a, b in zip(got, full))

    def soft(i, u):
        return prox.soft(u, 1e-3)

    full_f, _ = fista.run_fista(y, mask, 8, soft)
    part_f, _ = fista.run_fista(y, mask, 3, soft)
    checkpoint.save_fista_state(str(tmp_path / "f.npz"), part_f, 3, meta={"iter_num": 8})
    got_f, _ = checkpoint.resume_fista(str(tmp_path / "f.npz"), y, mask, soft)
    assert torch.equal(got_f.x, full_f.x) and torch.equal(got_f.v, full_f.v) and got_f.t == full_f.t


# ---------------------------------------------------------------------------
# training


def test_train_steps_on_the_card_match_the_cpu_in_float64(card):
    from pnp_admm_cnc_mri_torch.models.dncnn import DnCNN
    from pnp_admm_cnc_mri_torch.train import data as data_mod, trainer

    r = np.random.default_rng(0)
    patches = data_mod.extract_patches([r.random((64, 64)) for _ in range(2)], patch=16, stride=8)
    out = {}
    for dev in (card, torch.device("cpu")):
        out[dev.type], _ = trainer.train_denoiser(DnCNN(1, 1, nc=16, nb=5), patches, (0.0, 0.2), steps=3,
                                                  batch_size=8, cfg=trainer.TrainConfig(lr_decay="cosine"),
                                                  dtype=torch.float64, device=dev)
    for k in out["cpu"]:
        assert float((out["cuda"][k].cpu() - out["cpu"][k]).abs().max()) < 1e-9


def test_unrolled_step_on_the_card_matches_the_cpu_in_float64(card):
    from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
    from pnp_admm_cnc_mri_torch.train import trainer, unroll

    r = np.random.default_rng(1)
    clean, masks = r.random((2, 32, 32)), (r.random((2, 32, 32)) < 0.4).astype(np.float64)
    noise = 2.0 * r.standard_normal((2, 2, 32, 32))
    out = {}
    for dev in (card, torch.device("cpu")):
        m = trainer.prepare_model(UNetRes(2, 1, nc=(4, 8, 16, 32), nb=1), None, 0, torch.float64, dev)
        opt = trainer.make_optimizer(trainer.TrainConfig(learning_rate=1e-3), m.parameters(), 1)
        step = unroll.make_unrolled_step(unroll.make_unrolled_recon(unroll.make_drunet_ladder_denoise(m, 3), 3,
                                                                    dtype=torch.float64), opt)
        step(*(torch.from_numpy(a).to(dev) for a in (clean, masks, noise)))
        out[dev.type] = trainer.state_of(m)
    for k in out["cpu"]:
        assert float((out["cuda"][k].cpu() - out["cpu"][k]).abs().max()) < 1e-9


def test_training_repeats_bit_equal_and_ignores_tf32(card):
    from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
    from pnp_admm_cnc_mri_torch.train import synth, trainer

    gen = synth.make_generator(size=64, n_disks=100)
    runs = []
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            runs.append(trainer.train_denoiser_stream(UNetRes(2, 1, nc=(16, 32, 64, 128), nb=2), gen,
                                                      (0.0, 50 / 255), steps=6, batch_size=8, patch=32,
                                                      buffer_images=8, conditioned=True, ema_decay=0.9,
                                                      scan_steps=3, seed=2, device=card))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    for other in runs[1:]:
        assert other[1] == runs[0][1]
        for k in runs[0][0]:
            assert torch.equal(other[0][k], runs[0][0][k])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_reflect_gather_on_the_card_matches_the_cpu(card, dtype):
    from pnp_admm_cnc_mri_torch.train import synth

    g = torch.Generator().manual_seed(0)
    img = torch.rand((3, 17, 23), generator=g, dtype=dtype)
    y = -40 + 97 * torch.rand((3, 9, 11), generator=g, dtype=dtype)
    x = -50 + 120 * torch.rand((3, 9, 11), generator=g, dtype=dtype)
    ref = synth.map_coordinates_reflect(img, y, x)
    got = synth.map_coordinates_reflect(img.to(card), y.to(card), x.to(card)).cpu()
    assert float((got - ref).abs().max()) <= (1e-12 if dtype == torch.float64 else 1e-6)
