"""The DPIR restoration pipelines (``cli/experiments.py``: PnP deblurring and
PnP super-resolution) against the same loops built from the JAX package's
own ``sisr``, ``schedules`` and ``bm3d_prior`` functions, on the CPU.

Both get one noise array (numpy, seeded): the JAX package draws its noise
with ``jax.random``, which torch cannot reproduce, so the port takes it as
``noise=``. Images: two 32 x 32 scenes (SR x2 from 16 x 16). The BM3D
ladder prior runs the Haar tree in the port, so the JAX package is
switched to its tree form for this module (``core._STACK_FILTER_TREE``,
caches cleared around it). Tolerances (max abs): float64 1e-9 (measured
at most 1e-15). Float32, 4 iterations: deblurring 1e-5 max and 1e-6 mean
(measured 6.0e-7 and 8.6e-8); SR 2e-3 max and 5e-5 mean (measured 5.8e-4
and 1.0e-5): the first rungs of the ladder give rho ~2e-4, whose 1/rho in
the data solution cancels spectra ~4,000x the result, and the BM3D
thresholds then carry a float32 rounding; the JAX package's own float32 SR
loop is 2.8e-4 (max) from its float64 one, the port's 5.8e-4.

With the trained ``model_zoo/drunet_gray.npz`` (skipped only when the file
is absent): SR x2 (from 32 x 32) and deblurring of two 64 x 64 scenes, 2
iterations, nlm 2, against the JAX loop with the JAX package's DRUNet on
the same file. Float64 within 1e-9 (measured 1.1e-13 SR, 2.7e-15
deblurring). Float32 against the JAX package's float32 within twice the
JAX package's own float32-vs-float64 gap on these inputs, which is 6.26e-5
(SR) and 4.33e-7 (deblurring), so limits 1.25e-4 and 8.7e-7 (the port
measured 8.85e-5 and 6.56e-7; torch 2 threads).
"""

import os


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.cli import experiments as jexp
from pnp_admm_cnc_mri_tpu.ops import schedules as jschedules
from pnp_admm_cnc_mri_tpu.ops import sisr as jsisr
from pnp_admm_cnc_mri_tpu.priors import bm3d_prior as jbm3d_prior
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdenoiser
from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore
from pnp_admm_cnc_mri_torch import config
from pnp_admm_cnc_mri_torch.cli import experiments
from pnp_admm_cnc_mri_torch.priors import denoiser

N = 32
CPU = "cpu"
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
ITERS = 4
F32 = {"deblur": (1e-5, 1e-6), "sr": (2e-3, 5e-5)}  # float32 (max, mean) limits


@pytest.fixture(scope="module", autouse=True)
def setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    jax.clear_caches()
    jcore._STACK_FILTER_TREE = True
    yield
    jcore._STACK_FILTER_TREE = None
    jax.clear_caches()
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def truth():
    yy, xx = np.mgrid[:N, :N]
    a = 0.5 + 0.3 * np.sin(xx / 4.0) * np.cos(yy / 6.0)
    b = np.where((xx - 12) ** 2 + (yy - 18) ** 2 < 81, 0.8, 0.2)
    return np.stack([a, b])


def _jax_loop(x_true, noise, kind, dtype, iter_num=ITERS, denoise=None, nlm=None):
    """The JAX package's run_deblur / run_sr body on given noise, with its
    BM3D ladder prior (or ``denoise``); ``nlm`` ends the ladder as
    run_deblur / run_sr's ``nlm`` does."""
    jdt = JNP[dtype]
    x = jnp.asarray(x_true, jdt)
    if kind == "deblur":
        s255, sf = 2.55, 1
        k = jnp.asarray(jexp.make_blur_kernel("aniso"), jdt)
        y = jsisr.wrap_convolve(x, k)
        eff = float(max(1.0, s255))
    else:
        s255, sf = 1.5, 2
        k = jnp.asarray(jsisr.anisotropic_gaussian(ksize=9, theta=0.7, l1=2.5, l2=1.0), jdt)
        y = jsisr.classical_degradation(x, k, sf)
        eff = float(max(sf, s255))
    eff = eff if nlm is None else float(nlm)
    y = y + (s255 / 255.0) * jnp.asarray(noise, jdt)
    fb, fbc, f2b, fbfy = jsisr.pre_calculate(y, k, sf)
    rhos, sigmas = jschedules.get_rho_sigma(sigma=max(s255, 0.1) / 255.0, iter_num=iter_num, model_sigma1=49.0,
                                            model_sigma2=eff)
    denoise = denoise or jbm3d_prior.make_bm3d_ladder_denoiser(sigmas)
    z = y if sf == 1 else jnp.kron(y, jnp.ones((sf, sf), jdt))
    for i in range(iter_num):
        if sf == 1:
            xk = jsisr.deblur_solution(z, f2b, fbfy, float(rhos[i]))
        else:
            xk = jsisr.data_solution(z, fb, fbc, f2b, fbfy, float(rhos[i]), sf)
        z = jnp.clip(denoise(xk, i), 0.0, 1.0)
    return np.asarray(y), np.asarray(z)


def _noise(kind, seed=3):
    n = N if kind == "deblur" else N // 2
    return np.random.default_rng(seed).standard_normal((2, n, n))


def _port(kind, x_true, **kw):
    fn = experiments.deblur_batch if kind == "deblur" else experiments.sr_batch
    return fn(x_true, device=CPU, **kw)


KINDS = pytest.mark.parametrize("kind", ["deblur", "sr"])


@KINDS
def test_bm3d_loop_f64(truth, kind):
    noise = _noise(kind)
    y, z = _port(kind, truth, model_name="bm3d", iter_num=ITERS, noise=noise, dtype=torch.float64)
    jy, jz = _jax_loop(truth, noise, kind, torch.float64)
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-9)
    np.testing.assert_allclose(z.numpy(), jz, rtol=0, atol=1e-9)
    assert z.shape == truth.shape and y.dtype == z.dtype == torch.float64


@KINDS
def test_bm3d_loop_f32(truth, kind):
    noise = _noise(kind).astype(np.float32)
    y, z = _port(kind, truth, model_name="bm3d", iter_num=ITERS, noise=noise)
    jy, jz = _jax_loop(truth, noise, kind, torch.float32)
    assert z.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-6)
    d = np.abs(z.numpy() - jz)
    assert d.max() < F32[kind][0] and d.mean() < F32[kind][1], (d.max(), d.mean())


@KINDS
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_loop_with_a_given_denoiser(truth, kind, dtype):
    """The loop's data solutions, ladder and clipping, with a smooth
    stand-in for the prior (a 3 x 3 circular box blur) in both packages."""
    box = np.full((3, 3), 1.0 / 9.0)
    noise = _noise(kind, seed=4)
    _, z = _port(kind, truth, iter_num=6, noise=noise, dtype=dtype,
                 denoise=lambda v, i: experiments.sisr.wrap_convolve(v, torch.from_numpy(box)))
    _, jz = _jax_loop(truth, noise, kind, dtype, iter_num=6,
                      denoise=lambda v, i: jsisr.wrap_convolve(v, jnp.asarray(box, v.dtype)))
    np.testing.assert_allclose(z.numpy(), jz, rtol=0, atol=1e-9 if dtype == torch.float64 else 2e-6)


@KINDS
def test_images_equal_their_single_image_runs(truth, kind):
    noise = _noise(kind)
    _, z = _port(kind, truth, model_name="bm3d", iter_num=2, noise=noise, dtype=torch.float64)
    for i in range(2):
        _, zi = _port(kind, truth[i:i + 1], model_name="bm3d", iter_num=2, noise=noise[i:i + 1],
                      dtype=torch.float64)
        assert torch.equal(z[i], zi[0])


def test_default_noise_comes_from_a_seeded_torch_generator(truth):
    y1, _ = _port("deblur", truth, model_name="bm3d", iter_num=1, seed=7)
    y2, _ = _port("deblur", truth, model_name="bm3d", iter_num=1, seed=7)
    y3, _ = _port("deblur", truth, model_name="bm3d", iter_num=1,
                  generator=torch.Generator().manual_seed(7))
    y4, _ = _port("deblur", truth, model_name="bm3d", iter_num=1, seed=8)
    assert torch.equal(y1, y2) and torch.equal(y1, y3) and not torch.equal(y1, y4)
    clean = experiments.sisr.wrap_convolve(torch.from_numpy(truth).float(),
                                           torch.from_numpy(experiments.make_blur_kernel()).float())
    assert abs(float((y1 - clean).std()) - 2.55 / 255.0) < 2e-3


def test_sr_modcrop(truth):
    """SR crops the image to a multiple of 8 sf (decimation and the
    denoisers' pads stay aligned)."""
    odd = np.pad(truth, ((0, 0), (0, 5), (0, 3)), mode="edge")
    y, z = _port("sr", odd, model_name="bm3d", iter_num=1, noise=_noise("sr"))
    assert tuple(z.shape) == (2, N, N) and tuple(y.shape) == (2, N // 2, N // 2)


@pytest.mark.parametrize("kernel", ["aniso", "gauss", "box"])
def test_blur_kernels(kernel):
    np.testing.assert_array_equal(experiments.make_blur_kernel(kernel), jexp.make_blur_kernel(kernel))
    with pytest.raises(ValueError, match="unknown blur kernel"):
        experiments.make_blur_kernel("motion")


def test_restoration_prior_builds_the_tuned_cnn():
    """'drunet_gray' at ``TUNED_DEBLUR``: the zoo's DRUNet conditioned on the
    ladder that ends at the tuned noise level, as build_denoiser builds it."""
    row = config.TUNED_DEBLUR["drunet_gray"]
    _, sigmas = jschedules.get_rho_sigma(sigma=2.55 / 255.0, iter_num=row["iter_num"], model_sigma2=row["nlm"])
    d = experiments._restoration_prior("drunet_gray", row["iter_num"], row["nlm"], sigmas, None, False, None, False,
                                       device=CPU)
    ref = denoiser.build_denoiser("drunet_gray", weights=denoiser.resolve_weights("drunet_gray"),
                                  iter_num=row["iter_num"], noise_level_model=row["nlm"] / 255.0, device=CPU)
    v = torch.rand(1, N, N, generator=torch.Generator().manual_seed(0))
    assert torch.equal(d(v, 3), ref(v, 3))
    with pytest.warns(UserWarning, match="ignores x8"):
        experiments._restoration_prior("bm3d", 4, 2.0, sigmas, None, True, None, False)


def test_tuned_tables_equal_the_jax_packages():
    from pnp_admm_cnc_mri_tpu import config as jconfig

    for name in ("TUNED_SR", "TUNED_DEBLUR", "TUNED_SR_CLEAN", "TUNED_DEBLUR_CLEAN", "DEBLUR_KERNELS", "MODEL_NAMES"):
        assert getattr(config, name) == getattr(jconfig, name)


def test_entry_points_need_the_card_or_the_cpu(truth):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for fn in (experiments.deblur_batch, experiments.sr_batch):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(truth, model_name="bm3d", iter_num=1)


TRAINED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "model_zoo", "drunet_gray.npz")
# float32 limits: twice the JAX package's own float32-vs-float64 gap (module docstring)
TRAINED_F32 = {"sr": 2 * 6.26e-5, "deblur": 2 * 4.33e-7}


@pytest.mark.skipif(not os.path.exists(TRAINED), reason="model_zoo/drunet_gray.npz is absent")
@KINDS
def test_trained_drunet_loop_matches_jax(kind):
    """The restoration loop with the trained DRUNet, 2 x 64 x 64, 2
    iterations, nlm 2, in both packages on the same numpy noise."""
    n = 64
    yy, xx = np.mgrid[:n, :n]
    x_true = np.stack([0.5 + 0.3 * np.sin(xx / 6.0) * np.cos(yy / 9.0),
                       np.where((xx - 24) ** 2 + (yy - 36) ** 2 < 300, 0.8, 0.2)])
    m = n if kind == "deblur" else n // 2
    noise = np.random.default_rng(3).standard_normal((2, m, m))
    out = {}
    for dtype in (torch.float64, torch.float32):
        jd = jdenoiser.build_denoiser("drunet_gray", weights=TRAINED, iter_num=2, noise_level_model=2.0 / 255.0,
                                      param_dtype=JNP[dtype])
        _, jz = _jax_loop(x_true, noise.astype(np.float64 if dtype == torch.float64 else np.float32), kind, dtype,
                          iter_num=2, denoise=jd, nlm=2.0)
        _, z = _port(kind, x_true, model_name="drunet_gray", weights=TRAINED, iter_num=2, nlm=2.0, noise=noise,
                     dtype=dtype)
        assert z.dtype == dtype and z.shape == x_true.shape
        out[dtype] = (z.numpy(), jz)
    np.testing.assert_allclose(*out[torch.float64], rtol=0, atol=1e-9)
    np.testing.assert_allclose(*out[torch.float32], rtol=0, atol=TRAINED_F32[kind])
