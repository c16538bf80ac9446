"""The port's denoiser priors, tiling and schedules against the JAX package.

``build_denoiser`` of both packages gets the same Flax-initialised
parameter tree (numpy arrays) at reduced widths and the same numpy input.
Tolerances: float64 1e-9, float32 1e-4 (float32 convs round differently
in XLA and in torch's CPU backend); the dihedral transforms, the sigma
ladders and the bin indices are exact.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.models import ffdnet as jffdnet
from pnp_admm_cnc_mri_tpu.models import tdnet as jtdnet
from pnp_admm_cnc_mri_tpu.ops import schedules as jschedules
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdn
from pnp_admm_cnc_mri_tpu.priors import tiling as jtiling
from pnp_admm_cnc_mri_torch.ops import schedules
from pnp_admm_cnc_mri_torch.priors import denoiser as dn
from pnp_admm_cnc_mri_torch.priors import tiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ATOL = {torch.float64: 1e-9, torch.float32: 1e-4}
NP = {torch.float64: np.float64, torch.float32: np.float32}
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
ITERS = 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def flax_tree(model, *inputs):
    variables = model.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))
    return jax.tree.map(np.asarray, dict(variables))


def _ircnn_stack():
    base = flax_tree(jdncnn.IRCNN(out_nc=1, nc=4), np.zeros((1, 16, 16, 1), np.float32))
    return jax.tree.map(lambda a: np.stack([a * (1.0 + 0.02 * k) for k in range(25)]), base)


# model name -> (small-width kwargs shared by both packages, the Flax tree)
SMALL = {
    "dncnn_25": (dict(nc=8, nb=3), lambda: flax_tree(jdncnn.DnCNN(out_nc=1, nc=8, nb=3),
                                                     np.zeros((1, 16, 16, 1), np.float32))),
    "fdncnn_gray": (dict(nc=8, nb=4), lambda: flax_tree(jdncnn.FDnCNN(out_nc=1, nc=8, nb=4),
                                                        np.zeros((1, 16, 16, 2), np.float32))),
    "ircnn_gray": (dict(nc=4), _ircnn_stack),
    "ffdnet_gray": (dict(nc=8, nb=4, noise_level_model=25.0),
                    lambda: flax_tree(jffdnet.FFDNet(out_nc=1, nc=8, nb=4), np.zeros((1, 16, 16, 1), np.float32),
                                      np.float32(0.1))),
    "drunet_gray": (dict(nc=8, nb=1), lambda: flax_tree(jdrunet.UNetRes(out_nc=1, nc=(8, 16, 32, 64), nb=1),
                                                        np.zeros((1, 16, 16, 2), np.float32))),
    "tdnet": (dict(nc=16, nb=4), lambda: flax_tree(jtdnet.TDNet(out_nc=1, nc=16, nb=4),
                                                   np.zeros((1, 16, 16, 1), np.float32), np.float32(0.1))),
}


def _noises(h=32, w=32, seed=5):
    rng = np.random.default_rng(seed)
    return 20.0 * (rng.normal(size=(h, w)) + 1j * rng.normal(size=(h, w)))


def _pair(name, dtype, x8, **kw):
    small, tree = SMALL[name]
    args = dict(small, iter_num=ITERS, x8=x8, params=tree(), **kw)
    ours = dn.build_denoiser(name, param_dtype=dtype, device=CPU, **args)
    theirs = jdn.build_denoiser(name, param_dtype=JNP[dtype], **args)
    return ours, theirs


@pytest.mark.parametrize("x8", [False, True], ids=["x8off", "x8on"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(SMALL))
def test_denoiser_matches_jax(name, dtype, x8):
    """Every iteration's forward (DRUNet's sigma rung and, with x8, its
    dihedral transform; TDNet's rung and, with x8, the mean of all eight
    transforms; IRCNN's weight set) on a (2, 2, 32, 32) batch."""
    kw = dict(noises=_noises()) if name == "fdncnn_gray" else {}
    ours, theirs = _pair(name, dtype, x8, **kw)
    v = np.random.default_rng(6).random((2, 2, 32, 32)).astype(NP[dtype])
    for i in range(ITERS):
        got = ours(torch.from_numpy(v), i)
        ref = np.asarray(theirs(jnp.asarray(v), jnp.asarray(i)))
        assert got.dtype == dtype and got.shape == v.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL[dtype], err_msg=f"iteration {i}")


def test_fdncnn_constant_map_matches_jax():
    ours, theirs = _pair("fdncnn_gray", torch.float64, False, noise_level_model=12.0)
    v = np.random.default_rng(7).random((3, 24, 16))
    np.testing.assert_allclose(ours(torch.from_numpy(v), 0).numpy(), np.asarray(theirs(jnp.asarray(v), 0)),
                               rtol=0, atol=1e-9)


def test_ircnn_picks_each_iterations_weight_set():
    """Over a 30-rung ladder IRCNN's bin moves; each iteration's output
    equals the JAX gather's, and differs from the neighbouring bin's."""
    small, tree = SMALL["ircnn_gray"]
    ours = dn.build_denoiser("ircnn_gray", iter_num=30, param_dtype=torch.float64, params=tree(), device=CPU,
                             **small)
    theirs = jdn.build_denoiser("ircnn_gray", iter_num=30, param_dtype=jnp.float64, params=tree(), **small)
    v = np.random.default_rng(8).random((1, 32, 32))
    idx = schedules.ircnn_sigma_indices(schedules.get_rho_sigma(15 / 255, 30, 49.0, 15.0)[1])
    assert len(set(idx.tolist())) > 10
    for i in (0, 9, 29):
        np.testing.assert_allclose(ours(torch.from_numpy(v), i).numpy(), np.asarray(theirs(jnp.asarray(v), i)),
                                   rtol=0, atol=1e-9)


def test_bf16_compute_dtype_tracks_float32():
    """The JAX package's own budget for its bfloat16 path (tests/test_priors.py)."""
    small, tree = SMALL["dncnn_25"]
    d32 = dn.build_denoiser("dncnn_25", params=tree(), device=CPU, **small)
    d16 = dn.build_denoiser("dncnn_25", params=tree(), device=CPU, compute_dtype=torch.bfloat16, **small)
    v = torch.from_numpy(np.random.default_rng(9).random((2, 32, 32)).astype(np.float32))
    a, b = d32(v, 0), d16(v, 0)
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) < 0.03


@pytest.mark.parametrize("name", ["dncnn_25_clean", "drunet_gray_clean", "tdnet_clean"])
def test_shipped_weights_give_the_jax_forward(name):
    """The trained float16 zoo weights through both packages, float32 at 32 x 32."""
    path = os.path.join(REPO, "model_zoo", name + ".npz")
    assert dn.resolve_weights(name) == path == jdn.resolve_weights(name)
    ours = dn.build_denoiser(name, weights=path, iter_num=ITERS, device=CPU)
    theirs = jdn.build_denoiser(name, weights=path, iter_num=ITERS)
    v = np.random.default_rng(10).random((2, 32, 32)).astype(np.float32)
    for i in (0, ITERS - 1):
        got = ours(torch.from_numpy(v), i).numpy()
        ref = np.asarray(theirs(jnp.asarray(v), i))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# -- dihedral transforms, ensembles, tiling -----------------------------------


def test_augment_and_inverse_equal_jax():
    x = np.random.default_rng(11).random((2, 3, 8, 6))
    np.testing.assert_array_equal(dn.INVERSE_MODE, jdn.INVERSE_MODE)
    for mode in range(8):
        got = dn.augment(torch.from_numpy(x), mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jdn._augment(jnp.asarray(x), mode)))
        back = dn.augment(got, int(dn.INVERSE_MODE[mode]))
        np.testing.assert_array_equal(back.numpy(), x)


def _core_pair():
    """An asymmetric, position-dependent core, so every transform matters."""
    k = np.random.default_rng(12).random((3, 3))

    def ours(x):
        w = torch.from_numpy(k)[None, None].to(x.dtype)
        return torch.nn.functional.conv2d(x, w, padding=1) + torch.linspace(0, 1, x.shape[-1], dtype=x.dtype)

    def theirs(x):  # NHWC
        out = jax.lax.conv_general_dilated(x, jnp.asarray(k)[:, :, None, None], (1, 1), "SAME",
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return out + jnp.linspace(0, 1, x.shape[2])[None, None, :, None]

    return ours, theirs


def test_x8_ensemble_and_cycling_equal_jax():
    ours, theirs = _core_pair()
    x = np.random.default_rng(13).random((2, 1, 12, 12))
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    got = dn.x8_ensemble(ours, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(jdn.x8_ensemble(theirs, xj)), -1, 1), atol=1e-12)
    for i in (0, 3, 5, 11):
        got = dn.x8_cycling(ours, i, torch.from_numpy(x)).numpy()
        ref = np.moveaxis(np.asarray(jdn.x8_cycling(theirs, jnp.asarray(i), xj)), -1, 1)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12, err_msg=f"i = {i}")


@pytest.mark.parametrize("hw,min_size", [((48, 40), 16), ((32, 24), 16), ((20, 20), 32), ((21, 13), 16)])
def test_quad_split_and_wrappers_equal_jax(hw, min_size):
    """Recursive (48 x 40 > 4 * 16^2), one level (32 x 24), a plain padded
    forward (20 x 20 <= 32^2) and an odd size, with a shrunken min_size."""
    ours, theirs = _core_pair()
    x = np.random.default_rng(14).random((2, 1, *hw))
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    xt = torch.from_numpy(x)
    nchw = lambda a: np.moveaxis(np.asarray(a), -1, 1)  # noqa: E731
    pairs = {
        "quad_split": (tiling.quad_split(ours, xt, 8, min_size, 4), jtiling.quad_split(theirs, xj, 8, min_size, 4)),
        "pad_to_modulo": (tiling.pad_to_modulo(ours, xt, 16), jtiling.pad_to_modulo(theirs, xj, 16)),
        "split_x8": (tiling.split_x8(ours, xt, 8, min_size, 4), jtiling.split_x8(theirs, xj, 8, min_size, 4)),
        "one_split": (tiling.one_split(ours, xt, 8), jtiling.one_split(theirs, xj, 8)),
    }
    for what, (got, ref) in pairs.items():
        assert tuple(got.shape) == x.shape, what
        np.testing.assert_allclose(got.numpy(), nchw(ref), rtol=0, atol=1e-12, err_msg=what)


# -- schedules, weights, construction rules ------------------------------------


@pytest.mark.parametrize("iter_num", [1, 4, 15, 30, 50])
def test_sigma_ladders_and_bins_are_bit_equal(iter_num):
    for sigma, s1, s2 in ((15 / 255, 49.0, 15.0), (max(0.255 / 255, 5 / 255), 49.0, 5.0),
                          (8 / 255, 25.0, 8.0), (2.55 / 255, 49.0, 2.55)):
        for w in (1.0, 0.7):
            got = schedules.get_rho_sigma(sigma, iter_num, s1, s2, w)
            ref = jschedules.get_rho_sigma(sigma, iter_num, s1, s2, w)
            for a, b in zip(got, ref):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            idx = schedules.ircnn_sigma_indices(got[1])
            assert idx.dtype == np.int32
            np.testing.assert_array_equal(idx, jschedules.ircnn_sigma_indices(ref[1]))


def test_noise_level_scale_and_weight_lookup(tmp_path):
    for name in ("ircnn_gray", "drunet_gray", "tdnet", "ffdnet_gray", "fdncnn_gray", "dncnn_25"):
        for nlm in (None, 12.0):
            assert dn.nlm_for_model(name, nlm) == jdn.nlm_for_model(name, nlm)
    zoo = str(tmp_path)
    assert dn.resolve_weights("dncnn_25", model_zoo=zoo) is None
    open(os.path.join(zoo, "dncnn_25.npz"), "wb").close()
    assert dn.resolve_weights("dncnn_25", model_zoo=zoo) == os.path.join(zoo, "dncnn_25.npz")
    with pytest.warns(UserWarning, match="no clean weights"):
        assert dn.resolve_weights("dncnn_25", model_zoo=zoo, clean=True) == os.path.join(zoo, "dncnn_25.npz")
    open(os.path.join(zoo, "dncnn_25_clean.npz"), "wb").close()
    assert dn.resolve_weights("dncnn_25", model_zoo=zoo, clean=True) == os.path.join(zoo, "dncnn_25_clean.npz")
    assert dn.resolve_weights("dncnn_25", weights="given.npz") == "given.npz"


@pytest.mark.parametrize("name", list(SMALL))
def test_random_init_warns_and_is_seeded(name):
    small = dict(SMALL[name][0])
    with pytest.warns(UserWarning, match="RANDOM"):
        a = dn.build_denoiser(name, iter_num=ITERS, noises=_noises(), device=CPU, **small)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        b = dn.build_denoiser(name, iter_num=ITERS, noises=_noises(), device=CPU, **small)
    v = torch.from_numpy(np.random.default_rng(15).random((2, 32, 32)).astype(np.float32))
    assert torch.equal(a(v, 1), b(v, 1))
    assert bool(torch.isfinite(a(v, 1)).all())
    with pytest.raises(FileNotFoundError):
        dn.build_denoiser(name, iter_num=ITERS, noises=_noises(), allow_random_init=False, device=CPU, **small)


def test_construction_refusals(monkeypatch):
    with pytest.raises(ValueError, match="noises="):
        dn.build_denoiser("fdncnn_gray", nc=4, nb=3, device=CPU)
    with pytest.raises(ValueError, match="unknown denoiser"):
        dn.build_denoiser("bm3d", device=CPU)
    with pytest.raises(ValueError, match=".npz"):  # TDNet has no KAIR checkpoint layout
        dn.build_denoiser("tdnet", weights="tdnet.pth", device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dn.build_denoiser("dncnn_25", nc=4, nb=3)


def test_tf32_is_off_for_the_convs_and_back_after():
    seen = []

    def spy(v, i):
        seen.append(torch.backends.cudnn.allow_tf32)
        return v

    prev = torch.backends.cudnn.allow_tf32
    try:
        for caller in (True, False):
            torch.backends.cudnn.allow_tf32 = caller
            d = dn.build_denoiser("dncnn_25", nc=4, nb=3, device=CPU, params=flax_tree(
                jdncnn.DnCNN(out_nc=1, nc=4, nb=3), np.zeros((1, 8, 8, 1), np.float32)))
            d.model.register_forward_pre_hook(lambda m, a: spy(None, 0))
            d(torch.zeros(1, 8, 8), 0)
            assert torch.backends.cudnn.allow_tf32 is caller
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert seen == [False, False]


def test_rescaled_denoiser_matches_jax():
    x = np.random.default_rng(16).random((3, 12, 12)) * 4.0 - 1.0
    x[2] = 0.25  # a constant image: its range is taken as 1
    got = dn.rescaled_denoiser(lambda v: 0.1 * torch.tanh(v), 25.0)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jdn.rescaled_denoiser(lambda v: 0.1 * jnp.tanh(v), 25.0)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
