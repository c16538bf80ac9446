"""The port's denoiser networks and weight mapping against the Flax models.

Each model is built at a reduced width in Flax, initialised there, and its
parameter tree, as numpy arrays, is carried onto the port's module by
``models.convert.state_dict_from_flax``. Both run the same numpy input:
the Flax model NHWC, the port NCHW. Tolerances: float64 1e-9 (both sum
the same products in another order), float32 1e-4 (the float32 convs of
XLA and of torch's CPU backend round differently).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.models import blocks as jblocks
from pnp_admm_cnc_mri_tpu.models import convert as jconvert
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.models import ffdnet as jffdnet
from pnp_admm_cnc_mri_tpu.models import tdnet as jtdnet
from pnp_admm_cnc_mri_torch.models import blocks, convert, dncnn, drunet, ffdnet, tdnet

ATOL = {torch.float64: 1e-9, torch.float32: 1e-4}
NP = {torch.float64: np.float64, torch.float32: np.float32}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def flax_tree(model, *inputs):
    """Flax-initialised variables of ``model`` as nested dicts of numpy arrays."""
    variables = model.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))
    return jax.tree.map(np.asarray, dict(variables))


def nhwc(x):
    return jnp.asarray(np.moveaxis(x, 1, -1))


def port_module(module, tree, dtype):
    module = module.to(dtype)
    module.load_state_dict(convert.state_dict_from_flax(module, tree, dtype))
    return module.eval()


def run_both(jmodel, tmodel, x, dtype, *extra):
    """Forward of both on the NCHW numpy input x (and extra inputs)."""
    x = x.astype(NP[dtype])
    tree = flax_tree(jmodel, np.moveaxis(x, 1, -1), *extra)
    ref = np.moveaxis(np.asarray(jmodel.apply(tree, nhwc(x), *(jnp.asarray(e) for e in extra))), -1, 1)
    mod = port_module(tmodel, tree, dtype)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), *(torch.from_numpy(np.asarray(e)) for e in extra)).numpy()
    assert got.dtype == NP[dtype] and got.shape == ref.shape
    return got, ref


CASES = {
    "dncnn": (lambda: jdncnn.DnCNN(out_nc=1, nc=8, nb=3), lambda: dncnn.DnCNN(1, 1, nc=8, nb=3), (2, 1, 24, 20)),
    "dncnn_not_residual": (lambda: jdncnn.DnCNN(out_nc=1, nc=8, nb=4, residual=False),
                           lambda: dncnn.DnCNN(1, 1, nc=8, nb=4, residual=False), (1, 1, 16, 16)),
    "fdncnn": (lambda: jdncnn.FDnCNN(out_nc=1, nc=8, nb=4), lambda: dncnn.FDnCNN(2, 1, nc=8, nb=4), (2, 2, 20, 20)),
    "ircnn": (lambda: jdncnn.IRCNN(out_nc=1, nc=8), lambda: dncnn.IRCNN(1, 1, nc=8), (2, 1, 32, 32)),
    "drunet": (lambda: jdrunet.UNetRes(out_nc=1, nc=(8, 16, 32, 64), nb=1),
               lambda: drunet.UNetRes(2, 1, nc=(8, 16, 32, 64), nb=1), (2, 2, 32, 32)),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_flax(name, dtype):
    jm, tm, shape = CASES[name]
    x = np.random.default_rng(0).random(shape)
    got, ref = run_both(jm(), tm(), x, dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("hw", [(24, 24), (17, 19)])
def test_ffdnet_matches_flax(hw, dtype):
    """Odd sizes take the replication pad to sf and the crop back."""
    x = np.random.default_rng(1).random((2, 1, *hw))
    sigma = np.full((2, 1, 1, 1), 15.0 / 255.0, NP[dtype])
    got, ref = run_both(jffdnet.FFDNet(out_nc=1, nc=8, nb=4), ffdnet.FFDNet(1, 1, nc=8, nb=4), x, dtype, sigma)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("hw", [(32, 32), (33, 31)])
def test_tdnet_matches_flax(hw, dtype):
    """The sigma channel after the four unshuffled ones; an odd size takes
    the replication pad and the crop back. Flax's tree maps unchanged."""
    x = np.random.default_rng(5).random((2, 1, *hw))
    sigma = np.array([10.0, 25.0], NP[dtype]).reshape(2, 1, 1, 1) / 255.0
    got, ref = run_both(jtdnet.TDNet(out_nc=1, nc=16, nb=4), tdnet.TDNet(1, 1, nc=16, nb=4), x, dtype, sigma)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])


def test_tdnet_with_a_zero_tail_is_the_identity():
    """The network predicts the noise: with the tail's weights at 0 the
    output is the input, at any sigma and any size."""
    mod = convert.random_init_(tdnet.TDNet(1, 1, nc=8, nb=3).double())
    with torch.no_grad():
        mod.tail.conv.weight.zero_()
        mod.tail.conv.bias.zero_()
    x = torch.from_numpy(np.random.default_rng(6).random((3, 1, 17, 22)))
    for sigma in (0.0, 0.2, torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)):
        assert torch.equal(mod(x, sigma), x)
    assert sorted(k for k in mod.state_dict() if k.startswith("head"))[0] == "head.conv.bias"


@pytest.mark.parametrize("act", ["", "R", "L"])
def test_samplers_with_bias_and_activation_match_flax(act):
    """The biased, activated variants of the stride-2 conv and the
    transposed conv, which DRUNet (bias-free, no activation) does not reach."""
    x = np.random.default_rng(2).random((2, 3, 8, 12)) - 0.5
    got, ref = run_both(jblocks.DownStride(5, use_bias=True, act=act), blocks.DownStride(3, 5, True, act),
                        x, torch.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    got, ref = run_both(jblocks.UpTranspose(4, use_bias=True, act=act), blocks.UpTranspose(3, 4, True, act),
                        x, torch.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_shuffles_and_pad_match_flax():
    x = np.random.default_rng(3).random((2, 3, 12, 6))
    for factor in (2, 3):
        got = blocks.pixel_unshuffle(torch.from_numpy(x), factor).numpy()
        ref = np.moveaxis(np.asarray(jblocks.pixel_unshuffle(nhwc(x), factor)), -1, 1)
        np.testing.assert_array_equal(got, ref)
        back = blocks.pixel_shuffle(torch.from_numpy(got), factor).numpy()
        np.testing.assert_array_equal(back, np.moveaxis(np.asarray(jblocks.pixel_shuffle(nhwc(got), factor)), -1, 1))
        np.testing.assert_array_equal(back, x)
    got = blocks.replication_pad_2d(torch.from_numpy(x), 3, 1).numpy()
    ref = np.moveaxis(np.asarray(jblocks.replication_pad_2d(nhwc(x), 3, 1)), -1, 1)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="activation"):
        blocks._act(torch.zeros(1), "X")


def test_ircnn_stack_keeps_its_leading_axis():
    base = flax_tree(jdncnn.IRCNN(out_nc=1, nc=4), np.zeros((1, 16, 16, 1), np.float32))
    stacked = jax.tree.map(lambda a: np.stack([a * (1.0 + 0.1 * k) for k in range(25)]), base)
    mod = dncnn.IRCNN(1, 1, nc=4).double()
    sd = convert.state_dict_from_flax(mod, stacked, torch.float64, lead=(25,))
    assert sd["layer1.conv.weight"].shape == (25, 4, 4, 3, 3)
    x = np.random.default_rng(4).random((1, 1, 16, 16))
    for k in (0, 7, 24):
        one = jax.tree.map(lambda a: a[k], stacked)
        ref = np.moveaxis(np.asarray(jdncnn.IRCNN(out_nc=1, nc=4).apply(one, nhwc(x))), -1, 1)
        got = torch.func.functional_call(mod, {n: t[k] for n, t in sd.items()}, (torch.from_numpy(x),))
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-12)


def test_float16_trees_are_cast_to_the_param_dtype():
    tree = flax_tree(jdncnn.DnCNN(out_nc=1, nc=4, nb=3), np.zeros((1, 8, 8, 1), np.float32))
    half = jax.tree.map(lambda a: a.astype(np.float16), tree)
    sd = convert.state_dict_from_flax(dncnn.DnCNN(1, 1, nc=4, nb=3), half, torch.float32)
    assert all(t.dtype == torch.float32 for t in sd.values())
    k = half["params"]["body0"]["conv"]["kernel"]
    np.testing.assert_array_equal(sd["body0.conv.weight"].numpy(), k.astype(np.float32).transpose(3, 2, 0, 1))


def test_unknown_missing_and_misshapen_keys_raise():
    tree = flax_tree(jdncnn.DnCNN(out_nc=1, nc=4, nb=3), np.zeros((1, 8, 8, 1), np.float32))
    mod = dncnn.DnCNN(1, 1, nc=4, nb=3)
    extra = {"params": dict(tree["params"], body7={"conv": {"kernel": np.zeros((3, 3, 4, 4))}})}
    with pytest.raises(ValueError, match="no counterpart"):
        convert.state_dict_from_flax(mod, extra)
    short = {"params": {k: v for k, v in tree["params"].items() if k != "tail"}}
    with pytest.raises(ValueError, match="lacks"):
        convert.state_dict_from_flax(mod, short)
    with pytest.raises(ValueError, match="shape"):
        convert.state_dict_from_flax(dncnn.DnCNN(1, 1, nc=8, nb=3), tree)
    with pytest.raises(ValueError, match="params"):
        convert.state_dict_from_flax(mod, tree["params"])
    odd = {"params": {"head": {"conv": {"scale": np.zeros(4)}}}}
    with pytest.raises(ValueError, match="leaf"):
        convert.state_dict_from_flax(mod, odd)


def test_npz_reader_inverts_the_jax_writer(tmp_path):
    tree = flax_tree(jdrunet.UNetRes(out_nc=1, nc=(4, 8, 16, 32), nb=1), np.zeros((1, 16, 16, 2), np.float32))
    path = str(tmp_path / "w.npz")
    jconvert.save_npz(tree, path)
    got = convert.load_npz(path)
    ref = jconvert.load_npz(path)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}  # noqa: E731
    assert flat(got).keys() == flat(ref).keys() == flat(tree).keys()
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(flat(got)[k], v)


def test_random_init_is_seeded_and_dtype_independent():
    """Seeded draws, whatever the global RNG did, the same in float64 as in
    float32, within torch's default bounds."""
    torch.manual_seed(123)
    a = convert.random_init_(drunet.UNetRes(2, 1, nc=(4, 8, 16, 32), nb=1))
    torch.manual_seed(456)
    b = convert.random_init_(drunet.UNetRes(2, 1, nc=(4, 8, 16, 32), nb=1).double())
    for k, u in a.state_dict().items():
        assert torch.equal(u.double(), b.state_dict()[k]), k
        bound = 1.0 / np.sqrt(u[0].numel())
        assert 0.5 * bound < float(u.abs().max()) <= bound, k
