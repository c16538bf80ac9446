"""Weights across the two packages: the port's ``convert.save_npz`` writes
the JAX package's flattened Flax keys (kernels back in HWIO), so a file the
port saves loads into the JAX models with equal outputs (float64, 1e-9),
and a file either package saves round-trips through the other unchanged.
``flax_init_`` draws by Flax's default rule: its statistics, not its
values (torch's generator cannot replay ``jax.random``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.models import convert as jconvert
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.models import ffdnet as jffdnet
from pnp_admm_cnc_mri_torch.models import convert, dncnn, drunet, ffdnet


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


CASES = {
    "dncnn": (lambda: dncnn.DnCNN(1, 1, nc=8, nb=3), lambda: jdncnn.DnCNN(out_nc=1, nc=8, nb=3), 1, ()),
    "fdncnn": (lambda: dncnn.FDnCNN(2, 1, nc=8, nb=4), lambda: jdncnn.FDnCNN(out_nc=1, nc=8, nb=4), 2, ()),
    "ffdnet": (lambda: ffdnet.FFDNet(1, 1, nc=8, nb=3), lambda: jffdnet.FFDNet(out_nc=1, nc=8, nb=3), 1, (0.1,)),
    "drunet": (lambda: drunet.UNetRes(2, 1, nc=(8, 16, 32, 64), nb=1),
               lambda: jdrunet.UNetRes(out_nc=1, nc=(8, 16, 32, 64), nb=1), 2, ()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_port_npz_loads_into_the_jax_model(name, tmp_path):
    tm, jm, in_nc, extra = CASES[name]
    model = convert.flax_init_(tm().double(), torch.Generator().manual_seed(1))
    path = str(tmp_path / f"{name}.npz")
    convert.save_npz(model, path)
    x = np.random.default_rng(0).random((2, in_nc, 32, 32))
    with torch.no_grad():
        got = model(torch.from_numpy(x), *(torch.tensor(e, dtype=torch.float64) for e in extra)).numpy()
    tree = jconvert.load_npz(path)
    ref = jm().apply(tree, jnp.asarray(np.moveaxis(x, 1, -1)), *(jnp.asarray(e) for e in extra))
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(ref), -1, 1), atol=1e-9, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_round_trip_through_both_packages(name, tmp_path):
    tm, jm, in_nc, extra = CASES[name]
    variables = jm().init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, in_nc)), *(jnp.asarray(e) for e in extra))
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jconvert.save_npz(jax.tree.map(np.asarray, variables), jpath)
    model = tm()
    model.load_state_dict(convert.state_dict_from_flax(model, convert.load_npz(jpath)))
    convert.save_npz(model, ppath)
    with np.load(jpath) as a, np.load(ppath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    back = jconvert.load_npz(ppath)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jax.tree.map(np.asarray, variables))):
        np.testing.assert_array_equal(x, y)


def test_stacked_weight_sets_keep_their_leading_axis(tmp_path):
    model = dncnn.IRCNN(1, 1, nc=8)
    stack = {k: torch.stack([v + i for i in range(25)]) for k, v in model.state_dict().items()}
    path = str(tmp_path / "ircnn.npz")
    convert.save_npz(stack, path)
    back = convert.state_dict_from_flax(model, convert.load_npz(path), lead=(25,))
    for k in stack:
        assert torch.equal(back[k], stack[k])
    with np.load(path) as z:
        assert z["params/layer0/conv/kernel"].shape == (25, 3, 3, 1, 8)


def test_only_conv_weights_and_biases_convert():
    with pytest.raises(ValueError):
        convert.flax_tree_from_state_dict({"head.conv.running_mean": torch.zeros(3)})


def test_flax_init_statistics():
    """lecun_normal: std 1/sqrt(fan_in) with fan_in on the Flax kernel (the
    transposed conv's counts its output channels), truncated at two
    standard deviations of the underlying normal; biases zero. Against
    Flax's own draw of the same layers, the std within 4%."""
    model = convert.flax_init_(drunet.UNetRes(2, 1, nc=(16, 32, 64, 128), nb=1), torch.Generator().manual_seed(0))
    variables = jdrunet.UNetRes(out_nc=1, nc=(16, 32, 64, 128), nb=1).init(jax.random.PRNGKey(0),
                                                                           jnp.zeros((1, 16, 16, 2)))
    flax = convert.flax_tree_from_state_dict(model)["params"]
    ref = jax.tree.map(np.asarray, variables)["params"]
    for path in (("down2_res0", "conv1"), ("down1_ds", "conv"), ("up2_us", "conv"), ("body_res0", "conv2")):
        w, wj = flax[path[0]][path[1]]["kernel"], ref[path[0]][path[1]]["kernel"]
        assert w.shape == wj.shape
        fan_in = np.prod(w.shape[:3])
        assert abs(w.std() / (1.0 / np.sqrt(fan_in)) - 1.0) < 0.04
        assert abs(w.std() / wj.std() - 1.0) < 0.04
        assert np.abs(w).max() <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-7
    d = convert.flax_init_(dncnn.DnCNN(1, 1, nc=64, nb=3), torch.Generator().manual_seed(0))
    assert all(float(b.abs().max()) == 0.0 for k, b in d.state_dict().items() if k.endswith("bias"))
    again = convert.flax_init_(dncnn.DnCNN(1, 1, nc=64, nb=3), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(d.state_dict().values(), again.state_dict().values()))
