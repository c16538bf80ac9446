"""The port's KAIR checkpoint converters against the JAX package's.

The reference's own ``.pth`` files are not in the repository, so each test
writes a state dict in the reference's key layout (the layouts the
converters' docstrings give) from seeded random tensors, with random
BatchNorm statistics where the architecture has BatchNorms (fresh ones,
mean 0 and variance 1, would make the fold trivially right). Both packages'
converters must give bit-equal trees; the port's tree must load into its
module; the folded net must equal the unfolded one with the BatchNorms
applied; and a ``.pth`` written with ``torch.save`` must give the same
denoiser through both packages' ``build_denoiser`` (float64, 1e-9).
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.models import convert as jconvert
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdn
from pnp_admm_cnc_mri_torch.models import convert, dncnn, drunet, ffdnet, unet_variants as uv
from pnp_admm_cnc_mri_torch.priors import denoiser as dn

NC = (8, 12, 16, 20)
BN_EPS = 1e-4  # the reference's BatchNorm2d eps (basicblock.conv:72)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# The reference's key of each port module (its Flax name): the KAIR prefix,
# and the prefix of the BatchNorm that follows the conv, if any.
def _seq(name, nb):
    block = name.split(".")[0]  # head, body{i}, tail (a ConvBlock each)
    i = 0 if block == "head" else nb - 1 if block == "tail" else int(block[4:]) + 1
    return f"model.{2 * i}", None


def _ircnn(name, nb):
    return f"model.{2 * int(name[5])}", None


def _drunet(name, nb):
    m = re.fullmatch(r"(down|up)(\d)_(res(\d)\.conv(\d)|ds\.conv|us\.conv)|body_res(\d)\.conv(\d)|head|tail", name)
    if name in ("head", "tail"):
        return f"m_{name}", None
    if m.group(6) is not None:
        return f"m_body.{m.group(6)}.res.{2 * (int(m.group(7)) - 1)}", None
    t = f"m_{m.group(1)}{int(m.group(2)) + 1}"
    if m.group(3) in ("ds.conv", "us.conv"):
        return (f"{t}.{nb}" if m.group(1) == "down" else f"{t}.0"), None
    slot = int(m.group(4)) + (0 if m.group(1) == "down" else 1)
    return f"{t}.{slot}.res.{2 * (int(m.group(5)) - 1)}", None


def _stage(name):
    """(kind, level, block index, rest) of a U-Net child name."""
    m = re.fullmatch(r"(down|up)(\d)_([a-z1]+?)(\d*)(\..+)?", name)
    if m:
        return m.group(1), int(m.group(2)), m.group(3), m.group(4), m.group(5) or ""
    m = re.fullmatch(r"body_([a-z]+)(\d+)(\..+)?", name)
    return "body", None, m.group(1), m.group(2), m.group(3) or ""


def _unet(name, nb):
    if name in ("head", "tail"):
        return ("m_head.0" if name == "head" else "m_tail"), None
    kind, lvl, blk, i, _ = _stage(name)
    if kind == "body":
        return f"m_body.{2 * int(i)}", None
    t = f"m_{kind}{lvl + 1}"
    if blk in ("ds", "us"):
        return (f"{t}.{2 * nb}" if blk == "ds" else f"{t}.0"), None
    return (f"{t}.{2 * int(i)}" if kind == "down" else f"{t}.{2 * (int(i) + 1)}"), None


def _resunet(name, nb):
    if name in ("head", "tail"):
        return f"m_{name}", None
    kind, lvl, blk, i, rest = _stage(name)
    t = "m_body" if kind == "body" else f"m_{kind}{lvl + 1}"
    if blk in ("ds", "us"):
        return (f"{t}.{nb}" if blk == "ds" else f"{t}.0"), None
    slot = int(i) + (1 if kind == "up" else 0)
    conv = rest[1:]
    return (f"{t}.{slot}.{conv}.0" if conv in ("conv1", "conv2", "conv3") else f"{t}.{slot}.{conv}"), None


def _unet_res_subp(name, nb):
    if name in ("head", "tail"):
        return ("m_head.0" if name == "head" else "m_tail"), None
    kind, lvl, blk, i, rest = _stage(name)
    t = "m_body" if kind == "body" else f"m_{kind}{lvl + 1}"
    if blk in ("ds", "us"):
        return (f"{t}.{nb}" if blk == "ds" else f"{t}.0"), None
    slot = int(i) + (2 if kind == "up" else 0)
    return f"{t}.{slot}.res.{0 if rest == '.conv1' else 2}", None


def _unet_plus(name, nb):
    if name in ("head", "tail"):
        return f"m_{name}", None
    kind, lvl, blk, i, _ = _stage(name)
    t = "m_body" if kind == "body" else f"m_{kind}{lvl + 1}"
    if blk == "ds":
        return f"{t}.{3 * nb}", None
    if blk == "us":
        return f"{t}.0", f"{t}.1"
    slot = 3 * (int(i) + (1 if kind == "up" else 0))
    if kind == "up" and int(i) == nb - 1:
        return f"{t}.{slot}", None
    return f"{t}.{slot}", f"{t}.{slot + 1}"


def _nonlocal_unet(name, nb):
    if name in ("head", "tail"):
        return ("m_head.0" if name == "head" else "m_tail"), None
    m = re.fullmatch(r"(down|up)_nonlocal\.(theta|phi|g|w)", name)
    if m:
        t = "m_down3.0" if m.group(1) == "down" else f"m_up3.{2 * (nb + 1)}"
        return (f"{t}.W.0", f"{t}.W.1") if m.group(2) == "w" else (f"{t}.{m.group(2)}", None)
    kind, lvl, blk, i, _ = _stage(name)
    if kind == "body":
        return f"m_body.{2 * int(i)}", None
    t = f"m_{kind}{lvl + 1}"
    off = 1 if (kind, lvl) == ("down", 2) else 0
    if blk in ("ds", "us"):
        return (f"{t}.{off + 2 * nb}" if blk == "ds" else f"{t}.0"), None
    return (f"{t}.{off + 2 * int(i)}" if kind == "down" else f"{t}.{2 * (int(i) + 1)}"), None


def kair_state_dict(module, layout, nb, seed):
    """A reference-layout state dict for ``module``'s convs (seeded normal
    weights of variance 1 / fan-in and biases, of the port's shapes, which
    are torch's), with random
    BatchNorm statistics after the convs the layout folds; and the map from
    each port conv to its (KAIR prefix, BatchNorm prefix)."""
    g = torch.Generator().manual_seed(seed)
    sd, where = {}, {}
    for key, t in module.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        pre, bn = layout(mod, nb)
        where[mod] = pre, bn
        scale = t[0].numel() ** -0.5 if leaf == "weight" else 0.1  # keeps deep nets' outputs O(1)
        sd[f"{pre}.{leaf}"] = torch.randn(t.shape, generator=g, dtype=torch.float64) * scale
        if bn is not None and leaf == "weight":
            c = t.shape[1] if isinstance(module.get_submodule(mod), torch.nn.ConvTranspose2d) else t.shape[0]
            sd[f"{bn}.weight"] = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
            sd[f"{bn}.bias"] = torch.randn(c, generator=g, dtype=torch.float64) * 0.1
            sd[f"{bn}.running_mean"] = torch.randn(c, generator=g, dtype=torch.float64) * 0.3
            sd[f"{bn}.running_var"] = torch.rand(c, generator=g, dtype=torch.float64) + 0.5
            sd[f"{bn}.num_batches_tracked"] = torch.tensor(7)
    return sd, where


def assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


ARCHS = {
    "dncnn": (lambda nb: dncnn.DnCNN(1, 1, nc=8, nb=nb), _seq, 5),
    "fdncnn": (lambda nb: dncnn.FDnCNN(2, 1, nc=8, nb=nb), _seq, 4),
    "ffdnet": (lambda nb: ffdnet.FFDNet(1, 1, nc=8, nb=nb), _seq, 4),
    "ircnn": (lambda nb: dncnn.IRCNN(1, 1, nc=8), _ircnn, None),
    "drunet": (lambda nb: drunet.UNetRes(2, 1, nc=NC, nb=nb), _drunet, 2),
    "unet": (lambda nb: uv.UNet(1, 1, nc=NC, nb=nb), _unet, 2),
    "resunet": (lambda nb: uv.ResUNet(1, 1, nc=NC, nb=nb), _resunet, 2),
    "unet_res_subp": (lambda nb: uv.UNetResSubP(1, 1, nc=NC, nb=nb), _unet_res_subp, 2),
    "unet_plus": (lambda nb: uv.UNetPlus(1, 1, nc=NC, nb=nb), _unet_plus, 2),
    "nonlocal_unet": (lambda nb: uv.NonLocalUNet(1, 1, nc=NC, nb=nb), _nonlocal_unet, 1),
}


@pytest.mark.parametrize("name", list(ARCHS))
def test_converter_tree_is_bit_equal_to_jax_and_loads(name):
    build, layout, nb = ARCHS[name]
    module = build(nb).double()
    sd, _ = kair_state_dict(module, layout, nb, seed=1)
    kw = {} if nb is None else {"nb": nb}
    tree = convert.CONVERTERS[name](sd, **kw)
    assert_trees_equal(tree, jconvert.CONVERTERS[name](sd, **kw))
    module.load_state_dict(convert.state_dict_from_flax(module, tree, torch.float64))


def test_ircnn_bundle_tree_is_bit_equal_to_jax():
    module = dncnn.IRCNN(1, 1, nc=8).double()
    bundle = {str(k): kair_state_dict(module, _ircnn, None, seed=k)[0] for k in range(25)}
    tree = convert.convert_ircnn_bundle(bundle)
    assert_trees_equal(tree, jconvert.convert_ircnn_bundle(bundle))
    sd = convert.state_dict_from_flax(module, tree, torch.float64, lead=(25,))
    assert torch.equal(sd["layer3.conv.weight"][11], bundle["11"]["model.6.weight"])


def unfolded(module, sd, where):
    """``module`` with the raw KAIR weights and the BatchNorms applied after
    their convs (eval mode: running statistics, eps 1e-4), before any
    activation: the reference's 'CBR' / 'CB' order."""
    state = {}
    for mod, (pre, _) in where.items():
        for leaf in ("weight", "bias"):
            if f"{mod}.{leaf}" in module.state_dict():
                state[f"{mod}.{leaf}"] = sd[f"{pre}.{leaf}"]
    module.load_state_dict(state)
    for mod, (_, bn) in where.items():
        if bn is None:
            continue
        conv = module.get_submodule(mod)
        inner = conv._conv_forward if isinstance(conv, torch.nn.Conv2d) else None

        def with_bn(y, bn=bn):
            return F.batch_norm(y, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"], sd[f"{bn}.weight"],
                                sd[f"{bn}.bias"], training=False, eps=BN_EPS)

        if inner is not None:
            conv._conv_forward = lambda x, w, b, inner=inner, with_bn=with_bn: with_bn(inner(x, w, b))
        else:  # a transposed conv: its parent applies the activation after it
            conv.register_forward_hook(lambda m, args, out, with_bn=with_bn: with_bn(out))
    return module


@pytest.mark.parametrize("name", ["unet_plus", "nonlocal_unet"])
def test_folded_batchnorm_equals_the_unfolded_net(name):
    build, layout, nb = ARCHS[name]
    folded = build(nb).double()
    sd, where = kair_state_dict(folded, layout, nb, seed=2)
    folded.load_state_dict(convert.state_dict_from_flax(folded, convert.CONVERTERS[name](sd, nb=nb), torch.float64))
    ref = unfolded(build(nb).double(), sd, where)
    assert sum(bn is not None for _, bn in where.values()) >= 2
    x = torch.from_numpy(np.random.default_rng(3).random((2, 1, 16, 16)))
    with torch.no_grad():
        np.testing.assert_allclose(folded.eval()(x).numpy(), ref.eval()(x).numpy(), rtol=0, atol=1e-12)


PTH = {
    # model name: (port module for the layout, nb for it, build_denoiser kwargs)
    "dncnn_25": (lambda: dncnn.DnCNN(1, 1, nc=8, nb=5), _seq, 5, dict(nc=8, nb=5)),
    "ffdnet_gray": (lambda: ffdnet.FFDNet(1, 1, nc=8, nb=15), _seq, 15, dict(nc=8)),
    "drunet_gray": (lambda: drunet.UNetRes(2, 1, nc=(8, 16, 32, 64), nb=4), _drunet, 4, dict(nc=8)),
    "ircnn_gray": (lambda: dncnn.IRCNN(1, 1, nc=8), _ircnn, None, dict(nc=8)),
}


@pytest.mark.parametrize("name", list(PTH))
def test_pth_builds_the_same_denoiser_in_both_packages(name, tmp_path):
    build, layout, nb, kw = PTH[name]
    if name == "ircnn_gray":
        obj = {str(k): kair_state_dict(build().double(), layout, nb, seed=10 + k)[0] for k in range(25)}
    else:
        obj = kair_state_dict(build().double(), layout, nb, seed=4)[0]
    path = str(tmp_path / f"{name}.pth")
    torch.save(obj, path)
    v = np.random.default_rng(5).random((2, 32, 32))
    j = jdn.build_denoiser(name, weights=path, iter_num=8, param_dtype=jnp.float64, **kw)
    t = dn.build_denoiser(name, weights=path, iter_num=8, param_dtype=torch.float64, device="cpu", **kw)
    for i in (0, 5):
        ref = np.asarray(j(jnp.asarray(v), i))
        got = t(torch.from_numpy(v), i).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


def test_resolve_weights_takes_pth_after_npz(tmp_path):
    zoo = str(tmp_path)
    open(os.path.join(zoo, "drunet_gray.pth"), "wb").close()
    assert dn.resolve_weights("drunet_gray", model_zoo=zoo) == os.path.join(zoo, "drunet_gray.pth")
    assert jdn.resolve_weights("drunet_gray", model_zoo=zoo) == os.path.join(zoo, "drunet_gray.pth")
    open(os.path.join(zoo, "drunet_gray.npz"), "wb").close()
    assert dn.resolve_weights("drunet_gray", model_zoo=zoo) == os.path.join(zoo, "drunet_gray.npz")
    with pytest.warns(UserWarning, match="no clean weights"):
        assert dn.resolve_weights("drunet_gray", model_zoo=zoo, clean=True) == os.path.join(zoo, "drunet_gray.npz")


def test_load_state_dict_reads_pth_and_npz(tmp_path):
    sd = {"m_head.weight": torch.arange(6.0).reshape(1, 1, 2, 3)}
    torch.save(sd, tmp_path / "a.pth")
    np.savez(tmp_path / "a.npz", **{k: v.numpy() for k, v in sd.items()})
    assert torch.equal(convert.load_state_dict(str(tmp_path / "a.pth"))["m_head.weight"], sd["m_head.weight"])
    np.testing.assert_array_equal(convert.load_state_dict(str(tmp_path / "a.npz"))["m_head.weight"],
                                  sd["m_head.weight"].numpy())
    assert convert.conv_w(sd["m_head.weight"]).shape == (2, 3, 1, 1)
