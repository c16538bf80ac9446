"""The port's U-Net catalog and its blocks against the JAX package's Flax modules.

Each Flax module is initialised at a reduced width (the JAX tests' ``NC =
(8, 12, 16, 20)``), its tree's every leaf nudged by seeded noise (Flax
starts biases at zero, which would leave the bias mapping untested), and
the tree carried onto the port's module by
``models.convert.state_dict_from_flax``. Both run the same numpy input:
Flax NHWC, the port NCHW. Tolerances as in ``test_torch_models.py``:
float64 1e-9, float32 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.models import blocks as jblocks
from pnp_admm_cnc_mri_tpu.models import unet_variants as juv
from pnp_admm_cnc_mri_torch.models import blocks, convert, unet_variants as uv

ATOL = {torch.float64: 1e-9, torch.float32: 1e-4}
NP = {torch.float64: np.float64, torch.float32: np.float32}
NC = (8, 12, 16, 20)
DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def flax_tree(model, x, seed=0):
    """Flax-initialised variables of ``model`` with every leaf nudged, numpy."""
    variables = jax.tree.map(np.asarray, dict(model.init(jax.random.PRNGKey(seed), jnp.asarray(x))))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype), variables)


def run_both(jmodel, tmodel, x, dtype):
    """Both forwards of the NCHW numpy input ``x``; (port, Flax) as NCHW numpy."""
    x = x.astype(NP[dtype])
    xh = np.moveaxis(x, 1, -1)
    tree = flax_tree(jmodel, xh)
    ref = np.moveaxis(np.asarray(jmodel.apply(tree, jnp.asarray(xh))), -1, 1)
    mod = tmodel.to(dtype)
    mod.load_state_dict(convert.state_dict_from_flax(mod, tree, dtype))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == NP[dtype] and got.shape == ref.shape
    return got, ref


BLOCKS = {
    "imd": (lambda: jblocks.IMDBlock(16), lambda: blocks.IMDBlock(16), 16),
    "imd_bias_free_relu": (lambda: jblocks.IMDBlock(12, act="R", use_bias=False),
                           lambda: blocks.IMDBlock(12, act="R", use_bias=False), 12),
    "calayer": (lambda: jblocks.CALayer(16, reduction=4), lambda: blocks.CALayer(16, reduction=4), 16),
    "rcab": (lambda: jblocks.RCABlock(16, reduction=4), lambda: blocks.RCABlock(16, reduction=4), 16),
    "rcagroup": (lambda: jblocks.RCAGroup(8, nb=2, reduction=4), lambda: blocks.RCAGroup(8, nb=2, reduction=4), 8),
    "rdb5c": (lambda: jblocks.ResidualDenseBlock5C(12, gc=8), lambda: blocks.ResidualDenseBlock5C(12, gc=8), 12),
    "rrdb": (lambda: jblocks.RRDB(16, gc=8), lambda: blocks.RRDB(16, gc=8), 16),
    "nonlocal": (lambda: jblocks.NonLocalBlock(12), lambda: blocks.NonLocalBlock(12), 12),
    "nonlocal_pooled": (lambda: jblocks.NonLocalBlock(12, downsample=True),
                        lambda: blocks.NonLocalBlock(12, downsample=True), 12),
    "down_maxpool": (lambda: jblocks.DownMaxPool(10, act="R"), lambda: blocks.DownMaxPool(6, 10, act="R"), 6),
    "down_avgpool": (lambda: jblocks.DownAvgPool(10, act="L"), lambda: blocks.DownAvgPool(6, 10, act="L"), 6),
    "up_nearest": (lambda: jblocks.UpNearestConv(5, act="R"), lambda: blocks.UpNearestConv(6, 5, act="R"), 6),
    "up_pixelshuffle": (lambda: jblocks.UpPixelShuffle(5, use_bias=False),
                        lambda: blocks.UpPixelShuffle(6, 5, use_bias=False), 6),
}


@DTYPES
@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name, dtype):
    jm, tm, c = BLOCKS[name]
    x = np.random.default_rng(1).random((2, c, 12, 10)) - 0.5
    got, ref = run_both(jm(), tm(), x, dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])


VARIANTS = {
    "unet": (lambda: juv.UNet(out_nc=1, nc=NC, nb=2), lambda: uv.UNet(1, 1, nc=NC, nb=2), (2, 1, 16, 16)),
    # 20 x 20 takes the replication pad to 24 and the crop back
    "resunet": (lambda: juv.ResUNet(out_nc=1, nc=NC, nb=2), lambda: uv.ResUNet(1, 1, nc=NC, nb=2), (1, 1, 20, 20)),
    "unet_res_subp": (lambda: juv.UNetResSubP(out_nc=1, nc=NC, nb=2), lambda: uv.UNetResSubP(1, 1, nc=NC, nb=2),
                      (1, 1, 32, 32)),
    "unet_plus": (lambda: juv.UNetPlus(out_nc=1, nc=NC, nb=2), lambda: uv.UNetPlus(1, 1, nc=NC, nb=2),
                  (1, 1, 16, 16)),
    "nonlocal_unet": (lambda: juv.NonLocalUNet(out_nc=1, nc=NC, nb=1), lambda: uv.NonLocalUNet(1, 1, nc=NC, nb=1),
                      (2, 1, 16, 24)),
}


@DTYPES
@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_flax(name, dtype):
    jm, tm, shape = VARIANTS[name]
    x = np.random.default_rng(2).random(shape)
    got, ref = run_both(jm(), tm(), x, dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("down", ["strideconv", "maxpool", "avgpool"])
@pytest.mark.parametrize("up", ["convtranspose", "upconv", "pixelshuffle"])
def test_unet_sampler_modes_match_flax(down, up):
    """Every pair of the ``_DOWN`` / ``_UP`` registries, float64."""
    x = np.random.default_rng(3).random((1, 1, 16, 16))
    got, ref = run_both(juv.UNet(out_nc=1, nc=(4, 6, 8, 10), nb=1, downsample_mode=down, upsample_mode=up),
                        uv.UNet(1, 1, nc=(4, 6, 8, 10), nb=1, downsample_mode=down, upsample_mode=up),
                        x, torch.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[torch.float64])


def test_variants_keep_the_flax_defaults():
    """The default ``nb`` and widths of each variant, as the JAX modules
    have them, and the same parameter names and shapes at those defaults."""
    for jcls, tcls, nb in ((juv.UNet, uv.UNet, 2), (juv.ResUNet, uv.ResUNet, 4), (juv.UNetResSubP, uv.UNetResSubP, 2),
                           (juv.UNetPlus, uv.UNetPlus, 1), (juv.NonLocalUNet, uv.NonLocalUNet, 1)):
        assert jcls().nb == nb and tcls().nb == nb
        j = jcls(nc=NC)
        tree = jax.tree.map(np.asarray, dict(j.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))))
        sd = convert.state_dict_from_flax(tcls(nc=NC), tree, torch.float64)  # raises on any mismatch
        assert len(sd) == len(jax.tree.leaves(tree))
