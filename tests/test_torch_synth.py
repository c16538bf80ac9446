"""The port's procedural generators (``train/synth.py``) against the JAX
package's.

torch's generator cannot replay ``jax.random``, so each family is held by
its statistics: the mean, the standard deviation and the gradient energy
(mean squared forward difference, both axes) of 32 images at 64 x 64 from
seed 0 in each package. Over seeds 0-3 the per-draw spread of these
statistics was up to 3.5% of their value (JAX and port alike); a seed-0
pair differed by at most 9.6% (the phantoms' gradient energy). The limit,
15% (about 4 spreads), catches a wrong formula (a blur, a range or a
radius law off by a factor) and not the sampling. The elastic warp's
bilinear reflect gather is held exactly against
``jax.scipy.ndimage.map_coordinates``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.ndimage import map_coordinates

from pnp_admm_cnc_mri_tpu.train import synth as jsynth
from pnp_admm_cnc_mri_torch.train import synth

STAT_RTOL = 0.15


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def seeds():
    return np.random.default_rng(0).random((3, 96, 96)).astype(np.float32)


def _stats(a):
    a = np.asarray(a, np.float64)
    ge = np.mean(np.diff(a, axis=-1) ** 2) + np.mean(np.diff(a, axis=-2) ** 2)
    return np.array([a.mean(), a.std(), ge])


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


FAMILIES = {
    "dead_leaves": (lambda k, n, s: jsynth.dead_leaves(k, n, 64), lambda g, n, s: synth.dead_leaves(g, n, 64)),
    "gaussian_fields": (lambda k, n, s: jsynth.gaussian_fields(k, n, 64),
                        lambda g, n, s: synth.gaussian_fields(g, n, 64)),
    "mri_phantoms": (lambda k, n, s: jsynth.mri_phantoms(k, n, 64), lambda g, n, s: synth.mri_phantoms(g, n, 64)),
    "elastic_warps": (lambda k, n, s: jsynth.elastic_warps(k, jnp.asarray(s), n, 64),
                      lambda g, n, s: synth.elastic_warps(g, torch.from_numpy(s), n, 64)),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_generator_shape_range_and_determinism(name, seeds):
    f = FAMILIES[name][1]
    a = f(_gen(3), 4, seeds)
    assert a.shape == (4, 64, 64) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0 and float(a.std()) > 0.01
    assert torch.equal(a, f(_gen(3), 4, seeds))
    assert not torch.equal(a, f(_gen(4), 4, seeds))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_generator_statistics_match_the_jax_package(name, seeds):
    jf, tf = FAMILIES[name]
    ref = _stats(jf(jax.random.PRNGKey(0), 32, seeds))
    got = _stats(tf(_gen(0), 32, seeds).numpy())
    np.testing.assert_allclose(got, ref, rtol=STAT_RTOL)


def test_dead_leaves_paints_the_first_covering_disk():
    """The vectorised painting equals a loop over the disks, front to back,
    in any block size."""
    g = _gen(1)
    ref = synth.dead_leaves(g, 3, 32, n_disks=40, sigma_blur=0.0)
    old = synth._COVER_BLOCK
    try:
        synth._COVER_BLOCK = 32 * 32  # one image and one disk a block: the plain loop
        got = synth.dead_leaves(_gen(1), 3, 32, n_disks=40, sigma_blur=0.0)
    finally:
        synth._COVER_BLOCK = old
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-6)], ids=["f64", "f32"])
def test_reflect_gather_matches_jax_map_coordinates(dtype, atol):
    r = np.random.default_rng(2)
    img = r.random((3, 17, 23)).astype(dtype)
    # inside, on the edges and far outside (several reflections)
    y = r.uniform(-40, 57, (3, 9, 11)).astype(dtype)
    x = r.uniform(-50, 70, (3, 9, 11)).astype(dtype)
    y[0, 0, :4] = [0.0, 16.0, -0.5, 16.5]
    x[0, 0, :4] = [0.0, 22.0, -0.5, 22.5]
    ref = np.stack([np.asarray(map_coordinates(jnp.asarray(img[i]), [jnp.asarray(y[i]), jnp.asarray(x[i])],
                                               order=1, mode="reflect")) for i in range(3)])
    got = synth.map_coordinates_reflect(torch.from_numpy(img), torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("n", [1, 7, 8, 64, 4096])
@pytest.mark.parametrize("with_seeds", [False, True], ids=["no_seeds", "seeds"])
def test_make_generator_family_counts(n, with_seeds, seeds):
    gen = synth.make_generator(size=32, seeds=torch.from_numpy(seeds) if with_seeds else None, n_disks=20)
    mix = list((0.35, 0.2, 0.3, 0.15)) if with_seeds else [0.35, 0.2, 0.45, 0.0]
    tot = sum(mix)
    mix = [m / tot for m in mix]
    n_dl, n_gf, n_wp = (int(round(n * mix[0])), int(round(n * mix[1])), int(round(n * mix[3])))
    assert synth.family_counts(n, gen.mix) == (n_dl, n_gf, n - n_dl - n_gf - n_wp, n_wp)
    if n <= 64:
        out = gen(_gen(0), n)
        assert out.shape == (n, 32, 32) and torch.equal(out, gen(_gen(0), n))


def test_load_warp_seeds_match_the_jax_package():
    ref = jsynth.load_warp_seeds(side=64)
    got = synth.load_warp_seeds(side=64, device="cpu")
    assert ref is not None and got is not None
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert synth.warp_seed_stack({}) is None
