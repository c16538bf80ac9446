"""The port's numpy replica of JAX's normal stream (``utils/jax_random.py``)
against ``jax.random`` itself, on the CPU.

The bits must equal ``jax.random.bits`` exactly; the normals must be within
1e-6 of ``jax.random.normal`` (measured: equal, 0.0, on every case here and
at 15 x 256 x 256).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_torch.utils import jax_random

NORMAL_ATOL = 1e-6
CASES = [(0, (3, 64, 64)), (1, (7,)), (12345, (5, 33, 17)), (2 ** 32 - 1, (4, 31, 29)), (7, (1,)), (3, (2, 1, 3))]


@pytest.mark.parametrize("seed,shape", CASES)
def test_bits_equal_jax(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))
    got = jax_random.bits(seed, shape)
    assert got.dtype == np.uint32 and got.shape == shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed,shape", CASES)
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    got = jax_random.normal(seed, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert np.all(np.isfinite(got))
    assert float(np.abs(got - want).max()) <= NORMAL_ATOL


def test_uniform_is_the_mantissa_trick():
    u = jax_random.uniform(5, (4096,))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    assert u.dtype == np.float32 and u.min() >= lo and u.max() < 1.0
    want = jax.random.uniform(jax.random.PRNGKey(5), (4096,), jnp.float32, lo, 1.0)
    assert np.array_equal(u, np.asarray(want))


@pytest.mark.parametrize("seed", [-1, 2 ** 32])
def test_seed_outside_the_key_range_raises(seed):
    with pytest.raises(ValueError, match="2\\*\\*32"):
        jax_random.normal(seed, (3,))


def test_float64_raises():
    with pytest.raises(ValueError, match="float32"):
        jax_random.normal(0, (3,), np.float64)
