"""BM3D's colored core against the JAX package as it is, and in float32,
on the CPU (the float64 parity of the colored half is in
``test_torch_bm3d_colored.py``).

The same numpy image (32 x 32, the g1 noise family) goes through both
packages. JAX's exact variances are float32 arithmetic in every dtype (its
``coeff_cov_field`` and Haar bank are float32); the port computes them in
the working dtype. Tolerances (max abs): the port's float64 exact call
against the JAX package's float64 call, 1e-7 (measured 2.2e-8); float32
against the JAX package's float32 call, 2e-5 (measured 3.6e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.data import noise as jnoise
from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore
from pnp_admm_cnc_mri_torch.priors.bm3d import core

N = 32
JAX_F32_VARS_ATOL = 1e-7
F32_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _family(fam, var=0.02, seed=0, n=N):
    """(noisy image, PSD) of a noise family on a smooth disc, the PSD
    computed as ``get_experiment_noise`` computes it."""
    yy, xx = np.mgrid[:n, :n]
    x = 0.5 + 0.3 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    x = np.where((xx - n / 2) ** 2 + (yy - n / 2) ** 2 < (n / 3) ** 2, x, 0.1)
    k = jnoise.get_experiment_kernel(fam, var)
    return x + jnoise.synth_colored_noise((n, n), k, seed=seed), np.abs(np.fft.fft2(k, (n, n))) ** 2 * n * n


def test_exact_path_against_the_jax_packages_float32_variances():
    z, psd = _family("g1")
    got = core.bm3d_colored(torch.from_numpy(z), psd, exact=True, device="cpu")
    want = np.asarray(jcore.bm3d_colored(jnp.asarray(z), psd, exact=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_F32_VARS_ATOL)


def test_bm3d_colored_f32():
    z, psd = _family("g1")
    got = core.bm3d_colored(torch.from_numpy(z).float(), psd, exact=True, device="cpu")
    assert got.dtype == torch.float32
    want = np.asarray(jcore.bm3d_colored(jnp.asarray(z, jnp.float32), psd, exact=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL)
