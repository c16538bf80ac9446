"""The distributed 2-D FFT and ``spatial_admm_l1`` (``parallel/spatial.py``)
against numpy, the JAX package and the port's one-device ``admm_l1``, on
the CPU.

The port's side runs once, in a world of 4 gloo ranks
(``test_torch_ranks.spatial_rank``): both FFTs at ``space`` 4 on a 32 x 64
float64 plane, ``spatial_admm_l1`` at ``space`` 4 on a 64 x 64 scene (15
iterations) in float64 and float32, and the (data 2, space 2) case of
``tests/test_spatial.py:70`` (a 4 x 32 x 64 batch, 10 iterations). The JAX
side runs here under ``shard_map`` on the host devices of
``tests/conftest.py``. Limits: float64 1e-9; float32 the JAX test's 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pnp_admm_cnc_mri_tpu.ops import prox as jprox
from pnp_admm_cnc_mri_tpu.parallel import mesh as jmesh
from pnp_admm_cnc_mri_tpu.parallel import spatial as jspatial
from pnp_admm_cnc_mri_torch.solvers import admm

from test_torch_ranks import SPATIAL_CFG, SPATIAL_CFG_B, launch, load_ranks, spatial_inputs, spatial_rank

WORLD = 4
F64_ATOL = 1e-9
F32_TOL = 1e-4  # tests/test_spatial.py's rtol and atol


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spatial"))
    launch(spatial_rank, WORLD, out)
    return load_ranks(out, "spatial", WORLD)


@pytest.fixture(scope="module")
def jmesh_space():
    return jmesh.make_mesh(n_data=1, n_space=WORLD, devices=jax.devices()[:WORLD])


def _jax_cols(plane, mesh):
    f = jax.shard_map(lambda a: jspatial.fft2_rows_to_cols(a, "space"), mesh=mesh, in_specs=P("space", None),
                      out_specs=P(None, "space"))
    return np.asarray(f(jnp.asarray(plane)))


def test_fft2_rows_to_cols_matches_numpy_and_jax(ranks, jmesh_space):
    plane = spatial_inputs()["plane"]
    want, jax_cols = np.fft.fft2(plane), _jax_cols(plane, jmesh_space)
    for s, res in enumerate(ranks):
        got = res["cols"].numpy()
        assert got.shape == (32, 16)
        np.testing.assert_allclose(got, want[:, s * 16:(s + 1) * 16], atol=F64_ATOL, rtol=0)
        np.testing.assert_allclose(got, jax_cols[:, s * 16:(s + 1) * 16], atol=F64_ATOL, rtol=0)


def test_ifft2_cols_to_rows_inverts_it(ranks, jmesh_space):
    plane = spatial_inputs()["plane"]
    f = jax.shard_map(lambda a: jnp.real(jspatial.ifft2_cols_to_rows(jspatial.fft2_rows_to_cols(a, "space"), "space")),
                      mesh=jmesh_space, in_specs=P("space", None), out_specs=P("space", None))
    jax_rows = np.asarray(f(jnp.asarray(plane)))
    for s, res in enumerate(ranks):
        got = res["round_trip"].numpy()
        np.testing.assert_allclose(got, plane[s * 8:(s + 1) * 8], atol=F64_ATOL, rtol=0)
        np.testing.assert_allclose(got, jax_rows[s * 8:(s + 1) * 8], atol=F64_ATOL, rtol=0)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_spatial_admm_l1_matches_jax_and_the_one_device_solve(ranks, jmesh_space, precision):
    inp = spatial_inputs()
    cplx, jdt, tdt = {"f64": (np.complex128, jnp.float64, torch.float64),
                      "f32": (np.complex64, jnp.float32, torch.float32)}[precision]
    y, mask = inp["y"].astype(cplx), inp["mask"].astype(np.float32)
    want_jax = np.asarray(jspatial.spatial_admm_l1(jnp.asarray(y), jnp.asarray(mask), SPATIAL_CFG, jmesh_space,
                                                   dtype=jdt))
    want_port = admm.admm_l1(y, mask, SPATIAL_CFG, dtype=tdt, fused=False, device="cpu")[0].x.numpy()
    tol = dict(atol=F64_ATOL, rtol=0) if precision == "f64" else dict(atol=F32_TOL, rtol=F32_TOL)
    for res in ranks:
        assert res[f"admm_{precision}"].shape == (64, 64) and res[f"admm_{precision}"].dtype == tdt
        got = res[f"admm_{precision}"].numpy()
        np.testing.assert_allclose(got, want_jax, **tol)
        np.testing.assert_allclose(got, want_port, **tol)


def test_batched_and_spatially_sharded_2x2(ranks):
    """``tests/test_spatial.py:70`` at data 2 x space 2: the batch over
    ``data``, each image's rows over ``space``."""
    inp = spatial_inputs()
    mesh = jmesh.make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4])
    cfg = SPATIAL_CFG_B

    def local(y_l, m_l):
        la2 = 1.0 / (2.0 * cfg.rho)
        x0 = jnp.abs(jspatial.ifft2_cols_to_rows(y_l, "space")).astype(jnp.float32)
        z, w, x = x0, jnp.zeros_like(x0), x0
        for _ in range(cfg.iter_num):
            vf = jspatial.fft2_rows_to_cols((z - w).astype(jnp.float32), "space")
            xf = jnp.where(m_l != 0, (la2 * vf + y_l) / (1.0 + la2), vf)
            x = jnp.abs(jnp.real(jspatial.ifft2_cols_to_rows(xf, "space"))).astype(jnp.float32)
            z = jprox.soft(x + w, cfg.rho * cfg.lam)
            w = w + x - z
        return x

    f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("data", None, "space"), P(None, "space")),
                              out_specs=P("data", "space", None)))
    y = inp["y_b"].astype(np.complex64)
    mask = inp["mask_b"].astype(np.float32)
    want_jax = np.asarray(f(jnp.asarray(y), jnp.asarray(mask)))
    want_port = admm.admm_l1(y, mask, cfg, fused=False, use_rfft=False, device="cpu")[0].x.numpy()
    for res in ranks:
        got = res["batched_2x2"].numpy()
        assert got.shape == (4, 32, 64)
        np.testing.assert_allclose(got, want_jax, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(got, want_port, rtol=F32_TOL, atol=F32_TOL)
