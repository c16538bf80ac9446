"""The port's mesh and reductions (``parallel/mesh.py``,
``parallel/reductions.py``) against the JAX package's, on the CPU.

The port's side runs once, in a world of 4 gloo ranks
(``test_torch_ranks.mesh_rank``): the 1 x 4 and 2 x 2 meshes' coordinates
and groups, the default mesh (all ranks on ``data``), the ``shard_batch`` /
``gather_batch`` round trip and the raise on an axis that does not divide,
and the three reductions over ``data``. The JAX side runs here under
``shard_map`` on 4 of the 8 host devices of ``tests/conftest.py``, on the
same float64 inputs (limit 1e-9; both sum four shards).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pnp_admm_cnc_mri_tpu.parallel import mesh as jmesh
from pnp_admm_cnc_mri_tpu.parallel import reductions as jred
from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib
from pnp_admm_cnc_mri_torch.parallel import reductions

from test_torch_ranks import launch, load_ranks, mesh_inputs, mesh_rank

WORLD = 4
F64_ATOL = 1e-9


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    launch(mesh_rank, WORLD, out)
    return load_ranks(out, "mesh", WORLD)


def _jax_shard_map(fn, n_in):
    mesh = jmesh.make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    return jax.shard_map(fn, mesh=mesh, in_specs=(P("data"),) * n_in, out_specs=P())


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_coordinates_and_groups(ranks, shape):
    nd, ns = map(int, shape.split("x"))
    for r, res in enumerate(ranks):
        m = res[shape]
        assert m["shape"] == {"data": nd, "space": ns}
        assert m["coords"] == {"data": r // ns, "space": r % ns}
        assert m["data"] == [d * ns + r % ns for d in range(nd)]
        assert m["space"] == [(r // ns) * ns + s for s in range(ns)]


def test_2x2_sums_stay_in_their_groups(ranks):
    # ones over a column (2 ranks); rank + 1 over a row: 1 + 2 and 3 + 4
    assert [res["2x2_sums"] for res in ranks] == [[2.0, 3.0], [2.0, 3.0], [2.0, 7.0], [2.0, 7.0]]


def test_default_mesh_puts_every_rank_on_data(ranks):
    assert all(res["default_shape"] == {"data": WORLD, "space": 1} for res in ranks)


def test_shard_and_gather_round_trip(ranks):
    x = mesh_inputs()["x"]
    for r, res in enumerate(ranks):
        assert torch.equal(res["local"], torch.from_numpy(x[r * 4:(r + 1) * 4]))
        assert torch.equal(res["gathered"], torch.from_numpy(x))


def test_shard_batch_raises_where_the_axis_does_not_divide(ranks):
    assert all("does not divide" in (res["raise"] or "") for res in ranks)


def test_global_mean_matches_jax(ranks):
    inp = mesh_inputs()
    f = _jax_shard_map(lambda a, b: jred.global_mean(jnp.mean(jred.primal_residual_norm(a, b))), 2)
    want = float(f(jnp.asarray(inp["x"]), jnp.asarray(inp["z"])))
    for res in ranks:
        assert abs(float(res["global_mean"]) - want) < F64_ATOL


def test_global_sum_matches_jax(ranks):
    x = mesh_inputs()["x"]
    want = np.asarray(_jax_shard_map(lambda a: jred.global_sum(jnp.sum(a, axis=0)), 1)(jnp.asarray(x)))
    for res in ranks:
        np.testing.assert_allclose(res["global_sum"].numpy(), want, atol=F64_ATOL, rtol=0)


def test_converged_fraction_matches_jax(ranks):
    r_ = mesh_inputs()["res"]
    want = float(_jax_shard_map(lambda a: jred.converged_fraction(a, 0.5), 1)(jnp.asarray(r_)))
    assert want == float(np.mean(r_ < 0.5))
    for res in ranks:
        assert res["converged_fraction"].dtype == torch.float32 and float(res["converged_fraction"]) == want


@pytest.mark.parametrize("n,multiple", [(13, 8), (16, 8), (3, 2), (1, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.random.default_rng(n).random((n, 3, 2))
    got, got_n = mesh_lib.pad_to_multiple(x, multiple)
    want, want_n = jmesh.pad_to_multiple(x, multiple)
    assert got_n == want_n == n and got.shape[0] % multiple == 0
    np.testing.assert_array_equal(got, want)


def test_make_mesh_without_a_group_is_1x1():
    assert not torch.distributed.is_initialized()
    mesh = mesh_lib.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "space": 1} and not mesh.distributed
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh_lib.shard_batch(x, mesh), x) and torch.equal(mesh_lib.gather_batch(x, mesh), x)
    assert float(reductions.global_mean(torch.tensor(2.5), mesh)) == 2.5
    with pytest.raises(ValueError, match="mesh 2x1"):
        mesh_lib.make_mesh(n_data=2, device="cpu")


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_lib.make_mesh()
