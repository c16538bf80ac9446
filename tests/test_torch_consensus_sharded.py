"""The sharded consensus solvers (``parallel/consensus.py``'s
``run_consensus_sharded``, ``run_consensus_hqs_sharded``,
``run_consensus_fista_sharded``) against the JAX package's on a 4-device
mesh and against the port's one-process ``run_consensus*``, on the CPU.

The port's side runs once, in a world of 4 gloo ranks
(``test_torch_ranks.consensus_rank``), on one 32 x 32 scene seen through 8
random masks (2 a rank): ADMM in float64 and float32, HQS with a small
Flax-initialised DnCNN (nc 8, nb 3) as the denoiser and with an ``alphas``
ladder given, FISTA with and without the preconditioner. Every rank's
result is compared. Limits: float64 1e-9; float32
``tests/test_consensus.py``'s ``rtol=2e-5, atol=1e-6``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.models import convert as jconvert
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.ops import prox as jprox
from pnp_admm_cnc_mri_tpu.parallel import consensus as jconsensus
from pnp_admm_cnc_mri_tpu.parallel import mesh as jmesh
from pnp_admm_cnc_mri_torch.ops import prox
from pnp_admm_cnc_mri_torch.parallel import consensus

from test_torch_ranks import (
    CONSENSUS_CFG,
    FISTA_ITERS,
    FISTA_LAM,
    HQS_ALPHAS,
    HQS_ITERS,
    consensus_inputs,
    consensus_rank,
    dncnn_denoiser,
    launch,
    load_ranks,
    smooth,
)

WORLD = 4
F64_ATOL = 1e-9
F32 = dict(rtol=2e-5, atol=1e-6)
CPU = "cpu"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    model = jdncnn.DnCNN(out_nc=1, nc=8, nb=3)
    tree = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 1)))
    path = str(tmp_path_factory.mktemp("consensus_weights") / "dncnn.npz")
    jconvert.save_npz(jax.tree.map(lambda a: np.asarray(a, np.float64), tree), path)
    return path, model, jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    out = str(tmp_path_factory.mktemp("consensus"))
    launch(consensus_rank, WORLD, out, weights[0])
    return load_ranks(out, "consensus", WORLD)


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])


def _all_close(ranks, key, *wants, f64=True):
    for res in ranks:
        got = res[key]
        assert got.shape == wants[0].shape and got.dtype == (torch.float64 if f64 else torch.float32)
        for want in wants:
            if f64:
                np.testing.assert_allclose(got.numpy(), want, atol=F64_ATOL, rtol=0)
            else:
                np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_admm_matches_jax_sharded_and_the_one_process_solve(ranks, jax_mesh, precision):
    _, masks, ys = consensus_inputs()
    if precision == "f32":
        ys, masks = ys.astype(np.complex64), masks.astype(np.float32)
    jdt, tdt = (jnp.float64, torch.float64) if precision == "f64" else (jnp.float32, torch.float32)
    want_jax = np.asarray(jconsensus.run_consensus_sharded(jnp.asarray(ys), jnp.asarray(masks), CONSENSUS_CFG,
                                                           jax_mesh, dtype=jdt))
    want_port = consensus.run_consensus(ys, masks, CONSENSUS_CFG, dtype=tdt, device=CPU)[0].numpy()
    _all_close(ranks, f"admm_{precision}", want_jax, want_port, f64=precision == "f64")


def test_hqs_with_a_dncnn_denoiser(ranks, jax_mesh, weights):
    path, jmodel, jtree = weights
    _, masks, ys = consensus_inputs()

    def jdenoise(u, i):
        return jmodel.apply(jtree, u[None, ..., None])[0, ..., 0]

    want_jax = np.asarray(jconsensus.run_consensus_hqs_sharded(jnp.asarray(ys), jnp.asarray(masks), HQS_ITERS,
                                                               jdenoise, jax_mesh, dtype=jnp.float64))
    want_port = consensus.run_consensus_hqs(ys, masks, HQS_ITERS, dncnn_denoiser(path, torch.float64),
                                            dtype=torch.float64, device=CPU).numpy()
    _all_close(ranks, "hqs_dncnn", want_jax, want_port)


def test_hqs_with_alphas_given(ranks, jax_mesh):
    _, masks, ys = consensus_inputs()

    def jsmooth(v, i):
        k = sum(jnp.roll(v, (a, b), (-2, -1)) for a in (-1, 0, 1) for b in (-1, 0, 1)) / 9.0
        return (0.5 + 0.1 * i) * k + (0.5 - 0.1 * i) * v

    want_jax = np.asarray(jconsensus.run_consensus_hqs_sharded(jnp.asarray(ys), jnp.asarray(masks), HQS_ITERS,
                                                               jsmooth, jax_mesh, dtype=jnp.float64,
                                                               alphas=HQS_ALPHAS))
    want_port = consensus.run_consensus_hqs(ys, masks, HQS_ITERS, smooth, dtype=torch.float64, alphas=HQS_ALPHAS,
                                            device=CPU).numpy()
    _all_close(ranks, "hqs_alphas", want_jax, want_port)
    # the ladder given is the one used: the default ladder gives another result
    default = consensus.run_consensus_hqs(ys, masks, HQS_ITERS, smooth, dtype=torch.float64, device=CPU).numpy()
    assert np.abs(default - want_port).max() > 1e-3


@pytest.mark.parametrize("precondition", [True, False])
def test_fista_matches_jax_sharded_and_the_one_process_solve(ranks, jax_mesh, precondition):
    _, masks, ys = consensus_inputs()
    want_jax = np.asarray(jconsensus.run_consensus_fista_sharded(
        jnp.asarray(ys), jnp.asarray(masks), FISTA_ITERS, lambda i, u: jprox.soft(u, FISTA_LAM), jax_mesh,
        dtype=jnp.float64, precondition=precondition))
    want_port = consensus.run_consensus_fista(ys, masks, FISTA_ITERS, lambda i, u: prox.soft(u, FISTA_LAM),
                                              dtype=torch.float64, precondition=precondition, device=CPU).numpy()
    _all_close(ranks, f"fista_{precondition}", want_jax, want_port)
