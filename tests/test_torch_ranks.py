"""The programs that the multi-rank tests run in spawned ranks, their
inputs, and the tests of the launcher itself (``parallel/mesh.launch_local``).

Each ``*_rank`` function runs in every rank of a gloo world of CPU
processes (``launch(fn, world, ...)``) and writes what it computed to
``<out>/<name>_rank<r>.pt``; the test files (``test_torch_mesh.py``,
``_spatial.py``, ``_consensus_sharded.py``, ``_trainer.py``, ``_sweep.py``,
``_train_cli.py``) compare those results with the JAX package and with the
port on one process. This module imports torch, numpy and the port only:
every rank imports it, and a rank that imported JAX as well would take
twice as long to start. The inputs are made here from seeds, so that the
ranks and the test process build the same arrays.
"""

import contextlib
import importlib
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.parallel import consensus, spatial
from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib
from pnp_admm_cnc_mri_torch.parallel.reductions import (
    converged_fraction,
    global_mean,
    global_sum,
    primal_residual_norm,
)

LAUNCH_TIMEOUT_S = 240.0  # a broken rank fails its test within this, never the whole run


def launch(fn, world, *args):
    """``fn(*args)`` in ``world`` gloo ranks on the CPU, one thread each."""
    mesh_lib.launch_local(fn, world, args, timeout_s=LAUNCH_TIMEOUT_S, threads=1)


def load_ranks(out, name, world):
    return [torch.load(os.path.join(out, f"{name}_rank{r}.pt")) for r in range(world)]


def _save(out, name, obj):
    torch.save(obj, os.path.join(out, f"{name}_rank{dist.get_rank()}.pt"))


# -- inputs -------------------------------------------------------------------


def mesh_inputs():
    r = np.random.default_rng(21)
    return {"x": r.random((16, 8, 8)), "z": r.random((16, 8, 8)), "res": r.random(16)}


def spatial_inputs():
    """A 32 x 64 real plane; one 64 x 64 scene's k-space; a (4, 32, 64) batch's."""
    r = np.random.default_rng(22)
    plane = r.random((32, 64))
    img = r.random((64, 64))
    mask = (r.random((64, 64)) < 0.3).astype(np.float64)
    y = np.fft.fft2(img) * mask + 0.3 * (r.normal(size=(64, 64)) + 1j * r.normal(size=(64, 64)))
    imgs = r.random((4, 32, 64))
    mask_b = (r.random((32, 64)) < 0.3).astype(np.float64)
    y_b = np.fft.fft2(imgs, axes=(-2, -1)) * mask_b + 0.3 * (r.normal(size=(32, 64)) + 1j * r.normal(size=(32, 64)))
    return {"plane": plane, "y": y, "mask": mask, "y_b": y_b, "mask_b": mask_b}


SPATIAL_CFG = ADMMConfig(iter_num=15, lam=0.1, rho=0.015)
SPATIAL_CFG_B = ADMMConfig(iter_num=10, lam=0.1, rho=0.015)


def consensus_inputs(n_obs=8, n=32):
    """One scene seen through ``n_obs`` random 25% masks with their own noise
    (``tests/test_consensus.py``'s scenario)."""
    r = np.random.default_rng(23)
    img = r.random((n, n))
    masks = np.stack([(r.random((n, n)) < 0.25).astype(np.float64) for _ in range(n_obs)])
    noises = 0.3 * (r.normal(size=(n_obs, n, n)) + 1j * r.normal(size=(n_obs, n, n)))
    return img, masks, np.fft.fft2(img[None], axes=(-2, -1)) * masks + noises


CONSENSUS_CFG = ADMMConfig(iter_num=15, lam=0.1, rho=0.05)
HQS_ITERS = 4
FISTA_ITERS = 8
FISTA_LAM = 0.02
HQS_ALPHAS = np.linspace(0.5, 0.05, HQS_ITERS)


def smooth(v, i):
    """A denoiser both packages compute alike: a 3 x 3 box blend, weighted by the iteration."""
    k = sum(torch.roll(v, (a, b), (-2, -1)) for a in (-1, 0, 1) for b in (-1, 0, 1)) / 9.0
    return (0.5 + 0.1 * i) * k + (0.5 - 0.1 * i) * v


def dncnn_denoiser(weights, dtype):
    """``denoise(u, i)`` of a DnCNN (nc 8, nb 3) with the Flax tree in ``weights``."""
    from pnp_admm_cnc_mri_torch.models import convert, dncnn

    model = dncnn.DnCNN(1, 1, nc=8, nb=3)
    model.load_state_dict(convert.state_dict_from_flax(model, convert.load_npz(weights), dtype))
    model = model.to(dtype).eval()

    def denoise(u, i):
        with torch.no_grad():
            return model(u[None, None])[0, 0]

    return denoise


def trainer_batch():
    """``tests/test_train.py:99-102``'s batch, NHWC float32."""
    rng = np.random.default_rng(0)
    noisy = rng.standard_normal((8, 16, 16, 1)).astype(np.float32)
    clean = rng.standard_normal((8, 16, 16, 1)).astype(np.float32)
    return noisy, clean, np.full((8, 1, 1, 1), 0.1, np.float32)


def trainer_patches():
    r = np.random.default_rng(24)
    return r.random((32, 16, 16)).astype(np.float32)


# (learning rate, grad_clip): the JAX test's step, and one where the clip engages
TRAINER_CASES = {"jax_test": (1e-3, 1.0), "clipped": (1e-3, 1e-5)}
TRAINER_STEPS = 3


# -- the ranks' programs -------------------------------------------------------


def mesh_rank(out):
    res = {}
    for nd, ns in ((1, 4), (2, 2)):
        m = mesh_lib.make_mesh(nd, ns, device="cpu")
        res[f"{nd}x{ns}"] = {"shape": m.shape, "coords": m.coords,
                             "data": dist.get_process_group_ranks(m.groups["data"]),
                             "space": dist.get_process_group_ranks(m.groups["space"])}
        if (nd, ns) == (2, 2):
            one = torch.ones(1, dtype=torch.float64)
            res["2x2_sums"] = [float(global_sum(one, m, "data")), float(global_sum(one * (dist.get_rank() + 1), m,
                                                                                  "space"))]
    mesh = mesh_lib.make_mesh(device="cpu")  # all ranks on data
    inp = mesh_inputs()
    x, z = mesh_lib.shard_batch(inp["x"], mesh), mesh_lib.shard_batch(inp["z"], mesh)
    res["default_shape"] = mesh.shape
    res["local"] = x
    res["gathered"] = mesh_lib.gather_batch(x, mesh)
    try:
        mesh_lib.shard_batch(inp["x"][:6], mesh)
        res["raise"] = None
    except ValueError as e:
        res["raise"] = str(e)
    res["global_mean"] = global_mean(torch.mean(primal_residual_norm(x, z)), mesh)
    res["global_sum"] = global_sum(torch.sum(x, dim=0), mesh)
    res["converged_fraction"] = converged_fraction(mesh_lib.shard_batch(inp["res"], mesh), 0.5, mesh)
    _save(out, "mesh", res)


def spatial_rank(out):
    m14 = mesh_lib.make_mesh(1, 4, device="cpu")
    m22 = mesh_lib.make_mesh(2, 2, device="cpu")
    inp = spatial_inputs()
    s = m14.coords["space"]
    rows = torch.from_numpy(inp["plane"][s * 8:(s + 1) * 8])
    cols = spatial.fft2_rows_to_cols(rows, m14)
    res = {"cols": cols, "round_trip": torch.real(spatial.ifft2_cols_to_rows(cols, m14))}
    for name, (cplx, real) in {"f64": (np.complex128, torch.float64), "f32": (np.complex64, torch.float32)}.items():
        res[f"admm_{name}"] = spatial.spatial_admm_l1(inp["y"].astype(cplx), inp["mask"].astype(np.float32),
                                                      SPATIAL_CFG, m14, dtype=real)
    y_l = mesh_lib.shard_batch(inp["y_b"].astype(np.complex64), m22)
    x_l = spatial.spatial_admm_l1(y_l, inp["mask_b"].astype(np.float32), SPATIAL_CFG_B, m22)
    res["batched_2x2"] = mesh_lib.gather_batch(x_l, m22)
    _save(out, "spatial", res)


def consensus_rank(out, weights):
    mesh = mesh_lib.make_mesh(device="cpu")
    _, masks, ys = consensus_inputs()
    res = {
        "admm_f64": consensus.run_consensus_sharded(ys, masks, CONSENSUS_CFG, mesh, dtype=torch.float64),
        "admm_f32": consensus.run_consensus_sharded(ys.astype(np.complex64), masks.astype(np.float32),
                                                    CONSENSUS_CFG, mesh),
        "hqs_dncnn": consensus.run_consensus_hqs_sharded(ys, masks, HQS_ITERS, dncnn_denoiser(weights, torch.float64),
                                                         mesh, dtype=torch.float64),
        "hqs_alphas": consensus.run_consensus_hqs_sharded(ys, masks, HQS_ITERS, smooth, mesh, dtype=torch.float64,
                                                          alphas=HQS_ALPHAS),
    }
    from pnp_admm_cnc_mri_torch.ops import prox

    soft = lambda i, u: prox.soft(u, FISTA_LAM)  # noqa: E731
    for pre in (True, False):
        res[f"fista_{pre}"] = consensus.run_consensus_fista_sharded(ys, masks, FISTA_ITERS, soft, mesh,
                                                                    dtype=torch.float64, precondition=pre)
    _save(out, "consensus", res)


def trainer_rank(out, weights):
    """One step of ``make_train_step`` on the 2 x 2 mesh from the Flax tree
    in ``weights`` for each of ``TRAINER_CASES`` (float32 as the JAX test,
    and float64), then ``train_denoiser(mesh=)`` for ``TRAINER_STEPS``
    steps in float64."""
    from pnp_admm_cnc_mri_torch.models import convert, dncnn
    from pnp_admm_cnc_mri_torch.train import trainer

    mesh = mesh_lib.make_mesh(2, 2, device="cpu")
    tree = convert.load_npz(weights)
    res = {}
    for case, (lr, clip) in TRAINER_CASES.items():
        for dtype in (torch.float32, torch.float64):
            model = trainer.prepare_model(dncnn.DnCNN(1, 1, nc=8, nb=4), tree, 0, dtype, "cpu")
            split = trainer.shard_params_tp(model, mesh)
            opt = trainer.MeshOptimizer(model.named_parameters(), trainer.TrainConfig(learning_rate=lr,
                                                                                     grad_clip=clip), None, mesh,
                                        split)
            step = trainer.make_train_step(trainer.make_loss_fn(model, "l2"), opt)
            batch = trainer.shard_batch_dp(trainer_batch(), mesh, dtype)
            loss = global_mean(step(*batch), mesh)
            res[f"{case}_{dtype}"] = {"loss": float(loss), "state": trainer.gather_params_tp(model, mesh, split),
                                      "split": sorted(split), "local": {k: tuple(v.shape) for k, v in
                                                                        model.state_dict().items()}}
    state, losses = trainer.train_denoiser(dncnn.DnCNN(1, 1, nc=8, nb=4), trainer_patches(), 0.1,
                                           steps=TRAINER_STEPS, batch_size=8, mesh=mesh, params=tree,
                                           log_every=1, dtype=torch.float64)
    res["train_denoiser"] = {"state": state, "losses": losses}
    _save(out, "trainer", res)


def cli_rank(out, module, runs, testsets, data_dir):
    """``module.main(argv)`` for each ``(name, argv)`` of ``runs``, with the
    port's loaders pointed at ``testsets``/``data_dir`` and this rank's
    standard output kept in ``<out>/<name>_rank<r>.txt``."""
    from pnp_admm_cnc_mri_torch.data import images, masks, noise

    images.DEFAULT_TESTSETS = testsets
    masks.DEFAULT_DATA_DIR = noise.DEFAULT_DATA_DIR = data_dir
    main = importlib.import_module(module).main
    for name, argv in runs:
        with open(os.path.join(out, f"{name}_rank{dist.get_rank()}.txt"), "w") as f, contextlib.redirect_stdout(f):
            assert main(argv) == 0


def failing_rank():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")


def hanging_rank():
    if dist.get_rank() == 1:
        time.sleep(600)


# -- the launcher ---------------------------------------------------------------


def test_a_failing_rank_fails_the_launch():
    t = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch(failing_rank, 2)
    assert time.monotonic() - t < LAUNCH_TIMEOUT_S


def test_a_hanging_rank_is_killed_at_the_timeout():
    t = time.monotonic()
    with pytest.raises(TimeoutError):
        mesh_lib.launch_local(hanging_rank, 2, timeout_s=5.0, threads=1)
    assert time.monotonic() - t < 30.0
