"""The port's denoiser trainers (``train/trainer.py``) against the JAX
package's, on the CPU.

In float64, from Flax-initialised parameters carried across
(``state_dict_from_flax``), on the same numpy batches: the optimizer
against optax's ``chain(clip_by_global_norm, adam | adamw)`` over 5 steps
(clip triggered and not, with and without the cosine schedule; 1e-12), one
``make_train_step`` (DnCNN l2, FDnCNN conditioned l1, FFDNet-style; 1e-12)
and 10 steps of ``train_denoiser`` (1e-9; measured ~5e-16). The on-device
and stream trainers draw from torch's generator, so they are held by the
JAX package's step accounting (the logged step indices and the checkpoint
steps are equal) and by behaviour (the loss falls, EMA, distillation),
mirroring ``tests/test_train.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import ffdnet as jffdnet
from pnp_admm_cnc_mri_tpu.train import data as jdata
from pnp_admm_cnc_mri_tpu.train import synth as jsynth
from pnp_admm_cnc_mri_tpu.train import trainer as jtrainer
from pnp_admm_cnc_mri_torch.models import convert, dncnn, ffdnet
from pnp_admm_cnc_mri_torch.train import data, synth, trainer

import test_torch_ranks as ranks

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def patches():
    from scipy.ndimage import gaussian_filter

    r = np.random.default_rng(7)
    imgs = [gaussian_filter(r.random((64, 64)), 3.0) for _ in range(4)]
    return data.extract_patches(imgs, patch=16, stride=16)


def _f64_tree(jmodel, *inputs):
    variables = jmodel.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in inputs))
    return jax.tree.map(lambda a: np.asarray(a, np.float64), dict(variables))


def _tree_err(state, jtree) -> float:
    """Max abs difference of a port state dict and a Flax tree."""
    port = convert.flax_tree_from_state_dict(state)
    la, lb = jax.tree.leaves(port), jax.tree.leaves(jax.tree.map(np.asarray, jtree))
    assert len(la) == len(lb)
    return max(float(np.abs(a - b).max()) for a, b in zip(la, lb))


def _cfg(**kw):
    return jtrainer.TrainConfig(**kw), trainer.TrainConfig(**kw)


# ---------------------------------------------------------------------------
# the optimizer against optax


@pytest.mark.parametrize("kw,grad_scale,norm_above_one", [
    (dict(learning_rate=1e-2), 0.01, False),
    (dict(learning_rate=1e-2, lr_decay="cosine"), 10.0, True),
    (dict(learning_rate=3e-3, weight_decay=1e-2, lr_decay="cosine", lr_floor=0.2), 10.0, True),
    (dict(learning_rate=3e-3, weight_decay=1e-1, grad_clip=None), 1.0, True),
], ids=["adam", "adam_cosine_clipped", "adamw_cosine_clipped", "adamw_no_clip"])
def test_optimizer_matches_optax_over_5_steps(kw, grad_scale, norm_above_one):
    r = np.random.default_rng(0)
    shapes = {"w": (4, 3, 3, 2), "b": (4,), "v": (5,)}
    params = {k: r.standard_normal(s) for k, s in shapes.items()}
    jcfg, tcfg = _cfg(**kw)
    tx = jtrainer.make_optimizer(jcfg, steps=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = trainer.make_optimizer(tcfg, list(tp.values()), steps=5)
    for _ in range(5):
        grads = {k: grad_scale * r.standard_normal(s) for k, s in shapes.items()}
        # the clip (max norm 1, where configured) triggers exactly when the norm is at least 1
        assert (np.sqrt(sum(np.sum(g * g) for g in grads.values())) >= 1.0) == norm_above_one
        upd, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-12, rtol=0)


def test_clip_by_global_norm_is_optax_rule():
    g = [torch.tensor([3.0, 4.0], dtype=torch.float64), torch.tensor([0.0], dtype=torch.float64)]
    norm = trainer.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 5.0
    np.testing.assert_array_equal(g[0].numpy(), np.array([3.0, 4.0]) / 5.0 * 1.0)
    small = [torch.tensor([0.3, 0.4], dtype=torch.float64)]
    trainer.clip_by_global_norm_(small, 1.0)
    np.testing.assert_array_equal(small[0].numpy(), [0.3, 0.4])


def test_cosine_factor_is_optax_schedule():
    sched = optax.cosine_decay_schedule(2e-3, 7, alpha=0.1)
    f = trainer.cosine_decay(7, 0.1)
    for c in range(10):
        assert abs(2e-3 * f(c) - float(sched(c))) < 1e-12


# ---------------------------------------------------------------------------
# one step and 10 steps against the JAX package, float64


def _models(kind):
    if kind == "dncnn":
        return jdncnn.DnCNN(out_nc=1, nc=8, nb=4), dncnn.DnCNN(1, 1, nc=8, nb=4), (1, 16, 16, 1), ()
    if kind == "fdncnn":
        return jdncnn.FDnCNN(out_nc=1, nc=8, nb=4), dncnn.FDnCNN(2, 1, nc=8, nb=4), (1, 16, 16, 2), ()
    return jffdnet.FFDNet(out_nc=1, nc=8, nb=4), ffdnet.FFDNet(1, 1, nc=8, nb=4), (1, 16, 16, 1), (0.1,)


def _jax_loss(kind, jm, loss):
    if kind == "ffdnet":
        return lambda p, noisy, clean, sigma: 0.5 * jnp.mean((jm.apply(p, noisy, sigma[:, 0, 0, 0]) - clean) ** 2)
    return jtrainer.make_loss_fn(jm.apply, loss, conditioned=kind == "fdncnn")


@pytest.mark.parametrize("kind,loss", [("dncnn", "l2"), ("fdncnn", "l1"), ("ffdnet", "l2")])
def test_one_train_step_matches_jax(kind, loss, patches):
    jm, tm, shape, extra = _models(kind)
    tree = _f64_tree(jm, np.zeros(shape), *extra)
    jcfg, tcfg = _cfg(learning_rate=1e-2, loss=loss)
    noisy, clean, sig = next(jdata.batches(patches, 8, (0.05, 0.2), seed=1))
    jopt = jtrainer.make_optimizer(jcfg)
    jstep = jtrainer.make_train_step(_jax_loss(kind, jm, loss), jopt)
    jp, _, jl = jstep(tree, jopt.init(tree), jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(sig))
    model = trainer.prepare_model(tm, tree, 0, torch.float64, CPU)
    fn = trainer.ffdnet_loss_fn(model) if kind == "ffdnet" else trainer.make_loss_fn(model, loss, kind == "fdncnn")
    step = trainer.make_train_step(fn, trainer.make_optimizer(tcfg, model.parameters()))
    tl = step(*(torch.from_numpy(a).double().permute(0, 3, 1, 2) for a in (noisy, clean, sig)))
    assert abs(float(tl) - float(jl)) < 1e-12
    assert _tree_err(trainer.state_of(model), jp) < 1e-12


@pytest.mark.parametrize("kind,loss,kw,sigma", [
    ("dncnn", "l2", dict(learning_rate=1e-2, lr_decay="cosine", grad_clip=0.05), 0.1),
    ("fdncnn", "l1", dict(learning_rate=1e-3, weight_decay=1e-2), (0.05, 0.2)),
    ("ffdnet", "l2", dict(learning_rate=1e-3), (0.0, 0.2)),
])
def test_train_denoiser_matches_jax_over_10_steps(kind, loss, kw, sigma, patches):
    jm, tm, shape, extra = _models(kind)
    tree = _f64_tree(jm, np.zeros(shape), *extra)
    jcfg, tcfg = _cfg(loss=loss, **kw)
    args = dict(steps=10, batch_size=8, conditioned=kind == "fdncnn", ffdnet_style=kind == "ffdnet", seed=3,
                log_every=3, ckpt_every=4)
    jck, tck = [], []
    jp, jl = jtrainer.train_denoiser(jm, patches, sigma, cfg=jcfg, params=tree,
                                     ckpt_cb=lambda s, p: jck.append(s), **args)
    tp, tl = trainer.train_denoiser(tm, patches, sigma, cfg=tcfg, params=tree, dtype=torch.float64, device=CPU,
                                    ckpt_cb=lambda s, p: tck.append(s), **args)
    assert [i for i, _ in tl] == [i for i, _ in jl] == [0, 3, 6, 9]
    assert tck == jck == [4, 8, 10]
    np.testing.assert_allclose([l for _, l in tl], [l for _, l in jl], atol=1e-12, rtol=0)
    assert _tree_err(tp, jp) < 1e-9


# ---------------------------------------------------------------------------
# the dp x tp mesh: a world of 4 gloo ranks at data 2 x space 2
# (test_torch_ranks.trainer_rank), against the unsharded port and JAX's
# sharded step (tests/test_train.py:84) from the same Flax-initialised
# DnCNN (nc 8, nb 4). float32 at the JAX test's limits (loss rtol 1e-5,
# parameters rtol 1e-4 + atol 1e-6); float64 at 1e-9.

MESH_F32 = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def mesh_tree():
    return jax.tree.map(np.asarray, dict(jdncnn.DnCNN(out_nc=1, nc=8, nb=4).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))))


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory, mesh_tree):
    from pnp_admm_cnc_mri_tpu.models import convert as jconvert

    out = tmp_path_factory.mktemp("trainer_mesh")
    jconvert.save_npz(mesh_tree, str(out / "tree.npz"))
    ranks.launch(ranks.trainer_rank, 4, str(out), str(out / "tree.npz"))
    return ranks.load_ranks(str(out), "trainer", 4)


def _jax_mesh_2x2():
    from pnp_admm_cnc_mri_tpu.parallel import mesh as jmesh

    return jmesh.make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4])


def _jax_sharded_step(tree, lr, clip, jdt):
    """tests/test_train.py:84's sharded step, at ``lr``, ``clip`` and ``jdt``."""
    tree = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    mesh = _jax_mesh_2x2()
    optimizer = jtrainer.make_optimizer(jtrainer.TrainConfig(learning_rate=lr, grad_clip=clip))
    step = jtrainer.make_train_step(jtrainer.make_loss_fn(jdncnn.DnCNN(out_nc=1, nc=8, nb=4).apply, "l2"), optimizer)
    p = jtrainer.shard_params_tp(tree, mesh)
    batch = jtrainer.shard_batch_dp(tuple(np.asarray(a, jdt) for a in ranks.trainer_batch()), mesh)
    p, _, loss = step(p, optimizer.init(p), *batch)
    return float(loss), jax.tree.map(np.asarray, p)


def _port_step(tree, lr, clip, dtype):
    """The port's unsharded step on the same batch; returns (loss, state, the gradient's global norm)."""
    model = trainer.prepare_model(dncnn.DnCNN(1, 1, nc=8, nb=4), tree, 0, dtype, CPU)
    opt = trainer.make_optimizer(trainer.TrainConfig(learning_rate=lr, grad_clip=clip), model.parameters())
    batch = [torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2) for a in ranks.trainer_batch()]
    loss = trainer.make_loss_fn(model, "l2")(*batch)
    loss.backward()
    norm = float(torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()])))
    opt.step()
    return float(loss.detach()), trainer.state_of(model), norm


@pytest.mark.parametrize("case", sorted(ranks.TRAINER_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sharded_step_matches_unsharded_and_jax(mesh_ranks, mesh_tree, case, dtype):
    lr, clip = ranks.TRAINER_CASES[case]
    jl, jp = _jax_sharded_step(mesh_tree, lr, clip, jnp.float32 if dtype == torch.float32 else jnp.float64)
    ul, us, _ = _port_step(mesh_tree, lr, clip, dtype)
    for res in mesh_ranks:
        got = res[f"{case}_{dtype}"]
        # every conv but the last (1 output channel) is split over space 2
        assert got["split"] == sorted(f"{k}.{w}" for k in ("head.conv", "body0.conv", "body1.conv") for w in
                                      ("weight", "bias"))
        assert got["local"]["head.conv.weight"] == (4, 1, 3, 3) and got["local"]["tail.conv.weight"] == (1, 8, 3, 3)
        for want_loss, want in ((ul, us), (jl, None)):
            if dtype == torch.float32:
                np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
            else:
                assert abs(got["loss"] - want_loss) < 1e-9
        for k, v in got["state"].items():
            assert v.shape == us[k].shape and v.dtype == dtype
            if dtype == torch.float32:
                np.testing.assert_allclose(v.numpy(), us[k].numpy(), **MESH_F32)
            else:
                np.testing.assert_allclose(v.numpy(), us[k].numpy(), atol=1e-9, rtol=0)
        if dtype == torch.float32:
            port, want = convert.flax_tree_from_state_dict(got["state"]), jp
            for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(want)):
                np.testing.assert_allclose(a, b, **MESH_F32)
        else:
            assert _tree_err(got["state"], jp) < 1e-9


def test_the_clip_engages_in_the_clipped_case(mesh_tree):
    """The clipped case's gradient norm is far above its clip, and clipping
    moves the step by much more than the limits above: a norm that counted
    a split tensor wrongly would show."""
    lr, clip = ranks.TRAINER_CASES["clipped"]
    _, clipped, norm = _port_step(mesh_tree, lr, clip, torch.float64)
    _, unclipped, _ = _port_step(mesh_tree, lr, None, torch.float64)
    assert norm > 100 * clip
    assert max(float((clipped[k] - unclipped[k]).abs().max()) for k in clipped) > 1e-5


def test_train_denoiser_on_the_mesh_matches_unsharded_and_jax(mesh_ranks, mesh_tree):
    tree64 = jax.tree.map(lambda a: np.asarray(a, np.float64), mesh_tree)
    args = dict(steps=ranks.TRAINER_STEPS, batch_size=8, log_every=1)
    us, ul = trainer.train_denoiser(dncnn.DnCNN(1, 1, nc=8, nb=4), ranks.trainer_patches(), 0.1, params=tree64,
                                    dtype=torch.float64, device=CPU, **args)
    jp, jl = jtrainer.train_denoiser(jdncnn.DnCNN(out_nc=1, nc=8, nb=4), ranks.trainer_patches(), 0.1,
                                     params=jax.tree.map(jnp.asarray, tree64), mesh=_jax_mesh_2x2(), **args)
    for res in mesh_ranks:
        got = res["train_denoiser"]
        assert [i for i, _ in got["losses"]] == [i for i, _ in ul] == [i for i, _ in jl]
        np.testing.assert_allclose([l for _, l in got["losses"]], [l for _, l in ul], atol=1e-9, rtol=0)
        np.testing.assert_allclose([l for _, l in got["losses"]], [l for _, l in jl], atol=1e-9, rtol=0)
        assert max(float((got["state"][k] - us[k]).abs().max()) for k in us) < 1e-9
        assert _tree_err(got["state"], jp) < 1e-9


# ---------------------------------------------------------------------------
# augmentation, staging, numerics


def test_dihedral_matches_augment_batch_modes(patches):
    p = torch.from_numpy(patches[:2])
    for m in range(8):
        host = np.rot90(patches[:2], m % 4, axes=(1, 2))
        if m >= 4:
            host = host[:, ::-1, :]
        np.testing.assert_array_equal(trainer._dihedral(p, m).numpy(), host)
        jx = np.asarray(jtrainer._dihedral(jnp.asarray(patches[0][..., None]), jnp.int32(m)))[..., 0]
        np.testing.assert_array_equal(trainer._dihedral(p[0], m).numpy(), jx)


def test_dihedral_batch_applies_each_sample_its_mode(patches):
    x = torch.from_numpy(patches[:16])[:, None]
    modes = torch.arange(16) % 8
    out = trainer.dihedral_batch(x, modes)
    for i in range(16):
        assert torch.equal(out[i], trainer._dihedral(x[i], int(modes[i])))


def test_stage_to_device_and_step_numerics_restore(patches):
    assert torch.equal(trainer.stage_to_device(patches, CPU), torch.from_numpy(patches))
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    with trainer.step_numerics():
        assert cudnn.allow_tf32 is False and cudnn.deterministic is True
    assert (cudnn.allow_tf32, cudnn.deterministic) == prev


def test_l1_loss_tie_gradient_is_jax_rule(patches):
    """With the tail conv zeroed, the residual DnCNN returns its input, and
    half the pixels have noisy == clean: |err| ties at 0 there, where JAX's
    gradient is 1 and torch's abs would give 0."""
    jm = jdncnn.DnCNN(out_nc=1, nc=4, nb=3)
    tree = _f64_tree(jm, np.zeros((1, 16, 16, 1)))
    tree["params"]["tail"]["conv"]["kernel"][...] = 0.0
    tree["params"]["tail"]["conv"]["bias"][...] = 0.0
    clean = patches[:4, ..., None].astype(np.float64)
    noisy = clean + 0.1 * np.random.default_rng(0).standard_normal(clean.shape)
    noisy[:, ::2] = clean[:, ::2]
    sig = np.full((4, 1, 1, 1), 0.1)
    jloss = jtrainer.make_loss_fn(jm.apply, "l1")
    jg = jax.grad(jloss)(tree, jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(sig))
    model = trainer.prepare_model(dncnn.DnCNN(1, 1, nc=4, nb=3), tree, 0, torch.float64, CPU)
    t = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (noisy, clean, sig)]
    trainer.make_loss_fn(model, "l1")(*t).backward()
    tg = {k: p.grad for k, p in model.named_parameters()}
    assert _tree_err(tg, jg) < 1e-12
    # torch's own abs differs at the ties: the test does plant them
    model.zero_grad()
    torch.mean(torch.abs(model(t[0]) - t[1])).backward()
    assert _tree_err({k: p.grad for k, p in model.named_parameters()}, jg) > 1e-6


# ---------------------------------------------------------------------------
# the JAX package's step accounting in the on-device and stream trainers


@pytest.mark.parametrize("which", ["ondevice", "stream"])
@pytest.mark.parametrize("steps,scan,log_every,ckpt_every", [(25, 10, 3, 10), (7, 1, 3, 3), (12, 4, 1, 5)])
def test_step_and_checkpoint_indices_equal_jax(which, steps, scan, log_every, ckpt_every, patches):
    kw = dict(steps=steps, batch_size=4, log_every=log_every, ckpt_every=ckpt_every, scan_steps=scan, seed=0,
              cfg=trainer.TrainConfig(learning_rate=1e-3))
    jkw = dict(kw, cfg=jtrainer.TrainConfig(learning_rate=1e-3))
    jck, tck = [], []
    jm, tm = jdncnn.DnCNN(out_nc=1, nc=4, nb=2), dncnn.DnCNN(1, 1, nc=4, nb=2)
    if which == "ondevice":
        _, jl = jtrainer.train_denoiser_ondevice(jm, patches, 0.1, ckpt_cb=lambda s, p: jck.append(s), **jkw)
        _, tl = trainer.train_denoiser_ondevice(tm, patches, 0.1, ckpt_cb=lambda s, p: tck.append(s), device=CPU,
                                                **kw)
    else:
        sk = dict(patch=16, buffer_images=4, refresh_every=5)
        _, jl = jtrainer.train_denoiser_stream(jm, jsynth.make_generator(size=24, n_disks=10), 0.1,
                                               ckpt_cb=lambda s, p: jck.append(s), **sk, **jkw)
        _, tl = trainer.train_denoiser_stream(tm, synth.make_generator(size=24, n_disks=10), 0.1,
                                              ckpt_cb=lambda s, p: tck.append(s), device=CPU, **sk, **kw)
    assert [i for i, _ in tl] == [i for i, _ in jl]
    assert tck == jck
    assert all(np.isfinite(l) for _, l in tl)


# ---------------------------------------------------------------------------
# behaviour (tests/test_train.py's, on the port)


def test_loss_decreases_host_and_ondevice(patches):
    for fn in (trainer.train_denoiser, trainer.train_denoiser_ondevice):
        _, losses = fn(dncnn.DnCNN(1, 1, nc=8, nb=4), patches, 0.1, steps=60, batch_size=16, log_every=10,
                       cfg=trainer.TrainConfig(learning_rate=1e-3), device=CPU)
        assert losses[-1][1] < losses[0][1] * 0.8, losses


def test_conditioned_fdncnn_steps_are_finite(patches):
    _, losses = trainer.train_denoiser(dncnn.FDnCNN(2, 1, nc=8, nb=4), patches, (0.05, 0.2), steps=10,
                                       batch_size=8, conditioned=True, log_every=5, device=CPU)
    assert np.isfinite(losses[-1][1])


def test_ondevice_ema_is_the_average(patches):
    """ema_decay 0 keeps the last parameters; 1 keeps the first."""
    tm = dncnn.DnCNN(1, 1, nc=4, nb=2)
    start = trainer.state_of(trainer.prepare_model(tm, None, 0, torch.float32, CPU))
    last, _ = trainer.train_denoiser_ondevice(dncnn.DnCNN(1, 1, nc=4, nb=2), patches, 0.1, steps=5, batch_size=4,
                                              device=CPU)
    e0, _ = trainer.train_denoiser_ondevice(dncnn.DnCNN(1, 1, nc=4, nb=2), patches, 0.1, steps=5, batch_size=4,
                                            ema_decay=0.0, device=CPU)
    e1, _ = trainer.train_denoiser_ondevice(dncnn.DnCNN(1, 1, nc=4, nb=2), patches, 0.1, steps=5, batch_size=4,
                                            ema_decay=1.0, device=CPU)
    for k in last:
        assert torch.equal(e0[k], last[k]) and torch.equal(e1[k], start[k])


def test_stream_trainer_loss_decreases_and_refreshes():
    calls = []
    gen = synth.make_generator(size=48, n_disks=100)

    def counted(g, n):
        calls.append(n)
        return gen(g, n)

    _, losses = trainer.train_denoiser_stream(dncnn.DnCNN(1, 1, nc=8, nb=3), counted, 25 / 255.0, steps=60,
                                              batch_size=8, patch=24, buffer_images=16, refresh_every=30,
                                              scan_steps=10, log_every=10, cfg=trainer.TrainConfig(learning_rate=1e-3),
                                              device=CPU)
    assert losses[-1][1] < losses[0][1]
    assert calls == [16, 16, 16]  # the first buffer and refreshes at steps 30 and 60


def test_stream_trainer_fixed_buffer_with_ema():
    _, losses = trainer.train_denoiser_stream(dncnn.DnCNN(1, 1, nc=8, nb=2), synth.make_generator(size=48, n_disks=100),
                                              25 / 255.0, steps=20, batch_size=4, patch=24, buffer_images=8,
                                              refresh_every=0, ema_decay=0.99, log_every=5, device=CPU,
                                              cfg=trainer.TrainConfig(learning_rate=1e-3))
    assert len(losses) >= 3


def test_stream_trainer_distills_toward_teacher():
    """Pure distillation (weight 1) regresses the teacher's output (half the
    noisy input), not the clean image."""
    model = dncnn.DnCNN(1, 1, nc=8, nb=3)
    state, losses = trainer.train_denoiser_stream(
        model, synth.make_generator(size=48, n_disks=100), 25 / 255.0, steps=60, batch_size=8, patch=24,
        buffer_images=16, scan_steps=10, log_every=10, cfg=trainer.TrainConfig(learning_rate=1e-3),
        teacher_apply=lambda tp, noisy, sig: noisy * tp["gain"], teacher_params={"gain": 0.5},
        distill_weight=1.0, device=CPU)
    assert losses[-1][1] < losses[0][1]
    g = torch.Generator().manual_seed(7)
    clean = torch.rand((2, 1, 24, 24), generator=g)
    noisy = clean + 0.1 * torch.randn(clean.shape, generator=g)
    with torch.no_grad():
        pred = model(noisy)
    assert float(torch.mean((pred - 0.5 * noisy) ** 2)) < 0.5 * float(torch.mean((pred - clean) ** 2))


def test_stream_trainer_distill_weight_zero_ignores_the_teacher():
    _, losses = trainer.train_denoiser_stream(
        dncnn.DnCNN(1, 1, nc=8, nb=2), synth.make_generator(size=48, n_disks=100), 25 / 255.0, steps=10,
        batch_size=4, patch=24, buffer_images=8, log_every=5, cfg=trainer.TrainConfig(learning_rate=1e-3),
        teacher_apply=lambda tp, noisy, sig: noisy * 0.0 + 99.0, distill_weight=0.0, device=CPU)
    assert losses[-1][1] < 1.0


def test_stream_trainer_timers_split_the_step():
    from pnp_admm_cnc_mri_torch.utils.profiling import PhaseTimers

    timers = PhaseTimers()
    trainer.train_denoiser_stream(dncnn.DnCNN(1, 1, nc=4, nb=2), synth.make_generator(size=32, n_disks=20), 0.1,
                                  steps=4, batch_size=2, patch=16, buffer_images=4, refresh_every=2,
                                  ema_decay=0.9, timers=timers, device=CPU)
    rep = timers.report()
    assert sorted(rep) == ["backward", "batch", "ema", "forward", "optimizer", "synthesis"]
    assert rep["forward"]["count"] == 4 and rep["synthesis"]["count"] == 2


def test_stream_trainer_timed_run_is_the_plain_run():
    """The timed split is of the trainers' own step: the same weights and losses."""
    from pnp_admm_cnc_mri_torch.utils.profiling import PhaseTimers

    runs = []
    for timers in (None, PhaseTimers()):
        runs.append(trainer.train_denoiser_stream(
            dncnn.DnCNN(1, 1, nc=4, nb=2), synth.make_generator(size=32, n_disks=20), (0.0, 0.2), steps=6,
            batch_size=2, patch=16, buffer_images=4, refresh_every=3, log_every=1, ema_decay=0.9,
            cfg=trainer.TrainConfig(learning_rate=1e-3), timers=timers, device=CPU))
    (s0, l0), (s1, l1) = runs
    assert l0 == l1 and all(torch.equal(s0[k], s1[k]) for k in s0)


def test_trained_weights_usable_in_pnp(patches, tmp_path):
    from pnp_admm_cnc_mri_torch.config import ADMMConfig
    from pnp_admm_cnc_mri_torch.priors import denoiser
    from pnp_admm_cnc_mri_torch.solvers import admm

    state, _ = trainer.train_denoiser(dncnn.DnCNN(1, 1, nc=64, nb=17), patches, 15 / 255.0, steps=5, batch_size=8,
                                      log_every=5, device=CPU)
    path = str(tmp_path / "dncnn_tiny.npz")
    convert.save_npz(state, path)
    d = denoiser.build_denoiser("dncnn_15", weights=path, device=CPU)
    r = np.random.default_rng(0)
    img = r.random((32, 32))
    mask = (r.random((32, 32)) < 0.4).astype(np.float32)
    y = (np.fft.fft2(img) * mask + 0.3 * (r.normal(size=(32, 32)) + 1j * r.normal(size=(32, 32)))).astype(np.complex64)
    final, _ = admm.pnp_admm_l1(y, mask, ADMMConfig(iter_num=3, rho=0.15), d, device=CPU)
    assert torch.isfinite(final.x).all()
