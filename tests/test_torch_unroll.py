"""The port's unrolled trainer (``train/unroll.py``) against the JAX
package's and against the port's own eval solver, on the CPU.

- The training-time reconstruction is the eval pipeline's: equal to
  ``solvers/fista.pnp_fista`` with ``build_denoiser("drunet_gray")`` on the
  same weights (float32, 1e-6).
- Against the JAX package's ``make_unrolled_recon`` (which runs its
  iterates in float32 whatever the weights): the recon within 5e-5 and its
  gradient within 1e-6 (measured 4.9e-6 and 5.1e-8, the gradient's largest
  entry 0.024).
- In float64 against the same iteration composed from the JAX package's
  own pieces (``fourier.data_term_gradient``, ``fista.fista_extrapolate``,
  the Flax DRUNet, ``jnp.clip``) and ``jax.grad``: 1e-9.
- The checkpointed (``remat``) and plain recons and gradients equal.
- The clamp has ``jnp.clip``'s gradient at exact ties (1/2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pnp_admm_cnc_mri_tpu.models.drunet import UNetRes as JUNetRes
from pnp_admm_cnc_mri_tpu.ops import fourier as jfourier
from pnp_admm_cnc_mri_tpu.ops import schedules as jschedules
from pnp_admm_cnc_mri_tpu.solvers import fista as jfista
from pnp_admm_cnc_mri_tpu.train import unroll as junroll
from pnp_admm_cnc_mri_torch.models import convert
from pnp_admm_cnc_mri_torch.models.drunet import UNetRes
from pnp_admm_cnc_mri_torch.priors import denoiser
from pnp_admm_cnc_mri_torch.solvers import fista
from pnp_admm_cnc_mri_torch.train import synth, trainer, unroll

CPU = torch.device("cpu")
IT = 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scenario():
    rng = np.random.default_rng(1234)
    n, b = 64, 2
    img = rng.random((b, n, n)).astype(np.float32)
    mask = (rng.random((n, n)) < 0.35).astype(np.float32)
    noise = 2.0 * (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)))
    y = (np.fft.fft2(img, axes=(-2, -1)) * mask + noise).astype(np.complex64)
    return img, mask, y


@pytest.fixture(scope="module")
def tiny():
    jm = JUNetRes(out_nc=1, nc=(4, 8, 16, 32), nb=1)
    tree = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2), jnp.float32))
    return jm, jax.tree.map(np.asarray, dict(tree))


def _port(tree, dtype):
    return trainer.prepare_model(UNetRes(2, 1, nc=(4, 8, 16, 32), nb=1), tree, 0, dtype, CPU)


def _grad_err(model, jgrads) -> float:
    port = convert.flax_tree_from_state_dict({k: p.grad for k, p in model.named_parameters()})
    return max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(jgrads)))


def _jax_recon64(jm, iter_num, sigmas, denoise=None):
    """The unrolled PnP-FISTA of the JAX package's ``unroll.py`` in float64,
    from its own pieces (its ``make_unrolled_recon`` casts to float32)."""

    def recon(params, y, mask):
        x = jnp.abs(jfourier.zero_fill(y))
        v, t = x, jnp.asarray(1.0, jnp.float64)
        for i in range(iter_num):
            g = jnp.real(jfourier.data_term_gradient(v, y, mask))
            u = v - g
            if denoise is None:
                inp = jnp.concatenate([u[..., None], jnp.full_like(u[..., None], sigmas[i])], axis=-1)
                z = jm.apply(params, inp)[..., 0]
            else:
                z = denoise(params, u, i)
            x_new = jnp.clip(z, 0.0, 1.0)
            t, v = jfista.fista_extrapolate(x, x_new, t)
            x = x_new
        return x

    return recon


def test_recon_matches_the_eval_pipeline(scenario, tiny):
    img, mask, y = scenario
    _, tree = tiny
    model = _port(tree, torch.float32)
    x_train = unroll.make_unrolled_recon(unroll.make_drunet_ladder_denoise(model, IT, 12.0, 15.0), IT)(
        torch.from_numpy(y), torch.from_numpy(mask))
    d = denoiser.build_denoiser("drunet_gray", params=tree, iter_num=IT, noise_level_model=12.0 / 255.0,
                                model_sigma1=15.0, x8=False, nc=4, nb=1, device=CPU)
    final, _ = fista.pnp_fista(y, mask, IT, d, clamp=True, device=CPU)
    np.testing.assert_allclose(x_train.detach().numpy(), final.x.numpy(), atol=1e-6, rtol=0)


def test_recon_and_gradient_match_jax_float32(scenario, tiny):
    img, mask, y = scenario
    jm, tree = tiny
    jden = junroll.make_drunet_ladder_denoise(jm, IT, 12.0, 15.0)
    jrec = junroll.make_unrolled_recon(jden, IT)
    jx = np.asarray(jrec(tree, jnp.asarray(y), jnp.asarray(mask)))
    jg = jax.grad(lambda p: 0.5 * jnp.mean((jrec(p, jnp.asarray(y), jnp.asarray(mask)) - img) ** 2))(tree)
    model = _port(tree, torch.float32)
    rec = unroll.make_unrolled_recon(unroll.make_drunet_ladder_denoise(model, IT, 12.0, 15.0), IT)
    x = rec(torch.from_numpy(y), torch.from_numpy(mask))
    np.testing.assert_allclose(x.detach().numpy(), jx, atol=5e-5, rtol=0)
    (0.5 * torch.mean((x - torch.from_numpy(img)) ** 2)).backward()
    assert _grad_err(model, jg) < 1e-6


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "plain"])
def test_recon_and_gradient_match_jax_float64(scenario, tiny, remat):
    img, mask, y = scenario
    jm, tree = tiny
    tree64 = jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    y64 = y.astype(np.complex128)
    _, sigmas = jschedules.get_rho_sigma(sigma=12.0 / 255.0, iter_num=IT, model_sigma1=15.0, model_sigma2=12.0)
    jrec = _jax_recon64(jm, IT, np.asarray(sigmas))
    jx = np.asarray(jrec(tree64, jnp.asarray(y64), jnp.asarray(mask, jnp.float64)))
    jg = jax.grad(lambda p: 0.5 * jnp.mean((jrec(p, jnp.asarray(y64), jnp.asarray(mask, jnp.float64)) - img) ** 2))(
        tree64)
    model = _port(tree64, torch.float64)
    rec = unroll.make_unrolled_recon(unroll.make_drunet_ladder_denoise(model, IT, 12.0, 15.0), IT, remat=remat,
                                     dtype=torch.float64)
    x = rec(torch.from_numpy(y64), torch.from_numpy(mask).double())
    np.testing.assert_allclose(x.detach().numpy(), jx, atol=1e-9, rtol=0)
    (0.5 * torch.mean((x - torch.from_numpy(img).double()) ** 2)).backward()
    assert _grad_err(model, jg) < 1e-9


def test_remat_equals_plain(scenario, tiny):
    img, mask, y = scenario
    _, tree = tiny
    out = {}
    for remat in (True, False):
        model = _port(tree, torch.float32)
        rec = unroll.make_unrolled_recon(unroll.make_drunet_ladder_denoise(model, 3), 3, remat=remat)
        x = rec(torch.from_numpy(y), torch.from_numpy(mask))
        (0.5 * torch.mean((x - torch.from_numpy(img)) ** 2)).backward()
        out[remat] = (x.detach(), {k: p.grad.clone() for k, p in model.named_parameters()})
    assert torch.equal(out[True][0], out[False][0])
    for k in out[True][1]:
        assert torch.equal(out[True][1][k], out[False][1][k])
    assert sum(float(g.abs().sum()) for g in out[True][1].values()) > 0.0


def test_clip_gradient_is_jax_rule_at_ties():
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5, 0.0, 1.0])
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0) * jnp.arange(1.0, 8.0)))(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    torch.sum(unroll.jax_clip01(t) * torch.arange(1.0, 8.0, dtype=torch.float64)).backward()
    np.testing.assert_array_equal(t.grad.numpy(), jg)
    np.testing.assert_array_equal(unroll.jax_clip01(t).detach().numpy(), np.clip(x, 0, 1))


def test_recon_clip_ties_follow_jax(scenario):
    """A 'denoiser' whose output is exactly 0 or 1 everywhere puts every
    pixel of every clamp on a tie: the gradient is JAX's, and torch's own
    clamp would give another."""
    img, mask, y = scenario
    m01 = (np.random.default_rng(3).random((64, 64)) < 0.5).astype(np.float64)
    y64 = y.astype(np.complex128)

    def jden(p, u, i):
        return p["a"] * jnp.asarray(m01) + 0.0 * u

    jrec = _jax_recon64(None, 3, None, denoise=jden)
    jg = jax.grad(lambda p: 0.5 * jnp.mean((jrec(p, jnp.asarray(y64), jnp.asarray(mask, jnp.float64)) - img) ** 2))(
        {"a": jnp.asarray(1.0)})
    a = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    mt = torch.from_numpy(m01)
    rec = unroll.make_unrolled_recon(lambda u, i: a * mt + 0.0 * u, 3, dtype=torch.float64)
    loss = 0.5 * torch.mean((rec(torch.from_numpy(y64), torch.from_numpy(mask).double())
                             - torch.from_numpy(img).double()) ** 2)
    loss.backward()
    assert abs(float(a.grad) - float(jg["a"])) < 1e-12 and float(jg["a"]) != 0.0


def test_unrolled_step_matches_jax_float64(scenario, tiny):
    """One ``make_unrolled_step`` (y formed from the clean batch, the masks
    and the noise; the loss; optax's clip at 1 and Adam with the cosine
    schedule) against the same step in JAX, float64."""
    img, mask, _ = scenario
    jm, tree = tiny
    tree64 = jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    r = np.random.default_rng(5)
    clean = img.astype(np.float64)
    mk = np.stack([mask, np.roll(mask, 3, axis=0)]).astype(np.float64)
    noise = 15.0 * r.standard_normal((2, 2, 64, 64))
    _, sigmas = jschedules.get_rho_sigma(sigma=12.0 / 255.0, iter_num=3, model_sigma1=15.0, model_sigma2=12.0)
    jrec = _jax_recon64(jm, 3, np.asarray(sigmas))

    def jloss(p):
        yj = jnp.fft.fft2(jnp.asarray(clean), axes=(-2, -1)) * mk + noise[0] + 1j * noise[1]
        return 0.5 * jnp.mean((jrec(p, yj, jnp.asarray(mk)) - clean) ** 2)

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(optax.cosine_decay_schedule(1e-3, 4, alpha=0.1)))
    jl, g = jax.value_and_grad(jloss)(tree64)
    upd, _ = tx.update(g, tx.init(tree64), tree64)
    jp = optax.apply_updates(tree64, upd)
    model = _port(tree64, torch.float64)
    opt = trainer.make_optimizer(trainer.TrainConfig(learning_rate=1e-3, lr_decay="cosine", lr_floor=0.1),
                                 model.parameters(), 4)
    step = unroll.make_unrolled_step(unroll.make_unrolled_recon(unroll.make_drunet_ladder_denoise(model, 3), 3,
                                                                dtype=torch.float64), opt)
    tl = step(torch.from_numpy(clean), torch.from_numpy(mk), torch.from_numpy(noise))
    assert abs(float(tl) - float(jl)) < 1e-12
    port = convert.flax_tree_from_state_dict(trainer.state_of(model))
    assert max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(jp))) < 1e-9


def test_train_unrolled_runs_and_logs_as_jax(tiny):
    _, tree = tiny
    rng = np.random.default_rng(0)
    masks = (rng.random((2, 64, 64)) < 0.4).astype(np.float32)
    real = rng.random((3, 64, 64)).astype(np.float32)
    model = UNetRes(2, 1, nc=(4, 8, 16, 32), nb=1)
    ck = []
    state, losses = unroll.train_unrolled(model, unroll.make_drunet_ladder_denoise(model, 2), masks, iter_num=2,
                                          real_images=real, steps=3, batch_size=2, params=tree, noise_std=2.0,
                                          log_every=2, ckpt_every=2, ckpt_cb=lambda s, p: ck.append(s), device=CPU)
    assert [i for i, _ in losses] == [0, 2] and all(np.isfinite(l) for _, l in losses)
    assert ck == [2, 3]
    model2 = UNetRes(2, 1, nc=(4, 8, 16, 32), nb=1)
    calls = []
    gen = synth.make_generator(size=64, n_disks=20)

    def counted(g, n):
        calls.append(n)
        return gen(g, n)

    state2, losses2 = unroll.train_unrolled(model2, unroll.make_drunet_ladder_denoise(model2, 2), masks, iter_num=2,
                                            generator=counted, real_images=real, steps=4, batch_size=2,
                                            noise_std=2.0, log_every=1, ema_decay=0.9, refresh_every=2,
                                            buffer_images=4, device=CPU)
    assert len(losses2) == 4 and all(np.isfinite(l) for _, l in losses2)
    assert calls == [4, 4]  # the first buffer, then a refresh at step 2
    assert set(state2) == set(model2.state_dict())
    with pytest.raises(ValueError):
        unroll.train_unrolled(model2, unroll.make_drunet_ladder_denoise(model2, 2), masks, iter_num=2, steps=1,
                              device=CPU)
