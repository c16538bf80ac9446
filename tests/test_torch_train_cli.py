"""The port's training CLI (``cli/train_denoiser.py``) on the CPU (``--cpu``).

Every model and mode runs a few steps at a small width; the npz it saves
has the JAX package's keys and shapes (against its CLI's own file for
DnCNN, against the Flax model's tree for the rest), loads into both
packages' denoisers (equal outputs), and the corpus flags build the same
patch count as the JAX CLI. Without ``--cpu`` and without a card the CLI
stops instead of training on the CPU. ``--mesh`` without a world is the
run without it, bit for bit; at world 2 (two gloo ranks,
``test_torch_ranks.cli_rank``) rank 0 alone writes and prints, and its
npz equals the one-process run's within float32 rounding of the gradient
average (limit 1e-6 absolute on weights up to 0.7; measured 0).
"""

import json
import os

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.cli import train_denoiser as jcli
from pnp_admm_cnc_mri_tpu.models import convert as jconvert
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.models import drunet as jdrunet
from pnp_admm_cnc_mri_tpu.models import ffdnet as jffdnet
from pnp_admm_cnc_mri_tpu.models import tdnet as jtdnet
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdenoiser
from pnp_admm_cnc_mri_torch.cli import train_denoiser as cli
from pnp_admm_cnc_mri_torch.data import images, phantom
from pnp_admm_cnc_mri_torch.priors import denoiser

import test_torch_ranks as ranks


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trainset(tmp_path_factory):
    d = tmp_path_factory.mktemp("set")
    for k, im in enumerate(phantom.mri_phantoms(4, 64, seed=0)):
        images.imsave(im * 255.0, str(d / f"{k:02d}.png"))
    return str(d)


@pytest.fixture(scope="module")
def drunet_npz(tmp_path_factory):
    """A full-width DRUNet trained 2 steps on the synthetic stream (the CLI
    trains DRUNet at its published width only): the distillation teacher."""
    out = str(tmp_path_factory.mktemp("dru") / "drunet.npz")
    assert cli.main(["--cpu", "--model", "drunet", "--synth", "4", "--synth_size", "48", "--synth_disks", "20",
                     "--patch", "32", "--batch", "2", "--steps", "2", "--sigma", "0", "--sigma_max", "50",
                     "--out", out]) == 0
    return out


def _shapes_npz(path):
    with np.load(path) as z:
        return {k: z[k].shape for k in z.files}


def _shapes_tree(tree, lead=()):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in p): tuple(lead) + tuple(a.shape) for p, a in flat}


def _json(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]


def test_dncnn_npz_keys_equal_the_jax_cli_and_load_in_both(trainset, tmp_path, capsys):
    argv = ["--cpu", "--model", "dncnn", "--nc", "8", "--nb", "3", "--steps", "4", "--batch", "8", "--patch", "16",
            "--trainset", trainset, "--ckpt_every", "2"]
    timings = {}
    assert cli.main(argv + ["--out", str(tmp_path / "port.npz")], timings) == 0
    assert sorted(timings) == ["checkpoint_s", "save_s", "setup_s", "synthesis_s", "train_s"]
    assert timings["train_s"] >= timings["checkpoint_s"] > 0.0 and timings["synthesis_s"] == 0.0
    out = _json(capsys)
    assert [d["step"] for d in out if "ckpt" in d] == [2, 4]
    assert jcli.main(argv + ["--out", str(tmp_path / "jax.npz")]) == 0
    ref = _json(capsys)
    assert out[-1]["patches"] == ref[-1]["patches"] == 36
    assert [i for i, _ in out[-1]["losses"]] == [i for i, _ in ref[-1]["losses"]]
    assert _shapes_npz(tmp_path / "port.npz") == _shapes_npz(tmp_path / "jax.npz")
    x = np.random.default_rng(0).random((2, 32, 32)).astype(np.float32)
    got = denoiser.build_denoiser("dncnn_15", weights=str(tmp_path / "port.npz"), nc=8, nb=3,
                                  device="cpu")(torch.from_numpy(x), 0).numpy()
    jd = jdenoiser.build_denoiser("dncnn_15", params=jconvert.load_npz(str(tmp_path / "port.npz")), nc=8, nb=3)
    np.testing.assert_allclose(got, np.asarray(jd(jnp.asarray(x), 0)), atol=1e-5, rtol=0)


def test_corpus_flags_build_the_jax_cli_patch_count(trainset, tmp_path, capsys):
    extra_png = str(tmp_path / "extra.png")
    images.imsave(phantom.mri_phantoms(1, 80, seed=3)[0] * 255.0, extra_png)
    extra_mat = str(tmp_path / "extra.mat")
    sio.savemat(extra_mat, {"image": np.random.default_rng(1).random((72, 72, 3))})
    argv = ["--cpu", "--model", "dncnn", "--nc", "4", "--nb", "2", "--steps", "1", "--batch", "8", "--patch", "16",
            "--trainset", trainset, "--exclude", "01", "--extra_images", f"{extra_png}, {extra_mat}", "--multiscale"]
    assert cli.main(argv + ["--out", str(tmp_path / "p.npz")]) == 0
    assert jcli.main(argv + ["--out", str(tmp_path / "j.npz")]) == 0
    port, ref = _json(capsys)
    assert port["patches"] == ref["patches"] > 36


@pytest.mark.parametrize("model,extra,jmodel,shape,lead", [
    ("fdncnn", ["--nb", "3", "--ondevice", "--scan_steps", "2", "--ema", "0.9", "--sigma", "0", "--sigma_max", "50"],
     lambda: jdncnn.FDnCNN(out_nc=1, nc=8, nb=3), (1, 16, 16, 2), ()),
    ("ffdnet", ["--nb", "3", "--ondevice"], lambda: jffdnet.FFDNet(out_nc=1, nc=8, nb=3), (1, 16, 16, 1), ()),
    ("tdnet", ["--nb", "3", "--lr_decay", "cosine"], lambda: jtdnet.TDNet(out_nc=1, nc=8, nb=3), (1, 16, 16, 1), ()),
    ("ircnn", ["--bundle", "--bundle_steps", "1", "--ckpt_every", "1"], lambda: jdncnn.IRCNN(out_nc=1, nc=8),
     (1, 16, 16, 1), (25,)),
], ids=["fdncnn", "ffdnet", "tdnet", "ircnn_bundle"])
def test_models_save_the_jax_keys(model, extra, jmodel, shape, lead, trainset, tmp_path, capsys):
    out = str(tmp_path / f"{model}.npz")
    assert cli.main(["--cpu", "--model", model, "--nc", "8", "--steps", "2", "--batch", "8", "--patch", "16",
                     "--trainset", trainset, *extra, "--out", out]) == 0
    lines = _json(capsys)
    jm = jmodel()
    args = (jnp.zeros(shape),) + ((jnp.asarray(0.1),) if model in ("ffdnet", "tdnet") else ())
    want = _shapes_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), lead)
    assert _shapes_npz(out) == want
    if model == "ircnn":
        assert lines[-1]["bins"] == list(range(25))
        assert [d["bin"] for d in lines if "ckpt" in d] == [12, 12]  # the centre bin's checkpoints, all 25 sets
        d = denoiser.build_denoiser("ircnn_gray", weights=out, nc=8, iter_num=8, device="cpu")
        assert torch.isfinite(d(torch.rand(1, 32, 32), 3)).all()


def test_drunet_synth_saves_the_jax_keys_and_loads(drunet_npz):
    want = _shapes_tree(jax.eval_shape(jdrunet.UNetRes(out_nc=1).init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2))))
    assert _shapes_npz(drunet_npz) == want
    d = denoiser.build_denoiser("drunet_gray", weights=drunet_npz, iter_num=4, device="cpu")
    assert torch.isfinite(d(torch.rand(1, 32, 32), 0)).all()


def test_resume_casts_float16_to_float32(trainset, tmp_path, capsys):
    first = str(tmp_path / "a.npz")
    base = ["--cpu", "--model", "dncnn", "--nc", "8", "--nb", "3", "--batch", "8", "--patch", "16",
            "--trainset", trainset]
    assert cli.main(base + ["--steps", "2", "--out", first]) == 0
    with np.load(first) as z:
        half = {k: z[k].astype(np.float16) for k in z.files}
    np.savez(str(tmp_path / "half.npz"), **half)
    out = str(tmp_path / "b.npz")
    assert cli.main(base + ["--steps", "1", "--lr", "1e-4", "--resume", str(tmp_path / "half.npz"), "--out", out]) == 0
    with np.load(out) as z:
        for k in z.files:
            assert z[k].dtype == np.float32
            # one Adam step from the resumed weights moves each by at most about lr
            assert np.abs(z[k] - half[k].astype(np.float32)).max() <= 2e-4


def test_distill_from_a_drunet_teacher(drunet_npz, tmp_path, capsys):
    out = str(tmp_path / "ffdnet.npz")
    assert cli.main(["--cpu", "--model", "ffdnet", "--nc", "8", "--nb", "3", "--synth", "4", "--synth_size", "48",
                     "--synth_disks", "20", "--patch", "32", "--batch", "2", "--steps", "2", "--scan_steps", "2",
                     "--distill", drunet_npz, "--distill_weight", "0.7", "--out", out]) == 0
    line = _json(capsys)[-1]
    assert line["patches"] == "synth:4" and all(np.isfinite(l) for _, l in line["losses"])


def test_refusals(trainset, tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["--cpu", "--model", "dncnn", "--bundle", "--trainset", trainset, "--out", str(tmp_path / "x.npz")])
    if not torch.cuda.is_available():  # no silent CPU path
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--model", "dncnn", "--trainset", trainset, "--out", str(tmp_path / "x.npz")])
    assert not os.path.exists(tmp_path / "x.npz")


MESH_ARGV = ["--cpu", "--model", "dncnn", "--nc", "8", "--nb", "3", "--steps", "4", "--batch", "8", "--patch", "16",
             "--ckpt_every", "2"]
MESH_ATOL = 1e-6


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_mesh_without_a_world_is_the_run_without_it(trainset, tmp_path, capsys):
    outs = {}
    for tag, extra in (("plain", []), ("mesh", ["--mesh"])):
        assert cli.main(MESH_ARGV + extra + ["--trainset", trainset, "--out", str(tmp_path / f"{tag}.npz")]) == 0
        outs[tag] = [{k: v for k, v in d.items() if k != "out" and k != "ckpt"} for d in _json(capsys)]
    assert outs["plain"] == outs["mesh"]
    a, b = _npz(tmp_path / "plain.npz"), _npz(tmp_path / "mesh.npz")
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_mesh_at_world_2_equals_world_1(trainset, tmp_path, capsys):
    w2 = str(tmp_path / "w2.npz")
    ranks.launch(ranks.cli_rank, 2, str(tmp_path), "pnp_admm_cnc_mri_torch.cli.train_denoiser",
                 [("train", MESH_ARGV + ["--mesh", "--trainset", trainset, "--out", w2])], trainset, trainset)
    printed = [(tmp_path / f"train_rank{r}.txt").read_text().splitlines() for r in range(2)]
    assert len(printed[0]) == 3 and printed[1] == []  # two checkpoints and the summary, from rank 0 only
    assert cli.main(MESH_ARGV + ["--mesh", "--trainset", trainset, "--out", str(tmp_path / "w1.npz")]) == 0
    one, two = _json(capsys)[-1], json.loads(printed[0][-1])
    assert [i for i, _ in one["losses"]] == [i for i, _ in two["losses"]] and two["patches"] == one["patches"]
    np.testing.assert_allclose([v for _, v in two["losses"]], [v for _, v in one["losses"]], rtol=1e-5)
    a, b = _npz(tmp_path / "w1.npz"), _npz(w2)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=MESH_ATOL, rtol=0)

