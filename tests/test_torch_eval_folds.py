"""The port's fold-exclusion evaluation (``cli/eval_folds.py``) against the
JAX package's, on the CPU.

A testset ``set`` of 15 scenes at 32 x 32 (``01``-``15``), the masks and
``noises.mat`` (``test_torch_experiments.write_assets``), and five narrow
DRUNet fold files (``test_torch_cli.narrow_weights``, one seed each) with a
manifest that partitions the 15 images. Both modules run with ``--device
cpu``, ``--select_nlm`` over two candidates and ``--extra`` giving the
files, the width and 2 iterations. What must agree: the stdout lines (the
grid-edge warnings, each fold's selection and held-out PSNRs, the composite
summary) exactly; the JSONL rows, but for ``wall_s`` (a time) and the
results directory in ``argv`` (the port writes under the temporary
directory; the JAX module names a fixed ``/tmp`` one, which the test
redirects into ``tmp_path``), with their PSNRs, SSIM and RE within the float32 limits of
``test_torch_experiments.LIMITS``.
"""

import contextlib
import io
import json
import os
import tempfile
import warnings

import pytest
import torch

from pnp_admm_cnc_mri_tpu.cli import eval_folds as jfolds
from pnp_admm_cnc_mri_torch.cli import eval_folds as folds
from test_torch_cli import few_threads, narrow_weights, reset_loggers  # noqa: F401
from test_torch_experiments import LIMITS, write_assets

HELD = [["01", "02", "03"], ["04", "05", "06"], ["07", "08", "09"], ["10", "11", "12"], ["13", "14", "15"]]


def _manifest(root):
    folds_ = {}
    for k, held in enumerate(HELD):
        path, arch = narrow_weights(root, "drunet_gray", seed=k)
        os.rename(path, os.path.join(str(root), f"fold{k}.npz"))
        folds_[f"f{k}"] = {"weights": os.path.join(str(root), f"fold{k}.npz"), "held_out": held}
    path = os.path.join(str(root), "folds.json")
    with open(path, "w") as f:
        json.dump({"model": "drunet_gray", "folds": folds_}, f)
    return path, arch


def _run(main, argv):
    reset_loggers()  # what an earlier JAX run left
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert main(argv) == 0
    if main is jfolds.main:
        reset_loggers()
    return buf.getvalue().strip().splitlines()


@pytest.fixture
def jax_results_in(tmp_path, monkeypatch):
    """The JAX module's CLI runs log into ``tmp_path / "jax_results"``, not
    the fixed ``/tmp/eval_folds_results`` its argv names: the argument after
    ``--results_dir`` is replaced on its way into the JAX CLI (the JSONL rows
    keep the argv as the module built it). The port's runs log under a
    temporary directory inside ``tmp_path``."""
    from pnp_admm_cnc_mri_tpu.cli import main as jmain

    real = jmain.main
    rdir = str(tmp_path / "jax_results")

    def main(argv):
        k = argv.index("--results_dir") + 1
        return real([*argv[:k], rdir, *argv[k + 1:]])

    monkeypatch.setattr(jmain, "main", main)
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    return rdir


def test_composite_and_selection_match_the_jax_module(tmp_path, jax_results_in):
    tdir, ddir = write_assets(str(tmp_path), n_images=15)
    os.rename(os.path.join(tdir, "set1"), os.path.join(tdir, "set"))
    manifest, arch = _manifest(tmp_path)
    extra = " ".join(["--testsets_dir", tdir, "--data_dir", ddir, *arch, "--iter_num", "2"])
    out, rows = {}, {}
    for tag, main in (("port", folds.main), ("jax", jfolds.main)):
        jsonl = str(tmp_path / f"{tag}.jsonl")
        out[tag] = _run(main, ["--manifest", manifest, "--device", "cpu", "--select_nlm", "12,15", "--extra", extra,
                               "--out", jsonl])
        with open(jsonl) as f:
            rows[tag] = [json.loads(line) for line in f]
    assert out["port"] == out["jax"]
    for rdir in (jax_results_in, str(tmp_path / "tmp" / "eval_folds_results")):
        [res] = os.listdir(rdir)
        assert len(open(os.path.join(rdir, res, res + ".log")).read().splitlines()) == 10 * 16
    summary = json.loads(out["port"][-1])
    assert set(summary["selected_nlm"]) == {f"f{k}" for k in range(5)}
    assert sorted(summary["per_image"]) == list(folds.ALL_IMAGES)
    # the composite is the mean of the held-out PSNRs (each rounded to 3 places in the line)
    assert abs(summary["composite_fold_exclusion_psnr"] - sum(summary["per_image"].values()) / 15) < 1e-3
    lp, ls, lr = LIMITS[torch.float32]
    assert len(rows["port"]) == len(rows["jax"]) == 11
    for p, j in zip(rows["port"], rows["jax"]):
        p.pop("ts", None), j.pop("ts", None)
        if "fold" not in p or "argv" not in p:
            assert p == j  # the summary
            continue
        assert set(p) == set(j)
        pa, ja = p.pop("argv"), j.pop("argv")
        k = pa.index("--results_dir") + 1
        assert pa[k] == str(tmp_path / "tmp" / "eval_folds_results") and ja[k] == "/tmp/eval_folds_results"
        assert pa[:k] + pa[k + 1:] == ja[:k] + ja[k + 1:]
        for key in ("fold", "weights", "nlm", "held_in_avg", "images", "iters"):
            assert p[key] == j[key], key
        assert abs(p["psnr"] - j["psnr"]) < lp and abs(p["ssim"] - j["ssim"]) < ls and abs(p["re"] - j["re"]) < lr
        assert all(abs(p["per_image_psnr"][n] - j["per_image_psnr"][n]) < lp for n in folds.ALL_IMAGES)


def test_manifest_must_partition_the_testset(tmp_path):
    for bad in (HELD[:4], [*HELD[:4], ["13", "14", "14"]], [*HELD, ["15"]]):
        path = str(tmp_path / "m.json")
        with open(path, "w") as f:
            json.dump({"folds": {f"f{k}": {"weights": "w", "held_out": h} for k, h in enumerate(bad)}}, f)
        with pytest.raises(ValueError, match="partition"):
            folds.load_manifest(path)
        with pytest.raises(ValueError, match="partition"):
            jfolds.load_manifest(path)
    path = str(tmp_path / "ok.json")
    with open(path, "w") as f:
        json.dump({"model": "m", "folds": {f"f{k}": {"weights": "w", "held_out": h} for k, h in enumerate(HELD)}}, f)
    assert folds.load_manifest(path) == jfolds.load_manifest(path)
    assert folds.ALL_IMAGES == jfolds.ALL_IMAGES


def test_missing_fold_weights_are_skipped_as_in_the_jax_module(tmp_path):
    path = str(tmp_path / "m.json")
    with open(path, "w") as f:
        json.dump({"folds": {f"f{k}": {"weights": str(tmp_path / f"none{k}.npz"), "held_out": h}
                             for k, h in enumerate(HELD)}}, f)
    argv = ["--manifest", path, "--device", "cpu", "--out", str(tmp_path / "o.jsonl")]
    assert _run(folds.main, argv) == _run(jfolds.main, argv)


def test_the_card_is_the_default_device(tmp_path):
    """Without ``--device cpu`` each CLI run asks for the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tdir, ddir = write_assets(str(tmp_path), n_images=15)
    os.rename(os.path.join(tdir, "set1"), os.path.join(tdir, "set"))
    manifest, arch = _manifest(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        folds.main(["--manifest", manifest, "--out", str(tmp_path / "o.jsonl"),
                    "--extra", " ".join(["--testsets_dir", tdir, "--data_dir", ddir, *arch])])
