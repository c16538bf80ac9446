"""The scenario sweep (``cli/sweep.py``) of both packages on the same files,
on the CPU.

``build_grid`` must be bit-equal to the JAX function in ``ys``, ``ms``,
``idxs`` and ``labels``, whole chunks and ragged ones (the port fills a
preallocated complex64 grid a chunk of images and a (sigma, mask) block at
a time, the JAX package one scenario at a time). ``main`` runs in both packages with ``--cpu`` on a testset of three
32 x 32 PNG scenes, the three masks and ``noises.mat`` written to
``tmp_path`` (``test_torch_experiments.write_assets``); the JAX package's
loaders are pointed there by setting ``images.DEFAULT_TESTSETS`` and
``masks``/``noise``'s ``DEFAULT_DATA_DIR`` (monkeypatched, here only). The
JAX sweep shards over the 8 host devices of ``tests/conftest.py`` and pads
with repeated scenarios; only the true scenarios are compared.

Limits (float32 solves, as both sweeps run): each row's PSNR within 1e-4
dB (measured at most 1.5e-6 dB) and relative residual within 1e-6 + 1e-5
|residual| (measured at most 2.8e-9 for ``admm_l1``, whose residuals are
float32 rounding, ~2e-9, from the second iteration on; 9.7e-8 for
``admm_cnc`` at 5e-5 to 3e-3; 7.6e-6 for ``pnp_fista_d`` at 14 to 18;
2.4e-7 for ``red_d`` at 0.32 to 0.37); labels in order, ``scenarios``,
``iters`` and ``converged_fraction`` equal; ``avg_psnr`` (rounded to 3
decimals by both) within 1e-3. Each ``--tol`` lies at least 100 times the
largest residual gap of its run from every residual, which the test
asserts, so that the converged fraction cannot differ by float32 rounding:
it splits the grid in half, except for ``admm_l1``, all of whose residuals
lie far below any useful tolerance.
The PnP branches (``pnp_fista_d``, ``red_d``) build a small DnCNN (nc 8,
nb 3) with Flax-initialised weights in both packages.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.cli import sweep as jsweep
from pnp_admm_cnc_mri_tpu.data import images as jimages
from pnp_admm_cnc_mri_tpu.data import masks as jmasks
from pnp_admm_cnc_mri_tpu.data import noise as jnoise
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdn
from pnp_admm_cnc_mri_torch.cli import sweep
from pnp_admm_cnc_mri_torch.data import images, masks, noise, phantom
from pnp_admm_cnc_mri_torch.priors import denoiser as dn

import test_torch_ranks as ranks
from test_torch_experiments import write_assets

# --algo: (extra argv, tol, converged fraction)
RUNS = {
    "admm_l1": (["--iter_num", "10"], 1e-3, 1.0),
    "admm_cnc": (["--iter_num", "10"], 2e-4, 0.5),
    "pnp_fista_d": (["--iter_num", "4"], 14.8, 0.5),
    "red_d": (["--iter_num", "4"], 0.345, 0.5),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _grid_inputs(n_img=3, n=16):
    imgs = phantom.mri_phantoms(n_img, n, seed=1).astype(np.float64)
    ms = {"Q_Random30": masks.random_mask((n, n), 0.3, seed=3), "Q_Radial30": masks.radial_mask((n, n), 8),
          "Q_Cartesian30": masks.cartesian_mask((n, n), 0.3, seed=4)}
    return imgs, ms, noise.synth_noise((n, n), std=3.0, seed=5)


@pytest.mark.parametrize("sigmas,n_img", [([1.0], 3), ([1.0, 3.0, 5.0], 2 * sweep.CHUNK + 3), ([0.0, 2.5], sweep.CHUNK)])
def test_build_grid_bit_equal(sigmas, n_img):
    imgs, ms, base = _grid_inputs(n_img=n_img, n=8 if n_img > 3 else 16)
    got, ref = sweep.build_grid(imgs, ms, sigmas, base), jsweep.build_grid(imgs, ms, sigmas, base)
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert got[3] == ref[3] and len(got[3]) == n_img * 3 * len(sigmas)
    assert got[0].dtype == np.complex64 and got[1].dtype == np.float32


def test_build_grid_one_mask_one_image():
    imgs, ms, base = _grid_inputs(n_img=1)
    one = {"Q_Radial30": ms["Q_Radial30"]}
    got, ref = sweep.build_grid(imgs, one, [2.0], base), jsweep.build_grid(imgs, one, [2.0], base)
    assert all(np.array_equal(a, b) for a, b in zip(got[:3], ref[:3])) and got[3] == ref[3] == ["img0_Q_Radial30_s2.0"]


@pytest.fixture(scope="module")
def small_dncnn():
    model = jdncnn.DnCNN(out_nc=1, nc=8, nb=3)
    tree = jax.tree.map(np.asarray, dict(model.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 1), jnp.float32))))

    def small(build):
        return lambda name, **kw: build(name, **{**kw, "weights": None, "params": tree, "nc": 8, "nb": 3})

    return small


def _rows(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


@pytest.mark.parametrize("algo", list(RUNS))
def test_main_matches_jax(tmp_path, monkeypatch, capsys, small_dncnn, algo):
    tdir, ddir = write_assets(str(tmp_path))
    monkeypatch.setattr(jimages, "DEFAULT_TESTSETS", tdir)
    monkeypatch.setattr(jmasks, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(jnoise, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(images, "DEFAULT_TESTSETS", tdir)
    monkeypatch.setattr(masks, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(noise, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(jdn, "build_denoiser", small_dncnn(jdn.build_denoiser))
    monkeypatch.setattr(dn, "build_denoiser", small_dncnn(dn.build_denoiser))
    extra, tol, fraction = RUNS[algo]
    argv = ["--algo", algo, "--testset", "set1", "--sigmas", "1,3", "--tol", str(tol), *extra]
    summaries = {}
    for tag, main, dev in (("port", sweep.main, ["--cpu"]), ("jax", jsweep.main, ["--cpu"])):
        out = str(tmp_path / f"{tag}.jsonl")
        assert main(argv + dev + ["--out", out]) == 0
        summaries[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got, ref = _rows(tmp_path / "port.jsonl"), _rows(tmp_path / "jax.jsonl")
    s, js = summaries["port"], summaries["jax"]
    assert s["scenarios"] == js["scenarios"] == len(got) == len(ref) == 18 and s["devices"] == 1
    assert [r["scenario"] for r in got] == [r["scenario"] for r in ref]
    assert got[0]["scenario"] == "img0_Q_Random30_s1.0" and got[-1]["scenario"] == "img2_Q_Cartesian30_s3.0"
    assert got[0]["argv"] == argv + ["--cpu", "--out", str(tmp_path / "port.jsonl")]
    rel, jrel = np.array([r["residual"] for r in got]), np.array([r["residual"] for r in ref])
    psnr, jpsnr = np.array([r["psnr"] for r in got]), np.array([r["psnr"] for r in ref])
    assert np.all(np.isfinite(rel)) and np.all(np.isfinite(psnr))
    np.testing.assert_allclose(psnr, jpsnr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rel, jrel, rtol=1e-5, atol=1e-6)
    gap = float(np.abs(rel - jrel).max())
    assert float(np.abs(rel - tol).min()) > 100 * gap, (np.sort(rel), tol, gap)
    assert s["iters"] == js["iters"] == int(extra[-1]) and s["tol"] == js["tol"] == tol
    assert s["converged_fraction"] == js["converged_fraction"] == fraction
    assert abs(s["avg_psnr"] - js["avg_psnr"]) <= 1e-3 + 1e-9
    assert s["wall_s"] > 0 and s["scenario_iters_per_s"] > 0


def test_main_repeat_and_timings(tmp_path, monkeypatch, capsys):
    tdir, ddir = write_assets(str(tmp_path), n_images=2)
    monkeypatch.setattr(images, "DEFAULT_TESTSETS", tdir)
    monkeypatch.setattr(masks, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(noise, "DEFAULT_DATA_DIR", ddir)
    timings = {}
    out = str(tmp_path / "r.jsonl")
    assert sweep.main(["--testset", "set1", "--masks", "Q_Radial30", "--iter_num", "3", "--repeat", "2", "--cpu",
                       "--out", out], timings=timings) == 0
    s = json.loads(capsys.readouterr().out.strip())
    rows = _rows(out)
    assert s["scenarios"] == len(rows) == 4 and [r["scenario"] for r in rows] == ["img0_Q_Radial30_s1.0",
                                                                                "img1_Q_Radial30_s1.0"] * 2
    assert rows[0]["psnr"] == rows[2]["psnr"] and rows[1]["residual"] == rows[3]["residual"]
    assert set(timings) == {"load", "grid", "h2d", "solve", "score", "records"}
    assert timings["solve"] == pytest.approx(s["wall_s"], abs=1e-3)


def test_main_needs_the_card_or_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tdir, ddir = write_assets(str(tmp_path), n_images=1)
    monkeypatch.setattr(images, "DEFAULT_TESTSETS", tdir)
    monkeypatch.setattr(masks, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(noise, "DEFAULT_DATA_DIR", ddir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.main(["--testset", "set1"])


def test_build_grid_rows_are_the_grids_rows():
    imgs, ms, base = _grid_inputs(n_img=20)
    full = sweep.build_grid(imgs, ms, [1.0, 2.0], base)
    for rows in (np.arange(60, 120), np.array([119, 0, 33, 5, 5, 64]), np.arange(100, 120)):
        part = sweep.build_grid(imgs, ms, [1.0, 2.0], base, rows=rows)
        for a, b in zip(part[:3], full[:3]):
            assert np.array_equal(a, b[rows]) and a.dtype == b.dtype
        assert part[3] == [full[3][r] for r in rows]


# -- world 2: two gloo ranks (test_torch_ranks.cli_rank) against the one-process run.
# The 3 images x 3 masks x 1 sigma grid (9 scenarios) pads to 10, one repeated row on rank 1.

WORLD2_ALGOS = ("admm_l1", "admm_cnc")


def _world2_argv(root, algo, tag):
    extra, tol, _ = RUNS[algo]
    return ["--cpu", "--algo", algo, "--testset", "set1", "--tol", str(tol), *extra, "--out",
            str(root / f"{algo}_{tag}.jsonl")]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep_world2")
    tdir, ddir = write_assets(str(root))
    runs = [(algo, _world2_argv(root, algo, "w2")) for algo in WORLD2_ALGOS]
    ranks.launch(ranks.cli_rank, 2, str(root), "pnp_admm_cnc_mri_torch.cli.sweep", runs, tdir, ddir)
    return root, tdir, ddir


@pytest.mark.parametrize("algo", WORLD2_ALGOS)
def test_world_2_equals_world_1(world2, monkeypatch, capsys, algo):
    root, tdir, ddir = world2
    monkeypatch.setattr(images, "DEFAULT_TESTSETS", tdir)
    monkeypatch.setattr(masks, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(noise, "DEFAULT_DATA_DIR", ddir)
    assert sweep.main(_world2_argv(root, algo, "w1")) == 0
    one = json.loads(capsys.readouterr().out.strip())
    two = [(root / f"{algo}_rank{r}.txt").read_text().strip().splitlines() for r in range(2)]
    assert len(two[0]) == 1 and two[1] == []  # rank 0 alone prints
    two = json.loads(two[0][0])
    assert two["devices"] == 2 and one["devices"] == 1 and two["scenarios"] == one["scenarios"] == 9
    for k in ("iters", "avg_psnr", "converged_fraction", "tol"):
        assert two[k] == one[k], k
    got, want = _rows(root / f"{algo}_w2.jsonl"), _rows(root / f"{algo}_w1.jsonl")
    assert [r["scenario"] for r in got] == [r["scenario"] for r in want] and len(got) == 9
    for a, b in zip(got, want):
        assert a["psnr"] == b["psnr"] and a["residual"] == b["residual"]

