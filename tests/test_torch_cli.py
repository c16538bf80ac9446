"""The port's command line (``cli/main.py``) against the JAX package's, on
the CPU, on the same files.

Each case writes a testset ``set1`` of three 32 x 32 PNG scenes, the three
masks and ``noises.mat`` (``test_torch_experiments.write_assets``) and, for
the CNN algorithms, a narrow network's weights as an npz (the port's
``save_npz``, Flax-rule initialisation from a seeded generator), and runs
``main(argv)`` of both packages with the same arguments plus ``--cpu``, each
into its own ``--results_dir``. What must agree (``check_same``): the result
line's keys, ``images``, ``iters`` and image names exactly; PSNR (mean and
per image), SSIM and RE within ``LIMITS`` of ``test_torch_experiments``
(float64: 1e-6 dB, 1e-9, 1e-9; float32: 1e-4 dB, 1e-6, 1e-6); the ``.log``
lines once their timestamps are cut, exactly; the PNGs pixel for pixel in
float64 (in float32 within one grey level, on at most 1% of the pixels:
a rounding at .5 may fall either way).

This file holds the parser, the classical, FISTA/PGD, consensus-L1 and BM3D
algorithms, the float32 runs of the solver families and the device rules;
``test_torch_cli_restore.py`` the CNN algorithms and ``pnp_sr`` /
``pnp_deblur``. JAX's BM3D runs in its tree form there as in
``test_torch_pnp_bm3d.py`` (its matrix form keeps its Haar matrices in
float32).
"""

import contextlib
import dataclasses
import io
import json
import logging
import os
import re
import warnings

import cv2
import numpy as np
import pytest
import torch

import jax

from pnp_admm_cnc_mri_tpu import config as jconfig
from pnp_admm_cnc_mri_tpu.cli import main as jmain
from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore
from pnp_admm_cnc_mri_torch import config as pconfig
from pnp_admm_cnc_mri_torch.cli import main as pmain
from pnp_admm_cnc_mri_torch.data import images
from pnp_admm_cnc_mri_torch.models import convert
from test_torch_experiments import LIMITS, write_assets

KEYS = {"psnr", "ssim", "re", "per_image_psnr", "wall_s", "images", "iters"}
TS = re.compile(r"^\d\d-\d\d-\d\d \d\d:\d\d:\d\d\.\d{3} : ")
# narrow networks: (the port's module, the CLI's --nc/--nb)
NARROW = {
    "dncnn_25": ("DnCNN", ["--nc", "8", "--nb", "3"]),
    "fdncnn_gray": ("FDnCNN", ["--nc", "8", "--nb", "3"]),
    "ffdnet_gray": ("FFDNet", ["--nc", "8", "--nb", "3"]),
    "ircnn_gray": ("IRCNN", ["--nc", "8"]),
    "drunet_gray": ("UNetRes", ["--nc", "8", "--nb", "1"]),
    "tdnet": ("TDNet", ["--nc", "8", "--nb", "2"]),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def bm3d_tree():
    """JAX's BM3D in its tree form, the form the port runs."""
    jcore._STACK_FILTER_TREE = True
    jax.clear_caches()
    yield
    jcore._STACK_FILTER_TREE = None
    jax.clear_caches()


# the full widths, for the restoration pipelines, which take no --nc / --nb
FULL = {"DnCNN": dict(nc=64, nb=17), "FDnCNN": dict(nc=64, nb=20), "FFDNet": dict(nc=64, nb=15),
        "IRCNN": dict(nc=64), "UNetRes": dict(nc=64, nb=4), "TDNet": dict(nc=128, nb=12)}


def narrow_weights(root, name, seed=0, full=False):
    """A ``name`` network's npz under ``root``, narrow (``NARROW``) or at full
    width (Flax-rule init from a seeded generator; IRCNN as the 25-bin
    stack); returns (path, the CLI's --nc/--nb)."""
    from pnp_admm_cnc_mri_torch.models import dncnn, drunet, ffdnet, tdnet

    cls, arch = NARROW[name]
    kw = FULL[cls] if full else {k.lstrip("-"): int(v) for k, v in zip(arch[::2], arch[1::2])}
    nc, nb = kw["nc"], kw.get("nb")
    make = {"DnCNN": lambda: dncnn.DnCNN(1, 1, nc=nc, nb=nb), "FDnCNN": lambda: dncnn.FDnCNN(2, 1, nc=nc, nb=nb),
            "FFDNet": lambda: ffdnet.FFDNet(1, 1, nc=nc, nb=nb), "IRCNN": lambda: dncnn.IRCNN(1, 1, nc=nc),
            "UNetRes": lambda: drunet.UNetRes(2, 1, nc=(nc, 2 * nc, 4 * nc, 8 * nc), nb=nb),
            "TDNet": lambda: tdnet.TDNet(1, 1, nc=nc, nb=nb)}[cls]
    gen = torch.Generator().manual_seed(seed)
    path = os.path.join(str(root), f"{name}_{'full' if full else 'narrow'}.npz")
    if cls == "IRCNN":
        sds = [convert.flax_init_(make(), gen).state_dict() for _ in range(25)]
        convert.save_npz({k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}, path)
    else:
        convert.save_npz(convert.flax_init_(make(), gen), path)
    return path, [] if full else arch


def reset_loggers():
    """Close the files that the JAX package's result loggers keep open: its
    ``score_and_log`` leaves the handlers on ``logging.getLogger(result_name)``,
    which the next run of that name, in either package, would log through.
    (The port's ``score_and_log`` releases its own.)"""
    for log in list(logging.Logger.manager.loggerDict.values()):
        if isinstance(log, logging.Logger) and any(isinstance(h, logging.FileHandler) for h in log.handlers):
            for h in list(log.handlers):
                h.close()
                log.removeHandler(h)


def run_cli(main, argv):
    """``main(argv)`` in-process; (its return code, the JSON of its last stdout line)."""
    reset_loggers()  # what an earlier JAX run left
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(argv)
    if main is jmain.main:
        reset_loggers()
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def run_both(tmp_path, argv, assets=None):
    """Both CLIs on the same files and arguments (plus ``--cpu`` and each its
    own results directory); returns (port result, JAX result, port dir, JAX dir)."""
    tdir, ddir = assets or write_assets(str(tmp_path))
    out = {}
    for tag, main in (("port", pmain.main), ("jax", jmain.main)):
        rdir = str(tmp_path / tag)
        rc, out[tag] = run_cli(main, [*argv, "--cpu", "--testsets_dir", tdir, "--data_dir", ddir,
                                      "--results_dir", rdir])
        assert rc == 0
    return out["port"], out["jax"], tmp_path / "port", tmp_path / "jax"


def check_same(got, ref, pdir, jdir, dtype=torch.float64, saved=True):
    lp, ls, lr = LIMITS[dtype]
    assert set(got) == set(ref) == KEYS
    assert got["images"] == ref["images"] and got["iters"] == ref["iters"]
    assert list(got["per_image_psnr"]) == list(ref["per_image_psnr"])
    assert abs(got["psnr"] - ref["psnr"]) < lp
    assert abs(got["ssim"] - ref["ssim"]) < ls and abs(got["re"] - ref["re"]) < lr
    for k, v in got["per_image_psnr"].items():
        assert np.isfinite(v) and abs(v - ref["per_image_psnr"][k]) < lp, k
    assert got["wall_s"] > 0
    [pres], [jres] = os.listdir(pdir), os.listdir(jdir)
    assert pres == jres
    plog, jlog = ([TS.sub("", line) for line in open(os.path.join(d, res, res + ".log")).read().splitlines()]
                  for d, res in ((pdir, pres), (jdir, jres)))
    assert len(plog) == got["images"] + 1
    if dtype == torch.float64:
        assert plog == jlog
    pngs = sorted(f for f in os.listdir(os.path.join(pdir, pres)) if f.endswith(".png"))
    assert pngs == sorted(f for f in os.listdir(os.path.join(jdir, jres)) if f.endswith(".png"))
    assert len(pngs) == (got["images"] if saved else 0)
    for f in pngs:
        a = images.imread_gray(os.path.join(pdir, pres, f)).astype(int)
        b = images.imread_gray(os.path.join(jdir, jres, f)).astype(int)
        if dtype == torch.float64:
            assert np.array_equal(a, b), f
        else:
            assert np.abs(a - b).max() <= 1 and np.mean(a != b) <= 0.01, f


def _actions(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default, repr(a.choices), a.nargs, a.const, a.type,
                   type(a).__name__) for a in parser._actions)


def test_parser_equals_the_jax_clis():
    """Every flag: option strings, dest, default, choices, nargs, const,
    type and action; the 19 algorithms in order."""
    assert _actions(pmain.build_parser()) == _actions(jmain.build_parser())
    algo = [a for a in pmain.build_parser()._actions if a.dest == "algo"][0]
    jalgo = [a for a in jmain.build_parser()._actions if a.dest == "algo"][0]
    assert list(algo.choices) == list(jalgo.choices) and len(algo.choices) == 19


@pytest.mark.parametrize("argv", [
    ["admm_l1"], ["admm_cnc"], ["admm_l1", "--iter_num", "7", "--lambda1", "0.05", "--reo", "0.02"],
    ["admm_cnc", "--mask", "Q_Cartesian30", "--alpha", "0.3", "--b", "40", "--images", "03,01"],
    ["fista_l1", "--iter_num", "20"], ["pgd_l1", "--tuned", "--iter_num", "12"],
    ["fista_l1", "--step", "0.8", "--lambda1", "3e-4", "--iter_num", "9", "--mask", "Q_Radial30"],
    ["consensus_l1", "--iter_num", "10"],
], ids=lambda a: "_".join(a))
def test_classical_algorithms_f64(tmp_path, argv):
    got, ref, pdir, jdir = run_both(tmp_path, [*argv, "--f64"])
    check_same(got, ref, pdir, jdir)


@pytest.mark.parametrize("argv", [
    ["pnp_l1_bm3d", "--iter_num", "2"],
    ["pnp_cnc_bm3d", "--tuned", "--iter_num", "2", "--images", "02"],
    ["pnp_fista_d", "--model", "bm3d", "--iter_num", "2", "--nlm", "20", "--images", "01"],
    ["pnp_hqs_d", "--model", "bm3d", "--iter_num", "2", "--images", "03"],
], ids=lambda a: "_".join(a[:3]))
def test_bm3d_algorithms_f64(tmp_path, bm3d_tree, argv):
    got, ref, pdir, jdir = run_both(tmp_path, [*argv, "--f64"])
    check_same(got, ref, pdir, jdir)


@pytest.mark.parametrize("argv", [
    ["admm_l1"], ["admm_cnc", "--no_save"], ["fista_l1", "--iter_num", "20"], ["consensus_l1", "--iter_num", "10"],
], ids=lambda a: a[0])
def test_solver_families_f32(tmp_path, argv):
    got, ref, pdir, jdir = run_both(tmp_path, argv)
    check_same(got, ref, pdir, jdir, torch.float32, saved="--no_save" not in argv)


def test_each_run_logs_into_its_own_results_dir(tmp_path):
    """Two in-process runs of one result name into two results directories:
    each ``.log`` holds its own run's lines, and no handler stays open."""
    tdir, ddir = write_assets(str(tmp_path))
    reset_loggers()
    for k in range(2):
        rc, _ = run_cli(pmain.main, ["admm_l1", "--cpu", "--f64", "--iter_num", "3", "--testsets_dir", tdir,
                                     "--data_dir", ddir, "--results_dir", str(tmp_path / f"r{k}")])
        assert rc == 0
        [res] = os.listdir(tmp_path / f"r{k}")
        assert not logging.getLogger(res).handlers
    for k in range(2):
        [res] = os.listdir(tmp_path / f"r{k}")
        lines = open(os.path.join(tmp_path / f"r{k}", res, res + ".log")).read().splitlines()
        assert len(lines) == 4 and "Average PSNR" in lines[-1]


def test_without_a_card_the_cli_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tdir, ddir = write_assets(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmain.main(["admm_l1", "--testsets_dir", tdir, "--data_dir", ddir, "--results_dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


def test_helpers_match_the_jax_clis():
    """``_apply_tuned`` backfills ``nlm`` only when the flag is absent; the
    other helpers map the same arguments to the same values."""
    tuned = {"iter_num": 4, "alpha": 1.8, "nlm": 12.0, "x8": True}
    for argv in (["pnp_l1_d"], ["pnp_l1_d", "--nlm", "9", "--step", "0.5", "--nc", "16", "--nb", "2"],
                 ["pnp_cnc_d", "--iter_num", "3", "--alpha", "1.1", "--tol", "1e-4"]):
        pa, ja = pmain.build_parser().parse_args(argv), jmain.build_parser().parse_args(argv)
        assert pmain._arch_overrides(pa) == jmain._arch_overrides(ja)
        assert pmain._resolve_step(pa, {"step": 0.7}) == jmain._resolve_step(ja, {"step": 0.7})
        pcfg = pmain._merge_cfg(pmain._apply_tuned(pconfig.ADMM_CNC_DEFAULT, tuned, pa), pa)
        jcfg = jmain._merge_cfg(jmain._apply_tuned(jconfig.ADMM_CNC_DEFAULT, tuned, ja), ja)
        assert pa.nlm == ja.nlm and dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)


def test_kair_pth_weights_through_both_clis(tmp_path):
    """``--weights`` takes the reference's KAIR ``.pth``: a DnCNN checkpoint
    in its key layout (``model.{2i}.weight`` / ``.bias``) gives the JAX CLI's
    lines, float64, and the port's lines from the same weights as an npz."""
    g = torch.Generator().manual_seed(3)
    shapes = [(8, 1)] + [(8, 8)] + [(1, 8)]
    sd = {}
    for i, (o, c) in enumerate(shapes):
        sd[f"model.{2 * i}.weight"] = torch.randn(o, c, 3, 3, generator=g) * (9 * c) ** -0.5
        sd[f"model.{2 * i}.bias"] = torch.randn(o, generator=g) * 0.01
    pth = str(tmp_path / "dncnn_kair.pth")
    torch.save(sd, pth)
    argv = ["pnp_l1_d", "--model", "dncnn_25", "--nc", "8", "--nb", "3", "--iter_num", "4", "--f64"]
    got, ref, pdir, jdir = run_both(tmp_path, [*argv, "--weights", pth])
    check_same(got, ref, pdir, jdir)
    from pnp_admm_cnc_mri_torch.models import dncnn

    net = dncnn.DnCNN(1, 1, nc=8, nb=3)
    net.load_state_dict(convert.state_dict_from_flax(net, convert.convert_dncnn(sd, nb=3)))
    npz = str(tmp_path / "dncnn.npz")
    convert.save_npz(net, npz)
    tdir, ddir = write_assets(str(tmp_path / "again"))
    rc, via_npz = run_cli(pmain.main, [*argv, "--weights", npz, "--cpu", "--testsets_dir", tdir, "--data_dir", ddir,
                                       "--results_dir", str(tmp_path / "npz")])
    assert rc == 0 and via_npz["per_image_psnr"] == got["per_image_psnr"]


def test_testset_of_bmp_and_jpeg_payloads_through_both_clis(tmp_path):
    """A testset laid out as the reference's, ``.png`` names over BMP and
    JPEG payloads, solves in the port's CLI as in the JAX CLI (float64)."""
    tdir, ddir = write_assets(str(tmp_path / "assets"))
    set1 = os.path.join(tdir, "set1")
    for k, name in enumerate(sorted(os.listdir(set1))):
        img = cv2.imread(os.path.join(set1, name), cv2.IMREAD_GRAYSCALE)
        if k == 0:
            img = cv2.merge([img, np.uint8(img * 0.9), np.uint8(img * 0.8)])  # a colour BMP
        ext, params = ((".bmp", []), (".jpg", [cv2.IMWRITE_JPEG_QUALITY, 90]), (".jpg", []))[k]
        with open(os.path.join(set1, name), "wb") as f:
            f.write(cv2.imencode(ext, img, params)[1].tobytes())
    got, ref, pdir, jdir = run_both(tmp_path, ["admm_l1", "--f64"], assets=(tdir, ddir))
    check_same(got, ref, pdir, jdir)
