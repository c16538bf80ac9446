"""The MRI experiment runners (``cli/experiments.py``) of both packages on
the same files, on the CPU.

Each test writes a testset of three 32 x 32 PNG scenes (``cv2.imwrite``),
the three masks as ``Q_*30.mat`` (key ``Q1``, from the port's generators)
and ``noises.mat`` into ``tmp_path``, and runs a runner of each package on
them with ``testsets_dir`` and ``data_dir`` set there, each into its own
``results_dir``. Both packages log through ``logging.getLogger(result_name)``,
so the logger's handlers are closed and cleared before each run.

What must agree: ``images``, ``iters`` and the names of
``per_image_psnr`` exactly; the log lines once the timestamp is cut off,
exactly; the saved PNGs pixel for pixel; ``prepare_batch``'s observation
bit for bit. The metrics, in float64 (x within 1e-9 of the JAX package's):
PSNR within 1e-6 dB, SSIM and RE within 1e-9 (measured at most 7.1e-15 dB,
3.3e-16 and 1.4e-16 over the eleven float64 runs). In float32: PSNR within
1e-4 dB, SSIM and RE within 1e-6 (measured at most 1.2e-6 dB, 2.6e-8 and
9.3e-9 over the three float32 runs: the solvers' float32 FFTs and
convolutions round differently in torch and XLA).

The PnP runners take a small DnCNN (nc 8, nb 3) with Flax-initialised
weights carried across by ``models/convert.py`` (``params=``), and one plain
callable (a 3 x 3 circular box blur) in both packages.
"""

import logging
import os

import cv2
import numpy as np
import pytest
import scipy.io as sio
import torch

import jax
import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.cli import experiments as jexp
from pnp_admm_cnc_mri_tpu.models import dncnn as jdncnn
from pnp_admm_cnc_mri_tpu.priors import denoiser as jdn
from pnp_admm_cnc_mri_torch import config
from pnp_admm_cnc_mri_torch.cli import experiments
from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.data import masks, noise
from pnp_admm_cnc_mri_torch.priors import denoiser as dn

N = 32
CPU = "cpu"
JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32}
# (psnr dB, ssim, re) limits against the JAX package
LIMITS = {torch.float64: (1e-6, 1e-9, 1e-9), torch.float32: (1e-4, 1e-6, 1e-6)}
NAMES = ["01", "02", "03"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def write_assets(root, n=N, n_images=3, seed=0):
    """A testset ``set1`` of ``n_images`` PNG scenes, the three masks and
    ``noises.mat`` under ``root``; returns (testsets_dir, data_dir)."""
    tdir, ddir = os.path.join(root, "testsets"), os.path.join(root, "CS_MRI")
    os.makedirs(os.path.join(tdir, "set1"))
    os.makedirs(ddir)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    for k in range(n_images):
        scene = 110 + 80 * np.sin(xx / (3.0 + k)) * np.cos(yy / (4.0 + k))
        scene += np.where((xx - n / 2) ** 2 + (yy - n / 3 - k) ** 2 < (n / 5) ** 2, 50.0, 0.0)
        scene += rng.integers(0, 12, (n, n))
        cv2.imwrite(os.path.join(tdir, "set1", f"{k + 1:02d}.png"), np.uint8(np.clip(scene, 0, 255)))
    gens = {"Q_Random30": masks.random_mask((n, n), fraction=0.3, seed=1),
            "Q_Radial30": masks.radial_mask((n, n), n_spokes=12),
            "Q_Cartesian30": masks.cartesian_mask((n, n), fraction=0.3, seed=2)}
    for name, m in gens.items():
        sio.savemat(os.path.join(ddir, masks.MASK_FILES[name]), {"Q1": m.astype(np.uint8)})
    sio.savemat(os.path.join(ddir, "noises.mat"), {"noises": noise.synth_noise((n, n), std=1.0, seed=2)})
    return tdir, ddir


@pytest.fixture
def assets(tmp_path):
    return write_assets(str(tmp_path))


def fresh_logger(name):
    log = logging.getLogger(name)
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)


def _box(v, i):
    k = sum(torch.roll(v, (a, b), (-2, -1)) for a in (-1, 0, 1) for b in (-1, 0, 1))
    return k / 9.0


def _jbox(v, i):
    k = sum(jnp.roll(v, (a, b), (-2, -1)) for a in (-1, 0, 1) for b in (-1, 0, 1))
    return k / 9.0


@pytest.fixture(scope="module")
def dncnn_tree():
    model = jdncnn.DnCNN(out_nc=1, nc=8, nb=3)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1), jnp.float32))
    return jax.tree.map(np.asarray, dict(variables))


def dncnn_pair(tree, dtype, iter_num):
    kw = dict(nc=8, nb=3, iter_num=iter_num, params=tree)
    return (dn.build_denoiser("dncnn_25", param_dtype=dtype, device=CPU, **kw),
            jdn.build_denoiser("dncnn_25", param_dtype=JNP[dtype], **kw))


def run_both(tmp_path, assets, port_fn, jax_fn, result_name, dtype, **kw):
    """Run both runners on the files of ``assets`` with the same keyword
    arguments; returns (port result, JAX result, port dir, JAX dir)."""
    tdir, ddir = assets
    out = {}
    for tag, fn, extra in (("port", port_fn, dict(dtype=dtype, device=CPU)), ("jax", jax_fn, dict(dtype=JNP[dtype]))):
        fresh_logger(result_name)
        out[tag] = fn(testsets_dir=tdir, data_dir=ddir, results_dir=str(tmp_path / tag), **extra, **kw)
    fresh_logger(result_name)
    return out["port"], out["jax"], tmp_path / "port" / result_name, tmp_path / "jax" / result_name


def check_agree(got, ref, dtype, pdir, jdir, result_name, saved=True):
    lp, ls, lr = LIMITS[dtype]
    assert got["images"] == ref["images"] and got["iters"] == ref["iters"]
    assert list(got["per_image_psnr"]) == list(ref["per_image_psnr"])
    assert abs(got["psnr"] - ref["psnr"]) < lp
    assert abs(got["ssim"] - ref["ssim"]) < ls and abs(got["re"] - ref["re"]) < lr
    for k in got["per_image_psnr"]:
        assert abs(got["per_image_psnr"][k] - ref["per_image_psnr"][k]) < lp
    assert got["wall_s"] > 0

    def lines(d):
        with open(d / f"{result_name}.log") as f:
            return [ln.split(" : ", 1)[1] for ln in f.read().splitlines()]

    assert lines(pdir) == lines(jdir) and len(lines(pdir)) == got["images"] + 1
    pngs = sorted(p.name for p in pdir.glob("*.png"))
    assert pngs == sorted(p.name for p in jdir.glob("*.png")) and len(pngs) == (got["images"] if saved else 0)
    for name in pngs:
        a = cv2.imread(str(pdir / name), cv2.IMREAD_UNCHANGED)
        assert np.array_equal(a, cv2.imread(str(jdir / name), cv2.IMREAD_UNCHANGED)), name


@pytest.mark.parametrize("algo,dtype", [("admm_l1", torch.float64), ("admm_cnc", torch.float64),
                                        ("admm_l1", torch.float32), ("admm_cnc", torch.float32)])
def test_run_classical(tmp_path, assets, algo, dtype):
    cfg = ADMMConfig(**{**(config.ADMM_L1_DEFAULT if algo == "admm_l1" else config.ADMM_CNC_DEFAULT).__dict__,
                        "iter_num": 6})
    from pnp_admm_cnc_mri_tpu import config as jconfig

    name = f"set1_dn_{algo.upper()}_Q_Radial30"
    got, ref, pdir, jdir = run_both(
        tmp_path, assets,
        lambda **k: experiments.run_classical(algo, mask_name="Q_Radial30", cfg=cfg, **k),
        lambda **k: jexp.run_classical(algo, mask_name="Q_Radial30", cfg=jconfig.ADMMConfig(**cfg.__dict__), **k),
        name, dtype)
    check_agree(got, ref, dtype, pdir, jdir, name)
    assert got["iters"] == 6 and got["images"] == 3 and list(got["per_image_psnr"]) == NAMES


@pytest.mark.parametrize("scheme,round_uint8", [("l1", False), ("cnc", True)])
def test_run_pnp(tmp_path, assets, dncnn_tree, scheme, round_uint8):
    dtype = torch.float64
    d, jd = dncnn_pair(dncnn_tree, dtype, 3)
    alpha, _, lam, rho, b = config.PNP_CNC_DEFAULTS["dncnn_pair"]
    cfg = ADMMConfig(iter_num=3, rho=rho, lam=lam, alpha=alpha, b=b)
    from pnp_admm_cnc_mri_tpu import config as jconfig

    name = "set1_dn_pnp_Q_Random30"
    got, ref, pdir, jdir = run_both(
        tmp_path, assets,
        lambda **k: experiments.run_pnp(d, cfg, scheme=scheme, round_uint8=round_uint8, **k),
        lambda **k: jexp.run_pnp(jd, jconfig.ADMMConfig(**cfg.__dict__), scheme=scheme, round_uint8=round_uint8,
                                 **k),
        name, dtype)
    check_agree(got, ref, dtype, pdir, jdir, name)


def test_run_pnp_float32_with_only(tmp_path, assets, dncnn_tree):
    dtype = torch.float32
    d, jd = dncnn_pair(dncnn_tree, dtype, 3)
    cfg = ADMMConfig(iter_num=3, rho=config.PNP_L1_DEFAULTS["dncnn_25"][1])
    from pnp_admm_cnc_mri_tpu import config as jconfig

    name = "set1_dn_dncnn_Q_Cartesian30"
    got, ref, pdir, jdir = run_both(
        tmp_path, assets,
        lambda **k: experiments.run_pnp(d, cfg, mask_name="Q_Cartesian30", only="03,01", result_tag="dncnn",
                                        save_images=False, **k),
        lambda **k: jexp.run_pnp(jd, jconfig.ADMMConfig(**cfg.__dict__), mask_name="Q_Cartesian30", only="03,01",
                                 result_tag="dncnn", save_images=False, **k),
        name, dtype)
    check_agree(got, ref, dtype, pdir, jdir, name, saved=False)
    assert list(got["per_image_psnr"]) == ["01", "03"]


@pytest.mark.parametrize("momentum", [True, False])
def test_run_fista_l1(tmp_path, assets, momentum):
    dtype = torch.float64
    name = f"set1_dn_{'FISTA_L1' if momentum else 'PGD_L1'}_Q_Random30"
    got, ref, pdir, jdir = run_both(
        tmp_path, assets, lambda **k: experiments.run_fista_l1(iter_num=5, lam=2e-3, momentum=momentum, **k),
        lambda **k: jexp.run_fista_l1(iter_num=5, lam=2e-3, momentum=momentum, **k), name, dtype)
    check_agree(got, ref, dtype, pdir, jdir, name)


def test_run_pnp_fista_with_a_plain_callable(tmp_path, assets):
    dtype = torch.float64
    name = "set1_dn_pnp_fista_Q_Random30"
    got, ref, pdir, jdir = run_both(tmp_path, assets, lambda **k: experiments.run_pnp_fista(_box, 4, **k),
                                    lambda **k: jexp.run_pnp_fista(_jbox, 4, **k), name, dtype)
    check_agree(got, ref, dtype, pdir, jdir, name)


def test_run_pnp_pgd_cnc(tmp_path, assets, dncnn_tree):
    dtype = torch.float64
    d, jd = dncnn_pair(dncnn_tree, dtype, 3)
    name = "set1_dn_pnp_pgd_cnc_Q_Radial30"
    kw = dict(iter_num=3, alpha=1.2, lam=0.02, b=36.0, mask_name="Q_Radial30")
    got, ref, pdir, jdir = run_both(tmp_path, assets, lambda **k: experiments.run_pnp_pgd_cnc(d, **kw, **k),
                                    lambda **k: jexp.run_pnp_pgd_cnc(jd, **kw, **k), name, dtype)
    check_agree(got, ref, dtype, pdir, jdir, name)


def test_run_pnp_hqs(tmp_path, assets, dncnn_tree):
    dtype = torch.float64
    d, jd = dncnn_pair(dncnn_tree, dtype, 3)
    name = "set1_dn_pnp_hqs_Q_Random30"
    kw = dict(iter_num=3, sigma255=5.0, model_sigma1=30.0, model_sigma2=10.0)
    got, ref, pdir, jdir = run_both(tmp_path, assets, lambda **k: experiments.run_pnp_hqs(d, **kw, **k),
                                    lambda **k: jexp.run_pnp_hqs(jd, **kw, **k), name, dtype)
    check_agree(got, ref, dtype, pdir, jdir, name)


@pytest.mark.parametrize("variant", ["fp", "gd"])
def test_run_red(tmp_path, assets, dncnn_tree, variant):
    dtype = torch.float64
    d, jd = dncnn_pair(dncnn_tree, dtype, 3)
    name = "set1_dn_red_Q_Random30"
    kw = dict(iter_num=3, lam=0.3, step=0.8, variant=variant)
    got, ref, pdir, jdir = run_both(tmp_path, assets, lambda **k: experiments.run_red(d, **kw, **k),
                                    lambda **k: jexp.run_red(jd, **kw, **k), name, dtype)
    check_agree(got, ref, dtype, pdir, jdir, name)


def test_prepare_batch_bit_equal(assets):
    tdir, ddir = assets
    for only in (None, "02"):
        got = experiments.prepare_batch(os.path.join(tdir, "set1"), "Q_Cartesian30", ddir, only=only)
        ref = jexp.prepare_batch(os.path.join(tdir, "set1"), "Q_Cartesian30", ddir, only=only)
        assert got["names"] == ref["names"]
        for k in ("imgs01", "truth", "y", "mask"):
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    with pytest.raises(ValueError, match="not in testset"):
        experiments.prepare_batch(os.path.join(tdir, "set1"), "Q_Random30", ddir, only="01,99")


def test_only_keeps_each_images_full_set_result(tmp_path, assets):
    tdir, ddir = assets
    cfg = ADMMConfig(iter_num=4)
    kw = dict(cfg=cfg, testsets_dir=tdir, data_dir=ddir, save_images=False, dtype=torch.float64, device=CPU)
    fresh_logger("set1_dn_ADMM_L1_Q_Random30")
    full = experiments.run_classical(results_dir=str(tmp_path / "a"), **kw)
    fresh_logger("set1_dn_ADMM_L1_Q_Random30")
    part = experiments.run_classical(results_dir=str(tmp_path / "b"), only="02", **kw)
    fresh_logger("set1_dn_ADMM_L1_Q_Random30")
    assert part["images"] == 1 and abs(part["per_image_psnr"]["02"] - full["per_image_psnr"]["02"]) < 1e-9


def test_score_and_log_round_uint8_and_dtypes(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.random((2, 24, 24))
    truth = np.round(np.clip(x + 0.05 * rng.standard_normal(x.shape), 0, 1) * 255.0)
    names = ["a", "b"]
    for dtype in (np.float64, np.float32):
        for r in (False, True):
            outs = []
            for tag, fn, arr in (("p", experiments.score_and_log, torch.from_numpy(x.astype(dtype))),
                                 ("j", jexp.score_and_log, x.astype(dtype))):
                fresh_logger("score")
                outs.append(fn(arr, truth, names, "score", str(tmp_path / tag), False, r))
            fresh_logger("score")
            assert outs[0]["per_image_psnr"].keys() == outs[1]["per_image_psnr"].keys()
            for k in ("psnr", "ssim", "re"):
                assert abs(outs[0][k] - outs[1][k]) < 1e-9, (dtype, r, k)


def test_runners_need_the_card_or_the_cpu(assets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    tdir, ddir = assets
    with pytest.raises(RuntimeError, match="device='cpu'"):
        experiments.run_classical(testsets_dir=tdir, data_dir=ddir, save_images=False)


def test_mask_loaders_and_names(assets):
    from pnp_admm_cnc_mri_tpu import config as jconfig
    from pnp_admm_cnc_mri_tpu.data import masks as jmasks

    _, ddir = assets
    assert config.MASK_NAMES == jconfig.MASK_NAMES and masks.MASK_FILES == jmasks.MASK_FILES
    got, ref = masks.load_all_masks(data_dir=ddir), jmasks.load_all_masks(data_dir=ddir)
    assert list(got) == list(ref) == list(config.MASK_NAMES)
    for k in got:
        assert got[k].dtype == np.float64 and np.array_equal(got[k], ref[k])
    with pytest.raises(ValueError, match="unknown mask"):
        masks.load_mask("Q_Spiral30", ddir)
