"""The port's six examples (``pnp_admm_cnc_mri_torch/examples/``) against
the JAX package's (``examples/``), on the CPU.

Each case runs the JAX example's ``main(argv)`` and the port's
``main(argv + ["--cpu"])`` on the same arguments, at small sizes (32 x 32,
3 iterations), and compares the printed lines and the PSNRs. The JAX
examples run as their users run them, in float32: ``jax_enable_x64``, which
``tests/conftest.py`` turns on, is off around each JAX run, and the JAX
package's white BM3D core takes its tree filter (``core._STACK_FILTER_TREE``),
the port's form, as in ``test_torch_bm3d_api.py``. The PSNRs are compared
unrounded: the port's ``main`` returns them; the JAX example's are read
where it computes them (the ``np.log10`` of the BM3D demos' own ``psnr``,
``metrics.psnr`` in the MRI and SR examples).

The colored defaults (``bm3d_grayscale``'s g3, ``bm3d_deblurring``'s
colored residual) need the reference's ``param_matching_data.mat``, which
is not in the repository: they run against the synthetic database of
``test_torch_bm3d_api.py``, and without one both packages raise naming
the file. The MRI and SR examples read a PNG written to ``tmp_path`` and
the zoo's weights; the MRI example's mask and noise directory is an empty
``tmp_path``, so both draw the random mask and synthetic noise.

Tolerances, per printed PSNR: lines computed on the host in float64 from
the same inputs (the noisy and blurred inputs' PSNRs) 1e-6 dB; the float32
lines, the image tolerance (max abs on [0, 1]) of the module that holds
the same path, as a PSNR bound: an image within ``atol`` of another has a
PSNR within ``-20 log10(1 - atol / rmse)`` dB. BM3D white and colored 2e-5
(``test_torch_bm3d_api.py``, ``test_torch_bm3d_colored_f32.py``), the MRI
solvers and CNN priors 1e-4 (``test_torch_fista.py``, ``test_torch_pnp.py``),
SR with trained DRUNet 1.25e-4 (``test_torch_restoration.py``). Measured
gaps: at most 3.0e-5 dB (SR's PnP line; the others 7.9e-6 or less, the
host lines 0).
"""

import contextlib
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio
import torch

import jax

from pnp_admm_cnc_mri_tpu.data import masks as jmasks
from pnp_admm_cnc_mri_tpu.data import noise as jnoise
from pnp_admm_cnc_mri_tpu.ops import metrics as jmetrics
from pnp_admm_cnc_mri_tpu.priors.bm3d import core as jcore
from pnp_admm_cnc_mri_tpu.priors.bm3d import psd_params as jpsd
from pnp_admm_cnc_mri_torch.data import images, masks, noise
from pnp_admm_cnc_mri_torch.priors.bm3d import psd_params

HOST_TOL_DB = 1e-6
BM3D_ATOL = 2e-5
MRI_ATOL = 1e-4
SR_ATOL = 1.25e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("bm3d_grayscale", "bm3d_rgb", "bm3d_multichannel", "bm3d_deblurring", "mri_reconstruction",
         "super_resolution")


@pytest.fixture(scope="module", autouse=True)
def setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    jax.clear_caches()
    jcore._STACK_FILTER_TREE = True
    yield
    jcore._STACK_FILTER_TREE = None
    jax.clear_caches()
    torch.set_num_threads(prev)


@contextlib.contextmanager
def float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def set_db(monkeypatch, path):
    monkeypatch.setattr(jpsd, "DEFAULT_DB", str(path))
    monkeypatch.setattr(psd_params, "DEFAULT_DB", str(path))


@pytest.fixture
def param_db(tmp_path, monkeypatch):
    """``test_torch_bm3d_api.py``'s synthetic parameter database, read by both packages."""
    rng = np.random.default_rng(3)
    path = tmp_path / "param_matching_data.mat"
    sio.savemat(path, {"features": rng.random((20, 60)) * 10.0,
                       "maxes": rng.integers(1, 22, size=(60, 4)).astype(np.float64)})
    set_db(monkeypatch, path)


@pytest.fixture
def png(tmp_path):
    yy, xx = np.mgrid[:32, :32]
    path = tmp_path / "img.png"
    images.imsave((120 + 80 * np.sin(yy / 5.0) * np.cos(xx / 7.0)).astype(np.uint8), str(path))
    return str(path)


class _RecordingNumpy:
    """numpy, whose ``log10`` also records ``10 log10(x)``: the PSNRs of the
    BM3D demos' own ``psnr`` closures, unrounded."""

    def __init__(self):
        self.psnrs = []

    def __getattr__(self, name):
        return getattr(np, name)

    def log10(self, x):
        v = np.log10(x)
        self.psnrs.append(10 * float(v))
        return v


def run_jax(name, argv, monkeypatch):
    """The JAX example's printed PSNRs, unrounded, in the order printed."""
    mod = importlib.import_module(f"examples.{name}")
    if name.startswith("bm3d"):
        rec = _RecordingNumpy()
        monkeypatch.setattr(mod, "np", rec)
        psnrs = rec.psnrs
    else:
        psnrs, orig = [], jmetrics.psnr

        def psnr(*a, **k):
            v = orig(*a, **k)
            psnrs.append(float(v))
            return v

        monkeypatch.setattr(jmetrics, "psnr", psnr)
    with float32_jax():
        mod.main(argv)
    return psnrs


def port_main(name):
    return importlib.import_module(f"pnp_admm_cnc_mri_torch.examples.{name}").main


def psnr_tol(psnr_db, atol, peak=1.0):
    """The PSNR bound of an image gap of ``atol`` (max abs) at this PSNR."""
    return -20.0 * np.log10(1.0 - atol / (peak * 10.0 ** (-psnr_db / 20.0)))


def label(line):
    return re.sub(r"-?\d+\.\d+", "#", line)


def numbers(text):
    return [float(v) for v in re.findall(r"(-?\d+\.\d+) dB", text)]


# (name, argv, fixtures, per-line tolerances: HOST or an image atol)
HOST = "host"
CASES = [
    ("bm3d_grayscale", ["--noise", "gw", "--size", "32"], (), [HOST, BM3D_ATOL]),
    ("bm3d_grayscale", ["--size", "32"], ("param_db",), [HOST, BM3D_ATOL]),
    ("bm3d_rgb", ["--size", "32"], (), [HOST, BM3D_ATOL]),
    ("bm3d_multichannel", ["--size", "32"], (), [HOST, BM3D_ATOL]),
    ("bm3d_deblurring", ["--size", "32"], ("param_db",), [HOST, BM3D_ATOL]),
    ("mri_reconstruction", ["--iters", "3", "--model", "dncnn_25"], ("png",), [MRI_ATOL] * 6),
    ("mri_reconstruction", ["--iters", "3"], ("png",), [MRI_ATOL] * 6),
    ("super_resolution", ["--iters", "3"], ("png",), [MRI_ATOL, SR_ATOL]),
]


@pytest.mark.parametrize("name,argv,fixtures,tols", CASES,
                         ids=[f"{c[0]}-{'-'.join(c[1]).replace('--', '')}" for c in CASES])
def test_example_matches_jax(name, argv, fixtures, tols, request, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for f in fixtures:
        value = request.getfixturevalue(f)
        if f == "png":
            argv = ["--image", value] + argv
    if name == "mri_reconstruction":  # no reference mask or noise file: both draw their own
        for mod in (jmasks, jnoise, masks, noise):
            monkeypatch.setattr(mod, "DEFAULT_DATA_DIR", str(tmp_path))

    want = run_jax(name, argv, monkeypatch)
    jax_out = capsys.readouterr().out
    got = port_main(name)(argv + ["--cpu"])
    port_out = capsys.readouterr().out

    assert [label(s) for s in port_out.splitlines()] == [label(s) for s in jax_out.splitlines()]
    assert len(got) == len(want) == len(tols) == len(numbers(port_out))
    peak = 1.0
    if name == "bm3d_multichannel":  # its PSNR peak is the channels' range
        peak = float(np.ptp(importlib.import_module("pnp_admm_cnc_mri_torch.examples.bm3d_multichannel")
                            .load_channels(32)))
    for (line, g), w, p, j, tol in zip(got.items(), want, numbers(port_out), numbers(jax_out), tols):
        limit = HOST_TOL_DB if tol == HOST else psnr_tol(w, tol, peak)
        assert np.isfinite(g) and abs(g - w) <= limit, (line, g, w, limit)
        assert p == pytest.approx(g, abs=0.005) and abs(p - j) <= 0.011, (line, p, j)


@pytest.mark.parametrize("name", ["bm3d_grayscale", "bm3d_deblurring"])
def test_colored_default_without_the_database_raises(name, tmp_path, monkeypatch):
    set_db(monkeypatch, tmp_path / "absent.mat")
    with pytest.raises(FileNotFoundError, match="param_matching_data.mat"):
        port_main(name)(["--size", "32", "--cpu"])
    with pytest.raises(FileNotFoundError, match="param_matching_data.mat"), float32_jax():
        importlib.import_module(f"examples.{name}").main(["--size", "32"])


@pytest.mark.parametrize("name", NAMES)
def test_example_without_a_card_raises(name, monkeypatch):
    """Without ``--cpu`` an example runs on the card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(name)(["--size", "32"] if name.startswith("bm3d") else ["--iters", "1"])


def test_float64_run_is_float32_within_the_float32_gap():
    f32 = port_main("bm3d_rgb")(["--size", "32", "--cpu"])
    f64 = port_main("bm3d_rgb")(["--size", "32", "--cpu", "--f64"])
    assert f64["noisy"] == f32["noisy"]
    assert 0 < abs(f64["denoised"] - f32["denoised"]) <= psnr_tol(f64["denoised"], BM3D_ATOL)


def test_module_entry_point_runs(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "pnp_admm_cnc_mri_torch.examples.bm3d_multichannel", "--size", "16", "--cpu"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr
    assert [label(s) for s in res.stdout.splitlines()] == ["channels: 3", "noisy PSNR:    # dB",
                                                          "denoised PSNR: # dB"]
