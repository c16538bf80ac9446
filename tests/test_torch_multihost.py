"""The port's multi-process sweep (``cli/multihost.py``) on the CPU.

``--launch_local 2 --cpu`` spawns two processes of the module that join a
gloo group at a free local port and solve their slices of the scenario
list (2 a process) on a synthetic ``set1`` of three 32 x 32 scenes, the
masks and ``noises.mat`` (``test_torch_experiments.write_assets``, found
through ``PNPADMM_TESTSETS`` / ``PNPADMM_DATA``). Process 0 alone prints
the summary, and its mean and largest relative residual equal the JAX
package's ``admm_l1`` with residuals on the same four scenarios, computed
here, float32 in both, within 1e-4 relative. One iteration: its residuals
(2.9e-3 for these scenes) are far above float32 rounding, where from the
second iteration on they are that rounding (1e-9), which differs between
the two FFTs.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pnp_admm_cnc_mri_tpu.config import ADMM_L1_DEFAULT
from pnp_admm_cnc_mri_tpu.data import images as jimages
from pnp_admm_cnc_mri_tpu.data import masks as jmasks
from pnp_admm_cnc_mri_tpu.data import noise as jnoise
from pnp_admm_cnc_mri_tpu.solvers import admm as jadmm
from pnp_admm_cnc_mri_torch.cli import multihost

from test_torch_experiments import write_assets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, PER_PROCESS = 1, 2
REL = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launch_local_2_cpu_matches_jax(tmp_path, monkeypatch):
    tdir, ddir = write_assets(str(tmp_path))
    env = dict(os.environ, PNPADMM_TESTSETS=tdir, PNPADMM_DATA=ddir, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "pnp_admm_cnc_mri_torch.cli.multihost", "--launch_local", "2", "--cpu",
         "--coordinator", f"localhost:{_free_port()}", "--iter_num", str(ITERS),
         "--scenarios_per_device", str(PER_PROCESS)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout
    s = json.loads(lines[0])
    assert s["processes"] == s["global_devices"] == 2 and s["scenarios"] == 4 and s["iters"] == ITERS
    assert s["wall_s"] > 0 and s["scenario_iters_per_s"] > 0
    # the JAX package's solve of the same global list: process p holds images (2p, 2p + 1) mod 3
    monkeypatch.setattr(jmasks, "DEFAULT_DATA_DIR", ddir)
    monkeypatch.setattr(jnoise, "DEFAULT_DATA_DIR", ddir)
    imgs01, _, _ = jimages.load_testset(os.path.join(tdir, "set1"))
    mask = jmasks.load_mask("Q_Random30")
    idx = np.arange(2 * PER_PROCESS) % imgs01.shape[0]
    y = (np.fft.fft2(imgs01[idx], axes=(-2, -1)) * mask + jnoise.load_noise()).astype(np.complex64)
    cfg = type(ADMM_L1_DEFAULT)(**{**ADMM_L1_DEFAULT.__dict__, "iter_num": ITERS})
    final, res = jadmm.admm_l1(jnp.asarray(y), jnp.asarray(mask.astype(np.float32)), cfg, dtype=jnp.float32,
                               collect_residuals=True)
    rel = np.asarray(res[-1]) / (np.sqrt(np.sum(np.asarray(final.x) ** 2, axis=(-2, -1))) + 1e-12)
    np.testing.assert_allclose(s["mean_rel_residual"], float(np.mean(rel)), rtol=REL)
    np.testing.assert_allclose(s["max_rel_residual"], float(np.max(rel)), rtol=REL)


def test_without_cpu_it_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        multihost.main(["--coordinator", f"localhost:{_free_port()}"])
    assert not torch.distributed.is_initialized()
