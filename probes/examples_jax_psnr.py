#!/usr/bin/env python3
"""The JAX package's examples on the inputs of ``chip_smoke.py``'s examples
phase: their PSNRs, unrounded, for the smoke's ``JAX_EXAMPLE_PSNR``.

    python3 probes/examples_jax_psnr.py        (on the CPU; needs jax)

Writes the phase's assets (``chip_smoke.write_example_assets``: the 256 x
256 phantom as ``set1/05.png``, the synthetic BM3D parameter database, an
empty data directory) to a temporary directory and runs ``examples/*.py`` as
their users run them, float32 (``jax_enable_x64`` off), with the JAX
package's white BM3D core on its tree filter (the port's form), the BM3D
database and the mask and noise directory pointed at those assets and an
empty model zoo. It prints one JSON object of the lines no CNN weights
reach: every line of the BM3D demos, MRI's zero-fill, ADMM-L1, ADMM-CNC and
FISTA-L1, SR's zero-fill.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import sys
import tempfile
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

NO_CNN = {"mri_reconstruction": ("zero-fill", "ADMM-L1", "ADMM-CNC", "FISTA-L1"), "super_resolution": ("zero-fill",)}
LINES = {"bm3d_grayscale": ("noisy", "denoised"), "bm3d_rgb": ("noisy", "denoised"),
         "bm3d_multichannel": ("noisy", "denoised"), "bm3d_deblurring": ("blurred+noisy", "deblurred")}


class RecordingNumpy:
    """numpy, whose ``log10`` records ``10 log10(x)``: the BM3D demos' PSNRs."""

    def __init__(self):
        self.psnrs = []

    def __getattr__(self, name):
        return getattr(np, name)

    def log10(self, x):
        v = np.log10(x)
        self.psnrs.append(10 * float(v))
        return v


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    from pnp_admm_cnc_mri_tpu.data import masks, noise
    from pnp_admm_cnc_mri_tpu.ops import metrics
    from pnp_admm_cnc_mri_tpu.priors import denoiser
    from pnp_admm_cnc_mri_tpu.priors.bm3d import core, psd_params

    tmp = tempfile.mkdtemp(prefix="examples_jax_")
    paths = chip_smoke.write_example_assets(tmp)
    core._STACK_FILTER_TREE = True
    psd_params.DEFAULT_DB = paths["db"]
    masks.DEFAULT_DATA_DIR = noise.DEFAULT_DATA_DIR = paths["data"]
    denoiser.DEFAULT_MODEL_ZOO = os.path.join(tmp, "empty_zoo")
    png = os.path.join(paths["testsets"], "set1", "05.png")
    out = {}
    for name in chip_smoke.EXAMPLES:
        mod = importlib.import_module(f"examples.{name}")
        argv = [] if name.startswith("bm3d") else ["--image", png, "--cpu"]
        if name.startswith("bm3d"):
            rec = RecordingNumpy()
            mod.np = rec
            psnrs = rec.psnrs
        else:
            psnrs, orig = [], metrics.psnr

            def spy(*a, **k):
                v = orig(*a, **k)
                psnrs.append(float(v))
                return v

            metrics.psnr = spy
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mod.main(argv)
        if not name.startswith("bm3d"):
            metrics.psnr = orig
        print(name, buf.getvalue().strip().replace("\n", " | "), file=sys.stderr, flush=True)
        keys = LINES.get(name) or NO_CNN[name]
        out[name] = dict(zip(keys, psnrs))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
