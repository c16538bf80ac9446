#!/usr/bin/env python3
"""The CLI's ``pnp_deblur`` on the card against the CPU, with a TF32 control.

    python3 probes/cli_deblur_precision.py [cases]      (default 4)

Runs ``cli.main.main(["pnp_deblur", "--f64", "--testset", "set1", ...])``
in-process as ``chip_smoke.py``'s cli phase does (one 256 x 256 phantom,
full-width DRUNet from seeded weights, ``--iter_num 4``; ``pnp_deblur`` is
float32 whatever ``--f64`` says, as in the JAX package) three times per
case: on the card as the port runs it (cuDNN's TF32 off), on the card with
the denoiser's convolutions in TF32 (``chip_smoke._denoiser_convs_in_tf32``,
the smoke's control), and with ``--cpu``. Case ``k``
takes phantom ``(4 + k) % 15`` of ``phantom.mri_phantoms(15, 256, seed=7)``
and DRUNet weights from generator seed ``103 + k`` (case 0 is the smoke's
input). Prints, per case, the per-image PSNR distance of each card run from
the CPU run in dB.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from pnp_admm_cnc_mri_torch.cli import main as cli_main  # noqa: E402
from pnp_admm_cnc_mri_torch.data import images, phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.models import convert, drunet  # noqa: E402

N, DEPTH = 256, 4


def run(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if cli_main.main(argv) != 0:
            raise SystemExit(f"{argv} failed")
    return json.loads(buf.getvalue().strip().splitlines()[-1])["per_image_psnr"]


def main() -> None:
    cases = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    phantoms = phantom.mri_phantoms(15, N, seed=7)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(cases):
            tdir = os.path.join(tmp, f"case{k}")
            images.imsave(phantoms[(4 + k) % 15] * 255.0, os.path.join(tdir, "set1", "05.png"))
            wpath = os.path.join(tmp, f"drunet{k}.npz")
            convert.save_npz(convert.flax_init_(drunet.UNetRes(2, 1), torch.Generator().manual_seed(103 + k)), wpath)
            argv = ["pnp_deblur", "--f64", "--testset", "set1", "--testsets_dir", tdir, "--no_save", "--model",
                    "drunet_gray", "--weights", wpath, "--iter_num", str(DEPTH), "--results_dir",
                    os.path.join(tmp, "results")]
            card = run(argv)["05"]
            with chip_smoke._denoiser_convs_in_tf32():
                tf32 = run(argv)["05"]
            cpu = run([*argv, "--cpu"])["05"]
            rows.append({"case": k, "psnr_cpu": cpu, "card_vs_cpu_db": abs(card - cpu),
                         "tf32_card_vs_cpu_db": abs(tf32 - cpu)})
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"max_card_vs_cpu_db": max(r["card_vs_cpu_db"] for r in rows),
                      "min_tf32_card_vs_cpu_db": min(r["tf32_card_vs_cpu_db"] for r in rows)}))


if __name__ == "__main__":
    main()
