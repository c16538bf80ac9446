"""Fold-exclusion evaluation (the k-fold leakage-free composite).

Port of the JAX package's ``cli/eval_folds.py``. Protocol: each of the 15
test images is scored by the fold model that excluded it from training, so
every reported PSNR is leakage-free by construction. The fold -> (weights,
held-out images) map lives in a manifest (``model_zoo/folds.json``), so the
composition rule is pinned data.

Hyper-parameter selection (``--select_nlm``): for each fold, every candidate
nlm is evaluated on the full set, the winner is chosen by the average over
that fold's held-in images only (the 12 images the model trained on, its
validation set), and the held-out images are then scored at the winning nlm.
No held-out image influences a hyper-parameter that scores it. Every JSONL
row holds the exact CLI argv that produced it (reference
``【1】ADMM_L1.py:171-194``: one command, one recorded result).

    python -m pnp_admm_cnc_mri_torch.cli.eval_folds \
        --algo consensus_fista_d --select_nlm 11,12,13,14 \
        --out results/r5_fold_consensus_val.jsonl

One departure from the JAX module: ``--device`` defaults to the CUDA card
(``cuda``), as every entry point of the port does, and ``--device cpu``
inserts ``--cpu`` into each CLI argv, as the JAX module's ``cpu`` (its
default) does. The CLI runs write their logs under the temporary directory.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import tempfile

DEFAULT_MANIFEST = "model_zoo/folds.json"

ALL_IMAGES = tuple(f"{k:02d}" for k in range(1, 16))


def load_manifest(path: str) -> dict:
    """-> {"model": ..., "folds": {fold: {"weights", "held_out"}}}.

    Checks that the held-out sets partition the 15-image testset, the
    property the whole protocol rests on."""
    with open(path) as f:
        m = json.load(f)
    ids = sorted(i for spec in m["folds"].values() for i in spec["held_out"])
    if ids != sorted(ALL_IMAGES):
        raise ValueError(f"manifest {path}: held_out sets must partition {sorted(ALL_IMAGES)}, got {ids}")
    return m


def _run_cli(argv_cli: list[str]) -> dict:
    """Run one CLI evaluation in-process; its result JSON (the last stdout line)."""
    from pnp_admm_cnc_mri_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main.main(argv_cli)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pnp_admm_cnc_mri_torch.cli.eval_folds")
    p.add_argument("--manifest", default=DEFAULT_MANIFEST, help="fold -> (weights, held_out) JSON manifest")
    p.add_argument("--algo", default="pnp_fista_d")
    p.add_argument("--model", default=None, help="denoiser model name (default: manifest's)")
    p.add_argument("--out", default="results/fold_eval.jsonl")
    p.add_argument("--mask", default=None, help="single-mask algos: evaluate under this mask (default Q_Random30)")
    p.add_argument("--select_nlm", default=None,
                   help="comma-separated nlm candidates; per fold, pick by held-IN average (validation), score "
                        "held-out at the winner. Omit for the registry default.")
    p.add_argument("--extra", default="", help="extra CLI args, space-separated")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the card, the default) or cpu (adds --cpu to each CLI run)")
    args = p.parse_args(argv)

    from pnp_admm_cnc_mri_torch.utils import logger as logger_mod

    manifest = load_manifest(args.manifest)
    model = args.model or manifest.get("model", "drunet_gray")
    candidates = [float(v) for v in args.select_nlm.split(",")] if args.select_nlm else [None]
    results_dir = os.path.join(tempfile.gettempdir(), "eval_folds_results")

    composite: dict[str, float] = {}
    selections: dict[str, float | None] = {}
    for fold, spec in manifest["folds"].items():
        held = tuple(spec["held_out"])
        wpath = spec["weights"]
        if not os.path.exists(wpath):
            print(f"MISSING {wpath} — skipping", flush=True)
            continue
        held_in = [i for i in ALL_IMAGES if i not in held]

        best = None  # (held_in_avg, nlm, per_image, argv)
        for nlm in candidates:
            argv_cli = [args.algo, "--model", model, "--tuned", "--testset", "set", "--no_save", "--results_dir",
                        results_dir, "--weights", wpath]
            if args.device == "cpu":
                argv_cli.insert(1, "--cpu")
            if args.mask:
                argv_cli += ["--mask", args.mask]
            if nlm is not None:
                argv_cli += ["--nlm", repr(nlm)]
            if args.extra:
                argv_cli += args.extra.split()
            res = _run_cli(argv_cli)
            pim = res["per_image_psnr"]
            val = sum(pim[i] for i in held_in) / len(held_in)
            row = {"fold": fold, "weights": wpath, "nlm": nlm, "held_in_avg": round(val, 4), "argv": argv_cli, **res}
            logger_mod.append_record(args.out, row)
            if best is None or val > best[0]:
                best = (val, nlm, pim, argv_cli)

        _, nlm_sel, pim, _ = best
        selections[fold] = nlm_sel
        held_vals = {k: pim[k] for k in held}
        composite.update(held_vals)
        if nlm_sel is not None and len(candidates) > 1 and nlm_sel in (min(candidates), max(candidates)):
            # a grid-edge winner: the validation optimum may lie outside the
            # candidates; the composite is still clean, but extend the grid
            print(json.dumps({"fold": fold, "warning": f"selected nlm {nlm_sel} is a grid edge — extend --select_nlm"}),
                  flush=True)
        print(json.dumps({"fold": fold, "selected_nlm": nlm_sel,
                          "held_out": {k: round(v, 3) for k, v in held_vals.items()}}), flush=True)

    if len(composite) == len(ALL_IMAGES):
        avg = sum(composite.values()) / len(ALL_IMAGES)
        protocol = ("each image scored by the fold model excluding it; "
                    + ("nlm validation-selected per fold on held-in images" if args.select_nlm
                       else "registry-default hyper-parameters"))
        summary = {
            "composite_fold_exclusion_psnr": round(avg, 3),
            "set1_fold_excluded": round(composite["05"], 3),
            "per_image": {k: round(v, 3) for k, v in sorted(composite.items())},
            "selected_nlm": selections,
            "algo": args.algo,
            "protocol": protocol,
        }
        logger_mod.append_record(args.out, summary)
        print(json.dumps(summary))
    else:
        print(f"composite incomplete: {sorted(composite)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
