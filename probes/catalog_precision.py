"""Float32 against float64 of the port's U-Net catalog at full width.

    python3 probes/catalog_precision.py [cpu|cuda] [SIZE] [BATCH] [SEEDS]

Builds each variant of ``models/unet_variants.py`` at ``nc = (64, 128, 256,
512)`` and its default ``nb``, with weights from ``convert.flax_init_`` (a
CPU ``torch.Generator`` seeded 0, 1, ...), runs the same phantoms (``BATCH``
x ``SIZE`` x ``SIZE``; ResUNet also at ``SIZE - 4``) in float32, with
cuDNN's TF32 off, and in float64, and prints for each the largest absolute
difference and that over the largest output, as one JSON line.
``chip_smoke.py``'s catalog phase takes its limits from these readings on
the CPU (its default: cpu 64 1 3).
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pnp_admm_cnc_mri_torch.data import phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.models import convert, unet_variants as uv  # noqa: E402

VARIANTS = {"UNet": uv.UNet, "ResUNet": uv.ResUNet, "UNetResSubP": uv.UNetResSubP, "UNetPlus": uv.UNetPlus,
            "NonLocalUNet": uv.NonLocalUNet}


def gaps(device, size, batch, seed):
    out = {}
    for name, cls in VARIANTS.items():
        model = convert.flax_init_(cls(), torch.Generator().manual_seed(seed))
        for s in ((size, size - 4) if name == "ResUNet" else (size,)):
            x = torch.from_numpy(phantom.mri_phantoms(batch, size, seed=seed)[:, None, :s, :s])
            with torch.no_grad():
                prev = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                try:
                    y32 = model.float().to(device)(x.float().to(device)).double().cpu()
                    y64 = model.double().to(device)(x.double().to(device)).cpu()
                finally:
                    torch.backends.cudnn.allow_tf32 = prev
            d = float((y32 - y64).abs().max())
            out[f"{name}@{s}"] = {"max_abs": d, "rel": d / float(y64.abs().max())}
    return out


def main(argv):
    device = argv[0] if argv else "cpu"
    size, batch, seeds = (int(a) for a in (argv[1:4] + ["64", "1", "3"][len(argv[1:4]):]))
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    res = {str(s): gaps(device, size, batch, s) for s in range(seeds)}
    worst = {k: max(r[k]["max_abs"] for r in res.values()) for k in res["0"]}
    print(json.dumps({"device": device, "size": size, "batch": batch, "per_seed": res, "worst_max_abs": worst}))


if __name__ == "__main__":
    main(sys.argv[1:])
