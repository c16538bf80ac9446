#!/usr/bin/env python3
"""BM3D in float32 against float64, over a few noise draws.

    python3 probes/bm3d_precision.py [cpu|cuda]     (default: cuda)

One call of the port's BM3D (profile 'np', both stages, sigma sqrt(0.03), no
prefilter) on phantoms seed 0 plus white noise, in float32 and in float64,
for the noise draw of ``chip_smoke.py``'s bm3d phase (numpy seed 5, 4 x
256 x 256) and three more: numpy seeds 6 and 7 (2 x 256 x 256 each) and
torch's generator seeded 0 on the device the probe runs on (4 x 256 x 256,
float32; the CPU's and the card's generators draw different noise).
Prints the max and mean absolute difference of the outputs, and the share
of groups whose used matches (positions within the group size, or the
size) differ, per stage: the Wiener stage matches on the HT output of its
own dtype. On the CPU the images go one at a time (a call's fields grow
with its images).
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pnp_admm_cnc_mri_torch.data import phantom  # noqa: E402
from pnp_admm_cnc_mri_torch.priors.bm3d import core  # noqa: E402

SIGMA = math.sqrt(0.03)
N = 256


def draws(dev):
    """(name, float32 images on dev) of each noise draw."""
    img = phantom.mri_phantoms(4, N, seed=0)

    def numpy_draw(n, seed):
        z = img[:n] + SIGMA * np.random.default_rng(seed).standard_normal((n, N, N))
        return torch.from_numpy(z.astype(np.float32)).to(dev)

    yield "numpy seed 5", numpy_draw(4, 5)
    for seed in (6, 7):
        yield f"numpy seed {seed}", numpy_draw(2, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    yield f"torch seed 0 on {dev.type}", torch.from_numpy(img).to(dev) + SIGMA * torch.randn(
        img.shape, generator=gen, device=dev)


def compare(z32: torch.Tensor, dev):
    """(max, mean, {stage: share}) of one image stack in float32 against float64."""
    p = core.DEFAULT_PROFILE
    ref, offs = core._ref_grid(N - 7, 3), core._offsets(39, 8)
    z64 = z32.double()
    o32 = core.bm3d(z32, SIGMA, prefilter=False, device=dev)
    o64 = core.bm3d(z64, SIGMA, prefilter=False, device=dev)
    d = (o32.double() - o64).abs()
    share = {}
    for stage, a32, a64, k, tau in (
            ("ht", z32, z64, p.max_3d_ht, p.tau_match_ht),
            ("wiener", core.ht_stage(z32, SIGMA, prefilter=False), core.ht_stage(z64, SIGMA, prefilter=False),
             p.max_3d_wie, p.tau_match_wie)):
        tau = tau * p.tau_scale * 64 / 255.0**2
        (p32, c32), (p64, c64) = core._match(a32, ref, offs, 8, k, tau), core._match(a64, ref, offs, 8, k, tau)
        used = torch.arange(k, device=p32.device) < torch.minimum(c32, c64)[..., None]
        share[stage] = (((p32 != p64).any(-1) & used).any(-1) | (c32 != c64)).double().mean(-1)
    return d.amax(dim=(-2, -1)), d.mean(dim=(-2, -1)), share


def main():
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    if dev.type == "cpu":
        torch.set_num_threads(min(8, os.cpu_count() or 1))
    for name, z32 in draws(dev):
        parts = [compare(z32[i:i + 1], dev) for i in range(len(z32))] if dev.type == "cpu" else [compare(z32, dev)]
        mx = torch.cat([a.reshape(-1) for a, _, _ in parts])
        mean = torch.cat([b.reshape(-1) for _, b, _ in parts])
        share = {s: float(torch.cat([c[s].reshape(-1) for _, _, c in parts]).mean()) for s in ("ht", "wiener")}
        print(f"{name} ({len(z32)} x {N} x {N}, {dev.type}): max {float(mx.max()):.3g} mean {float(mean.mean()):.3g}; "
              f"groups with other used matches: HT {share['ht']:.4%}, Wiener {share['wiener']:.4%}", flush=True)


if __name__ == "__main__":
    main()
