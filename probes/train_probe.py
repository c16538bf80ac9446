#!/usr/bin/env python3
"""The denoiser trainers on the card, without the rest of the smoke run.

    python3 probes/train_probe.py [determinism] [precision] [stream] [phase]      (default: all four)

- ``determinism``: full-width DRUNet (nc 64..512, nb 4) at 16 x 64^2
  patches of a synthetic buffer, two 20-step runs from one seed with
  cuDNN's deterministic algorithms off (``trainer.step_numerics`` replaced
  by one that only turns TF32 off) and two with them on, as the trainers run:
  whether each pair is bit-equal, and the step's time in each mode (CUDA
  events, the median of 5 runs of 5 steps on one batch); then the step's
  time at batch 8, 16 and 32 (deterministic);
- ``precision``: ``chip_smoke.precision_readings`` (full-width DRUNet at
  16 x 64^2, Flax init, 2 steps on one batch, float32 against float64) on
  three batches, with the trainers' step (TF32 off) and with TF32 on in
  the float32 run (``step_numerics`` replaced): the first gradient's
  largest difference relative to its largest entry and the 2 steps'
  parameter change's relative difference, the readings
  ``chip_smoke.TRAIN_GRAD_RTOL`` and ``TRAIN_STEP_RTOL`` hold;
- ``stream``: ``train_denoiser_stream`` at the smoke's DRUNet config (a
  4096-image 128^2 buffer, batch 16, 64^2 patches, EMA, megasteps of 100,
  no refresh), 200 steps timed twice in one process (the first includes
  the warm-up), then 20 steps (and the buffer's synthesis) under
  ``utils.profiling.trace``: the wall time, the device's busy time and the
  ops with the most host and device time;
- ``phase``: ``chip_smoke.phase_train`` on 4 phantom PNGs written to a
  temporary directory (the smoke writes them in its experiments phase).

Prints the card's name and power limit and one JSON line per part.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from pnp_admm_cnc_mri_torch.models.drunet import UNetRes  # noqa: E402
from pnp_admm_cnc_mri_torch.train import synth, trainer  # noqa: E402


@contextlib.contextmanager
def numerics(tf32: bool, deterministic: bool):
    """``trainer.step_numerics`` replaced, for the block, by one setting
    cuDNN's TF32 and deterministic switches as given."""

    @contextlib.contextmanager
    def step_numerics():
        cudnn = torch.backends.cudnn
        prev = cudnn.allow_tf32, cudnn.deterministic
        cudnn.allow_tf32, cudnn.deterministic = tf32, deterministic
        try:
            yield
        finally:
            cudnn.allow_tf32, cudnn.deterministic = prev

    saved, trainer.step_numerics = trainer.step_numerics, step_numerics
    try:
        yield
    finally:
        trainer.step_numerics = saved


def determinism(dev) -> dict:
    gen = synth.make_generator(size=128)
    out = {}
    for det in (False, True):
        states = []
        # the trainers' step, or one with TF32 off and cuDNN's default algorithms
        mode = (lambda: contextlib.nullcontext()) if det else (lambda: numerics(False, False))  # noqa: E731
        for _ in range(2):
            # 20 steps from one seed: Flax init, batches drawn on the card from a seeded buffer
            g = torch.Generator(dev).manual_seed(4)
            buf = gen(g, 64)
            model = trainer.prepare_model(UNetRes(2, 1), None, 0, torch.float32, dev)
            cfg = trainer.TrainConfig(learning_rate=1e-4, lr_decay="cosine")
            step = trainer.make_train_step(trainer.make_loss_fn(model, "l2", True),
                                           trainer.make_optimizer(cfg, model.parameters(), 20))
            with mode():
                for _ in range(20):
                    idx = torch.randint(0, 64, (16,), generator=g, device=dev)
                    clean = buf[idx, None, :64, :64]
                    sig = (50 / 255) * torch.rand((16, 1, 1, 1), generator=g, device=dev)
                    step(clean + sig * torch.randn(clean.shape, generator=g, device=dev), clean, sig)
            states.append(trainer.state_of(model))
        out[f"deterministic_{det}_repeat_max_diff"] = chip_smoke._max_diff(*states)
        batches = (8, 16, 32) if det else (16,)
        for b in batches:
            clean = torch.rand((b, 1, 64, 64), device=dev)
            sig = torch.full((b, 1, 1, 1), 25 / 255, device=dev)
            noisy = clean + sig * torch.randn_like(clean)
            with mode():
                out[f"deterministic_{det}_batch{b}_step_ms"] = chip_smoke.cuda_ms(lambda: step(noisy, clean, sig),
                                                                                  reps=5, inner=5)
    return out


def precision(dev) -> dict:
    out = {}
    for seed in (0, 1, 2):
        g = torch.Generator().manual_seed(seed)
        clean = torch.rand((16, 1, 64, 64), generator=g).to(dev)
        sig = torch.full((16, 1, 1, 1), 25 / 255, device=dev)
        noisy = clean + sig * torch.randn(clean.shape, generator=g).to(dev)
        # TF32 touches float32 convolutions only: the float64 run is the same in both
        for name, mode in (("f32", contextlib.nullcontext()), ("f32_tf32", numerics(True, True))):
            with mode:
                step_rel, grad_rel = chip_smoke.precision_readings(dev, noisy, clean, sig)
            out.setdefault(f"{name}_step_rel", []).append(step_rel)
            out.setdefault(f"{name}_grad_rel", []).append(grad_rel)
    return out


def stream(dev) -> dict:
    import time

    from pnp_admm_cnc_mri_torch.utils import profiling

    gen = synth.make_generator(size=128)
    cfg = trainer.TrainConfig(learning_rate=1e-4, lr_decay="cosine")
    out = {}

    def run(steps, scan):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_denoiser_stream(UNetRes(2, 1), gen, (0.0, 50 / 255), steps=steps, batch_size=16, patch=64,
                                      cfg=cfg, buffer_images=4096, conditioned=True, ema_decay=0.999,
                                      scan_steps=scan, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    out["run_s"] = [run(200, 100), run(200, 100)]
    tmp = tempfile.mkdtemp(prefix="train_probe_trace_")
    try:
        with profiling.trace(tmp) as prof:
            traced_s = run(20, 10)
        ka = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in ka)
        wall_us = max(e.cpu_time_total for e in ka)
        out["trace"] = {
            "wall_ms": traced_s * 1e3, "device_self_ms": dev_us / 1e3, "longest_host_op_ms": wall_us / 1e3,
            "top_host": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                         for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]],
            "top_device": [(e.key, e.count, e.self_device_time_total / 1e3)
                           for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:8]]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase(dev) -> dict:
    from pnp_admm_cnc_mri_torch.data import images, phantom

    tmp = tempfile.mkdtemp(prefix="train_probe_")
    try:
        tdir = os.path.join(tmp, "testsets")
        for k, im in enumerate(phantom.mri_phantoms(4, 256, seed=0)):
            images.imsave(im * 255.0, os.path.join(tdir, "phantoms4", f"{k:03d}.png"))
        return chip_smoke.phase_train(dev, tmp, tdir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("train_probe: needs a CUDA card")
    parts = sys.argv[1:] or ["determinism", "precision", "stream", "phase"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for part in parts:
        print(json.dumps({part: {"determinism": determinism, "precision": precision, "stream": stream, "phase": phase}[part](dev)}), flush=True)


if __name__ == "__main__":
    main()
