#!/usr/bin/env python3
"""Which torch.distributed collectives take CUDA tensors, by backend.

    python3 probes/dist_probe.py [WORLD]     (default 2; needs a CUDA card)

Runs NCCL at world size 1 in this process, then WORLD processes over a
gloo group, every rank on ``cuda:0`` (one card cannot hold two NCCL ranks),
and prints for each collective and dtype whether it ran on CUDA tensors and
gave the right answer, with the error text where it was refused. Each
collective also runs on a two-rank sub-group made with ``new_group``.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def _try(results, name, fn):
    try:
        fn()
        results[name] = "ok"
    except Exception as e:  # the probe reports every refusal and goes on
        results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        traceback.print_exc(file=sys.stderr)


def collectives(rank: int, world: int, dev, group=None) -> dict:
    """Each collective on each dtype, checked against the answer it must give."""
    res = {}
    for dt in DTYPES:
        tag = str(dt).split(".")[-1]

        def all_reduce():
            t = torch.full((5,), rank + 1, dtype=dt, device=dev)
            dist.all_reduce(t, group=group)
            assert torch.all(t == world * (world + 1) // 2), t

        def all_gather():
            out = [torch.empty(3, dtype=dt, device=dev) for _ in range(world)]
            dist.all_gather(out, torch.full((3,), rank, dtype=dt, device=dev), group=group)
            assert all(torch.all(o == r) for r, o in enumerate(out))

        def all_gather_into_tensor():
            out = torch.empty(3 * world, dtype=dt, device=dev)
            dist.all_gather_into_tensor(out, torch.full((3,), rank, dtype=dt, device=dev), group=group)
            assert torch.equal(out.cpu(), torch.arange(world).repeat_interleave(3).to(dt))

        def all_to_all_single():
            inp = (torch.arange(world * 2) + 100 * rank).to(dt).to(dev)
            out = torch.empty_like(inp)
            dist.all_to_all_single(out, inp, group=group)
            want = torch.tensor([100 * r + 2 * rank + k for r in range(world) for k in range(2)]).to(dt)
            assert torch.equal(out.cpu(), want), out

        def broadcast():
            t = torch.full((4,), rank, dtype=dt, device=dev)
            dist.broadcast(t, src=dist.get_global_rank(group, 0) if group is not None else 0, group=group)
            assert torch.all(t.real == (dist.get_global_rank(group, 0) if group is not None else 0))

        for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather),
                         ("all_gather_into_tensor", all_gather_into_tensor),
                         ("all_to_all_single", all_to_all_single), ("broadcast", broadcast)):
            _try(res, f"{name}/{tag}", fn)
    torch.cuda.synchronize()
    return res


def _gloo_child(rank: int, world: int, store: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        dev = torch.device("cuda:0")
        res = {"world": collectives(rank, world, dev)}
        sub = dist.new_group([0, 1])
        if rank < 2:
            res["sub_group_0_1"] = collectives(rank, 2, dev, group=sub)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    world = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    if not torch.cuda.is_available():
        raise SystemExit("dist_probe: needs a CUDA card")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"nccl {dist.is_nccl_available()}, gloo {dist.is_gloo_available()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="dist_probe_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_store", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120), device_id=torch.device("cuda:0"))
    try:
        nccl = {"world": collectives(0, 1, torch.device("cuda:0")),
                "new_group": collectives(0, 1, torch.device("cuda:0"), group=dist.new_group([0]))}
    finally:
        dist.destroy_process_group()
    print(json.dumps({"nccl_world1": nccl}), flush=True)
    ctx = mp.start_processes(_gloo_child, args=(world, f"{tmp}/gloo_store", tmp), nprocs=world, join=False,
                             start_method="spawn")
    while not ctx.join(timeout=300):
        pass
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            print(json.dumps({f"gloo_world{world}_rank{r}": json.load(f)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
