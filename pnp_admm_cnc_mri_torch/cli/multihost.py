"""Multi-process scenario sweep: torch.distributed over N processes.

Port of the JAX package's ``cli/multihost.py``. JAX runs one process per
host, owning that host's devices; torch.distributed runs one process per
device: ``cuda:(process_id % device_count)``, or the CPU with ``--cpu``
(gloo). So ``global_devices`` is the number of processes. Each process
solves its slice of the scenario list with ``admm_l1`` on its device, the
mean and largest final relative residual and the mean of x are reduced
across the processes, and process 0 reports.

One invocation per device (a host with several cards runs several):

    python -m pnp_admm_cnc_mri_torch.cli.multihost \\
        --coordinator host0:12345 --num_processes N --process_id $ID

Local testing (this spawns N processes itself):

    python -m pnp_admm_cnc_mri_torch.cli.multihost --launch_local 2 --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def worker(args) -> int:
    """One process of the sweep: joins the group at ``--coordinator`` (or
    takes the group already initialized in this process), solves its
    scenarios and, on process 0, prints the summary."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pnp_admm_cnc_mri_torch.config import ADMM_L1_DEFAULT
    from pnp_admm_cnc_mri_torch.data import images, masks as masks_mod, noise as noise_mod
    from pnp_admm_cnc_mri_torch.parallel import mesh as mesh_lib
    from pnp_admm_cnc_mri_torch.parallel.reductions import global_mean
    from pnp_admm_cnc_mri_torch.solvers import admm

    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to run on the CPU")
    else:
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
    owned = not dist.is_initialized()
    if owned:
        mesh_lib.init_process_group(device, f"tcp://{args.coordinator}", args.process_id, args.num_processes)
    try:
        mesh = mesh_lib.make_mesh(device=device)
        n_global = mesh.shape["data"]
        imgs01, _, _ = images.load_testset(os.path.join(images.DEFAULT_TESTSETS, args.testset))
        mask = masks_mod.load_mask("Q_Random30")
        kn = noise_mod.load_noise()
        # this process's slice of the scenario list (one device a process)
        local_n = max(1, args.scenarios_per_device)
        idx = (np.arange(local_n) + mesh.coords["data"] * local_n) % imgs01.shape[0]
        local_y = (np.fft.fft2(imgs01[idx], axes=(-2, -1)) * mask + kn).astype(np.complex64)
        y = torch.as_tensor(local_y, device=device)
        m = torch.as_tensor(mask.astype(np.float32), device=device)
        cfg = type(ADMM_L1_DEFAULT)(**{**ADMM_L1_DEFAULT.__dict__, "iter_num": args.iter_num})

        def solve():
            final, res = admm.admm_l1(y, m, cfg, dtype=torch.float32, collect_residuals=True, device=device)
            rel = res[-1] / (torch.sqrt(torch.sum(final.x**2, dim=(-2, -1))) + 1e-12)
            rel = mesh_lib.gather_batch(rel, mesh)  # across the processes
            return torch.mean(rel), torch.max(rel), global_mean(torch.mean(final.x), mesh)

        float(solve()[0])  # warm-up (and the kernels' build)
        t0 = time.perf_counter()
        mean_rel, max_rel, _mean_x = solve()
        mean_rel = float(mean_rel)  # waits for every process's solve
        dt = time.perf_counter() - t0
        total = n_global * local_n
        if mesh.coords["data"] == 0:
            print(json.dumps({
                "processes": n_global,
                "global_devices": n_global,
                "scenarios": int(total),
                "iters": cfg.iter_num,
                "wall_s": round(dt, 3),
                "scenario_iters_per_s": round(total * cfg.iter_num / dt, 1),
                "mean_rel_residual": mean_rel,
                "max_rel_residual": float(max_rel),
            }), flush=True)
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default="localhost:12377")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--launch_local", type=int, default=0, help="spawn N local worker processes (testing)")
    p.add_argument("--testset", default="set1")
    p.add_argument("--iter_num", type=int, default=20)
    p.add_argument("--scenarios_per_device", type=int, default=2)
    p.add_argument("--cpu", action="store_true", help="run on the CPU over gloo (default: one CUDA card a process)")
    return p


def launch_local(args, timeout_s: float) -> int:
    """Spawn ``--launch_local`` worker processes of this module and wait for
    them, all within ``timeout_s`` (past it every worker is killed); returns
    the OR of their exit codes."""
    n = args.launch_local
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    procs = []
    for i in range(n):
        cmd = [sys.executable, "-m", "pnp_admm_cnc_mri_torch.cli.multihost",
               "--coordinator", args.coordinator, "--num_processes", str(n), "--process_id", str(i),
               "--testset", args.testset, "--iter_num", str(args.iter_num),
               "--scenarios_per_device", str(args.scenarios_per_device)] + (["--cpu"] if args.cpu else [])
        procs.append(subprocess.Popen(cmd, env=env))
    deadline = time.monotonic() + timeout_s
    rc = 0
    try:
        for pr in procs:
            rc |= pr.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        print(f"multihost: workers not done in {timeout_s} s; killed", file=sys.stderr)
        rc |= 1
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return rc


def main(argv=None) -> int:
    from pnp_admm_cnc_mri_torch.parallel.mesh import DEFAULT_TIMEOUT_S

    args = _parser().parse_args(argv)
    if args.launch_local:
        return launch_local(args, DEFAULT_TIMEOUT_S)
    return worker(args)


if __name__ == "__main__":
    raise SystemExit(main())
