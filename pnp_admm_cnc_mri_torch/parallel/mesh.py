"""A (data, space) mesh of torch.distributed ranks, its collectives, and launchers.

Port of the JAX package's ``parallel/mesh.py``. JAX runs one process per
host and shards arrays over every device it sees; torch.distributed runs one
process per device. So the mesh here is a grid of the ranks of the default
process group, rank ``r`` at ``(r // n_space, r % n_space)``:

  - ``data``: the scenario batch (images, masks, noise levels; the
    trainer's batch), one slice a row;
  - ``space``: one image's H axis (``parallel/spatial.py``), or the
    trainer's conv channels.

Each rank holds one sub-group for its row (the ``space`` group) and one for
its column (the ``data`` group). Where JAX's ``shard_map`` inserts
collectives, the port calls them itself through ``all_reduce``,
``all_gather`` and ``all_to_all`` below. Without an initialized process
group the mesh is 1 x 1 and those are the identity.

NCCL takes one rank per card. Several ranks on one card (the tests on the
CPU, the multi-rank checks on a one-card machine) run over a gloo group.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the mesh: ``shape`` (``{"data": n_data, "space":
    n_space}``), its ``coords`` on each axis, its ``device``, and the
    process group of each axis (None on the 1 x 1 mesh of an undistributed
    process)."""

    shape: dict
    coords: dict
    device: torch.device
    groups: dict

    @property
    def distributed(self) -> bool:
        return self.groups["data"] is not None


def mesh_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None is this process's card,
    ``cuda:(LOCAL_RANK % device_count)`` (all ranks share ``cuda:0`` on a
    one-card machine), and raises where there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())


def make_mesh(n_data: Optional[int] = None, n_space: int = 1, device=None) -> Mesh:
    """The (data, space) mesh over the ranks of the default process group,
    all on ``data`` by default (JAX's ``parallel/mesh.py:26``). Every rank
    must call it, in the same order as the other ranks' calls: it makes one
    ``new_group`` for each row and each column."""
    device = mesh_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_space
    if n_data * n_space != world:
        raise ValueError(f"mesh {n_data}x{n_space} != {world} ranks")
    shape = {"data": n_data, "space": n_space}
    if not dist.is_initialized():
        return Mesh(shape, {"data": 0, "space": 0}, device, {"data": None, "space": None})
    rank = dist.get_rank()
    coords = {"data": rank // n_space, "space": rank % n_space}
    groups = {}
    for d in range(n_data):  # rows: the space groups
        g = dist.new_group([d * n_space + s for s in range(n_space)])
        if d == coords["data"]:
            groups["space"] = g
    for s in range(n_space):  # columns: the data groups
        g = dist.new_group([d * n_space + s for d in range(n_data)])
        if s == coords["space"]:
            groups["data"] = g
    return Mesh(shape, coords, device, groups)


def shard_batch(x, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's slice of ``x``'s leading axis over ``axis``, on the mesh's
    device (JAX's ``shard_batch``); raises where the axis does not divide,
    as ``shard_map`` does."""
    x = torch.as_tensor(x)
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not divide the mesh's {axis!r} axis of {n}")
    per = x.shape[0] // n
    return x[mesh.coords[axis] * per:(mesh.coords[axis] + 1) * per].to(mesh.device)


def gather_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The inverse of ``shard_batch``: the slices of ``axis`` concatenated in
    axis order, on every rank."""
    return all_gather(x, mesh, axis, dim=0)


def replicate(x, mesh: Mesh) -> torch.Tensor:
    """``x`` (masks, noise, weights) as a tensor on the mesh's device."""
    return torch.as_tensor(x).to(mesh.device)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad a batch axis so it divides the mesh; returns (padded, true_n).
    The padding repeats entries from the start (index ``i % n``), so shapes
    stay whole while metrics drop the padding."""
    n = x.shape[axis]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return x, n
    pad_idx = np.arange(target) % n
    return np.take(x, pad_idx, axis=axis), n


# -- collectives over one axis of the mesh ------------------------------------


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over ``axis``, as a new tensor (``x`` itself on the
    1 x 1 mesh)."""
    group = mesh.groups[axis]
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ``axis`` group's tensors concatenated along ``dim`` in axis order."""
    group = mesh.groups[axis]
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``all_to_all_single`` over ``axis``: chunk ``j`` of ``x``'s leading
    axis goes to the ``j``-th rank of the group, and chunk ``i`` of the
    result came from the ``i``-th."""
    group = mesh.groups[axis]
    if group is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


# -- process groups and local launches -----------------------------------------


def init_process_group(device, init_method: str, rank: int, world_size: int,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``init_process_group`` with NCCL for a CUDA ``device`` and gloo for the
    CPU, and a timeout on every collective of the group."""
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init_method, rank=rank,
                            world_size=world_size, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def init_from_env(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the world torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); returns this rank's
    device (``mesh_device(device)``)."""
    device = mesh_device(device)
    init_process_group(device, "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), timeout_s)
    return device


def launched() -> bool:
    """Whether this process was started as one rank of a world (torchrun)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def _rank_main(rank: int, fn: Callable, world: int, init_method: str, timeout_s: float, threads: Optional[int],
               args: Sequence) -> None:
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch_local(fn: Callable, world: int, args: Sequence = (), timeout_s: float = DEFAULT_TIMEOUT_S,
                 threads: Optional[int] = None) -> None:
    """Run ``fn(*args)`` in ``world`` spawned processes that form one gloo
    group (a file store in a fresh temporary directory; gloo, since NCCL
    takes one rank per card), and wait for all of them. ``fn`` is
    importable by name (it is pickled); it writes its results itself. A
    rank that raises or exits non-zero fails the launch (the others are
    terminated), and so does a launch not done within ``timeout_s`` (the
    ranks are killed, ``TimeoutError``). ``threads`` caps each rank's
    torch threads."""
    tmp = tempfile.mkdtemp(prefix="pnp_dist_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, f"file://{tmp}/store", timeout_s, threads, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"launch_local: {world} ranks of {fn.__name__} not done in {timeout_s} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
