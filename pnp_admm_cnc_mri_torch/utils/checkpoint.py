"""Solver-state snapshots: save and resume long solves and sweeps.

Port of the JAX package's ``utils/checkpoint.py``, in its file format: one
``.npz`` a snapshot, with the same keys and dtypes, the configuration or
solve parameters as UTF-8 JSON in a uint8 array (``config_json``,
``meta_json``) and the family tag of single-iterate snapshots in ``kind``.
A file written by either package loads and resumes in the other.

The loaders return CPU tensors (FISTA's momentum t as a numpy scalar of the
state's dtype, as ``solvers.fista.FISTAState`` keeps it). Each ``resume_*``
moves the snapshot to ``device`` (None: the CUDA card), as the solvers take
their inputs, and continues the solver's own loop from the saved iteration
with the true global iteration index and the same data-consistency path,
so that a solve stopped, saved and resumed equals the uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from pnp_admm_cnc_mri_torch.config import ADMMConfig
from pnp_admm_cnc_mri_torch.solvers.admm import ADMMState, prepare_inputs, resolve_device


def _host(a) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _from_json(a: np.ndarray):
    return json.loads(bytes(a).decode())


def _save(path: str, payload: dict) -> None:
    if not path.endswith(".npz"):
        # np.savez appends '.npz' to other suffixes, which would break the
        # save/load round trip under the caller's original path
        raise ValueError(f"checkpoint path must end in .npz, got {path!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **payload)


def _on(device, *arrays):
    """The arrays as tensors on ``device``."""
    device = resolve_device(device)
    return [torch.as_tensor(a, device=device) for a in arrays]


def save_state(path: str, state: ADMMState, iteration: int, cfg: Optional[ADMMConfig] = None) -> None:
    """Snapshot an ADMM state (x, z, w) after ``iteration`` iterations."""
    payload = {"x": _host(state.x), "z": _host(state.z), "w": _host(state.w), "iteration": np.asarray(iteration)}
    if cfg is not None:
        payload["config_json"] = _json_bytes(dataclasses.asdict(cfg))
    _save(path, payload)


def load_state(path: str) -> Tuple[ADMMState, int, Optional[ADMMConfig]]:
    with np.load(path) as f:
        state = ADMMState(*(torch.from_numpy(f[k]) for k in ("x", "z", "w")))
        it = int(f["iteration"])
        cfg = ADMMConfig(**_from_json(f["config_json"])) if "config_json" in f.files else None
    return state, it, cfg


def resume_admm(path: str, y, mask, z_update, clamp: bool = False, use_rfft: bool = True, tail=None, device=None):
    """Continue a checkpointed ADMM run (``solvers.admm.run_admm``) to its
    configured iteration count; returns ``(final_state, cfg)``. ``tail``:
    the fused z/w update the solve ran with (``admm.classical_update``
    gives both for ``admm_l1`` and ``admm_cnc``)."""
    from pnp_admm_cnc_mri_torch.solvers import admm

    state, it, cfg = load_state(path)
    if cfg is None:
        raise ValueError(f"{path} has no embedded config")
    y, mask = prepare_inputs(y, mask, device)
    state = ADMMState(*_on(y.device, *state))
    final, _ = admm.run_admm(y, mask, cfg.iter_num, cfg.rho, z_update, clamp=clamp, tail=tail, use_rfft=use_rfft,
                             state=state, start=it)
    return final, cfg


def save_fista_state(path: str, state, iteration: int, meta: Optional[dict] = None) -> None:
    """Snapshot a ``solvers.fista.FISTAState`` (x, v, t) and the iteration;
    ``meta``: JSON-serializable solve parameters (iter_num, step, ...)."""
    payload = {"fista_x": _host(state.x), "fista_v": _host(state.v), "fista_t": np.asarray(state.t),
               "iteration": np.asarray(iteration)}
    if meta is not None:
        payload["meta_json"] = _json_bytes(meta)
    _save(path, payload)


def load_fista_state(path: str):
    """-> (FISTAState, iteration, meta dict or None)."""
    from pnp_admm_cnc_mri_torch.solvers.fista import FISTAState

    with np.load(path) as f:
        state = FISTAState(x=torch.from_numpy(f["fista_x"]), v=torch.from_numpy(f["fista_v"]), t=f["fista_t"][()])
        it = int(f["iteration"])
        meta = _from_json(f["meta_json"]) if "meta_json" in f.files else None
    return state, it, meta


def save_iterate_state(path: str, x, iteration: int, kind: str, meta: Optional[dict] = None) -> None:
    """Snapshot a single-iterate solver state (HQS's z, RED's x) and the
    iteration. ``kind`` tags the family ('hqs', 'consensus_hqs' or 'red')
    so that another family's resume refuses it; ``meta`` embeds the solve
    parameters as JSON."""
    payload = {"iterate": _host(x), "iteration": np.asarray(iteration),
               "kind": np.frombuffer(kind.encode(), dtype=np.uint8)}
    if meta is not None:
        payload["meta_json"] = _json_bytes(meta)
    _save(path, payload)


def load_iterate_state(path: str, kind: Optional[str] = None):
    """-> (iterate, iteration, meta dict or None). ``kind`` (if given) must
    match the tag the snapshot was saved with."""
    with np.load(path) as f:
        x = torch.from_numpy(f["iterate"])
        it = int(f["iteration"])
        saved_kind = bytes(f["kind"]).decode()
        meta = _from_json(f["meta_json"]) if "meta_json" in f.files else None
    if kind is not None and saved_kind != kind:
        raise ValueError(f"{path} is a {saved_kind!r} checkpoint, not {kind!r}")
    return x, it, meta


def _ladder_meta(alphas, clamp: bool, meta: Optional[dict]) -> dict:
    m = dict(meta or {})
    m["alphas"] = [float(a) for a in _host(alphas)]
    m["clamp"] = bool(clamp)
    return m


def save_hqs(path: str, z, iteration: int, alphas, clamp: bool = True, meta: Optional[dict] = None) -> None:
    """Snapshot an HQS run (``solvers.hqs.run_hqs``) with its alphas ladder
    and clamp flag."""
    save_iterate_state(path, z, iteration, kind="hqs", meta=_ladder_meta(alphas, clamp, meta))


def save_consensus_hqs(path: str, z, iteration: int, alphas, clamp: bool = True,
                       meta: Optional[dict] = None) -> None:
    """Snapshot a consensus-HQS run (``parallel.consensus.run_consensus_hqs``)
    with its alphas ladder and clamp flag."""
    save_iterate_state(path, z, iteration, kind="consensus_hqs", meta=_ladder_meta(alphas, clamp, meta))


def _load_ladder(path: str, kind: str, iter_num: Optional[int]):
    z0, it, meta = load_iterate_state(path, kind=kind)
    meta = meta or {}
    alphas = meta.get("alphas")
    if alphas is None:
        raise ValueError(f"{path} has no embedded alphas ladder")
    iter_num = iter_num if iter_num is not None else len(alphas)
    return z0, it, meta, alphas[:iter_num], iter_num, meta.get("clamp", True)


def resume_hqs(path: str, y, mask, denoise, iter_num: Optional[int] = None, device=None):
    """Continue a checkpointed HQS run to ``iter_num`` total iterations (the
    ladder's length by default) on the remaining rungs of the embedded
    ladder; returns ``(z, meta)``."""
    from pnp_admm_cnc_mri_torch.solvers import hqs

    z0, it, meta, alphas, iter_num, clamp = _load_ladder(path, "hqs", iter_num)
    y, mask = prepare_inputs(y, mask, device)
    (z0,) = _on(y.device, z0)
    z, _ = hqs.run_hqs(y, mask, iter_num, denoise, alphas, clamp=clamp, dtype=z0.dtype, device=y.device, z0=z0,
                       start=min(it, iter_num))
    return z, meta


def resume_consensus_hqs(path: str, ys, masks, denoise, iter_num: Optional[int] = None, device=None):
    """Continue a checkpointed consensus-HQS run to ``iter_num`` total
    iterations through the solver's own step; returns ``(z, meta)``."""
    from pnp_admm_cnc_mri_torch.parallel import consensus

    z0, it, meta, alphas, iter_num, clamp = _load_ladder(path, "consensus_hqs", iter_num)
    ys, masks = prepare_inputs(ys, masks, device)
    (z0,) = _on(ys.device, z0)
    z = consensus.run_consensus_hqs(ys, masks, iter_num, denoise, clamp=clamp, dtype=z0.dtype, alphas=alphas,
                                    device=ys.device, z0=z0, start=min(it, iter_num))
    return z, meta


def save_consensus_state(path: str, z, w, iteration: int, cfg: Optional[ADMMConfig] = None) -> None:
    """Snapshot a consensus-ADMM run (``run_consensus(...,
    return_state=True)``): the global iterate z and the per-observation
    duals w (N, H, W)."""
    payload = {"consensus_z": _host(z), "consensus_w": _host(w), "iteration": np.asarray(iteration)}
    if cfg is not None:
        payload["config_json"] = _json_bytes(dataclasses.asdict(cfg))
    _save(path, payload)


def load_consensus_state(path: str):
    """-> (z, w, iteration, ADMMConfig or None)."""
    with np.load(path) as f:
        if "consensus_z" not in f.files:
            raise ValueError(f"{path} is not a consensus-ADMM checkpoint")
        z, w = torch.from_numpy(f["consensus_z"]), torch.from_numpy(f["consensus_w"])
        it = int(f["iteration"])
        cfg = ADMMConfig(**_from_json(f["config_json"])) if "config_json" in f.files else None
    return z, w, it, cfg


def resume_consensus_admm(path: str, ys, masks, z_prox=None, dc_method: str = "auto", device=None):
    """Continue a checkpointed consensus-ADMM run to its configured
    iteration count through the solver's own loop (``z_prox`` defaults as
    there); returns ``(z, per-observation x, cfg)``."""
    from pnp_admm_cnc_mri_torch.parallel import consensus

    z0, w0, it, cfg = load_consensus_state(path)
    if cfg is None:
        raise ValueError(f"{path} has no embedded config")
    ys, masks = prepare_inputs(ys, masks, device)
    z, x = consensus.run_consensus(ys, masks, cfg, z_prox=z_prox, dc_method=dc_method, device=ys.device,
                                   state=tuple(_on(ys.device, z0, w0)), start=it)
    return z, x, cfg


def save_consensus_fista(path: str, state, iteration: int, iter_num: int, step: float = 1.0,
                         precondition: bool = True, meta: Optional[dict] = None) -> None:
    """Snapshot a consensus-FISTA run (``run_consensus_fista(...,
    return_state=True)``) with iter_num, step and precondition, tagged so
    that ``resume_fista`` refuses it."""
    m = dict(meta or {})
    m.update({"family": "consensus_fista", "iter_num": int(iter_num), "step": float(step),
              "precondition": bool(precondition)})
    save_fista_state(path, state, iteration, meta=m)


def _load_fista(path: str, device):
    from pnp_admm_cnc_mri_torch.solvers.fista import FISTAState

    state, it, meta = load_fista_state(path)
    return FISTAState(*_on(device, state.x, state.v), state.t), it, meta or {}


def resume_consensus_fista(path: str, ys, masks, prox_fn, iter_num: Optional[int] = None,
                           step: Optional[float] = None, device=None):
    """Continue a checkpointed consensus-FISTA run to ``iter_num`` total
    iterations (defaults from the embedded meta), the momentum t resumed
    from the snapshot; returns ``(state, meta)``."""
    from pnp_admm_cnc_mri_torch.parallel import consensus

    ys, masks = prepare_inputs(ys, masks, device)
    state, it, meta = _load_fista(path, ys.device)
    if meta.get("family") != "consensus_fista":
        raise ValueError(f"{path} is not a consensus-FISTA checkpoint (family={meta.get('family')!r}); "
                         "use resume_fista")
    iter_num = iter_num if iter_num is not None else meta.get("iter_num")
    step = step if step is not None else meta.get("step", 1.0)
    if iter_num is None:
        raise ValueError(f"{path} has no embedded iter_num; pass it")
    final = consensus.run_consensus_fista(ys, masks, iter_num, prox_fn, step=step,
                                          precondition=meta.get("precondition", True), return_state=True,
                                          device=ys.device, state=state, start=it)
    return final, meta


def resume_red(path: str, y, mask, denoise, iter_num: Optional[int] = None, device=None):
    """Continue a checkpointed RED run (``solvers.red.run_red``) to
    ``iter_num`` total iterations with the embedded (lam, step, variant,
    clamp); returns ``(x, meta)``."""
    from pnp_admm_cnc_mri_torch.solvers import red

    x0, it, meta = load_iterate_state(path, kind="red")
    meta = meta or {}
    iter_num = iter_num if iter_num is not None else meta.get("iter_num")
    if iter_num is None:
        raise ValueError(f"{path} has no embedded iter_num; pass it")
    y, mask = prepare_inputs(y, mask, device)
    (x0,) = _on(y.device, x0)
    x, _ = red.run_red(y, mask, iter_num, denoise, lam=meta.get("lam", 0.2), step=meta.get("step", 1.0),
                       variant=meta.get("variant", "fp"), clamp=meta.get("clamp", True), dtype=x0.dtype,
                       device=y.device, x0=x0, start=it)
    return x, meta


def resume_fista(path: str, y, mask, prox_fn, iter_num: Optional[int] = None, step: Optional[float] = None,
                 device=None):
    """Continue a checkpointed FISTA run to ``iter_num`` total iterations
    (defaults from the embedded meta): the momentum t resumes from the
    snapshot and the prox sees the true global iteration index. Returns
    ``(state, meta)``."""
    from pnp_admm_cnc_mri_torch.solvers import fista

    y, mask = prepare_inputs(y, mask, device)
    state, it, meta = _load_fista(path, y.device)
    if meta.get("family") == "consensus_fista":
        raise ValueError(f"{path} is a consensus-FISTA checkpoint; use resume_consensus_fista")
    iter_num = iter_num if iter_num is not None else meta.get("iter_num")
    step = step if step is not None else meta.get("step", 1.0)
    if iter_num is None:
        raise ValueError(f"{path} has no embedded iter_num; pass it")
    final, _ = fista.run_fista(y, mask, iter_num, prox_fn, step=step, dtype=state.x.dtype, device=y.device,
                               state=state, start=it)
    return final, meta
