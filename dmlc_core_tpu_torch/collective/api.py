"""Process-level, rabit-shaped collective API over ``torch.distributed``.

Counterpart of ``dmlc_core_tpu/collective/api.py``: each *process* is a
rank, arrays are host numpy arrays in and out, and every rank receives the
same result.  ``init``/``finalize``/``get_rank``/``get_world_size``/
``allreduce``/``broadcast``/``allgather``/``tracker_print``/
``version_number``/``checkpoint``/``load_checkpoint`` keep the reference's
semantics (checkpoints in its format, through :mod:`..bridge.checkpoint`);
underneath, the
reference's ``jax.distributed`` runtime becomes one ``torch.distributed``
process group per job.

Env contract (the same the tracker launchers set):

- ``DMLC_TASK_ID`` -> rank, falling back to the launcher rank variables
  ``OMPI_COMM_WORLD_RANK``/``PMIX_RANK``/``PMI_RANK``/``SLURM_PROCID``;
- ``DMLC_NUM_WORKER`` -> world size;
- ``DMLC_COORDINATOR_URI``/``DMLC_COORDINATOR_PORT`` -> the ``TCPStore``
  that rank 0 hosts and every rank joins.

With a coordinator address, :func:`init` joins a process group (at any
world size, so a one-rank job still runs its collectives through the
backend); without one the job is a single process and every collective is
the local identity, as in the reference.

Backends are chosen, never switched quietly: ``nccl`` when the port runs
on the card (the default) and every local rank has a card of its own
(``torch.cuda.set_device(local_rank)``), ``gloo`` when the caller passes
``init({"device": "cpu"})`` or asks for it with ``init({"backend":
"gloo"})``, which several ranks sharing one card need.  NCCL asked for
with more local ranks than cards raises.  Local rank and local world size
come from ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` when the launcher sets them,
else every worker is taken to run on this host (the tracker's local
backend).  Collectives time out after ``DMLC_COLLECTIVE_TIMEOUT`` seconds
(default 300, or ``init({"timeout": s})``), so a dead peer fails the run
instead of hanging it.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
import sys
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from dmlc_core_tpu_torch.param import get_env
from dmlc_core_tpu_torch.utils.device import resolve_device
from dmlc_core_tpu_torch.utils.logging import CHECK, Error, log_info

__all__ = [
    "init",
    "finalize",
    "is_initialized",
    "get_rank",
    "get_world_size",
    "get_processor_name",
    "allreduce",
    "broadcast",
    "allgather",
    "tracker_print",
    "version_number",
    "checkpoint",
    "load_checkpoint",
    "group_timeout",
]

_state: dict = {
    "initialized": False,
    "distributed": False,
    "wire": None,      # device the collectives' tensors live on
    "timeout": None,   # datetime.timedelta of the process group
    "version": 0,
}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT}


def _task_id_from_env(env) -> int:
    """Rank: DMLC_TASK_ID when the launcher set it (local/ssh/sge/yarn
    backends), else the MPI/SLURM launcher's rank variable, since mpirun
    assigns ranks itself and cannot bake per-process task ids into its
    shared environment."""
    for key in ("DMLC_TASK_ID", "OMPI_COMM_WORLD_RANK", "PMIX_RANK",
                "PMI_RANK", "SLURM_PROCID"):
        value = env.get(key, "").strip()
        if value:
            try:
                return int(value)
            except ValueError:
                # stale/garbage launcher vars inherited by an unrelated run
                # must not break standalone init
                sys.stderr.write(f"ignoring non-integer {key}={value!r}\n")
    return 0


def _pick_backend(backend: Optional[str], device: Optional[str], env,
                  num_worker: int, task_id: int):
    """(backend, device of the collectives' tensors); raises where the
    asked-for backend cannot serve the layout."""
    if backend is None:
        backend = "gloo" if device == "cpu" else "nccl"
    CHECK(backend in ("nccl", "gloo"),
          f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "gloo":
        return backend, torch.device("cpu")
    CHECK(device is None or torch.device(device).type == "cuda",
          f"the nccl backend needs device='cuda', got {device!r}")
    resolve_device("cuda")
    local_rank = int(env.get("LOCAL_RANK", task_id))
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_worker))
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise Error(
            f"nccl needs one card per local rank, but {local_world} local "
            f"ranks share {cards} card(s) (NCCL refuses two ranks on one "
            f"GPU: 'Duplicate GPU detected'); run several ranks on one "
            f"card with init({{'backend': 'gloo'}})")
    torch.cuda.set_device(local_rank)
    return backend, torch.device("cuda", local_rank)


def init(args: Optional[dict] = None) -> None:
    """Initialize the collective runtime (rabit::Init equivalent).

    ``args`` may carry ``backend`` (``"nccl"``/``"gloo"``), ``device``
    (``"cpu"`` selects gloo), ``timeout`` (seconds) and any ``DMLC_*``
    variable, which overrides the environment."""
    if _state["initialized"]:
        return
    args = dict(args or {})
    backend = args.pop("backend", None)
    device = args.pop("device", None)
    timeout = args.pop("timeout", None)
    env = dict(os.environ)
    env.update({k: str(v) for k, v in args.items()})
    num_worker = int(env.get("DMLC_NUM_WORKER", "1"))
    task_id = _task_id_from_env(env)
    coord_uri = env.get("DMLC_COORDINATOR_URI", "")
    coord_port = env.get("DMLC_COORDINATOR_PORT", "")
    if coord_uri:
        CHECK(coord_port, "DMLC_COORDINATOR_URI is set but "
                          "DMLC_COORDINATOR_PORT is not")
        CHECK(0 <= task_id < num_worker,
              f"task id {task_id} out of range for {num_worker} workers")
        backend, wire = _pick_backend(backend, device, env, num_worker,
                                      task_id)
        seconds = (float(timeout) if timeout is not None
                   else get_env("DMLC_COLLECTIVE_TIMEOUT", float, 300.0))
        limit = datetime.timedelta(seconds=seconds)
        # rank 0 hosts the store; the others connect to it
        store = dist.TCPStore(coord_uri, int(coord_port), num_worker,
                              is_master=(task_id == 0), timeout=limit,
                              wait_for_workers=False)
        dist.init_process_group(backend, store=store, rank=task_id,
                                world_size=num_worker, timeout=limit)
        _state.update(distributed=True, wire=wire, timeout=limit)
    _state["initialized"] = True
    atexit.register(finalize)


def finalize() -> None:
    """rabit::Finalize equivalent."""
    if not _state["initialized"]:
        return
    if _state["distributed"] and dist.is_initialized():
        dist.destroy_process_group()
    # the version resets with the session, as in the reference
    _state.update(initialized=False, distributed=False, wire=None,
                  timeout=None, version=0)


def is_initialized() -> bool:
    return _state["initialized"]


def group_timeout() -> Optional[datetime.timedelta]:
    """The process group's timeout, for groups made after :func:`init`
    (None when the job is a single process)."""
    return _state["timeout"]


def _require_init() -> None:
    CHECK(_state["initialized"], "collective.init() must be called first")


def get_rank() -> int:
    _require_init()
    return dist.get_rank() if _state["distributed"] else 0


def get_world_size() -> int:
    _require_init()
    return dist.get_world_size() if _state["distributed"] else 1


def get_processor_name() -> str:
    return socket.gethostname()


def _to_wire(value: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(value, copy=True, order="C")).to(
        _state["wire"])


def allreduce(value: Any, op: str = "sum") -> np.ndarray:
    """Elementwise reduce across all ranks; result identical on every rank
    (rabit::Allreduce).  ``op`` in {sum, max, min, prod}."""
    _require_init()
    CHECK(op in _OPS, f"unknown reduce op {op!r}")
    value = np.asarray(value)
    if get_world_size() == 1:
        return value
    t = _to_wire(value)
    dist.all_reduce(t, op=_OPS[op])
    return t.cpu().numpy()


# dtype codes for the broadcast shape/dtype header (fixed order, part of
# the cross-rank wire contract; append only).  The payload travels as raw
# uint8 bytes, so every listed dtype crosses unchanged (ranks are assumed
# same-endian).
_BCAST_DTYPES = ["float32", "float64", "int32", "int64", "uint8", "bool",
                 "float16", "uint32", "uint64", "int8", "int16", "uint16",
                 "complex64", "complex128"]
_BCAST_MAX_NDIM = 8
_BCAST_ERR = -1   # header[0] sentinel: root-side validation failed


def _bcast(value: np.ndarray, root: int) -> np.ndarray:
    t = _to_wire(value)
    dist.broadcast(t, src=root)
    return t.cpu().numpy()


def broadcast(value: Any = None, root: int = 0) -> np.ndarray:
    """Broadcast ``value`` from ``root`` to all ranks (rabit::Broadcast).

    Only ``root`` needs to supply data; other ranks may pass ``None`` (the
    shape and dtype travel in a fixed-size header round first).  A root-side
    error travels as a sentinel in the header, so every rank raises instead
    of hanging in the payload round.
    """
    _require_init()
    rank = get_rank()
    world = get_world_size()
    if world == 1:
        CHECK(value is not None, "broadcast root must supply a value")
        return np.asarray(value)
    CHECK(0 <= root < world, f"root {root} out of range for {world} ranks")
    header = np.zeros(2 + _BCAST_MAX_NDIM, np.int32)
    root_err: Optional[str] = None
    if rank == root:
        if value is None:
            root_err = "broadcast root must supply a value"
        else:
            value = np.asarray(value)
            if value.ndim > _BCAST_MAX_NDIM:
                root_err = f"broadcast supports ndim <= {_BCAST_MAX_NDIM}"
            elif str(value.dtype) not in _BCAST_DTYPES:
                root_err = f"unsupported broadcast dtype {value.dtype}"
        if root_err is None:
            header[0] = _BCAST_DTYPES.index(str(value.dtype))
            header[1] = value.ndim
            header[2:2 + value.ndim] = value.shape
        else:
            header[0] = _BCAST_ERR
    header = _bcast(header, root)
    if int(header[0]) == _BCAST_ERR:
        CHECK(False, root_err or
              f"broadcast root {root} failed validation; see its log")
    dtype = np.dtype(_BCAST_DTYPES[int(header[0])])
    shape = tuple(int(s) for s in header[2:2 + int(header[1])])
    nbytes = int(dtype.itemsize * int(np.prod(shape, dtype=np.int64)))
    if rank == root:
        payload = np.frombuffer(
            np.ascontiguousarray(value.astype(dtype, copy=False)).tobytes(),
            dtype=np.uint8)
    else:
        payload = np.zeros(nbytes, np.uint8)   # shape carrier; overwritten
    out = _bcast(payload, root)
    return np.frombuffer(out.tobytes(), dtype=dtype).reshape(shape)


def allgather(value: Any) -> np.ndarray:
    """Gather each rank's array (same shape everywhere); returns
    ``[world, ...]`` in rank order on every rank."""
    _require_init()
    value = np.asarray(value)
    if get_world_size() == 1:
        return value[None]
    t = _to_wire(value)
    parts = [torch.empty_like(t) for _ in range(get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def tracker_print(msg: str) -> None:
    """Print through the tracker on rank 0 (rabit::TrackerPrint)."""
    _require_init()
    if get_rank() == 0:
        sys.stderr.write(str(msg).rstrip("\n") + "\n")
        sys.stderr.flush()


def version_number() -> int:
    """Checkpoint version counter (rabit::VersionNumber)."""
    return _state["version"]


def _check_version_template(uri_template: str) -> None:
    CHECK(uri_template.format(version=1) != uri_template.format(version=2),
          "checkpoint uri_template must contain a {version} placeholder, "
          f"got {uri_template!r}")


def checkpoint(model: Any, uri_template: str = "") -> None:
    """Persist a model tree for failure recovery (rabit::Checkpoint).

    Every rank bumps its version; rank 0, holding state identical to every
    other rank's, writes it through the URI-dispatched store, so a restart
    resumes from the latest version.
    """
    _state["version"] += 1
    if uri_template and get_rank() == 0:
        from dmlc_core_tpu_torch.bridge.checkpoint import save_checkpoint

        _check_version_template(uri_template)
        save_checkpoint(uri_template.format(version=_state["version"]), model)


def load_checkpoint(uri_template: str = "", version: Optional[int] = None,
                    template: Any = None) -> Any:
    """Load the checkpoint saved by :func:`checkpoint`; None when absent.

    Like rabit's ``LoadCheckPoint``, a freshly restarted worker (version
    counter still 0) does not need to know which round died: rank 0
    discovers the latest version on the store (exponential ascent + binary
    search, O(log N) probes), falls back past a corrupt newest version,
    and BROADCASTS both the version and the model leaves to every rank, so
    ranks never resume out of step even when only rank 0 reaches the
    store.  Multi-process recovery therefore needs ``template`` (the tree
    structure non-root ranks rebuild).
    """
    if not uri_template:
        return None
    from dmlc_core_tpu_torch.bridge.checkpoint import (tree_flatten,
                                                       tree_unflatten)

    _check_version_template(uri_template)
    world = get_world_size() if _state["initialized"] else 1
    rank = get_rank() if _state["initialized"] else 0
    multi = world > 1
    if multi:
        CHECK(template is not None,
              "multi-process load_checkpoint needs template= (non-root "
              "ranks rebuild the model from broadcast leaves)")

    ver = version if version is not None else _state["version"]
    model = None
    if rank == 0 or not multi:
        if ver <= 0:
            ver = _discover_latest_version(uri_template)
        model, ver = _load_with_fallback(uri_template, ver, template)
    if multi:
        ver = int(broadcast(np.int64(ver if rank == 0 else 0), root=0))
        if ver > 0:
            src = (tree_flatten(model)[1] if rank == 0
                   else [None] * len(tree_flatten(template)[1]))
            model = tree_unflatten(template, [broadcast(s, root=0)
                                              for s in src])
    if ver <= 0 or model is None:
        return None
    _state["version"] = ver
    return model


def _discover_latest_version(uri_template: str) -> int:
    """Largest contiguous existing version: exponential ascent to bracket,
    then binary search — O(log N) store probes instead of N."""
    if not _checkpoint_exists(uri_template, 1):
        return 0
    lo = 1                      # known to exist
    hi = 2
    while _checkpoint_exists(uri_template, hi):
        lo, hi = hi, hi * 2
    # invariant: lo exists, hi does not; find the boundary
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if _checkpoint_exists(uri_template, mid):
            lo = mid
        else:
            hi = mid
    return lo


def _load_with_fallback(uri_template: str, ver: int, template: Any):
    """Load version ``ver``, falling back past corrupt/truncated newer
    versions (a remote store without atomic rename can expose a partial
    newest file — the same policy as ``CheckpointManager.restore``)."""
    from dmlc_core_tpu_torch.bridge.checkpoint import load_checkpoint as _load

    last_err: Optional[BaseException] = None
    while ver > 0:
        try:
            return _load(uri_template.format(version=ver), template), ver
        except Exception as e:  # noqa: BLE001 — fall back past bad versions
            log_info(f"checkpoint version {ver} unreadable ({e}); "
                     "falling back to previous version")
            last_err = e
            ver -= 1
    if last_err is not None and not _checkpoint_exists(uri_template, 1):
        # nothing restorable at all, and version 1 is genuinely absent:
        # treat as a fresh start rather than an error
        return None, 0
    if last_err is not None:
        raise RuntimeError(
            f"no restorable checkpoint for {uri_template!r}") from last_err
    return None, 0


def _checkpoint_exists(uri_template: str, version: int) -> bool:
    """Existence probe.  Only genuinely missing paths count as absent;
    transient store errors propagate — treating them as absent would
    silently roll training back to an older version and later overwrite
    newer checkpoints with stale state."""
    from dmlc_core_tpu_torch.io.stream import create_stream_for_read

    try:
        s = create_stream_for_read(uri_template.format(version=version))
    except (FileNotFoundError, IsADirectoryError):
        return False
    if s is None:
        return False
    s.close()
    return True
