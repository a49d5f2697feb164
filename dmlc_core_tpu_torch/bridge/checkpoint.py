"""Checkpoint trees of tensors and arrays to any URI-dispatched stream.

Counterpart of ``dmlc_core_tpu/bridge/checkpoint.py``: the same
``DMLCTPU1`` format, the same manifests and the same
:class:`CheckpointManager`, so a blob written by either package loads in
the other.  Where the reference flattens a jax pytree, the port walks the
tree itself (:func:`tree_flatten`) and gives each leaf the path jax's
``keystr`` would: dict keys sorted (``OrderedDict`` keys in their order)
as ``['key']``, list and tuple items as ``[0]``, NamedTuple fields as
``.field``, nested paths concatenated, ``None`` dropped.  Tensors are
written as their host numpy arrays.

Format: magic "DMLCTPU1" | u64 header_len | header JSON | leaf blobs in order.
Header: {"leaves": [{"path": str, "dtype": str, "shape": [...]}, ...]}.

**Manifests**: :class:`CheckpointManager` publishes a small JSON manifest
beside each step (``ckpt-XXXXXXXX.manifest.json``: the step, the blob's
byte count, a CRC-32 over every blob byte, the wall time), written only
*after* the blob is durable.  A reader that goes manifest-first never opens
a partially written checkpoint, and :func:`verify_checkpoint` re-hashes the
blob against its manifest so corrupt or truncated bytes are rejected before
any model work touches them.
"""

from __future__ import annotations

import glob
import json
import os
import re
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from dmlc_core_tpu_torch.io.stream import create_stream, create_stream_for_read
from dmlc_core_tpu_torch.utils.logging import CHECK, CHECK_EQ, log_info, log_warning

__all__ = ["save_checkpoint", "load_checkpoint", "AsyncCheckpointer",
           "CheckpointManager", "CheckpointCorruptError", "verify_checkpoint",
           "tree_flatten", "tree_unflatten", "tree_map", "host_array"]

_MAGIC = b"DMLCTPU1"

MANIFEST_SUFFIX = ".manifest.json"
MANIFEST_VERSION = 1

_VERIFY_CHUNK = 1 << 20


class CheckpointCorruptError(RuntimeError):
    """A checkpoint whose bytes disagree with its manifest (or that is not
    a checkpoint at all) — the one error a hot-swap validator must turn
    into "previous-good keeps serving", never into a crash."""


# -- the tree walk (jax.tree_util's paths, order and None handling) ----------

def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _dict_keys(d: dict) -> list:
    return list(d) if isinstance(d, OrderedDict) else sorted(d)


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """``(path suffix, child)`` pairs of a container, in jax's order, or
    ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in _dict_keys(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def tree_flatten(tree: Any) -> Tuple[List[str], List[Any]]:
    """``(paths, leaves)`` of ``tree`` in jax's order; ``None`` has no
    leaf."""
    paths: List[str] = []
    leaves: List[Any] = []

    def walk(node: Any, path: str) -> None:
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            paths.append(path)
            leaves.append(node)
            return
        for suffix, child in kids:
            walk(child, path + suffix)

    walk(tree, "")
    return paths, leaves


def tree_unflatten(template: Any, leaves: Iterable[Any]) -> Any:
    """``template``'s structure (dicts, lists, tuples, NamedTuples and
    ``None`` kept) with its leaves replaced, in :func:`tree_flatten`'s
    order, by ``leaves``."""
    it: Iterator[Any] = iter(leaves)

    def build(node: Any) -> Any:
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, dict):
            return type(node)((k, build(node[k])) for k in _dict_keys(node))
        built = [build(child) for _, child in kids]
        if _is_namedtuple(node):
            return type(node)(*built)
        return type(node)(built)

    out = build(template)
    CHECK(next(it, it) is it, "more leaves than the template holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    return tree_unflatten(tree, [fn(v) for v in tree_flatten(tree)[1]])


def host_array(v: Any) -> np.ndarray:
    """A tensor's (or array's, or scalar's) host numpy array, dtype
    unchanged."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# -- local-file helpers -------------------------------------------------------

def _is_local_uri(uri: str) -> bool:
    return "://" not in uri or uri.startswith("file://")


def _strip_file_scheme(uri: str) -> str:
    return uri[len("file://"):] if uri.startswith("file://") else uri


def _temp_suffix() -> str:
    """Host+pid writer tag for temp names: pid liveness is only decidable on
    the writing host, so the host must be part of the name."""
    import socket

    return f"{socket.gethostname()}.{os.getpid()}"


def _sweep_orphan_temps(base_path: str) -> None:
    """Remove ``{base_path}.tmp.<host>.<pid>`` files whose writer is dead.

    Liveness (``kill(pid, 0)``) is only meaningful for temps written on THIS
    host; another host's in-flight temp on a shared filesystem is left
    alone (its own host's next save or retention pass cleans it).
    """
    import socket

    host = socket.gethostname()
    prefix = base_path + ".tmp."
    for stale in glob.glob(prefix + "*"):
        rest = stale[len(prefix):]          # "<host>.<pid>" (legacy: "<pid>")
        tmp_host, _, pid_s = rest.rpartition(".")
        if tmp_host and tmp_host != host:
            continue                        # foreign host: cannot test pid
        try:
            pid = int(pid_s)
        except ValueError:
            continue                        # unrecognized name: leave it
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            pass                            # dead writer: sweep
        except OSError:
            continue                        # e.g. EPERM: pid exists
        else:
            continue                        # live writer, leave it
        try:
            os.remove(stale)
        except OSError:
            pass


# -- blobs --------------------------------------------------------------------

def save_checkpoint(uri: str, tree: Any) -> Dict[str, Any]:
    """Write a tree of tensors/arrays/scalars to ``uri``; returns a digest
    summary ``{"nbytes", "crc32", "num_leaves"}`` over the exact bytes
    written (what :class:`CheckpointManager` publishes as the step's
    manifest).

    Local writes are atomic (temp file + rename), so a crash mid-write
    never leaves a truncated checkpoint at the final path.
    """
    paths, values = tree_flatten(tree)
    arrays = [host_array(v) for v in values]
    header = json.dumps({
        "leaves": [
            {"path": p, "dtype": str(a.dtype), "shape": list(a.shape)}
            for p, a in zip(paths, arrays)
        ]
    }).encode("utf-8")
    target = uri
    local = _is_local_uri(uri)
    if local:
        # host+pid-unique temp name: concurrent savers to the same URI must
        # not interleave writes into one temp file and rename a torn mix
        target = f"{uri}.tmp.{_temp_suffix()}"
    crc = 0
    nbytes = 0

    def _put(fo, chunk: bytes) -> None:
        nonlocal crc, nbytes
        fo.write(chunk)
        crc = zlib.crc32(chunk, crc)
        nbytes += len(chunk)

    with create_stream(target, "w") as fo:
        _put(fo, _MAGIC)
        fo.write_u64(len(header))
        crc = zlib.crc32(struct.pack("<Q", len(header)), crc)
        nbytes += 8
        _put(fo, header)
        for a in arrays:
            _put(fo, np.ascontiguousarray(a).tobytes())
    if local:
        os.replace(_strip_file_scheme(target), _strip_file_scheme(uri))
    return {"nbytes": nbytes, "crc32": crc, "num_leaves": len(arrays)}


def verify_checkpoint(uri: str, manifest: Dict[str, Any]) -> None:
    """Re-hash the blob at ``uri`` against its manifest — magic, byte
    count, CRC-32 — raising :class:`CheckpointCorruptError` on any
    disagreement.  Pure byte IO, so a hot-swap validator can reject a torn
    or bit-rotted candidate before any model work starts.
    """
    want_nbytes = int(manifest.get("nbytes", -1))
    want_crc = int(manifest.get("crc32", -1))
    crc = 0
    nbytes = 0
    first = b""
    with (create_stream_for_read(uri) or create_stream(uri, "r")) as fi:
        while True:
            chunk = fi.read(_VERIFY_CHUNK)
            if not chunk:
                break
            if nbytes < len(_MAGIC):
                first += chunk[:len(_MAGIC) - nbytes]
            crc = zlib.crc32(chunk, crc)
            nbytes += len(chunk)
    if first != _MAGIC:
        raise CheckpointCorruptError(
            f"{uri!r}: not a dmlc_core_tpu checkpoint (bad magic)")
    if nbytes != want_nbytes:
        raise CheckpointCorruptError(
            f"{uri!r}: {nbytes} bytes on store, manifest says "
            f"{want_nbytes} (truncated or torn write)")
    if crc != want_crc:
        raise CheckpointCorruptError(
            f"{uri!r}: CRC-32 mismatch (got {crc:#010x}, manifest says "
            f"{want_crc:#010x}) — corrupt checkpoint")


def load_checkpoint(uri: str, template: Any = None) -> Any:
    """Read a checkpoint back.

    With ``template`` (a tree of matching structure), returns the
    template's structure filled with the loaded numpy leaves.  Without,
    returns a flat ``{path: array}`` dict.
    """
    with (create_stream_for_read(uri) or create_stream(uri, "r")) as fi:
        CHECK_EQ(fi.read_exact(8), _MAGIC, "not a dmlc_core_tpu checkpoint")
        header = json.loads(fi.read_exact(fi.read_u64()).decode("utf-8"))
        loaded = {}
        for leaf in header["leaves"]:
            dtype = np.dtype(leaf["dtype"])
            shape = tuple(leaf["shape"])
            nbytes = dtype.itemsize * int(np.prod(shape)) if shape else dtype.itemsize
            data = fi.read_exact(int(nbytes))
            loaded[leaf["path"]] = np.frombuffer(data, dtype=dtype).reshape(shape)
    if template is None:
        return loaded
    paths, values = tree_flatten(template)
    CHECK_EQ(len(paths), len(loaded), "checkpoint/template structure mismatch")
    new_values = []
    for p, v in zip(paths, values):
        CHECK(p in loaded, f"checkpoint missing leaf {p!r}")
        arr = loaded[p]
        CHECK_EQ(tuple(arr.shape),
                 tuple(v.shape) if hasattr(v, "shape") else np.shape(v),
                 f"shape mismatch for leaf {p!r}")
        new_values.append(arr)
    return tree_unflatten(template, new_values)


class AsyncCheckpointer:
    """Checkpoint writes in the background.

    ``save`` synchronously snapshots the tree to host memory (so the
    training step can immediately mutate its tensors) and hands the byte
    writing to a background thread.  At most one write is in flight; a
    second ``save`` first waits for the previous one.  Errors from the
    background write surface on the next ``save``/``wait_until_finished``
    call, carrying the failed URI.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_uri: Optional[str] = None

    def save(self, uri: str, tree: Any, on_durable=None) -> None:
        """Snapshot ``tree`` and write it in the background.

        ``on_durable`` (optional) runs on the writer thread only after the
        checkpoint bytes are fully committed, receiving the
        :func:`save_checkpoint` digest summary — the hook manifest
        publication and retention use, so older steps are never deleted
        (and the manifest never appears) while the write is in flight.
        """
        self.wait_until_finished()
        # snapshot on the caller's thread: the device->host copy completes
        # here, so the step loop may overwrite the tensors right away
        snapshot = _host_snapshot(tree)

        def _write():
            try:
                summary = save_checkpoint(uri, snapshot)
            except BaseException as e:  # ferried to the caller's thread
                self._error = e
                self._error_uri = uri
                return
            if on_durable is not None:
                try:
                    on_durable(summary)
                except BaseException as e:
                    # the checkpoint IS durable — a retention/hook failure
                    # must not masquerade as a write failure and block restore
                    log_warning(f"post-checkpoint hook for {uri!r} "
                                f"failed: {e}")

        # non-daemon: interpreter shutdown joins the writer, so a script that
        # exits right after save() still gets a complete final checkpoint
        self._thread = threading.Thread(target=_write,
                                        name="dmlc-ckpt-writer", daemon=False)
        self._thread.start()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, uri = self._error, self._error_uri
            self._error = self._error_uri = None
            raise RuntimeError(f"async checkpoint to {uri!r} failed") from err


def _host_snapshot(tree: Any) -> Any:
    # a real copy of every leaf: .cpu() of a CPU tensor and np.asarray of
    # an array alias the caller's memory, which the next step may overwrite
    # while the background write reads it
    return tree_map(lambda v: np.array(host_array(v), copy=True), tree)


class CheckpointManager:
    """Step-numbered checkpoints with retention and latest-step resume.

    Directory layout: ``{directory}/ckpt-{step:08d}`` over any
    URI-dispatched store.  ``keep`` bounds how many past steps are
    retained (retention deletes only on local paths; a warning is logged
    once for remote stores).  Every process restarts, finds
    ``latest_step()``, restores and continues.
    """

    _STEP_RE = re.compile(r"ckpt-(\d{8,})$")

    def __init__(self, directory: str, keep: int = 3):
        CHECK(keep >= 1, "keep must be >= 1")
        self.directory = directory.rstrip("/")
        self.keep = keep
        self._async = AsyncCheckpointer()
        # _retain runs on whatever thread made the step durable (the async
        # writer thread, a trainer's publish clock): the once-only
        # retention warning flag needs a lock like any shared write
        self._warn_lock = threading.Lock()
        self._warned_retention = False
        self._is_local = "://" not in directory or \
            directory.startswith("file://")

    def step_uri(self, step: int) -> str:
        return f"{self.directory}/ckpt-{step:08d}"

    # internal alias kept for call-site brevity
    _step_uri = step_uri

    def manifest_uri(self, step: int) -> str:
        return self.step_uri(step) + MANIFEST_SUFFIX

    def all_steps(self) -> List[int]:
        from dmlc_core_tpu_torch.io.filesys import URI, get_filesystem

        base = URI(self.directory)
        try:
            infos = get_filesystem(base).list_directory(base)
        except FileNotFoundError:
            return []          # directory not created yet = no checkpoints;
                               # other listing errors must propagate, not
                               # masquerade as "start fresh"
        steps = []
        for info in infos:
            m = self._STEP_RE.search(str(info.path))
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_valid(self, *, above: int = -1,
                     known_bad: Iterable[Tuple[int, Any]] = (),
                     verify: bool = False,
                     skip_unpublished: bool = False) \
            -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
        """The newest trustworthy step, manifest-first: ``(step, manifest)``
        or ``(None, None)``.

        Newest first, skipping every ``(step, crc32)`` pair in
        ``known_bad`` (the watcher's rejected-candidate ledger), and
        stopping at ``above`` exclusive.  A step without a parseable
        manifest stops the scan by default (its write may still be in
        flight); with ``skip_unpublished=True`` it is skipped instead (a
        resuming trainer knows the previous writer is dead).
        ``verify=True`` re-hashes each candidate's blob against its
        manifest and falls back past corrupt or truncated steps.
        """
        bad = set(known_bad)
        for step in reversed(self.all_steps()):
            if step <= above:
                return None, None
            manifest = self.read_manifest(step)
            if manifest is None:
                if skip_unpublished:
                    continue
                return None, None
            if (step, manifest.get("crc32")) in bad:
                continue
            if verify:
                try:
                    verify_checkpoint(self.step_uri(step), manifest)
                except Exception as e:
                    log_warning(f"checkpoint step {step} fails its "
                                f"manifest ({e}); falling back past it")
                    continue
            return step, manifest
        return None, None

    def prepare_step(self, step: int) -> str:
        """Make the step's URI writable and return it: ensure the local
        directory exists and sweep temp orphans a crashed previous writer
        of this step left behind (live writers' temps are skipped).  No-op
        on remote stores."""
        uri = self.step_uri(step)
        if self._is_local:
            os.makedirs(_strip_file_scheme(self.directory), exist_ok=True)
            _sweep_orphan_temps(_strip_file_scheme(uri))
        return uri

    def save(self, step: int, tree: Any, async_: bool = True) -> None:
        uri = self.prepare_step(step)
        if async_:
            # manifest + retention run on the writer thread only once the
            # new step is durable: publishing the manifest earlier would
            # point readers at in-flight bytes, and deleting older steps
            # before durability could leave zero restorable checkpoints
            self._async.save(uri, tree,
                             on_durable=lambda summary:
                             self._publish(step, summary))
        else:
            summary = save_checkpoint(uri, tree)
            self._publish(step, summary)
        log_info(f"checkpoint step {step} -> {uri}")

    def _publish(self, step: int, summary: Dict[str, Any]) -> None:
        """Write the step's manifest (the durable blob's digest), then run
        retention: a manifest-first reader never opens a checkpoint whose
        bytes are still in flight."""
        self.write_manifest(step, summary)
        self._retain(step)

    def publish(self, step: int, summary: Dict[str, Any]) -> None:
        """Publish a step an external writer already made durable (and
        verified): manifest-last + retention."""
        self._publish(step, summary)

    def write_manifest(self, step: int, summary: Dict[str, Any]) -> None:
        manifest = {
            "manifest_version": MANIFEST_VERSION,
            "step": int(step),
            "nbytes": int(summary["nbytes"]),
            "crc32": int(summary["crc32"]),
            "num_leaves": int(summary.get("num_leaves", 0)),
            # current wall time: every manifest a long trainer publishes
            # must carry its own timestamp
            "written_at": time.time(),
        }
        uri = self.manifest_uri(step)
        payload = json.dumps(manifest, sort_keys=True).encode("utf-8")
        target = uri
        if self._is_local:
            # same atomic temp+rename discipline as the blob: a torn
            # manifest must never validate (or invalidate) a good blob
            target = f"{uri}.tmp.{_temp_suffix()}"
        with create_stream(target, "w") as fo:
            fo.write(payload)
        if self._is_local:
            os.replace(_strip_file_scheme(target), _strip_file_scheme(uri))

    def read_manifest(self, step: int) -> Optional[Dict[str, Any]]:
        """The step's manifest dict, or ``None`` when it is absent or
        unparseable — both mean "do not trust this checkpoint yet" to a
        manifest-first reader (absent = the blob may still be writing)."""
        uri = self.manifest_uri(step)
        try:
            with (create_stream_for_read(uri) or create_stream(uri, "r")) as fi:
                chunks = []
                while True:
                    chunk = fi.read(1 << 16)
                    if not chunk:
                        break
                    chunks.append(chunk)
                raw = b"".join(chunks)
        except Exception:
            return None
        try:
            manifest = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            log_warning(f"checkpoint manifest {uri!r} unparseable ({e}); "
                        "treating the step as unpublished")
            return None
        if not isinstance(manifest, dict):
            log_warning(f"checkpoint manifest {uri!r} is not an object; "
                        "treating the step as unpublished")
            return None
        return manifest

    def restore(self, step: Optional[int] = None,
                template: Any = None) -> Any:
        self.wait_until_finished()
        if step is not None:
            return load_checkpoint(self._step_uri(step), template)
        steps = self.all_steps()
        CHECK(bool(steps), f"no checkpoints under {self.directory!r}")
        # newest first, falling back past corrupt/truncated files (a remote
        # store without atomic rename can expose a partial newest step)
        last_err: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                return load_checkpoint(self._step_uri(s), template)
            except Exception as e:
                log_warning(f"checkpoint step {s} unreadable ({e}); "
                            "falling back to previous step")
                last_err = e
        raise RuntimeError(
            f"all checkpoints under {self.directory!r} are unreadable"
        ) from last_err

    def wait_until_finished(self) -> None:
        self._async.wait_until_finished()

    def _retain(self, current_step: int) -> None:
        if not self._is_local:
            # retention only deletes local checkpoints; skip the (remote)
            # listing round-trip entirely on the hot save path
            with self._warn_lock:
                warn, self._warned_retention = \
                    not self._warned_retention, True
            if warn:
                log_warning("CheckpointManager retention only deletes local "
                            "checkpoints; remote steps are left in place")
            return
        # current_step is durable by the time retention runs; the union
        # guards against a lagging directory listing — only strictly older
        # steps are deleted
        steps = sorted(set(self.all_steps()) | {current_step})
        excess = [s for s in steps[:-self.keep] if s != current_step]
        for s in excess:
            path = _strip_file_scheme(self._step_uri(s))
            # manifest first: a step must never look published (manifest
            # present) after its blob is gone
            try:
                os.remove(path + MANIFEST_SUFFIX)
            except OSError:
                pass
            try:
                os.remove(path)
            except OSError:
                pass
            _sweep_orphan_temps(path)
