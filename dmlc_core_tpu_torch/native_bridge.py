"""The native ingest engine: C++ parsers and split engine, bound with ctypes.

Counterpart of ``dmlc_core_tpu/native_bridge.py``.  The library is compiled
at first use with ``g++ -O3 -std=c++17 -fPIC -shared -pthread`` from the
three sources under ``csrc/native/`` (``parsers.cc``, ``recordio.cc``,
``input_split.cc``) into ``build/native/libdmlc_torch_native.so`` under the
repository root (listed in ``.gitignore``).  It is rebuilt when a source is
newer than the library or when the library answers another ABI version.
Processes that start at once take an ``fcntl`` lock in ``build/native/``,
so one compiles and the others wait; the build writes a temporary file and
renames it into place.  The library is loaded ``RTLD_LOCAL``, under a file
name of its own.

There is no hidden fallback: when the compiler is missing or fails, the
first native call raises with the compiler's output.  The numpy engine runs
only when it is asked for, with ``DMLC_TPU_DISABLE_NATIVE`` set (read on
every call, see :func:`enabled`).  ``ENGINE_CALLS`` counts the calls into
the library by name, so a run can show which engine parsed and split.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["enabled", "load_library", "parse_libsvm", "parse_libfm",
           "parse_csv", "find_magic_positions", "recordio_scan",
           "recordio_extract", "recordio_frame", "READ_AT_FN",
           "NativeLineSplit", "NativeSpanReader", "NativeCacheReplay",
           "ENGINE_CALLS", "reset_engine_calls", "BUILD_INFO"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PKG, "csrc", "native")
SOURCES = ("parsers.cc", "recordio.cc", "input_split.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
LIBRARY_NAME = "libdmlc_torch_native.so"
# native/Makefile's CXXFLAGS, then its LDFLAGS
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread"]
LD_FLAGS = ["-shared", "-pthread"]
ABI = 5          # dmlc_tpu_abi_version() of the sources in SOURCE_DIR

# calls into the library, by name (chunk pops count one per chunk)
ENGINE_CALLS: Dict[str, int] = dict.fromkeys(
    ("parse_libsvm", "parse_libfm", "parse_csv", "find_magic_positions",
     "recordio_scan", "recordio_extract", "recordio_frame",
     "lsplit_next_chunk", "span_next_chunk", "creplay_next_chunk"), 0)

# what the last build did: seconds and the command, or cached=True
BUILD_INFO: Dict[str, object] = {}

# read-at callback signature: (ctx, file_idx, offset, buf, size) -> bytes
# read (0 = EOF), <0 = error.  Python implementations run on the native
# prefetch thread; ctypes acquires the GIL per call.
READ_AT_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_char), ctypes.c_int64)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """Whether the native engine is the one to take: True unless
    ``DMLC_TPU_DISABLE_NATIVE`` is set to a non-empty value."""
    return not os.environ.get("DMLC_TPU_DISABLE_NATIVE")


def reset_engine_calls() -> None:
    for key in ENGINE_CALLS:
        ENGINE_CALLS[key] = 0


def _count(name: str) -> None:
    ENGINE_CALLS[name] += 1


def library_path() -> str:
    return os.path.join(BUILD_DIR, LIBRARY_NAME)


def _sources():
    return [os.path.join(SOURCE_DIR, name) for name in SOURCES]


def _stale() -> bool:
    lib = library_path()
    if not os.path.isfile(lib):
        return True
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(src) > built for src in _sources())


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "dmlc_core_tpu_torch: g++ not found on PATH; the native ingest "
            "engine cannot be built (set DMLC_TPU_DISABLE_NATIVE=1 to ask "
            "for the numpy engine)")
    return cxx


def _compile() -> None:
    """Compile the sources into a temporary file and rename it into place;
    the caller holds the build lock."""
    cxx = _compiler()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, *LD_FLAGS, "-o", tmp, *_sources()]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except BaseException:
        os.unlink(tmp)
        raise
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"dmlc_core_tpu_torch: building the native ingest engine failed "
            f"({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n"
            f"{proc.stderr}")
    os.replace(tmp, library_path())
    BUILD_INFO.update(seconds=time.perf_counter() - start,
                      command=" ".join(cmd), cached=False)


class _BuildLock:
    """An exclusive ``flock`` on a file in the build directory: processes
    building at once wait for one build."""

    def __enter__(self):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self._f = open(os.path.join(BUILD_DIR, LIBRARY_NAME + ".lock"), "w")
        fcntl.flock(self._f, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._f, fcntl.LOCK_UN)
        self._f.close()


def _abi_of(lib: ctypes.CDLL) -> Optional[int]:
    fn = getattr(lib, "dmlc_tpu_abi_version", None)
    return None if fn is None else int(fn())


def _open_checked() -> ctypes.CDLL:
    """Load the library; on an ABI mismatch unlink it and rebuild once.

    The unlink comes before the rebuild: a loaded library stays mapped
    under its name, so the rebuilt one must be a new file (a new inode),
    never the old one rewritten in place."""
    lib = ctypes.CDLL(library_path())
    if _abi_of(lib) == ABI:
        return lib
    handle = lib._handle
    del lib
    import _ctypes

    _ctypes.dlclose(handle)
    with _BuildLock():
        lib = ctypes.CDLL(library_path())     # another process may have
        if _abi_of(lib) == ABI:               # rebuilt it meanwhile
            return lib
        _ctypes.dlclose(lib._handle)
        del lib
        try:
            os.unlink(library_path())
        except OSError:
            pass
        _compile()
    lib = ctypes.CDLL(library_path())
    if _abi_of(lib) != ABI:
        raise RuntimeError(
            f"dmlc_core_tpu_torch: {library_path()} answers ABI version "
            f"{_abi_of(lib)} after a rebuild, expected {ABI}")
    return lib


def load_library() -> ctypes.CDLL:
    """The bound library, built on first use; raises when the build
    fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with _BuildLock():
            if _stale():
                _compile()
            else:
                BUILD_INFO.setdefault("cached", True)
        _lib = _bind(_open_checked())
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, vp, i64p = ctypes.c_int64, ctypes.c_void_p, ctypes.POINTER(
        ctypes.c_int64)
    for name in ("dmlc_tpu_parse_libsvm", "dmlc_tpu_parse_libfm"):
        fn = getattr(lib, name)
        fn.restype = vp
        fn.argtypes = [ctypes.c_char_p, i64, ctypes.c_int]
    lib.dmlc_tpu_parse_csv.restype = vp
    lib.dmlc_tpu_parse_csv.argtypes = [ctypes.c_char_p, i64, ctypes.c_int,
                                       ctypes.c_float]
    lib.dmlc_tpu_result_dims.argtypes = [vp, i64p, i64p, i64p,
                                         ctypes.POINTER(ctypes.c_int32)]
    lib.dmlc_tpu_error_msg.restype = ctypes.c_char_p
    lib.dmlc_tpu_error_msg.argtypes = [vp]
    lib.dmlc_tpu_result_fill.argtypes = [vp] + [vp] * 6
    lib.dmlc_tpu_result_fill_csv.argtypes = [vp, i64, vp, vp]
    lib.dmlc_tpu_result_free.argtypes = [vp]
    lib.dmlc_tpu_find_magic.restype = i64
    lib.dmlc_tpu_find_magic.argtypes = [ctypes.c_char_p, i64,
                                        ctypes.c_uint32, vp, i64]
    lib.dmlc_tpu_recordio_scan.restype = vp
    lib.dmlc_tpu_recordio_scan.argtypes = [ctypes.c_char_p, i64, i64, i64]
    lib.dmlc_tpu_recordio_scan_dims.argtypes = [vp] + [i64p] * 3
    lib.dmlc_tpu_recordio_scan_error.restype = ctypes.c_char_p
    lib.dmlc_tpu_recordio_scan_error.argtypes = [vp]
    lib.dmlc_tpu_recordio_scan_fill.argtypes = [vp] + [vp] * 3
    lib.dmlc_tpu_recordio_scan_free.argtypes = [vp]
    lib.dmlc_tpu_recordio_extract.restype = i64
    lib.dmlc_tpu_recordio_extract.argtypes = [ctypes.c_char_p, i64, i64, vp,
                                              i64]
    lib.dmlc_tpu_recordio_frame.restype = vp
    lib.dmlc_tpu_recordio_frame.argtypes = [ctypes.c_char_p, vp, i64]
    lib.dmlc_tpu_frame_dims.argtypes = [vp] + [i64p] * 3
    lib.dmlc_tpu_frame_error.restype = ctypes.c_char_p
    lib.dmlc_tpu_frame_error.argtypes = [vp]
    lib.dmlc_tpu_frame_fill.argtypes = [vp, vp, vp]
    lib.dmlc_tpu_frame_free.argtypes = [vp]

    # the split engine (native/input_split.cc); a NULL read-at callback
    # reads local files with FILE*
    open_sig = [ctypes.c_char_p, i64p, i64p, i64, i64, i64, i64]
    lib.dmlc_tpu_lsplit_open2.restype = vp
    lib.dmlc_tpu_lsplit_open2.argtypes = open_sig + [
        i64, i64, ctypes.c_char_p, READ_AT_FN, vp]
    lib.dmlc_tpu_lsplit_finish_cache.restype = i64
    lib.dmlc_tpu_lsplit_finish_cache.argtypes = [vp]
    lib.dmlc_tpu_creplay_open.restype = vp
    lib.dmlc_tpu_creplay_open.argtypes = [ctypes.c_char_p]
    lib.dmlc_tpu_creplay_reset.argtypes = [vp]
    lib.dmlc_tpu_creplay_next_chunk.restype = i64
    lib.dmlc_tpu_creplay_next_chunk.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p)]
    lib.dmlc_tpu_creplay_error.restype = ctypes.c_char_p
    lib.dmlc_tpu_creplay_error.argtypes = [vp]
    lib.dmlc_tpu_creplay_close.argtypes = [vp]
    lib.dmlc_tpu_span_open2.restype = vp
    lib.dmlc_tpu_span_open2.argtypes = open_sig[:4] + [READ_AT_FN, vp]
    lib.dmlc_tpu_span_set_plan.argtypes = [vp, i64p, i64p, i64p, i64, i64]
    lib.dmlc_tpu_span_next_chunk.restype = i64
    lib.dmlc_tpu_span_next_chunk.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p)]
    lib.dmlc_tpu_span_error.restype = ctypes.c_char_p
    lib.dmlc_tpu_span_error.argtypes = [vp]
    lib.dmlc_tpu_span_close.argtypes = [vp]
    lib.dmlc_tpu_lsplit_hint.argtypes = [vp, i64]
    lib.dmlc_tpu_lsplit_total.restype = i64
    lib.dmlc_tpu_lsplit_total.argtypes = [vp]
    lib.dmlc_tpu_lsplit_reset.argtypes = [vp, i64, i64]
    lib.dmlc_tpu_lsplit_next_chunk.restype = i64
    lib.dmlc_tpu_lsplit_next_chunk.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p)]
    lib.dmlc_tpu_lsplit_next_chunks.restype = i64
    lib.dmlc_tpu_lsplit_next_chunks.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p), i64p, i64]
    lib.dmlc_tpu_lsplit_error.restype = ctypes.c_char_p
    lib.dmlc_tpu_lsplit_error.argtypes = [vp]
    lib.dmlc_tpu_lsplit_close.argtypes = [vp]
    return lib


def _ptr(arr: Optional[np.ndarray]):
    if arr is None or arr.size == 0:
        return None
    return arr.ctypes.data_as(ctypes.c_void_p)


def _as_data_ptr(data):
    """bytes -> (bytes, len); (addr, len) -> zero-copy pointer pass.

    The (addr, len) form is the native split's fast path: the chunk stays
    in the split handle's buffer (valid until its next call) and the parser
    reads it in place, with no Python bytes between the two C++ stages.
    """
    if isinstance(data, tuple):
        addr, length = data
        return ctypes.c_char_p(addr), length
    return data, len(data)


def _parse_sparse(name: str, data, nthread: int):
    lib = load_library()
    _count(name)
    ptr, length = _as_data_ptr(data)
    handle = getattr(lib, "dmlc_tpu_" + name)(ptr, length, nthread)
    try:
        n_rows = ctypes.c_int64()
        nnz = ctypes.c_int64()
        n_cols = ctypes.c_int64()
        flags = ctypes.c_int32()
        lib.dmlc_tpu_result_dims(handle, ctypes.byref(n_rows),
                                 ctypes.byref(nnz), ctypes.byref(n_cols),
                                 ctypes.byref(flags))
        if n_rows.value < 0:
            raise ValueError(lib.dmlc_tpu_error_msg(handle).decode())
        nr, nz, fl = n_rows.value, nnz.value, flags.value
        offset = np.empty(nr + 1, dtype=np.int64)
        label = np.empty(nr, dtype=np.float32)
        weight = np.empty(nr, dtype=np.float32) if (fl & 1) else None
        index = np.empty(nz, dtype=np.uint32)
        field = np.empty(nz, dtype=np.uint32) if (fl & 4) else None
        value = np.empty(nz, dtype=np.float32) if (fl & 2) else None
        lib.dmlc_tpu_result_fill(handle, _ptr(offset), _ptr(label),
                                 _ptr(weight), _ptr(index), _ptr(field),
                                 _ptr(value), None)
        return offset, label, weight, index, field, value
    finally:
        lib.dmlc_tpu_result_free(handle)


def parse_libsvm(data, nthread: int = 4):
    """Chunk (bytes or zero-copy ``(addr, len)``) ->
    (offset, label, weight|None, index, value|None)."""
    offset, label, weight, index, _, value = _parse_sparse(
        "parse_libsvm", data, nthread)
    return offset, label, weight, index, value


def parse_libfm(data, nthread: int = 4):
    """Chunk (bytes or zero-copy ``(addr, len)``) ->
    (offset, label, weight|None, index, field, value)."""
    return _parse_sparse("parse_libfm", data, nthread)


def parse_csv(data, nthread: int = 4, missing: float = 0.0,
              label_column: int = -1):
    """Chunk (bytes or zero-copy ``(addr, len)``) -> parsed CSV floats.

    With ``label_column`` out of range (default) returns the dense
    ``[n_rows, n_cols]`` float32 block.  With ``0 <= label_column <
    n_cols`` returns ``(labels, feats)``, split in one C pass
    (``dmlc_tpu_result_fill_csv``).  ``missing`` fills empty cells.
    """
    lib = load_library()
    _count("parse_csv")
    ptr, length = _as_data_ptr(data)
    handle = lib.dmlc_tpu_parse_csv(ptr, length, nthread,
                                    ctypes.c_float(missing))
    try:
        n_rows = ctypes.c_int64()
        nnz = ctypes.c_int64()
        n_cols = ctypes.c_int64()
        flags = ctypes.c_int32()
        lib.dmlc_tpu_result_dims(handle, ctypes.byref(n_rows),
                                 ctypes.byref(nnz), ctypes.byref(n_cols),
                                 ctypes.byref(flags))
        if n_rows.value < 0:
            raise ValueError(lib.dmlc_tpu_error_msg(handle).decode())
        if 0 <= label_column < n_cols.value:
            labels = np.empty(n_rows.value, dtype=np.float32)
            feats = np.empty((n_rows.value, n_cols.value - 1),
                             dtype=np.float32)
            lib.dmlc_tpu_result_fill_csv(handle, label_column, _ptr(labels),
                                         _ptr(feats.reshape(-1)))
            return labels, feats
        dense = np.empty((n_rows.value, n_cols.value), dtype=np.float32)
        lib.dmlc_tpu_result_fill(handle, None, None, None, None, None, None,
                                 _ptr(dense.reshape(-1)))
        return dense
    finally:
        lib.dmlc_tpu_result_free(handle)


def find_magic_positions(data: bytes, magic: int, limit: int) -> np.ndarray:
    """Aligned magic-word byte offsets (the RecordIO writer's escape scan)."""
    lib = load_library()
    _count("find_magic_positions")
    out = np.empty(limit, dtype=np.int64)
    n = lib.dmlc_tpu_find_magic(data, len(data), magic, _ptr(out), limit)
    return out[:min(n, limit)]


def recordio_scan(data: bytes, begin: int, end: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """One-pass record scan of a chunk partition.

    Returns ``(head, plen, escaped, pbegin, pend)``: per-record head byte
    offsets, logical payload lengths, escaped flags, and the resynced
    partition bounds (reference RecordIOChunkReader, src/recordio.cc:102-156).
    """
    lib = load_library()
    _count("recordio_scan")
    handle = lib.dmlc_tpu_recordio_scan(data, len(data), begin, end)
    try:
        n = ctypes.c_int64()
        pbegin = ctypes.c_int64()
        pend = ctypes.c_int64()
        lib.dmlc_tpu_recordio_scan_dims(handle, ctypes.byref(n),
                                        ctypes.byref(pbegin),
                                        ctypes.byref(pend))
        if n.value < 0:
            raise ValueError(lib.dmlc_tpu_recordio_scan_error(handle).decode())
        head = np.empty(n.value, dtype=np.int64)
        plen = np.empty(n.value, dtype=np.int64)
        escaped = np.empty(n.value, dtype=np.uint8)
        lib.dmlc_tpu_recordio_scan_fill(handle, _ptr(head), _ptr(plen),
                                        _ptr(escaped))
        return head, plen, escaped, pbegin.value, pend.value
    finally:
        lib.dmlc_tpu_recordio_scan_free(handle)


def recordio_extract(data: bytes, head: int, length: int) -> bytes:
    """Reassemble one (escaped) record whose head is at byte offset ``head``;
    ``length`` is its logical payload length from a prior scan."""
    lib = load_library()
    _count("recordio_extract")
    out = np.empty(length, dtype=np.uint8)
    got = lib.dmlc_tpu_recordio_extract(data, len(data), head, _ptr(out),
                                        length)
    if got < 0:
        raise ValueError("invalid RecordIO format: bad record head")
    return out[:got].tobytes()


def recordio_frame(payloads: bytes, lens: np.ndarray
                   ) -> Tuple[memoryview, np.ndarray, int]:
    """Batch-encode concatenated payloads into RecordIO framing.

    Returns ``(framed, offsets, except_count)``: ``framed`` is a memoryview
    over a freshly filled buffer and ``offsets[i]`` the start of record i
    within it (reference writer, recordio.cc:11-51).
    """
    lib = load_library()
    _count("recordio_frame")
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    handle = lib.dmlc_tpu_recordio_frame(payloads, _ptr(lens), len(lens))
    try:
        size = ctypes.c_int64()
        n_off = ctypes.c_int64()
        nexc = ctypes.c_int64()
        lib.dmlc_tpu_frame_dims(handle, ctypes.byref(size),
                                ctypes.byref(n_off), ctypes.byref(nexc))
        if size.value < 0:
            raise ValueError(lib.dmlc_tpu_frame_error(handle).decode())
        out = np.empty(size.value, dtype=np.uint8)
        offsets = np.empty(n_off.value, dtype=np.int64)
        lib.dmlc_tpu_frame_fill(handle, _ptr(out), _ptr(offsets))
        return memoryview(out).cast("B"), offsets, nexc.value
    finally:
        lib.dmlc_tpu_frame_free(handle)


# ---- the split engine (csrc/native/input_split.cc) --------------------------

def _encode_files(paths, sizes):
    encoded = [p.encode() for p in paths]
    blob = b"".join(encoded)         # length-delimited: any filename byte ok
    lens = (ctypes.c_int64 * len(encoded))(*[len(e) for e in encoded])
    arr = (ctypes.c_int64 * len(sizes))(*sizes)
    return blob, lens, arr


class NativeLineSplit:
    """Handle over the C++ split engine (sharded read + prefetch thread).

    ``next_chunk`` returns bytes of whole records for the partition, or
    None at the end.  ``reset`` re-partitions (or rewinds, with the same
    arguments).  ``format`` selects the record kind: "line" or "recordio"
    (same engine, another realignment scan).

    ``read_at`` (a ``READ_AT_FN``-compatible callable) routes all byte
    reads through Python: the remote-filesystem path.  ``cache_path`` tees
    epoch-1 chunks into a cache file (``finish_cache`` closes it,
    :class:`NativeCacheReplay` replays it).

    ``ring`` is the native prefetch-queue depth.  2 is the classic double
    buffer; deeper rings pre-post more read-ahead and switch the consumer
    to the batched ``next_chunks`` pop: one Python-to-C crossing (one GIL
    round trip) drains everything the ring had buffered, which amortizes
    the per-chunk crossing on the remote callback path.
    """

    def __init__(self, paths, sizes, part: int, nparts: int,
                 buffer_size: int = 8 << 20, format: str = "line",
                 read_at=None, cache_path: Optional[str] = None,
                 ring: int = 2):
        lib = load_library()
        self._lib = lib
        self._handle = None
        self._ring = max(2, int(ring))
        # batched-pop state: arrays the C side fills in one crossing, and
        # the views not yet handed back from the last fill (addr, len)
        self._batch_ptrs = (ctypes.c_char_p * self._ring)()
        self._batch_lens = (ctypes.c_int64 * self._ring)()
        self._pending: list = []
        blob, lens, arr = _encode_files(paths, sizes)
        # the CFUNCTYPE object must outlive the handle (the prefetch thread
        # calls through it); keep the reference on self
        if read_at is not None and not isinstance(read_at, READ_AT_FN):
            read_at = READ_AT_FN(read_at)
        self._read_at = read_at
        self._handle = lib.dmlc_tpu_lsplit_open2(
            blob, lens, arr, len(sizes), part, nparts, buffer_size,
            1 if format == "recordio" else 0, self._ring,
            cache_path.encode() if cache_path else None,
            self._read_at if self._read_at is not None
            else ctypes.cast(None, READ_AT_FN), None)
        self._check()

    def finish_cache(self) -> None:
        """Drain the rest of the partition through the cache tee and close
        the cache file (the preproc finish of the cached split)."""
        if self._lib.dmlc_tpu_lsplit_finish_cache(self._require_open()) != 0:
            self._check()

    def _require_open(self):
        if self._handle is None:
            raise ValueError("NativeLineSplit is closed")
        return self._handle

    def _check(self):
        err = self._lib.dmlc_tpu_lsplit_error(self._require_open())
        if err:
            raise OSError(err.decode())

    def total_size(self) -> int:
        return self._lib.dmlc_tpu_lsplit_total(self._require_open())

    def reset(self, part: int, nparts: int) -> None:
        self._pending.clear()   # views into pre-reset chunks are stale
        self._lib.dmlc_tpu_lsplit_reset(self._require_open(), part, nparts)
        self._check()

    def hint_chunk_size(self, chunk_size: int) -> None:
        """Grow the typical chunk size; read position is unaffected."""
        self._lib.dmlc_tpu_lsplit_hint(self._require_open(), chunk_size)

    def next_chunk(self):
        view = self.next_chunk_view()
        if view is None:
            return None
        return ctypes.string_at(*view)

    def next_chunk_view(self):
        """Zero-copy ``(addr, len)`` over the next chunk, valid at least
        until the crossing after the batch it came from drains (with the
        default ``ring=2``: until the next call; the parser's fast path
        consumes it in place before popping again).

        With ``ring > 2`` one batched ``next_chunks`` crossing drains
        everything the native ring had buffered, and later calls serve from
        that batch without crossing into C."""
        if self._ring > 2:
            if not self._pending:
                n = self._lib.dmlc_tpu_lsplit_next_chunks(
                    self._require_open(), self._batch_ptrs, self._batch_lens,
                    self._ring)
                if n < 0:
                    self._check()
                if n <= 0:
                    return None
                ptrs = ctypes.cast(self._batch_ptrs,
                                   ctypes.POINTER(ctypes.c_void_p))
                self._pending = [(ptrs[i], self._batch_lens[i])
                                 for i in range(n)]
            _count("lsplit_next_chunk")
            return self._pending.pop(0)
        ptr = ctypes.c_char_p()
        n = self._lib.dmlc_tpu_lsplit_next_chunk(self._require_open(),
                                                 ctypes.byref(ptr))
        if n < 0:
            self._check()
        if n <= 0:
            return None
        _count("lsplit_next_chunk")
        return ctypes.cast(ptr, ctypes.c_void_p).value, n

    def close(self) -> None:
        self._pending.clear()   # batched views die with the handle
        if self._handle is not None:
            self._lib.dmlc_tpu_lsplit_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeSpanReader:
    """C++ span-plan reader: index-driven batch reads with prefetch.

    The caller (``IndexedRecordIOSplitter``) computes a per-epoch plan, flat
    (offset, size) spans in the concatenated-file space plus per-batch span
    counts, and pops concatenated batch chunks; a native producer thread
    reads ahead (``SpanReadEngine``).  ``read_at`` routes the byte reads
    through Python, as on :class:`NativeLineSplit`.
    """

    def __init__(self, paths, sizes, read_at=None):
        lib = load_library()
        self._lib = lib
        self._handle = None
        blob, lens, arr = _encode_files(paths, sizes)
        if read_at is not None and not isinstance(read_at, READ_AT_FN):
            read_at = READ_AT_FN(read_at)
        self._read_at = read_at  # keep alive for the prefetch thread
        self._handle = lib.dmlc_tpu_span_open2(
            blob, lens, arr, len(sizes),
            self._read_at if self._read_at is not None
            else ctypes.cast(None, READ_AT_FN), None)

    def _require_open(self):
        if self._handle is None:
            raise ValueError("NativeSpanReader is closed")
        return self._handle

    def _check(self):
        err = self._lib.dmlc_tpu_span_error(self._require_open())
        if err:
            raise OSError(err.decode())

    def set_plan(self, offsets, sizes, counts) -> None:
        """Start a new epoch: spans (offsets[i], sizes[i]); batch b is the
        concatenation of counts[b] consecutive spans."""
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        szs = np.ascontiguousarray(sizes, dtype=np.int64)
        cnt = np.ascontiguousarray(counts, dtype=np.int64)
        assert len(offs) == len(szs)
        self._lib.dmlc_tpu_span_set_plan(
            self._require_open(),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            szs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offs), len(cnt))

    def next_chunk(self):
        ptr = ctypes.c_char_p()
        n = self._lib.dmlc_tpu_span_next_chunk(self._require_open(),
                                               ctypes.byref(ptr))
        if n < 0:
            self._check()
        if n <= 0:
            return None
        _count("span_next_chunk")
        return ctypes.string_at(ptr, n)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dmlc_tpu_span_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeCacheReplay:
    """Replays a (u64-LE length, chunk)-framed cache file with native
    read-ahead: epoch N of the cached split (``CacheReplayEngine``; the
    frame format is the Python cache writer's)."""

    def __init__(self, path: str):
        lib = load_library()
        self._lib = lib
        self._handle = None
        self._handle = lib.dmlc_tpu_creplay_open(path.encode())
        self._check()

    def _require_open(self):
        if self._handle is None:
            raise ValueError("NativeCacheReplay is closed")
        return self._handle

    def _check(self):
        err = self._lib.dmlc_tpu_creplay_error(self._require_open())
        if err:
            raise OSError(err.decode())

    def reset(self) -> None:
        """Rewind to the first frame (epoch boundary)."""
        self._lib.dmlc_tpu_creplay_reset(self._require_open())
        self._check()

    def next_chunk(self):
        view = self.next_chunk_view()
        if view is None:
            return None
        return ctypes.string_at(*view)

    def next_chunk_view(self):
        """Zero-copy ``(addr, len)``, valid until the next call."""
        ptr = ctypes.c_char_p()
        n = self._lib.dmlc_tpu_creplay_next_chunk(self._require_open(),
                                                  ctypes.byref(ptr))
        if n < 0:
            self._check()
        if n <= 0:
            return None
        _count("creplay_next_chunk")
        return ctypes.cast(ptr, ctypes.c_void_p).value, n

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dmlc_tpu_creplay_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
