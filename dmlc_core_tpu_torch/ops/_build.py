"""Build the kernels of ``csrc/`` with ``nvcc`` and bind them with ``ctypes``.

The library is compiled at first use from every ``csrc/*.cu`` in the
checkout (one ``nvcc`` call) into ``build/torch_kernels/libdmlc_hist.so``
under the repository root (listed in ``.gitignore``; the name is the first
kernel's, and the one library holds every source's entries, the traversal
kernel's of ``predict.cu`` too, with one error-string entry,
``dmlc_hist_error_string``, for all of them), and rebuilt when any
``csrc/*.cu`` or ``csrc/*.cuh`` is newer than the library.  The sources
have a plain C interface and include no PyTorch header, so the build takes
seconds.  Nothing here runs at import time: the CPU tests import
every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

__all__ = ["load_library", "BUILD_INFO", "SOURCE", "LIBRARY", "sources",
           "stale"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCE = os.path.join(CSRC, "hist.cu")     # the histogram kernels
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIBRARY = os.path.join(BUILD_DIR, "libdmlc_hist.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# what the last build did: seconds, the nvcc command and its -Xptxas -v
# report (registers, shared memory, spills), or cached=True
BUILD_INFO: Dict[str, object] = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def sources(csrc: str = CSRC) -> List[str]:
    """The translation units the library is compiled from."""
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def stale(library: str = LIBRARY, csrc: str = CSRC) -> bool:
    """Whether ``library`` is missing or older than a source or header."""
    if not os.path.isfile(library):
        return True
    built = os.path.getmtime(library)
    return any(os.path.getmtime(f) > built
               for pat in ("*.cu", "*.cuh")
               for f in glob.glob(os.path.join(csrc, pat)))


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    srcs = sources()
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {srcs}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    BUILD_INFO.update(seconds=seconds, command=" ".join(cmd),
                      ptxas=proc.stderr + proc.stdout, cached=False)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # every pointer and the stream are c_void_p: without argtypes ctypes
    # would pass Python ints as 32-bit C ints and cut the pointers
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dmlc_hist_tile.argtypes = []
    lib.dmlc_hist_tile.restype = i
    lib.dmlc_hist_error_string.argtypes = [i]
    lib.dmlc_hist_error_string.restype = ctypes.c_char_p
    # dmlc_hist_matmul(w, bins, bins_u8, num_rows, num_feature, ld_bins,
    #   f_offset, m_total, num_bins, ld_w, rows_per_chunk, n_chunks,
    #   partial, out, stream)
    lib.dmlc_hist_matmul.argtypes = [p, p, i, ll, i, i, i, i, i, i, ll, i,
                                     p, p, p]
    lib.dmlc_hist_matmul.restype = i
    # dmlc_grad_hist_fused(bins, bins_u8, node, grad, hess, rows, offsets,
    #   num_rows, num_feature, ld_bins, f_offset, num_nodes, num_bins,
    #   rows_per_chunk, n_chunks, partial, out, stream)
    lib.dmlc_grad_hist_fused.argtypes = [p, i, p, p, p, p, p, ll, i, i, i, i,
                                         i, ll, i, p, p, p]
    lib.dmlc_grad_hist_fused.restype = i
    # dmlc_row_partition(node, num_rows, num_nodes, parts, rows_per_part,
    #   rows_out, counts, offsets, stream)
    lib.dmlc_row_partition.argtypes = [p, ll, i, i, ll, p, p, p, p]
    lib.dmlc_row_partition.restype = i
    # predict.cu: dmlc_predict_margin(bins, bins_u8, num_rows, num_feature,
    #   split_feat, split_bin, default_left, leaf_value, num_trees,
    #   num_class, depth, miss_id, base, bins_smem, trees_per_tile, packed,
    #   out, stream)
    lib.dmlc_predict_rows.argtypes = []
    lib.dmlc_predict_rows.restype = i
    lib.dmlc_predict_margin.argtypes = [p, i, ll, i, p, p, p, p, i, i, i, i,
                                        ctypes.c_float, i, i, p, p, p]
    lib.dmlc_predict_margin.restype = i
    return lib


def load_library() -> ctypes.CDLL:
    """The bound kernel library, built on first use; raises when the
    build fails."""
    global _lib
    with _lock:
        if _lib is None:
            if stale():
                _build()
            else:
                BUILD_INFO.setdefault("cached", True)
            _lib = _bind(ctypes.CDLL(LIBRARY))
        return _lib
