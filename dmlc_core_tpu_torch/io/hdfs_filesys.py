"""hdfs:// filesystem, gated on pyarrow's libhdfs bindings.

The reference wraps libhdfs via JNI behind the DMLC_USE_HDFS compile flag
(src/io/hdfs_filesys.{h,cc}); the rebuild gates at import: when
``pyarrow.fs.HadoopFileSystem`` (which drives the same libhdfs) is available
it backs the Stream contract, otherwise any hdfs:// access raises an
actionable error — matching the reference's "compiled without HDFS" failure
mode (src/io.cc:38-42).

Counterpart of ``dmlc_core_tpu/io/hdfs_filesys.py`` (a copy).
"""

from __future__ import annotations

from typing import List

from dmlc_core_tpu_torch.io import filesys as fsys
from dmlc_core_tpu_torch.io import fs_metrics
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream
from dmlc_core_tpu_torch.registry import Registry
from dmlc_core_tpu_torch.utils.logging import CHECK, log_fatal

__all__ = ["HDFSFileSystem"]


def _arrow_fs(uri: fsys.URI):
    try:
        from pyarrow import fs as pafs  # type: ignore
    except ImportError:
        log_fatal(
            "hdfs:// support requires pyarrow with libhdfs (the reference "
            "gates the same way with DMLC_USE_HDFS, src/io.cc:38-42); "
            "install pyarrow + a Hadoop client, or use file:///gs:///s3://")
    host = uri.host or "default"
    if ":" in host:
        name, port = host.rsplit(":", 1)
        return pafs.HadoopFileSystem(name, int(port))
    return pafs.HadoopFileSystem(host)


class _ArrowStream(SeekStream):
    def __init__(self, f, writable: bool):
        self._f = f
        self._writable = writable

    def read(self, nbytes: int) -> bytes:
        t0 = fs_metrics.request_start()
        data = self._f.read(nbytes)
        fs_metrics.note_request("hdfs", "read", t0, nread=len(data))
        return data

    def write(self, data: bytes) -> None:
        CHECK(self._writable, "stream opened read-only")
        t0 = fs_metrics.request_start()
        self._f.write(data)
        fs_metrics.note_request("hdfs", "write", t0, nwritten=len(data))

    def seek(self, pos: int) -> None:
        self._f.seek(pos)

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.close()


class HDFSFileSystem(fsys.FileSystem):
    def get_path_info(self, path: fsys.URI) -> fsys.FileInfo:
        from pyarrow import fs as pafs  # type: ignore

        hdfs = _arrow_fs(path)
        info = hdfs.get_file_info(path.name)
        if info.type == pafs.FileType.NotFound:
            raise FileNotFoundError(path.str())
        ftype = (fsys.FileType.DIRECTORY
                 if info.type == pafs.FileType.Directory else fsys.FileType.FILE)
        return fsys.FileInfo(path.copy(), info.size or 0, ftype)

    def list_directory(self, path: fsys.URI) -> List[fsys.FileInfo]:
        from pyarrow import fs as pafs  # type: ignore

        hdfs = _arrow_fs(path)
        sel = pafs.FileSelector(path.name)
        out = []
        for info in hdfs.get_file_info(sel):
            sub = path.copy()
            sub.name = info.path
            ftype = (fsys.FileType.DIRECTORY
                     if info.type == pafs.FileType.Directory
                     else fsys.FileType.FILE)
            out.append(fsys.FileInfo(sub, info.size or 0, ftype))
        return out

    def open(self, path: fsys.URI, mode: str) -> Stream:
        hdfs = _arrow_fs(path)
        if mode == "r":
            return _ArrowStream(hdfs.open_input_file(path.name), False)
        if mode == "w":
            return _ArrowStream(hdfs.open_output_stream(path.name), True)
        return _ArrowStream(hdfs.open_append_stream(path.name), True)

    def delete(self, path: fsys.URI) -> None:
        # hdfs writes stream THROUGH to the target (no abort/commit point),
        # so abandoning a half-written file means deleting it
        _arrow_fs(path).delete_file(path.name)

    def open_for_read(self, path: fsys.URI) -> SeekStream:
        hdfs = _arrow_fs(path)
        return _ArrowStream(hdfs.open_input_file(path.name), False)


Registry.get("filesystem").add("hdfs", HDFSFileSystem,
                               description="HDFS via pyarrow/libhdfs (gated)")
