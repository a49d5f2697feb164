"""URI parsing + virtual filesystem dispatch + local filesystem.

Counterpart of ``dmlc_core_tpu/io/filesys.py`` (a copy): ``URI``,
``FileInfo``, ``FileSystem``, protocol dispatch and the local filesystem.
Filesystems register themselves in the ``"filesystem"`` registry keyed by
protocol (``file``, ``s3``, ``gs``, ``http`` ...), so the remote backends
(:mod:`.s3_filesys`, :mod:`.http_filesys`, :mod:`.hdfs_filesys`,
:mod:`.azure_filesys`) plug in without touching this module.
"""

from __future__ import annotations

import enum
import os
import stat as statmod
import sys
from typing import List

from dmlc_core_tpu_torch.registry import Registry
from dmlc_core_tpu_torch.io.stream import SeekStream, Stream
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = [
    "URI",
    "FileInfo",
    "FileType",
    "FileSystem",
    "get_filesystem",
    "LocalFileSystem",
]


class URI:
    """``protocol://host/path`` split (reference filesys.h:18-52).

    - no ``://`` -> protocol is ``file://``, whole string is the name;
    - otherwise host is the segment before the next '/', name the remainder
      (for ``file://`` the host is empty and the name absolute).
    """

    def __init__(self, uri: str = ""):
        self.protocol = ""
        self.host = ""
        self.name = ""
        if not uri:
            return
        idx = uri.find("://")
        if idx < 0:
            self.protocol = "file://"
            self.name = uri
        else:
            self.protocol = uri[: idx + 3]
            rest = uri[idx + 3:]
            slash = rest.find("/")
            if slash < 0:
                self.host, self.name = rest, ""
            else:
                self.host, self.name = rest[:slash], rest[slash:]
            if self.protocol == "file://":
                # file://host is not meaningful; treat everything as the path
                self.name = rest if not rest.startswith("/") else rest
                self.host = ""

    def str(self) -> str:
        if self.protocol in ("", "file://"):
            return self.name
        return f"{self.protocol}{self.host}{self.name}"

    def __str__(self) -> str:
        return self.str()

    def __repr__(self) -> str:
        return f"URI({self.str()!r})"

    def copy(self) -> "URI":
        out = URI()
        out.protocol, out.host, out.name = self.protocol, self.host, self.name
        return out


class FileType(enum.Enum):
    FILE = 0
    DIRECTORY = 1


class FileInfo:
    """Metadata for one path (reference filesys.h:63-72)."""

    def __init__(self, path: URI, size: int = 0, type: FileType = FileType.FILE):
        self.path = path
        self.size = size
        self.type = type

    def __repr__(self) -> str:
        return f"FileInfo({self.path.str()!r}, size={self.size}, type={self.type.name})"


class FileSystem:
    """Abstract filesystem (reference filesys.h:75-118)."""

    def get_path_info(self, path: URI) -> FileInfo:
        raise NotImplementedError

    def list_directory(self, path: URI) -> List[FileInfo]:
        raise NotImplementedError

    def open(self, path: URI, mode: str) -> Stream:
        """Open for "r"/"w"/"a"."""
        raise NotImplementedError

    def open_for_read(self, path: URI) -> SeekStream:
        raise NotImplementedError


_fs_registry = Registry.get("filesystem")


def get_filesystem(uri: URI) -> FileSystem:
    """Protocol dispatch (reference FileSystem::GetInstance, src/io.cc:31-60)."""
    proto = uri.protocol or "file://"
    key = proto[:-3] if proto.endswith("://") else proto
    entry = _fs_registry.find(key)
    CHECK(entry is not None,
          f"unknown filesystem protocol {proto!r}; known: {_fs_registry.list_names()}. "
          f"(remote backends such as hdfs:// must be enabled/registered first)")
    return entry()


class _LocalFileStream(SeekStream):
    """stdio-backed stream (reference local_filesys.cc:28-60)."""

    def __init__(self, fileobj, seekable: bool = True):
        self._f = fileobj
        self._seekable = seekable

    def read(self, nbytes: int) -> bytes:
        return self._f.read(nbytes)

    def write(self, data: bytes) -> None:
        self._f.write(data)

    def seek(self, pos: int) -> None:
        CHECK(self._seekable, "stream is not seekable")
        self._f.seek(pos)

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        if self._f not in (getattr(sys.stdin, "buffer", None),
                           getattr(sys.stdout, "buffer", None)):
            self._f.close()


class LocalFileSystem(FileSystem):
    """Local disk implementation (reference src/io/local_filesys.cc:28-160)."""

    _instance: "LocalFileSystem" = None

    def __new__(cls) -> "LocalFileSystem":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def get_path_info(self, path: URI) -> FileInfo:
        st = os.stat(path.name)
        ftype = FileType.DIRECTORY if statmod.S_ISDIR(st.st_mode) else FileType.FILE
        return FileInfo(path.copy(), size=st.st_size, type=ftype)

    def list_directory(self, path: URI) -> List[FileInfo]:
        out: List[FileInfo] = []
        base = path.name
        for entry in sorted(os.scandir(base), key=lambda e: e.name):
            sub = path.copy()
            sub.name = os.path.join(base, entry.name)
            st = entry.stat()
            ftype = FileType.DIRECTORY if entry.is_dir() else FileType.FILE
            out.append(FileInfo(sub, size=st.st_size, type=ftype))
        return out

    def open(self, path: URI, mode: str) -> Stream:
        CHECK(mode in ("r", "w", "a"), f"invalid mode {mode!r}")
        # '-' means stdin/stdout (reference local_filesys.cc:129-150)
        if path.name == "-":
            if mode == "r":
                return _LocalFileStream(sys.stdin.buffer, seekable=False)
            return _LocalFileStream(sys.stdout.buffer, seekable=False)
        return _LocalFileStream(open(path.name, mode + "b"))

    def open_for_read(self, path: URI) -> SeekStream:
        return _LocalFileStream(open(path.name, "rb"))

    def delete(self, path: URI) -> None:
        os.unlink(path.name)


_fs_registry.add("file", LocalFileSystem, description="local disk (default protocol)")
