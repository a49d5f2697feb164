"""Any-URI filesystem CLI (the reference's filesys_test harness as an
operator tool, test/filesys_test.cc:8-40):

    python -m dmlc_core_tpu_torch.io ls  <uri>
    python -m dmlc_core_tpu_torch.io cat <uri>
    python -m dmlc_core_tpu_torch.io cp  <src-uri> <dst-uri>

Works across every registered protocol (file/s3/gs/azure/hdfs/http) and
honors the same environment credential contract as the library
(AWS_ACCESS_KEY_ID/..., AZURE_STORAGE_*, S3_ENDPOINT, etc.) — this is the
one-command smoke tool for poking a real bucket/namenode the moment an
endpoint is reachable.

Counterpart of ``dmlc_core_tpu/io/__main__.py`` (a copy).
"""

import sys

from dmlc_core_tpu_torch.io.filesys import URI, FileType, get_filesystem
from dmlc_core_tpu_torch.io.stream import create_stream, create_stream_for_read

USAGE = __doc__

CHUNK = 4 << 20


def cmd_ls(uri: str) -> int:
    fs = get_filesystem(URI(uri))
    infos = fs.list_directory(URI(uri))
    for info in infos:
        marker = "/" if info.type == FileType.DIRECTORY else ""
        print(f"{info.size:>16}  {info.path.str()}{marker}")
    print(f"{len(infos)} entries", file=sys.stderr)
    return 0


def cmd_cat(uri: str) -> int:
    src = create_stream_for_read(uri)
    out = sys.stdout.buffer
    total = 0
    while True:
        data = src.read(CHUNK)
        if not data:
            break
        out.write(data)
        total += len(data)
    out.flush()
    print(f"{total} bytes", file=sys.stderr)
    return 0


def cmd_cp(src_uri: str, dst_uri: str) -> int:
    src = create_stream_for_read(src_uri)
    try:
        dst = create_stream(dst_uri, "w")
        total = 0
        try:
            while True:
                data = src.read(CHUNK)
                if not data:
                    break
                dst.write(data)
                total += len(data)
        except BaseException:
            # do NOT commit a truncated destination: closing a half-written
            # remote stream would finalize the upload and leave an object
            # that looks complete.  Best effort: remove a local partial;
            # for remote targets say so explicitly.
            _discard_partial_dest(dst, dst_uri)
            raise
        dst.close()
    finally:
        src.close()
    print(f"copied {total} bytes {src_uri} -> {dst_uri}", file=sys.stderr)
    return 0


def _discard_partial_dest(dst, dst_uri: str) -> None:
    import os

    if "://" not in dst_uri or dst_uri.startswith("file://"):
        path = dst_uri[len("file://"):] if dst_uri.startswith("file://") \
            else dst_uri
        try:
            dst.close()
        except Exception:
            pass
        try:
            os.remove(path)
        except OSError:
            pass
    else:
        print(f"warning: copy failed mid-stream; a partial object may "
              f"remain at {dst_uri}", file=sys.stderr)


def main(argv) -> int:
    if len(argv) < 2:
        print(USAGE, file=sys.stderr)
        return 2
    cmd, args = argv[0], argv[1:]
    try:
        if cmd == "ls" and len(args) == 1:
            return cmd_ls(args[0])
        if cmd == "cat" and len(args) == 1:
            return cmd_cat(args[0])
        if cmd == "cp" and len(args) == 2:
            return cmd_cp(args[0], args[1])
    except Exception as e:  # noqa: BLE001 — operator tool: message, not trace
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(USAGE, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
