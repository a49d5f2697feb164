"""PyTorch port vs the JAX package: the native ingest engine on the CPU.

The same seeded bytes go through the JAX package's Python engine (always
present, switched on by monkeypatching its native library away) and through
both of the port's engines: the native C++ parsers, built with g++ at first
use, and the numpy engine, asked for with ``DMLC_TPU_DISABLE_NATIVE``.
Merged columns must be bitwise equal (an absent weight or value column
means all ones in either form).  The build itself is held here too: two
processes building at once, a missing or failing compiler, an ABI
mismatch, and the copies of the C++ sources.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from dmlc_core_tpu import native_bridge as jax_native
from dmlc_core_tpu.data.factory import create_parser as jax_create_parser
from dmlc_core_tpu.data.row_block import concat_blocks as jax_concat
from dmlc_core_tpu_torch import native_bridge as nb
from dmlc_core_tpu_torch.data import factory as pfactory
from dmlc_core_tpu_torch.data.row_block import concat_blocks as port_concat
from dmlc_core_tpu_torch.io import input_split as psplit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ("offset", "label", "weight", "index", "value", "field")
FLOATS = ["1", "2.", ".5", "-0.0", "1e3", "3.14159e-2", "-7E+1", "0.00001",
          "123456.789", "-2.5e-7", "65504", "1e-30"]
ENGINES = ("native", "numpy")


def make_libsvm(n=1500, seed=0, weights=False, values=True):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        idx = sorted(rng.choice(500, size=rng.randint(0, 8), replace=False))
        head = f"{rng.randint(0, 2)}"
        if weights:
            head += f":{rng.rand():.3f}"
        feats = " ".join(f"{j}:{rng.randn():.6g}" if values else str(j)
                         for j in idx)
        lines.append((head + " " + feats).strip())
    return ("\n".join(lines) + "\n").encode()


def make_messy_libsvm(n=600, seed=0):
    """Valid but messy libsvm: whitespace runs, tabs, CR/LF mixes, blank
    lines, exotic float spellings, weights on some rows, bare indices."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        if rng.rand() < 0.05:
            lines.append("")
            continue
        sep = "\t" if rng.rand() < 0.3 else " " * rng.randint(1, 4)
        idx = sorted(rng.choice(100, size=rng.randint(0, 6), replace=False))
        head = FLOATS[rng.randint(len(FLOATS))]
        if rng.rand() < 0.3:
            head += f":{FLOATS[rng.randint(len(FLOATS))]}"
        feats = sep.join(f"{j}:{FLOATS[rng.randint(len(FLOATS))]}"
                         if rng.rand() > 0.1 else str(j) for j in idx)
        lines.append(head + sep + feats + " " * rng.randint(0, 3))
    eol = ["\n", "\r\n"]
    return "".join(line + eol[rng.randint(2)] for line in lines).encode()


def make_libfm(n=800, seed=0, weights=False, messy=False):
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(n):
        feats = []
        for _ in range(rng.randint(1, 7)):
            val = (FLOATS[rng.randint(len(FLOATS))] if messy
                   else f"{rng.randn():.7g}")
            feats.append(f"{rng.randint(0, 12)}:{rng.randint(0, 400)}:{val}")
        sep = ("\t" if rng.rand() < 0.3 else "  ") if messy else " "
        head = f"{rng.randint(0, 2)}"
        if weights:
            head += f":{rng.rand():.4f}"
        lines.append(head + sep + sep.join(feats))
    eol = "\r\n" if messy else "\n"
    return (eol.join(lines) + eol).encode()


def make_messy_csv(seed, ncol=5, n=300):
    rng = np.random.RandomState(seed)
    lines = [",".join(FLOATS[rng.randint(len(FLOATS))] if rng.rand() > 0.1
                      else "" for _ in range(ncol)) for _ in range(n)]
    eol = "\r\n" if seed % 2 else "\n"
    return (eol.join(lines) + eol).encode()


def make_precise_csv(n=2000, f=6, seed=1):
    """float32 values over 16 decades with %.9g: each survives the text."""
    rng = np.random.RandomState(seed)
    scale = np.float32(10.0) ** rng.randint(-8, 8, (n, f)).astype(np.float32)
    x = (rng.randn(n, f).astype(np.float32) * scale).astype(np.float32)
    return "".join(",".join(f"{v:.9g}" for v in r) + "\n"
                   for r in x).encode()


PARSE_CASES = {
    "libsvm": (make_libsvm(), "libsvm", ""),
    "libsvm-weights": (make_libsvm(weights=True), "libsvm", ""),
    "libsvm-valueless": (make_libsvm(values=False), "libsvm", ""),
    "csv-empty-cells": (b"1,0.5,,2.0\n0,,1.5,\n,,,\n3,4,5,6\n", "csv",
                        "?format=csv&label_column=1"),
    "csv-precise-label0": (make_precise_csv(), "csv",
                           "?format=csv&label_column=0"),
    "csv-nan-cells": (make_messy_csv(3), "csv", "?format=csv&missing=nan"),
    "csv-messy-label2": (make_messy_csv(4), "csv",
                         "?format=csv&label_column=2"),
    "libfm": (make_libfm(), "libfm", ""),
    "libfm-weights": (make_libfm(seed=1, weights=True), "libfm", ""),
    "libfm-messy": (make_libfm(seed=2, messy=True), "libfm", ""),
}
# the differential fuzz of messy lines (one case a seed)
PARSE_CASES.update({f"libsvm-fuzz{s}": (make_messy_libsvm(seed=s), "libsvm",
                                        "") for s in range(6)})


@pytest.fixture
def jax_python_engine(monkeypatch):
    """The JAX package without its native library: its Python engine."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "lsplit_available", lambda: False)


def use_engine(monkeypatch, engine):
    """Point the port at one engine; counts set to 0."""
    if engine == "numpy":
        monkeypatch.setenv("DMLC_TPU_DISABLE_NATIVE", "1")
    else:
        monkeypatch.delenv("DMLC_TPU_DISABLE_NATIVE", raising=False)
    nb.reset_engine_calls()


def merged_columns(blocks, concat):
    block = concat(blocks)
    out = {}
    for name in COLUMNS:
        col = getattr(block, name)
        if col is None and name == "weight":
            col = np.ones(block.size, np.float32)
        elif col is None and name == "value":
            col = np.ones(block.num_nonzero, np.float32)
        out[name] = col
    return out


def parse_all(create, uri, fmt, **kw):
    parser = create(uri, type=fmt, **kw)
    try:
        return list(parser)
    finally:
        parser.close()


def assert_bitwise(got, want, what=""):
    if want is None or got is None:
        assert got is None and want is None, what
        return
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parsed_columns_bitwise_jax_python_engine(tmp_path, monkeypatch,
                                                  jax_python_engine, case,
                                                  engine):
    content, fmt, query = PARSE_CASES[case]
    path = tmp_path / f"data.{fmt}"
    path.write_bytes(content)
    uri = str(path) + query
    want = merged_columns(parse_all(jax_create_parser, uri, fmt,
                                    threaded=False), jax_concat)
    use_engine(monkeypatch, engine)
    got = merged_columns(parse_all(pfactory.create_parser, uri, fmt),
                         port_concat)
    for name in COLUMNS:
        assert_bitwise(got[name], want[name], f"{case} {engine}: {name}")
    parse_calls = nb.ENGINE_CALLS[f"parse_{fmt}"]
    if engine == "native":
        assert parse_calls > 0 and nb.ENGINE_CALLS["lsplit_next_chunk"] > 0
    else:
        assert sum(nb.ENGINE_CALLS.values()) == 0


def test_native_parses_a_chunk_into_one_block(tmp_path, monkeypatch):
    """The native parser cuts no chunk into per-thread blocks."""
    path = tmp_path / "a.libsvm"
    path.write_bytes(make_libsvm(n=4000))
    use_engine(monkeypatch, "native")
    blocks = parse_all(pfactory.create_parser, str(path), "libsvm",
                       nthread=4)
    assert len(blocks) == 1 and blocks[0].size == 4000
    use_engine(monkeypatch, "numpy")
    assert len(parse_all(pfactory.create_parser, str(path), "libsvm",
                         nthread=4, threaded=False)) >= 4


def test_native_errors_carry_the_engine_message():
    with pytest.raises(ValueError, match="label"):
        nb.parse_libsvm(b"abc 1:2\n")
    with pytest.raises(ValueError, match="CSV"):
        nb.parse_csv(b"1,2\n1,2,3\n")


def test_zero_copy_view_parse_equals_bytes_parse(tmp_path):
    """A native split's (addr, len) view parses to the same columns as the
    chunk's bytes."""
    path = tmp_path / "a.libsvm"
    content = make_messy_libsvm(seed=9)
    path.write_bytes(content)
    split = psplit.create_input_split(str(path), 0, 1, "text")
    try:
        view = split.next_chunk_view()
        from_view = nb.parse_libsvm(view)
        import ctypes

        from_bytes = nb.parse_libsvm(ctypes.string_at(*view))
    finally:
        split.close()
    for a, b in zip(from_view, from_bytes):
        assert_bitwise(a, b)
    assert from_bytes[0][-1] == len(nb.parse_libsvm(content)[3])


@pytest.mark.parametrize("name", nb.SOURCES)
def test_native_sources_are_copies_of_the_jax_package(name):
    with open(os.path.join(REPO, "native", name), "rb") as f:
        want = f.read()
    with open(os.path.join(nb.SOURCE_DIR, name), "rb") as f:
        assert f.read() == want


def test_disable_native_selects_the_numpy_and_python_engines(tmp_path,
                                                             monkeypatch):
    from dmlc_core_tpu_torch.io.memory_io import MemoryStringStream
    from dmlc_core_tpu_torch.io.recordio import (RecordIOChunkReader,
                                                 RecordIOWriter)

    path = tmp_path / "a.libsvm"
    path.write_bytes(make_libsvm(n=300))
    use_engine(monkeypatch, "numpy")
    split = psplit.create_input_split(str(path), 0, 1, "text")
    assert isinstance(split, psplit.ThreadedInputSplit)
    split.close()
    parse_all(pfactory.create_parser, str(path), "libsvm")
    stream = MemoryStringStream()
    RecordIOWriter(stream).write_records([b"abc", b"", b"defgh"])
    assert [bytes(r) for r in RecordIOChunkReader(bytes(stream.data))] == \
        [b"abc", b"", b"defgh"]
    assert sum(nb.ENGINE_CALLS.values()) == 0
    use_engine(monkeypatch, "native")
    split = psplit.create_input_split(str(path), 0, 1, "text")
    assert isinstance(split, psplit.NativeLineSplitter)
    split.close()
    assert isinstance(psplit.create_input_split(str(path), 0, 1, "text",
                                                threaded=False),
                      psplit.LineSplitter)


# -- the build ----------------------------------------------------------------

_BUILD_SCRIPT = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo!r})
    from dmlc_core_tpu_torch import native_bridge as nb
    nb.BUILD_DIR = {build!r}
    lib = nb.load_library()
    print(json.dumps(dict(cached=nb.BUILD_INFO.get("cached"),
                          abi=int(lib.dmlc_tpu_abi_version()),
                          inode=os.stat(nb.library_path()).st_ino,
                          rows=len(nb.parse_libsvm(b"1 2:3\\n0 4:5\\n")[1]))))
""")


def test_two_processes_build_at_once_and_load_one_library(tmp_path):
    import json

    build = str(tmp_path / "build" / "native")
    script = _BUILD_SCRIPT.format(repo=REPO, build=build)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(o["cached"] for o in outs) == [False, True]   # one build
    assert {o["inode"] for o in outs} == {os.stat(
        os.path.join(build, nb.LIBRARY_NAME)).st_ino}
    assert all(o["abi"] == nb.ABI and o["rows"] == 2 for o in outs)
    # no temporary file is left behind
    assert sorted(os.listdir(build)) == [nb.LIBRARY_NAME,
                                         nb.LIBRARY_NAME + ".lock"]


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(nb, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(nb, "_lib", None)
    nb.BUILD_INFO.clear()


def test_missing_compiler_raises_and_never_parses_with_numpy(tmp_path,
                                                             monkeypatch):
    _fresh_build(monkeypatch, tmp_path)
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    use_engine(monkeypatch, "native")
    with pytest.raises(RuntimeError, match="g.. not found"):
        nb.load_library()
    data = tmp_path / "a.libsvm"
    data.write_bytes(make_libsvm(n=50))
    with pytest.raises(RuntimeError, match="g.. not found"):
        parse_all(pfactory.create_parser, str(data), "libsvm",
                  threaded=False)
    assert sum(nb.ENGINE_CALLS.values()) == 0
    assert not os.path.exists(nb.library_path())


def test_failing_compiler_raises_with_its_output(tmp_path, monkeypatch):
    _fresh_build(monkeypatch, tmp_path)
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'fatal: the compiler is broken' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    with pytest.raises(RuntimeError, match="the compiler is broken"):
        nb.load_library()
    assert os.listdir(nb.BUILD_DIR) == [nb.LIBRARY_NAME + ".lock"]


def test_abi_mismatch_unlinks_and_rebuilds(tmp_path, monkeypatch):
    _fresh_build(monkeypatch, tmp_path)
    os.makedirs(nb.BUILD_DIR)
    stale_src = tmp_path / "stale.c"
    stale_src.write_text("int dmlc_tpu_abi_version(void) { return 4; }\n")
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", nb.library_path(),
                    str(stale_src)], check=True)
    newest = max(os.path.getmtime(os.path.join(nb.SOURCE_DIR, s))
                 for s in nb.SOURCES)
    os.utime(nb.library_path(), (newest + 10, newest + 10))
    lib = nb.load_library()       # the stale mapping was dropped, too
    assert lib.dmlc_tpu_abi_version() == nb.ABI
    assert nb.BUILD_INFO["cached"] is False
    assert len(nb.parse_libsvm(b"1 2:3\n")[1]) == 1
