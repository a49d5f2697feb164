"""PyTorch port vs the JAX package: the ingest path on the CPU.

The same seeded text files go through both packages' URI streams,
InputSplits, text parsers, batching and binning.  RowBlocks are compared
column by column, bitwise, after merging a parse's blocks (the JAX
package's native C++ parser, when it is built, cuts chunks into other
blocks, and an absent weight or value column means all ones in either
form).  With the JAX package held to its Python engine, the blocks must
match one for one, absent columns included.  Partitions, batches, wire
bytes and bin edges are bitwise equal; thread, fault and counter behaviour
is the same in both.
"""

import os
import threading

import numpy as np
import pytest
import torch

from dmlc_core_tpu import fault as jfault
from dmlc_core_tpu import native_bridge
from dmlc_core_tpu import telemetry as jtelemetry
from dmlc_core_tpu.bridge import batching as jbatching
from dmlc_core_tpu.bridge import binning as jbinning
from dmlc_core_tpu.data.factory import create_parser as jax_create_parser
from dmlc_core_tpu.data.row_block import concat_blocks as jax_concat
from dmlc_core_tpu.io import input_split as jsplit
from dmlc_core_tpu.io import stream as jstream
from dmlc_core_tpu.io.threadediter import ThreadedIter as JaxThreadedIter
from dmlc_core_tpu_torch import fault as pfault
from dmlc_core_tpu_torch import telemetry as ptelemetry
from dmlc_core_tpu_torch.bridge import batching as pbatching
from dmlc_core_tpu_torch.bridge import binning as pbinning
from dmlc_core_tpu_torch.data import factory as pfactory
from dmlc_core_tpu_torch.data.row_block import concat_blocks as port_concat
from dmlc_core_tpu_torch.io import input_split as psplit
from dmlc_core_tpu_torch.io import stream as pstream
from dmlc_core_tpu_torch.io.threadediter import ThreadedIter as PortThreadedIter
from dmlc_core_tpu_torch.utils.logging import Error
from tests.test_native import make_libsvm, make_messy_libsvm

COLUMNS = ("offset", "label", "weight", "index", "value")
_FLOATS = ["1", "2.", ".5", "-0.0", "1e3", "3.14159e-2", "-7E+1", "0.00001",
           "123456.789"]


def _precise_rows(n=3000, f=5, seed=0):
    """float32 values over 16 decades printed with %.9g: every value
    survives the text round trip."""
    rng = np.random.RandomState(seed)
    scale = np.float32(10.0) ** rng.randint(-8, 8, (n, f)).astype(np.float32)
    x = (rng.randn(n, f).astype(np.float32) * scale).astype(np.float32)
    y = (rng.rand(n) > 0.5).astype(np.float32)
    return x, y


def _precise_libsvm():
    x, y = _precise_rows()
    return "".join(f"{y[i]:.9g} " + " ".join(f"{j}:{v:.9g}"
                                             for j, v in enumerate(r)) + "\n"
                   for i, r in enumerate(x)).encode()


def _precise_csv():
    x, y = _precise_rows(seed=1)
    return "".join(f"{y[i]:.9g}," + ",".join(f"{v:.9g}" for v in r) + "\n"
                   for i, r in enumerate(x)).encode()


def _messy_csv(seed):
    rng = np.random.RandomState(seed)
    lines = [",".join(_FLOATS[rng.randint(len(_FLOATS))] if rng.rand() > 0.1
                      else "" for _ in range(5)) for _ in range(300)]
    eol = "\r\n" if seed % 2 else "\n"
    return (eol.join(lines) + eol).encode()


CASES = {
    "libsvm": (make_libsvm(), "a.libsvm", ""),
    "libsvm-weights": (make_libsvm(weights=True), "w.libsvm", ""),
    "libsvm-valueless": (make_libsvm(values=False), "nv.libsvm", ""),
    "libsvm-precise": (_precise_libsvm(), "p.libsvm", ""),
    "csv-label-empty-cells": (b"1,0.5,,2.0\n0,,1.5,\n,,,\n3,4,5,6\n",
                              "e.csv", "?format=csv&label_column=1"),
    "csv-precise": (_precise_csv(), "p.csv", "?format=csv&label_column=0"),
    "csv-no-label-nan-cells": (_messy_csv(3), "n.csv",
                               "?format=csv&missing=nan"),
}
CASES.update({f"libsvm-messy{s}": (make_messy_libsvm(seed=s),
                                   f"m{s}.libsvm", "") for s in range(8)})
CASES.update({f"csv-messy{s}": (_messy_csv(s), f"m{s}.csv",
                                "?format=csv&label_column=2")
              for s in range(2)})


@pytest.fixture
def python_engine(monkeypatch):
    """The JAX package without its native library: the engine the port
    copies."""
    monkeypatch.setattr(native_bridge, "available", lambda: False)
    monkeypatch.setattr(native_bridge, "lsplit_available", lambda: False)


def _write(tmp_path, case):
    content, name, query = CASES[case]
    path = tmp_path / name
    path.write_bytes(content)
    return str(path) + query


def _parse(create, uri, **kw):
    parser = create(uri, **kw)
    try:
        return list(parser)
    finally:
        parser.close()


def _columns(block):
    """Merged-block columns with absent weight/value as the ones they mean."""
    return dict(offset=block.offset, label=block.label,
                weight=(block.weight if block.weight is not None
                        else np.ones(block.size, np.float32)),
                index=block.index,
                value=(block.value if block.value is not None
                       else np.ones(block.num_nonzero, np.float32)))


def _assert_bitwise(got, want, what=""):
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rowblocks_bitwise_equal(tmp_path, case, threaded):
    uri = _write(tmp_path, case)
    want = _columns(jax_concat(_parse(jax_create_parser, uri,
                                      threaded=threaded)))
    got = _columns(port_concat(_parse(pfactory.create_parser, uri,
                                      threaded=threaded)))
    for name in COLUMNS:
        _assert_bitwise(got[name], want[name], f"{case}: {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_blocks_match_python_engine_one_for_one(tmp_path, python_engine,
                                                case):
    uri = _write(tmp_path, case)
    want = _parse(jax_create_parser, uri, threaded=False)
    got = _parse(pfactory.create_parser, uri, threaded=False)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for name in COLUMNS + ("field",):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None), f"{case}: {name}"
            if x is not None:
                _assert_bitwise(x, y, f"{case}: {name}")


def _shard_files(tmp_path):
    """Three libsvm files listed with ';', lines of uneven length."""
    paths = []
    for k in range(3):
        path = tmp_path / f"part{k}.libsvm"
        path.write_bytes(make_messy_libsvm(n=200 + 50 * k, seed=10 + k))
        paths.append(str(path))
    return ";".join(paths), paths


def _records(module, uri, part, nparts, threaded):
    split = module.create_input_split(uri, part, nparts, "text",
                                      threaded=threaded)
    try:
        return [bytes(r) for r in split]
    finally:
        split.close()


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("nparts", [1, 2, 3, 4])
def test_partitions_equal_disjoint_and_exhaustive(tmp_path, nparts,
                                                  threaded):
    uri, paths = _shard_files(tmp_path)
    every = []
    for part in range(nparts):
        got = _records(psplit, uri, part, nparts, threaded)
        want = _records(jsplit, uri, part, nparts, threaded)
        assert got == want
        every += got
    lines = []
    for path in paths:
        with open(path, "rb") as f:
            text = f.read().replace(b"\r", b"\n")
        lines += [line for line in text.split(b"\n") if line]
    assert every == lines          # union is the files, in order, once


@pytest.mark.parametrize("nparts", [2, 3])
def test_parser_partitions_equal(tmp_path, nparts):
    uri, _ = _shard_files(tmp_path)
    for part in range(nparts):
        kw = dict(part_index=part, num_parts=nparts, threaded=False)
        want = _columns(jax_concat(_parse(jax_create_parser, uri, **kw)))
        got = _columns(port_concat(_parse(pfactory.create_parser, uri, **kw)))
        for name in COLUMNS:
            _assert_bitwise(got[name], want[name], f"part {part}: {name}")


def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__
        assert a.num_rows == b.num_rows
        for name in a._fields[:-1]:             # num_rows checked above
            x, y = getattr(a, name), getattr(b, name)
            if x is None or y is None:
                assert x is None and y is None, name
                continue
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            _assert_bitwise(x.numpy(), np.asarray(y), name)
    return got


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("fill", [0.0, np.nan])
@pytest.mark.parametrize("case", ["libsvm-weights", "libsvm-messy0",
                                  "csv-label-empty-cells"])
def test_dense_batches_equal(tmp_path, case, fill, drop):
    uri = _write(tmp_path, case)
    bs = 3 if case.startswith("csv") else 96
    kw = dict(batch_size=bs, num_feature=500, drop_remainder=drop,
              fill_value=fill)
    jp, pp = jax_create_parser(uri), pfactory.create_parser(uri)
    try:
        got = _batches_equal(pbatching.dense_batches(pp, **kw),
                             jbatching.dense_batches(jp, **kw))
    finally:
        jp.close()
        pp.close()
    assert got and all(b.x.shape == (bs, 500) for b in got)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("case", ["libsvm", "libsvm-valueless",
                                  "libsvm-messy1"])
def test_sparse_batches_equal(tmp_path, case, drop):
    uri = _write(tmp_path, case)
    jp, pp = jax_create_parser(uri), pfactory.create_parser(uri)
    try:
        _batches_equal(pbatching.sparse_batches(pp, 128, drop_remainder=drop),
                       jbatching.sparse_batches(jp, 128, drop_remainder=drop))
    finally:
        jp.close()
        pp.close()


def test_bucket_size_ladder_equal():
    for n in list(range(0, 70)) + [255, 256, 257, 10_000, 123_457]:
        for minimum in (1, 256):
            assert pbatching.bucket_size(n, minimum) == \
                jbatching.bucket_size(n, minimum)


class _WorldOfOne:
    """``comm`` of a one-rank world: allgather adds the world axis."""

    @staticmethod
    def allgather(value):
        return np.asarray(value)[None]


@pytest.mark.parametrize("handle_missing", [False, True])
@pytest.mark.parametrize("source", ["array", "chunks", "parser", "comm"])
def test_fit_binner_edges_equal(tmp_path, python_engine, source,
                                handle_missing):
    """Each RowBlock a parser yields is one summarised chunk, so edges over
    a parser depend on where the blocks are cut: the JAX package is held
    to its Python engine, which cuts them as the port does."""
    x, _ = _precise_rows(n=2000, f=5, seed=3)
    x = np.clip(x, -1e6, 1e6)
    if handle_missing:
        x[np.random.RandomState(4).rand(*x.shape) < 0.1] = np.nan
    kw = dict(num_bins=32, handle_missing=handle_missing)
    if source == "array":
        args = (x, x)
    elif source == "chunks":
        args = ([x[:700], x[700:1500], x[1500:]],) * 2
    elif source == "comm":
        args = ([x[:1000], x[1000:]],) * 2
        kw["comm"] = _WorldOfOne()
    else:
        uri = _write(tmp_path, "libsvm-messy2")
        args = (jax_create_parser(uri), pfactory.create_parser(uri))
        kw["num_feature"] = 100
    try:
        want = jbinning.fit_binner(args[0], **kw)
        got = pbinning.fit_binner(args[1], **kw)
    finally:
        for p in args:
            if hasattr(p, "close"):
                p.close()
    _assert_bitwise(got.boundaries, want.boundaries)
    assert got.dtype == want.dtype and got.num_bins == want.num_bins


@pytest.mark.parametrize("handle_missing", [False, True])
def test_binned_batches_equal(tmp_path, handle_missing):
    uri = _write(tmp_path, "libsvm-messy3")
    with_parser = jax_create_parser(uri)
    try:
        binner = jbinning.fit_binner(with_parser, 16, num_feature=100,
                                     handle_missing=handle_missing)
    finally:
        with_parser.close()
    pbinner = pbinning.HostBinner(binner.boundaries, 16,
                                  handle_missing=handle_missing)
    assert pbinner.wire_nbytes(1000) == binner.wire_nbytes(1000)
    jp, pp = jax_create_parser(uri), pfactory.create_parser(uri)
    try:
        got = _batches_equal(pbinning.binned_batches(pp, pbinner, 64),
                             jbinning.binned_batches(jp, binner, 64))
    finally:
        jp.close()
        pp.close()
    assert got[0].bins.dtype == torch.uint8


class _Counter:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.i = n, fail_at, 0

    def before_first(self):
        self.i = 0

    def next(self, reuse):
        if self.i == self.fail_at:
            self.i += 1
            raise ValueError(f"boom at {self.fail_at}")
        if self.i >= self.n:
            return None
        self.i += 1
        return self.i - 1


def _drain(it, limit=100):
    out = []
    while len(out) < limit:
        try:
            item = it.next()
        except ValueError as exc:
            out.append(f"raised {exc}")
            continue
        if item is None:
            break
        out.append(item)
    return out


@pytest.mark.parametrize("fail_at", [None, 0, 7])
def test_threadediter_restart_and_errors_same(fail_at):
    runs = []
    for cls in (JaxThreadedIter, PortThreadedIter):
        it = cls(_Counter(12, fail_at), max_capacity=3, name="t")
        try:
            first = _drain(it)
            it.before_first()
            second = _drain(it)
        finally:
            it.destroy()
        runs.append((first, second))
    assert runs[0] == runs[1]
    if fail_at is None:
        assert runs[1][0] == list(range(12))


_PLANS = [
    ("io.stream.open", {"site": "io.stream.open", "kind": "error",
                        "exception": "OSError"}),
    ("io.stream.read", {"site": "io.stream.read", "kind": "truncate",
                        "keep": 3}),
    ("threadediter.produce", {"site": "threadediter.produce",
                              "kind": "error", "after": 2,
                              "exception": "RuntimeError"}),
]


def _exercise_sites(stream_mod, iter_cls, path):
    """Open and read ``path`` and drain a ThreadedIter: the outcome at
    each site, as text."""
    out = []
    try:
        with stream_mod.create_stream_for_read(path) as fi:
            out.append(fi.read_exact(8))
    except Exception as exc:  # noqa: BLE001 - the outcome is the result
        out.append(type(exc).__name__)
    it = iter_cls(_Counter(5), max_capacity=2, name="t")
    try:
        out.append(_drain(it))
    except Exception as exc:  # noqa: BLE001
        out.append(type(exc).__name__)
    finally:
        it.destroy()
    return out


@pytest.mark.parametrize("site,rule", _PLANS, ids=[p[0] for p in _PLANS])
def test_fault_sites_fire_the_same(tmp_path, site, rule):
    path = tmp_path / "f.bin"
    path.write_bytes(b"0123456789abcdef")
    spec = {"seed": 1, "rules": [rule]}
    outcomes = []
    for fault_mod, stream_mod, iter_cls in (
            (jfault, jstream, JaxThreadedIter),
            (pfault, pstream, PortThreadedIter)):
        fault_mod.configure(spec)
        try:
            outcomes.append((_exercise_sites(stream_mod, iter_cls, str(path)),
                             fault_mod.fires()))
        finally:
            fault_mod.clear()
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][1] and outcomes[1][1][0][0] == site
    assert site in pfault.SITES


def _counters(telemetry, names):
    out = {}
    for fam in telemetry.get_registry().families():
        if fam.name in names:
            for key, child in fam.samples():
                out[(fam.name, key)] = child.value
    return out


@pytest.mark.parametrize("case", ["libsvm-messy4", "csv-precise"])
def test_parser_counters_equal(tmp_path, case):
    uri = _write(tmp_path, case)
    names = ("dmlc_parser_rows_total", "dmlc_parser_bytes_total")
    got = []
    for telemetry, create in ((jtelemetry, jax_create_parser),
                              (ptelemetry, pfactory.create_parser)):
        was = telemetry.enabled()
        telemetry.enable()
        telemetry.reset()
        try:
            _parse(create, uri, threaded=False)
            got.append(_counters(telemetry, names))
        finally:
            telemetry.reset()
            if not was:
                telemetry.disable()
    assert got[0] == got[1]
    assert len(got[1]) == 2


@pytest.mark.parametrize("uri", ["s3://bucket/a.libsvm", "gs://b/a",
                                 "http://host/a.libsvm", "https://host/a",
                                 "hdfs://nn/a.libsvm", "azure://c/a"])
def test_remote_filesystems_not_ported(uri):
    with pytest.raises(Error, match="not yet in the PyTorch port"):
        pfactory.create_parser(uri)


def test_unported_formats_and_splits_raise(tmp_path):
    uri = _write(tmp_path, "libsvm")
    with pytest.raises(Error, match="ROADMAP"):
        psplit.create_input_split(uri, 0, 1, "recordio")
    with pytest.raises(Error, match="ROADMAP"):
        psplit.create_input_split(uri + "#cache", 0, 1, "text")
    for fmt in ("libfm", "parquet", "arrow"):
        with pytest.raises(Error, match="ROADMAP"):
            pfactory.create_parser(uri, type=fmt)
    with pytest.raises(Error, match="ROADMAP"):
        pfactory.create_parser(str(tmp_path / "t.parquet"))
    with pytest.raises(Error, match="ROADMAP"):
        pfactory.create_row_block_iter(uri)
    with pytest.raises(Error, match="unknown input split type"):
        psplit.create_input_split(uri, 0, 1, "bogus")


def test_stdin_split_and_glob_expansion(tmp_path):
    _, paths = _shard_files(tmp_path)
    pattern = os.path.join(str(tmp_path), r"part[0-2]\.libsvm")
    got = _records(psplit, pattern, 0, 1, False)
    assert got == _records(jsplit, pattern, 0, 1, False)
    assert got == _records(psplit, ";".join(paths), 0, 1, False)
    single = psplit.SingleFileSplit(paths[0])
    try:
        assert [bytes(r) for r in single] == _records(psplit, paths[0], 0, 1,
                                                      False)
    finally:
        single.close()


def test_parser_error_closes_its_split(tmp_path):
    """A parser that fails to build closes the split it was given, so no
    read-ahead thread outlives the error."""
    uri = _write(tmp_path, "csv-precise").split("?")[0]
    before = threading.active_count()
    with pytest.raises(Exception, match="label_column"):
        pfactory.create_parser(uri + "?format=csv&label_column=x")
    assert threading.active_count() == before
