"""PyTorch port vs the JAX package: the parse process pool.

The process-pool cases of ``tests/test_parse_fanout.py``, with the port's
pool (``DMLC_PARSE_PROC``, :mod:`dmlc_core_tpu_torch.data.parse_proc`)
held to the JAX package's and to the port's thread pool on the same seeded
corpora:

- blocks parsed by the port's pool are bitwise the thread pool's, the
  serial parse's and the JAX pool's, for libsvm, CSV and libfm;
- ``resolve_nproc`` reads its values as the JAX one does;
- the shared-memory leases are released, failed chunks leak no segment;
- a worker killed through the ``data.parse_worker`` fault site surfaces a
  clean error, and a fresh parser (or the same parser's next epoch)
  recovers;
- a spawned worker has no ``torch`` in ``sys.modules``; a parent that has
  imported torch spawns rather than forks;
- the pool switches itself off, with a log line, while the native engine
  parses chunks, as the JAX pool does while its native parser is built;
- the slice whole, at a small size: a libsvm file parsed by the pool,
  densified, binned and fitted on the CPU gives the JAX fit's trees on the
  same bins, within ``tests/test_torch_gbdt.py``'s tolerance.

The pool is host code and runs only with the native engine off, so every
test sets ``DMLC_TPU_DISABLE_NATIVE`` for the port and switches the JAX
package's native parser off likewise.
"""

import gc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dmlc_core_tpu import native_bridge as j_native
from dmlc_core_tpu.data import parse_proc as j_parse_proc
from dmlc_core_tpu.data.factory import create_parser as j_create_parser
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu_torch import native_bridge, telemetry
from dmlc_core_tpu_torch.bridge.batching import dense_batches
from dmlc_core_tpu_torch.bridge.binning import HostBinner, fit_binner
from dmlc_core_tpu_torch.data import parse_proc
from dmlc_core_tpu_torch.data.factory import create_parser
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
from dmlc_core_tpu_torch.utils import logging as p_logging
from tests.test_torch_gbdt import _assert_same_trees, interpret_mode  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ("offset", "label", "weight", "field", "index", "value")


@pytest.fixture(autouse=True)
def numpy_engines(monkeypatch):
    """The pools run where the native engines are off."""
    monkeypatch.setenv("DMLC_TPU_DISABLE_NATIVE", "1")
    monkeypatch.setattr(j_native, "available", lambda: False)


@pytest.fixture(scope="module", autouse=True)
def pools_down():
    yield
    parse_proc.shutdown()
    j_parse_proc.shutdown()


def _gen_corpus(tmp_path, fmt, rows=4000):
    rng = np.random.RandomState(7)
    lines = []
    for i in range(rows):
        if i % 61 == 0:
            lines.append("")                        # empty line
        feats = sorted(rng.choice(60, size=rng.randint(1, 8), replace=False))
        if fmt == "csv":
            lines.append(",".join(f"{rng.randn():.4f}" for _ in range(6)))
        elif fmt == "libfm":
            lines.append(f"{i % 2} " + " ".join(
                f"{j % 5}:{j}:{rng.rand():.4f}" for j in feats))
        else:
            lines.append(f"{i % 2} " + " ".join(
                f"{j}:{rng.rand():.4f}" for j in feats))
    eol = "\r\n" if fmt == "libsvm" else "\n"       # CRLF coverage
    path = tmp_path / f"corpus.{fmt}"
    path.write_bytes((eol.join(lines) + eol).encode())
    return str(path)


def _blocks_concat(parser):
    blocks = list(parser)
    parser.close()
    out = {"rows": sum(b.size for b in blocks)}
    for att in COLUMNS:
        cols = [getattr(b, att) for b in blocks]
        cols = [c for c in cols if c is not None]
        if att == "offset":          # row lengths: blind to block cuts
            cols = [np.diff(c) for c in cols]
        out[att] = np.concatenate(cols) if cols else None
    return out


def _assert_same_columns(got, want):
    assert got["rows"] == want["rows"] > 0
    for att in COLUMNS:
        if want[att] is None:
            assert got[att] is None, att
        else:
            assert got[att].dtype == want[att].dtype, att
            assert got[att].tobytes() == want[att].tobytes(), att


@pytest.mark.parametrize("fmt", ["libsvm", "libfm", "csv"])
def test_proc_blocks_bitwise_threads_serial_and_jax(tmp_path, monkeypatch,
                                                    fmt):
    uri = _gen_corpus(tmp_path, fmt)
    monkeypatch.setenv("DMLC_PARSE_PROC", "0")
    serial = _blocks_concat(create_parser(uri, type=fmt, nthread=1,
                                          threaded=False))
    threads = _blocks_concat(create_parser(uri, type=fmt, nthread=3,
                                           threaded=True))
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    proc = _blocks_concat(create_parser(uri, type=fmt, nthread=2,
                                        threaded=True))
    assert parse_proc.engaged()
    jax_proc = _blocks_concat(j_create_parser(uri, type=fmt, nthread=2,
                                              threaded=True))
    assert j_parse_proc.engaged()
    for other in (threads, proc, jax_proc):
        _assert_same_columns(other, serial)


@pytest.mark.parametrize("raw", ["4", "0", "off", "", "junk", "auto", "-3",
                                 " 2 ", "FALSE", None])
def test_resolve_nproc_matches_jax(raw):
    env = {} if raw is None else {"DMLC_PARSE_PROC": raw}
    assert parse_proc.resolve_nproc(env) == j_parse_proc.resolve_nproc(env)


def test_proc_backend_invalid_env_falls_back(tmp_path, monkeypatch):
    uri = _gen_corpus(tmp_path, "libsvm", rows=100)
    monkeypatch.setenv("DMLC_PARSE_PROC", "not-a-number")
    parser = create_parser(uri, type="libsvm", threaded=False)
    assert sum(b.size for b in parser) == 100
    parser.close()


def test_proc_backend_bad_error_matches_jax(tmp_path, monkeypatch):
    """Garbage input raises the same ValueError through both pools."""
    path = tmp_path / "bad.libsvm"
    path.write_bytes(b"1 abc:def\n" * 50)
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    errors = []
    for make in (create_parser, j_create_parser):
        parser = make(str(path), type="libsvm", threaded=False)
        try:
            with pytest.raises(ValueError, match="feature") as err:
                list(parser)
            errors.append(str(err.value))
        finally:
            parser.close()
    assert errors[0] == errors[1]


def test_proc_backend_label_only_rows(tmp_path, monkeypatch):
    path = tmp_path / "labels.libsvm"
    path.write_bytes(b"".join(b"%d\n" % (i % 2) for i in range(2000)))
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    parser = create_parser(str(path), type="libsvm", threaded=False)
    blocks = list(parser)
    parser.close()
    assert sum(b.size for b in blocks) == 2000
    assert all(b.num_nonzero == 0 for b in blocks)
    np.testing.assert_array_equal(np.concatenate([b.label for b in blocks]),
                                  np.arange(2000) % 2)


def test_failed_chunk_leaks_no_shm_segments(tmp_path, monkeypatch):
    """When one range of a chunk fails, the sibling ranges' segments are
    unlinked before the error propagates.  The check follows the names
    this parse discarded, so other processes' segments do not count."""
    rng = np.random.RandomState(0)
    good = [f"{i%2} " + " ".join(f"{j}:{rng.rand():.3f}" for j in range(4))
            for i in range(3000)]
    good[2900] = "1 broken:token"               # lands in a late range
    path = tmp_path / "mixed.libsvm"
    path.write_text("\n".join(good) + "\n")
    discarded = []
    real_discard = parse_proc._discard_meta

    def recording(meta):
        if meta and meta.get("shm"):
            discarded.append(meta["shm"])
        real_discard(meta)

    monkeypatch.setattr(parse_proc, "_discard_meta", recording)
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    parser = create_parser(str(path), type="libsvm", nthread=2,
                           threaded=False)
    with pytest.raises(ValueError):
        list(parser)
    parser.close()
    gc.collect()
    assert discarded
    if os.path.isdir("/dev/shm"):
        left = set(os.listdir("/dev/shm"))
        assert not [n for n in discarded if n.lstrip("/") in left]


def test_shm_leases_release(tmp_path, monkeypatch):
    uri = _gen_corpus(tmp_path, "libsvm", rows=2000)
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    telemetry.reset()
    telemetry.enable()
    try:
        parser = create_parser(uri, type="libsvm", threaded=False)
        blocks = list(parser)
        assert sum(b.size for b in blocks) == 2000
        gauge = telemetry.get_registry().gauge(
            "dmlc_parse_shm_bytes_in_flight")
        assert gauge.value > 0
        del blocks
        gc.collect()
        assert gauge.value == 0
        parser.close()
    finally:
        telemetry.disable()
        telemetry.reset()


def test_worker_parse_unlinks_segment_when_copy_fails(monkeypatch):
    from multiprocessing import shared_memory

    created = []
    real_shm = shared_memory.SharedMemory

    class _ExplodingBuf:
        def __init__(self, seg):
            self._seg = seg
            self.name = seg.name

        @property
        def buf(self):
            raise RuntimeError("injected copy failure")

        def close(self):
            self._seg.close()

        def unlink(self):
            self._seg.unlink()

    def exploding(*args, **kwargs):
        seg = real_shm(*args, **kwargs)
        created.append(seg.name)
        return _ExplodingBuf(seg)

    monkeypatch.setattr(parse_proc.shared_memory, "SharedMemory", exploding)
    spec = ("dmlc_core_tpu_torch.data.libsvm_parser", "LibSVMParser",
            {"nthread": 1, "index_dtype": "<u4"})
    with pytest.raises(RuntimeError, match="injected copy failure"):
        parse_proc._worker_parse(spec, b"1 0:1.5 3:2.5\n0 1:0.5\n")
    assert len(created) == 1
    with pytest.raises(FileNotFoundError):
        real_shm(name=created[0])


def test_worker_meta_and_attached_block_match_jax():
    data = b"1 0:1.5 3:2.5\n0 1:0.5\n1:2 7:0.25\n"
    p_meta = parse_proc._worker_parse(
        ("dmlc_core_tpu_torch.data.libsvm_parser", "LibSVMParser",
         {"nthread": 1, "index_dtype": "<u4"}), data)
    j_meta = j_parse_proc._worker_parse(
        ("dmlc_core_tpu.data.libsvm_parser", "LibSVMParser",
         {"nthread": 1, "index_dtype": "<u4"}), data)
    for key in ("rows", "max_index", "max_field", "nbytes", "cols"):
        assert p_meta[key] == j_meta[key], key
    got = parse_proc.attach_block(p_meta, np.uint32).get_block()
    want = j_parse_proc.attach_block(j_meta, np.uint32).get_block()
    for att in COLUMNS:
        a, b = getattr(got, att), getattr(want, att)
        assert (a is None) == (b is None), att
        if a is not None:
            assert a.tobytes() == b.tobytes(), att


def test_attach_block_releases_mapping_when_wrapping_fails(monkeypatch):
    spec = ("dmlc_core_tpu_torch.data.libsvm_parser", "LibSVMParser",
            {"nthread": 1, "index_dtype": "<u4"})
    meta = parse_proc._worker_parse(spec, b"1 0:1.5 3:2.5\n0 1:0.5\n")
    assert meta["shm"] and meta["nbytes"] > 0
    released = []
    gauge_deltas = []
    real_release = parse_proc._release_lease
    real_telemetry = parse_proc.telemetry

    def recording_release(mm, buf, gauge_bytes):
        released.append(gauge_bytes)
        real_release(mm, buf, gauge_bytes)

    class _Telemetry:
        @staticmethod
        def enabled():
            return True

        @staticmethod
        def gauge_add(name, delta, **labels):
            gauge_deltas.append(delta)

        def __getattr__(self, name):
            return getattr(real_telemetry, name)

    def exploding_finalize(*args, **kwargs):
        raise RuntimeError("injected finalize failure")

    monkeypatch.setattr(parse_proc, "_release_lease", recording_release)
    monkeypatch.setattr(parse_proc, "telemetry", _Telemetry())
    monkeypatch.setattr(parse_proc.weakref, "finalize", exploding_finalize)
    with pytest.raises(RuntimeError, match="injected finalize failure"):
        parse_proc.attach_block(meta, np.uint32)
    assert released == [meta["nbytes"]]
    assert sum(gauge_deltas) == 0


# -- chaos: killed worker -----------------------------------------------------

_KILL_PLAN = ('{"rules": [{"site": "data.parse_worker", "kind": "exit", '
              '"times": null}]}')


def test_fault_site_matches_jax():
    from dmlc_core_tpu import fault as j_fault
    from dmlc_core_tpu_torch import fault

    assert fault.SITES["data.parse_worker"] == \
        j_fault.SITES["data.parse_worker"]


@pytest.mark.chaos
def test_killed_parse_worker_surfaces_clean_error(tmp_path, monkeypatch):
    uri = _gen_corpus(tmp_path, "libsvm", rows=3000)
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    monkeypatch.setenv("DMLC_FAULT_PLAN", _KILL_PLAN)
    parse_proc.shutdown()   # workers read plans at start: force a fresh pool
    parser = create_parser(uri, type="libsvm", threaded=True)
    try:
        with pytest.raises(RuntimeError, match="parse worker died"):
            list(parser)
    finally:
        parser.close()
    assert not parse_proc.engaged()


@pytest.mark.chaos
def test_killed_worker_then_fresh_parser_recovers(tmp_path, monkeypatch):
    uri = _gen_corpus(tmp_path, "libsvm", rows=500)
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    monkeypatch.setenv("DMLC_FAULT_PLAN", _KILL_PLAN)
    parse_proc.shutdown()
    broken = create_parser(uri, type="libsvm", threaded=False)
    try:
        with pytest.raises(RuntimeError, match="parse worker died"):
            list(broken)
    finally:
        broken.close()
    monkeypatch.delenv("DMLC_FAULT_PLAN")
    clean = create_parser(uri, type="libsvm", threaded=False)
    assert sum(b.size for b in clean) == 500
    clean.close()
    assert parse_proc.engaged()


@pytest.mark.chaos
def test_same_parser_self_heals_after_worker_death(tmp_path, monkeypatch):
    uri = _gen_corpus(tmp_path, "libsvm", rows=500)
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    monkeypatch.setenv("DMLC_FAULT_PLAN", _KILL_PLAN)
    parse_proc.shutdown()
    parser = create_parser(uri, type="libsvm", threaded=False)
    try:
        with pytest.raises(RuntimeError, match="parse worker died"):
            list(parser)
        monkeypatch.delenv("DMLC_FAULT_PLAN")  # new workers read env afresh
        parser.before_first()
        assert sum(b.size for b in parser) == 500
    finally:
        parser.close()


# -- workers, start method and the native switch-off --------------------------

def test_spawned_workers_import_no_torch(tmp_path, monkeypatch):
    uri = _gen_corpus(tmp_path, "csv", rows=3000)
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    assert "torch" in sys.modules
    # a parent holding torch (and maybe a CUDA context) never forks
    assert parse_proc._default_start_method() == "spawn"
    parse_proc.shutdown()
    parser = create_parser(uri, type="csv", nthread=2, threaded=False)
    assert sum(b.size for b in parser) == 3000
    parser.close()
    pool, _ = parse_proc._get_shared_pool(2)
    probe = ("(sorted(m for m in ('torch', 'jax') if m in "
             "__import__('sys').modules), 'dmlc_core_tpu_torch.data."
             "csv_parser' in __import__('sys').modules)")
    results = [pool.submit(eval, probe).result(120) for _ in range(6)]
    assert all(loaded == [] for loaded, _ in results), results
    assert any(parsed for _, parsed in results), results


def test_single_threaded_parent_without_torch_forks():
    code = ("import sys, threading; "
            "from dmlc_core_tpu_torch.data import parse_proc; "
            "assert 'torch' not in sys.modules; "
            "assert threading.active_count() == 1; "
            "print(parse_proc._default_start_method())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "fork"


def test_pool_switches_off_while_the_native_engine_parses(tmp_path,
                                                          monkeypatch):
    uri = _gen_corpus(tmp_path, "libsvm", rows=1000)
    monkeypatch.delenv("DMLC_TPU_DISABLE_NATIVE")
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    parse_proc.shutdown()
    lines = []
    p_logging.set_log_sink(lambda severity, line: lines.append(line))
    try:
        native_bridge.reset_engine_calls()
        parser = create_parser(uri, type="libsvm", threaded=False)
        native = _blocks_concat(parser)
    finally:
        p_logging.set_log_sink(None)
    assert sum(native_bridge.ENGINE_CALLS.values()) > 0
    assert not parse_proc.engaged()
    assert any("DMLC_PARSE_PROC=2 is not used" in line for line in lines)
    monkeypatch.setenv("DMLC_TPU_DISABLE_NATIVE", "1")
    _assert_same_columns(_blocks_concat(
        create_parser(uri, type="libsvm", threaded=False)), native)
    assert parse_proc.engaged()


# -- the slice whole, at a small size -----------------------------------------

def test_pool_parse_to_fit_matches_jax(tmp_path, monkeypatch, interpret_mode):  # noqa: F811
    """libsvm parsed by the pool -> dense_batches -> HostBinner ->
    GBDT.fit_binned on the CPU, against the JAX fit of the same bins."""
    n, nf = 1200, 6
    rng = np.random.RandomState(11)
    x = rng.randn(n, nf).astype(np.float32)
    y = (x @ rng.randn(nf).astype(np.float32) > 0).astype(np.float32)
    path = tmp_path / "fit.libsvm"
    with open(path, "w") as f:
        for xi, yi in zip(x, y):
            f.write(f"{int(yi)} " + " ".join(
                f"{j}:{float(v)!r}" for j, v in enumerate(xi)) + "\n")
    monkeypatch.setenv("DMLC_PARSE_PROC", "2")
    parser = create_parser(str(path), nthread=2)
    batches = list(dense_batches(parser, 256, nf))
    parser.close()
    assert parse_proc.engaged()
    xs = torch.cat([b.x[:b.num_rows] for b in batches]).numpy()
    ys = torch.cat([b.label[:b.num_rows] for b in batches]).numpy()
    np.testing.assert_array_equal(xs, x)
    np.testing.assert_array_equal(ys, y)
    kw = dict(num_boost_round=3, max_depth=4, num_bins=32,
              hist_method="pallas")
    edges = fit_binner(xs, num_bins=32).boundaries
    bins = HostBinner(edges, 32).transform(xs)
    pm = GBDT(GBDTParam(**kw), num_feature=nf, device="cpu")
    pm.set_boundaries(edges)
    p_ens, p_margin = pm.fit_binned(torch.from_numpy(bins), ys)
    jm = JaxGBDT(JaxParam(**kw), num_feature=nf)
    jm.set_boundaries(edges)
    j_ens, j_margin = jm.fit_binned(bins, ys)
    _assert_same_trees(p_ens, j_ens, 1e-4)
    np.testing.assert_allclose(p_margin.numpy(), np.asarray(j_margin),
                               rtol=1e-4, atol=1e-4)
