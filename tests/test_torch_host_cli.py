"""PyTorch port vs the JAX package: the host command lines.

``python -m dmlc_core_tpu_torch.fault list-sites|validate`` and ``python -m
dmlc_core_tpu_torch.telemetry report|trace`` (with the trace assembler,
:mod:`dmlc_core_tpu_torch.telemetry.traceview`) against the JAX package's
on the CPU:

- the CLI cases of ``tests/test_fault.py`` and ``tests/test_telemetry.py``
  and the assembler cases of ``tests/test_tracecontext.py``: each runs the
  JAX command and the port's on the same input and requires the same exit
  code, standard output and standard error;
- span, flight and snapshot directories built from a numpy seed (several
  processes on unaligned clocks, orphans, untraced spans, instants, a
  crashed process, dropped spans): ``assemble``, ``critical_path`` and
  ``render_report`` give equal results under both packages, and so do the
  ``trace`` CLI's report and merged Perfetto file;
- the four cases of ``tests/test_trace_e2e.py`` with port processes
  (``--device cpu``): one trace across the test process, the port's
  serving CLI and two parse pool workers; the loadgen report's slowest
  trace ids; a fault fire as an instant on its enclosing span; a killed
  parse worker's flight dump reported as a crash;
- the file format: directories that port processes wrote assemble to the
  same report under the JAX assembler as under the port's.
"""

import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
# loaded, as in every port process that trains: the parse pool then spawns
# its workers, and a spawned worker flushes its span file at exit
import torch  # noqa: F401

from dmlc_core_tpu import fault as j_fault
from dmlc_core_tpu import telemetry as j_telemetry
from dmlc_core_tpu.fault.__main__ import main as j_fault_cli
from dmlc_core_tpu.telemetry import export as j_export
from dmlc_core_tpu.telemetry import flight as j_flight
from dmlc_core_tpu.telemetry import traceview as j_traceview
from dmlc_core_tpu.telemetry import tracecontext as j_tc
from dmlc_core_tpu.telemetry.__main__ import main as j_telemetry_cli
from dmlc_core_tpu.telemetry.registry import MetricRegistry as JRegistry
from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.data import parse_proc
from dmlc_core_tpu_torch.fault.__main__ import main as fault_cli
from dmlc_core_tpu_torch.telemetry import export, flight, traceview
from dmlc_core_tpu_torch.telemetry import tracecontext as tc
from dmlc_core_tpu_torch.telemetry.__main__ import main as telemetry_cli
from dmlc_core_tpu_torch.telemetry.registry import MetricRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 2, 3, 4, 5]
_LIBSVM_SPEC = ("dmlc_core_tpu_torch.data.libsvm_parser", "LibSVMParser",
                {"nthread": 1, "index_dtype": "<u4"})


@pytest.fixture(autouse=True)
def _clean_tracing():
    """Both packages start with no ambient context and empty tracers and
    rings; the prior enabled state is restored afterwards."""
    saved = []
    for tel, fl, ctx in ((telemetry, flight, tc),
                         (j_telemetry, j_flight, j_tc)):
        saved.append((tel, fl, ctx, tel.enabled(), ctx.get_process_root()))
        tel.disable()
        tel.reset()
        fl.reset()
        ctx.set_process_root(None)
    yield
    fault.clear()
    j_fault.clear()
    for tel, fl, ctx, was_enabled, root in saved:
        tel.disable()
        tel.reset()
        fl.reset()
        ctx.set_process_root(root)
        if was_enabled:
            tel.enable()


def _same(capsys, fn_jax, fn_port):
    """(rc, stdout, stderr) of the port's call, required equal to the JAX
    call's."""
    out = []
    for fn in (fn_jax, fn_port):
        rc = fn()
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    assert out[1] == out[0]
    return out[1]


# -- fault CLI ----------------------------------------------------------------

PLANS = {
    "good": json.dumps({"seed": 1, "rules": [
        {"site": "net.request", "kind": "http_status", "status": 503}]}),
    "bad_kind": '{"rules": [{"site": "x", "kind": "nope"}]}',
    "bad_status": ('{"rules": [{"site": "x", "kind": "http_status", '
                   '"status": "5xx"}]}'),
    "unknown_site": json.dumps({"rules": [
        {"site": "tracker.framed.recv", "kind": "reset"},
        {"site": "no.such.site", "kind": "reset"},
        {"site": "tracker.*", "kind": "reset"}]}),
    "not_json": "{rules: [",
    "many_rules": json.dumps({"seed": 7, "rules": [
        {"site": "io.stream.read", "kind": "truncate", "keep": 3},
        {"site": "serve.predict", "kind": "error", "times": 2},
        {"site": "tracker.accept", "kind": "delay", "seconds": 0.5,
         "probability": 0.25}]}),
}


def test_fault_cli_list_sites(capsys):
    rc, out, _ = _same(capsys, lambda: j_fault_cli(["list-sites"]),
                       lambda: fault_cli(["list-sites"]))
    assert rc == 0
    for site in ("tracker.framed.recv", "net.request", "io.stream.open",
                 "threadediter.produce"):
        assert site in out


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_cli_validate_file(name, tmp_path, capsys):
    plan = tmp_path / f"{name}.json"
    plan.write_text(PLANS[name])
    rc, out, err = _same(capsys,
                         lambda: j_fault_cli(["validate", str(plan)]),
                         lambda: fault_cli(["validate", str(plan)]))
    want_rc = 2 if name in ("bad_kind", "bad_status", "not_json") else 0
    assert rc == want_rc
    if want_rc == 0:
        assert "plan ok" in out
    else:
        assert "invalid plan" in err
    if name == "unknown_site":
        assert "no.such.site" in err and "tracker.*" not in err


@pytest.mark.parametrize("name", ["good", "bad_kind"])
def test_fault_cli_validate_stdin(name, monkeypatch, capsys):
    def run(cli):
        monkeypatch.setattr(sys, "stdin", io.StringIO(PLANS[name]))
        return cli(["validate", "-"])

    rc, _, _ = _same(capsys, lambda: run(j_fault_cli), lambda: run(fault_cli))
    assert rc == (0 if name == "good" else 2)


def test_fault_cli_missing_plan(tmp_path, capsys):
    path = str(tmp_path / "missing.json")
    rc, _, err = _same(capsys, lambda: j_fault_cli(["validate", path]),
                       lambda: fault_cli(["validate", path]))
    assert rc == 2 and "cannot read plan" in err


def test_fault_cli_needs_a_command(capsys):
    for cli in (j_fault_cli, fault_cli):
        with pytest.raises(SystemExit) as exc:
            cli([])
        assert exc.value.code == 2
    assert capsys.readouterr().err.count("the following arguments") == 2


# -- telemetry report ---------------------------------------------------------

def _write_rank_snapshot(dirpath, rank, counter_v, gauge_v, hist_counts,
                         dropped=0):
    reg = MetricRegistry()
    reg.counter("dmlc_parser_rows_total", parser="p").inc(counter_v)
    reg.gauge("dmlc_threadediter_queue_depth").set(gauge_v)
    for v in hist_counts:
        reg.histogram("dmlc_collective_op_seconds",
                      buckets=(0.1, 1.0)).observe(v)
    snap = export.json_snapshot(reg)
    snap["rank"] = rank
    snap["pid"] = 1000 + rank
    if dropped:
        snap["spans"] = {"dropped": dropped}
    path = os.path.join(dirpath, f"metrics-r{rank}-p{1000 + rank}.json")
    with open(path, "w") as f:
        json.dump(snap, f)


def test_snapshot_writers_agree():
    """The port's registry and exporter write the JAX package's snapshot
    (the report reads either)."""
    snaps = []
    for reg_cls, exp in ((JRegistry, j_export), (MetricRegistry, export)):
        reg = reg_cls()
        reg.counter("dmlc_parser_rows_total", parser="p").inc(5)
        reg.histogram("dmlc_collective_op_seconds",
                      buckets=(0.1, 1.0)).observe(0.5)
        snap = exp.json_snapshot(reg)
        for key in ("pid", "time", "wall_epoch_s", "monotonic_s"):
            snap.pop(key, None)
        snaps.append(snap)
    assert snaps[0] == snaps[1]


@pytest.mark.parametrize("as_json", [False, True])
def test_report_cli(as_json, tmp_path, capsys):
    _write_rank_snapshot(str(tmp_path), 0, 100, 3.0, [0.05, 0.5])
    _write_rank_snapshot(str(tmp_path), 1, 250, 7.0, [2.0])
    argv = ["report", str(tmp_path)] + (["--json"] if as_json else [])
    rc, out, _ = _same(capsys, lambda: j_telemetry_cli(argv),
                       lambda: telemetry_cli(argv))
    assert rc == 0
    if as_json:
        merged = json.loads(out)
        assert merged['dmlc_parser_rows_total{parser="p"}']["total"] == 350
    else:
        assert "2 snapshot(s) from rank(s) 0,1" in out and "350" in out


def test_report_cli_skips_corrupt_snapshots(tmp_path, capsys):
    (tmp_path / "metrics-r0-p1.json").write_text("{not json")
    (tmp_path / "metrics-r1-p2.json").write_text('{"no_metrics": 1}')
    _write_rank_snapshot(str(tmp_path), 2, 5, 0.0, [])
    rc, out, _ = _same(capsys,
                       lambda: j_telemetry_cli(["report", str(tmp_path)]),
                       lambda: telemetry_cli(["report", str(tmp_path)]))
    assert rc == 0 and "rank(s) 2" in out


def test_report_cli_empty_dir_exit_code(tmp_path, capsys):
    rc, _, _ = _same(capsys,
                     lambda: j_telemetry_cli(["report", str(tmp_path)]),
                     lambda: telemetry_cli(["report", str(tmp_path)]))
    assert rc == 1


def test_report_cli_end_to_end(tmp_path):
    """``python -m dmlc_core_tpu_torch.telemetry report`` as a command."""
    _write_rank_snapshot(str(tmp_path), 0, 10, 1.0, [])
    _write_rank_snapshot(str(tmp_path), 1, 20, 2.0, [])
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.telemetry", "report",
         str(tmp_path), "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    merged = json.loads(proc.stdout)
    assert merged['dmlc_parser_rows_total{parser="p"}']["total"] == 30
    # the port's command imports neither jax nor torch
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['x', 'report', sys.argv[1]]\n"
         "try:\n"
         "    runpy.run_module('dmlc_core_tpu_torch.telemetry', "
         "run_name='__main__')\n"
         "except SystemExit:\n"
         "    pass\n"
         "print(sorted(m for m in ('jax', 'torch') if m in sys.modules))",
         str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert probe.stdout.strip().splitlines()[-1] == "[]", probe.stderr


# -- the trace assembler: the reference's cases -------------------------------

def _fake_trace_file(path, pid, wall_epoch, events, tag=None):
    payload = {"traceEvents": [
        {"name": "clock_sync", "ph": "M", "pid": pid, "tid": 0,
         "args": {"wall_epoch_s": wall_epoch}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
         "args": {"name": "main"}},
    ] + events, "displayTimeUnit": "ms"}
    out = path / f"trace-r0-p{tag or pid}.trace.json"
    out.write_text(json.dumps(payload))
    return out


def _span(name, pid, ts, dur, trace_id=None, span_id=None, parent_id=None):
    ev = {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": pid,
          "tid": 1}
    if trace_id:
        ev["trace_id"], ev["span_id"] = trace_id, span_id
        if parent_id:
            ev["parent_id"] = parent_id
    return ev


def _same_assembly(path):
    """assemble() of ``path`` under both packages, required equal."""
    want = j_traceview.assemble(str(path))
    got = traceview.assemble(str(path))
    assert got == want
    for top in (1, 10):
        assert traceview.render_report(got, top) == \
            j_traceview.render_report(want, top)
    return got


def _same_trace_cli(capsys, path, *extra):
    argv = ["trace", str(path), *extra]
    return _same(capsys, lambda: j_telemetry_cli(argv),
                 lambda: telemetry_cli(argv))


def test_assemble_aligns_and_joins_across_processes(tmp_path, capsys):
    t = "f" * 32
    _fake_trace_file(tmp_path, 100, 1000.0, [
        _span("client.request", 100, 0.0, 50_000.0, t, "a" * 16)])
    _fake_trace_file(tmp_path, 200, 1010.0, [
        _span("serve.request", 200, 5_000.0, 20_000.0, t, "b" * 16,
              "a" * 16)])
    asm = _same_assembly(tmp_path)
    assert asm["orphans"] == 0
    (trace,) = asm["traces"]
    assert trace["pids"] == [100, 200]
    by_name = {e["name"]: e for e in asm["events"]}
    assert by_name["serve.request"]["ts"] == pytest.approx(10_005_000.0)
    rc, _, _ = _same_trace_cli(capsys, tmp_path)
    assert rc == 0


def test_assemble_flags_orphans_and_cli_gate(tmp_path, capsys):
    t = "e" * 32
    _fake_trace_file(tmp_path, 300, 1000.0, [
        _span("serve.request", 300, 0.0, 1000.0, t, "b" * 16,
              parent_id="dead" * 4)])
    assert _same_assembly(tmp_path)["orphans"] == 1
    rc, out, _ = _same_trace_cli(capsys, tmp_path)
    assert rc == 0 and "orphan" in out
    rc, _, err = _same_trace_cli(capsys, tmp_path, "--fail-on-orphans")
    assert rc == 2 and "FAIL: 1 orphan" in err


def test_assemble_dedups_flight_overlap(tmp_path, capsys):
    t = "d" * 32
    ev = _span("the.op", 400, 100.0, 5.0, t, "ab" * 8)
    _fake_trace_file(tmp_path, 400, 1000.0, [ev])
    (tmp_path / "flight-r0-p400.json").write_text(json.dumps({
        "reason": "sigterm", "pid": 400, "rank": 0, "wall_epoch_s": 1000.0,
        "entries": [ev,
                    _span("only.in.flight", 400, 200.0, 5.0, t, "cd" * 8)]}))
    asm = _same_assembly(tmp_path)
    names = [e["name"] for e in asm["events"]]
    assert names.count("the.op") == 1 and "only.in.flight" in names
    (crash,) = asm["flights"]
    assert crash["reason"] == "sigterm" and crash["events_recovered"] == 1
    _same_trace_cli(capsys, tmp_path)


def test_critical_path_charges_exclusive_time():
    t = "c" * 32
    spans = [
        _span("request", 1, 0.0, 100_000.0, t, "a" * 16),
        _span("queue.wait", 1, 1_000.0, 20_000.0, t, "b" * 16, "a" * 16),
        _span("predict", 1, 21_000.0, 70_000.0, t, "ce" * 8, "a" * 16),
    ]
    path = traceview.critical_path(spans)
    assert path == j_traceview.critical_path(spans)
    shares = {p["stage"]: p for p in path}
    assert path[0]["stage"] == "predict"
    assert shares["request"]["exclusive_ms"] == pytest.approx(10.0)


def test_trace_cli_warns_on_drops(tmp_path, capsys):
    telemetry.enable()
    tracer = telemetry.get_tracer()
    tracer.record("kept", 0.0, 5.0)
    tracer.dropped = 7
    telemetry.flush(str(tmp_path))
    rc, out, _ = _same_trace_cli(capsys, tmp_path)
    assert rc == 0
    assert "dropped 7 span(s)" in out and "may be incomplete" in out


@pytest.mark.parametrize("top", ["1", "3"])
def test_trace_cli_writes_merged_perfetto(top, tmp_path, capsys):
    t = "b" * 32
    _fake_trace_file(tmp_path, 500, 1000.0, [
        _span("solo.op", 500, 0.0, 10.0, t, "ab" * 8),
        _span("other.op", 500, 20.0, 30.0, "9" * 32, "cd" * 8)])
    outs = {}
    for name, cli in (("jax", j_telemetry_cli), ("port", telemetry_cli)):
        out_path = tmp_path / f"merged-{name}.json"
        rc = cli(["trace", str(tmp_path), "--out", str(out_path),
                  "--top", top])
        text = capsys.readouterr().out
        assert rc == 0
        outs[name] = (text.replace(str(out_path), "OUT"),
                      out_path.read_bytes())
    assert outs["port"] == outs["jax"]
    merged = json.loads(outs["port"][1])
    names = {e.get("name") for e in merged["traceEvents"]}
    assert "solo.op" in names and "thread_name" in names


def test_trace_cli_as_a_command(tmp_path):
    """``python -m dmlc_core_tpu_torch.telemetry trace --out --json``."""
    t = "b" * 32
    _fake_trace_file(tmp_path, 500, 1000.0, [
        _span("solo.op", 500, 0.0, 10.0, t, "ab" * 8)])
    out_path = tmp_path / "merged.trace.json"
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.telemetry", "trace",
         str(tmp_path), "--out", str(out_path), "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["traces"][0]["trace_id"] == t
    merged = json.loads(out_path.read_text())
    assert "solo.op" in {e.get("name") for e in merged["traceEvents"]}


def test_trace_cli_empty_dir_exits_1(tmp_path, capsys):
    rc, out, _ = _same_trace_cli(capsys, tmp_path)
    assert rc == 1 and "no trace-*.trace.json" in out


# -- the trace assembler on seeded directories --------------------------------

def _hex(rng, n):
    return "".join("0123456789abcdef"[i] for i in rng.randint(0, 16, n))


def _seeded_dir(path, seed):
    """A telemetry directory from a numpy seed: 2-4 processes whose clocks
    start up to 5 s apart, traces that cross them, orphans, untraced
    spans, instants, one process with no clock anchor, a crashed process
    whose flight dump overlaps nothing or part of its flush, and metrics
    snapshots with dropped spans."""
    rng = np.random.RandomState(seed)
    n_proc = rng.randint(2, 5)
    pids = [int(p) for p in 1000 + rng.choice(9000, n_proc, replace=False)]
    events = {p: [] for p in pids}
    for _ in range(rng.randint(2, 7)):
        t = _hex(rng, 32)
        ids = [_hex(rng, 16)]
        root_pid = pids[rng.randint(n_proc)]
        ts0 = float(rng.randint(0, 100_000))
        events[root_pid].append(_span("root.op", root_pid, ts0,
                                      float(rng.randint(50_000, 200_000)),
                                      t, ids[0]))
        for k in range(rng.randint(1, 8)):
            pid = pids[rng.randint(n_proc)]
            sid = _hex(rng, 16)
            parent = (ids[rng.randint(len(ids))] if rng.rand() > 0.15
                      else _hex(rng, 16))        # an orphan's lost parent
            events[pid].append(_span(
                f"stage.{rng.randint(4)}", pid,
                ts0 + float(rng.randint(0, 50_000)),
                float(rng.randint(10, 40_000)), t, sid, parent))
            ids.append(sid)
            if rng.rand() < 0.3:
                events[pid].append({"name": "fault.injected", "ph": "i",
                                    "ts": ts0 + float(rng.randint(0, 9000)),
                                    "pid": pid, "tid": 1, "s": "t",
                                    "trace_id": t, "parent_id": sid,
                                    "args": {"site": "x", "kind": "delay"}})
    for pid in pids:
        for k in range(rng.randint(0, 3)):
            events[pid].append(_span("untraced.op", pid,
                                     float(rng.randint(0, 10_000)), 5.0))
    unanchored = pids[-1] if rng.rand() < 0.5 else None
    for i, pid in enumerate(pids[:-1] if n_proc > 2 else pids):
        wall = 1000.0 + float(rng.randint(0, 5000)) / 1000
        if pid == unanchored:
            payload = {"traceEvents": events[pid], "displayTimeUnit": "ms"}
            (path / f"trace-r{i}-p{pid}.trace.json").write_text(
                json.dumps(payload))
        else:
            _fake_trace_file(path, pid, wall, events[pid],
                             tag=f"{pid}")
    if n_proc > 2:
        # the last process crashed: only its flight dump is left, with
        # part of another process' flushed events as ring residue
        pid = pids[-1]
        entries = events[pid] + events[pids[0]][:2]
        (path / f"flight-r{n_proc - 1}-p{pid}.json").write_text(json.dumps({
            "reason": "fault_exit:data.parse_worker", "pid": pid,
            "rank": n_proc - 1, "wall_epoch_s": 1001.0,
            "spans_dropped": int(rng.randint(0, 3)), "entries": entries}))
    for r in range(rng.randint(0, 3)):
        _write_rank_snapshot(str(path), r, int(rng.randint(1, 100)),
                             float(rng.rand()), [], dropped=int(
                                 rng.randint(0, 4)))
    (path / "trace-r9-p9.trace.json").write_text("{torn")     # skipped


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_directory_assembles_alike(seed, tmp_path, capsys):
    _seeded_dir(tmp_path, seed)
    asm = _same_assembly(tmp_path)
    assert asm["spans"] > 0
    for t in asm["traces"]:
        spans = [e for e in asm["events"]
                 if e.get("ph") == "X" and e.get("trace_id") == t["trace_id"]]
        assert traceview.critical_path(spans) == \
            j_traceview.critical_path(spans) == t["critical_path"]
    for extra in ([], ["--json"], ["--top", "2", "--fail-on-orphans"],
                  ["--json", "--fail-on-orphans"]):
        rc, _, _ = _same_trace_cli(capsys, tmp_path, *extra)
        assert rc == (2 if asm["orphans"] and "--fail-on-orphans" in extra
                      else 0)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_seeded_directory_merged_files_alike(seed, tmp_path):
    _seeded_dir(tmp_path, seed)
    files = []
    for name, tv in (("jax", j_traceview), ("port", traceview)):
        out_path = tmp_path / f"merged-{name}.json"
        assert tv.main(str(tmp_path), out=str(out_path), as_json=True) == 0
        files.append(out_path.read_bytes())
    assert files[0] == files[1]


# -- end to end with port processes ------------------------------------------

def _spawn_server(telemetry_dir, num_feature):
    env = dict(os.environ, DMLC_TELEMETRY_DIR=str(telemetry_dir),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.serve", "--model",
         "linear", "--num-feature", str(num_feature), "--port", "0",
         "--no-warmup", "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    url = None
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if "serving linear on http://" in line:
            url = line.split("on ", 1)[1].split()[0]
            break
    return proc, url


def _stop_server(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if proc.stdout is not None:
        proc.stdout.close()


def _assemble_until(telemetry_dir, predicate, timeout_s=60.0):
    """Assemble until ``predicate(asm)`` holds (pool workers and the server
    flush their span files at process exit)."""
    deadline = time.monotonic() + timeout_s
    asm = traceview.assemble(str(telemetry_dir))
    while not predicate(asm) and time.monotonic() < deadline:
        time.sleep(0.5)
        asm = traceview.assemble(str(telemetry_dir))
    return asm


def test_trace_propagation_three_port_processes(tmp_path, monkeypatch,
                                                capsys):
    """One trace across the test process (client and parse consumer), the
    port's serving CLI and the port's parse pool workers: >= 3 pids, no
    orphans; then the JAX assembler reads the directory alike."""
    tel = tmp_path / "tel"
    tel.mkdir()
    monkeypatch.setenv("DMLC_TELEMETRY_DIR", str(tel))
    monkeypatch.setenv("DMLC_TPU_DISABLE_NATIVE", "1")
    parse_proc.shutdown()
    server, url = _spawn_server(tel, 4)
    try:
        assert url, "server did not come up"
        telemetry.enable()
        with tc.activate(tc.new_root()):
            with telemetry.span("e2e.root") as root:
                trace_id = root.trace_id
                body = json.dumps(
                    {"instances": [[0.1, 0.2, 0.3, 0.4]]}).encode()
                req = urllib.request.Request(
                    url + "/v1/score", data=body, method="POST",
                    headers={"Content-Type": "application/json",
                             "traceparent": tc.current_traceparent()})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    assert len(json.load(resp)["predictions"]) == 1
                pool = parse_proc.ProcParsePool(_LIBSVM_SPEC, 2)
                blocks = pool.parse_ranges([b"1 0:1.5\n0 2:2.0\n" * 200,
                                            b"1 1:0.5\n" * 150])
                assert sum(b.size for b in blocks) == 550
                pool.close()
    finally:
        _stop_server(server)
    parse_proc.shutdown()
    telemetry.flush(str(tel))

    def ready(asm):
        ours = [t for t in asm["traces"] if t["trace_id"] == trace_id]
        return ours and len(ours[0]["pids"]) >= 3 and ours[0]["orphans"] == 0

    asm = _assemble_until(tel, ready)
    (trace,) = [t for t in asm["traces"] if t["trace_id"] == trace_id]
    assert len(trace["pids"]) >= 3, trace["pids"]
    assert trace["orphans"] == 0, trace
    stages = {p["stage"] for p in trace["critical_path"]}
    assert {"e2e.root", "serve.request", "serve.predict",
            "serve.queue.wait", "parse_worker.parse_block"} <= stages, stages
    assert sum(p["share"] for p in trace["critical_path"]) \
        == pytest.approx(1.0, abs=0.01)
    # the file format: the JAX assembler reads the port's files alike
    _same_assembly(tel)
    _same_trace_cli(capsys, tel, "--fail-on-orphans", "--json")


def test_loadgen_report_names_slowest_traces(tmp_path, capsys):
    from dmlc_core_tpu_torch.serve.loadgen import run_load
    from dmlc_core_tpu_torch.serve.model_runtime import build_runtime
    from dmlc_core_tpu_torch.serve.server import ScoringServer

    telemetry.enable()
    runtime = build_runtime("linear", 6, device="cpu")
    server = ScoringServer(runtime, max_batch=8, max_delay_ms=1.0).start()
    try:
        report = run_load(server.url, qps=40, duration_s=1.0, num_feature=6,
                          rows_per_request=1, seed=5, timeout_s=10.0)
    finally:
        server.close()
    assert report["counts"]["ok"] > 0
    slowest = report["slowest_traces"]
    assert 0 < len(slowest) <= 5
    assert slowest == sorted(slowest, key=lambda s: -s["latency_ms"])
    for entry in slowest:
        assert len(entry["trace_id"]) == 32
    telemetry.flush(str(tmp_path))
    capsys.readouterr()              # the server's log lines
    asm = _same_assembly(tmp_path)
    assert {s["trace_id"] for s in slowest} <= \
        {t["trace_id"] for t in asm["traces"]}
    _same_trace_cli(capsys, tmp_path, "--top", "5")


def test_fault_fire_is_event_on_enclosing_span():
    telemetry.enable()
    fault.configure({"rules": [{"site": "tracker.accept", "kind": "delay",
                                "seconds": 0.0}]})
    try:
        with tc.activate(tc.new_root()):
            with telemetry.span("guarded.op"):
                fault.inject("tracker.accept", host="t")
    finally:
        fault.clear()
    events = telemetry.get_tracer().events()
    fire = [e for e in events if e["name"] == "fault.injected"][0]
    span = [e for e in events if e["name"] == "guarded.op"][0]
    assert fire["ph"] == "i"
    assert fire["trace_id"] == span["trace_id"]
    assert fire["parent_id"] == span["span_id"]
    assert fire["args"] == {"site": "tracker.accept", "kind": "delay"}
    assert any(e.get("name") == "fault.injected" for e in flight.snapshot())


_KILL_PLAN = ('{"rules": [{"site": "data.parse_worker", "kind": "exit", '
              '"times": null}]}')


def test_killed_port_worker_leaves_flight_dump(tmp_path, monkeypatch,
                                               capsys):
    tel = tmp_path / "tel"
    tel.mkdir()
    monkeypatch.setenv("DMLC_TELEMETRY_DIR", str(tel))
    monkeypatch.setenv("DMLC_FAULT_PLAN", _KILL_PLAN)
    monkeypatch.setenv("DMLC_TPU_DISABLE_NATIVE", "1")
    parse_proc.shutdown()
    pool = parse_proc.ProcParsePool(_LIBSVM_SPEC, 2)
    with pytest.raises(RuntimeError, match="parse worker died"):
        pool.parse_ranges([b"1 0:1.0\n" * 500, b"0 1:2.0\n" * 500])
    parse_proc.shutdown()
    deadline = time.monotonic() + 60
    dumps = []
    while not dumps and time.monotonic() < deadline:
        dumps = [p for p in os.listdir(tel) if p.startswith("flight-")]
        time.sleep(0.2)
    assert dumps, "killed worker left no flight dump"
    with open(tel / dumps[0]) as f:
        payload = json.load(f)
    assert payload["reason"] == "fault_exit:data.parse_worker"
    assert any(e.get("name") == "fault.injected" for e in payload["entries"])
    asm = _same_assembly(tel)
    assert any(c["reason"] == "fault_exit:data.parse_worker"
               for c in asm["flights"])
    rc, out, _ = _same_trace_cli(capsys, tel)
    assert rc == 0 and "fault_exit:data.parse_worker" in out
