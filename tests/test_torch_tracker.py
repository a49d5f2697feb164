"""The port's tracker and launcher against the JAX package's.

- Topology: ``RabitTracker.get_link_map(n)`` equal to the JAX package's
  for n = 1..64 (dict equality, so tree neighbour order too), with the
  properties ``tests/test_tracker.py`` holds.
- Wire: the scripted Rabit client sessions of
  ``tests/test_tracker_conformance.py`` (fresh starts, a recovered rank,
  the print command, a jobid restart) driven against both trackers; the
  recorded transcripts (listener ports normalised) and the assigned
  topologies must be equal op for op.  ``FakeRabitClient``
  (``tests/test_tracker.py``) checks ranks and realised links.
- Launcher: ``get_opts`` equal to the JAX package's on the same argv,
  ``submit_job`` giving the same env keys, the ``local`` backend's retry
  budget and staging, ``--cluster`` dispatching to the backend the JAX
  launcher picks (an unknown one exits 2 with its message), and
  ``worker_device`` taking the rank the collective takes.
- Telemetry: the rendezvous spans and series, and the collective ops'
  series, with the JAX package's names and labels for the same calls.

Tolerances: none; everything here is compared exactly.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dmlc_core_tpu import telemetry as jax_telemetry
from dmlc_core_tpu.tracker import filecache as jax_filecache
from dmlc_core_tpu.tracker import opts as jax_opts
from dmlc_core_tpu.tracker import rendezvous as jax_rdv
from dmlc_core_tpu.tracker import submit as jax_submit
from dmlc_core_tpu_torch import fault, telemetry
from dmlc_core_tpu_torch.tracker import filecache, local, opts, rendezvous
from dmlc_core_tpu_torch.tracker import submit
from tests.test_torch_collective import store_port
from tests.test_tracker import FakeRabitClient
from tests.test_tracker_conformance import RecordingClient, drive_session

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_port_workers(tmp_path, script_text, nworkers, env_extra=None,
                     timeout=120, script_path=None, script_args=(),
                     submit_args=()):
    """``tests.conftest.run_tracker_workers`` through the port's launcher
    (``python -m dmlc_core_tpu_torch.tracker.submit --cluster local``):
    write the worker script (or use ``script_path``), run it in
    ``nworkers`` processes, return the CompletedProcess.  The store gets a
    port of its own (``store_port``): trackers started at once by parallel
    test processes probe the same coordinator port."""
    if script_path is None:
        script_path = tmp_path / "worker.py"
        script_path.write_text(script_text)
    env = os.environ.copy()
    env["RESULT_DIR"] = str(tmp_path)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
           "--cluster", "local", "--num-workers", str(nworkers),
           "--env", f"DMLC_COORDINATOR_PORT={store_port()}",
           *submit_args, "--",
           sys.executable, str(script_path), *map(str, script_args)]
    return subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


# ---------------------------------------------------------------- topology --
@pytest.mark.parametrize("n", range(1, 65))
def test_link_map_equals_jax(n):
    got = rendezvous.RabitTracker.get_link_map(n)
    assert got == jax_rdv.RabitTracker.get_link_map(n)
    tree_map, parent_map, ring_map = got
    assert set(tree_map) == set(range(n))
    for r in range(n):
        # the ring after relabelling is 0 -> 1 -> ... -> n-1 -> 0
        assert ring_map[r] == ((r - 1) % n, (r + 1) % n)
        for nb in tree_map[r]:
            assert r in tree_map[nb]
        if parent_map[r] != -1:
            assert parent_map[r] in tree_map[r]
    assert [r for r in range(n) if parent_map[r] == -1] == [0]


# --------------------------------------------------------------------- wire --
def _run(module, n, **kw):
    tracker = module.RabitTracker("127.0.0.1", n)
    tracker.start(n)
    out = drive_session(("127.0.0.1", tracker.port), n, **kw)
    tracker.join(timeout=30)
    assert not tracker.alive()
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_fresh_start_wire_equals_jax(n):
    want_tr, want_topo = _run(jax_rdv, n)
    got_tr, got_topo = _run(rendezvous, n)
    assert got_topo == want_topo
    for i, (a, b) in enumerate(zip(want_tr, got_tr)):
        assert a == b, f"client {i}: jax={a} port={b}"


def test_recover_wire_equals_jax():
    want = _run(jax_rdv, 3, with_recover=True)
    assert _run(rendezvous, 3, with_recover=True) == want


def test_print_wire_equals_jax(caplog):
    want = _run(jax_rdv, 2, with_print=True)
    with caplog.at_level(logging.INFO, logger="dmlc_core_tpu_torch.tracker"):
        got = _run(rendezvous, 2, with_print=True)
    assert got == want
    assert any("hello from conformance" in r.message for r in caplog.records)


def _jobid_restart(module):
    """Three workers with job ids; worker 1 dies and restarts under its
    job id and must get its rank back without a batch."""
    tracker = module.RabitTracker("127.0.0.1", 3)
    tracker.start(3)
    addr = ("127.0.0.1", tracker.port)
    clients = [RecordingClient(addr, jobid=f"job-{i}") for i in range(3)]
    for c in clients:
        c.begin_start()
    threads = [threading.Thread(target=c.finish_start, daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    revived = RecordingClient(addr, jobid=clients[1].jobid)
    revived.links = clients[1].links
    revived.session_jobid_restart()
    assert revived.rank == clients[1].rank
    for c in (revived, clients[0], clients[2]):
        c.session_shutdown()
    tracker.join(timeout=30)
    out = [list(c.transcript) for c in clients + [revived]]
    for c in clients + [revived]:
        c.close()
    return out


def test_jobid_restart_wire_equals_jax():
    assert _jobid_restart(rendezvous) == _jobid_restart(jax_rdv)


@pytest.mark.parametrize("n", [2, 4, 7])
def test_port_tracker_realizes_every_link(n):
    """After the rendezvous every tree and ring edge exists as one TCP
    connection, ranks are 0..n-1 and every client sees world n."""
    tree_map, _, ring_map = rendezvous.RabitTracker.get_link_map(n)
    edges = {frozenset((r, p)) for r in range(n)
             for p in list(tree_map[r]) + list(ring_map[r]) if p not in (-1, r)}
    tracker = rendezvous.RabitTracker("127.0.0.1", n)
    tracker.start(n)
    clients = [FakeRabitClient("127.0.0.1", tracker.port) for _ in range(n)]
    threads = [threading.Thread(target=c.start, daemon=True) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive(), "rendezvous deadlocked"
    assert sorted(c.rank for c in clients) == list(range(n))
    assert {c.world for c in clients} == {n}
    deadline = time.time() + 10
    total = 0
    while time.time() < deadline:
        total = sum(len(c.peer_socks) for c in clients)
        if total == 2 * len(edges):
            break
        time.sleep(0.05)
    assert total == 2 * len(edges)
    for c in clients:
        c.shutdown()
    tracker.join(timeout=20)
    assert tracker.end_time is not None and not tracker.failed_ranks


def test_port_recovery_restores_rank():
    tracker = rendezvous.RabitTracker("127.0.0.1", 2)
    tracker.start(2)
    a = FakeRabitClient("127.0.0.1", tracker.port, jobid="job-a")
    b = FakeRabitClient("127.0.0.1", tracker.port, jobid="job-b")
    threads = [threading.Thread(target=c.start, daemon=True) for c in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    again = FakeRabitClient("127.0.0.1", tracker.port, jobid="job-a")
    t = threading.Thread(target=lambda: again.start(cmd="recover",
                                                    rank=a.rank), daemon=True)
    t.start()
    t.join(20)
    assert not t.is_alive() and again.rank == a.rank
    for c in (again, b):
        c.shutdown()
    tracker.join(timeout=20)


def _shutdown_ranks(port, ranks):
    """Send the ``shutdown`` command for each rank (a rendezvous nobody
    dialled ends when every rank has shut down)."""
    for rank in ranks:
        with socket.create_connection(("127.0.0.1", port)) as s:
            fs = rendezvous.FramedSocket(s)
            fs.sendint(rendezvous.MAGIC)
            assert fs.recvint() == rendezvous.MAGIC
            fs.sendint(rank)
            fs.sendint(-1)
            fs.sendstr("NULL")
            fs.sendstr("shutdown")


def test_accept_fault_site_rejects_one_connection():
    fault.configure({"rules": [{"site": "tracker.accept", "kind": "reset",
                                "times": 1}]})
    try:
        tracker = rendezvous.RabitTracker("127.0.0.1", 1)
        tracker.start(1)
        with socket.create_connection(("127.0.0.1", tracker.port)) as s:
            s.settimeout(10)
            # the tracker closes the connection before the handshake
            assert s.recv(4) == b""
        assert [f[:2] for f in fault.fires()] == [("tracker.accept", "reset")]
        _shutdown_ranks(tracker.port, [0])
        tracker.join(timeout=20)
    finally:
        fault.clear()


def test_rendezvous_deadline_fails_cleanly():
    tracker = rendezvous.RabitTracker("127.0.0.1", 2,
                                      rendezvous_deadline=0.5)
    tracker.start(2)
    lone = FakeRabitClient("127.0.0.1", tracker.port)
    with pytest.raises(OSError):
        lone.start()        # its peer never comes; the tracker gives up
    with pytest.raises(rendezvous.TrackerError, match="deadline"):
        tracker.join(timeout=20)
    lone.listen_sock.close()


def test_ps_tracker_ferries_scheduler_failure():
    ps = rendezvous.PSTracker("127.0.0.1", cmd=f"{sys.executable} -c "
                                                "'import sys; sys.exit(3)'")
    assert set(ps.worker_envs()) == {"DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT"}
    with pytest.raises(RuntimeError, match="scheduler"):
        ps.join()
    assert rendezvous.PSTracker("127.0.0.1", cmd=None).worker_envs() == {}


def _metric_families(snap):
    return {name: sorted(json.dumps(s["labels"], sort_keys=True)
                         for s in fam["samples"])
            for name, fam in snap["metrics"].items()}


def test_rendezvous_telemetry_names_equal_jax():
    out = {}
    for name, module, tel in (("jax", jax_rdv, jax_telemetry),
                              ("port", rendezvous, telemetry)):
        tel.enable()
        tel.reset()
        try:
            _run(module, 3)
            spans = sorted({e["name"] for e in tel.get_tracer().events()})
            out[name] = (spans, _metric_families(tel.snapshot()))
        finally:
            tel.disable()
            tel.reset()
    assert out["port"] == out["jax"]
    spans, families = out["port"]
    assert {"tracker.start", "tracker.rendezvous", "rendezvous.connect",
            "rendezvous.assign", "rendezvous.barrier"} <= set(spans)
    assert "dmlc_rendezvous_assign_seconds" in families


# ----------------------------------------------------------------- launcher --
ARGVS = [
    ["--num-workers", "4", "--cluster", "local", "--worker-memory", "2g",
     "--env", "FOO=bar", "--", "python", "train.py"],
    ["--num-workers", "2", "--num-servers", "1", "--server-memory", "512m",
     "--files", "a.txt#b.txt", "--archives", "z.zip", "--no-auto-file-cache",
     "--num-attempt", "3", "python", "x.py"],
    ["--cluster", "mpi", "--num-workers", "8", "--host-file", "hosts",
     "--log-level", "DEBUG", "--jobname", "j", "--", "a", "--b"],
    ["--num-workers", "1", "--host-ip", "127.0.0.1", "--worker-cores", "4",
     "--queue", "q", "--sync-dst-dir", "/d"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_get_opts_equals_jax(argv):
    assert vars(opts.get_opts(argv)) == vars(jax_opts.get_opts(argv))


@pytest.mark.parametrize("text", ["4g", "512m", "1024", "1.5G", " 2g "])
def test_parse_memory_mb_equals_jax(text):
    assert opts.parse_memory_mb(text) == jax_opts.parse_memory_mb(text)


def test_bad_cluster_choice_exits_like_jax():
    argv = ["--cluster", "k8s", "--num-workers", "1"]
    for get in (opts.get_opts, jax_opts.get_opts):
        with pytest.raises(SystemExit):
            get(argv)


@pytest.mark.parametrize("servers", [0, 2])
def test_submit_job_env_equals_jax(servers):
    argv = ["--num-workers", "3", "--num-servers", str(servers),
            "--host-ip", "127.0.0.1", "--env", "EXTRA=1", "--env",
            "DMLC_JOB_CLUSTER=over", "--", "true"]
    envs = {}
    for name, mod, get in (("jax", jax_submit, jax_opts.get_opts),
                           ("port", submit, opts.get_opts)):
        tracker = mod.submit_job(get(argv), envs.setdefault(name, {}).update,
                                 wait=False)
        _shutdown_ranks(tracker.port, range(3))
        tracker.join(timeout=20)
    assert set(envs["port"]) == set(envs["jax"])
    assert envs["port"]["DMLC_NUM_WORKER"] == "3"
    assert envs["port"]["DMLC_NUM_SERVER"] == str(servers)
    assert envs["port"]["DMLC_JOB_CLUSTER"] == "over"     # --env wins
    assert envs["port"]["EXTRA"] == "1"
    assert 12321 <= int(envs["port"]["DMLC_COORDINATOR_PORT"]) < 12999
    for key in ("DMLC_TRACKER_URI", "DMLC_COORDINATOR_URI"):
        assert envs["port"][key] == envs["jax"][key] == "127.0.0.1"


def test_exec_cmd_retry_and_exhaustion(tmp_path):
    marker = tmp_path / "attempted"
    flaky = tmp_path / "flaky.py"
    flaky.write_text(
        "import os, sys\n"
        f"m = {str(marker)!r}\n"
        "assert os.environ['DMLC_NUM_ATTEMPT'] == '2'\n"
        "if not os.path.exists(m):\n"
        "    open(m, 'w').close()\n"
        "    sys.exit(3)\n")
    local.exec_cmd([sys.executable, str(flaky)], "worker", 0, {},
                   num_attempt=2)
    assert marker.exists()
    dead = tmp_path / "dead.py"
    dead.write_text("import sys; sys.exit(7)\n")
    with pytest.raises(RuntimeError, match="failed with exit 7"):
        local.exec_cmd([sys.executable, str(dead)], "worker", 0, {},
                       num_attempt=2)


FLAKY = r"""
import os, sys
rank = os.environ["DMLC_TASK_ID"]
mark = os.path.join(os.environ["RESULT_DIR"], "tried-" + rank)
if not os.path.exists(mark):
    open(mark, "w").close()
    sys.exit(5)          # every worker's first attempt crashes
with open(os.path.join(os.environ["RESULT_DIR"], "ok-" + rank), "w") as f:
    f.write(open("shipped.txt").read() + " " + os.environ["DMLC_ROLE"])
"""


def test_launcher_retries_and_ships_files(tmp_path):
    shipped = tmp_path / "shipped.txt"
    shipped.write_text("payload")
    proc = run_port_workers(tmp_path, FLAKY, 2, timeout=60,
                            submit_args=["--num-attempt", "2", "--files",
                                         str(shipped)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    for rank in range(2):
        assert (tmp_path / f"ok-{rank}").read_text() == "payload worker"


def test_launcher_exhausted_retries_fail(tmp_path):
    proc = run_port_workers(tmp_path, "import sys; sys.exit(7)\n", 2,
                            timeout=60, submit_args=["--num-attempt", "2"])
    assert proc.returncode != 0
    assert "failed with exit 7" in proc.stderr


@pytest.mark.parametrize("cluster", ["local", "ssh", "mpi", "sge", "tpu-vm",
                                     "yarn", "mesos", "unknown"])
def test_backend_dispatch_matches_jax(cluster, monkeypatch, capsys):
    """``main`` hands the options to the backend module the JAX launcher
    picks for the same argv; a backend name that gets past the option
    schema exits 2 with the reference's message and runs nothing."""
    import importlib

    out = {}
    for name, package, main, opts_mod in (
            ("jax", "dmlc_core_tpu", jax_submit.main, jax_opts),
            ("port", "dmlc_core_tpu_torch", submit.main, opts)):
        called = []
        for backend in ("local", "ssh", "mpi", "sge", "tpu_vm", "yarn",
                        "mesos"):
            mod = importlib.import_module(f"{package}.tracker.{backend}")
            monkeypatch.setattr(
                mod, "submit", lambda o, b=backend: called.append(
                    (b, vars(o))))
        if cluster == "unknown":
            real = opts_mod.get_opts

            def renamed(argv, real=real):
                parsed = real(argv)
                parsed.cluster = "k8s"
                return parsed

            monkeypatch.setattr(opts_mod, "get_opts", renamed)
        rc = main(["--cluster", "local" if cluster == "unknown" else cluster,
                   "--num-workers", "2", "--", "true"])
        out[name] = (rc, called, capsys.readouterr().err)
    assert out["port"] == out["jax"]
    rc, called, err = out["port"]
    if cluster == "unknown":
        assert rc == 2 and called == []
        assert "error: unknown cluster backend 'k8s'" in err
    else:
        assert rc == 0 and [b for b, _ in called] == [cluster.replace("-",
                                                                      "_")]


@pytest.mark.parametrize("env,card", [
    ({"OMPI_COMM_WORLD_RANK": "3"}, 3),
    ({"PMIX_RANK": "6"}, 2),
    ({"SLURM_PROCID": "1"}, 1),
    ({"DMLC_TASK_ID": "2", "OMPI_COMM_WORLD_RANK": "3"}, 2),
    ({"LOCAL_RANK": "1", "DMLC_TASK_ID": "2"}, 1),
], ids=["mpi", "pmix", "slurm", "dmlc-first", "local-rank-first"])
def test_worker_device_takes_the_collective_rank(env, card, monkeypatch):
    """Under mpirun a rank has no DMLC_TASK_ID: its card comes from the
    launcher's rank variable, as its collective rank does, so the ranks
    of a host with several cards do not all land on card 0."""
    from dmlc_core_tpu_torch.utils.device import worker_device

    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    for key in ("LOCAL_RANK", "DMLC_TASK_ID", "OMPI_COMM_WORLD_RANK",
                "PMIX_RANK", "PMI_RANK", "SLURM_PROCID"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DMLC_NUM_WORKER", "4")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert worker_device() == torch.device("cuda", card)
    assert chosen == [torch.device("cuda", card)]
    # an explicit card, the CPU and a single worker stay as they are
    assert worker_device("cuda:0") == torch.device("cuda", 0)
    assert worker_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    assert worker_device() == torch.device("cuda")
    assert len(chosen) == 1


def test_no_command_is_a_usage_error(capsys):
    assert submit.main(["--num-workers", "1"]) == 2
    assert "no worker command" in capsys.readouterr().err


def test_shipping_plan_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "prog.py").write_text("print(1)\n")
    (tmp_path / "extra.cfg").write_text("x\n")
    argv = ["--num-workers", "1", "--files", "extra.cfg#renamed.cfg", "--",
            "python", "prog.py", "--flag"]
    got = filecache.prepare_shipping(opts.get_opts(argv), wrap_launcher=True)
    want = jax_filecache.prepare_shipping(jax_opts.get_opts(argv),
                                          wrap_launcher=True)
    assert got[0] == want[0] and got[2:] == want[2:]
    assert got[1][3:] == want[1][3:] == ["python", "./prog.py", "--flag"]
    assert got[1][:3] == ["python3", "-m",
                          "dmlc_core_tpu_torch.tracker.launcher"]
    filecache.stage_job_dir(got[2], got[3], str(tmp_path / "job"))
    assert sorted(os.listdir(tmp_path / "job")) == ["prog.py", "renamed.cfg"]


# -------------------------------------------------- collective telemetry --
def _collective_calls(collective):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    collective.allreduce(x)
    collective.allreduce(x[0], op="max")
    collective.allgather(x)
    collective.broadcast(x, root=0)


def test_collective_series_equal_jax(monkeypatch):
    from dmlc_core_tpu import collective as jax_collective
    from dmlc_core_tpu_torch import collective

    for key in ("DMLC_COORDINATOR_URI", "DMLC_COORDINATOR_PORT",
                "DMLC_NUM_WORKER", "DMLC_TASK_ID"):
        monkeypatch.delenv(key, raising=False)
    out = {}
    for name, coll, tel in (("jax", jax_collective, jax_telemetry),
                            ("port", collective, telemetry)):
        tel.enable()
        tel.reset()
        coll.init()
        try:
            _collective_calls(coll)
            snap = tel.snapshot()
            values = {(n, json.dumps(s["labels"])): s.get("value", s.get(
                "count")) for n, fam in snap["metrics"].items()
                for s in fam["samples"]}
            spans = sorted(e["name"] for e in tel.get_tracer().events())
            out[name] = (values, spans)
        finally:
            coll.finalize()
            tel.disable()
            tel.reset()
    assert out["port"] == out["jax"]
    values, spans = out["port"]
    assert values[("dmlc_collective_payload_bytes_total",
                   '{"op": "sum"}')] == 24
    assert spans == ["collective.gather", "collective.max", "collective.sum"]


TELEMETRY_WORKER = r"""
import json, os
import numpy as np
from dmlc_core_tpu_torch import collective, telemetry

telemetry.enable()
collective.init({"device": "cpu", "timeout": 60})
rank = collective.get_rank()
x = np.arange(6, dtype=np.float32).reshape(2, 3) + rank
assert collective.allreduce(x).tolist() == (2 * x + 1 - 2 * rank).tolist()
assert collective.broadcast(x if rank == 1 else None, root=1).tolist() \
    == (x + 1 - rank).tolist()
assert collective.allgather(x).shape == (2, 2, 3)
snap = telemetry.snapshot()
out = {n: {s["labels"]["op"]: s.get("value", s.get("count"))
           for s in fam["samples"]} for n, fam in snap["metrics"].items()}
with open(os.path.join(os.environ["RESULT_DIR"], "tel%d.json" % rank),
          "w") as f:
    json.dump(out, f)
collective.finalize()
"""


def test_collective_series_at_world_two(tmp_path):
    """At world 2 a broadcast is two root moves (the shape header, then the
    payload), each counted under ``broadcast`` as in the reference."""
    proc = run_port_workers(tmp_path, TELEMETRY_WORKER, 2, timeout=60)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for rank in range(2):
        got = json.loads((tmp_path / f"tel{rank}.json").read_text())
        assert got["dmlc_collective_ops_total"] == {
            "sum": 1, "broadcast": 2, "gather": 1}
        # header: 10 int32; payload: 6 float32 as bytes
        assert got["dmlc_collective_payload_bytes_total"] == {
            "sum": 24, "broadcast": 40 + 24, "gather": 24}
