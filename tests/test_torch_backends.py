"""PyTorch port vs the JAX package: the launcher backends.

``python -m dmlc_core_tpu_torch.tracker.submit --cluster
ssh|mpi|sge|tpu-vm|yarn|mesos`` on the CPU, with no cluster:

- the cases of ``tests/test_backend_exec.py``: fake ``ssh`` (drops its
  options and runs the remote command through ``sh -c``, as sshd does),
  ``mpirun`` (Open MPI's ``-n``/``-x``; ranks get ``OMPI_COMM_WORLD_RANK``
  and no ``DMLC_TASK_ID``), ``qsub`` (an array job, ``SGE_TASK_ID``) and
  ``gcloud`` (``TPU_WORKER_ID`` per host) on ``PATH``, and port workers
  that do a gloo all-reduce;
- the backend cases of ``tests/test_tracker_ferry.py``, and those of
  ``tests/test_mesos.py``, ``tests/test_yarn.py`` (a mock ResourceManager)
  and ``tests/test_yarn_supervisor.py``, where each supervisor case feeds
  one event sequence to the JAX and the port ``ContainerSupervisor`` and
  requires the same recorded calls;
- for every backend, the argv, run script or REST payload the port builds
  equals the JAX one once ``dmlc_core_tpu`` reads ``dmlc_core_tpu_torch``
  (the tracker's port and trace id, which differ from run to run, are
  masked);
- the slice whole: ``train_gbdt --device cpu`` at world 2 through the
  port's ``--cluster ssh`` and ``--cluster mpi`` fakes grows ensembles
  bitwise equal to ``--cluster local``, and the JAX CLI through the JAX
  ssh fake grows the same trees (splits equal, leaves within rtol = atol
  = 1e-4, as ``tests/test_torch_multiworker.py`` states).
"""

import json
import os
import re
import stat
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from dmlc_core_tpu.collective.api import _task_id_from_env as j_task_id
from dmlc_core_tpu.tracker import mesos as j_mesos
from dmlc_core_tpu.tracker import mpi as j_mpi
from dmlc_core_tpu.tracker import sge as j_sge
from dmlc_core_tpu.tracker import ssh as j_ssh
from dmlc_core_tpu.tracker import tpu_vm as j_tpu_vm
from dmlc_core_tpu.tracker import yarn as j_yarn
from dmlc_core_tpu.tracker import yarn_supervisor as j_sup
from dmlc_core_tpu.tracker.opts import get_opts as j_get_opts
from dmlc_core_tpu_torch.collective.api import _task_id_from_env
from dmlc_core_tpu_torch.tracker import mesos, mpi, sge, ssh, tpu_vm, yarn
from dmlc_core_tpu_torch.tracker import yarn_supervisor as sup
from dmlc_core_tpu_torch.tracker.opts import get_opts
from dmlc_core_tpu_torch.tracker.submit import run_ferried
from tests.test_torch_collective import store_port
from tests.test_torch_multiworker import (F, GBDT_ARGS, N, _blob, _libsvm,
                                          _trained_lines)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"mesos": j_mesos, "mpi": j_mpi, "sge": j_sge, "ssh": j_ssh,
       "tpu-vm": j_tpu_vm, "yarn": j_yarn}
PORT = {"mesos": mesos, "mpi": mpi, "sge": sge, "ssh": ssh,
        "tpu-vm": tpu_vm, "yarn": yarn}
# set by the tracker of each submit; masked before two launches compare
VOLATILE = ("DMLC_TRACKER_PORT", "DMLC_TRACKER_TRACEPARENT")

# a port worker doing a real collective (test_backend_exec.py's WORKER)
WORKER = r"""
import json, os
import numpy as np
from dmlc_core_tpu_torch import collective
from dmlc_core_tpu_torch.collective.api import _task_id_from_env

collective.init({"device": "cpu", "timeout": 60})
rank = collective.get_rank()
world = collective.get_world_size()
assert rank == _task_id_from_env(os.environ), rank
out = collective.allreduce(np.array([float(rank + 1)], dtype=np.float32))
assert abs(float(out[0]) - world * (world + 1) / 2) < 1e-5
with open(os.environ["RESULT_DIR"] + f"/rank{rank}.ok", "w") as f:
    json.dump({"via": os.environ.get("WORKER_VIA", "?"),
               "task_id_env": os.environ.get("DMLC_TASK_ID")}, f)
collective.finalize()
"""

FAKE_SSH = """#!/bin/sh
# fake sshd: swallow ssh options, then run the remote command locally
while [ $# -gt 0 ]; do
  case "$1" in
    -o|-p) shift 2 ;;
    *) break ;;
  esac
done
host="$1"; shift
WORKER_VIA="ssh:$host" ; export WORKER_VIA
exec sh -c "$*"
"""

FAKE_MPIRUN = """#!/usr/bin/env python3
import os, subprocess, sys
args = sys.argv[1:]
if "--version" in args:
    print("mpirun (Open MPI) 9.fake")
    sys.exit(0)
n, env, cmd, i = 1, {}, [], 0
while i < len(args):
    a = args[i]
    if a == "-n":
        n = int(args[i + 1]); i += 2
    elif a == "--hostfile":
        i += 2
    elif a == "-x":
        k, _, v = args[i + 1].partition("="); env[k] = v; i += 2
    else:
        cmd = args[i:]; break
procs = []
for r in range(n):
    e = os.environ.copy(); e.update(env)
    e.pop("DMLC_TASK_ID", None)
    e["OMPI_COMM_WORLD_RANK"] = str(r)
    e["OMPI_COMM_WORLD_SIZE"] = str(n)
    e["WORKER_VIA"] = "mpi"
    procs.append(subprocess.Popen(cmd, env=e))
sys.exit(max([p.wait() for p in procs], default=0))
"""

FAKE_QSUB = """#!/usr/bin/env python3
import os, subprocess, sys
args = sys.argv[1:]
lo = hi = 1
script = args[-1]
for i, a in enumerate(args):
    if a == "-t":
        lo, hi = (int(x) for x in args[i + 1].split("-"))
procs = []
for t in range(lo, hi + 1):
    e = os.environ.copy()
    e["SGE_TASK_ID"] = str(t)
    e["WORKER_VIA"] = "sge"
    procs.append(subprocess.Popen(["/bin/bash", script], env=e))
sys.exit(max([p.wait() for p in procs], default=0))
"""

FAKE_GCLOUD = """#!/usr/bin/env python3
import os, subprocess, sys
cmd = None
for a in sys.argv[1:]:
    if a.startswith("--command="):
        cmd = a[len("--command="):]
assert cmd, sys.argv
n = int(os.environ.get("FAKE_TPU_HOSTS", "2"))
procs = []
for w in range(n):
    e = os.environ.copy()
    e["TPU_WORKER_ID"] = str(w)
    e["WORKER_VIA"] = "tpu-vm"
    procs.append(subprocess.Popen(["/bin/sh", "-c", cmd], env=e))
sys.exit(max([p.wait() for p in procs], default=0))
"""


def _write_fakes(bindir):
    bindir.mkdir(exist_ok=True)
    for name, body in (("ssh", FAKE_SSH), ("mpirun", FAKE_MPIRUN),
                       ("qsub", FAKE_QSUB), ("gcloud", FAKE_GCLOUD)):
        p = bindir / name
        p.write_text(body)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)


@pytest.fixture()
def fake_cluster(tmp_path, monkeypatch):
    """Fake cluster binaries on PATH and a port worker script."""
    _write_fakes(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    monkeypatch.setenv("RESULT_DIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH",
                       REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    monkeypatch.delenv("DMLC_TASK_ID", raising=False)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    return tmp_path, worker


def _opts(*argv):
    """Options of a launch whose store has a port of its own (launches of
    parallel test processes would otherwise probe the same one)."""
    head, sep, cmd = list(argv), [], []
    if "--" in head:
        i = head.index("--")
        head, sep, cmd = head[:i], ["--"], head[i + 1:]
    return get_opts(head + ["--env", f"DMLC_COORDINATOR_PORT={store_port()}",
                            "--host-ip", "127.0.0.1"] + sep + cmd)


def _no_wait_submit(module, monkeypatch, seen=None):
    """Submit without joining the tracker (the workers never dial it); the
    tracker's per-run values go into ``seen``."""
    orig = module.submit_job

    def no_wait(opts_, fun, wait=True):
        def record(envs):
            if seen is not None:
                seen.update({k: envs[k] for k in VOLATILE if k in envs})
            return fun(envs)
        return orig(opts_, record, wait=False)

    monkeypatch.setattr(module, "submit_job", no_wait)


def _ranks(tmp_path, n):
    out = []
    for r in range(n):
        f = tmp_path / f"rank{r}.ok"
        assert f.exists(), f"rank {r} never completed"
        out.append(json.loads(f.read_text()))
    return out


# -- execution with fake cluster binaries (test_backend_exec.py) -------------

def test_ssh_backend_executes_workers(fake_cluster):
    tmp_path, worker = fake_cluster
    hostfile = tmp_path / "hosts"
    hostfile.write_text("nodeA\nnodeB:2222\n")
    ssh.submit(_opts("--cluster", "ssh", "--num-workers", "2",
                     "--host-file", str(hostfile), "--",
                     sys.executable, str(worker)))
    ranks = _ranks(tmp_path, 2)
    assert {r["via"] for r in ranks} == {"ssh:nodeA", "ssh:nodeB"}
    assert [r["task_id_env"] for r in ranks] == ["0", "1"]


def test_mpi_backend_executes_workers(fake_cluster):
    """mpirun's ranks carry no DMLC_TASK_ID: each takes its rank from
    OMPI_COMM_WORLD_RANK."""
    tmp_path, worker = fake_cluster
    mpi.submit(_opts("--cluster", "mpi", "--num-workers", "2", "--",
                     sys.executable, str(worker)))
    ranks = _ranks(tmp_path, 2)
    assert [r["via"] for r in ranks] == ["mpi", "mpi"]
    assert [r["task_id_env"] for r in ranks] == [None, None]


def test_sge_backend_executes_workers(fake_cluster, monkeypatch):
    work, worker = fake_cluster
    _no_wait_submit(sge, monkeypatch)     # the workers never dial the tracker
    monkeypatch.chdir(work)
    sge.submit(_opts("--cluster", "sge", "--num-workers", "2",
                     "--jobname", "sgejob", "--",
                     sys.executable, str(worker)))
    assert [r["via"] for r in _ranks(work, 2)] == ["sge", "sge"]
    assert (work / "sgejob.sge.sh").exists()


ENVS = [{"DMLC_TASK_ID": "3"}, {"OMPI_COMM_WORLD_RANK": "2"},
        {"DMLC_TASK_ID": "1", "OMPI_COMM_WORLD_RANK": "7"},
        {"PMIX_RANK": "5"}, {"PMI_RANK": ""}, {"SLURM_PROCID": "garbage"},
        {"PMI_RANK": "x", "SLURM_PROCID": "4"}, {}]


def test_task_id_env_fallback_equals_jax(capsys):
    got = [_task_id_from_env(env) for env in ENVS]
    assert got == [j_task_id(env) for env in ENVS]
    assert got == [3, 2, 1, 5, 0, 0, 4, 0]
    err = capsys.readouterr().err
    assert err.count("ignoring non-integer") == 4


def test_sge_task_ids_are_role_relative(fake_cluster, monkeypatch):
    work, _ = fake_cluster
    _no_wait_submit(sge, monkeypatch)
    monkeypatch.chdir(work)
    probe = work / "probe.py"
    probe.write_text(
        "import os\n"
        "role = os.environ['DMLC_ROLE']\n"
        "tid = os.environ['DMLC_TASK_ID']\n"
        "open(os.environ['RESULT_DIR'] + f'/{role}{tid}.seen', 'w').close()\n")
    sge.submit(_opts("--cluster", "sge", "--num-workers", "2",
                     "--num-servers", "1", "--jobname", "rolejob", "--",
                     sys.executable, str(probe)))
    for name in ("server0", "worker0", "worker1"):
        assert (work / f"{name}.seen").exists(), name


def test_tpu_vm_backend_hostfile_path(fake_cluster):
    tmp_path, worker = fake_cluster
    hostfile = tmp_path / "tpu_hosts"
    hostfile.write_text("tpu-w0\ntpu-w1\n")
    tpu_vm.submit(_opts("--cluster", "tpu-vm", "--num-workers", "2",
                        "--host-file", str(hostfile), "--",
                        sys.executable, str(worker)))
    assert {r["via"] for r in _ranks(tmp_path, 2)} == {"ssh:tpu-w0",
                                                       "ssh:tpu-w1"}


def test_tpu_vm_backend_gcloud_path(fake_cluster, monkeypatch):
    """Each host's DMLC_TASK_ID expands there from its TPU_WORKER_ID."""
    tmp_path, worker = fake_cluster
    monkeypatch.setenv("TPU_NAME", "fake-slice")
    monkeypatch.setenv("FAKE_TPU_HOSTS", "2")
    tpu_vm.submit(_opts("--cluster", "tpu-vm", "--num-workers", "2", "--",
                        sys.executable, str(worker)))
    ranks = _ranks(tmp_path, 2)
    assert [r["via"] for r in ranks] == ["tpu-vm", "tpu-vm"]
    assert [r["task_id_env"] for r in ranks] == ["0", "1"]


def test_tpu_vm_gcloud_path_ships_files(fake_cluster, monkeypatch):
    """--files on the gcloud path: the port's launcher materializes the
    file in each task's own cwd, so a resubmit never reads a stale copy."""
    tmp_path, _ = fake_cluster
    monkeypatch.setenv("TPU_NAME", "fake-slice")
    monkeypatch.setenv("FAKE_TPU_HOSTS", "2")
    monkeypatch.setenv("DMLC_REMOTE_PYTHON", sys.executable)
    payload = tmp_path / "manifest.txt"
    rundir = tmp_path / "rundir"
    rundir.mkdir()
    monkeypatch.chdir(rundir)
    reader = tmp_path / "read_manifest.py"
    reader.write_text(
        "import os\n"
        "tid = os.environ['DMLC_TASK_ID']\n"
        "body = open('manifest.txt').read().strip()\n"
        "open(os.environ['RESULT_DIR'] + f'/ship{tid}.out', 'w')"
        ".write(body + ' ' + os.path.basename(os.path.dirname(os.getcwd())))"
        "\n")
    for text in ("shipped-manifest", "edited-manifest"):
        payload.write_text(text + "\n")
        tpu_vm.submit(_opts("--cluster", "tpu-vm", "--num-workers", "2",
                            "--files", str(payload), "--",
                            sys.executable, str(reader)))
        for tid in range(2):
            assert (tmp_path / f"ship{tid}.out").read_text() == \
                f"{text} dmlc-jobs"


# -- failures propagate (test_tracker_ferry.py) ------------------------------

def _boom(cmd, *a, **kw):
    raise subprocess.CalledProcessError(255, cmd)


@pytest.mark.parametrize("cluster", ["ssh", "mpi", "tpu-vm"])
def test_submit_raises_on_task_failure(cluster, monkeypatch, tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("unreachable-host-a\nunreachable-host-b\n")
    monkeypatch.setattr(mpi, "_detect_mpi_env_flag", lambda: "-x")
    monkeypatch.setattr(subprocess, "check_call", _boom)
    extra = [] if cluster == "mpi" else ["--host-file", str(hf)]
    with pytest.raises(subprocess.CalledProcessError):
        PORT[cluster].submit(_opts("--cluster", cluster, "--num-workers",
                                   "2", *extra, "--", "true"))


def test_run_ferried_raises_first_error_after_all_join():
    ran = []

    def bad():
        raise ValueError("task exploded")

    with pytest.raises(ValueError, match="task exploded"):
        run_ferried([("a", lambda: ran.append(1)), ("boom", bad),
                     ("b", lambda: ran.append(2))])
    assert sorted(ran) == [1, 2]
    run_ferried([("c", lambda: ran.append(3))])
    assert 3 in ran


# -- what each backend builds, against the JAX package's ---------------------

def _norm(value, seen):
    """``value`` with the port's package name read as the JAX one's and
    the tracker's per-run values masked."""
    if isinstance(value, dict):
        return {_norm(k, seen): _norm(v, seen) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_norm(v, seen) for v in value]
    if not isinstance(value, str):
        return value
    value = value.replace("dmlc_core_tpu_torch", "dmlc_core_tpu")
    for key in VOLATILE:
        if seen.get(key):
            value = re.sub(rf"\b{re.escape(seen[key])}\b", f"<{key}>", value)
    return re.sub(r"dmlc-[0-9a-f-]{36}", "dmlc-<uuid>", value)


def _built(cluster, argv, monkeypatch, patch=None):
    """(JAX, port) lists of what each package's backend hands to the
    cluster for one argv, normalized."""
    out = []
    port = store_port()
    for mods, get in ((JAX, j_get_opts), (PORT, get_opts)):
        mod = mods[cluster]
        calls, seen = [], {}
        _no_wait_submit(mod, monkeypatch, seen)
        monkeypatch.setattr(subprocess, "check_call",
                            lambda cmd, *a, **kw: calls.append(list(cmd)))
        if patch is not None:
            patch(mod, calls)
        head = argv[:argv.index("--")]
        mod.submit(get(head + ["--env", f"DMLC_COORDINATOR_PORT={port}",
                               "--host-ip", "127.0.0.1"]
                       + argv[argv.index("--"):]))
        # tasks start on threads of their own: order is not part of it
        out.append(sorted(_norm(calls, seen), key=json.dumps))
    return out


CMD = ["--", "python3", "train.py", "--data", "a b.libsvm", "--lr=0.1"]


@pytest.mark.parametrize("servers", ["0", "1"])
def test_ssh_commands_equal_jax(servers, tmp_path, monkeypatch):
    hf = tmp_path / "hosts"
    hf.write_text("h1\nh2:2200  # a comment\n\n")
    monkeypatch.setenv("AWS_REGION", "us-east-1")
    monkeypatch.chdir(tmp_path)
    want, got = _built("ssh", ["--cluster", "ssh", "--num-workers", "2",
                               "--num-servers", servers, "--host-file",
                               str(hf), *CMD], monkeypatch)
    assert got == want
    assert len(got) == 2 + int(servers)
    assert "export AWS_REGION=us-east-1" in got[0][-1]
    assert ssh.parse_host_file(str(hf)) == j_ssh.parse_host_file(str(hf)) \
        == [("h1", 22), ("h2", 2200)]
    assert ssh.FORWARD_ENV == j_ssh.FORWARD_ENV


def test_ssh_unpack_prelude_equals_jax():
    assert ssh._REMOTE_UNZIP == j_ssh._REMOTE_UNZIP
    specs = ["/x/data.zip#data", "/y/model.zip"]
    assert ssh._unpack_prelude(specs) == j_ssh._unpack_prelude(specs)
    args = ("h", 22, {"A": "x y", "B": "$HOME"}, "/w d", ["a", "b c"], "pre")
    assert ssh._ssh_command(*args) == j_ssh._ssh_command(*args)


@pytest.mark.parametrize("flavour", ["Open MPI", "HYDRA (MPICH)"])
def test_mpi_commands_equal_jax(flavour, tmp_path, monkeypatch):
    def patch(mod, calls):
        def run(cmd, **kw):
            return subprocess.CompletedProcess(cmd, 0, f"mpirun ({flavour})",
                                               "")
        monkeypatch.setattr(subprocess, "run", run)

    hf = tmp_path / "hosts"
    hf.write_text("h1\n")
    want, got = _built("mpi", ["--cluster", "mpi", "--num-workers", "2",
                               "--num-servers", "1", "--host-file", str(hf),
                               *CMD], monkeypatch, patch)
    assert got == want
    flag = "-x" if flavour == "Open MPI" else "-env"
    assert all(flag in cmd for cmd in got)
    assert mpi._detect_mpi_env_flag() == ("-x" if flavour == "Open MPI"
                                          else "-env")


@pytest.mark.parametrize("ship", [False, True])
def test_sge_runscripts_equal_jax(ship, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    payload = tmp_path / "conf.txt"
    payload.write_text("x")
    extra = ["--files", str(payload)] if ship else []

    def patch(mod, calls):
        # the qsub argv, then the run script it names
        monkeypatch.setattr(subprocess, "check_call", lambda cmd, *a, **kw:
                            calls.append(list(cmd) + [open(cmd[-1]).read()]))

    want, got = _built("sge", ["--cluster", "sge", "--num-workers", "3",
                               "--num-servers", "1", "--jobname", "j",
                               "--queue", "q.long", *extra, *CMD],
                       monkeypatch, patch)
    assert got == want
    (qsub,) = got
    assert qsub[:6] == ["qsub", "-cwd", "-t", "1-4", "-pe", "smp"]
    assert "export DMLC_TASK_ID=$((GLOBAL_ID - 1))" in qsub[-1]
    assert ("dmlc_core_tpu.tracker.launcher" in qsub[-1]) == ship


def test_tpu_vm_gcloud_commands_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_NAME", "slice-a")
    monkeypatch.setenv("TPU_ZONE", "us-central2-b")
    payload = tmp_path / "conf.txt"
    payload.write_text("x")
    for extra in ([], ["--files", str(payload)]):
        want, got = _built("tpu-vm", ["--cluster", "tpu-vm", "--num-workers",
                                      "4", *extra, *CMD], monkeypatch)
        assert got[0][:7] == ["gcloud", "compute", "tpus", "tpu-vm", "ssh",
                              "slice-a", "--worker=all"]
        assert 'export DMLC_TASK_ID="${TPU_WORKER_ID:-0}"' in got[0][7]
        # a job with files gets a cwd of its own, named at random
        masked = [re.sub(r"dmlc-jobs/[\w.-]+", "<cwd>", json.dumps(c))
                  for c in (got, want)]
        assert masked[0] == masked[1]
    env = {"K": "v w"}
    assert tpu_vm._gcloud_cmd(env, ["a"]) == j_tpu_vm._gcloud_cmd(env, ["a"])


def _mesos_launches(mod, monkeypatch):
    launched = []
    monkeypatch.setattr(mod, "_run_task", lambda *a: launched.append(a))
    return launched


def test_mesos_tasks_equal_jax(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    monkeypatch.setenv("KMP_AFFINITY", "compact")
    argv = ["--cluster", "mesos", "--num-workers", "2", "--num-servers", "1",
            "--mesos-master", "master-host", "--worker-cores", "2",
            "--worker-memory", "2g", "--", "python", "train.py"]
    out = []
    for mods, get in ((JAX, j_get_opts), (PORT, get_opts)):
        launched = _mesos_launches(mods["mesos"], monkeypatch)
        seen = {}
        _no_wait_submit(mods["mesos"], monkeypatch, seen)
        mods["mesos"].submit(get(argv[:-3] + ["--env",
                                              "DMLC_COORDINATOR_PORT=1",
                                              "--host-ip", "127.0.0.1"]
                                 + argv[-3:]))
        out.append(sorted(json.dumps(_norm(list(a), seen), sort_keys=True)
                          for a in launched))
    assert out[1] == out[0]
    res = {"cpus": 2.0, "mem": 64.0}
    want = _norm(j_mesos._mesos_execute_argv("m:5050", "p", {"A": "1"}, res),
                 {})
    assert _norm(mesos._mesos_execute_argv("m:5050", "p", {"A": "1"}, res),
                 {}) == want


# -- mesos (test_mesos.py) ---------------------------------------------------

def test_mesos_requires_master(monkeypatch):
    monkeypatch.delenv("MESOS_MASTER", raising=False)
    with pytest.raises(RuntimeError, match="MESOS_MASTER"):
        mesos.submit(get_opts(["--cluster", "mesos", "--num-workers", "1",
                               "--", "true"]))


def test_mesos_master_default_port(monkeypatch):
    monkeypatch.setenv("MESOS_MASTER", "m1")
    opts = get_opts(["--cluster", "mesos", "--num-workers", "1", "--",
                     "true"])
    assert mesos._resolve_master(opts) == j_mesos._resolve_master(opts) \
        == "m1:5050"


def test_mesos_explicit_env_wins_over_forwarded(monkeypatch):
    launched = _mesos_launches(mesos, monkeypatch)
    monkeypatch.setenv("LD_LIBRARY_PATH", "/shell/lib")
    mesos.submit(_opts("--cluster", "mesos", "--num-workers", "1",
                       "--mesos-master", "m", "--env",
                       "LD_LIBRARY_PATH=/custom/lib", "--", "true"))
    assert launched[0][2]["LD_LIBRARY_PATH"] == "/custom/lib"


def test_mesos_submit_tasks(monkeypatch):
    launched = _mesos_launches(mesos, monkeypatch)
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    monkeypatch.setenv("PYTHONPATH", "/not/forwarded")
    mesos.submit(_opts("--cluster", "mesos", "--num-workers", "2",
                       "--num-servers", "1", "--mesos-master", "master-host",
                       "--worker-cores", "2", "--worker-memory", "2g",
                       "--server-cores", "1", "--server-memory", "512m",
                       "--", "python", "train.py"))
    assert len(launched) == 3
    by_role = sorted((env["DMLC_ROLE"], env["DMLC_TASK_ID"])
                     for _, _, env, _ in launched)
    assert by_role == [("server", "0"), ("worker", "0"), ("worker", "1")]
    for master, prog, env, resources in launched:
        assert master == "master-host:5050"
        assert prog == "python train.py"
        assert env["OMP_NUM_THREADS"] == "3"
        assert "PYTHONPATH" not in env        # only the three are forwarded
        if env["DMLC_ROLE"] == "server":
            assert env["DMLC_SERVER_ID"] == "0"
            assert resources == {"cpus": 1.0, "mem": 512.0}
        else:
            assert env["DMLC_WORKER_ID"] in ("0", "1")
            assert resources == {"cpus": 2.0, "mem": 2048.0}


def test_mesos_execute_argv():
    argv = mesos._mesos_execute_argv(
        "m1:5050", "python train.py", {"A": "1"}, {"cpus": 2.0, "mem": 64.0})
    assert argv[0] == "mesos-execute"
    assert argv[1] == "--master=m1:5050"
    assert argv[3].startswith("--command=cd ")
    assert argv[3].endswith("&& python train.py")
    assert json.loads(argv[4][len("--env="):]) == {"A": "1"}
    assert argv[5] == "--resources=cpus:2.0;mem:64.0"


# -- yarn: a mock ResourceManager (test_yarn.py, test_yarn_supervisor.py) ----

class StatefulMockRM:
    """Apps go NEW -> RUNNING(node) -> terminal; ``node_plan`` gives the
    node of each submission in order, ``fail_plan`` the ordinals that
    fail."""

    def __init__(self, node_plan=("node0",), fail_plan=()):
        self.node_plan = list(node_plan)
        self.fail_plan = set(fail_plan)
        self.apps = {}
        self.submissions = []
        self.kills = []
        self.diagnostics = "boom"
        self._lock = threading.Lock()
        self._n = 0

    def start(self):
        store = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _reply(self, status, obj):
                out = json.dumps(obj).encode() if obj is not None else b""
                self.send_response(status)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))
                with store._lock:
                    if self.path.endswith("new-application"):
                        app_id = f"app_{store._n}"
                        store._n += 1
                        self._reply(200, {"application-id": app_id})
                        return
                    if self.path.endswith("/apps"):
                        sub_ = json.loads(body)
                        ordinal = len(store.submissions)
                        store.submissions.append(sub_)
                        store.apps[sub_["application-id"]] = {
                            "node": store.node_plan[
                                min(ordinal, len(store.node_plan) - 1)],
                            "polls": 0, "fails": ordinal in store.fail_plan}
                        self._reply(202, None)
                        return
                self._reply(404, None)

            def do_PUT(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with store._lock:
                    app_id = self.path.split("/")[-2]
                    store.kills.append(app_id)
                    if app_id in store.apps:
                        store.apps[app_id]["killed"] = True
                    self._reply(200, None)

            def do_GET(self):
                with store._lock:
                    app = store.apps.get(self.path.rsplit("/", 1)[-1])
                    if app is None:
                        self._reply(404, None)
                        return
                    app["polls"] += 1
                    if app.get("killed"):
                        state, final = "KILLED", "KILLED"
                    elif app["polls"] <= 1:
                        state, final = "RUNNING", "UNDEFINED"
                    elif app["fails"]:
                        state, final = "FAILED", "FAILED"
                    else:
                        state, final = "FINISHED", "SUCCEEDED"
                    self._reply(200, {"app": {
                        "state": state, "finalStatus": final,
                        "amHostHttpAddress": f"{app['node']}:8042",
                        "diagnostics":
                            store.diagnostics if app["fails"] else ""}})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.uri = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def _fast_supervise(orig):
    def fast(cluster, num_workers, num_servers, poll_interval=2.0, **kw):
        return orig(cluster, num_workers, num_servers, poll_interval=0.01)
    return fast


def test_yarn_submit_payloads_equal_jax(monkeypatch):
    argv = ["--cluster", "yarn", "--num-workers", "4", "--num-servers", "1",
            "--worker-memory", "2g", "--worker-cores", "2", "--server-memory",
            "1g", "--jobname", "test-job", "--", "python", "train.py"]
    out = []
    for mods, get in ((JAX, j_get_opts), (PORT, get_opts)):
        rm = StatefulMockRM().start()
        try:
            monkeypatch.setenv("YARN_RM_URI", rm.uri)
            seen = {}
            _no_wait_submit(mods["yarn"], monkeypatch, seen)
            monkeypatch.setattr(mods["yarn"], "supervise",
                                _fast_supervise(mods["yarn"].supervise))
            mods["yarn"].submit(get(argv[:-3] + [
                "--env", "DMLC_COORDINATOR_PORT=1", "--host-ip",
                "127.0.0.1"] + argv[-3:]))
        finally:
            rm.stop()
        out.append((_norm(rm.submissions, seen), rm.kills))
    assert out[1] == out[0]
    subs = out[1][0]
    assert len(subs) == 5
    assert [s["application-name"] for s in subs] == \
        [f"test-job[{i}]:worker" for i in range(4)] + ["test-job[4]:server"]
    for i, s in enumerate(subs[:4]):
        assert s["max-app-attempts"] == 1
        assert s["resource"] == {"memory": 2048, "vCores": 2}
        cmd = s["am-container-spec"]["commands"]["command"]
        assert f"DMLC_TASK_ID='{i}'" in cmd and "python train.py" in cmd
    port_cmd = yarn._launch_command(
        get_opts(argv), {"K": "v"}, sup.TaskRecord(2, "worker", 1))
    assert "-m dmlc_core_tpu_torch.tracker.launcher python train.py" \
        in port_cmd
    assert _norm(port_cmd, {}) == j_yarn._launch_command(
        j_get_opts(argv), {"K": "v"}, j_sup.TaskRecord(2, "worker", 1))


def test_yarn_needs_a_resource_manager(monkeypatch):
    monkeypatch.delenv("YARN_RM_URI", raising=False)
    with pytest.raises(Exception, match="YARN_RM_URI"):
        yarn.submit(get_opts(["--cluster", "yarn", "--num-workers", "1",
                              "--", "true"]))


@pytest.mark.parametrize("diag,status", [
    ("Container is running beyond physical memory limits", -104),
    ("... is running BEYOND VIRTUAL MEMORY limits ...", -103),
    ("exit code 1", -1), ("", -1)])
def test_exit_status_from_diag_equals_jax(diag, status):
    assert yarn._exit_status_from_diag(diag) == \
        j_yarn._exit_status_from_diag(diag) == status


# -- the container supervisor, both packages on one event sequence ----------

class FakeCluster:
    """Records every call; hands out containers through offer()."""

    def __init__(self, mod):
        self.mod = mod
        self.calls = []
        self._serial = 0

    def request_containers(self, tasks):
        self.calls.append(("request", [t.task_id for t in tasks]))

    def launch(self, container, task):
        self.calls.append(("launch", container.container_id, container.node,
                           task.task_id))

    def burn(self, container):
        self.calls.append(("burn", container.container_id))

    def release(self, container):
        self.calls.append(("release", container.container_id))

    def stop(self, container):
        self.calls.append(("stop", container.container_id))

    def cancel_requests(self, tasks):
        self.calls.append(("cancel", [t.task_id for t in tasks]))

    def offer(self, s, node, task_id=None):
        self._serial += 1
        c = self.mod.Container(f"c{self._serial}", node, task_id=task_id)
        s.on_containers_allocated([c])
        return c


def _state(s):
    return dict(done=s.done, aborted=s.aborted, blacklist=sorted(s.blacklist),
                attempts=[t.attempts for t in s.tasks],
                finished=[t.task_id for t in s.finished],
                killed=[t.task_id for t in s.killed],
                pending=[t.task_id for t in s.pending],
                running=sorted(s.running))


def _events_retry_elsewhere(m, s, fc):
    c1, c2 = fc.offer(s, "badnode"), fc.offer(s, "badnode")
    s.on_container_completed(c1.container_id, 1, "exit 1")
    s.on_container_completed(c2.container_id, 1, "exit 1")
    fc.offer(s, "badnode")
    c3, c4 = fc.offer(s, "goodnode"), fc.offer(s, "goodnode")
    s.on_container_completed(c3.container_id, 0)
    s.on_container_completed(c4.container_id, 0)


def _events_exhaustion(m, s, fc):
    for i in range(2):
        c = fc.offer(s, f"node{i}")
        s.on_container_completed(c.container_id, 1)
    c = fc.offer(s, "node3")
    s.on_container_completed(c.container_id, 1)


def _events_memory_kill(m, s, fc):
    c1 = fc.offer(s, "a")
    fc.offer(s, "b")
    s.on_container_completed(c1.container_id, m.EXIT_KILLED_PMEM)


def _events_vmem_kill(m, s, fc):
    c1 = fc.offer(s, "a")
    s.on_container_completed(c1.container_id, m.EXIT_KILLED_VMEM)


def _events_surplus(m, s, fc):
    fc.offer(s, "a")
    fc.offer(s, "b")


def _events_launch_error(m, s, fc):
    c = fc.offer(s, "flaky")
    s.on_container_error(c.container_id, "NM start failed")


def _events_task_bound(m, s, fc):
    fc.offer(s, "n1", task_id=1)
    fc.offer(s, "n0", task_id=0)
    s.on_container_completed("c1", 1)


def _events_unreported(m, s, fc):
    s.on_unreported_completion(m.Container("x0", "", task_id=0), 1, "died")
    s.on_unreported_completion(m.Container("x1", "n", task_id=1), 0)
    c = fc.offer(s, "n2", task_id=0)
    s.on_container_completed(c.container_id, 0)


def _events_unknown_ids(m, s, fc):
    s.on_container_completed("nobody", 1)
    s.on_container_error("nobody", "lost")
    c = fc.offer(s, "n")
    s.on_container_completed(c.container_id, 0)


def _events_after_abort(m, s, fc):
    c = fc.offer(s, "a")
    try:
        s.on_container_completed(c.container_id, m.EXIT_KILLED_PMEM)
    except m.JobAbort:
        pass
    fc.offer(s, "b")


SCENARIOS = {
    "retry_elsewhere": (_events_retry_elsewhere, dict(num_workers=2)),
    "exhaustion": (_events_exhaustion, dict(num_workers=1)),
    "memory_kill": (_events_memory_kill, dict(num_workers=2)),
    "vmem_kill": (_events_vmem_kill, dict(num_workers=1, num_servers=1)),
    "surplus": (_events_surplus, dict(num_workers=1)),
    "launch_error": (_events_launch_error, dict(num_workers=1)),
    "task_bound": (_events_task_bound, dict(num_workers=2)),
    "unreported": (_events_unreported, dict(num_workers=2)),
    "unknown_ids": (_events_unknown_ids, dict(num_workers=1)),
    "after_abort": (_events_after_abort, dict(num_workers=1,
                                              num_servers=1)),
}


def _run_scenario(mod, events, kw):
    fc = FakeCluster(mod)
    s = mod.ContainerSupervisor(fc, max_attempts=3, **kw)
    s.start()
    error = None
    try:
        events(mod, s, fc)
    except mod.JobAbort as exc:
        error = str(exc)
    return dict(calls=fc.calls, error=error, **_state(s))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_records_the_jax_calls(name):
    events, kw = SCENARIOS[name]
    got = _run_scenario(sup, events, kw)
    assert got == _run_scenario(j_sup, events, kw)
    if name == "retry_elsewhere":
        assert got["done"] and got["blacklist"] == ["badnode"]
        assert ("burn", "c3") in got["calls"] and got["attempts"] == [1, 1]
    elif name == "exhaustion":
        assert "failed more than 3" in got["error"]
    elif name in ("memory_kill", "vmem_kill"):
        assert "memory" in got["error"]
    elif name == "task_bound":
        assert got["attempts"] == [0, 1]


def test_supervisor_max_attempts_from_env(monkeypatch):
    monkeypatch.setenv("DMLC_MAX_ATTEMPT", "5")
    assert sup.ContainerSupervisor(FakeCluster(sup), 1).max_attempts == \
        j_sup.ContainerSupervisor(FakeCluster(j_sup), 1).max_attempts == 5


def _yarn_opts(get, n):
    return get(["--cluster", "yarn", "--num-workers", str(n),
                "--worker-memory", "1g", "--jobname", "sup-job", "--",
                "python", "train.py"])


def _rest_case(mods, name):
    """One supervision run over REST against a fresh mock RM; returns what
    the RM saw and how the supervisor ended."""
    get = j_get_opts if mods is JAX else get_opts
    y = mods["yarn"]
    s_mod = j_sup if mods is JAX else sup
    plans = {
        "retry": (["node-a", "node-b", "node-b"], {0}, 2),
        "burn": (["node-a", "node-a", "node-b"], {0}, 1),
        "abort": (["n0", "n1", "n2"], {0, 1, 2}, 1),
        "no_node": (["", "node-b"], {0}, 1),
        "pmem": (["node-a"], {0}, 1),
        "pending_killed": (["n0", "n1"], set(), 2),
        "lost": (["n0", "n1"], set(), 1),
        "outage": (["n0", "n1"], {0}, 1),
        "fast_fail": (["node-a", "node-b"], {0}, 1),
    }
    nodes, fails, n = plans[name]
    rm = StatefulMockRM(nodes, fails).start()
    if name == "pmem":
        rm.diagnostics = ("Container killed: is running beyond physical "
                          "memory limits. Killing container.")
    error, s = None, None
    try:
        cluster = y.RestYarnCluster(rm.uri, _yarn_opts(get, n),
                                    {"DMLC_NUM_WORKER": str(n)})
        if name == "lost":
            apps = rm.apps

            class Forgetful(dict):
                def get(self, key, default=None):
                    return None if key == "app_0" else \
                        dict.get(self, key, default)

            rm.apps = Forgetful(apps)
        if name == "outage":
            orig = cluster._submit_app
            armed = [True]

            def flaky(task):
                if task.attempts == 1 and armed[0]:
                    armed[0] = False
                    raise OSError("connection refused (simulated outage)")
                orig(task)

            cluster._submit_app = flaky
        try:
            if name == "pending_killed":
                s = s_mod.ContainerSupervisor(cluster, num_workers=2,
                                              max_attempts=1)
                s.start()
                s.on_containers_allocated(
                    [s_mod.Container("app_0", "n0", task_id=0)])
                s.on_container_completed("app_0", 1)
            elif name == "fast_fail":
                s = s_mod.ContainerSupervisor(cluster, num_workers=1,
                                              max_attempts=3)
                s.blacklist.add("node-a")
                s.start()
                rm.apps["app_0"]["polls"] = 1
                cluster.poll(s)
            else:
                s = y.supervise(cluster, num_workers=n, num_servers=0,
                                poll_interval=0.01)
        except s_mod.JobAbort as exc:
            error = str(exc)
        live = list(cluster.live)
    finally:
        rm.stop()
    subs = [(x["application-id"], x["application-name"],
             _norm(x["am-container-spec"]["commands"]["command"], {}))
            for x in rm.submissions]
    return dict(subs=subs, kills=rm.kills, error=error, live=live,
                **(_state(s) if s is not None else {}))


@pytest.mark.parametrize("name", ["retry", "burn", "abort", "no_node",
                                  "pmem", "pending_killed", "lost", "outage",
                                  "fast_fail"])
def test_rest_supervision_equals_jax(name):
    got = _rest_case(PORT, name)
    assert got == _rest_case(JAX, name)
    if name == "retry":
        assert got["done"] and got["blacklist"] == ["node-a"]
        assert len(got["subs"]) == 3
        assert "DMLC_NUM_ATTEMPT='1'" in got["subs"][2][2]
    elif name == "burn":
        assert got["kills"] == ["app_0", "app_1"]
    elif name == "abort":
        assert "failed more than 3" in got["error"]
    elif name == "no_node":
        assert got["done"] and "" not in got["blacklist"]
    elif name == "pmem":
        assert "physical memory" in got["error"]
    elif name == "pending_killed":
        assert "app_1" in got["kills"] and got["live"] == []
    elif name in ("lost", "outage"):
        assert got["done"] and got["attempts"] == [1]
    elif name == "fast_fail":
        assert got["attempts"] == [1] and len(got["subs"]) == 2


# -- the slice whole: train_gbdt at world 2 through the backends ------------

PORT_WRAPPER = r"""
import os, sys
import numpy as np
from dmlc_core_tpu_torch.collective.api import _task_id_from_env
from dmlc_core_tpu_torch.examples import train_gbdt

tag, argv = sys.argv[1], sys.argv[2:]
out = train_gbdt.main(argv)
arrays = {k: v.numpy() for k, v in out[0]._asdict().items() if v is not None}
rank = _task_id_from_env(os.environ)
np.savez(os.path.join(os.environ["RESULT_DIR"], f"{tag}-rank{rank}.npz"),
         **arrays)
"""
SLICE_TIMEOUT = 180


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("backends_slice")
    _write_fakes(tmp / "bin")
    data = _libsvm(tmp / "train.libsvm", N, F, 0)
    hosts = tmp / "hosts"
    hosts.write_text("localhost\nlocalhost\n")
    wrapper = tmp / "wrapper.py"
    wrapper.write_text(PORT_WRAPPER)
    common = ["--data", data, "--num-feature", str(F), *GBDT_ARGS]
    env = os.environ.copy()
    env.update(RESULT_DIR=str(tmp), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               DMLC_COLLECTIVE_TIMEOUT="60",
               PATH=f"{tmp / 'bin'}:{env['PATH']}",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    env.pop("DMLC_TASK_ID", None)
    port_cmd = [sys.executable, str(wrapper)]
    launches = {
        "local": ("dmlc_core_tpu_torch", ["--cluster", "local"],
                  [*port_cmd, "local", *common, "--device", "cpu"]),
        "ssh": ("dmlc_core_tpu_torch", ["--cluster", "ssh", "--host-file",
                                        str(hosts)],
                [*port_cmd, "ssh", *common, "--device", "cpu"]),
        "mpi": ("dmlc_core_tpu_torch", ["--cluster", "mpi"],
                [*port_cmd, "mpi", *common, "--device", "cpu"]),
        "jax_ssh": ("dmlc_core_tpu", ["--cluster", "ssh", "--host-file",
                                      str(hosts)],
                    [sys.executable, "examples/train_gbdt.py", *common,
                     "--checkpoint", str(tmp / "jax_gbdt.bin")]),
    }
    procs = {}
    for name, (package, args, cmd) in launches.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", f"{package}.tracker.submit",
             "--num-workers", "2", "--env",
             f"DMLC_COORDINATOR_PORT={store_port()}", *args, "--", *cmd],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=SLICE_TIMEOUT)
            out[name] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name, (rc, _, stderr) in out.items():
        assert rc == 0, f"{name} exited {rc}:\n{stderr[-3000:]}"
    # ssh and mpi return once their tasks exit; the ranks' files are there
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not all(
            (tmp / f"{t}-rank{r}.npz").exists()
            for t in ("local", "ssh", "mpi") for r in range(2)):
        time.sleep(0.5)
    return tmp, out


def _rank_arrays(tmp, tag):
    return [dict(np.load(tmp / f"{tag}-rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("cluster", ["ssh", "mpi"])
def test_train_gbdt_through_backend_equals_local(slice_runs, cluster):
    tmp, out = slice_runs
    local = _rank_arrays(tmp, "local")[0]
    for got in _rank_arrays(tmp, cluster):
        assert sorted(got) == sorted(local)
        for k in local:
            np.testing.assert_array_equal(got[k], local[k], err_msg=k)
    lines = _trained_lines(out[cluster][1])
    assert len(lines) == 2 and lines[0] == lines[1]
    assert lines[0].split(" in ")[0] == \
        _trained_lines(out["local"][1])[0].split(" in ")[0]


def test_train_gbdt_through_ssh_matches_the_jax_cli(slice_runs):
    tmp, out = slice_runs
    got = _rank_arrays(tmp, "ssh")[0]
    want = _blob(tmp / "jax_gbdt.bin")
    np.testing.assert_array_equal(got["split_feat"], want["split_feat"])
    np.testing.assert_array_equal(got["default_left"], want["default_left"])
    split = want["split_feat"] >= 0
    np.testing.assert_array_equal(got["split_bin"][split],
                                  want["split_bin"][split])
    for name in ("leaf_value", "split_cover"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    acc = float(_trained_lines(out["ssh"][1])[0].rsplit(" ", 1)[1])
    jax_acc = float(_trained_lines(out["jax_ssh"][1])[0].rsplit(" ", 1)[1])
    assert abs(acc - jax_acc) <= 1e-4
