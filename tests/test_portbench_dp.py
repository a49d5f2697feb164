"""The benchmark's sharded training cell (``criteo.train.dp4``) on the CPU.

Four gloo ranks on free local ports stand in for the four cards, at a
tiny size (4 x 1,500 rows x 67 features, depth 4, 16 bins, the plain
version of the card's histogram kernel):

- the sharded judge (``portbench/reference/check_dp.py``) over the four
  shards gives the numbers ``check.judge_train`` gives on the table they
  make up, for the same ensemble and margins;
- the port's 4-rank mesh fit (``collective.init``, ``make_mesh``, ``with
  mesh:``, ``GBDT.append_rounds``) passes it, and three planted faults and
  the control (the sharded reference one precision step below) do not;
- the ``train_dp`` kind, through the harness's own ``main`` in a
  throwaway checkout, prints its result line, and a rank that dies ends
  the run at once;
- every ``MeshCollective`` op records its ``collective.<op>`` span and
  counters, and nothing with telemetry off;
- the cell's per-layer metrics read a traced call's reduction.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.collective.mesh_collectives import MeshCollective
from dmlc_core_tpu_torch.parallel.mesh import Mesh
from portbench import harness, ranks, shards
from portbench.reference import check
from portbench.tests import tiny

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, ROWS, F, BINS, DEPTH = 4, 1500, 67, 16, 4
SEED = 2 ** 31 + 11
CELL = "criteo.train.dp4"
with open(os.path.join(REPO, "portbench", "workloads", CELL + ".json")) as f:
    LIMITS = json.load(f)["limits"]
with open(os.path.join(REPO, "portbench", "configs", "criteo.json")) as f:
    DATA = json.load(f)["data"]
PARAMS = {"objective": "logistic", "max_depth": DEPTH, "learning_rate": 0.3,
          "num_bins": BINS, "hist_method": "pallas", "seed": SEED}
ROUNDS = 4
CHECKED = [0, 2]

WORKER = r"""
import json, os, sys
import torch
sys.path.insert(0, %(repo)r)
from dmlc_core_tpu_torch import collective
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
from dmlc_core_tpu_torch.parallel.mesh import make_mesh
from portbench import shards
from portbench.control import LOWER
from portbench.reference import check_dp

ROWS, F, BINS, ROUNDS = %(rows)d, %(f)d, %(bins)d, %(rounds)d
PARAMS, DATA, CHECKED = %(params)r, %(data)r, %(checked)r
collective.init({"device": "cpu", "timeout": 60})
rank = collective.get_rank()
bins, label = shards.make_shard(DATA, ROWS, F, BINS, PARAMS["seed"], rank,
                                "cpu")
mesh = make_mesh({"data": %(world)d})


def fit(sharded=True):
    model = GBDT(GBDTParam(**PARAMS), num_feature=F, device="cpu")
    if not sharded:
        return model.append_rounds(None, bins, label, num_rounds=ROUNDS)
    with mesh:
        return model.append_rounds(None, bins, label, num_rounds=ROUNDS)


def control():
    margin = torch.zeros(ROWS)
    trees = []
    for t in range(ROUNDS):
        sf, sb, lv, margin = check_dp.build_tree_dp(
            bins, margin, label, PARAMS, t, LOWER["bfloat16"],
            LOWER["float32 matmul, TF32 off"])
        trees.append((sf, sb, lv, torch.zeros_like(sf, dtype=torch.bool)))
    return tuple(torch.stack([t[i] for t in trees]) for i in range(4)), margin


ens, margin = fit()
port = tuple(ens[:4])
leaf = tuple(t.clone() for t in port)
leaf[2][1, 0] += 0.01
one_bin = tuple(t.clone() for t in port)
if rank == 2:
    one_bin[1][0, 0] += 1
lone, lone_margin = fit(sharded=False)
ctl, ctl_margin = control()
# one row of rank 2's shard off by 0.25, for margin_err
off = margin.clone()
if rank == 2:
    off[7] += 0.25
cases = {"port": (port, off), "control": (ctl, ctl_margin),
         "leaf_altered": (leaf, margin), "no_allreduce": (tuple(lone[:4]),
                                                          lone_margin),
         "one_rank_bin": (one_bin, margin)}
out = {}
for name, (trees, m) in cases.items():
    out[name] = check_dp.judge_train_dp(bins, label, trees, m, PARAMS,
                                        ROUNDS, CHECKED, "bfloat16")
torch.save({"checks": out, "port": port, "margin": off, "control": ctl,
            "control_margin": ctl_margin},
           os.path.join(%(out)r, "rank%%d.pt" %% rank))
collective.finalize()
"""


def _launch(script: str, world: int, timeout: float = 180):
    port = ranks.free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   **ranks.rank_env(rank, world, port))
        procs.append(subprocess.Popen([sys.executable, "-c", script],
                                      env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Each rank's judged numbers, ensembles and margins, and the table the
    shards make up."""
    out = tmp_path_factory.mktemp("dp")
    _launch(WORKER % dict(repo=REPO, rows=ROWS, f=F, bins=BINS,
                          rounds=ROUNDS, params=PARAMS, data=DATA,
                          checked=CHECKED, world=WORLD, out=str(out)), WORLD)
    got = [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]
    parts = [shards.make_shard(DATA, ROWS, F, BINS, SEED, r, "cpu")
             for r in range(WORLD)]
    table = tuple(torch.cat([p[i] for p in parts]) for i in (0, 1))
    return got, table


@pytest.mark.parametrize("key", ["shape_faults", "split_gap",
                                 "leaf_err_med", "margin_err"])
@pytest.mark.parametrize("ensemble", ["port", "control"])
def test_sharded_judge_gives_the_whole_tables_numbers(sharded, ensemble,
                                                      key):
    got, (bins, label) = sharded
    margin_key = "margin" if ensemble == "port" else "control_margin"
    whole = check.judge_train(
        bins, label, got[0][ensemble],
        torch.cat([g[margin_key] for g in got]), PARAMS, ROUNDS, CHECKED,
        "bfloat16")
    for g in got:
        assert g["checks"][ensemble][key] == pytest.approx(
            whole[key], rel=1e-9, abs=1e-15)
    if ensemble == "control" and key in ("split_gap", "leaf_err_med"):
        assert whole[key] > 0          # the tie is held on real readings
    if ensemble == "port" and key == "margin_err":
        assert whole[key] == pytest.approx(0.25, rel=1e-6)


def _correct(checks):
    return all(v <= LIMITS[k] for k, v in checks.items())


def test_mesh_fit_passes_the_sharded_judge(sharded):
    got, _ = sharded
    for g in got:
        checks = dict(g["checks"]["port"])
        assert checks["rank_faults"] == 0
        # the 0.25 planted in rank 2's margin aside
        assert checks.pop("margin_err") == pytest.approx(0.25, rel=1e-6)
        assert _correct(checks), checks
        for a, b in zip(g["port"], got[0]["port"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fault,key,floor", [
    ("leaf_altered", "margin_err", 0.009),
    ("no_allreduce", "rank_faults", 1),
    ("one_rank_bin", "rank_faults", 1),
    ("control", "split_gap", LIMITS["split_gap"]),
])
def test_planted_fault_is_refused(sharded, fault, key, floor):
    got, _ = sharded
    for g in got:
        checks = g["checks"][fault]
        assert not _correct(checks), checks
        assert checks[key] >= floor, checks
        if fault == "one_rank_bin":
            assert checks["rank_faults"] == 1


def test_shards_make_one_table_from_the_seed():
    a0, l0 = shards.make_shard(DATA, 3000, F, 256, SEED, 0, "cpu")
    a1, l1 = shards.make_shard(DATA, 3000, F, 256, SEED, 1, "cpu")
    b0, m0 = shards.make_shard(DATA, 3000, F, 256, SEED, 0, "cpu")
    assert torch.equal(a0, b0) and torch.equal(l0, m0)
    assert not torch.equal(a0, a1)
    # one label function: both shards balanced near the global cut
    assert 0.45 < float(l0.mean()) < 0.55 and 0.45 < float(l1.mean()) < 0.55
    assert int(a0.min()) == 0 and int(a0.max()) == 255
    assert shards.stream_seed(SEED, 0) != shards.stream_seed(SEED, 1)


# -- the kind, through the harness ------------------------------------------

TINY_DP = "tiny_dp.train_dp4"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A throwaway checkout with the tiny cells and a tiny sharded cell
    added as a later change adds them."""
    root = tiny.checkout(tmp_path_factory.mktemp("dpbench"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "criteo.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_dp", rows_per_rank=ROWS,
               param={k: v for k, v in PARAMS.items() if k != "seed"})
    with open(os.path.join(pb, "configs", "tiny_dp.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "workloads", CELL + ".json")) as f:
        spec = json.load(f)
    spec.update(config="tiny_dp", collective_timeout_s=60)
    with open(os.path.join(pb, "workloads", TINY_DP + ".json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_dp", "source": "test",
                             "file": "portbench/configs/tiny_dp.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": TINY_DP, "config": "tiny_dp",
                               "traffic": "train_dp4", "chips": 4,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_DP)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_train_dp_kind_prints_its_result(checkout, trace):
    rc, out, err = tiny.run(checkout, TINY_DP, seed=SEED, seconds=1.0,
                            trace=trace)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["rank_faults"]["value"] == 0
    assert res["device"]["count"] == WORLD
    assert res["attempted"] >= 2 and res["failed"] == 0
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert set(res["metrics"]) == {"train_row_rounds_per_s",
                                       "peak_mem_gib", "setup_s"}
        assert res["metrics"]["train_row_rounds_per_s"]["value"] > 0


def test_control_is_not_correct(checkout):
    src = ("import sys; sys.path.insert(0, '.'); "
           "from portbench import control_dp; "
           f"sys.exit(control_dp.main(['--workload', {TINY_DP!r}, "
           "'--seeds', '5,6'], device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", src], cwd=checkout,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert [line["seed"] for line in lines] == [5, 6]
    for line in lines:
        assert line["control_correct"] is False, line["checks"]
        assert line["checks"]["rank_faults"] == 0


DEATHS = {
    # rank 2 never starts its job
    "at_start": "sys.exit(7)",
    # rank 2 dies inside its third call of append_rounds, mid-window
    "mid_window": """
from dmlc_core_tpu_torch.models import gbdt as G
real, calls = G.GBDT.append_rounds, []
def dying(*a, **k):
    calls.append(1)
    if len(calls) == 3:
        os._exit(9)
    return real(*a, **k)
G.GBDT.append_rounds = dying
""",
}


@pytest.mark.parametrize("death", sorted(DEATHS))
def test_a_dead_rank_fails_the_run_at_once(checkout, death):
    plant = f"""
import os, sys
from portbench import ranks
real_command = ranks.child_command
def command(rank, entry, args):
    cmd = real_command(rank, entry, args)
    if rank != 2:
        return cmd
    src = "\\n".join(["import os, sys", "sys.path.insert(0, {checkout!r})",
                      {DEATHS[death]!r}, "from portbench import ranks",
                      "sys.exit(ranks._child(sys.argv[1]))"])
    return [sys.executable, "-c", src, cmd[-1]]
ranks.child_command = command
"""
    start = time.monotonic()
    rc, out, err = tiny.run(checkout, TINY_DP, seed=SEED, seconds=30.0,
                            plant=plant)
    assert rc != 0
    assert "rank 2 exited with code" in err, err[-3000:]
    # well inside the window and the collective timeout (60 s)
    assert time.monotonic() - start < 45


# -- the collective spans -----------------------------------------------------

OPS = [  # (call, op name, payload bytes of a [4, 3] float32 tensor)
    (lambda c, x: c.psum(x), "sum", 48),
    (lambda c, x: c.allreduce(x, "max"), "max", 48),
    (lambda c, x: c.allgather(x, 1), "gather", 48),
    (lambda c, x: c.reduce_scatter(x), "reduce_scatter", 48),
    (lambda c, x: c.broadcast(x), "broadcast", 48),
    (lambda c, x: c.ppermute(x), "ppermute", 48),
    (lambda c, x: c.all_to_all(x, 0, 1), "all_to_all", 48),
]


@pytest.fixture
def collecting():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


def _series():
    return {(name, s["labels"]["op"]): s["value"]
            for name, fam in telemetry.snapshot()["metrics"].items()
            for s in fam["samples"]}


@pytest.mark.parametrize("axis", ["data", ("data", "model")])
@pytest.mark.parametrize("call,op,nbytes", OPS, ids=[o[1] for o in OPS])
def test_mesh_collective_op_records_its_span(collecting, call, op, nbytes,
                                             axis):
    coll = MeshCollective(Mesh({"data": 1, "model": 1}), axis)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = call(coll, x)
    assert torch.equal(out.reshape(-1), x.reshape(-1))   # one rank
    events = telemetry.get_tracer().events()
    assert [e["name"] for e in events] == [f"collective.{op}"]
    assert events[0]["args"] == {"payload_bytes": nbytes,
                                 "axis": "data" if axis == "data"
                                 else "data,model", "ranks": 1}
    assert _series() == {("dmlc_collective_ops_total", op): 1,
                         ("dmlc_collective_payload_bytes_total", op): nbytes}


def test_mesh_collectives_record_nothing_with_telemetry_off():
    telemetry.disable()
    telemetry.reset()
    coll = MeshCollective(Mesh({"data": 1}), "data")
    x = torch.ones(4, 3)
    for call, _, _ in OPS:
        call(coll, x)
    assert telemetry.get_tracer().events() == []
    assert telemetry.snapshot()["metrics"] == {}


def test_mesh_collective_spans_reach_the_profiler_with_telemetry_off():
    from torch.profiler import ProfilerActivity, profile

    telemetry.disable()
    coll = MeshCollective(Mesh({"data": 1}), "data")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        coll.psum(torch.ones(4))
        coll.allgather(torch.ones(4))
    names = {e.name for e in prof.events()}
    assert {"collective.sum", "collective.gather"} <= names
    assert telemetry.get_tracer().events() == []


# -- the cell's per-layer metrics ---------------------------------------------

PEAK = {"bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}


def _ctx(**over):
    """A traced two-round call of a 1,000-row, 10-feature, depth-2 shard."""
    ctx = {"kind": "train_dp", "peak": PEAK, "rounds": 2, "rows": 1000,
           "features": 10, "num_bins": 16, "ranks": 4,
           "node_rows": [[[1000], [400, 600]], [[1000], [700, 300]]],
           "level_features": [[10, 10], [10, 10]],
           "call_ms": 4.0, "busy_s": 0.003, "window_s": 0.004,
           "device_ops": 50,
           "span_device_ms": {"gbdt.hist": 1.0, "collective.sum": 0.1,
                              "nccl:all_reduce": 0.4, "gbdt.leaf": 0.2},
           "top_ops": [["k3", 0.001], ["ncclDevKernel_AllReduce", 0.0004]],
           "collective_payload_bytes": 1.0e6}
    ctx.update(over)
    return ctx


def _least_s():
    # level 0: 1,000 rows x (10 + 8) B and one 10 x 16 x 8 B histogram;
    # level 1: the smaller children, 400 and 300 rows, one histogram each
    b = ((1000 * 18 + 1280) + (400 * 18 + 1280)
         + (1000 * 18 + 1280) + (300 * 18 + 1280)) / 2
    ops = 2.0 * 10 * (1000 + 400 + 1000 + 300) / 2
    return max(b / PEAK["bytes_per_s"], ops / PEAK["f32_flops_per_s"]), b


@pytest.mark.parametrize("metric,expect", [
    ("train_mfu.dp4",
     lambda: 100 * (_least_s()[1] + 20 * 1000) / PEAK["bytes_per_s"] / 2e-3),
    ("hist_roofline.dp4", lambda: 100 * _least_s()[0] / 0.5e-3),
    ("allreduce_ms.dp4", lambda: 0.25),
    ("allreduce_busbw.dp4",
     lambda: 100 * 0.5e6 * 1.5 / 0.25e-3 / 450e9),
    ("device_idle_frac.dp4", lambda: 25.0),
])
def test_dp_metric_reads_a_traced_call(metric, expect):
    value = harness.load_metric(metric).read(_ctx())
    assert value == pytest.approx(expect(), rel=1e-9)
    assert 0 < value < 100


def test_dp_metrics_without_the_programs_spans():
    """A program without collective spans or counters (the parent of the
    change that added them): the all-reduce time falls back to the NCCL
    kernels, the bandwidth reads nothing, no reader raises."""
    ctx = _ctx(span_device_ms={"gbdt.hist": 1.4},
               collective_payload_bytes=None)
    read = {m: harness.load_metric(m).read(ctx) for m in (
        "allreduce_ms.dp4", "allreduce_busbw.dp4", "hist_roofline.dp4")}
    assert read["allreduce_ms.dp4"] == pytest.approx(0.2)
    assert read["allreduce_busbw.dp4"] is None
    assert read["hist_roofline.dp4"] > 0
    for m in ("train_mfu.dp4", "hist_roofline.dp4", "allreduce_ms.dp4",
              "allreduce_busbw.dp4", "device_idle_frac.dp4"):
        assert harness.load_metric(m).read(_ctx(kind="train")) is None


def test_cell_is_declared_as_the_harness_reads_it():
    cell = harness.Cell(CELL)
    assert cell.chips == WORLD == cell.config["ranks"]
    assert cell.spec["mesh"] == {"data": WORLD}
    assert [m["name"] for m in cell.end_to_end] == [
        "train_row_rounds_per_s", "peak_mem_gib", "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(
        ["train_mfu.dp4", "hist_roofline.dp4", "allreduce_ms.dp4",
         "allreduce_busbw.dp4", "device_idle_frac.dp4"])
