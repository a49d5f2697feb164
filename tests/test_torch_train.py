"""PyTorch port vs the JAX package: the continuous trainer.

The cases of ``tests/test_train.py`` run on the port's daemon with
``device="cpu"`` (spool source, cold start, publish cadence and clock,
resume past corrupt and manifest-less steps, torn publishes, ingest
faults, poison, the state file), and the port is held to the JAX package:
the same spool gives the same batches, and both daemons over it publish
the same steps with the same cursors and trees (rtol 1e-5, the exact f32
scatter path in both); a step either daemon publishes resumes in the
other's; the CLI killed by a ``DMLC_FAULT_PLAN`` exit (rc 43) and
restarted ends with an ensemble bitwise equal to an uninterrupted run's;
and without ``--device cpu`` the CLI needs a card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dmlc_core_tpu import train as jax_train
from dmlc_core_tpu.bridge.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu_torch import fault
from dmlc_core_tpu_torch.bridge.checkpoint import load_checkpoint
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
from dmlc_core_tpu_torch.train import (CURSOR_KEY, DONE_SENTINEL, ROUND_KEY,
                                       DirectorySource, TrainerDaemon)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 6
ROWS = 80
PARAM = {"num_bins": 16, "max_depth": 3, "learning_rate": 0.3}


def _write_libsvm(path, n=ROWS, bias=0.0, seed=0, nan_features=False):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            x = rng.normal(size=F)
            y = int(rng.random() < 1 / (1 + np.exp(-(x[0] + bias))))
            if nan_features:
                feats = " ".join(f"{j}:nan" for j in range(F))
            else:
                feats = " ".join(f"{j}:{x[j]:.5f}" for j in range(F))
            f.write(f"{y} {feats}\n")


def _spool(tmp_path, n_files=3, start_seed=0, done=False):
    d = tmp_path / "spool"
    d.mkdir(exist_ok=True)
    for i in range(n_files):
        _write_libsvm(d / f"part-{i:04d}.libsvm", seed=start_seed + i,
                      bias=0.3 * i)
    if done:
        open(d / DONE_SENTINEL, "w").close()
    return str(d)


def _daemon(tmp_path, spool, ckpt="ckpt", **kw):
    kw.setdefault("param", GBDTParam(**PARAM))
    kw.setdefault("rounds_per_batch", 2)
    kw.setdefault("publish_every_rounds", 4)
    kw.setdefault("poll_s", 0.05)
    kw.setdefault("device", "cpu")
    return TrainerDaemon(str(tmp_path / ckpt), DirectorySource(spool, F), F,
                         **kw)


def _jax_daemon(tmp_path, spool, ckpt="ckpt", **kw):
    kw.setdefault("param", JaxParam(**PARAM))
    kw.setdefault("rounds_per_batch", 2)
    kw.setdefault("publish_every_rounds", 4)
    kw.setdefault("poll_s", 0.05)
    return jax_train.TrainerDaemon(str(tmp_path / ckpt),
                                   jax_train.DirectorySource(spool, F), F,
                                   **kw)


def _step_arrays(manager, step, loader=load_checkpoint):
    flat = loader(manager.step_uri(step))
    return {k: np.asarray(v) for k, v in flat.items()}


def _assert_same_steps(port_mgr, jax_mgr):
    """Both daemons published the same steps, cursors, odometers, edges
    and trees."""
    assert port_mgr.all_steps() == jax_mgr.all_steps()
    for step in port_mgr.all_steps():
        assert port_mgr.read_manifest(step) is not None
        got = _step_arrays(port_mgr, step)
        want = _step_arrays(jax_mgr, step, jax_load_checkpoint)
        assert sorted(got) == sorted(want)
        for key in (CURSOR_KEY, ROUND_KEY, "serve_meta", "boundaries",
                    "split_feat", "default_left", "handle_missing",
                    "base_score"):
            np.testing.assert_array_equal(got[f"['{key}']"],
                                          want[f"['{key}']"], err_msg=key)
        split = want["['split_feat']"] >= 0
        np.testing.assert_array_equal(got["['split_bin']"][split],
                                      want["['split_bin']"][split])
        for key in ("leaf_value", "split_cover"):
            np.testing.assert_allclose(got[f"['{key}']"], want[f"['{key}']"],
                                       rtol=1e-5, atol=1e-5, err_msg=key)


# -- DirectorySource ----------------------------------------------------------
def test_directory_source_name_order_and_cursor(tmp_path):
    spool = _spool(tmp_path, n_files=3)
    src = DirectorySource(spool, F)
    seen = []
    cursor = 0
    while True:
        b = src.next_batch(cursor)
        if b is None:
            break
        assert b.error is None
        assert b.x.shape == (ROWS, F) and b.x.dtype == np.float32
        assert b.label.dtype == np.float32
        assert b.cursor == cursor + 1
        seen.append(os.path.basename(b.origin))
        cursor = b.cursor
    assert seen == sorted(seen) and len(seen) == 3
    assert not src.exhausted(cursor)
    open(os.path.join(spool, DONE_SENTINEL), "w").close()
    assert src.exhausted(cursor)
    assert not src.exhausted(cursor - 1)


def test_directory_source_skips_hidden_and_tmp_names(tmp_path):
    spool = _spool(tmp_path, n_files=1)
    open(os.path.join(spool, ".tmp-part-9999.libsvm"), "w").close()
    open(os.path.join(spool, "_scratch"), "w").close()
    src = DirectorySource(spool, F)
    assert src.next_batch(0).error is None
    assert src.next_batch(1) is None


def test_directory_source_poison_is_a_batch_not_a_raise(tmp_path):
    spool = _spool(tmp_path, n_files=1)
    with open(os.path.join(spool, "part-0000.libsvm"), "w") as f:
        f.write("utterly : not : libsvm\n")
    b = DirectorySource(spool, F).next_batch(0)
    assert b.error is not None and b.x is None
    assert b.cursor == 1


@pytest.mark.parametrize("nan_fill", [False, True])
def test_directory_source_batches_equal_jax(tmp_path, nan_fill):
    spool = _spool(tmp_path, n_files=2)
    # a sparse file: absent features densify as 0.0 or NaN
    with open(os.path.join(spool, "part-0002.libsvm"), "w") as f:
        f.write("1 0:0.5 3:-1.25\n0 5:2.0\n1\n")
    got_src = DirectorySource(spool, F, nan_fill=nan_fill)
    want_src = jax_train.DirectorySource(spool, F, nan_fill=nan_fill)
    for cursor in range(3):
        got, want = got_src.next_batch(cursor), want_src.next_batch(cursor)
        assert (got.origin, got.cursor, got.error) == \
            (want.origin, want.cursor, want.error)
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.label, want.label)
    assert got_src.next_batch(3) is None


# -- daemon: cold start, cadence, and the serving ring ------------------------
def test_cold_train_publish_and_hot_swap(tmp_path):
    from dmlc_core_tpu_torch.serve import (CheckpointWatcher, ModelRegistry,
                                           build_runtime, runtime_builder)

    spool = _spool(tmp_path, n_files=4, done=True)
    d = _daemon(tmp_path, spool)
    d.run(exit_when_idle=True)
    assert d.rounds_completed == 8
    assert d.publishes_completed == 2  # every 4 rounds
    assert d.resumed_from is None

    mgr = d.manager
    step, _ = mgr.latest_valid(verify=True)
    assert step == 2
    state = load_checkpoint(mgr.step_uri(step))
    assert int(np.asarray(state[f"['{CURSOR_KEY}']"])[0]) == 4
    assert int(np.asarray(state[f"['{ROUND_KEY}']"])[0]) == 8

    # the published checkpoint swaps through the port's serving watcher
    registry = ModelRegistry()
    registry.add("m", build_runtime("gbdt", F, checkpoint=mgr.step_uri(1),
                                    device="cpu"),
                 version=1, max_batch=8, max_delay_ms=1.0)
    w = CheckpointWatcher(registry, "m", str(tmp_path / "ckpt"),
                          runtime_builder("gbdt", F, device="cpu"),
                          poll_s=60, manager=mgr)
    assert w.poll_once() == 2
    assert registry.get("m").version == 2


def test_publish_clock_thread_publishes_on_cadence(tmp_path):
    spool = _spool(tmp_path, n_files=2)
    d = _daemon(tmp_path, spool, publish_every_rounds=0,
                publish_every_s=0.15)
    with d:
        assert d.step_once() and d.step_once()
        deadline = time.monotonic() + 10
        while d.publishes_completed == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
    assert d.publishes_completed >= 1
    d.publish_now()
    before = d.publishes_completed
    assert d.publish_now() is None   # nothing new: a no-op
    assert d.publishes_completed == before


def test_env_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TRAIN_PUBLISH_ROUNDS", "6")
    monkeypatch.setenv("DMLC_TRAIN_PUBLISH_EVERY_S", "2.5")
    monkeypatch.setenv("DMLC_TRAIN_POLL_S", "0.25")
    d = TrainerDaemon(str(tmp_path / "ckpt"),
                      DirectorySource(_spool(tmp_path, n_files=1), F), F,
                      param=GBDTParam(**PARAM), device="cpu")
    assert (d.publish_every_rounds, d.publish_every_s, d.poll_s) == \
        (6, 2.5, 0.25)
    assert d._gbdt.device.type == "cpu"


# -- daemon: crash resume -----------------------------------------------------
def test_resume_restores_trees_cursor_and_appends(tmp_path):
    spool = _spool(tmp_path, n_files=4)
    d1 = _daemon(tmp_path, spool)
    d1.run(max_batches=4)
    assert d1.publishes_completed == 2

    d2 = _daemon(tmp_path, spool, incarnation=1)
    assert d2.resumed_from == 2
    st = d2.describe()
    assert st["cursor"] == 4 and st["rounds_completed"] == 8
    assert st["trees"] == 8  # restored, not retrained
    np.testing.assert_array_equal(d2._gbdt.boundaries, d1._gbdt.boundaries)

    _write_libsvm(os.path.join(spool, "part-0004.libsvm"), seed=9)
    open(os.path.join(spool, DONE_SENTINEL), "w").close()
    d2.run(exit_when_idle=True)
    assert d2.rounds_completed == 10 and d2.publishes_completed == 1
    step, _ = d2.manager.latest_valid(verify=True)
    assert step == 3
    _, ens = GBDT.resume(load_checkpoint(d2.manager.step_uri(step)),
                         device="cpu")
    assert ens.num_trees == 10


def test_resume_falls_past_corrupt_newest_step(tmp_path):
    spool = _spool(tmp_path, n_files=4)
    d1 = _daemon(tmp_path, spool)
    d1.run(max_batches=4)
    blob = d1.manager.step_uri(2).replace("file://", "")
    with open(blob, "r+b") as f:
        f.seek(16)
        f.write(b"\xff" * 8)
    d2 = _daemon(tmp_path, spool, incarnation=1)
    assert d2.resumed_from == 1
    assert d2.describe()["cursor"] == 2
    assert d2.describe()["next_step"] == 3   # the corrupt number stays retired


def test_resume_skips_manifestless_step_and_republishes_it(tmp_path):
    import shutil

    spool = _spool(tmp_path, n_files=4)
    d1 = _daemon(tmp_path, spool)
    d1.run(max_batches=4)
    mgr = d1.manager
    shutil.copy(mgr.step_uri(2).replace("file://", ""),
                mgr.step_uri(3).replace("file://", ""))
    assert mgr.all_steps() == [1, 2, 3]
    d2 = _daemon(tmp_path, spool, incarnation=1)
    assert d2.resumed_from == 2
    assert d2.describe()["next_step"] == 3   # the orphan's number is reused
    _write_libsvm(os.path.join(spool, "part-0004.libsvm"), seed=9)
    open(os.path.join(spool, DONE_SENTINEL), "w").close()
    d2.run(exit_when_idle=True)
    step, manifest = mgr.latest_valid(verify=True)
    assert step == 3 and manifest is not None


# -- daemon: publish discipline under faults ----------------------------------
@pytest.mark.chaos
def test_torn_publish_rejected_then_republished(tmp_path):
    fault.configure({"rules": [
        {"site": "train.publish", "kind": "truncate", "keep": 48,
         "match": {"phase": "durable"}, "times": 1}]})
    try:
        spool = _spool(tmp_path, n_files=4, done=True)
        d = _daemon(tmp_path, spool)
        d.run(exit_when_idle=True)
        assert d.publish_rejections == 1
        assert d.publishes_completed >= 1
        assert ("train.publish", "truncate") in \
            [(s, k) for s, k, _ in fault.fires()]
        step, _ = d.manager.latest_valid(verify=True)
        assert step is not None
        for s in d.manager.all_steps():
            assert d.manager.read_manifest(s) is not None
    finally:
        fault.clear()


@pytest.mark.chaos
def test_ingest_fault_retries_without_advancing_cursor(tmp_path):
    fault.configure({"rules": [
        {"site": "train.ingest", "kind": "error",
         "exception": "RuntimeError", "times": 2}]})
    try:
        spool = _spool(tmp_path, n_files=1, done=True)
        d = _daemon(tmp_path, spool)
        d.run(exit_when_idle=True)
        assert d.ingest_failures == 2
        assert d.describe()["cursor"] == 1
        assert d.rounds_completed == 2
    finally:
        fault.clear()


def _poison_nan(path):
    _write_libsvm(path, nan_features=True, seed=3)


def _poison_arity(path):
    with open(path, "w") as f:
        f.write(f"1 {F + 3}:0.5\n0 0:1.0\n")


def _poison_label(path):
    with open(path, "w") as f:
        f.write("inf 0:0.5 1:0.25\n0 0:1.0\n")


def _poison_parse(path):
    with open(path, "w") as f:
        f.write("utterly : not : libsvm\n")


POISON = {"nan": _poison_nan, "arity": _poison_arity,
          "label": _poison_label, "parse": _poison_parse}


@pytest.mark.parametrize("kind", sorted(POISON))
def test_poison_quarantined_not_fatal(tmp_path, kind):
    spool = _spool(tmp_path, n_files=1)
    POISON[kind](os.path.join(spool, "part-0001.libsvm"))
    _write_libsvm(os.path.join(spool, "part-0002.libsvm"), seed=4)
    open(os.path.join(spool, DONE_SENTINEL), "w").close()
    d = _daemon(tmp_path, spool)
    d.run(exit_when_idle=True)
    assert d.quarantined == 1
    assert d.rounds_completed == 4   # both healthy files trained
    assert d.describe()["cursor"] == 3


def test_state_file_is_atomic_and_current(tmp_path):
    spool = _spool(tmp_path, n_files=2, done=True)
    state_path = tmp_path / "state.json"
    d = _daemon(tmp_path, spool, state_file=str(state_path))
    d.run(exit_when_idle=True)
    with open(state_path) as f:
        assert json.load(f) == d.describe()
    assert not list(tmp_path.glob("state.json.tmp.*"))


def test_concurrent_publish_clock_and_training_is_consistent(tmp_path):
    spool = _spool(tmp_path, n_files=6, done=True)
    d = _daemon(tmp_path, spool, publish_every_rounds=2,
                publish_every_s=0.05, rounds_per_batch=1)
    d.run(exit_when_idle=True)
    mgr = d.manager
    for step in mgr.all_steps():
        if mgr.read_manifest(step) is None:
            continue
        flat = load_checkpoint(mgr.step_uri(step))
        _, ens = GBDT.resume(flat, device="cpu")
        assert int(np.asarray(flat[f"['{ROUND_KEY}']"])[0]) == ens.num_trees


# -- the port's daemon against the JAX package's ------------------------------
@pytest.mark.parametrize("rounds_per_batch,publish_every",
                         [(2, 4), (1, 3), (3, 0)])
def test_daemon_publishes_what_jax_daemon_publishes(tmp_path,
                                                    rounds_per_batch,
                                                    publish_every):
    spool = _spool(tmp_path, n_files=5, done=True)
    kw = dict(rounds_per_batch=rounds_per_batch,
              publish_every_rounds=publish_every)
    d = _daemon(tmp_path, spool, ckpt="port", **kw)
    d.run(exit_when_idle=True)
    j = _jax_daemon(tmp_path, spool, ckpt="jax", **kw)
    j.run(exit_when_idle=True)
    assert d.describe() == j.describe()
    _assert_same_steps(d.manager, j.manager)


def test_port_steps_resume_in_jax_daemon(tmp_path):
    spool = _spool(tmp_path, n_files=4)
    d = _daemon(tmp_path, spool)
    d.run(max_batches=4)
    j = _jax_daemon(tmp_path, spool, incarnation=1)
    assert j.resumed_from == 2
    assert j.describe()["cursor"] == 4 and j.describe()["trees"] == 8
    np.testing.assert_array_equal(j._gbdt.boundaries, d._gbdt.boundaries)
    _write_libsvm(os.path.join(spool, "part-0004.libsvm"), seed=9)
    open(os.path.join(spool, DONE_SENTINEL), "w").close()
    j.run(exit_when_idle=True)
    # and the JAX daemon's step loads back in the port
    step, _ = d.manager.latest_valid(verify=True)
    assert step == 3
    gbdt, ens = GBDT.resume(load_checkpoint(d.manager.step_uri(step)),
                            device="cpu")
    assert ens.num_trees == 10 and gbdt.num_feature == F


def test_jax_steps_resume_in_port_daemon(tmp_path):
    spool = _spool(tmp_path, n_files=4)
    j = _jax_daemon(tmp_path, spool, ckpt="jax")
    j.run(max_batches=4)
    # the same history in the port, for the comparison at the end
    ref = _daemon(tmp_path, spool, ckpt="port")
    ref.run(max_batches=4)
    d = _daemon(tmp_path, spool, ckpt="jax", incarnation=1)
    assert d.resumed_from == 2
    assert d.describe()["cursor"] == 4 and d.describe()["trees"] == 8
    _write_libsvm(os.path.join(spool, "part-0004.libsvm"), seed=9)
    open(os.path.join(spool, DONE_SENTINEL), "w").close()
    d.run(exit_when_idle=True)
    ref = _daemon(tmp_path, spool, ckpt="port", incarnation=1)
    ref.run(exit_when_idle=True)
    assert d.describe()["trees"] == ref.describe()["trees"] == 10
    got = _step_arrays(d.manager, 3)
    want = _step_arrays(ref.manager, 3)
    np.testing.assert_array_equal(got["['split_feat']"],
                                  want["['split_feat']"])
    np.testing.assert_allclose(got["['leaf_value']"],
                               want["['leaf_value']"], rtol=1e-5, atol=1e-5)


# -- the CLI ------------------------------------------------------------------
def _cli(args, env=None, timeout=180):
    full_env = dict(os.environ)
    full_env.pop("DMLC_FAULT_PLAN", None)
    full_env["PYTHONPATH"] = REPO + os.pathsep + full_env.get("PYTHONPATH",
                                                             "")
    full_env.update(env or {})
    return subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.train"] + args,
        cwd=REPO, env=full_env, capture_output=True, text=True,
        timeout=timeout)


def _cli_args(spool, ckpt, state):
    return ["--data", spool, "--ckpt", ckpt, "--num-feature", str(F),
            "--rounds-per-batch", "2", "--publish-every-rounds", "4",
            "--max-depth", "3", "--num-bins", "16", "--learning-rate", "0.3",
            "--poll-s", "0.05", "--exit-when-idle", "--state-file", state]


def _final_ensemble(ckpt):
    from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager

    mgr = CheckpointManager(ckpt)
    step, _ = mgr.latest_valid(verify=True)
    flat = load_checkpoint(mgr.step_uri(step))
    return flat, GBDT.resume(flat, device="cpu")[1]


def test_cli_killed_and_resumed_matches_uninterrupted_run(tmp_path):
    from dmlc_core_tpu_torch.train.__main__ import main

    spool = _spool(tmp_path, n_files=8, done=True)
    clean = str(tmp_path / "clean")
    assert main(_cli_args(spool, clean, str(tmp_path / "clean.json"))
                + ["--device", "cpu"]) == 0

    ckpt, state = str(tmp_path / "ckpt"), str(tmp_path / "state.json")
    kill = {"rules": [{"site": "train.round", "kind": "exit", "code": 43,
                       "match": {"incarnation": "0"}, "after": 9,
                       "times": 1}]}
    run = _cli(_cli_args(spool, ckpt, state) + ["--device", "cpu"],
               env={"DMLC_FAULT_PLAN": json.dumps(kill)})
    assert run.returncode == 43, run.stderr[-2000:]
    with open(state) as f:
        assert json.load(f)["rounds_completed"] == 8   # published twice

    tear = {"rules": [{"site": "train.publish", "kind": "truncate",
                       "keep": 64, "match": {"phase": "durable"},
                       "times": 1}]}
    run = _cli(_cli_args(spool, ckpt, state)
               + ["--device", "cpu", "--incarnation", "1"],
               env={"DMLC_FAULT_PLAN": json.dumps(tear)})
    assert run.returncode == 0, run.stderr[-2000:]
    with open(state) as f:
        st = json.load(f)
    assert st["resumed_from"] == 2 and st["publish_rejections"] == 1
    assert st["cursor"] == 8 and st["trees"] == 16

    flat, ens = _final_ensemble(ckpt)
    assert int(np.asarray(flat[f"['{CURSOR_KEY}']"])[0]) == 8
    _, want = _final_ensemble(clean)
    assert all(torch.equal(a, b) for a, b in zip(ens, want))

    # the CLI's steps: hot-swapped by the port's server, resumed by the
    # JAX package
    from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
    from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager
    from dmlc_core_tpu_torch.serve import (CheckpointWatcher, ModelRegistry,
                                           build_runtime, runtime_builder)

    mgr = CheckpointManager(ckpt)
    registry = ModelRegistry()
    registry.add("m", build_runtime("gbdt", F, checkpoint=mgr.step_uri(1),
                                    device="cpu"), version=1)
    watcher = CheckpointWatcher(registry, "m", ckpt,
                                runtime_builder("gbdt", F, device="cpu"),
                                poll_s=60, manager=mgr)
    assert watcher.poll_once() == 4
    assert registry.get("m").version == 4
    _, jax_ens = JaxGBDT.resume(jax_load_checkpoint(mgr.step_uri(4)))
    assert jax_ens.num_trees == 16
    np.testing.assert_array_equal(np.asarray(jax_ens.split_feat),
                                  ens.split_feat.numpy())


def test_cli_without_device_needs_a_card(tmp_path):
    spool = _spool(tmp_path, n_files=1, done=True)
    run = _cli(_cli_args(spool, str(tmp_path / "ckpt"),
                         str(tmp_path / "state.json")))
    if torch.cuda.is_available():
        assert run.returncode == 0, run.stderr[-2000:]
        return
    assert run.returncode != 0
    assert "device='cpu'" in run.stderr
    assert not os.path.exists(tmp_path / "ckpt")


def test_trainer_fault_sites_match_the_reference():
    from dmlc_core_tpu import fault as jax_fault

    for site in ("train.ingest", "train.round", "train.publish",
                 "io.fleet.lease", "tracker.framed.recv",
                 "tracker.framed.send"):
        assert fault.SITES[site] == jax_fault.SITES[site]
    with open(os.path.join(REPO, "benchmarks",
                           "continuous_fault_plan.json")) as f:
        plan = fault.FaultPlan(json.load(f))
    sites = {r.site for r in plan.rules}
    assert {"train.round", "train.publish"} <= sites <= set(fault.SITES)
