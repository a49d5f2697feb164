"""Multi-worker training: the port's CLIs at world 2 against the JAX CLIs.

On the CPU, on one seeded libsvm file: each JAX example runs in 2 workers
through the JAX package's launcher (``python -m
dmlc_core_tpu.tracker.submit``), and the port's CLI (``--device cpu``) in
2 workers through the port's launcher (``python -m
dmlc_core_tpu_torch.tracker.submit``).  The port's workers call the CLI's
``main(argv)`` through a small wrapper that saves each rank's result.

- GBDT (``--hist-method scatter``, once with ``--subsample 0.8``): every
  rank's ensemble bitwise equal and both ranks' ``trained ... over 2
  workers`` lines identical; against the JAX ``--checkpoint`` blob (byte
  format is shared), at the tolerances of
  ``tests/test_torch_distributed_gbdt.py``: ``split_feat`` and
  ``default_left`` equal, ``split_bin`` equal where a node splits,
  ``leaf_value`` and ``split_cover`` within rtol = atol = 1e-4;
- logreg: ranks' params bitwise equal, and rank 0's ``--checkpoint``
  template holds them; the port's dense and sparse runs within 1e-5
  (relative to the largest |param|) of the JAX CLI's dense
  ``--checkpoint``, and rank 0's printed losses within rtol 1e-5.  The
  JAX CLI's sparse form at world > 1 is not the reference here: it keeps
  each process's row ids local to its slice of the global batch
  (ROADMAP.md §3);
- MLP: ranks' params bitwise equal; step 2 of ``--checkpoint-dir`` within
  the bf16 bounds of ``tests/test_torch_linear_mlp.py`` (rtol = atol =
  2e-2, and the change from the initial params within 0.25 relative
  norm), rank 0's printed losses within rtol = atol = 2e-2;
- shards whose batch counts differ: the port's launch fails within the
  collective timeout (the JAX CLI hangs there, ROADMAP.md §3);
- refusals under 2 workers: ``train_mlp --model-parallel 3`` (a model
  axis that does not divide the job) and ``train_gbdt --eval-data`` (the
  reference's messages).

In-process: a data-parallel step (its collective replaced by one that
adds a second rank's local sums) equals the JAX step on the two slices
concatenated (linear within 1e-6, the f32 MLP within rtol 1e-5), and at
world 1, with or without a mesh, the step is bitwise the single-process
step.
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.test_torch_collective import store_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F = 3000, 8
GBDT_ARGS = ["--rounds", "3", "--max-depth", "3", "--num-bins", "16",
             "--hist-method", "scatter"]
SAMPLED = ["--subsample", "0.8", "--seed", "5"]
LR_ARGS = ["--batch-size", "256", "--epochs", "2"]
MLP_ARGS = ["--batch-size", "256", "--epochs", "3", "--hidden", "16,16"]
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LAUNCH_TIMEOUT = 90
WAVE = 4              # launches run at once

WRAPPER = r"""
import os, sys
import numpy as np
from dmlc_core_tpu_torch.examples import train_gbdt, train_logreg, train_mlp

tag, module, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
out = {"train_gbdt": train_gbdt, "train_logreg": train_logreg,
       "train_mlp": train_mlp}[module].main(argv)
if module == "train_gbdt":
    arrays = {k: v.numpy() for k, v in out[0]._asdict().items()
              if v is not None}
elif module == "train_logreg":
    arrays = {k: v.cpu().numpy() for k, v in out[0].items()}
else:
    arrays = {f"{i}_{k}": layer[k].cpu().numpy()
              for i, layer in enumerate(out[0]["layers"]) for k in "wb"}
rank = os.environ["DMLC_TASK_ID"]
np.savez(os.path.join(os.environ["RESULT_DIR"], f"{tag}-rank{rank}.npz"),
         **arrays)
"""


def _libsvm(path, n, f, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f).astype(np.float32)
    y = ((x @ w + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(f"{int(y[i])} " + " ".join(
                f"{j}:{v:.9g}" for j, v in enumerate(x[i])) + "\n")
    return str(path)


def _env(tmp):
    env = os.environ.copy()
    env.update(RESULT_DIR=str(tmp), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               DMLC_COLLECTIVE_TIMEOUT="60",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    return env


def _launch(package, worker_cmd, tmp, env_extra=None):
    """Start a 2-worker launch through ``package``'s launcher (its own
    store port); returns the Popen."""
    env = _env(tmp)
    env.update(env_extra or {})
    cmd = [sys.executable, "-m", f"{package}.tracker.submit", "--cluster",
           "local", "--num-workers", "2", "--env",
           f"DMLC_COORDINATOR_PORT={store_port()}", "--", *worker_cmd]
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait_all(procs):
    """Wait for every launch; returns name -> (rc, stdout, stderr, secs)."""
    out = {}
    start = time.monotonic()
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=LAUNCH_TIMEOUT)
            out[name] = (proc.returncode, stdout, stderr,
                         time.monotonic() - start)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multiworker")
    data = _libsvm(tmp / "train.libsvm", N, F, 0)
    wrapper = tmp / "wrapper.py"
    wrapper.write_text(WRAPPER)
    common = ["--data", data, "--num-feature", str(F)]
    jax_py = [sys.executable]
    jax_runs = {
        "gbdt": [*jax_py, "examples/train_gbdt.py", *common, *GBDT_ARGS,
                 "--checkpoint", str(tmp / "jax_gbdt.bin")],
        "gbdt_sampled": [*jax_py, "examples/train_gbdt.py", *common,
                         *GBDT_ARGS, *SAMPLED, "--checkpoint",
                         str(tmp / "jax_gbdt_sampled.bin")],
        "logreg": [*jax_py, "examples/train_logreg.py", *common, *LR_ARGS,
                   "--form", "dense", "--checkpoint",
                   str(tmp / "jax_lr-{version}.bin")],
        "mlp": [*jax_py, "examples/train_mlp.py", *common, *MLP_ARGS,
                "--checkpoint-dir", str(tmp / "jax_mlp")],
    }
    port = [sys.executable, str(wrapper)]
    port_runs = {
        "gbdt": [*port, "gbdt", "train_gbdt", *common, *GBDT_ARGS,
                 "--device", "cpu"],
        "gbdt_sampled": [*port, "gbdt_sampled", "train_gbdt", *common,
                         *GBDT_ARGS, *SAMPLED, "--device", "cpu"],
        "logreg_dense": [*port, "logreg_dense", "train_logreg", *common,
                         *LR_ARGS, "--form", "dense", "--device", "cpu",
                         "--checkpoint", str(tmp / "port_lr-{version}.bin")],
        "logreg_sparse": [*port, "logreg_sparse", "train_logreg", *common,
                          *LR_ARGS, "--form", "sparse", "--device", "cpu"],
        "mlp": [*port, "mlp", "train_mlp", *common, *MLP_ARGS,
                "--checkpoint-dir", str(tmp / "port_mlp"), "--device", "cpu"],
        # the command a user types, not through the wrapper
        "gbdt_cli": [sys.executable, "-m",
                     "dmlc_core_tpu_torch.examples.train_gbdt", *common,
                     *GBDT_ARGS, "--device", "cpu", "--checkpoint",
                     str(tmp / "port_gbdt.bin")],
    }
    waves = [("dmlc_core_tpu", "jax_", jax_runs)]
    names = list(port_runs)
    for i in range(0, len(names), WAVE):
        waves.append(("dmlc_core_tpu_torch", "port_",
                      {k: port_runs[k] for k in names[i:i + WAVE]}))
    out = {}
    # a few launches at once (two processes each), not all of them
    for package, prefix, launches in waves:
        procs = {prefix + name: _launch(package, cmd, tmp)
                 for name, cmd in launches.items()}
        out.update(_wait_all(procs))
    for name, (rc, _, stderr, _) in out.items():
        assert rc == 0, f"{name} exited {rc}:\n{stderr[-3000:]}"
    return tmp, out


def _ranks(tmp, tag):
    return [dict(np.load(tmp / f"{tag}-rank{r}.npz")) for r in range(2)]


def _blob(path):
    from dmlc_core_tpu_torch.bridge.checkpoint import load_checkpoint

    return {k.strip("[]'"): np.asarray(v)
            for k, v in load_checkpoint(str(path)).items() if v is not None}


def _losses(text):
    return [float(v) for v in re.findall(r"epoch \d+: loss=([0-9.]+)", text)]


def _trained_lines(text):
    """The ``trained ... over 2 workers ...`` summaries (two ranks writing
    to one pipe at once may run their lines together)."""
    return re.findall(r"trained \d+ rounds on \d+ rows over 2 workers in "
                      r"[^\n]*?train acc \d+\.\d{4}", text)


@pytest.mark.parametrize("tag", ["gbdt", "gbdt_sampled", "logreg_dense",
                                 "logreg_sparse", "mlp"])
def test_ranks_hold_bitwise_equal_models(runs, tag):
    tmp, _ = runs
    r0, r1 = _ranks(tmp, tag)
    assert sorted(r0) == sorted(r1)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("tag", ["gbdt", "gbdt_sampled"])
def test_gbdt_matches_the_jax_cli(runs, tag):
    tmp, out = runs
    got = _ranks(tmp, tag)[0]
    want = _blob(tmp / f"jax_{tag}.bin")
    np.testing.assert_array_equal(got["split_feat"], want["split_feat"])
    np.testing.assert_array_equal(got["default_left"], want["default_left"])
    split = want["split_feat"] >= 0
    np.testing.assert_array_equal(got["split_bin"][split],
                                  want["split_bin"][split])
    for name in ("leaf_value", "split_cover"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    lines = _trained_lines(out[f"port_{tag}"][1])
    assert len(lines) == 2 and lines[0] == lines[1]
    assert f"on {N} rows over 2 workers" in lines[0]
    acc = float(lines[0].rsplit(" ", 1)[1])
    jax_acc = float(_trained_lines(out[f"jax_{tag}"][1])[0].rsplit(" ", 1)[1])
    assert abs(acc - jax_acc) <= 1e-4


def test_gbdt_cli_command_line(runs):
    """``python -m ...train_gbdt`` under the port's launcher: exit 0, two
    identical summary lines, rank 0's checkpoint equal to the ranks'."""
    tmp, out = runs
    lines = _trained_lines(out["port_gbdt_cli"][1])
    assert len(lines) == 2 and lines[0] == lines[1]
    assert out["port_gbdt_cli"][1].count("checkpoint written to") == 1
    blob = _blob(tmp / "port_gbdt.bin")
    for k, v in _ranks(tmp, "gbdt")[0].items():
        np.testing.assert_array_equal(blob[k], v, err_msg=k)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_logreg_matches_the_jax_cli(runs, form):
    tmp, out = runs
    got = _ranks(tmp, f"logreg_{form}")[0]
    want = _blob(tmp / "jax_lr-2.bin")
    for k in ("w", "b"):
        scale = np.abs(want["w"]).max()
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * scale, k
    port_losses = _losses(out[f"port_logreg_{form}"][2])
    jax_losses = _losses(out["jax_logreg"][2])
    assert len(port_losses) == len(jax_losses) == 2
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    if form == "dense":
        # rank 0's --checkpoint template holds the ranks' params
        blob = _blob(tmp / "port_lr-2.bin")
        for k in ("w", "b"):
            np.testing.assert_array_equal(blob[k], got[k])


def test_mlp_matches_the_jax_cli(runs):
    from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager
    from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam

    tmp, out = runs
    init = MLP(MLPParam(num_feature=F, hidden="16,16"),
               device="cpu").init_params()
    leaves = [layer[k].numpy() for layer in init["layers"] for k in "wb"]
    step = {}
    for name in ("jax_mlp", "port_mlp"):
        mgr = CheckpointManager(str(tmp / name))
        assert mgr.latest_step() == 2
        state = mgr.restore(2)
        step[name] = [np.asarray(state[f"[0]['layers'][{i}]['{k}']"])
                      for i in range(3) for k in "wb"]
    for a, b in zip(step["port_mlp"], step["jax_mlp"]):
        np.testing.assert_allclose(a, b, **BF16_TOL)
    got = np.concatenate([(a - a0).ravel()
                          for a, a0 in zip(step["port_mlp"], leaves)])
    want = np.concatenate([(b - b0).ravel()
                           for b, b0 in zip(step["jax_mlp"], leaves)])
    assert np.linalg.norm(got - want) <= 0.25 * np.linalg.norm(want)
    port_losses = _losses(out["port_mlp"][2])
    jax_losses = _losses(out["jax_mlp"][2])
    assert len(port_losses) == len(jax_losses) == 3
    np.testing.assert_allclose(port_losses, jax_losses, **BF16_TOL)
    # the final params of every rank are the ones rank 0 would save next
    final = _ranks(tmp, "mlp")[0]
    assert all(np.isfinite(v).all() for v in final.values())


def test_launches_stay_short(runs):
    _, out = runs
    for name, (_, _, _, secs) in out.items():
        assert secs < 30, f"{name} took {secs:.1f} s"


def _skewed(path):
    """Rows of 8 nonzeros, then rows of 1: the byte-range halves hold 570
    and 1,430 rows, one and two batches of 512 rows."""
    rng = np.random.RandomState(1)
    with open(path, "w") as fh:
        for i in range(2000):
            k = 8 if i < 1000 else 1
            fh.write(f"{rng.randint(2)} " + " ".join(
                f"{j}:{rng.randn():.9g}" for j in range(k)) + "\n")
    return str(path)


def test_unequal_batch_counts_fail_within_the_timeout(tmp_path):
    data = _skewed(tmp_path / "skew.libsvm")
    start = time.monotonic()
    proc = _launch("dmlc_core_tpu_torch", [
        sys.executable, "-m", "dmlc_core_tpu_torch.examples.train_logreg",
        "--data", data, "--num-feature", "8", "--form", "dense",
        "--device", "cpu"], tmp_path, {"DMLC_COLLECTIVE_TIMEOUT": "20"})
    rc, _, stderr, _ = _wait_all({"skew": proc})["skew"]
    assert rc != 0
    assert time.monotonic() - start < 60
    assert "failed with exit" in stderr


@pytest.mark.parametrize("case", ["mlp_model_parallel", "gbdt_eval"])
def test_refusals_under_two_workers(tmp_path, case):
    data = _libsvm(tmp_path / "t.libsvm", 600, F, 0)
    common = ["--data", data, "--num-feature", str(F), "--device", "cpu"]
    cmd, want = {
        "mlp_model_parallel": (["train_mlp", "--model-parallel", "3"],
                               "--model-parallel 3 does not divide 2 ranks"),
        "gbdt_eval": (["train_gbdt", "--eval-data", data],
                      "--eval-data/--checkpoint-dir are single-host flows"),
    }[case]
    proc = _launch("dmlc_core_tpu_torch", [
        sys.executable, "-m", f"dmlc_core_tpu_torch.examples.{cmd[0]}",
        *common, *cmd[1:]], tmp_path)
    rc, _, stderr, _ = _wait_all({case: proc})[case]
    assert rc != 0
    assert want in stderr


# ------------------------------------------------------------ in-process --
class _SecondRank:
    """A stand-in for ``data_allreduce`` over two ranks: its first call
    records the second rank's local sums, later calls add them."""

    def __init__(self):
        self.other = None

    def __call__(self, x):
        if self.other is None:           # recording the second rank
            self.other = x.clone()
            return (x,)
        return (x + self.other,)


def _dense_batch(rows, seed, weight=None):
    from dmlc_core_tpu_torch.bridge.batching import DenseBatch

    rng = np.random.RandomState(seed)
    x = rng.randn(rows, F).astype(np.float32)
    y = (rng.rand(rows) > 0.5).astype(np.float32)
    w = np.ones(rows, np.float32) if weight is None else weight
    return DenseBatch(torch.from_numpy(x), torch.from_numpy(y),
                      torch.from_numpy(w), rows)


def _jax_dense(*batches):
    from dmlc_core_tpu.bridge.batching import DenseBatch as JaxBatch

    cat = [np.concatenate([b[i].numpy() for b in batches]) for i in range(3)]
    return JaxBatch(*cat, cat[0].shape[0])


def _sparse_pair(seed):
    """A sparse batch of each of two ranks, and the JAX batch of both
    (row ids of the second offset past the first)."""
    from dmlc_core_tpu.bridge.batching import SparseBatch as JaxSparse
    from dmlc_core_tpu_torch.bridge.batching import SparseBatch

    rng = np.random.RandomState(seed)
    parts = []
    for rows in (5, 7):
        nnz = rows * 3
        row_id = np.sort(rng.randint(0, rows, nnz)).astype(np.int32)
        row_id[-2:] = rows                  # two padding slots
        parts.append(dict(
            label=(rng.rand(rows) > 0.5).astype(np.float32),
            weight=rng.rand(rows).astype(np.float32),
            index=rng.randint(0, F, nnz).astype(np.int32),
            value=rng.randn(nnz).astype(np.float32), row_id=row_id,
            rows=rows))
    port = [SparseBatch(*(torch.from_numpy(p[k]) for k in
                          ("value", "index", "row_id", "label", "weight")),
                        num_rows=p["rows"]) for p in parts]
    total = sum(p["rows"] for p in parts)
    row_id = np.concatenate([
        np.where(parts[0]["row_id"] == parts[0]["rows"], total,
                 parts[0]["row_id"]),
        np.where(parts[1]["row_id"] == parts[1]["rows"], total,
                 parts[1]["row_id"] + parts[0]["rows"])]).astype(np.int32)
    cat = {k: np.concatenate([p[k] for p in parts])
           for k in ("value", "index", "label", "weight")}
    whole = JaxSparse(cat["value"], cat["index"], row_id, cat["label"],
                      cat["weight"], num_rows=total)
    return port, whole


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_linear_data_parallel_step_is_the_global_step(monkeypatch, form):
    from dmlc_core_tpu.models.linear import LinearModel as JaxLinear
    from dmlc_core_tpu.models.linear import LinearParam as JaxParam
    from dmlc_core_tpu_torch.models import linear

    param = dict(num_feature=F, learning_rate=0.5, reg_lambda=0.01)
    model = linear.LinearModel(linear.LinearParam(**param), device="cpu")
    jm = JaxLinear(JaxParam(**param))
    if form == "dense":
        # weights summing below 1 on one rank: a mean of the ranks' means
        # would differ from the global step
        mine = _dense_batch(6, 1, np.full(6, 0.1, np.float32))
        theirs = _dense_batch(9, 2)
        whole = _jax_dense(mine, theirs)
    else:
        (mine, theirs), whole = _sparse_pair(3)
    monkeypatch.setattr(linear, "data_allreduce", _SecondRank())
    model.train_step(model.init_params(1), theirs)     # records rank 1
    got, loss = model.train_step(model.init_params(1), mine)
    want, want_loss = jm.train_step(jm.init_params(1), whole)
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)


def test_mlp_data_parallel_step_is_the_global_step(monkeypatch):
    from dmlc_core_tpu.models.mlp import MLP as JaxMLP
    from dmlc_core_tpu.models.mlp import MLPParam as JaxParam
    from dmlc_core_tpu_torch.models import mlp

    param = dict(num_feature=F, hidden="8,8", bf16=False)
    model = mlp.MLP(mlp.MLPParam(**param), device="cpu")
    jm = JaxMLP(JaxParam(**param))
    mine = _dense_batch(6, 1, np.full(6, 0.1, np.float32))
    theirs = _dense_batch(9, 2)
    monkeypatch.setattr(mlp, "data_parallel", lambda: True)
    monkeypatch.setattr(mlp, "data_allreduce", _SecondRank())
    p = model.init_params(0)
    model.train_step(p, model.init_optimizer(p), theirs)
    got, _, loss = model.train_step(p, model.init_optimizer(p), mine)
    jp = jm.init_params(0)
    want, _, want_loss = jm.train_step(jp, jm.init_optimizer(jp),
                                       _jax_dense(mine, theirs))
    for a, b in zip(got["layers"], want["layers"]):
        for k in "wb":
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def _old_linear_step(model, params, batch):
    """The single-process step as it stood before the data-parallel path
    (written out here), which world 1 must keep bit for bit."""
    from dmlc_core_tpu_torch.models.linear import _loss_grad
    from dmlc_core_tpu_torch.ops.sparse import segment_transpose_matvec

    p = model.param
    w, b = params["w"], params["b"]
    margin = model._margin(params, batch)
    g = _loss_grad(margin, batch.label, p.loss) * batch.weight
    denom = torch.clamp(batch.weight.sum(), min=1.0)
    if hasattr(batch, "x"):
        grad_w = batch.x.T @ g / denom + p.reg_lambda * w
    else:
        g_ext = torch.cat([g, g.new_zeros(1)])
        grad_w = segment_transpose_matvec(
            g_ext, batch.value, batch.index, batch.row_id,
            p.num_feature) / denom + p.reg_lambda * w
    grad_b = g.sum() / denom
    ls = torch.logaddexp(torch.zeros_like(margin), margin) \
        - batch.label * margin
    return ({"w": w - p.learning_rate * grad_w,
             "b": b - p.learning_rate * grad_b},
            (ls * batch.weight).sum() / denom)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_world_one_linear_step_unchanged(form):
    from dmlc_core_tpu_torch.models.linear import LinearModel, LinearParam
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh

    model = LinearModel(LinearParam(num_feature=F, reg_lambda=0.01),
                        device="cpu")
    batch = _dense_batch(9, 4) if form == "dense" else _sparse_pair(5)[0][1]
    params = model.init_params(2)
    want, want_loss = _old_linear_step(model, params, batch)
    plain = model.train_step(params, batch)
    with make_mesh():
        meshed = model.train_step(params, batch)
    for got, loss in (plain, meshed):
        for k in ("w", "b"):
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(loss, want_loss)


def test_world_one_mlp_step_unchanged():
    from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam, _leaves, \
        _rebuild
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh

    model = MLP(MLPParam(num_feature=F, hidden="8,8"), device="cpu")
    batch = _dense_batch(9, 4)
    params = model.init_params(1)
    # the gradient the single-process step took before: autograd of the
    # mean loss, computed as one expression
    leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
    logits = model._apply(_rebuild(leaves), batch.x)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, batch.label.to(torch.int64)[:, None])[:, 0]
    want_loss = (nll * batch.weight).sum() / torch.clamp(
        batch.weight.sum(), min=1.0)
    want_grads = torch.autograd.grad(want_loss, leaves)
    got_loss = model._loss(_rebuild(leaves), batch)
    got_grads = torch.autograd.grad(got_loss, leaves)
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
    plain = model.train_step(params, model.init_optimizer(params), batch)
    with make_mesh():
        meshed = model.train_step(params, model.init_optimizer(params), batch)
    for a, b in zip(_leaves(plain[0]), _leaves(meshed[0])):
        assert torch.equal(a, b)
    assert torch.equal(plain[2], meshed[2])
