"""The port's tensor-parallel MLP against the JAX package's.

One launch of 4 port ranks (the port's launcher, gloo, ``device="cpu"``)
on a ``{"data": 2, "model": 2}`` mesh runs ``MLP(model_axis="model")``
(hidden ``16,12,8``: two sharded middle layers in a row) with
``bf16=False`` and ``bf16=True``: the all-reduced gradients of the first
step and the params and Adam moments after two steps, each gathered to
the full tree, then ``train_mlp.main`` with ``--model-parallel 2`` and a
``--checkpoint-dir`` (2 epochs: step 1 written).  A second launch runs
``python -m dmlc_core_tpu_torch.examples.train_mlp --model-parallel 2``
with ``--epochs 3``, which must resume from step 1.  The test holds the
steps to JAX ``MLP(model_axis="model")`` on a 2 x 2 sub-mesh of the CPU
mesh: f32 within 1e-5 (rtol 1e-5, atol 1e-5 of the largest value), bf16
gradients within 2e-2 of the largest and losses within rtol = atol = 2e-2
(the bounds of ``tests/test_torch_multiworker.py``).  The gathered trees
are bitwise equal on every rank; the checkpoints are full trees that the
JAX package's ``CheckpointManager`` restores bitwise as the port's does,
and a one-process ``train_mlp`` (``--model-parallel 1``) resumes them.
"""

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from dmlc_core_tpu.bridge.batching import DenseBatch as JaxDense
from dmlc_core_tpu.bridge.checkpoint import CheckpointManager as JaxManager
from dmlc_core_tpu.models.mlp import MLP as JaxMLP
from dmlc_core_tpu.models.mlp import MLPParam as JaxParam
from dmlc_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager
from dmlc_core_tpu_torch.examples import train_mlp
from tests.test_torch_tracker import run_port_workers

N = 4
F, B, HIDDEN, NCLASS, LR = 6, 32, "16,12,8", 3, 1e-2
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

WORKER = r'''
import os

import numpy as np
import torch

from dmlc_core_tpu_torch import collective
from dmlc_core_tpu_torch.bridge.batching import DenseBatch
from dmlc_core_tpu_torch.examples import train_mlp
from dmlc_core_tpu_torch.models import mlp as mlp_mod
from dmlc_core_tpu_torch.parallel.mesh import data_sharding, make_mesh

F, B, HIDDEN, NCLASS, LR = {consts!r}
collective.init({{"device": "cpu", "timeout": 60}})
r = collective.get_rank()
mesh = make_mesh({{"data": 2, "model": 2}})
rows = data_sharding(mesh, ndim=1)
rng = np.random.RandomState(11)
x = rng.randn(B, F).astype(np.float32)
y = rng.randint(0, NCLASS, B).astype(np.float32)
w = rng.uniform(0.5, 1.5, B).astype(np.float32)
batch = DenseBatch(*(torch.from_numpy(rows.shard(a).copy()) for a in (x, y, w)))
out = {{}}


def flat(tree, tag):
    for i, layer in enumerate(tree["layers"]):
        for k in ("w", "b"):
            out[f"{{tag}}_{{i}}{{k}}"] = layer[k].detach().numpy()


for bf16 in (False, True):
    tag = "bf16" if bf16 else "f32"
    model = mlp_mod.MLP(mlp_mod.MLPParam(
        num_feature=F, hidden=HIDDEN, num_class=NCLASS, bf16=bf16,
        learning_rate=LR), model_axis="model", device="cpu", mesh=mesh)
    params = model.init_params(2)
    opt = model.init_optimizer(params)
    with mesh:
        leaves = [t.detach().requires_grad_(True)
                  for t in mlp_mod._leaves(params)]
        loss, grads = model._data_parallel_grads(leaves, batch)
        out[tag + "_loss0"] = loss.detach().numpy()
        flat(model.gather_params(mlp_mod._rebuild(list(grads))),
             tag + "_grad")
        for step in range(2):
            params, opt, loss = model.train_step(params, opt, batch)
            out[f"{{tag}}_loss{{step + 1}}"] = loss.numpy()
    flat(model.gather_params(params), tag + "_p")
    flat(model.gather_params(opt.mu), tag + "_mu")
    flat(model.gather_params(opt.nu), tag + "_nu")
    out[tag + "_shapes"] = np.array([t.shape[1] if t.dim() == 2 else -1
                                     for t in mlp_mod._leaves(params)])
np.savez(os.path.join(os.environ["RESULT_DIR"], f"tp{{r}}.npz"), **out)
# the CLI in the same ranks: it joins the process group made above
train_mlp.main({cli!r})
'''


def _libsvm(path, n=512, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    y = (x[:, 0] + x[:, 1] - 0.5 * x[:, 5] > 0).astype(int)
    with open(path, "w") as f:
        for row, label in zip(x, y):
            f.write(f"{label} " + " ".join(f"{j}:{v:.6g}" for j, v in
                                           enumerate(row)) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(every rank's saved arrays, the checkpoint directory, the CLI's
    arguments, the resume launch's stderr)."""
    tmp = tmp_path_factory.mktemp("tp")
    data = _libsvm(tmp / "lin.libsvm")
    ckpt = str(tmp / "ckpt")
    cli = ["--data", data, "--num-feature", "8", "--hidden", "16,16",
           "--batch-size", "64", "--model-parallel", "2", "--device", "cpu",
           "--checkpoint-dir", ckpt]
    script = WORKER.format(consts=(F, B, HIDDEN, NCLASS, LR),
                           cli=cli + ["--epochs", "2"])
    env = {"DMLC_COLLECTIVE_TIMEOUT": "60"}
    proc = run_port_workers(tmp, script, N, timeout=120, env_extra=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [np.load(tmp / f"tp{r}.npz") for r in range(N)]
    first = proc.stderr
    proc = run_port_workers(tmp, "", N, timeout=120, env_extra=env,
                            script_path=train_mlp.__file__,
                            script_args=cli + ["--epochs", "3"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ranks, ckpt, cli, first, proc.stderr


def _jax_run(bf16):
    """JAX MLP(model_axis="model") on the 2 x 2 sub-mesh: the gradients of
    the first step, the losses, params and moments after two steps."""
    jmesh = jax_make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:N])
    rng = np.random.RandomState(11)
    x = rng.randn(B, F).astype(np.float32)
    y = rng.randint(0, NCLASS, B).astype(np.float32)
    w = rng.uniform(0.5, 1.5, B).astype(np.float32)
    sh = NamedSharding(jmesh, P("data"))
    batch = JaxDense(x=jax.device_put(x, sh), label=jax.device_put(y, sh),
                     weight=jax.device_put(w, sh))
    model = JaxMLP(JaxParam(num_feature=F, hidden=HIDDEN, num_class=NCLASS,
                            bf16=bf16, learning_rate=LR), model_axis="model")
    with jmesh:
        params = model.init_params(2)
        opt = model.init_optimizer(params)
        grads = jax.grad(model._loss)(params, batch)
        losses = [float(model._loss(params, batch))]
        for _ in range(2):
            params, opt, loss = model.train_step(params, opt, batch)
            losses.append(float(loss))
    return grads, losses, params, opt[0]


def _leaves(got, tag):
    n = len(HIDDEN.split(",")) + 1
    return [got[f"{tag}_{i}{k}"] for i in range(n) for k in ("w", "b")]


def _jleaves(tree):
    return [np.asarray(layer[k]) for layer in tree["layers"]
            for k in ("w", "b")]


def test_tp_ranks_hold_blocks_and_agree(run):
    ranks = run[0]
    # layers 1 and 2 are sharded over 2 model ranks: 12 / 2 and 8 / 2
    np.testing.assert_array_equal(ranks[0]["f32_shapes"],
                                  [16, -1, 6, -1, 4, -1, 3, -1])
    for got in ranks[1:]:
        for key in ranks[0].files:
            if "_grad_" in key or "_p_" in key or "_mu_" in key \
                    or "_nu_" in key or "_loss" in key:
                np.testing.assert_array_equal(got[key], ranks[0][key])


def test_tp_f32_steps_match_jax(run):
    got = run[0][0]
    grads, losses, params, opt = _jax_run(bf16=False)
    for a, b in zip(_leaves(got, "f32_grad"), _jleaves(grads)):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose([float(got[f"f32_loss{i}"]) for i in range(3)],
                               losses, rtol=1e-5, atol=1e-6)
    for tag, tree in (("f32_p", params), ("f32_mu", opt.mu),
                      ("f32_nu", opt.nu)):
        for a, b in zip(_leaves(got, tag), _jleaves(tree)):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())


def test_tp_bf16_steps_match_jax(run):
    got = run[0][0]
    grads, losses, params, _ = _jax_run(bf16=True)
    for a, b in zip(_leaves(got, "bf16_grad"), _jleaves(grads)):
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max()
    np.testing.assert_allclose([float(got[f"bf16_loss{i}"])
                                for i in range(3)], losses, **BF16_TOL)
    p0 = _jleaves(JaxMLP(JaxParam(num_feature=F, hidden=HIDDEN,
                                  num_class=NCLASS)).init_params(2))
    moved = np.concatenate([(a - a0).ravel() for a, a0 in
                            zip(_leaves(got, "bf16_p"), p0)])
    want = np.concatenate([(b - b0).ravel() for b, b0 in
                           zip(_jleaves(params), p0)])
    assert np.linalg.norm(moved - want) <= 0.25 * np.linalg.norm(want)


def _full_template():
    model = JaxMLP(JaxParam(num_feature=8, hidden="16,16"))
    params = model.init_params()
    return params, model.init_optimizer(params)


def test_tp_cli_checkpoints_full_trees_and_resumes(run):
    _, ckpt, cli, first, resumed = run
    assert "resuming from checkpoint epoch 1" in resumed
    assert "epoch 2: loss=" in resumed
    mine = CheckpointManager(ckpt)
    assert mine.all_steps() == [1, 2]
    for step in (1, 2):
        want = JaxManager(ckpt).restore(step, template=_full_template())
        got = mine.restore(step, template=_full_template())
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # the full widths: layer 1 is the sharded one
        assert np.asarray(want[0]["layers"][1]["w"]).shape == (16, 16)
    # a one-process run (--model-parallel 1) resumes the TP checkpoint
    # at step 2 and trains epochs 2 and 3
    argv = [a for a in cli if a not in ("--model-parallel", "2")]
    _, opt, losses = train_mlp.main(argv + ["--epochs", "4"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert int(opt.count) > 0


def test_tp_cli_losses_fall(run):
    first = run[3]
    losses = [float(line.split("loss=")[1]) for line in first.splitlines()
              if "loss=" in line]
    assert len(losses) == 2 and losses[1] < losses[0]
