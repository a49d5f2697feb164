"""PyTorch port vs the JAX package: the linear and MLP model families.

The same seeded inputs go through the JAX package and the port on the
CPU.  Tolerances:

- initial params: bitwise (both draw from numpy ``RandomState(seed)``);
- linear models and runtimes (dense and sparse SGD, logistic and
  squared): rtol 1e-6, atol 1e-6;
- MLP with ``bf16=False``: rtol 1e-5 (atol 1e-6 for values near 0; the
  Adam moments atol 1e-5 of their largest value);
- MLP with ``bf16=True``: logits and losses within rtol 2e-2, atol 2e-2
  (the two packages round the bf16 gelu at other points, and XLA and
  torch order the bf16 dot's sums otherwise; the largest differences
  read over the cases below are 1.5625e-2 on a logit, one bf16 ulp at
  2-4, and 6.27e-3 on a loss).  The bf16 backward pass and step are held
  by norms that a wrong step fails: each leaf's gradient of the first
  step within a relative norm of 5e-2 of JAX's (largest read 1.60e-2),
  and the whole update of 3 Adam steps, ``p3 - p0`` over every leaf,
  within a relative norm of 0.25 of JAX's (largest read 0.109, for gelu
  with 3 classes: Adam moves each param by about ``lr`` times the sign of
  its gradient, so the few near-zero gradients whose sign the rounding
  flips count twice).  A step that does nothing reads 1.0 there, a
  half-size step 0.5 and a negated step 2.0.

Checkpoints of params written by either package are byte-identical and
load in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.bridge.batching import DenseBatch as JaxDense
from dmlc_core_tpu.bridge.batching import SparseBatch as JaxSparse
from dmlc_core_tpu.bridge.checkpoint import CheckpointManager as JaxManager
from dmlc_core_tpu.models.linear import LinearModel as JaxLinear
from dmlc_core_tpu.models.linear import LinearParam as JaxLinearParam
from dmlc_core_tpu.models.mlp import MLP as JaxMLP
from dmlc_core_tpu.models.mlp import MLPParam as JaxMLPParam
from dmlc_core_tpu.ops import sparse as jax_sparse
from dmlc_core_tpu.serve import build_runtime as jax_build_runtime
from dmlc_core_tpu_torch.bridge.batching import DenseBatch, SparseBatch
from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager
from dmlc_core_tpu_torch.models.linear import LinearModel, LinearParam
from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam
from dmlc_core_tpu_torch.ops import sparse
from dmlc_core_tpu_torch.serve import (LinearRuntime, MLPRuntime,
                                       build_runtime)
from dmlc_core_tpu_torch.utils.logging import Error

NF = 6
B = 48
LIN_TOL = dict(rtol=1e-6, atol=1e-6)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MLP_LR = 1e-3


def _np(a):
    return np.asarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else a)


def _dense(seed, label="binary", nf=NF, n=B):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, nf).astype(np.float32)
    if label == "binary":
        y = (x[:, 0] - x[:, 1] > 0).astype(np.float32)
    elif label == "class3":
        y = rng.randint(0, 3, n).astype(np.float32)
    else:
        y = (x @ rng.randn(nf)).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    w[-3:] = 0.0   # padding rows
    return (JaxDense(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)),
            DenseBatch(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(w)))


def _sparse(seed, nf=NF, n=B, nnz=160):
    rng = np.random.RandomState(seed)
    row_id = np.sort(rng.randint(0, n + 1, nnz)).astype(np.int32)
    index = rng.randint(0, nf, nnz).astype(np.int32)
    index[row_id == n] = 0                     # padding entries
    value = rng.randn(nnz).astype(np.float32)
    label = (rng.rand(n) > 0.5).astype(np.float32)
    weight = np.ones(n, np.float32)
    arrays = (value, index, row_id, label, weight)
    return (JaxSparse(*[jnp.asarray(a) for a in arrays]),
            SparseBatch(*[torch.from_numpy(a) for a in arrays]))


# -- ops/sparse.py --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_ops_match_jax_with_padding(seed):
    jb, pb = _sparse(seed)
    rng = np.random.RandomState(10 + seed)
    w = rng.randn(NF).astype(np.float32)
    r = np.append(rng.randn(B).astype(np.float32), np.float32(0.0))
    want = jax_sparse.segment_matvec(jnp.asarray(w), jb.value, jb.index,
                                     jb.row_id, B)
    got = sparse.segment_matvec(torch.from_numpy(w), pb.value, pb.index,
                                pb.row_id, B)
    assert got.shape == (B,)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LIN_TOL)
    want_t = jax_sparse.segment_transpose_matvec(
        jnp.asarray(r), jb.value, jb.index, jb.row_id, NF)
    got_t = sparse.segment_transpose_matvec(torch.from_numpy(r), pb.value,
                                            pb.index, pb.row_id, NF)
    np.testing.assert_allclose(_np(got_t), np.asarray(want_t), **LIN_TOL)
    b = np.float32(0.25)
    np.testing.assert_allclose(
        _np(sparse.sparse_logit(torch.from_numpy(w), torch.tensor(b), pb,
                                NF)),
        np.asarray(jax_sparse.sparse_logit(jnp.asarray(w), b, jb, NF)),
        **LIN_TOL)


def test_segment_matvec_drops_the_padding_segment():
    # the reference's own hand case: row 2 is the padding segment
    got = sparse.segment_matvec(torch.tensor([1.0, 2.0, 3.0, 4.0]),
                                torch.tensor([1.0, 1.0, 2.0, 9.0]),
                                torch.tensor([0, 3, 1, 0], dtype=torch.int32),
                                torch.tensor([0, 0, 1, 2], dtype=torch.int32),
                                2)
    np.testing.assert_array_equal(_np(got), [5.0, 4.0])


# -- models/linear.py -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_linear_init_params_bitwise(seed):
    want = JaxLinear(JaxLinearParam(num_feature=NF)).init_params(seed)
    got = LinearModel(LinearParam(num_feature=NF),
                      device="cpu").init_params(seed)
    for k in ("w", "b"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("loss", ["logistic", "squared"])
def test_linear_steps_and_predict_match_jax(layout, loss):
    kw = dict(num_feature=NF, loss=loss, learning_rate=0.3, reg_lambda=0.01)
    jm, pm = JaxLinear(JaxLinearParam(**kw)), \
        LinearModel(LinearParam(**kw), device="cpu")
    jp, pp = jm.init_params(1), pm.init_params(1)
    for step in range(3):
        if layout == "dense":
            jb, pb = _dense(step, "binary" if loss == "logistic" else "reg")
        else:
            jb, pb = _sparse(step)
        jp, jloss = jm.train_step(jp, jb)
        pp, ploss = pm.train_step(pp, pb)
        np.testing.assert_allclose(float(ploss), float(jloss), **LIN_TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(_np(pp[k]), np.asarray(jp[k]),
                                       **LIN_TOL)
    np.testing.assert_allclose(_np(pm.predict(pp, pb)),
                               np.asarray(jm.predict(jp, jb)), **LIN_TOL)


def test_linear_fit_over_a_loader_matches_jax():
    batches = [_dense(s) for s in range(4)]
    kw = dict(num_feature=NF, learning_rate=0.5)
    jp, jloss = JaxLinear(JaxLinearParam(**kw)).fit(
        [j for j, _ in batches], params=None)
    pp, ploss = LinearModel(LinearParam(**kw), device="cpu").fit(
        [p for _, p in batches], params=None, log_every=2)
    np.testing.assert_allclose(float(ploss), float(jloss), **LIN_TOL)
    np.testing.assert_allclose(_np(pp["w"]), np.asarray(jp["w"]), **LIN_TOL)


# -- models/mlp.py --------------------------------------------------------------

def _mlp_pair(activation="relu", bf16=False, num_class=3, hidden="16,8"):
    kw = dict(num_feature=NF, hidden=hidden, num_class=num_class,
              activation=activation, bf16=bf16, learning_rate=MLP_LR)
    return JaxMLP(JaxMLPParam(**kw)), MLP(MLPParam(**kw), device="cpu")


def _layers(params):
    return [_np(layer[k]) for layer in params["layers"] for k in ("w", "b")]


def _rel_norm(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _grads(jm, jp, jb, pm, pp, pb):
    """Each leaf's gradient of the loss, from JAX and from torch autograd."""
    want = jax.grad(jm._loss)(jp, jb)
    leaves = {"layers": [{k: layer[k].detach().clone().requires_grad_(True)
                          for k in ("w", "b")} for layer in pp["layers"]]}
    flat = [layer[k] for layer in leaves["layers"] for k in ("w", "b")]
    got = torch.autograd.grad(pm._loss(leaves, pb), flat)
    return [_np(g) for g in got], _layers(want)


@pytest.mark.parametrize("hidden", ["16,8", "32,32", "5"])
def test_mlp_init_params_bitwise(hidden):
    jm, pm = _mlp_pair(hidden=hidden)
    for a, b in zip(_layers(pm.init_params(4)), _layers(jm.init_params(4))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_class", [1, 3])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu"])
def test_mlp_apply_loss_and_adam_match_jax(activation, bf16, num_class):
    jm, pm = _mlp_pair(activation, bf16, num_class)
    tol = BF16_TOL if bf16 else F32_TOL
    jp, pp = jm.init_params(2), pm.init_params(2)
    jo, po = jm.init_optimizer(jp), pm.init_optimizer(pp)
    jb, pb = _dense(5, "class3" if num_class > 1 else "reg")
    np.testing.assert_allclose(_np(pm._apply(pp, pb.x)),
                               np.asarray(jm._apply(jp, jb.x)), **tol)
    np.testing.assert_allclose(float(pm._loss(pp, pb)),
                               float(jm._loss(jp, jb)), **tol)
    if bf16:
        for got, want in zip(*_grads(jm, jp, jb, pm, pp, pb)):
            assert _rel_norm(got, want) <= 5e-2
    p0 = _layers(jp)
    assert all(np.array_equal(a, b) for a, b in zip(_layers(pp), p0))
    for step in range(3):
        jp, jo, jloss = jm.train_step(jp, jo, jb)
        pp, po, ploss = pm.train_step(pp, po, pb)
        np.testing.assert_allclose(float(ploss), float(jloss), **tol)
    assert int(po.count) == int(jo[0].count) == 3
    if bf16:
        got = np.concatenate([(a - a0).ravel()
                              for a, a0 in zip(_layers(pp), p0)])
        want = np.concatenate([(b - b0).ravel()
                               for b, b0 in zip(_layers(jp), p0)])
        assert _rel_norm(got, want) <= 0.25
    else:
        for a, b in zip(_layers(pp), _layers(jp)):
            np.testing.assert_allclose(a, b, **F32_TOL)
        # the moments within 1e-5 of their own scale (a tiny gradient's
        # relative error is larger than 1e-5; its square's twice that)
        for a, b in zip(_layers(po.mu) + _layers(po.nu),
                        _layers(jo[0].mu) + _layers(jo[0].nu)):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
    x = _np(pb.x)
    np.testing.assert_allclose(_np(pm.predict(pp, x)),
                               np.asarray(jm.predict(jp, x)), **tol)


def test_mlp_gelu_is_the_tanh_approximation():
    # jax.nn.gelu defaults to approximate=True: at 1.0 the tanh form gives
    # 0.841192 and the erf form 0.841345
    _, pm = _mlp_pair("gelu", hidden="1")
    params = {"layers": [{"w": torch.ones(NF, 1) / NF, "b": torch.zeros(1)},
                         {"w": torch.ones(1, 3), "b": torch.zeros(3)}]}
    out = _np(pm._apply(params, torch.ones(1, NF)))
    want = float(jax.nn.gelu(jnp.float32(1.0)))
    np.testing.assert_allclose(out, np.full((1, 3), want), rtol=1e-6)
    assert abs(want - 0.841192) < 1e-5


def test_mlp_model_axis_and_card_rules():
    # the sharded hidden layers need a mesh with the model axis
    # (tests/test_torch_mlp_tp.py runs them on one)
    with pytest.raises(Error, match="needs a mesh"):
        MLP(MLPParam(num_feature=NF), model_axis="model",
            device="cpu").init_params()
    if torch.cuda.is_available():
        assert MLP(MLPParam(num_feature=NF)).device.type == "cuda"
        return
    for make in (lambda: MLP(MLPParam(num_feature=NF)),
                 lambda: LinearModel(LinearParam(num_feature=NF)),
                 lambda: build_runtime("linear", NF),
                 lambda: build_runtime("mlp", NF)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# -- serving runtimes and checkpoints -------------------------------------------

RUNTIME_CASES = [("linear", {}), ("mlp", {}),
                 ("mlp", {"num_class": 1, "hidden": "8"}),
                 ("mlp", {"num_class": 4, "hidden": "16,16,16"})]


def _rows(seed, n=37, nf=NF):
    return np.random.RandomState(seed).randn(n, nf).astype(np.float32)


@pytest.mark.parametrize("kind,kw", RUNTIME_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(RUNTIME_CASES)])
def test_runtimes_match_jax_on_the_same_rows(kind, kw):
    port = build_runtime(kind, NF, seed=3, device="cpu", **kw)
    ref = jax_build_runtime(kind, NF, seed=3, **kw)
    assert isinstance(port, LinearRuntime if kind == "linear" else MLPRuntime)
    assert port.name == ref.name == kind
    x = _rows(1)
    got, want = port.predict(x), np.asarray(ref.predict(x))
    assert got.shape == want.shape and got.dtype == np.float32
    # the MLP runtimes serve the JAX defaults: bf16 matmuls
    tol = LIN_TOL if kind == "linear" else BF16_TOL
    np.testing.assert_allclose(got, want, **tol)
    assert port.warmup([1, 2, 4]) == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_param_checkpoints_byte_identical_and_cross_load(tmp_path, kind,
                                                         writer):
    port_rt = build_runtime(kind, NF, seed=9, device="cpu")
    ref_rt = jax_build_runtime(kind, NF, seed=9)
    jmgr, pmgr = JaxManager(str(tmp_path / "j")), \
        CheckpointManager(str(tmp_path / "p"))
    jmgr.save(1, ref_rt.params, async_=False)
    pmgr.save(1, port_rt.params, async_=False)
    with open(jmgr.step_uri(1), "rb") as a, open(pmgr.step_uri(1), "rb") as b:
        assert a.read() == b.read()
    uri = (jmgr if writer == "jax" else pmgr).step_uri(1)
    # another seed's architecture, restored from the blob: seed 9's answers
    port = build_runtime(kind, NF, seed=0, checkpoint=uri, device="cpu")
    ref = jax_build_runtime(kind, NF, seed=0, checkpoint=uri)
    x = _rows(2)
    np.testing.assert_array_equal(port.predict(x), port_rt.predict(x))
    np.testing.assert_array_equal(np.asarray(ref.predict(x)),
                                  np.asarray(ref_rt.predict(x)))
    tol = LIN_TOL if kind == "linear" else BF16_TOL
    np.testing.assert_allclose(port.predict(x), np.asarray(ref.predict(x)),
                               **tol)
