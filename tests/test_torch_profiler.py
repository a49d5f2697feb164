"""The port's profiling helpers and MLP weight carrying, on the CPU.

``utils/profiler.py``: :func:`trace` writes a trace directory that holds
the :func:`annotate` spans (the contract of ``jax.profiler.start_trace``
and ``TraceAnnotation``), :func:`device_timer` returns ``(last result,
seconds per call)`` after ``warmup`` untimed calls, as the JAX package's
``device_timer`` does on the same function.  ``convert.py``: a JAX MLP
tree crosses into the port and back bitwise, and with
``MLP(model_axis=...)`` each rank gets its column blocks of the middle
layers.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.mlp import MLP as JaxMLP
from dmlc_core_tpu.models.mlp import MLPParam as JaxParam
from dmlc_core_tpu.utils import profiler as jax_profiler
from dmlc_core_tpu_torch.convert import (mlp_params_from_numpy,
                                         mlp_params_to_numpy)
from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam
from dmlc_core_tpu_torch.parallel.mesh import Mesh
from dmlc_core_tpu_torch.utils import profiler


def test_trace_writes_the_annotated_spans(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiler.trace(log_dir) as prof:
        with profiler.annotate("dmlc.step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "dmlc.step" in names
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "dmlc.step" for e in events)


def test_annotate_outside_a_trace_is_harmless():
    with profiler.annotate("outside"):
        x = torch.arange(4) + 1
    assert x.tolist() == [1, 2, 3, 4]


@pytest.mark.parametrize("iters,warmup", [(1, 1), (3, 0), (2, 2)])
def test_device_timer_matches_jax_contract(iters, warmup):
    calls = {"port": 0, "jax": 0}

    def fn(tag):
        calls[tag] += 1
        return np.float32(calls[tag])

    out, sec = profiler.device_timer(fn, "port", iters=iters, warmup=warmup)
    jout, jsec = jax_profiler.device_timer(fn, "jax", iters=iters,
                                           warmup=warmup)
    assert calls["port"] == calls["jax"] == iters + warmup
    assert float(out) == float(jout) == iters + warmup
    assert sec >= 0 and jsec >= 0


def test_device_timer_times_the_calls():
    import time

    _, sec = profiler.device_timer(time.sleep, 0.02, iters=3, warmup=0)
    assert 0.015 <= sec < 1.0


def _jax_tree(hidden="16,12,8"):
    model = JaxMLP(JaxParam(num_feature=6, hidden=hidden, num_class=3))
    return {"layers": [{k: np.asarray(layer[k]) for k in ("w", "b")}
                       for layer in model.init_params(5)["layers"]]}


def test_mlp_tree_crosses_both_ways_bitwise():
    tree = _jax_tree()
    mine = mlp_params_from_numpy(tree, device="cpu")
    ref = MLP(MLPParam(num_feature=6, hidden="16,12,8", num_class=3),
              device="cpu").init_params(5)
    for a, b in zip(mine["layers"], ref["layers"]):
        for k in ("w", "b"):
            assert torch.equal(a[k], b[k])
    back = mlp_params_to_numpy(mine)
    for a, b in zip(back["layers"], tree["layers"]):
        for k in ("w", "b"):
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("rank", range(4))
def test_mlp_tree_cut_into_the_ranks_blocks(rank):
    tree = _jax_tree()
    mesh = Mesh({"data": 2, "model": 2}, rank=rank)
    model = MLP(MLPParam(num_feature=6, hidden="16,12,8", num_class=3),
                model_axis="model", device="cpu", mesh=mesh)
    mine = mlp_params_from_numpy(tree, model=model)
    m = mesh.coord("model")
    for i, (a, b) in enumerate(zip(mine["layers"], tree["layers"])):
        if i in (1, 2):             # the middle layers: column blocks
            k = b["w"].shape[1] // 2
            np.testing.assert_array_equal(a["w"].numpy(),
                                          b["w"][:, m * k:(m + 1) * k])
            np.testing.assert_array_equal(a["b"].numpy(),
                                          b["b"][m * k:(m + 1) * k])
        else:
            np.testing.assert_array_equal(a["w"].numpy(), b["w"])
    # init_params draws the full weights, then keeps the same blocks
    drawn = model.init_params(5)
    for a, b in zip(drawn["layers"], mine["layers"]):
        for k in ("w", "b"):
            assert torch.equal(a[k], b[k])
