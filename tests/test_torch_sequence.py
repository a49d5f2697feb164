"""The port's sequence parallelism against the JAX package's.

One launch of 4 port ranks (the port's launcher, gloo, ``device="cpu"``)
runs every case of ``tests/test_sequence.py`` at 4 ranks: ring and
Ulysses attention, causal and not, at its shapes (B=2, L=64, H=8, D=16),
the ring at L=256, and the gradients of q, k and v of ``sum(out**2)``
(L=32, H=8, D=8) through both.  Each rank saves its sequence blocks; the
test process joins them and holds them to the JAX functions on a 4-device
sub-mesh of the 8-device CPU mesh: outputs within rtol 2e-4, atol 2e-5,
gradients within atol 2e-5, rtol 1e-4 (the JAX tests' bounds).  The shape
checks and ``reference_attention`` run in this process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dmlc_core_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dmlc_core_tpu.parallel.sequence import (
    reference_attention as jax_reference,
    ring_attention as jax_ring,
    ulysses_attention as jax_ulysses,
)
from dmlc_core_tpu_torch.parallel.mesh import Mesh
from dmlc_core_tpu_torch.parallel.sequence import (reference_attention,
                                                   ring_attention,
                                                   shard_sequence,
                                                   ulysses_attention)
from dmlc_core_tpu_torch.utils.logging import Error
from tests.test_torch_tracker import run_port_workers

N = 4
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)

# (name, function, B, L, H, D, seed, causal)
CASES = [
    ("ring_full", "ring", 2, 64, 8, 16, 0, False),
    ("ring_causal", "ring", 2, 64, 8, 16, 0, True),
    ("ulysses_full", "ulysses", 2, 64, 8, 16, 0, False),
    ("ulysses_causal", "ulysses", 2, 64, 8, 16, 0, True),
    ("ring_long", "ring", 1, 256, 4, 8, 3, True),
]
GRAD_CASES = [("ring_grad", "ring"), ("ulysses_grad", "ulysses")]

WORKER = r'''
import os

import numpy as np
import torch

from dmlc_core_tpu_torch import collective
from dmlc_core_tpu_torch.parallel.mesh import make_mesh
from dmlc_core_tpu_torch.parallel.sequence import (ring_attention,
                                                   shard_sequence,
                                                   ulysses_attention)

CASES = {cases!r}
GRAD_CASES = {grad_cases!r}
FNS = {{"ring": ring_attention, "ulysses": ulysses_attention}}


def make_qkv(B=2, L=64, H=8, D=16, seed=0):
    rng = np.random.RandomState(seed)
    shape = (B, L, H, D)
    return (torch.from_numpy(rng.randn(*shape).astype(np.float32)) * 0.3,
            torch.from_numpy(rng.randn(*shape).astype(np.float32)) * 0.3,
            torch.from_numpy(rng.randn(*shape).astype(np.float32)))


collective.init({{"device": "cpu", "timeout": 60}})
rank = collective.get_rank()
mesh = make_mesh({{"sp": 4}})
out = {{}}
for name, fn, B, L, H, D, seed, causal in CASES:
    q, k, v = (shard_sequence(t, mesh, "sp")
               for t in make_qkv(B, L, H, D, seed))
    out[name] = FNS[fn](q, k, v, mesh, axis="sp", causal=causal).numpy()
for name, fn in GRAD_CASES:
    leaves = [shard_sequence(t, mesh, "sp").clone().requires_grad_(True)
              for t in make_qkv(L=32, H=8, D=8, seed=1)]
    loss = (FNS[fn](*leaves, mesh, axis="sp", causal=True) ** 2).sum()
    loss.backward()
    for tag, t in zip("qkv", leaves):
        out[f"{{name}}_d{{tag}}"] = t.grad.numpy()
np.savez(os.path.join(os.environ["RESULT_DIR"], f"seq{{rank}}.npz"), **out)
collective.finalize()
'''


def make_qkv(B=2, L=64, H=8, D=16, seed=0):
    rng = np.random.RandomState(seed)
    shape = (B, L, H, D)
    return (jnp.asarray(rng.randn(*shape).astype(np.float32)) * 0.3,
            jnp.asarray(rng.randn(*shape).astype(np.float32)) * 0.3,
            jnp.asarray(rng.randn(*shape).astype(np.float32)))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's saved blocks, joined along the sequence."""
    tmp = tmp_path_factory.mktemp("seq")
    proc = run_port_workers(
        tmp, WORKER.format(cases=CASES, grad_cases=GRAD_CASES), N,
        timeout=120, env_extra={"DMLC_COLLECTIVE_TIMEOUT": "60"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [np.load(tmp / f"seq{r}.npz") for r in range(N)]
    return {k: np.concatenate([r[k] for r in ranks], axis=1)
            for k in ranks[0].files}


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"sp": N}, devices=jax.devices()[:N])


def _shard(mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P(None, "sp", None, None)))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_attention_matches_jax(port, jax_mesh, case):
    name, fn, B, L, H, D, seed, causal = case
    q, k, v = make_qkv(B, L, H, D, seed)
    jfn = jax_ring if fn == "ring" else jax_ulysses
    want = np.asarray(jfn(*(_shard(jax_mesh, t) for t in (q, k, v)),
                          jax_mesh, axis="sp", causal=causal))
    np.testing.assert_allclose(port[name], want, **OUT_TOL)
    expect = np.asarray(jax_reference(q, k, v, causal=causal))
    np.testing.assert_allclose(port[name], expect, **OUT_TOL)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_gradients_match_jax(port, jax_mesh, case):
    name, fn = case
    q, k, v = make_qkv(L=32, H=8, D=8, seed=1)
    jfn = jax_ring if fn == "ring" else jax_ulysses

    def loss_sp(q, k, v):
        return jnp.sum(jfn(q, k, v, jax_mesh, axis="sp", causal=True) ** 2)

    def loss_ref(q, k, v):
        return jnp.sum(jax_reference(q, k, v, causal=True) ** 2)

    g_sp = jax.grad(loss_sp, argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for tag, a, b in zip("qkv", g_sp, g_ref):
        got = port[f"{name}_d{tag}"]
        np.testing.assert_allclose(got, np.asarray(a), **GRAD_TOL)
        np.testing.assert_allclose(got, np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    q, k, v = make_qkv(L=48, seed=5)
    got = reference_attention(*(torch.from_numpy(np.array(t))
                                for t in (q, k, v)), causal=causal)
    want = np.asarray(jax_reference(q, k, v, causal=causal))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_shape_validation():
    # the checks fire before any collective: a layout-only mesh will do
    mesh = Mesh({"sp": N}, rank=1)
    q, k, v = (torch.from_numpy(np.array(t)) for t in make_qkv(L=62))
    with pytest.raises(Error, match="divide"):
        shard_sequence(q, mesh, "sp")
    q, k, v = (torch.from_numpy(np.array(t)) for t in make_qkv(H=2))
    with pytest.raises(Error, match="heads"):
        ulysses_attention(q, k, v, mesh, axis="sp")
    with pytest.raises(Error, match="do not fit"):
        ring_attention(q, k[:, :, :1], v, mesh, axis="sp")
