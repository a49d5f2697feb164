"""PyTorch port vs the JAX package: checkpoints and GBDT persistence.

The port writes the JAX package's ``DMLCTPU1`` format with its own tree
walk.  The same trees and the same seeded GBDTs go through both packages'
writers on the CPU: the bytes must be identical, and each blob must load in
the other package.  The port's ``CheckpointManager`` (manifests, retention,
``latest_valid``) is held to the rules ``tests/test_lifecycle.py`` holds
the reference's to.
"""

import collections
import os
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from dmlc_core_tpu.bridge import checkpoint as jck
from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
from dmlc_core_tpu.models.gbdt import TreeEnsemble as JaxEnsemble
from dmlc_core_tpu_torch.bridge import checkpoint as pck
from dmlc_core_tpu_torch.convert import ensemble_from_numpy
from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble
from dmlc_core_tpu_torch.utils.logging import Error

NF = 6


class Pair(NamedTuple):
    a: object
    b: object = None


def _trees():
    rng = np.random.RandomState(3)
    ens = [rng.randint(-1, 5, (2, 7)).astype(np.int32),
           rng.randint(0, 9, (2, 7)).astype(np.int32),
           rng.randn(2, 8).astype(np.float32), rng.rand(2, 7) > 0.5,
           None, rng.rand(2, 7).astype(np.float32)]
    return {
        "nested": {"z": np.arange(3, dtype=np.int64),
                   "b": {"y": None, "x": rng.randn(2, 3).astype(np.float32)},
                   "a": [np.zeros(2, np.float16), None,
                         (1.5, Pair(np.ones((1, 2), np.uint8)))]},
        "ensemble": (JaxEnsemble(*ens), TreeEnsemble(*ens)),
        "scalars": {"i": 7, "f": 0.25, "n": np.float32(2.0),
                    "o": collections.OrderedDict([("q", 1), ("p", 2)])},
        "list": [np.arange(4, dtype=np.int32), [np.eye(2), None]],
    }


@pytest.mark.parametrize("name", ["nested", "ensemble", "scalars", "list"])
def test_paths_and_bytes_match_jax(tmp_path, name):
    tree = _trees()[name]
    jax_tree, port_tree = tree if name == "ensemble" else (tree, tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_tree)
    assert pck.tree_flatten(port_tree)[0] == [
        jax.tree_util.keystr(p) for p, _ in flat]
    a, b = str(tmp_path / "jax.ck"), str(tmp_path / "port.ck")
    ja = jck.save_checkpoint(a, jax_tree)
    pa = pck.save_checkpoint(b, port_tree)
    assert ja == pa
    assert open(a, "rb").read() == open(b, "rb").read()
    # each package loads the other's blob, flat and through a template
    for uri in (a, b):
        want = jck.load_checkpoint(uri)
        got = pck.load_checkpoint(uri)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        rebuilt = pck.load_checkpoint(uri, template=port_tree)
        assert type(rebuilt) is type(port_tree)
        assert pck.tree_flatten(rebuilt)[0] == pck.tree_flatten(port_tree)[0]
        for x, y in zip(pck.tree_flatten(rebuilt)[1],
                        jax.tree_util.tree_leaves(
                            jck.load_checkpoint(uri, template=jax_tree))):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_tensor_leaves_and_template_rebuild(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "p": Pair(torch.tensor([1, 2], dtype=torch.int32)),
            "l": [torch.zeros(1, dtype=torch.bool), None]}
    uri = str(tmp_path / "t.ck")
    pck.save_checkpoint(uri, tree)
    numpy_tree = pck.tree_map(lambda t: t.numpy(), tree)
    jck.save_checkpoint(str(tmp_path / "j.ck"), numpy_tree)
    assert open(uri, "rb").read() == open(tmp_path / "j.ck", "rb").read()
    back = pck.load_checkpoint(uri, template=tree)
    assert isinstance(back["p"], Pair) and back["p"].b is None
    assert back["l"][1] is None
    np.testing.assert_array_equal(back["w"], tree["w"].numpy())
    with pytest.raises(Error, match="shape mismatch"):
        pck.load_checkpoint(uri, template=dict(tree, w=torch.zeros(3)))
    with pytest.raises(Error, match="structure mismatch"):
        pck.load_checkpoint(uri, template={"w": tree["w"]})


def test_async_save_snapshots_before_the_step_mutates(tmp_path):
    mgr = pck.CheckpointManager(str(tmp_path / "ck"))
    w = torch.ones(1000)
    mgr.save(1, {"w": w})
    w.fill_(5.0)            # the next step overwrites the tensor at once
    mgr.wait_until_finished()
    assert mgr.read_manifest(1) is not None
    np.testing.assert_array_equal(mgr.restore(1)["['w']"], np.ones(1000))


# -- GBDT persistence --------------------------------------------------------

def _jax_fit(objective="logistic", handle_missing=False, rounds=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(400, NF).astype(np.float32)
    y = (x[:, 0] - x[:, 2] > 0).astype(np.float32)
    if objective == "squared":
        y = (x[:, 0] - 0.5 * x[:, 1]).astype(np.float32)
    if handle_missing:
        x[rng.rand(*x.shape) < 0.15] = np.nan
    jm = JaxGBDT(JaxParam(objective=objective, num_boost_round=rounds,
                          max_depth=3, num_bins=32,
                          handle_missing=handle_missing, base_score=0.25),
                 num_feature=NF)
    jm.make_bins(x)
    ens, _ = jm.fit_binned(jm.bin_features(x), y)
    return jm, ens, x


def _port_twin(jm, ens):
    p = jm.param
    pm = GBDT(GBDTParam(objective=p.objective, num_boost_round=p.num_boost_round,
                        max_depth=p.max_depth, num_bins=p.num_bins,
                        handle_missing=p.handle_missing,
                        base_score=p.base_score),
              num_feature=NF, device="cpu")
    pm.set_boundaries(jm.boundaries)
    return pm, ensemble_from_numpy(
        [None if a is None else np.asarray(a) for a in ens], device="cpu")


@pytest.mark.parametrize("handle_missing", [False, True])
def test_model_blobs_byte_identical_and_cross_load(tmp_path, handle_missing):
    jm, ens, x = _jax_fit(handle_missing=handle_missing)
    pm, pens = _port_twin(jm, ens)
    extra = {"labels": np.array([3, 5], np.int64)}
    for kind in ("save_model", "serving_state"):
        a, b = str(tmp_path / f"{kind}.jax"), str(tmp_path / f"{kind}.port")
        if kind == "save_model":
            jm.save_model(a, ens, extra)
            pm.save_model(b, pens, extra)
        else:
            jck.save_checkpoint(a, jm.serving_state(ens, extra))
            pck.save_checkpoint(b, pm.serving_state(pens, extra))
        assert open(a, "rb").read() == open(b, "rb").read(), kind
    # the JAX blob in the port, the port blob in the JAX package
    pg, pe = GBDT.from_serving_state(
        pck.load_checkpoint(str(tmp_path / "serving_state.jax")),
        device="cpu")
    jg, je = JaxGBDT.from_serving_state(
        jck.load_checkpoint(str(tmp_path / "serving_state.port")))
    assert pg.param.handle_missing == handle_missing
    assert pg.param.base_score == jg.param.base_score == 0.25
    for got, want in zip(pe, je):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pg.boundaries, jg.boundaries)
    want = np.asarray(jg.predict_margin(je, jg.bin_features(x)))
    got = pg.predict_margin(pe, pg.bin_features(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # load_model into a GBDT with the right param; the wrong one refuses
    loaded = pm.load_model(str(tmp_path / "save_model.jax"))
    for got, want in zip(loaded, pens):
        assert torch.equal(got, want)
    other = GBDT(GBDTParam(num_bins=32, max_depth=3, base_score=0.25,
                           handle_missing=not handle_missing),
                 num_feature=NF, device="cpu")
    with pytest.raises(Error, match="handle_missing"):
        other.load_model(str(tmp_path / "save_model.port"))


def test_stats_free_ensembles_and_extra_clashes(tmp_path):
    jm, ens, _ = _jax_fit(objective="squared")
    pm, pens = _port_twin(jm, ens)
    bare = TreeEnsemble(*pens[:4])
    jbare = JaxEnsemble(*ens[:4])
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jck.save_checkpoint(a, jm.serving_state(jbare))
    pck.save_checkpoint(b, pm.serving_state(bare))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert "['split_gain']" not in pck.load_checkpoint(b)
    _, back = GBDT.from_serving_state(pck.load_checkpoint(b), device="cpu")
    assert back.split_gain is None and back.split_cover is None
    with pytest.raises(Error, match="clashes"):
        pm.save_model(b, pens, {"split_feat": np.zeros(1)})
    with pytest.raises(Error, match="serve_meta"):
        pm.serving_state(pens, {"serve_meta": np.zeros(1)})
    with pytest.raises(Error, match="object dtype"):
        pm.save_model(b, pens, {"labels": np.array(["a", 1], object)})


def test_resume_appends_rounds_like_the_jax_package(tmp_path):
    jm, ens, x = _jax_fit(objective="squared", rounds=2)
    pm, pens = _port_twin(jm, ens)
    uri = str(tmp_path / "s")
    pck.save_checkpoint(uri, pm.serving_state(pens))
    flat = pck.load_checkpoint(uri)
    param = GBDTParam(objective="squared", num_bins=32, max_depth=3,
                      base_score=0.25, learning_rate=0.1,
                      hist_method="scatter")
    pg, pe = GBDT.resume(flat, param, device="cpu")
    jg, je = JaxGBDT.resume(jck.load_checkpoint(uri), JaxParam(
        objective="squared", num_bins=32, max_depth=3, base_score=0.25,
        learning_rate=0.1))
    y = (x[:, 0] - 0.5 * x[:, 1]).astype(np.float32)
    pe2, _ = pg.append_rounds(pe, pg.bin_features(x), y, num_rounds=2)
    je2, _ = jg.append_rounds(je, jg.bin_features(x), y, num_rounds=2)
    assert pe2.num_trees == je2.num_trees == 4
    np.testing.assert_array_equal(pe2.split_feat.numpy(),
                                  np.asarray(je2.split_feat))
    np.testing.assert_allclose(pe2.leaf_value.numpy(),
                               np.asarray(je2.leaf_value), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(Error, match="structural contract"):
        GBDT.resume(flat, GBDTParam(objective="squared", num_bins=64,
                                    max_depth=3, base_score=0.25),
                    device="cpu")
    with pytest.raises(Error, match="serve_meta"):
        GBDT.from_serving_state({"['split_feat']": np.zeros(1)},
                                device="cpu")


# -- corrupt blobs -----------------------------------------------------------

def _corrupt(path, case, nbytes):
    if case == "magic":
        with open(path, "r+b") as f:
            f.write(b"NOTACKPT")
    elif case == "truncated":
        with open(path, "r+b") as f:
            f.truncate(nbytes - 7)
    else:
        with open(path, "r+b") as f:
            f.seek(30)
            byte = f.read(1)
            f.seek(30)
            f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("case,match", [
    ("magic", "bad magic"), ("truncated", "truncated"), ("crc", "CRC-32")])
def test_verify_checkpoint_rejects_corrupt_blobs(tmp_path, case, match):
    mgr = pck.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"w": np.arange(32, dtype=np.float32)}, async_=False)
    manifest = mgr.read_manifest(1)
    pck.verify_checkpoint(mgr.step_uri(1), manifest)   # clean first
    _corrupt(mgr.step_uri(1), case, manifest["nbytes"])
    with pytest.raises(pck.CheckpointCorruptError, match=match):
        pck.verify_checkpoint(mgr.step_uri(1), manifest)
    # the reference's verifier agrees on the same bytes and manifest
    with pytest.raises(jck.CheckpointCorruptError, match=match):
        jck.verify_checkpoint(mgr.step_uri(1), manifest)


# -- CheckpointManager (the rules of tests/test_lifecycle.py) ----------------

def _publish(mgr, step):
    mgr.save(step, {"w": np.full(4, step, np.float32)}, async_=False)


def test_manifest_publishes_after_blob_and_retention_removes_it(tmp_path):
    import time

    mgr = pck.CheckpointManager(str(tmp_path / "ck"), keep=1)
    _publish(mgr, 1)
    m = mgr.read_manifest(1)
    assert m is not None and m["step"] == 1 and m["nbytes"] > 0
    assert abs(m["written_at"] - time.time()) < 60
    pck.verify_checkpoint(mgr.step_uri(1), m)
    # the reference's manager reads the port's manifests
    assert jck.CheckpointManager(mgr.directory).read_manifest(1)["crc32"] \
        == m["crc32"]
    _publish(mgr, 2)
    assert mgr.all_steps() == [2]
    assert mgr.read_manifest(1) is None


def test_unpublished_step_is_not_used_until_its_manifest_lands(tmp_path):
    mgr = pck.CheckpointManager(str(tmp_path / "ck"), keep=10)
    _publish(mgr, 1)
    # a blob with no manifest beside it == a write still in flight
    pck.save_checkpoint(mgr.prepare_step(2), {"w": np.zeros(4, np.float32)})
    assert mgr.latest_step() == 2
    assert mgr.latest_valid() == (None, None)        # watch semantics
    step, manifest = mgr.latest_valid(skip_unpublished=True)
    assert step == 1 and manifest["step"] == 1       # resume semantics
    summary = pck.save_checkpoint(mgr.step_uri(2),
                                  {"w": np.zeros(4, np.float32)})
    mgr.publish(2, summary)
    assert mgr.latest_valid()[0] == 2


def test_latest_valid_falls_back_past_known_bad_and_corrupt(tmp_path):
    mgr = pck.CheckpointManager(str(tmp_path / "ck"), keep=10)
    for step in (1, 2, 3):
        _publish(mgr, step)
    m3 = mgr.read_manifest(3)
    assert mgr.latest_valid(known_bad=[(3, m3["crc32"])])[0] == 2
    assert mgr.latest_valid(above=3) == (None, None)
    with open(mgr.step_uri(3), "r+b") as f:
        f.seek(25)
        f.write(b"\x00\xff")
    assert mgr.latest_valid()[0] == 3                 # bytes not checked
    assert mgr.latest_valid(verify=True)[0] == 2
    # the same scan on the reference's manager over the same store
    assert jck.CheckpointManager(mgr.directory).latest_valid(
        verify=True)[0] == 2


def test_restore_falls_back_past_an_unreadable_newest_step(tmp_path):
    mgr = pck.CheckpointManager(str(tmp_path / "ck"), keep=10)
    _publish(mgr, 1)
    _publish(mgr, 2)
    with open(mgr.step_uri(2), "r+b") as f:
        f.truncate(12)
    np.testing.assert_array_equal(mgr.restore()["['w']"],
                                  np.full(4, 1, np.float32))
    os.remove(mgr.step_uri(1))
    with pytest.raises(RuntimeError, match="unreadable"):
        mgr.restore()


def test_orphan_temps_of_dead_writers_are_swept(tmp_path):
    import socket

    mgr = pck.CheckpointManager(str(tmp_path / "ck"))
    uri = mgr.prepare_step(1)
    host = socket.gethostname()
    dead = f"{uri}.tmp.{host}.999999999"
    live = f"{uri}.tmp.{host}.{os.getpid()}"
    foreign = f"{uri}.tmp.other-host.1"
    for p in (dead, live, foreign):
        open(p, "wb").close()
    mgr.prepare_step(1)
    assert not os.path.exists(dead)
    assert os.path.exists(live) and os.path.exists(foreign)
