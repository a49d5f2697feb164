"""PyTorch port vs the JAX package: the entry points.

On the CPU (``--device cpu``), against the JAX examples run in-process on
the same seeded libsvm files:

- ``train_gbdt`` with ``--eval-data``/``--early-stopping-rounds`` stops at
  the JAX CLI's round with the same trees, and its ``--checkpoint-dir``
  steps resume in either package (sampling on, so the resumed rounds must
  draw by their round index);
- ``train_logreg`` (both forms) reaches the JAX example's epoch losses
  within 1e-5 and resumes ``--checkpoint`` versions of either package;
- ``train_mlp`` reaches the JAX example's losses within the bf16 bounds of
  ``tests/test_torch_linear_mlp.py`` (rtol = atol = 2e-2) and resumes a
  checkpoint directory the JAX example wrote, and the other way round;
- ``graft_entry.entry()`` scores what ``__graft_entry__.entry()`` scores;
- ``MeshBatchLoader`` at world 1 yields the JAX loader's batches bitwise;
- a 3-class ensemble serves the same probabilities through both
  packages' ``GBDTRuntime`` (atol 1.2e-7: ``exp`` differs by an ulp).
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.examples import train_gbdt, train_logreg, train_mlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_MLP = 2e-2
PROB_ATOL = 1.2e-7


def _libsvm(path, n, f, seed, rule):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    y = rule(x).astype(np.float32)
    path.write_text("".join(
        f"{int(y[i])} " + " ".join(f"{j}:{v:.6g}" for j, v in enumerate(r))
        + "\n" for i, r in enumerate(x)))
    return str(path)


def _run_jax_example(name, args, monkeypatch):
    """The JAX example ``examples/<name>.py`` run in-process."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args)
    try:
        runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"),
                       run_name="__main__")
    finally:
        from dmlc_core_tpu import collective

        collective.finalize()


def _epoch_losses(text):
    return [float(line.split("loss=")[1].split()[0])
            for line in text.splitlines() if line.startswith("epoch ")]


# -- train_gbdt ---------------------------------------------------------------

def _gbdt_files(tmp_path):
    rule = lambda x: x[:, 0] + 0.5 * x[:, 1] * x[:, 2] > 0  # noqa: E731
    return (_libsvm(tmp_path / "tr.libsvm", 900, 4, 9, rule),
            _libsvm(tmp_path / "ev.libsvm", 300, 4, 10, rule))


def _jax_trees(ckpt):
    from dmlc_core_tpu.bridge.checkpoint import load_checkpoint

    flat = load_checkpoint(ckpt)
    return {name: next(v for k, v in flat.items() if name in k)
            for name in ("split_feat", "split_bin", "leaf_value",
                         "default_left")}


def _assert_trees(ens, want, rtol=1e-5):
    np.testing.assert_array_equal(ens.split_feat.numpy(), want["split_feat"])
    np.testing.assert_array_equal(ens.default_left.numpy(),
                                  want["default_left"])
    split = want["split_feat"] >= 0
    np.testing.assert_array_equal(ens.split_bin.numpy()[split],
                                  want["split_bin"][split])
    np.testing.assert_allclose(ens.leaf_value.numpy(), want["leaf_value"],
                               rtol=rtol, atol=rtol)


@pytest.mark.parametrize("sampled", [False, True])
def test_train_gbdt_early_stopping_matches_jax_cli(tmp_path, monkeypatch,
                                                   capsys, sampled):
    tr, ev = _gbdt_files(tmp_path)
    args = ["--data", tr, "--eval-data", ev, "--num-feature", "4",
            "--rounds", "40", "--max-depth", "3", "--num-bins", "16",
            "--learning-rate", "0.9", "--early-stopping-rounds", "3"]
    if sampled:
        args += ["--subsample", "0.7", "--colsample-bynode", "0.6",
                 "--seed", "3"]
    ckpt = str(tmp_path / "jax.ckpt")
    _run_jax_example("train_gbdt", args + ["--checkpoint", ckpt],
                     monkeypatch)
    jax_out = capsys.readouterr().out
    want = _jax_trees(ckpt)
    ens, margin = train_gbdt.main(args + ["--device", "cpu", "--checkpoint",
                                          str(tmp_path / "port.ckpt")])
    out = capsys.readouterr().out
    assert 0 < ens.num_trees < 40
    _assert_trees(ens, want)
    line = [s for s in out.splitlines() if s.startswith("eval: ")]
    assert line == [s for s in jax_out.splitlines()
                    if s.startswith("eval: ")]
    assert f"({ens.num_trees} trees kept)" in line[0]
    # the ensemble saved with --checkpoint reads back as the JAX CLI's does
    _assert_trees(ens, _jax_trees(str(tmp_path / "port.ckpt")), rtol=0)


def test_train_gbdt_checkpoint_dir_resumes_across_packages(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    tr, _ = _gbdt_files(tmp_path)
    base = ["--data", tr, "--num-feature", "4", "--max-depth", "3",
            "--num-bins", "16", "--hist-method", "scatter",
            "--subsample", "0.8", "--colsample-bytree", "0.8",
            "--checkpoint-every", "2"]
    port_dir = str(tmp_path / "port_ckpts")
    train_gbdt.main(base + ["--rounds", "4", "--checkpoint-dir", port_dir,
                            "--device", "cpu"])
    assert os.path.exists(os.path.join(port_dir, "ckpt-00000002"))
    capsys.readouterr()
    # the port resumes its own step ...
    ens, _ = train_gbdt.main(base + ["--rounds", "6", "--checkpoint-dir",
                                     port_dir, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 2 (2/6 rounds done)" in out
    assert "trained 4 rounds" in out
    # ... and grows the trees of an uninterrupted fit, to the bit
    whole, _ = train_gbdt.main(base + ["--rounds", "6", "--device", "cpu"])
    assert all(torch.equal(a, b) for a, b in zip(ens, whole))
    # the JAX CLI resumes a step the port wrote
    cross = str(tmp_path / "cross")
    train_gbdt.main(base + ["--rounds", "4", "--checkpoint-dir", cross,
                            "--device", "cpu"])
    capsys.readouterr()
    ckpt = str(tmp_path / "jax.ckpt")
    _run_jax_example("train_gbdt", base + ["--rounds", "6", "--checkpoint-dir",
                                           cross, "--checkpoint", ckpt],
                     monkeypatch)
    assert "resuming from checkpoint step 2" in capsys.readouterr().out
    _assert_trees(whole, _jax_trees(ckpt))


def test_train_gbdt_refuses_checkpoint_dir_with_eval(tmp_path, capsys):
    tr, ev = _gbdt_files(tmp_path)
    with pytest.raises(SystemExit):
        train_gbdt.main(["--data", tr, "--num-feature", "4", "--device",
                         "cpu", "--eval-data", ev, "--checkpoint-dir",
                         str(tmp_path / "d")])
    assert "cannot be combined" in capsys.readouterr().err


# -- train_logreg / train_mlp -----------------------------------------------

def _linear_file(tmp_path, n=640, f=8, seed=0):
    rule = lambda x: x[:, 0] + x[:, 1] - 0.5 * x[:, 5] > 0  # noqa: E731
    return _libsvm(tmp_path / "lin.libsvm", n, f, seed, rule)


@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_train_logreg_matches_jax_example(tmp_path, monkeypatch, capsys,
                                          form):
    data = _linear_file(tmp_path)
    args = ["--data", data, "--num-feature", "8", "--batch-size", "64",
            "--epochs", "3", "--form", form]
    _run_jax_example("train_logreg", args, monkeypatch)
    want = _epoch_losses(capsys.readouterr().err)
    params, losses = train_logreg.main(args + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert len(want) == 3
    np.testing.assert_allclose(losses, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_epoch_losses(err), want, rtol=0, atol=1e-5)
    assert losses[-1] < losses[0]
    assert set(params) == {"w", "b"} and params["w"].shape == (8,)


def test_train_logreg_checkpoint_resumes_across_packages(tmp_path,
                                                        monkeypatch, capsys):
    data = _linear_file(tmp_path, seed=1)
    args = ["--data", data, "--num-feature", "8", "--batch-size", "64"]
    _, whole = train_logreg.main(args + ["--epochs", "3", "--device", "cpu"])
    tmpl = str(tmp_path / "ck-{version}.bin")
    _, first = train_logreg.main(args + ["--epochs", "1", "--checkpoint",
                                         tmpl, "--device", "cpu"])
    assert os.path.exists(tmpl.format(version=1))
    capsys.readouterr()
    _, rest = train_logreg.main(args + ["--epochs", "3", "--checkpoint",
                                        tmpl, "--device", "cpu"])
    assert "resuming from checkpoint version 1" in capsys.readouterr().err
    np.testing.assert_allclose(first + rest, whole, rtol=0, atol=1e-7)
    # the JAX example resumes the port's version 3 for a fourth epoch
    _, four = train_logreg.main(args + ["--epochs", "4", "--device", "cpu"])
    capsys.readouterr()
    _run_jax_example("train_logreg", args + ["--epochs", "4",
                                             "--checkpoint", tmpl],
                     monkeypatch)
    err = capsys.readouterr().err
    assert "resuming from checkpoint version 3" in err
    np.testing.assert_allclose(_epoch_losses(err), four[3:], rtol=0,
                               atol=1e-5)


def test_train_mlp_matches_jax_example(tmp_path, monkeypatch, capsys):
    data = _linear_file(tmp_path, seed=2)
    args = ["--data", data, "--num-feature", "8", "--hidden", "16,16",
            "--batch-size", "64", "--epochs", "3"]
    _run_jax_example("train_mlp", args, monkeypatch)
    want = _epoch_losses(capsys.readouterr().err)
    _, _, losses = train_mlp.main(args + ["--device", "cpu"])
    assert len(want) == len(losses) == 3
    np.testing.assert_allclose(losses, want, rtol=LOSS_MLP, atol=LOSS_MLP)
    assert losses[-1] < losses[0]


def test_train_mlp_resumes_jax_checkpoint_and_back(tmp_path, monkeypatch,
                                                   capsys):
    from dmlc_core_tpu.bridge.checkpoint import load_checkpoint as jax_load

    data = _linear_file(tmp_path, seed=3)
    args = ["--data", data, "--num-feature", "8", "--hidden", "16",
            "--batch-size", "64"]
    jdir = str(tmp_path / "jax_dir")
    _run_jax_example("train_mlp", args + ["--epochs", "2", "--checkpoint-dir",
                                          jdir], monkeypatch)
    capsys.readouterr()
    step1 = jax_load(os.path.join(jdir, "ckpt-00000001"))
    params, opt, losses = train_mlp.main(args + ["--epochs", "3",
                                                 "--checkpoint-dir", jdir,
                                                 "--device", "cpu"])
    assert "resuming from checkpoint epoch 1" in capsys.readouterr().err
    assert len(losses) == 2
    # the port wrote step 2 in the reference's layout: the same leaf paths
    step2 = jax_load(os.path.join(jdir, "ckpt-00000002"))
    assert sorted(step2) == sorted(step1)
    assert int(step2["[1][0].count"]) == 2 * int(step1["[1][0].count"])
    assert int(opt.count) == 3 * int(step1["[1][0].count"])
    # and the JAX example resumes it
    _run_jax_example("train_mlp", args + ["--epochs", "4", "--checkpoint-dir",
                                          jdir], monkeypatch)
    err = capsys.readouterr().err
    assert "resuming from checkpoint epoch 2" in err
    assert len(_epoch_losses(err)) == 2


def test_train_mlp_model_parallel_names_the_roadmap_item(tmp_path):
    # [9a] is ported: a model axis wider than the job exits with the
    # reference's message (tests/test_torch_mlp_tp.py runs it in 4 ranks)
    data = _linear_file(tmp_path, n=64)
    with pytest.raises(SystemExit, match="does not divide 1 ranks"):
        train_mlp.main(["--data", data, "--num-feature", "8",
                        "--model-parallel", "2", "--device", "cpu"])


@pytest.mark.parametrize("cli", [train_logreg, train_mlp])
def test_clis_need_a_card_unless_cpu_is_asked(tmp_path, cli):
    data = _linear_file(tmp_path, n=64)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--data", data, "--num-feature", "8"])


@pytest.mark.parametrize("cli", [train_logreg, train_mlp])
def test_clis_refuse_a_multi_worker_launch(tmp_path, monkeypatch, capsys,
                                           cli):
    """A launch of more than one worker is not refused: the
    CLI reads its own byte-range shard and steps under the data mesh
    (``tests/test_torch_multiworker.py`` runs it in 2 real workers).  A
    model axis must divide the job: ``--model-parallel 2`` in this
    one-process job exits."""
    from dmlc_core_tpu_torch.data import factory
    from dmlc_core_tpu_torch.parallel import mesh

    data = _linear_file(tmp_path, n=64)
    monkeypatch.setattr(mesh, "local_shard_info", lambda: (0, 2))
    shards = []
    plain = factory.create_parser

    def recording(uri, part, nparts, **kw):
        shards.append((part, nparts))
        return plain(uri, part, nparts, **kw)

    monkeypatch.setattr(factory, "create_parser", recording)
    argv = ["--data", data, "--num-feature", "8", "--device", "cpu",
            "--batch-size", "8", "--epochs", "1"]
    losses = cli.main(argv)[-1]
    assert shards == [(0, 2)] and len(losses) == 1
    assert "never per-shard models" not in capsys.readouterr().err
    if cli is train_mlp:
        with pytest.raises(SystemExit, match="does not divide"):
            cli.main(argv + ["--model-parallel", "2"])


# -- graft entry, loader, serving ---------------------------------------------

def test_graft_entry_matches_jax_entry():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as jax_entry
    finally:
        sys.path.remove(REPO)
    from dmlc_core_tpu_torch import graft_entry

    jfn, jargs = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    assert got.shape == (64,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    for a, b in zip(args[0], jargs[0]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            graft_entry.entry()


def _leaves(batch):
    return [(name, v) for name, v in zip(batch._fields, batch)
            if v is not None and not isinstance(v, int)]


@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("batch", [64, 100])
def test_mesh_batch_loader_matches_jax(tmp_path, form, batch):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dmlc_core_tpu.bridge.loader import MeshBatchLoader as JaxLoader
    from dmlc_core_tpu.data.factory import create_parser as jax_parser
    from dmlc_core_tpu.parallel.mesh import make_mesh as jax_mesh
    from dmlc_core_tpu_torch.bridge.loader import MeshBatchLoader
    from dmlc_core_tpu_torch.data.factory import create_parser
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh

    data = _linear_file(tmp_path, n=300)
    kw = dict(form=form, global_batch_size=batch, num_feature=8,
              nnz_bucket=None if form == "dense" else batch * 8)
    jl = JaxLoader(jax_parser(data, 0, 1, type="auto"),
                   jax_mesh(devices=jax.devices()[:1]), **kw)
    pl = MeshBatchLoader(create_parser(data, 0, 1, type="auto"), make_mesh(),
                         device="cpu", **kw)
    for epoch in range(2):
        if epoch:
            jl.before_first()
            pl.before_first()
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == 300 // batch
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__
            for (name, a), (_, b) in zip(_leaves(g), _leaves(w)):
                b = np.asarray(b)
                assert a.numpy().dtype == b.dtype, name
                np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert pl.bytes_read() == jl.bytes_read()
    jl.close()
    pl.close()


def test_softmax_served_probabilities_match_jax(tmp_path):
    from dmlc_core_tpu.bridge.checkpoint import CheckpointManager as JaxMgr
    from dmlc_core_tpu.models.gbdt import GBDT as JaxGBDT
    from dmlc_core_tpu.models.gbdt import GBDTParam as JaxParam
    from dmlc_core_tpu.serve import build_runtime as jax_build_runtime
    from dmlc_core_tpu_torch.serve import build_runtime

    rng = np.random.RandomState(4)
    x = rng.randn(1257, 6).astype(np.float32)
    y = (np.digitize(x[:, 0] + 0.5 * x[:, 1], [-0.5, 0.5])).astype(
        np.float32)
    jm = JaxGBDT(JaxParam(objective="softmax", num_class=3,
                          num_boost_round=4, max_depth=4, num_bins=32),
                 num_feature=6)
    jm.make_bins(x[:1000])
    ens, _ = jm.fit_binned(jm.bin_features(x[:1000]), y[:1000])
    mgr = JaxMgr(str(tmp_path / "soft"))
    mgr.save(1, jm.serving_state(ens), async_=False)
    port = build_runtime("gbdt", 6, checkpoint=mgr.step_uri(1),
                         device="cpu")
    ref = jax_build_runtime("gbdt", 6, checkpoint=mgr.step_uri(1))
    held = x[1000:]
    got = np.asarray(port.predict(held))
    want = np.asarray(ref.predict(held))
    assert got.shape == want.shape == (257, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)
    # the margins under the softmax are bitwise the reference's
    jg, je = ref.gbdt, ref.ensemble
    want_margin = np.asarray(jg.predict_margin(je, jg.bin_features(held)))
    got_margin = port.gbdt.predict_margin(
        port.ensemble, port.binner.transform(held)).numpy()
    np.testing.assert_array_equal(got_margin.view(np.uint32),
                                  want_margin.view(np.uint32))
