"""PyTorch port: the device feed, the throughput meter and the
``train_gbdt`` entry point, against the JAX package where it has one.

On the CPU (``device="cpu"``) the feed's sequence is byte-identical to
synchronous placement and to the JAX package's ``DeviceFeedLoader``.  The
pinned-buffer ring runs only on a card: those tests carry the ``cuda``
marker and hold the fed sequence bitwise to synchronous ``.to()`` copies
at ``prefetch`` 1, 2 and 4.  The CLI with ``--device cpu`` grows the trees
the JAX CLI grows on the same file, to the tolerances of
``tests/test_torch_gbdt.py`` (rtol 1e-5 on the scatter path).

The JAX package is imported inside the tests that compare with it, so the
``cuda`` tests run on a card machine without JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_device_feed.py``.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.bridge.batching import DenseBatch
from dmlc_core_tpu_torch.bridge.binning import BinnedBatch
from dmlc_core_tpu_torch.bridge.loader import DeviceFeedLoader, batch_nbytes
from dmlc_core_tpu_torch.examples import train_gbdt
from dmlc_core_tpu_torch.utils.profiler import ThroughputMeter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host_batches(n=7, rows=64, f=5, seed=0, partial=True):
    """A stream of binned batches, the last one padded, as numpy and as
    the port's CPU tensors."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        real = rows // 2 if partial and i == n - 1 else rows
        bins = rng.randint(0, 256, (rows, f)).astype(np.uint8)
        label = (rng.rand(rows) > 0.5).astype(np.float32)
        weight = np.zeros(rows, np.float32)
        weight[:real] = 1.0
        out.append((bins, label, weight, real))
    return out


def _port(batches):
    return [BinnedBatch(*map(torch.from_numpy, b[:3]), num_rows=b[3])
            for b in batches]


def _sequence(loader):
    return [(b.num_rows, [t.cpu().numpy().tobytes() for t in b[:3]])
            for b in loader]


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_cpu_feed_matches_synchronous_placement(prefetch):
    batches = _port(_host_batches())
    want = [(b.num_rows, [t.to("cpu").numpy().tobytes() for t in b[:3]])
            for b in batches]
    loader = DeviceFeedLoader(lambda: iter(batches), device="cpu",
                              prefetch=prefetch)
    assert _sequence(loader) == want
    loader.before_first()
    assert _sequence(loader) == want           # a restarted epoch too


def test_cpu_feed_matches_jax_feed():
    from dmlc_core_tpu.bridge.loader import DeviceFeedLoader as JaxFeedLoader

    host = _host_batches(seed=1)
    jax_loader = JaxFeedLoader(lambda: iter(
        [tuple(b[:3]) for b in host]), prefetch=2)
    want = [[np.asarray(a).tobytes() for a in b] for b in jax_loader]
    got = [[t.numpy().tobytes() for t in b]
           for b in DeviceFeedLoader(lambda: iter([tuple(b[:3])
                                                   for b in host]),
                                     device="cpu", prefetch=2)]
    assert got == want


class _Restartable:
    """A source object: ``before_first`` + iteration."""

    def __init__(self, batches):
        self.batches, self.starts = batches, 0

    def before_first(self):
        self.starts += 1

    def __iter__(self):
        return iter(self.batches)


def test_object_source_restarts_and_leaves_pass_through():
    batches = [DenseBatch(torch.arange(6.0).view(3, 2), torch.zeros(3),
                          torch.ones(3), num_rows=3),
               {"x": np.arange(4, dtype=np.int32), "note": None}]
    src = _Restartable(batches)
    loader = DeviceFeedLoader(src, device="cpu")
    first = list(loader)
    assert src.starts == 1
    assert isinstance(first[0], DenseBatch) and first[0].num_rows == 3
    assert torch.equal(first[0].x, batches[0].x)
    assert first[1]["note"] is None
    assert torch.equal(first[1]["x"], torch.arange(4, dtype=torch.int32))
    loader.before_first()
    assert src.starts == 2
    assert batch_nbytes(batches[0]) == 6 * 4 + 3 * 4 + 3 * 4


def test_feed_accounts_transfers_when_telemetry_is_on():
    batches = _port(_host_batches(n=3))
    was = telemetry.enabled()
    telemetry.enable()
    telemetry.reset()
    try:
        list(DeviceFeedLoader(lambda: iter(batches), device="cpu"))
        reg = telemetry.get_registry()
        nbytes = reg.counter("dmlc_transfer_bytes_total",
                             path="device_feed").value
        spans = [e for e in telemetry.get_tracer().events()
                 if e["name"] == "loader.transfer"]
    finally:
        telemetry.reset()
        if not was:
            telemetry.disable()
    assert nbytes == sum(batch_nbytes(b) for b in batches)
    assert len(spans) == 3


def test_feed_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        assert DeviceFeedLoader([])._device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFeedLoader([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFeedLoader([], device="cuda")
    with pytest.raises(Exception, match="prefetch"):
        DeviceFeedLoader([], device="cpu", prefetch=0)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_pinned_ring_matches_synchronous_copies(prefetch):
    """On the card: the pinned ring's sequence is bitwise equal to
    synchronous pageable ``.to()`` copies, with the consumer writing into
    what it gets (a reused pinned buffer overwritten mid-copy, or a device
    block handed out twice, would show here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    batches = _port(_host_batches(n=25, rows=1 << 16, f=28, seed=prefetch))
    want = [[t.to("cuda") for t in b[:3]] for b in batches]
    loader = DeviceFeedLoader(lambda: iter(batches), prefetch=prefetch)
    for epoch in range(2):
        got = []
        for b in loader:
            got.append([t.clone() for t in b[:3]])
            # consumer work on the fed tensors, then churn the allocator
            b.bins.add_(1)
            torch.empty(1 << 20, device="cuda").fill_(7)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(torch.equal(a, c) for a, c in zip(g, w))
        loader.before_first()


def test_throughput_meter_matches_jax():
    from dmlc_core_tpu.utils.profiler import ThroughputMeter as JaxMeter

    port, ref = ThroughputMeter("ingest"), JaxMeter("ingest")
    for nbytes, rows in ((1000, 10), (5 << 20, 300), (7 << 20, 0)):
        port.add(nbytes, rows)
        ref.add(nbytes, rows)
    assert port.mb == ref.mb
    assert port._rows == ref._rows
    assert port.summary().split(" in ")[0] == ref.summary().split(" in ")[0]


# -- the CLI ----------------------------------------------------------------

def _libsvm(tmp_path, n=1500, f=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    y = (x[:, 0] * x[:, 1] + 0.3 * x[:, 2] > 0).astype(np.float32)
    path = tmp_path / "train.libsvm"
    path.write_text("".join(
        f"{int(y[i])} " + " ".join(f"{j}:{v:.9g}" for j, v in enumerate(r))
        + "\n" for i, r in enumerate(x)))
    return str(path)


def _jax_cli(args, monkeypatch, ckpt):
    from dmlc_core_tpu.bridge.checkpoint import load_checkpoint

    monkeypatch.setattr(sys, "argv", ["train_gbdt.py"] + args
                        + ["--checkpoint", ckpt])
    runpy.run_path(os.path.join(REPO, "examples", "train_gbdt.py"),
                   run_name="__main__")
    flat = load_checkpoint(ckpt)
    return {name: next(v for k, v in flat.items() if name in k)
            for name in ("split_feat", "split_bin", "leaf_value",
                         "default_left")}


@pytest.mark.parametrize("extra", [[], ["--handle-missing"],
                                   ["--objective", "squared"]],
                         ids=["logistic", "missing", "squared"])
def test_cli_trees_match_jax_cli(tmp_path, monkeypatch, capsys, extra):
    data = _libsvm(tmp_path)
    args = ["--data", data, "--num-feature", "4", "--rounds", "4",
            "--max-depth", "3", "--num-bins", "16"] + extra
    want = _jax_cli(args, monkeypatch, str(tmp_path / "jax.ckpt"))
    jax_out = capsys.readouterr().out
    ens, margin = train_gbdt.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    np.testing.assert_array_equal(ens.split_feat.numpy(), want["split_feat"])
    np.testing.assert_array_equal(ens.default_left.numpy(),
                                  want["default_left"])
    split = want["split_feat"] >= 0
    np.testing.assert_array_equal(ens.split_bin.numpy()[split],
                                  want["split_bin"][split])
    np.testing.assert_allclose(ens.leaf_value.numpy(), want["leaf_value"],
                               rtol=1e-5, atol=1e-5)
    assert margin.shape == (1500,) and torch.isfinite(margin).all()
    # the same two report lines, up to their times and rates
    for prefix in ("ingest: ", "trained 4 rounds on 1500 rows in "):
        assert any(line.startswith(prefix) for line in out.splitlines())
        assert any(line.startswith(prefix) for line in jax_out.splitlines())
    acc = lambda text: [line.rsplit(" ", 1)[1] for line in text.splitlines()
                        if "train acc" in line]
    assert acc(out) == acc(jax_out)


def test_cli_needs_a_card_unless_cpu_is_asked(tmp_path):
    data = _libsvm(tmp_path, n=50)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gbdt.main(["--data", data, "--num-feature", "4"])


@pytest.mark.parametrize("flag", [["--eval-data", "x"],
                                  ["--early-stopping-rounds", "3"],
                                  ["--checkpoint", "x"],
                                  ["--checkpoint-dir", "x"]])
def test_cli_refuses_unported_flows(tmp_path, capsys, flag):
    """Named when these flags were refused; now each flow runs: ``x``
    stands for the data file (``--eval-data``) or a path under
    ``tmp_path``."""
    data = _libsvm(tmp_path, n=200)
    value = flag[1]
    if value == "x":
        value = data if flag[0] == "--eval-data" else str(tmp_path / "x")
    ens, margin = train_gbdt.main(["--data", data, "--num-feature", "4",
                                   "--rounds", "3", "--max-depth", "2",
                                   "--checkpoint-every", "1",
                                   "--device", "cpu", flag[0], value])
    out = capsys.readouterr().out
    assert "trained " in out and torch.isfinite(margin).all()
    assert "ROADMAP" not in out
    if flag[0] == "--eval-data":
        assert "eval: first" in out
    elif flag[0] == "--checkpoint":
        assert os.path.isfile(value)
    elif flag[0] == "--checkpoint-dir":
        assert {"ckpt-00000001", "ckpt-00000002"} <= set(os.listdir(value))


def test_cli_refuses_a_multi_worker_launch(tmp_path, monkeypatch, capsys):
    """A launch of more than one worker trains one global
    model (``tests/test_torch_multiworker.py`` runs it in 2 real workers);
    what it still refuses, with the reference's message, are the
    single-host flows ``--eval-data`` and ``--checkpoint-dir``."""
    from dmlc_core_tpu_torch.parallel import mesh

    data = _libsvm(tmp_path, n=50)
    monkeypatch.setattr(mesh, "local_shard_info", lambda: (0, 2))
    argv = ["--data", data, "--num-feature", "4", "--device", "cpu",
            "--rounds", "2", "--max-depth", "2"]
    for flag, value in (("--eval-data", data),
                        ("--checkpoint-dir", str(tmp_path / "ckpt"))):
        with pytest.raises(SystemExit):
            train_gbdt.main(argv + [flag, value])
        assert "are single-host flows" in capsys.readouterr().err
    train_gbdt.main(argv)
    assert "over 2 workers" in capsys.readouterr().out
