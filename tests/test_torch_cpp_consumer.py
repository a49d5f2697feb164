"""The C++ consumer against the port's native library.

``tests/test_cpp_consumer.py`` compiles ``examples/cpp/consumer_demo.cc``
against ``include/dmlc_tpu/`` and the JAX package's native library.  Here
the same demo, unchanged, is compiled against the port's
``build/native/libdmlc_torch_native.so`` (linked by its path; the library
exports the same C ABI), and its output passes the same four checks: shard
reads cover the file exactly once, a blob the port's serializer writes
loads in C++, a blob C++ writes loads in the port's serializer, and
garbage fails cleanly.  The port builds its own library, so only a missing
``g++`` skips.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "examples", "cpp", "consumer_demo.cc")


def build_demo(out_path):
    """Compile the demo against the port's library (built on first use);
    returns the compiler's command line."""
    from dmlc_core_tpu_torch import native_bridge

    native_bridge.load_library()
    lib = native_bridge.library_path()
    cmd = ["g++", "-std=c++17", "-Wall", "-Wextra", "-Werror",
           "-I", os.path.join(REPO, "include"), DEMO, lib,
           f"-Wl,-rpath,{os.path.dirname(lib)}", "-o", str(out_path)]
    subprocess.run(cmd, check=True, capture_output=True, text=True,
                   timeout=300)
    return cmd


@pytest.fixture(scope="module")
def demo_bin(tmp_path_factory):
    out = tmp_path_factory.mktemp("cppdemo") / "consumer_demo"
    build_demo(out)
    return str(out)


def _write_libsvm(path, n_rows):
    nnz = 0
    label_sum = 0
    with open(path, "w") as f:
        for i in range(n_rows):
            y = i % 2
            feats = [(j, (i + j) % 10 / 10.0) for j in range(i % 4 + 1)]
            f.write(f"{y} " + " ".join(f"{j}:{v}" for j, v in feats) + "\n")
            nnz += len(feats)
            label_sum += y
    return nnz, label_sum


def _blob_spec(ser):
    return ser.Pair(ser.Map(ser.Str, ser.Vector(ser.POD(np.float32))),
                    ser.Vector(ser.Pair(ser.Str, ser.POD(np.int64))))


def test_demo_links_the_port_library(demo_bin):
    proc = subprocess.run(["ldd", demo_bin], capture_output=True, text=True,
                          timeout=60)
    if proc.returncode == 0:
        assert "libdmlc_torch_native.so" in proc.stdout
        assert "libdmlc_tpu_native" not in proc.stdout


@pytest.mark.parametrize("nparts", [1, 3])
def test_demo_end_to_end(demo_bin, tmp_path, nparts):
    data = tmp_path / "train.libsvm"
    nnz, label_sum = _write_libsvm(data, 500)
    proc = subprocess.run([demo_bin, str(data), str(nparts)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert f"rows=500 nnz={nnz} label_sum={float(label_sum):.1f}" \
        in proc.stdout
    assert "nthread : int, default=2" in proc.stdout
    assert "range check ok" in proc.stdout


def test_serializer_interop_port_to_cpp(demo_bin, tmp_path):
    from dmlc_core_tpu_torch import serializer as ser
    from dmlc_core_tpu_torch.io.stream import create_stream

    blob = ({"bias": np.array([0.125], np.float32),
             "weights": np.array([1.5, -2.25, 0.0], np.float32)},
            [("rounds", 10), ("depth", 6)])
    path = tmp_path / "py.bin"
    with create_stream(str(path), "w") as s:
        ser.save(s, blob, _blob_spec(ser))
    proc = subprocess.run([demo_bin, "--deserialize", str(path)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "maps=2 wsum=-0.6250 rounds=10 depth=6" in proc.stdout
    assert "roundtrip ok" in proc.stdout


def test_serializer_interop_cpp_to_port(demo_bin, tmp_path):
    from dmlc_core_tpu_torch import serializer as ser
    from dmlc_core_tpu_torch.io.stream import create_stream_for_read

    path = tmp_path / "cpp.bin"
    proc = subprocess.run([demo_bin, "--serialize", str(path)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    with create_stream_for_read(str(path)) as s:
        maps, meta = ser.load(s, _blob_spec(ser))
    assert set(maps) == {"weights", "bias"}
    assert list(maps["weights"]) == [1.5, -2.25, 0.0]
    assert list(maps["bias"]) == [0.125]
    assert meta == [("rounds", 10), ("depth", 6)]


def test_deserialize_garbage_fails_cleanly(demo_bin, tmp_path):
    bad = tmp_path / "garbage.bin"
    bad.write_bytes(b"\xff" * 64)
    proc = subprocess.run([demo_bin, "--deserialize", str(bad)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 1
    assert "deserialize failed" in proc.stderr
    proc = subprocess.run([demo_bin, "--serialise", str(bad)],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
