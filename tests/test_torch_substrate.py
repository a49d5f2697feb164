"""PyTorch port vs the JAX package: the L0-L2 substrate.

The port's ``config``, ``json_io``, ``serializer``, ``utils/common``,
``utils/concurrency`` and ``interop`` are held to the JAX package's on the
same inputs (made from a seed with numpy where they are data):

- ``Config``: items, ``to_proto_string`` and ``multi_value`` equal, the
  same refusals (the cases of ``tests/test_config.py``);
- JSON: the writer's text byte-equal in ``multi_line`` on and off, read-back
  values equal, the same errors with the same line numbers, registered
  ``any`` types in each package's own registry (``tests/test_json_io.py``);
- serializer: blobs byte-equal for every spec kind, a JAX blob loads in
  the port and a port blob loads in JAX, both comparing equal
  (``tests/test_serializer.py``);
- concurrency: kill, priority order, blocking and the buffer pool;
- interop: a ``jax.Array`` and a numpy array go through the port's
  ``to_torch`` equal to JAX ``to_torch``'s; the numpy case shares memory.

Exact equality throughout: these modules move bytes, not floats.
"""

import io
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu import config as j_config
from dmlc_core_tpu import interop as j_interop
from dmlc_core_tpu import json_io as j_json
from dmlc_core_tpu import serializer as j_ser
from dmlc_core_tpu.io.memory_io import MemoryStringStream as JStream
from dmlc_core_tpu.utils import common as j_common
from dmlc_core_tpu.utils import concurrency as j_conc
from dmlc_core_tpu.utils.logging import Error as JError
from dmlc_core_tpu_torch import config as p_config
from dmlc_core_tpu_torch import interop as p_interop
from dmlc_core_tpu_torch import json_io as p_json
from dmlc_core_tpu_torch import serializer as p_ser
from dmlc_core_tpu_torch.io.memory_io import MemoryStringStream as PStream
from dmlc_core_tpu_torch.utils import common as p_common
from dmlc_core_tpu_torch.utils import concurrency as p_conc
from dmlc_core_tpu_torch.utils.logging import Error as PError

# -- config -------------------------------------------------------------------

CONFIG_TEXTS = {
    "basics": ('k1 = 1243\nk2=  okay\n k3 = "a ok" # comment\n'
               '# full comment\nk4 = 1e-4'),
    "escapes": 'msg = "line1\\nline2\\ttabbed \\"quoted\\""',
    "repeated": "k = 1\nk = 2\n",
    "proto": 'x = 10\nname = "hi there"',
    "crlf_tabs": 'a\t=\t1\r\nb = "x # not a comment"\r\n',
    "empty": "",
}


def _config_view(mod, text, multi_value):
    cfg = mod.Config(text, multi_value=multi_value)
    return list(cfg.items()), cfg.to_proto_string(), \
        {k: cfg.get_param(k) for k, _ in cfg.items()}


@pytest.mark.parametrize("multi_value", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIG_TEXTS))
def test_config_matches_jax(name, multi_value):
    text = CONFIG_TEXTS[name]
    assert _config_view(p_config, text, multi_value) == \
        _config_view(j_config, text, multi_value)


def test_config_set_param_and_stream_input():
    out = []
    for mod in (j_config, p_config):
        cfg = mod.Config(io.StringIO("k = v\n"))
        cfg.set_param("b", 2)
        cfg.set_param("a", "x y", is_string=True)
        cfg.set_param("b", 3)
        out.append((list(cfg.items()), cfg.to_proto_string(), "k" in cfg))
    assert out[0] == out[1]


@pytest.mark.parametrize("text", ['k = "unterminated', "k =", "= v"])
def test_config_errors_match_jax(text):
    with pytest.raises(JError) as jerr:
        j_config.Config(text)
    with pytest.raises(PError) as perr:
        p_config.Config(text)
    assert str(perr.value).split("\n")[0].split("] ", 1)[1] == \
        str(jerr.value).split("\n")[0].split("] ", 1)[1]


# -- JSON ---------------------------------------------------------------------

class _JPoint:
    def __init__(self, x=0, y=0):
        self.x, self.y = x, y

    def __eq__(self, other):
        return (self.x, self.y) == (other.x, other.y)

    def json_save(self, writer):
        writer.begin_object(multi_line=False)
        writer.write_object_keyvalue("x", self.x)
        writer.write_object_keyvalue("y", self.y)
        writer.end_object()


class _PPoint(_JPoint):
    """The same class registered in the port's registry (each package keeps
    its own any-type registry)."""


def _rng_floats(n, seed):
    rng = np.random.RandomState(seed)
    return [float(v) for v in rng.randn(n).astype(np.float64)]


JSON_CASES = {
    "stl_tree": ({"a": [(1, 2.5), (3, 4.0)], "b": []}, {str: [(int, float)]}),
    "plain_tree": ({"x": [1, 2, {"y": None, "z": True}],
                    "s": 'quote " and \n line'}, None),
    "int_keys": ({1: "one", 2: "two"}, {int: str}),
    "floats": (_rng_floats(16, 0), [float]),
    "nonfinite": ([math.inf, -math.inf, 1.5, -0.0], [float]),
    "escapes": ('tab\t newline\n backslash\\ quote" unicode:é '
                "bell\x07 null\x00", str),
    "nested_empty": ({"a": {}, "b": [[], [[]]], "c": ""}, None),
    "ints": ([int(v) for v in np.random.RandomState(1).randint(
        -2 ** 40, 2 ** 40, 12)], [int]),
}


@pytest.mark.parametrize("multi_line", [True, False])
@pytest.mark.parametrize("name", sorted(JSON_CASES))
def test_json_text_byte_equal_and_reads_back(name, multi_line):
    value, spec = JSON_CASES[name]
    text = p_json.dumps(value, spec, multi_line=multi_line)
    assert text == j_json.dumps(value, spec, multi_line=multi_line)
    want = j_json.loads(text, spec)
    got = p_json.loads(text, spec)
    assert repr(got) == repr(want)


def test_json_nan_and_surrogates_read_alike():
    import json as stdlib_json
    for text, spec in (("[NaN, 1.0]", [float]),
                       (stdlib_json.dumps("emoji \U0001F600 é"), str),
                       ('"\\u00e9"', str)):
        want, got = j_json.loads(text, spec), p_json.loads(text, spec)
        assert repr(got) == repr(want)


def test_json_event_reader_and_writer_structure():
    src = '{"count": 3, "names": ["a", "b"], "nested": {"k": [1, 2]}}'
    out = []
    for mod in (j_json, p_json):
        reader = mod.JSONReader(src)
        reader.begin_object()
        seen = {}
        while (key := reader.next_object_item()) is not None:
            seen[key] = reader.read({"count": int, "names": [str],
                                     "nested": {str: [int]}}[key])
        writer = mod.JSONWriter(multi_line=False)
        writer.begin_object()
        for k, v in seen.items():
            writer.write_object_keyvalue(k, v)
        writer.end_object()
        out.append((seen, writer.getvalue()))
    assert out[0] == out[1]


@pytest.mark.parametrize("text,spec", [
    ('{\n  "a": 1,\n  "b": oops\n}', {str: int}),
    ('{\n  "a": "nope"\n}', {str: int}),
    ('[["mystery", 1]]', ["any"]),
    ('[1, 2', [int]),
])
def test_json_errors_match_jax(text, spec):
    with pytest.raises(j_json.JSONError) as jerr:
        j_json.loads(text, spec)
    with pytest.raises(p_json.JSONError) as perr:
        p_json.loads(text, spec)
    assert str(perr.value) == str(jerr.value)


def test_json_object_read_helper_matches_jax():
    def helper(mod):
        h = mod.JSONObjectReadHelper()
        h.declare_field("name", str)
        h.declare_field("value", int)
        h.declare_field_optional("scale", float, default=1.0)
        return h

    assert helper(p_json).read_all_fields(
        p_json.JSONReader('{"name": "n", "value": 7}')) == \
        helper(j_json).read_all_fields(
            j_json.JSONReader('{"name": "n", "value": 7}'))
    for bad in ('{"name": "n", "value": 1, "bad": 0}', '{"name": "n"}',
                '{"name": "a", "name": "b", "value": 1}'):
        with pytest.raises(j_json.JSONError) as jerr:
            helper(j_json).read_all_fields(j_json.JSONReader(bad))
        with pytest.raises(p_json.JSONError) as perr:
            helper(p_json).read_all_fields(p_json.JSONReader(bad))
        assert str(perr.value) == str(jerr.value)


def test_json_any_types_byte_equal_in_separate_registries(monkeypatch):
    # empty registries for this test alone: test_json_io registers its own
    # "point" class in the JAX package's, and a worker may run both files
    for mod in (j_json, p_json):
        monkeypatch.setattr(mod, "_ANY_BY_NAME", {})
        monkeypatch.setattr(mod, "_ANY_BY_TYPE", {})
    j_json.register_any_type("point", _JPoint,
                             to_json=lambda p: {"x": p.x, "y": p.y},
                             from_json=lambda d: _JPoint(d["x"], d["y"]))
    j_json.register_any_type("intval", int)
    p_json.register_any_type("point", _PPoint,
                             to_json=lambda p: {"x": p.x, "y": p.y},
                             from_json=lambda d: _PPoint(d["x"], d["y"]))
    p_json.register_any_type("intval", int)
    # the registries are separate: each knows only its own point class
    assert _PPoint not in j_json._ANY_BY_TYPE
    assert _JPoint not in p_json._ANY_BY_TYPE
    j_vals = [_JPoint(5, 6), 42, _JPoint(0, 0)]
    p_vals = [_PPoint(5, 6), 42, _PPoint(0, 0)]
    for ml in (True, False):
        text = p_json.dumps(p_vals, ["any"], multi_line=ml)
        assert text == j_json.dumps(j_vals, ["any"], multi_line=ml)
        assert p_json.loads(text, ["any"]) == p_vals
        assert j_json.loads(text, ["any"]) == j_vals
    pairs = [(42, "x"), (7, "y")]
    text = p_json.dumps(pairs, [("any", str)])
    assert text == j_json.dumps(pairs, [("any", str)])
    assert p_json.loads(text, [("any", str)]) == pairs
    with pytest.raises(TypeError, match="not registered"):
        p_json.dumps([3.25j], ["any"])


# -- serializer ---------------------------------------------------------------

class _JObj:
    def __init__(self, data=0, name=""):
        self.data, self.name = data, name

    def save(self, stream):
        j_ser.save(stream, self.data, j_ser.POD(np.int32))
        j_ser.save(stream, self.name, j_ser.Str)

    def load(self, stream):
        self.data = j_ser.load(stream, j_ser.POD(np.int32))
        self.name = j_ser.load(stream, j_ser.Str)


class _PObj(_JObj):
    def save(self, stream):
        p_ser.save(stream, self.data, p_ser.POD(np.int32))
        p_ser.save(stream, self.name, p_ser.Str)

    def load(self, stream):
        self.data = p_ser.load(stream, p_ser.POD(np.int32))
        self.name = p_ser.load(stream, p_ser.Str)


def _spec(mod, kind):
    """The same spec built from either package's vocabulary."""
    obj = {j_ser: _JObj, p_ser: _PObj}[mod]
    return {
        "pod_i32": mod.POD(np.int32),
        "pod_i64": mod.POD(np.int64),
        "pod_f32": mod.POD(np.float32),
        "pod_big_endian": mod.POD(np.dtype(">i4")),
        "str": mod.Str,
        "vec_f32": mod.Vector(mod.POD(np.float32)),
        "vec_u16_be": mod.Vector(mod.POD(">u2")),
        "vec_str": mod.Vector(mod.Str),
        "nested": mod.Map(mod.Str, mod.Vector(mod.Pair(mod.POD(np.int32),
                                                      mod.Str))),
        "checkpoint": mod.Pair(mod.Map(mod.Str, mod.Vector(mod.POD(np.float32))),
                               mod.Vector(mod.Pair(mod.Str, mod.POD(np.int64)))),
        "objs": mod.Vector(mod.Obj(obj)),
    }[kind]


def _value(kind, for_port):
    rng = np.random.RandomState(sorted(SER_KINDS).index(kind))
    obj = _PObj if for_port else _JObj
    return {
        "pod_i32": int(rng.randint(-2 ** 31, 2 ** 31)),
        "pod_i64": int(rng.randint(-2 ** 62, 2 ** 62, dtype=np.int64)),
        "pod_f32": float(rng.randn()),
        "pod_big_endian": 0x01020304,
        "str": "hello wörld",
        "vec_f32": rng.randn(1000).astype(np.float32),
        "vec_u16_be": rng.randint(0, 2 ** 16, 9).astype(">u2"),
        "vec_str": ["a", "bb", "", "é"],
        "nested": {"a": [(1, "x"), (2, "y")], "b": [], "c": [(7, "z")]},
        "checkpoint": ({"bias": rng.randn(1).astype(np.float32),
                        "weights": rng.randn(28).astype(np.float32)},
                       [("rounds", 10), ("depth", 6)]),
        "objs": [obj(1, "one"), obj(2, "two")],
    }[kind]


SER_KINDS = ["pod_i32", "pod_i64", "pod_f32", "pod_big_endian", "str",
             "vec_f32", "vec_u16_be", "vec_str", "nested", "checkpoint",
             "objs"]


def _norm(v):
    """A comparable form of a loaded value."""
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.newbyteorder("<").str, v.astype(
            v.dtype.newbyteorder("<")).tobytes())
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v).__name__, [_norm(x) for x in v]
    if isinstance(v, _JObj):
        return ("obj", v.data, v.name)
    return v


@pytest.mark.parametrize("kind", SER_KINDS)
def test_serializer_blobs_byte_equal_and_cross_load(kind):
    js, ps = JStream(), PStream()
    j_ser.save(js, _value(kind, False), _spec(j_ser, kind))
    p_ser.save(ps, _value(kind, True), _spec(p_ser, kind))
    assert bytes(ps.data) == bytes(js.data)
    # a JAX blob loads in the port and a port blob in JAX
    from_jax = PStream()
    from_jax.write(bytes(js.data))
    from_jax.seek(0)
    from_port = JStream()
    from_port.write(bytes(ps.data))
    from_port.seek(0)
    js.seek(0)
    want = _norm(j_ser.load(js, _spec(j_ser, kind)))
    assert _norm(p_ser.load(from_jax, _spec(p_ser, kind))) == want
    assert _norm(j_ser.load(from_port, _spec(j_ser, kind))) == want


def test_serializer_inferred_spec_and_refusals():
    js, ps = JStream(), PStream()
    arr = np.arange(5, dtype=np.int64)
    j_ser.save(js, arr)
    p_ser.save(ps, arr)
    assert bytes(ps.data) == bytes(js.data) == \
        (5).to_bytes(8, "little") + arr.tobytes()
    with pytest.raises(TypeError, match="spec"):
        p_ser.save(PStream(), object())
    short = PStream()
    short.write((100).to_bytes(8, "little"))
    short.seek(0)
    with pytest.raises(PError, match="short read"):
        p_ser.load(short, p_ser.Vector(p_ser.POD(np.float64)))


# -- utils/common and utils/concurrency ---------------------------------------

def test_common_helpers_match_jax():
    rng = np.random.RandomState(0)
    for s in ("a;;b;c", ";", "", "x", ";a;b;;"):
        assert p_common.split_string(s, ";") == j_common.split_string(s, ";")
    for seed, value in rng.randint(0, 2 ** 62, (16, 2), dtype=np.int64):
        assert p_common.hash_combine(int(seed), int(value)) == \
            j_common.hash_combine(int(seed), int(value))


def _queue_trace(mod, priority):
    q = mod.ConcurrentBlockingQueue(priority=priority)
    rng = np.random.RandomState(3)
    for i, pri in enumerate(rng.randint(0, 5, 40)):
        q.push(i, priority=int(pri))
    out = [q.pop() for _ in range(20)]
    q.signal_for_kill()
    out += [q.pop() for _ in range(21)]   # drains, then None once empty
    q.push("after kill")                  # dropped, as the reference drops
    return out, q.size()


@pytest.mark.parametrize("priority", [False, True])
def test_blocking_queue_order_and_kill_match_jax(priority):
    assert _queue_trace(p_conc, priority) == _queue_trace(j_conc, priority)


def test_blocking_queue_blocks_until_popped_and_kill_wakes():
    q = p_conc.ConcurrentBlockingQueue(max_size=1)
    q.push(1)
    pushed = threading.Event()

    def producer():
        q.push(2)                          # blocks until a pop frees room
        pushed.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    assert not pushed.wait(0.2)
    assert q.pop() == 1
    assert pushed.wait(30)
    t.join(30)
    assert q.pop() == 2
    got = []
    waiter = threading.Thread(target=lambda: got.append(q.pop()),
                              daemon=True)
    waiter.start()
    q.signal_for_kill()                    # wakes the blocked pop with None
    waiter.join(30)
    assert got == [None]


def test_thread_local_store_and_buffer_pool():
    def factory():
        return {"id": threading.get_ident()}

    mine = p_conc.ThreadLocalStore.get(factory)
    assert p_conc.ThreadLocalStore.get(factory) is mine
    other = []
    t = threading.Thread(
        target=lambda: other.append(p_conc.ThreadLocalStore.get(factory)))
    t.start()
    t.join(30)
    assert other[0] is not mine
    pools = [mod.BufferPool(64, max_cached=2) for mod in (j_conc, p_conc)]
    traces = []
    for pool in pools:
        bufs = [pool.alloc() for _ in range(3)]
        for b in bufs:
            pool.free(b)
        pool.free(bytearray(8))            # wrong size: never cached
        again = [pool.alloc() for _ in range(3)]
        traces.append([len(b) for b in again] +
                      [any(a is b for b in bufs) for a in again])
    assert traces[0] == traces[1]


# -- interop ------------------------------------------------------------------

def test_to_torch_of_a_jax_array_matches_jax():
    x = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    arr = jnp.asarray(x)
    got = p_interop.to_torch(arr)
    want = j_interop.to_torch(arr)
    assert isinstance(got, torch.Tensor)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_to_torch_of_numpy_shares_memory():
    x = np.random.RandomState(5).randn(4, 6).astype(np.float32)
    got = p_interop.to_torch(x)
    assert torch.equal(got, j_interop.to_torch(x))
    assert got.data_ptr() == x.__array_interface__["data"][0]
    x[0, 0] = 123.0
    assert got[0, 0].item() == 123.0


def test_from_torch_to_numpy_and_from_numpy():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    back = p_interop.from_torch(t)
    assert not back.requires_grad and back.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(p_interop.to_numpy(t),
                                  j_interop.to_numpy(t.detach()))
    a = np.arange(4, dtype=np.int64)
    on_cpu = p_interop.from_numpy(a, device="cpu")
    assert on_cpu.device.type == "cpu" and on_cpu.tolist() == [0, 1, 2, 3]
    np.testing.assert_array_equal(p_interop.to_numpy(on_cpu),
                                  np.asarray(j_interop.from_numpy(a)))
    if torch.cuda.is_available():
        assert p_interop.from_numpy(a).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            p_interop.from_numpy(a)
