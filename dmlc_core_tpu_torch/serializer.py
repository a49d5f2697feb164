"""Schema-directed typed binary serialization onto streams.

Counterpart of ``dmlc_core_tpu/serializer.py`` (a copy; it imports no
torch).

Capability parity with the reference's compile-time serializer
(include/dmlc/serializer.h:35-381): POD scalars, strings, vectors of POD
(bulk-copied, serializer.h:104+), nested STL composites (vector/map/pair of
anything), and user classes implementing ``Serializable``
(SaveLoadClassHandler, serializer.h:80-88).  Unsupported types raise at
save/load time (the reference fails at compile time, serializer.h:96-98).

Layout (matching the reference so C++/Python blobs interoperate):
- POD scalar: raw little-endian fixed width;
- string / vector<T>: ``uint64`` element count then payload;
- map<K,V>: ``uint64`` count then (key, value) pairs;
- pair<A,B>: A then B.

The schema is a *spec* value::

    POD(np.float32)                 # one scalar
    Str                             # byte/unicode string
    Vector(POD(np.int64))           # bulk numpy fast path
    Vector(Str)                     # element-wise
    Map(Str, Vector(POD(np.f4)))    # dict
    Pair(POD(np.i4), Str)           # 2-tuple
    Obj(MyClass)                    # MyClass() constructed then .load(stream)

``save(stream, value, spec)`` / ``load(stream, spec)`` are the entry points.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from dmlc_core_tpu_torch.io.stream import Stream
from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["POD", "Str", "Vector", "Map", "Pair", "Obj", "save", "load"]


class _Spec:
    def save(self, stream: Stream, value: Any) -> None:
        raise NotImplementedError

    def load(self, stream: Stream) -> Any:
        raise NotImplementedError


class POD(_Spec):
    """Fixed-width scalar (reference PODHandler, serializer.h:69-77)."""

    def __init__(self, dtype: Any):
        # pin little-endian regardless of host order (the reference guards
        # byte order the same way, include/dmlc/endian.h:10-17); on LE
        # hosts this is the native dtype, so no conversion cost
        self.dtype = np.dtype(dtype).newbyteorder("<")
        CHECK(self.dtype.kind in "iufb", f"POD spec requires numeric dtype, got {self.dtype}")

    def save(self, stream: Stream, value: Any) -> None:
        stream.write(np.asarray(value, dtype=self.dtype).tobytes())

    def load(self, stream: Stream) -> Any:
        data = stream.read_exact(self.dtype.itemsize)
        return np.frombuffer(data, dtype=self.dtype)[0].item()


class _StrSpec(_Spec):
    """Length-prefixed byte string; decodes to str when valid UTF-8 was written."""

    def save(self, stream: Stream, value: Any) -> None:
        stream.write_string(value)

    def load(self, stream: Stream) -> str:
        return stream.read_string().decode("utf-8")


Str = _StrSpec()


class Vector(_Spec):
    """uint64 count + elements (reference PODVectorHandler/ComposeVectorHandler)."""

    def __init__(self, elem: _Spec):
        self.elem = elem

    def save(self, stream: Stream, value: Any) -> None:
        if isinstance(self.elem, POD):
            arr = np.asarray(value, dtype=self.elem.dtype)
            CHECK(arr.ndim <= 1, "Vector(POD) expects a 1-d sequence")
            stream.write_array(arr.reshape(-1))
            return
        value = list(value)
        stream.write_u64(len(value))
        for item in value:
            self.elem.save(stream, item)

    def load(self, stream: Stream) -> Any:
        if isinstance(self.elem, POD):
            return stream.read_array(self.elem.dtype)
        n = stream.read_u64()
        return [self.elem.load(stream) for _ in range(n)]


class Map(_Spec):
    """uint64 count + key/value pairs (reference map handlers)."""

    def __init__(self, key: _Spec, value: _Spec):
        self.key = key
        self.value = value

    def save(self, stream: Stream, value: Dict) -> None:
        stream.write_u64(len(value))
        for k, v in value.items():
            self.key.save(stream, k)
            self.value.save(stream, v)

    def load(self, stream: Stream) -> Dict:
        n = stream.read_u64()
        out = {}
        for _ in range(n):
            k = self.key.load(stream)
            out[k] = self.value.load(stream)
        return out


class Pair(_Spec):
    """A then B (reference PairHandler)."""

    def __init__(self, first: _Spec, second: _Spec):
        self.first = first
        self.second = second

    def save(self, stream: Stream, value: Tuple) -> None:
        self.first.save(stream, value[0])
        self.second.save(stream, value[1])

    def load(self, stream: Stream) -> Tuple:
        a = self.first.load(stream)
        b = self.second.load(stream)
        return (a, b)


class Obj(_Spec):
    """A class with save(stream)/load(stream) (reference SaveLoadClassHandler)."""

    def __init__(self, cls: type):
        self.cls = cls

    def save(self, stream: Stream, value: Any) -> None:
        value.save(stream)

    def load(self, stream: Stream) -> Any:
        obj = self.cls()
        obj.load(stream)
        return obj


def _infer_spec(value: Any) -> _Spec:
    """Best-effort spec inference for convenience saves (numpy arrays, str, ...)."""
    if isinstance(value, np.ndarray):
        return Vector(POD(value.dtype))
    if isinstance(value, (bytes, str)):
        return Str
    if isinstance(value, bool):
        return POD(np.uint8)
    if isinstance(value, int):
        return POD(np.int64)
    if isinstance(value, float):
        return POD(np.float64)
    raise TypeError(
        f"cannot infer serialization spec for {type(value).__name__}; pass spec= "
        f"(the reference rejects undefined types at compile time, serializer.h:96-98)"
    )


def save(stream: Stream, value: Any, spec: _Spec | None = None) -> None:
    (spec or _infer_spec(value)).save(stream, value)


def load(stream: Stream, spec: _Spec) -> Any:
    return spec.load(stream)
