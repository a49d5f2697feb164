"""Schema-directed JSON reader/writer with line-number error reporting.

Counterpart of ``dmlc_core_tpu/json_io.py`` (a copy; it imports no
torch).

Capability parity with the reference's ``dmlc::JSONReader/JSONWriter``
(include/dmlc/json.h:41-147 reader, 152-248 writer), the struct helper
``JSONObjectReadHelper`` (json.h:266+), and type-erased ``any`` JSON via
registered type names (``AnyJSONManager`` json.h:486,
``DMLC_JSON_ENABLE_ANY`` json.h:327-340):

- event-style pull reader: ``begin_object``/``next_object_item``,
  ``begin_array``/``next_array_item``, typed ``read(spec)`` — every error
  reports the 1-based source line (json.h:116-123);
- writer with matching ``begin_*``/``write_object_keyvalue``/
  ``write_array_item`` calls and multi-line indentation;
- :class:`JSONObjectReadHelper`: declare typed fields (optional or
  required), then ``read_all_fields`` enforces unknown-key and missing-key
  policy exactly like the reference;
- :func:`register_any_type`: name-registered (to_json, from_json) pairs so
  heterogeneous ``any`` values round-trip as ``[type_name, value]`` pairs the
  way ``AnyJSONManager`` serializes them.

Type *specs* mirror the serializer module's vocabulary: a spec is ``int``,
``float``, ``bool``, ``str``, ``None`` (infer / plain tree), ``[elem_spec]``
(list), ``{key_spec: value_spec}`` (dict with string keys), ``(s1, s2, ...)``
(fixed tuple), a class with ``json_load``/``json_save`` methods, or the
string ``"any"`` for registered type-erased values.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["JSONReader", "JSONWriter", "JSONObjectReadHelper",
           "JSONError", "register_any_type", "dumps", "loads"]


# --------------------------------------------------------------------------
# type-erased any registry (reference AnyJSONManager, json.h:486+)

_ANY_BY_NAME: Dict[str, Tuple[type, Callable, Callable]] = {}
_ANY_BY_TYPE: Dict[type, str] = {}


def register_any_type(name: str, cls: type,
                      to_json: Optional[Callable[[Any], Any]] = None,
                      from_json: Optional[Callable[[Any], Any]] = None) -> None:
    """Register ``cls`` under ``name`` for type-erased JSON round-trips
    (reference ``DMLC_JSON_ENABLE_ANY``, json.h:327-340)."""
    if name in _ANY_BY_NAME and _ANY_BY_NAME[name][0] is not cls:
        raise ValueError(f"any type name {name!r} already registered")
    _ANY_BY_NAME[name] = (cls, to_json or (lambda v: v),
                          from_json or (lambda v: cls(v)))
    _ANY_BY_TYPE[cls] = name


class JSONError(ValueError):
    pass


# --------------------------------------------------------------------------
# reader

class JSONReader:
    """Event-style pull reader (reference json.h:41-147).

    Typical use::

        reader = JSONReader(text)
        reader.begin_object()
        while (key := reader.next_object_item()) is not None:
            value = reader.read(int)
    """

    def __init__(self, text: str):
        self._s = text
        self._pos = 0
        self._line = 1
        # scope_counter[-1] counts items emitted in the innermost scope
        self._scope: List[int] = []

    # -- low-level ---------------------------------------------------------
    def _error(self, msg: str) -> JSONError:
        return JSONError(f"JSON parse error at line {self._line}: {msg}")

    def _peek(self) -> str:
        """Next non-whitespace char without consuming (json.h PeekNextNonSpace)."""
        while self._pos < len(self._s):
            c = self._s[self._pos]
            if c == "\n":
                self._line += 1
            elif not c.isspace():
                return c
            self._pos += 1
        raise self._error("unexpected end of input")

    def _next(self) -> str:
        c = self._peek()
        self._pos += 1
        return c

    def _expect(self, ch: str) -> None:
        c = self._next()
        if c != ch:
            raise self._error(f"expected {ch!r}, got {c!r}")

    # -- tokens ------------------------------------------------------------
    def read_string(self) -> str:
        self._expect('"')
        out = []
        while True:
            if self._pos >= len(self._s):
                raise self._error("unterminated string")
            c = self._s[self._pos]
            self._pos += 1
            if c == '"':
                return "".join(out)
            if c == "\\":
                e = self._s[self._pos] if self._pos < len(self._s) else ""
                self._pos += 1
                mapping = {'"': '"', "\\": "\\", "/": "/", "b": "\b",
                           "f": "\f", "n": "\n", "r": "\r", "t": "\t"}
                if e == "u":
                    code = self._s[self._pos:self._pos + 4]
                    self._pos += 4
                    try:
                        cp = int(code, 16)
                    except ValueError:
                        raise self._error(f"bad unicode escape \\u{code}")
                    # combine UTF-16 surrogate pairs (stdlib-json producers
                    # emit non-BMP chars as \uD8xx\uDCxx with ensure_ascii)
                    if 0xD800 <= cp <= 0xDBFF and self._s.startswith(
                            "\\u", self._pos):
                        lo_code = self._s[self._pos + 2:self._pos + 6]
                        try:
                            lo = int(lo_code, 16)
                        except ValueError:
                            lo = -1
                        if 0xDC00 <= lo <= 0xDFFF:
                            self._pos += 6
                            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00)
                    out.append(chr(cp))
                elif e in mapping:
                    out.append(mapping[e])
                else:
                    raise self._error(f"bad escape \\{e}")
            else:
                if c == "\n":
                    self._line += 1
                out.append(c)

    def read_number(self) -> float:
        c = self._peek()
        # non-finite tokens (stdlib-json compatible: NaN/Infinity/-Infinity)
        for tok, val in (("NaN", float("nan")), ("Infinity", float("inf")),
                         ("-Infinity", float("-inf"))):
            if self._s.startswith(tok, self._pos):
                self._pos += len(tok)
                return val
        start = self._pos
        while (self._pos < len(self._s)
               and self._s[self._pos] in "+-0123456789.eE"):
            self._pos += 1
        tok = self._s[start:self._pos]
        try:
            return int(tok)
        except ValueError:
            try:
                return float(tok)
            except ValueError:
                raise self._error(f"invalid number {tok!r}")

    def read_bool(self) -> bool:
        c = self._peek()
        word = self._s[self._pos:self._pos + (4 if c == "t" else 5)]
        if word == "true":
            self._pos += 4
            return True
        if word == "false":
            self._pos += 5
            return False
        raise self._error(f"expected true/false, got {word!r}")

    def read_null(self) -> None:
        if self._s[self._pos:self._pos + 4] == "null":
            self._pos += 4
            return None
        raise self._error("expected null")

    # -- structure (reference json.h:71-105) -------------------------------
    def begin_object(self) -> None:
        self._expect("{")
        self._scope.append(0)

    def begin_array(self) -> None:
        self._expect("[")
        self._scope.append(0)

    def next_object_item(self) -> Optional[str]:
        """Key of the next item, or None at object end (json.h:98)."""
        if self._peek() == "}":
            self._pos += 1
            self._scope.pop()
            return None
        if self._scope[-1] > 0:
            self._expect(",")
        self._scope[-1] += 1
        key = self.read_string()
        self._expect(":")
        return key

    def next_array_item(self) -> bool:
        if self._peek() == "]":
            self._pos += 1
            self._scope.pop()
            return False
        if self._scope[-1] > 0:
            self._expect(",")
        self._scope[-1] += 1
        return True

    # -- typed read (reference Read<T>, json.h:113) ------------------------
    def read(self, spec: Any = None) -> Any:
        if spec is None:
            return self._read_value()
        if spec == "any":
            self.begin_array()
            if not self.next_array_item():
                raise self._error("any value must be [type_name, value]")
            name = self.read_string()
            if name not in _ANY_BY_NAME:
                raise self._error(f"any type {name!r} is not registered")
            _, _, from_json = _ANY_BY_NAME[name]
            if not self.next_array_item():
                raise self._error("any value must be [type_name, value]")
            value = self._read_value()
            if self.next_array_item():
                raise self._error("any value must have exactly 2 entries")
            return from_json(value)
        if spec is str:
            return self.read_string()
        if spec is bool:
            return self.read_bool()
        if spec is int:
            v = self.read_number()
            if not isinstance(v, int):
                raise self._error(f"expected integer, got {v}")
            return v
        if spec is float:
            return float(self.read_number())
        if isinstance(spec, list):
            out = []
            self.begin_array()
            while self.next_array_item():
                out.append(self.read(spec[0]))
            return out
        if isinstance(spec, tuple):
            self.begin_array()
            out = []
            for s in spec:
                if not self.next_array_item():
                    raise self._error(f"expected {len(spec)}-tuple")
                out.append(self.read(s))
            if self.next_array_item():
                raise self._error(f"expected {len(spec)}-tuple")
            return tuple(out)
        if isinstance(spec, dict):
            (kspec, vspec), = spec.items()
            out = {}
            self.begin_object()
            while (key := self.next_object_item()) is not None:
                out[_coerce_key(key, kspec, self)] = self.read(vspec)
            return out
        if isinstance(spec, type) and hasattr(spec, "json_load"):
            return spec.json_load(self)
        raise self._error(f"unsupported read spec {spec!r}")

    def _read_value(self) -> Any:
        c = self._peek()
        if c == "{":
            out = {}
            self.begin_object()
            while (key := self.next_object_item()) is not None:
                out[key] = self._read_value()
            return out
        if c == "[":
            out = []
            self.begin_array()
            while self.next_array_item():
                out.append(self._read_value())
            return out
        if c == '"':
            return self.read_string()
        if c in "tf":
            return self.read_bool()
        if c == "n":
            return self.read_null()
        return self.read_number()


def _coerce_key(key: str, kspec: Any, reader: JSONReader) -> Any:
    if kspec is str:
        return key
    if kspec is int:
        try:
            return int(key)
        except ValueError:
            raise reader._error(f"expected integer key, got {key!r}")
    raise reader._error(f"unsupported key spec {kspec!r}")


# --------------------------------------------------------------------------
# writer

class JSONWriter:
    """Streaming writer mirroring the reader's call structure
    (reference json.h:152-248)."""

    def __init__(self, multi_line: bool = True):
        self._out: List[str] = []
        self._scope: List[int] = []
        self._scope_multi: List[bool] = []
        self._multi_line = multi_line

    def _sep(self) -> None:
        if self._scope_multi and self._scope_multi[-1]:
            self._out.append("\n" + "  " * len(self._scope))

    def write_string(self, s: str) -> None:
        out = ['"']
        for c in s:
            if c == "\\":
                out.append("\\\\")
            elif c == '"':
                out.append('\\"')
            elif c == "\n":
                out.append("\\n")
            elif c == "\r":
                out.append("\\r")
            elif c == "\t":
                out.append("\\t")
            elif ord(c) < 0x20:
                out.append(f"\\u{ord(c):04x}")
            else:
                out.append(c)
        out.append('"')
        self._out.append("".join(out))

    def begin_object(self, multi_line: Optional[bool] = None) -> None:
        self._out.append("{")
        self._scope.append(0)
        self._scope_multi.append(self._multi_line if multi_line is None
                                 else multi_line)

    def begin_array(self, multi_line: Optional[bool] = None) -> None:
        self._out.append("[")
        self._scope.append(0)
        self._scope_multi.append(self._multi_line if multi_line is None
                                 else multi_line)

    def end_object(self) -> None:
        n = self._scope.pop()
        multi = self._scope_multi.pop()
        if n and multi:
            self._out.append("\n" + "  " * len(self._scope))
        self._out.append("}")

    def end_array(self) -> None:
        n = self._scope.pop()
        multi = self._scope_multi.pop()
        if n and multi:
            self._out.append("\n" + "  " * len(self._scope))
        self._out.append("]")

    def write_object_keyvalue(self, key: str, value: Any,
                              spec: Any = None) -> None:
        if self._scope[-1] > 0:
            self._out.append(",")
        self._scope[-1] += 1
        self._sep()
        self.write_string(key)
        self._out.append(": " if self._scope_multi[-1] else ":")
        self.write(value, spec)

    def write_array_item(self, value: Any, spec: Any = None) -> None:
        if self._scope[-1] > 0:
            self._out.append(",")
        self._scope[-1] += 1
        self._sep()
        self.write(value, spec)

    def write(self, value: Any, spec: Any = None) -> None:
        if spec == "any":
            name = _ANY_BY_TYPE.get(type(value))
            if name is None:
                raise TypeError(
                    f"type {type(value).__name__} is not registered for "
                    f"any-JSON (register_any_type)")
            _, to_json, _ = _ANY_BY_NAME[name]
            self.begin_array(multi_line=False)
            self.write_array_item(name)
            self.write_array_item(to_json(value))
            self.end_array()
            return
        if hasattr(value, "json_save") and not isinstance(value, type):
            value.json_save(self)
            return
        if isinstance(value, bool):
            self._out.append("true" if value else "false")
        elif value is None:
            self._out.append("null")
        elif isinstance(value, float):
            import math
            if math.isnan(value):
                self._out.append("NaN")          # stdlib-json compatible
            elif math.isinf(value):
                self._out.append("Infinity" if value > 0 else "-Infinity")
            else:
                self._out.append(repr(value))
        elif isinstance(value, int):
            self._out.append(repr(value))
        elif isinstance(value, str):
            self.write_string(value)
        elif isinstance(value, (list, tuple)):
            self.begin_array()
            for i, v in enumerate(value):
                if isinstance(spec, list):
                    vspec = spec[0]
                elif isinstance(spec, tuple) and i < len(spec):
                    vspec = spec[i]
                else:
                    vspec = None
                self.write_array_item(v, vspec)
            self.end_array()
        elif isinstance(value, dict):
            self.begin_object()
            for k, v in value.items():
                vspec = None
                if isinstance(spec, dict):
                    (_, vspec), = spec.items()
                self.write_object_keyvalue(str(k), v, vspec)
            self.end_object()
        else:
            raise TypeError(f"cannot JSON-write {type(value).__name__}")

    def getvalue(self) -> str:
        return "".join(self._out)


# --------------------------------------------------------------------------
# struct helper (reference JSONObjectReadHelper, json.h:266+)

class JSONObjectReadHelper:
    """Declare typed fields, then read a whole object with required/optional
    and unknown-key enforcement::

        helper = JSONObjectReadHelper()
        helper.declare_field("name", str)
        helper.declare_field_optional("size", int, default=0)
        values = helper.read_all_fields(reader)
    """

    def __init__(self):
        self._fields: Dict[str, Tuple[Any, bool, Any]] = {}

    def declare_field(self, key: str, spec: Any) -> None:
        self._fields[key] = (spec, False, None)

    def declare_field_optional(self, key: str, spec: Any,
                               default: Any = None) -> None:
        self._fields[key] = (spec, True, default)

    def read_all_fields(self, reader: JSONReader) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        reader.begin_object()
        while (key := reader.next_object_item()) is not None:
            if key not in self._fields:
                raise reader._error(f"JSONReader: unknown field {key!r}")
            if key in out:
                raise reader._error(f"JSONReader: duplicate field {key!r}")
            out[key] = reader.read(self._fields[key][0])
        for key, (_, optional, default) in self._fields.items():
            if key not in out:
                if not optional:
                    raise JSONError(
                        f"JSONReader: missing required field {key!r}")
                out[key] = default
        return out


# --------------------------------------------------------------------------
# convenience

def dumps(value: Any, spec: Any = None, multi_line: bool = True) -> str:
    writer = JSONWriter(multi_line=multi_line)
    writer.write(value, spec)
    return writer.getvalue()


def loads(text: str, spec: Any = None) -> Any:
    return JSONReader(text).read(spec)
