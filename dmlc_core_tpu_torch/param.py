"""Reflected, self-documenting parameter structs.

Counterpart of ``dmlc_core_tpu/param.py``, line for line in behaviour:
typed fields with defaults, range checks, enum values (string lists or
name->value maps) and optional fields; ``init(kwargs, allow_unknown=)``
with the hidden-key rule (keys of the form ``__x__`` are skipped, as
dmlc-core skips hidden arguments); ``update``; the str->str dict form,
``to_json``/``load_json``/``save`` (the JSON is byte-identical to the JAX
package's, so a parameter file saved by either package loads in the
other); ``get_field_info``/``type_str``/``doc_string``; ``__eq__`` and
``__hash__`` by content; and :func:`get_env`, the typed environment read.

Usage::

    class LinearParam(Parameter):
        learning_rate = field(float, default=0.1, lower=0.0, help="step size")
        num_feature = field(int, help="feature dimension")   # required

    p = LinearParam()
    unknown = p.init({"num_feature": 100, "batch": 32}, allow_unknown=True)
"""

from __future__ import annotations

import json as _json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type, Union

__all__ = ["Parameter", "ParamError", "field", "Field", "get_env"]


class ParamError(ValueError):
    """Raised on bad/missing parameter values (reference parameter.h:60-67)."""


_REQUIRED = object()


def _parse_bool(s: str) -> bool:
    t = s.strip().lower()
    if t in ("1", "true", "yes", "t"):
        return True
    if t in ("0", "false", "no", "f"):
        return False
    raise ValueError(f"invalid bool literal {s!r}")


class Field:
    """One declared parameter field (reference FieldEntry<T>, parameter.h:500-900).

    Acts as a data descriptor on :class:`Parameter` subclasses.
    """

    def __init__(
        self,
        dtype: type,
        default: Any = _REQUIRED,
        help: str = "",
        lower: Optional[float] = None,
        upper: Optional[float] = None,
        enum: Union[None, Sequence[str], Dict[str, Any]] = None,
        optional: bool = False,
    ):
        if dtype not in (int, float, str, bool):
            raise TypeError(f"unsupported field dtype {dtype!r}; use int/float/str/bool")
        self.dtype = dtype
        self.default = default
        self.help = help
        self.lower = lower
        self.upper = upper
        self.optional = optional
        # enum: sequence of allowed strings (str fields) or name->value map
        # (reference add_enum, parameter.h:681-783).
        self.enum_map: Optional[Dict[str, Any]] = None
        if enum is not None:
            if isinstance(enum, dict):
                self.enum_map = dict(enum)
            else:
                self.enum_map = {str(v): str(v) for v in enum}
        self.name: str = "<unbound>"
        if optional and default is _REQUIRED:
            self.default = None

    # -- descriptor protocol ------------------------------------------------
    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def __get__(self, obj: Any, objtype: Any = None) -> Any:
        if obj is None:
            return self
        try:
            return obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(
                f"parameter field {self.name!r} accessed before init and has no default"
            ) from None

    def __set__(self, obj: Any, value: Any) -> None:
        obj.__dict__[self.name] = self.check(self.coerce(value))

    # -- value handling -----------------------------------------------------
    def coerce(self, value: Any) -> Any:
        """Parse/convert ``value`` to the field type (FieldEntryBase::Set, 518-539)."""
        if self.optional and (value is None or value == "None"):
            return None
        if self.enum_map is not None and isinstance(value, str):
            if value not in self.enum_map:
                raise ParamError(
                    f"Invalid value {value!r} for parameter {self.name!r}; "
                    f"expected one of {sorted(self.enum_map)}"
                )
            return self.enum_map[value]
        try:
            if isinstance(value, str) and self.dtype is bool:
                return _parse_bool(value)
            if isinstance(value, bool) and self.dtype in (int, float):
                return self.dtype(value)
            if self.dtype is int and isinstance(value, float) and value != int(value):
                raise ValueError(f"non-integral value {value!r}")
            return self.dtype(value)
        except (TypeError, ValueError) as exc:
            raise ParamError(
                f"Invalid value {value!r} for parameter {self.name!r} of type "
                f"{self.dtype.__name__}: {exc}"
            ) from None

    def check(self, value: Any) -> Any:
        """Range validation (FieldEntryNumeric::Check, parameter.h:638-659)."""
        if value is None and self.optional:
            return value
        if self.lower is not None and value < self.lower:
            raise ParamError(
                f"value {value!r} for parameter {self.name!r} exceeds bound: "
                f"expected {self.name} >= {self.lower}"
            )
        if self.upper is not None and value > self.upper:
            raise ParamError(
                f"value {value!r} for parameter {self.name!r} exceeds bound: "
                f"expected {self.name} <= {self.upper}"
            )
        if self.enum_map is not None and value not in self.enum_map.values():
            raise ParamError(
                f"value {value!r} for parameter {self.name!r} not among enum values "
                f"{sorted(map(repr, self.enum_map.values()))}"
            )
        return value

    def value_to_str(self, value: Any) -> str:
        if self.enum_map is not None:
            for k, v in self.enum_map.items():
                if v == value:
                    return k
        if value is None:
            return "None"
        if self.dtype is bool:
            return "1" if value else "0"
        return str(value)

    # -- reflection ---------------------------------------------------------
    def type_str(self) -> str:
        base = "optional[int]" if self.optional and self.dtype is int else self.dtype.__name__
        parts = [base]
        if self.enum_map is not None:
            parts = ["{" + ", ".join(sorted(map(repr, self.enum_map))) + "}"]
        if self.lower is not None or self.upper is not None:
            lo = self.lower if self.lower is not None else "-inf"
            hi = self.upper if self.upper is not None else "inf"
            parts.append(f"range [{lo}, {hi}]")
        if self.default is not _REQUIRED:
            parts.append(f"default={self.value_to_str(self.default)}")
        else:
            parts.append("required")
        return ", ".join(parts)


def field(
    dtype: type,
    default: Any = _REQUIRED,
    help: str = "",
    lower: Optional[float] = None,
    upper: Optional[float] = None,
    enum: Union[None, Sequence[str], Dict[str, Any]] = None,
    optional: bool = False,
) -> Field:
    """Declare a parameter field (reference DMLC_DECLARE_FIELD, parameter.h:240-250)."""
    return Field(dtype, default=default, help=help, lower=lower, upper=upper,
                 enum=enum, optional=optional)


class Parameter:
    """Base class for declarative parameter structs (reference Parameter<PType>)."""

    __fields__: Dict[str, Field] = {}

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        fields: Dict[str, Field] = {}
        for base in reversed(cls.__mro__[1:]):
            fields.update(getattr(base, "__fields__", {}))
        for name, value in list(vars(cls).items()):
            if isinstance(value, Field):
                fields[name] = value
        cls.__fields__ = fields

    def __init__(self, **kwargs: Any):
        for name, f in self.__fields__.items():
            if f.default is not _REQUIRED:
                self.__dict__[name] = f.check(f.coerce(f.default)) if f.default is not None else None
        if kwargs:
            self.init(kwargs)

    # -- init protocol ------------------------------------------------------
    def init(
        self,
        kwargs: Dict[str, Any],
        allow_unknown: bool = False,
    ) -> Dict[str, Any]:
        """Initialize fields from a kwargs dict (reference RunInit, parameter.h:370-410).

        Returns the dict of unknown key/value pairs when ``allow_unknown`` is
        True; raises :class:`ParamError` on unknown keys otherwise.  Keys of the
        form ``__x__`` are silently ignored (reference "hidden" args policy).
        Missing required fields raise :class:`ParamError`.
        """
        unknown: Dict[str, Any] = {}
        for key, value in kwargs.items():
            f = self.__fields__.get(key)
            if f is None:
                if len(key) > 4 and key.startswith("__") and key.endswith("__"):
                    continue
                if allow_unknown:
                    unknown[key] = value
                    continue
                raise ParamError(
                    f"Cannot find parameter {key!r} in {type(self).__name__}. "
                    f"Candidates: {sorted(self.__fields__)}"
                )
            setattr(self, key, value)
        missing = [n for n in self.__fields__ if n not in self.__dict__]
        if missing:
            raise ParamError(
                f"required parameter(s) {missing} of {type(self).__name__} not set"
            )
        return unknown

    def update(self, kwargs: Dict[str, Any]) -> None:
        """Update a subset of fields (reference UpdateDict semantics)."""
        for key, value in kwargs.items():
            if key in self.__fields__:
                setattr(self, key, value)

    # -- reflection / serialization -----------------------------------------
    def to_dict(self) -> Dict[str, str]:
        """All fields as a str->str dict (reference GetDict / __DICT__)."""
        return {
            name: f.value_to_str(self.__dict__[name])
            for name, f in self.__fields__.items()
            if name in self.__dict__
        }

    def to_json(self) -> str:
        """JSON text holding the str->str dict (reference Save, parameter.h:165-170)."""
        return _json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def load_json(self, text: str) -> None:
        """Inverse of :meth:`to_json` (reference Load, parameter.h:172-177)."""
        data = _json.loads(text)
        if not isinstance(data, dict):
            raise ParamError("parameter JSON must hold an object of key/value pairs")
        self.init({str(k): v for k, v in data.items()})

    def save(self, stream: Any) -> None:
        """Write JSON to a binary stream (a port ``io`` stream or file-like)."""
        stream.write(self.to_json().encode("utf-8"))

    @classmethod
    def get_field_info(cls) -> List[Tuple[str, str, str]]:
        """List of (name, type_str, description) (reference __FIELDS__, GetFieldInfo)."""
        return [(n, f.type_str(), f.help) for n, f in cls.__fields__.items()]

    @classmethod
    def doc_string(cls) -> str:
        """Generated human-readable doc (reference __DOC__, parameter.h:463-471)."""
        lines = []
        for name, f in cls.__fields__.items():
            lines.append(f"{name} : {f.type_str()}")
            if f.help:
                lines.append(f"    {f.help}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.to_dict().items())
        return f"{type(self).__name__}({body})"

    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __hash__(self) -> int:  # params are config values; hash by content
        return hash((type(self), tuple(sorted(self.to_dict().items()))))


def get_env(key: str, dtype: Type, default: Any) -> Any:
    """Typed environment variable read (reference GetEnv, parameter.h:998-1008)."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    if dtype is bool:
        return _parse_bool(raw)
    return dtype(raw)
