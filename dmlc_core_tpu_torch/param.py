"""Declarative typed parameter structs (the part ``GBDTParam`` needs).

Counterpart of ``dmlc_core_tpu/param.py``: typed fields with defaults,
range checks and enum values, strict keyword init, and the str->str dict
form, so a parameter dict written by the JAX package
(``param.to_dict()``) initialises the port's struct unchanged; and
:func:`get_env`, the typed environment read the collective API uses.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Type

__all__ = ["Parameter", "ParamError", "field", "get_env"]


class ParamError(ValueError):
    """Raised on bad or unknown parameter values."""


_REQUIRED = object()


def _parse_bool(s: str) -> bool:
    t = s.strip().lower()
    if t in ("1", "true", "yes", "t"):
        return True
    if t in ("0", "false", "no", "f"):
        return False
    raise ValueError(f"invalid bool literal {s!r}")


class Field:
    """One declared field; a data descriptor on :class:`Parameter`."""

    def __init__(self, dtype: type, default: Any = _REQUIRED, help: str = "",
                 lower: Optional[float] = None, upper: Optional[float] = None,
                 enum: Optional[Sequence[str]] = None):
        if dtype not in (int, float, str, bool):
            raise TypeError(f"unsupported field dtype {dtype!r}")
        self.dtype = dtype
        self.default = default
        self.help = help
        self.lower = lower
        self.upper = upper
        self.enum = None if enum is None else tuple(str(v) for v in enum)
        self.name = "<unbound>"

    def __set_name__(self, owner: type, name: str) -> None:
        self.name = name

    def __get__(self, obj: Any, objtype: Any = None) -> Any:
        if obj is None:
            return self
        return obj.__dict__[self.name]

    def __set__(self, obj: Any, value: Any) -> None:
        obj.__dict__[self.name] = self.check(self.coerce(value))

    def coerce(self, value: Any) -> Any:
        try:
            if isinstance(value, str) and self.dtype is bool:
                return _parse_bool(value)
            if isinstance(value, bool) and self.dtype in (int, float):
                return self.dtype(value)
            if (self.dtype is int and isinstance(value, float)
                    and value != int(value)):
                raise ValueError(f"non-integral value {value!r}")
            return self.dtype(value)
        except (TypeError, ValueError) as exc:
            raise ParamError(
                f"Invalid value {value!r} for parameter {self.name!r} of "
                f"type {self.dtype.__name__}: {exc}") from None

    def check(self, value: Any) -> Any:
        if self.lower is not None and value < self.lower:
            raise ParamError(f"value {value!r} for parameter {self.name!r} "
                             f"exceeds bound: expected >= {self.lower}")
        if self.upper is not None and value > self.upper:
            raise ParamError(f"value {value!r} for parameter {self.name!r} "
                             f"exceeds bound: expected <= {self.upper}")
        if self.enum is not None and value not in self.enum:
            raise ParamError(f"Invalid value {value!r} for parameter "
                             f"{self.name!r}; expected one of "
                             f"{sorted(self.enum)}")
        return value

    def value_to_str(self, value: Any) -> str:
        if self.dtype is bool:
            return "1" if value else "0"
        return str(value)


def field(dtype: type, default: Any = _REQUIRED, help: str = "",
          lower: Optional[float] = None, upper: Optional[float] = None,
          enum: Optional[Sequence[str]] = None) -> Field:
    """Declare a parameter field."""
    return Field(dtype, default=default, help=help, lower=lower, upper=upper,
                 enum=enum)


class Parameter:
    """Base class for declarative parameter structs."""

    __fields__: Dict[str, Field] = {}

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        fields: Dict[str, Field] = {}
        for base in reversed(cls.__mro__[1:]):
            fields.update(getattr(base, "__fields__", {}))
        fields.update({n: v for n, v in vars(cls).items()
                       if isinstance(v, Field)})
        cls.__fields__ = fields

    def __init__(self, **kwargs: Any):
        for name, f in self.__fields__.items():
            if f.default is not _REQUIRED:
                self.__dict__[name] = f.check(f.coerce(f.default))
        for key, value in kwargs.items():
            if key not in self.__fields__:
                raise ParamError(
                    f"Cannot find parameter {key!r} in {type(self).__name__}."
                    f" Candidates: {sorted(self.__fields__)}")
            setattr(self, key, value)
        missing = [n for n in self.__fields__ if n not in self.__dict__]
        if missing:
            raise ParamError(f"required parameter(s) {missing} of "
                             f"{type(self).__name__} not set")

    def to_dict(self) -> Dict[str, str]:
        """All fields as a str->str dict (the JAX package's form)."""
        return {n: f.value_to_str(self.__dict__[n])
                for n, f in self.__fields__.items()}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self.to_dict().items())
        return f"{type(self).__name__}({body})"


def get_env(key: str, dtype: Type, default: Any) -> Any:
    """Typed environment variable read: ``default`` when unset, booleans
    parsed as the parameter fields parse them."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    if dtype is bool:
        return _parse_bool(raw)
    return dtype(raw)
