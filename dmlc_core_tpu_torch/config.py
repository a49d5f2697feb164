"""key=value config-file parser.

Counterpart of ``dmlc_core_tpu/config.py`` (a copy; it imports no
torch).

Capability parity with the reference's ``dmlc::Config`` (include/dmlc/config.h:40-186,
src/config.cc:19-279): parses ``key = value`` text with comments, quoted strings
with escape sequences, insertion-order iteration, an optional multi-value mode
(repeated keys accumulate instead of overwrite), and protobuf-text-style output
(``ToProtoString``, config.h:102).
"""

from __future__ import annotations

import io
from typing import Iterator, List, Tuple

from dmlc_core_tpu_torch.utils.logging import CHECK

__all__ = ["Config"]

_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "r": "\r"}
_REV_ESCAPES = {"\n": "\\n", "\t": "\\t", "\\": "\\\\", '"': '\\"', "\r": "\\r"}


def _tokenize(text: str) -> Iterator[str]:
    """Yield tokens: bare words, ``=``, and quoted strings with escapes resolved.

    Mirrors the reference tokenizer (src/config.cc:30-141): ``#`` starts a
    comment to end-of-line outside quotes; quoted tokens keep a leading marker
    so the writer can restore quoting.
    """
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c.isspace():
            i += 1
        elif c == "=":
            yield "="
            i += 1
        elif c == '"':
            i += 1
            out: List[str] = []
            closed = False
            while i < n:
                c = text[i]
                if c == "\\":
                    CHECK(i + 1 < n, "config: dangling escape at end of input")
                    esc = text[i + 1]
                    CHECK(esc in _ESCAPES, f"config: unsupported escape \\{esc}")
                    out.append(_ESCAPES[esc])
                    i += 2
                elif c == '"':
                    closed = True
                    i += 1
                    break
                else:
                    out.append(c)
                    i += 1
            CHECK(closed, "config: unterminated quoted string")
            yield '"' + "".join(out)
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in ('=', '#', '"'):
                j += 1
            yield text[i:j]
            i = j


class Config:
    """Ordered key=value configuration (reference config.h:40-186)."""

    def __init__(self, text_or_stream: object = None, multi_value: bool = False):
        self._multi = multi_value
        self._order: List[Tuple[str, str, bool]] = []  # (key, value, was_quoted)
        self._map: dict = {}
        if text_or_stream is not None:
            self.load(text_or_stream)

    def load(self, text_or_stream: object) -> None:
        """Parse config text or a text stream (reference LoadFromStream, config.cc:143)."""
        if hasattr(text_or_stream, "read"):
            text = text_or_stream.read()
            if isinstance(text, bytes):
                text = text.decode("utf-8")
        else:
            text = str(text_or_stream)
        tokens = list(_tokenize(text))
        i = 0
        while i < len(tokens):
            key = tokens[i]
            CHECK(key != "=", "config: stray '=' without key")
            if key.startswith('"'):
                key = key[1:]
            CHECK(i + 2 < len(tokens) + 1 and i + 1 < len(tokens) and tokens[i + 1] == "=",
                  f"config: expected '=' after key {key!r}")
            CHECK(i + 2 < len(tokens), f"config: missing value for key {key!r}")
            raw = tokens[i + 2]
            quoted = raw.startswith('"')
            value = raw[1:] if quoted else raw
            self.set_param(key, value, quoted)
            i += 3

    def set_param(self, key: str, value: object, is_string: bool = False) -> None:
        """Set/append a key (reference SetParam config.h:84-92)."""
        value = str(value)
        if not self._multi and key in self._map:
            # overwrite in place, preserving original position
            for idx, (k, _, q) in enumerate(self._order):
                if k == key:
                    self._order[idx] = (key, value, is_string or q)
                    break
        else:
            self._order.append((key, value, is_string))
        self._map.setdefault(key, [])
        if self._multi:
            self._map[key].append(value)
        else:
            self._map[key] = [value]

    def get_param(self, key: str) -> str:
        """Latest value for key; raises KeyError when absent (config.h:77-82)."""
        return self._map[key][-1]

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def items(self) -> Iterator[Tuple[str, str]]:
        """Iterate (key, value) in insertion order (reference begin/end iteration)."""
        for key, value, _ in self._order:
            yield key, value

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        return self.items()

    def to_proto_string(self) -> str:
        """Protobuf-text-format rendering (reference ToProtoString, config.h:102)."""
        out = io.StringIO()
        for key, value, quoted in self._order:
            if quoted:
                escaped = "".join(_REV_ESCAPES.get(c, c) for c in value)
                out.write(f'{key} : "{escaped}"\n')
            else:
                out.write(f"{key} : {value}\n")
        return out.getvalue()
