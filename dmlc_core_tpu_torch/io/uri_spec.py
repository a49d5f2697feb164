"""URI sugar: ``path?format=...&k=v#cachefile`` (reference src/io/uri_spec.h:29-77).

Counterpart of ``dmlc_core_tpu/io/uri_spec.py`` (a copy).
"""

from __future__ import annotations

from typing import Dict

from dmlc_core_tpu_torch.utils.logging import CHECK, CHECK_EQ

__all__ = ["URISpec"]


class URISpec:
    """Parse dmlc URI sugar.

    - ``#cachefile`` names a local cache; with ``num_parts != 1`` the cache
      path becomes ``<cache>.split<num_parts>.part<part_index>`` so each shard
      caches independently (reference uri_spec.h:48-55);
    - ``?k=v&k2=v2`` query args land in :attr:`args` (e.g. ``format=csv``,
      ``label_column=0`` consumed by the parser factory, reference
      src/data.cc:70-76).
    """

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1):
        name_cache = uri.split("#")
        CHECK(len(name_cache) <= 2,
              "only one `#` is allowed in file path for cachefile specification")
        self.cache_file = ""
        if len(name_cache) == 2:
            self.cache_file = name_cache[1]
            if num_parts != 1:
                self.cache_file += f".split{num_parts}.part{part_index}"
        name_args = name_cache[0].split("?")
        CHECK(len(name_args) <= 2, "only one `?` is allowed in file path")
        self.args: Dict[str, str] = {}
        if len(name_args) == 2 and name_args[1]:
            for i, kv in enumerate(name_args[1].split("&")):
                CHECK_EQ(kv.count("="), 1,
                         f"invalid uri argument format in arg {i + 1}: {kv!r}")
                key, value = kv.split("=")
                self.args[key] = value
        self.uri = name_args[0]

    def __repr__(self) -> str:
        return f"URISpec(uri={self.uri!r}, args={self.args}, cache_file={self.cache_file!r})"
