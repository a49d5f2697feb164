"""Name -> factory registries with aliases.

Capability parity with the reference's ``dmlc::Registry<EntryType>``
(include/dmlc/registry.h:26-304): per-entry-type singleton registries, alias
registration (registry.h:62-72), and declarative registration macros — here a
decorator.  Registries underpin the parser/data factories (reference
src/data.cc:150-159) and our ops/model/filesystem factories.

Usage::

    parsers = Registry.get("parser")

    @parsers.register("libsvm", aliases=["svm"])
    def make_libsvm(source, nthread):
        ...

    entry = parsers.find("svm")
    parser = entry(source, nthread=2)

Counterpart of ``dmlc_core_tpu/registry.py`` (a copy).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Registry", "RegistryEntry"]


class RegistryEntry:
    """One registered factory (reference FunctionRegEntryBase, registry.h:146-222)."""

    def __init__(self, name: str, body: Callable[..., Any], description: str = ""):
        self.name = name
        self.body = body
        self.description = description
        self.aliases: List[str] = []

    def describe(self, description: str) -> "RegistryEntry":
        self.description = description
        return self

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.body(*args, **kwargs)

    def __repr__(self) -> str:
        return f"RegistryEntry({self.name!r})"


class Registry:
    """A singleton-per-name registry (reference Registry<E>::Get, registry.h:26-122)."""

    _registries: Dict[str, "Registry"] = {}
    _lock = threading.Lock()

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, RegistryEntry] = {}

    @classmethod
    def get(cls, kind: str) -> "Registry":
        """Return the global registry for ``kind``, creating it on first use."""
        with cls._lock:
            reg = cls._registries.get(kind)
            if reg is None:
                reg = cls._registries[kind] = Registry(kind)
            return reg

    # -- registration --------------------------------------------------------
    def register(
        self,
        name: str,
        aliases: Optional[List[str]] = None,
        description: str = "",
        override: bool = False,
    ) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        """Decorator registering a factory under ``name`` (+ aliases).

        Double registration of the same name raises unless ``override=True``
        (the reference fails a CHECK, registry.h:82-85).
        """

        def deco(body: Callable[..., Any]) -> Callable[..., Any]:
            self.add(name, body, aliases=aliases, description=description,
                     override=override)
            return body

        return deco

    def add(
        self,
        name: str,
        body: Callable[..., Any],
        aliases: Optional[List[str]] = None,
        description: str = "",
        override: bool = False,
    ) -> RegistryEntry:
        entry = RegistryEntry(name, body, description)
        with self._lock:
            if name in self._entries and not override:
                raise KeyError(f"{self.kind} registry: name {name!r} already registered")
            self._entries[name] = entry
            for alias in aliases or []:
                existing = self._entries.get(alias)
                if existing is not None and existing.name != name and not override:
                    raise KeyError(
                        f"{self.kind} registry: alias {alias!r} already bound to "
                        f"{existing.name!r}"
                    )
                self._entries[alias] = entry
                entry.aliases.append(alias)
        return entry

    # -- lookup ---------------------------------------------------------------
    def find(self, name: str) -> Optional[RegistryEntry]:
        """Find an entry by name or alias; None when absent (registry.h:48-56)."""
        return self._entries.get(name)

    def __getitem__(self, name: str) -> RegistryEntry:
        entry = self.find(name)
        if entry is None:
            raise KeyError(
                f"{self.kind} registry: unknown name {name!r}; "
                f"known: {sorted(self.list_names())}"
            )
        return entry

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def list_names(self) -> List[str]:
        """Canonical (non-alias) names (reference ListAllNames, registry.h:41-46)."""
        return sorted({e.name for e in self._entries.values()})

    def remove(self, name: str) -> None:
        with self._lock:
            entry = self._entries.pop(name, None)
            if entry is not None:
                for alias in entry.aliases:
                    self._entries.pop(alias, None)
