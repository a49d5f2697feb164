"""Transport pass: the shared-memory parse transport must never pickle.

The whole point of :mod:`dmlc_core_tpu_torch.data.parse_proc` is that RowBlock
array payloads cross the process boundary as raw shared-memory bytes — a
``pickle.dumps`` (or any serializer cousin) on that path silently
reintroduces the copy+encode cost the backend exists to remove, and it
does so off the profiler's radar (the executor's own metadata pickling is
tiny and unavoidable; payload pickling is neither).

Rule ``shm-no-pickle`` flags, **only in the shm transport module(s)**:

- ``import pickle`` / ``from pickle import ...`` (and cPickle/_pickle,
  dill, cloudpickle, marshal);
- any call through those modules (``pickle.dumps(x)``, aliased or not);
- ``ForkingPickler`` usage (multiprocessing's payload pickler).
"""

from __future__ import annotations

import ast
from typing import List

from dmlc_core_tpu_torch.analysis.driver import (FileContext, Finding,
                                                 dotted_name)

__all__ = ["run", "SHM_TRANSPORT_PATHS"]

# modules whose array payloads are contractually shm-only
SHM_TRANSPORT_PATHS = {"dmlc_core_tpu_torch/data/parse_proc.py"}

_BANNED_MODULES = {"pickle", "cPickle", "_pickle", "dill", "cloudpickle",
                   "marshal"}
_BANNED_NAMES = {"ForkingPickler"}

RULE = "shm-no-pickle"


def run(ctx: FileContext) -> List[Finding]:
    if ctx.relpath not in SHM_TRANSPORT_PATHS:
        return []
    findings: List[Finding] = []

    def flag(node: ast.AST, what: str) -> None:
        findings.append(ctx.finding(
            RULE, node,
            f"{what} on the shm transport path: array payloads must cross "
            "process boundaries as raw shared-memory bytes, not pickled "
            "objects"))

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] in _BANNED_MODULES:
                    flag(node, f"import of {alias.name!r}")
        elif isinstance(node, ast.ImportFrom):
            root = (node.module or "").split(".")[0]
            if root in _BANNED_MODULES:
                flag(node, f"import from {node.module!r}")
            else:
                for alias in node.names:
                    if alias.name in _BANNED_NAMES:
                        flag(node, f"import of {alias.name!r}")
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if not name:
                continue
            root = name.split(".")[0]
            resolved = ctx.module_aliases.get(root, root).split(".")[0]
            if resolved in _BANNED_MODULES:
                flag(node, f"call to {name!r}")
            elif name.rsplit(".", 1)[-1] in _BANNED_NAMES:
                flag(node, f"call to {name!r}")
    return findings
