"""Pass 4 — protocol: wire-data validation discipline in the control plane.

``assert-in-protocol``
    A bare ``assert`` inside a function that reads from a peer or stream,
    in the network-facing layers (``dmlc_core_tpu_torch/tracker/`` and
    ``dmlc_core_tpu_torch/io/``).  Asserting on peer-supplied data is wrong
    twice: the check vanishes under ``python -O`` (the malformed frame
    then flows downstream unvalidated), and when it does fire it raises
    ``AssertionError`` through whatever daemon thread is serving the peer
    — crashing the service a hardened path would have kept alive by
    rejecting just that peer.  Validate with an explicit raise
    (:class:`dmlc_core_tpu_torch.tracker.rendezvous.ProtocolError` in the
    tracker) or reject-log-and-continue instead.

    The pass is scoped to functions that visibly ingest external bytes (a
    call to one of :data:`WIRE_INGEST_CALLS` anywhere in the function):
    internal invariants asserted in pure topology/bookkeeping code are
    not protocol validation and stay allowed.
"""

from __future__ import annotations

import ast
from typing import List

from dmlc_core_tpu_torch.analysis.driver import FileContext, Finding

__all__ = ["run", "PROTOCOL_PREFIXES", "WIRE_INGEST_CALLS"]

# the network-facing layers this discipline applies to (serve/ handles
# arbitrary HTTP clients: same hostile-peer posture as the tracker wire)
PROTOCOL_PREFIXES = ("dmlc_core_tpu_torch/tracker/", "dmlc_core_tpu_torch/io/",
                     "dmlc_core_tpu_torch/serve/")

# method names whose presence marks a function as ingesting external bytes
WIRE_INGEST_CALLS = {
    "recv", "recvall", "recvint", "recvstr", "recvfrom", "recv_into",
    "accept", "read", "read_exact", "readline", "readinto", "getresponse",
}


def run(ctx: FileContext) -> List[Finding]:
    if not ctx.relpath.startswith(PROTOCOL_PREFIXES):
        return []
    findings: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assert):
            continue
        func = ctx.enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)
        if func is None or not _ingests_wire_data(func):
            continue
        findings.append(ctx.finding(
            "assert-in-protocol", node,
            "bare `assert` in a function that reads peer/stream data — "
            "vanishes under `python -O` and crashes the serving thread on "
            "a malformed peer; raise ProtocolError (or reject-log-continue)"))
    return findings


def _ingests_wire_data(func: ast.AST) -> bool:
    for node in ast.walk(func):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in WIRE_INGEST_CALLS):
            return True
    return False
