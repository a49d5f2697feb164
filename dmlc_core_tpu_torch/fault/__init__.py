"""Deterministic fault injection for the port's IO paths.

Counterpart of ``dmlc_core_tpu/fault/__init__.py``, cut to the sites the
port has.  A JSON **fault plan** (:mod:`.plan`) names injection sites,
fault kinds, and a deterministic firing discipline; the instrumented code
consults this module at the named sites.

Injection sites (see :data:`SITES`):

- ``io.stream.open``       — URI stream factory open;
- ``io.stream.read``       — :meth:`Stream.read_exact` (``truncate`` rules);
- ``threadediter.produce`` — the producer thread, per item.

**Disabled is the default and costs one attribute load + branch**: every
helper returns immediately while no plan is configured, and the instrumented
call sites additionally guard on :func:`enabled`.

Enable via :func:`configure` (tests) or the environment::

    DMLC_FAULT_PLAN='{"rules": [{"site": "io.stream.open", "kind": "error"}]}'
    DMLC_FAULT_PLAN=@/path/to/plan.json

Every fired fault is logged, appended to the in-process ledger
(:func:`fires`), and counted as ``dmlc_fault_injected_total{site,kind}``
through the telemetry stack.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from dmlc_core_tpu_torch import telemetry
from dmlc_core_tpu_torch.fault.plan import (ACT_KINDS, FaultPlan,
                                            FaultPlanError, FaultRule, KINDS)

__all__ = [
    "SITES", "KINDS",
    "enabled", "configure", "clear", "get_plan", "fires",
    "inject", "truncate",
    "FaultPlan", "FaultRule", "FaultPlanError",
]

logger = logging.getLogger("dmlc_core_tpu_torch.fault")

# the named sites the codebase is instrumented with -> what faults mean there
SITES: Dict[str, str] = {
    "io.stream.open": "URI stream factory open (create_stream[_for_read])",
    "io.stream.read": (
        "Stream.read_exact; 'truncate' cuts the stream short, modeling a "
        "truncated object/dropped connection"),
    "threadediter.produce": (
        "producer thread, once per produced item (ctx: name=<iterator>)"),
}

_plan: Optional[FaultPlan] = None
_TRUNCATE_KINDS = frozenset({"truncate"})


def enabled() -> bool:
    """True when a fault plan is configured (call sites guard on this)."""
    return _plan is not None


def configure(spec: Any) -> FaultPlan:
    """Install a plan (dict, JSON text, or FaultPlan); returns it."""
    global _plan
    plan = spec if isinstance(spec, FaultPlan) else FaultPlan(spec)
    _plan = plan
    logger.info("fault plan configured: %d rule(s), seed=%r",
                len(plan.rules), plan.seed)
    return plan


def clear() -> None:
    """Remove the plan; every helper becomes a no-op again."""
    global _plan
    _plan = None


def get_plan() -> Optional[FaultPlan]:
    return _plan


def fires() -> List[Tuple[str, str, int]]:
    """(site, kind, rule index) for every fault fired so far, in order."""
    plan = _plan
    if plan is None:
        return []
    with plan._lock:
        return list(plan.fired_log)


def _note(site: str, kind: str) -> None:
    logger.warning("fault injected: site=%s kind=%s", site, kind)
    telemetry.count("dmlc_fault_injected_total", site=site, kind=kind)
    # the fire lands ON the span that was running when it hit: an instant
    # event carrying the thread's active trace context, so an assembled
    # trace shows exactly which request/chunk ate the injected fault —
    # and the flight ring keeps it even if the process dies right after
    telemetry.event("fault.injected", site=site, kind=kind)
    if not telemetry.enabled():
        telemetry.flight.note("fault.injected", site=site, kind=kind)


def inject(site: str, **ctx: Any) -> None:
    """Fire any eligible act rule at ``site``: sleep, raise, or exit.

    No-op without a plan.  ``delay``/``stall`` sleep and return; ``reset``
    raises ConnectionResetError; ``error`` raises the rule's whitelisted
    exception; ``exit`` calls ``os._exit`` (worker kill-at-site).
    """
    plan = _plan
    if plan is None:
        return
    rule = plan.select(site, ACT_KINDS, ctx)
    if rule is None:
        return
    _note(site, rule.kind)
    if rule.kind in ("delay", "stall"):
        time.sleep(rule.seconds)
        return
    if rule.kind == "reset":
        raise ConnectionResetError(rule.message)
    if rule.kind == "exit":
        # flush the fault ledger to telemetry before dying, so a killed
        # worker's chaos run still shows WHERE it was killed; the flight
        # dump marks the process as crashed (reason names the site) so the
        # trace assembler reports it instead of showing silence
        try:
            telemetry.flight.dump(f"fault_exit:{site}")
            if telemetry.enabled():
                telemetry._atexit_flush()
        except Exception:
            pass
        os._exit(rule.code)
    raise rule.exception(rule.message)


def truncate(site: str, nbytes: int, **ctx: Any) -> int:
    """Possibly reduced byte budget for a read at ``site``.

    Returns ``nbytes`` untouched without a plan or when no truncate rule
    fires; otherwise the injected shorter length (``keep`` bytes, or
    ``fraction`` of the request).
    """
    plan = _plan
    if plan is None:
        return nbytes
    rule = plan.select(site, _TRUNCATE_KINDS, ctx)
    if rule is None:
        return nbytes
    _note(site, rule.kind)
    if rule.fraction is not None:
        return min(nbytes, int(nbytes * rule.fraction))
    return min(nbytes, rule.keep)


# -- env-driven bring-up ------------------------------------------------------

def _init_from_env() -> None:
    spec = os.environ.get("DMLC_FAULT_PLAN", "").strip()
    if not spec:
        return
    if spec.startswith("@"):
        # a plan file: the form long plans and k8s configmaps use
        with open(spec[1:], encoding="utf-8") as f:
            spec = f.read()
    # a malformed plan raises here, at import: a chaos run that silently
    # injects nothing must fail loudly, not pass greenly
    configure(spec)


_init_from_env()
