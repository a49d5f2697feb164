"""Deterministic fault injection for the port's IO paths.

Counterpart of ``dmlc_core_tpu/fault/__init__.py``, cut to the sites the
port has.  A JSON **fault plan** (:mod:`.plan`) names injection sites,
fault kinds, and a deterministic firing discipline; the instrumented code
consults this module at the named sites.

Injection sites (see :data:`SITES`):

- ``io.stream.open``       — URI stream factory open;
- ``io.stream.read``       — :meth:`Stream.read_exact` (``truncate`` rules);
- ``net.request``          — the remote filesystems' HTTP requests
  (``http_status`` rules replace the request; act rules fire before it);
- ``io.cache.fetch``       — remote page-cache ranged reads;
- ``threadediter.produce`` — the producer thread, per item;
- ``data.parse_worker``   — the process-pool parse worker, per sub-range;
- ``serve.request`` / ``serve.queue`` / ``serve.predict`` /
  ``serve.swap`` — the scoring server's ingress, batch assembly, model
  call and hot-swap stages;
- ``serve.router.forward`` — the multi-replica router's forward path, per
  attempt (replica-death, slow-link, and injected-response chaos);
- ``tracker.framed.recv`` / ``tracker.framed.send`` — the rendezvous
  and lease protocols' framing;
- ``tracker.accept`` — the rendezvous accept loop, per connection;
- ``io.fleet.lease`` — the fleet-ingest lease client, per wire op;
- ``train.ingest`` / ``train.round`` / ``train.publish`` — the continuous
  trainer's batch fetch, boosting round and checkpoint publish.

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
    "inject", "truncate", "http_response",
    "FaultPlan", "FaultRule", "FaultPlanError",
]

logger = logging.getLogger("dmlc_core_tpu_torch.fault")

# the named sites the codebase is instrumented with -> what faults mean there
SITES: Dict[str, str] = {
    "tracker.framed.recv": (
        "FramedSocket receive path; 'truncate' simulates a peer closing "
        "mid-frame, act kinds fire before the read"),
    "tracker.framed.send": "FramedSocket send path",
    "tracker.accept": (
        "tracker accept loop, once per accepted connection (before the "
        "handshake)"),
    "net.request": (
        "remote-FS HTTP request; 'http_status' replaces the round-trip "
        "with an injected response, act kinds fire instead of connecting"),
    "io.stream.open": "URI stream factory open (create_stream[_for_read])",
    "io.stream.read": (
        "Stream.read_exact; 'truncate' cuts the stream short, modeling a "
        "truncated object/dropped connection"),
    "io.cache.fetch": (
        "remote page-cache ranged reads (ctx: uri=<uri>, offset=<byte "
        "offset>), once per header/TOC/page fetch; 'truncate' cuts a page "
        "short and 'reset'/'error' kill the transfer — every outcome must "
        "end in a loud stream-parse fallback, never a served bad page"),
    "threadediter.produce": (
        "producer thread, once per produced item (ctx: name=<iterator>)"),
    "data.parse_worker": (
        "process-pool parse worker, once per sub-range before parsing "
        "(ctx: parser=<class>); 'exit' kills the worker mid-chunk.  "
        "Workers read DMLC_FAULT_PLAN at start: the shared pool must be "
        "(re)started after setting the plan (data.parse_proc.shutdown())"),
    "io.fleet.lease": (
        "fleet-ingest shard-lease client, once per wire op before it runs "
        "(ctx: op=acquire|renew|commit, worker=<id>); 'delay' models a "
        "straggling rank, 'reset' a flaky control link (the client "
        "retries), and 'exit' with match op=commit kills a worker mid-unit "
        "— the lease expires and the unit must be reassigned with "
        "exactly-once coverage (docs/performance.md \"Fleet ingest\")"),
    "serve.request": (
        "scoring HTTP ingress, once per POST /v1/score before parsing; "
        "'http_status' REPLACES the response (the chaos 503 storm), "
        "delay/stall model a slow handler thread, 'reset' kills the "
        "connection mid-request (the one outcome a client sees as a "
        "crash)"),
    "serve.queue": (
        "micro-batch assembly loop, once per batch (ctx: depth=<queue "
        "depth>); 'stall' models a stuck consumer — the queue backs up "
        "and admission control starts shedding (503 + Retry-After)"),
    "serve.predict": (
        "once per assembled batch before the model call (ctx: "
        "model=<family>, slot=<slot name>, rows=<n>); 'error' models a "
        "killed predict worker — that batch's requests fail with a "
        "structured 503 predict_failed and the batcher continues; a "
        "'delay' holds the batch's admission bytes, so queues genuinely "
        "back up (the router chaos drill saturates replicas this way)"),
    "serve.swap": (
        "model-lifecycle watcher, once per stage of each hot-swap cycle "
        "(ctx: model=<slot>, stage=watch|validate|warmup|swap); "
        "'error'/'reset' during validate or warmup reject the candidate "
        "— previous-good keeps serving; 'stall' during swap delays the "
        "pointer flip but can never tear it (docs/serving.md \"Model "
        "lifecycle\")"),
    "serve.router.forward": (
        "multi-replica router, once per forward attempt before the replica "
        "connection is opened (ctx: replica=<name>, attempt=<n>, "
        "tag=primary|hedge); 'reset' models a replica dying at connect "
        "time (zero response bytes read — the router retries on another "
        "replica), 'stall'/'delay' model a slow replica link (hedging "
        "territory), 'error' a router-side forwarding bug (structured "
        "503 replica_failed, never a dropped connection), and "
        "'http_status' REPLACES the replica round-trip with an injected "
        "response (docs/serving.md \"Multi-replica tier\")"),
    "train.ingest": (
        "continuous trainer, once per batch fetch before the source is "
        "read (ctx: cursor=<position>, incarnation=<n>); 'error'/'reset' "
        "model a flaky source — the fetch is retried next tick, the "
        "cursor does not advance (docs/training.md)"),
    "train.round": (
        "continuous trainer, once per boosting round before it computes "
        "(ctx: round=<odometer>, incarnation=<n>); 'exit' kills the "
        "trainer mid-round — restart must resume from the last valid "
        "manifest with the rounds since it retrained, never a torn "
        "checkpoint (the continuous chaos drill)"),
    "train.publish": (
        "continuous trainer checkpoint publish (ctx: step=<n>, "
        "phase=begin|durable, incarnation=<n>); 'exit' at phase=durable "
        "kills between blob and manifest — the step must never become a "
        "swap candidate; 'truncate' at phase=durable tears the durable "
        "blob before the publish-side verify, which must reject the step "
        "and re-publish it idempotently"),
}

_plan: Optional[FaultPlan] = None
_TRUNCATE_KINDS = frozenset({"truncate"})
_HTTP_KINDS = frozenset({"http_status"})


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


def http_response(site: str, **ctx: Any) \
        -> Optional[Tuple[int, Dict[str, str], bytes]]:
    """Injected (status, headers, body) replacing a request, or None."""
    plan = _plan
    if plan is None:
        return None
    rule = plan.select(site, _HTTP_KINDS, ctx)
    if rule is None:
        return None
    _note(site, rule.kind)
    return rule.status, dict(rule.headers), rule.body


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
