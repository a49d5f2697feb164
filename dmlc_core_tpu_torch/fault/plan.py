"""Fault plan: the declarative, deterministic description of what to break.

A plan is JSON (or an equivalent dict) with an optional ``seed`` and a list
of ``rules``.  Each rule names an injection **site** (see
:data:`dmlc_core_tpu_torch.fault.SITES`; ``fnmatch`` wildcards allowed), a fault
**kind**, and firing discipline::

    {
      "seed": 7,
      "rules": [
        {"site": "tracker.framed.recv", "kind": "reset", "after": 2},
        {"site": "net.request", "kind": "http_status", "status": 503,
         "headers": {"retry-after": "1"}, "times": 3},
        {"site": "threadediter.produce", "kind": "delay", "seconds": 0.05,
         "probability": 0.5, "times": null, "match": {"name": "parse"}}
      ]
    }

Firing discipline per rule:

- ``after``: skip the first N matching hits (default 0);
- ``times``: maximum fires (default 1; ``null``/``"inf"`` = unlimited);
- ``probability``: fire chance per eligible hit, decided by a PRNG seeded
  from ``(plan seed, rule index, site, kind)`` — the same plan replays the
  same decisions, which is what makes chaos runs debuggable;
- ``match``: context filters compared as strings against the keyword
  context the injection site provides (e.g. ``{"name": "parse"}`` on the
  threadediter site, ``{"mode": "r"}`` on stream open).

Kinds and their parameters:

=============  =============================================================
``delay``      sleep ``seconds`` (default 0.05) and continue
``stall``      alias of ``delay`` for long hangs (semantically: a peer that
               stops responding rather than a slow one)
``reset``      raise ``ConnectionResetError`` at the site
``error``      raise ``exception`` (whitelisted name, default
               ``ConnectionError``) with ``message``
``exit``       ``os._exit(code)`` (default 1) — worker kill-at-site for
               subprocess chaos tests
``truncate``   value-transforming: cut a read to ``keep`` bytes (default 0)
               or ``fraction`` of the request (sites that read peer bytes)
``http_status``value-producing: replace the request with an injected
               (``status`` default 503, ``headers``, ``body``) response
=============  =============================================================

Unknown keys, kinds, sites-typed-wrong, negative counts and out-of-range
probabilities all raise :class:`FaultPlanError` at configure time: a chaos
plan that silently injects nothing is worse than no plan at all.

Counterpart of ``dmlc_core_tpu/fault/plan.py`` (a copy).
"""

from __future__ import annotations

import fnmatch
import json
import random
import socket
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["FaultPlan", "FaultRule", "FaultPlanError", "KINDS",
           "ACT_KINDS"]


class FaultPlanError(ValueError):
    """A fault plan that cannot mean what its author intended."""


# kinds consulted by fault.inject() (side effects: sleep / raise / exit)
ACT_KINDS = frozenset({"delay", "stall", "reset", "error", "exit"})
# value kinds consulted by their dedicated helpers
KINDS = ACT_KINDS | {"truncate", "http_status"}

# the only exceptions an "error" rule may raise: everything an injection
# site's hardened caller is expected to survive
_EXCEPTIONS: Dict[str, type] = {
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "ConnectionAbortedError": ConnectionAbortedError,
    "BrokenPipeError": BrokenPipeError,
    "TimeoutError": TimeoutError,
    "socket.timeout": socket.timeout,
    "OSError": OSError,
    "IOError": IOError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
}

_RULE_KEYS = {
    "site", "kind", "after", "times", "probability", "match",
    "seconds", "exception", "message", "code", "keep", "fraction",
    "status", "headers", "body",
}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise FaultPlanError(msg)


def _coerce(fn, spec: Dict[str, Any], key: str, default: Any, index: int):
    """Typed field read that fails as a plan error, not a raw traceback —
    the validate CLI's exit-0/2 contract depends on every malformed value
    surfacing as FaultPlanError."""
    try:
        return fn(spec.get(key, default))
    except (TypeError, ValueError) as exc:
        raise FaultPlanError(
            f"rule #{index}: invalid {key!r}: {exc}") from None


class FaultRule:
    """One parsed rule plus its firing state (hits/fired/PRNG)."""

    def __init__(self, spec: Dict[str, Any], index: int, seed: Any):
        _require(isinstance(spec, dict),
                 f"rule #{index}: expected an object, got {type(spec).__name__}")
        unknown = set(spec) - _RULE_KEYS
        _require(not unknown,
                 f"rule #{index}: unknown key(s) {sorted(unknown)}")
        self.index = index
        self.site = spec.get("site")
        _require(isinstance(self.site, str) and self.site,
                 f"rule #{index}: 'site' must be a non-empty string")
        self.kind = spec.get("kind")
        _require(self.kind in KINDS,
                 f"rule #{index}: unknown kind {self.kind!r} "
                 f"(one of {sorted(KINDS)})")

        self.after = _coerce(int, spec, "after", 0, index)
        _require(self.after >= 0, f"rule #{index}: 'after' must be >= 0")
        times = spec.get("times", 1)
        if times in (None, "inf"):
            self.times: Optional[int] = None
        else:
            self.times = _coerce(int, spec, "times", 1, index)
            _require(self.times >= 1,
                     f"rule #{index}: 'times' must be >= 1 (or null for "
                     "unlimited)")
        self.probability = _coerce(float, spec, "probability", 1.0, index)
        _require(0.0 < self.probability <= 1.0,
                 f"rule #{index}: 'probability' must be in (0, 1]")
        match = spec.get("match", {})
        _require(isinstance(match, dict),
                 f"rule #{index}: 'match' must be an object")
        self.match = {str(k): str(v) for k, v in match.items()}

        # per-kind parameters
        self.seconds = _coerce(float, spec, "seconds", 0.05, index)
        _require(self.seconds >= 0, f"rule #{index}: 'seconds' must be >= 0")
        exc_name = spec.get("exception", "ConnectionError")
        _require(exc_name in _EXCEPTIONS,
                 f"rule #{index}: 'exception' must be one of "
                 f"{sorted(_EXCEPTIONS)}")
        self.exception = _EXCEPTIONS[exc_name]
        self.message = str(spec.get(
            "message", f"injected fault (site={self.site}, kind={self.kind})"))
        self.code = _coerce(int, spec, "code", 1, index)
        self.keep = _coerce(int, spec, "keep", 0, index)
        _require(self.keep >= 0, f"rule #{index}: 'keep' must be >= 0")
        self.fraction = spec.get("fraction")
        if self.fraction is not None:
            self.fraction = _coerce(float, spec, "fraction", None, index)
            _require(0.0 <= self.fraction < 1.0,
                     f"rule #{index}: 'fraction' must be in [0, 1)")
        self.status = _coerce(int, spec, "status", 503, index)
        headers = spec.get("headers", {})
        _require(isinstance(headers, dict),
                 f"rule #{index}: 'headers' must be an object")
        self.headers = {str(k).lower(): str(v) for k, v in headers.items()}
        body = spec.get("body", "")
        _require(isinstance(body, (str, bytes)),
                 f"rule #{index}: 'body' must be a string")
        self.body = body.encode() if isinstance(body, str) else bytes(body)

        # deterministic per-rule decision stream: same plan -> same chaos
        self._rng = random.Random(f"{seed}:{index}:{self.site}:{self.kind}")
        self.hits = 0
        self.fired = 0

    def matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if not fnmatch.fnmatchcase(site, self.site):
            return False
        return all(str(ctx.get(k)) == v for k, v in self.match.items())

    def describe(self) -> str:
        extra = {
            "delay": f" seconds={self.seconds}",
            "stall": f" seconds={self.seconds}",
            "error": f" exception={self.exception.__name__}",
            "exit": f" code={self.code}",
            "truncate": (f" fraction={self.fraction}"
                         if self.fraction is not None else f" keep={self.keep}"),
            "http_status": f" status={self.status}",
        }.get(self.kind, "")
        times = "inf" if self.times is None else self.times
        return (f"#{self.index} site={self.site} kind={self.kind}{extra} "
                f"after={self.after} times={times} p={self.probability}"
                + (f" match={self.match}" if self.match else ""))


class FaultPlan:
    """Parsed plan + thread-safe firing state."""

    def __init__(self, spec: Any):
        if isinstance(spec, (str, bytes)):
            try:
                spec = json.loads(spec)
            except json.JSONDecodeError as exc:
                raise FaultPlanError(f"fault plan is not valid JSON: {exc}") \
                    from None
        _require(isinstance(spec, dict),
                 f"fault plan must be a JSON object, got {type(spec).__name__}")
        unknown = set(spec) - {"seed", "rules"}
        _require(not unknown,
                 f"fault plan: unknown top-level key(s) {sorted(unknown)}")
        self.seed = spec.get("seed", 0)
        rules = spec.get("rules", [])
        _require(isinstance(rules, list), "fault plan: 'rules' must be a list")
        self.rules: List[FaultRule] = [FaultRule(r, i, self.seed)
                                       for i, r in enumerate(rules)]
        self._lock = threading.Lock()
        # every fire, in order: (site, kind, rule index) — the in-process
        # ledger tests assert on (telemetry is the cross-process one)
        self.fired_log: List[Tuple[str, str, int]] = []

    def select(self, site: str, kinds: frozenset,
               ctx: Dict[str, Any]) -> Optional[FaultRule]:
        """First eligible matching rule, or None.  Every matching rule's hit
        counter advances (so ``after`` counts real traffic at the site even
        when an earlier rule fires for the same hit)."""
        chosen: Optional[FaultRule] = None
        with self._lock:
            for rule in self.rules:
                if rule.kind not in kinds or not rule.matches(site, ctx):
                    continue
                rule.hits += 1
                if chosen is not None:
                    continue
                if rule.hits <= rule.after:
                    continue
                if rule.times is not None and rule.fired >= rule.times:
                    continue
                if (rule.probability < 1.0
                        and rule._rng.random() >= rule.probability):
                    continue
                rule.fired += 1
                self.fired_log.append((site, rule.kind, rule.index))
                chosen = rule
        return chosen
