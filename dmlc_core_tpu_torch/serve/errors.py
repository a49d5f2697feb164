"""Structured serving errors: every failure a client can see has a shape.

Counterpart of ``dmlc_core_tpu/serve/errors.py`` (a copy): the same codes,
statuses and JSON envelopes.  The serving contract is that a request **completes, is shed,
or is rejected** — never dropped on the floor with a bare traceback.  Each
error here maps to one HTTP status and renders as one JSON envelope::

    {"error": {"code": "overloaded", "message": "...", "retry_after": 2}}

so load generators, retry layers, and humans all parse the same thing.
``Overloaded`` / ``PredictFailed`` are the two *shed* forms (503 + a
Retry-After the client is expected to honor); ``BadRequest``
is the caller's bug (400, retrying is pointless); ``RequestTimeout`` (504)
means the request was admitted but its deadline elapsed in the queue or in
predict.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

__all__ = ["ServeError", "BadRequest", "ClientTimeout", "Overloaded",
           "PredictFailed", "RequestTimeout", "UnknownModel",
           "UpstreamFailed"]


class ServeError(Exception):
    """Base: carries the HTTP status, a stable machine code, and details."""

    status = 500
    code = "internal"

    def __init__(self, message: str, *,
                 retry_after: Optional[float] = None,
                 details: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.message = message
        self.retry_after = retry_after
        self.details = details or {}

    def payload(self) -> Dict[str, Any]:
        err: Dict[str, Any] = {"code": self.code, "message": self.message}
        if self.retry_after is not None:
            # integer seconds: the delta-seconds form every Retry-After
            # parser accepts
            err["retry_after"] = max(1, int(round(self.retry_after)))
        if self.details:
            err["details"] = self.details
        return {"error": err}

    def body(self) -> bytes:
        return json.dumps(self.payload(), sort_keys=True).encode("utf-8")

    def headers(self) -> Dict[str, str]:
        hdrs = {"Content-Type": "application/json"}
        if self.retry_after is not None:
            hdrs["Retry-After"] = str(max(1, int(round(self.retry_after))))
        return hdrs


class BadRequest(ServeError):
    """The request body cannot mean what its author intended (400)."""

    status = 400
    code = "bad_request"


class Overloaded(ServeError):
    """Admission control shed this request before queueing it (503)."""

    status = 503
    code = "overloaded"

    def __init__(self, message: str, *, retry_after: float = 1.0,
                 details: Optional[Dict[str, Any]] = None):
        super().__init__(message, retry_after=retry_after, details=details)


class PredictFailed(ServeError):
    """The batch this request rode in failed in predict; the request was
    not computed and the client should retry (503 — a shed, not a crash:
    the server is alive and the next batch is expected to succeed)."""

    status = 503
    code = "predict_failed"

    def __init__(self, message: str, *, retry_after: float = 1.0,
                 details: Optional[Dict[str, Any]] = None):
        super().__init__(message, retry_after=retry_after, details=details)


class RequestTimeout(ServeError):
    """Admitted but not answered within the request deadline (504)."""

    status = 504
    code = "timeout"


class ClientTimeout(ServeError):
    """The client failed to deliver its request bytes within the
    transport's assembly deadline (408) — the event-loop transport's
    slowloris / stalled-body defense (``DMLC_SERVE_HEADER_S``).  The
    connection is closed after this envelope is written: a half-delivered
    request leaves no framing to recover.  The threaded transport's
    equivalent is a silent per-socket timeout close; a structured 408 is
    strictly more diagnosable."""

    status = 408
    code = "client_timeout"


class UpstreamFailed(ServeError):
    """The router forwarded this request to a replica that failed after
    response bytes were read (or after the no-replay point) — the body is
    never replayed, so the client gets a structured 503 shed and retries
    itself (scoring is idempotent end-to-end, the router just refuses to
    guess whether a half-answered request was scored)."""

    status = 503
    code = "replica_failed"

    def __init__(self, message: str, *, retry_after: float = 1.0,
                 details: Optional[Dict[str, Any]] = None):
        super().__init__(message, retry_after=retry_after, details=details)


class UnknownModel(ServeError):
    """``/v1/score/<model>`` named a model no slot serves (404 — the
    details list what IS registered, so a mis-deployed client can see
    its routing bug without server logs)."""

    status = 404
    code = "unknown_model"
