"""Typed serving errors: every way a request can fail maps to one exception
class with a stable ``code``. Counterpart of ``hydragnn_tpu/serve/errors.py``.
Admission failures raise from ``GraphServer.submit``; in-flight failures
arrive on the request's ``PredictionHandle``; the fleet's router and wire
codec (serve/router.py, serve/wire.py) carry the same codes between
processes and rebuild the typed error from its code (``error_from_code``)."""

from __future__ import annotations

from typing import Optional


class ServeError(RuntimeError):
    """Base class of every serving error."""

    code = "serve_error"


class RequestError(ServeError):
    """A failure of exactly one request (its co-batched neighbors are not
    affected)."""

    code = "request_error"

    def __init__(self, message: str, request_id: Optional[int] = None):
        super().__init__(message)
        self.request_id = request_id


class InvalidRequestError(RequestError):
    """The request graph failed admission validation (``reason`` is the
    validator's rejection key)."""

    code = "invalid_request"

    def __init__(self, message: str, request_id: Optional[int] = None,
                 reason: Optional[str] = None):
        super().__init__(message, request_id)
        self.reason = reason


class QueueFullError(RequestError):
    """The admission queue is at ``Serving.max_queue_requests``."""

    code = "queue_full"


class SheddedError(RequestError):
    """The projected queue wait exceeded ``Serving.slo_p99_s``."""

    code = "shed"

    def __init__(self, message: str, request_id: Optional[int] = None,
                 projected_wait_s: float = 0.0, slo_s: float = 0.0):
        super().__init__(message, request_id)
        self.projected_wait_s = projected_wait_s
        self.slo_s = slo_s


class DeadlineExceededError(RequestError):
    """The request's deadline expired while it was queued."""

    code = "deadline_exceeded"


class ServerDrainingError(RequestError):
    """The server is draining: no new admissions."""

    code = "draining"


class ServerClosedError(RequestError):
    """The server is closed, or its warm-up failed."""

    code = "closed"


class WedgedStepError(RequestError):
    """The device step serving this request's batch exceeded
    ``Serving.step_timeout_s``. The batch's requests fail with this bounded
    error and the server takes a fresh step runner rather than hang every
    later request behind a wedged step."""

    code = "wedged_step"


class ReplicaUnavailableError(RequestError):
    """A fleet replica could not take the request at the transport level
    (connection refused or reset, the process died mid-request, a
    non-protocol failure of its /predict). Retryable on another replica:
    the request never entered a device batch."""

    code = "replica_unavailable"


class BreakerOpenError(RequestError):
    """The target replica's circuit breaker is open; raised to callers only
    when every candidate replica is broken or benched."""

    code = "breaker_open"


class NoReplicasError(RequestError):
    """The router exhausted its retries without a replica that could serve
    the request; ``attempts`` holds each attempt's failure code."""

    code = "no_replicas"

    def __init__(self, message: str, request_id: Optional[int] = None,
                 attempts: Optional[list] = None):
        super().__init__(message, request_id)
        self.attempts = list(attempts or [])


#: stable code -> class (append-only: the wire codec and remote clients
#: rebuild typed errors from these codes)
ERROR_CODES = {
    cls.code: cls
    for cls in (ServeError, RequestError, InvalidRequestError, QueueFullError,
                SheddedError, DeadlineExceededError, WedgedStepError,
                ServerDrainingError, ServerClosedError, ReplicaUnavailableError,
                BreakerOpenError, NoReplicasError)
}

#: codes safe to retry on another replica: the request provably had no
#: effect on the failing one. ``shed`` and ``queue_full`` are backpressure
#: (retrying elsewhere amplifies an overload), ``invalid_request`` fails the
#: same way everywhere.
RETRYABLE_CODES = frozenset((
    ReplicaUnavailableError.code,
    ServerDrainingError.code,
    ServerClosedError.code,
    WedgedStepError.code,
    BreakerOpenError.code,
))


def error_from_code(code: str, message: str) -> ServeError:
    """The typed serving error of a stable wire code; an unknown code (a
    newer server than client) degrades to ``ServeError``."""
    cls = ERROR_CODES.get(code, ServeError)
    try:
        return cls(message)
    except TypeError:  # every current class takes (message)
        return ServeError(message)
