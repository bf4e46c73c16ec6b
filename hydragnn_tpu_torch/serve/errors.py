"""Typed serving errors: every way a request can fail maps to one exception
class with a stable ``code``. Counterpart of ``hydragnn_tpu/serve/errors.py``
for the single-server slice (the fleet's replica/breaker codes come with the
fleet). Admission failures raise from ``GraphServer.submit``; in-flight
failures arrive on the request's ``PredictionHandle``."""

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


ERROR_CODES = {
    cls.code: cls
    for cls in (ServeError, RequestError, InvalidRequestError, QueueFullError,
                SheddedError, DeadlineExceededError, ServerDrainingError,
                ServerClosedError, WedgedStepError)
}
