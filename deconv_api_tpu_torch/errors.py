"""The HTTP error taxonomy the slice serves (the codes of
``deconv_api_tpu/errors.py``): each error maps to a status and a
machine-readable code, served as ``{"error": code, "detail": message}``
(``to_payload`` adds the request id).  An error that carries
``retry_after_s`` is answered with a ``Retry-After`` header
(``retry_after_value``)."""

from __future__ import annotations

import math


class DeconvError(Exception):
    status = 500
    code = "internal_error"

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class BadRequest(DeconvError):
    status = 400
    code = "bad_request"


class InvalidImage(BadRequest):
    code = "invalid_image"


class UnknownLayer(DeconvError):
    status = 422
    code = "unknown_layer"


class UnknownModel(DeconvError):
    """The request names a model this server does not serve."""

    status = 422
    code = "unknown_model"


class IllegalMode(DeconvError):
    status = 422
    code = "illegal_visualize_mode"


class IllegalQuality(DeconvError):
    """The request's precision tier (``quality=`` form field or
    ``x-quality`` header) is none of full|bf16|int8."""

    status = 422
    code = "illegal_quality"


class NoActiveFilters(DeconvError):
    """No filter fired for the requested layer."""

    status = 422
    code = "no_active_filters"


class ModelNotReady(DeconvError):
    status = 503
    code = "model_not_ready"


class Overloaded(DeconvError):
    """The queue's drain estimate exceeds the request timeout: shed now with
    a 503 rather than make the caller wait out a certain 504
    (``serving/batcher.py:BatchingDispatcher.submit``).  Carries the drain
    estimate for the ``Retry-After`` header."""

    status = 503
    code = "overloaded"

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RequestTimeout(DeconvError):
    status = 504
    code = "request_timeout"


class Unavailable(DeconvError):
    """The dispatcher is shutting down, a worker pool has no live worker, or
    a model's weights could not be brought onto the device in time."""

    status = 503
    code = "unavailable"


class DeadlineExpired(DeconvError):
    """The request's own ``x-deadline-ms`` budget lapsed: queued work whose
    caller has given up is dropped before any device work."""

    status = 504
    code = "deadline_expired"


class BreakerOpen(DeconvError):
    """The device circuit breaker is open: requests fail fast with a
    ``Retry-After`` from the breaker's remaining cooldown."""

    status = 503
    code = "breaker_open"

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class JobQueueFull(DeconvError):
    """The async job queue is at capacity: 429 with a ``Retry-After`` from
    the queue depth and the running job cost (``serving/jobs.py``)."""

    status = 429
    code = "job_queue_full"

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class JobNotFound(DeconvError):
    """No such job id: never submitted, or compacted out after its
    retention window."""

    status = 404
    code = "job_not_found"


class UndurableWrite(DeconvError):
    """A fail-loud persistence surface could not make a pre-ack write
    durable (a job submit whose journal append cannot fsync): 503 with a
    ``Retry-After`` rather than a 202 the server cannot keep."""

    status = 503
    code = "undurable_write"

    def __init__(self, message: str, retry_after_s: float | None = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class TenantOverQuota(DeconvError):
    """A tenant exhausted one of its QoS budgets (``serving/qos.py``): the
    device-time token bucket or the in-flight cap.  429 with a
    ``Retry-After`` from the bucket's refill rate, and the tenant's name in
    the payload."""

    status = 429
    code = "tenant_over_quota"

    def __init__(self, message: str, retry_after_s: float | None = None, tenant: str | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.tenant = tenant


class BackendUnavailable(DeconvError):
    """The fleet router (``serving/fleet.py``) reached no backend for this
    request: the ring is empty, or the key's owner and its failover
    neighbour both failed at the transport.  502, the gateway speaking
    about its upstream (a backend's own 503 passes through untouched),
    with a ``Retry-After`` of the ejection cooldown."""

    status = 502
    code = "backend_unavailable"

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class FaultInjected(DeconvError):
    """An armed fault-injection site fired (``serving/faults.py``)."""

    status = 500
    code = "fault_injected"


def to_payload(e: DeconvError, request_id: str | None = None) -> dict:
    """The JSON error body of every route: the code and the detail, and the
    request id that joins it to the server's logs and traces; a quota
    error also names whose budget it hit."""
    payload = {"error": e.code, "detail": e.message}
    tenant = getattr(e, "tenant", None)
    if tenant:
        payload["tenant"] = tenant
    if request_id:
        payload["request_id"] = request_id
    return payload


def code_from_body(body: bytes) -> str | None:
    """The error code of a JSON error body, or None."""
    import json

    try:
        return json.loads(body).get("error")
    except (ValueError, AttributeError):
        return None


def retry_after_value(retry_after_s: float | None) -> str | None:
    """A ``Retry-After`` header value: whole seconds, at least 1; None for
    no header."""
    if not retry_after_s or retry_after_s <= 0:
        return None
    return str(max(1, math.ceil(retry_after_s)))
