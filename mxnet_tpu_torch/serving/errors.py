"""Serving-layer error taxonomy (a copy of ``mxnet_tpu/serving/errors.py``).

Every error carries an ``http_status`` (the frontend maps it 1:1 onto the
response code) and a stable ``code`` string (the client maps it back to
the same exception class on the other side of the wire), identical to
the JAX package's so that both packages speak one wire vocabulary.

A failed request poisons ONLY its own future and rethrows at
``future.result()`` — the engine worker survives and keeps serving.
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for all mxnet_tpu_torch.serving errors."""
    http_status = 500
    code = "internal"


class BadRequestError(ServingError):
    """Malformed request payload (shape/dtype/JSON)."""
    http_status = 400
    code = "bad_request"


class ModelNotFoundError(ServingError):
    """Unknown model name or version in the registry."""
    http_status = 404
    code = "model_not_found"


class QueueFullError(ServingError):
    """Load shed: the model's request queue is at max depth.  Raised
    synchronously at submit() — fast-fail 503, never unbounded latency.
    ``queued`` (when known) carries the queue depth observed at shed
    time; the router aggregates it across shedding replicas to compute
    an honest ``Retry-After`` from the fleet's drain estimate."""
    http_status = 503
    code = "queue_full"

    def __init__(self, message, queued=None):
        super().__init__(message)
        self.queued = queued


class DeadlineInfeasibleError(ServingError):
    """SLO-aware admission shed: at the current observed service rate
    the queue ahead of this request drains AFTER its deadline, so
    admitting it would only burn capacity on a guaranteed 504.  Sheds
    synchronously at submit with ``retry_after`` = the queue drain
    estimate — the honest earliest time a retry could succeed."""
    http_status = 503
    code = "deadline_infeasible"

    def __init__(self, message, retry_after=None):
        super().__init__(message)
        if retry_after is not None:
            self.retry_after = retry_after


class ServerClosedError(ServingError):
    """The batcher/server is draining or stopped; no new admissions."""
    http_status = 503
    code = "server_closed"


class DeadlineExceededError(ServingError):
    """The request's deadline expired before it could be served."""
    http_status = 504
    code = "deadline_exceeded"


class SessionResetError(ServingError):
    """A generation request tried to RESUME a decode session this
    replica does not hold (the replica restarted, was ejected and the
    ring remapped the key, or the session expired) — the KV pages are
    gone, so silently continuing would decode against an empty cache.
    409: the client restarts generation from the full prompt."""
    http_status = 409
    code = "session_reset"


class KVLeakError(ServingError):
    """The page allocator's conservation invariant broke: a page is
    missing from (or duplicated across) the free list and the owner
    lists, or the scratch page escaped into circulation.  Carries the
    offending page ids in ``pages`` — this is a serving bug, not a
    client error, so it maps to 500."""
    http_status = 500
    code = "kv_leak"

    def __init__(self, message, pages=()):
        super().__init__(message)
        self.pages = sorted(pages)


class FleetUnavailableError(ServingError):
    """The fleet router has no routable replica for this request (all
    ejected/unready/failed).  503 with Retry-After: the condition is
    expected to clear once the supervisor restarts replicas and probes
    re-admit them."""
    http_status = 503
    code = "fleet_unavailable"


class RolloutAbortedError(ServingError):
    """A rolling model rollout was aborted (canary error rate or tail
    latency regressed past the configured threshold) and rolled back."""
    http_status = 500
    code = "rollout_aborted"


#: code string -> exception class (client-side rehydration)
CODE_TO_ERROR = {
    cls.code: cls
    for cls in (ServingError, BadRequestError, ModelNotFoundError,
                QueueFullError, ServerClosedError, DeadlineExceededError,
                DeadlineInfeasibleError, SessionResetError, KVLeakError,
                FleetUnavailableError, RolloutAbortedError)
}


def error_for_code(code, message):
    """Rebuild the server-side exception class from its wire code."""
    return CODE_TO_ERROR.get(code, ServingError)(message)
