"""Python client for the serving HTTP frontend (the port of
``mxnet_tpu/serving/client.py``).

Stdlib-only (http.client): one persistent connection per client object,
JSON request/response, server error codes rehydrated into the same
exception classes the in-process API raises (``QueueFullError`` on shed,
``DeadlineExceededError`` on expiry, ...), so calling code is identical
whether it talks to the batcher directly or over the wire.

Transport resilience: connect failures and connection resets retry with bounded
exponential backoff + jitter (``MXNET_SERVING_RETRIES`` /
``MXNET_SERVING_BACKOFF_MS``) — but ONLY for requests the server cannot
have processed: refusals, and errors raised while sending.  A failure
after the request reached the server retries only for idempotent GETs;
a non-idempotent ``:predict`` whose reply was lost surfaces the error
(re-sending could double-run it)."""
from __future__ import annotations

import http.client
import json
import os
import random
import time

import numpy as onp

from .. import config as _config
from .errors import ServingError, SessionResetError, error_for_code

__all__ = ["ServingClient"]


class ServingClient:
    def __init__(self, host="127.0.0.1", port=8080, timeout=30.0,
                 retries=None, backoff_ms=None):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self.retries = max(0, int(retries if retries is not None
                                  else _config.get("MXNET_SERVING_RETRIES")))
        self.backoff_ms = max(1.0, float(
            backoff_ms if backoff_ms is not None
            else _config.get("MXNET_SERVING_BACKOFF_MS")))
        # jitter decorrelates retry storms across clients; never affects
        # payloads, so a non-deterministic seed is fine
        self._jitter = random.Random(os.getpid() ^ id(self))
        self._conn = None
        # (model, session) -> full token transcript (prompts + replies),
        # the client-side replay recipe behind resume_on_reset
        self._transcripts = {}

    # -- plumbing ---------------------------------------------------------
    def _connection(self):
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        return self._conn

    def _request(self, method, path, body=None, retries=None):
        payload = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if payload else {}
        retries = self.retries if retries is None else retries
        last = None
        for attempt in range(retries + 1):
            phase = "send"
            try:
                conn = self._connection()
                conn.request(method, path, body=payload, headers=headers)
                phase = "recv"
                resp = conn.getresponse()
                data = resp.read()
                break
            except (ConnectionError, http.client.HTTPException,
                    OSError) as e:
                self.close()  # a broken keep-alive stream never reuses
                last = e
                # not-yet-sent only: a refusal or a send-phase failure
                # means the server never processed the request; a
                # recv-phase loss retries only for idempotent GETs
                retryable = (isinstance(e, ConnectionRefusedError)
                             or phase == "send" or method == "GET")
                if attempt >= retries or not retryable:
                    raise
                time.sleep(self.backoff_ms / 1e3 * (2 ** attempt)
                           * (0.5 + self._jitter.random()))
        else:  # pragma: no cover — loop always breaks or raises
            raise last
        try:
            doc = json.loads(data.decode() or "{}")
        except ValueError:
            doc = {"error": data.decode(errors="replace"), "code": "internal"}
        if resp.status >= 400:
            exc = error_for_code(doc.get("code", "internal"),
                                 doc.get("error", "HTTP %d" % resp.status))
            retry_after = resp.getheader("Retry-After")
            if retry_after is not None:
                try:  # a router-level shed says when to come back
                    exc.retry_after = float(retry_after)
                except ValueError:
                    pass
            raise exc
        return doc

    def close(self):
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- API --------------------------------------------------------------
    def predict(self, model, data, version=None, deadline_ms=None,
                affinity_key=None, idempotent=None, tier=None,
                tenant=None):
        """Run inference on a BATCH: ``data`` is a list of instances or
        an array whose leading axis is the batch (each instance must have
        the model's item shape — wrap a single item in a length-1 list).
        Returns a numpy array with the batch axis first.

        Fleet-router hints (ignored by a single ModelServer):
        ``affinity_key`` steers consistent-hash dispatch (cache
        affinity); ``idempotent=False`` forbids the router from failing
        the request over to another replica after it may have executed."""
        if isinstance(data, (list, tuple)):
            instances = [onp.asarray(d).tolist() for d in data]
        else:
            arr = onp.asarray(data)
            if arr.ndim == 0:
                raise ServingError("scalar input has no batch axis")
            instances = [row.tolist() for row in arr]
        path = ("/v1/models/%s:predict" % model if version is None
                else "/v1/models/%s/versions/%d:predict" % (model, version))
        body = {"instances": instances}
        if deadline_ms is not None:
            body["deadline_ms"] = float(deadline_ms)
        if affinity_key is not None:
            body["affinity_key"] = str(affinity_key)
        if idempotent is not None:
            body["idempotent"] = bool(idempotent)
        if tier is not None:
            body["tier"] = str(tier)
        if tenant is not None:
            body["tenant"] = str(tenant)
        doc = self._request("POST", path, body)
        return onp.asarray(doc["predictions"])

    def generate(self, model, prompt, max_tokens=16, *, session=None,
                 resume=False, resume_on_reset=False, deadline_ms=None,
                 tier=None, tenant=None):
        """Autoregressive generation: ``prompt`` is a list of token ids;
        returns the server's result dict (``tokens``, ``finish_reason``,
        token counts).

        ``session`` keeps the KV cache parked server-side for follow-up
        calls; it is sent as the fleet router's ``affinity_key`` so a
        multi-call session sticks to the replica holding its pages, and
        marks the request non-idempotent (a mid-flight failover must not
        double-advance the session).  ``resume=True`` demands the
        session exist — a replica that lost it answers with the typed
        :class:`~.errors.SessionResetError` (409) and the caller
        restarts generation from the full prompt.

        ``resume_on_reset=True`` makes that restart transparent: the
        client accumulates the session's transcript (every prompt and
        every reply) and, on a 409, replays it ONCE as a fresh prompt
        under the same session id — one attempt, still non-idempotent
        (the reset reply proves the server did not advance the session,
        so the replay cannot double-run anything; a second consecutive
        409 surfaces)."""
        prompt = [int(t) for t in prompt]
        skey = (model, str(session)) if session is not None else None
        hist = list(self._transcripts.get(skey, ())) if skey else []
        body = {"prompt": prompt, "max_tokens": int(max_tokens)}
        if deadline_ms is not None:
            body["deadline_ms"] = float(deadline_ms)
        if tier is not None:
            body["tier"] = str(tier)
        if tenant is not None:
            body["tenant"] = str(tenant)
        if session is not None:
            body["session"] = str(session)
            body["affinity_key"] = str(session)
            body["idempotent"] = False
            body["resume"] = bool(resume)
        path = "/v1/models/%s:generate" % model
        try:
            doc = self._request("POST", path, body)
        except SessionResetError:
            if not (resume_on_reset and skey):
                raise
            # the server lost the session but processed nothing: replay
            # the whole transcript + this turn as a fresh prompt
            body = dict(body, prompt=hist + prompt, resume=False)
            doc = self._request("POST", path, body)
        if skey:
            self._transcripts[skey] = (hist + prompt
                                       + [int(t) for t in
                                          doc.get("tokens", ())])
        return doc

    def server_alive(self):
        """Liveness probe: one /healthz round trip, no retries — True iff
        a server is answering at (host, port)."""
        try:
            return bool(self._request("GET", "/healthz",
                                      retries=0).get("ok"))
        except (ServingError, OSError, http.client.HTTPException):
            return False

    def server_ready(self):
        """Readiness probe: True iff /readyz reports ≥1 loaded model and
        a non-draining batcher (503 → False, unreachable → False)."""
        try:
            return bool(self._request("GET", "/readyz").get("ready"))
        except (ServingError, OSError, http.client.HTTPException):
            return False

    def models(self):
        return self._request("GET", "/v1/models")["models"]

    def model(self, name):
        return self._request("GET", "/v1/models/%s" % name)

    def stats(self):
        """The scrapeable metrics snapshot (counters, batch occupancy,
        p50/p95/p99 queue-wait & service latencies)."""
        return self._request("GET", "/v1/stats")

    def metrics_text(self):
        """Prometheus exposition text."""
        return self._request("GET", "/metrics")["text"]
