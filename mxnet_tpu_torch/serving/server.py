"""Thin HTTP frontend over the registry + dynamic batcher (the port of
``mxnet_tpu/serving/server.py``).

Endpoints (TF-Serving-flavoured REST, JSON bodies):

- ``GET  /v1/models``                          — registry listing
- ``GET  /v1/models/<name>``                   — one model's description
- ``POST /v1/models/<name>:predict``           — latest version
- ``POST /v1/models/<name>/versions/<v>:predict``
      body: ``{"instances": [<item>, ...], "deadline_ms": <opt float>}``
      reply: ``{"predictions": [...], "model": ..., "version": ...}``
- ``POST /v1/models/<name>:generate`` and ``POST /v1/generate`` (the
      model in the body) — generation through an attached
      ``DecodeEngine``
- ``GET  /v1/stats``                           — metrics snapshot (JSON)
- ``GET  /metrics``                            — same counters/percentiles
      in Prometheus text exposition format (scrape target)
- ``GET  /healthz``                            — liveness: 200 whenever
      the HTTP loop answers (orchestrator restart probe)
- ``GET  /readyz``                             — readiness: 200 only with
      ≥1 loaded model and the batcher not draining, else 503 (load
      balancers stop routing BEFORE shutdown sheds requests)

Error mapping is 1:1 with the serving error taxonomy (``errors.py``):
400 bad payload, 404 unknown model, 503 shed/draining, 504 deadline —
the body carries ``{"error", "code"}`` so the Python client rehydrates
the exact exception class.

The HTTP layer is intentionally thin: every concurrency decision
(coalescing, shedding, deadlines) lives in the batcher, so in-process
callers and HTTP callers get identical semantics.

The JAX server's admin plane (``/v1/admin/load``, ``unload``,
``migrate_out``, ``set_role``: model hot-load by importable builder, the
fleet's rollout and role flips) needs the replica's sharding resolution
and the fleet, which the port has not reached: every ``/v1/admin/*``
route answers the JAX server's typed 404 for an unknown admin route.
"""
from __future__ import annotations

import json
import re
import threading
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as onp

from .batcher import DynamicBatcher
from .errors import (BadRequestError, DeadlineExceededError,
                     ModelNotFoundError, ServingError)
from .registry import ModelRegistry

__all__ = ["ModelServer"]

_PREDICT_RE = re.compile(
    r"^/v1/models/(?P<name>[^/:]+)(?:/versions/(?P<version>\d+))?:predict$")
_GENERATE_RE = re.compile(r"^/v1/models/(?P<name>[^/:]+):generate$")
_MODEL_RE = re.compile(r"^/v1/models/(?P<name>[^/:]+)$")


def _generate_only(name):
    """The batch function of a model that serves ``:generate`` alone."""
    def fn(batch_np):
        raise BadRequestError("model %r serves :generate only" % (name,))
    return fn


class ModelServer:
    """Own a registry + batcher and expose them over HTTP.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` after
    ``start()``).  ``stop(drain=True)`` is the graceful path: stop
    admissions, let queued requests finish, then shut the listener down.
    """

    def __init__(self, registry=None, *, host="127.0.0.1", port=0,
                 batcher=None, request_timeout_s=30.0, admin=False,
                 **batcher_kwargs):
        self.registry = registry if registry is not None else ModelRegistry()
        self.batcher = batcher if batcher is not None else DynamicBatcher(
            self.registry, **batcher_kwargs)
        self.metrics = self.batcher.metrics
        self.request_timeout_s = float(request_timeout_s)
        # admin=True asks for the JAX server's /v1/admin/* plane, which the
        # port has not reached (see _handle_admin)
        self.admin = bool(admin)
        self._host = host
        self._port = int(port)
        self._httpd = None
        self._thread = None

    # -- generation -------------------------------------------------------
    def attach_engine(self, name, engine):
        """Serve ``engine`` (a :class:`~.generate.DecodeEngine`) as
        ``name``'s generation path (``POST /v1/models/<name>:generate``
        and ``/v1/generate``).  The engine joins this server's metrics
        and drain lifecycle; the LM itself is listed in the registry so
        ``/v1/models`` shows what this replica serves."""
        if name not in self.registry:
            model = engine.model
            if not callable(model):
                # a QuantizedLM serves :generate only
                model = _generate_only(name)
            self.registry.load(name, model, item_shape=None,
                               dtype="int32", warmup=False)
        engine.name = name
        engine.warmup()  # build the kernels before taking traffic
        return self.batcher.register_engine(name, engine)

    # -- lifecycle --------------------------------------------------------
    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else self._port

    @property
    def address(self):
        return (self._host, self.port)

    def start(self):
        if self._httpd is not None:
            return self.address
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet: metrics are the log
                pass

            def _reply(self, status, payload, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_error(self, exc):
                status = getattr(exc, "http_status", 500)
                code = getattr(exc, "code", "internal")
                payload = {"error": str(exc), "code": code}
                # a shed reply reports the queue depth it saw, so the
                # fleet router can compute an honest aggregate
                # Retry-After from the drain estimate
                queued = getattr(exc, "queued", None)
                if queued is not None:
                    payload["queued"] = int(queued)
                headers = {}
                retry_after = getattr(exc, "retry_after", None)
                if retry_after is not None:
                    headers["Retry-After"] = "%g" % retry_after
                self._reply(status, payload, headers)

            def do_GET(self):
                try:
                    self._reply(*server._handle_get(self.path))
                except Exception as e:  # pragma: no cover - defensive
                    self._reply_error(e)

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n) if n else b""
                    self._reply(*server._handle_post(self.path, raw))
                except ServingError as e:
                    self._reply_error(e)
                except Exception as e:
                    self._reply_error(ServingError(
                        "%s: %s" % (type(e).__name__, e)))

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="mxt-serving-http",
                                        daemon=True)
        self._thread.start()
        return self.address

    def stop(self, drain=True, timeout=30.0):
        """Graceful shutdown: quiesce the batcher first (admissions fail
        503 while queued work completes), then stop the listener."""
        self.batcher.stop(drain=drain, timeout=timeout)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- request handling (transport-independent) -------------------------
    def _handle_get(self, path):
        if path == "/healthz":
            return 200, {"ok": True}
        if path == "/readyz":
            n_models = len(self.registry.models())
            draining = bool(getattr(self.batcher, "draining", False))
            ready = n_models > 0 and not draining
            return (200 if ready else 503), {
                "ready": ready, "models": n_models, "draining": draining}
        if path == "/v1/models":
            return 200, {"models": self.registry.models()}
        if path in ("/v1/stats", "/stats"):
            snap = self.metrics.snapshot()
            engines = {name: e.stats()
                       for name, e in self.batcher._engines.items()}
            if engines:
                snap["generators"] = engines
            # live (not counter-derived) queue depths: what the fleet
            # autoscaler's control loop aggregates each tick
            snap["queue_depths"] = {
                name: self.batcher.queue_depth(name)
                for name in list(self.batcher._queues)}
            return 200, snap
        if path == "/metrics":
            return 200, {"text": self._prometheus_text()}
        m = _MODEL_RE.match(path)
        if m:
            name = m.group("name")
            if name not in self.registry:
                raise ModelNotFoundError("no model %r" % (name,))
            return 200, self.registry.models()[name]
        raise ModelNotFoundError("no route %r" % (path,))

    def _handle_post(self, path, raw_body):
        if path.startswith("/v1/admin/"):
            return self._handle_admin(path, raw_body)
        m = _GENERATE_RE.match(path)
        if m or path == "/v1/generate":
            return self._handle_generate(m.group("name") if m else None,
                                         raw_body)
        m = _PREDICT_RE.match(path)
        if not m:
            raise ModelNotFoundError("no route %r" % (path,))
        name = m.group("name")
        version = int(m.group("version")) if m.group("version") else None
        try:
            body = json.loads(raw_body.decode() or "{}")
        except ValueError as e:
            raise BadRequestError("invalid JSON body: %s" % (e,))
        instances = body.get("instances")
        if instances is None and "data" in body:
            instances = [body["data"]]
        if not isinstance(instances, list) or not instances:
            raise BadRequestError(
                'body must carry "instances": [<item>, ...]')
        deadline_ms = body.get("deadline_ms")
        tier = body.get("tier")
        tenant = body.get("tenant")
        futures = [self.batcher.submit(name, inst, version=version,
                                       deadline_ms=deadline_ms,
                                       tier=tier, tenant=tenant)
                   for inst in instances]
        timeout = (float(deadline_ms) / 1e3 + 1.0 if deadline_ms is not None
                   else self.request_timeout_s)
        preds = []
        for f in futures:
            try:
                preds.append(onp.asarray(f.result(timeout=timeout)).tolist())
            except FutureTimeoutError:
                raise DeadlineExceededError(
                    "no response within %.1fs" % timeout)
        served = self.registry.get(name, version)
        return 200, {"predictions": preds, "model": name,
                     "version": served.version}

    def _handle_generate(self, name, raw_body):
        """``POST /v1/models/<name>:generate`` (or ``/v1/generate`` with
        ``"model"`` in the body): autoregressive generation through the
        model's continuous-batching decode engine.

        Body: ``{"prompt": [token ids], "max_tokens": n,
        "deadline_ms": opt, "session": opt id, "resume": opt bool}``.
        ``session`` parks the KV pages for a follow-up call (pass the
        session as the router ``affinity_key`` so the fleet returns to
        the replica that holds them); ``resume=true`` makes a missing
        session a typed 409 ``session_reset`` instead of a silent
        fresh start."""
        try:
            body = json.loads(raw_body.decode() or "{}")
        except ValueError as e:
            raise BadRequestError("invalid JSON body: %s" % (e,))
        if name is None:
            name = body.get("model")
            if not name:
                raise BadRequestError(
                    '/v1/generate body must carry "model"')
        prompt = body.get("prompt")
        resume = bool(body.get("resume", False))
        if not isinstance(prompt, list) or (
                not prompt and not (resume and body.get("session"))):
            # an empty prompt is legal only as a resume continuation —
            # the disaggregated decode phase: "keep generating from the
            # migrated session, nothing new to prefill"
            raise BadRequestError(
                'generate body must carry "prompt": [token ids]')
        deadline_ms = body.get("deadline_ms")
        future = self.batcher.submit_generate(
            name, prompt,
            max_new_tokens=body.get("max_tokens", 16),
            deadline_ms=deadline_ms,
            session=body.get("session"),
            resume=resume,
            tier=body.get("tier"),
            tenant=body.get("tenant"))
        timeout = (float(deadline_ms) / 1e3 + 1.0 if deadline_ms is not None
                   else self.request_timeout_s)
        try:
            result = future.result(timeout=timeout)
        except FutureTimeoutError:
            raise DeadlineExceededError("no response within %.1fs" % timeout)
        result = dict(result)
        result["model"] = name
        return 200, result

    def _handle_admin(self, path, raw_body):
        """The admin plane: refused as the JAX server refuses an admin
        route it does not have (``ModelNotFoundError``, 404 ``not_found``).
        Model hot-load, unload, session migration and role flips need
        ``replica.resolve_sharding`` and the fleet (ROADMAP Queue 1, item
        6), which the port has not reached."""
        if not self.admin:
            raise ModelNotFoundError(
                "admin API disabled on this server (ModelServer(admin="
                "True) — replica processes enable it)")
        raise ModelNotFoundError("no admin route %r" % (path,))

    def _prometheus_text(self):
        """Counters + percentiles in Prometheus exposition format."""
        snap = self.metrics.snapshot()
        replica = snap.get("replica")
        lines = []
        for model, stats in sorted(snap["models"].items()):
            labels = 'model="%s"' % model
            if replica is not None:
                labels += ',replica="%s"' % replica
            for cname, v in sorted(stats["counters"].items()):
                lines.append("mxtpu_serving_%s{%s} %d" % (cname, labels, v))
            occ = stats.get("batch_occupancy")
            if occ is not None:
                lines.append("mxtpu_serving_batch_occupancy{%s} %g"
                             % (labels, occ))
            for hist in ("queue_wait", "device", "total"):
                h = stats.get(hist) or {}
                for k, v in sorted(h.items()):
                    if k == "count":
                        continue
                    lines.append("mxtpu_serving_%s_%s{%s} %g"
                                 % (hist, k, labels, v))
            gen = stats.get("generate")
            if gen:
                for hist in ("ttft", "inter_token", "decode_step",
                             "tokens_per_step", "host_gap_us",
                             "dispatch_depth"):
                    for k, v in sorted((gen.get(hist) or {}).items()):
                        if k == "count":
                            continue
                        lines.append("mxtpu_serving_%s_%s{%s} %g"
                                     % (hist, k, labels, v))
                # (kv_tokens_resident / kv_bytes_per_token ride the
                # kv_cache loop below — one sample per name)
                for gauge in ("tokens_per_s", "decode_occupancy",
                              "kv_occupancy"):
                    if gen.get(gauge) is not None:
                        lines.append("mxtpu_serving_%s{%s} %g"
                                     % (gauge, labels, gen[gauge]))
                spec = gen.get("speculative")
                if spec:
                    for hist in ("draft_step", "verify_step"):
                        for k, v in sorted((spec.get(hist) or {}).items()):
                            if k == "count":
                                continue
                            lines.append("mxtpu_serving_spec_%s_%s{%s} %g"
                                         % (hist, k, labels, v))
                    if spec.get("accepted_token_rate") is not None:
                        lines.append(
                            "mxtpu_serving_accepted_token_rate{%s} %g"
                            % (labels, spec["accepted_token_rate"]))
                for k, v in sorted((gen.get("kv_cache") or {}).items()):
                    # used/total/peak_used/shared/leaked page gauges —
                    # leaked_pages nonzero is the alert condition
                    lines.append("mxtpu_serving_kv_%s{%s} %g"
                                 % (k, labels, v))
        return "\n".join(lines) + "\n"
