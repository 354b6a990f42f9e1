"""Dynamic batcher: per-model request queues with coalescing dispatch
(the port of ``mxnet_tpu/serving/batcher.py``).

Request lifecycle:

- ``submit()`` validates the item against the served model's signature
  and enqueues it.  Admission control is synchronous: a full queue sheds
  the request with ``QueueFullError`` (fast-fail 503) instead of letting
  latency grow without bound; a draining batcher rejects with
  ``ServerClosedError``.
- One worker thread per model coalesces requests that share a shape
  bucket key ``(pinned_version, item_shape, dtype)``, flushing a batch
  when it reaches the model's max batch size OR when the oldest request
  has waited ``flush_ms`` — the classic size-or-timeout policy
  (Clipper / TF-Serving style) that trades a bounded latency floor for
  hardware-limited throughput.
- The batch is padded to the model's enclosing batch bucket (a few
  shapes per model, see ``registry.py``) and results are fanned back out
  to per-request futures.
- Generation requests go to the model's ``DecodeEngine``
  (``register_engine``/``submit_generate``) under the same admission,
  deadline and drain policy.

Failure isolation: an exception poisons only its own request's future
and rethrows at ``future.result()``, never killing the worker.  A batch
that raises is re-executed per request so ONLY the poisoned request's
future carries the exception; every other request in the batch still
gets its result, and the worker thread keeps serving.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as onp

from .autoscale import SLOPolicy
from .errors import (DeadlineExceededError, ModelNotFoundError,
                     QueueFullError, ServerClosedError)
from .metrics import ServingMetrics

__all__ = ["DynamicBatcher"]


class _Request:
    __slots__ = ("item", "future", "t_enqueue", "deadline", "version",
                 "tier", "tenant", "rank", "vstart")

    def __init__(self, item, version, deadline, tier="latency",
                 tenant=None, rank=0, vstart=0.0):
        self.item = item
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline  # absolute perf_counter time or None
        self.version = version    # pinned version or None (= latest)
        self.tier = tier          # "latency" | "bulk" (SLO class)
        self.tenant = tenant
        self.rank = rank          # tier priority (0 = latency, first)
        self.vstart = vstart      # weighted-fair-queueing start tag

    @property
    def sort_key(self):
        return (self.rank, self.vstart)

    def expired(self, now):
        return self.deadline is not None and now > self.deadline


class DynamicBatcher:
    """Coalesce concurrent single-item requests into bucketed batches.

    Knobs:
      flush_ms        — max time the oldest queued request waits for the
                        batch to fill before a partial batch dispatches.
      max_queue_depth — per-model bound on queued requests; admission
                        beyond it sheds with ``QueueFullError``.
      max_batch_size  — per-model cap (defaults to the served model's
                        largest bucket; the smaller of the two wins).
    """

    def __init__(self, registry, *, flush_ms=5.0, max_queue_depth=256,
                 max_batch_size=None, metrics=None, slo=None):
        self.registry = registry
        self.flush_s = float(flush_ms) / 1e3
        self.max_queue_depth = int(max_queue_depth)
        self._max_batch_override = max_batch_size
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # one SLO policy per replica (shared with registered engines):
        # tier classification, weighted-fair tenant tags, and the
        # service-rate estimate behind deadline-infeasibility shedding
        self.slo = slo if slo is not None else SLOPolicy()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues = {}   # model -> {key: sorted list[_Request]}
        self._depth = {}    # model -> queued request count
        self._workers = {}  # model -> Thread
        self._engines = {}  # model -> DecodeEngine (generation path)
        self._stopping = False

    @property
    def draining(self):
        """True once stop()/drain() began: admissions are rejected while
        queued work completes (the /readyz "not ready" signal)."""
        return self._stopping

    # -- admission --------------------------------------------------------
    @staticmethod
    def _insert(q, req):
        """Priority insertion: queues stay sorted by ``(rank, vstart)``
        — latency tier strictly before bulk, weighted-fair within a
        tier.  All-default traffic degenerates to an append (FIFO)."""
        i = len(q)
        while i > 0 and q[i - 1].sort_key > req.sort_key:
            i -= 1
        q.insert(i, req)

    def _evict_bulk_locked(self, model):
        """Degradation ladder rung 1: a full queue admits a latency-tier
        request by evicting the NEWEST bulk-tier one (typed 503 — it
        retries later; the latency SLO is protected now).  Returns True
        when a victim was found."""
        victim = victim_q = None
        for q in (self._queues.get(model) or {}).values():
            for r in q:
                if r.rank > 0 and (victim is None
                                   or r.vstart > victim.vstart):
                    victim, victim_q = r, q
        if victim is None:
            return False
        victim_q.remove(victim)
        self._depth[model] -= 1
        self.metrics.count(model, "shed_total")
        self.metrics.count(model, "bulk_evicted_total")
        victim.future.set_exception(QueueFullError(
            "bulk-tier request evicted to admit a latency-tier one "
            "(queue at max_queue_depth=%d)" % self.max_queue_depth,
            queued=self._depth.get(model, 0)))
        return True

    def submit(self, model, item, *, version=None, deadline_ms=None,
               tier=None, tenant=None):
        """Enqueue one item; returns a ``concurrent.futures.Future`` that
        resolves to the model output for this item (the exception
        transport: a failed/shed/expired request rethrows at
        ``future.result()``).

        ``tier`` ("latency"|"bulk") and ``tenant`` drive SLO-aware
        admission: bulk is evicted first under overload, tenants share
        capacity by their configured weights, and a deadline that
        provably cannot be met at the observed service rate sheds
        synchronously (``DeadlineInfeasibleError``)."""
        served = self.registry.get(model, version)  # ModelNotFound early
        rank, vstart = self.slo.stamp(tier, tenant)  # BadRequest early
        arr = served.check_item(item)               # BadRequest early
        self.metrics.count(model, "requests_total")
        deadline = (time.perf_counter() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        req = _Request(arr, version, deadline,
                       tier=self.slo.normalize_tier(tier), tenant=tenant,
                       rank=rank, vstart=vstart)
        key = (version, tuple(arr.shape), str(arr.dtype))
        with self._cond:
            if self._stopping:
                self.metrics.count(model, "shed_total")
                raise ServerClosedError(
                    "batcher is draining; not accepting new requests")
            depth = self._depth.get(model, 0)
            if depth >= self.max_queue_depth:
                # a latency-tier arrival evicts the newest bulk request
                # instead of being shed itself (bulk sheds first)
                if req.rank > 0 or not self._evict_bulk_locked(model):
                    self.metrics.count(model, "shed_total")
                    raise QueueFullError(
                        "model %r queue full (%d queued >= "
                        "max_queue_depth=%d)"
                        % (model, depth, self.max_queue_depth),
                        queued=depth)
                depth = self._depth.get(model, 0)
            if deadline_ms is not None and depth:
                # rung 2: provably-late requests shed at admission with
                # an honest drain estimate (no-op while the rate
                # estimator is cold)
                try:
                    self.slo.check_deadline(depth,
                                            float(deadline_ms) / 1e3)
                except Exception:
                    self.metrics.count(model, "shed_total")
                    self.metrics.count(model, "infeasible_shed_total")
                    raise
            self._insert(self._queues.setdefault(model, {}).setdefault(
                key, []), req)
            self._depth[model] = depth + 1
            if model not in self._workers:
                t = threading.Thread(target=self._worker, args=(model,),
                                     name="mxt-serving-%s" % model,
                                     daemon=True)
                self._workers[model] = t
                t.start()
            self._cond.notify_all()
        self.metrics.observe_queue_depth(model, depth + 1)
        return req.future

    def queue_depth(self, model):
        with self._lock:
            return self._depth.get(model, 0)

    # -- generation (continuous-batching decode engines) ------------------
    def register_engine(self, model, engine):
        """Attach a :class:`~.generate.DecodeEngine` as ``model``'s
        generation path.  The engine inherits this batcher's metrics and
        queue-depth bound, and drains/stops with it — one admission
        policy for both request kinds."""
        engine.metrics = self.metrics
        engine.max_queue_depth = self.max_queue_depth
        engine.slo = self.slo  # one fairness/shed regime per replica
        with self._cond:
            self._engines[model] = engine
        return engine

    def engine(self, model):
        with self._cond:
            return self._engines.get(model)

    def submit_generate(self, model, prompt, **kwargs):
        """Admit one generation request through the same
        deadline/load-shed/drain machinery as ``submit()``: a draining
        batcher refuses (``ServerClosedError``), a full engine queue
        sheds (``QueueFullError``), deadlines expire typed.  Returns the
        engine future."""
        with self._cond:
            if self._stopping:
                self.metrics.count(model, "shed_total")
                raise ServerClosedError(
                    "batcher is draining; not accepting new requests")
            engine = self._engines.get(model)
        if engine is None:
            raise ModelNotFoundError(
                "model %r has no generation engine (have: %s)"
                % (model, sorted(self._engines)))
        return engine.submit(prompt, **kwargs)

    # -- worker -----------------------------------------------------------
    def _max_batch(self, served):
        if self._max_batch_override is not None:
            return min(int(self._max_batch_override), served.max_batch_size)
        return served.max_batch_size

    def _worker(self, model):
        while True:
            batch = self._collect(model)
            if batch is None:
                return  # stopped and drained
            if batch:
                self._execute(model, batch)

    def _collect(self, model):
        """Block until a batch is ready for ``model``; pop and return it.
        Returns None when the batcher is stopping and the queue is empty,
        [] when a wait loop ended with nothing dispatchable (retry)."""
        with self._cond:
            while True:
                queues = self._queues.get(model) or {}
                if queues:
                    break
                if self._stopping:
                    return None
                self._cond.wait()
            # serve the shape key whose head request sorts first under
            # the SLO order — latency tier before bulk, weighted-fair
            # start tags within a tier (pure FIFO for untiered traffic)
            key = min(queues, key=lambda k: queues[k][0].sort_key)
            q = queues[key]
            try:
                served = self.registry.get(model, key[0])
            except Exception as e:
                # model unloaded with requests still queued: poison them
                for r in q:
                    r.future.set_exception(e)
                self._depth[model] -= len(q)
                del queues[key]
                return []
            target = self._max_batch(served)
            # size-or-timeout flush, CAPPED by the head request's
            # deadline: a request due to expire sooner than the flush
            # window must not hold the window open — it is expired (and
            # rejected) at its deadline, not at flush_s
            while (len(q) < target and not self._stopping):
                cap = q[0].t_enqueue + self.flush_s
                if q[0].deadline is not None:
                    cap = min(cap, q[0].deadline)
                remaining = cap - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            # expire-before-dispatch: already-dead head requests are
            # rejected here instead of padding the batch (the tail of
            # the queue keeps its own flush window)
            now = time.perf_counter()
            expired = []
            while q and q[0].expired(now):
                expired.append(q.pop(0))
            if expired:
                self._depth[model] -= len(expired)
                for r in expired:
                    self.metrics.count(model, "deadline_expired_total")
                    r.future.set_exception(DeadlineExceededError(
                        "request expired after %.1f ms in queue (deadline)"
                        % ((now - r.t_enqueue) * 1e3)))
                if not q:
                    del queues[key]
                    self._cond.notify_all()
                    return []
            n = min(len(q), target)
            batch = [q.pop(0) for _ in range(n)]
            if not q:
                del queues[key]
            self._depth[model] -= n
            self._cond.notify_all()
        if batch:   # a stop without drain may have emptied the queue
            self.slo.on_dispatch(max(r.vstart for r in batch))
        return batch

    def _execute(self, model, batch):
        now = time.perf_counter()
        live = []
        for r in batch:
            if r.expired(now):
                self.metrics.count(model, "deadline_expired_total")
                r.future.set_exception(DeadlineExceededError(
                    "request expired after %.1f ms in queue (deadline)"
                    % ((now - r.t_enqueue) * 1e3)))
            elif r.future.set_running_or_notify_cancel():
                live.append(r)
        if not live:
            return
        try:
            served = self.registry.get(model, live[0].version)
        except Exception as e:
            for r in live:
                r.future.set_exception(e)
            return
        t_dispatch = time.perf_counter()
        stacked = onp.stack([r.item for r in live], axis=0)
        try:
            out, bucket, device_s = served.run_batch(stacked)
            self.metrics.observe_batch(model, len(live), bucket, device_s)
            done = time.perf_counter()
            self.slo.observe_served(len(live))
            for i, r in enumerate(live):
                self.metrics.observe_request(
                    model, t_dispatch - r.t_enqueue, done - r.t_enqueue)
                r.future.set_result(out[i])
        except Exception:
            # poisoned-request isolation: one bad input must not take the
            # batch (or the worker) down — re-run each request alone so
            # the exception poisons only its own future
            for r in live:
                try:
                    out, bucket, device_s = served.run_batch(
                        r.item[None, ...])
                    self.metrics.observe_batch(model, 1, bucket, device_s)
                    done = time.perf_counter()
                    self.metrics.observe_request(
                        model, t_dispatch - r.t_enqueue, done - r.t_enqueue)
                    r.future.set_result(out[0])
                except Exception as e:
                    self.metrics.count(model, "errors_total")
                    r.future.set_exception(e)

    # -- shutdown ---------------------------------------------------------
    def drain(self, timeout=30.0):
        """Stop admissions, serve everything queued, join the workers."""
        return self.stop(drain=True, timeout=timeout)

    def stop(self, drain=True, timeout=30.0):
        """Graceful (drain=True: queued requests complete) or immediate
        (drain=False: queued requests fail with ServerClosedError) stop.
        Returns True when every worker exited within the timeout."""
        with self._cond:
            self._stopping = True
            if not drain:
                for model, queues in self._queues.items():
                    for q in queues.values():
                        for r in q:
                            self._depth[model] -= 1
                            r.future.set_exception(ServerClosedError(
                                "batcher stopped before this request ran"))
                        q.clear()
                self._queues.clear()
            self._cond.notify_all()
            workers = list(self._workers.values())
            engines = list(self._engines.values())
        deadline = time.monotonic() + timeout
        ok = True
        for engine in engines:  # generation drains under the same policy
            ok = engine.stop(
                drain=drain,
                timeout=max(0.0, deadline - time.monotonic())) and ok
        for t in workers:
            t.join(max(0.0, deadline - time.monotonic()))
            ok = ok and not t.is_alive()
        return ok
