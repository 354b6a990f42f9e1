"""Serving observability: per-model counters + latency histograms.

A copy of ``mxnet_tpu/serving/metrics.py`` (host-side only), so that the
port's engine reports the same snapshot shape as the JAX engine.

Three surfaces over one set of measurements:
- ``ServingMetrics.snapshot()`` — a JSON-able dict (the scrapeable stats
  endpoint): counters, p50/p95/p99 for queue-wait / device / end-to-end
  latency, and the batch-occupancy ratio (items served / bucket slots
  dispatched).
- ``mxnet_tpu_torch.profiler`` aggregate table: each dispatched batch feeds
  ``record_op_stat("serving::<model>", device_s)`` when
  ``set_config(aggregate_stats=True)`` is active, so serving shows up in
  ``profiler.aggregate_stats()``.
- chrome-trace counters: queue depth and batch occupancy ride
  ``profiler.record_counter`` while a trace is recording.
"""
from __future__ import annotations

import threading
import time

from .. import config as _config
from .. import profiler

#: ring-buffer size per histogram — recent-window percentiles, O(1) memory
_RESERVOIR = 2048

PERCENTILES = (50, 95, 99)


class LatencyHistogram:
    """Bounded reservoir of the most recent ``_RESERVOIR`` samples.

    Serving percentiles are a moving window by design: a p99 over the
    process lifetime would bury a fresh latency regression under hours of
    old samples.  Not thread-safe on its own — the owning
    ``ServingMetrics`` lock serializes access."""

    __slots__ = ("count", "total", "_ring", "_idx")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self._ring = []
        self._idx = 0

    def observe(self, value_s):
        self.count += 1
        self.total += value_s
        if len(self._ring) < _RESERVOIR:
            self._ring.append(value_s)
        else:
            self._ring[self._idx] = value_s
            self._idx = (self._idx + 1) % _RESERVOIR

    def snapshot(self, scale=1e3, suffix="_ms"):
        """{count, mean_ms, p50_ms, p95_ms, p99_ms, max_ms} (ms floats).
        Dimensionless reservoirs (e.g. tokens-per-step) pass
        ``scale=1, suffix=""`` to report raw values."""
        if not self._ring:
            return {"count": 0}
        srt = sorted(self._ring)
        out = {"count": self.count,
               "mean%s" % suffix: round(self.total / self.count * scale,
                                        3),
               "max%s" % suffix: round(srt[-1] * scale, 3)}
        n = len(srt)
        for p in PERCENTILES:
            # nearest-rank percentile over the recent window
            k = min(n - 1, max(0, int(round(p / 100.0 * (n - 1)))))
            out["p%d%s" % (p, suffix)] = round(srt[k] * scale, 3)
        return out


class ModelMetrics:
    """One model's counters + histograms (guarded by the parent lock)."""

    COUNTERS = ("requests_total", "responses_total", "shed_total",
                "deadline_expired_total", "errors_total", "batches_total",
                "items_total", "bucket_slots_total",
                # SLO-aware admission: bulk-tier requests evicted
                # to admit latency-tier ones, and requests shed because
                # they provably could not meet their deadline
                "bulk_evicted_total", "infeasible_shed_total",
                # generation (continuous-batching decode engine)
                "tokens_generated_total", "prefill_tokens_total",
                "sequences_total", "sequences_completed_total",
                "decode_steps_total", "decode_slot_steps_total",
                "preemptions_total", "sessions_reset_total",
                # prefix caching + session migration
                "prefix_hits_total", "prefix_tokens_saved_total",
                "cow_forks_total", "migrations_out_total",
                "migrations_in_total", "migrations_replayed_total",
                # speculative decoding
                "spec_draft_tokens_total", "spec_accepted_tokens_total",
                "spec_verify_steps_total", "spec_rollbacks_total",
                # async decode engine: device-array reads that
                # happened at retire time, after the next launch was
                # already in flight
                "deferred_reads_total",
                # page-store refusals: the engine kept the
                # session local instead of shipping it — degrade paths
                # are counted, never silent
                "store_rejected_total", "store_over_budget_total")

    def __init__(self):
        self.counters = dict.fromkeys(self.COUNTERS, 0)
        self.queue_wait = LatencyHistogram()   # submit -> dispatch
        self.device = LatencyHistogram()       # model execution per batch
        self.total = LatencyHistogram()        # submit -> response
        self.batch_size = LatencyHistogram()   # items per dispatched batch
        # generation-path histograms (empty unless a DecodeEngine serves
        # this model): TTFT = submit -> first generated token; inter-token
        # = gap between consecutive tokens of one sequence; decode_step =
        # device time of one whole-batch decode step
        self.ttft = LatencyHistogram()
        self.inter_token = LatencyHistogram()
        self.decode_step = LatencyHistogram()
        # speculative decoding: tokens EMITTED per decode step (a wide
        # verify can land several — this is where >1 token/step shows),
        # plus the draft/verify latency split
        self.tokens_per_step = LatencyHistogram()
        self.draft_step = LatencyHistogram()
        self.verify_step = LatencyHistogram()
        # async decode engine: host gap = wall time the device sat with
        # no decode work queued between steps (the async win is this
        # collapsing toward zero); dispatch_depth = launched-but-
        # unretired steps at each launch (achieved pipelining depth)
        self.host_gap = LatencyHistogram()
        self.dispatch_depth = LatencyHistogram()
        self.kv_cache = {"used_pages": 0, "total_pages": 0,
                         "peak_used_pages": 0, "shared_pages": 0,
                         "leaked_pages": 0, "tokens_resident": 0,
                         "bytes_per_token": 0.0}
        self.tokens_per_s = 0.0  # EMA over decode steps
        # static gauges (set once per engine): the kernel launches of one
        # decode step, and (JAX engine only) its program cache
        self.decode_launches = None
        self.fn_cache = None
        # static cross-chip census (set once at engine attach when the
        # engine is tensor-parallel): mesh shape + per-step collective
        # counts — how the fleet router tells a TP replica from a dp one
        self.decode_collectives = None

    def snapshot(self):
        items = self.counters["items_total"]
        slots = self.counters["bucket_slots_total"]
        out = {
            "counters": dict(self.counters),
            "batch_occupancy": round(items / slots, 4) if slots else None,
            "queue_wait": self.queue_wait.snapshot(),
            "device": self.device.snapshot(),
            "total": self.total.snapshot(),
            "batch_size": self.batch_size.snapshot(),
        }
        steps = self.counters["decode_steps_total"]
        if steps or self.counters["sequences_total"]:
            total = self.kv_cache["total_pages"]
            slot_steps = self.counters["decode_slot_steps_total"]
            out["generate"] = {
                "ttft": self.ttft.snapshot(),
                "inter_token": self.inter_token.snapshot(),
                "decode_step": self.decode_step.snapshot(),
                "tokens_per_s": round(self.tokens_per_s, 2),
                # fraction of dispatched decode-slot work that produced a
                # real token — the continuous-batching win over static
                "decode_occupancy": (round(
                    self.counters["tokens_generated_total"]
                    / slot_steps, 4) if slot_steps else None),
                "kv_occupancy": (round(
                    self.kv_cache["used_pages"] / total, 4)
                    if total else None),
                # logical tokens resident in cache pages, and the
                # physical cost per token (scales amortized) — the
                # int8-KV capacity story in two numbers
                "kv_tokens_resident": self.kv_cache["tokens_resident"],
                "kv_bytes_per_token": self.kv_cache["bytes_per_token"],
                "kv_cache": dict(self.kv_cache),
            }
            out["generate"]["tokens_per_step"] = (
                self.tokens_per_step.snapshot(scale=1, suffix=""))
            out["generate"]["host_gap_us"] = self.host_gap.snapshot(
                scale=1e6, suffix="_us")
            out["generate"]["dispatch_depth"] = (
                self.dispatch_depth.snapshot(scale=1, suffix=""))
            drafted = self.counters["spec_draft_tokens_total"]
            if drafted or self.counters["spec_verify_steps_total"]:
                out["generate"]["speculative"] = {
                    "draft_step": self.draft_step.snapshot(),
                    "verify_step": self.verify_step.snapshot(),
                    # the one-number health read: of every drafted
                    # token, how many did the target keep
                    "accepted_token_rate": (round(
                        self.counters["spec_accepted_tokens_total"]
                        / drafted, 4) if drafted else None),
                }
            if self.decode_launches is not None:
                out["generate"]["decode_launches"] = dict(
                    self.decode_launches)
            if self.fn_cache is not None:
                out["generate"]["fn_cache"] = dict(self.fn_cache)
        if self.decode_collectives is not None:
            # static census — surfaced from attach time on, before any
            # traffic lands (it never changes while the engine lives)
            out.setdefault("generate", {})["sharding"] = dict(
                self.decode_collectives)
        return out


class ServingMetrics:
    """Thread-safe per-model metrics registry.

    ``replica`` labels every snapshot (and the Prometheus export) with
    the serving replica that produced it — the fleet supervisor stamps
    ``MXNET_SERVING_REPLICA_ID`` into each replica process so the router
    can aggregate per-replica stats without guessing by port."""

    def __init__(self, replica=None):
        self.replica = (str(replica) if replica is not None
                        else (_config.get("MXNET_SERVING_REPLICA_ID")
                              or None))
        self._lock = threading.Lock()
        self._models = {}

    def _model(self, name):
        m = self._models.get(name)
        if m is None:
            m = self._models.setdefault(name, ModelMetrics())
        return m

    def count(self, name, counter, n=1):
        with self._lock:
            self._model(name).counters[counter] += n

    def observe_queue_depth(self, name, depth):
        # chrome-trace counter only — depth is an instantaneous gauge,
        # the snapshot reports it live from the batcher instead
        profiler.record_counter("serving::%s::queue_depth" % name,
                                depth=depth)

    def observe_batch(self, name, batch, bucket, device_s):
        """One dispatched batch: ``batch`` real items padded up to
        ``bucket`` slots, executed in ``device_s`` seconds."""
        with self._lock:
            m = self._model(name)
            m.counters["batches_total"] += 1
            m.counters["items_total"] += batch
            m.counters["bucket_slots_total"] += bucket
            m.device.observe(device_s)
            m.batch_size.observe(float(batch))
        # profiler hooks outside the lock: the aggregate table is the
        # MXAggregateProfileStatsPrint analog, the counter the trace view
        if profiler._AGG["enabled"]:
            profiler.record_op_stat("serving::%s" % name, device_s)
        profiler.record_counter("serving::%s::batch" % name,
                                batch=batch, bucket=bucket)

    def observe_request(self, name, queue_wait_s, total_s):
        with self._lock:
            m = self._model(name)
            m.counters["responses_total"] += 1
            m.queue_wait.observe(queue_wait_s)
            m.total.observe(total_s)

    # -- generation (continuous-batching decode engine) -------------------
    def observe_generate_done(self, name, total_s):
        """One completed generation (queue-wait is folded into TTFT, so
        only the end-to-end latency histogram is fed here)."""
        with self._lock:
            m = self._model(name)
            m.counters["responses_total"] += 1
            m.total.observe(total_s)

    def observe_ttft(self, name, ttft_s):
        with self._lock:
            self._model(name).ttft.observe(ttft_s)
        profiler.record_counter("serving::%s::ttft" % name,
                                ttft_ms=ttft_s * 1e3)

    def observe_inter_token(self, name, gap_s):
        with self._lock:
            self._model(name).inter_token.observe(gap_s)

    def observe_decode_step(self, name, device_s, wall_s, active, slots,
                            new_tokens):
        """One whole-batch decode step: ``active`` of ``slots`` decode
        slots produced ``new_tokens`` tokens in ``device_s`` seconds."""
        with self._lock:
            m = self._model(name)
            m.counters["decode_steps_total"] += 1
            m.counters["decode_slot_steps_total"] += slots
            m.counters["tokens_generated_total"] += new_tokens
            m.decode_step.observe(device_s)
            m.tokens_per_step.observe(float(new_tokens))
            rate = new_tokens / max(wall_s, 1e-9)
            m.tokens_per_s = (rate if m.tokens_per_s == 0.0
                              else 0.9 * m.tokens_per_s + 0.1 * rate)
        if profiler._AGG["enabled"]:
            profiler.record_op_stat("serving::%s::decode_step" % name,
                                    device_s)
        profiler.record_counter("serving::%s::decode" % name,
                                active=active, tokens=new_tokens)

    def observe_host_gap(self, name, gap_s):
        """Device-idle gap before one decode launch: wall time since the
        engine last blocked on (and received) a step result with nothing
        left in flight.  Zero when the launch went out while a previous
        step was still unretired — the pipelined steady state."""
        with self._lock:
            self._model(name).host_gap.observe(gap_s)

    def observe_dispatch_depth(self, name, depth):
        """Launched-but-unretired decode steps right after one launch
        (the achieved dispatch-ahead depth, histogrammed)."""
        with self._lock:
            self._model(name).dispatch_depth.observe(float(depth))

    def observe_draft(self, name, draft_s):
        """Wall time of one slot's draft proposal (speculative path)."""
        with self._lock:
            self._model(name).draft_step.observe(draft_s)

    def observe_verify(self, name, verify_s):
        """Wall time of one whole-batch wide verify launch."""
        with self._lock:
            self._model(name).verify_step.observe(verify_s)
        if profiler._AGG["enabled"]:
            profiler.record_op_stat("serving::%s::verify_step" % name,
                                    verify_s)

    def observe_decode_launches(self, name, stats):
        """Hand-written kernel launches of one decode step (see
        ``serving.generate.DecodeEngine``): layer groups, kernel launches
        per step."""
        with self._lock:
            self._model(name).decode_launches = dict(stats)
        profiler.record_counter(
            "serving::%s::decode_launches" % name,
            launches=stats.get("launches_per_step", 0))

    def observe_decode_collectives(self, name, stats):
        """Static per-step collective census of a tensor-parallel
        engine's decode program (models.decoder.decode_collective_stats):
        mesh shape, tp degree, {collective: count}.  Recorded once at
        engine attach — the census is a property of the compiled program,
        not of traffic."""
        with self._lock:
            self._model(name).decode_collectives = dict(stats)
        cols = stats.get("collectives") or {}
        profiler.record_counter(
            "serving::%s::decode_collectives" % name,
            all_reduce=cols.get("all-reduce", 0))

    def observe_fn_cache(self, name, stats):
        """Decode/prefill program-cache gauges ({size, cap, compiles,
        evictions} from models.decoder.fn_cache_stats)."""
        with self._lock:
            self._model(name).fn_cache = dict(stats)

    def observe_kv_cache(self, name, used_pages, total_pages,
                         shared_pages=0, leaked_pages=0,
                         tokens_resident=None, bytes_per_token=None):
        with self._lock:
            kv = self._model(name).kv_cache
            kv["used_pages"] = int(used_pages)
            kv["total_pages"] = int(total_pages)
            kv["shared_pages"] = int(shared_pages)
            kv["leaked_pages"] = int(leaked_pages)
            kv["peak_used_pages"] = max(kv["peak_used_pages"],
                                        int(used_pages))
            if tokens_resident is not None:
                kv["tokens_resident"] = int(tokens_resident)
            if bytes_per_token is not None:
                kv["bytes_per_token"] = float(bytes_per_token)
        profiler.record_counter("serving::%s::kv_cache" % name,
                                used_pages=used_pages)

    def snapshot(self):
        """Scrapeable stats: {model: {counters, batch_occupancy,
        queue_wait/device/total/batch_size histograms}}, labelled with
        the replica id when one is set."""
        with self._lock:
            snap = {"time": time.time(),
                    "models": {n: m.snapshot()
                               for n, m in self._models.items()}}
        if self.replica is not None:
            snap["replica"] = self.replica
        return snap

    def reset(self):
        with self._lock:
            self._models.clear()
