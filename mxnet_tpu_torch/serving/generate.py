"""Continuous-batching autoregressive decode engine over a paged KV cache.

The port of ``mxnet_tpu/serving/generate.py``'s synchronous core:

- **Iteration-level (continuous) batching** — the decode batch is
  re-formed every step: a sequence is admitted into a free slot the
  moment one opens, and evicted the step it finishes (EOS / max tokens /
  deadline).
- **Paged KV cache** — per-sequence KV lives in fixed-size pages handed
  out by ``kvcache.PageAllocator``; attention reads through per-slot
  page tables.  When the pool runs dry the engine **preempts** the
  youngest sequence (frees its pages, requeues it for recompute with its
  progress kept) instead of failing.
- **Chunked prefill** — prompts are cached ``prefill_chunk`` tokens per
  engine step, round-robin over the slots in prefill, interleaved with
  decode steps.
- **Decode step** — by default the fused decode-layer-group kernel (one
  launch per ``MXNET_DECODE_LAYER_GROUP`` layers); ``MXNET_DECODE_FUSED=0``
  selects the per-op step (paged-attention and bias_gelu kernels between
  torch matmuls).  Both run hand-written kernels on the card.
- **Quantized serving** — ``quantize="int8"|"int4"`` (or a model wrapped by
  ``quantize.quantize_lm``, or ``MXNET_QUANT_WEIGHTS``/``MXNET_QUANT_GROUP``)
  serves weight-only quantized GEMMs through the ``quant_matmul`` kernel;
  ``kv_dtype="int8"`` (or ``MXNET_QUANT_KV``) stores the KV pages as int8
  codes with one scale per (layer, KV head, page), read by the int8-page
  paged-attention kernel.  Either one takes the per-op decode step: the
  fused kernel is fp-only, as in the JAX engine.
- **Tensor-parallel serving** — ``sharding=`` a ``parallel.ShardingConfig``
  with a ``tp`` axis (``ShardingConfig.for_transformer(mesh_shape=(1, 2),
  axis_names=("dp", "tp"))``) splits every layer Megatron-style over tp
  shards (``models.decoder.TPPlan``): the fused step runs the attention
  and FFN phase kernels per layer per shard, the per-op step the
  paged-attention kernel per shard, and the shards' partial products are
  summed by ``models.decoder._all_reduce``.  The port runs on one card, so
  the shards run there in turn.  A geometry tp does not divide serves
  replicated, with a warning, as in the JAX engine.  Quantized weights
  and int8 KV pages serve under ``sharding=`` too, through the per-op TP
  step: each shard's GEMMs launch ``quant_matmul`` on its cut of the
  integer weights, its attention the int8-page kernel on its KV heads'
  slab; int4 weights are quantized with the shard-local group
  (``QuantizedLM.params(tp=)``).

The KV page pools are tensors on the engine's device, updated in place by
every step (the JAX engine donates them to each jitted step instead).
The engine runs on ``cuda`` unless ``device="cpu"`` is passed, in which
case every kernel's plain PyTorch version serves.

Not ported yet, and refused with ``NotImplementedError`` when asked for:
the async decode pipeline (``async_decode``/``MXNET_GEN_ASYNC``),
decode sessions and migration (``session=``, ``migrate``, ``pagestore``),
the prefix cache (``prefix_cache``/``MXNET_GEN_PREFIX_CACHE``),
speculative decoding and role specialization.

Admission control mirrors the JAX engine: a bounded queue sheds with
``QueueFullError``, draining rejects with ``ServerClosedError``,
deadlines expire typed, and a failed sequence poisons only its own
future.  Fault sites: ``decode.step`` and ``kvcache.alloc``.
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
from concurrent.futures import Future

import numpy as onp
import torch

from .. import config as _config
from .. import context, faults
from ..models import decoder as _decoder
from ..ops.kernels import paged_attention as _paged
from ..parallel.shardcfg import ShardingConfig
from .autoscale import SLOPolicy
from .errors import (BadRequestError, DeadlineExceededError, QueueFullError,
                     ServerClosedError, ServingError)
from .kvcache import CacheOOM, PageAllocator, pages_for
from .metrics import ServingMetrics
from .quantize import quantize_lm

__all__ = ["DecodeEngine"]

_log = logging.getLogger(__name__)


class _Request:
    __slots__ = ("prompt", "max_new", "deadline", "future", "t_enqueue",
                 "prefix", "ttft_recorded", "prompt_tokens", "started",
                 "tier", "tenant", "rank", "vstart")

    def __init__(self, prompt, max_new, deadline, tier="latency",
                 tenant=None, rank=0, vstart=0.0):
        self.prompt = list(prompt)
        self.prompt_tokens = len(self.prompt)  # as submitted (reporting)
        self.max_new = int(max_new)
        self.deadline = deadline          # absolute perf_counter or None
        self.future = Future()
        self.t_enqueue = time.perf_counter()
        self.prefix = []                  # tokens emitted before a preempt
        self.ttft_recorded = False
        self.started = False              # future already marked running
        self.tier = tier                  # "latency" | "bulk" (SLO class)
        self.tenant = tenant
        self.rank = rank                  # tier priority (0 = latency)
        self.vstart = vstart              # weighted-fair start tag

    @property
    def sort_key(self):
        return (self.rank, self.vstart)

    def expired(self, now):
        return self.deadline is not None and now > self.deadline


class _Slot:
    __slots__ = ("req", "state", "owner", "prompt", "done", "pos",
                 "history", "generated", "pending", "t_last", "admit_seq",
                 "idx")

    def __init__(self, idx):
        self.idx = idx
        self.req = None
        self.owner = None
        self.state = "idle"   # idle | prefill | decode

    @property
    def active(self):
        return self.state != "idle"


def _not_ported(what):
    raise NotImplementedError(
        "%s is not ported to mxnet_tpu_torch yet (the JAX package "
        "mxnet_tpu.serving.DecodeEngine has it)" % what)


def _refuse_unported(prefix_cache, async_decode, dispatch_ahead, role,
                     migrate, pagestore, speculate, spec_k, drafter,
                     draft_model):
    """Raise NotImplementedError for every feature of the JAX engine that
    the port lacks and the caller (or the environment) asks for."""
    asks = [
        ("the prefix cache", prefix_cache,
         "MXNET_GEN_PREFIX_CACHE"),
        ("the async decode pipeline", async_decode or dispatch_ahead,
         "MXNET_GEN_ASYNC"),
        ("session migration", migrate or pagestore, "MXNET_GEN_PAGESTORE"),
        ("speculative decoding",
         speculate or spec_k or drafter or draft_model,
         "MXNET_GEN_SPECULATE"),
    ]
    for what, arg, env in asks:
        if arg or (arg is None and _config.requested(env)):
            _not_ported(what)
    r = role if role is not None else (
        os.environ.get("MXNET_GEN_ROLE") or "mixed")
    if str(r) != "mixed":
        _not_ported("role=%r (prefill/decode specialization)" % (r,))


def _decode_fused():
    """MXNET_DECODE_FUSED: ''/'1' -> fused kernel step, '0' -> per-op."""
    flag = str(_config.get("MXNET_DECODE_FUSED") or "").strip().lower()
    if flag in ("", "1", "on", "true"):
        return True
    if flag in ("0", "off", "false"):
        return False
    raise ValueError("MXNET_DECODE_FUSED=%r: use '' or '1' for the fused "
                     "decode kernel, '0' for the per-op step (CPU tensors "
                     "run the plain versions; there is no interpret mode)"
                     % flag)


def _check_quant_matmul_lane():
    """MXNET_QUANT_MATMUL: only '' is taken.  The JAX package's '0'
    (plain lane) and 'interpret' have no counterpart: CUDA tensors always
    launch the kernel, CPU tensors run the plain version."""
    flag = str(_config.get("MXNET_QUANT_MATMUL") or "").strip()
    if flag:
        raise ValueError("MXNET_QUANT_MATMUL=%r: the port has no interpret "
                         "or plain lane on the card (CUDA tensors launch the "
                         "quant_matmul kernel, CPU tensors run its plain "
                         "version); leave it unset" % flag)


def _kernels_per_layer(quant, kv_dtype, tp):
    """Kernel launches per layer of one per-op decode step and of one
    prefill chunk (each of the tp shards launches its own: one
    ``quant_matmul`` a GEMM of its six)."""
    decode = {"paged_attention_int8" if kv_dtype == "int8"
              else "paged_attention": tp, "bias_gelu": tp}
    prefill = {"bias_gelu": tp}
    if quant is not None:
        decode["quant_matmul"] = prefill["quant_matmul"] = 6 * tp
    return decode, prefill


#: the collective classes of the JAX package's census
#: (``parallel/shardcfg.py:851``)
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


class DecodeEngine:
    """Continuous-batching decode scheduler for one causal LM.

    ``model`` is a :class:`mxnet_tpu_torch.models.decoder.CausalLM` whose
    parameters live on ``device`` (``cuda`` unless ``"cpu"`` is passed;
    with no GPU and no device given, construction raises).  One worker
    thread owns the KV pages and re-forms the decode batch every step.

    Knobs (env defaults in parentheses):
      slots          — decode batch width (``MXNET_GEN_SLOTS``)
      page_size      — tokens per KV page (``MXNET_GEN_PAGE_SIZE``)
      total_pages    — KV pool size incl. the scratch page
                       (``MXNET_GEN_PAGES``; 0 = fully provision
                       ``slots * pages_per_seq + 1`` — no preemption)
      max_ctx        — max prompt+output tokens per sequence
                       (``MXNET_GEN_MAX_CTX``; 0 = model max_length)
      prefill_chunk  — prompt tokens cached per engine step
                       (``MXNET_GEN_PREFILL_CHUNK``)

    Quantized serving (``quantize``/``quant_group``/``kv_dtype``, or a
    ``quantize.QuantizedLM``, or ``MXNET_QUANT_WEIGHTS``/
    ``MXNET_QUANT_GROUP``/``MXNET_QUANT_KV``) runs the per-op step; its
    format lands in ``stats()["quant"]``.

    ``MXNET_DECODE_FUSED`` picks the decode step and
    ``MXNET_DECODE_LAYER_GROUP`` the layers per fused launch; the kernel
    launches one step makes land in ``stats()["launches"]``.

    ``sharding`` (a ``parallel.ShardingConfig``) with a ``tp`` axis serves
    tensor-parallel (``models.decoder.TPPlan``); ``stats()["sharding"]``
    and the metrics then carry the mesh, tp and the collectives of one
    decode step, counted on a step run at construction with every slot
    inactive.
    """

    def __init__(self, model, *, name="llm", slots=None, page_size=None,
                 total_pages=None, max_ctx=None, prefill_chunk=None,
                 eos_id=None, max_queue_depth=256, metrics=None,
                 device=None,
                 prefix_cache=None, async_decode=None, dispatch_ahead=None,
                 role=None, migrate=None, pagestore=None, speculate=None,
                 spec_k=None, drafter=None, draft_model=None, sharding=None,
                 quantize=None, quant_group=None, kv_dtype=None):
        _refuse_unported(prefix_cache, async_decode, dispatch_ahead, role,
                         migrate, pagestore, speculate, spec_k, drafter,
                         draft_model)
        if sharding is not None and not isinstance(sharding, ShardingConfig):
            raise TypeError("sharding must be a mxnet_tpu_torch.parallel."
                            "ShardingConfig, got %s"
                            % type(sharding).__name__)
        _check_quant_matmul_lane()
        # weights and KV pages quantize independently; a QuantizedLM
        # passed in keeps its own format
        qmode = getattr(model, "quant_mode", None)
        want = str(quantize if quantize is not None
                   else _config.get("MXNET_QUANT_WEIGHTS") or "")
        if qmode is None and want:
            model = quantize_lm(model, want, group=int(
                quant_group if quant_group is not None
                else _config.get("MXNET_QUANT_GROUP")))
            qmode = model.quant_mode
        self.quant = model.quant_token() if qmode is not None else None
        self.kv_dtype = str(kv_dtype if kv_dtype is not None
                            else _config.get("MXNET_QUANT_KV")
                            or "float32")
        if self.kv_dtype not in ("float32", "int8"):
            raise ValueError("kv_dtype must be float32 or int8, got %r"
                             % (self.kv_dtype,))
        self.device = context.resolve(device)
        if model.device != self.device:
            raise ValueError(
                "the model's weights live on %s but the engine runs on %s; "
                "build the model with device=%r"
                % (model.device, self.device, str(self.device)))
        self.model = model
        self.name = name
        self.cfg = model.config
        # tensor parallelism: the plan comes before any program; a geometry
        # tp does not divide resolves to None (tp_plan warns) and serves
        # replicated
        self._tp_plan = _decoder.tp_plan(self.cfg, sharding)
        self.sharding = sharding if self._tp_plan is not None else None
        self.tp = self._tp_plan.tp if self._tp_plan is not None else 1
        # int4 scale groups must not straddle the row-parallel shards: a
        # quantized model gives the params quantized with the shard-local
        # group at this tp (int8 ignores it), as the JAX engine re-derives
        # them (mxnet_tpu/serving/generate.py:320-324)
        self.params = (model.params(tp=self.tp) if self.quant is not None
                       else model.params())
        if self._tp_plan is not None:
            self.params = self._tp_plan.shard_params(self.params)
        self.slots = int(slots if slots is not None
                         else _config.get("MXNET_GEN_SLOTS"))
        self.page_size = int(page_size if page_size is not None
                             else _config.get("MXNET_GEN_PAGE_SIZE"))
        self.max_ctx = int(max_ctx or _config.get("MXNET_GEN_MAX_CTX")
                           or self.cfg.max_length)
        self.max_ctx = min(self.max_ctx, self.cfg.max_length)
        self.pages_per_seq = pages_for(self.max_ctx, self.page_size)
        total = int(total_pages if total_pages is not None
                    else _config.get("MXNET_GEN_PAGES"))
        if not total:
            total = self.slots * self.pages_per_seq + 1
        self.prefill_chunk = int(prefill_chunk if prefill_chunk is not None
                                 else _config.get("MXNET_GEN_PREFILL_CHUNK"))
        self.eos_id = eos_id if eos_id is not None else getattr(
            model, "eos_id", None)
        self.max_queue_depth = int(max_queue_depth)
        self.metrics = metrics if metrics is not None else ServingMetrics()

        cfg = self.cfg
        elems = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim
        int8 = self.kv_dtype == "int8"
        self.alloc = PageAllocator(
            total, self.page_size, kv_dtype=self.kv_dtype,
            page_bytes=elems * self.page_size * (1 if int8 else 4),
            scale_page_bytes=(2 * cfg.num_layers * cfg.num_kv_heads * 4
                              if int8 else 0))
        shape = (cfg.num_layers, cfg.num_kv_heads, total, self.page_size,
                 cfg.head_dim)
        self._kp = self._fresh_pool(shape)
        self._vp = self._fresh_pool(shape)
        self._tables = onp.zeros((self.slots, self.pages_per_seq),
                                 onp.int32)
        self._tables_dev = None  # device copy, rebuilt when rows change

        self.decode_fused = _decode_fused()
        if self.decode_fused and (self.quant is not None or int8):
            _log.info("decode engine %r: the fused decode kernel is fp-only; "
                      "quantized serving (quant=%r kv=%s) runs the per-op "
                      "step", name, self.quant, self.kv_dtype)
            self.decode_fused = False
        self.layer_group = (int(_config.get("MXNET_DECODE_LAYER_GROUP"))
                            or cfg.num_layers)
        L = cfg.num_layers
        plan = self._tp_plan
        decode_k, prefill_k = _kernels_per_layer(self.quant, self.kv_dtype,
                                                 self.tp)
        if self.decode_fused:
            self._decode_fn = _decoder.make_decode_step_fused(
                cfg, self.page_size, self.layer_group, plan=plan)
            if plan is None:
                groups = len(_decoder._group_bounds(L, self.layer_group))
                per_step = {"decode_layer_group": groups}
            else:
                groups = L
                per_step = {"decode_attn_phase": L * self.tp,
                            "decode_ffn_phase": L * self.tp}
        else:
            self._decode_fn = _decoder.make_decode_step(cfg, self.page_size,
                                                        plan=plan)
            groups = L
            per_step = {k: n * L for k, n in decode_k.items()}
        self._prefill_fn = _decoder.make_prefill_chunk(
            cfg, self.page_size, self.prefill_chunk, plan=plan)
        # kernel launches of one decode step and of one prefill chunk (on
        # the CPU the same calls run the plain versions)
        self.launch_stats = {"fused": self.decode_fused,
                             "layer_groups": groups,
                             "launches_per_step": sum(per_step.values()),
                             "kernels": per_step,
                             "prefill_chunk_kernels": {
                                 k: n * L for k, n in prefill_k.items()}}
        self.metrics.observe_decode_launches(self.name, self.launch_stats)
        self.collective_stats = None
        if plan is not None:
            self.collective_stats = self._count_collectives()
            self.metrics.observe_decode_collectives(self.name,
                                                    self.collective_stats)

        self._slots = [_Slot(i) for i in range(self.slots)]
        self._queue = collections.deque()
        self.slo = SLOPolicy()
        self._cond = threading.Condition()
        self._worker = None
        self._stopping = False
        self._drain_mode = True
        self._seq = 0                 # admission counter (owner ids)
        self._prefill_rr = 0
        self.steps = 0
        # staging buffers for batch formation, reused every step
        self._stage_tokens = onp.zeros(self.slots, onp.int64)
        self._stage_positions = onp.zeros(self.slots, onp.int64)
        self._stage_active = onp.zeros(self.slots, bool)

    # -- admission --------------------------------------------------------
    def _evict_bulk_locked(self):
        """A full queue admits a latency-tier request by evicting the
        newest queued bulk-tier one.  Returns True when a victim was
        found."""
        victim = None
        for r in self._queue:
            if r.rank > 0 and (victim is None
                               or r.vstart > victim.vstart):
                victim = r
        if victim is None:
            return False
        self._queue.remove(victim)
        self.metrics.count(self.name, "shed_total")
        self.metrics.count(self.name, "bulk_evicted_total")
        victim.future.set_exception(QueueFullError(
            "bulk-tier generate evicted to admit a latency-tier one "
            "(queue at max_queue_depth=%d)" % self.max_queue_depth,
            queued=len(self._queue)))
        return True

    def submit(self, prompt, max_new_tokens=16, *, deadline_ms=None,
               session=None, resume=False, tier=None, tenant=None):
        """Enqueue one generation; returns a Future resolving to
        ``{"tokens", "finish_reason", "session", "prompt_tokens",
        "completion_tokens"}``.  Shed/deadline failures rethrow typed at
        ``future.result()`` (or synchronously at submit for
        admission-time refusals).  ``session``/``resume`` (decode
        sessions) are not ported yet and raise NotImplementedError."""
        if session is not None or resume:
            _not_ported("decode sessions (session=/resume=)")
        rank, vstart = self.slo.stamp(tier, tenant)
        tier = self.slo.normalize_tier(tier)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise BadRequestError("generate: prompt must be non-empty")
        if any(t < 0 or t >= self.cfg.vocab_size for t in prompt):
            raise BadRequestError(
                "generate: token ids must be in [0, %d)"
                % self.cfg.vocab_size)
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise BadRequestError("generate: max_tokens must be >= 1")
        if len(prompt) + max_new > self.max_ctx:
            raise BadRequestError(
                "generate: prompt (%d) + max_tokens (%d) exceeds "
                "max_ctx=%d" % (len(prompt), max_new, self.max_ctx))
        deadline = (time.perf_counter() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        self.metrics.count(self.name, "requests_total")
        with self._cond:
            if self._stopping:
                self.metrics.count(self.name, "shed_total")
                raise ServerClosedError(
                    "decode engine is draining; not accepting new requests")
            if len(self._queue) >= self.max_queue_depth:
                if rank > 0 or not self._evict_bulk_locked():
                    self.metrics.count(self.name, "shed_total")
                    raise QueueFullError(
                        "model %r generate queue full (%d >= %d)"
                        % (self.name, len(self._queue),
                           self.max_queue_depth),
                        queued=len(self._queue))
            if deadline_ms is not None and self._queue:
                try:
                    self.slo.check_deadline(len(self._queue),
                                            float(deadline_ms) / 1e3)
                except Exception:
                    self.metrics.count(self.name, "shed_total")
                    self.metrics.count(self.name,
                                       "infeasible_shed_total")
                    raise
            req = _Request(prompt, max_new, deadline, tier=tier,
                           tenant=tenant, rank=rank, vstart=vstart)
            # priority insertion: latency tier ahead of bulk, weighted-
            # fair tags within a tier (all-default traffic appends)
            i = len(self._queue)
            while i > 0 and self._queue[i - 1].sort_key > req.sort_key:
                i -= 1
            self._queue.insert(i, req)
            self._ensure_worker_locked()
            self._cond.notify_all()
        return req.future

    def _ensure_worker_locked(self):
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._run, name="mxt-decode-%s" % self.name,
                daemon=True)
            self._worker.start()

    # -- worker -----------------------------------------------------------
    def _run(self):
        scope = (torch.cuda.device(self.device)
                 if self.device.type == "cuda" else contextlib.nullcontext())
        with torch.no_grad(), scope:
            while True:
                with self._cond:
                    while (not self._stopping and not self._queue
                           and not any(s.active for s in self._slots)):
                        self._cond.wait(0.1)
                    if self._stopping:
                        busy = (any(s.active for s in self._slots)
                                or (self._drain_mode and self._queue))
                        if not busy:
                            return
                try:
                    self._step()
                except Exception as e:
                    # a failed step fails the sequences it carried (typed,
                    # with the cause); the engine keeps serving the queue
                    _log.exception("decode engine step failed")
                    for s in self._slots:
                        if s.active:
                            self._fail_slot(s, ServingError(
                                "engine step failed: %r" % (e,)))

    def _step(self):
        self._expire_queued(time.perf_counter())
        self._admit()
        self._prefill_phase()
        self._decode()
        kv = self.alloc.stats()
        self.metrics.observe_kv_cache(
            self.name, kv["used_pages"], kv["total_pages"],
            kv["shared_pages"], kv["leaked_pages"],
            tokens_resident=self._tokens_resident(),
            bytes_per_token=kv.get("kv_bytes_per_token", 0.0))
        self.steps += 1

    def _expire_queued(self, now):
        with self._cond:
            expired = [r for r in self._queue if r.expired(now)]
            for r in expired:
                self._queue.remove(r)
        for r in expired:
            self.metrics.count(self.name, "deadline_expired_total")
            r.future.set_exception(DeadlineExceededError(
                "generate request expired after %.1f ms in queue"
                % ((now - r.t_enqueue) * 1e3)))

    # -- scheduling -------------------------------------------------------
    def _free_slot(self):
        for s in self._slots:
            if not s.active:
                return s
        return None

    def _admit(self):
        while True:
            with self._cond:
                if not self._queue:
                    return
                slot = self._free_slot()
                if slot is None:
                    return
                req = self._queue.popleft()
            self.slo.on_dispatch(req.vstart)
            if not self._activate(slot, req):
                return

    def _activate(self, slot, req):
        """Place ``req`` into ``slot``; returns False when admission must
        pause (page watermark) — the request goes back to the head."""
        prefill = list(req.prompt)
        remaining_new = req.max_new - len(req.prefix)
        if len(prefill) + max(0, remaining_new - 1) > self.max_ctx:
            req.future.set_exception(BadRequestError(
                "generate: prompt + max_tokens exceeds max_ctx=%d"
                % self.max_ctx))
            return True
        # watermark: enough pages to finish prefill + the first decode
        # token, otherwise leave it queued until evictions free pages
        if pages_for(len(prefill) + 1, self.page_size) > self.alloc.num_free:
            with self._cond:
                self._queue.appendleft(req)
            return False
        if not req.started and not req.future.set_running_or_notify_cancel():
            return True  # client cancelled while queued
        req.started = True
        self._seq += 1
        slot.req = req
        slot.state = "prefill"
        slot.owner = ("req", self._seq)
        slot.prompt = prefill
        slot.done = 0
        slot.pos = 0
        slot.history = []
        slot.generated = []
        slot.pending = None
        slot.t_last = time.perf_counter()
        slot.admit_seq = self._seq
        self.metrics.count(self.name, "sequences_total")
        self._sync_table(slot)
        return True

    def _sync_table(self, slot):
        row = self.alloc.pages(slot.owner)
        self._tables[slot.idx, :] = 0
        if row:
            self._tables[slot.idx, :len(row)] = row
        self._tables_dev = None  # invalidate the device copy

    def _tables_device(self):
        if self._tables_dev is None:
            self._tables_dev = torch.tensor(self._tables, dtype=torch.int32,
                                            device=self.device)
        return self._tables_dev

    def _ensure_pages(self, slot, tokens_ahead):
        """Grow the slot's page list to cover ``tokens_ahead`` more cache
        positions; preempts the youngest other sequence on exhaustion.
        Returns False when the SLOT ITSELF was failed (nothing fits)."""
        need = (pages_for(slot.pos + tokens_ahead, self.page_size)
                - len(self.alloc.pages(slot.owner)))
        while need > 0:
            try:
                self.alloc.alloc(slot.owner, need)
                self._sync_table(slot)
                return True
            except CacheOOM:
                victim = self._preempt_victim(exclude=slot)
                if victim is None:
                    self._fail_slot(slot, ServingError(
                        "kv cache too small for this sequence (%d pages "
                        "total)" % (self.alloc.total_pages - 1,)))
                    return False
                self._preempt(victim)
            except Exception as e:
                # injected kvcache.alloc fault (or a real allocator bug):
                # fail only this sequence, keep the engine serving
                self._fail_slot(slot, e if isinstance(e, ServingError)
                                else ServingError(
                                    "kv page allocation failed: %r" % (e,)))
                return False
        return True

    def _preempt_victim(self, exclude):
        victim = None
        for s in self._slots:
            if s.active and s is not exclude:
                if victim is None or s.admit_seq > victim.admit_seq:
                    victim = s
        return victim

    def _preempt(self, slot):
        """vLLM recompute eviction: free the slot's pages, requeue the
        request at the head with its emitted tokens folded into the
        prompt (the continuation decodes on, nothing is lost)."""
        req = slot.req
        recompute = list(slot.history) + slot.prompt[slot.done:]
        if slot.state == "decode" and slot.pending is not None:
            recompute.append(slot.pending)
        new = _Request(recompute, req.max_new, req.deadline, tier=req.tier,
                       tenant=req.tenant, rank=req.rank, vstart=req.vstart)
        new.future = req.future
        new.started = req.started
        new.t_enqueue = req.t_enqueue
        new.prefix = req.prefix + slot.generated
        new.ttft_recorded = req.ttft_recorded
        new.prompt_tokens = req.prompt_tokens
        self.alloc.free(slot.owner)
        self._clear(slot)
        with self._cond:
            self._queue.appendleft(new)
        self.metrics.count(self.name, "preemptions_total")

    # -- prefill ----------------------------------------------------------
    def _prefill_phase(self):
        """Advance EVERY prefill-state slot one chunk (round-robin
        start), so a long prompt cannot monopolize the engine."""
        order = [self._slots[(self._prefill_rr + i) % self.slots]
                 for i in range(self.slots)]
        pending = [s for s in order if s.state == "prefill"]
        if pending:
            self._prefill_rr = (pending[0].idx + 1) % self.slots
        for slot in pending:
            if slot.state == "prefill":  # peers may preempt it mid-loop
                self._prefill_chunk_step(slot)

    def _prefill_chunk_step(self, slot):
        now = time.perf_counter()
        if slot.req.expired(now):
            self._finish(slot, "deadline")
            return
        n = min(self.prefill_chunk, len(slot.prompt) - slot.done)
        if not self._ensure_pages(slot, n):
            return
        chunk = slot.prompt[slot.done:slot.done + n]
        padded = onp.zeros(self.prefill_chunk, onp.int64)
        padded[:n] = chunk
        _, _, next_tok, _ = self._prefill_fn(
            self.params, self._kp, self._vp,
            torch.tensor(padded, device=self.device), slot.pos, n,
            self._tables_device()[slot.idx])
        slot.history.extend(chunk)
        slot.pos += n
        slot.done += n
        self.metrics.count(self.name, "prefill_tokens_total", n)
        if slot.done < len(slot.prompt):
            return
        # prompt fully cached: the prefill's last logits ARE the first
        # generated token — time-to-first-token lands here
        tok = int(next_tok)
        now = time.perf_counter()
        if not slot.req.ttft_recorded:
            self.metrics.observe_ttft(self.name, now - slot.req.t_enqueue)
            slot.req.ttft_recorded = True
        slot.generated.append(tok)
        slot.pending = tok
        slot.state = "decode"
        slot.t_last = now
        self._maybe_finish(slot, now)

    # -- decode -----------------------------------------------------------
    def _decode(self):
        batch = [s for s in self._slots if s.state == "decode"]
        if not batch:
            return
        try:
            faults.check("decode.step")
        except Exception as e:
            # a decode-step fault poisons the in-flight decode batch
            # (typed), frees its pages, and the engine keeps serving
            for s in batch:
                self._fail_slot(s, ServingError(
                    "decode step failed: %r" % (e,)))
            return
        live = []
        for s in batch:
            if s.state != "decode":
                continue  # preempted while a peer above grew its pages
            if s.req.expired(time.perf_counter()):
                self._finish(s, "deadline")
            elif self._ensure_pages(s, 1):
                live.append(s)
        live = [s for s in live if s.state == "decode"]  # after preemption
        if not live:
            return
        tokens = self._stage_tokens
        positions = self._stage_positions
        active = self._stage_active
        tokens.fill(0)
        positions.fill(0)
        active.fill(False)
        for s in live:
            tokens[s.idx] = s.pending
            positions[s.idx] = s.pos
            active[s.idx] = True
        t0 = time.perf_counter()
        dev = self.device
        _, _, next_tokens, _ = self._decode_fn(
            self.params, self._kp, self._vp, torch.tensor(tokens, device=dev),
            torch.tensor(positions, device=dev), self._tables_device(),
            torch.tensor(active, device=dev))
        next_tokens = next_tokens.cpu().numpy()
        now = time.perf_counter()
        for s in live:
            tok = int(next_tokens[s.idx])
            s.history.append(s.pending)
            s.pos += 1
            s.generated.append(tok)
            s.pending = tok
            self.metrics.observe_inter_token(self.name, now - s.t_last)
            s.t_last = now
            self._maybe_finish(s, now)
        self.metrics.observe_decode_step(
            self.name, now - t0, now - t0, len(live), self.slots,
            len(live))

    # -- completion -------------------------------------------------------
    def _maybe_finish(self, slot, now):
        req = slot.req
        if self.eos_id is not None and slot.pending == self.eos_id:
            self._finish(slot, "eos")
        elif len(slot.generated) + len(req.prefix) >= req.max_new:
            self._finish(slot, "length")
        elif req.expired(now):
            self._finish(slot, "deadline")

    def _finish(self, slot, reason):
        req = slot.req
        tokens = req.prefix + slot.generated
        now = time.perf_counter()
        self.alloc.free(slot.owner)
        self.metrics.count(self.name, "sequences_completed_total")
        self.metrics.observe_generate_done(self.name, now - req.t_enqueue)
        self.slo.observe_served(1)  # feeds the drain-rate estimator
        self._clear(slot)
        req.future.set_result({
            "tokens": tokens,
            "finish_reason": reason,
            "session": None,
            "prompt_tokens": req.prompt_tokens,
            "completion_tokens": len(tokens),
        })
        with self._cond:
            self._cond.notify_all()

    def _fail_slot(self, slot, exc):
        req = slot.req
        self.alloc.free(slot.owner)
        self.metrics.count(self.name, "errors_total")
        self._clear(slot)
        req.future.set_exception(exc)

    def _clear(self, slot):
        slot.req = None
        slot.state = "idle"
        slot.owner = None
        slot.generated = []
        slot.history = []
        slot.pending = None
        self._tables[slot.idx, :] = 0
        self._tables_dev = None

    # -- lifecycle / stats ------------------------------------------------
    @torch.no_grad()
    def _count_collectives(self):
        """The collective census of one tensor-parallel decode step: the
        ``_all_reduce`` calls of a step run with every slot inactive (it
        writes only the scratch page), counted by the plan."""
        dev, plan = self.device, self._tp_plan
        before = plan.all_reduces
        zeros = torch.zeros(self.slots, dtype=torch.int64, device=dev)
        self._decode_fn(
            self.params, self._kp, self._vp, zeros, zeros,
            torch.zeros((self.slots, self.pages_per_seq), dtype=torch.int32,
                        device=dev),
            torch.zeros(self.slots, dtype=torch.bool, device=dev))
        counts = dict.fromkeys(_COLLECTIVES, 0)
        counts["all-reduce"] = plan.all_reduces - before
        counts["total"] = sum(counts.values())
        return {"mesh": self.sharding.describe(), "tp": self.tp,
                "fused": self.decode_fused, "collectives": counts}

    @torch.no_grad()
    def warmup(self):
        """Run the prefill and decode programs once on dummy inputs that
        touch only the scratch page, so that the kernels are built before
        the first request.  Returns the number of programs run."""
        dev = self.device
        zrow = torch.zeros(self.pages_per_seq, dtype=torch.int32, device=dev)
        self._prefill_fn(self.params, self._kp, self._vp,
                         torch.zeros(self.prefill_chunk, dtype=torch.int64,
                                     device=dev), 0, 1, zrow)
        _, _, toks, _ = self._decode_fn(
            self.params, self._kp, self._vp,
            torch.zeros(self.slots, dtype=torch.int64, device=dev),
            torch.zeros(self.slots, dtype=torch.int64, device=dev),
            torch.zeros((self.slots, self.pages_per_seq), dtype=torch.int32,
                        device=dev),
            torch.zeros(self.slots, dtype=torch.bool, device=dev))
        toks.cpu()
        return 2

    def stop(self, drain=True, timeout=30.0):
        """Stop admissions; ``drain=True`` serves everything queued and
        in flight first.  Returns True when the worker exited."""
        with self._cond:
            self._stopping = True
            self._drain_mode = bool(drain)
            if not drain:
                for r in self._queue:
                    r.future.set_exception(ServerClosedError(
                        "decode engine stopped before this request ran"))
                self._queue.clear()
                for s in self._slots:
                    if s.active:
                        s.req.future.set_exception(ServerClosedError(
                            "decode engine stopped mid-generation"))
                        self.alloc.free(s.owner)
                        self._clear(s)
            self._cond.notify_all()
            worker = self._worker
        if worker is None:
            return True
        worker.join(timeout)
        return not worker.is_alive()

    def _fresh_pool(self, shape):
        """A zeroed KV page pool: an fp32 tensor, or int8 ``QPages``
        (codes, per-page-per-head scales).  Scales start at one, so the
        pages no token has opened (the scratch page, inactive slots)
        dequantize to zeros, as the fp pool does."""
        if self.kv_dtype == "int8":
            return _paged.QPages(
                q=torch.zeros(shape, dtype=torch.int8, device=self.device),
                s=torch.ones(shape[:3], dtype=torch.float32,
                             device=self.device))
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def _tokens_resident(self):
        """Logical tokens currently cached in pool pages."""
        with self._cond:
            return sum(s.pos for s in self._slots if s.active)

    def stats(self):
        with self._cond:
            active = sum(1 for s in self._slots if s.active)
            queued = len(self._queue)
        out = {"slots": self.slots, "active": active, "queued": queued,
               "steps": self.steps, "device": str(self.device),
               "page_size": self.page_size,
               "pages_per_seq": self.pages_per_seq,
               "prefill_chunk": self.prefill_chunk,
               "max_ctx": self.max_ctx,
               "slo": {"service_rate": self.slo.service_rate(),
                       "default_tier": self.slo.default_tier},
               "kv": self.alloc.stats(),
               "quant": {
                   "weights": self.quant[0] if self.quant else None,
                   "group": (self.quant[1] if self.quant
                             and len(self.quant) > 1 else None),
                   "kv_dtype": self.kv_dtype,
                   "tokens_resident": self._tokens_resident(),
               },
               "decode_fused": self.decode_fused,
               "launches": dict(self.launch_stats)}
        if self.sharding is not None:
            out["sharding"] = {
                "mesh": self.sharding.describe(), "tp": self.tp,
                "collectives": dict(self.collective_stats["collectives"])}
        return out
