"""Continuous-batching autoregressive decode engine over a paged KV cache.

The port of ``mxnet_tpu/serving/generate.py``, serving on the JAX engine's
defaults:

- **Iteration-level (continuous) batching** — the decode batch is
  re-formed every step: a sequence is admitted into a free slot the
  moment one opens, and evicted the step it finishes (EOS / max tokens /
  deadline).
- **Paged KV cache** — per-sequence KV lives in fixed-size pages handed
  out by ``kvcache.PageAllocator``; attention reads through per-slot
  page tables.  When the pool runs dry the engine first drops LRU
  prefix-cache entries, then **preempts** the youngest sequence (frees
  its pages, requeues it for recompute with its progress kept) instead
  of failing.
- **Chunked prefill** — prompts are cached ``prefill_chunk`` tokens per
  engine step, round-robin over the slots in prefill, interleaved with
  decode steps.
- **Async decode pipeline** (``async_decode``/``MXNET_GEN_ASYNC``, on by
  default) — the decode step splits into a *launch* half and a *retire*
  half with a depth-``dispatch_ahead`` (``MXNET_GEN_DISPATCH_AHEAD``)
  in-flight queue, all on the worker thread's one CUDA stream.  A
  launch's sampled tokens stay on the card and chain into the next
  launch (``decoder.make_token_combine`` only when lanes join); right
  after the launch a ``non_blocking`` copy of them into a pinned buffer
  is queued and a CUDA event recorded, and the retire half waits on that
  event.  Inputs go up from pinned staging rings (``_Ring``) with
  ``non_blocking`` copies; a plain upload from pageable memory would
  synchronise the stream and silently make the pipeline synchronous.
  Emission, EOS, admission and metrics shift to retire time; deadlines
  are judged at launch; pages an in-flight step writes are pinned (frees
  defer to that step's retire).  ``async_decode=False`` (or
  ``MXNET_GEN_ASYNC=0``) selects the synchronous loop; the greedy streams
  are the same either way.  A failing launch or event wait fails that
  flight's lanes typed; nothing falls back to the synchronous loop.
- **Copy-on-write prefix caching** (``prefix_cache``/
  ``MXNET_GEN_PREFIX_CACHE``, on by default) — prompt-prefix pages are
  content-addressed in ``kvcache.PrefixCache`` and attached to new
  sequences as shared references; a hit on the trailing partial page is
  forked (``paged_attention.copy_page``, codes and scales of int8 pages)
  before its first write lands.
- **Decode sessions** — a request carrying ``session=<id>`` parks its
  pages on completion; a later request with the same id continues
  decoding against the cached context.  Resuming a session the engine
  does not hold raises :class:`~.errors.SessionResetError`.
  :meth:`DecodeEngine.export_session` / :meth:`import_session` move a
  parked session between engines in the ``kvcache.pack_session`` wire
  format, byte for byte the JAX package's (v2 for int8 pages, with their
  scales).
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
  with a ``tp`` axis splits every layer Megatron-style over tp shards
  (``models.decoder.TPPlan``); the shards run in turn on the one card and
  their partial products are summed by ``models.decoder._all_reduce``.
  The KV pool stays one tensor on the card, so page ids, forks and
  session blobs are the same at any tp.  Quantized weights and int8 KV
  pages serve under ``sharding=`` through the per-op TP step.
- **Speculative decoding** (``speculate``/``MXNET_GEN_SPECULATE``, off by
  default) — a drafter (n-gram prompt lookup or a small draft model,
  ``serving/speculate``) proposes up to ``spec_k`` tokens per decode slot,
  one wide verify step (``decoder.make_verify_step``) scores the whole
  batch, longest-prefix greedy acceptance keeps what the target itself
  would emit, and the pages rejected positions opened are trimmed
  (``_rollback_kv``, copy-on-write aware).  A per-sequence adaptive-k
  controller turns speculation off for a sequence whose drafts stop
  landing.  On the async loop a verify's input depends on the host's
  acceptance, so a verify retires before the next launch instead of
  chaining; a host drafter drafts the next step while the verify is in
  flight (``reuse_predraft``; a draft model, whose launches would queue
  behind the verify, drafts at launch) and slots whose end is decided
  park in ``finishing`` until the deferred bookkeeping runs, or until
  page growth finds the pool dry.  Fp, quantized and
  tensor-parallel engines speculate alike.

The KV page pools are tensors on the engine's device, updated in place by
every step (the JAX engine donates them to each jitted step instead).
The engine runs on ``cuda`` unless ``device="cpu"`` is passed, in which
case every kernel's plain PyTorch version serves.

Not ported yet, and refused with ``NotImplementedError``: the fleet page
store (``pagestore=``/``MXNET_GEN_PAGESTORE``, ``migrate=True``,
:meth:`DecodeEngine.migrate_out`) and role specialization (``role=``/
``MXNET_GEN_ROLE``).

Admission control mirrors the JAX engine: a bounded queue sheds with
``QueueFullError``, draining rejects with ``ServerClosedError``,
deadlines expire typed, and a failed sequence poisons only its own
future.  Fault sites: ``decode.step``, ``engine.retire``,
``kvcache.alloc``, ``session.export``, ``session.import``,
``speculate.draft`` and ``speculate.verify``.
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
                     ServerClosedError, ServingError, SessionResetError)
from .kvcache import (CacheOOM, PageAllocator, PrefixCache, pack_session,
                      pages_for, unpack_session)
from .metrics import ServingMetrics
from .quantize import quantize_lm

__all__ = ["DecodeEngine"]

_log = logging.getLogger(__name__)


class _Request:
    __slots__ = ("prompt", "max_new", "deadline", "future", "session",
                 "resume", "t_enqueue", "prefix", "ttft_recorded",
                 "prompt_tokens", "started", "tier", "tenant", "rank",
                 "vstart")

    def __init__(self, prompt, max_new, deadline, session, resume,
                 tier="latency", tenant=None, rank=0, vstart=0.0):
        self.prompt = list(prompt)
        self.prompt_tokens = len(self.prompt)  # as submitted (reporting)
        self.max_new = int(max_new)
        self.deadline = deadline          # absolute perf_counter or None
        self.session = session
        self.resume = bool(resume)
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
                 "idx", "cacheable", "flight", "predraft")

    def __init__(self, idx):
        self.idx = idx
        self.req = None
        self.owner = None
        # idle | prefill | decode | finishing (the async speculative
        # pipeline parks a slot whose end its retire decided there, until
        # the deferred bookkeeping finishes it)
        self.state = "idle"
        self.flight = 0       # launched-but-unretired lanes (async)
        self.predraft = None  # the overlapped draft (async speculation)

    @property
    def active(self):
        return self.state != "idle"


class _Flight:
    """One launched-but-unretired decode step (async engine).

    ``out`` is the step's ``next_tokens`` on the card (the next launch
    chains on it); ``host`` the pinned buffer a ``non_blocking`` copy of
    it lands in, and ``event`` the CUDA event recorded after that copy
    (None on the CPU, where ``host`` is ``out``).  A speculative engine's
    flight is ``kind`` "verify" (``out`` the (B, width) argmax of a wide
    verify step) or "plain", and ``fed`` maps each lane's slot index to
    the token row it fed (pending token, then its draft).  ``lanes`` are the
    ``(slot, admit_seq-at-launch)`` pairs it carries — a slot recycled
    since launch fails the seq check and its lane is discarded;
    ``owners`` the page owners the step writes (pinned: their pages are
    not recycled until this retire); ``on_retire`` the deferred page
    releases of sequences that ended while the step was in flight."""

    __slots__ = ("out", "host", "event", "t_launch", "lanes", "owners",
                 "on_retire", "kind", "fed")

    def __init__(self, out, host, event, t_launch, lanes, owners,
                 kind="plain", fed=None):
        self.out = out
        self.host = host
        self.event = event
        self.t_launch = t_launch
        self.lanes = lanes
        self.owners = owners
        self.on_retire = []
        self.kind = kind
        self.fed = fed or {}


class _Session:
    __slots__ = ("sid", "owner", "pos", "pending", "history", "last_used",
                 "busy", "replay", "gen")

    def __init__(self, sid, owner):
        self.sid = sid
        self.owner = owner
        self.pos = 0
        self.pending = None
        self.history = []
        self.last_used = time.monotonic()
        self.busy = False
        # a transcript record (``_install_record``) parks here until the
        # next request replays it; gen is the record's generation fence
        self.replay = None
        self.gen = 0


class _Ring:
    """``n`` host buffers of one shape and dtype — pinned on a CUDA
    engine — with their device twins and the CUDA event recorded after
    each buffer's last copy.

    A ``non_blocking`` copy runs in stream order, behind every step
    launched before it, and reads (or writes) its host buffer only then;
    so a buffer is refilled only once its event has passed.  The engine
    sizes each ring so that this holds without waiting (the buffer's last
    user has retired); ``waits`` counts the times it did not.  On the CPU
    :meth:`upload` returns a fresh tensor and :meth:`download` the tensor
    itself: there every call has finished when it returns."""

    def __init__(self, n, shape, dtype, device, twins=True):
        self.cuda = device.type == "cuda"
        self.waits = 0
        self._next = 0
        if not self.cuda:
            return
        self.host = [torch.zeros(shape, dtype=dtype, pin_memory=True)
                     for _ in range(n)]
        self.dev = [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(n)] if twins else None
        self.events = [torch.cuda.Event() for _ in range(n)]

    def _take(self):
        i = self._next
        self._next = (i + 1) % len(self.host)
        ev = self.events[i]
        if not ev.query():
            self.waits += 1
            ev.synchronize()
        return i

    def upload(self, array):
        """The device copy of the numpy ``array``, queued without a host
        wait."""
        if not self.cuda:
            return torch.from_numpy(onp.array(array))
        i = self._take()
        self.host[i].numpy()[...] = array
        self.dev[i].copy_(self.host[i], non_blocking=True)
        self.events[i].record()
        return self.dev[i]

    def download(self, tensor):
        """Queue a copy of the device ``tensor`` into the next host buffer;
        returns ``(buffer, event)``, the buffer valid once the event has
        passed."""
        if not self.cuda:
            return tensor, None
        i = self._take()
        self.host[i].copy_(tensor, non_blocking=True)
        self.events[i].record()
        return self.host[i], self.events[i]


def _not_ported(what):
    raise NotImplementedError(
        "%s is not ported to mxnet_tpu_torch yet (the JAX package "
        "mxnet_tpu.serving.DecodeEngine has it)" % what)


def _refuse_unported(role, migrate, pagestore):
    """Raise NotImplementedError for every feature of the JAX engine that
    the port lacks and the caller (or the environment) asks for."""
    arg = migrate or pagestore
    if arg or (arg is None and _config.requested("MXNET_GEN_PAGESTORE")):
        _not_ported("session migration through the fleet page store "
                    "(kvstore/pagestore.py)")
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


def _accept(row, preds):
    """Longest-prefix greedy acceptance of one slot's verify: draft token
    ``i`` survives iff it equals the target's own argmax after everything
    before it, so the emitted tokens are exactly what plain decode would
    give.  ``row`` is [pending, draft...], ``preds`` the verify's argmax at
    each of its positions; returns (emitted tokens, accepted drafts)."""
    preds = [int(t) for t in preds]
    accepted = 0
    while accepted < len(row) - 1 and row[accepted + 1] == preds[accepted]:
        accepted += 1
    return preds[:accepted + 1], accepted


#: the collective classes of the JAX package's census
#: (``parallel/shardcfg.py:851``)
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


class DecodeEngine:
    """Continuous-batching decode scheduler for one causal LM.

    ``model`` is a :class:`mxnet_tpu_torch.models.decoder.CausalLM` whose
    parameters live on ``device`` (``cuda`` unless ``"cpu"`` is passed;
    with no GPU and no device given, construction raises).  One worker
    thread owns the KV pages and re-forms the decode batch every step;
    session exports and imports run on it as queued worker ops.

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
      session_ttl_s  — idle parked-session lifetime
                       (``MXNET_GEN_SESSION_TTL``)
      prefix_cache   — copy-on-write prefix caching
                       (``MXNET_GEN_PREFIX_CACHE``, on)
      async_decode   — the async decode pipeline (``MXNET_GEN_ASYNC``, on)
      dispatch_ahead — launched-but-unretired decode steps
                       (``MXNET_GEN_DISPATCH_AHEAD``, 1)

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

    ``speculate`` (``MXNET_GEN_SPECULATE``) turns speculative decoding on:
    ``drafter`` a ``speculate.Drafter``, or "ngram" / "model"
    (``MXNET_GEN_SPEC_DRAFTER``), ``draft_model`` the draft ``CausalLM``
    (default ``decoder.decoder_draft`` of the target, or
    ``MXNET_GEN_SPEC_DRAFT_BUILDER``), ``spec_k`` the depth cap
    (``MXNET_GEN_SPEC_K``); ``stats()["speculative"]`` reports the
    scheduler, and ``verify_launch_stats(width)`` a verify step's kernel
    launches.
    """

    def __init__(self, model, *, name="llm", slots=None, page_size=None,
                 total_pages=None, max_ctx=None, prefill_chunk=None,
                 eos_id=None, max_queue_depth=256, metrics=None,
                 device=None, session_ttl_s=None,
                 prefix_cache=None, async_decode=None, dispatch_ahead=None,
                 role=None, migrate=None, pagestore=None, speculate=None,
                 spec_k=None, drafter=None, draft_model=None, sharding=None,
                 quantize=None, quant_group=None, kv_dtype=None):
        _refuse_unported(role, migrate, pagestore)
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
        self.session_ttl_s = float(
            session_ttl_s if session_ttl_s is not None
            else _config.get("MXNET_GEN_SESSION_TTL"))

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
        self._sessions = {}           # sid -> _Session (parked or busy)
        self._queue = collections.deque()
        self.slo = SLOPolicy()
        self._cond = threading.Condition()
        self._worker = None
        self._stopping = False
        self._drain_mode = True
        self._seq = 0                 # admission counter (owner ids)
        self._prefill_rr = 0
        self.steps = 0
        use_pfx = (bool(prefix_cache) if prefix_cache is not None
                   else bool(_config.get("MXNET_GEN_PREFIX_CACHE")))
        self.prefix_cache = PrefixCache(self.alloc) if use_pfx else None
        self._ops = collections.deque()   # (fn, Future|None) — worker ops

        # the async decode pipeline: launch/retire halves with a bounded
        # in-flight queue (see the module docstring and _decode_async)
        self.async_decode = (bool(async_decode) if async_decode is not None
                             else bool(_config.get("MXNET_GEN_ASYNC")))
        self.dispatch_ahead = max(1, int(
            dispatch_ahead if dispatch_ahead is not None
            else _config.get("MXNET_GEN_DISPATCH_AHEAD")))
        self._pipe = collections.deque()  # in-flight _Flight entries
        self._flight_owners = {}          # owner -> in-flight refcount
        self._t_force_end = None          # last forced-read end (host gap)
        self._spec_rec = None             # retired spec step, finishes due
        self._t_last_retire = None        # retire cadence (decode_step)
        self._combine = _decoder.make_token_combine(self.slots)
        # last prefill chunks whose first-token read waited for flights
        self.prefill_drains = 0
        # batch formation fills these host arrays in place every step;
        # the rings below carry them to the card.  A launch's inputs and
        # its token read-back each take the next set of a ring of
        # dispatch_ahead + 1, whose last user has retired by then; the
        # page tables and prefill tokens, uploaded a variable number of
        # times a step, take rings one slot-count longer
        n = self.dispatch_ahead + 1
        dev, B, pps = self.device, self.slots, self.pages_per_seq
        self._stage_tokens = onp.zeros(B, onp.int32)
        self._stage_positions = onp.zeros(B, onp.int32)
        self._stage_active = onp.zeros(B, bool)
        self._stage_carry = onp.zeros(B, bool)
        self._rings = {
            "tokens": _Ring(n, (B,), torch.int32, dev),
            "positions": _Ring(n, (B,), torch.int32, dev),
            "active": _Ring(n + 1, (B,), torch.bool, dev),
            "carry": _Ring(n, (B,), torch.bool, dev),
            "out": _Ring(n, (B,), torch.int32, dev, twins=False),
            "tables": _Ring(n + B + 1, (B, pps), torch.int32, dev),
            "prefill": _Ring(n + B, (self.prefill_chunk,), torch.int64, dev),
        }
        self._active_dev = None
        self._active_key = None

        # speculative decoding (MXNET_GEN_SPECULATE): a drafter proposes k
        # tokens per decode slot and one wide verify step scores them all
        # (see serving/speculate.py)
        self._spec = None
        self._verify_fns = {}             # width -> verify step
        use_spec = (bool(speculate) if speculate is not None
                    else bool(_config.get("MXNET_GEN_SPECULATE")))
        if use_spec:
            self._spec = self._build_spec(drafter, draft_model, spec_k)

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
        "completion_tokens"}``.  Shed/deadline/reset failures rethrow
        typed at ``future.result()`` (or synchronously at submit for
        admission-time refusals).  ``session`` parks the sequence's pages
        when it finishes; ``resume=True`` requires the session to be held
        (else :class:`SessionResetError`)."""
        rank, vstart = self.slo.stamp(tier, tenant)
        tier = self.slo.normalize_tier(tier)
        prompt = [int(t) for t in prompt]
        if not prompt and not (resume and session is not None):
            # an empty prompt is legal only as a resume continuation
            raise BadRequestError("generate: prompt must be non-empty")
        if any(t < 0 or t >= self.cfg.vocab_size for t in prompt):
            raise BadRequestError(
                "generate: token ids must be in [0, %d)"
                % self.cfg.vocab_size)
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise BadRequestError("generate: max_tokens must be >= 1")
        if session is None and len(prompt) + max_new > self.max_ctx:
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
            if resume and session is not None \
                    and session not in self._sessions:
                self.metrics.count(self.name, "sessions_reset_total")
                raise SessionResetError(
                    "session %r is not held by this engine (expired, "
                    "evicted or never parked); restart generation"
                    % (session,))
            req = _Request(prompt, max_new, deadline, session, resume,
                           tier=tier, tenant=tenant, rank=rank,
                           vstart=vstart)
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
                           and not self._ops and not self._pipe
                           and not any(s.active for s in self._slots)):
                        self._cond.wait(0.1)
                        self._expire_sessions_locked()
                    if self._stopping:
                        busy = (any(s.active for s in self._slots)
                                or self._ops or self._pipe
                                or (self._drain_mode and self._queue))
                        if not busy:
                            return
                try:
                    self._step()
                except Exception as e:
                    # a failed step fails the sequences it carried (typed,
                    # with the cause) and drops the flights in the pipe;
                    # the engine keeps serving the queue
                    _log.exception("decode engine step failed")
                    self._flush_pipe(discard=True)
                    for s in self._slots:
                        if s.active:
                            self._fail_slot(s, ServingError(
                                "engine step failed: %r" % (e,)))

    def _step(self):
        now = time.perf_counter()
        if self._pipe:
            with self._cond:
                ops = bool(self._ops)
            if ops:
                # worker ops (session imports/exports) read or rewrite the
                # page pools and tables: run them on retired state
                self._flush_pipe()
        self._drain_ops()
        self._expire_queued(now)
        with self._cond:
            self._expire_sessions_locked()
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

    def _drain_ops(self):
        """Run queued worker-thread ops (session imports/exports).  Only
        the worker touches the page pools, so other threads enqueue here
        and the ops run at step start — imports land before this step's
        admissions."""
        while True:
            with self._cond:
                if not self._ops:
                    return
                fn, fut = self._ops.popleft()
            try:
                out = fn()
            except Exception as e:
                fut.set_exception(e)
            else:
                fut.set_result(out)

    def _run_op(self, fn, timeout=30.0):
        """Run ``fn`` on the worker thread, the only thread that touches
        the page pools.  Runs inline when no worker is alive (stopped or
        never-started engine) or when called from the worker itself."""
        with self._cond:
            worker = self._worker
            if (worker is not None and worker.is_alive()
                    and worker is not threading.current_thread()):
                fut = Future()
                self._ops.append((fn, fut))
                self._cond.notify_all()
            else:
                fut = None
        if fut is None:
            with torch.no_grad():
                return fn()
        return fut.result(timeout)

    # -- sessions: export / import ------------------------------------------
    def _install_record(self, sid, rec, gen):
        """Materialize a session record as a parked session (worker thread
        only): ``{"kind": "pages", "blob"}`` scatters a ``pack_session``
        blob into the pool (bit-exact) and falls back to replaying its
        transcript when that fails; ``{"kind": "transcript", "history",
        "pending"}`` parks the tokens for the next request to replay as a
        fresh prefill.  The JAX engine takes these records from its page
        store, which the port has not ported."""
        faults.check("session.import")
        if rec.get("kind") == "pages":
            try:
                self._install_pages(sid, bytes(rec["blob"]), gen)
                self.metrics.count(self.name, "migrations_in_total")
                return sid
            except Exception as e:
                try:
                    meta, _k, _v = unpack_session(bytes(rec["blob"]))
                except ValueError:
                    raise e from None
                _log.warning(
                    "session %r page import failed (%r); falling back to "
                    "transcript replay", sid, e)
                rec = {"kind": "transcript",
                       "history": meta.get("history", []),
                       "pending": meta.get("pending")}
        hist = [int(t) for t in rec.get("history") or []]
        pending = rec.get("pending")
        sess = _Session(sid, None)
        sess.replay = hist + ([int(pending)] if pending is not None else [])
        sess.gen = int(gen)
        with self._cond:
            self._sessions[sid] = sess
        self.metrics.count(self.name, "migrations_in_total")
        return sid

    def _install_pages(self, sid, blob, gen=None):
        """Unpack a ``pack_session`` blob into fresh pool pages and park
        the session (worker thread only).  A KV-dtype mismatch between the
        blob and this engine raises typed: int8 codes are only meaningful
        next to their page scales."""
        meta, k, v, ks, vs = unpack_session(blob, with_scales=True)
        sid = sid if sid is not None else meta["sid"]
        cfg = self.cfg
        blob_kv = "int8" if ks is not None else "float32"
        if blob_kv != self.kv_dtype:
            raise ValueError(
                "imported session KV dtype %r does not match this "
                "engine's %r (weight-only requantization is lossy; "
                "resume via transcript replay instead)"
                % (blob_kv, self.kv_dtype))
        want = (cfg.num_layers, cfg.num_kv_heads, self.page_size,
                cfg.head_dim)
        got = (k.shape[0], k.shape[1], k.shape[3], k.shape[4])
        if got != want:
            raise ValueError(
                "imported session KV geometry %r does not match this "
                "engine's %r" % (got, want))
        n = k.shape[2]
        self._seq += 1
        owner = ("imp", self._seq)
        while True:
            try:
                pages = self.alloc.alloc(owner, n) if n else []
                break
            except CacheOOM:
                if not self._reclaim(keep=sid):
                    raise
        if n:
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            dev = self.device
            if ks is not None:
                self._kp.q[:, :, idx] = torch.from_numpy(k.copy()).to(dev)
                self._kp.s[:, :, idx] = torch.from_numpy(ks.copy()).to(dev)
                self._vp.q[:, :, idx] = torch.from_numpy(v.copy()).to(dev)
                self._vp.s[:, :, idx] = torch.from_numpy(vs.copy()).to(dev)
            else:
                self._kp[:, :, idx] = torch.from_numpy(k.copy()).to(dev)
                self._vp[:, :, idx] = torch.from_numpy(v.copy()).to(dev)
        sess = _Session(sid, owner)
        sess.pos = int(meta["pos"])
        sess.pending = (int(meta["pending"])
                        if meta.get("pending") is not None else None)
        sess.history = [int(t) for t in meta.get("history") or []]
        sess.gen = int(gen if gen is not None else meta.get("gen", 0))
        with self._cond:
            self._sessions[sid] = sess
        return sid

    def _export_state(self, sid, pos, pending, history, owner, gen):
        """Serialize one sequence's page table and live KV pages into a
        ``pack_session`` buffer (worker thread only, on a flushed pipe).
        Shared prefix pages are copied out like any other page; int8 pages
        ship as codes plus their scales (format v2)."""
        faults.check("session.export")
        pages = self.alloc.pages(owner)
        cfg = self.cfg
        ks = vs = None
        if pages:
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            if self.kv_dtype == "int8":
                k = self._kp.q[:, :, idx].cpu().numpy()
                v = self._vp.q[:, :, idx].cpu().numpy()
                ks = self._kp.s[:, :, idx].cpu().numpy()
                vs = self._vp.s[:, :, idx].cpu().numpy()
            else:
                k = self._kp[:, :, idx].cpu().numpy()
                v = self._vp[:, :, idx].cpu().numpy()
        else:
            shape = (cfg.num_layers, cfg.num_kv_heads, 0, self.page_size,
                     cfg.head_dim)
            if self.kv_dtype == "int8":
                k = onp.zeros(shape, onp.int8)
                v = onp.zeros(shape, onp.int8)
                ks = onp.zeros(shape[:3], onp.float32)
                vs = onp.zeros(shape[:3], onp.float32)
            else:
                k = onp.zeros(shape, onp.float32)
                v = onp.zeros(shape, onp.float32)
        meta = {"sid": sid, "pos": int(pos),
                "pending": int(pending) if pending is not None else None,
                "history": [int(t) for t in history],
                "gen": int(gen)}
        return pack_session(meta, k, v, ks, vs)

    def export_session(self, session):
        """Serialize a parked session into a flat buffer;
        :meth:`import_session` on any engine with the same model geometry
        and KV dtype restores it bit-exactly (same pages, same greedy
        continuation).  Raises ``KeyError`` for unknown sessions and
        ``RuntimeError`` for busy or replay-pending ones."""
        def op():
            with self._cond:
                sess = self._sessions.get(session)
                if sess is None:
                    raise KeyError("unknown session %r" % (session,))
                if sess.busy:
                    raise RuntimeError(
                        "session %r is mid-generation; drain first"
                        % (session,))
                if sess.replay is not None:
                    raise RuntimeError(
                        "session %r holds a replay transcript, not pages"
                        % (session,))
            return self._export_state(session, sess.pos, sess.pending,
                                      sess.history, sess.owner, sess.gen)
        return self._run_op(op)

    def import_session(self, blob, gen=None):
        """Install an :meth:`export_session` buffer as a parked session on
        this engine; returns the session id."""
        def op():
            faults.check("session.import")
            sid = self._install_pages(None, bytes(blob), gen)
            self.metrics.count(self.name, "migrations_in_total")
            return sid
        return self._run_op(op)

    def migrate_out(self):
        """Ship every parked session to the fleet page store: not ported
        (the port has no ``kvstore/pagestore.py`` client)."""
        _not_ported("migrate_out() (session migration through the fleet "
                    "page store, kvstore/pagestore.py)")

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

    def _expire_sessions_locked(self):
        if not self.session_ttl_s:
            return
        cutoff = time.monotonic() - self.session_ttl_s
        for sid in [sid for sid, s in self._sessions.items()
                    if not s.busy and s.last_used < cutoff]:
            sess = self._sessions.pop(sid)
            self._free_owner(sess.owner)
            self._spec_release(sess.owner, sid)

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
                req = self._queue[0]
                sess = (self._sessions.get(req.session)
                        if req.session is not None else None)
                if sess is not None and sess.busy:
                    return  # head-of-line: continuation waits for its turn
                self._queue.popleft()
            self.slo.on_dispatch(req.vstart)
            if not self._activate(slot, req, sess):
                return

    def _activate(self, slot, req, sess):
        """Place ``req`` into ``slot``; returns False when admission must
        pause (page watermark) — the request goes back to the head."""
        if req.session is not None and sess is None \
                and self._resume_missing(req):
            return True  # rejected typed; keep admitting
        replaying = False
        pfx_pages, pfx_partial = [], False
        if sess is not None and sess.replay is not None:
            # a transcript record: rebuild the pages by replaying the
            # whole conversation as a fresh prefill (recompute gives the
            # cache a preempted sequence would rebuild)
            prefill = list(sess.replay) + req.prompt
            base, history = 0, []
            self._seq += 1
            owner = ("req", self._seq)
            replaying = True
        elif sess is not None:
            # the session's last emitted token was never fed back; it
            # leads the continuation prompt (None: parked mid-prefill)
            prefill = (([sess.pending] if sess.pending is not None else [])
                       + req.prompt)
            base, owner = sess.pos, sess.owner
            history = list(sess.history)
        else:
            prefill = list(req.prompt)
            base, history = 0, []
            self._seq += 1
            owner = ("req", self._seq)
        if ((sess is None or replaying) and self.prefix_cache is not None
                and len(prefill) > 1):
            # fresh prompts and replayed transcripts prefill from zero:
            # both skip whatever prefix the cache already holds
            pages, covered, pfx_partial = self.prefix_cache.lookup(prefill)
            if covered:
                pfx_pages = pages
                history = prefill[:covered]
                prefill = prefill[covered:]
                base = covered
        if not prefill:
            req.future.set_exception(BadRequestError(
                "generate: nothing to prefill (empty prompt and no "
                "pending session context)"))
            if sess is not None:
                sess.last_used = time.monotonic()
            return True
        remaining_new = req.max_new - len(req.prefix)
        final_ctx = base + len(prefill) + max(0, remaining_new - 1)
        if final_ctx > self.max_ctx:
            req.future.set_exception(BadRequestError(
                "generate: session context (%d) + prompt + max_tokens "
                "exceeds max_ctx=%d" % (base, self.max_ctx)))
            if sess is not None:
                sess.last_used = time.monotonic()
            return True
        if pfx_pages:
            # take the shared references now, so that pool-pressure
            # eviction below cannot free the pages under the hit
            self.alloc.share(owner, pfx_pages)
        # watermark: enough pages to finish prefill + the first decode
        # token (plus one for the copy-on-write fork of a shared partial
        # page), otherwise leave it queued until evictions free pages —
        # under pressure, prefix-cache entries go first (LRU), then idle
        # parked sessions (their later resume resets typed)
        need_now = (pages_for(base + len(prefill) + 1, self.page_size)
                    - len(self.alloc.pages(owner))
                    + (1 if pfx_partial else 0))
        while (need_now > self.alloc.num_free
               and self._reclaim(keep=req.session)):
            pass
        if need_now > self.alloc.num_free:
            if pfx_pages or replaying:
                self.alloc.free(owner)  # drop shared refs; retry relooks
            with self._cond:
                self._queue.appendleft(req)
            return False
        if not req.started and not req.future.set_running_or_notify_cancel():
            if pfx_pages or replaying:
                self.alloc.free(owner)
            return True  # client cancelled while queued
        req.started = True
        self._seq += 1
        slot.req = req
        slot.state = "prefill"
        slot.owner = owner
        slot.prompt = prefill
        slot.done = 0
        slot.pos = base
        slot.history = history
        slot.generated = []
        slot.pending = None
        slot.flight = 0
        slot.t_last = time.perf_counter()
        slot.admit_seq = self._seq
        slot.cacheable = (self.prefix_cache is not None
                          and (sess is None or replaying))
        if req.session is not None:
            sess = self._sessions.get(req.session)
            if sess is None:
                sess = self._sessions[req.session] = _Session(
                    req.session, owner)
            if replaying:
                sess.replay = None
                sess.owner = owner
                sess.pos = 0
                sess.pending = None
                sess.history = []
                self.metrics.count(self.name, "migrations_replayed_total")
            sess.busy = True
        if pfx_pages:
            self.metrics.count(self.name, "prefix_hits_total")
            self.metrics.count(self.name, "prefix_tokens_saved_total",
                               base)
            if pfx_partial:
                # the trailing shared page is partially filled and this
                # sequence will write into it: fork copy-on-write before
                # the first divergent write lands.  The copy is queued on
                # the stream behind every launch that wrote the page, and
                # it is the pool's one tensor at any tp
                old = pfx_pages[-1]
                new = self.alloc.fork(owner, old)
                _paged.copy_page(self._kp, old, new)
                _paged.copy_page(self._vp, old, new)
                self.metrics.count(self.name, "cow_forks_total")
        self.metrics.count(self.name, "sequences_total")
        self._sync_table(slot)
        return True

    def _reclaim(self, keep=None):
        """Free pool pages under pressure: LRU prefix-cache entries first
        (pure capacity, nothing breaks), then idle parked sessions.
        Returns True while there is anything left to try."""
        if self.prefix_cache is not None and self.prefix_cache.evict_one():
            return True
        return self._evict_lru_session(keep=keep)

    def _evict_lru_session(self, keep=None):
        """Reclaim the least-recently-used idle parked session's pages
        (cache pressure).  Returns True when one was evicted."""
        with self._cond:
            idle = [s for s in self._sessions.values()
                    if not s.busy and s.sid != keep]
            if not idle:
                return False
            victim = min(idle, key=lambda s: s.last_used)
            del self._sessions[victim.sid]
        self._free_owner(victim.owner)
        self._spec_release(victim.owner, victim.sid)
        return True

    def _resume_missing(self, req):
        """resume=True but the session is gone (TTL, eviction, preemption):
        reject typed.  Returns True when the request was rejected."""
        if req.resume:
            self.metrics.count(self.name, "sessions_reset_total")
            req.future.set_exception(SessionResetError(
                "session %r is not held by this engine (expired, evicted "
                "or never parked); restart generation" % (req.session,)))
            return True
        return False

    def _sync_table(self, slot):
        row = self.alloc.pages(slot.owner)
        self._tables[slot.idx, :] = 0
        if row:
            self._tables[slot.idx, :len(row)] = row
        self._tables_dev = None  # invalidate the device copy

    def _tables_device(self):
        if self._tables_dev is None:
            self._tables_dev = self._rings["tables"].upload(self._tables)
        return self._tables_dev

    def _active_device(self, mask):
        """Device copy of the active mask, uploaded only when the
        membership changes (steady-state steps reuse it)."""
        key = mask.tobytes()
        if self._active_key != key:
            self._active_dev = self._rings["active"].upload(mask)
            self._active_key = key
        return self._active_dev

    # -- in-flight page pinning (async pipeline) --------------------------
    def _pin_owners(self, fl):
        for o in fl.owners:
            self._flight_owners[o] = self._flight_owners.get(o, 0) + 1

    def _unpin_owners(self, fl):
        for o in fl.owners:
            n = self._flight_owners.get(o, 0) - 1
            if n > 0:
                self._flight_owners[o] = n
            else:
                self._flight_owners.pop(o, None)

    def _free_owner(self, owner):
        """Release an owner's pool pages, deferred past any in-flight step
        that still writes them.  On one stream a later write to a recycled
        page lands after the in-flight step's anyway; the deferral keeps
        the allocator's state and ``check_leaks`` equal to the JAX
        engine's, where the free list must never recycle a page an
        unretired launch targets."""
        if owner is None:
            return
        with self._cond:
            if self._flight_owners.get(owner):
                for fl in reversed(self._pipe):
                    if owner in fl.owners:
                        fl.on_retire.append(
                            lambda o=owner: self.alloc.free(o))
                        return
        self.alloc.free(owner)

    def _ensure_pages(self, slot, tokens_ahead):
        """Grow the slot's page list to cover ``tokens_ahead`` more cache
        positions; on exhaustion drops LRU prefix-cache entries, then
        preempts the youngest other sequence.  Returns False when the SLOT
        ITSELF was failed (nothing fits)."""
        need = (pages_for(slot.pos + tokens_ahead, self.page_size)
                - len(self.alloc.pages(slot.owner)))
        while need > 0:
            try:
                self.alloc.alloc(slot.owner, need)
                self._sync_table(slot)
                return True
            except CacheOOM:
                if self._pipe:
                    # pages of sequences that ended (or are preempted
                    # below) while a flight writes them free only at its
                    # retire: retire the flights first, so that relief
                    # frees pages now.  (The JAX engine preempts against
                    # pinned pages here and can fail a prompt that fits.)
                    self._flush_pipe()
                    if slot.req is None or slot.state not in ("prefill",
                                                              "decode"):
                        return False  # the flush finished or failed it
                    continue
                # likewise the slots a retired spec step decided but whose
                # finishes still wait behind this launch
                if self._finish_decided():
                    continue
                # cheapest relief first: drop an LRU prefix-cache entry
                # (pure capacity) before preempting live work
                if self.prefix_cache is not None \
                        and self.prefix_cache.evict_one():
                    continue
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
        self._sync_table(slot)
        return True

    def _preempt_victim(self, exclude):
        victim = None
        for s in self._slots:
            # "finishing" slots are done: their result is decided, and a
            # preempt-recompute would replay a completed stream
            if s.active and s is not exclude and s.state != "finishing":
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
        new = _Request(recompute, req.max_new, req.deadline, req.session,
                       False, tier=req.tier, tenant=req.tenant,
                       rank=req.rank, vstart=req.vstart)
        new.future = req.future
        new.started = req.started
        new.t_enqueue = req.t_enqueue
        new.prefix = req.prefix + slot.generated
        new.ttft_recorded = req.ttft_recorded
        new.prompt_tokens = req.prompt_tokens
        self._free_owner(slot.owner)
        self._spec_release(slot.owner)  # the draft cache goes with the pages
        if req.session is not None:
            # the parked context is gone with the pages; the requeued
            # request re-creates the session from the full history
            self._sessions.pop(req.session, None)
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
            self._rings["prefill"].upload(padded), slot.pos, n,
            self._tables_device()[slot.idx])
        slot.history.extend(chunk)
        slot.pos += n
        slot.done += n
        self.metrics.count(self.name, "prefill_tokens_total", n)
        if slot.done < len(slot.prompt):
            return
        # prompt fully cached: the prefill's last logits ARE the first
        # generated token — time-to-first-token lands here
        if slot.cacheable:
            # publish the prompt's pages for prefix sharing (refcount
            # bumps only).  Decode keeps writing into the trailing partial
            # page, but only past its published token count, which hitters
            # never read (and a hitter forks it copy-on-write anyway)
            self.prefix_cache.insert(list(slot.history),
                                     self.alloc.pages(slot.owner))
        if self._pipe:
            # the read below waits for the flights queued before this
            # chunk: a completing prompt drains the pipe (the JAX engine
            # blocks here too)
            self.prefill_drains += 1
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
        if self.async_decode:
            return self._decode_async()
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
        if self._spec is not None and self._decode_speculative(live):
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
        if self._t_force_end is not None:
            # host gap: wall time this step spent on scheduling between the
            # previous result landing and this launch going out (what the
            # async pipeline hides behind the in-flight step)
            self.metrics.observe_host_gap(
                self.name, max(0.0, t0 - self._t_force_end))
        rings = self._rings
        _, _, next_tokens, _ = self._decode_fn(
            self.params, self._kp, self._vp, rings["tokens"].upload(tokens),
            rings["positions"].upload(positions), self._tables_device(),
            self._active_device(active))
        next_tokens = next_tokens.cpu().numpy()
        now = time.perf_counter()
        self._t_force_end = now
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

    # -- async decode pipeline --------------------------------------------
    def _decode_async(self):
        """Launch step N+1 while step N's tokens are still on their way
        to the host, then retire launches down to the dispatch depth.  The
        sampled tokens stay on the card and chain into the next launch;
        the host reads a step's tokens (its event wait) only once the
        next launch is queued, so scheduling hides behind the card's
        work.  A speculative engine runs :meth:`_decode_async_spec`."""
        if self._spec is not None:
            return self._decode_async_spec()
        launched = self._launch_decode()
        limit = self.dispatch_ahead if launched else 0
        while len(self._pipe) > limit:
            self._retire_one()

    def _launch_decode(self):
        """Queue one decode step without waiting for in-flight results.
        Lanes with work in flight take their input token from the newest
        launch's output on the card (``carry``); fresh lanes stage theirs
        from the host.  Launch-time exclusions (budget, context, deadline)
        count in-flight lanes, and they are monotone until a retire runs —
        so every carried lane rides ``self._pipe[-1]``.  Nothing here
        waits for the card: the inputs go up from pinned rings and the
        tokens come back into one.  Returns True when a step launched."""
        now = time.perf_counter()
        batch = []
        for s in self._slots:
            if s.state != "decode":
                continue
            req = s.req
            if req.expired(now):
                # the deadline is judged against launch time; a slot with
                # lanes still in flight expires at its retire instead
                if s.flight == 0:
                    self._finish(s, "deadline")
                continue
            if len(s.generated) + s.flight + len(req.prefix) >= req.max_new:
                continue  # in-flight lanes already cover the budget
            if s.pos + s.flight >= self.max_ctx:
                continue
            batch.append(s)
        if not batch:
            return False
        try:
            faults.check("decode.step")
        except Exception as e:
            for s in batch:
                self._fail_slot(s, ServingError(
                    "decode step failed: %r" % (e,)))
            return False
        depth0 = len(self._pipe)
        live = []
        for s in batch:
            if s.state != "decode":
                continue  # a peer's page scramble took it down
            ok = self._grow_pages_inflight(s)
            if len(self._pipe) != depth0:
                # growth flushed the pipeline (OOM relief); every flight
                # count is stale now — abandon this launch and let the
                # next step rebuild from quiesced state
                return False
            if ok and s.state == "decode":
                live.append(s)
        live = [s for s in live if s.state == "decode"]
        if not live:
            return False
        st = self._stage_tokens
        sp = self._stage_positions
        sa = self._stage_active
        carry = self._stage_carry
        st.fill(0)
        sp.fill(0)
        sa.fill(False)
        carry.fill(False)
        chain = False
        for s in live:
            sp[s.idx] = s.pos + s.flight
            sa[s.idx] = True
            if s.flight > 0:
                carry[s.idx] = True  # input is the in-flight step's output
                chain = True
            else:
                st[s.idx] = s.pending
        rings = self._rings
        if chain and onp.array_equal(carry, sa):
            # steady state: every live lane chains, so the combine is the
            # identity — feed the in-flight output straight in.  Inactive
            # lanes see that step's garbage rows, which the active mask
            # already quarantines (scratch-page writes, outputs nobody
            # retires)
            tokens = self._pipe[-1].out
        elif chain:
            tokens = self._combine(self._pipe[-1].out,
                                   rings["tokens"].upload(st),
                                   rings["carry"].upload(carry))
        else:
            tokens = rings["tokens"].upload(st)
        t0 = time.perf_counter()
        if self._t_force_end is not None:
            # with lanes in flight the host gap is hidden (0 by
            # construction); an empty pipe exposes it like sync mode
            self.metrics.observe_host_gap(
                self.name,
                0.0 if depth0 else max(0.0, t0 - self._t_force_end))
        try:
            _, _, out, _ = self._decode_fn(
                self.params, self._kp, self._vp, tokens,
                rings["positions"].upload(sp), self._tables_device(),
                self._active_device(sa))
            host, event = rings["out"].download(out)
        except Exception as e:
            # a failing launch fails this batch's lanes typed; the flights
            # already in the pipe retire as usual
            _log.exception("decode launch failed")
            for s in live:
                self._fail_slot(s, ServingError(
                    "decode launch failed: %r" % (e,)))
            return False
        fl = _Flight(out, host, event, t0, [(s, s.admit_seq) for s in live],
                     set(s.owner for s in live))
        for s in live:
            s.flight += 1
        with self._cond:
            self._pipe.append(fl)
            self._pin_owners(fl)
        self.metrics.observe_dispatch_depth(self.name, len(self._pipe))
        return True

    def _retire_one(self):
        """Wait for the oldest in-flight step's tokens (its CUDA event)
        and run its bookkeeping (history/pos advance, emission,
        inter-token + decode-step metrics, EOS/length/deadline finishes).
        Lanes whose slot was recycled since launch (admit-seq mismatch)
        are discarded — their tokens were never promised to anyone."""
        with self._cond:
            if not self._pipe:
                return
            fl = self._pipe.popleft()
        try:
            faults.check("engine.retire")
            if fl.event is not None:
                fl.event.synchronize()
            toks = fl.host.numpy().copy()
        except Exception as e:
            self._retire_poisoned(fl, e)
            return
        now = time.perf_counter()
        self._t_force_end = now
        self.metrics.count(self.name, "deferred_reads_total")
        with self._cond:
            self._unpin_owners(fl)
        live = 0
        for s, seq in fl.lanes:
            if s.req is None or s.admit_seq != seq or s.state != "decode":
                continue
            s.flight = max(0, s.flight - 1)
            tok = int(toks[s.idx])
            s.history.append(s.pending)
            s.pos += 1
            s.generated.append(tok)
            s.pending = tok
            self.metrics.observe_inter_token(self.name, now - s.t_last)
            s.t_last = now
            live += 1
            self._maybe_finish(s, now)
        for cb in fl.on_retire:
            cb()
        if live:
            # step wall = retire cadence in steady state (launch→retire
            # spans the whole pipeline depth); the first retire after an
            # idle pipe falls back to its own launch→retire wall
            base = max(fl.t_launch, self._t_last_retire or 0.0)
            self.metrics.observe_decode_step(
                self.name, now - base, now - base, live,
                self.slots, live)
        self._t_last_retire = now

    def _retire_poisoned(self, fl, exc):
        """An ``engine.retire`` fault (or a failed event wait) poisons
        exactly one flight: its live lanes fail typed, its pins release,
        and the REST of the pipeline is discarded unread — chained
        launches downstream consumed this step's unreadable tokens, and
        surviving slots relaunch from their last confirmed token (greedy
        decode recomputes the same stream)."""
        with self._cond:
            self._unpin_owners(fl)
        err = ServingError("decode retire failed: %r" % (exc,))
        for s, seq in fl.lanes:
            if s.req is not None and s.admit_seq == seq \
                    and s.state in ("decode", "finishing"):
                self._fail_slot(s, err)
        for cb in fl.on_retire:
            cb()
        self._flush_pipe(discard=True)

    def _flush_pipe(self, discard=False):
        """Drain every in-flight launch.  ``discard=True`` drops results
        without reading them (downstream of a poisoned flight): valid
        lanes just lose their in-flight count and relaunch from their
        last confirmed token."""
        while self._pipe:
            if not discard:
                self._retire_oldest()
                continue
            with self._cond:
                if not self._pipe:
                    break
                fl = self._pipe.popleft()
                self._unpin_owners(fl)
            for s, seq in fl.lanes:
                if s.req is not None and s.admit_seq == seq:
                    s.flight = max(0, s.flight - 1)
            for cb in fl.on_retire:
                cb()

    def _grow_pages_inflight(self, s):
        """Page growth for an async launch: the slot's cache must cover
        ``pos + flight + 1`` positions (every unretired lane writes one).
        The happy path allocates from the free list without touching
        peers; on pressure the pipeline is flushed FIRST so the sync
        preemption machinery (:meth:`_ensure_pages`) runs against a
        quiesced engine whose flight counts are all zero."""
        need = (pages_for(s.pos + s.flight + 1, self.page_size)
                - len(self.alloc.pages(s.owner)))
        if need <= 0:
            return True
        try:
            self.alloc.alloc(s.owner, need)
            self._sync_table(s)
            return True
        except CacheOOM:
            self._flush_pipe()
            if s.req is None or s.state != "decode":
                return False  # the flush finished / failed / preempted it
            return self._ensure_pages(s, 1)
        except Exception as e:
            self._fail_slot(s, e if isinstance(e, ServingError)
                            else ServingError(
                                "kv page allocation failed: %r" % (e,)))
            return False

    def _retire_oldest(self):
        """Retire the oldest in-flight step: :meth:`_retire_one`, or on a
        speculative engine :meth:`_retire_spec` with its deferred
        bookkeeping run at once."""
        if self._spec is not None:
            rec = self._retire_spec()
            if rec is not None:
                self._run_spec_deferred(rec)
            return
        self._retire_one()

    # -- async speculative pipeline ---------------------------------------
    def _decode_async_spec(self):
        """Speculative pipelining.  A verify's input depends on the host's
        acceptance, so two launches cannot stack; the overlap comes from
        the order instead: retire the step in flight with only the state
        updates the next launch needs, launch at once (its draft was made
        while the step ran on the card), then do the rest of the
        bookkeeping (metrics, finishes, futures) behind the new launch."""
        rec = self._spec_rec = self._retire_spec()
        try:
            self._launch_spec()
        finally:
            self._spec_rec = None
            if rec is not None:
                self._run_spec_deferred(rec)

    def _finish_decided(self):
        """Finish at once the slots the retired spec step decided (parked
        in ``finishing`` with their pages held until its deferred
        bookkeeping).  Page growth calls this when the pool is dry, before
        it evicts or preempts, so that no live sequence is preempted or
        failed for pages a decided one frees a few lines later.  Returns
        whether any slot finished."""
        rec, done = self._spec_rec, False
        if rec is not None:
            for s, _, _, _, _, reason in rec["lanes"]:
                if reason is not None and s.state == "finishing":
                    self._finish(s, reason)
                    done = True
        return done

    def _retire_spec(self):
        """Retire the in-flight spec step: wait for its tokens (its CUDA
        event), run longest-prefix acceptance, advance the slots, roll
        back rejected positions' pages, feed adaptive-k, check the
        pre-draft, and DECIDE finishes (such slots park in ``finishing``,
        which the next launch skips).  Returns the deferred record for
        :meth:`_run_spec_deferred`, or None."""
        with self._cond:
            if not self._pipe:
                return None
            fl = self._pipe.popleft()
        try:
            faults.check("engine.retire")
            if fl.event is not None:
                fl.event.synchronize()
            out = fl.host.numpy().copy()
        except Exception as e:
            self._retire_poisoned(fl, e)
            return None
        now = time.perf_counter()
        self._t_force_end = now
        self.metrics.count(self.name, "deferred_reads_total")
        with self._cond:
            self._unpin_owners(fl)
        spec = self._spec
        lanes = []
        emitted_total = 0
        for s, seq in fl.lanes:
            if s.req is None or s.admit_seq != seq or s.state != "decode":
                continue
            s.flight = 0
            row = fl.fed[s.idx]
            nv = len(row)
            pos0 = s.pos
            if fl.kind == "verify":
                emitted, accepted = _accept(row, out[s.idx, :nv])
            else:
                emitted, accepted = [int(out[s.idx])], 0
            emitted = self._clip_emission(s, emitted)
            gap = (now - s.t_last) / len(emitted)
            self._emit(s, emitted, now)
            emitted_total += len(emitted)
            drafted = nv - 1
            if drafted:
                # adaptive-k learns the outcome before the next launch
                # budgets its draft, as on the sync loop
                spec.observe(self._spec_key(s), drafted, accepted)
            if fl.kind == "verify":
                self._rollback_kv(s, pos0 + nv)
            # keep the overlapped draft's tail only if it predicted this
            # step's emission exactly (any draft is safe: the verify
            # gates it; this decides whether the next launch re-drafts)
            s.predraft = spec.reuse_predraft(s.predraft, emitted,
                                             spec.k_cap)
            reason = None
            if self.eos_id is not None and s.pending == self.eos_id:
                reason = "eos"
            elif len(s.generated) + len(s.req.prefix) >= s.req.max_new:
                reason = "length"
            elif s.req.expired(now):
                reason = "deadline"
            if reason is not None:
                s.state = "finishing"
            lanes.append((s, len(emitted), gap, drafted, accepted, reason))
        for cb in fl.on_retire:
            cb()
        return {"lanes": lanes, "kind": fl.kind, "t_launch": fl.t_launch,
                "now": now, "emitted_total": emitted_total}

    def _plan_drafts(self, live, predrafts=False):
        """Draft for the live slots: ``{slot index: draft}`` of the slots
        with a depth budget and a non-empty draft.  With ``predrafts`` a
        slot's overlapped draft (checked at retire) stands in for a fresh
        one."""
        spec = self._spec
        plan = {}
        for s in live:
            req = s.req
            budget = req.max_new - len(req.prefix) - len(s.generated)
            max_k = min(spec.k_cap, budget - 1, self.max_ctx - s.pos - 1)
            k = spec.budget(self._spec_key(s), max_k)
            if k <= 0:
                continue
            pre, s.predraft = s.predraft, None
            if predrafts and pre:
                draft = pre[:k]
            else:
                t0 = time.perf_counter()
                draft = spec.propose(self._spec_key(s), s.owner,
                                     list(s.history) + [s.pending], k)
                self.metrics.observe_draft(self.name,
                                           time.perf_counter() - t0)
            if draft:
                plan[s.idx] = [int(t) for t in draft]
        return plan

    def _grow_for_plan(self, live, plan):
        """Page growth AFTER the verify gate: a speculating slot writes 1 +
        k cache positions this step (peers may be preempted to fit).
        Returns the slots still decoding; drops the plans of the others."""
        survivors = []
        for s in live:
            if s.state != "decode":
                plan.pop(s.idx, None)
                continue
            if self._ensure_pages(s, 1 + len(plan.get(s.idx, ()))):
                if s.state == "decode":
                    survivors.append(s)
                    continue
            plan.pop(s.idx, None)
        return [s for s in survivors if s.state == "decode"]

    def _verify_inputs(self, live, plan, width):
        """The host arrays of one verify step over ``live`` (every live
        slot rides it: a slot without a draft feeds its pending token
        alone, ``n_valid`` 1), and each slot's fed row."""
        B = self.slots
        tokens = onp.zeros((B, self._spec.k_cap + 1), onp.int32)
        positions = onp.zeros(B, onp.int32)
        n_valid = onp.zeros(B, onp.int32)
        active = onp.zeros(B, bool)
        fed = {}
        for s in live:
            row = [s.pending] + plan.get(s.idx, [])
            fed[s.idx] = row
            tokens[s.idx, :len(row)] = row
            positions[s.idx] = s.pos
            n_valid[s.idx] = len(row)
            active[s.idx] = True
        return tokens, positions, n_valid, active, fed

    def _run_verify(self, width, tokens, positions, n_valid, active):
        """Queue one verify step of ``width`` on the card (inputs through
        the staging rings); returns its (B, width) argmax tokens."""
        rings = self._rings
        _, _, out = self._verify_fn(width)(
            self.params, self._kp, self._vp,
            rings["vtokens"].upload(tokens)[:, :width],
            rings["positions"].upload(positions),
            rings["nvalid"].upload(n_valid), self._tables_device(),
            self._active_device(active))
        return out

    def _launch_spec(self):
        """Launch the next spec step (a wide verify, or a plain step when
        nothing drafted), then pre-draft the step after it while this one
        runs on the card.  Admission, the gate and page growth run in the
        sync loop's order (:meth:`_decode_speculative`), so the streams
        are the same."""
        spec = self._spec
        now = time.perf_counter()
        batch = []
        for s in self._slots:
            if s.state != "decode":
                continue
            if s.req.expired(now):
                self._finish(s, "deadline")
                continue
            batch.append(s)
        if not batch:
            return False
        try:
            faults.check("decode.step")
        except Exception as e:
            for s in batch:
                self._fail_slot(s, ServingError(
                    "decode step failed: %r" % (e,)))
            return False
        live = []
        for s in batch:
            if s.state != "decode":
                continue
            if self._ensure_pages(s, 1) and s.state == "decode":
                live.append(s)
        live = [s for s in live if s.state == "decode"]
        if not live:
            return False
        plan = self._plan_drafts(live, predrafts=True)
        if plan and not spec.verify_gate([self._spec_key(s) for s in live
                                          if s.idx in plan]):
            plan = {}
        live = self._grow_for_plan(live, plan)
        if not live:
            return False
        t0 = time.perf_counter()
        if self._t_force_end is not None:
            self.metrics.observe_host_gap(
                self.name, max(0.0, t0 - self._t_force_end))
        rings = self._rings
        try:
            if plan:
                width = 1 + max(len(d) for d in plan.values())
                tokens, positions, n_valid, active, fed = \
                    self._verify_inputs(live, plan, width)
                out = self._run_verify(width, tokens, positions, n_valid,
                                       active)
                wide = self._spec.k_cap + 1
                host, event = rings["vout"].download(
                    torch.nn.functional.pad(out, (0, wide - width)))
                kind = "verify"
            else:
                st = self._stage_tokens
                sp = self._stage_positions
                sa = self._stage_active
                st.fill(0)
                sp.fill(0)
                sa.fill(False)
                fed = {}
                for s in live:
                    fed[s.idx] = [s.pending]
                    st[s.idx] = s.pending
                    sp[s.idx] = s.pos
                    sa[s.idx] = True
                _, _, out, _ = self._decode_fn(
                    self.params, self._kp, self._vp,
                    rings["tokens"].upload(st), rings["positions"].upload(sp),
                    self._tables_device(), self._active_device(sa))
                host, event = rings["out"].download(out)
                kind = "plain"
        except Exception as e:
            _log.exception("speculative launch failed")
            for s in live:
                self._fail_slot(s, ServingError(
                    "decode launch failed: %r" % (e,)))
            return False
        fl = _Flight(out, host, event, t0, [(s, s.admit_seq) for s in live],
                     set(s.owner for s in live), kind, fed)
        for s in live:
            s.flight = 1
        with self._cond:
            self._pipe.append(fl)
            self._pin_owners(fl)
        self.metrics.observe_dispatch_depth(self.name, len(self._pipe))
        # overlapped drafting: propose the NEXT step's continuation from
        # the confirmed context while this step runs on the card, covering
        # this step's largest emission plus k; the retire keeps the tail
        # only if the emission matched it (propose absorbs drafter faults).
        # A drafter on the card would only queue behind this step.
        if spec.drafter.on_device:
            return True
        for s in live:
            k = spec.budget(self._spec_key(s), spec.k_cap)
            if k <= 0:
                continue
            t1 = time.perf_counter()
            s.predraft = spec.propose(self._spec_key(s), s.owner,
                                      list(s.history) + [s.pending],
                                      len(fed[s.idx]) + k)
            self.metrics.observe_draft(self.name, time.perf_counter() - t1)
        return True

    def _run_spec_deferred(self, rec):
        """The retired spec step's remaining bookkeeping, run AFTER the
        next launch is queued: metrics, the verify and step histograms,
        and the finishes (futures resolved, pages released or parked)."""
        now = rec["now"]
        if not rec["lanes"]:
            return
        for s, n_emitted, gap, drafted, accepted, reason in rec["lanes"]:
            for _ in range(n_emitted):
                self.metrics.observe_inter_token(self.name, gap)
            if drafted:
                self.metrics.count(self.name, "spec_draft_tokens_total",
                                   drafted)
                self.metrics.count(self.name, "spec_accepted_tokens_total",
                                   accepted)
            if reason is not None and s.state == "finishing":
                self._finish(s, reason)
        if rec["kind"] == "verify":
            self.metrics.observe_verify(self.name, now - rec["t_launch"])
            self.metrics.count(self.name, "spec_verify_steps_total")
        self.metrics.observe_decode_step(
            self.name, now - rec["t_launch"], now - rec["t_launch"],
            len(rec["lanes"]), self.slots, rec["emitted_total"])

    # -- speculative decoding ---------------------------------------------
    def _build_spec(self, drafter, draft_model, spec_k):
        from .speculate import (DraftModelDrafter, Drafter, NGramDrafter,
                                SpeculativeScheduler)
        if isinstance(drafter, Drafter):
            d = drafter
        else:
            kind = str(drafter if drafter is not None
                       else _config.get("MXNET_GEN_SPEC_DRAFTER")
                       or "ngram")
            if kind not in ("ngram", "model"):
                raise ValueError("drafter must be a speculate.Drafter, "
                                 "'ngram' or 'model', got %r" % (kind,))
            if kind == "model" or draft_model is not None:
                dm = draft_model
                if dm is None:
                    builder = str(_config.get(
                        "MXNET_GEN_SPEC_DRAFT_BUILDER") or "")
                    if builder:
                        import importlib
                        mod, _, attr = builder.partition(":")
                        dm = getattr(importlib.import_module(mod),
                                     attr)(self.model)
                    else:
                        dm = _decoder.decoder_draft(self.model,
                                                    device=self.device)
                if dm.device != self.device:
                    raise ValueError(
                        "the draft model's weights live on %s but the "
                        "engine runs on %s" % (dm.device, self.device))
                # one draft cache per slot, so that drafting a full batch
                # evicts no peer (the JAX engine keeps its default of 8)
                d = DraftModelDrafter(dm, page_size=self.page_size,
                                      max_seqs=self.slots)
            else:
                d = NGramDrafter()
        sched = SpeculativeScheduler(d, k_cap=spec_k, name=self.name)
        # a verify's (B, width) inputs and tokens travel through pinned
        # buffers as wide as the widest verify
        B, dev = self.slots, self.device
        n, wide = self.dispatch_ahead + 1, sched.k_cap + 1
        self._rings["vtokens"] = _Ring(n, (B, wide), torch.int32, dev)
        self._rings["nvalid"] = _Ring(n, (B,), torch.int32, dev)
        self._rings["vout"] = _Ring(n, (B, wide), torch.int32, dev,
                                    twins=False)
        return sched

    def _verify_fn(self, width):
        """The verify step of ``width`` (built once per width)."""
        fn = self._verify_fns.get(width)
        if fn is None:
            fn = self._verify_fns[width] = _decoder.make_verify_step(
                self.cfg, self.page_size, width, plan=self._tp_plan)
        return fn

    def verify_launch_stats(self, width):
        """Kernel launches of one verify step of ``width`` on this engine
        (``decoder.verify_launch_stats``): independent of acceptance."""
        return _decoder.verify_launch_stats(self.cfg, width, self.quant,
                                            self.tp)

    def _spec_key(self, slot):
        """Controller key: the session id of a session request (learned
        acceptance carries across turns), else the slot's owner."""
        if slot.req is not None and slot.req.session is not None:
            return slot.req.session
        return slot.owner

    def _spec_release(self, owner, key=None):
        """Drop the drafter's state of ``owner`` when its pages are retired
        (finish, fail, preempt, evict, expiry, stop); with ``key`` the
        adaptive-k controller goes too."""
        if self._spec is None or owner is None:
            return
        try:
            self._spec.release(owner, key)
        except Exception:
            _log.exception("drafter release failed")

    def _clip_emission(self, s, emitted):
        """``emitted`` cut to the request's remaining budget (at least one
        token) and at the first EOS."""
        budget = s.req.max_new - len(s.req.prefix) - len(s.generated)
        emitted = emitted[:max(1, budget)]
        if self.eos_id is not None and self.eos_id in emitted:
            emitted = emitted[:emitted.index(self.eos_id) + 1]
        return emitted

    @staticmethod
    def _emit(s, emitted, now):
        for tok in emitted:
            s.history.append(s.pending)
            s.pos += 1
            s.generated.append(tok)
            s.pending = tok
        s.t_last = now

    def _decode_speculative(self, live):
        """One draft, wide-verify, accept and rollback step over the whole
        decode batch (sync loop).  Returns False (nothing consumed) when no
        slot drafted or the verify gate trips: the caller then runs the
        plain one-token step.

        Every live slot rides the SAME verify step: speculating slots feed
        ``1 + k`` positions, the others their pending token with
        ``n_valid`` 1, so a mixed batch costs no extra launch and the
        launches a step stay a property of the width alone."""
        spec = self._spec
        plan = self._plan_drafts(live)
        if not plan:
            return False
        if not spec.verify_gate([self._spec_key(s) for s in live
                                 if s.idx in plan]):
            return False
        live = self._grow_for_plan(live, plan)
        if not live:
            return True   # the page scramble consumed the whole batch
        if not plan:
            return False  # every draft's slot died: plain decode serves
        width = 1 + max(len(d) for d in plan.values())
        tokens, positions, n_valid, active, fed = self._verify_inputs(
            live, plan, width)
        t0 = time.perf_counter()
        if self._t_force_end is not None:
            self.metrics.observe_host_gap(
                self.name, max(0.0, t0 - self._t_force_end))
        out = self._run_verify(width, tokens, positions, n_valid, active)
        out = out.cpu().numpy()
        now = time.perf_counter()
        self._t_force_end = now
        self.metrics.observe_verify(self.name, now - t0)
        self.metrics.count(self.name, "spec_verify_steps_total")
        emitted_total = 0
        for s in live:
            row = fed[s.idx]
            nv = len(row)
            pos0 = s.pos
            emitted, accepted = _accept(row, out[s.idx, :nv])
            emitted = self._clip_emission(s, emitted)
            gap = (now - s.t_last) / len(emitted)
            self._emit(s, emitted, now)
            for _ in emitted:
                self.metrics.observe_inter_token(self.name, gap)
            emitted_total += len(emitted)
            drafted = nv - 1
            if drafted:
                spec.observe(self._spec_key(s), drafted, accepted)
                self.metrics.count(self.name, "spec_draft_tokens_total",
                                   drafted)
                self.metrics.count(self.name, "spec_accepted_tokens_total",
                                   accepted)
            self._rollback_kv(s, pos0 + nv)
            self._maybe_finish(s, now)
        self.metrics.observe_decode_step(
            self.name, now - t0, now - t0, len(live), self.slots,
            emitted_total)
        return True

    def _rollback_kv(self, slot, written_end):
        """Return the slot's page list to exactly what its confirmed length
        needs after a verify wrote ``written_end`` positions.

        Rejected positions leave KV at offsets the causal mask never reads
        (a query sees key positions ``<= its own``), so the rollback is
        accounting: whole pages past the confirmed length go back through
        :meth:`PageAllocator.trim`.  If the kept boundary page is SHARED (a
        published prefix page, refcount > 1) and this verify wrote past
        the confirmed length, it is forked copy-on-write first, so that the
        truncation never leaves this sequence writing into a page another
        sequence (or the prefix cache) still holds."""
        keep = pages_for(slot.pos, self.page_size)
        pages = self.alloc.pages(slot.owner)
        if written_end > slot.pos and 0 < keep <= len(pages) \
                and slot.pos % self.page_size != 0 \
                and self.alloc.refcount(pages[keep - 1]) > 1:
            old = pages[keep - 1]
            try:
                new = self.alloc.fork(slot.owner, old)
            except CacheOOM:
                new = None
                if self._reclaim(keep=slot.req.session
                                 if slot.req else None):
                    try:
                        new = self.alloc.fork(slot.owner, old)
                    except CacheOOM:
                        new = None
            if new is not None:
                _paged.copy_page(self._kp, old, new)
                _paged.copy_page(self._vp, old, new)
                self.metrics.count(self.name, "cow_forks_total")
            # (an unforkable pool is safe all the same: the written
            # offsets lie past every sharer's published token count, which
            # no reader touches; the fork keeps the invariant airtight)
        if self.alloc.trim(slot.owner, keep):
            self.metrics.count(self.name, "spec_rollbacks_total")
        self._sync_table(slot)

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
        if req.session is not None:
            # park: the pages stay under the session for its next turn
            sess = self._sessions.get(req.session)
            if sess is None:
                sess = self._sessions[req.session] = _Session(
                    req.session, slot.owner)
            sess.owner = slot.owner
            sess.pos = slot.pos
            sess.pending = slot.pending
            sess.history = list(slot.history)
            sess.busy = False
            sess.last_used = time.monotonic()
        else:
            self._free_owner(slot.owner)
            self._spec_release(slot.owner, slot.owner)
        self.metrics.count(self.name, "sequences_completed_total")
        self.metrics.observe_generate_done(self.name, now - req.t_enqueue)
        self.slo.observe_served(1)  # feeds the drain-rate estimator
        self._clear(slot)
        req.future.set_result({
            "tokens": tokens,
            "finish_reason": reason,
            "session": req.session,
            "prompt_tokens": req.prompt_tokens,
            "completion_tokens": len(tokens),
        })
        with self._cond:
            self._cond.notify_all()

    def _fail_slot(self, slot, exc):
        req = slot.req
        self._free_owner(slot.owner)
        self._spec_release(slot.owner, self._spec_key(slot))
        if req.session is not None:
            self._sessions.pop(req.session, None)
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
        slot.flight = 0
        slot.predraft = None
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
        if self._spec is None:
            return 2
        # every verify width the adaptive-k controller can reach (2 ..
        # k_cap + 1), on inactive slots that write only the scratch page
        zeros = torch.zeros(self.slots, dtype=torch.int64, device=dev)
        for w in range(2, self._spec.k_cap + 2):
            _, _, out = self._verify_fn(w)(
                self.params, self._kp, self._vp,
                torch.zeros((self.slots, w), dtype=torch.int64, device=dev),
                zeros, zeros,
                torch.zeros((self.slots, self.pages_per_seq),
                            dtype=torch.int32, device=dev),
                torch.zeros(self.slots, dtype=torch.bool, device=dev))
            out.cpu()
        return 2 + self._spec.k_cap

    def drain(self, timeout=30.0):
        return self.stop(drain=True, timeout=timeout)

    def stop(self, drain=True, timeout=30.0):
        """Stop admissions; ``drain=True`` serves everything queued and in
        flight first.  Parked sessions are released either way and the
        prefix cache is cleared (their pages return to the pool —
        occupancy ends at zero); with no page store there is nowhere to
        ship them.  Returns True when the worker exited."""
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
                        self._free_owner(s.owner)
                        self._spec_release(s.owner, self._spec_key(s))
                        self._clear(s)
            self._cond.notify_all()
            worker = self._worker
        ok = True
        if worker is not None:
            worker.join(timeout)
            ok = not worker.is_alive()
        with self._cond:
            for sess in self._sessions.values():
                self._free_owner(sess.owner)
                self._spec_release(sess.owner, sess.sid)
            self._sessions.clear()
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        return ok

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
        """Logical tokens cached in pool pages: live slots' positions plus
        parked sessions' (replay-pending sessions hold a transcript, not
        pages)."""
        with self._cond:
            toks = sum(s.pos for s in self._slots if s.active)
            toks += sum(s.pos for s in self._sessions.values()
                        if not s.busy and s.replay is None)
        return toks

    def stats(self):
        with self._cond:
            active = sum(1 for s in self._slots if s.active)
            queued = len(self._queue)
            sessions = len(self._sessions)
        out = {"slots": self.slots, "active": active, "queued": queued,
               "sessions": sessions, "steps": self.steps,
               "device": str(self.device),
               "page_size": self.page_size,
               "pages_per_seq": self.pages_per_seq,
               "prefill_chunk": self.prefill_chunk,
               "max_ctx": self.max_ctx,
               "slo": {"service_rate": self.slo.service_rate(),
                       "default_tier": self.slo.default_tier},
               "async": {"enabled": self.async_decode,
                         "dispatch_ahead": self.dispatch_ahead,
                         "inflight": len(self._pipe),
                         "prefill_drains": self.prefill_drains,
                         "staging_waits": sum(
                             r.waits for r in self._rings.values())},
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
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self._spec is not None:
            out["speculative"] = self._spec.stats()
        return out
