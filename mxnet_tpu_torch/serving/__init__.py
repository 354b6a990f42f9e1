"""mxnet_tpu_torch.serving — the LLM decode-serving slice of the port.

- ``DecodeEngine`` (``generate.py``) — continuous batching over a paged
  KV cache with chunked prefill and preemption by recompute, on the JAX
  engine's defaults: the async decode pipeline (CUDA events and pinned
  staging on one stream), copy-on-write prefix caching and decode
  sessions with export and import; decode runs the fused
  decode-layer-group kernel, or the per-op step with the paged-attention
  and bias_gelu kernels; ``speculate=True`` turns on speculative decoding.
  The fleet page store (``pagestore=``, ``migrate_out()``) and ``role=``
  are refused with ``NotImplementedError``.
- ``NGramDrafter``, ``DraftModelDrafter``, ``AdaptiveK``,
  ``SpeculativeScheduler`` (``speculate.py``) — speculative decoding's
  drafters (prompt lookup; a small draft model on its own page pool), its
  per-sequence depth controller and the engine's per-step policy.
- ``quantize_lm`` / ``QuantizedLM`` (``quantize.py``) — weight-only int8 /
  int4 serving through the ``quant_matmul`` kernel; int8 KV pages are the
  engine's ``kv_dtype="int8"``.
- ``PageAllocator``, ``PrefixCache``, ``pack_session``/``unpack_session``
  (``kvcache.py``) — host-side page bookkeeping, the prefix cache and the
  session wire format, the JAX package's.
- ``ModelRegistry`` (``registry.py``), ``DynamicBatcher``
  (``batcher.py``), ``ModelServer`` (``server.py``) and ``ServingClient``
  (``client.py``) — the HTTP surface: versioned batch functions behind a
  size-or-timeout batcher, ``:predict`` and ``:generate`` over HTTP on an
  attached ``DecodeEngine``, health, readiness, stats and Prometheus
  text; the admin plane (``/v1/admin/*``) is refused.
- ``ServingMetrics`` (``metrics.py``), ``SLOPolicy`` (``autoscale.py``)
  and the error taxonomy (``errors.py``).

Quick start::

    from mxnet_tpu_torch.models.decoder import CausalLM
    from mxnet_tpu_torch.serving import DecodeEngine
    lm = CausalLM(vocab_size=30522, num_layers=12, units=768,
                  hidden_size=3072, num_heads=12, max_length=512)
    eng = DecodeEngine(lm, slots=16, page_size=16, prefill_chunk=64)
    print(eng.submit([101, 2023, 2003], max_new_tokens=16).result())
    # a two-turn session: the second turn decodes on the parked pages
    eng.submit([101, 2023], max_new_tokens=8, session="chat").result()
    eng.submit([2003], max_new_tokens=8, session="chat", resume=True)
    eng.stop()
    # quantized: int8 weights and int8 KV pages
    eng = DecodeEngine(quantize_lm(lm, "int8"), kv_dtype="int8", slots=16,
                       page_size=16, prefill_chunk=64)
    # speculative: prompt-lookup drafts of up to 4 tokens a slot
    eng = DecodeEngine(lm, slots=16, speculate=True, spec_k=4,
                       drafter="ngram")
    # over HTTP: a server on an ephemeral port, and a client
    from mxnet_tpu_torch.serving import ModelServer, ServingClient
    with ModelServer() as srv:
        srv.attach_engine("llm", DecodeEngine(lm, slots=16))
        print(ServingClient(*srv.address).generate("llm", [101, 2023]))
"""
from __future__ import annotations

from .autoscale import SLOPolicy
from .batcher import DynamicBatcher
from .client import ServingClient
from .errors import (BadRequestError, DeadlineExceededError,
                     DeadlineInfeasibleError, KVLeakError, ModelNotFoundError,
                     QueueFullError, ServerClosedError, ServingError,
                     SessionResetError)
from .generate import DecodeEngine
from .kvcache import (PageAllocator, PrefixCache, pack_session, pages_for,
                      unpack_session)
from .metrics import LatencyHistogram, ModelMetrics, ServingMetrics
from .quantize import QuantizedLM, quantize_lm
from .registry import ModelRegistry, ServedModel, default_buckets
from .server import ModelServer
from .speculate import (AdaptiveK, DraftModelDrafter, Drafter, NGramDrafter,
                        SpeculativeScheduler)

__all__ = ["DecodeEngine", "QuantizedLM", "quantize_lm", "PageAllocator",
           "PrefixCache", "pack_session", "unpack_session",
           "pages_for", "ServingMetrics",
           "ModelMetrics", "LatencyHistogram", "SLOPolicy", "ServingError",
           "BadRequestError", "QueueFullError", "ServerClosedError",
           "DeadlineExceededError", "DeadlineInfeasibleError", "KVLeakError",
           "SessionResetError", "ModelNotFoundError", "ModelRegistry",
           "ServedModel", "default_buckets", "DynamicBatcher", "ModelServer",
           "ServingClient", "Drafter", "NGramDrafter", "DraftModelDrafter",
           "AdaptiveK", "SpeculativeScheduler"]
