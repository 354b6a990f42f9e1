"""mxnet_tpu_torch.serving — the LLM decode-serving slice of the port.

- ``DecodeEngine`` (``generate.py``) — continuous batching over a paged
  KV cache with chunked prefill and preemption by recompute; decode runs
  the fused decode-layer-group kernel, or the per-op step with the
  paged-attention and bias_gelu kernels.
- ``quantize_lm`` / ``QuantizedLM`` (``quantize.py``) — weight-only int8 /
  int4 serving through the ``quant_matmul`` kernel; int8 KV pages are the
  engine's ``kv_dtype="int8"``.
- ``PageAllocator`` (``kvcache.py``) — host-side page bookkeeping, the
  JAX package's allocator.
- ``ServingMetrics`` (``metrics.py``), ``SLOPolicy`` (``autoscale.py``)
  and the error taxonomy (``errors.py``).

Quick start::

    from mxnet_tpu_torch.models.decoder import CausalLM
    from mxnet_tpu_torch.serving import DecodeEngine
    lm = CausalLM(vocab_size=30522, num_layers=12, units=768,
                  hidden_size=3072, num_heads=12, max_length=512)
    eng = DecodeEngine(lm, slots=16, page_size=16, prefill_chunk=64)
    print(eng.submit([101, 2023, 2003], max_new_tokens=16).result())
    eng.stop()
    # quantized: int8 weights and int8 KV pages
    eng = DecodeEngine(quantize_lm(lm, "int8"), kv_dtype="int8", slots=16,
                       page_size=16, prefill_chunk=64)
"""
from __future__ import annotations

from .autoscale import SLOPolicy
from .errors import (BadRequestError, DeadlineExceededError,
                     DeadlineInfeasibleError, KVLeakError, QueueFullError,
                     ServerClosedError, ServingError)
from .generate import DecodeEngine
from .kvcache import PageAllocator, pages_for
from .metrics import LatencyHistogram, ModelMetrics, ServingMetrics
from .quantize import QuantizedLM, quantize_lm

__all__ = ["DecodeEngine", "QuantizedLM", "quantize_lm", "PageAllocator",
           "pages_for", "ServingMetrics",
           "ModelMetrics", "LatencyHistogram", "SLOPolicy", "ServingError",
           "BadRequestError", "QueueFullError", "ServerClosedError",
           "DeadlineExceededError", "DeadlineInfeasibleError", "KVLeakError"]
