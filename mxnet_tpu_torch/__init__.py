"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package ``mxnet_tpu`` stays the reference; this package mirrors
its module structure and names, imports ``torch`` and never ``jax``, and
imports nothing of ``mxnet_tpu``.  Every kernel that the JAX package
wrote in Pallas for the TPU is written again by hand for Hopper (sm_90a)
under ``ops/kernels`` (CUDA C++ sources in ``csrc/``), each beside a
plain PyTorch version that CPU tensors take.

Ported so far:

- the LLM serving slice — ``models.decoder.CausalLM`` served by
  ``serving.DecodeEngine`` over a paged KV cache, in fp32 or quantized;
- the training slice — ``models.bert.BERTModel`` (MLM + NSP) trained by
  ``gluon.Trainer`` with MXNet's optimizers (``optimizer``), on
  ``gluon.nn`` layers, ``gluon.loss``, ``initializer`` and ``ops.nn``,
  through the fused epilogue kernels with their gradients, and the flash
  attention kernels, in fp32 or bf16 (``amp``);
- the RNN slice — ``gluon.rnn`` layers and cells over ``ops.rnn``, the
  LSTM time loop in one persistent kernel forward and backward;
- the tensor-parallel serving slice — ``serving.DecodeEngine(sharding=)``
  with a ``parallel.ShardingConfig``, every layer split over tp shards
  that run in turn on the one card, through the attention and FFN phase
  kernels; and ``ops.attention.flash_attention_sharded`` over a (dp, tp)
  mesh.

Entry points run on ``cuda`` unless ``device="cpu"`` is passed
(``context.resolve``).
"""
from . import config, context, faults, profiler  # noqa: F401
from .context import cpu, gpu  # noqa: F401

__all__ = ["config", "context", "faults", "profiler", "cpu", "gpu"]
