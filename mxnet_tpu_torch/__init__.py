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
  mesh;
- the array and op core — ``mx.np`` (``numpy/``), ``mx.npx``
  (``numpy_extension/``), ``mx.nd``, ``mx.autograd`` and ``mx.random``
  on ``ndarray``s that hold torch tensors, ``npx``'s fused ops routed to
  the kernels;
- Gluon — ``mx.gluon`` (``Parameter``, ``Block``/``HybridBlock``, every
  layer, loss, metric and data module, the one-card ``Trainer``),
  ``mx.init``, ``mx.optimizer`` and ``mx.lr_scheduler``; a block takes
  ``ndarray``s (the JAX package's contract) or torch tensors;
- the model zoo — ``mx.gluon.model_zoo.vision`` (ResNet v1/v2, VGG,
  AlexNet, MobileNet v1/v2, SqueezeNet, DenseNet, Inception v3; the
  offline weight store); ``mx.profiler`` and ``mx.test_utils``.

Entry points run on ``cuda`` unless ``device="cpu"`` (or ``ctx=mx.cpu()``,
or an open ``with mx.cpu():`` scope) asks for the CPU
(``context.resolve``).

Import convention: ``import mxnet_tpu_torch as mx``, then ``mx.np``,
``mx.npx``, ``mx.nd``, ``mx.autograd``, ``mx.random``, ``mx.waitall``,
``mx.gluon``, ``mx.init``, ``mx.optimizer``, ``mx.lr_scheduler``.
"""
from . import config, context, faults, profiler  # noqa: F401
from .context import (cpu, gpu, Context, Device, current_context,  # noqa
                      num_gpus)

from . import ndarray as _ndarray_mod  # noqa: F401
from .ndarray import ndarray, NDArray, waitall  # noqa: F401
from . import autograd  # noqa: F401
from . import util  # noqa: F401
from .util import is_np_array, is_np_shape, set_np, reset_np  # noqa: F401
from . import numpy as np  # noqa: F401
from . import numpy_extension as npx  # noqa: F401
from . import _rng  # noqa: F401
from . import random  # noqa: F401
from . import nd  # noqa: F401
from . import initializer  # noqa: F401
from . import initializer as init  # noqa: F401
from . import lr_scheduler  # noqa: F401
from . import optimizer  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from . import gluon  # noqa: F401
from . import test_utils  # noqa: F401

__all__ = ["config", "context", "faults", "profiler", "cpu", "gpu",
           "Context", "Device", "current_context", "num_gpus", "ndarray",
           "NDArray", "waitall", "autograd", "util", "np", "npx", "random",
           "nd", "is_np_array", "is_np_shape", "set_np", "reset_np",
           "initializer", "init", "lr_scheduler", "optimizer", "Optimizer",
           "gluon", "test_utils"]
