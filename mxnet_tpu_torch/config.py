"""Typed environment/config registry (the port's copy of
``mxnet_tpu/config.py``).

The knobs the port reads are registered here with the JAX package's
names, types and defaults.  Knobs of features the port has not reached
yet are registered as ``not_ported``: the port never acts on them, and
the engine refuses (``NotImplementedError``) when one is set to ask for
its feature — see :func:`requested`.

API:
  config.get("MXNET_GEN_SLOTS") -> typed value
  config.requested("MXNET_GEN_ASYNC") -> True when the env asks for it
  config.describe() -> {name: ConfigVar}
  config.check_env() -> [warnings]
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

__all__ = ["ConfigVar", "register", "get", "requested", "describe",
           "check_env"]

# status: honored    — read by the port (consumer says where)
#         not_ported — a JAX-package knob whose feature the port lacks;
#                      setting it to ask for the feature makes the
#                      consumer raise NotImplementedError
_REGISTRY: dict = {}


@dataclass
class ConfigVar:
    name: str
    type: type
    default: object
    status: str
    help: str
    consumer: str = ""


def register(name, type_, default, status, help_, consumer=""):
    _REGISTRY[name] = ConfigVar(name, type_, default, status, help_,
                                consumer)
    return _REGISTRY[name]


def get(name, default=None):
    """Typed read of a registered variable (env wins over default)."""
    var = _REGISTRY.get(name)
    raw = os.environ.get(name)
    if var is None:
        return raw if raw is not None else default
    if raw is None:
        return var.default if default is None else default
    if var.type is bool:
        return raw not in ("0", "false", "False", "")
    try:
        return var.type(raw)
    except (TypeError, ValueError):
        warnings.warn("invalid value %r for %s (expected %s); using "
                      "default %r" % (raw, name, var.type.__name__,
                                      var.default))
        return var.default


def requested(name):
    """True when the environment explicitly sets ``name`` to a value that
    turns its feature on (anything but unset, '', '0', 'false', 'off')."""
    raw = os.environ.get(name)
    return raw is not None and raw.strip().lower() not in (
        "", "0", "false", "off")


def describe():
    return dict(_REGISTRY)


def check_env(warn=True):
    """Scan the environment for unknown or not-yet-ported MXNET_* knobs."""
    msgs = []
    for key in os.environ:
        if not key.startswith("MXNET_"):
            continue
        var = _REGISTRY.get(key)
        if var is None:
            msgs.append("%s is set but not a knob the port reads" % key)
        elif var.status == "not_ported":
            msgs.append("%s is set but its feature is not ported yet (%s)"
                        % (key, var.help))
    if warn:
        for m in msgs:
            warnings.warn(m, stacklevel=2)
    return msgs


# ---------------------------------------------------------------------------
# honored knobs
# ---------------------------------------------------------------------------
register("MXNET_GEN_SLOTS", int, 8, "honored",
         "decode batch width of the continuous-batching LLM engine "
         "(sequences decoded per step)", "serving.DecodeEngine")
register("MXNET_GEN_PAGE_SIZE", int, 16, "honored",
         "tokens per KV-cache page (paged attention page granularity)",
         "serving.DecodeEngine")
register("MXNET_GEN_PAGES", int, 0, "honored",
         "total KV-cache pages incl. the scratch page (0 = fully "
         "provision slots x pages_per_seq + 1: no preemption pressure)",
         "serving.DecodeEngine")
register("MXNET_GEN_PREFILL_CHUNK", int, 32, "honored",
         "prompt tokens cached per engine step (chunked prefill: long "
         "prompts never stall the decode batch)", "serving.DecodeEngine")
register("MXNET_GEN_MAX_CTX", int, 0, "honored",
         "max prompt+output tokens per sequence (0 = model max_length)",
         "serving.DecodeEngine")
register("MXNET_DECODE_FUSED", str, "", "honored",
         "decode step of the LLM engine: ''/'1' = the fused decode-layer-"
         "group kernel (one launch per layer group), '0'/'off' = the "
         "per-op step (paged-attention and bias_gelu kernels between "
         "torch matmuls)", "serving.DecodeEngine")
register("MXNET_DECODE_LAYER_GROUP", int, 0, "honored",
         "decoder layers per fused decode-step kernel launch (0 = all "
         "layers in ONE group — one launch per token per engine step)",
         "serving.DecodeEngine")
register("MXNET_QUANT_WEIGHTS", str, "", "honored",
         "weight-only quantized LLM serving: 'int8' (per-output-channel "
         "scales) or 'int4' (per-group, see MXNET_QUANT_GROUP) quantizes "
         "the decode GEMM weights of a model given to a DecodeEngine; '' "
         "serves fp32.  Activations stay fp32: the quant_matmul kernel "
         "dequantizes inside", "serving.DecodeEngine")
register("MXNET_QUANT_GROUP", int, 128, "honored",
         "int4 scale-group size (input elements per scale), shrunk to "
         "divide the input dim", "serving.DecodeEngine")
register("MXNET_QUANT_KV", str, "", "honored",
         "KV-cache page dtype of the LLM engine: 'int8' stores pages as "
         "int8 codes + one scale per (layer, kv_head, page); '' keeps fp32 "
         "pages", "serving.DecodeEngine")
register("MXNET_QUANT_MATMUL", str, "", "honored",
         "the JAX package's dequant-matmul lane switch; the port has one "
         "lane (the kernel on CUDA tensors, the plain version on CPU "
         "tensors), so any value but '' raises ValueError",
         "serving.DecodeEngine")
register("MXNET_FUSE_EPILOGUE", str, "1", "honored",
         "fused transformer epilogues: Dense(gelu), PositionwiseFFN and "
         "BERT run bias-free GEMMs followed by the fused bias_gelu and "
         "bias_dropout_residual kernels; '0'/'false'/'False'/'off' takes "
         "the unfused add/activation/dropout chain (read by "
         "ops.kernels.epilogue.fuse_epilogue_enabled)",
         "models.bert, gluon.nn.Dense")
register("MXNET_SLO_DEFAULT_TIER", str, "latency", "honored",
         "SLO admission: tier assigned to requests that carry none "
         "('latency' is protected; 'bulk' is shed first under overload)",
         "serving.autoscale.SLOPolicy")
register("MXNET_SLO_TENANT_WEIGHTS", str, "", "honored",
         "SLO admission: weighted-fair-queueing tenant weights as "
         "'tenant=weight,...' (e.g. 'free=1,pro=4'); unlisted tenants "
         "weigh 1", "serving.autoscale.SLOPolicy")
register("MXNET_SERVING_REPLICA_ID", str, "", "honored",
         "replica label stamped on ServingMetrics snapshots",
         "serving.metrics.ServingMetrics")
register("MXNET_FAULT_SPEC", str, "", "honored",
         "deterministic fault injection spec: site:kind[@p=F|n=I] joined "
         "by ';' (sites: decode.step, kvcache.alloc)", "faults")
register("MXNET_FAULT_SEED", int, 0, "honored",
         "seed for probability-based fault-injection rules (deterministic "
         "trip sequences per (seed, site, kind))", "faults.FaultRule")

# ---------------------------------------------------------------------------
# JAX-package knobs whose features the port has not reached
# ---------------------------------------------------------------------------
for _name, _help in [
    ("MXNET_GEN_ASYNC", "async decode pipeline"),
    ("MXNET_GEN_PREFIX_CACHE", "copy-on-write prefix caching"),
    ("MXNET_GEN_SPECULATE", "speculative decoding"),
    ("MXNET_GEN_PAGESTORE", "session migration through the page store"),
    ("MXNET_GEN_ROLE", "prefill/decode role specialization"),
]:
    register(_name, str, "", "not_ported", _help, "serving.DecodeEngine")
