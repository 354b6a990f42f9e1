"""Weight-only quantization for LLM serving (the port of
``mxnet_tpu/serving/quantize.py``, one card).

Decode GEMMs are bound by the weight bytes, so storing the weights in
fewer bits is the lever: activations stay fp32 and the integer weights are
dequantized inside the ``quant_matmul`` kernel.  Two rungs:

- ``int8`` — per-output-channel symmetric scales, ~4x smaller weights;
- ``int4`` — per-group symmetric scales (group 128 by default), ~8x
  smaller.

:func:`quantize_lm` wraps a :class:`~..models.decoder.CausalLM` into a
:class:`QuantizedLM` that offers what ``DecodeEngine`` reads off a model
(``config``, ``eos_id``, ``device``, ``params()``), with the six GEMM
leaves (``decoder._QUANT_KINDS``) replaced by ``QuantW8``/``QuantW4``.
Every GEMM of the decoder dispatches on the leaf type, so the engine's
programs and the ``full_forward`` oracle score with the same integer
weights.  Embeddings, biases and LayerNorm parameters stay fp32, as does
the logits GEMM against ``embed``.

KV-cache quantization (``kv_dtype="int8"``) is the engine's side: pages
hold int8 codes with one scale per (layer, KV head, page), latched by the
first token written to the page (``ops/kernels/paged_attention.QPages``).

Under tensor parallelism an int4 scale group must not straddle the
row-parallel shards of ``wo`` and ``w2`` (a scale spans a contiguous
range of inputs, a shard owns its own range), so ``quantize_params(tp=)``
and :meth:`QuantizedLM.params` shrink those leaves' group to divide the
per-shard input dim, as the JAX package does; int8's per-channel scales
need nothing.

Not ported: the ``calibrate_kv_ranges`` diagnostic.
"""
from __future__ import annotations

import torch

from ..models import decoder as _decoder
from ..ops.kernels import quant_matmul as _qmm

__all__ = ["QuantizedLM", "quantize_lm", "quantize_params"]

_MODES = ("int8", "int4")


def _check_mode(mode):
    if mode not in _MODES:
        raise ValueError("quantize mode must be one of %r, got %r"
                         % (_MODES, mode))


@torch.no_grad()
def quantize_params(params, mode="int8", group=128, tp=1):
    """Quantize the GEMM weight leaves of a decoder params dict.

    ``params`` is the ``CausalLM.params()`` dict; the qkv/proj/ffn weights
    become :class:`QuantW8`/:class:`QuantW4` on the weights' device,
    everything else is returned as is.  The codes and scales are the JAX
    package's, bit for bit.  With ``tp > 1`` the int4 group of the
    row-parallel ``wo`` and ``w2`` shrinks to divide their per-shard input
    dim (:func:`_tp_group`), as ``mxnet_tpu/serving/quantize.py:74-83``
    does."""
    _check_mode(mode)
    tp = max(1, int(tp))
    out = dict(params)
    layers = []
    for lp in params["layers"]:
        qlp = dict(lp)
        for kind in _decoder._QUANT_KINDS:
            w = lp[kind].detach()
            qlp[kind] = (_qmm.quantize_w8(w) if mode == "int8"
                         else _qmm.quantize_w4(w, group=_tp_group(
                             kind, w.shape[1], group, tp)))
        layers.append(qlp)
    out["layers"] = layers
    return out


def _tp_group(kind, in_dim, group, tp):
    """The int4 group asked of ``quantize_w4`` for GEMM leaf ``kind`` of
    ``in_dim`` inputs at tensor-parallel degree ``tp``: the row-parallel
    leaves (``wo``, ``w2``) split their inputs ``tp`` ways, so their group
    is :func:`~..ops.kernels.quant_matmul.group_for` the shard's inputs
    (``wo`` at I 768 and tp 4: 64 of 192); the others keep ``group``."""
    local = in_dim // tp if kind in _decoder._TP_ROW else in_dim
    return _qmm.group_for(local, group)


class QuantizedLM:
    """A served LM with weight-only quantized GEMMs.

    Offers what ``DecodeEngine`` reads off a model: ``config``,
    ``eos_id``, ``device`` and ``params(tp=)``, the quantized params dict,
    made once at the first call and cached, per tensor-parallel degree
    for int4 (whose row-parallel groups depend on it).  A wrapper whose
    codes came from :meth:`load_jax_params` serves them at the degree they
    were quantized for, and no other.  The engine reads
    :meth:`quant_token` to report the format."""

    def __init__(self, model, mode="int8", group=128):
        _check_mode(mode)
        self.model = model
        self.quant_mode = str(mode)
        self.group = int(group)
        self._params = {}        # tp degree (1 for int8) -> params dict
        self._loaded = None      # the key of load_jax_params' codes

    @property
    def config(self):
        return self.model.config

    @property
    def eos_id(self):
        return getattr(self.model, "eos_id", None)

    @property
    def device(self):
        return self.model.device

    def quant_token(self):
        """``("int8",)`` or ``("int4", group)``."""
        if self.quant_mode == "int8":
            return ("int8",)
        return ("int4", self.group)

    def _key(self, tp):
        return max(1, int(tp)) if self.quant_mode == "int4" else 1

    def params(self, tp=1):
        """The quantized params dict for tensor-parallel degree ``tp`` (made
        once, then cached; int8 ignores ``tp``).  After
        :meth:`load_jax_params` an int4 wrapper has no fp GEMM weights to
        quantize at another degree (the wrapped model's were not loaded):
        asking for one raises ``ValueError``."""
        key = self._key(tp)
        if key not in self._params:
            if self._loaded is not None:
                raise ValueError(
                    "this int4 wrapper holds the codes loaded from JAX at "
                    "tp %d and no fp GEMM weights, so it cannot quantize "
                    "for tp %d: load the pytree quantized at tp %d"
                    % (self._loaded, key, key))
            self._params[key] = quantize_params(
                self.model.params(), self.quant_mode, group=self.group,
                tp=key)
        return self._params[key]

    @torch.no_grad()
    def load_jax_params(self, params_np, tp=1):
        """Load a JAX quantized pytree, the numpy form of
        ``mxnet_tpu.serving.quantize.quantize_params(jax_params(), mode,
        group, tp)``: its fp leaves go into the wrapped model, its
        ``QuantW8``/``QuantW4`` leaves become this wrapper's params at
        ``tp`` (the cache of every other degree is dropped).  The format
        must be this wrapper's (mode, and the group of each leaf at
        ``tp``); the wrapped model's fp GEMM weights are left as they
        are, so an int4 wrapper then serves ``tp`` alone (:meth:`params`)."""
        state = _decoder.params_from_jax(params_np)
        own = dict(self.model.named_parameters())
        if set(state) != set(own):
            raise ValueError("load_jax_params: parameter names differ: %s"
                             % sorted(set(state) ^ set(own)))
        want = _qmm.QuantW8 if self.quant_mode == "int8" else _qmm.QuantW4
        dev = self.device
        layers = [dict() for _ in range(self.config.num_layers)]
        for name, t in state.items():
            kind = name.rsplit(".", 1)[-1]
            if kind in _decoder._QUANT_KINDS:
                if not isinstance(t, want):
                    raise ValueError("load_jax_params: %s is %s, this "
                                     "wrapper serves %s" % (
                                         name, type(t).__name__,
                                         self.quant_mode))
                i = own[name].shape[1]
                group = _qmm.w4_group(i, _tp_group(kind, i, self.group, tp))
                if (want is _qmm.QuantW4
                        and 2 * t.q.shape[1] // t.s.shape[1] != group):
                    raise ValueError("load_jax_params: %s has int4 group %d, "
                                     "this wrapper quantizes with %d at tp "
                                     "%d" % (name, 2 * t.q.shape[1]
                                             // t.s.shape[1], group, tp))
                layers[int(name.split(".")[1])][kind] = type(t)(
                    q=t.q.to(dev), s=t.s.to(dev))
                continue
            if _qmm.is_quantized(t) or own[name].shape != t.shape:
                raise ValueError("load_jax_params: %s does not match the "
                                 "model's fp parameter" % name)
            own[name].copy_(t)
        fp = self.model.params()
        for lp, flp in zip(layers, fp["layers"]):
            for k in _decoder.LAYER_KEYS:
                lp.setdefault(k, flp[k])
        self._loaded = self._key(tp)
        self._params = {self._loaded: {"embed": fp["embed"],
                                       "pos": fp["pos"], "layers": layers}}
        return self

    def __repr__(self):
        return "QuantizedLM(%r, mode=%s%s)" % (
            self.model, self.quant_mode,
            ", group=%d" % self.group if self.quant_mode == "int4" else "")


def quantize_lm(model, mode="int8", group=128):
    """Wrap ``model`` for weight-only quantized serving.

    Returns a :class:`QuantizedLM`; hand it to ``DecodeEngine`` in place
    of the fp model.  ``mode`` is ``"int8"`` (per output channel) or
    ``"int4"`` (per group, ``group`` inputs per scale).  Quantizing an
    already quantized model re-wraps the underlying fp model (modes do not
    compose: each quantizes from fp32)."""
    if isinstance(model, QuantizedLM):
        model = model.model
    return QuantizedLM(model, mode=mode, group=group)
