"""Causal decoder LM for autoregressive decode serving (the port of
``mxnet_tpu/models/decoder.py``).

The model half of ``serving/generate.py``'s continuous-batching engine:
a GPT-style post-LN decoder (erf GELU, biased projections, learned
positions, tied LM head) with the pieces an LLM server needs:

- :func:`full_forward`       — whole-sequence causal forward, attending
  through ``ops.attention.flash_attention`` (the flash forward kernel on
  the card, its plain version on the CPU): the oracle the incremental
  paths are held against (tests and ``chip_smoke.py``).
- :func:`make_prefill_chunk` — one sequence's fixed-size chunk of prompt
  tokens: scatter their KV into the cache pages, attend causally over the
  sequence's own pages.  Its FFN runs the ``bias_gelu`` kernel.
- :func:`make_decode_step`   — one token per sequence over the slot
  batch: KV append, the paged-attention kernel, the ``bias_gelu`` kernel
  between torch matmuls, greedy next token.
- :func:`make_decode_step_fused` — the same step as one
  ``fused_cell.decode_layer_group`` kernel launch per layer group (fp
  weights and fp pages only).

Tensor parallelism (:class:`TPPlan`, from :func:`tp_plan` and a
``parallel.ShardingConfig`` with a ``tp`` axis): the steps and the chunk
built with ``plan=`` take the per-shard weights of
:meth:`TPPlan.shard_params` (Megatron column shards of ``wq``/``wk``/
``wv``/``w1``, row shards of ``wo``/``w2``) and run every layer shard by
shard over the shard's heads, KV heads and FFN columns, with the
row-parallel partial products summed by :func:`_all_reduce`.  The port
runs on one card, so the shards run in turn there and the all-reduce is a
fixed-order sum; the page pools keep the tp = 1 layout, a shard's slab
being a contiguous view (:meth:`TPPlan.kv_view`).  The fused TP step runs
one ``fused_cell.decode_attn_phase`` and one ``decode_ffn_phase`` launch
per layer per shard (fp weights and fp pages only); the per-op TP step and
the TP chunk also take quantized shards and int8 ``QPages`` slabs.

Quantized serving: the six GEMM leaves (:data:`_QUANT_KINDS`) may be
``quant_matmul.QuantW8``/``QuantW4`` (``serving.quantize``), which every
GEMM routes through the ``quant_matmul`` kernel (:func:`_dot_t`); and the
page pools may be ``paged_attention.QPages`` (int8 codes + one scale per
(layer, KV head, page)), which :func:`_kv_append` quantizes with the
page-start scale latch and the paged-attention kernel dequantizes as it
reads.

The KV page pools ``(layers, KVH, total_pages, page_size, head_dim)`` are
updated IN PLACE by every step; the steps return the same tensors.  This
replaces the JAX package's buffer donation (``jax.jit(...,
donate_argnums=(1, 2))``).

GQA layout: head ``h`` reads KV head ``h // (H // KVH)``.  Weights are a
nested dict ``{"embed", "pos", "layers": [{wq, bq, ..., ln2b}]}`` with the
same names and shapes as ``mxnet_tpu``'s ``CausalLM.jax_params()``
(gluon's (out, in) weight layout), so :func:`params_from_jax` carries a
JAX model's weights across unchanged.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import context
from ..ops import attention as _attention
from ..ops.kernels import epilogue as _epilogue
from ..ops.kernels import fused_cell as _fused
from ..ops.kernels import paged_attention as _paged
from ..ops.kernels import quant_matmul as _qmm

__all__ = ["DecoderConfig", "CausalLM", "full_forward", "make_decode_step",
           "make_decode_step_fused", "make_prefill_chunk", "params_from_jax",
           "TPPlan", "tp_plan", "decoder_tiny", "decoder_tiny_lm"]

LAYER_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
              "w1", "b1", "w2", "b2", "ln1g", "ln1b", "ln2g", "ln2b")

#: the GEMM leaves quantize_lm replaces with QuantW8/QuantW4 structures
#: (biases, LN params and embeddings stay fp32)
_QUANT_KINDS = ("wq", "wk", "wv", "wo", "w1", "w2")


class DecoderConfig(NamedTuple):
    """Static model geometry."""
    vocab_size: int
    num_layers: int
    units: int
    hidden_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_length: int


def _ln(x, gamma, beta, eps=1e-5):
    """LayerNorm in fp32 over the last axis (biased variance, eps 1e-5)."""
    return F.layer_norm(x.float(), x.shape[-1:], gamma, beta, eps).to(x.dtype)


def _dot_t(x, w, plain=False):
    """``x @ w.T`` for an integer weight leaf (``QuantW8``/``QuantW4``,
    gluon's (out, in) layout): the ``quant_matmul`` kernel, or its plain
    version when ``plain``."""
    return (_qmm.quant_matmul_plain if plain else _qmm.quant_matmul)(x, w)


def _proj(x, w, b=None, plain=False):
    """Dense: x @ w.T + b.  fp weights take ``F.linear`` (bias inside the
    matmul); integer ones :func:`_dot_t`, with the bias added after, as in
    the JAX package."""
    if not _qmm.is_quantized(w):
        return F.linear(x, w, b)
    y = _dot_t(x, w, plain)
    return y if b is None else y + b


def _ffn(x, lp, plain=False):
    """PositionwiseFFN math; ``plain`` selects the plain bias_gelu and
    quant_matmul."""
    gelu = _epilogue.bias_gelu_plain if plain else _epilogue.bias_gelu
    h = gelu(_proj(x, lp["w1"], plain=plain), lp["b1"])
    return _proj(h, lp["w2"], lp["b2"], plain)


def _qkv(x, lp, cfg, plain=False):
    """x: (..., C) -> q (..., H, D), k/v (..., KVH, D)."""
    lead = x.shape[:-1]
    q = _proj(x, lp["wq"], lp["bq"], plain).reshape(
        lead + (cfg.num_heads, cfg.head_dim))
    k = _proj(x, lp["wk"], lp["bk"], plain).reshape(
        lead + (cfg.num_kv_heads, cfg.head_dim))
    v = _proj(x, lp["wv"], lp["bv"], plain).reshape(
        lead + (cfg.num_kv_heads, cfg.head_dim))
    return q, k, v


def _layer_tail(x, att_merged, lp, plain=False):
    """Post-attention epilogue: proj + residual LN + FFN + residual LN
    (post-LN, the TransformerLayer convention)."""
    o = _proj(att_merged, lp["wo"], lp["bo"], plain)
    x = _ln(x + o, lp["ln1g"], lp["ln1b"])
    return _ln(x + _ffn(x, lp, plain), lp["ln2g"], lp["ln2b"])


def _quantized(params):
    return any(_qmm.is_quantized(lp[k]) for lp in params["layers"]
               for k in _QUANT_KINDS)


# ---------------------------------------------------------------------------
# KV page access: fp tensors or int8 QPages behind one set of helpers
# ---------------------------------------------------------------------------
def _kv_append(pages, li, wp, ws, val):
    """Scatter new tokens into layer ``li``'s pages of an engine pool
    ``(L, KVH, P, S, D)`` (or :class:`~..ops.kernels.paged_attention.
    QPages` of that layout), in place: :func:`_kv_write` on the layer's
    view."""
    _kv_write(_paged.kv_heads(pages, li), wp, ws, val)


def _kv_write(pages_li, wp, ws, val):
    """Scatter new tokens into one layer's pages, in place: fp pages
    ``(KVH, P, S, D)`` or int8 ``QPages`` of that layer (codes of that
    shape, scales ``(KVH, P)``), whole or a tensor-parallel shard's
    KV-head slab (:meth:`TPPlan.kv_view`), written where they lie.

    ``wp``/``ws``: (..., T) write page/slot per token; the last axis holds
    consecutive positions of one sequence (decode passes T=1, prefill the
    chunk); ``val``: ``ws.shape + (KVH, D)``, the layout of the JAX
    package's ``pages.at[li, :, wp, ws, :].set(val)``.  NumPy counts the
    integer ``li`` as an advanced index, so there the index dimensions go
    first; torch indexes the layer's view and keeps the (adjacent)
    page/slot dimensions in place, behind the KV-head axis — hence the
    explicit moves of the head axis of ``val``, of the codes and of the
    scales.

    int8 pages quantize with the page-start scale latch: a token landing
    at page slot 0 sets its page's per-head scale to ``amax / 127``; every
    other token reuses the scale its page start latched — looked up in
    this call's window when the start is in it (``src = t - ws``), from
    the scales pool otherwise.  The latch is per KV head, so a shard's
    slab latches the scales the whole pool would."""
    wpl, wsl = wp.long(), ws.long()
    if not isinstance(pages_li, _paged.QPages):
        pages_li[:, wpl, wsl, :] = val.movedim(-2, 0)
        return
    vf = val.to(torch.float32)
    amax = vf.abs().amax(dim=-1)                        # ws.shape + (KVH,)
    fresh = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    old = pages_li.s[:, wpl].movedim(0, -1)             # ws.shape + (KVH,)
    t = ws.shape[-1]
    src = torch.arange(t, device=ws.device) - wsl       # page-start index
    start_fresh = torch.take_along_dim(
        fresh, src.clamp(0, t - 1)[..., None], dim=-2)
    snew = torch.where((src >= 0)[..., None], start_fresh, old)
    codes = torch.round(vf / snew[..., None]).clamp(-127, 127).to(torch.int8)
    pages_li.q[:, wpl, wsl, :] = codes.movedim(-2, 0)
    pages_li.s[:, wpl] = snew.movedim(-1, 0)


def _gather_kv(pages_li, tables):
    """Contiguous fp32 per-sequence context from one layer's pages: a
    plain gather for fp pages, gather + dequantize for int8."""
    if isinstance(pages_li, _paged.QPages):
        return _paged.gather_pages_deq(pages_li.q, pages_li.s, tables)
    return _paged.gather_pages(pages_li, tables)


def _repeat_kv(t, g, dim):
    """GQA: KV head k serves query heads k*g .. k*g+g-1."""
    return t if g == 1 else t.repeat_interleave(g, dim=dim)


def _logits(x, params):
    return x.float() @ params["embed"].float().T


# ---------------------------------------------------------------------------
# tensor-parallel plan (ShardingConfig -> per-shard decode geometry)
# ---------------------------------------------------------------------------
#: the Megatron layout :func:`tp_plan` requires of the sharding rules: the
#: gluon path of a layer leaf (what ShardingConfig.for_transformer's rules
#: are written against) and the spec they must resolve it to
_TP_LAYOUT = {
    "wq": ("attention.qkv.weight", ("tp",)),
    "wk": ("attention.qkv.weight", ("tp",)),
    "wv": ("attention.qkv.weight", ("tp",)),
    "bq": ("attention.qkv.bias", ("tp",)),
    "w1": ("ffn.ffn1.weight", ("tp",)), "b1": ("ffn.ffn1.bias", ("tp",)),
    "wo": ("attention.proj.weight", (None, "tp")),
    "w2": ("ffn.ffn2.weight", (None, "tp")),
}
#: leaves split along their output rows (contiguous row slices)
_TP_COLUMN = ("wq", "bq", "wk", "bk", "wv", "bv", "w1", "b1")
#: leaves split along their input columns (copied to contiguous tensors)
_TP_ROW = ("wo", "w2")


def _all_reduce(parts):
    """The all-reduce of a tensor-parallel layer: the sum of the shards'
    partial products, in shard order (shard 0, then 1, ...), so results do
    not depend on timing.  The port runs every shard on one card; a
    ``torch.distributed`` backend would go here and nowhere else."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class TPPlan:
    """The tensor-parallel serving layout of one (cfg, ShardingConfig),
    the port of the JAX package's ``TPPlan`` (``decoder.py:296-420``).
    Built by :func:`tp_plan`.

    ``local_cfg`` is a shard's geometry: heads, KV heads and FFN width
    divided by tp; ``units`` and ``head_dim`` stay full, since activations
    are replicated.  A mesh's ``dp`` axis does not multiply the work: in
    the JAX program every dp lane computes the same thing, so the port
    computes it once.  ``all_reduces`` counts the :func:`_all_reduce` calls
    of the steps built with this plan (the engine's collective census)."""

    def __init__(self, sharding, cfg):
        self.tp = int(sharding.axis_size("tp"))
        self.local_cfg = cfg._replace(
            num_heads=cfg.num_heads // self.tp,
            num_kv_heads=cfg.num_kv_heads // self.tp,
            hidden_size=cfg.hidden_size // self.tp)
        self.all_reduces = 0

    def all_reduce(self, parts):
        """:func:`_all_reduce`, counted."""
        self.all_reduces += 1
        return _all_reduce(parts)

    def shard_params(self, params):
        """The tp per-shard weight dicts ``[{"embed", "pos", "layers"}]``
        of a full weight dict, fp32 or quantized, built once (at engine
        init).  Column shards (:data:`_TP_COLUMN`) are contiguous row
        slices of the full tensors (views); row shards of ``wo``/``w2`` are
        contiguous copies of column slices, as the phase kernels read
        them; ``bo``, ``b2``, the LN affines and the embeddings are the
        full tensors, shared.  Quantized leaves (``QuantW8``/``QuantW4``)
        are cut by ``quant_matmul.shard_quantized`` along the same axes, as
        the JAX plan's ``param_specs`` places them: the codes follow the
        fp weight's axes, int8 scales its output axis only (replicated on
        the row shards), int4 group scales both."""
        tp = self.tp
        shards = [{"embed": params["embed"], "pos": params["pos"],
                   "layers": []} for _ in range(tp)]
        for lp in params["layers"]:
            parts = {k: self._cut(lp[k], 0) for k in _TP_COLUMN}
            parts.update((k, self._cut(lp[k], 1)) for k in _TP_ROW)
            for r in range(tp):
                d = dict(lp)
                d.update((k, p[r]) for k, p in parts.items())
                shards[r]["layers"].append(d)
        return shards

    def _cut(self, w, dim):
        """A leaf's tp parts along ``dim`` (0: column, 1: row)."""
        if _qmm.is_quantized(w):
            return _qmm.shard_quantized(w, self.tp, dim)
        parts = w.chunk(self.tp, dim=dim)
        return [p.contiguous() for p in parts] if dim else list(parts)

    def kv_view(self, pages, li, r):
        """Shard ``r``'s page slab of layer ``li``: its KV heads of the
        engine's ``(L, KVH, total, S, D)`` pool, or of ``QPages`` of that
        layout (codes and their ``(L, KVH, total)`` scales split alike), a
        contiguous view."""
        n = self.local_cfg.num_kv_heads
        return _paged.kv_heads(pages, li, r * n, (r + 1) * n)


def tp_plan(cfg, sharding):
    """A :class:`TPPlan` for ``cfg`` on ``sharding``, or None when the
    engine serves replicated: no config, or a tp axis of size 1 or none.
    When tp does not divide the heads, KV heads or FFN width, or the rules
    do not give the Megatron column/row layout, it warns and returns None,
    as the JAX package's ``tp_plan`` does (``decoder.py:439-466``)."""
    if sharding is None:
        return None
    tp = int(sharding.axis_size("tp"))
    if tp <= 1:
        return None
    bad = ["%s=%d" % (name, n) for name, n in (
        ("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads),
        ("hidden_size", cfg.hidden_size)) if n % tp]
    if bad:
        warnings.warn(
            "decoder: tp=%d does not divide %s; serving REPLICATED (pick tp "
            "dividing the head/FFN geometry)" % (tp, ", ".join(bad)),
            stacklevel=2)
        return None
    shapes = DecoderLayer.shapes(cfg.units, cfg.hidden_size, cfg.num_heads,
                                 cfg.num_kv_heads)
    off = [k for k, (path, want) in _TP_LAYOUT.items()
           if sharding.param_spec("layers.0." + path, shapes[k]) != want]
    if off:
        warnings.warn(
            "decoder: sharding rules do not resolve the Megatron column/row "
            "layout for %s (use ShardingConfig.for_transformer); serving "
            "REPLICATED" % ", ".join(sorted(off)), stacklevel=2)
        return None
    return TPPlan(sharding, cfg)


def _tp_inputs(params, plan):
    """The per-shard weights a TP step takes (fp or quantized; the pages fp
    or ``QPages``), checked."""
    if not isinstance(params, (list, tuple)) or len(params) != plan.tp:
        raise TypeError("a tensor-parallel step takes the %d per-shard weight "
                        "dicts of TPPlan.shard_params, not %s"
                        % (plan.tp, type(params).__name__))
    return params


def _ffn_part(x, lp):
    """A shard's FFN partial product, per op: FFN1 on its column shard, the
    bias_gelu kernel, FFN2 on its row shard with no bias (fp leaves by
    ``F.linear``, quantized ones by ``quant_matmul``)."""
    return _proj(_epilogue.bias_gelu(_proj(x, lp["w1"]), lp["b1"]),
                 lp["w2"])


def _layer_tail_tp(x, o_parts, lps, plan, ffn_part=_ffn_part):
    """The row-parallel tail of a Megatron layer over the shards:
    ``o_parts`` are the shards' out-projection partial products, ``lps``
    their layer weights and ``ffn_part(x, lp)`` a shard's FFN partial.  The
    partials are all-reduced and the replicated ``bo``/``b2`` added after
    the sum, as the JAX package's ``_layer_tail(axis=)`` does
    (``decoder.py:189-208``)."""
    lp0 = lps[0]
    x = _ln(x + (plan.all_reduce(o_parts) + lp0["bo"]), lp0["ln1g"],
            lp0["ln1b"])
    f = plan.all_reduce([ffn_part(x, lp) for lp in lps])
    return _ln(x + (f + lp0["b2"]), lp0["ln2g"], lp0["ln2b"])


# ---------------------------------------------------------------------------
# full-sequence causal forward (the oracle)
# ---------------------------------------------------------------------------
def full_forward(params, cfg, tokens):
    """tokens: (B, L) int -> logits (B, L, vocab) float32.

    Whole-sequence causal attention through the flash kernel (its plain
    version on the CPU) and the layer stack in plain PyTorch (quantized
    GEMMs take ``quant_matmul_plain``), the oracle for the incremental
    paged paths."""
    B, L = tokens.shape
    g = cfg.num_heads // cfg.num_kv_heads
    tokens = tokens.long()
    x = params["embed"][tokens] + params["pos"][:L]
    for lp in params["layers"]:
        q, k, v = _qkv(x, lp, cfg, plain=True)          # (B, L, H/KVH, D)
        q4 = q.transpose(1, 2).float()                   # (B, H, L, D)
        k4 = _repeat_kv(k.transpose(1, 2), g, 1).float()
        v4 = _repeat_kv(v.transpose(1, 2), g, 1).float()
        att = _attention.flash_attention(q4, k4, v4, causal=True)
        merged = att.transpose(1, 2).reshape(B, L, cfg.units).to(x.dtype)
        x = _layer_tail(x, merged, lp, plain=True)
    return _logits(x, params)


# ---------------------------------------------------------------------------
# incremental decode over the paged KV cache
# ---------------------------------------------------------------------------
def _step_inputs(params, cfg, S, tokens, positions, page_tables, active):
    """Embeddings, write page/slot and context lengths of one decode step.
    Inactive slots write the scratch page 0, slot 0, and read length 0."""
    pps = page_tables.shape[1]
    x = (params["embed"][tokens.long()]
         + params["pos"][positions.long().clamp(0, cfg.max_length - 1)])
    page_of = page_tables.long().gather(
        1, (positions.long() // S).clamp(0, pps - 1)[:, None])[:, 0]
    wp = torch.where(active, page_of, 0).to(torch.int32)
    ws = torch.where(active, positions.long() % S, 0).to(torch.int32)
    lengths = torch.where(active, positions.long() + 1, 0).to(torch.int32)
    return x, wp, ws, lengths


def make_decode_step(cfg, page_size, plan=None):
    """The per-op batched decode step for (cfg, page_size), or with a
    :class:`TPPlan` the tensor-parallel one: per layer, shard by shard, the
    qkv over the shard's heads, the KV append into its slab and the
    paged-attention kernel; then the row-parallel tail
    (:func:`_layer_tail_tp`), as the JAX package's ``_build_decode_step``
    (``decoder.py:527-568``).

    fn(params, k_pages, v_pages, tokens, positions, page_tables, active)
      params:     fp or quantized weights (GEMMs through quant_matmul); with
                  a plan, the per-shard list of ``plan.shard_params``
      k_pages/v_pages: (layers, KVH, total_pages, page_size, head_dim),
                       or QPages of that layout, updated in place
      tokens:     (B,) int — this step's input token per slot
      positions:  (B,) int — cache index the token lands at
      page_tables:(B, pages_per_seq) int32
      active:     (B,) bool — inactive slots write the scratch page and
                  read nothing; the engine discards their outputs
    -> (k_pages, v_pages, next_tokens (B,) int32, logits (B, vocab) f32)
    """
    S = int(page_size)
    if plan is not None:
        return _tp_decode_step(cfg, S, plan, fused=False)

    def step(params, k_pages, v_pages, tokens, positions, page_tables,
             active):
        B = tokens.shape[0]
        x, wp, ws, lengths = _step_inputs(params, cfg, S, tokens, positions,
                                          page_tables, active)
        for li, lp in enumerate(params["layers"]):
            q, k, v = _qkv(x, lp, cfg)                  # (B, H/KVH, D)
            _kv_append(k_pages, li, wp[:, None], ws[:, None], k[:, None])
            _kv_append(v_pages, li, wp[:, None], ws[:, None], v[:, None])
            att = _paged.paged_attention(
                q.contiguous(), _paged.kv_heads(k_pages, li),
                _paged.kv_heads(v_pages, li), lengths, page_tables)
            x = _layer_tail(x, att.reshape(B, cfg.units), lp)
        logits = _logits(x, params)
        return (k_pages, v_pages,
                logits.argmax(dim=-1).to(torch.int32), logits)

    return step


def _fused_ffn_part(x, lp):
    """A shard's FFN partial product through the FFN phase kernel (#14)."""
    return _fused.decode_ffn_phase(x, lp["w1"], lp["b1"], lp["w2"])


def _tp_decode_step(cfg, S, plan, fused):
    """The tensor-parallel decode step, per-op or through the phase
    kernels (#13, #14)."""
    lcfg = plan.local_cfg
    Cl = lcfg.num_heads * cfg.head_dim

    def attn_part(x, lp, kp, vp, wp, ws, page_tables, lengths):
        """A shard's attention half, per op: its out-projection partial."""
        q, k, v = _qkv(x, lp, lcfg)                     # (B, Hl/KVHl, D)
        _kv_write(kp, wp[:, None], ws[:, None], k[:, None])
        _kv_write(vp, wp[:, None], ws[:, None], v[:, None])
        att = _paged.paged_attention(q.contiguous(), kp, vp, lengths,
                                     page_tables)
        return _proj(att.reshape(x.shape[0], Cl), lp["wo"])

    def step(params, k_pages, v_pages, tokens, positions, page_tables,
             active):
        shards = _tp_inputs(params, plan)
        if fused and (isinstance(k_pages, _paged.QPages)
                      or _quantized(shards[0])):
            raise ValueError("make_decode_step_fused: the phase kernels take "
                             "fp32 weights and fp32 pages; quantized weights "
                             "or int8 QPages take make_decode_step")
        x, wp, ws, lengths = _step_inputs(shards[0], cfg, S, tokens,
                                          positions, page_tables, active)
        meta = torch.stack([wp, ws])
        for li in range(cfg.num_layers):
            lps = [sh["layers"][li] for sh in shards]
            o_parts = []
            for r, lp in enumerate(lps):
                kp = plan.kv_view(k_pages, li, r)
                vp = plan.kv_view(v_pages, li, r)
                if fused:
                    o = _fused.decode_attn_phase(x, kp, vp, lp, meta,
                                                 page_tables, lengths, lcfg)[2]
                else:
                    o = attn_part(x, lp, kp, vp, wp, ws, page_tables, lengths)
                o_parts.append(o)
            x = _layer_tail_tp(x, o_parts, lps, plan, ffn_part=(
                _fused_ffn_part if fused else _ffn_part))
        logits = _logits(x, shards[0])
        return (k_pages, v_pages,
                logits.argmax(dim=-1).to(torch.int32), logits)

    return step


def _group_bounds(num_layers, layer_group):
    """[(lo, hi), …] contiguous layer groups of size ≤ layer_group
    (0 / >=L collapses to one group — the default: ONE launch/step)."""
    g = int(layer_group) or num_layers
    g = max(1, min(g, num_layers))
    return [(lo, min(lo + g, num_layers))
            for lo in range(0, num_layers, g)]


def make_decode_step_fused(cfg, page_size, layer_group=0, plan=None):
    """The persistent-kernel decode step: one
    ``fused_cell.decode_layer_group`` launch per layer group (default:
    all layers in one group).  Same signature and in-place page contract
    as :func:`make_decode_step`.  The kernel reads each layer's weights
    through a pointer table (``fused_cell.WeightTable``) built once per
    group when the step first sees a weight set, so no weights are
    stacked or copied per step.

    With a :class:`TPPlan` (``layer_group`` is then not read), per layer:
    one ``fused_cell.decode_attn_phase`` launch per shard, the all-reduce of
    their partials + ``bo`` and the residual LN, one
    ``fused_cell.decode_ffn_phase`` launch per shard, the all-reduce +
    ``b2`` and the LN, as the JAX package's ``decoder.py:656-671``.

    The kernels take fp32 weights and fp32 pages only: quantized weights
    or ``QPages`` raise ``ValueError`` (the engine serves them with the
    per-op step, as the JAX engine does)."""
    S = int(page_size)
    if plan is not None:
        return _tp_decode_step(cfg, S, plan, fused=True)
    groups = _group_bounds(cfg.num_layers, layer_group)
    seen = {}       # the last weight set's layer list -> its group tables

    def tables(params, device):
        layers = params["layers"]
        if seen.get("layers") is not layers:
            if _quantized(params):
                raise ValueError("make_decode_step_fused: the fused decode "
                                 "kernel takes fp32 weights; quantized "
                                 "weights take make_decode_step")
            seen["tables"] = [_fused.WeightTable(layers[lo:hi], device)
                              for lo, hi in groups]
            seen["layers"] = layers
        return seen["tables"]

    def step(params, k_pages, v_pages, tokens, positions, page_tables,
             active):
        if isinstance(k_pages, _paged.QPages):
            raise ValueError("make_decode_step_fused: the fused decode "
                             "kernel takes fp32 pages; int8 QPages take "
                             "make_decode_step")
        x, wp, ws, lengths = _step_inputs(params, cfg, S, tokens, positions,
                                          page_tables, active)
        meta = torch.stack([wp, ws])
        for (lo, hi), table in zip(groups, tables(params, k_pages.device)):
            _, _, x = _fused.decode_layer_group(
                x.contiguous(), k_pages[lo:hi], v_pages[lo:hi], table, meta,
                page_tables, lengths, cfg)
        logits = _logits(x, params)
        return (k_pages, v_pages,
                logits.argmax(dim=-1).to(torch.int32), logits)

    return step


def make_prefill_chunk(cfg, page_size, chunk, plan=None):
    """Single-sequence chunk prefill for (cfg, page_size, chunk); with a
    :class:`TPPlan` shard by shard per layer (the shard's heads and slab,
    its FFN columns), with the row-parallel tail (:func:`_layer_tail_tp`),
    as the JAX package's ``_build_prefill_chunk`` (``decoder.py:825-870``).

    fn(params, k_pages, v_pages, tokens, pos0, n_valid, page_row)
      tokens:  (chunk,) int — prompt slice, padded past n_valid
      pos0:    int — absolute cache position of tokens[0]
      n_valid: int — valid tokens in this chunk
      page_row:(pages_per_seq,) int32 — THIS sequence's page table
    -> (k_pages, v_pages, next_token () int32, last_logits (vocab,) f32)

    The chunk's KV is scattered into the sequence's pages first (padded
    tokens go to the scratch page), then the chunk's queries attend over
    the gathered pages (prefix + chunk, read back dequantized from int8
    QPages) under a causal mask."""
    S = int(page_size)
    P = int(chunk)
    lcfg = plan.local_cfg if plan is not None else cfg
    g = cfg.num_heads // cfg.num_kv_heads
    scale = 1.0 / (cfg.head_dim ** 0.5)

    def attend(q, kp_li, vp_li, page_row, causal):
        """One layer's (or shard's) chunk attention over the sequence's
        gathered pages: q (P, H, D) -> (P, H D)."""
        kc = _gather_kv(kp_li, page_row[None])[0]
        vc = _gather_kv(vp_li, page_row[None])[0]
        kr = _repeat_kv(kc, g, 0).float()                # (H, ctx, D)
        vr = _repeat_kv(vc, g, 0).float()
        qf = q.float().transpose(0, 1) * scale           # (H, P, D)
        # every query row sees key 0, so no row is fully masked
        logits = (qf @ kr.transpose(1, 2)).masked_fill(
            ~causal[None], float("-inf"))
        att = torch.softmax(logits, dim=-1) @ vr         # (H, P, D)
        return att.transpose(0, 1).reshape(P, q.shape[1] * q.shape[2])

    def prefill(params, k_pages, v_pages, tokens, pos0, n_valid, page_row):
        if plan is not None:
            params = _tp_inputs(params, plan)
        base = params[0] if plan is not None else params
        dev = page_row.device
        pps = page_row.shape[0]
        idx = int(pos0) + torch.arange(P, device=dev)
        valid = torch.arange(P, device=dev) < int(n_valid)
        x = (base["embed"][tokens.long()]
             + base["pos"][idx.clamp(0, cfg.max_length - 1)])
        # padded tokens of a last partial chunk may index past the page
        # row: clamp before the gather, then send them to the scratch page
        row = page_row.long()
        wp = torch.where(valid, row[(idx // S).clamp(max=pps - 1)], 0)
        ws = torch.where(valid, idx % S, 0)
        ctx = torch.arange(pps * S, device=dev)
        causal = ctx[None, :] <= idx[:, None]            # key <= query pos
        for li in range(cfg.num_layers):
            if plan is None:
                lp = params["layers"][li]
                q, k, v = _qkv(x, lp, cfg)              # (P, H/KVH, D)
                _kv_append(k_pages, li, wp, ws, k)
                _kv_append(v_pages, li, wp, ws, v)
                merged = attend(q, _paged.kv_heads(k_pages, li),
                                _paged.kv_heads(v_pages, li), page_row,
                                causal)
                x = _layer_tail(x, merged.to(x.dtype), lp)
                continue
            lps = [sh["layers"][li] for sh in params]
            o_parts = []
            for r, lp in enumerate(lps):
                q, k, v = _qkv(x, lp, lcfg)             # (P, Hl/KVHl, D)
                kp, vp = (plan.kv_view(k_pages, li, r),
                          plan.kv_view(v_pages, li, r))
                _kv_write(kp, wp, ws, k)
                _kv_write(vp, wp, ws, v)
                o_parts.append(_proj(attend(q, kp, vp, page_row, causal),
                                     lp["wo"]))
            x = _layer_tail_tp(x, o_parts, lps, plan)
        last = x[min(max(int(n_valid) - 1, 0), P - 1)]
        last_logits = _logits(last, base)
        return (k_pages, v_pages,
                last_logits.argmax().to(torch.int32), last_logits)

    return prefill


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def _frozen(shape, device):
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class DecoderLayer(nn.Module):
    """One post-LN decoder layer's weights, named as in ``jax_params()``
    (compute lives in the functions above)."""

    def __init__(self, units, hidden_size, num_heads, num_kv_heads, device):
        super().__init__()
        shapes = self.shapes(units, hidden_size, num_heads, num_kv_heads)
        for name in LAYER_KEYS:
            setattr(self, name, _frozen(shapes[name], device))

    @staticmethod
    def shapes(units, hidden_size, num_heads, num_kv_heads):
        """``{leaf: shape}`` of one layer's weights."""
        kvu = num_kv_heads * (units // num_heads)
        return {"wq": (units, units), "bq": (units,),
                "wk": (kvu, units), "bk": (kvu,),
                "wv": (kvu, units), "bv": (kvu,),
                "wo": (units, units), "bo": (units,),
                "w1": (hidden_size, units), "b1": (hidden_size,),
                "w2": (units, hidden_size), "b2": (units,),
                "ln1g": (units,), "ln1b": (units,),
                "ln2g": (units,), "ln2b": (units,)}


class CausalLM(nn.Module):
    """GPT-style causal decoder LM (tied input/output embedding).

    ``forward(tokens)`` is the full-sequence path (:func:`full_forward`);
    incremental generation runs through ``serving.DecodeEngine``.  The
    weights are frozen parameters made from ``seed`` by :meth:`initialize`
    on the CPU and copied to ``device`` (``cuda`` unless ``"cpu"`` is
    asked for), or loaded from a JAX model with :meth:`load_jax_params`."""

    def __init__(self, vocab_size=512, num_layers=2, units=128,
                 hidden_size=256, num_heads=4, num_kv_heads=None,
                 max_length=512, eos_id=None, *, device=None, seed=0):
        super().__init__()
        num_kv_heads = num_kv_heads or num_heads
        if units % num_heads or num_heads % num_kv_heads:
            raise ValueError("units must divide into num_heads, and "
                             "num_heads into num_kv_heads")
        self._cfg = DecoderConfig(
            vocab_size=int(vocab_size), num_layers=int(num_layers),
            units=int(units), hidden_size=int(hidden_size),
            num_heads=int(num_heads), num_kv_heads=int(num_kv_heads),
            head_dim=units // num_heads, max_length=int(max_length))
        self.eos_id = eos_id
        dev = context.resolve(device)
        self.embed = _frozen((vocab_size, units), dev)
        self.pos = _frozen((max_length, units), dev)
        self.layers = nn.ModuleList(
            DecoderLayer(units, hidden_size, num_heads, num_kv_heads, dev)
            for _ in range(num_layers))
        self.initialize(seed)

    @property
    def config(self):
        return self._cfg

    @property
    def device(self):
        return self.embed.device

    @torch.no_grad()
    def initialize(self, seed=0):
        """Xavier-uniform matrices (gluon's default ``Xavier()``: bound
        ``sqrt(6 / (fan_in + fan_out))``), zero biases, LN gamma 1 and
        beta 0, drawn from a ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() == 2:
                bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
                w = (torch.rand(p.shape, generator=gen) * 2 - 1) * bound
                p.copy_(w)
            elif leaf in ("ln1g", "ln2g"):
                p.fill_(1.0)
            else:
                p.zero_()
        return self

    def params(self):
        """The weights as the nested dict the step functions take
        (``{"embed", "pos", "layers": [dict]}``, the structure of the JAX
        package's ``jax_params()``)."""
        return {"embed": self.embed, "pos": self.pos,
                "layers": [{k: getattr(layer, k) for k in LAYER_KEYS}
                           for layer in self.layers]}

    @torch.no_grad()
    def load_jax_params(self, params_np):
        """Load the nested dict of numpy arrays that ``np.asarray`` makes
        of ``mxnet_tpu``'s ``CausalLM.jax_params()``.  Afterwards both
        packages compute the same function.  A quantized pytree (integer
        GEMM leaves) has no place in the fp parameters: load it with
        ``serving.quantize.QuantizedLM.load_jax_params``."""
        state = params_from_jax(params_np)
        if any(_qmm.is_quantized(t) for t in state.values()):
            raise ValueError("load_jax_params: the pytree holds quantized "
                             "weights; wrap the model with quantize_lm and "
                             "load it through QuantizedLM.load_jax_params")
        own = dict(self.named_parameters())
        if set(state) != set(own):
            raise ValueError("load_jax_params: parameter names differ: %s"
                             % sorted(set(state) ^ set(own)))
        for name, t in state.items():
            if own[name].shape != t.shape:
                raise ValueError("load_jax_params: %s has shape %s, want %s"
                                 % (name, tuple(t.shape),
                                    tuple(own[name].shape)))
            own[name].copy_(t)
        return self

    def forward(self, tokens):
        return full_forward(self.params(), self._cfg,
                            torch.as_tensor(tokens, device=self.device))


def _leaf_from_jax(leaf):
    """A float32 CPU tensor, or the port's ``QuantW8``/``QuantW4`` for a
    JAX quantized leaf (a ``(q, s)`` NamedTuple of numpy arrays)."""
    if tuple(getattr(leaf, "_fields", ())) == ("q", "s"):
        cls = (_qmm.QuantW4 if type(leaf).__name__ == "QuantW4"
               else _qmm.QuantW8)
        return cls(q=torch.tensor(leaf.q),
                   s=torch.tensor(leaf.s, dtype=torch.float32))
    return torch.tensor(leaf, dtype=torch.float32)


def params_from_jax(params_np):
    """Flat ``{parameter name: CPU tensor}`` from the nested dict of numpy
    arrays of a JAX ``CausalLM.jax_params()`` (or of its
    ``serving.quantize.quantize_params``): ``embed``, ``pos`` and
    ``layers.<i>.<key>`` — the names of :class:`CausalLM`'s parameters.
    fp leaves become float32 tensors; quantized GEMM leaves the port's
    ``QuantW8``/``QuantW4`` of the same codes and scales."""
    out = {"embed": _leaf_from_jax(params_np["embed"]),
           "pos": _leaf_from_jax(params_np["pos"])}
    for i, lp in enumerate(params_np["layers"]):
        for k in LAYER_KEYS:
            out["layers.%d.%s" % (i, k)] = _leaf_from_jax(lp[k])
    return out


# ---------------------------------------------------------------------------
# tiny models (tests)
# ---------------------------------------------------------------------------
def decoder_tiny(vocab_size=128, *, device=None, seed=0, **kw):
    kw.setdefault("num_layers", 2)
    kw.setdefault("units", 64)
    kw.setdefault("hidden_size", 128)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_kv_heads", 2)
    kw.setdefault("max_length", 128)
    return CausalLM(vocab_size, device=device, seed=seed, **kw)


def decoder_tiny_lm(seed=0, vocab_size=128, *, device=None, **kw):
    """Initialized, deterministic tiny LM made from ``seed``."""
    return decoder_tiny(vocab_size, device=device, seed=seed, **kw)
