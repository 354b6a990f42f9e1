"""Persistent fused-cell kernels: the port of
``mxnet_tpu/ops/pallas/fused_cell.py``.

- :func:`lstm_sequence` -- RNN training.  One kernel launch runs the
  whole LSTM time loop of one layer (``csrc/lstm.cu``, replacing
  ``_lstm_fwd_kernel``, ``fused_cell.py:142``), and two launches its
  time-reversed backward (replacing ``_lstm_bwd_kernel``, ``:195``): the
  gate recompute over all steps at once on the tensor cores, then the
  time loop; inside a ``torch.autograd.Function`` that saves what the JAX
  ``custom_vjp`` saves: the inputs, the h sequence (``out``) and the c
  sequence, and no per-gate activation.  The i2h GEMM stays outside (in
  ``ops/rnn.py``), and so do dW and db, as fp32 contractions over the
  per-step gate gradients.
- :func:`decode_layer_group` -- LLM decode.  For every layer of the group,
  for the whole decode batch, one kernel launch runs: the qkv
  projections, the KV append into the paged cache, paged attention, the
  out-projection with residual and post-LN, and the FFN with erf GELU,
  residual and post-LN.  The page pools are updated in place, which
  replaces the JAX kernel's ``input_output_aliases`` and the engine's
  buffer donation.
- :func:`decode_attn_phase` and :func:`decode_ffn_phase` -- LLM decode
  under tensor parallelism.  The layer-group fusion splits at the two
  all-reduces of a Megatron layer: for one shard of one layer, one launch
  runs the q/k/v projections over the shard's heads, the KV append into
  the shard's page slab and paged attention with each row's keys split
  over blocks in 64-key chunks (merged in chunk order), and the
  out-projection's partial product (no bias); another runs FFN1 on the
  column shard with its bias and erf GELU, and FFN2's partial product
  (no bias).  The
  caller sums the shards' partials (``models.decoder._all_reduce``) and
  adds the bias and the residual LayerNorm.

A CUDA tensor launches the cooperative kernels of ``csrc/lstm.cu``,
``csrc/fused_decode.cu`` and ``csrc/decode_phase.cu``, whose notes say
what bounds them on the card and how their design answers; a CPU tensor
runs the plain PyTorch versions (:func:`lstm_sequence_plain`,
:func:`lstm_sequence_backward_plain`, :func:`decode_layer_group_plain`,
:func:`decode_attn_phase_plain`, :func:`decode_ffn_phase_plain`;
:func:`lstm_bwd_gates_plain` is the recompute's).  Launches are counted
in ``lstm_sequence.launches_fwd``/``.launches_bwd_gates``/``.launches_bwd``,
``decode_layer_group.launches``, ``decode_attn_phase.launches`` and
``decode_ffn_phase.launches``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .epilogue import _sms, bias_gelu_plain
from .paged_attention import paged_attention_reference

__all__ = ["lstm_sequence", "lstm_sequence_plain",
           "lstm_sequence_backward_plain", "lstm_bwd_gates_plain",
           "lstm_record_gates", "lstm_plan",
           "decode_layer_group", "decode_layer_group_plain", "WeightTable",
           "WEIGHT_ORDER", "PHASES", "GEMV_PHASES", "grid_blocks",
           "phase_times",
           "LSTM_BWD_PHASES", "LSTM_GATES_PHASES", "lstm_bwd_phase_times",
           "LSTM_FWD_PHASES", "lstm_fwd_phase_times",
           "decode_attn_phase", "decode_attn_phase_plain",
           "decode_attn_phase_times", "ATTN_PHASES", "decode_ffn_phase",
           "decode_ffn_phase_plain", "decode_ffn_phase_times", "FFN_PHASES",
           "phase_grid_blocks"]

#: the kernel's phases per layer, separated by grid-wide barriers
PHASES = ("qkv", "append+attention", "merge", "out_proj", "residual+ln1",
          "ffn1+gelu", "ffn2", "residual+ln2")
#: the phases whose weight rows are copied into shared memory ahead of
#: them, in the kernel's order; :func:`phase_times` also reports when the
#: last block's rows had landed
GEMV_PHASES = ("qkv", "out_proj", "ffn1+gelu", "ffn2")
#: the phases of the tensor-parallel attention phase kernel #13
ATTN_PHASES = ("qkv", "append+attention", "merge", "out_proj",
               "slice_sum")
#: the phases of the tensor-parallel FFN phase kernel #14 ("copies": until
#: the last block's FFN1 rows landed in shared memory)
FFN_PHASES = ("copies", "ffn1", "gelu", "ffn2", "slice_sum")

#: per-layer weights in the order the kernel's pointer table holds them
WEIGHT_ORDER = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
                "w1", "b1", "w2", "b2", "ln1g", "ln1b", "ln2g", "ln2b")

_P = ctypes.c_void_p
_I = ctypes.c_int


class WeightTable:
    """A layer group's weights and the ``(Lg, 16)`` int64 table of their
    addresses, in :data:`WEIGHT_ORDER`, through which the kernel reads
    them (the weight matrices by 16-byte bulk copies, so every weight must
    start 16-byte aligned).  It holds the layer dicts, so the addresses
    stay valid while it lives.  Build it once per weight set: the fused
    decode step builds one per group when it first sees a weight set.  It
    iterates as the list of layer dicts, which is what the plain version
    reads."""

    def __init__(self, layers, device):
        ptrs = []
        for lp in layers:
            for k in WEIGHT_ORDER:
                t = lp[k]
                if (t.dtype != torch.float32 or t.device != device
                        or not t.is_contiguous() or t.data_ptr() % 16):
                    raise ValueError("decode_layer_group: weight %r must be "
                                     "a contiguous, 16-byte aligned float32 "
                                     "tensor on %s" % (k, device))
                ptrs.append(t.data_ptr())
        self.layers = list(layers)
        self.ptrs = torch.tensor(ptrs, dtype=torch.int64, device=device)

    def __len__(self):
        return len(self.layers)

    def __iter__(self):
        return iter(self.layers)


def decode_layer_group_plain(x, kp, vp, layers, meta, page_tables, lengths,
                             cfg):
    """Plain version of :func:`decode_layer_group`: the same arguments, the
    same in-place page update, per-op PyTorch math in fp32."""
    B, C = x.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wp, ws = meta[0].long(), meta[1].long()
    lengths = lengths.reshape(B)
    x = x.float()
    for li, lp in enumerate(layers):
        q = F.linear(x, lp["wq"], lp["bq"]).reshape(B, H, D)
        k = F.linear(x, lp["wk"], lp["bk"]).reshape(B, KVH, D)
        v = F.linear(x, lp["wv"], lp["bv"]).reshape(B, KVH, D)
        kp[li][:, wp, ws, :] = k.transpose(0, 1)        # (KVH, B, D)
        vp[li][:, wp, ws, :] = v.transpose(0, 1)
        att = paged_attention_reference(q, kp[li], vp[li], lengths,
                                        page_tables)
        o = F.linear(att.reshape(B, C), lp["wo"], lp["bo"])
        x = F.layer_norm(x + o, (C,), lp["ln1g"], lp["ln1b"], 1e-5)
        h1 = bias_gelu_plain(F.linear(x, lp["w1"]), lp["b1"])
        f = F.linear(h1, lp["w2"], lp["b2"])
        x = F.layer_norm(x + f, (C,), lp["ln2g"], lp["ln2b"], 1e-5)
    return kp, vp, x


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library with its entry points typed (once)."""
    lib = _build.load("fused_decode")
    fn = lib.mxt_decode_layer_group
    fn.argtypes = [_P] * 9 + [_I] * 10 + [ctypes.c_float, _P]
    fn.restype = _I
    lib.mxt_decode_layer_group_scratch.argtypes = [_I] * 7
    lib.mxt_decode_layer_group_scratch.restype = ctypes.c_longlong
    lib.mxt_decode_layer_group_grid.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    lib.mxt_decode_layer_group_grid.restype = _I
    for fn in (lib.mxt_decode_layer_group_phases,
               lib.mxt_decode_layer_group_gemvs):
        fn.argtypes = []
        fn.restype = _I
    return lib


def grid_blocks(cfg):
    """Thread blocks the fused kernel launches with on the current card
    (all resident at once: occupancy per SM times the SM count)."""
    lib = _lib()
    n = _I(0)
    _build.check(lib, lib.mxt_decode_layer_group_grid(
        cfg.units, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        ctypes.byref(n)), "decode_layer_group grid")
    return n.value


def decode_layer_group(x, kp, vp, layers, meta, page_tables, lengths, cfg):
    """Run ``Lg`` decoder layers as ONE persistent kernel launch.

    x:           (B, C) fp32 activations entering the group
    kp/vp:       (Lg, KVH, P, S, D) this group's page pools, updated in
                 place (a view of the engine's pools)
    layers:      ``Lg`` per-layer weight dicts (keys of WEIGHT_ORDER), or
                 a :class:`WeightTable` of them (a list of dicts builds
                 one for this call)
    meta:        (2, B) int32 — rows: write page, write slot
    page_tables: (B, pages_per_seq) int32
    lengths:     (B,) or (B, 1) int32 valid context lengths (0 = inactive)
    cfg:         DecoderConfig (heads geometry)

    Returns (kp, vp, x_out); kp/vp are the tensors passed in.  A CPU
    tensor takes :func:`decode_layer_group_plain`; a CUDA tensor launches
    the kernel (counted in ``decode_layer_group.launches``) or raises (a
    head dim other than 32, 64 or 128 raises ``ValueError``).  An empty
    batch launches nothing."""
    if x.device.type == "cpu":
        return decode_layer_group_plain(x, kp, vp, layers, meta,
                                        page_tables, lengths, cfg)
    return _launch(x, kp, vp, layers, meta, page_tables, lengths, cfg, None)


def phase_times(x, kp, vp, layers, meta, page_tables, lengths, cfg):
    """One kernel launch on CUDA tensors (same arguments and in-place
    effects as :func:`decode_layer_group`) that also stamps the card's
    global timer.  Returns, per layer (lists of Lg values):

    - ``{phase: ns}`` over :data:`PHASES`: from block 0's exit of the
      barrier before the phase to its exit of the barrier after it;
    - ``{"<phase> arrived": ns}``: from that start until the last block
      reached the closing barrier (the rest of the phase is the barrier);
    - over :data:`GEMV_PHASES`, ``{"<phase> landed": ns}``: from the
      phase's start until the last block's weight rows were there (None
      where no block had its rows copied; a landing late in its phase
      means that the weight stream, not the math, set the phase), and
      ``{"<phase> streamed": units}`` whose rows were read from device
      memory instead."""
    Lg, n_p, n_g = kp.shape[0], len(PHASES), len(GEMV_PHASES)
    stamps = torch.zeros(1 + 2 * Lg * (n_p + n_g), dtype=torch.int64,
                         device=x.device)
    _launch(x, kp, vp, layers, meta, page_tables, lengths, cfg, stamps)
    st = stamps.cpu()
    ends = st[:1 + Lg * n_p]
    starts = ends[:-1].reshape(Lg, n_p)
    dur = torch.diff(ends).reshape(Lg, n_p)
    arrived = st[1 + Lg * n_p:1 + 2 * Lg * n_p].reshape(Lg, n_p) - starts
    landed = st[1 + 2 * Lg * n_p:1 + Lg * (2 * n_p + n_g)].reshape(Lg, n_g)
    streamed = st[1 + Lg * (2 * n_p + n_g):].reshape(Lg, n_g)
    out = {p: dur[:, i].tolist() for i, p in enumerate(PHASES)}
    out.update({p + " arrived": arrived[:, i].tolist()
                for i, p in enumerate(PHASES)})
    for j, p in enumerate(GEMV_PHASES):
        out[p + " landed"] = [
            int(t - s0) if t else None for t, s0 in zip(
                landed[:, j].tolist(), starts[:, PHASES.index(p)].tolist())]
        out[p + " streamed"] = streamed[:, j].tolist()
    return out


def _launch(x, kp, vp, layers, meta, page_tables, lengths, cfg, stamps):
    if x.device.type != "cuda":
        raise ValueError("decode_layer_group: unsupported device %s"
                         % x.device)
    dev = x.device
    B, C = x.shape
    Lg, KVH, P, S, D = kp.shape
    H = cfg.num_heads
    F = cfg.hidden_size
    pps = page_tables.shape[-1]
    lengths = lengths.reshape(B)
    if (len(layers) != Lg or vp.shape != kp.shape or KVH != cfg.num_kv_heads
            or D != cfg.head_dim or C != cfg.units or H % KVH
            or tuple(meta.shape) != (2, B)
            or tuple(page_tables.shape) != (B, pps)):
        raise ValueError("decode_layer_group: shapes do not match the "
                         "config (x %s, pages %s, %d layers)"
                         % (tuple(x.shape), tuple(kp.shape), len(layers)))
    if C % 4 or F % 4 or D not in (32, 64, 128):
        raise ValueError("decode_layer_group: units and hidden_size must be "
                         "multiples of 4 and the head dim 32, 64 or 128 (a "
                         "lane takes D / 32 columns), not %d" % D)
    for name, t, dt in (("x", x, torch.float32), ("kp", kp, torch.float32),
                        ("vp", vp, torch.float32), ("meta", meta, torch.int32),
                        ("page_tables", page_tables, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError("decode_layer_group: %s must be a contiguous "
                             "%s tensor on %s (got %s on %s)"
                             % (name, dt, dev, t.dtype, t.device))
    table = (layers if isinstance(layers, WeightTable)
             else WeightTable(layers, dev))
    if table.ptrs.device != dev:
        raise ValueError("decode_layer_group: the weight table lives on %s, "
                         "the activations on %s" % (table.ptrs.device, dev))
    lib = _lib()
    if stamps is not None and (
            lib.mxt_decode_layer_group_phases() != len(PHASES)
            or lib.mxt_decode_layer_group_gemvs() != len(GEMV_PHASES)):
        raise RuntimeError("decode_layer_group: the kernel stamps %d phases "
                           "and %d GEMVs, PHASES and GEMV_PHASES name %d, %d"
                           % (lib.mxt_decode_layer_group_phases(),
                              lib.mxt_decode_layer_group_gemvs(),
                              len(PHASES), len(GEMV_PHASES)))
    x_out = x.clone()
    if not B:     # no rows: no launch (a block must wait for its copies)
        return kp, vp, x_out
    scratch = torch.empty(lib.mxt_decode_layer_group_scratch(
        B, C, F, H, KVH, D, pps * S), dtype=torch.float32, device=dev)
    rc = lib.mxt_decode_layer_group(
        x_out.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.ptrs.data_ptr(),
        meta.data_ptr(), page_tables.data_ptr(), lengths.data_ptr(),
        scratch.data_ptr(), None if stamps is None else stamps.data_ptr(),
        B, C, F, H, KVH, D, P, S, pps, Lg, 1.0 / (D ** 0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "decode_layer_group")
    decode_layer_group.launches += 1
    return kp, vp, x_out


decode_layer_group.launches = 0


# ---------------------------------------------------------------------------
# tensor-parallel decode phases (kernels #13 and #14)
# ---------------------------------------------------------------------------
def decode_attn_phase_plain(x, kp, vp, lp, meta, page_tables, lengths, cfg):
    """Plain version of :func:`decode_attn_phase`: the same arguments, the
    same in-place page update, per-op PyTorch math in fp32."""
    B = x.shape[0]
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wp, ws = meta[0].long(), meta[1].long()
    x = x.float()
    q = F.linear(x, lp["wq"], lp["bq"]).reshape(B, H, D)
    k = F.linear(x, lp["wk"], lp["bk"]).reshape(B, KVH, D)
    v = F.linear(x, lp["wv"], lp["bv"]).reshape(B, KVH, D)
    kp[:, wp, ws, :] = k.transpose(0, 1)                # (KVH, B, D)
    vp[:, wp, ws, :] = v.transpose(0, 1)
    att = paged_attention_reference(q, kp, vp, lengths.reshape(B),
                                    page_tables)
    return kp, vp, F.linear(att.reshape(B, H * D), lp["wo"])


def decode_ffn_phase_plain(x, w1, b1, w2):
    """Plain version of :func:`decode_ffn_phase`, in fp32."""
    return F.linear(bias_gelu_plain(F.linear(x.float(), w1), b1), w2)


@functools.lru_cache(maxsize=None)
def _phase_lib():
    """The loaded ``decode_phase`` library with its entry points typed."""
    lib = _build.load("decode_phase")
    lib.mxt_decode_attn_phase.argtypes = ([_P] * 16 + [_I] * 8
                                          + [ctypes.c_float, _P])
    lib.mxt_decode_attn_phase.restype = _I
    lib.mxt_decode_ffn_phase.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    lib.mxt_decode_ffn_phase.restype = _I
    lib.mxt_decode_phase_scratch.argtypes = [_I] * 7
    lib.mxt_decode_phase_scratch.restype = ctypes.c_longlong
    lib.mxt_decode_phase_grid.argtypes = [_I, _I, ctypes.POINTER(_I),
                                          ctypes.POINTER(_I)]
    lib.mxt_decode_phase_grid.restype = _I
    for fn in (lib.mxt_decode_attn_phases, lib.mxt_decode_ffn_phases):
        fn.argtypes = []
        fn.restype = _I
    return lib


def phase_grid_blocks(cfg):
    """Thread blocks of the attention and the FFN phase kernels on the
    current card, for a shard's (local) config."""
    lib = _phase_lib()
    a, f = _I(0), _I(0)
    _build.check(lib, lib.mxt_decode_phase_grid(
        cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, ctypes.byref(a),
        ctypes.byref(f)), "decode phase grid")
    return a.value, f.value


def _phase_check(what, dev, tensors):
    """Each of ``(name, tensor, dtype, shape)`` must be a contiguous,
    16-byte aligned tensor of that dtype and shape on ``dev``."""
    for name, t, dt, shape in tensors:
        if (t.dtype != dt or t.device != dev or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape) or t.data_ptr() % 16):
            raise ValueError("%s: %s must be a contiguous, 16-byte aligned %s "
                             "tensor of shape %s on %s (got %s %s on %s)"
                             % (what, name, dt, tuple(shape), dev, t.dtype,
                                tuple(t.shape), t.device))


def decode_attn_phase(x, kp, vp, lp, meta, page_tables, lengths, cfg):
    """The attention half of one tensor-parallel shard of a decode layer,
    as ONE kernel launch.

    x:           (B, C) fp32 activations, C the FULL model width
    kp/vp:       (KVH_local, P, S, D) this layer's page slab of the shard
                 (a view of the engine's pools), updated in place
    lp:          the shard's layer weights: ``wq`` (H_local D, C), ``bq``,
                 ``wk``/``wv`` (KVH_local D, C), ``bk``/``bv`` and ``wo``'s
                 row shard (C, H_local D), contiguous
    meta:        (2, B) int32 -- rows: write page, write slot
    page_tables: (B, pages_per_seq) int32
    lengths:     (B,) or (B, 1) int32 valid context lengths (0 = inactive)
    cfg:         the shard's (local) DecoderConfig

    Returns (kp, vp, o_part): the pages passed in and the shard's
    out-projection partial product (B, C) fp32, with no bias.  A CPU tensor
    takes :func:`decode_attn_phase_plain`; a CUDA tensor launches kernel #13
    (counted in ``decode_attn_phase.launches``) or raises."""
    if x.device.type == "cpu":
        return decode_attn_phase_plain(x, kp, vp, lp, meta, page_tables,
                                       lengths, cfg)
    return _attn_launch(x, kp, vp, lp, meta, page_tables, lengths, cfg, None)


def decode_attn_phase_times(x, kp, vp, lp, meta, page_tables, lengths, cfg):
    """One launch of kernel #13 on CUDA tensors (same arguments and
    in-place effects as :func:`decode_attn_phase`) that also stamps the
    card's global timer at the end of every phase.  Returns ``{phase: ns}``
    in the kernel's order (:data:`ATTN_PHASES`)."""
    stamps = torch.zeros(len(ATTN_PHASES) + 1, dtype=torch.int64,
                         device=x.device)
    _attn_launch(x, kp, vp, lp, meta, page_tables, lengths, cfg, stamps)
    return dict(zip(ATTN_PHASES, torch.diff(stamps.cpu()).tolist()))


def _attn_launch(x, kp, vp, lp, meta, page_tables, lengths, cfg, stamps):
    if x.device.type != "cuda":
        raise ValueError("decode_attn_phase: unsupported device %s"
                         % x.device)
    dev = x.device
    B, C = x.shape
    KVH, P, S, D = kp.shape
    H = cfg.num_heads
    pps = page_tables.shape[-1]
    lengths = lengths.reshape(B)
    if (KVH != cfg.num_kv_heads or D != cfg.head_dim or H % KVH
            or C % 4 or D not in (32, 64, 128)):
        raise ValueError("decode_attn_phase: pages %s do not match the "
                         "shard's config (%d heads, %d KV heads, head dim "
                         "%d), or C is not a multiple of 4, or the head dim "
                         "not 32, 64 or 128 (a lane takes D / 32 columns)"
                         % (tuple(kp.shape), H, cfg.num_kv_heads,
                            cfg.head_dim))
    Cl, KVC = H * D, KVH * D
    f32, i32 = torch.float32, torch.int32
    _phase_check("decode_attn_phase", dev, [
        ("x", x, f32, (B, C)), ("kp", kp, f32, kp.shape),
        ("vp", vp, f32, kp.shape), ("wq", lp["wq"], f32, (Cl, C)),
        ("bq", lp["bq"], f32, (Cl,)), ("wk", lp["wk"], f32, (KVC, C)),
        ("bk", lp["bk"], f32, (KVC,)), ("wv", lp["wv"], f32, (KVC, C)),
        ("bv", lp["bv"], f32, (KVC,)), ("wo", lp["wo"], f32, (C, Cl)),
        ("meta", meta, i32, (2, B)), ("page_tables", page_tables, i32,
                                      (B, pps)),
        ("lengths", lengths, i32, (B,))])
    lib = _phase_lib()
    if stamps is not None and lib.mxt_decode_attn_phases() != len(
            ATTN_PHASES):
        raise RuntimeError("decode_attn_phase: the kernel stamps %d phases, "
                           "ATTN_PHASES names %d"
                           % (lib.mxt_decode_attn_phases(), len(ATTN_PHASES)))
    scratch = torch.empty(lib.mxt_decode_phase_scratch(0, B, C, Cl, KVC, D,
                                                       pps * S),
                          dtype=f32, device=dev)
    out = torch.empty(B, C, dtype=f32, device=dev)
    rc = lib.mxt_decode_attn_phase(
        x.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        *(lp[k].data_ptr() for k in ("wq", "bq", "wk", "bk", "wv", "bv",
                                     "wo")),
        meta.data_ptr(), page_tables.data_ptr(), lengths.data_ptr(),
        scratch.data_ptr(), out.data_ptr(),
        None if stamps is None else stamps.data_ptr(), B, C, H, KVH, D, P,
        S, pps, 1.0 / (D ** 0.5), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "decode_attn_phase")
    decode_attn_phase.launches += 1
    return kp, vp, out


decode_attn_phase.launches = 0


def decode_ffn_phase(x, w1, b1, w2):
    """The FFN half of one tensor-parallel shard of a decode layer, as ONE
    kernel launch: ``gelu_erf(x @ w1.T + b1) @ w2.T``, the partial product
    (B, C) fp32 with no bias.  x (B, C); w1 the column shard (F_local, C),
    b1 (F_local,); w2 the row shard (C, F_local), contiguous.  A CPU tensor
    takes :func:`decode_ffn_phase_plain`; a CUDA tensor launches kernel #14
    (counted in ``decode_ffn_phase.launches``) or raises."""
    if x.device.type == "cpu":
        return decode_ffn_phase_plain(x, w1, b1, w2)
    return _ffn_launch(x, w1, b1, w2, None)


def decode_ffn_phase_times(x, w1, b1, w2):
    """One launch of kernel #14 on CUDA tensors that also stamps the card's
    global timer at the end of every phase.  Returns ``{phase: ns}`` in the
    kernel's order (:data:`FFN_PHASES`)."""
    stamps = torch.zeros(len(FFN_PHASES) + 1, dtype=torch.int64,
                         device=x.device)
    _ffn_launch(x, w1, b1, w2, stamps)
    return dict(zip(FFN_PHASES, torch.diff(stamps.cpu()).tolist()))


def _ffn_launch(x, w1, b1, w2, stamps):
    if x.device.type != "cuda":
        raise ValueError("decode_ffn_phase: unsupported device %s" % x.device)
    dev = x.device
    B, C = x.shape
    Fl = w1.shape[0]
    if C % 4 or Fl % 4:
        raise ValueError("decode_ffn_phase: C %d and the shard's FFN width %d "
                         "must be multiples of 4" % (C, Fl))
    f32 = torch.float32
    _phase_check("decode_ffn_phase", dev, [
        ("x", x, f32, (B, C)), ("w1", w1, f32, (Fl, C)),
        ("b1", b1, f32, (Fl,)), ("w2", w2, f32, (C, Fl))])
    lib = _phase_lib()
    if stamps is not None and lib.mxt_decode_ffn_phases() != len(FFN_PHASES):
        raise RuntimeError("decode_ffn_phase: the kernel stamps %d phases, "
                           "FFN_PHASES names %d"
                           % (lib.mxt_decode_ffn_phases(), len(FFN_PHASES)))
    scratch = torch.empty(lib.mxt_decode_phase_scratch(1, B, C, Fl, 0, 0,
                                                       0),
                          dtype=f32, device=dev)
    out = torch.empty(B, C, dtype=f32, device=dev)
    if not B:     # no rows: no launch (a block must wait for its copies)
        return out
    rc = lib.mxt_decode_ffn_phase(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        scratch.data_ptr(), out.data_ptr(),
        None if stamps is None else stamps.data_ptr(), B, C, Fl,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "decode_ffn_phase")
    decode_ffn_phase.launches += 1
    return out


decode_ffn_phase.launches = 0


# ---------------------------------------------------------------------------
# persistent LSTM time loop (kernels #10 and #11)
# ---------------------------------------------------------------------------
_LSTM_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lstm_gates(g):
    """i, f, u, o of the (B, 4H) fp32 pre-activations, MXNet gate order."""
    i, f, u, o = g.chunk(4, dim=-1)
    return (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(u),
            torch.sigmoid(o))


def lstm_sequence_plain(gates_x, h0, c0, w_h2h_t, b_h2h):
    """Plain version of the forward kernel: a Python loop over t in fp32.

    gates_x (T, B, 4H); h0, c0 (B, H); w_h2h_t (H, 4H); b_h2h (4H,).
    Returns (out (T, B, H) in gates_x's dtype, cseq (T, B, H) fp32), the
    h carry kept in fp32 as the kernel keeps it.  Differentiable by
    autograd."""
    w, b = w_h2h_t.float(), b_h2h.float()
    h, c = h0.float(), c0.float()
    outs, cs = [], []
    for t in range(gates_x.shape[0]):
        i, f, u, o = _lstm_gates(gates_x[t].float() + h @ w + b)
        c = f * c + i * u
        h = o * torch.tanh(c)
        outs.append(h.to(gates_x.dtype))
        cs.append(c)
    return torch.stack(outs), torch.stack(cs)


def lstm_sequence_backward_plain(gates_x, h_prev, c_prev, cseq, dout, dcseq,
                                 w_h2h_t, b_h2h):
    """Plain version of the backward kernel: the time-reversed loop in fp32.

    h_prev (T, B, H) in gates_x's dtype and c_prev (T, B, H) fp32 are the
    carries entering each step; cseq, dcseq fp32; dout in gates_x's dtype.
    Returns (dgx (T, B, 4H), dh0, dc0 (B, H)), all in gates_x's dtype."""
    w, b = w_h2h_t.float(), b_h2h.float()
    T, B, _ = gates_x.shape
    H = w.shape[0]
    dh = torch.zeros(B, H, dtype=torch.float32, device=gates_x.device)
    dc = torch.zeros_like(dh)
    dgx = torch.empty_like(gates_x)
    for t in range(T - 1, -1, -1):
        cp = c_prev[t].float()
        i, f, u, o = _lstm_gates(gates_x[t].float() + h_prev[t].float() @ w
                                 + b)
        dh = dh + dout[t].float()
        tc = torch.tanh(cseq[t].float())
        d_o = dh * tc
        dc = dc + dcseq[t].float() + dh * o * (1 - tc * tc)
        dg = torch.cat([(dc * u) * i * (1 - i), (dc * cp) * f * (1 - f),
                        (dc * i) * (1 - u * u), d_o * o * (1 - o)], dim=-1)
        dgx[t] = dg.to(gates_x.dtype)
        dh = dg @ w.T
        dc = dc * f
    return dgx, dh.to(gates_x.dtype), dc.to(gates_x.dtype)


@functools.lru_cache(maxsize=None)
def _lstm_lib():
    """The loaded ``lstm`` library with its entry points typed (once)."""
    lib = _build.load("lstm")
    L = ctypes.c_longlong
    lib.mxt_lstm_plan.argtypes = [_I] * 3 + [ctypes.POINTER(_I)] * 2 + [
        ctypes.POINTER(L)]
    lib.mxt_lstm_plan.restype = _I
    lib.mxt_lstm_fwd_fits.argtypes = [_I] * 5 + [ctypes.POINTER(_I),
                                                 ctypes.POINTER(L)]
    lib.mxt_lstm_fwd_fits.restype = _I
    lib.mxt_lstm_fwd.argtypes = ([_P] * 3 + [L, L, _I, _P, _I] + [_P] * 5
                                 + [_I] * 6 + [_P])
    lib.mxt_lstm_fwd.restype = _I
    lib.mxt_lstm_bwd_gates.argtypes = ([_P, _P, L] + [_I] * 3 + [_P] * 2
                                       + [_I] + [_P] * 6 + [_I] * 5 + [_P])
    lib.mxt_lstm_bwd_gates.restype = _I
    lib.mxt_lstm_bwd.argtypes = ([_P] * 2 + [L, L, _I] + [_P] * 6
                                 + [_I] * 4 + [_P])
    lib.mxt_lstm_bwd.restype = _I
    return lib


#: a time loop's launch: units per block, blocks, dynamic shared memory
#: in bytes and (the forward) batch lanes, independent groups of blocks
#: that each take every lanes-th group of 16 batch rows
LstmPlan = collections.namedtuple("LstmPlan", "units blocks smem lanes")


@functools.lru_cache(maxsize=None)
def _lstm_fwd_fits(device, code, H, B, units, lanes):
    lib = _lstm_lib()
    grid, smem = _I(0), ctypes.c_longlong(0)
    _build.check(lib, lib.mxt_lstm_fwd_fits(code, H, B, units, lanes,
                                            ctypes.byref(grid),
                                            ctypes.byref(smem)), "lstm_plan")
    return (LstmPlan(units, grid.value, smem.value, lanes) if grid.value
            else None)


def lstm_plan(H, B, dtype=torch.float32, backward=False, units=None,
              lanes=None):
    """The launch on the current card, an :class:`LstmPlan`.  The
    backward takes the fewest units per block (at most 8) whose grid of
    ceil(H / U) blocks is resident at once (a cooperative launch needs
    every block resident; there is no fallback).  The forward takes two
    batch lanes when B has two groups of 16 rows or more, else one, and
    the fewest units per block (at most 10) whose ceil(H / U) lanes
    blocks are resident at once, one lane if two do not fit; or the
    ``units`` and ``lanes`` given, if they fit.  Raises when nothing
    fits."""
    lib = _lstm_lib()
    code = _LSTM_DTYPES[dtype]
    if backward:
        u, grid, smem = _I(0), _I(0), ctypes.c_longlong(0)
        _build.check(lib, lib.mxt_lstm_plan(code, H, B, ctypes.byref(u),
                                            ctypes.byref(grid),
                                            ctypes.byref(smem)), "lstm_plan")
        plan = (LstmPlan(u.value, grid.value, smem.value, 1) if u.value
                else None)
    else:
        dev = torch.cuda.current_device()
        if units:
            tried = [(units, lanes or 1)]
        else:
            tried = [(u, n) for n in ((2, 1) if B > 16 else (1,))
                     for u in range(max(1, -(-H * n // _sms(dev))), 11)]
        plan = next((p for p in (_lstm_fwd_fits(dev, code, H, B, u, n)
                                 for u, n in tried) if p), None)
    if plan is None:
        raise RuntimeError(
            "lstm_sequence: H %d, B %d does not fit the card: no grid of "
            "ceil(H / U) blocks with U <= 8 units each (10 forward) is "
            "resident at once within the shared memory a block may use"
            % (H, B))
    return plan


def _lstm_check(what, gates_x, vectors, w, b):
    """Device, dtype, shape and layout checks of a CUDA launch."""
    dev = gates_x.device
    if gates_x.dtype not in _LSTM_DTYPES:
        raise TypeError("%s: unsupported dtype %s (float32 or bfloat16)"
                        % (what, gates_x.dtype))
    T, B, G = gates_x.shape
    H = G // 4
    if G != 4 * H or T < 1 or tuple(w.shape) != (H, G) or tuple(
            b.shape) != (G,):
        raise ValueError("%s: shapes do not match: gates_x %s, w_h2h_t %s, "
                         "b_h2h %s" % (what, tuple(gates_x.shape),
                                       tuple(w.shape), tuple(b.shape)))
    for name, t, dt, shape in vectors:
        if (t.dtype != dt or t.device != dev or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError("%s: %s must be a contiguous %s tensor of shape "
                             "%s on %s (got %s %s on %s)"
                             % (what, name, dt, shape, dev, t.dtype,
                                tuple(t.shape), t.device))
    for name, t in (("w_h2h_t", w), ("b_h2h", b)):
        if t.dtype not in _LSTM_DTYPES or t.device != dev:
            raise ValueError("%s: %s must be float32 or bfloat16 on %s"
                             % (what, name, dev))
    if not gates_x.is_contiguous() or not b.is_contiguous():
        raise ValueError("%s: gates_x and b_h2h must be contiguous" % what)
    return T, B, H


def _lstm_fwd(gates_x, h0, c0, w, b, stamps=None, plan=None):
    if gates_x.device.type == "cpu":
        return lstm_sequence_plain(gates_x, h0, c0, w, b)
    if gates_x.device.type != "cuda":
        raise ValueError("lstm_sequence: unsupported device %s"
                         % gates_x.device)
    T, B, H = gates_x.shape[0], gates_x.shape[1], gates_x.shape[2] // 4
    dt = gates_x.dtype
    _lstm_check("lstm_sequence", gates_x,
                (("h0", h0, dt, (B, H)), ("c0", c0, dt, (B, H))), w, b)
    p = plan or lstm_plan(H, B, dt)
    dev = gates_x.device
    out = torch.empty(T, B, H, dtype=dt, device=dev)
    cseq = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    # the kernel keeps h transposed, (H, Bp) in fp32 with B padded to 16
    # columns (those past B only ever reach product rows that no store
    # reads); h0 enters as hbuf[1]
    hbuf = torch.empty(2, H, -(-B // 16) * 16, dtype=torch.float32,
                       device=dev)
    hbuf[1, :, :B].copy_(h0.T)
    flags = torch.empty(p.blocks * 32, dtype=torch.int32, device=dev)
    lib = _lstm_lib()
    rc = lib.mxt_lstm_fwd(
        gates_x.data_ptr(), c0.data_ptr(), w.data_ptr(),
        w.stride(0), w.stride(1), _LSTM_DTYPES[w.dtype], b.data_ptr(),
        _LSTM_DTYPES[b.dtype], out.data_ptr(), cseq.data_ptr(),
        hbuf.data_ptr(), flags.data_ptr(),
        None if stamps is None else stamps.data_ptr(), T, B, H,
        _LSTM_DTYPES[dt], p.units, p.lanes,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "lstm_sequence")
    lstm_sequence.launches_fwd += 1
    lstm_sequence.last_dtype = dt
    return out, cseq


#: the phases of one step of the forward time loop, in the order the
#: kernel stamps their ends (:func:`lstm_fwd_phase_times`): the wait
#: (block 0's warp 0 polling the flags of the blocks that own its slice
#: of h: the step's grid-wide sync), warp 0's copy of that slice, the
#: gate products and the elementwise update (out, cseq and the block's
#: slice of the next h written, its flag released)
LSTM_FWD_PHASES = ("barrier", "stage", "products", "elementwise")


def lstm_fwd_phase_times(gates_x, h0, c0, w, b, plan=None):
    """The forward on CUDA tensors (the arguments of ``_lstm_fwd``), its
    block 0 stamping the card's global timer at its entry, at the end of
    its set-up's W columns and of the whole set-up, and at the end of
    every phase of every step.  Returns ``(total, per_step)``: µs per
    phase of :data:`LSTM_FWD_PHASES` summed over the steps, with the
    set-up's ``"w_columns"`` and ``"setup"`` (the whole), and the list of
    µs per step of each phase."""
    T = gates_x.shape[0]
    n = len(LSTM_FWD_PHASES)
    stamps = torch.zeros(3 + n * T, dtype=torch.int64,
                         device=gates_x.device)
    _lstm_fwd(gates_x, h0, c0, w, b, stamps, plan)
    d = torch.diff(stamps.cpu()).double() / 1e3
    per_step = {p: d[2:].reshape(T, n)[:, i].tolist()
                for i, p in enumerate(LSTM_FWD_PHASES)}
    total = {p: sum(v) for p, v in per_step.items()}
    total.update(w_columns=float(d[0]), setup=float(d[0] + d[1]))
    return total, per_step


def _lstm_bwd(gates_x, h_prev, c_prev, cseq, dout, dcseq, w, b):
    if gates_x.device.type == "cpu":
        return lstm_sequence_backward_plain(gates_x, h_prev, c_prev, cseq,
                                            dout, dcseq, w, b)
    gates, loop, outs, _ = _lstm_bwd_parts(gates_x, h_prev, c_prev, cseq,
                                           dout, dcseq, w, b)
    gates()
    loop()
    return outs


#: the phases of one step of the backward time loop, in the order the
#: kernel stamps their ends (:func:`lstm_bwd_phase_times`): the sum of the
#: partial dh of the last step, the elementwise update, the partial
#: products (written out) and the grid barrier
LSTM_BWD_PHASES = ("dh_sum", "elementwise", "dh_products", "barrier")
#: the recompute kernel's phases, stamped by its first block
#: (:func:`lstm_bwd_phase_times`)
LSTM_GATES_PHASES = ("products", "inputs", "activations", "step_inputs")


def lstm_bwd_phase_times(gates_x, h_prev, c_prev, cseq, dout, dcseq, w, b):
    """The backward on CUDA tensors (the arguments of ``_lstm_bwd``), both
    kernels stamping the card's global timer: the recompute's first block
    at the end of each of its phases, the time loop's at the end of every
    phase of every step.  Returns ``(total, per_step)``: µs per phase of
    :data:`LSTM_GATES_PHASES` and of :data:`LSTM_BWD_PHASES`, the latter
    summed over the steps, and for the latter the list of µs per step of
    each, in the order the steps run (t = T-1 first)."""
    T = gates_x.shape[0]
    n = len(LSTM_BWD_PHASES)
    dev = gates_x.device
    gstamps = torch.zeros(1 + len(LSTM_GATES_PHASES), dtype=torch.int64,
                          device=dev)
    stamps = torch.zeros(1 + n * T, dtype=torch.int64, device=dev)
    gates, loop, _, _ = _lstm_bwd_parts(gates_x, h_prev, c_prev, cseq, dout,
                                        dcseq, w, b)
    gates(gstamps)
    loop(stamps)
    d = torch.diff(stamps.cpu()).double().reshape(T, n) / 1e3
    per_step = {p: d[:, i].tolist() for i, p in enumerate(LSTM_BWD_PHASES)}
    total = dict(zip(LSTM_GATES_PHASES,
                     (torch.diff(gstamps.cpu()).double() / 1e3).tolist()))
    total.update({p: sum(v) for p, v in per_step.items()})
    return total, per_step


def lstm_bwd_gates_plain(gates_x, h_prev, w_h2h_t, b_h2h):
    """Plain version of the backward's gate recompute: the activations
    (T, B, 4H) fp32, i, f, u, o = sigmoid, sigmoid, tanh, sigmoid of
    gates_x + h_prev W + b, in fp32."""
    T, B, G = gates_x.shape
    g = (gates_x.float() + (h_prev.float().reshape(T * B, -1)
                            @ w_h2h_t.float()).reshape(T, B, G)
         + b_h2h.float())
    return torch.cat(_lstm_gates(g), dim=-1)


def lstm_record_gates(rec, T, B, H, units):
    """The activations (T, B, 4H) held in the step records the recompute
    kernel writes, ``(T, 8, nb units, B)`` fp32 (nb = ceil(H / units)
    blocks) with fields i, f, u, o, tanh(cseq), c_prev, dout, dcseq (units
    past H dropped)."""
    nb = -(-H // units)
    r = rec.reshape(T, 8, nb * units, B)[:, :4, :H]       # (T, 4, H, B)
    return r.permute(0, 3, 1, 2).reshape(T, B, 4 * H)


def _lstm_bwd_parts(gates_x, h_prev, c_prev, cseq, dout, dcseq, w, b):
    """The backward's two kernels on CUDA tensors, as ``(gates, loop,
    (dgx, dh0, dc0), (rec, units))``: ``gates(stamps=None)`` launches the
    recompute of the gate activations into the step records ``rec``
    (:func:`lstm_record_gates` reads them), ``loop(stamps=None)`` the
    time loop over them into dgx, dh0 and dc0, each counting its launch;
    ``units`` per block is the time loop's plan."""
    if gates_x.device.type != "cuda":
        raise ValueError("lstm_sequence: unsupported device %s"
                         % gates_x.device)
    T, B, H = gates_x.shape[0], gates_x.shape[1], gates_x.shape[2] // 4
    dt, f32 = gates_x.dtype, torch.float32
    seq = (T, B, H)
    _lstm_check("lstm_sequence (backward)", gates_x,
                (("h_prev", h_prev, dt, seq), ("c_prev", c_prev, f32, seq),
                 ("cseq", cseq, f32, seq), ("dout", dout, dt, seq),
                 ("dcseq", dcseq, f32, seq)), w, b)
    units, nb = lstm_plan(H, B, dt, backward=True)[:2]
    dev = gates_x.device
    bup = -(-B * units // 4) * 4
    dgx = torch.empty_like(gates_x)
    dh0 = torch.empty(B, H, dtype=dt, device=dev)
    dc0 = torch.empty(B, H, dtype=dt, device=dev)
    # each step's inputs by unit and batch row, as the time loop reads them
    rec = torch.empty(T * 8 * nb * units * B, dtype=f32, device=dev)
    # the partial dh sums, double-buffered, and the barrier's flags
    part = torch.empty(2 * nb * nb * bup, dtype=f32, device=dev)
    flags = torch.empty(nb * 32, dtype=torch.int32, device=dev)
    lib = _lstm_lib()
    code = _LSTM_DTYPES[dt]
    # the recompute's operands as its 4-byte copies take them: W with K
    # along memory (w_h2h's rows), both bf16 (in pairs: H and the row
    # stride even) or both fp32 (a bf16 one cast; it stays exact in tf32)
    a_exact, w_exact = dt == torch.bfloat16, w.dtype == torch.bfloat16
    wg = w if w.stride(0) == 1 else w.t().contiguous().t()
    tiles = int(a_exact and w_exact and H % 2 == 0 and wg.stride(1) % 2 == 0
                and wg.data_ptr() % 4 == 0)
    hg = h_prev
    if not tiles:
        hg = h_prev.float()
        wg = wg.float()
        if wg.stride(0) != 1:
            wg = wg.t().contiguous().t()

    def gates(stamps=None):
        rc = lib.mxt_lstm_bwd_gates(
            hg.data_ptr(), wg.data_ptr(), wg.stride(1), tiles, int(a_exact),
            int(w_exact), gates_x.data_ptr(), b.data_ptr(),
            _LSTM_DTYPES[b.dtype], cseq.data_ptr(), c_prev.data_ptr(),
            dout.data_ptr(), dcseq.data_ptr(), rec.data_ptr(),
            None if stamps is None else stamps.data_ptr(), T, B, H, units,
            code, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "lstm_sequence (backward gates)")
        lstm_sequence.launches_bwd_gates += 1

    def loop(stamps=None):
        rc = lib.mxt_lstm_bwd(
            rec.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
            _LSTM_DTYPES[w.dtype], dgx.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), part.data_ptr(), flags.data_ptr(),
            None if stamps is None else stamps.data_ptr(), T, B, H, code,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "lstm_sequence (backward)")
        lstm_sequence.launches_bwd += 1
        lstm_sequence.last_dtype = dt

    return gates, loop, (dgx, dh0, dc0), (rec, units)


class _LSTMSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates_x, h0, c0, w, b):
        out, cseq = _lstm_fwd(gates_x, h0, c0, w, b)
        # the residuals of the JAX custom_vjp: the inputs and the two
        # carry sequences (out IS the h sequence); no per-gate activation
        ctx.save_for_backward(gates_x, h0, c0, w, b, out, cseq)
        return out, cseq

    @staticmethod
    def backward(ctx, dout, dcseq):
        gates_x, h0, c0, w, b, out, cseq = ctx.saved_tensors
        cdt = gates_x.dtype
        # the carries entering each step; in bf16 the backward recomputes
        # the gates from the bf16-rounded h, as the JAX backward does
        h_prev = torch.cat([h0[None].to(cdt), out[:-1]])
        c_prev = torch.cat([c0[None].float(), cseq[:-1]])
        dgx, dh0, dc0 = _lstm_bwd(gates_x, h_prev, c_prev, cseq,
                                  dout.to(cdt).contiguous(),
                                  dcseq.float().contiguous(), w, b)
        # weight and bias gradients contract outside the kernel, in fp32
        dgx32 = dgx.float()
        dw = torch.einsum("tbh,tbg->hg", h_prev.float(), dgx32).to(w.dtype)
        db = dgx32.sum(dim=(0, 1)).to(b.dtype)
        return dgx, dh0.to(h0.dtype), dc0.to(c0.dtype), dw, db


def lstm_sequence(gates_x, h0, c0, w_h2h_t, b_h2h):
    """The whole LSTM time loop of one layer, differentiable.

    gates_x: (T, B, 4H) input projections with the i2h bias added
    h0, c0:  (B, H) initial carries, cast to gates_x's dtype
    w_h2h_t: (H, 4H) the recurrent weight, transposed (any strides)
    b_h2h:   (4H,)

    Returns ``(out (T, B, H), hT, cT)`` in gates_x's dtype; cT is cast
    from the fp32 c sequence.  A CPU tensor takes the plain versions; a
    CUDA tensor launches kernel #10 (``lstm_sequence.launches_fwd``) and,
    under autograd, #11 in the backward: the gate recompute
    (``.launches_bwd_gates``) and the time loop (``.launches_bwd``); or
    raises."""
    cdt = gates_x.dtype
    h0, c0 = h0.to(cdt), c0.to(cdt)
    args = (gates_x.contiguous(), h0.contiguous(), c0.contiguous(), w_h2h_t,
            b_h2h.contiguous())
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out, cseq = _LSTMSequence.apply(*args)
    else:
        out, cseq = _lstm_fwd(*args)
    return out, out[-1], cseq[-1].to(cdt)


lstm_sequence.launches_fwd = 0
lstm_sequence.launches_bwd = 0
lstm_sequence.launches_bwd_gates = 0
lstm_sequence.last_dtype = None
