"""Persistent fused decode kernel: one launch per decoder layer group.

The port of ``decode_layer_group`` from
``mxnet_tpu/ops/pallas/fused_cell.py`` (the LSTM and tensor-parallel phase
kernels of that module are not ported yet).  For every layer of the
group, for the whole decode batch, one kernel launch runs: the qkv
projections, the KV append into the paged cache, paged attention, the
out-projection with residual and post-LN, and the FFN with erf GELU,
residual and post-LN.

A CUDA tensor launches the cooperative kernel ``csrc/fused_decode.cu``,
whose note says what bounds it on the card and how its design answers;
a CPU tensor runs :func:`decode_layer_group_plain`, the same math in
plain PyTorch.  The page pools are updated in place in both, which
replaces the JAX kernel's ``input_output_aliases`` and the engine's
buffer donation.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .epilogue import bias_gelu_plain
from .paged_attention import paged_attention_reference

__all__ = ["decode_layer_group", "decode_layer_group_plain", "WeightTable",
           "WEIGHT_ORDER", "PHASES", "grid_blocks", "phase_times"]

#: the kernel's phases per layer, separated by grid-wide barriers
PHASES = ("qkv", "append+attention", "out_proj", "residual+ln1",
          "ffn1+gelu", "ffn2", "residual+ln2")

#: per-layer weights in the order the kernel's pointer table holds them
WEIGHT_ORDER = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
                "w1", "b1", "w2", "b2", "ln1g", "ln1b", "ln2g", "ln2b")

_P = ctypes.c_void_p
_I = ctypes.c_int


class WeightTable:
    """A layer group's weights and the ``(Lg, 16)`` int64 table of their
    addresses, in :data:`WEIGHT_ORDER`, through which the kernel reads
    them.  It holds the layer dicts, so the addresses stay valid while it
    lives.  Build it once per weight set: the fused decode step builds
    one per group when it first sees a weight set.  It iterates as the
    list of layer dicts, which is what the plain version reads."""

    def __init__(self, layers, device):
        ptrs = []
        for lp in layers:
            for k in WEIGHT_ORDER:
                t = lp[k]
                if (t.dtype != torch.float32 or t.device != device
                        or not t.is_contiguous()):
                    raise ValueError("decode_layer_group: weight %r must be "
                                     "a contiguous float32 tensor on %s"
                                     % (k, device))
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
    lib.mxt_decode_layer_group_scratch.argtypes = [_I] * 5
    lib.mxt_decode_layer_group_scratch.restype = ctypes.c_longlong
    lib.mxt_decode_layer_group_grid.argtypes = [_I, _I, _I,
                                                ctypes.POINTER(_I)]
    lib.mxt_decode_layer_group_grid.restype = _I
    return lib


def grid_blocks(cfg):
    """Thread blocks the fused kernel launches with on the current card
    (all resident at once: occupancy per SM times the SM count)."""
    lib = _lib()
    n = _I(0)
    _build.check(lib, lib.mxt_decode_layer_group_grid(
        cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, ctypes.byref(n)),
        "decode_layer_group grid")
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
    the kernel (counted in ``decode_layer_group.launches``)."""
    if x.device.type == "cpu":
        return decode_layer_group_plain(x, kp, vp, layers, meta,
                                        page_tables, lengths, cfg)
    return _launch(x, kp, vp, layers, meta, page_tables, lengths, cfg, None)


def phase_times(x, kp, vp, layers, meta, page_tables, lengths, cfg):
    """One kernel launch on CUDA tensors (same arguments and in-place
    effects as :func:`decode_layer_group`) that also stamps the card's
    global timer at the end of every phase.  Returns ``{phase: [ns per
    layer]}`` over :data:`PHASES`."""
    Lg = kp.shape[0]
    stamps = torch.zeros(Lg * len(PHASES) + 1, dtype=torch.int64,
                         device=x.device)
    _launch(x, kp, vp, layers, meta, page_tables, lengths, cfg, stamps)
    d = torch.diff(stamps.cpu()).reshape(Lg, len(PHASES))
    return {p: d[:, i].tolist() for i, p in enumerate(PHASES)}


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
    if C % 4 or F % 4 or D % 4 or C > 8128:
        raise ValueError("decode_layer_group: units, hidden_size and "
                         "head_dim must be multiples of 4, and units at "
                         "most 8128")
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
    x_out = x.clone()
    scratch = torch.empty(lib.mxt_decode_layer_group_scratch(B, C, F, KVH, D),
                          dtype=torch.float32, device=dev)
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
