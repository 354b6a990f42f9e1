"""Paged attention for autoregressive decode over a page-granular KV cache.

The port of ``mxnet_tpu/ops/pallas/paged_attention.py`` (fp pages).  The
cache is a pool of fixed-size pages (``k_pages``/``v_pages``:
``(num_kv_heads, total_pages, page_size, head_dim)``); each sequence owns
a page-table row, and attention reads through the table.

- :func:`paged_attention` — one query token per sequence.  A CUDA tensor
  launches the hand-written kernel ``csrc/paged_attention.cu`` (split-key
  units over each row's keys, merged in chunk order; its design note is
  there); a CPU tensor runs :func:`paged_attention_reference`.  There is
  no fallback: a CUDA call launches the kernel or raises.
- :func:`paged_attention_reference` — the plain version: gather the
  sequence's pages into a contiguous cache (:func:`gather_pages`), then
  masked fp32 softmax (:func:`attend_ctx`).  Length-0 rows give zeros.
- :func:`copy_page` — duplicate one physical page, in place.
- :class:`QPages` — int8 pages: codes ``q`` in the fp layout and one fp32
  scale per (KV head, page) in ``s``; :func:`paged_attention` on QPages
  launches the int8-page variant of the kernel (counted in
  ``paged_attention.launches_int8``), whose plain version is
  :func:`gather_pages_deq` + :func:`attend_ctx`.

The kernel replaces the upstream TPU Pallas kernel
``jax.experimental.pallas.ops.tpu.paged_attention`` that the JAX package
calls at ``mxnet_tpu/ops/pallas/paged_attention.py:251``; its int8 variant
replaces the XLA dequant-gather path of that module (``:237-247``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_reference", "gather_pages",
           "gather_pages_deq", "attend_ctx", "copy_page", "QPages",
           "kv_heads", "paged_attention_times", "PAGED_PHASES"]

_P = ctypes.c_void_p
_I = ctypes.c_int

#: the kernel's phases: the split units, then the merge in chunk order
PAGED_PHASES = ("units", "merge")


class QPages(NamedTuple):
    """int8 KV page pool + parallel per-(page, head) scales pool.

    ``q``: int8 codes in the fp page layout, ``(KVH, P, S, D)`` per layer
    or ``(L, KVH, P, S, D)`` stacked.  ``s``: f32 scales, one per (KV
    head, page), ``(KVH, P)`` / ``(L, KVH, P)``; ``token ≈ q * s`` for
    every token in the page.  A page's scale is latched by the write at
    page slot 0 (``amax(token) / 127``); later writes into the page reuse
    it (``models.decoder._kv_append``)."""
    q: torch.Tensor
    s: torch.Tensor


def kv_heads(pages, li, lo=0, hi=None):
    """Layer ``li``'s pages of KV heads ``lo:hi`` (all by default) from an
    engine pool ``(L, KVH, P, S, D)``, or from :class:`QPages` of that
    layout (codes ``(hi - lo, P, S, D)`` and scales ``(hi - lo, P)``): a
    contiguous view, which :func:`paged_attention` reads and
    ``models.decoder._kv_write`` writes in place, with no copy.  A
    tensor-parallel shard's slab is its KV heads (``decoder.TPPlan.
    kv_view``)."""
    if isinstance(pages, QPages):
        return QPages(q=pages.q[li, lo:hi], s=pages.s[li, lo:hi])
    return pages[li, lo:hi]


def gather_pages(pages, page_indices):
    """Gather per-sequence pages into contiguous per-sequence caches.

    pages: (KVH, P, S, D); page_indices: (B, pages_per_seq) int
    -> (B, KVH, pages_per_seq * S, D), token-major per sequence.  Page
    tables may alias (the scratch page in many rows); each reference is
    read independently."""
    kvh, _, s, d = pages.shape
    b, pps = page_indices.shape
    g = pages[:, page_indices.long()]                 # (KVH, B, pps, S, D)
    return g.transpose(0, 1).reshape(b, kvh, pps * s, d)


def gather_pages_deq(codes, scales, page_indices):
    """Gather + dequantize int8 pages into contiguous fp32 caches.

    codes: (KVH, P, S, D) int8; scales: (KVH, P) f32; page_indices:
    (B, pages_per_seq) int -> (B, KVH, pages_per_seq * S, D) f32, the
    layout of :func:`gather_pages`, each page's tokens times its scale."""
    kvh, _, s, d = codes.shape
    b, pps = page_indices.shape
    idx = page_indices.long()
    g = codes[:, idx].transpose(0, 1)                  # (B, KVH, pps, S, D)
    sg = scales[:, idx].transpose(0, 1)                # (B, KVH, pps)
    ctx = g.to(torch.float32) * sg[..., None, None]
    return ctx.reshape(b, kvh, pps * s, d)


def copy_page(pages, src, dst):
    """``pages[..., dst, :, :] <- pages[..., src, :, :]``, in place, on any
    layout whose page axis is third from last (the kernel layout
    ``(KVH, P, S, D)`` and the engine's ``(L, KVH, P, S, D)``).  On
    :class:`QPages` the codes page and its scale entry (page axis last in
    the scales pool) are both copied.  Returns ``pages``.  The JAX package
    returns an updated copy instead."""
    if isinstance(pages, QPages):
        pages.q[..., dst, :, :] = pages.q[..., src, :, :]
        pages.s[..., dst] = pages.s[..., src]
        return pages
    pages[..., dst, :, :] = pages[..., src, :, :]
    return pages


def attend_ctx(q, k_ctx, v_ctx, lengths, scale):
    """Masked decode attention over contiguous per-sequence caches.

    q: (B, H, D); k_ctx/v_ctx: (B, KVH, C, D); lengths: (B,) valid keys.
    fp32 softmax, GQA by head grouping (head h reads KV head h // g)."""
    b, h, d = q.shape
    kvh, c = k_ctx.shape[1], k_ctx.shape[2]
    g = h // kvh
    qf = (q.float() * scale).reshape(b, kvh, g, d)
    logits = torch.einsum("bkgd,bkcd->bkgc", qf, k_ctx.float())
    mask = (torch.arange(c, device=q.device)[None, None, None, :]
            < lengths.reshape(b, 1, 1, 1))
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # length-0 rows (inactive slots)
    out = torch.einsum("bkgc,bkcd->bkgd", p, v_ctx.float())
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices,
                              scale=None):
    """Gather-based plain version: pages -> contiguous view -> masked fp32
    softmax.  Correct for any GQA grouping and for length-0 rows.  On
    :class:`QPages` the gather dequantizes (:func:`gather_pages_deq`)."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if isinstance(k_pages, QPages):
        k_ctx = gather_pages_deq(k_pages.q, k_pages.s, page_indices)
        v_ctx = gather_pages_deq(v_pages.q, v_pages.s, page_indices)
    else:
        k_ctx = gather_pages(k_pages, page_indices)
        v_ctx = gather_pages(v_pages, page_indices)
    return attend_ctx(q, k_ctx, v_ctx, lengths, scale)


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library with its entry points typed (once)."""
    lib = _build.load("paged_attention")
    fn = lib.mxt_paged_attention
    fn.argtypes = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    fn = lib.mxt_paged_attention_i8
    fn.argtypes = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    lib.mxt_paged_attention_phases.argtypes = []
    lib.mxt_paged_attention_phases.restype = _I
    fn = lib.mxt_paged_attention_scratch
    fn.argtypes = [_I] * 5
    fn.restype = ctypes.c_longlong
    return lib


def paged_attention(q, k_pages, v_pages, lengths, page_indices, scale=None):
    """Decode-phase paged attention (one query token per sequence).

    q:            (B, num_heads, head_dim) fp32; head_dim 32, 64 or 128
                  for a CUDA tensor
    k_pages/v_pages: (num_kv_heads, total_pages, page_size, head_dim) fp32,
                  or :class:`QPages` of that layout (int8 codes, fp32
                  scales (num_kv_heads, total_pages))
    lengths:      (B,) int32 valid context length per sequence (0 for an
                  inactive row, whose output is zeros)
    page_indices: (B, pages_per_seq) int32 page-table rows
    scale:        softmax scale, ``1/sqrt(head_dim)`` by default

    Returns (B, num_heads, head_dim).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel, counted in
    ``paged_attention.launches`` (fp pages) or
    ``paged_attention.launches_int8`` (int8 pages)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, lengths,
                                          page_indices, scale=scale)
    return _launch(q, k_pages, v_pages, lengths, page_indices, scale, None)


def paged_attention_times(q, k_pages, v_pages, lengths, page_indices,
                          scale=None):
    """One launch of the kernel on CUDA tensors (as :func:`paged_attention`)
    that also stamps the card's global timer at the end of each phase.
    Returns ``{phase: ns}`` in the kernel's order (:data:`PAGED_PHASES`)."""
    stamps = torch.zeros(len(PAGED_PHASES) + 1, dtype=torch.int64,
                         device=q.device)
    _launch(q, k_pages, v_pages, lengths, page_indices, scale, stamps)
    return dict(zip(PAGED_PHASES, torch.diff(stamps.cpu()).tolist()))


def _launch(q, k_pages, v_pages, lengths, page_indices, scale, stamps):
    if q.device.type != "cuda":
        raise ValueError("paged_attention: unsupported device %s" % q.device)
    int8 = isinstance(k_pages, QPages)
    if int8 != isinstance(v_pages, QPages):
        raise ValueError("paged_attention: k_pages and v_pages must both be "
                         "QPages or both fp tensors")
    kc, vc = (k_pages.q, v_pages.q) if int8 else (k_pages, v_pages)
    B, H, D = q.shape
    KVH, P, S, Dk = kc.shape
    pps = page_indices.shape[-1]
    if (Dk != D or vc.shape != kc.shape or H % KVH
            or tuple(lengths.shape) != (B,)
            or tuple(page_indices.shape) != (B, pps)):
        raise ValueError(
            "paged_attention: bad shapes q %s pages %s/%s lengths %s "
            "tables %s" % (tuple(q.shape), tuple(kc.shape),
                           tuple(vc.shape), tuple(lengths.shape),
                           tuple(page_indices.shape)))
    page_dt = torch.int8 if int8 else torch.float32
    checks = [("q", q, torch.float32, q.shape),
              ("k_pages", kc, page_dt, kc.shape),
              ("v_pages", vc, page_dt, kc.shape),
              ("lengths", lengths, torch.int32, lengths.shape),
              ("page_indices", page_indices, torch.int32,
               page_indices.shape)]
    if int8:
        checks += [("k scales", k_pages.s, torch.float32, (KVH, P)),
                   ("v scales", v_pages.s, torch.float32, (KVH, P))]
    for name, t, dt, shape in checks:
        if (t.dtype != dt or t.device != q.device or not t.is_contiguous()
                or tuple(t.shape) != tuple(shape)):
            raise ValueError("paged_attention: %s must be a contiguous %s "
                             "tensor of shape %s on %s (got %s %s on %s)"
                             % (name, dt, tuple(shape), q.device, t.dtype,
                                tuple(t.shape), t.device))
    if D not in (32, 64, 128):
        raise ValueError("paged_attention: head_dim must be 32, 64 or 128 "
                         "(a lane takes head_dim / 32 columns), got %d" % D)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _lib()
    if stamps is not None and lib.mxt_paged_attention_phases() != len(
            PAGED_PHASES):
        raise RuntimeError("paged_attention: the kernel stamps %d phases, "
                           "PAGED_PHASES names %d"
                           % (lib.mxt_paged_attention_phases(),
                              len(PAGED_PHASES)))
    out = torch.empty_like(q)
    if not B:
        return out
    # the split units' partials: outputs, maxima and sums per unit
    scratch = torch.empty(lib.mxt_paged_attention_scratch(B, H, KVH, D,
                                                          pps * S),
                          dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if int8:
        rc = lib.mxt_paged_attention_i8(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            k_pages.s.data_ptr(), v_pages.s.data_ptr(), lengths.data_ptr(),
            page_indices.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            None if stamps is None else stamps.data_ptr(), B, H, KVH, P, S,
            D, pps, float(scale), stream)
        _build.check(lib, rc, "paged_attention (int8 pages)")
        paged_attention.launches_int8 += 1
    else:
        rc = lib.mxt_paged_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lengths.data_ptr(),
            page_indices.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            None if stamps is None else stamps.data_ptr(), B, H, KVH, P, S,
            D, pps, float(scale), stream)
        _build.check(lib, rc, "paged_attention")
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
paged_attention.launches_int8 = 0
