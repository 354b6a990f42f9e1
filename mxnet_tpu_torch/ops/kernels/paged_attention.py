"""Paged attention for autoregressive decode over a page-granular KV cache.

The port of ``mxnet_tpu/ops/pallas/paged_attention.py`` (fp pages).  The
cache is a pool of fixed-size pages (``k_pages``/``v_pages``:
``(num_kv_heads, total_pages, page_size, head_dim)``); each sequence owns
a page-table row, and attention reads through the table.

- :func:`paged_attention` — one query token per sequence.  A CUDA tensor
  launches the hand-written kernel ``csrc/paged_attention.cu`` (its design
  note is in ``csrc/paged_attention.cuh``); a CPU tensor runs
  :func:`paged_attention_reference`.  There is no fallback: a CUDA call
  launches the kernel or raises.
- :func:`paged_attention_reference` — the plain version: gather the
  sequence's pages into a contiguous cache (:func:`gather_pages`), then
  masked fp32 softmax (:func:`attend_ctx`).  Length-0 rows give zeros.
- :func:`copy_page` — duplicate one physical page, in place.

The kernel replaces the upstream TPU Pallas kernel
``jax.experimental.pallas.ops.tpu.paged_attention`` that the JAX package
calls at ``mxnet_tpu/ops/pallas/paged_attention.py:251``.  The int8
``QPages`` dequant-at-read of that module is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_reference", "gather_pages",
           "attend_ctx", "copy_page"]

_P = ctypes.c_void_p
_I = ctypes.c_int


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


def copy_page(pages, src, dst):
    """``pages[..., dst, :, :] <- pages[..., src, :, :]``, in place, on any
    layout whose page axis is third from last (the kernel layout
    ``(KVH, P, S, D)`` and the engine's ``(L, KVH, P, S, D)``).  Returns
    ``pages``.  The JAX package returns an updated copy instead."""
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
    softmax.  Correct for any GQA grouping and for length-0 rows."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    k_ctx = gather_pages(k_pages, page_indices)
    v_ctx = gather_pages(v_pages, page_indices)
    return attend_ctx(q, k_ctx, v_ctx, lengths, scale)


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.mxt_paged_attention
    fn.argtypes = [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    return lib


def paged_attention(q, k_pages, v_pages, lengths, page_indices, scale=None):
    """Decode-phase paged attention (one query token per sequence).

    q:            (B, num_heads, head_dim) fp32
    k_pages/v_pages: (num_kv_heads, total_pages, page_size, head_dim) fp32
    lengths:      (B,) int32 valid context length per sequence (0 for an
                  inactive row, whose output is zeros)
    page_indices: (B, pages_per_seq) int32 page-table rows
    scale:        softmax scale, ``1/sqrt(head_dim)`` by default

    Returns (B, num_heads, head_dim).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted in
    ``paged_attention.launches``)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, lengths,
                                          page_indices, scale=scale)
    if q.device.type != "cuda":
        raise ValueError("paged_attention: unsupported device %s" % q.device)
    B, H, D = q.shape
    KVH, P, S, Dk = k_pages.shape
    pps = page_indices.shape[-1]
    if (Dk != D or v_pages.shape != k_pages.shape or H % KVH
            or tuple(lengths.shape) != (B,)
            or tuple(page_indices.shape) != (B, pps)):
        raise ValueError(
            "paged_attention: bad shapes q %s pages %s/%s lengths %s "
            "tables %s" % (tuple(q.shape), tuple(k_pages.shape),
                           tuple(v_pages.shape), tuple(lengths.shape),
                           tuple(page_indices.shape)))
    for name, t, dt in (("q", q, torch.float32),
                        ("k_pages", k_pages, torch.float32),
                        ("v_pages", v_pages, torch.float32),
                        ("lengths", lengths, torch.int32),
                        ("page_indices", page_indices, torch.int32)):
        if t.dtype != dt or t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_attention: %s must be a contiguous %s "
                             "tensor on %s (got %s on %s)"
                             % (name, dt, q.device, t.dtype, t.device))
    if D % 4:
        raise ValueError("paged_attention: head_dim must be a multiple of 4")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lib = _lib()
    out = torch.empty_like(q)
    if B:
        rc = lib.mxt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
            B, H, KVH, P, S, D, pps, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, rc, "paged_attention")
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
