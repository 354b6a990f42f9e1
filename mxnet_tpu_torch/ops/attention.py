"""Attention (the port of the single-device half of
``mxnet_tpu/ops/attention.py``).

- :func:`attention_reference` — the O(L^2) softmax(QK^T)V in plain
  PyTorch (``attention.py:83``), with dense masks, cross-attention
  (Lq != Lk) and dropout drawn from a ``torch.Generator``;
- :func:`flash_attention` — the dispatch of ``_flash_local``
  (``attention.py:168``): self-attention without a dense mask goes to the
  flash kernels of ``ops/kernels/flash_attention.py`` (the CUDA kernels
  for a tensor on the card, their plain version on the CPU); a dense
  mask or Lq != Lk goes to :func:`attention_reference`, as in the JAX
  package.  That is a rule about features: a kernel that fails on the
  card raises;
- :func:`sldwin_atten` — sliding-window attention (``attention.py:431``).

``last_path`` names the route of the last :func:`flash_attention` call:
``"kernel"`` (CUDA), ``"plain"`` (the kernels' plain version, CPU) or
``"reference"``.  The mesh-sharded and splash routes of the JAX module
are not ported (ROADMAP Queue 1, splash attention on a mesh).
"""
from __future__ import annotations

import math

import torch

from .kernels import flash_attention as _flash
from .nn import _amp_cast1

__all__ = ["attention_reference", "flash_attention", "sldwin_atten"]

#: the route of the last :func:`flash_attention` call
last_path = None


def attention_reference(q, k, v, mask=None, causal=False, window=None,
                        scale=None, dropout=0.0, generator=None,
                        kv_length=None):
    """q (B, H, Lq, D), k and v (B, H, Lk, D) -> (B, H, Lq, D) in q.dtype,
    computed in fp32.  ``mask``: boolean, broadcastable to (B, H, Lq, Lk),
    True where a key is seen; ``kv_length``: (B,) valid keys; ``dropout``
    drops normalised probabilities with a mask drawn from ``generator``
    (no dropout when it is None).  A row with no valid key gives 0."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    Lq, Lk = logits.shape[-2], logits.shape[-1]
    neg = float("-inf")
    dev = q.device
    if causal:
        cm = torch.ones(Lq, Lk, dtype=torch.bool, device=dev).tril(Lk - Lq)
        logits = logits.masked_fill(~cm, neg)
    if window is not None:
        qi = torch.arange(Lq, device=dev)[:, None] + (Lk - Lq)
        ki = torch.arange(Lk, device=dev)[None, :]
        logits = logits.masked_fill((qi - ki).abs() > window, neg)
    if kv_length is not None:
        km = (torch.arange(Lk, device=dev)[None, None, None, :]
              < torch.as_tensor(kv_length, device=dev).reshape(-1, 1, 1, 1))
        logits = logits.masked_fill(~km, neg)
    if mask is not None:
        logits = logits.masked_fill(~torch.as_tensor(mask, device=dev)
                                    .bool(), neg)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    if dropout and generator is not None:
        keep = torch.rand(p.shape, generator=generator, device=dev) < (
            1.0 - dropout)
        p = p * keep / (1.0 - dropout)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, mask=None, causal=False, window=None,
                    scale=None, dropout=0.0, seed=None, generator=None,
                    kv_length=None):
    """Blockwise O(L)-memory attention with its gradient: q, k, v (B, H, L,
    D) -> (B, H, L, D).  ``dropout`` (the rate, already resolved for train
    or eval mode) drops attention probabilities in the kernel with the
    hash mask of ``seed`` (an int or a one-element int64 tensor), or of a
    seed drawn from ``generator`` on the device; ``kv_length`` (B,) is a
    padding mask as a per-row count of valid keys.  Under an AMP scope q,
    k and v are cast to its dtype."""
    global last_path
    if not 0.0 <= dropout < 1.0:
        raise ValueError("flash_attention: dropout must be in [0, 1), got %r"
                         % (dropout,))
    if dropout and seed is None and generator is None:
        raise ValueError("flash_attention: dropout > 0 requires a seed or a "
                         "generator")
    q = _amp_cast1("flash_attention", q)
    k = _amp_cast1("flash_attention", k)
    v = _amp_cast1("flash_attention", v)
    if mask is None and q.shape[-2] == k.shape[-2]:
        out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                     scale=scale, dropout=dropout, seed=seed,
                                     kv_length=kv_length, generator=generator)
        last_path = "plain" if q.device.type == "cpu" else "kernel"
        return out
    if dropout and generator is None:
        generator = torch.Generator(device=q.device).manual_seed(
            int(seed) & 0xFFFFFFFF)
    last_path = "reference"
    return attention_reference(q, k, v, mask=mask, causal=causal,
                               window=window, scale=scale, dropout=dropout,
                               generator=generator, kv_length=kv_length)


def sldwin_atten(q, k, v, window, symmetric=True):
    """q, k, v (B, H, L, D); banded attention of half-width ``window``
    (symmetric), or looking back ``window`` keys (not symmetric)."""
    if symmetric:
        return flash_attention(q, k, v, window=window)
    L = q.shape[-2]
    qi = torch.arange(L, device=q.device)[:, None]
    ki = torch.arange(L, device=q.device)[None, :]
    m = (ki <= qi) & (qi - ki <= window)
    return attention_reference(q, k, v, mask=m)
