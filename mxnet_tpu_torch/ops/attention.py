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
- :func:`flash_attention_sharded` — attention over a (dp, tp) mesh
  (``attention.py:315-396``): batch over dp, heads over tp.  Plain causal
  attention is one flash call over the whole tensors, where the JAX
  package runs the TPU's splash kernel on each shard: causal attention
  with no dropout, window or padding mask is independent per (batch,
  head), and the shards tile (batch, heads) exactly, so on one card one
  call over all of them computes what the mesh's per-shard calls compute,
  in one launch of each kernel.  The other masks run each shard in turn;
- :func:`sldwin_atten` — sliding-window attention (``attention.py:431``).

``last_path`` names the route of the last :func:`flash_attention` call:
``"kernel"`` (CUDA), ``"plain"`` (the kernels' plain version, CPU) or
``"reference"``, and ``"flash-causal-shard"`` after a
:func:`flash_attention_sharded` call whose shards took the causal route.
``flash_attention_sharded.launches`` counts the forward kernel launches
that route made on the card (one a call), and
``flash_attention_sharded.causal_shards`` the (dp, tp) shards its calls
stood for (dp * tp a call, on any device).  The ring route over a
sequence-parallel axis waits for ``parallel.ring_attention``.
"""
from __future__ import annotations

import math

import torch

from .kernels import flash_attention as _flash
from .nn import _amp_cast1

__all__ = ["attention_reference", "flash_attention", "flash_attention_sharded",
           "sldwin_atten"]

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


def _fold_in(seed, idx):
    """A uint32 seed mixed with a shard index: murmur3's 32-bit finaliser
    of ``seed ^ (idx + 1) * 0x9E3779B9``, on a Python int or an int64
    tensor alike.  It stands where the JAX package
    calls ``jax.random.fold_in`` (threefry), whose bits it does not
    reproduce: shards draw different masks, the same for the same seed.
    Each product is taken in 16-bit halves, so an int64 tensor never
    overflows."""
    m = 0xFFFFFFFF

    def mul32(a, c):        # a * c mod 2**32 with no product past 2**49
        return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & m

    h = (seed ^ mul32(idx + 1, 0x9E3779B9)) & m
    h = mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def flash_attention_sharded(q, k, v, cfg, causal=False, window=None,
                            scale=None, dropout=0.0, seed=None,
                            generator=None, kv_length=None):
    """Attention over the (dp, tp) mesh of ``cfg`` (a
    ``parallel.ShardingConfig``): q, k, v (B, H, L, D) -> (B, H, L, D),
    batch split over dp and heads over tp, as the JAX package's
    ``flash_attention_sharded`` (``attention.py:315-396``) lays them out.

    - Plain causal attention (no window, dropout or ``kv_length``), where
      the JAX package runs the TPU's splash kernel on each shard
      (``_splash_causal``, ``attention.py:302``), is ONE call of the flash
      op with ``causal=True`` on the whole tensors: one launch of the
      forward kernel, and in the backward one each of the delta, dq and
      dkv kernels.  Each (batch, head) of causal attention is independent
      of the others, and the (dp, tp) shards tile (batch, heads) exactly,
      so the one call computes every shard's splash call, each (batch,
      head) with the same arithmetic as a call on its shard alone.
      ``launches`` counts the forward kernel's launch (none on the CPU)
      and ``causal_shards`` the dp * tp shards the call stands for.
    - Otherwise (window, dropout or ``kv_length``) the port, on one card,
      runs the shards there in turn: each takes :func:`flash_attention`
      with its slice of ``kv_length``, and the outputs are concatenated.
    - Under dropout each shard's seed is ``seed`` (or one drawn from
      ``generator``) mixed with the linear shard index ``d * tp + t`` by
      :func:`_fold_in`, so shards draw different masks.

    B must divide by dp and H by tp.  A sequence-parallel axis (sp > 1)
    raises NotImplementedError: its ring route is not ported yet."""
    global last_path
    if cfg.axis_size("sp") > 1:
        raise NotImplementedError(
            "flash_attention_sharded: sp > 1 takes the ring route, and "
            "parallel.ring_attention is not ported yet")
    B, H = q.shape[:2]
    dp, tp = cfg.axis_size("dp"), cfg.axis_size("tp")
    if B % dp or H % tp:
        raise ValueError("flash_attention_sharded: batch %d must divide by "
                         "dp=%d and heads %d by tp=%d" % (B, dp, H, tp))
    if dropout and seed is None:
        seed = torch.randint(0, 2 ** 32, (1,), dtype=torch.int64,
                             device=q.device, generator=generator)
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(1).to(device=q.device, dtype=torch.int64)
    if kv_length is not None:
        kv_length = torch.as_tensor(kv_length, device=q.device).reshape(B)
    if causal and not (window is not None or dropout
                       or kv_length is not None):
        q = _amp_cast1("flash_attention", q)
        k = _amp_cast1("flash_attention", k)
        v = _amp_cast1("flash_attention", v)
        n0 = _flash.flash_attention.launches_fwd
        out = _flash.flash_attention(q, k, v, causal=True, scale=scale)
        flash_attention_sharded.launches += (
            _flash.flash_attention.launches_fwd - n0)
        flash_attention_sharded.causal_shards += dp * tp
        last_path = "flash-causal-shard"
        return out
    outs = [flash_attention(
        q[b, h], k[b, h], v[b, h], causal=causal, window=window,
        scale=scale, dropout=dropout,
        seed=_fold_in(seed, d * tp + t) if dropout else None,
        kv_length=None if kv_length is None else kv_length[b])
        for d, t, b, h in _shards(B, H, dp, tp)]
    return torch.cat([torch.cat(outs[d * tp:(d + 1) * tp], dim=1)
                      for d in range(dp)], dim=0)


flash_attention_sharded.launches = 0
flash_attention_sharded.causal_shards = 0


def _shards(B, H, dp, tp):
    """(d, t, batch slice, head slice) of each shard of the (dp, tp) mesh,
    d-major."""
    Bl, Hl = B // dp, H // tp
    for d in range(dp):
        for t in range(tp):
            yield (d, t, slice(d * Bl, (d + 1) * Bl),
                   slice(t * Hl, (t + 1) * Hl))


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
