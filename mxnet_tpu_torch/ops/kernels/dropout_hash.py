"""Counter-based dropout hash (the port's copy of ``hash_keep_bits``,
``mxnet_tpu/ops/pallas/flash_attention.py:125``, and ``_keep_scale_rows``,
``mxnet_tpu/ops/pallas/epilogue.py:120``).

A uint32 per (seed, batch-head, row, column) from uint32 multiply, xor and
shift: Murmur3's finalizer after a linear pre-mix.  The mask depends only
on global positions, so a forward and its backward, any tiling, the CUDA
kernels (``csrc/dropout_hash.cuh``) and this plain version all draw the same
mask, bit for bit, as the JAX package does.

PyTorch has no uint32 multiply, so the plain version holds every value in
int64 and reduces mod 2**32 after each step.  A product of two 32-bit
values can pass 2**63; :func:`_mul32` splits the constant into 16-bit
halves, so no intermediate passes 2**49.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["hash_keep_bits", "keep_threshold", "keep_scale",
           "keep_scale_rows"]

_M32 = 0xFFFFFFFF


def _mul32(h, c):
    """(h * c) mod 2**32 for int64 ``h`` in [0, 2**32) and a constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def hash_keep_bits(seed, b, gi, gj):
    """The hash as an int64 tensor of values in [0, 2**32).  ``seed``: an
    int or an int64 tensor broadcastable to the result; ``b``: the
    batch-head index ``bh = b * H + h`` (0 for the epilogue ops), an int
    or an int64 tensor that broadcasts with ``gi`` and ``gj``;
    ``gi``/``gj``: int64 row and column indices, non-negative."""
    gi = torch.as_tensor(gi, dtype=torch.int64)
    gj = torch.as_tensor(gj, dtype=torch.int64)
    h = _mul32(gi & _M32, 0x9E3779B1) ^ _mul32(gj & _M32, 0x85EBCA77)
    s = torch.as_tensor(seed, dtype=torch.int64, device=h.device) & _M32
    b = torch.as_tensor(b, dtype=torch.int64, device=h.device) & _M32
    h = h ^ ((s + _mul32(b, 0xC2B2AE3D)) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_threshold(rate):
    """An element is kept where its hash is >= this uint32 threshold."""
    return min(int(round(float(rate) * 4294967296.0)), 4294967295)


def keep_scale(rate):
    """The multiplier of a kept element, 1/(1-rate) rounded to float32."""
    return float(np.float32(1.0 / (1.0 - float(rate))))


def keep_scale_rows(seed, i0, shape, rate, device=None):
    """Float32 dropout multiplier for rows [i0, i0 + shape[0]) of the
    (R, C) view: 0 where dropped, :func:`keep_scale` where kept.
    ``seed``: int, or an int64 tensor of one element (on ``device``)."""
    R, C = shape
    if isinstance(seed, torch.Tensor):
        device = seed.device
        seed = seed.reshape(())
    gi = torch.arange(i0, i0 + R, dtype=torch.int64, device=device)[:, None]
    gj = torch.arange(C, dtype=torch.int64, device=device)[None, :]
    keep = hash_keep_bits(seed, 0, gi, gj) >= keep_threshold(rate)
    return keep.to(torch.float32) * keep_scale(rate)
