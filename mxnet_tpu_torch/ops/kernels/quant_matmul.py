"""Weight-only quantized matmul for LLM decode (the port of
``mxnet_tpu/ops/pallas/quant_matmul.py``).

Decode GEMMs at a batch of a few sequences are bound by the weight bytes,
so storing the weights in fewer bits is the lever: activations stay fp32
and the integer weights are dequantized inside the kernel, never written
out at full width.  Two formats, plain ``NamedTuple``s of tensors:

- :class:`QuantW8` — per-output-channel symmetric int8: ``q (O, I) int8``,
  ``s (O,) f32``; ``w = q * s[:, None]``.
- :class:`QuantW4` — per-group symmetric int4, two values per byte along
  the input dim (low nibble = even index): ``q (O, I/2) uint8``,
  ``s (O, G) f32``, ``group = I / G = 2 * q.shape[1] // s.shape[1]``.
  Values are clipped to [-7, 7].

Quantization (:func:`quantize_w8`, :func:`quantize_w4`) gives the JAX
package's codes and scales bit for bit.  :func:`quant_matmul` on a CUDA
tensor launches the hand-written kernel ``csrc/quant_matmul.cu`` (its
design note is there), counted in ``quant_matmul.launches_w8`` /
``quant_matmul.launches_w4``; on a CPU tensor it runs
:func:`quant_matmul_plain` (dequantize, then ``x @ w.T`` in fp32).  There
is no other lane: a CUDA call launches the kernel or raises, and
``MXNET_QUANT_MATMUL`` cannot switch the card to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

__all__ = ["QuantW8", "QuantW4", "is_quantized", "group_for", "w4_group",
           "quantize_w8", "quantize_w4", "pack_int4", "unpack_int4",
           "dequantize_weight", "quant_matmul", "quant_matmul_plain"]

_INT8_MAX = 127.0
_INT4_MAX = 7.0

_P = ctypes.c_void_p
_I = ctypes.c_int


class QuantW8(NamedTuple):
    """Per-output-channel int8 weight: ``w ≈ q * s[:, None]``."""
    q: torch.Tensor  # (O, I) int8
    s: torch.Tensor  # (O,)   f32


class QuantW4(NamedTuple):
    """Per-group int4 weight, nibble-packed along the input dim:
    ``w ≈ unpack(q).reshape(O, G, group) * s[:, :, None]``."""
    q: torch.Tensor  # (O, I // 2) uint8: byte i holds values 2i (low
    #                  nibble) and 2i+1 (high nibble)
    s: torch.Tensor  # (O, G) f32, G = I // group


def is_quantized(w):
    return isinstance(w, (QuantW8, QuantW4))


def group_for(in_dim, group):
    """Largest divisor of ``in_dim`` that is ≤ ``group`` and divides it
    evenly — the effective group size."""
    return math.gcd(min(int(group), int(in_dim)), int(in_dim))


def w4_group(in_dim, group):
    """The group :func:`quantize_w4` uses for ``in_dim`` inputs: the
    :func:`group_for` divisor, made even so that a group covers whole
    packed bytes.  ``in_dim`` must be even."""
    if in_dim % 2:
        raise ValueError("int4 packing needs an even input dim, got %d"
                         % in_dim)
    group = group_for(in_dim, group)
    if group % 2:
        group = group_for(in_dim, group * 2) if group > 1 else 2
    return group


def quantize_w8(w):
    """fp32 (O, I) → :class:`QuantW8` (symmetric per output channel,
    amax/127)."""
    w = torch.as_tensor(w, dtype=torch.float32)
    amax = w.abs().amax(dim=1)
    s = torch.where(amax > 0, amax / _INT8_MAX, torch.ones_like(amax))
    q = torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8)
    return QuantW8(q=q, s=s)


def quantize_w4(w, group=128):
    """fp32 (O, I) → :class:`QuantW4` (symmetric per group, amax/7).

    ``group`` is clamped to a divisor of the input dim via
    :func:`group_for`, then made even so that a group covers whole packed
    bytes; I must be even."""
    w = torch.as_tensor(w, dtype=torch.float32)
    o, i = w.shape
    group = w4_group(i, group)
    g = i // group
    wg = w.reshape(o, g, group)
    amax = wg.abs().amax(dim=2)
    s = torch.where(amax > 0, amax / _INT4_MAX, torch.ones_like(amax))
    q = torch.round(wg / s[:, :, None]).clamp(-7, 7)
    return QuantW4(q=pack_int4(q.reshape(o, i).to(torch.int8)), s=s)


def pack_int4(v):
    """(O, I) int8 in [-8, 7] → (O, I/2) uint8, value ``2i`` in the low
    nibble of byte ``i`` and ``2i+1`` in the high nibble."""
    v32 = v.to(torch.int32)
    packed = ((v32[:, 1::2] & 0xF) << 4) | (v32[:, 0::2] & 0xF)
    return packed.to(torch.uint8)


def unpack_int4(q):
    """(O, I/2) uint8 → (O, I) int32, sign-extended nibbles."""
    b = q.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)


def dequantize_weight(qw):
    """Integer weight → fp32 (O, I), the plain version's formula."""
    if isinstance(qw, QuantW8):
        return qw.q.to(torch.float32) * qw.s[:, None]
    o, i, g = qw.q.shape[0], 2 * qw.q.shape[1], qw.s.shape[1]
    w = (unpack_int4(qw.q).to(torch.float32).reshape(o, g, i // g)
         * qw.s[:, :, None])
    return w.reshape(o, i)


def _in_dim(qw):
    return qw.q.shape[1] * (1 if isinstance(qw, QuantW8) else 2)


def quant_matmul_plain(x, qw):
    """Plain version: dequantize, then ``x @ w.T`` in fp32.  ``x``:
    (..., I) any float dtype; returns (..., O) f32."""
    i, o = _in_dim(qw), qw.q.shape[0]
    lead = x.shape[:-1]
    y = x.reshape(-1, i).to(torch.float32) @ dequantize_weight(qw).T
    return y.reshape(lead + (o,))


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library with its entry points typed (once)."""
    lib = _build.load("quant_matmul")
    lib.mxt_quant_matmul.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    lib.mxt_quant_matmul.restype = _I
    lib.mxt_quant_matmul_k_tile.argtypes = [_I]
    lib.mxt_quant_matmul_k_tile.restype = _I
    lib.k_tile = {f: lib.mxt_quant_matmul_k_tile(f) for f in (8, 4)}
    return lib


def quant_matmul(x, qw):
    """``x @ dequant(qw).T`` with the integer weight dequantized inside
    the kernel.  ``x``: (..., I) fp32; returns (..., O) fp32.

    A CPU tensor takes :func:`quant_matmul_plain`.  A CUDA tensor
    launches the kernel, counted in ``quant_matmul.launches_w8`` or
    ``quant_matmul.launches_w4``; the kernel takes contiguous fp32 ``x``
    with 16-byte aligned rows, an input dim that is a multiple of its K
    tile (128 inputs for int8, 256 for int4) and an even int4 group."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qw)
    if x.device.type != "cuda":
        raise ValueError("quant_matmul: unsupported device %s" % x.device)
    if not is_quantized(qw):
        raise ValueError("quant_matmul: weight must be QuantW8 or QuantW4")
    w8 = isinstance(qw, QuantW8)
    i, o = _in_dim(qw), qw.q.shape[0]
    if x.shape[-1] != i:
        raise ValueError("quant_matmul: x has %d inputs, the weight %d"
                         % (x.shape[-1], i))
    lead = x.shape[:-1]
    xf = x.reshape(-1, i)
    m = xf.shape[0]
    s_shape = (o,) if w8 else (o, qw.s.shape[-1])
    for name, t, dt, shape in (
            ("x", xf, torch.float32, (m, i)),
            ("q", qw.q, torch.int8 if w8 else torch.uint8,
             (o, i if w8 else i // 2)),
            ("s", qw.s, torch.float32, s_shape)):
        if (t.dtype != dt or t.device != x.device or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError("quant_matmul: %s must be a contiguous %s tensor "
                             "of shape %s on %s (got %s %s on %s)"
                             % (name, dt, shape, x.device, t.dtype,
                                tuple(t.shape), t.device))
    lib = _lib()
    fmt = 8 if w8 else 4
    k_tile = lib.k_tile[fmt]
    group = i if w8 else 2 * qw.q.shape[1] // qw.s.shape[1]
    bad_group = not w8 and (group % 2 or group * qw.s.shape[-1] != i)
    if (i % k_tile or bad_group or xf.data_ptr() % 16
            or qw.q.data_ptr() % 16):
        raise ValueError(
            "quant_matmul: the kernel takes an input dim that is a multiple "
            "of %d, an even int4 group dividing it and 16-byte aligned x and "
            "q (got I=%d, group=%d)" % (k_tile, i, group))
    y = torch.empty((m, o), dtype=torch.float32, device=x.device)
    if m:
        rc = lib.mxt_quant_matmul(
            xf.data_ptr(), qw.q.data_ptr(), qw.s.data_ptr(), y.data_ptr(),
            m, o, i, fmt, group,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, "quant_matmul")
        if w8:
            quant_matmul.launches_w8 += 1
        else:
            quant_matmul.launches_w4 += 1
    return y.reshape(lead + (o,))


quant_matmul.launches_w8 = 0
quant_matmul.launches_w4 = 0
