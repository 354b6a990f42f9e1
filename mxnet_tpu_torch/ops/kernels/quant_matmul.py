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
           "shard_quantized",
           "dequantize_weight", "quant_matmul", "quant_matmul_plain",
           "qmm_plan", "QmmPlan", "qmm_phase_times"]

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


def shard_quantized(qw, tp, dim):
    """Cut an integer weight into its ``tp`` tensor-parallel parts, as the
    JAX plan places them (``mxnet_tpu/models/decoder.py:TPPlan.
    param_specs``): ``dim`` 0 is a column shard (output channels: ``q``
    and ``s`` split along O, contiguous views), ``dim`` 1 a row shard
    (input dims, contiguous copies): int8 ``q`` split along I with ``s``
    replicated (the same tensor in every part), int4 ``q`` along its
    packed bytes (I / 2) and ``s`` along its groups.  An int4 row shard
    whose boundary would cut a scale group raises ``ValueError``
    (``quantize_params(tp=)`` shrinks the group so none does)."""
    tp, dim = int(tp), int(dim)
    o, i = qw.q.shape[0], _in_dim(qw)
    n = (o, i)[dim]
    if dim not in (0, 1) or tp < 1 or n % tp:
        raise ValueError("shard_quantized: %d %s do not split %d ways"
                         % (n, ("outputs", "inputs")[dim], tp))
    if dim == 0:
        return [type(qw)(q=q, s=s) for q, s in zip(qw.q.chunk(tp, 0),
                                                    qw.s.chunk(tp, 0))]
    if isinstance(qw, QuantW8):
        return [QuantW8(q=q.contiguous(), s=qw.s) for q in qw.q.chunk(tp, 1)]
    groups = qw.s.shape[1]
    if groups % tp or (i // tp) % 2:
        raise ValueError(
            "shard_quantized: int4 groups of %d inputs straddle the %d-input "
            "row shards of tp %d (quantize with quantize_params(tp=%d))"
            % (i // groups, i // tp, tp, tp))
    return [QuantW4(q=q.contiguous(), s=s.contiguous())
            for q, s in zip(qw.q.chunk(tp, 1), qw.s.chunk(tp, 1))]


def _in_dim(qw):
    return qw.q.shape[1] * (1 if isinstance(qw, QuantW8) else 2)


def quant_matmul_plain(x, qw):
    """Plain version: dequantize, then ``x @ w.T`` in fp32.  ``x``:
    (..., I) any float dtype; returns (..., O) f32."""
    i, o = _in_dim(qw), qw.q.shape[0]
    lead = x.shape[:-1]
    y = x.reshape(-1, i).to(torch.float32) @ dequantize_weight(qw).T
    return y.reshape(lead + (o,))


#: the kernel's fixed sizes (``csrc/quant_matmul.cu``): inputs per
#: pipeline stage and per warp chunk, the most blocks a cluster takes; the
#: blocks the plan aims at on mma.sync (three an SM of the H100's 132) and
#: the most it takes on wgmma (two an SM)
KSTAGE, KCHUNK, CLUSTER_MAX = 128, 32, 8
TARGET_BLOCKS, WG_BLOCKS = 3 * 132, 2 * 132


class QmmPlan(NamedTuple):
    """How the kernel splits ``x (m, i) @ w (o, i).T``: ``ks`` K slices of
    ``slice`` inputs (whole stages; the last slice ends at ``i``), one
    block each, summed by the cluster of ``ks`` blocks in slice order;
    blocks of ``16 * wch`` channels and ``8 * nt`` rows; ``fold``: int4
    with the scale folded into the weight (a group not a multiple of
    ``KCHUNK``); ``wg``: products on wgmma (64 channels, 32 rows), else
    on mma.sync."""
    ks: int
    slice: int
    wch: int
    nt: int
    fold: bool
    wg: bool = False

    def slices(self, i):
        """(lo, hi) of each K slice, in slice (cluster rank) order."""
        return [(r * self.slice, min(i, (r + 1) * self.slice))
                for r in range(self.ks)]

    def blocks(self, m, o):
        return (self.ks * -(-o // (16 * self.wch))
                * -(-m // (8 * self.nt)))


@functools.lru_cache(maxsize=1024)
def qmm_plan(m, o, i, fmt, group):
    """The kernel's plan for ``m`` rows, ``o`` outputs, ``i`` inputs, int
    ``fmt`` (8 or 4) and the int4 ``group``.  Up to 16 rows (a decode
    step), mma.sync on one 8-row tile of 16 channels a block, or one
    16-row tile of 32; K cut into as many slices (at most 8) as bring the
    blocks near three an SM.  Above 16 rows (a prefill chunk), wgmma on
    32-row tiles of 64 channels, whose shared memory and registers allow
    two blocks an SM: K cut into as many slices as keep the blocks within
    that, one wave.  K is split in two at least wherever it has two
    stages; slices are whole 128-input stages, none empty."""
    if m <= 16:
        nt = 1 if m <= 8 else 2
        wch, wg = nt, False
        want = -(-TARGET_BLOCKS // -(-o // (16 * wch)))
    else:
        nt, wch, wg = 4, 4, True
        want = WG_BLOCKS // (-(-o // 64) * -(-m // 32))
    stages = max(1, -(-i // KSTAGE))
    ks = min(CLUSTER_MAX, stages, max(2, want))     # K split where it can
    per = -(-stages // ks)
    return QmmPlan(ks=-(-stages // per), slice=per * KSTAGE, wch=wch, nt=nt,
                   fold=fmt == 4 and group % KCHUNK != 0, wg=wg)


@functools.lru_cache(maxsize=None)
def _lib():
    """The loaded library with its entry point typed (once)."""
    lib = _build.load("quant_matmul")
    lib.mxt_quant_matmul.argtypes = [_P] * 4 + [_I] * 13 + [_P, _P]
    lib.mxt_quant_matmul.restype = _I
    return lib


def quant_matmul(x, qw):
    """``x @ dequant(qw).T`` with the integer weight dequantized inside
    the kernel.  ``x``: (..., I) fp32; returns (..., O) fp32.

    A CPU tensor takes :func:`quant_matmul_plain`.  A CUDA tensor
    launches the kernel once, as :func:`qmm_plan` splits it, counted in
    ``quant_matmul.launches_w8`` or ``quant_matmul.launches_w4``; the
    kernel takes contiguous fp32 ``x`` and any input dim (even for int4,
    whose group is ``I / s.shape[1]``)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, qw)
    if x.device.type != "cuda":
        raise ValueError("quant_matmul: unsupported device %s" % x.device)
    w8 = isinstance(qw, QuantW8)
    if not w8 and not isinstance(qw, QuantW4):
        raise ValueError("quant_matmul: weight must be QuantW8 or QuantW4")
    q, s = qw.q, qw.s
    i, o = _in_dim(qw), q.shape[0]
    if x.shape[-1] != i:
        raise ValueError("quant_matmul: x has %d inputs, the weight %d"
                         % (x.shape[-1], i))
    if not w8 and (s.dim() != 2 or not s.shape[1] or i % s.shape[1]):
        raise ValueError("quant_matmul: int4 scales of shape %s do not cut "
                         "%d inputs into equal groups" % (tuple(s.shape), i))
    lead = x.shape[:-1]
    xf = x.reshape(-1, i)
    m = xf.shape[0]
    if not (xf.dtype == torch.float32 and s.dtype == torch.float32
            and q.dtype == (torch.int8 if w8 else torch.uint8)
            and q.device == x.device and s.device == x.device
            and q.dim() == 2 and s.dim() == 2 - w8 and s.shape[0] == o
            and xf.is_contiguous() and q.is_contiguous()
            and s.is_contiguous()):
        _refuse(xf, qw, w8, m, i, o)
    y = torch.empty((m, o), dtype=torch.float32, device=x.device)
    if m and o and i:
        _launch(xf, qw, y, qmm_plan(m, o, i, 8 if w8 else 4,
                                    i if w8 else i // s.shape[1]))
        if w8:
            quant_matmul.launches_w8 += 1
        else:
            quant_matmul.launches_w4 += 1
    elif m and o:
        y.zero_()                       # no inputs: the empty sum
    return y.reshape(lead + (o,))


def _refuse(xf, qw, w8, m, i, o):
    """Raise naming the tensor the kernel does not take."""
    s_shape = (o,) if w8 else (o, qw.s.shape[-1])
    for name, t, dt, shape in (
            ("x", xf, torch.float32, (m, i)),
            ("q", qw.q, torch.int8 if w8 else torch.uint8,
             (o, i if w8 else i // 2)),
            ("s", qw.s, torch.float32, s_shape)):
        if (t.dtype != dt or t.device != xf.device or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError("quant_matmul: %s must be a contiguous %s tensor "
                             "of shape %s on %s (got %s %s on %s)"
                             % (name, dt, shape, xf.device, t.dtype,
                                tuple(t.shape), t.device))


def _launch(xf, qw, y, plan, stamps=None):
    """One launch of the kernel on checked CUDA tensors, split as
    ``plan`` says; ``stamps``: an int64 tensor of ``STAMPS`` per block for
    :func:`qmm_phase_times`, or None."""
    w8 = isinstance(qw, QuantW8)
    (m, i), o = xf.shape, qw.q.shape[0]
    group = i if w8 else i // qw.s.shape[1]
    row_unit = 16 if w8 else 32       # inputs per 16 bytes of a code row
    lib = _lib()
    rc = lib.mxt_quant_matmul(
        xf.data_ptr(), qw.q.data_ptr(), qw.s.data_ptr(), y.data_ptr(),
        m, o, i, 8 if w8 else 4, group, plan.ks, plan.slice, plan.wch,
        plan.nt, int(plan.fold), int(plan.wg),
        int(i % 4 == 0 and xf.data_ptr() % 16 == 0),
        int(i % row_unit == 0 and qw.q.data_ptr() % 16 == 0),
        None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(xf.device).cuda_stream)
    _build.check(lib, rc, "quant_matmul")


#: the kernel's %globaltimer stamps a block, in order
STAMPS = ("start", "issued", "products", "sent", "barrier", "written")


def qmm_phase_times(x, qw, plan=None):
    """One launch on CUDA tensors ``x (M, I)`` (not counted in the launch
    counters) that stamps the card's global timer in every block.
    Returns ns: ``span`` from the first block's start to the last block's
    end, ``starts`` the spread of the blocks' starts, and for each phase
    that ends at a stamp (``issued``: the ring's first stages issued;
    ``products``: the K slice's products, its loads waited for;
    ``sent``: the partials sent to the ranks that sum them; ``barrier``:
    the cluster's barrier; ``written``: this block's share of y summed
    and written) its median and its largest over the blocks."""
    m, i = x.shape
    o = qw.q.shape[0]
    w8 = isinstance(qw, QuantW8)
    if plan is None:
        plan = qmm_plan(m, o, i, 8 if w8 else 4,
                        i if w8 else i // qw.s.shape[1])
    n = plan.blocks(m, o)
    stamps = torch.zeros(n * len(STAMPS), dtype=torch.int64,
                         device=x.device)
    y = torch.empty((m, o), dtype=torch.float32, device=x.device)
    _launch(x, qw, y, plan, stamps)
    st = stamps.view(n, len(STAMPS)).cpu()
    out = {"span": int(st[:, -1].max() - st[:, 0].min()),
           "starts": int(st[:, 0].max() - st[:, 0].min())}
    for k, name in enumerate(STAMPS[1:], 1):
        d = (st[:, k] - st[:, k - 1]).to(torch.float64)
        out[name] = (float(d.median()), int(d.max()))
    return out


quant_matmul.launches_w8 = 0
quant_matmul.launches_w4 = 0
