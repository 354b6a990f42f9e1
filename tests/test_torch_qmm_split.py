"""The arithmetic order of the quantized matmul kernels #8/#9
(``csrc/quant_matmul.cu:qmm_kernel``), emulated on the CPU, against the
JAX kernels ``_qmm8_kernel``/``_qmm4_kernel`` run by the Pallas
interpreter and against ``quant_matmul_reference``.

On the card ``qmm_plan`` cuts K into ``ks`` slices, one block of a
cluster each.  A block walks its slice in 128-input stages; its warps
take the 32-input chunks of a stage in turn (``4 / wch`` warps a channel
tile), and each chunk's products run on the tensor cores with the codes
as one tf32 piece and x as two, ``hi = tf32(x)`` and ``lo = tf32(x -
hi)``, each rounded as ``cvt.rna.tf32.f32`` rounds.  int8 sums the
products and multiplies by ``s[o]`` after the slices are summed; int4
with a group that is a multiple of 32 scales each chunk's products by
its group's scale and adds them to the warp's sum; any other group folds
the scale into the weight (``code * s`` in fp32, split like x, three
products).  The partial tiles are summed in cluster-rank order, each
rank's warps in order.  The emulation follows that order in fp32 torch;
within a chunk, torch's product stands for the tensor core's sums (their
order is the card's own and not emulated).

Widths: small analogues of a layer's GEMMs (O 48 to 96; I 96, 384, 192),
input dims no stage divides (int8 I 100; int4 I 200 and 98, whose groups
``w4_group`` shrinks to 8 and 2, and I 120 with group 40), slices of
several stages (I 1100 and 1280), and the full-width shapes with their
real plans.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import quant_matmul as jqmm
from mxnet_tpu_torch.ops.kernels import quant_matmul as tqmm

torch.set_num_threads(2)

# fp32 on both sides: XLA and torch sum the products of a dot in other
# orders, the emulation also splits them over chunks, warps and slices,
# and x's two tf32 pieces leave x - hi - lo within 2^-22 of x, so outputs
# of order 1 differ by a few ulps of their largest terms (ulp 1.2e-7 at
# 1, up to 1280 inputs): 2e-5 absolute and relative.  One tf32 piece of x
# (2^-11 of x) is off by far more
RTOL, ATOL = 2e-5, 2e-5


def tf32_rna(t):
    """fp32 ``t`` rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest on the magnitude's bits, ties away from zero (the kernel's
    integer add and mask)."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split(t):
    hi = tf32_rna(t)
    return hi, tf32_rna(t - hi)


def tf32_trunc(t):
    """What the tensor core reads of an fp32 word: its top 19 bits."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_trunc(t):
    """x as wgmma reads it: the word itself (truncated) and its residual
    x - tf32(x) (truncated in turn)."""
    hi = tf32_trunc(t)
    return hi, tf32_trunc(t - hi)


def codes_of(qw):
    """The integer codes (O, I) as fp32 (exact)."""
    if isinstance(qw, tqmm.QuantW8):
        return qw.q.to(torch.float32)
    return tqmm.unpack_int4(qw.q).to(torch.float32)


def qmm_emulate(x, qw, plan=None, pieces=2):
    """The kernel's y (M, O) in its order.  ``pieces`` 1 leaves out x's
    low tf32 piece."""
    w8 = isinstance(qw, tqmm.QuantW8)
    (m, i), o = x.shape, qw.q.shape[0]
    group = i if w8 else i // qw.s.shape[1]
    if plan is None:
        plan = tqmm.qmm_plan(m, o, i, 8 if w8 else 4, group)
    codes = codes_of(qw)
    xh, xl = (split_trunc if plan.wg else split)(x)
    if pieces == 1:
        xl = torch.zeros_like(xl)
    kw = 4 // plan.wch                     # warps splitting a stage
    parts = []
    for lo, hi in plan.slices(i):
        acc = [torch.zeros(m, o) for _ in range(kw)]
        for kst in range(lo, hi, tqmm.KSTAGE):
            for c in range(tqmm.KSTAGE // tqmm.KCHUNK):
                kc = kst + c * tqmm.KCHUNK
                if kc >= hi:
                    break
                ke = min(kc + tqmm.KCHUNK, hi)
                a, p = codes[:, kc:ke], c % kw
                bh, bl = xh[:, kc:ke], xl[:, kc:ke]
                if plan.fold:
                    sc = qw.s[:, torch.arange(kc, ke) // group]
                    ah, al = split(a * sc)
                    acc[p] = acc[p] + (bh @ ah.T + bl @ ah.T + bh @ al.T)
                elif w8:
                    acc[p] = acc[p] + (bh @ a.T + bl @ a.T)
                else:
                    part = bh @ a.T + bl @ a.T
                    acc[p] = acc[p] + qw.s[:, kc // group] * part
        parts.extend(acc)                  # rank order, then warp order
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y * qw.s if w8 else y


def _weights(seed, o, i):
    """Xavier-scaled weights with one all-zero row (scale 1)."""
    rng = np.random.default_rng(seed)
    w = ((rng.random((o, i)) * 2 - 1)
         * (6.0 / (o + i)) ** 0.5).astype(np.float32)
    w[3] = 0.0
    return w


def _both(fmt, w, group):
    """The JAX and the port's quantized weight: the port's codes and
    scales (equal to JAX's bit for bit, ``test_torch_quant_matmul.py``),
    handed to JAX as arrays, which spares a compile of JAX's quantizer at
    every shape."""
    tq = (tqmm.quantize_w8(torch.tensor(w)) if fmt == "w8"
          else tqmm.quantize_w4(torch.tensor(w), group))
    cls = jqmm.QuantW8 if fmt == "w8" else jqmm.QuantW4
    return cls(q=jnp.asarray(tq.q.numpy()), s=jnp.asarray(tq.s.numpy())), tq


# (fmt, O, I, group asked of quantize_w4, M)
SMALL = [("w8", 64, 96, None, 16), ("w4", 64, 96, 32, 16),
         ("w8", 96, 384, None, 1), ("w4", 96, 384, 128, 5),
         ("w8", 48, 192, None, 64), ("w4", 48, 192, 64, 64),
         ("w8", 48, 100, None, 16), ("w4", 48, 200, 128, 16),
         ("w4", 48, 98, 128, 3), ("w4", 48, 120, 40, 16)]


@pytest.mark.parametrize("fmt,o,i,group,m", SMALL)
def test_emulation_matches_jax_kernel(fmt, o, i, group, m):
    """The emulated kernel against the JAX kernel in Pallas interpret mode
    and the XLA reference; the same order with one tf32 piece of x falls
    outside the tolerance."""
    w = _weights(o + i, o, i)
    x = np.random.default_rng(m + i).standard_normal((m, i)).astype(
        np.float32)
    jq, tq = _both(fmt, w, group)
    ref = np.asarray(jqmm.quant_matmul_reference(jnp.asarray(x), jq))
    kern = np.asarray(jqmm._pallas_qmm(jnp.asarray(x), jq, interpret=True))
    got = qmm_emulate(torch.tensor(x), tq).numpy()
    np.testing.assert_allclose(got, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    one = qmm_emulate(torch.tensor(x), tq, pieces=1).numpy()
    assert not np.allclose(one, ref, rtol=RTOL, atol=ATOL)


# (fmt, O, I, group, M): slices of several stages, a grouped int4 among
# them, and the full-width shapes with their real plans
WIDE = [("w8", 48, 1100, None, 16), ("w4", 48, 1100, 128, 16),
        ("w4", 48, 1280, 128, 64),
        ("w8", 768, 3072, None, 16), ("w4", 768, 3072, 128, 64),
        ("w8", 3072, 768, None, 64), ("w4", 3072, 768, 128, 1),
        ("w8", 768, 768, None, 64), ("w4", 768, 192, 128, 16),
        ("w8", 768, 1536, None, 1)]


@pytest.mark.parametrize("fmt,o,i,group,m", WIDE)
def test_emulation_matches_reference_wide(fmt, o, i, group, m):
    w = _weights(o + i, o, i)
    x = np.random.default_rng(m + i).standard_normal((m, i)).astype(
        np.float32)
    jq, tq = _both(fmt, w, group)
    ref = np.asarray(jqmm.quant_matmul_reference(jnp.asarray(x), jq))
    got = qmm_emulate(torch.tensor(x), tq).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


PLAN_SHAPES = [(o, i) for o, i in ((768, 768), (3072, 768), (768, 3072),
                                   (768, 384), (768, 192), (768, 1536))]


@pytest.mark.parametrize("m", [1, 5, 16, 17, 64, 200])
@pytest.mark.parametrize("fmt,group", [(8, None), (4, 128), (4, 40),
                                       (4, 2)])
def test_plan_slices_cover_k_in_order(m, fmt, group):
    """Every plan's slices cover [0, I) in order, without overlap or an
    empty slice, at most 8 (a cluster), whole stages but the last; the
    fold follows the group; the grid's shapes keep the card busy."""
    rng = np.random.default_rng(m)
    dims = [i for _, i in PLAN_SHAPES] + [1, 2, 98, 100, 127, 128, 129,
                                          200, 1100]
    dims += rng.integers(1, 5000, 6).tolist()
    for i in dims:
        if fmt == 4 and i % 2:
            continue
        g = i if fmt == 8 else tqmm.w4_group(i, group)
        for o in (16, 48, 768, 3072):
            plan = tqmm.qmm_plan(m, o, i, fmt, g)
            sl = plan.slices(i)
            assert 1 <= plan.ks <= tqmm.CLUSTER_MAX == 8
            assert plan.slice % tqmm.KSTAGE == 0
            assert sl[0][0] == 0 and sl[-1][1] == i
            assert all(hi > lo for lo, hi in sl)
            assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
            assert all(hi - lo == plan.slice for lo, hi in sl[:-1])
            assert plan.fold == (fmt == 4 and g % tqmm.KCHUNK != 0)
            assert plan.nt in (1, 2, 4, 8) and (m > 16 or 8 * plan.nt >= m)
    # K split across at least two blocks wherever K has two stages;
    # wgmma above 16 rows; a layer's GEMMs at one token, a decode batch
    # and a prefill chunk take at least a block an SM
    for o, i in PLAN_SHAPES:
        plan = tqmm.qmm_plan(m, o, i, fmt, 128 if fmt == 4 else i)
        assert plan.ks >= 2
        assert plan.wg == (m > 16) and (not plan.wg or plan.wch == 4)
        if i >= 768 and m in (1, 16, 64):
            assert plan.blocks(m, o) >= 132
