"""The split-key attention of the tensor-parallel attention phase kernel
#13 (``csrc/decode_phase.cu``, ``csrc/decode_common.cuh:split_attend`` and
``split_merge``), its arithmetic emulated on the CPU, against the JAX
kernel ``_decode_attn_phase_kernel`` run by the Pallas interpreter.

On the card a row's keys are cut into chunks of 64; each (row, KV head,
chunk) unit gives each of its 8 warps 8 consecutive keys, each warp takes
the max, the exponentials, their sum and P V over its keys for every
query head of the group, and the block combines its warps in warp order
at the largest max into the chunk's (m, l, unnormalised o).  After a grid
barrier each (row, head) merges its chunks in chunk order: o = sum_c o_c
exp(m_c - m) / sum_c l_c exp(m_c - m).  A row of length 0 has no chunk
and gives 0.  The emulation below follows that order in fp32 torch; the
projections, the append and the out-projection are the plain version's.

Geometry: head dim 8, page size 16, lengths {0, 1, 63, 64, 65, 512} (no
key, one, each side of a chunk boundary, the longest row), tp 2 and 4,
one query head a KV head (g = 1) and three (g = 3).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from mxnet_tpu.models import decoder as jdec
from mxnet_tpu.ops.pallas import fused_cell as jfc
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa

torch.set_num_threads(2)

D, S = 8, 16
CHUNK, WARP_KEYS = 64, 8           # csrc/decode_common.cuh: SPLIT_KEYS, ..
LENGTHS = (0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 512)
PPS = 512 // S
# fp32 on both sides over at most 512 keys: the JAX kernel's two-pass
# softmax and the emulated chunks' running maxima and rescales round
# differently, and XLA and torch sum the projections in other orders.
# o_part's elements (up to ~5 in size) sum 32 to 96 such terms, so an
# element that cancels to near 0 keeps the few-ulp error of its largest
# terms (ulp 4.8e-7 at 4): 1e-5 absolute; a merge without its rescale is
# off by far more
RTOL, ATOL = 1e-5, 1e-5
CASES = [(8, 8, 2), (8, 8, 4), (12, 4, 2), (12, 4, 4)]   # (H, KVH, tp)


def split_attention(q, kp, vp, tables, lengths, rescale=True):
    """The card's split-key attention: q (B, H, D) unscaled, kp/vp (KVH, P,
    S, D) with this step's appends, tables (B, pps), lengths (B,) ->
    (B, H, D).  ``rescale=False`` merges the chunks without their
    exp(m_c - m) factors (a wrong merge, which the tolerance must
    catch)."""
    B, H, _ = q.shape
    KVH = kp.shape[0]
    g = H // KVH
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = int(lengths[b])
        t = torch.arange(n)
        slots = (torch.as_tensor(tables[b])[t // S].long(), t % S)
        for kvh in range(KVH):
            qs = q[b, kvh * g:(kvh + 1) * g] * (1.0 / D ** 0.5)   # (g, D)
            keys, vals = kp[kvh][slots], vp[kvh][slots]            # (n, D)
            chunks = []
            for t0 in range(0, n, CHUNK):
                warps = []
                for w0 in range(t0, min(t0 + CHUNK, n), WARP_KEYS):
                    k = keys[w0:min(w0 + WARP_KEYS, n)]
                    v = vals[w0:min(w0 + WARP_KEYS, n)]
                    s = qs @ k.T                                   # (g, nk)
                    m = s.max(-1).values
                    p = torch.exp(s - m[:, None])
                    warps.append((m, p.sum(-1), p @ v))
                # warps with no key add exp(-inf) = 0: left out here
                m = torch.stack([w[0] for w in warps]).max(0).values
                o, l = torch.zeros(g, D), torch.zeros(g)
                for mw, lw, ow in warps:                          # warp order
                    a = torch.exp(mw - m)
                    o = o + ow * a[:, None]
                    l = l + lw * a
                chunks.append((m, l, o))
            if not chunks:
                continue
            m = torch.stack([c[0] for c in chunks]).max(0).values
            o, l = torch.zeros(g, D), torch.zeros(g)
            for mc, lc, oc in chunks:                             # chunk order
                a = torch.exp(mc - m) if rescale else torch.ones(g)
                o = o + oc * a[:, None]
                l = l + lc * a
            out[b, kvh * g:(kvh + 1) * g] = o / l[:, None]
    return out


def _state(H, KVH, seed=0):
    """Weights, pages and one step's meta, tables and lengths (each row's
    pages distinct, the inactive row writing the scratch page 0)."""
    rng = np.random.default_rng(seed)
    C, B = H * D, len(LENGTHS)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    weights = {"wq": w(C, C), "bq": w(C), "wk": w(KVH * D, C),
               "bk": w(KVH * D), "wv": w(KVH * D, C), "bv": w(KVH * D),
               "wo": w(C, C)}
    need = [-(-n // S) for n in LENGTHS]
    total = 1 + sum(need)
    pages = rng.permutation(np.arange(1, total))
    tables = np.zeros((B, PPS), np.int32)
    k = 0
    for b, n in enumerate(need):
        tables[b, :n] = pages[k:k + n]
        k += n
    lengths = np.array(LENGTHS, np.int32)
    pos = np.maximum(lengths - 1, 0)
    act = lengths > 0
    wp = np.where(act, tables[np.arange(B), pos // S], 0).astype(np.int32)
    ws = np.where(act, pos % S, 0).astype(np.int32)
    kp = (rng.standard_normal((KVH, total, S, D)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal(kp.shape) * 0.5).astype(np.float32)
    x = rng.standard_normal((B, C)).astype(np.float32)
    return weights, x, kp, vp, np.stack([wp, ws]), tables, lengths


def _shard(full, tp, r):
    out = {}
    for k in ("wq", "bq", "wk", "bk", "wv", "bv"):
        n = full[k].shape[0] // tp
        out[k] = np.ascontiguousarray(full[k][r * n:(r + 1) * n])
    n = full["wo"].shape[1] // tp
    out["wo"] = np.ascontiguousarray(full["wo"][:, r * n:(r + 1) * n])
    return out


def _split_phase(x, kp, vp, lp, meta, tables, lengths, H, KVH,
                 rescale=True):
    """#13 with the emulated split attention: (pages, o_part)."""
    B = x.shape[0]
    x, kp, vp = torch.tensor(x), torch.tensor(kp), torch.tensor(vp)
    lp = {k: torch.tensor(v) for k, v in lp.items()}
    q = F.linear(x, lp["wq"], lp["bq"]).reshape(B, H, D)
    k = F.linear(x, lp["wk"], lp["bk"]).reshape(B, KVH, D)
    v = F.linear(x, lp["wv"], lp["bv"]).reshape(B, KVH, D)
    wp, ws = torch.tensor(meta[0]).long(), torch.tensor(meta[1]).long()
    kp[:, wp, ws] = k.transpose(0, 1)
    vp[:, wp, ws] = v.transpose(0, 1)
    att = split_attention(q, kp, vp, tables, lengths, rescale)
    return kp, vp, F.linear(att.reshape(B, H * D), lp["wo"])


def _jax_phase(x, kp, vp, lp, meta, tables, lengths, H, KVH):
    B = x.shape[0]
    cfg = jdec.DecoderConfig(vocab_size=64, num_layers=1, units=x.shape[1],
                             hidden_size=16, num_heads=H, num_kv_heads=KVH,
                             head_dim=D, max_length=512)
    return jfc.decode_attn_phase(
        jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(meta),
        jnp.asarray(tables), jnp.asarray(lengths.reshape(B, 1)), cfg,
        "interpret")


@pytest.mark.parametrize("H,KVH,tp", CASES)
def test_split_attention_matches_jax_interpret(H, KVH, tp):
    """The first and last shard's o_part and pages from the emulated split
    attention against the JAX kernel in interpret mode; the length-0 row
    gives 0, and a merge without the chunks' rescale is caught by the
    tolerance."""
    full, x, kp, vp, meta, tables, lengths = _state(H, KVH)
    n = KVH // tp
    for r in (0, tp - 1):                     # the first and the last shard
        lp = _shard(full, tp, r)
        slab = slice(r * n, (r + 1) * n)
        args = (x, kp[slab], vp[slab], lp, meta, tables, lengths, H // tp,
                n)
        jkp, jvp, jo = _jax_phase(*args)
        tkp, tvp, to = _split_phase(*args)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)
        for got, want in ((tkp, jkp), (tvp, jvp)):
            np.testing.assert_allclose(got.numpy()[:, 1:],
                                       np.asarray(want)[:, 1:], rtol=RTOL,
                                       atol=1e-6)
        assert not to[0].any()                    # length 0: no chunk
        if r == 0:
            _, _, bad = _split_phase(*args, rescale=False)
            assert not np.allclose(bad.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("g", [1, 3])
def test_split_equals_plain_paged_attention(g):
    """At random lengths up to 512 the emulated split equals the port's
    plain paged attention (the two-pass softmax over each row's pages)
    within the same tolerance."""
    rng = np.random.default_rng(7 + g)
    KVH, B = 2, 5
    lengths = rng.integers(0, 513, B).astype(np.int32)
    need = [-(-int(n) // S) for n in lengths]
    total = 1 + sum(need)
    pages = rng.permutation(np.arange(1, total))
    tables = np.zeros((B, PPS), np.int32)
    k = 0
    for b, n in enumerate(need):
        tables[b, :n] = pages[k:k + n]
        k += n
    kp = torch.tensor(rng.standard_normal((KVH, total, S, D)),
                      dtype=torch.float32)
    vp = torch.tensor(rng.standard_normal((KVH, total, S, D)),
                      dtype=torch.float32)
    q = torch.tensor(rng.standard_normal((B, KVH * g, D)),
                     dtype=torch.float32)
    got = split_attention(q, kp, vp, tables, lengths)
    want = tpa.paged_attention_reference(q, kp, vp, torch.tensor(lengths),
                                         torch.tensor(tables))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
