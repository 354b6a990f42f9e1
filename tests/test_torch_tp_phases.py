"""Port parity: the tensor-parallel decode phases of
``mxnet_tpu_torch.ops.kernels.fused_cell`` (``decode_attn_phase`` and
``decode_ffn_phase``, their plain versions, which CPU tensors take) against
the JAX ``fused_cell.decode_attn_phase(..., mode="interpret")`` and
``decode_ffn_phase(..., "interpret")`` -- the Pallas kernels #13 and #14 run
by the interpreter -- called directly on one shard's numpy operands.

Geometry: units 32, head dim 8, FFN 64, page size 8, 16 pages, 4 slots of
which one is inactive (length 0, writing the scratch page 0), at tp 2 and
4 with heads = KV heads = 4, and at GQA (4 heads over 2 KV heads) at tp 2.
Each shard's operands are the Megatron slices of one set of random
weights: column shards of wq/wk/wv/w1 and their biases, row shards of
wo/w2.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from mxnet_tpu.models import decoder as jdec
from mxnet_tpu.ops.pallas import fused_cell as jfc
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import fused_cell as tfc
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa

torch.set_num_threads(2)

C, D, FF, S, TOTAL, PPS, B = 32, 8, 64, 8, 16, 4, 4
# fp32 on both sides; the projections and the softmax sum in other orders
# in XLA and in PyTorch, so outputs of order 1 differ by a few ulps
RTOL = 1e-5
CASES = [(4, 4, 2), (4, 4, 4), (4, 2, 2)]     # (heads, KV heads, tp)


def _weights(H, KVH, seed=0):
    rng = np.random.default_rng(seed)
    kvc = KVH * D

    def w(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    return {"wq": w(C, C), "bq": w(C), "wk": w(kvc, C), "bk": w(kvc),
            "wv": w(kvc, C), "bv": w(kvc), "wo": w(C, C), "bo": w(C),
            "w1": w(FF, C), "b1": w(FF), "w2": w(C, FF), "b2": w(C)}


def _shard(full, tp, r):
    """Shard ``r``'s leaves: contiguous row slices of the column-parallel
    leaves, column slices of wo and w2."""
    out = {}
    for k in ("wq", "bq", "wk", "bk", "wv", "bv", "w1", "b1"):
        n = full[k].shape[0] // tp
        out[k] = np.ascontiguousarray(full[k][r * n:(r + 1) * n])
    for k in ("wo", "w2"):
        n = full[k].shape[1] // tp
        out[k] = np.ascontiguousarray(full[k][:, r * n:(r + 1) * n])
    return out


def _state(KVH, seed=1):
    """Pages, activations and one step's meta/tables/lengths: rows 0-2
    active at positions 9, 3, 11 (their pages distinct), row 3 inactive."""
    rng = np.random.default_rng(seed)
    kp = (rng.standard_normal((KVH, TOTAL, S, D)) * 0.2).astype(np.float32)
    vp = (rng.standard_normal(kp.shape) * 0.2).astype(np.float32)
    x = rng.standard_normal((B, C)).astype(np.float32)
    tables = np.zeros((B, PPS), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, 0] = 3
    tables[2, :2] = [4, 5]
    pos = np.array([9, 3, 11, 0], np.int32)
    act = np.array([True, True, True, False])
    wp = np.where(act, tables[np.arange(B), pos // S], 0).astype(np.int32)
    ws = np.where(act, pos % S, 0).astype(np.int32)
    lengths = np.where(act, pos + 1, 0).astype(np.int32)
    return x, kp, vp, np.stack([wp, ws]), tables, lengths


def _local_cfgs(H, KVH, tp):
    kw = dict(vocab_size=64, num_layers=1, units=C, hidden_size=FF // tp,
              num_heads=H // tp, num_kv_heads=KVH // tp, head_dim=D,
              max_length=64)
    return jdec.DecoderConfig(**kw), tdec.DecoderConfig(**kw)


def _t(d):
    return {k: torch.tensor(v) for k, v in d.items()}


@pytest.mark.parametrize("H,KVH,tp", CASES)
def test_attn_phase_matches_jax_interpret(H, KVH, tp):
    full = _weights(H, KVH)
    x, kp, vp, meta, tables, lengths = _state(KVH)
    jcfg, tcfg = _local_cfgs(H, KVH, tp)
    n = KVH // tp
    for r in range(tp):
        lp = _shard(full, tp, r)
        slab = slice(r * n, (r + 1) * n)
        jkp, jvp, jo = jfc.decode_attn_phase(
            jnp.asarray(x), jnp.asarray(kp[slab]), jnp.asarray(vp[slab]),
            {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(meta),
            jnp.asarray(tables), jnp.asarray(lengths[:, None]), jcfg,
            "interpret")
        tkp, tvp = torch.tensor(kp[slab]), torch.tensor(vp[slab])
        rkp, rvp, to = tfc.decode_attn_phase(
            torch.tensor(x), tkp, tvp, _t(lp), torch.tensor(meta),
            torch.tensor(tables), torch.tensor(lengths), tcfg)
        assert rkp is tkp and rvp is tvp                 # updated in place
        # the append wrote every active row's slot; every other slot of
        # the slab is untouched, in both packages, bit for bit
        written = np.zeros(kp[slab].shape[1:3], bool)
        written[meta[0], meta[1]] = True
        for got, want, before in ((tkp, jkp, kp[slab]), (tvp, jvp, vp[slab])):
            got, want = got.numpy(), np.asarray(want)
            assert np.array_equal(got[:, ~written], before[:, ~written])
            assert np.array_equal(want[:, ~written], before[:, ~written])
            # the new k/v: one projection of 32 inputs, summed in another
            # order by XLA's dot and by torch's, so within an ulp or two
            np.testing.assert_allclose(got[:, written], want[:, written],
                                       rtol=RTOL, atol=1e-6)
        assert to.dtype == torch.float32 and to.shape == (B, C)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=1e-6)
        # the inactive row reads nothing: its partial product is 0
        assert not to[3].any()


@pytest.mark.parametrize("H,KVH,tp", CASES)
def test_ffn_phase_matches_jax_interpret(H, KVH, tp):
    full = _weights(H, KVH)
    x = _state(KVH)[0]
    for r in range(tp):
        lp = _shard(full, tp, r)
        jf = jfc.decode_ffn_phase(jnp.asarray(x), jnp.asarray(lp["w1"]),
                                  jnp.asarray(lp["b1"]),
                                  jnp.asarray(lp["w2"]), "interpret")
        tf = tfc.decode_ffn_phase(torch.tensor(x), torch.tensor(lp["w1"]),
                                  torch.tensor(lp["b1"]),
                                  torch.tensor(lp["w2"]))
        assert tf.dtype == torch.float32 and tf.shape == (B, C)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.parametrize("H,KVH,tp", CASES)
def test_shard_partials_sum_to_the_unsharded_layer(H, KVH, tp):
    """The shards' o_part summed in shard order plus bo equals the
    unsharded layer's out-projection, and their f_part plus b2 its FFN;
    the shards' appends together equal the unsharded append."""
    full = _weights(H, KVH)
    x, kp, vp, meta, tables, lengths = _state(KVH)
    _, tcfg = _local_cfgs(H, KVH, tp)
    tx, tm, tt, tl = (torch.tensor(a) for a in (x, meta, tables, lengths))
    tfull = _t(full)
    n = KVH // tp
    kp_s, vp_s = torch.tensor(kp), torch.tensor(vp)
    o_parts, f_parts = [], []
    for r in range(tp):
        lp = _t(_shard(full, tp, r))
        slab = slice(r * n, (r + 1) * n)
        o_parts.append(tfc.decode_attn_phase(tx, kp_s[slab], vp_s[slab], lp,
                                             tm, tt, tl, tcfg)[2])
        f_parts.append(tfc.decode_ffn_phase(tx, lp["w1"], lp["b1"],
                                            lp["w2"]))
    o = tdec._all_reduce(o_parts) + tfull["bo"]
    f = tdec._all_reduce(f_parts) + tfull["b2"]

    kp_u, vp_u = torch.tensor(kp), torch.tensor(vp)
    q = F.linear(tx, tfull["wq"], tfull["bq"]).reshape(B, H, D)
    k = F.linear(tx, tfull["wk"], tfull["bk"]).reshape(B, KVH, D)
    v = F.linear(tx, tfull["wv"], tfull["bv"]).reshape(B, KVH, D)
    kp_u[:, tm[0].long(), tm[1].long()] = k.transpose(0, 1)
    vp_u[:, tm[0].long(), tm[1].long()] = v.transpose(0, 1)
    att = tpa.paged_attention_reference(q, kp_u, vp_u, tl, tt)
    o_ref = F.linear(att.reshape(B, C), tfull["wo"], tfull["bo"])
    f_ref = F.linear(F.gelu(F.linear(tx, tfull["w1"], tfull["b1"])),
                     tfull["w2"], tfull["b2"])
    # the same products, their sums split at shard boundaries
    torch.testing.assert_close(o, o_ref, rtol=RTOL, atol=1e-6)
    torch.testing.assert_close(f, f_ref, rtol=RTOL, atol=1e-6)
    # each shard's slice of the projections lands where the whole does
    torch.testing.assert_close(kp_s, kp_u, rtol=RTOL, atol=1e-6)
    torch.testing.assert_close(vp_s, vp_u, rtol=RTOL, atol=1e-6)


def test_cpu_tensors_launch_nothing():
    full = _weights(4, 4)
    x, kp, vp, meta, tables, lengths = _state(4)
    _, tcfg = _local_cfgs(4, 4, 2)
    lp = _t(_shard(full, 2, 0))
    a0, f0 = tfc.decode_attn_phase.launches, tfc.decode_ffn_phase.launches
    tfc.decode_attn_phase(torch.tensor(x), torch.tensor(kp[:2]),
                          torch.tensor(vp[:2]), lp, torch.tensor(meta),
                          torch.tensor(tables), torch.tensor(lengths), tcfg)
    tfc.decode_ffn_phase(torch.tensor(x), lp["w1"], lp["b1"], lp["w2"])
    assert tfc.decode_attn_phase.launches == a0
    assert tfc.decode_ffn_phase.launches == f0


def test_unsupported_device_raises():
    x = torch.zeros(B, C, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfc.decode_ffn_phase(x, x, x[0], x)
