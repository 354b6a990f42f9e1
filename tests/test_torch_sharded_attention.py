"""Port parity: ``mxnet_tpu_torch.ops.attention.flash_attention_sharded``
against the JAX package's ``flash_attention_sharded`` on the 8-device CPU
mesh of ``tests/conftest.py``, at (dp, tp) meshes of (2, 2) and (4, 2).

The port runs each (dp, tp) shard in turn (batch over dp, heads over tp)
and concatenates; on CPU tensors each shard takes the flash kernels'
plain version.  The JAX side runs ``shard_map`` over the mesh, whose
per-shard body on the CPU is its reference attention.  A plain causal
shard takes the port's causal route (the flash forward kernel with the
scale folded into q, where the JAX package takes the TPU's splash
kernel); dropout draws a different mask per shard from the seed mixed
with the shard index.  The causal route is one autograd function over
the whole tensors, each shard's launch reading and writing its views in
place: its output and gradients must equal, bit for bit, the per-shard
composition it replaced (contiguous slices, the scale folded into q,
the flash op, concatenation).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.parallel.shardcfg import ShardingConfig as JSharding
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa
from mxnet_tpu_torch.parallel import ShardingConfig

torch.set_num_threads(2)

B, H, L, D = 4, 4, 32, 8
MESHES = [(2, 2), (4, 2)]
# fp32 attention over 32 keys: the JAX reference's and the port's plain
# flash version sum in other orders (and the causal route folds the scale
# into q first), a few ulps on outputs of order 1
TOL = 1e-5


def _mask_kw(mask):
    if mask == "causal":
        return dict(causal=True)
    if mask == "window":
        return dict(window=5)
    return dict(kv_length=np.array([L, 0, 17, 9], np.int32))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, D)).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "dp%d-tp%d" % m)
@pytest.mark.parametrize("mask", ["causal", "window", "kv_length"])
def test_matches_jax_sharded(eight_devices, mesh, mask):
    q, k, v = _inputs()
    kw = _mask_kw(mask)
    jcfg = JSharding.for_transformer(mesh_shape=mesh, axis_names=("dp", "tp"))
    jkw = dict(kw)
    if "kv_length" in jkw:
        jkw["kv_length"] = jnp.asarray(jkw["kv_length"])
    want = jatt.flash_attention_sharded(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), cfg=jcfg, **jkw)
    cfg = ShardingConfig.for_transformer(mesh_shape=mesh,
                                         axis_names=("dp", "tp"))
    before = tatt.flash_attention_sharded.causal_shards
    got = tatt.flash_attention_sharded(torch.tensor(q), torch.tensor(k),
                                       torch.tensor(v), cfg, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    routed = tatt.flash_attention_sharded.causal_shards - before
    assert routed == (mesh[0] * mesh[1] if mask == "causal" else 0)
    if mask == "causal":
        assert tatt.last_path == "flash-causal-shard"
    if mask == "kv_length":
        assert not got[1].any()          # the row with no valid key is 0


@pytest.mark.parametrize("mask", ["causal", "window", "kv_length"])
def test_gradients_match_unsharded(mask):
    """Autograd through every shard's flash op equals autograd through the
    unsharded op (q, k, v gradients), at dropout 0."""
    q, k, v = _inputs(1)
    g = _inputs(2)[0]
    kw = _mask_kw(mask)
    cfg = ShardingConfig.for_transformer(mesh_shape=(2, 2),
                                         axis_names=("dp", "tp"))
    grads = []
    for fn in (lambda *a: tatt.flash_attention_sharded(*a, cfg, **kw),
               lambda *a: tatt.flash_attention(*a, **kw)):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        (fn(*ts) * torch.tensor(g)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def _dropout_masks(cfg, seed):
    """The kept (row, key) pairs of every (batch, head), read off the
    output: q = k = 0 gives every valid key the probability 1/L, and V = I
    (L = D) copies column j of the dropped probabilities into output
    column j."""
    n = 16
    zeros = torch.zeros(B, H, n, n)
    eye = torch.eye(n).expand(B, H, n, n).contiguous()
    out = tatt.flash_attention_sharded(zeros, zeros, eye, cfg, dropout=0.1,
                                       seed=seed)
    return out > 0


def test_dropout_masks_differ_between_shards_and_repeat():
    cfg = ShardingConfig.for_transformer(mesh_shape=(2, 2),
                                         axis_names=("dp", "tp"))
    m = _dropout_masks(cfg, 7)
    assert torch.equal(m, _dropout_masks(cfg, 7))
    assert torch.equal(m, _dropout_masks(cfg, torch.tensor([7])))
    assert not torch.equal(m, _dropout_masks(cfg, 8))
    # local (batch 0, head 0) of each of the four shards
    shards = [m[d * 2, t * 2] for d in range(2) for t in range(2)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(shards[i], shards[j]), (i, j)
    # about 10% dropped
    assert 0.05 < 1 - m.float().mean().item() < 0.15


def test_dropout_seed_mix():
    """The shard seed mix on ints and on int64 tensors agrees, and
    gives each shard of a mesh a different seed."""
    seeds = [tatt._fold_in(2 ** 32 - 1, i) for i in range(8)]
    assert len(set(seeds)) == 8 and all(0 <= s < 2 ** 32 for s in seeds)
    t = tatt._fold_in(torch.tensor([2 ** 32 - 1]), 5)
    assert int(t) == seeds[5]


def test_sequence_parallel_and_ragged_meshes_raise():
    q = torch.zeros(B, H, L, D)
    sp = ShardingConfig.for_transformer(mesh_shape=(1, 2, 2),
                                        axis_names=("dp", "tp", "sp"))
    with pytest.raises(NotImplementedError, match="ring"):
        tatt.flash_attention_sharded(q, q, q, sp, causal=True)
    odd = ShardingConfig.for_transformer(mesh_shape=(1, 3),
                                         axis_names=("dp", "tp"))
    with pytest.raises(ValueError, match="divide"):
        tatt.flash_attention_sharded(q, q, q, odd)


def test_causal_route_launches_nothing_on_the_cpu():
    q = torch.zeros(B, H, L, D)
    cfg = ShardingConfig.for_transformer(mesh_shape=(2, 2),
                                         axis_names=("dp", "tp"))
    before = tfa.flash_attention.launches_fwd
    tatt.flash_attention_sharded(q, q, q, cfg, causal=True)
    assert tfa.flash_attention.launches_fwd == before


def _per_shard_causal(q, k, v, dp, tp):
    """The causal route composed per shard: contiguous slices, the scale
    folded into q in q's dtype, the flash op with ``causal=True``, then a
    concat over heads and one over the batch."""
    Bl, Hl = q.shape[0] // dp, q.shape[1] // tp
    s = 1.0 / math.sqrt(q.shape[-1])
    rows = []
    for d in range(dp):
        heads = []
        for t in range(tp):
            qs, ks, vs = (x[d * Bl:(d + 1) * Bl, t * Hl:(t + 1) * Hl]
                          for x in (q, k, v))
            heads.append(tfa.flash_attention((qs * s).to(qs.dtype), ks, vs,
                                             causal=True, scale=1.0))
        rows.append(torch.cat(heads, dim=1))
    return torch.cat(rows, dim=0)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)],
                         ids=lambda m: "dp%d-tp%d" % m)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_route_equals_per_shard_composition(mesh, dtype):
    """The in-place causal route's output and q, k, v gradients equal the
    per-shard composition's exactly (``torch.equal``), and each call
    counts dp * tp causal shards."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a).to(tdt) for a in _inputs(3))
    g = torch.tensor(_inputs(4)[0]).to(tdt)
    cfg = ShardingConfig.for_transformer(mesh_shape=mesh,
                                         axis_names=("dp", "tp"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tatt.flash_attention_sharded.causal_shards
    out = tatt.flash_attention_sharded(*leaves, cfg, causal=True)
    assert (tatt.flash_attention_sharded.causal_shards - before
            == mesh[0] * mesh[1])
    assert tatt.last_path == "flash-causal-shard" and out.dtype == tdt
    grads = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = _per_shard_causal(*ref_leaves, *mesh)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    assert torch.equal(out, ref)
    for got, want in zip(grads, ref_grads):
        assert got.dtype == tdt and torch.equal(got, want)


def _within(t, parent):
    """Whether the view ``t`` lies inside ``parent``'s storage."""
    lo = parent.untyped_storage().data_ptr()
    hi = lo + parent.untyped_storage().nbytes()
    return lo <= t.data_ptr() < hi


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_route_backward_reads_and_writes_views(monkeypatch, dtype):
    """The route's backward hands the backward kernels' wrappers each
    shard's views of the whole q, k, v, gradient, lse and delta, not
    copies, and output views inside one dq, dk and dv, which it returns:
    dp * tp calls of each wrapper, no copy or slice assignment."""
    tdt = getattr(torch, dtype)
    calls = {"dq": [], "dkv": []}
    dq_fn, dkv_fn = tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv

    def dq(*args, **kw):
        calls["dq"].append((args, kw))
        return dq_fn(*args, **kw)

    def dkv(*args, **kw):
        calls["dkv"].append((args, kw))
        return dkv_fn(*args, **kw)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq", dq)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkv", dkv)
    leaves = [torch.tensor(a).to(tdt).requires_grad_() for a in _inputs(5)]
    g = torch.tensor(_inputs(6)[0]).to(tdt)
    cfg = ShardingConfig.for_transformer(mesh_shape=(2, 2),
                                         axis_names=("dp", "tp"))
    out = tatt.flash_attention_sharded(*leaves, cfg, causal=True)
    grads = torch.autograd.grad(out, leaves, g)
    assert len(calls["dq"]) == len(calls["dkv"]) == 4
    for name, outs in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
        for args, kw in calls[name]:
            q, k, v, do, lse, delta = args
            assert q.shape == (B // 2, H // 2, L, D)
            # the shards' views, read where they lie
            assert not any(t.is_contiguous() for t in args)
            for t, whole in zip(args[1:4], (leaves[1], leaves[2], g)):
                assert _within(t, whole)
            assert lse.dtype == delta.dtype == torch.float32
            # written in place into views of the returned gradients
            for o in outs:
                assert not kw[o].is_contiguous()
            got = [kw[o] for o in outs]
            want = grads[:1] if name == "dq" else grads[1:]
            for o, whole in zip(got, want):
                assert _within(o, whole)
