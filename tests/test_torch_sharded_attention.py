"""Port parity: ``mxnet_tpu_torch.ops.attention.flash_attention_sharded``
against the JAX package's ``flash_attention_sharded`` on the 8-device CPU
mesh of ``tests/conftest.py``, at (dp, tp) meshes of (2, 2) and (4, 2).

Under a window, dropout or ``kv_length`` the port runs each (dp, tp)
shard in turn (batch over dp, heads over tp) and concatenates; on CPU
tensors each shard takes the flash kernels' plain version.  The JAX side runs ``shard_map`` over the mesh, whose
per-shard body on the CPU is its reference attention.  Plain causal
attention takes the port's causal route, where the JAX package takes the
TPU's splash kernel per shard: one call of the flash op over the whole
tensors, since causal attention is independent per (batch, head) and the
shards tile (batch, heads).  Its output and gradients must equal, bit
for bit, the per-shard composition (contiguous slices, the flash op with
the scale, concatenation), and, where the scale is a power of two (D 16,
s = 1/4), the composition the route ran before, which folded the scale
into q in q's dtype.  Dropout draws a different mask per shard from the
seed mixed with the shard index.
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
# flash version sum in other orders, a few ulps on outputs of order 1
TOL = 1e-5


def _mask_kw(mask):
    if mask == "causal":
        return dict(causal=True)
    if mask == "window":
        return dict(window=5)
    return dict(kv_length=np.array([L, 0, 17, 9], np.int32))


def _inputs(seed=0, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, L, d)).astype(np.float32)
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


def _per_shard_causal(q, k, v, dp, tp, fold_scale=False):
    """Causal attention composed per shard: contiguous slices, the flash op
    with ``causal=True`` and the scale, then a concat over heads and one
    over the batch.  ``fold_scale``: the composition the route ran until
    it became one call, the scale folded into q in q's dtype and the op
    run at scale 1."""
    Bl, Hl = q.shape[0] // dp, q.shape[1] // tp
    s = 1.0 / math.sqrt(q.shape[-1])
    rows = []
    for d in range(dp):
        heads = []
        for t in range(tp):
            qs, ks, vs = (x[d * Bl:(d + 1) * Bl, t * Hl:(t + 1) * Hl]
                          for x in (q, k, v))
            if fold_scale:
                heads.append(tfa.flash_attention(
                    (qs * s).to(qs.dtype), ks, vs, causal=True, scale=1.0))
            else:
                heads.append(tfa.flash_attention(qs, ks, vs, causal=True,
                                                 scale=s))
        rows.append(torch.cat(heads, dim=1))
    return torch.cat(rows, dim=0)


def _route_and_composition(mesh, dtype, d, fold_scale):
    """The route's output and q, k, v gradients, and the composition's."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a).to(tdt) for a in _inputs(3, d))
    g = torch.tensor(_inputs(4, d)[0]).to(tdt)
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
    ref = _per_shard_causal(*ref_leaves, *mesh, fold_scale=fold_scale)
    ref_grads = torch.autograd.grad(ref, ref_leaves, g)
    return (out, grads), (ref, ref_grads)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)],
                         ids=lambda m: "dp%d-tp%d" % m)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_route_equals_per_shard_composition(mesh, dtype):
    """The causal route's output and q, k, v gradients equal the
    per-shard composition's exactly (``torch.equal``) at D 8, where the
    scale 1/sqrt(8) is no power of two, and each call counts dp * tp
    causal shards."""
    (out, grads), (ref, ref_grads) = _route_and_composition(mesh, dtype, D,
                                                            False)
    assert torch.equal(out, ref)
    for got, want in zip(grads, ref_grads):
        assert got.dtype == out.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_route_equals_folded_scale_composition(dtype):
    """At D 16 the scale 1/4 is a power of two, so the scale applied in
    fp32 inside the op and the scale folded into q in q's dtype give the
    same bits: the route equals, bit for bit, the per-shard composition it
    ran before it became one call (as at the card's D 64, s = 1/8)."""
    (out, grads), (ref, ref_grads) = _route_and_composition((2, 2), dtype,
                                                            16, True)
    assert torch.equal(out, ref)
    for got, want in zip(grads, ref_grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "dp%d-tp%d" % m)
def test_causal_route_counts_its_launches(monkeypatch, mesh):
    """The route's ``launches`` counts the forward kernel's launches its
    call made, and nothing else: none on the CPU, where the op runs its
    plain version, and exactly one where the op launches (a stand-in op
    that counts one launch, as the wrapper does on the card).  The dp * tp
    shards the call stands for are counted apart, in ``causal_shards``."""
    q, k, v = (torch.tensor(a) for a in _inputs(7))
    cfg = ShardingConfig.for_transformer(mesh_shape=mesh,
                                         axis_names=("dp", "tp"))
    route = tatt.flash_attention_sharded
    n0, c0 = route.launches, route.causal_shards
    route(q, k, v, cfg, causal=True)
    assert (route.launches - n0, route.causal_shards - c0) == (
        0, mesh[0] * mesh[1])
    real = tfa.flash_attention

    def one_launch(*args, **kw):
        one_launch.launches_fwd += 1
        return real(*args, **kw)
    one_launch.launches_fwd = real.launches_fwd
    monkeypatch.setattr(tfa, "flash_attention", one_launch)
    n0, c0 = route.launches, route.causal_shards
    route(q, k, v, cfg, causal=True)
    route(q, k, v, cfg, window=5)         # the per-shard route adds nothing
    assert (route.launches - n0, route.causal_shards - c0) == (
        1, mesh[0] * mesh[1])


def _same_storage(t, whole):
    """Whether ``t`` is ``whole``'s data itself: the same storage, offset
    and shape, so no copy."""
    return (t.data_ptr() == whole.data_ptr() and t.shape == whole.shape
            and t.stride() == whole.stride())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_route_backward_reads_and_writes_views(monkeypatch, dtype):
    """The route's backward calls the delta, dq and dkv wrappers once
    each, on the whole q, k, v and output gradient as they are (no slice,
    no copy), and returns what they return: dq, dk and dv of one call."""
    tdt = getattr(torch, dtype)
    calls = {"delta": [], "dq": [], "dkv": []}
    wrapped = {"delta": tfa.flash_attention_bwd_delta,
               "dq": tfa.flash_attention_bwd_dq,
               "dkv": tfa.flash_attention_bwd_dkv}

    def spy(name):
        def fn(*args, **kw):
            r = wrapped[name](*args, **kw)
            calls[name].append((args, kw, r))
            return r
        return fn
    for name in wrapped:
        monkeypatch.setattr(tfa, "flash_attention_bwd_" + name, spy(name))
    leaves = [torch.tensor(a).to(tdt).requires_grad_() for a in _inputs(5)]
    g = torch.tensor(_inputs(6)[0]).to(tdt)
    cfg = ShardingConfig.for_transformer(mesh_shape=(2, 2),
                                         axis_names=("dp", "tp"))
    out = tatt.flash_attention_sharded(*leaves, cfg, causal=True)
    grads = torch.autograd.grad(out, leaves, g)
    assert [len(c) for c in calls.values()] == [1, 1, 1]
    (do, o), _, delta = calls["delta"][0]
    assert _same_storage(do, g) and _same_storage(o, out)
    assert delta.shape == (B, H, L) and delta.dtype == torch.float32
    for name in ("dq", "dkv"):
        args, _, _ = calls[name][0]
        for t, whole in zip(args[:4], (*leaves, g)):
            assert _same_storage(t, whole)
        assert args[5] is delta
    assert grads[0].data_ptr() == calls["dq"][0][2].data_ptr()
    for got, r in zip(grads[1:], calls["dkv"][0][2]):
        assert got.data_ptr() == r.data_ptr()
