"""Port parity: quantized serving under tensor parallelism.
``mxnet_tpu_torch``'s int8/int4 weights and int8 KV pages under
``DecodeEngine(sharding=)`` against the JAX package's on the 8-device CPU
mesh of ``tests/conftest.py``, at a (dp, tp) = (4, 2) mesh as
``tests/test_quantized_serving.py::test_quantized_engine_tensor_parallel``
runs it (and (2, 4) for the tp 4 shards).

The model is the JAX ``decoder_tiny_lm(seed=0)`` (vocab 128, 2 layers,
units 64, FFN 128, 4 heads over 2 KV heads; 4 KV heads for tp 4) with
random biases and LN affines, carried across by ``params_from_jax``.

- ``quantize_params(tp=)`` gives the JAX codes, scales and int4 groups
  bit for bit, and ``TPPlan.shard_params`` cuts them as the JAX plan's
  ``place_params`` places them (``addressable_shards``), bit for bit;
- a loaded int4 model serves only the tp it was quantized at.

The decode step and the engine under tensor parallelism are
``test_torch_quantized_tp_engine.py``'s, which takes this file's
constants and ``models`` fixture.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import decoder as jdec
from mxnet_tpu.parallel.shardcfg import ShardingConfig as JSharding
from mxnet_tpu.serving import quantize as jquant
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import quant_matmul as tqm
from mxnet_tpu_torch.parallel import ShardingConfig
from mxnet_tpu_torch.serving import DecodeEngine, quantize_lm
from mxnet_tpu_torch.serving import quantize as tquant
from torch_parity import tiny_lm_with_affine

torch.set_num_threads(2)

ENGINE = dict(slots=3, page_size=4, max_ctx=40, total_pages=13,
              prefill_chunk=8)
# prompts past the prefill chunk, and a pool this traffic exhausts
# (preemption by recompute)
PROMPT_LENS = (3, 11, 20, 7)
MAX_NEW = (10, 9, 8, 12)
MESH = dict(mesh_shape=(4, 2), axis_names=("dp", "tp"))
MESH4 = dict(mesh_shape=(2, 4), axis_names=("dp", "tp"))
# one decode step's logits at tp 2 against tp 1 on the same integer
# weights: fp32, the row-parallel sums in another order (the fp TP band of
# tests/test_torch_tp_serving.py)
TOL_LOGITS = 1e-4
# a stream may leave the JAX engine's only where the port's own top-2
# logits are this close (test_torch_quantized_serving.py's near-tie)
TIE = 1e-4
# (weights, int4 group, KV dtype) of the JAX package's TP battery and its
# int8-KV-alone case
COMBOS = [("int8", None, "int8"), ("int4", 16, "int8"), (None, None, "int8")]
COMBO_IDS = ["w8-kv8", "w4g16-kv8", "kv8"]


def _kw(quantize, group, kv_dtype):
    kw = {"kv_dtype": kv_dtype}
    if quantize:
        kw["quantize"] = quantize
    if group:
        kw["quant_group"] = group
    return kw


@pytest.fixture(scope="module")
def models():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    jlm = tiny_lm_with_affine()
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.decoder_tiny_lm(device="cpu").load_jax_params(params_np)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, jlm.config.vocab_size, n).tolist(), m)
            for n, m in zip(PROMPT_LENS, MAX_NEW)]
    return jlm, tlm, reqs


@pytest.fixture(scope="module")
def models4():
    """The tiny LM with 4 KV heads, which tp 4 divides."""
    jlm = tiny_lm_with_affine(num_kv_heads=4)
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.decoder_tiny_lm(device="cpu", num_kv_heads=4).load_jax_params(
        params_np)
    return jlm, tlm


# ---------------------------------------------------------------------------
# the quantized params and their shards
# ---------------------------------------------------------------------------
def _leaf_np(t):
    return {"q": np.asarray(t.q), "s": np.asarray(t.s)}


@functools.lru_cache(maxsize=None)
def _jax_quantized(jlm, mode, group, tp):
    """The JAX quantizer's pytree of ``jlm``'s params at ``tp``, made once
    for the tests that read it (eager, as the JAX engine quantizes: under
    ``jax.jit`` XLA's rewrites change some codes)."""
    return jquant.quantize_params(jlm.jax_params(), mode, group=group, tp=tp)


QUANT_CASES = [("int8", 128, 2), ("int4", 16, 2), ("int4", 128, 2),
               ("int4", 128, 4)]
QUANT_IDS = ["w8-tp2", "w4g16-tp2", "w4g128-tp2", "w4g128-tp4"]


@pytest.mark.parametrize("mode,group,tp", QUANT_CASES, ids=QUANT_IDS)
def test_quantize_params_tp_matches_jax(models, models4, mode, group, tp):
    """Codes, scales and groups of every GEMM leaf equal the JAX
    quantizer's at the same tp, bit for bit; the int4 groups of ``wo`` and
    ``w2`` shrink to their shard's inputs."""
    jlm, tlm = models4 if tp == 4 else models[:2]
    jq = _jax_quantized(jlm, mode, group, tp)
    tq = tquant.quantize_params(tlm.params(), mode, group=group, tp=tp)
    for jl, tl in zip(jq["layers"], tq["layers"]):
        for kind in tdec._QUANT_KINDS:
            want, got = _leaf_np(jl[kind]), tl[kind]
            np.testing.assert_array_equal(got.q.numpy(), want["q"])
            np.testing.assert_array_equal(got.s.numpy(), want["s"])
            if mode == "int4":
                i = 2 * got.q.shape[1]
                local = i // tp if kind in ("wo", "w2") else i
                assert i // got.s.shape[1] == tqm.group_for(local, group)
                # no group straddles a row shard
                assert local % (i // got.s.shape[1]) == 0


def _rank(index, shape, tp):
    """The tp rank of a placed shard: where it starts along its split
    axis; None for a replicated leaf."""
    for ax, sl in enumerate(index):
        if sl != slice(None) and (sl.start or 0, sl.stop) != (0, shape[ax]):
            return (sl.start or 0) // (shape[ax] // tp)
    return None


@pytest.mark.parametrize("mode,group,tp", QUANT_CASES, ids=QUANT_IDS)
def test_quantized_shards_equal_jax_placed_shards(models, models4, mode,
                                                  group, tp):
    """Every quantized leaf of every shard equals the JAX plan's placed
    shard of the same tp rank (``addressable_shards`` of ``q`` and ``s``),
    bit for bit: column shards split ``q`` and ``s`` along the outputs
    (views), row shards are contiguous copies, int8 row scales the full
    tensor, int4 row scales split along the groups."""
    jlm, tlm = models4 if tp == 4 else models[:2]
    mesh = MESH4 if tp == 4 else MESH
    qlm = quantize_lm(tlm, mode, group=group)
    token = ("int8",) if mode == "int8" else ("int4", group)
    jplan = jdec.tp_plan(jlm.config, JSharding.for_transformer(**mesh),
                         quant=token)
    placed = jplan.place_params(_jax_quantized(jlm, mode, group, tp))
    plan = tdec.tp_plan(tlm.config, ShardingConfig.for_transformer(**mesh))
    full = qlm.params(tp=tp)
    shards = plan.shard_params(full)
    assert len(shards) == tp
    for li, jl in enumerate(placed["layers"]):
        for kind in tdec._QUANT_KINDS:
            for field in ("q", "s"):
                leaf = getattr(jl[kind], field)
                for sh in leaf.addressable_shards:
                    r = _rank(sh.index, leaf.shape, tp)
                    for rr in range(tp) if r is None else (r,):
                        got = getattr(shards[rr]["layers"][li][kind], field)
                        np.testing.assert_array_equal(got.numpy(),
                                                      np.asarray(sh.data))
            parts = [sh["layers"][li][kind] for sh in shards]
            whole = full["layers"][li][kind]
            assert all(p.q.is_contiguous() and p.s.is_contiguous()
                       for p in parts)
            if kind in ("wo", "w2") and mode == "int8":
                assert all(p.s is whole.s for p in parts)   # replicated
            if kind not in ("wo", "w2"):
                # column shards are views of the full codes
                assert parts[-1].q.data_ptr() > whole.q.data_ptr()
                assert parts[-1].q.untyped_storage().data_ptr() == \
                    whole.q.untyped_storage().data_ptr()


def test_shard_quantized_refuses_straddling_groups():
    w = torch.randn(8, 64, generator=torch.Generator().manual_seed(1))
    w4 = tqm.quantize_w4(w, group=32)                  # 2 groups
    assert len(tqm.shard_quantized(w4, 2, 1)) == 2
    with pytest.raises(ValueError, match="straddle"):
        tqm.shard_quantized(w4, 4, 1)                   # 16-input shards
    with pytest.raises(ValueError, match="do not split"):
        tqm.shard_quantized(tqm.quantize_w8(w), 3, 0)
    # a column shard splits every group's scale row with its channel
    parts = tqm.shard_quantized(w4, 4, 0)
    assert [tuple(p.s.shape) for p in parts] == [(2, 2)] * 4
    assert torch.equal(torch.cat([tqm.dequantize_weight(p) for p in parts]),
                       tqm.dequantize_weight(w4))


def test_quantized_lm_params_cached_per_tp(models):
    tlm = models[1]
    q4 = quantize_lm(tlm, "int4", group=128)
    p1, p2 = q4.params(), q4.params(tp=2)
    assert q4.params(tp=2) is p2 and q4.params(tp=1) is p1
    wo1, wo2 = p1["layers"][0]["wo"], p2["layers"][0]["wo"]
    assert 2 * wo1.q.shape[1] // wo1.s.shape[1] == 64          # I 64
    assert 2 * wo2.q.shape[1] // wo2.s.shape[1] == 32          # I / 2
    assert torch.equal(p1["layers"][0]["wq"].q, p2["layers"][0]["wq"].q)
    q8 = quantize_lm(tlm, "int8")
    assert q8.params(tp=2) is q8.params() is q8.params(tp=4)


def test_load_jax_params_at_tp(models):
    """A JAX int4 pytree quantized at tp 2 loads at tp 2 and equals the
    port's own quantization there; at tp 1 its wo/w2 groups do not fit."""
    jlm, tlm = models[:2]
    jq = jax.tree.map(np.asarray, _jax_quantized(jlm, "int4", 128, 2))
    fresh = tdec.decoder_tiny_lm(device="cpu", seed=5)
    qlm = quantize_lm(fresh, "int4", group=128).load_jax_params(jq, tp=2)
    want = quantize_lm(tlm, "int4", group=128).params(tp=2)
    for gl, wl in zip(qlm.params(tp=2)["layers"], want["layers"]):
        for kind in tdec._QUANT_KINDS:
            assert torch.equal(gl[kind].q, wl[kind].q)
            assert torch.equal(gl[kind].s, wl[kind].s)
        for k in ("bq", "ln1g", "b2"):
            assert torch.equal(gl[k], wl[k])
    with pytest.raises(ValueError, match="int4 group"):
        quantize_lm(fresh, "int4", group=128).load_jax_params(jq)
    # the wrapped model's fp GEMM weights are seed 5's: no other tp is
    # quantized from them
    with pytest.raises(ValueError, match="at tp 2"):
        qlm.params()


@pytest.mark.parametrize("loaded,served", [(1, 2), (2, 1), (4, 2), (2, 4)],
                         ids=["tp1-to-tp2", "tp2-to-tp1", "tp4-to-tp2",
                              "tp2-to-tp4"])
def test_loaded_int4_engine_refuses_other_tp(models, models4, loaded,
                                              served):
    """An int4 wrapper loaded from a JAX pytree quantized at one tp holds
    no fp GEMM weights to quantize for another: an engine at another tp
    raises ValueError naming the loaded tp, and one at the loaded tp
    serves its codes."""
    jlm = (models4 if 4 in (loaded, served) else models)[0]
    kvh = jlm.config.num_kv_heads
    jq = jax.tree.map(np.asarray, _jax_quantized(jlm, "int4", 128, loaded))
    fresh = tdec.decoder_tiny_lm(device="cpu", seed=5, num_kv_heads=kvh)
    qlm = quantize_lm(fresh, "int4", group=128).load_jax_params(jq,
                                                                tp=loaded)

    def engine(tp):
        mesh = dict(mesh_shape=(8 // tp, tp), axis_names=("dp", "tp"))
        return DecodeEngine(qlm, name="llm", device="cpu",
                            sharding=ShardingConfig.for_transformer(**mesh),
                            **ENGINE)

    with pytest.raises(ValueError, match="at tp %d" % loaded):
        engine(served)
    eng = engine(loaded)
    try:
        assert eng.tp == loaded
        wo = qlm.params(tp=loaded)["layers"][0]["wo"]
        if loaded == 1:
            assert eng.params["layers"][0]["wo"] is wo
        else:
            for p, w in zip(eng.params, tqm.shard_quantized(wo, loaded, 1)):
                assert torch.equal(p["layers"][0]["wo"].q, w.q)
                assert torch.equal(p["layers"][0]["wo"].s, w.s)
    finally:
        assert eng.stop()
