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
- greedy streams of the port's quantized TP engine equal the JAX
  quantized TP engine's, or differ only after a near-tie of the port's
  own TP prefill (top-2 margin below ``TIE``), as
  ``test_torch_quantized_serving.py`` allows at tp 1;
- one quantized TP decode step on a fixed state against the port's tp 1
  step on the same integer weights (``TOL_LOGITS``);
- stats, launch counts and the collective census.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu.serving as jserving
from mxnet_tpu.models import decoder as jdec
from mxnet_tpu.parallel.shardcfg import ShardingConfig as JSharding
from mxnet_tpu.serving import quantize as jquant
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa
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


# ---------------------------------------------------------------------------
# one decode step against tp 1
# ---------------------------------------------------------------------------
def _step_state(cfg, kv_dtype, seed=3):
    rng = np.random.default_rng(seed)
    slots, S, pps, total = 4, 4, 8, 33
    shape = (cfg.num_layers, cfg.num_kv_heads, total, S, cfg.head_dim)

    def pool():
        vals = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        if kv_dtype != "int8":
            return torch.tensor(vals)
        return tpa.QPages(
            q=torch.tensor(rng.integers(-127, 128, shape).astype(np.int8)),
            s=torch.tensor(rng.uniform(0.001, 0.01, shape[:3])
                           .astype(np.float32)))

    kp, vp = pool(), pool()
    tables = np.zeros((slots, pps), np.int32)
    for b in range(slots):
        tables[b] = 1 + b * pps + np.arange(pps)
    # a row opening a page (slot 0 latches its scale), one mid-page, an
    # inactive one, one ending a page
    pos = np.array([4, 17, 0, 31], np.int32)
    act = np.array([True, True, False, True])
    toks = rng.integers(0, cfg.vocab_size, slots).astype(np.int32)
    return S, kp, vp, (torch.tensor(toks), torch.tensor(pos),
                       torch.tensor(tables), torch.tensor(act)), act


def _clone(pages):
    if isinstance(pages, tpa.QPages):
        return tpa.QPages(q=pages.q.clone(), s=pages.s.clone())
    return pages.clone()


@pytest.mark.parametrize("quantize,group,kv_dtype",
                         COMBOS + [("int4", 128, "float32")],
                         ids=COMBO_IDS + ["w4g128"])
def test_quantized_tp_step_matches_tp1(models, quantize, group, kv_dtype):
    """The per-op TP step on shards of the integer weights (int4 at the
    tp 2 group) and the KV-head slabs of the pools against the tp 1 step
    on the same weights and pools: logits within TOL_LOGITS, the same
    greedy tokens, 2 all-reduces a layer; the int8 pages' codes within
    one step and their latched scales within a few ulps."""
    tlm = models[1]
    cfg = tlm.config
    model = quantize_lm(tlm, quantize, group=group or 128) if quantize \
        else tlm
    params = model.params(tp=2) if quantize else model.params()
    S, kp, vp, args, act = _step_state(cfg, kv_dtype)
    plan = tdec.tp_plan(cfg, ShardingConfig.for_transformer(**MESH))
    step = tdec.make_decode_step(cfg, S, plan=plan)
    tkp, tvp = _clone(kp), _clone(vp)
    before = plan.all_reduces
    _, _, ttok, tlog = step(plan.shard_params(params), tkp, tvp, *args)
    assert plan.all_reduces - before == 2 * cfg.num_layers
    rkp, rvp = _clone(kp), _clone(vp)
    _, _, rtok, rlog = tdec.make_decode_step(cfg, S)(params, rkp, rvp, *args)
    live = torch.tensor(act)
    torch.testing.assert_close(tlog[live], rlog[live], rtol=0,
                               atol=TOL_LOGITS)
    assert torch.equal(ttok[live], rtok[live])
    for got, want in ((tkp, rkp), (tvp, rvp)):
        if kv_dtype == "int8":
            assert (got.q.int() - want.q.int()).abs().max() <= 1
            torch.testing.assert_close(got.s, want.s, rtol=1e-5, atol=0)
            assert not torch.equal(got.s, kp.s)     # the step latched some
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=TOL_LOGITS)


def test_fused_tp_step_refuses_quantized_inputs(models):
    tlm = models[1]
    cfg = tlm.config
    plan = tdec.tp_plan(cfg, ShardingConfig.for_transformer(**MESH))
    step = tdec.make_decode_step_fused(cfg, 4, plan=plan)
    S, kp, vp, args, _ = _step_state(cfg, "int8")
    with pytest.raises(ValueError, match="fp32 pages"):
        step(plan.shard_params(tlm.params()), kp, vp, *args)
    S, kp, vp, args, _ = _step_state(cfg, "float32")
    with pytest.raises(ValueError, match="fp32 weights"):
        step(plan.shard_params(quantize_lm(tlm, "int8").params()), kp, vp,
             *args)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _serve(eng, reqs):
    try:
        with eng._cond:      # every request queued before the first step
            futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = [f.result(timeout=300)["tokens"] for f in futs]
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    return outs


def _last_logits(eng, toks):
    """Last-position logits of ``toks`` through the engine's own TP
    prefill program on a fresh one-sequence pool of its KV format."""
    cfg, S, chunk = eng.cfg, eng.page_size, eng.prefill_chunk
    pps = -(-len(toks) // S)
    shape = (cfg.num_layers, cfg.num_kv_heads, pps + 1, S, cfg.head_dim)
    kp, vp = eng._fresh_pool(shape), eng._fresh_pool(shape)
    row = torch.arange(1, pps + 1, dtype=torch.int32)
    for p0 in range(0, len(toks), chunk):
        n = min(chunk, len(toks) - p0)
        padded = torch.zeros(chunk, dtype=torch.int64)
        padded[:n] = torch.tensor(toks[p0:p0 + n])
        _, _, _, last = eng._prefill_fn(eng.params, kp, vp, padded, p0, n,
                                        row)
    return last


@pytest.mark.parametrize("quantize,group,kv_dtype", COMBOS, ids=COMBO_IDS)
def test_quantized_tp_engine_streams_match_jax(monkeypatch, models,
                                               quantize, group, kv_dtype):
    """The JAX package's quantized TP battery (int8 and int4 group 16
    weights with int8 KV, and int8 KV alone) at tp 2: the port's streams
    equal the JAX TP engine's but where the port's own TP prefill shows a
    near-tie; the engine takes the per-op step though the fused one is
    asked for, and its stats carry the format and the mesh as the JAX
    engine's do."""
    jlm, tlm, reqs = models
    kw = _kw(quantize, group, kv_dtype)
    jeng = jserving.DecodeEngine(
        jlm, name="llm", sharding=JSharding.for_transformer(**MESH),
        prefix_cache=False, async_decode=False, **ENGINE, **kw)
    try:
        jfuts = [jeng.submit(p, max_new_tokens=n) for p, n in reqs]
        ref = [f.result(timeout=300)["tokens"] for f in jfuts]
        jstats = jeng.stats()
    finally:
        assert jeng.stop()
    monkeypatch.setenv("MXNET_DECODE_FUSED", "1")
    eng = DecodeEngine(tlm, name="llm", device="cpu",
                       sharding=ShardingConfig.for_transformer(**MESH),
                       **ENGINE, **kw)
    assert eng.tp == 2 and not eng.decode_fused
    outs = _serve(eng, reqs)
    for (prompt, _), got, want in zip(reqs, outs, ref):
        if got == want:
            continue
        i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
        top2 = torch.topk(_last_logits(eng, prompt + got[:i]), 2).values
        margin = float(top2[0] - top2[1])
        assert margin < TIE, ("streams differ at %d without a near-tie "
                              "(margin %.3g): %s vs %s"
                              % (i, margin, got, want))
    st = eng.stats()
    assert st["quant"] == jstats["quant"]
    assert st["sharding"]["mesh"] == jstats["sharding"]["mesh"] == "dp=4xtp=2"
    assert st["sharding"]["tp"] == jstats["sharding"]["tp"] == 2
    assert st["sharding"]["collectives"]["all-reduce"] == \
        jstats["sharding"]["collectives"]["all-reduce"]
    counters = eng.metrics.snapshot()["models"]["llm"]["counters"]
    assert counters["preemptions_total"] >= 1


@pytest.mark.parametrize("kw", [dict(quantize="int8", kv_dtype="int8"),
                                dict(quantize="int4", quant_group=128)],
                         ids=["w8-kv8", "w4g128"])
def test_quantized_tp_engine_stats_and_census(models, kw):
    """The census, counted on one step at construction: 2 all-reduces a
    layer and nothing else; the per-op kernels of every shard (6
    quant_matmul launches a shard a layer); int8 pools keep the engine's
    (L, KVH, P, S, D) layout with their (L, KVH, P) scales; int4 weights
    carry the tp 2 groups."""
    tlm = models[1]
    eng = DecodeEngine(tlm, name="llm", device="cpu",
                       sharding=ShardingConfig.for_transformer(**MESH),
                       **ENGINE, **kw)
    try:
        L, cfg = tlm.config.num_layers, tlm.config
        st = eng.stats()
        assert st["quant"]["weights"] == kw["quantize"]
        assert st["quant"]["kv_dtype"] == kw.get("kv_dtype", "float32")
        shd = st["sharding"]
        assert shd["tp"] == 2 and shd["mesh"] == "dp=4xtp=2"
        assert shd["collectives"]["all-reduce"] == 2 * L
        assert shd["collectives"]["total"] == 2 * L
        int8 = kw.get("kv_dtype") == "int8"
        attn = "paged_attention_int8" if int8 else "paged_attention"
        assert st["launches"]["kernels"] == {
            attn: 2 * L, "bias_gelu": 2 * L, "quant_matmul": 12 * L}
        assert st["launches"]["prefill_chunk_kernels"] == {
            "bias_gelu": 2 * L, "quant_matmul": 12 * L}
        if int8:
            assert isinstance(eng._kp, tpa.QPages)
            assert tuple(eng._kp.q.shape)[:2] == (L, cfg.num_kv_heads)
            assert tuple(eng._kp.s.shape) == tuple(eng._kp.q.shape[:3])
        else:
            wo = eng.params[0]["layers"][0]["wo"]
            assert 2 * wo.q.shape[1] // wo.s.shape[1] == 32     # 64 / 2
        assert len(eng.params) == 2
        assert len(eng.submit([1, 2, 3], max_new_tokens=4).result(
            timeout=60)["tokens"]) == 4
    finally:
        assert eng.stop()
