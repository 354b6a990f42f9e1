"""Port parity: the quantized decode step and engine under tensor
parallelism.  ``mxnet_tpu_torch``'s int8/int4 weights and int8 KV pages
under ``DecodeEngine(sharding=)`` against the JAX package's on the 8-device
CPU mesh of ``tests/conftest.py``, at a (dp, tp) = (4, 2) mesh as
``tests/test_quantized_serving.py::test_quantized_engine_tensor_parallel``
runs it.  The model, the traffic and the constants are
``test_torch_quantized_tp.py``'s (which holds the quantized params and
their shards).

- greedy streams of the port's quantized TP engine equal the JAX
  quantized TP engine's, or differ only after a near-tie of the port's
  own TP prefill (top-2 margin below ``TIE``), as
  ``test_torch_quantized_serving.py`` allows at tp 1;
- one quantized TP decode step on a fixed state against the port's tp 1
  step on the same integer weights (``TOL_LOGITS``);
- stats, launch counts and the collective census.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu.serving as jserving
from mxnet_tpu.parallel.shardcfg import ShardingConfig as JSharding
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa
from mxnet_tpu_torch.parallel import ShardingConfig
from mxnet_tpu_torch.serving import DecodeEngine, quantize_lm
from test_torch_quantized_tp import (COMBO_IDS, COMBOS, ENGINE, MESH, TIE,
                                     TOL_LOGITS, _kw, models)  # noqa: F401

torch.set_num_threads(2)


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
