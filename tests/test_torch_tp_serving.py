"""Port parity: tensor-parallel serving.  ``mxnet_tpu_torch``'s
``DecodeEngine(sharding=)``, ``models.decoder.TPPlan``/``tp_plan`` and the
TP decode steps and prefill chunk against the JAX package's on the
8-device CPU mesh of ``tests/conftest.py``, at a (dp, tp) = (4, 2) mesh as
``tests/test_tp_serving.py`` runs it.

The model is the JAX ``decoder_tiny_lm(seed=0)`` (vocab 128, 2 layers,
units 64, FFN 128, 4 heads over 2 KV heads) with random biases and LN
affines, carried across by ``params_from_jax``.  The port runs every
shard in turn on one device (the CPU here), so its all-reduce is a
fixed-order sum of the shards' partial products; JAX's ``psum`` adds them
in its own order.  Tolerances below say what each comparison allows.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu.serving as jserving
from mxnet_tpu.models import decoder as jdec
from mxnet_tpu.parallel.shardcfg import ShardingConfig as JSharding
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.parallel import ShardingConfig
from mxnet_tpu_torch.serving import DecodeEngine
from torch_parity import tiny_lm_with_affine

torch.set_num_threads(2)

ENGINE = dict(slots=3, page_size=4, max_ctx=40, total_pages=13,
              prefill_chunk=8)
# prompts past the prefill chunk (chunked prefill), and a pool of 13
# pages that this traffic exhausts (preemption by recompute)
PROMPT_LENS = (3, 11, 20, 7, 17)
MAX_NEW = (12, 10, 8, 14, 9)
MESH = dict(mesh_shape=(4, 2), axis_names=("dp", "tp"))
# one decode step's logits: fp32, the row-parallel sums in another order
# than the unsharded step's (the JAX package's own TP step-parity band)
TOL_LOGITS = 1e-4


def tp_config(**kw):
    return ShardingConfig.for_transformer(**dict(MESH, **kw))


@pytest.fixture(scope="module")
def setup():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    jlm = tiny_lm_with_affine()
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.decoder_tiny_lm(device="cpu").load_jax_params(params_np)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, jlm.config.vocab_size, n).tolist(), m)
            for n, m in zip(PROMPT_LENS, MAX_NEW)]
    eng = jserving.DecodeEngine(jlm, name="llm", sharding=JSharding
                                .for_transformer(**MESH), prefix_cache=False,
                                async_decode=False, **ENGINE)
    try:
        with eng._cond:      # every request queued before the first step
            futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        ref = [f.result(timeout=300)["tokens"] for f in futs]
        jstats = eng.stats()
        jcounters = eng.metrics.snapshot()["models"]["llm"]["counters"]
    finally:
        assert eng.stop()
    assert jstats["sharding"]["tp"] == 2
    assert jcounters["preemptions_total"] >= 1
    return jlm, tlm, reqs, ref, jstats


def serve(tlm, reqs, **kw):
    """Serve ``reqs`` through a port engine.  They are submitted under the
    engine's lock, so every request is queued before the first step and
    the run is the same every time."""
    eng = DecodeEngine(tlm, name="llm", device="cpu", **ENGINE, **kw)
    try:
        with eng._cond:
            futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = [f.result(timeout=120)["tokens"] for f in futs]
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    return outs, eng


# ---------------------------------------------------------------------------
# plan resolution and the shards
# ---------------------------------------------------------------------------
def test_tp_plan_resolution(setup):
    tlm = setup[1]
    cfg = tlm.config
    plan = tdec.tp_plan(cfg, tp_config())
    assert plan.tp == 2
    assert plan.local_cfg == cfg._replace(num_heads=2, num_kv_heads=1,
                                          hidden_size=64)
    assert tdec.tp_plan(cfg, None) is None
    dp_only = ShardingConfig.for_transformer(mesh_shape=(8,),
                                             axis_names=("dp",))
    assert tdec.tp_plan(cfg, dp_only) is None
    # rules that do not give the Megatron layout: served replicated
    with pytest.warns(UserWarning, match="Megatron"):
        assert tdec.tp_plan(cfg, ShardingConfig(**MESH)) is None


def test_tp_that_does_not_divide_serves_replicated(setup):
    """KV heads 2 cannot split 4 ways: the plan warns and the engine
    serves replicated, as the JAX engine does."""
    tlm = setup[1]
    bad = tp_config(mesh_shape=(1, 4))
    with pytest.warns(UserWarning, match="tp=4 does not divide"):
        assert tdec.tp_plan(tlm.config, bad) is None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = DecodeEngine(tlm, device="cpu", sharding=bad, **ENGINE)
    try:
        assert eng.tp == 1 and eng.sharding is None
        assert "sharding" not in eng.stats()
        assert len(eng.submit([1, 2, 3], max_new_tokens=4).result(
            timeout=60)["tokens"]) == 4
    finally:
        assert eng.stop()


def test_shards_equal_jax_placed_shards(setup):
    """Every leaf of every shard equals the JAX plan's placed shard of the
    same tp rank (``addressable_shards``), bit for bit; the column shards
    are views of the full weights and the row shards contiguous."""
    jlm, tlm = setup[0], setup[1]
    jplan = jdec.tp_plan(jlm.config, JSharding.for_transformer(**MESH))
    placed = jplan.place_params(jlm.jax_params())
    plan = tdec.tp_plan(tlm.config, tp_config())
    full = tlm.params()
    shards = plan.shard_params(full)
    for li, jl in enumerate(placed["layers"]):
        for key, leaf in jl.items():
            for sh in leaf.addressable_shards:
                idx = sh.index
                # the tp rank: where the shard starts along its split axis
                axis = 1 if key in ("wo", "w2") else 0
                sl = idx[axis] if axis < len(idx) else slice(None)
                width = leaf.shape[axis] // 2
                r = (sl.start or 0) // width if sl.stop is not None else 0
                got = shards[r]["layers"][li][key]
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(sh.data))
            if key in ("wq", "bq", "wk", "bk", "wv", "bv", "w1", "b1"):
                assert shards[1]["layers"][li][key].data_ptr() \
                    > full["layers"][li][key].data_ptr()        # a view
            if key in ("wo", "w2"):
                assert shards[0]["layers"][li][key].is_contiguous()
            if key in ("bo", "b2", "ln1g", "ln1b", "ln2g", "ln2b"):
                assert shards[1]["layers"][li][key] is full["layers"][li][key]
    assert shards[1]["embed"] is full["embed"]


def test_kv_view_is_a_contiguous_slab(setup):
    plan = tdec.tp_plan(setup[1].config, tp_config())
    pages = torch.arange(2 * 2 * 5 * 4 * 16, dtype=torch.float32).reshape(
        2, 2, 5, 4, 16)
    v = plan.kv_view(pages, 1, 1)
    assert v.is_contiguous() and v.shape == (1, 5, 4, 16)
    assert v.data_ptr() == pages[1, 1:].data_ptr()


# ---------------------------------------------------------------------------
# one decode step against JAX's TP steps
# ---------------------------------------------------------------------------
def _step_state(cfg, seed=3):
    rng = np.random.default_rng(seed)
    slots, S, pps, total = 4, 4, 8, 33
    shape = (cfg.num_layers, cfg.num_kv_heads, total, S, cfg.head_dim)
    kp = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    vp = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    tables = np.zeros((slots, pps), np.int32)
    for b in range(slots):
        tables[b] = 1 + b * pps + np.arange(pps)
    pos = np.array([5, 17, 0, 30], np.int32)
    act = np.array([True, True, False, True])
    toks = rng.integers(0, cfg.vocab_size, slots).astype(np.int32)
    return S, kp, vp, toks, pos, tables, act


@pytest.mark.parametrize("fused", [False, True], ids=["per_op", "fused"])
def test_tp_decode_step_matches_jax(setup, fused):
    jlm, tlm = setup[0], setup[1]
    cfg = tlm.config
    S, kp, vp, toks, pos, tables, act = _step_state(cfg)
    jsh = JSharding.for_transformer(**MESH)
    if fused:
        jfn = jdec.make_decode_step_fused(jlm.config, S, mode="interpret",
                                          sharding=jsh)
    else:
        jfn = jdec.make_decode_step(jlm.config, S, sharding=jsh)
    jkp, jvp, jtok, jlog = jfn(jlm.jax_params(), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(toks),
                               jnp.asarray(pos), jnp.asarray(tables),
                               jnp.asarray(act))
    plan = tdec.tp_plan(cfg, tp_config())
    build = tdec.make_decode_step_fused if fused else tdec.make_decode_step
    tfn = build(cfg, S, plan=plan)
    shards = plan.shard_params(tlm.params())
    tkp, tvp = torch.tensor(kp), torch.tensor(vp)
    args = (torch.tensor(toks), torch.tensor(pos), torch.tensor(tables),
            torch.tensor(act))
    before = plan.all_reduces
    _, _, ttok, tlog = tfn(shards, tkp, tvp, *args)
    assert plan.all_reduces - before == 2 * cfg.num_layers
    live = act.nonzero()[0]
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               rtol=0, atol=TOL_LOGITS)
    assert np.array_equal(ttok.numpy()[live], np.asarray(jtok)[live])
    np.testing.assert_allclose(tkp.numpy()[:, :, 1:],
                               np.asarray(jkp)[:, :, 1:], rtol=0,
                               atol=TOL_LOGITS)
    np.testing.assert_allclose(tvp.numpy()[:, :, 1:],
                               np.asarray(jvp)[:, :, 1:], rtol=0,
                               atol=TOL_LOGITS)
    # and against the port at tp 1 on the same state
    rkp, rvp = torch.tensor(kp), torch.tensor(vp)
    ref = (tdec.make_decode_step_fused if fused
           else tdec.make_decode_step)(cfg, S)
    _, _, rtok, rlog = ref(tlm.params(), rkp, rvp, *args)
    torch.testing.assert_close(tlog[live], rlog[live], rtol=0,
                               atol=TOL_LOGITS)
    torch.testing.assert_close(tkp[:, :, 1:], rkp[:, :, 1:], rtol=0,
                               atol=TOL_LOGITS)


def test_tp_step_refuses_full_weights(setup):
    tlm = setup[1]
    plan = tdec.tp_plan(tlm.config, tp_config())
    S, kp, vp, toks, pos, tables, act = _step_state(tlm.config)
    step = tdec.make_decode_step(tlm.config, S, plan=plan)
    with pytest.raises(TypeError, match="per-shard"):
        step(tlm.params(), torch.tensor(kp), torch.tensor(vp),
             torch.tensor(toks), torch.tensor(pos), torch.tensor(tables),
             torch.tensor(act))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", ["1", "0"])
def test_tp_engine_streams_match_jax_tp_engine(monkeypatch, setup, fused):
    """Greedy streams at tp 2 equal the JAX TP engine's, through chunked
    prefill and preemption; the pools after serving equal the port's tp 1
    engine's after the same traffic."""
    _, tlm, reqs, ref, _ = setup
    monkeypatch.setenv("MXNET_DECODE_FUSED", fused)
    outs, eng = serve(tlm, reqs, sharding=tp_config())
    assert eng.tp == 2 and eng.decode_fused == (fused == "1")
    assert outs == ref
    counters = eng.metrics.snapshot()["models"]["llm"]["counters"]
    assert counters["preemptions_total"] >= 1
    one, eng1 = serve(tlm, reqs)
    assert one == outs
    # fp32 KV of layer 1 comes from activations whose row-parallel sums
    # ran in another order than tp 1's: equal within a few ulps
    for a, b in ((eng._kp, eng1._kp), (eng._vp, eng1._vp)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_tp_engine_stats_and_census(monkeypatch, setup, fused):
    """The collective census, counted on one step at construction, lands
    in stats() and the metrics before any traffic: 2 all-reduces per
    layer, as the JAX engine's census says."""
    tlm, jstats = setup[1], setup[4]
    monkeypatch.setenv("MXNET_DECODE_FUSED", fused)
    eng = DecodeEngine(tlm, name="llm", device="cpu", sharding=tp_config(),
                       **ENGINE)
    try:
        L = tlm.config.num_layers
        shd = eng.stats()["sharding"]
        assert shd["mesh"] == "dp=4xtp=2" == jstats["sharding"]["mesh"]
        assert shd["tp"] == 2
        assert shd["collectives"]["all-reduce"] == 2 * L == \
            jstats["sharding"]["collectives"]["all-reduce"]
        assert not any(shd["collectives"][k] for k in (
            "all-gather", "reduce-scatter", "collective-permute",
            "all-to-all"))
        snap = eng.metrics.snapshot()["models"]["llm"]["generate"]
        assert snap["sharding"]["collectives"] == shd["collectives"]
        assert snap["sharding"]["fused"] == (fused == "1")
        kernels = eng.stats()["launches"]["kernels"]
        if fused == "1":
            assert kernels == {"decode_attn_phase": 2 * L,
                               "decode_ffn_phase": 2 * L}
        else:
            assert kernels == {"paged_attention": 2 * L, "bias_gelu": 2 * L}
        assert eng.stats()["launches"]["prefill_chunk_kernels"] == {
            "bias_gelu": 2 * L}
        # the census step wrote nothing but the scratch page
        assert not eng._kp[:, :, 1:].any()
    finally:
        assert eng.stop()


def test_sharding_must_be_a_sharding_config(setup):
    with pytest.raises(TypeError, match="ShardingConfig"):
        DecodeEngine(setup[1], device="cpu", **ENGINE,
                     sharding=JSharding.for_transformer(**MESH))
