"""Port parity: copy-on-write prefix caching.  ``mxnet_tpu_torch.serving.
kvcache``'s ``PageAllocator.share``/``fork``/``trim`` and ``PrefixCache``
against the JAX package's on the same seeded operations, and the port's
``DecodeEngine`` with prefix hits and copy-on-write forks against itself
with the cache off and against the JAX engine with it on, on the CPU.

The model is the JAX ``decoder_tiny_lm(seed=0)`` with random biases and LN
affines, carried across by ``load_jax_params``.  A hit changes which chunk
computes a prefix's K and V, not what the engine computes for any token:
within the port, streams with the cache on must equal streams with it off
exactly.  Against the JAX engine they must be equal, or show a near-tie
(top-2 margin below 1e-4, ``torch_parity.check_stream``) at the first
difference.  The JAX engine runs its synchronous loop, whose streams do
not depend on the host's load (``test_torch_async_engine.py`` says why).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu.serving as jserving
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch.parallel import ShardingConfig
from mxnet_tpu_torch.serving import DecodeEngine
from mxnet_tpu_torch.serving import kvcache as tkv
from torch_parity import carried_models, check_stream

torch.set_num_threads(2)

ENGINE = dict(slots=4, page_size=4, prefill_chunk=8, max_ctx=48)
# 2 full pages of 4 and 2 tokens: a hit forks the partial page
SHARED = [5, 17, 3, 90, 41, 8, 66, 12, 29, 100]
TAILS = [[20, 21, 7], [30, 31], [40], [9, 9, 9, 9, 9]]
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    return carried_models()


def _counters(eng):
    return eng.metrics.snapshot()["models"]["llm"]["counters"]


def _serve(eng, prefix, tails):
    """The prefix alone, then prefix + each tail at once; the streams.
    Stops the engine and checks that its pages are all back."""
    try:
        out = [eng.submit(prefix, max_new_tokens=MAX_NEW)
               .result(timeout=300)["tokens"]]
        futs = [eng.submit(prefix + t, max_new_tokens=MAX_NEW)
                for t in tails]
        out += [f.result(timeout=300)["tokens"] for f in futs]
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    return out


def _ops(rng, n=120):
    """A seeded run of allocator operations over four owners."""
    for _ in range(n):
        owner = int(rng.integers(0, 4))
        r = rng.random()
        if r < 0.35:
            yield "alloc", owner, int(rng.integers(1, 3))
        elif r < 0.55:
            yield "share", owner, int(rng.integers(0, 4))
        elif r < 0.7:
            yield "fork", owner, int(rng.integers(0, 8))
        elif r < 0.85:
            yield "trim", owner, int(rng.integers(0, 4))
        else:
            yield "free", owner, 0


def _apply(a, mod, op, owner, arg):
    if op == "alloc":
        try:
            return a.alloc(owner, arg)
        except mod.CacheOOM:
            return "oom"
    if op == "share":
        src = a.pages(arg)
        return a.share(owner, src[:2]) if src and arg != owner else None
    if op == "fork":
        mine = a.pages(owner)
        if not mine:
            return None
        page = mine[arg % len(mine)]
        if a.refcount(page) < 2:
            return None
        try:
            return a.fork(owner, page)
        except mod.CacheOOM:
            return "oom"
    if op == "trim":
        return a.trim(owner, arg)
    return a.free(owner)


@pytest.mark.parametrize("seed", [0, 1])
def test_share_fork_trim_match_jax(seed):
    """One seeded run of alloc/share/fork/trim/free, through an exhausted
    pool, hands out the same page ids and keeps the same refcounts,
    ``stats()`` and ``check_leaks`` in both packages."""
    rng = np.random.default_rng(seed)
    j = jkv.PageAllocator(11, 4, page_bytes=64)
    t = tkv.PageAllocator(11, 4, page_bytes=64)
    seen = set()
    for op, owner, arg in _ops(rng):
        want = _apply(j, jkv, op, owner, arg)
        got = _apply(t, tkv, op, owner, arg)
        assert got == want, (op, owner, arg)
        seen.add(op if got not in (None, "oom") else None)
        assert t.stats() == j.stats()
        assert [t.refcount(p) for p in range(11)] == [
            j.refcount(p) for p in range(11)]
        assert t.check_leaks() == j.check_leaks()
    assert {"alloc", "share", "fork", "trim", "free"} <= seen
    assert t.stats()["counters"]["forks"] > 0
    assert t.stats()["shared_pages"] == j.stats()["shared_pages"]


def test_prefix_cache_lookup_insert_evict_match_jax():
    """Inserts of full and partial pages, lookups (full cover, partial
    hit, the one token always left to prefill, a miss) and LRU evictions
    give the same pages, covers, counters and pool in both packages."""
    results = []
    for mod in (jkv, tkv):
        a = mod.PageAllocator(total_pages=12, page_size=4)
        pc = mod.PrefixCache(a)
        toks = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]     # 2 full pages + 2
        pages = a.alloc("seq", 3)
        out = [pc.insert(toks, pages)]
        a.free("seq")
        other = [1, 2, 3, 4, 50, 60, 70, 80, 90]
        op = a.alloc("o", 3)
        out.append(pc.insert(other, op))
        a.free("o")
        for prompt in (toks + [11, 12], toks[:8], toks, other + [1],
                       [9, 9, 9, 9, 9], [1, 2, 3, 4, 5]):
            out.append(pc.lookup(prompt))
        while pc.evict_one():
            out.append((len(pc), a.num_used, a.stats()))
        out.append((pc.stats(), a.stats()))
        a.check_leaks()
        results.append(out)
    assert results[1] == results[0]
    assert results[0][2] == ([1, 2, 3], 10, True)


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "per_op"])
def test_cow_fork_streams_match_cache_off_and_jax(monkeypatch, models,
                                                  fused):
    """fp pages: every request after the prefix hits its two full pages
    and forks its partial page copy-on-write; the streams equal the cache
    off exactly, and the JAX engine's with the cache on."""
    jlm, tlm = models
    monkeypatch.setenv("MXNET_DECODE_FUSED", fused)
    on = DecodeEngine(tlm, name="llm", device="cpu", prefix_cache=True,
                      **ENGINE)
    got = _serve(on, SHARED, TAILS)
    c = _counters(on)
    assert c["prefix_hits_total"] == len(TAILS)
    assert c["prefix_tokens_saved_total"] == len(TAILS) * len(SHARED)
    assert c["cow_forks_total"] == len(TAILS)
    assert on.stats()["prefix_cache"]["counters"]["hits"] == len(TAILS)
    off = DecodeEngine(tlm, name="llm", device="cpu", prefix_cache=False,
                       **ENGINE)
    assert _serve(off, SHARED, TAILS) == got
    assert _counters(off)["prefix_hits_total"] == 0
    jeng = jserving.DecodeEngine(jlm, name="llm", prefix_cache=True,
                                 async_decode=False, **ENGINE)
    want = _serve(jeng, SHARED, TAILS)
    jc = _counters(jeng)
    assert (jc["prefix_hits_total"], jc["cow_forks_total"]) == (
        c["prefix_hits_total"], c["cow_forks_total"])
    for t, g, w in zip([[]] + TAILS, got, want):
        check_stream(tlm, "float32", SHARED + t, g, w, ENGINE["page_size"],
                     ENGINE["prefill_chunk"])


def test_int8_whole_page_hits_match_cache_off(models):
    """int8 pages, a prefix of two whole pages: hits share codes and
    scales, and the streams equal the cache off exactly (a partial page's
    scale latches at its first write, which the cache moves to another
    chunk, so whole pages only, as ``tests/test_quantized_serving.py``)."""
    tlm = models[1]
    prefix = SHARED[:8]
    outs = []
    for pc in (True, False):
        eng = DecodeEngine(tlm, name="llm", device="cpu", prefix_cache=pc,
                           kv_dtype="int8", quantize="int8", **ENGINE)
        outs.append(_serve(eng, prefix, TAILS))
        c = _counters(eng)
        assert c["prefix_hits_total"] == (len(TAILS) if pc else 0)
        assert c["cow_forks_total"] == 0
    assert outs[0] == outs[1]


def test_int8_partial_fork_copies_codes_and_scales(models):
    """int8 pages, a partial-page hit: the fork copies the shared page's
    codes and its scales bit for bit (the hitter's page holds them at the
    shared offsets after its own prefill), and the streams equal the JAX
    int8 engine's under the same hit."""
    jlm, tlm = models
    S, m = ENGINE["page_size"], len(SHARED) % ENGINE["page_size"]
    eng = DecodeEngine(tlm, name="llm", device="cpu", kv_dtype="int8",
                       **ENGINE)
    try:
        first = eng.submit(SHARED, max_new_tokens=MAX_NEW).result(300)
        # park the hitter's pages under a session to read them afterwards
        second = eng.submit(SHARED + TAILS[0], max_new_tokens=MAX_NEW,
                            session="hit").result(300)
        assert _counters(eng)["cow_forks_total"] == 1
        cached, covered, partial = eng.prefix_cache.lookup(SHARED + [0])
        assert covered == len(SHARED) and partial
        old = cached[-1]
        new = eng.alloc.pages(eng._sessions["hit"].owner)[len(cached) - 1]
        assert new != old
        for pool in (eng._kp, eng._vp):
            assert torch.equal(pool.q[:, :, new, :m], pool.q[:, :, old, :m])
            assert torch.equal(pool.s[:, :, new], pool.s[:, :, old])
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    jeng = jserving.DecodeEngine(jlm, name="llm", prefix_cache=True,
                                 kv_dtype="int8", async_decode=False,
                                 **ENGINE)
    try:
        want = [jeng.submit(SHARED, max_new_tokens=MAX_NEW).result(300),
                jeng.submit(SHARED + TAILS[0], max_new_tokens=MAX_NEW)
                .result(300)]
        assert _counters(jeng)["cow_forks_total"] == 1
    finally:
        assert jeng.stop()
    for p, g, w in zip((SHARED, SHARED + TAILS[0]), (first, second), want):
        check_stream(tlm, "int8", p, g["tokens"], w["tokens"], S,
                     ENGINE["prefill_chunk"])


def test_tp2_prefix_hits_match_cache_off(models):
    """Tensor-parallel (tp 2): hits and copy-on-write forks on the one
    pool every shard reads its KV heads from; the streams equal the TP
    engine's with the cache off exactly."""
    tlm = models[1]
    tp2 = ShardingConfig.for_transformer(mesh_shape=(1, 2),
                                         axis_names=("dp", "tp"))
    outs = []
    for pc in (True, False):
        eng = DecodeEngine(tlm, name="llm", device="cpu", prefix_cache=pc,
                           sharding=tp2, **ENGINE)
        assert eng.tp == 2
        outs.append(_serve(eng, SHARED, TAILS))
        assert _counters(eng)["cow_forks_total"] == (len(TAILS) if pc
                                                     else 0)
    assert outs[0] == outs[1]


def test_lru_entries_evicted_before_preemption(models):
    """Under pool pressure the engine drops LRU prefix-cache entries before
    it preempts a live sequence: a pool that fits the traffic once the
    cache is emptied serves it with evictions and no preemption."""
    tlm = models[1]
    eng = DecodeEngine(tlm, name="llm", device="cpu", prefix_cache=True,
                       slots=2, page_size=4, prefill_chunk=8, max_ctx=24,
                       total_pages=11)
    try:
        # three distinct 11-token prompts leave 9 cached pages behind
        for i in range(3):
            eng.submit([i + 1] * 11, max_new_tokens=2).result(300)
        assert len(eng.prefix_cache) == 9
        futs = [eng.submit([50 + i] * 6, max_new_tokens=12)
                for i in range(2)]
        outs = [f.result(300) for f in futs]
    finally:
        assert eng.stop()
    assert [len(o["tokens"]) for o in outs] == [12, 12]
    c = _counters(eng)
    assert c["preemptions_total"] == 0
    assert eng.prefix_cache.stats()["counters"]["evictions"] >= 5
    assert len(eng.prefix_cache) == 0       # stop() cleared the cache
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
