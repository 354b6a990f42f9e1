"""Port parity: speculative decoding in ``mxnet_tpu_torch.serving.
DecodeEngine`` (``speculate=True``) on the CPU, sync and async loops.

The model is the JAX ``decoder_tiny_lm(seed=0)`` with random biases and LN
affines, carried across by ``load_jax_params``; the draft model is the
JAX ``decoder_draft`` of it with its weights carried across the same way.
Speculation changes how many tokens a step emits, never which: every
speculative stream must equal the port's own plain engine's token for
token (as the JAX package's tests demand of the JAX engine), and the JAX
engine's plain synchronous loop by the near-tie rule of
``torch_parity.check_stream``.  The JAX speculative engine is never the
reference: two of its tests give streams that move between runs.

Covered: k 1-4 x {n-gram, draft model} x prefix cache on and off x sync
and async; int8 KV pages, int8 and int4 weights and tp 2 at k 3; pages
handed back after every verify (``trim``) under a drafter whose drafts
are all rejected, with ``check_leaks()`` clean and shared prefix pages
dereferenced, not destroyed, and the copy-on-write fork of a published
prefix page the verify wrote past; the draft and verify fault sites
degrading to plain decode; a session exported after speculative turns and
imported into a second engine; the verify launch census against the
wrappers the verify steps called; ``stats()`` and the metrics' and
server's ``speculative`` blocks.  Every test queues its requests under the
engine's lock before the first step.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu.serving as jserving
from mxnet_tpu.models import decoder as jdec
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.parallel import ShardingConfig
from mxnet_tpu_torch.serving import DecodeEngine, generate
from mxnet_tpu_torch.serving import speculate as tspec
from mxnet_tpu_torch.serving.kvcache import pages_for
from torch_parity import carried_models, check_stream

torch.set_num_threads(2)

ENGINE = dict(slots=3, page_size=4, prefill_chunk=8, max_ctx=64)
#: repetitive prompts (n-gram drafts land), plain ones, and two that share
#: a 9-token prefix (2 full pages and 1 token of a third: with the prefix
#: cache on the later one hits and forks the partial page)
PREFIX = [3, 9, 4, 3, 9, 4, 3, 9, 4]
PROMPTS = [[1, 2, 3, 1, 2, 3, 1, 2], [7, 5], PREFIX + [8, 8],
           [11, 12, 13, 11, 12, 13, 11], [42], PREFIX + [1]]
MAX_NEW = 14
MESH = dict(mesh_shape=(4, 2), axis_names=("dp", "tp"))


@pytest.fixture(scope="module")
def models():
    jlm, tlm = carried_models()
    jd = jdec.decoder_draft(jlm, seed=3)
    td = tdec.decoder_draft(tlm, seed=3).load_jax_params(
        jax.tree.map(np.asarray, jd.jax_params()))
    return jlm, tlm, td


def _engine(lm, make=DecodeEngine, **kw):
    kw = dict(ENGINE, **kw)
    if make is DecodeEngine:
        kw["device"] = "cpu"
    return make(lm, name="llm", **kw)


def _serve(eng, prompts=PROMPTS, max_new=MAX_NEW, stop=True):
    """Serve ``prompts``, all queued under the engine's lock before its
    first step; with ``stop``, stop the engine and check its pages."""
    try:
        with eng._cond:
            futs = [eng.submit(list(p), max_new_tokens=max_new)
                    for p in prompts]
        return [f.result(timeout=300)["tokens"] for f in futs]
    finally:
        if stop:
            assert eng.stop()
            assert eng.alloc.num_used == 0
            eng.alloc.check_leaks()


@functools.lru_cache(maxsize=None)
def _plain_ref(tlm, prefix_cache=False):
    """The port's plain synchronous streams (computed once a setting)."""
    return _serve(_engine(tlm, async_decode=False,
                          prefix_cache=prefix_cache))


_JAX = {}


def _jax_ref(jlm, kv_dtype="float32"):
    """The JAX engine's plain synchronous streams (computed once)."""
    if kv_dtype not in _JAX:
        _JAX[kv_dtype] = _serve(_engine(
            jlm, jserving.DecodeEngine, async_decode=False,
            prefix_cache=False, kv_dtype=kv_dtype))
    return _JAX[kv_dtype]


def _drafter(kind, td):
    return (tspec.NGramDrafter() if kind == "ngram"
            else tspec.DraftModelDrafter(td, page_size=4))


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("prefix_cache", [False, True], ids=["nopfx", "pfx"])
@pytest.mark.parametrize("kind", ["ngram", "model"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_speculative_streams_equal_plain(models, k, kind, prefix_cache,
                                         loop):
    jlm, tlm, td = models
    eng = _engine(tlm, speculate=True, spec_k=k,
                  drafter=_drafter(kind, td), prefix_cache=prefix_cache,
                  async_decode=loop == "async")
    got = _serve(eng, stop=False)
    try:
        st = eng.stats()["speculative"]
        assert st["drafter"] == kind and st["k_cap"] == k
        assert st["counters"]["proposals"] > 0
        snap = eng.metrics.snapshot()["models"]["llm"]
        assert snap["counters"]["spec_verify_steps_total"] > 0
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    assert got == _plain_ref(tlm, prefix_cache)
    for p, g, w in zip(PROMPTS, got, _jax_ref(jlm)):
        check_stream(tlm, "float32", p, g, w, ENGINE["page_size"],
                     ENGINE["prefill_chunk"])


QUANT_CASES = {"kv8": dict(kv_dtype="int8"),
               "w8-kv8": dict(quantize="int8", kv_dtype="int8"),
               "w4g16": dict(quantize="int4", quant_group=16),
               "tp2": "tp2", "tp2-w8-kv8": "tp2-w8"}


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("kind", ["ngram", "model"])
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantized_and_tp_speculative_streams_equal_plain(models, case, kind,
                                                          loop):
    jlm, tlm, td = models
    kw = QUANT_CASES[case]
    if isinstance(kw, str):
        if len(jax.devices()) < 8:
            pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
        kw = dict(sharding=ShardingConfig.for_transformer(**MESH))
        if case == "tp2-w8-kv8":
            kw.update(quantize="int8", kv_dtype="int8")
    want = _serve(_engine(tlm, async_decode=False, prefix_cache=False, **kw))
    eng = _engine(tlm, speculate=True, spec_k=3, drafter=_drafter(kind, td),
                  async_decode=loop == "async", **kw)
    assert _serve(eng) == want
    if "quantize" not in kw and "sharding" not in kw:
        for p, g, w in zip(PROMPTS, want, _jax_ref(jlm, kw["kv_dtype"])):
            check_stream(tlm, kw["kv_dtype"], p, g, w, ENGINE["page_size"],
                         ENGINE["prefill_chunk"])


class _Reject(tspec.Drafter):
    """Drafts k tokens at every step that the target (nearly) never picks:
    the pending token plus 61, 62, ... modulo the vocab."""

    name = "reject"

    def propose(self, owner, context, k):
        return [(int(context[-1]) + 61 + i) % 128 for i in range(k)]


def _full_depth(monkeypatch):
    """Hold every sequence's depth at the cap, whatever it accepts, so a
    rejecting drafter drafts (and rolls back) at every step."""
    monkeypatch.setattr(tspec.AdaptiveK, "current", lambda self: self.cap)


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_all_reject_rolls_back_every_verify(models, monkeypatch, kv_dtype,
                                            loop):
    """Drafts that are (nearly) all rejected: after every verify the
    slot's pages are exactly what its confirmed length needs, the pages
    the rejected positions opened are back in the pool, the streams equal
    plain decode's and ``check_leaks()`` is clean at the end.  With int8
    pages a rejected write at a page's slot 0 latched a scale on a page
    that is then freed; the next write there latches afresh (the streams
    would drift from plain decode's otherwise)."""
    tlm = models[1]
    _full_depth(monkeypatch)
    eng = _engine(tlm, speculate=True, spec_k=4, drafter=_Reject(),
                  kv_dtype=kv_dtype, prefix_cache=True,
                  async_decode=loop == "async")
    checked = []
    rollback = eng._rollback_kv

    def checked_rollback(slot, written_end):
        rollback(slot, written_end)
        assert len(eng.alloc.pages(slot.owner)) == pages_for(
            slot.pos, eng.page_size)
        checked.append(written_end - slot.pos)
    monkeypatch.setattr(eng, "_rollback_kv", checked_rollback)
    got = _serve(eng, stop=False)
    try:
        counters = eng.metrics.snapshot()["models"]["llm"]["counters"]
        assert counters["spec_rollbacks_total"] > 0
        assert counters["spec_accepted_tokens_total"] < \
            counters["spec_draft_tokens_total"]
        assert max(checked) > 0           # positions written past the end
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    assert got == _serve(_engine(tlm, async_decode=False, kv_dtype=kv_dtype,
                                 prefix_cache=False))


def test_rollback_forks_a_shared_boundary_page(models, monkeypatch):
    """A prompt whose pages the prefix cache published ends mid-page: the
    first verify writes past its confirmed length into that shared page,
    and the rollback forks it copy-on-write before trimming, so the
    cache's page keeps its reference (dereferenced by the sequence, not
    destroyed) and the sequence owns a private copy."""
    tlm = models[1]
    _full_depth(monkeypatch)
    eng = _engine(tlm, speculate=True, spec_k=4, drafter=_Reject(),
                  prefix_cache=True, async_decode=False)
    forks = []
    fork = eng.alloc.fork

    def counted_fork(owner, page):
        new = fork(owner, page)
        forks.append((page, new, eng.alloc.refcount(page)))
        return new
    monkeypatch.setattr(eng.alloc, "fork", counted_fork)
    prompt = PREFIX + [5]             # 10 tokens: 2 pages and 2 of a third
    try:
        with eng._cond:
            fut = eng.submit(prompt, max_new_tokens=6)
        got = fut.result(timeout=300)["tokens"]
        assert forks, "no copy-on-write fork of the published page"
        old, new, refs = forks[0]
        assert new != old and refs >= 1
        assert eng.prefix_cache.stats()["entries"] >= 1
        # the published page is still held by the cache, not freed
        assert eng.alloc.refcount(old) >= 1
        counters = eng.metrics.snapshot()["models"]["llm"]["counters"]
        assert counters["cow_forks_total"] >= 1
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    assert got == _serve(_engine(tlm, async_decode=False,
                                 prefix_cache=False), [prompt], max_new=6)[0]


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_async_predraft_only_for_host_drafters(models, kind):
    """The async loop drafts the next step while a verify is in flight for
    the n-gram drafter (its overlapped drafts are checked at retire) and
    not for the draft model, whose launches would only queue behind the
    verify on the engine's stream."""
    tlm, td = models[1], models[2]
    eng = _engine(tlm, speculate=True, spec_k=3, drafter=_drafter(kind, td))
    assert eng._spec.drafter.on_device == (kind == "model")
    got = _serve(eng, stop=False)
    try:
        c = eng.stats()["speculative"]["counters"]
        checked = c["predraft_hits"] + c["predraft_misses"]
        assert c["proposals"] > 0
        if kind == "ngram":
            assert c["predraft_hits"] > 0
        else:
            assert checked == 0
    finally:
        assert eng.stop()
    assert got == _plain_ref(tlm)


#: (total pages, A's and B's new tokens) of a pool that holds both
#: sequences only if A's pages come back as soon as its last verify
#: decides it: a finish deferred past B's page growth preempts or fails B
TIGHT_POOLS = {"9p": (9, 9, 24), "11p": (11, 13, 30)}


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("pool", sorted(TIGHT_POOLS))
def test_decided_slot_frees_pages_before_preemption(models, pool, loop):
    """On a tight pool one sequence reaches its length in a verify while
    the other needs a page for the next one.  The async loop parks the
    decided slot in ``finishing`` with its pages held until the step's
    deferred bookkeeping; when the next launch's page growth finds the
    pool dry it finishes that slot first, so nothing is preempted or
    failed (as on the sync loop, which finishes it at once) and both
    streams equal plain decode's."""
    tlm = models[1]
    pages, new_a, new_b = TIGHT_POOLS[pool]
    reqs = [(PROMPTS[0], new_a), (PROMPTS[3], new_b)]
    eng = _engine(tlm, speculate=True, spec_k=3, drafter="ngram",
                  total_pages=pages, prefix_cache=False,
                  async_decode=loop == "async")
    try:
        with eng._cond:
            futs = [eng.submit(list(p), max_new_tokens=n) for p, n in reqs]
        got = [f.result(timeout=300)["tokens"] for f in futs]
        c = eng.metrics.snapshot()["models"]["llm"]["counters"]
        assert c["spec_verify_steps_total"] > 0
        assert c.get("preemptions_total", 0) == 0
        assert c.get("errors_total", 0) == 0
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    plain = _engine(tlm, async_decode=False, prefix_cache=False)
    want = [_serve(plain, [p], max_new=n, stop=False)[0] for p, n in reqs]
    assert plain.stop()
    assert got == want


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("site", ["speculate.draft", "speculate.verify"])
def test_fault_sites_degrade_to_plain(models, site, loop):
    """An injected draft fault poisons one sequence's controller; a verify
    fault turns one step into plain decode and poisons the planned
    sequences.  The engine keeps serving and the streams equal plain
    decode's."""
    tlm = models[1]
    eng = _engine(tlm, speculate=True, spec_k=3, drafter="ngram",
                  async_decode=loop == "async")
    with faults.inject(site, "error", n=1, max_trips=2):
        got = _serve(eng, stop=False)
    try:
        c = eng.stats()["speculative"]["counters"]
        key = "draft_faults" if site == "speculate.draft" else \
            "verify_faults"
        assert c[key] == 2
    finally:
        assert eng.stop()
    eng.alloc.check_leaks()
    assert got == _plain_ref(tlm)


TURN1, TURN2 = [1, 2, 3, 1, 2, 3, 1], [2, 3, 1, 2]


@pytest.mark.parametrize("kind", ["ngram", "model"])
def test_session_exported_mid_speculation_continues(models, kind):
    """Two speculative turns of a session, exported and imported into a
    second speculative engine, continue as the one-engine plain session
    does."""
    tlm, td = models[1], models[2]
    plain = _engine(tlm, async_decode=False, prefix_cache=False)
    try:
        p1 = plain.submit(TURN1, 6, session="s").result(300)["tokens"]
        p2 = plain.submit(TURN2, 6, session="s", resume=True).result(300)
        p3 = plain.submit(TURN1, 8, session="s", resume=True).result(300)
    finally:
        assert plain.stop()
    e1 = _engine(tlm, speculate=True, spec_k=3, drafter=_drafter(kind, td))
    e2 = _engine(tlm, speculate=True, spec_k=3, drafter=_drafter(kind, td))
    try:
        r1 = e1.submit(TURN1, 6, session="s").result(300)["tokens"]
        r2 = e1.submit(TURN2, 6, session="s", resume=True).result(300)
        assert (r1, r2["tokens"]) == (p1, p2["tokens"])
        assert e2.import_session(e1.export_session("s")) == "s"
        r3 = e2.submit(TURN1, 8, session="s", resume=True).result(300)
        assert r3["tokens"] == p3["tokens"]
        assert e1.stats()["speculative"]["counters"]["proposals"] > 0
    finally:
        for e in (e1, e2):
            assert e.stop()
            assert e.alloc.num_used == 0
            e.alloc.check_leaks()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_verify_census_matches_the_wrappers_called(models, monkeypatch,
                                                   quantize):
    """Each verify step calls the kernel wrappers exactly as
    ``verify_launch_stats(width)`` counts them, whatever was accepted."""
    from mxnet_tpu_torch.ops.kernels import epilogue, quant_matmul
    tlm = models[1]
    eng = _engine(tlm, speculate=True, spec_k=4, drafter="ngram",
                  quantize=quantize, async_decode=False)
    calls = {"bias_gelu": 0, "quant_matmul": 0}
    for mod, name in ((epilogue, "bias_gelu"),
                      (quant_matmul, "quant_matmul")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    seen = []
    verify_fn = eng._verify_fn

    def census(width):
        fn = verify_fn(width)

        def run(*a):
            before = dict(calls)
            out = fn(*a)
            seen.append((width, {k: calls[k] - before[k] for k in calls
                                 if calls[k] - before[k]}))
            return out
        return run
    monkeypatch.setattr(eng, "_verify_fn", census)
    _serve(eng)
    assert len({w for w, _ in seen}) > 1      # several widths ran
    for width, got in seen:
        assert got == eng.verify_launch_stats(width)["kernels"]


def test_stats_metrics_and_server_show_speculation(models):
    """``stats()["speculative"]`` carries the JAX engine's keys, the
    metrics snapshot the ``speculative`` block the JAX server reads, and
    the server's Prometheus text its lines."""
    from mxnet_tpu_torch.serving import ModelRegistry, ModelServer
    tlm = models[1]
    srv = ModelServer(ModelRegistry(), host="127.0.0.1", port=0)
    eng = _engine(tlm, speculate=True, spec_k=2, drafter="ngram",
                  metrics=srv.metrics)
    try:
        _serve(eng, stop=False)
        st = eng.stats()["speculative"]
        assert set(st) == {"drafter", "k_cap", "controllers", "counters",
                           "drafter_stats"}
        spec = srv.metrics.snapshot()["models"]["llm"]["generate"][
            "speculative"]
        assert 0.0 <= spec["accepted_token_rate"] <= 1.0
        assert spec["verify_step"]["count"] > 0
        text = srv._prometheus_text()
        assert "mxtpu_serving_accepted_token_rate{" in text
        assert "mxtpu_serving_spec_verify_step_" in text
        assert "mxtpu_serving_spec_draft_step_" in text
    finally:
        assert eng.stop()


def test_engine_knobs(models, monkeypatch):
    """``MXNET_GEN_SPECULATE`` turns speculation on, the drafter and depth
    come from their knobs, a draft model builder is imported by name, and
    an unknown drafter is refused."""
    tlm = models[1]
    monkeypatch.setenv("MXNET_GEN_SPECULATE", "1")
    monkeypatch.setenv("MXNET_GEN_SPEC_K", "2")
    monkeypatch.setenv("MXNET_GEN_SPEC_DRAFTER", "model")
    monkeypatch.setenv("MXNET_GEN_SPEC_DRAFT_BUILDER",
                       "mxnet_tpu_torch.models.decoder:decoder_draft")
    eng = _engine(tlm)
    try:
        st = eng.stats()["speculative"]
        assert st["drafter"] == "model" and st["k_cap"] == 2
        d = eng._spec.drafter
        assert d.cfg.head_dim == 16 and d.model.device == tlm.device
        assert eng.warmup() == 2 + 2
    finally:
        assert eng.stop()
    monkeypatch.delenv("MXNET_GEN_SPECULATE")
    assert "speculative" not in _engine(tlm).stats()
    with pytest.raises(ValueError, match="drafter"):
        _engine(tlm, speculate=True, drafter="oracle")
    assert generate._accept([5, 6, 7, 9], [6, 7, 8, 1]) == ([6, 7, 8], 2)
    assert generate._accept([5], [4]) == ([4], 0)
