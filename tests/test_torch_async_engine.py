"""Port parity: the async decode pipeline of ``mxnet_tpu_torch.serving.
DecodeEngine`` against its own synchronous loop and the JAX package's
engine on the CPU (the port of ``tests/test_async_engine.py``, without its
speculative cases).

The model is the JAX ``decoder_tiny_lm(seed=0)`` with random biases and LN
affines, carried across by ``load_jax_params``.  The async engine changes
when host work happens, never what is computed: within the port its
streams must equal the synchronous loop's exactly (the same programs on
the same inputs).  Against the JAX engine they must be equal too; where
one differs, the port's prefill program over the stream's prefix must
show a near-tie at the first differing position (top-2 margin below
1e-4, ``torch_parity.check_stream``).  The JAX reference runs its
synchronous loop, as every other port serving test's does: the JAX async
engine's int8-KV streams depend on the host's load (one run in 100 under
five concurrent processes decoded ``[12, 12, 12, 12, 12, 12, 93, 93]``
where it otherwise decodes ``[12, 12, 12, 93, 93, 93, 93, 93]``), which
the JAX package's own tests hold it to apart.  On the CPU every kernel's plain
version serves; the CUDA stream, pinned staging and events are held on
the card by ``chip_smoke.py``.
"""
from __future__ import annotations

import threading
import time

import pytest
import torch

import mxnet_tpu.serving as jserving
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.parallel import ShardingConfig
from mxnet_tpu_torch.serving import DecodeEngine, PrefixCache, ServingError
from mxnet_tpu_torch.serving import generate
from torch_parity import carried_models, check_stream

torch.set_num_threads(2)

ENGINE = dict(slots=4, page_size=8, prefill_chunk=8, max_ctx=64)
PROMPTS = [[1, 2, 3], [7, 5], [2, 9, 4, 1], [3], [11, 3, 7]]
SHARED = list(range(1, 18))          # 2 full pages of 8 + 1 token
MATRIX = {
    "plain": ({}, PROMPTS),
    # the shared prefix is served alone first, so the others hit its
    # pages and fork its partial one copy-on-write
    "prefix_cow": ({"prefix_cache": True},
                   [SHARED, SHARED + [20, 21], SHARED + [30, 31],
                    SHARED + [40]]),
    # prompts longer than the chunk, so prefill spans many steps while
    # decode lanes have launches in flight
    "chunked_prefill": ({"prefill_chunk": 4},
                        [list(range(1, 20)), list(range(2, 12)), [5, 6, 7]]),
    "preemption": ({"slots": 3, "page_size": 4, "max_ctx": 32,
                    "total_pages": 9}, PROMPTS),
    "int8_kv": ({"kv_dtype": "int8"}, PROMPTS),
}
MAX_NEW = 8


@pytest.fixture(scope="module")
def models():
    return carried_models()


def _engine(lm, make=DecodeEngine, **kw):
    kw = dict(ENGINE, **kw)
    if make is DecodeEngine:
        kw["device"] = "cpu"
    return make(lm, name="llm", **kw)


def _serve(eng, prompts, max_new=MAX_NEW, serial_first=False):
    """Serve ``prompts`` (the first alone when ``serial_first``); stop the
    engine and check that its pages are all back.  The requests are
    submitted under the engine's lock, so all are queued before its first
    step and the schedule (admissions, preemptions) does not depend on
    how fast the host runs the worker."""
    try:
        out = []
        if serial_first:
            out.append(eng.submit(prompts[0], max_new_tokens=max_new)
                       .result(timeout=300)["tokens"])
            prompts = prompts[1:]
        with eng._cond:
            futs = [eng.submit(list(p), max_new_tokens=max_new)
                    for p in prompts]
        out += [f.result(timeout=300)["tokens"] for f in futs]
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()
    return out


_JAX_REF = {}


def _jax_ref(jlm, case):
    """The JAX engine's streams for a matrix case (computed once), on its
    synchronous loop."""
    if case not in _JAX_REF:
        kw, prompts = MATRIX[case]
        _JAX_REF[case] = _serve(
            _engine(jlm, jserving.DecodeEngine, async_decode=False, **kw),
            prompts, serial_first=case == "prefix_cow")
    return _JAX_REF[case]


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "per_op"])
@pytest.mark.parametrize("case", sorted(MATRIX))
def test_async_streams_match_sync_and_jax(monkeypatch, models, case, fused):
    jlm, tlm = models
    monkeypatch.setenv("MXNET_DECODE_FUSED", fused)
    kw, prompts = MATRIX[case]
    serial = case == "prefix_cow"
    a_eng = _engine(tlm, async_decode=True, **kw)
    a = _serve(a_eng, prompts, serial_first=serial)
    s = _serve(_engine(tlm, async_decode=False, **kw), prompts,
               serial_first=serial)
    assert a == s
    counters = a_eng.metrics.snapshot()["models"]["llm"]["counters"]
    assert counters["deferred_reads_total"] == counters["decode_steps_total"]
    if case == "prefix_cow":
        assert counters["prefix_hits_total"] == 3
        assert counters["cow_forks_total"] == 3
    if case == "preemption":
        assert counters["preemptions_total"] >= 1
    eng_kw = dict(ENGINE, **kw)
    for p, got, want in zip(prompts, a, _jax_ref(jlm, case)):
        check_stream(tlm, kw.get("kv_dtype", "float32"), p, got, want,
                     eng_kw["page_size"], eng_kw["prefill_chunk"])


def test_async_tp2_streams_match_sync(models):
    """Tensor-parallel serving (tp 2, the shards in turn on the CPU) under
    the pipeline: its streams equal the TP synchronous loop's exactly and
    the JAX 1-chip engine's by the near-tie rule (the row-parallel
    sums add in another order)."""
    jlm, tlm = models
    tp2 = ShardingConfig.for_transformer(mesh_shape=(1, 2),
                                         axis_names=("dp", "tp"))
    a_eng = _engine(tlm, async_decode=True, sharding=tp2)
    assert a_eng.tp == 2
    a = _serve(a_eng, PROMPTS)
    s = _serve(_engine(tlm, async_decode=False, sharding=tp2), PROMPTS)
    assert a == s
    for p, got, want in zip(PROMPTS, a, _jax_ref(jlm, "plain")):
        check_stream(tlm, "float32", p, got, want, ENGINE["page_size"],
                     ENGINE["prefill_chunk"])


def test_async_launch_stats_identical_to_sync(models):
    """Pipelining reorders launches; it does not change the kernel launches
    of one decode step or of one prefill chunk."""
    tlm = models[1]
    a = _engine(tlm, async_decode=True)
    s = _engine(tlm, async_decode=False)
    try:
        assert a.decode_fused == s.decode_fused
        assert dict(a.launch_stats) == dict(s.launch_stats)
    finally:
        a.stop(drain=False)
        s.stop(drain=False)


def test_launch_half_makes_no_blocking_copy(monkeypatch, models):
    """No plain upload or host read runs between a launch and its retire:
    ``_launch_decode`` calls neither ``torch.tensor`` nor ``Tensor.cpu``,
    ``item`` or ``tolist`` (on the card each would synchronise the
    stream).  The inputs go up through the staging rings.  ``warmup``
    first, as a server does: the fused step uploads its weight-pointer
    table at its first call."""
    tlm = models[1]
    eng = _engine(tlm, async_decode=True)
    eng.warmup()
    launch = eng._launch_decode
    calls = []

    def guarded():
        def refuse(name):
            def fn(*a, **k):
                calls.append(name)
                raise AssertionError("%s in the launch half" % name)
            return fn
        with monkeypatch.context() as m:
            m.setattr(torch, "tensor", refuse("torch.tensor"))
            for name in ("cpu", "item", "tolist"):
                m.setattr(torch.Tensor, name, refuse("Tensor." + name))
            return launch()

    eng._launch_decode = guarded
    ref = _serve(_engine(tlm, async_decode=False), PROMPTS[:3])
    assert _serve(eng, PROMPTS[:3]) == ref
    assert not calls


def test_engine_retire_fault_poisons_flight_only(models):
    """A retire fault fails exactly the poisoned flight's lanes (typed
    ServingError), discards the rest of the pipeline, and the engine keeps
    serving with a clean page pool."""
    tlm = models[1]
    eng = _engine(tlm, async_decode=True, prefix_cache=False)
    try:
        with faults.inject("engine.retire", "error", n=1, max_trips=1):
            fut = eng.submit([1, 2, 3], max_new_tokens=10)
            with pytest.raises(ServingError, match="retire"):
                fut.result(timeout=120)
        assert eng.alloc.num_used == 0  # poisoned lanes freed their pages
        res = eng.submit([1, 2, 3], max_new_tokens=4).result(timeout=120)
        snap = eng.metrics.snapshot()["models"]["llm"]
        assert snap["counters"]["errors_total"] == 1
    finally:
        assert eng.stop()
    ref = _serve(_engine(tlm, async_decode=False), [[1, 2, 3]], max_new=4)
    assert res["tokens"] == ref[0]
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()


class _StepClock:
    """The engine module's ``time`` with a ``perf_counter`` that steps
    ``step`` seconds a call: a deadline then expires after a count of the
    engine's clock reads (about four a decoded token on the CPU), never
    with the host's speed.  Everything else is the real ``time``."""

    def __init__(self, step):
        self.step, self._t, self._lock = step, 0.0, threading.Lock()

    def perf_counter(self):
        with self._lock:
            self._t += self.step
            return self._t

    def __getattr__(self, name):
        return getattr(time, name)


def test_async_deadline_expires_under_deep_queue(models, monkeypatch):
    """Deadlines are judged at launch and retire: with a dispatch depth of
    3 an expired stream still ends with ``finish_reason="deadline"``
    instead of riding the pipeline to its length, and its pages come
    back."""
    tlm = models[1]
    # 1 ms a clock read, a 40 ms deadline: the 120-token stream expires
    # after some 40 reads, with tokens out and launches in flight
    monkeypatch.setattr(generate, "time", _StepClock(1e-3))
    eng = _engine(tlm, async_decode=True, dispatch_ahead=3, max_ctx=128)
    try:
        res = eng.submit([1, 2, 3], max_new_tokens=120,
                         deadline_ms=40.0).result(timeout=120)
        assert res["finish_reason"] == "deadline"
        assert 0 < len(res["tokens"]) < 120
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()


def test_async_drain_mid_pipeline_completes_all(models, monkeypatch):
    """stop(drain=True) while launches are in flight: the worker drains the
    pipe, every stream completes as the sync loop's, and occupancy ends at
    zero (every in-flight pin released)."""
    tlm = models[1]
    ref = _serve(_engine(tlm, async_decode=False), PROMPTS, max_new=12)
    eng = _engine(tlm, async_decode=True, dispatch_ahead=2)
    # the worker waits at its first retire, launches in the pipe, until
    # stop(drain=True) has been asked for
    held, go = threading.Event(), threading.Event()
    retire = eng._retire_one

    def gated_retire():
        if not held.is_set():
            held.set()
            assert go.wait(120)
        return retire()

    monkeypatch.setattr(eng, "_retire_one", gated_retire)
    futs = [eng.submit(list(p), max_new_tokens=12) for p in PROMPTS]
    stopped = []
    try:
        assert held.wait(120)
        assert eng._pipe
        stopper = threading.Thread(
            target=lambda: stopped.append(eng.stop(drain=True)))
        stopper.start()
        with eng._cond:
            assert eng._cond.wait_for(lambda: eng._stopping, timeout=120)
    finally:
        go.set()
    stopper.join(120)
    assert stopped == [True]
    assert [f.result(timeout=10)["tokens"] for f in futs] == ref
    assert eng.stats()["async"]["inflight"] == 0
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()


@pytest.mark.parametrize("async_decode", [True, False],
                         ids=["async", "sync"])
def test_host_gap_and_dispatch_depth(models, async_decode):
    """Both loops record the host gap (the scheduling time between one
    step's tokens landing and the next launch); the async loop also
    records its dispatch depth and one deferred read per step."""
    tlm = models[1]
    eng = _engine(tlm, async_decode=async_decode, dispatch_ahead=2)
    try:
        for f in [eng.submit(p, max_new_tokens=10) for p in PROMPTS]:
            f.result(timeout=120)
        snap = eng.metrics.snapshot()["models"]["llm"]
    finally:
        assert eng.stop()
    gen = snap["generate"]
    assert gen["host_gap_us"]["count"] > 0
    reads = snap["counters"]["deferred_reads_total"]
    if async_decode:
        assert gen["dispatch_depth"]["count"] == reads > 0
        assert 1 <= gen["dispatch_depth"]["max"] <= 3
    else:
        assert reads == 0
        assert gen.get("dispatch_depth", {"count": 0})["count"] == 0


def test_async_stats(models):
    tlm = models[1]
    eng = _engine(tlm, async_decode=True, dispatch_ahead=2)
    try:
        assert eng.stats()["async"] == {
            "enabled": True, "dispatch_ahead": 2, "inflight": 0,
            "prefill_drains": 0, "staging_waits": 0}
        for f in [eng.submit(p, max_new_tokens=10) for p in PROMPTS]:
            f.result(timeout=120)
        st = eng.stats()["async"]
        assert st["inflight"] == 0          # all retired
        assert st["staging_waits"] == 0     # CPU rings never wait
    finally:
        assert eng.stop()
    s = _engine(tlm, async_decode=False)
    s.stop()
    assert s.stats()["async"]["enabled"] is False


def test_defaults_are_the_jax_engines(monkeypatch, models):
    """With no arguments and no environment the port serves as the JAX
    engine does: async with dispatch depth 1 and a prefix cache; the
    environment turns each off."""
    jlm, tlm = models
    for var in ("MXNET_GEN_ASYNC", "MXNET_GEN_PREFIX_CACHE",
                "MXNET_GEN_DISPATCH_AHEAD"):
        monkeypatch.delenv(var, raising=False)
    eng = DecodeEngine(tlm, device="cpu")
    jeng = jserving.DecodeEngine(jlm)
    try:
        assert eng.async_decode is True and jeng.async_decode is True
        assert eng.dispatch_ahead == jeng.dispatch_ahead == 1
        assert isinstance(eng.prefix_cache, PrefixCache)
        assert jeng.prefix_cache is not None
        assert eng.session_ttl_s == jeng.session_ttl_s == 300.0
    finally:
        eng.stop()
        jeng.stop()
    monkeypatch.setenv("MXNET_GEN_ASYNC", "0")
    monkeypatch.setenv("MXNET_GEN_PREFIX_CACHE", "0")
    monkeypatch.setenv("MXNET_GEN_DISPATCH_AHEAD", "3")
    eng = DecodeEngine(tlm, device="cpu")
    try:
        assert eng.async_decode is False
        assert eng.prefix_cache is None
        assert eng.dispatch_ahead == 3
    finally:
        eng.stop()
