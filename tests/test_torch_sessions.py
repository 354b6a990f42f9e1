"""Port parity: decode sessions.  ``mxnet_tpu_torch.serving.DecodeEngine``
parks a session's pages, continues it, expires and evicts it, exports and
imports it, and ``kvcache.pack_session`` writes the JAX package's wire
format byte for byte, on the CPU.

The model is the JAX ``decoder_tiny_lm(seed=0)`` with random biases and LN
affines, carried across by ``load_jax_params``.  A continuation decodes on
the parked pages what a one-shot request over the whole conversation
decodes on pages it prefills itself; the two must be equal exactly (the
same programs; the decode step's K and V equal the prefill's row for row),
as ``tests/test_llm_serving.py`` holds the JAX engine.  Against the JAX
engine, a continuation must be equal or show a near-tie (top-2 margin
below 1e-4, ``torch_parity.check_stream``) at the first difference.  The
JAX engine runs its synchronous loop, whose streams do not depend on the
host's load (``test_torch_async_engine.py`` says why).
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import mxnet_tpu.serving as jserving
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.serving import (DecodeEngine, SessionResetError,
                                     pack_session, unpack_session)
from mxnet_tpu_torch.serving import generate
from torch_parity import carried_models, check_stream

torch.set_num_threads(2)

ENGINE = dict(slots=4, page_size=4, prefill_chunk=8, max_ctx=48)
TURN1 = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
TURN2 = [7, 8]


@pytest.fixture(scope="module")
def models():
    return carried_models()


def _engine(tlm, **kw):
    return DecodeEngine(tlm, name="llm", device="cpu", **dict(ENGINE, **kw))


def _counters(eng):
    return eng.metrics.snapshot()["models"]["llm"]["counters"]


def _stopped_clean(eng):
    assert eng.stop()
    assert eng.alloc.num_used == 0      # parked sessions released
    assert eng.stats()["sessions"] == 0
    eng.alloc.check_leaks()


def _pages(eng, sid):
    """A parked session's pages on the host: (k, v[, k scales, v scales])."""
    idx = torch.tensor(eng.alloc.pages(eng._sessions[sid].owner))
    if eng.kv_dtype == "int8":
        return [t[:, :, idx].clone() for t in (eng._kp.q, eng._vp.q,
                                               eng._kp.s, eng._vp.s)]
    return [eng._kp[:, :, idx].clone(), eng._vp[:, :, idx].clone()]


@pytest.mark.parametrize("async_decode", [True, False],
                         ids=["async", "sync"])
def test_continuation_matches_one_shot(models, async_decode):
    tlm = models[1]
    eng = _engine(tlm, async_decode=async_decode)
    try:
        r1 = eng.submit(TURN1, max_new_tokens=5, session="s").result(120)
        assert r1["session"] == "s" and eng.stats()["sessions"] == 1
        held = eng.alloc.num_used
        assert held > 0                  # parked pages stay resident
        r2 = eng.submit(TURN2, max_new_tokens=5, session="s",
                        resume=True).result(120)
        one = eng.submit(TURN1 + r1["tokens"] + TURN2,
                         max_new_tokens=5).result(120)
        assert r2["tokens"] == one["tokens"]
        assert eng.stats()["quant"]["tokens_resident"] == (
            len(TURN1) + 5 + len(TURN2) + 4)
    finally:
        _stopped_clean(eng)


def test_continuation_matches_jax_engine(models):
    """The same two turns through the JAX engine's session."""
    jlm, tlm = models
    outs = []
    for eng in (_engine(tlm), jserving.DecodeEngine(
            jlm, name="llm", async_decode=False, **ENGINE)):
        try:
            r1 = eng.submit(TURN1, 5, session="s").result(120)["tokens"]
            r2 = eng.submit(TURN2, 5, session="s",
                            resume=True).result(120)["tokens"]
        finally:
            assert eng.stop()
        outs.append((r1, r2))
    (t1, t2), (j1, j2) = outs
    check_stream(tlm, "float32", TURN1, t1, j1, ENGINE["page_size"],
                 ENGINE["prefill_chunk"])
    if t1 == j1:
        check_stream(tlm, "float32", TURN1 + t1 + TURN2, t2, j2,
                     ENGINE["page_size"], ENGINE["prefill_chunk"])


def test_resume_not_held_resets_typed(models):
    tlm = models[1]
    eng = _engine(tlm)
    try:
        with pytest.raises(SessionResetError):
            eng.submit([1], max_new_tokens=2, session="gone", resume=True)
        assert _counters(eng)["sessions_reset_total"] == 1
    finally:
        _stopped_clean(eng)


class _Monotonic:
    """The engine module's ``time`` with a ``monotonic`` the test moves
    forward by hand (``skip``): a session's TTL then runs out when the test
    says so, never with the host's speed.  Everything else is the real
    ``time``."""

    def __init__(self):
        self.offset = 0.0

    def monotonic(self):
        return time.monotonic() + self.offset

    def skip(self, seconds):
        self.offset += seconds

    def __getattr__(self, name):
        return getattr(time, name)


def test_ttl_expiry_resets_typed(models, monkeypatch):
    """A session idle past ``session_ttl_s`` loses its pages; resuming it
    raises the typed reset and counts ``sessions_reset_total``."""
    tlm = models[1]
    clock = _Monotonic()
    monkeypatch.setattr(generate, "time", clock)
    eng = _engine(tlm, session_ttl_s=60.0, prefix_cache=False)
    try:
        eng.submit([1, 2, 3], max_new_tokens=2, session="brief").result(120)
        assert eng.alloc.num_used > 0
        clock.skip(120.0)                # the session is now idle past 60 s
        deadline = time.time() + 60
        while eng.alloc.num_used and time.time() < deadline:
            time.sleep(0.05)             # the idle worker sweeps the TTL
        assert eng.alloc.num_used == 0
        with pytest.raises(SessionResetError):
            eng.submit([4], max_new_tokens=2, session="brief", resume=True)
        assert _counters(eng)["sessions_reset_total"] == 1
    finally:
        _stopped_clean(eng)


def test_lru_session_evicted_under_pressure(models):
    """A request that does not fit evicts the least recently used idle
    session; that session's resume resets typed, the other continues."""
    tlm = models[1]
    eng = _engine(tlm, prefix_cache=False, total_pages=9, slots=2)
    try:
        a = eng.submit([1, 2, 3, 4, 5, 6], 4, session="a").result(120)
        eng.submit([9, 8, 7, 6, 5, 4], 4, session="b").result(120)
        assert eng.alloc.num_free == 2   # 3 pages each parked
        eng.submit(list(range(10, 20)), 6).result(120)   # needs 4 pages
        assert eng.stats()["sessions"] == 1
        with pytest.raises(SessionResetError):
            eng.submit([1], 2, session="a", resume=True)
        b2 = eng.submit([3], 2, session="b", resume=True).result(120)
        assert len(b2["tokens"]) == 2
        assert a["session"] == "a"
    finally:
        _stopped_clean(eng)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_export_import_round_trip(models, kv_dtype):
    """A parked session exported from one engine and imported into
    another holds bit-equal pages (codes and scales for int8) and
    continues as the exporter would."""
    tlm = models[1]
    e1 = _engine(tlm, kv_dtype=kv_dtype)
    e2 = _engine(tlm, kv_dtype=kv_dtype)
    try:
        e1.submit(TURN1, 5, session="mig").result(120)
        blob = e1.export_session("mig")
        meta, k, v, ks, vs = unpack_session(blob, with_scales=True)
        assert meta["sid"] == "mig" and meta["pos"] == len(TURN1) + 4
        assert (ks is not None) == (kv_dtype == "int8")
        assert e2.import_session(blob) == "mig"
        for a, b in zip(_pages(e1, "mig"), _pages(e2, "mig")):
            assert torch.equal(a, b)
        want = e1.submit(TURN2, 5, session="mig",
                         resume=True).result(120)
        got = e2.submit(TURN2, 5, session="mig", resume=True).result(120)
        assert got["tokens"] == want["tokens"]
        assert _counters(e2)["migrations_in_total"] == 1
        with pytest.raises(KeyError):
            e1.export_session("no-such-session")
    finally:
        _stopped_clean(e1)
        _stopped_clean(e2)


def test_import_refuses_other_kv_dtype(models):
    tlm = models[1]
    e1 = _engine(tlm)
    e2 = _engine(tlm, kv_dtype="int8")
    try:
        e1.submit(TURN1, 3, session="x").result(120)
        with pytest.raises(ValueError, match="KV dtype"):
            e2.import_session(e1.export_session("x"))
        assert e2.stats()["sessions"] == 0
    finally:
        _stopped_clean(e1)
        _stopped_clean(e2)


def _blocks(version):
    rng = np.random.RandomState(3)
    shape = (2, 2, 3, 4, 8)
    if version == "v2":
        k = rng.randint(-127, 128, size=shape).astype("int8")
        v = rng.randint(-127, 128, size=shape).astype("int8")
        ks = rng.rand(*shape[:3]).astype("float32")
        vs = rng.rand(*shape[:3]).astype("float32")
        return k, v, ks, vs
    return (rng.randn(*shape).astype("float32"),
            rng.randn(*shape).astype("float32"), None, None)


META = {"sid": "s", "pos": 11, "pending": 7, "history": [1, 2, 3],
        "gen": 2}


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_pack_session_bytes_match_jax(version):
    k, v, ks, vs = _blocks(version)
    blob = pack_session(META, k, v, ks, vs)
    assert blob == jkv.pack_session(META, k, v, ks, vs)
    hlen = int(np.frombuffer(blob[4:8], ">u4")[0])
    assert (b'"kv_dtype"' in blob[8:8 + hlen]) == (version == "v2")


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_each_package_unpacks_the_others_blob(version):
    k, v, ks, vs = _blocks(version)
    for pack, unpack in ((pack_session, jkv.unpack_session),
                         (jkv.pack_session, unpack_session)):
        meta, k2, v2, ks2, vs2 = unpack(pack(META, k, v, ks, vs),
                                        with_scales=True)
        assert meta == META
        assert k2.tobytes() == k.tobytes() and v2.tobytes() == v.tobytes()
        if ks is None:
            assert ks2 is None and vs2 is None
        else:
            assert ks2.tobytes() == ks.tobytes()
            assert vs2.tobytes() == vs.tobytes()
    bad = bytearray(pack_session(META, k, v, ks, vs))
    bad[-1] ^= 0xFF
    for unpack in (unpack_session, jkv.unpack_session):
        with pytest.raises(ValueError, match="CRC"):
            unpack(bytes(bad), with_scales=True)


def test_port_blob_imports_into_jax_engine(models):
    """A session the port exports continues in the JAX engine as it does
    in the port."""
    jlm, tlm = models
    eng = _engine(tlm)
    jeng = jserving.DecodeEngine(jlm, name="llm", async_decode=False,
                                 **ENGINE)
    try:
        r1 = eng.submit(TURN1, 5, session="m").result(120)["tokens"]
        assert jeng.import_session(eng.export_session("m")) == "m"
        want = eng.submit(TURN2, 5, session="m", resume=True).result(120)
        got = jeng.submit(TURN2, 5, session="m", resume=True).result(120)
        check_stream(tlm, "float32", TURN1 + r1 + TURN2, want["tokens"],
                     got["tokens"], ENGINE["page_size"],
                     ENGINE["prefill_chunk"])
    finally:
        _stopped_clean(eng)
        assert jeng.stop()


@pytest.mark.parametrize("site", ["session.export", "session.import"])
def test_session_fault_sites_fail_typed(models, site):
    """An injected ``session.export``/``session.import`` fault fails that
    call with the injected error; the session stays parked on the
    exporter and nothing is installed on the importer."""
    tlm = models[1]
    e1, e2 = _engine(tlm), _engine(tlm)
    try:
        e1.submit(TURN1, 3, session="f").result(120)
        blob = None if site == "session.export" else e1.export_session("f")
        with faults.inject(site, "error", n=1, max_trips=1):
            with pytest.raises(RuntimeError, match="injected"):
                if blob is None:
                    e1.export_session("f")
                else:
                    e2.import_session(blob)
        assert e1.stats()["sessions"] == 1
        assert e2.stats()["sessions"] == 0 and e2.alloc.num_used == 0
        e2.import_session(e1.export_session("f"))   # the next one goes
        assert e2.stats()["sessions"] == 1
    finally:
        _stopped_clean(e1)
        _stopped_clean(e2)


def test_transcript_record_replays(models):
    """A transcript record (what the JAX engine pulls from its page store)
    parks the conversation's tokens; the next request replays them as a
    fresh prefill and continues as the one-shot request does."""
    tlm = models[1]
    eng = _engine(tlm)
    try:
        r1 = eng.submit(TURN1, 4, session="t").result(120)["tokens"]
        hist = TURN1 + r1[:-1]
        eng._run_op(lambda: eng._install_record(
            "r", {"kind": "transcript", "history": hist,
                  "pending": r1[-1]}, 1))
        got = eng.submit(TURN2, 5, session="r", resume=True).result(120)
        one = eng.submit(TURN1 + r1 + TURN2, 5).result(120)
        assert got["tokens"] == one["tokens"]
        c = _counters(eng)
        assert c["migrations_in_total"] == 1
        assert c["migrations_replayed_total"] == 1
    finally:
        _stopped_clean(eng)
