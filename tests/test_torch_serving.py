"""Port parity: ``mxnet_tpu_torch.serving.DecodeEngine`` against the JAX
``mxnet_tpu.serving.DecodeEngine`` on the CPU, on the weights of the JAX
``decoder_tiny_lm(seed=0)``, with random biases and LN affines, carried
across by ``params_from_jax``.

The traffic mixes prompt lengths across several prefill chunks, runs a
page pool small enough to force preemption, and ends one stream on EOS
(an EOS id taken from the port's own greedy decode, in this run, that
only that stream holds).  The
port's token streams must equal the JAX engine's, computed in the same
run; where one differs, the port's ``full_forward`` logits must show a
near-tie (top-2 margin below 1e-4) at the first differing position.  The
port serves once with ``MXNET_DECODE_FUSED=1`` and once with ``=0``, so
both decode steps' plain versions serve.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu.serving as jserving
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.serving import DecodeEngine, ServingError
from mxnet_tpu_torch.serving import kvcache as tkv
from torch_parity import tiny_lm_with_affine

torch.set_num_threads(2)

ENGINE = dict(slots=3, page_size=4, max_ctx=40, total_pages=13,
              prefill_chunk=8)
PROMPT_LENS = (3, 11, 20, 7, 17)
MAX_NEW = (12, 10, 8, 14, 9)


def _greedy(tlm, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        lg = tdec.full_forward(tlm.params(), tlm.config,
                               torch.tensor([toks]))[0, -1]
        toks.append(int(lg.argmax()))
    return toks[len(prompt):]


@pytest.fixture(scope="module")
def setup():
    jlm = tiny_lm_with_affine()
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    cfg = jlm.config
    tlm = tdec.decoder_tiny_lm(device="cpu").load_jax_params(params_np)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), m)
            for n, m in zip(PROMPT_LENS, MAX_NEW)]
    # EOS: a token of request 0's greedy stream that no other request's
    # greedy stream holds, so only request 0 ends on it and the others
    # still fill the pool
    streams = [_greedy(tlm, p, n) for p, n in reqs]
    others = {t for st in streams[1:] for t in st}
    eos = next(t for t in streams[0] if t not in others)
    eng = jserving.DecodeEngine(jlm, name="llm", eos_id=eos,
                                prefix_cache=False, async_decode=False,
                                **ENGINE)
    try:
        with eng._cond:      # every request queued before the first step
            futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        ref = [f.result(timeout=300) for f in futs]
    finally:
        assert eng.stop()
    return tlm, reqs, eos, ref


def _check_stream(tlm, prompt, got, want):
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    lg = tdec.full_forward(tlm.params(), tlm.config,
                           torch.tensor([prompt + got[:i]]))[0, -1]
    top2 = torch.topk(lg, 2).values
    margin = float(top2[0] - top2[1])
    assert margin < 1e-4, (
        "streams differ at %d without a near-tie (margin %.3g): %s vs %s"
        % (i, margin, got, want))


@pytest.mark.parametrize("fused", ["1", "0"])
def test_engine_streams_match_jax(monkeypatch, setup, fused):
    tlm, reqs, eos, ref = setup
    monkeypatch.setenv("MXNET_DECODE_FUSED", fused)
    eng = DecodeEngine(tlm, name="llm", eos_id=eos, device="cpu", **ENGINE)
    assert eng.decode_fused == (fused == "1")
    try:
        with eng._cond:      # every request queued before the first step
            futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        assert eng.stop()
    for (prompt, _), o, r in zip(reqs, outs, ref):
        _check_stream(tlm, prompt, o["tokens"], r["tokens"])
        if o["tokens"] == r["tokens"]:
            assert o["finish_reason"] == r["finish_reason"]
    assert outs[0]["finish_reason"] == "eos"
    assert outs[0]["tokens"][-1] == eos
    counters = eng.metrics.snapshot()["models"]["llm"]["counters"]
    assert counters["preemptions_total"] >= 1
    assert counters["sequences_completed_total"] == len(reqs)
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()


@pytest.mark.parametrize("fused", ["1", "0"])
def test_preemption_inside_decode_batch(monkeypatch, setup, fused):
    """Without EOS this traffic preempts a decode slot while a peer earlier
    in the same batch grows its pages; the preempted slot must be skipped
    (not read), so no request fails and every stream equals the greedy
    ``full_forward`` oracle."""
    tlm, reqs = setup[0], setup[1]
    monkeypatch.setenv("MXNET_DECODE_FUSED", fused)
    eng = DecodeEngine(tlm, name="llm", device="cpu", **ENGINE)
    try:
        with eng._cond:      # every request queued before the first step
            futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        assert eng.stop()
    counters = eng.metrics.snapshot()["models"]["llm"]["counters"]
    assert counters["preemptions_total"] >= 1
    assert counters["errors_total"] == 0
    for (prompt, n), o in zip(reqs, outs):
        _check_stream(tlm, prompt, o["tokens"], _greedy(tlm, prompt, n))


def test_decode_step_fault_fails_batch_typed(setup):
    """The ``decode.step`` fault site poisons only the decode batch, typed;
    the engine keeps serving the next request."""
    tlm = setup[0]
    eng = DecodeEngine(tlm, name="llm", device="cpu", **ENGINE)
    try:
        with faults.inject("decode.step", "error", n=1, max_trips=1):
            fut = eng.submit([1, 2, 3], max_new_tokens=4)
            with pytest.raises(ServingError):
                fut.result(timeout=60)
        assert len(eng.submit([1, 2, 3], max_new_tokens=4).result(
            timeout=60)["tokens"]) == 4
    finally:
        assert eng.stop()
    assert eng.alloc.num_used == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_page_allocator_matches_jax(seed):
    """One random run of allocations and frees, through an exhausted
    pool, hands out the same page ids, fails the same allocations and
    keeps the same accounts in both packages."""
    rng = np.random.default_rng(seed)
    j = jkv.PageAllocator(9, 4, page_bytes=64)
    t = tkv.PageAllocator(9, 4, page_bytes=64)
    ooms = 0
    for _ in range(80):
        owner = int(rng.integers(0, 4))
        if rng.random() < 0.6:
            n = int(rng.integers(1, 4))
            try:
                want = j.alloc(owner, n)
            except jkv.CacheOOM:
                want = "oom"
            try:
                got = t.alloc(owner, n)
            except tkv.CacheOOM:
                got = "oom"
            ooms += got == "oom"
        else:
            want, got = j.free(owner), t.free(owner)
        assert got == want
        js, ts = j.stats(), t.stats()
        for k, v in ts.items():
            if k == "counters":
                assert v == {c: js[k][c] for c in v}
            else:
                assert v == js[k], k
        assert t.check_leaks() == j.check_leaks()
    assert ooms and t.peak_used == 8
