"""Port parity: quantized serving through ``mxnet_tpu_torch.serving.
DecodeEngine`` against the JAX ``DecodeEngine`` on the CPU, on the JAX
``decoder_tiny_lm(seed=0)`` with random biases and LN affines carried
across by ``params_from_jax``.

For int8 weights + fp KV, int4 (group 32) weights + fp KV, int8 weights +
int8 KV, and fp weights + int8 KV, the port's token streams must equal
the JAX engine's, computed in the same run; where one differs, the port's
own prefill program (same weights, same KV format, over the stream's
prefix) must show a near-tie (top-2 margin below 1e-4) at the first
differing position.  The prefill chunk (6) is not a multiple of the page
size (4), so chunks start mid-page and cross page starts, and the pool is
small enough to force preemption.  Also: the engine reproduces its own
quantized ``full_forward`` greedily (fp KV), the allocator's int8
accounting equals the JAX allocator's, the env knobs boot a quantized
engine, and quantized serving takes the per-op step with ``quant_matmul``
counted.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu.serving as jserving
from mxnet_tpu.serving import kvcache as jkv
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa
from mxnet_tpu_torch.serving import DecodeEngine, quantize_lm
from mxnet_tpu_torch.serving import kvcache as tkv
from torch_parity import tiny_lm_with_affine

torch.set_num_threads(2)

ENGINE = dict(slots=3, page_size=4, max_ctx=40, total_pages=13,
              prefill_chunk=6)
PROMPT_LENS = (3, 11, 20, 7)
MAX_NEW = (10, 9, 8, 12)
COMBOS = [("int8", None, "float32"), ("int4", 32, "float32"),
          ("int8", None, "int8"), (None, None, "int8")]
IDS = ["w8", "w4g32", "w8-kv8", "kv8"]


@pytest.fixture(scope="module")
def models():
    jlm = tiny_lm_with_affine()
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.decoder_tiny_lm(device="cpu").load_jax_params(params_np)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, jlm.config.vocab_size, n).tolist(), m)
            for n, m in zip(PROMPT_LENS, MAX_NEW)]
    return jlm, tlm, reqs


def _quant_kw(quantize, group, kv_dtype):
    kw = {"kv_dtype": kv_dtype}
    if quantize:
        kw["quantize"] = quantize
    if group:
        kw["quant_group"] = group
    return kw


def _serve(eng, reqs):
    try:
        futs = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        outs = [f.result(timeout=300) for f in futs]
    finally:
        assert eng.stop()
    return outs


def _last_logits(model, kv_dtype, toks):
    """Last-position logits of ``toks`` through the port's own prefill
    program on a fresh one-sequence pool of ``kv_dtype`` pages."""
    cfg, S, chunk = model.config, ENGINE["page_size"], ENGINE["prefill_chunk"]
    pps = -(-len(toks) // S)
    shape = (cfg.num_layers, cfg.num_kv_heads, pps + 1, S, cfg.head_dim)

    def pool():
        if kv_dtype == "int8":
            return tpa.QPages(q=torch.zeros(shape, dtype=torch.int8),
                              s=torch.ones(shape[:3]))
        return torch.zeros(shape)

    kp, vp = pool(), pool()
    fn = tdec.make_prefill_chunk(cfg, S, chunk)
    row = torch.arange(1, pps + 1, dtype=torch.int32)
    for p0 in range(0, len(toks), chunk):
        n = min(chunk, len(toks) - p0)
        padded = torch.zeros(chunk, dtype=torch.int64)
        padded[:n] = torch.tensor(toks[p0:p0 + n])
        _, _, _, last = fn(model.params(), kp, vp, padded, p0, n, row)
    return last


def _check_stream(model, kv_dtype, prompt, got, want):
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    top2 = torch.topk(_last_logits(model, kv_dtype, prompt + got[:i]),
                      2).values
    margin = float(top2[0] - top2[1])
    assert margin < 1e-4, (
        "streams differ at %d without a near-tie (margin %.3g): %s vs %s"
        % (i, margin, got, want))


@pytest.mark.parametrize("quantize,group,kv_dtype", COMBOS, ids=IDS)
def test_quantized_engine_streams_match_jax(monkeypatch, models, quantize,
                                            group, kv_dtype):
    jlm, tlm, reqs = models
    kw = _quant_kw(quantize, group, kv_dtype)
    jeng = jserving.DecodeEngine(jlm, name="llm", prefix_cache=False,
                                 async_decode=False, **ENGINE, **kw)
    ref = _serve(jeng, reqs)
    jquant = jeng.stats()["quant"]
    monkeypatch.setenv("MXNET_DECODE_FUSED", "1")   # quantized: per-op
    eng = DecodeEngine(tlm, name="llm", device="cpu", **ENGINE, **kw)
    outs = _serve(eng, reqs)
    served = eng.model
    for (prompt, _), o, r in zip(reqs, outs, ref):
        _check_stream(served, kv_dtype, prompt, o["tokens"], r["tokens"])
    st = eng.stats()
    assert st["quant"] == jquant
    assert st["quant"] == {"weights": quantize, "group": group,
                           "kv_dtype": kv_dtype, "tokens_resident": 0}
    assert st["kv"]["kv_dtype"] == kv_dtype
    assert not eng.decode_fused and not st["launches"]["fused"]
    L = tlm.config.num_layers
    attn = "paged_attention_int8" if kv_dtype == "int8" else "paged_attention"
    want = {attn: L, "bias_gelu": L}
    if quantize:
        want["quant_matmul"] = 6 * L
    assert st["launches"]["kernels"] == want
    assert st["launches"]["prefill_chunk_kernels"] == {
        k: v for k, v in want.items() if k != attn}
    counters = eng.metrics.snapshot()["models"]["llm"]["counters"]
    assert counters["preemptions_total"] >= 1
    assert counters["sequences_completed_total"] == len(reqs)
    assert eng.alloc.num_used == 0
    eng.alloc.check_leaks()


def _greedy(model, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        lg = tdec.full_forward(model.params(), model.config,
                               torch.tensor([toks]))[0, -1]
        toks.append(int(lg.argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("mode,group", [("int8", 128), ("int4", 32)])
def test_engine_reproduces_quantized_full_forward(models, mode, group):
    """fp KV pages + quantized weights: chunked prefill and paged decode
    reproduce ``full_forward`` over the same integer weights, greedily."""
    tlm, reqs = models[1], models[2]
    qlm = quantize_lm(tlm, mode, group=group)
    eng = DecodeEngine(qlm, name="llm", device="cpu", **ENGINE)
    assert eng.model is qlm and eng.quant[0] == mode
    outs = _serve(eng, reqs[:3])
    for (prompt, n), o in zip(reqs[:3], outs):
        _check_stream(qlm, "float32", prompt, o["tokens"],
                      _greedy(qlm, prompt, n))


def test_allocator_int8_accounting_matches_jax():
    """The scales pool is counted in the physical bytes and the per-token
    cost, as in the JAX allocator."""
    kw = dict(kv_dtype="int8", page_bytes=128, scale_page_bytes=16)
    j, t = jkv.PageAllocator(9, 4, **kw), tkv.PageAllocator(9, 4, **kw)
    for step in (lambda a: a.alloc("s", 2), lambda a: a.alloc("r", 3),
                 lambda a: a.free("s")):
        assert step(t) == step(j)
        ts, js = t.stats(), j.stats()
        assert {k: v for k, v in ts.items() if k != "counters"} == {
            k: js[k] for k in ts if k != "counters"}
    assert ts["pool_bytes"] == 8 * (128 + 16)
    assert ts["kv_bytes_per_token"] == (128 + 16) / 4
    t.check_leaks()
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.PageAllocator(4, 4, kv_dtype="fp8")


def test_env_knobs_boot_quantized_engine(monkeypatch, models):
    tlm = models[1]
    monkeypatch.setenv("MXNET_QUANT_WEIGHTS", "int4")
    monkeypatch.setenv("MXNET_QUANT_GROUP", "32")
    monkeypatch.setenv("MXNET_QUANT_KV", "int8")
    eng = DecodeEngine(tlm, name="llm", device="cpu", **ENGINE)
    try:
        st = eng.stats()
        assert st["quant"]["weights"] == "int4" and st["quant"]["group"] == 32
        assert st["quant"]["kv_dtype"] == "int8"
        assert isinstance(eng._kp, tpa.QPages)
        assert eng._kp.q.dtype == torch.int8
        assert tuple(eng._kp.s.shape) == tuple(eng._kp.q.shape[:3])
        assert len(eng.submit([1, 2, 3], max_new_tokens=3).result(
            timeout=60)["tokens"]) == 3
    finally:
        assert eng.stop()
    # the metrics carry the per-token cost with the scales pool counted
    gen = eng.metrics.snapshot()["models"]["llm"]["generate"]
    assert gen["kv_bytes_per_token"] == st["kv"]["kv_bytes_per_token"]
    cfg = tlm.config
    assert st["kv"]["kv_bytes_per_token"] == round(
        2 * cfg.num_layers * cfg.num_kv_heads * (4 * cfg.head_dim + 4) / 4,
        2)


def test_fused_step_refuses_quantized_inputs(models):
    tlm = models[1]
    cfg = tlm.config
    step = tdec.make_decode_step_fused(cfg, 4)
    shape = (cfg.num_layers, cfg.num_kv_heads, 5, 4, cfg.head_dim)
    args = (torch.zeros(2, dtype=torch.int64), torch.zeros(2,
            dtype=torch.int64), torch.zeros((2, 2), dtype=torch.int32),
            torch.zeros(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="fp32 weights"):
        step(quantize_lm(tlm, "int8").params(), torch.zeros(shape),
             torch.zeros(shape), *args)
    qp = tpa.QPages(q=torch.zeros(shape, dtype=torch.int8),
                    s=torch.ones(shape[:3]))
    with pytest.raises(ValueError, match="fp32 pages"):
        step(tlm.params(), qp, qp, *args)
