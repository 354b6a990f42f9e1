"""Port parity at the head dims the decode kernels take beyond 32, 64 and
128: D 16, 48, 80 and 96 (every multiple of 8 in [8, 256] runs: the
multiples of 16 up to 128 on kernels of their own, any other D on its
class's; see ``csrc/decode_common.cuh:split_class``).
``test_torch_head_dims_any.py`` holds the other multiples of 8.

On the CPU each wrapper takes its plain version, which the card's kernel
is held to by ``chip_smoke.py``; here those plain versions are held
against the JAX package at each new D:

- #12 ``fused_cell.decode_layer_group`` against the JAX
  ``decode_layer_group(..., "interpret")`` (the Pallas kernel run by the
  interpreter), one launch for both layers, rows at the split attention's
  edges (the whole table, one key, a page boundary, inactive);
- #13 ``fused_cell.decode_attn_phase`` against the JAX
  ``decode_attn_phase(..., "interpret")``;
- #15 ``paged_attention.paged_attention`` over fp and int8 pages against
  the JAX ``paged_attention`` (its XLA gather path);
- the wrappers' head-dim rule on the path a CUDA tensor takes (a ``meta``
  tensor stands in for the card, as the other refusal tests do): a
  multiple of 8 in [8, 256] passes to the device check, any other D
  raises naming the decode kernels' rule;
- ``decoder_tiny_lm(seed=0)`` (units 64 over 4 heads: D 16, the JAX
  package's own serving-test model) served by the port's engine, fused and
  per-op, with fp and int8 KV pages, against the JAX engine.

Tolerances: fp32 on both sides with sums in other orders (XLA's and
torch's), outputs of order 1: 1e-5 relative and absolute, as
``test_torch_fused_cell.py`` and ``test_torch_tp_phases.py`` hold D 8.
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
from mxnet_tpu.ops.pallas import fused_cell as jfc
from mxnet_tpu.ops.pallas import paged_attention as jpa
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import _build
from mxnet_tpu_torch.ops.kernels import fused_cell as tfc
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa
from mxnet_tpu_torch.serving import DecodeEngine
from torch_parity import carried_models, check_stream, tiny_lm_with_affine

torch.set_num_threads(2)

NEW_DIMS = (16, 48, 80, 96)
RTOL = ATOL = 1e-5
S, B, PPS, TOTAL = 8, 4, 8, 16
#: lengths after this step's append: a row over the whole table, one of
#: one key, one ending on a page boundary, an inactive one
LENGTHS = (S * PPS, 1, 2 * S, 0)


def _step(kvh, d, layers=2, lengths=LENGTHS, seed=1):
    """x (B, units), pages, meta, tables and lengths (B, 1) of one step
    whose rows reach ``lengths`` after the append; page 0 is the scratch
    page inactive rows write."""
    rng = np.random.default_rng(seed)
    lead = (layers,) if layers else ()
    kp = (rng.standard_normal(lead + (kvh, TOTAL, S, d)) * 0.2).astype(
        np.float32)
    vp = (rng.standard_normal(kp.shape) * 0.2).astype(np.float32)
    lengths = np.array(lengths, np.int32)
    tables = np.zeros((B, PPS), np.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        need = -(-int(n) // S)
        tables[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    pos = np.maximum(lengths - 1, 0)
    act = lengths > 0
    wp = np.where(act, tables[np.arange(B), pos // S], 0).astype(np.int32)
    ws = np.where(act, pos % S, 0).astype(np.int32)
    return kp, vp, np.stack([wp, ws]), tables, lengths[:, None], rng


@functools.lru_cache(maxsize=None)
def _models(d):
    """The JAX tiny LM with random affines at head dim ``d`` (2 heads over
    1 KV head, so g 2) and the port's with its weights."""
    geom = dict(vocab_size=64, num_layers=2, units=2 * d, hidden_size=64,
                num_heads=2, num_kv_heads=1, max_length=64)
    jlm = tiny_lm_with_affine(**geom)
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.CausalLM(**geom, device="cpu").load_jax_params(params_np)
    assert tlm.config.head_dim == d
    return jlm, tlm


@pytest.mark.parametrize("d", NEW_DIMS)
def test_decode_layer_group_matches_jax_interpret(d):
    jlm, tlm = _models(d)
    cfg = jlm.config
    kp, vp, meta, tables, lengths, rng = _step(cfg.num_kv_heads, d)
    x = rng.standard_normal((B, cfg.units)).astype(np.float32)
    kg, vg, jx = jfc.decode_layer_group(
        jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jdec._stack_layer_params(jlm.jax_params(), 0, cfg.num_layers),
        jnp.asarray(meta), jnp.asarray(tables), jnp.asarray(lengths), cfg,
        "interpret")
    tkp, tvp = torch.tensor(kp), torch.tensor(vp)
    _, _, tx = tfc.decode_layer_group(
        torch.tensor(x), tkp, tvp, tlm.params()["layers"],
        torch.tensor(meta), torch.tensor(tables), torch.tensor(lengths),
        tlm.config)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL,
                               atol=ATOL)
    # page 0 is the scratch page the inactive row writes
    for got, want in ((tkp, kg), (tvp, vg)):
        np.testing.assert_allclose(got.numpy()[:, :, 1:],
                                   np.asarray(want)[:, :, 1:], rtol=RTOL,
                                   atol=ATOL)


def _phase_weights(C, H, KVH, d, rng):
    def w(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return {"wq": w(H * d, C), "bq": w(H * d), "wk": w(KVH * d, C),
            "bk": w(KVH * d), "wv": w(KVH * d, C), "bv": w(KVH * d),
            "wo": w(C, H * d), "bo": w(C)}


@pytest.mark.parametrize("d", NEW_DIMS)
@pytest.mark.parametrize("H,KVH", [(2, 2), (4, 2)], ids=["g1", "g2"])
def test_attn_phase_matches_jax_interpret(d, H, KVH):
    C = 32
    kp, vp, meta, tables, lengths, rng = _step(KVH, d, layers=0)
    x = rng.standard_normal((B, C)).astype(np.float32)
    lp = _phase_weights(C, H, KVH, d, rng)
    kw = dict(vocab_size=64, num_layers=1, units=C, hidden_size=64,
              num_heads=H, num_kv_heads=KVH, head_dim=d, max_length=64)
    jkp, jvp, jo = jfc.decode_attn_phase(
        jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(meta),
        jnp.asarray(tables), jnp.asarray(lengths), jdec.DecoderConfig(**kw),
        "interpret")
    tkp, tvp = torch.tensor(kp), torch.tensor(vp)
    _, _, to = tfc.decode_attn_phase(
        torch.tensor(x), tkp, tvp, {k: torch.tensor(v) for k, v in lp.items()},
        torch.tensor(meta), torch.tensor(tables), torch.tensor(lengths[:, 0]),
        tdec.DecoderConfig(**kw))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    for got, want in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(got.numpy()[:, 1:],
                                   np.asarray(want)[:, 1:], rtol=RTOL,
                                   atol=ATOL)
    assert not to[3].any()            # the inactive row reads nothing


@pytest.mark.parametrize("d", NEW_DIMS)
@pytest.mark.parametrize("pages", ["fp", "int8"])
def test_paged_attention_matches_jax(d, pages):
    KVH, g = 2, 3
    kp, vp, _, tables, lengths, rng = _step(KVH, d, layers=0)
    lengths = lengths[:, 0]
    q = rng.standard_normal((B, KVH * g, d)).astype(np.float32)
    if pages == "fp":
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
        tk, tv = torch.tensor(kp), torch.tensor(vp)
    else:
        codes = [rng.integers(-127, 128, kp.shape).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random(kp.shape[:2]) * 0.05).astype(np.float32)
                  for _ in range(2)]
        jk, jv = (jpa.QPages(jnp.asarray(c), jnp.asarray(s))
                  for c, s in zip(codes, scales))
        tk, tv = (tpa.QPages(torch.tensor(c), torch.tensor(s))
                  for c, s in zip(codes, scales))
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), jnp.asarray(tables)))
    got = tpa.paged_attention(torch.tensor(q), tk, tv, torch.tensor(lengths),
                              torch.tensor(tables))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got[3].any()                              # length 0


def _meta_calls(d):
    """The three decode wrappers on ``meta`` tensors of head dim ``d``,
    each a thunk: a tensor on neither the CPU nor the card takes the
    kernel's path and must stop at its checks."""
    H = KVH = 2
    m = functools.partial(torch.zeros, device="meta")
    pages = m(KVH, TOTAL, S, d)
    meta, tables, lengths = (m(2, B, dtype=torch.int32),
                             m(B, PPS, dtype=torch.int32),
                             m(B, dtype=torch.int32))
    cfg = tdec.DecoderConfig(vocab_size=64, num_layers=1, units=H * d,
                             hidden_size=64, num_heads=H, num_kv_heads=KVH,
                             head_dim=d, max_length=64)
    x = m(B, H * d)
    return {
        "paged_attention": lambda: tpa.paged_attention(
            m(B, H, d), pages, pages, lengths, tables),
        "paged_attention_int8": lambda: tpa.paged_attention(
            m(B, H, d), tpa.QPages(m(KVH, TOTAL, S, d, dtype=torch.int8),
                                   m(KVH, TOTAL)),
            tpa.QPages(m(KVH, TOTAL, S, d, dtype=torch.int8), m(KVH, TOTAL)),
            lengths, tables),
        "decode_layer_group": lambda: tfc.decode_layer_group(
            x, pages[None], pages[None], [{}], meta, tables, lengths, cfg),
        "decode_attn_phase": lambda: tfc.decode_attn_phase(
            x, pages, pages, {}, meta, tables, lengths, cfg),
    }


@pytest.mark.parametrize("d", _build.HEAD_DIMS["decode"])
def test_head_dims_taken(d):
    """Every multiple of 8 in [8, 256] passes the head-dim check and
    stops at the device check."""
    for name, call in _meta_calls(d).items():
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.parametrize("d", [4, 12, 20, 132, 260, 264])
def test_head_dims_refused(d):
    """Any other head dim raises on the kernel's path, naming the rule."""
    for name, call in _meta_calls(d).items():
        with pytest.raises(ValueError,
                           match=r"head dim %d; the decode kernels .*a "
                                 r"multiple of 8 in \[8, 256\]" % d):
            call()


ENGINE = dict(slots=3, page_size=4, prefill_chunk=8, max_ctx=48)
PROMPTS = [[1, 2, 3], [7, 5, 9, 11, 2, 4, 6, 8, 10], [3], [12, 1, 1]]


@pytest.fixture(scope="module")
def tiny():
    return carried_models()


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "per-op"])
def test_tiny_lm_serves_as_the_jax_engine(monkeypatch, tiny, fused,
                                          kv_dtype):
    """The JAX package's serving-test model, at head dim 16: the port's
    streams equal the JAX engine's, or differ only after a near-tie of
    the port's own prefill."""
    jlm, tlm = tiny
    assert tlm.config.head_dim == 16
    jeng = jserving.DecodeEngine(jlm, name="llm", kv_dtype=kv_dtype,
                                 prefix_cache=False, async_decode=False,
                                 **ENGINE)
    try:
        want = [f.result(timeout=300)["tokens"] for f in
                [jeng.submit(p, max_new_tokens=8) for p in PROMPTS]]
    finally:
        assert jeng.stop()
    monkeypatch.setenv("MXNET_DECODE_FUSED", fused)
    eng = DecodeEngine(tlm, name="llm", device="cpu", kv_dtype=kv_dtype,
                       **ENGINE)
    assert eng.decode_fused == (fused == "1" and kv_dtype == "float32")
    try:
        got = [f.result(timeout=300)["tokens"] for f in
               [eng.submit(p, max_new_tokens=8) for p in PROMPTS]]
    finally:
        assert eng.stop()
    for p, g, w in zip(PROMPTS, got, want):
        check_stream(tlm, kv_dtype, p, g, w, ENGINE["page_size"],
                     ENGINE["prefill_chunk"])
    assert eng.alloc.num_used == 0
