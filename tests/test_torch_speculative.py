"""Port parity of speculative decoding's parts: ``mxnet_tpu_torch``'s wide
verify step (``models.decoder.make_verify_step``), its launch census, the
draft model (``decoder_draft``) and ``serving/speculate.py``'s drafters,
controller and scheduler, against the JAX package's on the CPU.  The
engine's speculative streams are ``test_torch_speculative_engine.py``'s.

- the verify step against the JAX ``make_verify_step`` on the same pages,
  tokens, positions, valid counts, tables and active mask: fp32 weights
  and pages, int8 KV pages (windows that open a page at slot 0, so the
  page-start scale latch runs inside the window), int8 and int4 weights,
  and tp 2 (fp, and int8 weights with int8 pages) on the 8-device CPU mesh
  of ``tests/conftest.py``.  Out-tokens equal; fp pages within 1e-5 (fp32
  sums in other orders, values of order 1); int8 codes within one step and
  latched scales within 1e-5 relative (the same amax over sums in other
  orders);
- the verify step against the port's own per-op decode step run once per
  position (teacher-forced): the same tokens at every position, which is
  what makes speculative streams equal plain ones; the pages within 1e-5
  (fp32 products at M = B W and at M = B, which the CPU's GEMM blocks
  differently: last-bit differences);
- ``NGramDrafter``, ``AdaptiveK`` and ``SpeculativeScheduler`` against the
  JAX classes on the same inputs (pure host code: equal outputs);
- ``DraftModelDrafter`` with the JAX draft model's weights (carried across
  by ``params_from_jax``) against its own greedy decode through
  ``full_forward``, across catch-up, lookahead, trim and rebuild;
- the verify census: the wrappers a verify step calls, counted on the
  CPU, equal ``verify_launch_stats`` whatever the tokens.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import faults as jfaults
from mxnet_tpu.models import decoder as jdec
from mxnet_tpu.ops.pallas import paged_attention as jpa
from mxnet_tpu.parallel.shardcfg import ShardingConfig as JSharding
from mxnet_tpu.serving import quantize as jquant
from mxnet_tpu.serving import speculate as jspec
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa
from mxnet_tpu_torch.parallel import ShardingConfig
from mxnet_tpu_torch.serving import quantize_lm
from mxnet_tpu_torch.serving import speculate as tspec
from mxnet_tpu_torch.serving.kvcache import pages_for
from torch_parity import carried_models

torch.set_num_threads(2)

MESH = dict(mesh_shape=(4, 2), axis_names=("dp", "tp"))
S, PPS, TOTAL, W = 4, 8, 33, 4
#: per slot: the position of the pending token, the tokens fed and
#: whether it is active.  Slot 0's window opens a page at its first
#: position, slot 1's at its last, slot 3's in its middle; slot 2 is
#: inactive, slot 1 rides the step with its pending token alone
POSITIONS = np.array([4, 17, 0, 26], np.int32)
N_VALID = np.array([3, 1, 1, 4], np.int32)
ACTIVE = np.array([True, True, False, True])
# (quantize, int4 group, kv dtype, tp)
VERIFY_CASES = {
    "fp": (None, None, "float32", 1),
    "kv8": (None, None, "int8", 1),
    "w8-kv8": ("int8", None, "int8", 1),
    "w4g16": ("int4", 16, "float32", 1),
    "tp2": (None, None, "float32", 2),
    "tp2-w8-kv8": ("int8", None, "int8", 2),
}


@pytest.fixture(scope="module")
def models():
    return carried_models()


def _state(cfg, kv_dtype, seed=3):
    """numpy pools, tables and the step's tokens."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, cfg.num_kv_heads, TOTAL, S, cfg.head_dim)
    pools = []
    for _ in range(2):
        if kv_dtype == "int8":
            pools.append((rng.integers(-127, 128, shape).astype(np.int8),
                          rng.uniform(0.001, 0.01, shape[:3])
                          .astype(np.float32)))
        else:
            pools.append((rng.standard_normal(shape) * 0.3)
                         .astype(np.float32))
    tables = np.zeros((len(POSITIONS), PPS), np.int32)
    for b in range(len(POSITIONS)):
        tables[b] = 1 + b * PPS + np.arange(PPS)
    tokens = rng.integers(0, cfg.vocab_size, (len(POSITIONS), W)).astype(
        np.int32)
    return pools, tables, tokens


def _jax_pool(p):
    if isinstance(p, tuple):
        return jpa.QPages(jnp.asarray(p[0]), jnp.asarray(p[1]))
    return jnp.asarray(p)


def _torch_pool(p):
    if isinstance(p, tuple):
        return tpa.QPages(q=torch.tensor(p[0]), s=torch.tensor(p[1]))
    return torch.tensor(p)


def _np_pool(p):
    if isinstance(p, (tpa.QPages, jpa.QPages)):
        return np.asarray(p.q), np.asarray(p.s)
    return np.asarray(p)


def _inputs(tables, tokens):
    return (tokens, POSITIONS, N_VALID, tables, ACTIVE)


@functools.lru_cache(maxsize=None)
def _jax_params(jlm, quantize, group, tp):
    if quantize is None:
        return jlm.jax_params()
    return jquant.quantize_params(jlm.jax_params(), quantize,
                                  group=group or 128, tp=tp)


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_verify_step_matches_jax(models, case):
    quantize, group, kv_dtype, tp = VERIFY_CASES[case]
    if tp > 1 and len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    jlm, tlm = models
    cfg = tlm.config
    pools, tables, tokens = _state(cfg, kv_dtype)
    qtok = None
    if quantize == "int8":
        qtok = ("int8",)
    elif quantize == "int4":
        qtok = ("int4", group)
    jfn = jdec.make_verify_step(
        jlm.config, S, W, sharding=(JSharding.for_transformer(**MESH)
                                    if tp > 1 else None),
        quant=qtok, kv_dtype=kv_dtype)
    jk, jv, jout = jfn(_jax_params(jlm, quantize, group, tp),
                       *(_jax_pool(p) for p in pools),
                       *(jnp.asarray(a) for a in _inputs(tables, tokens)))
    model = (quantize_lm(tlm, quantize, group=group or 128) if quantize
             else tlm)
    params = model.params(tp=tp) if quantize else model.params()
    plan = None
    if tp > 1:
        plan = tdec.tp_plan(cfg, ShardingConfig.for_transformer(**MESH))
        params = plan.shard_params(params)
    tk, tv = (_torch_pool(p) for p in pools)
    fn = tdec.make_verify_step(cfg, S, W, plan=plan)
    rk, rv, out = fn(params, tk, tv,
                     *(torch.tensor(a) for a in _inputs(tables, tokens)))
    assert rk is tk and rv is tv                      # in place
    assert out.dtype == torch.int32 and out.shape == (len(POSITIONS), W)
    np.testing.assert_array_equal(out.numpy()[ACTIVE], np.asarray(jout)[
        ACTIVE])
    for got, want in ((tk, jk), (tv, jv)):
        got, want = _np_pool(got), _np_pool(want)
        if kv_dtype == "int8":
            # page 0 is the scratch page padded positions write
            assert np.abs(got[0][:, :, 1:].astype(int)
                          - want[0][:, :, 1:].astype(int)).max() <= 1
            np.testing.assert_allclose(got[1][:, :, 1:], want[1][:, :, 1:],
                                       rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_verify_step_equals_teacher_forced_decode(models, kv_dtype):
    """Position i of the verify step is the decode step's output after
    consuming tokens[:i + 1], and the pages end the same within the
    tolerance of a GEMM of other M."""
    tlm = models[1]
    cfg = tlm.config
    pools, tables, tokens = _state(cfg, kv_dtype, seed=5)
    vk, vv = (_torch_pool(p) for p in pools)
    _, _, out = tdec.make_verify_step(cfg, S, W)(
        tlm.params(), vk, vv,
        *(torch.tensor(a) for a in _inputs(tables, tokens)))
    dk, dv = (_torch_pool(p) for p in pools)
    step = tdec.make_decode_step(cfg, S)
    for i in range(W):
        act = torch.tensor(ACTIVE & (i < N_VALID))
        _, _, nxt, _ = step(tlm.params(), dk, dv,
                            torch.tensor(tokens[:, i]),
                            torch.tensor(POSITIONS + i),
                            torch.tensor(tables), act)
        assert torch.equal(nxt[act], out[act, i])
    for got, want in ((vk, dk), (vv, dv)):
        got, want = _np_pool(got), _np_pool(want)
        if kv_dtype == "int8":
            assert np.abs(got[0][:, :, 1:].astype(int)
                          - want[0][:, :, 1:].astype(int)).max() <= 1
            np.testing.assert_allclose(got[1][:, :, 1:], want[1][:, :, 1:],
                                       rtol=1e-5, atol=0)
        else:
            np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:],
                                       rtol=1e-5, atol=1e-5)


def test_rejected_slot0_write_relatches(models):
    """A rejected verify write at page slot 0 latches a scale on a page
    that trim frees; when the page comes back, the next token written at
    its slot 0 latches afresh: its scale and codes equal a fresh page's."""
    tlm = models[1]
    cfg = tlm.config
    pools, tables, tokens = _state(cfg, "int8", seed=9)
    kp, vp = (_torch_pool(p) for p in pools)
    # slot 0 at position 4: the verify's first token opens page tables[0,
    # 1] at slot 0; all of it is rejected and the page is handed back
    pos = np.array([4], np.int32)
    tab = tables[:1]
    tdec.make_verify_step(cfg, S, W)(
        tlm.params(), kp, vp, torch.tensor(tokens[:1]), torch.tensor(pos),
        torch.tensor([W], dtype=torch.int32), torch.tensor(tab),
        torch.tensor([True]))
    page = int(tab[0, 1])
    latched = kp.s[:, :, page].clone()
    fresh_k, fresh_v = (_torch_pool(p) for p in pools)
    step = tdec.make_decode_step(cfg, S)
    other = torch.tensor([(int(tokens[0, 0]) + 5) % cfg.vocab_size])
    args = (other, torch.tensor(pos), torch.tensor(tab),
            torch.tensor([True]))
    step(tlm.params(), kp, vp, *args)
    step(tlm.params(), fresh_k, fresh_v, *args)
    assert not torch.equal(kp.s[:, :, page], latched)
    for got, want in ((kp, fresh_k), (vp, fresh_v)):
        assert torch.equal(got.s[:, :, page], want.s[:, :, page])
        assert torch.equal(got.q[:, :, page, 0], want.q[:, :, page, 0])


def _count_calls(monkeypatch):
    """Count the kernel wrappers the decoder module calls (on the CPU a
    wrapper runs its plain version, so the launch counters do not move)."""
    from mxnet_tpu_torch.ops.kernels import epilogue, quant_matmul
    counts = {"bias_gelu": 0, "quant_matmul": 0}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def counted(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    wrap(epilogue, "bias_gelu")
    wrap(quant_matmul, "quant_matmul")
    return counts


@pytest.mark.parametrize("quantize,tp", [(None, 1), ("int8", 1),
                                         (None, 2), ("int4", 2)],
                         ids=["fp", "w8", "tp2", "w4-tp2"])
def test_verify_census_independent_of_acceptance(models, monkeypatch,
                                                 quantize, tp):
    """The wrappers one verify step calls equal ``verify_launch_stats``,
    for tokens the target would accept and for tokens it rejects."""
    tlm = models[1]
    cfg = tlm.config
    model = quantize_lm(tlm, quantize, group=16) if quantize else tlm
    params = model.params(tp=tp) if quantize else model.params()
    plan = None
    if tp > 1:
        plan = tdec.tp_plan(cfg, ShardingConfig.for_transformer(**MESH))
        params = plan.shard_params(params)
    fn = tdec.make_verify_step(cfg, S, W, plan=plan)
    want = tdec.verify_launch_stats(cfg, W, ("int8",) if quantize else None,
                                    tp)
    assert want["launches_per_step"] == sum(want["kernels"].values())
    assert want["launches_per_emitted_token"] == \
        want["launches_per_step"] / W
    pools, tables, tokens = _state(cfg, "float32", seed=11)
    counts = _count_calls(monkeypatch)
    seen = []
    out = None
    for feed in (tokens, None):
        if feed is None:
            # feed the step's own predictions: every draft is accepted
            feed = np.concatenate([tokens[:, :1], out[:, :-1]], axis=1)
        for k in counts:
            counts[k] = 0
        pk, pv = (_torch_pool(p) for p in pools)
        _, _, o = fn(params, pk, pv,
                     *(torch.tensor(a) for a in _inputs(tables, feed)))
        out = o.numpy()
        seen.append({k: n for k, n in counts.items() if n})
    assert seen[0] == seen[1] == want["kernels"]


# ---------------------------------------------------------------------------
# drafters, controller, scheduler against the JAX classes
# ---------------------------------------------------------------------------
def _contexts(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        base = rng.integers(0, 6 if i % 2 else 50, rng.integers(1, 30))
        ctx = list(base) * int(rng.integers(1, 4)) + list(
            rng.integers(0, 6, rng.integers(0, 5)))
        out.append([int(t) for t in ctx])
    return out


@pytest.mark.parametrize("max_ngram", [1, 2, 3, 5])
def test_ngram_drafter_matches_jax(max_ngram):
    td = tspec.NGramDrafter(max_ngram=max_ngram)
    jd = jspec.NGramDrafter(max_ngram=max_ngram)
    for ctx in _contexts():
        for k in (1, 2, 4, 7):
            assert td.propose("o", ctx, k) == jd.propose("o", ctx, k)
    assert td.stats() == jd.stats()
    assert td.name == jd.name == "ngram"


def test_ngram_drafter_default_from_config(monkeypatch):
    monkeypatch.setenv("MXNET_GEN_SPEC_NGRAM", "2")
    assert tspec.NGramDrafter().max_ngram == \
        jspec.NGramDrafter().max_ngram == 2


@pytest.mark.parametrize("cap", [0, 1, 3, 4])
def test_adaptive_k_matches_jax(cap):
    rng = np.random.default_rng(cap)
    t, j = tspec.AdaptiveK(cap), jspec.AdaptiveK(cap)
    for step in range(60):
        if step == 45:
            t.poison()
            j.poison()
        drafted = int(rng.integers(0, 5))
        accepted = int(rng.integers(0, drafted + 1)) if drafted else 0
        if step < 20:
            accepted = drafted            # open toward the cap first
        t.update(drafted, accepted)
        j.update(drafted, accepted)
        assert (t.current(), t.k, t.ema, t.disabled) == \
            (j.current(), j.k, j.ema, j.disabled)


def test_scheduler_matches_jax():
    """budget, propose, verify_gate, reuse_predraft, observe, release and
    stats on the same call sequence, faults included."""
    t = tspec.SpeculativeScheduler(tspec.NGramDrafter(), k_cap=4)
    j = jspec.SpeculativeScheduler(jspec.NGramDrafter(), k_cap=4)
    rng = np.random.default_rng(1)
    ctxs = _contexts(seed=2, n=12)
    for step in range(80):
        key = "s%d" % (step % 5)
        ctx = ctxs[step % len(ctxs)]
        assert t.budget(key, 3) == j.budget(key, 3)
        k = t.budget(key, 4) or 1
        if step == 30:
            with faults.inject("speculate.draft", "error", n=1,
                               max_trips=1), \
                    jfaults.inject("speculate.draft", "error", n=1,
                                   max_trips=1):
                assert t.propose(key, key, ctx, k) == \
                    j.propose(key, key, ctx, k) == []
        else:
            assert t.propose(key, key, ctx, k) == j.propose(key, key, ctx, k)
        if step == 50:
            with faults.inject("speculate.verify", "error", n=1,
                               max_trips=1), \
                    jfaults.inject("speculate.verify", "error", n=1,
                                   max_trips=1):
                assert not t.verify_gate([key, "s9"])
                assert not j.verify_gate([key, "s9"])
        else:
            assert t.verify_gate([key]) and j.verify_gate([key])
        pre = [int(x) for x in rng.integers(0, 4, int(rng.integers(0, 6)))]
        emitted = [int(x) for x in rng.integers(0, 4, int(rng.integers(1, 3)))]
        if step % 3 == 0:
            emitted = pre[:len(emitted)] or emitted
        assert t.reuse_predraft(pre, emitted, 3) == \
            j.reuse_predraft(pre, emitted, 3)
        d = int(rng.integers(0, 5))
        a = int(rng.integers(0, d + 1)) if d else 0
        t.observe(key, d, a)
        j.observe(key, d, a)
        if step % 17 == 0:
            t.release(key, key)
            j.release(key, key)
    assert t.stats() == j.stats()
    assert t.counters["draft_faults"] == t.counters["verify_faults"] == 1


def test_scheduler_defaults_from_config(monkeypatch):
    monkeypatch.setenv("MXNET_GEN_SPEC_K", "3")
    assert tspec.SpeculativeScheduler(tspec.Drafter()).k_cap == \
        jspec.SpeculativeScheduler(jspec.Drafter()).k_cap == 3


# ---------------------------------------------------------------------------
# the draft model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def draft(models):
    """The JAX ``decoder_draft`` of the tiny LM and the port's
    ``decoder_draft`` with its weights."""
    jlm, tlm = models
    jd = jdec.decoder_draft(jlm, seed=3)
    td = tdec.decoder_draft(tlm, seed=3).load_jax_params(
        jax.tree.map(np.asarray, jd.jax_params()))
    return jd, td


def test_decoder_draft_geometry(models, draft):
    jd, td = draft
    tlm = models[1]
    assert td.config == tdec.DecoderConfig(*jd.config)
    assert td.config.head_dim == 16
    assert td.config.vocab_size == tlm.config.vocab_size
    assert td.config.max_length == tlm.config.max_length
    assert td.device == tlm.device
    assert tdec.decoder_draft(tlm.config, device="cpu").config == td.config


def _greedy(td, ctx, k):
    toks = list(ctx)
    for _ in range(k):
        logits = tdec.full_forward(td.params(), td.config,
                                   torch.tensor([toks]))
        toks.append(int(logits[0, -1].argmax()))
    return toks[len(ctx):]


def test_draft_model_drafter_is_its_greedy_decode(draft):
    """Proposals equal the draft model's own greedy continuation, as the
    context grows by accepted tokens (catch-up chunks of 16), after a
    rollback to a shorter context (rebuild) and for a second sequence;
    the lookahead pages are trimmed after every proposal."""
    td = draft[1]
    d = tspec.DraftModelDrafter(td, page_size=4, max_seqs=2)
    rng = np.random.default_rng(4)
    ctx = [int(t) for t in rng.integers(0, td.config.vocab_size, 21)]
    for k, grow in ((3, 2), (4, 1), (2, 19), (4, 0)):
        got = d.propose("a", ctx, k)
        assert got == _greedy(td, ctx, k)
        assert len(d.alloc.pages("a")) == pages_for(len(ctx) - 1, 4)
        ctx = ctx + got[:grow] + [int(rng.integers(0, 100))]
    short = ctx[:9]
    assert d.propose("a", short, 3) == _greedy(td, short, 3)
    other = [5, 6, 7]
    assert d.propose("b", other, 4) == _greedy(td, other, 4)
    assert d.stats()["sequences"] == 2
    d.release("a")
    d.release("b")
    assert d.alloc.num_used == 0
    d.alloc.check_leaks()
    assert d.propose("c", [], 3) == []
