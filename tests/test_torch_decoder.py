"""Port parity: ``mxnet_tpu_torch.models.decoder`` against
``mxnet_tpu.models.decoder`` on the CPU, with the JAX model's weights
carried across by ``params_from_jax``.  The biases and LN affines are
random, so each of them is held against JAX too.

- every weight leaf round-trips exactly;
- the KV append lays tokens out as the JAX ``.at[li, :, wp, ws, :]``
  scatter does, for one token (decode) and for a chunk (prefill);
- ``full_forward`` logits match;
- teacher-forced chunked prefill (several chunks, a partial last one, a
  last chunk whose padding indexes past the page row) followed by the
  per-op and the fused decode steps: logits and pages match the JAX
  programs at rtol = atol = 1e-4, the tolerance of
  ``test_fused_cell.py``'s decode parity test.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import decoder as jdec
from mxnet_tpu_torch.models import decoder as tdec
from torch_parity import tiny_lm_with_affine

torch.set_num_threads(2)

GEOM = dict(vocab_size=64, num_layers=2, units=32, hidden_size=64,
            num_heads=4, num_kv_heads=2, max_length=64)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jlm = tiny_lm_with_affine(**GEOM)
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.CausalLM(**GEOM, device="cpu").load_jax_params(params_np)
    return jlm, tlm, params_np


def test_params_from_jax_round_trip(models):
    _, tlm, params_np = models
    state = tdec.params_from_jax(params_np)
    leaves = {"embed": params_np["embed"], "pos": params_np["pos"]}
    for i, lp in enumerate(params_np["layers"]):
        leaves.update({"layers.%d.%s" % (i, k): v for k, v in lp.items()})
    assert set(state) == set(leaves) == set(dict(tlm.named_parameters()))
    own = dict(tlm.named_parameters())
    for name, leaf in leaves.items():
        np.testing.assert_array_equal(state[name].numpy(), leaf)
        np.testing.assert_array_equal(own[name].numpy(), leaf)


@pytest.mark.parametrize("T", [1, 5])
def test_kv_append_layout_matches_jax(T):
    """(B, T) page/slot indices with values (B, T, KVH, D) — decode's T=1
    and a prefill chunk's T — land where the JAX scatter puts them."""
    rng = np.random.default_rng(0)
    L, KVH, P, S, D, B = 2, 3, 6, 4, 5, 2
    pages = rng.standard_normal((L, KVH, P, S, D)).astype(np.float32)
    wp = rng.integers(1, P, (B, T)).astype(np.int32)
    ws = np.tile(np.arange(T, dtype=np.int32) % S, (B, 1))
    wp[1] = (wp[0] % (P - 1)) + 1 if T == 1 else wp[1]
    val = rng.standard_normal((B, T, KVH, D)).astype(np.float32)
    ref = np.asarray(jdec._kv_append(jnp.asarray(pages), 1, jnp.asarray(wp),
                                     jnp.asarray(ws), jnp.asarray(val)))
    out = torch.tensor(pages)
    tdec._kv_append(out, 1, torch.tensor(wp), torch.tensor(ws),
                    torch.tensor(val))
    np.testing.assert_array_equal(out.numpy(), ref)
    # and a 1-D chunk (prefill's layout): (T,) indices, (T, KVH, D) values
    ref1 = np.asarray(jdec._kv_append(jnp.asarray(pages), 0,
                                      jnp.asarray(wp[0]), jnp.asarray(ws[0]),
                                      jnp.asarray(val[0])))
    out1 = torch.tensor(pages)
    tdec._kv_append(out1, 0, torch.tensor(wp[0]), torch.tensor(ws[0]),
                    torch.tensor(val[0]))
    np.testing.assert_array_equal(out1.numpy(), ref1)


def test_full_forward_matches_jax(models):
    jlm, tlm, _ = models
    toks = np.random.default_rng(1).integers(0, 64, (2, 21)).astype(np.int32)
    ref = np.asarray(jdec.full_forward(jlm.jax_params(), jlm.config,
                                       jnp.asarray(toks)))
    out = tlm(torch.tensor(toks)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_prefill_padding_past_page_row_matches_jax(models):
    """Chunk 12 over a 63-token prompt in a 64-slot context: the last
    chunk's padded positions 64..71 index past the 8-entry page row; the
    port clamps where JAX's gather clamps implicitly."""
    jlm, tlm, _ = models
    cfg, S, chunk, pps = jlm.config, 8, 12, 8
    prompt = np.random.default_rng(2).integers(0, 64, 63).astype(np.int32)
    row = np.arange(1, pps + 1, dtype=np.int32)
    shape = (cfg.num_layers, cfg.num_kv_heads, pps + 1, S, cfg.head_dim)
    jf = jdec.make_prefill_chunk(cfg, S, chunk)
    tf = tdec.make_prefill_chunk(tlm.config, S, chunk)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    for p0 in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - p0)
        padded = np.zeros(chunk, np.int32)
        padded[:n] = prompt[p0:p0 + n]
        jk, jv, jt, jl = jf(jlm.jax_params(), jk, jv, jnp.asarray(padded),
                            jnp.int32(p0), jnp.int32(n), jnp.asarray(row))
        _, _, tt, tl = tf(tlm.params(), tk, tv, torch.tensor(padded), p0, n,
                          torch.tensor(row))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy()[:, :, 1:], np.asarray(jk)[:, :, 1:],
                               **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_then_decode_matches_jax(models, fused):
    """Two sequences prefilled in chunks of 8 (13 tokens: a full chunk and
    a partial one; 6 tokens: one partial chunk), then teacher-forced
    decode over a 3-slot batch whose third slot stays inactive and whose
    second slot goes inactive once its sequence ends."""
    jlm, tlm, _ = models
    cfg, S, chunk, pps, total = jlm.config, 8, 8, 8, 20
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 64, 24).tolist(), rng.integers(0, 64, 14).tolist()]
    n_prompt = [13, 6]
    tables = np.zeros((3, pps), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :2] = [7, 5]
    shape = (cfg.num_layers, cfg.num_kv_heads, total, S, cfg.head_dim)
    jp, tp = jlm.jax_params(), tlm.params()
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)

    jpre = jdec.make_prefill_chunk(cfg, S, chunk)
    tpre = tdec.make_prefill_chunk(tlm.config, S, chunk)
    for b, seq in enumerate(seqs):
        for p0 in range(0, n_prompt[b], chunk):
            n = min(chunk, n_prompt[b] - p0)
            padded = np.zeros(chunk, np.int32)
            padded[:n] = seq[p0:p0 + n]
            jk, jv, jt, jl = jpre(jp, jk, jv, jnp.asarray(padded),
                                  jnp.int32(p0), jnp.int32(n),
                                  jnp.asarray(tables[b]))
            _, _, tt, tl = tpre(tp, tk, tv, torch.tensor(padded), p0, n,
                                torch.tensor(tables[b]))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            assert int(tt) == int(jt)

    if fused:
        jdecode = jdec.make_decode_step_fused(cfg, S, 0, "interpret")
        tdecode = tdec.make_decode_step_fused(tlm.config, S, 0)
    else:
        jdecode = jdec.make_decode_step(cfg, S)
        tdecode = tdec.make_decode_step(tlm.config, S)
    pos = list(n_prompt)
    steps = 0
    while pos[0] < len(seqs[0]):
        act = np.array([pos[0] < len(seqs[0]), pos[1] < len(seqs[1]), False])
        toks = np.array([seqs[b][pos[b]] if act[b] else 0 for b in (0, 1)]
                        + [0], np.int32)
        p = np.array([pos[b] if act[b] else 0 for b in (0, 1)] + [0],
                     np.int32)
        jk, jv, jn, jl = jdecode(jp, jk, jv, jnp.asarray(toks),
                                 jnp.asarray(p), jnp.asarray(tables),
                                 jnp.asarray(act))
        rk, rv, tn, tl = tdecode(tp, tk, tv, torch.tensor(toks),
                                 torch.tensor(p), torch.tensor(tables),
                                 torch.tensor(act))
        assert rk is tk and rv is tv                    # updated in place
        np.testing.assert_allclose(tl.numpy()[act], np.asarray(jl)[act],
                                   **TOL)
        np.testing.assert_array_equal(tn.numpy()[act], np.asarray(jn)[act])
        pos = [q + 1 for q in pos]
        steps += 1
    assert steps == 11
    # page 0 is the scratch page (inactive rows scatter there)
    np.testing.assert_allclose(tk.numpy()[:, :, 1:], np.asarray(jk)[:, :, 1:],
                               **TOL)
    np.testing.assert_allclose(tv.numpy()[:, :, 1:], np.asarray(jv)[:, :, 1:],
                               **TOL)
