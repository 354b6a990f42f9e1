"""The split-key paged attention of kernel #15 (``csrc/paged_attention.cu``,
``csrc/decode_common.cuh:split_attend`` and ``split_merge``), over fp32
and over int8 pages, its arithmetic emulated on the CPU, against the JAX
package's ``paged_attention`` (the XLA gather path on the CPU; for int8
``QPages`` its ``gather_pages_deq`` + ``attend_ctx``).

The card cuts each row's keys into chunks of 64: a (row, KV head, chunk)
unit gives each of its 8 warps 8 consecutive keys and combines the warps
in warp order at the largest max; after a grid barrier each output
element merges its row's chunks in chunk order.  That order is
``split_attention`` of ``test_torch_decode_split.py`` (#13 runs the same
units).  Over int8 pages a lane multiplies each code by its page's scale
as it loads it, the value the plain version's dequantizing gather gives,
so the emulation dequantizes the pages first and runs the same order.

Geometry: head dim 8, page size 16, lengths {0, 1, 63, 64, 65, 512} (no
key, one, each side of a chunk boundary, the longest row), 2 KV heads
with one query head each (g 1) and three (g 3).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import paged_attention as jpa
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa
from test_torch_decode_split import (CHUNK, D, LENGTHS, PPS, S,
                                     split_attention)

torch.set_num_threads(2)

KVH = 2
# fp32 on both sides over at most 512 keys: XLA's two-pass softmax and
# the emulated chunks' running maxima and rescales round differently, on
# outputs of order 1 (a convex mix of values of order 1): a few ulps,
# 1e-5 absolute and relative.  A merge without the chunks' rescale, or
# int8 codes left unscaled, is off by far more
RTOL, ATOL = 1e-5, 1e-5


def _state(g, seed=0):
    """q, fp pages, int8 pages (codes and per-page scales), tables and
    lengths: each row's pages distinct, page 0 the scratch page."""
    rng = np.random.default_rng(seed)
    B = len(LENGTHS)
    need = [-(-n // S) for n in LENGTHS]
    total = 1 + sum(need)
    pages = rng.permutation(np.arange(1, total))
    tables = np.zeros((B, PPS), np.int32)
    k = 0
    for b, n in enumerate(need):
        tables[b, :n] = pages[k:k + n]
        k += n
    q = rng.standard_normal((B, KVH * g, D)).astype(np.float32)
    kp = rng.standard_normal((KVH, total, S, D)).astype(np.float32)
    vp = rng.standard_normal((KVH, total, S, D)).astype(np.float32)

    def qpages():
        codes = rng.integers(-127, 128, (KVH, total, S, D)).astype(np.int8)
        scales = (rng.random((KVH, total)) * 0.05).astype(np.float32)
        return codes, scales

    return (q, kp, vp, qpages(), qpages(), tables,
            np.array(LENGTHS, np.int32))


def dequantized(codes, scales):
    """Each code times its page's scale, one fp32 multiply."""
    return torch.tensor(codes).float() * torch.tensor(scales)[..., None,
                                                               None]


@pytest.mark.parametrize("g", [1, 3])
def test_split_fp_pages_match_jax(g):
    """fp pages: the emulated split against the JAX paged_attention; the
    length-0 row gives 0; a merge without the rescale is caught."""
    q, kp, vp, _, _, tables, lengths = _state(g)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(tables)))
    tq, tk, tv = torch.tensor(q), torch.tensor(kp), torch.tensor(vp)
    got = split_attention(tq, tk, tv, tables, lengths)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got[0].any() and not want[0].any()        # length 0
    bad = split_attention(tq, tk, tv, tables, lengths, rescale=False)
    assert not np.allclose(bad.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("g", [1, 3])
def test_split_int8_pages_match_jax(g):
    """int8 pages: the emulated split over the codes times their page's
    scale against the JAX paged_attention on QPages (gather_pages_deq +
    attend_ctx) and the port's plain version; codes left unscaled are
    caught."""
    q, _, _, (kc, ks), (vc, vs), tables, lengths = _state(g, seed=1)
    want = np.asarray(jpa.paged_attention(
        jnp.asarray(q), jpa.QPages(jnp.asarray(kc), jnp.asarray(ks)),
        jpa.QPages(jnp.asarray(vc), jnp.asarray(vs)), jnp.asarray(lengths),
        jnp.asarray(tables)))
    tq = torch.tensor(q)
    got = split_attention(tq, dequantized(kc, ks), dequantized(vc, vs),
                          tables, lengths)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    plain = tpa.paged_attention(
        tq, tpa.QPages(torch.tensor(kc), torch.tensor(ks)),
        tpa.QPages(torch.tensor(vc), torch.tensor(vs)),
        torch.tensor(lengths), torch.tensor(tables))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert not got[0].any()                               # length 0
    bad = split_attention(tq, torch.tensor(kc).float(),
                          torch.tensor(vc).float(), tables, lengths)
    assert not np.allclose(bad.numpy(), want, rtol=RTOL, atol=ATOL)


def test_chunks_per_row():
    """The units a row gives: one per 64 keys and KV head, none at 0."""
    chunks = [-(-n // CHUNK) for n in LENGTHS]
    assert chunks == [0, 1, 1, 1, 2, 8]
    assert sum(chunks) * KVH == 26
