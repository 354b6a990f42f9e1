"""The arithmetic order of the tensor-parallel FFN phase kernel #14
(``csrc/decode_phase.cu:ffn_phase_kernel``), emulated on the CPU, against
the JAX kernel ``_decode_ffn_phase_kernel`` run by the Pallas interpreter.

On the card FFN1 (x times w1's column shard) is split over K like FFN2:
``ksplit_for`` gives each GEMV as many K slices as the grid has blocks per
column group of 8, at most 8 (2 for FFN1 at tp 2 and 4 at tp 4 on the
H100's 396 blocks), each slice ``round4(ceil(K / ks))`` columns wide, the
last ones possibly short or empty.  Each slice's partial product goes to
scratch; after a grid barrier FFN2 stages its input as
``h = gelu_erf((p_0 + p_1 + ...) + b1)``, the slices summed in slice
order, and its own K slices' partials are summed in slice order into the
output after a second barrier.  The emulation below follows that order in
fp32 torch; within a slice, torch's product stands for the warp's FMAs
(the order there is the card's own and not emulated).

Widths: the full width (C 768, FFN 3072) at tp 2 and 4, where the slices
are 384 or 192 columns (FFN1) and 384 or 192 (FFN2); C 96 and FFN 384 at
tp 2 and 4 and C 104 and FFN 208 at tp 2, whose slices (12 to 24 columns)
do not fill a 128-column pass of a warp's lanes, the last of C 104's FFN1
slices being empty.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import fused_cell as jfc
from mxnet_tpu_torch.ops.kernels import fused_cell as tfc
from mxnet_tpu_torch.ops.kernels.epilogue import bias_gelu_plain

torch.set_num_threads(2)

B = 16
GRID = 396                  # #14's blocks on the H100: 3 an SM x 132 SMs
NWARPS, KSPLIT_MAX = 8, 8   # csrc/decode_common.cuh
# (C, FFN width, tp)
CASES = [(768, 3072, 2), (768, 3072, 4), (96, 384, 2), (96, 384, 4),
         (104, 208, 2)]
# fp32 on both sides: XLA and torch sum the products of a dot in other
# orders, and the emulation also splits them over the slices, so outputs
# of order 1 (Xavier-scaled weights) differ by a few ulps of their largest
# terms (ulp 1.2e-7 at 1): 1e-5 absolute and relative.  A GELU taken per
# slice instead of on the slices' sum is off by far more
RTOL, ATOL = 1e-5, 1e-5


def ksplit_for(n):
    """K slices of an n-column GEMV (``decode_common.cuh:ksplit_for``)."""
    groups = -(-n // NWARPS)
    return max(1, min(KSPLIT_MAX, GRID // groups))


def slices(K, ks):
    """(lo, hi) of each K slice, in slice order; hi <= lo is empty."""
    width = (-(-K // ks) + 3) & ~3
    return [(s * width, min(K, s * width + width)) for s in range(ks)]


def split_products(a, w):
    """a (B, K) times w (N, K) transposed, one partial per K slice of the
    card's split of this N-column GEMV, in slice order."""
    return [a[:, lo:hi] @ w[:, lo:hi].T if hi > lo
            else torch.zeros(a.shape[0], w.shape[0])
            for lo, hi in slices(a.shape[1], ksplit_for(w.shape[0]))]


def in_order(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def ffn_split(x, w1, b1, w2, gelu_per_slice=False):
    """#14 in the card's order: (B, C).  ``gelu_per_slice`` applies b1 and
    the GELU to each FFN1 slice before the sum (a wrong order, which the
    tolerance must catch)."""
    parts = split_products(x, w1)
    if gelu_per_slice:
        h = in_order([bias_gelu_plain(p, b1 if s == 0 else torch.zeros_like(b1))
                      for s, p in enumerate(parts)])
    else:
        h = bias_gelu_plain(in_order(parts), b1)
    return in_order(split_products(h, w2))


def _shard(C, FF, tp, seed=0):
    """x and shard 0's w1 rows, b1 and w2 columns, Xavier-scaled."""
    rng = np.random.default_rng(seed)
    Fl = FF // tp
    x = rng.standard_normal((B, C)).astype(np.float32)
    w1 = (rng.standard_normal((FF, C)) / np.sqrt(C)).astype(np.float32)
    b1 = (rng.standard_normal(FF) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((C, FF)) / np.sqrt(FF)).astype(np.float32)
    return (x, np.ascontiguousarray(w1[:Fl]), b1[:Fl].copy(),
            np.ascontiguousarray(w2[:, :Fl]))


def test_full_width_slices():
    """At full width the card splits FFN1 in 2 (tp 2) and 4 (tp 4) and
    FFN2 in 4, every block of the 396 holding one unit of each."""
    assert [ksplit_for(3072 // tp) for tp in (2, 4)] == [2, 4]
    assert ksplit_for(768) == 4
    for tp in (2, 4):
        Fl = 3072 // tp
        assert (Fl // NWARPS) * ksplit_for(Fl) <= GRID
        assert (768 // NWARPS) * ksplit_for(768) <= GRID


@pytest.mark.parametrize("C,FF,tp", CASES)
def test_ffn_split_matches_jax_interpret(C, FF, tp):
    """The emulated split order against the JAX kernel in interpret mode;
    a GELU taken per slice is caught by the tolerance."""
    x, w1, b1, w2 = _shard(C, FF, tp)
    want = np.asarray(jfc.decode_ffn_phase(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
        "interpret"))
    tx, tw1, tb1, tw2 = (torch.tensor(a) for a in (x, w1, b1, w2))
    got = ffn_split(tx, tw1, tb1, tw2)
    assert got.shape == (B, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # and the port's plain version, which CPU tensors take
    np.testing.assert_allclose(
        tfc.decode_ffn_phase(tx, tw1, tb1, tw2).numpy(), want, rtol=RTOL,
        atol=ATOL)
    bad = ffn_split(tx, tw1, tb1, tw2, gelu_per_slice=True)
    assert not np.allclose(bad.numpy(), want, rtol=RTOL, atol=ATOL)


def test_empty_slice_adds_nothing():
    """C 104 over 8 FFN1 slices of 16 columns: the last is empty and its
    partial is 0, as the card writes it."""
    assert slices(104, ksplit_for(104))[-1] == (112, 104)
    x, w1, b1, w2 = (torch.tensor(a) for a in _shard(104, 208, 2))
    parts = split_products(x, w1)
    assert len(parts) == 8 and not parts[-1].any()
    torch.testing.assert_close(in_order(parts), x @ w1.T, rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(ffn_split(x, w1, b1, w2),
                               F.linear(bias_gelu_plain(x @ w1.T, b1), w2),
                               rtol=RTOL, atol=ATOL)
