"""Port parity: the flash backward's delta kernel, ``delta = sum_d dO * O``
in fp32, the row statistic #6 and #7 read.

The kernel (``csrc/flash_attention.cu``, ``flash_bwd_delta_kernel``) runs
only on the card; here its row split (``run_delta``'s grid: blocks of 8
warps, a warp's pass ``32 / G`` rows, at most 4096 blocks, the warps
striding over the rest) and its summation order (G lanes of one 16-byte
vector each, each lane adding its rounded products in element order, the
partials meeting in an xor butterfly over G rounded up to a power of two,
GP, the lanes past G adding 0) are emulated in plain PyTorch and
held against the JAX package's expression (``jnp.sum(g * out)`` in fp32,
``mxnet_tpu/ops/pallas/flash_attention.py:466``) within ``TOL_DELTA``
(``chip_smoke``'s: the error over each row's sum of |dO O|).  Every split
must cover each row once and give the same bits (the order depends on D
and the dtype alone).  On the card ``chip_smoke.check_flash_delta`` holds
the kernel itself in the same edge shapes.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu_torch.ops.kernels import flash_attention as tfa

torch.set_num_threads(2)

# two fp32 sums of the same <= 128 rounded products differ by at most
# ~D 2**-24 of the row's sum of |products|: chip_smoke.TOL_DELTA
TOL_DELTA = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, H, L), D: fewer rows than a warp's pass (3); rows no block's pass
# divides (222, 1155); and a whole number of passes (3072); then the head
# dims whose G is no power of two (48, 80, 96) or a lane pair (16)
CASES = (((1, 1, 3), 32), ((2, 3, 37), 64), ((3, 5, 77), 128),
         ((4, 6, 128), 64), ((2, 3, 37), 16), ((1, 2, 45), 48),
         ((2, 2, 33), 80), ((1, 3, 29), 96))
#: the kernel's grid: warps a block, and the most blocks (``run_delta``)
WARPS, MAX_BLOCKS = 8, 4096


def _inputs(B, H, L, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    do, out = (torch.tensor(rng.standard_normal((B, H, L, D)),
                            dtype=torch.float32).to(DTYPES[dtype])
               for _ in range(2))
    return do, out


def _lanes(D, itemsize):
    """GP: G, the lanes that read a row, one 16-byte vector each, rounded
    up to a power of two (the lanes a row takes in the warp)."""
    G = D * itemsize // 16
    return 1 << (G - 1).bit_length()


def _grid(rows, GP, max_blocks=MAX_BLOCKS):
    """``run_delta``'s blocks: one warp pass of 32 / GP rows a warp, at
    most ``max_blocks``."""
    return min(-(-rows // (WARPS * (32 // GP))), max_blocks)


def _kernel_sums(do_rows, out_rows):
    """Each row's sum in the kernel's order: G lanes of V elements (16
    bytes), each lane adding its rounded fp32 products in element order
    from 0, the lanes up to GP holding 0, then the partials of lanes ``c``
    and ``c ^ o`` added for ``o`` = GP/2, ..., 1.  Rows (n, D) -> (n,)
    fp32."""
    n, D = do_rows.shape
    V = 16 // do_rows.element_size()
    G, GP = D // V, _lanes(D, do_rows.element_size())
    p = (do_rows.float() * out_rows.float()).reshape(n, G, V)
    s = torch.zeros(n, GP)
    for e in range(V):
        s[:, :G] = s[:, :G] + p[:, :, e]
    lanes = torch.arange(GP)
    o = GP // 2
    while o:
        s = s + s[:, lanes ^ o]
        o //= 2
    assert torch.equal(s, s[:, :1].expand(n, GP))    # every lane the same
    return s[:, 0]


def _emulate(do, out, max_blocks=MAX_BLOCKS):
    """The kernel: warp ``w`` of the grid takes the pass of rows ``w *
    32 / GP`` on, then strides by the grid's warps; each pass's rows past
    the end are not read or written.  Returns delta (B, H, L) and each
    row's store count."""
    B, H, L, D = do.shape
    rows = B * H * L
    GP = _lanes(D, do.element_size())
    per_warp = 32 // GP
    warps = _grid(rows, GP, max_blocks) * WARPS
    d, o = do.reshape(rows, D), out.reshape(rows, D)
    delta = torch.full((rows,), float("nan"))
    stores = torch.zeros(rows, dtype=torch.int64)
    for w in range(warps):
        for r0 in range(w * per_warp, rows, warps * per_warp):
            r1 = min(rows, r0 + per_warp)
            delta[r0:r1] = _kernel_sums(d[r0:r1], o[r0:r1])
            stores[r0:r1] += 1
    return delta.reshape(B, H, L), stores


def _jax_delta(do, out):
    """The JAX package's delta over the same values."""
    g = jnp.asarray(do.float().numpy()).astype(str(do.dtype)[6:])
    o = jnp.asarray(out.float().numpy()).astype(str(out.dtype)[6:])
    return np.asarray(jnp.sum(g.astype(jnp.float32) * o.astype(jnp.float32),
                              axis=-1))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,D", CASES, ids=[
    "x".join(map(str, s)) + "-D%d" % d for s, d in CASES])
def test_delta_emulation_matches_jax(shape, D, dtype):
    """The emulated kernel matches the JAX expression within TOL_DELTA,
    stores every row once, and gives the same bits when its grid is cut
    to a block or two (the warps then stride over the rows)."""
    B, H, L = shape
    do, out = _inputs(B, H, L, D, dtype, seed=sum(shape) + D)
    rows = B * H * L
    got, stores = _emulate(do, out)
    assert torch.equal(stores, torch.ones(rows, dtype=torch.int64))
    want = _jax_delta(do, out)
    row = (do.float() * out.float()).abs().sum(-1).clamp_min(1e-30)
    err = float(((got - torch.tensor(want)).abs() / row).max())
    assert err <= TOL_DELTA, err
    for max_blocks in (1, 2):
        again, stores = _emulate(do, out, max_blocks)
        assert torch.equal(stores, torch.ones(rows, dtype=torch.int64))
        assert torch.equal(again, got)
    # the CPU wrapper takes the plain version: within the tolerance too
    plain = tfa.flash_attention_bwd_delta(do, out)
    assert float(((plain - got).abs() / row).max()) <= TOL_DELTA
