"""Port parity: ``mxnet_tpu_torch.ops.kernels.epilogue`` (``bias_gelu``
with its backward, ``bias_dropout_residual`` forward and backward) and
``dropout_hash`` against ``mxnet_tpu.ops.pallas.epilogue`` on the CPU.

The same numpy inputs go through the JAX function (its XLA path, and the
Pallas kernels in interpret mode) and the port's wrappers, which take
their plain PyTorch versions for CPU tensors.  The hash and the dropout
mask must match exactly.  The Triton and CUDA kernels themselves run
only on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas import epilogue as jep
from mxnet_tpu.ops.pallas.flash_attention import hash_keep_bits as jhash
from mxnet_tpu_torch.ops.kernels import dropout_hash as thash
from mxnet_tpu_torch.ops.kernels import epilogue as tep

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(8, 128), (2, 4, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_gelu_matches_jax(monkeypatch, mode, shape, dtype):
    monkeypatch.setenv("MXNET_EPILOGUE_KERNEL",
                       "0" if mode == "xla" else "interpret")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    jdt, tdt = _DT[dtype]
    ref = jep.bias_gelu(jnp.asarray(x, jdt), jnp.asarray(b, jdt))
    assert jep.last_path == ("xla" if mode == "xla" else "pallas-interpret")
    out = tep.bias_gelu(torch.tensor(x).to(tdt), torch.tensor(b).to(tdt))
    assert out.dtype == tdt and tuple(out.shape) == shape
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    # Both compute erf in fp32, and the two erf implementations differ by
    # a few ulps.  In the far negative tail gelu is the cancellation
    # 0.5 u (1 + erf(u / sqrt 2)) of size ~1e-6, where they differ by up
    # to ~1e-6 absolute: hence atol 2e-6.
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=2e-6)
    else:
        # one rounding to bf16 at the end: an erf ulp apart can round to
        # neighbouring bf16 values, at most 2**-7 relative
        np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=2e-6)


def test_bias_gelu_cpu_takes_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    x = torch.randn(4, 16)
    b = torch.randn(16)
    before = tep.bias_gelu.launches
    out = tep.bias_gelu(x, b)
    assert tep.bias_gelu.launches == before
    assert torch.equal(out, tep.bias_gelu_plain(x, b))


# (R, C, itemsize) -> (vec, threads, rows, (gx, gy)) on an H100's 132 SMs
_GELU_PLANS = {
    (16, 3072, 4): (4, 64, 1, (12, 16)),      # per-op decode step
    (64, 3072, 4): (4, 128, 1, (6, 64)),      # prefill chunk
    (4096, 3072, 4): (4, 128, 2, (6, 2048)),  # BERT training
    (16, 3072, 2): (4, 64, 1, (12, 16)),      # 8-byte vectors while small
    (64, 3072, 2): (4, 128, 1, (6, 64)),
    (4096, 3072, 2): (8, 128, 4, (3, 1024)),
    (16, 770, 4): (1, 64, 1, (13, 16)),       # ragged C: one element
    (64, 770, 4): (1, 128, 1, (7, 64)),
    (16, 770, 2): (1, 64, 1, (13, 16)),
    (16, 1536, 4): (4, 32, 1, (12, 16)),      # FFN1's bias shard at tp 2
    (64, 1536, 4): (4, 128, 1, (3, 64)),
    (16, 1536, 2): (4, 32, 1, (12, 16)),
    (64, 1536, 2): (4, 128, 1, (3, 64)),
}


@pytest.mark.parametrize("R,C,itemsize", sorted(_GELU_PLANS),
                         ids=["%dx%d-%s" % (r, c, "fp32" if e == 4 else "bf16")
                              for r, c, e in sorted(_GELU_PLANS)])
def test_bias_gelu_plan(R, C, itemsize):
    """The forward kernel's launch: 16-byte vectors where C allows them
    (at most 4 elements, one row a pass, at the serving shapes), one
    element for a ragged C; gx blocks just cover a row's vectors; at
    least one block an SM where R allows it, one pass a thread;
    misaligned pointers take one element."""
    plan = tep.bias_gelu_plan(R, C, itemsize, True)
    assert plan == _GELU_PLANS[(R, C, itemsize)]
    vec, threads, rows, (gx, gy) = plan
    nv = C // vec
    assert (gx - 1) * threads < nv <= gx * threads
    assert gx * gy >= tep.SMS or (threads == 32 and rows == 1)
    assert gy * rows >= R > (gy - 1) * rows
    assert tep.bias_gelu_plan(R, C, itemsize, False)[0] == 1


@pytest.mark.parametrize("R,C,sms", [(37, 770, 4), (300, 96, 2), (5, 8, 64),
                                     (140001, 4, 1)])
def test_bias_gelu_plan_covers_every_element_once(R, C, sms):
    """The kernel's loops over the plan (thread col = bx threads + tx of
    the gx threads covering a row; rows by K + gy K i + k) visit every
    (row, vector) of x exactly once, grid-strided (past 65535 row
    groups) or not."""
    for aligned in (True, False):
        vec, threads, rows, (gx, gy) = tep.bias_gelu_plan(R, C, 4, aligned,
                                                          sms)
        nv = C // vec
        passes = -(-R // (gy * rows))
        r = (np.arange(gy)[:, None, None] * rows
             + np.arange(passes)[None, :, None] * gy * rows
             + np.arange(rows)[None, None, :]).ravel()
        r = r[r < R]
        cols = np.arange(gx * threads)
        cols = cols[cols < nv]
        seen = np.zeros((R, nv), np.int64)
        np.add.at(seen, (r[:, None], cols[None, :]), 1)
        assert (seen == 1).all()
        assert gy <= 65535 and (R <= 65535 * rows or passes > 1)


def test_bias_gelu_bias_of_another_dtype():
    """The wrapper takes a bias of another type than x (as the Triton
    kernel did): the plain version adds it in fp32."""
    x = torch.randn(4, 16).to(torch.bfloat16)
    b = torch.randn(16)
    out = tep.bias_gelu(x, b)
    assert out.dtype == torch.bfloat16
    ref = tep.bias_gelu_plain(x.float(), b).to(torch.bfloat16)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _mode_env(monkeypatch, mode):
    monkeypatch.setenv("MXNET_EPILOGUE_KERNEL",
                       "0" if mode == "xla" else "interpret")
    return None if mode == "xla" else "interpret"


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_gelu_backward_matches_jax(monkeypatch, mode, dtype):
    """dx and db of the autograd.Function against jax.vjp of the JAX op."""
    _mode_env(monkeypatch, mode)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 8, 128)) * 3).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    g = rng.standard_normal((2, 8, 128)).astype(np.float32)
    jdt, tdt = _DT[dtype]
    _, vjp = jax.vjp(jep.bias_gelu, jnp.asarray(x, jdt), jnp.asarray(b, jdt))
    jdx, jdb = vjp(jnp.asarray(g, jdt))
    xt = torch.tensor(x).to(tdt).requires_grad_()
    bt = torch.tensor(b).to(tdt).requires_grad_()
    before = tep.bias_gelu_backward.launches
    tep.bias_gelu(xt, bt).backward(torch.tensor(g).to(tdt))
    assert tep.bias_gelu_backward.launches == before
    assert xt.grad.dtype == tdt and bt.grad.dtype == tdt
    jdx = np.asarray(jdx.astype(jnp.float32))
    jdb = np.asarray(jdb.astype(jnp.float32))
    if dtype == "float32":
        # erf and exp a few ulps apart; gelu' is O(1), g ~ N(0, 1)
        np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=1e-5,
                                   atol=1e-6)
        # db sums 16 such rows in fp32
        np.testing.assert_allclose(bt.grad.numpy(), jdb, rtol=1e-5,
                                   atol=1e-5)
    else:
        # one bf16 rounding of dx; db is the fp32 sum of 16 bf16 dx values
        # rounded once to bf16: two neighbouring bf16 values at most
        np.testing.assert_allclose(xt.grad.float().numpy(), jdx,
                                   rtol=2.0 ** -7, atol=1e-6)
        np.testing.assert_allclose(bt.grad.float().numpy(), jdb,
                                   rtol=2.0 ** -7, atol=2.0 ** -7)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31, 2 ** 32 - 1])
def test_hash_matches_jax_exactly(seed):
    rows = np.array([0, 1, 2, 127, 128, 4095, 65535, 2 ** 20 - 1, 2 ** 20],
                    np.int64)[:, None]
    cols = np.concatenate([np.arange(0, 64), np.array([767, 768, 3071,
                                                      30521])])[None, :]
    ref = jhash(jnp.uint32(seed), 0, jnp.asarray(rows, jnp.int32),
                jnp.asarray(cols, jnp.int32))
    out = thash.hash_keep_bits(seed, 0, torch.tensor(rows),
                               torch.tensor(cols))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(ref).astype(np.int64))
    # keep mask and scale of a whole tile, against _keep_scale_rows
    for rate in (0.1, 0.5):
        ref = jep._keep_scale_rows(jnp.uint32(seed), 1000, (16, 96), rate)
        out = thash.keep_scale_rows(seed, 1000, (16, 96), rate)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
def test_epilogue_mask_unchanged_by_tensor_batch_head(seed):
    """``hash_keep_bits`` takes the batch-head index as a tensor for the
    flash kernels; the epilogue's batch-head 0, as an int or as a tensor,
    keeps its mask bit for bit: the bias_dropout_residual forward's mask
    (x = 1, b = 0, r = 0) over (256, 768) equals JAX's
    ``_keep_scale_rows``."""
    gi = torch.arange(300, dtype=torch.int64)[:, None]
    gj = torch.arange(770, dtype=torch.int64)[None, :]
    ref = thash.hash_keep_bits(seed, 0, gi, gj)
    for b in (torch.tensor(0), torch.zeros(300, 1, dtype=torch.int64)):
        assert torch.equal(thash.hash_keep_bits(seed, b, gi, gj), ref)
    R, C = 256, 768
    st = torch.tensor([seed], dtype=torch.int64)
    for rate in (0.1, 0.5):
        out = tep.bias_dropout_residual_plain(
            torch.ones(R, C), torch.zeros(C), torch.zeros(R, C), rate, st)
        want = jep._keep_scale_rows(jnp.uint32(seed), 0, (R, C), rate)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


SEED = 0xDEADBEEF


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_dropout_residual_matches_jax(monkeypatch, mode, rate, dtype):
    """Forward and backward against JAX's op given the same seed: the mask
    exactly (x = 1, b = 0, r = 0 gives keep scale or 0), values within
    tolerance."""
    jmode = _mode_env(monkeypatch, mode)
    jdt, tdt = _DT[dtype]
    shape = (3, 8, 96)                   # R = 24 rows of the (R, C) view
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    seed = jnp.asarray([SEED], jnp.uint32)

    def jax_op(x, b, r):
        C = x.shape[-1]
        return jep._bias_dropout_residual(
            x.reshape(-1, C), b, r.reshape(-1, C), seed, rate,
            jmode).reshape(x.shape)

    ones = np.ones(shape, np.float32)
    zb, zr = np.zeros(shape[-1], np.float32), np.zeros(shape, np.float32)
    jmask = jax_op(jnp.asarray(ones, jdt), jnp.asarray(zb, jdt),
                   jnp.asarray(zr, jdt))
    tmask = tep.bias_dropout_residual(torch.tensor(ones).to(tdt),
                                      torch.tensor(zb).to(tdt),
                                      torch.tensor(zr).to(tdt), rate,
                                      seed=SEED)
    np.testing.assert_array_equal(tmask.float().numpy(),
                                  np.asarray(jmask.astype(jnp.float32)))
    dropped = float((tmask == 0).float().mean())
    assert abs(dropped - rate) < 0.05

    jout, vjp = jax.vjp(jax_op, jnp.asarray(x, jdt), jnp.asarray(b, jdt),
                        jnp.asarray(r, jdt))
    jdx, jdb, jdr = vjp(jnp.asarray(g, jdt))
    xt, bt, rt = (torch.tensor(a).to(tdt).requires_grad_()
                  for a in (x, b, r))
    before = (tep.bias_dropout_residual.launches_fwd,
              tep.bias_dropout_residual.launches_bwd)
    out = tep.bias_dropout_residual(xt, bt, rt, rate, seed=SEED)
    out.backward(torch.tensor(g).to(tdt))
    assert before == (tep.bias_dropout_residual.launches_fwd,
                      tep.bias_dropout_residual.launches_bwd)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))      # noqa: E731
    if dtype == "float32":
        # the same fp32 adds and multiplies in the same order
        tol = dict(rtol=1e-6, atol=1e-6)
        db_tol = dict(rtol=1e-5, atol=1e-5)          # fp32 sum of 24 rows
    else:
        # one bf16 rounding at the end, at most a bf16 step apart
        tol = dict(rtol=2.0 ** -7, atol=1e-6)
        db_tol = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
    np.testing.assert_allclose(out.detach().float().numpy(), f32(jout),
                               **tol)
    np.testing.assert_allclose(xt.grad.float().numpy(), f32(jdx), **tol)
    np.testing.assert_allclose(rt.grad.float().numpy(), f32(jdr), **tol)
    np.testing.assert_allclose(bt.grad.float().numpy(), f32(jdb), **db_tol)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_bias_dropout_residual_saves_no_activation(rate):
    """Only the one-element seed is saved for the backward: no mask and no
    activation."""
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    x = torch.randn(16, 64, requires_grad=True)
    b = torch.randn(64, requires_grad=True)
    r = torch.randn(16, 64, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tep.bias_dropout_residual(x, b, r, rate, seed=7)
    assert all(math.prod(s) <= 1 for s in saved), saved
    assert len(saved) == (1 if rate else 0)
    out.sum().backward()
    if not rate:
        torch.testing.assert_close(x.grad, torch.ones_like(x))
    torch.testing.assert_close(r.grad, torch.ones_like(r))


def test_bias_dropout_residual_seed_from_generator():
    """Without ``seed=``, the uint32 seed comes from the caller's generator:
    the same generator state gives the same mask."""
    x, b, r = torch.ones(32, 64), torch.zeros(64), torch.zeros(32, 64)
    outs = [tep.bias_dropout_residual(
        x, b, r, 0.5, generator=torch.Generator().manual_seed(s))
        for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        tep.bias_dropout_residual(x, b, r, 1.0)
