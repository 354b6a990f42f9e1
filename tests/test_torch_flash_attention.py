"""Port parity: ``mxnet_tpu_torch.ops.kernels.flash_attention`` and
``mxnet_tpu_torch.ops.attention`` against ``mxnet_tpu``'s flash kernel
(``ops/pallas/flash_attention.py``, run in Pallas interpret mode on the
CPU) and ``mxnet_tpu.ops.attention`` on the CPU.

The same numpy inputs go through both.  On CPU tensors the port's
wrappers take their plain PyTorch versions; the CUDA kernels themselves
run only on the card (``chip_smoke.py`` holds them against these plain
versions).

- ``flash_attention_plain``'s output and ``lse`` against the JAX
  kernel's ``_fwd_call``, with no mask, causal, a window of 8, and
  ``kv_length`` with a row of length 0, in fp32 (L 64, 32 x 32 tiles on
  the JAX side) and bf16 (L 48, 16 x 16 tiles);
- gradients against ``jax.grad`` through the interpret kernel (causal
  with ``kv_length`` and a row of length 0, fp32 and bf16, dropout 0 and
  0.1; a window in the dropout test), in bf16 pinning the backward's
  roundings of P keep and dS to bf16;
- the dropout keep bits equal to JAX's ``hash_keep_bits(seed, bh, i, j)``
  in every element, and the dropout output and gradients against the
  interpret kernel at the same seed;
- a row with no valid key: the port gives the reference attention's 0,
  where the JAX kernel's output depends on its tiling;
- ``ops.attention.flash_attention``'s dispatch and validation;
- the autograd Function saves no (L, L) tensor.

The wrappers on strided views and into output views, and the fp32
kernels' 3xTF32 tolerance, are in ``test_torch_flash_attention_views.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops.pallas import flash_attention as jfa
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops.kernels import dropout_hash as thash
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa
from flash_parity import DTYPES, close_grads, inputs, jax_grads

torch.set_num_threads(2)

MASKS = ["none", "causal", "window", "kv_length"]


def mask_kw(mask, B):
    """The mask's keyword arguments, with kv_length as numpy."""
    if mask == "causal":
        return dict(causal=True)
    if mask == "window":
        return dict(window=8)
    if mask == "kv_length":
        return dict(kv_length=np.array([37, 0] + [20] * (B - 2))[:B])
    return {}


def jax_fwd(q, k, v, jdt, block, causal=False, window=None, kv_length=None,
            dropout=0.0, seed=0):
    """(out, lse) of the JAX kernel's forward call, in interpret mode."""
    B, H, L, D = q.shape
    r = [jnp.asarray(a, jdt).reshape(B * H, L, D) for a in (q, k, v)]
    has = kv_length is not None
    kvlen = (jnp.repeat(jnp.asarray(kv_length, jnp.int32), H) if has
             else jnp.zeros((1,), jnp.int32))
    out, lse = jfa._fwd_call(*r, jnp.asarray([seed], jnp.uint32), kvlen,
                             causal, window, 1.0 / np.sqrt(D), dropout, has,
                             block, block, True)
    return (np.asarray(out.astype(jnp.float32)).reshape(B, H, L, D),
            np.asarray(lse).reshape(B, H, L))


def port(arrays, tdt):
    return [torch.tensor(a).to(tdt) for a in arrays]


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape,block,dtype", [
    ((2, 2, 64, 16), 32, "float32"), ((2, 2, 48, 16), 16, "bfloat16")])
def test_forward_and_lse_match_jax(shape, block, dtype, mask):
    jdt, tdt = DTYPES[dtype]
    q, k, v = inputs(shape)
    kw = mask_kw(mask, shape[0])
    ref, ref_lse = jax_fwd(q, k, v, jdt, block, **kw)
    tkw = {n: (torch.tensor(a) if n == "kv_length" else a)
           for n, a in kw.items()}
    out, lse = tfa.flash_attention_plain(*port((q, k, v), tdt), **tkw)
    assert out.dtype == tdt and lse.dtype == torch.float32
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(ref_lse))
    fin = np.isfinite(ref_lse)
    # lse: fp32 sums of exact products in another order on both sides
    np.testing.assert_allclose(lse.numpy()[fin], ref_lse[fin], rtol=1e-5,
                               atol=1e-5)
    if dtype == "float32":
        # another summation order (online vs two-pass softmax)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        # both round P to bf16 before P V (the JAX kernel relative to its
        # running max), and the output once: one bf16 step of each
        # element, and 2**-9 of the largest beyond it for a rounding of P
        # that fell the other way
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0 ** -7,
                                   atol=2.0 ** -9 * np.abs(ref).max())
    if mask == "kv_length":
        assert np.all(out.float().numpy()[1] == 0)


def port_grads(q, k, v, g, tdt=torch.float32, **kw):
    leaves = [torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, **kw)
    out.backward(torch.tensor(g).to(tdt))
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in leaves])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax(dtype, rate):
    """Causal with kv_length (37, 0): a batch row with no valid key; at
    dropout 0.1 the same seed on both sides.  In bfloat16 both backward
    passes round P keep to bf16 before the dV product and dS before the dK
    and dQ products (flash_attention.py:300, 355, 361): the gradients must
    agree within one bf16 step (2**-8) of the largest element.  They agree
    exactly here; leaving out the roundings moves some gradient by more
    than that, so the tolerance pins them."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, g = inputs((2, 2, 64, 16), seed=1, n=4)
    kw = dict(causal=True, dropout=rate)
    seed = 0xDEADBEEF
    jkw = dict(kw, seed=jnp.uint32(seed)) if rate else kw
    want = jax_grads(q, k, v, g, 64, jdt, kv_length=[37, 0], **jkw)
    _, got = port_grads(q, k, v, g, tdt, seed=seed if rate else None,
                        kv_length=torch.tensor([37, 0]), **kw)
    if dtype == "float32":
        close_grads(got, want)
    else:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2.0 ** -8 * np.abs(b).max())
    assert not np.any(got[0][1])      # the row without keys: no gradient


@pytest.mark.parametrize("seed", [0, 2 ** 31, 2 ** 32 - 1])
def test_keep_bits_match_jax(seed):
    B, H, L = 2, 3, 48
    bh = np.arange(B * H).reshape(B, H, 1, 1)
    gi = np.arange(L)[:, None]
    ref = jfa.hash_keep_bits(jnp.uint32(seed), jnp.asarray(bh, jnp.int32),
                             jnp.asarray(gi, jnp.int32),
                             jnp.asarray(gi.T, jnp.int32))
    out = thash.hash_keep_bits(seed, torch.tensor(bh), torch.tensor(gi),
                               torch.tensor(gi.T))
    assert out.shape == (B, H, L, L)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(ref).astype(np.int64))
    # the plain version's multiplier is that mask at the rate's threshold
    keep = tfa._keep(torch.tensor([seed]), B, H, L, 0.3, "cpu")
    want = (np.asarray(ref).astype(np.int64) >= thash.keep_threshold(0.3))
    np.testing.assert_array_equal(keep.numpy(),
                                  want * np.float32(thash.keep_scale(0.3)))


def test_dropout_matches_jax():
    """Dropout 0.2 at one seed: the JAX kernel's output and gradients (its
    mask from the same hash), with kv_length and a window of 8, the
    lengths long enough that every row keeps a key (see the next test)."""
    q, k, v, g = inputs((2, 2, 64, 16), seed=2, n=4)
    seed = 0xDEADBEEF
    kw = dict(window=8, kv_length=[60, 57], dropout=0.2)
    jkw = dict(kw, seed=jnp.uint32(seed))

    def run(a, b, c):
        return jfa.flash_attention_tpu(a, b, c, block_q=32, block_k=32,
                                       interpret=True, **jkw)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    ref, vjp = jax.vjp(run, *jq)
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    out, got = port_grads(q, k, v, g, seed=seed,
                          **dict(kw, kv_length=torch.tensor([60, 57])))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    close_grads(got, want)
    assert np.mean(out == 0) < 0.2      # dropped probabilities, not rows


def test_fully_masked_row_is_zero():
    """Row 40 sees no key: |40 - j| <= 4 and j < 8 never hold together.
    The reference attention gives 0, and so does the port; the JAX kernel
    with 32 x 32 tiles visits the row's tile for other rows and returns
    the mean of v[0:32] there."""
    q, k, v = inputs((1, 1, 64, 8), seed=3)
    kw = dict(window=4, kv_length=[8])
    ref = np.asarray(jax.jit(jatt.attention_reference,
                             static_argnames="window")(
        *(jnp.asarray(a) for a in (q, k, v)), window=4,
        kv_length=jnp.asarray([8])))
    out, lse = tfa.flash_attention_plain(
        *port((q, k, v), torch.float32), window=4,
        kv_length=torch.tensor([8]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert np.all(out.numpy()[0, 0, 40] == 0)
    assert np.isneginf(lse.numpy()[0, 0, 12:]).all()
    assert np.isfinite(lse.numpy()[0, 0, :12]).all()
    jout, _ = jax_fwd(q, k, v, jnp.float32, 32, **kw)
    assert np.abs(jout[0, 0, 40]).max() > 0.1


def test_dispatch_and_validation():
    q, k, v = port(inputs((1, 2, 16, 8), seed=4), torch.float32)
    out = tatt.flash_attention(q, k, v, causal=True)
    assert tatt.last_path == "plain"
    np.testing.assert_allclose(
        out.numpy(), tatt.attention_reference(q, k, v, causal=True).numpy(),
        rtol=1e-5, atol=1e-6)
    dense = torch.ones(16, 16, dtype=torch.bool).tril()
    out = tatt.flash_attention(q, k, v, mask=dense)
    assert tatt.last_path == "reference"
    np.testing.assert_allclose(
        out.numpy(), tatt.flash_attention(q, k, v, causal=True).numpy(),
        rtol=1e-5, atol=1e-6)
    tatt.flash_attention(q, k[:, :, :8], v[:, :, :8])     # Lq != Lk
    assert tatt.last_path == "reference"
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout"):
            tatt.flash_attention(q, k, v, dropout=rate)
    with pytest.raises(ValueError, match="seed"):
        tatt.flash_attention(q, k, v, dropout=0.1)
    # a seed or a generator takes the kernel path with dropout
    a = tatt.flash_attention(q, k, v, dropout=0.5, seed=7)
    b = tatt.flash_attention(q, k, v, dropout=0.5, seed=torch.tensor([7]))
    assert tatt.last_path == "plain" and torch.equal(a, b)
    gen = torch.Generator().manual_seed(1)
    tatt.flash_attention(q, k, v, dropout=0.5, generator=gen)
    # symmetric sliding windows are a band of the same kernel
    np.testing.assert_allclose(
        tatt.sldwin_atten(q, k, v, 3).numpy(),
        tatt.flash_attention(q, k, v, window=3).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_saves_no_square_tensor(rate):
    B, H, L, D = 2, 2, 48, 16
    leaves = [torch.tensor(a, requires_grad=True)
              for a in inputs((B, H, L, D), seed=5)]
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tfa.flash_attention(*leaves, causal=True, dropout=rate,
                                  seed=3, kv_length=torch.tensor([40, 7]))
    assert not [s for s in shapes if s[-2:] == (L, L)], shapes
    assert (B, H, L, D) in shapes and (B, H, L) in shapes
    out.sum().backward()
    assert all(t.grad is not None for t in leaves)
    counts = (tfa.flash_attention.launches_fwd,
              tfa.flash_attention.launches_dq,
              tfa.flash_attention.launches_dkv)
    assert counts == (0, 0, 0)          # CPU tensors launch no kernel
