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
- the autograd Function saves no (L, L) tensor;
- the forward on strided views (a permuted qkv, head slices) equals the
  call on their contiguous copies, ``out=`` and ``lse=`` write only
  their slices, and ``_strided_ok`` (which views the kernel reads in
  place) admits exactly what TMA's rules for a tensor map admit;
- the backward likewise: on a permuted qkv with a transposed dO and on
  head slices, lse and delta as slices, with and without dropout and
  kv_length, the JAX kernel's gradients and the bits of the call on
  contiguous copies; ``dq=``, ``dk=`` and ``dv=`` write only their
  slices; and the gradients of the op on a permuted qkv against the JAX
  kernel's.
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

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MASKS = ["none", "causal", "window", "kv_length"]


def inputs(shape, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


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
    jdt, tdt = _DT[dtype]
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


def jax_grads(q, k, v, g, block, jdt=jnp.float32, **kw):
    def loss(a, b, c):
        out = jfa.flash_attention_tpu(a, b, c, block_q=block, block_k=block,
                                      interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * g)
    jq = [jnp.asarray(a, jdt) for a in (q, k, v)]
    return [np.asarray(t.astype(jnp.float32))
            for t in jax.grad(loss, argnums=(0, 1, 2))(*jq)]


def port_grads(q, k, v, g, tdt=torch.float32, **kw):
    leaves = [torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, **kw)
    out.backward(torch.tensor(g).to(tdt))
    return (out.detach().float().numpy(),
            [t.grad.float().numpy() for t in leaves])


def close_grads(got, want):
    """Each gradient within 1e-4 of its largest element: fp32 products
    and sums over the keys in another order."""
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


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
    jdt, tdt = _DT[dtype]
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


def test_strided_views_equal_contiguous_call():
    """``flash_attention_fwd`` on BERT's permuted (B, L, 3, H, D)
    projection and on head slices gives exactly what it gives on their
    contiguous copies; ``out=`` and ``lse=`` write their slices of larger
    buffers and nothing else, and are what it returns."""
    B, H, L, D = 2, 4, 40, 8
    rng = np.random.default_rng(6)
    qkv = torch.tensor(rng.standard_normal((B, L, 3, H, D)),
                       dtype=torch.float32)
    wide = torch.tensor(rng.standard_normal((3, B, H + 2, L, D)),
                        dtype=torch.float32)
    kvl = torch.tensor([L, 13])
    for views in (tuple(qkv.permute(2, 0, 3, 1, 4)), tuple(wide[:, :, 1:-1])):
        assert not views[0].is_contiguous()
        for kw in (dict(causal=True),
                   dict(kv_length=kvl, dropout=0.1, seed=torch.tensor([5]))):
            got = tfa.flash_attention_fwd(*views, **kw)
            want = tfa.flash_attention_fwd(*(t.contiguous() for t in views),
                                           **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    out_buf = torch.full((B + 1, H + 2, L, D), float("nan"))
    lse_buf = torch.full((B + 1, H + 2, L), float("nan"))
    out_v, lse_v = out_buf[1:, 1:-1], lse_buf[1:, 1:-1]
    out, lse = tfa.flash_attention_fwd(q, k, v, causal=True, out=out_v,
                                       lse=lse_v)
    assert out is out_v and lse is lse_v
    want = tfa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
    assert torch.equal(out_v, want[0]) and torch.equal(lse_v, want[1])
    inside = torch.zeros(B + 1, H + 2, L, dtype=torch.bool)
    inside[1:, 1:-1] = True
    assert out_buf[~inside].isnan().all() and lse_buf[~inside].isnan().all()
    with pytest.raises(ValueError, match="out"):
        tfa.flash_attention_fwd(q, k, v, out=out_buf)


def _tma_admits(t):
    """TMA's rules for a tensor map over the (B, H, L, D) view ``t``, as
    CUDA's ``cuTensorMapEncodeTiled`` states them: a 16-byte aligned
    base, unit stride along D, and every other stride a positive multiple
    of 16 bytes below 2**40 (a dim of size 1 is never stepped along: its
    stride is free)."""
    elt = t.element_size()
    if t.data_ptr() % 16 or t.stride(-1) != 1:
        return False
    return all(n == 1 or (0 < s * elt < 2 ** 40 and s * elt % 16 == 0)
               for n, s in zip(t.shape[:-1], t.stride()[:-1]))


class _FakeView:
    """The metadata of a view too large to allocate."""

    def __init__(self, shape, stride, elt=2):
        self.shape, self._stride, self._elt = shape, stride, elt

    def stride(self):
        return self._stride

    def data_ptr(self):
        return 0

    def is_contiguous(self):
        return False

    def element_size(self):
        return self._elt


def test_strided_ok_admits_exactly_the_tma_rules():
    views = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        x = torch.zeros(2, 6, 10, 64, dtype=dt)
        views[name + " contiguous"] = x
        views[name + " head slice"] = x[:, 1:4]
        views[name + " batch and row slices"] = x[1:, :, 3:7]
        views[name + " permuted qkv"] = torch.zeros(
            2, 10, 3, 6, 64, dtype=dt).permute(2, 0, 3, 1, 4)[1]
        flat = torch.zeros(2 * 6 * 10 * 64 + 8, dtype=dt)
        views[name + " misaligned base"] = flat[1:1 + 2 * 6 * 10 * 64].view(
            2, 6, 10, 64)
        views[name + " base 16 bytes on"] = flat[16 // x.element_size():][
            :2 * 6 * 10 * 64].view(2, 6, 10, 64)
        views[name + " D stride 2"] = torch.zeros(2, 6, 10, 128,
                                                  dtype=dt)[..., ::2]
        views[name + " L and D swapped"] = torch.zeros(
            2, 6, 64, 10, dtype=dt).transpose(2, 3)
        views[name + " expanded heads"] = x[:, :1].expand(2, 6, 10, 64)
        views[name + " size-1 head, odd stride"] = x[:, :1].as_strided(
            (2, 1, 10, 64), (6 * 640, 7, 64, 1))
    # a row stride of 8 bytes at D 4 (bf16), from a larger tensor
    views["bf16 D 4 rows 8 bytes"] = torch.zeros(2, 6, 10, 4,
                                                 dtype=torch.bfloat16)[:, 1:3]
    views["fp32 D 4 rows 16 bytes"] = torch.zeros(2, 6, 10, 4)[:, 1:3]
    views["fp32 D 3 rows 12 bytes"] = torch.zeros(2, 6, 10, 3)
    want_in_place = {k: _tma_admits(v) for k, v in views.items()}
    assert want_in_place["float32 head slice"]
    assert want_in_place["bfloat16 permuted qkv"]
    assert not want_in_place["bfloat16 misaligned base"]
    assert not want_in_place["bf16 D 4 rows 8 bytes"]
    assert not want_in_place["float32 D stride 2"]
    got = {k: tfa._strided_ok(v) for k, v in views.items()}
    for k in views:
        assert got[k] == want_in_place[k], k
    # bf16 batch strides of 2**39 and 2**40 bytes
    for stride, ok in ((2 ** 38, True), (2 ** 39, False)):
        fake = _FakeView((2, 2, 2, 64), (stride, 128, 64, 1))
        assert tfa._strided_ok(fake) == ok, stride


def _tf32_trunc(x):
    """x with the low 13 bits of each fp32 word cleared: the tf32 value a
    tensor core reads from an fp32 word."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_round(x):
    """x rounded to the nearest tf32 (ties away from zero), as
    ``cvt.rna.tf32.f32``."""
    return _tf32_trunc((x.view(torch.int32) + 4096).view(torch.float32))


def _product_3xtf32(a, b):
    """a @ b as the fp32 backward kernels form it: each operand split into
    hi = trunc(x) and lo = trunc(x - hi), hi hi + hi lo + lo hi summed in
    fp32, lo lo left out."""
    ah, bh = _tf32_trunc(a), _tf32_trunc(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return ah @ bh + ah @ bl + al @ bh


@pytest.mark.parametrize("D", [32, 64, 128])
def test_tf32x3_tolerance(D):
    """The fp32 backward's tolerance on the card (``chip_smoke``'s
    TOL_FLASH_BWD_F32) against emulated tensor-core products: the
    backward's second products dS K, dS^T Q and (P keep)^T dO over 512
    keys, from seeded inputs at dropout 0.1, stay within it of the fp64
    product in 3xTF32, and a single TF32 product (operands rounded to
    tf32) exceeds it."""
    import chip_smoke
    tol = chip_smoke.TOL_FLASH_BWD_F32
    L, rate = 512, 0.1
    rng = np.random.default_rng(D)
    q, k, v, do = (torch.tensor(rng.standard_normal((L, D)),
                                dtype=torch.float64) for _ in range(4))
    keep = torch.tensor(rng.random((L, L)) >= rate) / (1 - rate)
    p = torch.softmax(q @ k.T / np.sqrt(D), dim=-1)
    pk = p * keep
    delta = (do * (pk @ v)).sum(-1, keepdim=True)
    ds = p * ((do @ v.T) * keep - delta)
    for a, b in ((ds, k), (ds.T, q), (pk.T, do)):
        want = a @ b
        a32, b32 = a.float(), b.float()
        err3 = float((_product_3xtf32(a32, b32).double() - want).abs().max())
        err1 = float(((_tf32_round(a32) @ _tf32_round(b32)).double()
                      - want).abs().max())
        big = float(want.abs().max())
        assert err3 / big <= tol, (err3 / big, tol)
        assert err1 / big > tol, (err1 / big, tol)


def _bwd_inputs(views, kw):
    """(q, k, v, dO, lse, delta) over the views (q, k, v, dO), lse and
    delta as slices of larger buffers."""
    out, lse = tfa.flash_attention_fwd(*views[:3], **kw)
    delta = (views[3].float() * out.float()).sum(-1)
    B, H, L = lse.shape
    stats = [torch.full((B + 1, H + 2, L), float("nan"))[1:, 1:-1].copy_(t)
             for t in (lse, delta)]
    return list(views) + stats


_JAX_BWD = {}


def _jax_bwd_want(dtype, rate, q, k, v, g, L):
    """The JAX kernel's gradients (interpret mode) for the cases of
    ``test_backward_strided_views_equal_contiguous_call``, once per dtype
    and rate."""
    if (dtype, rate) not in _JAX_BWD:
        jkw = dict(causal=True)
        if rate:
            jkw = dict(dropout=rate, seed=jnp.uint32(9), kv_length=[L, 13])
        _JAX_BWD[dtype, rate] = jax_grads(q, k, v, g, 64, _DT[dtype][0],
                                          **jkw)
    return _JAX_BWD[dtype, rate]


@pytest.mark.parametrize("layout", ["permuted", "head slices"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_strided_views_equal_contiguous_call(layout, dtype, rate):
    """``flash_attention_bwd_dq`` and ``_dkv`` on BERT's permuted (B, L, 3,
    H, D) projection with dO as the transposed gradient of the output, or
    on head slices of NaN-padded buffers, with lse and delta as slices:
    causal, and kv_length (a row of 13) with dropout.  The gradients they
    give are the JAX kernel's (``jax.grad`` in interpret mode on the same
    numpy q, k, v and dO), within ``test_gradients_match_jax``'s
    tolerances, and the same bits as the call on contiguous copies.  (On
    the CPU the wrappers read contiguous copies; that the kernels read the
    views in place to the same bits is ``chip_smoke.check_flash_strided``'s
    check on the card.)"""
    tdt = _DT[dtype][1]
    B, H, L, D = 2, 2, 64, 16
    q, k, v, g = inputs((B, H, L, D), seed=7, n=4)
    if layout == "permuted":
        # (B, L, 3, H, D) and (B, L, H, D) in row-major order, as BERT's
        # projection and output gradient lie
        qkv = np.ascontiguousarray(
            np.stack([np.transpose(a, (0, 2, 1, 3)) for a in (q, k, v)], 2))
        views = list(torch.tensor(qkv).to(tdt).permute(2, 0, 3, 1, 4))
        views.append(torch.tensor(np.ascontiguousarray(
            np.transpose(g, (0, 2, 1, 3)))).to(tdt).transpose(1, 2))
    else:
        wide = np.full((4, B, H + 2, L, D), np.nan, np.float32)
        wide[:, :, 1:-1] = (q, k, v, g)
        views = list(torch.tensor(wide).to(tdt)[:, :, 1:-1])
    kw = dict(causal=True)
    if rate:
        kw = dict(dropout=rate, seed=torch.tensor([9]),
                  kv_length=torch.tensor([L, 13]))
    ins = _bwd_inputs(views, kw)
    assert not any(t.is_contiguous() for t in ins)
    got = (tfa.flash_attention_bwd_dq(*ins, **kw),
           *tfa.flash_attention_bwd_dkv(*ins, **kw))
    assert all(a.dtype == tdt for a in got)
    want = _jax_bwd_want(dtype, rate, q, k, v, g, L)
    got_np = [a.float().numpy() for a in got]
    if dtype == "float32":
        close_grads(got_np, want)
    else:
        for a, b in zip(got_np, want):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2.0 ** -8 * np.abs(b).max())
    flat = [t.contiguous() for t in ins]
    same = (tfa.flash_attention_bwd_dq(*flat, **kw),
            *tfa.flash_attention_bwd_dkv(*flat, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, same))


def test_backward_output_views():
    """``dq=``, ``dk=`` and ``dv=`` views of larger NaN-filled buffers are
    written, returned, and nothing else of the buffers changes; an output
    of the wrong shape or dtype raises."""
    B, H, L, D = 2, 3, 24, 8
    rng = np.random.default_rng(8)
    views = [torch.tensor(a) for a in rng.standard_normal((4, B, H, L, D),
                                                          dtype=np.float32)]
    kw = dict(dropout=0.1, seed=torch.tensor([4]),
              kv_length=torch.tensor([L, 5]))
    ins = _bwd_inputs(views, kw)
    bufs = [torch.full((B + 1, H + 2, L, D), float("nan")) for _ in range(3)]
    outs = [b[1:, 1:-1] for b in bufs]
    dq = tfa.flash_attention_bwd_dq(*ins, dq=outs[0], **kw)
    dk, dv = tfa.flash_attention_bwd_dkv(*ins, dk=outs[1], dv=outs[2], **kw)
    assert dq is outs[0] and dk is outs[1] and dv is outs[2]
    want = (tfa.flash_attention_bwd_dq(*ins, **kw),
            *tfa.flash_attention_bwd_dkv(*ins, **kw))
    inside = torch.zeros(B + 1, H + 2, L, D, dtype=torch.bool)
    inside[1:, 1:-1] = True
    for o, w, b in zip(outs, want, bufs):
        assert torch.equal(o, w) and not o.isnan().any()
        assert b[~inside].isnan().all()
    with pytest.raises(ValueError, match="dq"):
        tfa.flash_attention_bwd_dq(*ins, dq=bufs[0], **kw)
    with pytest.raises(ValueError, match="dv"):
        tfa.flash_attention_bwd_dkv(*ins, dv=outs[2].to(torch.bfloat16),
                                    **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_on_permuted_views_match_jax(dtype):
    """``ops.attention.flash_attention`` on q, k, v permuted out of one
    (B, L, 3, H, D) projection, its output transposed back as BERT's
    attention does: the projection's gradient against ``jax.grad``
    through the JAX package's kernel in interpret mode on the same numpy
    q, k, v (causal, kv_length with a row of length 0), within the
    tolerances of ``test_gradients_match_jax``."""
    jdt, tdt = _DT[dtype]
    B, H, L, D = 2, 2, 64, 16
    rng = np.random.default_rng(10)
    qkv = rng.standard_normal((B, L, 3, H, D)).astype(np.float32)
    g = rng.standard_normal((B, L, H, D)).astype(np.float32)
    q, k, v = np.transpose(qkv, (2, 0, 3, 1, 4))
    want = jax_grads(q, k, v, np.transpose(g, (0, 2, 1, 3)), 64, jdt,
                     causal=True, kv_length=[37, 0])
    leaf = torch.tensor(qkv).to(tdt).requires_grad_()
    tq, tk, tv = leaf.permute(2, 0, 3, 1, 4)
    out = tatt.flash_attention(tq, tk, tv, causal=True,
                               kv_length=torch.tensor([37, 0]))
    out.transpose(1, 2).backward(torch.tensor(g).to(tdt))
    got = [t.float().numpy() for t in leaf.grad.permute(2, 0, 3, 1, 4)]
    if dtype == "float32":
        close_grads(got, want)
    else:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2.0 ** -8 * np.abs(b).max())
    assert not np.any(got[0][1])      # the row without keys: no gradient
