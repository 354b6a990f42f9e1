"""Port parity of the flash-attention wrappers on strided views and into
output views, and the float32 kernels' 3xTF32 tolerance:
``mxnet_tpu_torch.ops.kernels.flash_attention`` against ``mxnet_tpu``'s
flash kernel (``ops/pallas/flash_attention.py``, run in Pallas interpret
mode on the CPU).  The plain-version parity is in
``test_torch_flash_attention.py``, the helpers both share in
``flash_parity.py``.

- the forward on strided views (a permuted qkv, head slices) equals the
  call on their contiguous copies, ``out=`` and ``lse=`` write only
  their slices, and ``_strided_ok`` (which views the kernels read in
  place) admits exactly what TMA's rules for a tensor map admit;
- the backward likewise: on a permuted qkv with a transposed dO and on
  head slices, lse and delta as slices, with and without dropout and
  kv_length, the JAX kernel's gradients and the bits of the call on
  contiguous copies; ``dq=``, ``dk=`` and ``dv=`` write only their
  slices; and the gradients of the op on a permuted qkv against the JAX
  kernel's;
- emulated 3xTF32 products of the fp32 backward and of the fp32 forward
  within ``chip_smoke``'s TOL_FLASH_3XTF32 of fp64, and single TF32
  products outside it;
- ``flash_attention_bwd_delta``: its plain version is the expression
  it replaced (and the JAX backward's delta, ``flash_attention.py:466``),
  on contiguous tensors and on BERT's transposed dO, and the op's
  backward takes delta from it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa
from flash_parity import DTYPES, close_grads, inputs, jax_grads

torch.set_num_threads(2)


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
    TOL_FLASH_3XTF32) against emulated tensor-core products: the
    backward's second products dS K, dS^T Q and (P keep)^T dO over 512
    keys, from seeded inputs at dropout 0.1, stay within it of the fp64
    product in 3xTF32, and a single TF32 product (operands rounded to
    tf32) exceeds it."""
    import chip_smoke
    tol = chip_smoke.TOL_FLASH_3XTF32
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


def _split_rna(x):
    """x = hi + lo as ``tf32_split`` forms it in registers (mma_product):
    hi and lo each rounded to the nearest tf32."""
    hi = _tf32_round(x)
    return hi, _tf32_round(x - hi)


def _forward_3xtf32(q, k, v, keep, scale):
    """The fp32 forward #5 as the card forms its products, in fp32:
    S = Q K^T on wgmma reads Q and K truncated to tf32, K's residual tile
    truncated and Q's residual rounded (``residual_frags``), lo products
    first; P = exp(S scale - max), P keep; O = (P keep) V on mma.sync with
    both operands split hi + lo, rounded; out = O / l, l the sum of the
    undropped P."""
    qh, kh = _tf32_trunc(q), _tf32_trunc(k)
    ql, kl = _tf32_round(q - qh), _tf32_trunc(k - kh)
    s = (ql @ kh.T + qh @ kl.T) + qh @ kh.T
    p = torch.exp(s * scale - (s * scale).max(-1, keepdim=True).values)
    ph, pl = _split_rna(p * keep)
    vh, vl = _split_rna(v)
    o = (pl @ vh + ph @ vl) + ph @ vh
    return o / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_tf32x3_forward_tolerance(D):
    """The fp32 forward's tolerance on the card (``chip_smoke``'s
    TOL_FLASH_3XTF32, which holds #5's out) against its emulated
    tensor-core products over 512 keys at dropout 0.1, from seeded
    inputs: out in 3xTF32 stays within it of the fp64 forward, and a
    forward whose two products take operands rounded to tf32 once exceeds
    it."""
    import chip_smoke
    tol = chip_smoke.TOL_FLASH_3XTF32
    L, rate = 512, 0.1
    rng = np.random.default_rng(100 + D)
    q, k, v = (torch.tensor(rng.standard_normal((L, D)), dtype=torch.float64)
               for _ in range(3))
    keep = torch.tensor(rng.random((L, L)) >= rate) / (1 - rate)
    scale = 1.0 / np.sqrt(D)
    p = torch.softmax(q @ k.T * scale, dim=-1)
    want = (p * keep) @ v
    big = float(want.abs().max())
    q32, k32, v32, keep32 = q.float(), k.float(), v.float(), keep.float()
    got3 = _forward_3xtf32(q32, k32, v32, keep32, scale)
    s1 = _tf32_round(q32) @ _tf32_round(k32).T * scale
    p1 = torch.exp(s1 - s1.max(-1, keepdim=True).values)
    got1 = (_tf32_round(p1 * keep32) @ _tf32_round(v32)) / p1.sum(
        -1, keepdim=True)
    err3 = float((got3.double() - want).abs().max()) / big
    err1 = float((got1.double() - want).abs().max()) / big
    assert err3 <= tol, (err3, tol)
    assert err1 > tol, (err1, tol)


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
        _JAX_BWD[dtype, rate] = jax_grads(q, k, v, g, 64, DTYPES[dtype][0],
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
    tdt = DTYPES[dtype][1]
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
    jdt, tdt = DTYPES[dtype]
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_plain_is_the_expression_it_replaced(dtype):
    """``flash_attention_bwd_delta`` on CPU tensors is ``(dO.float() *
    O.float()).sum(-1)`` bit for bit, on contiguous tensors and on a
    transposed (B, L, H, D) gradient, and agrees with the JAX backward's
    jnp delta (fp32 sums of 8 products in other orders: a few ulps)."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(21)
    B, H, L, D = 2, 3, 20, 8
    do_t = torch.tensor(rng.standard_normal((B, L, H, D)),
                        dtype=torch.float32).to(tdt)
    out = torch.tensor(rng.standard_normal((B, H, L, D)),
                       dtype=torch.float32).to(tdt)
    for do in (do_t.transpose(1, 2), do_t.transpose(1, 2).contiguous()):
        got = tfa.flash_attention_bwd_delta(do, out)
        assert got.dtype == torch.float32 and got.shape == (B, H, L)
        assert torch.equal(got, (do.float() * out.float()).sum(-1))
        assert torch.equal(got, tfa.flash_attention_bwd_delta_plain(do, out))
        want = jnp.sum(jnp.asarray(do.float().numpy())
                       * jnp.asarray(out.float().numpy()), axis=-1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert tfa.flash_attention.launches_delta == 0    # no kernel on the CPU


def test_backward_takes_delta_from_the_wrapper(monkeypatch):
    """The op's backward computes delta through
    ``flash_attention_bwd_delta`` (once, on the output gradient and the
    saved output) and hands that tensor to the dq and dkv wrappers."""
    seen = {}
    delta_fn = tfa.flash_attention_bwd_delta
    dq_fn = tfa.flash_attention_bwd_dq

    def delta(do, out):
        seen.setdefault("delta", []).append(delta_fn(do, out))
        return seen["delta"][-1]

    def dq(*args, **kw):
        seen["dq_delta"] = args[5]
        return dq_fn(*args, **kw)
    monkeypatch.setattr(tfa, "flash_attention_bwd_delta", delta)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq", dq)
    rng = np.random.default_rng(22)
    q, k, v = (torch.tensor(rng.standard_normal((2, 2, 16, 8)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    g = torch.tensor(rng.standard_normal((2, 2, 16, 8)), dtype=torch.float32)
    out = tfa.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out, (q, k, v), g)
    assert len(seen["delta"]) == 1 and seen["dq_delta"] is seen["delta"][0]
    assert torch.equal(seen["delta"][0], (g * out.detach()).sum(-1))
