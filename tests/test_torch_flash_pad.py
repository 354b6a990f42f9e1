"""The flash wrappers at a head dim that is not a multiple of 8.

The kernels #5-#7 and the delta kernel run multiples of 8; for any other D
in [1, 128] each wrapper zero-pads q, k, v (and dO, O) to the next
multiple of 8, takes the default scale from the true D, runs the kernels
and slices out, dq, dk and dv back to D (``flash_attention._pad8``).
Here, on the CPU:

- padding, then the plain version (at the true D's scale), then slicing
  equals the plain version on the unpadded tensors, forward, lse, delta,
  dq, dk and dv, at D 12 and 100, with and without dropout: fp32 within
  1e-6 of the largest element (the padded products add exact zeros; only
  the summation order of the matmuls may change);
- the wrappers' own padding branch, reached by treating the unpadded
  tensors as the card's (``_on_cpu`` answers False for them only, so the
  padded call inside takes the plain version): the same results, the
  inner calls at the padded D, and autograd through ``flash_attention``
  and the #16 route (``flash_attention_sharded``) equal to autograd
  through the plain version, with q, k, v padded once in the forward and
  dO once in the backward (``_FlashAttention``), not again by each
  wrapper.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import attention as att
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa
from mxnet_tpu_torch.parallel import ShardingConfig

torch.set_num_threads(2)

TOL = 1e-6


def _inputs(D, seed, n=4, shape=(2, 3, 40)):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, D, generator=g) for _ in range(n)]


def _seed(rate):
    return torch.tensor([1234567], dtype=torch.int64) if rate else None


def _close(a, b):
    b = b.detach().numpy()
    np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [12, 100])
def test_padded_plain_equals_unpadded(D, rate):
    q, k, v, do = _inputs(D, D)
    kvl = torch.tensor([40, 17])
    kw = dict(causal=False, window=None, dropout=rate, seed=_seed(rate),
              kv_length=kvl)
    out, lse = tfa.flash_attention_plain(q, k, v, scale=None, **kw)
    qp, kp, vp, dop = tfa._pad8(D, q, k, v, do)
    assert qp.shape[-1] == D + (-D % 8)
    scale = 1.0 / D ** 0.5
    outp, lsep = tfa.flash_attention_plain(qp, kp, vp, scale=scale, **kw)
    _close(outp[..., :D], out)
    assert not outp[..., D:].any()
    _close(lsep, lse)
    delta = tfa.flash_attention_bwd_delta_plain(do, out)
    deltap = tfa.flash_attention_bwd_delta_plain(dop, outp)
    _close(deltap, delta)
    dq = tfa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    dqp = tfa.flash_attention_bwd_dq_plain(qp, kp, vp, dop, lsep, deltap,
                                           scale=scale, **kw)
    _close(dqp[..., :D], dq)
    dk, dv = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    dkp, dvp = tfa.flash_attention_bwd_dkv_plain(qp, kp, vp, dop, lsep,
                                                 deltap, scale=scale, **kw)
    _close(dkp[..., :D], dk)
    _close(dvp[..., :D], dv)


@pytest.fixture
def card_branch(monkeypatch):
    """Unpadded tensors take the wrappers' card branch; the padded ones
    inside it the plain version.  Records the head dims of the calls that
    reached the plain version."""
    seen = []
    real = tfa._on_cpu

    def on_cpu(what, q):
        real(what, q)
        if q.shape[-1] % 8:
            return False
        seen.append((what, q.shape[-1]))
        return True

    monkeypatch.setattr(tfa, "_on_cpu", on_cpu)
    return seen


@pytest.fixture
def pads(monkeypatch):
    """The number of tensors each call of ``_pad8`` padded, in order."""
    n = []
    real = tfa._pad8

    def pad8(D, *tensors):
        n.append(len(tensors))
        return real(D, *tensors)

    monkeypatch.setattr(tfa, "_pad8", pad8)
    return n


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [12, 100])
def test_wrappers_pad_and_slice(card_branch, D, rate):
    q, k, v, do = _inputs(D, D + 1)
    kvl = torch.tensor([40, 0])
    kw = dict(causal=True, dropout=rate, seed=_seed(rate), kv_length=kvl)
    want, want_lse = tfa.flash_attention_plain(q, k, v, **kw)
    out_view = torch.empty(2, 3, 40, D)
    out, lse = tfa.flash_attention_fwd(q, k, v, out=out_view, **kw)
    assert out is out_view
    _close(out, want)
    _close(lse, want_lse)
    delta = tfa.flash_attention_bwd_delta(do, out)
    _close(delta, tfa.flash_attention_bwd_delta_plain(do, want))
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    _close(dq, tfa.flash_attention_bwd_dq_plain(q, k, v, do, want_lse,
                                                delta, **kw))
    wk, wv = tfa.flash_attention_bwd_dkv_plain(q, k, v, do, want_lse, delta,
                                               **kw)
    _close(dk, wk)
    _close(dv, wv)
    DP = D + (-D % 8)
    assert [d for _, d in card_branch] == [DP] * 4


@pytest.mark.parametrize("D", [12, 100])
def test_autograd_through_padding(card_branch, pads, D):
    q, k, v, do = _inputs(D, D + 2)
    ls = [t.clone().requires_grad_() for t in (q, k, v)]
    lp = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*ls, dropout=0.1, seed=99)
    assert out.shape == q.shape
    ref = tfa.flash_attention_plain(*lp, dropout=0.1,
                                    seed=torch.tensor([99]))[0]
    _close(out, ref)
    for a, b in zip(torch.autograd.grad(out, ls, do),
                    torch.autograd.grad(ref, lp, do)):
        _close(a, b)
    assert {d for _, d in card_branch} == {D + (-D % 8)}
    assert pads == [3, 1]


def test_sharded_route_through_padding(card_branch, pads):
    """The #16 route's causal call (one flash call over the whole tensors)
    at D 12, forward and gradients."""
    D = 12
    q, k, v, do = _inputs(D, 5, shape=(4, 4, 24))
    cfg = ShardingConfig(mesh_shape=(2, 2), axis_names=("dp", "tp"))
    ls = [t.clone().requires_grad_() for t in (q, k, v)]
    lp = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention_sharded(*ls, cfg, causal=True)
    assert att.last_path == "flash-causal-shard"
    ref = tfa.flash_attention_plain(*lp, causal=True)[0]
    _close(out, ref)
    for a, b in zip(torch.autograd.grad(out, ls, do),
                    torch.autograd.grad(ref, lp, do)):
        _close(a, b)
    assert {d for _, d in card_branch} == {16}
    assert pads == [3, 1]


def test_above_128_still_raises():
    q = torch.zeros(1, 1, 8, 136, device="meta")
    with pytest.raises(ValueError, match=r"any D in \[1, 128\]"):
        tfa._check("flash_attention_fwd", q, q, q, None, None)
