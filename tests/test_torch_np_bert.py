"""The slice as a whole on the CPU: a 2-layer BERT encoder at small widths
(``bert_tiny``: units 64, FFN 128, 2 heads of D 32) from
``tests/torch_parity.py:tiny_bert_with_affine``'s weights, composed of
``np``/``npx`` ops (``models.bert.encoder_np``, the JAX package's layer
composition with flash attention and the fused epilogues) and run in both
packages under ``autograd.record()``:

- the loss and every parameter's gradient (and the input's) agree with
  the JAX package's, at dropout 0 with valid lengths shorter than L;
- the same encoder agrees with the port's torch-native ``BERTEncoder`` on
  the same weights, output and gradients;
- with dropout 0.1 in the flash and bias-dropout-residual kernels' hash
  masks (the FFN's ``npx.dropout`` off), the same ``mx.random.seed`` gives
  the same loss and gradients;
- under ``amp.init("bfloat16")`` and ``amp.op_scope()`` the projections,
  attention and epilogues run in bfloat16 and the loss is within 1e-2 of
  the fp32 loss; fp32 again after the scope.

Tolerance: fp32 loss within rtol 1e-5, gradients within 1e-4 of each
tensor's largest element (the two packages sum the projections' and the
attention's products in different orders).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from np_parity import jax_mx, port_mx, to_numpy
from torch_parity import tiny_bert_with_affine

torch.set_num_threads(2)

B, L = 3, 16
VALID = np.array([16, 9, 12], np.int32)


@pytest.fixture(scope="module")
def weights():
    _, params = tiny_bert_with_affine(seed=0)
    enc = {k[len("encoder."):]: v for k, v in params.items()
           if k.startswith("encoder.")}
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, L, 64)).astype(np.float32)
    w = rng.standard_normal((B, L, 64)).astype(np.float32)
    return enc, x, w


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


def run(m, weights, dropout=0.0, valid=True, ffn_dropout=None):
    from mxnet_tpu_torch.models.bert import encoder_np
    enc, x, w = weights
    params = {k: m.np.array(v) for k, v in enc.items()}
    for p in params.values():
        p.attach_grad()
    xa = m.np.array(x)
    xa.attach_grad()
    with m.autograd.record():
        out = encoder_np(params, xa, m.np.array(VALID) if valid else None,
                         num_heads=2, dropout=dropout, np=m.np, npx=m.npx,
                         ffn_dropout=ffn_dropout)
        loss = (out * m.np.array(w)).sum()
    loss.backward()
    grads = {k: to_numpy(p.grad) for k, p in params.items()}
    grads["x"] = to_numpy(xa.grad)
    return float(loss), to_numpy(out), grads


def _close_grads(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_encoder_loss_and_gradients_match_jax(weights):
    lt, ot, gt = run(port_mx(), weights)
    lj, oj, gj = run(jax_mx(), weights)
    assert lt == pytest.approx(lj, rel=1e-5)
    np.testing.assert_allclose(ot, oj, rtol=1e-4, atol=1e-4)
    _close_grads(gt, gj)


def test_encoder_matches_the_torch_native_encoder(weights):
    from mxnet_tpu_torch.models.bert import BERTEncoder
    enc, x, w = weights
    net = BERTEncoder(num_layers=2, units=64, hidden_size=128, num_heads=2,
                      dropout=0.0, device="cpu")
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(enc[name]))
    xt = torch.tensor(x, requires_grad=True)
    out = net(xt, torch.tensor(VALID))
    (out * torch.tensor(w)).sum().backward()
    _, on, gn = run(port_mx(), weights)
    np.testing.assert_allclose(on, out.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    want = {k: p.grad.numpy() for k, p in net.named_parameters()}
    want["x"] = xt.grad.numpy()
    _close_grads(gn, want)


def test_hash_dropout_reproducible_for_a_seed(weights):
    """Dropout 0.1 in the flash and bias-dropout-residual kernels (whose
    hash masks follow the seed on every device); the FFN's npx.dropout,
    which draws from a device generator, is held off."""
    tmx = port_mx()
    tmx.random.seed(3)
    l1, _, g1 = run(tmx, weights, dropout=0.1, ffn_dropout=0.0)
    tmx.random.seed(3)
    l2, _, g2 = run(tmx, weights, dropout=0.1, ffn_dropout=0.0)
    l0, _, _ = run(tmx, weights, dropout=0.0)
    assert l1 == l2 and l1 != l0
    for k in g1:
        np.testing.assert_array_equal(g1[k], g2[k])


def test_amp_bf16_op_scope(weights):
    tmx = port_mx()
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.ops import nn as onn
    l32, _, _ = run(tmx, weights)
    prev = amp._TARGET
    amp.init("bfloat16")
    try:
        with amp.op_scope():
            assert onn._amp_state()[0] == torch.bfloat16
            enc, x, w = weights
            y = tmx.npx.fully_connected(
                tmx.np.array(x), tmx.np.array(enc["layers.0.ffn.ffn1.weight"]),
                None, no_bias=True, flatten=False)
            assert y.dtype == tmx.np.bfloat16
            l16, _, g16 = run(tmx, weights)
    finally:
        amp._TARGET = prev
    assert onn._amp_state() is None
    assert abs(l16 - l32) <= 1e-2 * abs(l32)
    assert all(np.isfinite(g).all() for g in g16.values())
