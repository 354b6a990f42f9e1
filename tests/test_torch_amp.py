"""Port parity: ``mxnet_tpu_torch.amp`` against ``mxnet_tpu.amp`` on the
CPU.

- ``convert_hybrid_block(net, "bfloat16")`` on the tiny BERT (flash
  attention, valid lengths) gives JAX's bf16 logits (its flash kernel in
  Pallas interpret mode), fp32 out, while the parameters and their
  gradients stay fp32 masters;
- ``excluded_sym_names`` keeps a layer in fp32; ``fp32_ops`` drops an op
  from the scope; ``cast_params_offline`` casts the weights;
- the op lists equal ``mxnet_tpu.amp.lists``;
- ``LossScaler`` gives JAX's scale sequence on a scripted overflow
  pattern, and ``init_trainer``/``scale_loss``/``unscale`` drive it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mxnet_tpu import amp as jamp
from mxnet_tpu import np as mnp
from mxnet_tpu.amp.loss_scaler import LossScaler as JLossScaler
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.ops import nn as tnn
from torch_parity import tiny_bert_with_affine

torch.set_num_threads(2)

B, L = 3, 12
# bf16 on both sides, the same casts at the same ops.  MLM logits: the
# frameworks' fp32 sums in another order only rarely round a bf16 value
# the other way (observed 4e-6, against a bf16-vs-fp32 difference of
# 4.5e-3).  NSP logits: the pooled vector (tanh, |x| <= 1) is rounded to
# bf16 before the NSP GEMM; where the two tanh differ in the last fp32
# bits it can round one bf16 step (2**-8) apart, moving a logit by
# 2**-8 |w| ~ 1e-4 per element that flips (observed 1.7e-4)
TOL_MLM = 1e-4
TOL_NSP = 5e-4


@pytest.fixture(scope="module")
def models():
    return tiny_bert_with_affine(use_flash=True)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 1000, (B, L)), rng.integers(0, 2, (B, L)),
            np.array([L, 5, 0]))


def port_net(params):
    return tbert.bert_tiny(device="cpu", dropout=0.0).load_jax_params(params)


def run_port(model, batch):
    return model(*(torch.tensor(a) for a in batch))


def test_bf16_logits_match_jax(monkeypatch, models, batch):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "interpret")
    jnet, params = models
    jm, jn = jamp.convert_hybrid_block(jnet, "bfloat16")(
        *(mnp.array(a) for a in batch))
    net = port_net(params).eval()
    with torch.no_grad():
        tm, tn = run_port(tamp.convert_hybrid_block(net, "bfloat16"), batch)
        fm, _ = run_port(net, batch)
    assert tm.dtype == tn.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), jm.asnumpy(), rtol=0,
                               atol=TOL_MLM)
    np.testing.assert_allclose(tn.numpy(), jn.asnumpy(), rtol=0,
                               atol=TOL_NSP)
    # bf16 ran: the fp32 model's logits lie far outside that tolerance
    assert float((tm - fm).abs().max()) > 10 * TOL_MLM


def test_masters_stay_fp32(models, batch):
    _, params = models
    net = port_net(params)
    amp_net = tamp.convert_hybrid_block(net, "bfloat16")
    mlm, nsp = run_port(amp_net, batch)
    (mlm.sum() + nsp.sum()).backward()
    for name, p in net.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is not None and p.grad.dtype == torch.float32, name
    assert tnn._amp_state() is None          # the scope closed
    # the wrapper is the module: parameters, train/eval, attributes
    assert list(amp_net.parameters())[0] is list(net.parameters())[0]
    assert amp_net.generator is net.generator


def layer_dtypes(net, amp_net, batch):
    seen = {}
    hooks = [layer.register_forward_hook(
        lambda m, i, out, n=n: seen.__setitem__(n, out.dtype))
        for n, layer in enumerate(net.encoder.layers)]
    with torch.no_grad():
        run_port(amp_net, batch)
    for h in hooks:
        h.remove()
    return [seen[n] for n in range(len(seen))]


def test_excluded_layer_stays_fp32(models, batch):
    _, params = models
    net = port_net(params).eval()
    bf16 = layer_dtypes(net, tamp.convert_hybrid_block(net), batch)
    assert bf16 == [torch.bfloat16, torch.bfloat16]
    amp_net = tamp.convert_hybrid_block(
        net, excluded_sym_names=["encoder.layers.0"])
    assert layer_dtypes(net, amp_net, batch) == [torch.float32,
                                                 torch.bfloat16]
    # converting again without exclusions clears the hooks
    amp_net = tamp.convert_hybrid_block(amp_net)
    assert layer_dtypes(net, amp_net, batch) == bf16
    with pytest.warns(UserWarning, match="not found"):
        tamp.convert_hybrid_block(net, excluded_sym_names=["nope"])


def test_fp32_ops_override():
    x = torch.randn(4, 32)
    w = torch.randn(16, 32)
    ref = tnn.fully_connected(x, w)
    tnn._amp_set((torch.bfloat16, frozenset(["fully_connected"])))
    try:
        assert tnn.fully_connected(x, w).dtype == torch.bfloat16
        # an fp32 bias joins after the bf16 product, as in the JAX package
        assert tnn.fully_connected(x, w, torch.zeros(16)).dtype == \
            torch.float32
        assert tnn.batch_dot(x[None], x[None], transpose_b=True).dtype == \
            torch.float32                    # not in this op set
    finally:
        tnn._amp_set(None)
    fc = torch.nn.Linear(32, 16)
    amp_fc = tamp.convert_hybrid_block(fc, fp32_ops=["fully_connected"])
    assert amp_fc._opset == frozenset(tamp.lists.TARGET_DTYPE_OPS) - {
        "fully_connected"}
    assert torch.equal(tnn.fully_connected(x, w), ref)


def test_cast_params_offline(models, batch):
    _, params = models
    net = port_net(params).eval()
    with torch.no_grad():
        ref, _ = run_port(net, batch)
    out = tamp.convert_hybrid_block(net, cast_params_offline=True)
    assert out is net
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    with torch.no_grad():
        mlm, _ = run_port(net, batch)
    assert mlm.dtype == torch.bfloat16
    # bf16 weights and activations throughout: a few bf16 steps of the
    # logits' largest magnitude (~0.9)
    assert float((mlm.float() - ref).abs().max()) < 0.05


def test_lists_match_jax():
    for name in ("TARGET_DTYPE_OPS", "WIDEST_TYPE_CASTS", "FP32_OPS",
                 "CONDITIONAL_FP32_OPS"):
        assert getattr(tamp.lists, name) == getattr(jamp.lists, name), name


def test_loss_scaler_matches_jax():
    pattern = [True, True] + [False] * 5 + [True] + [False] * 7 + \
        [True, True] + [False] * 20
    ours = tamp.LossScaler(init_scale=2 ** 10, scale_window=3,
                           max_scale=2 ** 12)
    ref = JLossScaler(init_scale=2 ** 10, scale_window=3, max_scale=2 ** 12)
    got = [ours.update_scale(o) for o in pattern]
    want = [ref.update_scale(o) for o in pattern]
    assert got == want
    steps = np.diff([2.0 ** 10] + got)
    assert (steps > 0).any() and (steps < 0).any()
    assert max(got) == 2 ** 12                      # capped
    assert ours.scale_window == 3
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(2))
    assert not ours.has_overflow([p, q])            # no gradients yet
    p.grad, q.grad = torch.ones(3), torch.tensor([1.0, float("nan")])
    assert ours.has_overflow([p, q])
    q.grad = torch.ones(2)
    assert not ours.has_overflow([p, q])


def test_init_trainer_scale_and_unscale():
    p = torch.nn.Parameter(torch.ones(4))
    trainer = Trainer([p], "sgd", {"learning_rate": 0.1})
    assert trainer._amp_loss_scaler is None
    tamp.init("bfloat16")
    tamp.init_trainer(trainer)
    assert trainer._amp_loss_scaler is None          # bf16 needs none
    try:
        tamp.init(target_dtype="float16")
        tamp.init_trainer(trainer)
    finally:
        tamp.init("bfloat16")
    scaler = trainer._amp_loss_scaler
    assert isinstance(scaler, tamp.LossScaler)
    loss = (p * 2.0).sum()
    with tamp.scale_loss(loss, trainer) as scaled:
        assert float(scaled.detach()) == float(loss.detach()) * \
            scaler.loss_scale
        scaled.backward()
    tamp.unscale(trainer)
    torch.testing.assert_close(p.grad, torch.full((4,), 2.0))
