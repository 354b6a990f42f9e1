"""Port parity: ``mxnet_tpu_torch.optimizer`` and ``gluon.Trainer`` against
``mxnet_tpu``'s on the CPU.

- SGD (with and without momentum), Adam and AdamW, with weight decay,
  ``clip_gradient``, ``rescale_grad`` and ``lr_mult``/``wd_mult``, over 3
  updates from the same numpy weights and gradients;
- three ``Trainer.step(B)`` steps of ``bert_tiny`` with Adam at dropout 0
  in both packages: the losses and the parameters agree and the loss
  falls;
- the Trainer's learning-rate accessors, gradient hand-back, and refusal
  of kvstores it does not have.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon as jgluon
from mxnet_tpu import np as mnp
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.gluon import Trainer, loss as tloss
from mxnet_tpu_torch.models import bert as tbert
from torch_parity import tiny_bert_with_affine

torch.set_num_threads(2)

OPTS = [
    ("sgd", dict(learning_rate=0.1)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    ("sgd", dict(learning_rate=0.05, momentum=0.5, clip_gradient=0.3,
                 rescale_grad=0.25)),
    ("adam", dict(learning_rate=0.01)),
    ("adam", dict(learning_rate=0.01, wd=0.1, clip_gradient=0.5,
                  rescale_grad=0.5, epsilon=1e-6)),
    ("adamw", dict(learning_rate=0.01, wd=0.1, beta1=0.8, beta2=0.99)),
    ("adamw", dict(learning_rate=0.02, wd=0.01, clip_gradient=0.2,
                   rescale_grad=2.0)),
]


@pytest.mark.parametrize("name,kw", OPTS,
                         ids=["%s-%d" % (n, i) for i, (n, _) in
                              enumerate(OPTS)])
def test_optimizer_matches_jax(name, kw):
    rng = np.random.default_rng(1)
    shapes = [(4, 6), (6,)]
    w0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jo = mx.optimizer.create(name, **kw)
    to = topt.create(name, **kw)
    for o in (jo, to):
        o.set_lr_mult({1: 0.5})
        o.set_wd_mult({1: 0.0})
    jw = [mnp.array(w) for w in w0]
    tw = [torch.tensor(w) for w in w0]
    js = [jo.create_state(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state(i, w) for i, w in enumerate(tw)]
    for step in grads:
        jo.update([0, 1], jw, [mnp.array(g) for g in step], js)
        to.update([0, 1], tw, [torch.tensor(g) for g in step], ts)
        for j, t in zip(jw, tw):
            # elementwise fp32 updates; the two frameworks may round the
            # scalar products in another order: a few ulps
            np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-6,
                                       atol=1e-6)
    assert to.num_update == jo.num_update == 3


def test_optimizer_registry():
    assert isinstance(topt.create("Adam"), topt.Adam)
    assert isinstance(topt.create("adamw"), topt.AdamW)
    sgd = topt.SGD(learning_rate=0.5)
    assert topt.create(sgd) is sgd
    assert isinstance(topt.create("lamb"), topt.LAMB)
    with pytest.raises(KeyError):
        topt.create("no_such_optimizer")


B, L, V = 4, 10, 1000


def test_trainer_steps_match_jax():
    jnet, params = tiny_bert_with_affine(seed=1)
    net = tbert.bert_tiny(use_flash=False, dropout=0.0, device="cpu")
    net.load_jax_params(params)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, V, (B, L))
    types = rng.integers(0, 2, (B, L))
    valid = rng.integers(4, L + 1, (B,))
    mlm = rng.integers(0, V, (B, L))
    nsp = rng.integers(0, 2, (B,))
    opt = {"learning_rate": 1e-3}
    jtr = jgluon.Trainer(jnet.collect_params(), "adam", opt)
    ttr = Trainer(dict(net.named_parameters()), "adam", opt)
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    tce = tloss.SoftmaxCrossEntropyLoss()
    jl, tl = [], []
    for _ in range(3):
        with autograd.record():
            jm, jn = jnet(mnp.array(tokens), mnp.array(types),
                          mnp.array(valid))
            loss = jce(jm, mnp.array(mlm)) + jce(jn, mnp.array(nsp))
        loss.backward()
        jtr.step(B)
        jl.append(float(loss.sum()))
        tm, tn = net(torch.tensor(tokens), torch.tensor(types),
                     torch.tensor(valid))
        loss = tce(tm, torch.tensor(mlm)) + tce(tn, torch.tensor(nsp))
        loss.backward(torch.ones_like(loss))
        ttr.step(B)
        tl.append(float(loss.detach().sum()))
        assert all(p.grad is None for p in net.parameters())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    jp = jnet.collect_params()
    for name, p in net.named_parameters():
        # fp32 gradients a few ulps apart move the weights ~1e-7 apart
        # (5.1e-7 at most here).  Adam moves a weight by about lr per step
        # whatever its gradient's size, so a gradient within rounding of 0
        # could split the two copies by up to 2 lr; none does at this seed
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name].data().asnumpy(), rtol=0,
                                   atol=2e-6, err_msg=name)


def test_trainer_accessors_and_stores():
    w = torch.nn.Parameter(torch.ones(3))
    tr = Trainer([w], "sgd", {"learning_rate": 0.5, "rescale_grad": 2.0})
    assert tr.learning_rate == 0.5
    tr.set_learning_rate(0.25)
    assert tr.learning_rate == tr.optimizer.lr == 0.25
    w.grad = torch.full((3,), 4.0)
    tr.step(8)                       # rescale 2 / 8: w -= 0.25 * 4 / 4
    torch.testing.assert_close(w.detach(), torch.full((3,), 0.75))
    assert w.grad is None
    tr.step(8)                       # no gradient: nothing moves
    torch.testing.assert_close(w.detach(), torch.full((3,), 0.75))
    for kv in ("local", None):
        Trainer([w], "sgd", kvstore=kv)
    for kv in ("dist_sync", "dist_async", "nccl"):
        with pytest.raises(NotImplementedError):
            Trainer([w], "sgd", kvstore=kv)
    with pytest.raises(NotImplementedError):
        Trainer([w], "sgd", update_on_kvstore=True)
    with pytest.raises(ValueError):
        Trainer([torch.ones(3)], "sgd")
