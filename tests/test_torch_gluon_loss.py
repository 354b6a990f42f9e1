"""Port parity: every loss of ``gluon.loss`` against ``mxnet_tpu`` on the
CPU, called with ``ndarray``s in both packages: the per-sample losses and
the gradients of the prediction (and of the second input where it is
one), from the same numpy inputs; and the same loss called with torch
tensors gives the ``ndarray`` call's values.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gluon_parity import assert_close, jax_mx, port_mx, rand

# fp32 on both sides: log, exp and the per-sample means a few ulps apart
TOL = dict(rtol=1e-5, atol=1e-6)


def _labels(*shape, hi, seed=1):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(
        np.float32)


def _signs(*shape, seed=1):
    return np.where(rand(*shape, seed=seed) > 0, 1.0, -1.0).astype(
        np.float32)


def _prob(*shape, seed=1):
    p = np.abs(rand(*shape, seed=seed)) + 0.1
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


CASES = {
    # name: (factory, inputs, indices of the differentiated inputs)
    "L2Loss": (lambda l: l.L2Loss(), [rand(4, 3), rand(4, 3, seed=1)],
               (0, 1)),
    "L1Loss": (lambda l: l.L1Loss(weight=0.5), [rand(4, 3),
                                                rand(4, 3, seed=1)], (0,)),
    "SigmoidBCELoss": (lambda l: l.SigmoidBCELoss(),
                       [rand(4, 3), _labels(4, 3, hi=2)], (0,)),
    "SigmoidBCELoss_from_sigmoid": (
        lambda l: l.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True),
        [1 / (1 + np.exp(-rand(4, 3))), _labels(4, 3, hi=2)], (0,)),
    "SoftmaxCELoss": (lambda l: l.SoftmaxCELoss(),
                      [rand(4, 5), _labels(4, hi=5)], (0,)),
    "SoftmaxCELoss_dense": (lambda l: l.SoftmaxCrossEntropyLoss(
        sparse_label=False), [rand(4, 5), _prob(4, 5)], (0,)),
    "KLDivLoss": (lambda l: l.KLDivLoss(from_logits=False),
                  [rand(4, 5), _prob(4, 5)], (0,)),
    "CTCLoss": (lambda l: l.CTCLoss(),
                [rand(2, 6, 4), np.array([[1, 2, 3], [2, 2, 1]],
                                         np.float32)], (0,)),
    "HuberLoss": (lambda l: l.HuberLoss(rho=0.5),
                  [rand(4, 3) * 2, rand(4, 3, seed=1)], (0,)),
    "HingeLoss": (lambda l: l.HingeLoss(), [rand(4, 3), _signs(4, 3)],
                  (0,)),
    "SquaredHingeLoss": (lambda l: l.SquaredHingeLoss(margin=0.5),
                         [rand(4, 3), _signs(4, 3)], (0,)),
    "LogisticLoss": (lambda l: l.LogisticLoss(),
                     [rand(4, 3), _signs(4, 3)], (0,)),
    "LogisticLoss_binary": (lambda l: l.LogisticLoss(label_format="binary"),
                            [rand(4, 3), _labels(4, 3, hi=2)], (0,)),
    "TripletLoss": (lambda l: l.TripletLoss(),
                    [rand(4, 3), rand(4, 3, seed=1), rand(4, 3, seed=2)],
                    (0, 1, 2)),
    "PoissonNLLLoss": (lambda l: l.PoissonNLLLoss(compute_full=True),
                       [rand(4, 3) * 0.5, _labels(4, 3, hi=4)], (0,)),
    "PoissonNLLLoss_probs": (lambda l: l.PoissonNLLLoss(from_logits=False),
                             [np.abs(rand(4, 3)) + 0.5, _labels(4, 3, hi=4)],
                             (0,)),
    "CosineEmbeddingLoss": (lambda l: l.CosineEmbeddingLoss(margin=0.1),
                            [rand(4, 3), rand(4, 3, seed=1),
                             _signs(4, seed=2)], (0, 1)),
    "SDMLLoss": (lambda l: l.SDMLLoss(), [rand(4, 3), rand(4, 3, seed=1)],
                 (0, 1)),
}


def _run(mx, make, inputs, grads):
    xs = [mx.np.array(a) for a in inputs]
    for i in grads:
        xs[i].attach_grad()
    with mx.autograd.record():
        out = make(mx.gluon.loss)(*xs)
    out.backward(mx.np.array(rand(*out.shape, seed=5)))
    return out.asnumpy(), [xs[i].grad.asnumpy() for i in grads]


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    make, inputs, grads = CASES[name]
    want = _run(jax_mx(), make, inputs, grads)
    tmx = port_mx()
    with tmx.Context("cpu"):
        got = _run(tmx, make, inputs, grads)
    assert_close(got[0], want[0], name=name, **TOL)
    assert_close(got[1], want[1], name=name + " grads", **TOL)
    direct = make(tmx.gluon.loss)(*[torch.tensor(a) for a in inputs])
    np.testing.assert_array_equal(direct.numpy(), got[0])


def test_loss_weights_and_batch_axis():
    pred, label = rand(3, 4, 2), rand(3, 4, 2, seed=1)
    sw = np.abs(rand(3, 4, 1, seed=2))
    jmx, tmx = jax_mx(), port_mx()
    want = jmx.gluon.loss.L2Loss(weight=0.3, batch_axis=1)(
        jmx.np.array(pred), jmx.np.array(label), jmx.np.array(sw))
    with tmx.Context("cpu"):
        got = tmx.gluon.loss.L2Loss(weight=0.3, batch_axis=1)(
            tmx.np.array(pred), tmx.np.array(label), tmx.np.array(sw))
    assert got.shape == (4,)
    assert_close(got.asnumpy(), want.asnumpy(), **TOL)
