"""Port parity: the training slice's building blocks on the CPU against
``mxnet_tpu``: ``ops.nn`` (layer_norm, masked_softmax, log_softmax, pick,
fully_connected, activation, dropout), the ``gluon.nn`` layers, the
softmax cross-entropy loss with each of its options, and the
initializers' rules and scales.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import np as mnp
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tgnn
from mxnet_tpu_torch.ops import nn as tnn

torch.set_num_threads(2)

# fp32 on both sides, a few ulps apart in exp, erf, tanh and the sums
TOL = dict(rtol=1e-6, atol=1e-6)


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_jax(axis):
    x = rand(3, 5, 7) * 4 + 1
    C = x.shape[axis]
    g, b = rand(C, seed=1) + 1, rand(C, seed=2)
    ref = jnn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                         axis=axis)
    out = tnn.layer_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b),
                         axis=axis)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_masked_softmax_matches_jax_and_zeroes_empty_rows():
    x = rand(2, 3, 4, 6) * 3
    lengths = np.array([6, 0])
    mask = np.arange(6)[None, None, None, :] < lengths[:, None, None, None]
    ref = jnn.masked_softmax(jnp.asarray(x), jnp.asarray(mask))
    out = tnn.masked_softmax(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert torch.count_nonzero(out[1]) == 0


def test_log_softmax_pick_match_jax():
    x = rand(4, 9) * 5
    idx = np.array([0, 8, 3, 3])
    ref = jnn.pick(jnn.log_softmax(jnp.asarray(x)), jnp.asarray(idx))
    out = tnn.pick(tnn.log_softmax(torch.tensor(x)), torch.tensor(idx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected_matches_jax(flatten):
    x = rand(2, 3, 4)
    w = rand(5, 12 if flatten else 4, seed=1)
    b = rand(5, seed=2)
    ref = jnn.fully_connected(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              flatten=flatten)
    out = tnn.fully_connected(torch.tensor(x), torch.tensor(w),
                              torch.tensor(b), flatten=flatten)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_activation_matches_jax(act):
    x = rand(64) * 4
    ref = jnn.activation(jnp.asarray(x), act)
    out = tnn.activation(torch.tensor(x), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_activation_not_ported_raises():
    with pytest.raises(ValueError, match="not ported"):
        tnn.activation(torch.zeros(2), "relu")


def test_dropout_scales_kept_and_follows_generator():
    x = torch.ones(200, 100)
    outs = [tnn.dropout(x, 0.25, True, torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    kept = outs[0][outs[0] != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.75))
    assert abs(float((outs[0] == 0).float().mean()) - 0.25) < 0.01
    assert tnn.dropout(x, 0.25, training=False) is x
    shared = tnn.dropout(x, 0.5, True, torch.Generator().manual_seed(1),
                         axes=(1,))
    assert torch.all(shared == shared[:, :1])


def test_dense_layers_match_jax(monkeypatch):
    """Dense (flatten and not, tanh and gelu, fused and unfused),
    Embedding and LayerNorm with the JAX layers' weights."""
    x = rand(2, 3, 8)
    for act, flatten, fuse in [(None, True, "1"), ("tanh", False, "1"),
                               ("gelu", False, "1"), ("gelu", False, "0")]:
        monkeypatch.setenv("MXNET_FUSE_EPILOGUE", fuse)
        jd = jgluon.nn.Dense(5, activation=act, flatten=flatten,
                             in_units=24 if flatten else 8)
        jd.initialize(mx.init.Normal(0.5))
        jd.bias.set_data(rand(5, seed=3))
        td = tgnn.Dense(5, activation=act, flatten=flatten,
                        in_units=24 if flatten else 8, device="cpu")
        with torch.no_grad():
            td.weight.copy_(torch.tensor(jd.weight.data().asnumpy()))
            td.bias.copy_(torch.tensor(jd.bias.data().asnumpy()))
        np.testing.assert_allclose(
            td(torch.tensor(x)).detach().numpy(),
            jd(mnp.array(x)).asnumpy(), rtol=1e-5, atol=1e-5,
            err_msg=str((act, flatten, fuse)))
    je = jgluon.nn.Embedding(10, 4)
    je.initialize()
    te = tgnn.Embedding(10, 4, device="cpu")
    with torch.no_grad():
        te.weight.copy_(torch.tensor(je.weight.data().asnumpy()))
    ids = np.array([[1, 9], [0, 1]])
    np.testing.assert_array_equal(te(torch.tensor(ids)).detach().numpy(),
                                  je(mnp.array(ids)).asnumpy())
    tl = tgnn.LayerNorm(in_channels=8, device="cpu")
    assert torch.all(tl.gamma == 1) and torch.all(tl.beta == 0)
    ref = jnn.layer_norm(jnp.asarray(x), jnp.ones(8), jnp.zeros(8))
    np.testing.assert_allclose(tl(torch.tensor(x)).detach().numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tgnn.Dense(5, device="cpu")


def test_dropout_layer_train_and_eval():
    layer = tgnn.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    x = torch.ones(64, 64)
    assert torch.count_nonzero(layer(x) == 0) > 0
    assert layer.eval()(x) is x


@pytest.mark.parametrize("case", ["sparse", "dense", "from_logits",
                                  "axis1", "weighted"])
def test_softmax_cross_entropy_matches_jax(case):
    pred = rand(4, 6, 5) * 2
    kw, sw = {}, None
    if case == "sparse":
        label = np.random.default_rng(1).integers(0, 5, (4, 6))
    elif case == "dense":
        kw = dict(sparse_label=False)
        label = np.abs(rand(4, 6, 5, seed=1))
        label /= label.sum(-1, keepdims=True)
    elif case == "from_logits":
        kw = dict(from_logits=True)
        pred = np.asarray(jnn.log_softmax(jnp.asarray(pred)))
        label = np.random.default_rng(1).integers(0, 5, (4, 6))
    elif case == "axis1":
        kw = dict(axis=1)
        label = np.random.default_rng(1).integers(0, 6, (4, 5))
    else:
        kw = dict(weight=0.5)
        label = np.random.default_rng(1).integers(0, 5, (4, 6))
        sw = np.abs(rand(4, 6, 1, seed=2))
    jl = jgluon.loss.SoftmaxCrossEntropyLoss(**kw)
    tl = tloss.SoftmaxCrossEntropyLoss(**kw)
    ref = jl(mnp.array(pred), mnp.array(label),
             None if sw is None else mnp.array(sw))
    out = tl(torch.tensor(pred), torch.tensor(label),
             None if sw is None else torch.tensor(sw))
    assert tuple(out.shape) == (4,)
    np.testing.assert_allclose(out.numpy(), ref.asnumpy(), **TOL)


def test_initializer_rules_and_scales():
    g = torch.Generator().manual_seed(0)
    w = torch.empty(300, 500)
    tinit.create("xavier")("dense.weight", w, g)
    bound = (6 / 800) ** 0.5
    assert 0.99 * bound < float(w.abs().max()) <= bound
    tinit.Xavier(rnd_type="gaussian", factor_type="in",
                 magnitude=2)("w", w, g)
    assert abs(float(w.std()) - (2 / 500) ** 0.5) < 1e-3
    tinit.Normal(0.02)("w", w, g)
    assert abs(float(w.std()) - 0.02) < 1e-3
    tinit.Uniform(0.1)("w", w, g)
    assert 0.099 < float(w.abs().max()) <= 0.1
    for name, want in (("x.bias", 0.0), ("ln.beta", 0.0), ("ln.gamma", 1.0),
                       ("bn.running_var", 1.0)):
        t = torch.full((4,), 7.0)
        tinit.Uniform()(name, t, g)
        assert torch.all(t == want), name
    t = torch.empty(3, 3)
    tinit.One()("w", t)
    assert torch.all(t == 1)
    tinit.Zero()("w", t)
    assert torch.all(t == 0)
    with pytest.raises(ValueError):
        tinit.Xavier()("v", torch.empty(4))
