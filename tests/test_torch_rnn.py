"""Port parity: ``mxnet_tpu_torch.ops.rnn`` and ``gluon.rnn`` against
``mxnet_tpu``'s on the CPU (the gluon layers' own parity is in
``test_torch_rnn_layers.py``).

- ``param_size``/``unpack_params`` and ``rnn_forward`` (LSTM with 1 and 2
  layers and bidirectional, GRU, RNN tanh/relu) against JAX
  ``ops.rnn.rnn_forward``;
- ``GRUCell`` and ``RNNCell`` unrolled against the op;
- a tiny word LM (vocab 50, 16 units, 2 x 16 LSTM) trained three SGD
  ``Trainer`` steps with truncated BPTT in both packages;
- inter-layer dropout (keep rate, 1/keep scale, none outside training);
- with no GPU, a layer given no device raises.

Inputs are made with numpy from a seed and handed to both packages.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon as jgluon
from mxnet_tpu import np as mnp
from mxnet_tpu.gluon import nn as jnn, rnn as jrnn
from mxnet_tpu.ops import rnn as jops
from mxnet_tpu_torch.gluon import Trainer, loss as tloss, nn as tnn
from mxnet_tpu_torch.gluon import rnn as trnn
from mxnet_tpu_torch.ops import rnn as tops

torch.set_num_threads(2)

# fp32 on both sides; the time loops sum their products in other orders:
# a few ulps on values of order 1, growing slowly over the steps
TOL = dict(rtol=1e-5, atol=1e-5)

CONFIGS = [("lstm", 1, False), ("lstm", 2, False), ("lstm", 2, True),
           ("gru", 2, True), ("rnn_tanh", 2, False), ("rnn_relu", 1, True)]


@pytest.mark.parametrize("mode,L,bidir", CONFIGS)
def test_rnn_forward_matches_jax(mode, L, bidir):
    T, B, I, H = 5, 3, 4, 6
    d = 2 if bidir else 1
    rng = np.random.default_rng(L * 10 + len(mode))
    n = tops.param_size(mode, I, H, L, bidir)
    assert n == jops.param_size(mode, I, H, L, bidir)
    params = (0.3 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal((T, B, I)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((L * d, B, H))).astype(np.float32)
    c0 = (0.5 * rng.standard_normal((L * d, B, H))).astype(np.float32)
    lstm = mode == "lstm"
    jt = jops.rnn_forward(jnp.asarray(x), jnp.asarray(params),
                          jnp.asarray(h0), jnp.asarray(c0) if lstm else None,
                          mode, H, L, bidir, fused=None)
    tt = tops.rnn_forward(torch.tensor(x), torch.tensor(params),
                          torch.tensor(h0),
                          torch.tensor(c0) if lstm else None, mode, H, L,
                          bidir)
    assert tuple(tt[0].shape) == (T, B, H * d)
    assert (tt[2] is None) == (not lstm)
    for t, j in zip(tt, jt):
        if j is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_unpack_params_matches_jax():
    rng = np.random.default_rng(0)
    n = tops.param_size("gru", 3, 4, 2, True)
    flat = rng.standard_normal(n).astype(np.float32)
    jl = jops.unpack_params(jnp.asarray(flat), "gru", 3, 4, 2, True)
    tl = tops.unpack_params(torch.tensor(flat), "gru", 3, 4, 2, True)
    for jd, td in zip(jl, tl):
        for jp, tp in zip(jd, td):
            assert set(jp) == set(tp)
            for k in jp:
                np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    with pytest.raises(ValueError):
        tops.unpack_params(torch.tensor(flat[:-1]), "gru", 3, 4, 2, True)


@pytest.mark.parametrize("cell,mode", [("GRUCell", "gru"),
                                       ("RNNCell", "rnn_tanh")])
def test_other_cells_match_the_op(cell, mode):
    T, B, I, H = 4, 2, 3, 5
    rng = np.random.default_rng(6)
    c = getattr(trnn, cell)(H, input_size=I, device="cpu")
    with torch.no_grad():
        for p in c.parameters():
            p.copy_(torch.tensor(0.4 * rng.standard_normal(p.shape)))
    x = torch.tensor(rng.standard_normal((T, B, I)).astype(np.float32))
    out, _ = c.unroll(T, x, layout="TNC")
    flat = torch.cat([c.i2h_weight.reshape(-1), c.h2h_weight.reshape(-1),
                      c.i2h_bias, c.h2h_bias])
    ref, _, _ = tops.rnn_forward(x, flat, torch.zeros(1, B, H), None, mode,
                                 H)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **TOL)


V, E, NL, SEG_B, SEG_T = 50, 16, 2, 4, 6


class _JaxWordLM(jgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.embed = jnn.Embedding(V, E)
        self.lstm = jrnn.LSTM(E, num_layers=NL, layout="NTC", input_size=E)
        self.decoder = jnn.Dense(V, flatten=False, in_units=E)

    def forward(self, x, states):
        out, states = self.lstm(self.embed(x), states)
        return self.decoder(out), states


class _TorchWordLM(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.embed = tnn.Embedding(V, E, device="cpu")
        self.lstm = trnn.LSTM(E, num_layers=NL, layout="NTC", input_size=E,
                              device="cpu")
        self.decoder = tnn.Dense(V, flatten=False, in_units=E, device="cpu")

    def forward(self, x, states):
        out, states = self.lstm(self.embed(x), states)
        return self.decoder(out), states


def test_tiny_word_lm_trainer_steps_match_jax():
    mx.random.seed(2)
    jnet = _JaxWordLM()
    jnet.initialize(mx.init.Xavier())
    rng = np.random.default_rng(2)
    toks = rng.integers(0, V, (SEG_B, 3 * SEG_T + 1))
    jnet(mnp.array(toks[:, :SEG_T]), jnet.lstm.begin_state(SEG_B))
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    tnet = _TorchWordLM()
    own = dict(tnet.named_parameters())
    assert set(own) == set(params)
    with torch.no_grad():
        for k, a in params.items():
            own[k].copy_(torch.tensor(a))
    opt = {"learning_rate": 0.1}
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", opt)
    ttr = Trainer(dict(tnet.named_parameters()), "sgd", opt)
    jce = jgluon.loss.SoftmaxCrossEntropyLoss()
    tce = tloss.SoftmaxCrossEntropyLoss()
    js = jnet.lstm.begin_state(SEG_B)
    ts = tnet.lstm.begin_state(SEG_B)
    jl, tl = [], []
    for s in range(3):
        x = toks[:, s * SEG_T:(s + 1) * SEG_T]
        y = toks[:, s * SEG_T + 1:(s + 1) * SEG_T + 1]
        js = [a.detach() for a in js]
        with autograd.record():
            logits, js = jnet(mnp.array(x), js)
            loss = jce(logits, mnp.array(y))
        loss.backward()
        jtr.step(SEG_B)
        jl.append(float(loss.sum()))
        ts = [a.detach() for a in ts]
        logits, ts = tnet(torch.tensor(x), ts)
        loss = tce(logits, torch.tensor(y))
        loss.backward(torch.ones_like(loss))
        ttr.step(SEG_B)
        tl.append(float(loss.detach().sum()))
    # fp32 losses of order 16 a few ulps apart, carried over two updates
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jp = jnet.collect_params()
    for name, p in tnet.named_parameters():
        # SGD moves each weight by lr * g / B: the gradients' fp32
        # differences (~1e-7) scaled by lr
        np.testing.assert_allclose(p.detach().numpy(),
                                   jp[name].data().asnumpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


def test_interlayer_dropout_rate_and_scale():
    """2-layer relu RNN whose second layer passes its input through
    (w_i2h = I, w_h2h = 0, biases 0): its output is the first layer's
    output times the dropout mask, each element 0 or 1/keep times it."""
    T, B, H, p = 20, 50, 32, 0.3
    rng = np.random.default_rng(1)
    l0 = [0.3 * np.abs(rng.standard_normal((H, H))),
          np.zeros((H, H)), np.ones(H), np.zeros(H)]
    l1 = [np.eye(H), np.zeros((H, H)), np.zeros(H), np.zeros(H)]
    flat = torch.tensor(np.concatenate(
        [a.reshape(-1) for a in l0[:2] + l1[:2] + l0[2:] + l1[2:]]),
        dtype=torch.float32)
    x = torch.tensor(np.abs(rng.standard_normal((T, B, H))),
                     dtype=torch.float32)
    h0 = torch.zeros(2, B, H)
    flat0 = torch.tensor(np.concatenate([a.reshape(-1) for a in l0]),
                         dtype=torch.float32)
    first, _, _ = tops.rnn_forward(x, flat0, h0[:1], None, "rnn_relu", H)
    assert bool((first > 0).all())
    gen = torch.Generator().manual_seed(0)
    out, _, _ = tops.rnn_forward(x, flat, h0, None, "rnn_relu", H, 2,
                                 dropout_rate=p, training=True,
                                 generator=gen)
    ratio = (out / first).numpy()
    kept = ratio > 0
    assert abs(kept.mean() - (1 - p)) < 0.01
    np.testing.assert_allclose(ratio[kept], 1 / (1 - p), rtol=1e-5)
    assert np.all(ratio[~kept] == 0)
    evald, _, _ = tops.rnn_forward(x, flat, h0, None, "rnn_relu", H, 2,
                                   dropout_rate=p, training=False,
                                   generator=gen)
    np.testing.assert_allclose(evald.numpy(), first.numpy(), **TOL)
    # the layer applies it in train mode only
    layer = trnn.RNN(H, num_layers=2, dropout=p, input_size=H,
                     device="cpu", generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for k, a in zip(("i2h_weight", "h2h_weight", "i2h_bias",
                         "h2h_bias"), l0):
            getattr(layer, k + "_l0").copy_(torch.tensor(a))
        for k, a in zip(("i2h_weight", "h2h_weight", "i2h_bias",
                         "h2h_bias"), l1):
            getattr(layer, k + "_l1").copy_(torch.tensor(a))
        train_out = layer(x)
        layer.eval()
        eval_out = layer(x)
    assert abs(float((train_out > 0).float().mean()) - (1 - p)) < 0.01
    np.testing.assert_allclose(eval_out.numpy(), first.numpy(), **TOL)


def test_layer_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trnn.LSTM(4, input_size=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trnn.LSTMCell(4, input_size=3)
