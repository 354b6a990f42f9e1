"""Port parity: ``mxnet_tpu_torch.ops.rnn`` and ``gluon.rnn`` against
``mxnet_tpu``'s on the CPU.

- ``param_size``/``unpack_params`` and ``rnn_forward`` (LSTM with 1 and 2
  layers and bidirectional, GRU, RNN tanh/relu) against JAX
  ``ops.rnn.rnn_forward``;
- the gluon ``LSTM``/``GRU``/``RNN`` layers, their weights carried across
  with ``load_jax_params``, in TNC and NTC, with and without states,
  outputs and gradients against the JAX layers;
- ``LSTMCell.unroll`` and ``SequentialRNNCell`` against the fused layer;
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


def _grad_tol(ref):
    """Gradients sum over T and B: 1e-5 of the largest element."""
    return dict(rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


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


LAYERS = [("LSTM", dict(num_layers=2, layout="TNC")),
          ("LSTM", dict(num_layers=1, layout="NTC", bidirectional=True)),
          ("GRU", dict(num_layers=2, layout="NTC")),
          ("RNN", dict(num_layers=1, layout="TNC", activation="tanh"))]


def _jax_layer(cls, H, I, kw, seed):
    mx.random.seed(seed)
    layer = getattr(jrnn, cls)(H, input_size=I, **kw)
    layer.initialize(mx.init.Xavier())
    rng = np.random.default_rng(seed)
    for name, p in layer.collect_params().items():
        if "bias" in name:          # the initializer leaves them at 0
            p.set_data((0.1 * rng.standard_normal(p.shape)).astype(
                np.float32))
    return layer, {k: p.data().asnumpy()
                   for k, p in layer.collect_params().items()}


@pytest.mark.parametrize("cls,kw", LAYERS,
                         ids=["%s-%d" % (c, i) for i, (c, _) in
                              enumerate(LAYERS)])
@pytest.mark.parametrize("with_states", [False, True])
def test_layers_match_jax(cls, kw, with_states):
    T, B, I, H = 4, 3, 5, 6
    jl, params = _jax_layer(cls, H, I, kw, seed=len(cls) + T)
    tl = getattr(trnn, cls)(H, input_size=I, device="cpu", **kw)
    tl.load_jax_params(params)
    rng = np.random.default_rng(9)
    shape = (B, T, I) if kw["layout"] == "NTC" else (T, B, I)
    x = rng.standard_normal(shape).astype(np.float32)
    nstates = 2 if cls == "LSTM" else 1
    d = 2 if kw.get("bidirectional") else 1
    states = [(0.5 * rng.standard_normal((kw["num_layers"] * d, B, H)))
              .astype(np.float32) for _ in range(nstates)]
    out_shape = shape[:2] + (H * d,)
    r_out = rng.standard_normal(out_shape).astype(np.float32)
    r_st = [rng.standard_normal(s.shape).astype(np.float32) for s in states]

    jx = mnp.array(x)
    js = [mnp.array(s) for s in states]
    for a in [jx] + js:
        a.attach_grad()
    with autograd.record():
        res = jl(jx, js) if with_states else jl(jx)
        jout = res[0] if with_states else res
        jloss = (jout * mnp.array(r_out)).sum()
        if with_states:
            for s, r in zip(res[1], r_st):
                jloss = jloss + (s * mnp.array(r)).sum()
    jloss.backward()

    tx = torch.tensor(x, requires_grad=True)
    ts = [torch.tensor(s, requires_grad=True) for s in states]
    res = tl(tx, ts) if with_states else tl(tx)
    tout = res[0] if with_states else res
    tloss_ = (tout * torch.tensor(r_out)).sum()
    if with_states:
        assert len(res[1]) == nstates
        for s, r in zip(res[1], r_st):
            tloss_ = tloss_ + (s * torch.tensor(r)).sum()
    else:
        assert isinstance(res, torch.Tensor)
    tloss_.backward()

    np.testing.assert_allclose(tout.detach().numpy(), jout.asnumpy(), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(),
                               **_grad_tol(jx.grad.asnumpy()))
    if with_states:
        for t, j in zip(ts, js):
            np.testing.assert_allclose(t.grad.numpy(), j.grad.asnumpy(),
                                       **_grad_tol(j.grad.asnumpy()))
    jp = jl.collect_params()
    for name, p in tl.named_parameters():
        ref = jp[name].grad().asnumpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, err_msg=name,
                                   **_grad_tol(ref))


def test_load_jax_params_checks_names_and_shapes():
    tl = trnn.LSTM(4, input_size=3, device="cpu")
    params = {n: p.detach().numpy() for n, p in tl.named_parameters()}
    with pytest.raises(ValueError, match="names differ"):
        tl.load_jax_params(dict(params, extra=np.zeros(1)))
    params["h2h_weight_l0"] = np.zeros((16, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        tl.load_jax_params(params)


def test_cell_unroll_matches_fused_layer():
    T, B, I, H = 5, 2, 4, 6
    _, params = _jax_layer("LSTM", H, I, dict(num_layers=2), seed=3)
    layer = trnn.LSTM(H, num_layers=2, input_size=I, device="cpu")
    layer.load_jax_params(params)
    stack = trnn.SequentialRNNCell()
    for li, in_sz in enumerate((I, H)):
        cell = trnn.LSTMCell(H, input_size=in_sz, device="cpu")
        with torch.no_grad():
            for k in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
                getattr(cell, k).copy_(torch.tensor(params["%s_l%d"
                                                           % (k, li)]))
        stack.add(cell)
    x = torch.tensor(np.random.default_rng(4).standard_normal(
        (B, T, I)).astype(np.float32))
    out, states = stack.unroll(T, x, layout="NTC")
    ref, (hT, cT) = layer(x.transpose(0, 1), layer.begin_state(B))
    np.testing.assert_allclose(out.detach().numpy(),
                               ref.transpose(0, 1).detach().numpy(), **TOL)
    # the cells' states: h and c of layer 0, then of layer 1
    np.testing.assert_allclose(torch.stack(states[0::2]).detach().numpy(),
                               hT.detach().numpy(), **TOL)
    np.testing.assert_allclose(torch.stack(states[1::2]).detach().numpy(),
                               cT.detach().numpy(), **TOL)


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
