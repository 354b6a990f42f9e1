"""Port parity: the gluon RNN layers of ``mxnet_tpu_torch.gluon.rnn``
against ``mxnet_tpu``'s on the CPU (split from ``test_torch_rnn.py``,
which keeps the op, the other cells, dropout and the word LM).

- the gluon ``LSTM``/``GRU``/``RNN`` layers, their weights carried across
  with ``load_jax_params``, in TNC and NTC, with and without states,
  outputs and gradients against the JAX layers;
- ``load_jax_params`` refuses wrong names and shapes;
- ``LSTMCell.unroll`` and ``SequentialRNNCell`` against the fused layer.

Inputs are made with numpy from a seed and handed to both packages.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd
from mxnet_tpu import np as mnp
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu_torch.gluon import rnn as trnn

torch.set_num_threads(2)

# fp32 on both sides; the time loops sum their products in other orders:
# a few ulps on values of order 1, growing slowly over the steps
TOL = dict(rtol=1e-5, atol=1e-5)


def _grad_tol(ref):
    """Gradients sum over T and B: 1e-5 of the largest element."""
    return dict(rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


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
