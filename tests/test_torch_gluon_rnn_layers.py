"""Port parity: the fused recurrent layers of ``gluon.rnn`` as Gluon
blocks against ``mxnet_tpu`` on the CPU (deferred input size, ndarray
calls with and without states, forward and gradients); the stochastic
cells (dropout, zoneout, variational dropout) held to their statistics
in training; and the cells called with torch tensors.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gluon_parity import (assert_close, carry, forward_backward, jax_mx,
                          port_mx, rand)

# fp32 on both sides: the gate matmuls and the recurrence's
# sigmoid/tanh chain a few ulps apart per step, over 4 steps
TOL = dict(rtol=2e-5, atol=2e-5)
T, B, I, H = 4, 2, 3, 5


@pytest.mark.parametrize("mode,kw", [
    ("LSTM", dict(num_layers=2, layout="NTC")),
    ("LSTM", dict(bidirectional=True)),
    ("GRU", dict(num_layers=2)),
    ("RNN", dict(activation="tanh", layout="NTC")),
])
def test_rnn_layer_gluon_matches_jax(mode, kw, tmp_path):
    """The fused layers as Gluon blocks: deferred input size, ndarray
    calls with and without states."""
    jmx, tmx = jax_mx(), port_mx()
    x = rand(B, T, I) if kw.get("layout") == "NTC" else rand(T, B, I)
    jl = getattr(jmx.gluon.rnn, mode)(H, **kw)
    jl.initialize(jmx.init.Normal(0.4))
    jl(jmx.np.array(x))
    with tmx.Context("cpu"):
        tl = getattr(tmx.gluon.rnn, mode)(H, **kw)
    carry(jl, tl, tmp_path / "w.npz")
    want = forward_backward(jmx, jl, [x])
    with tmx.Context("cpu"):
        got = forward_backward(tmx, tl, [x])
    assert_close(got, want, name=mode, **TOL)
    h0 = [rand(*s["shape"], seed=4 + k)
          for k, s in enumerate(tl.state_info(B))]
    want = forward_backward(jmx, jl, [x], kwargs=dict(
        states=[jmx.np.array(h) for h in h0]))
    with tmx.Context("cpu"):
        got = forward_backward(tmx, tl, [x], kwargs=dict(
            states=[tmx.np.array(h) for h in h0]))
    assert_close(got, want, name=mode + " states", **TOL)


def test_stochastic_cells_in_training():
    tmx = port_mx()
    tmx.random.seed(1)
    with tmx.Context("cpu"):
        x = tmx.np.ones((T, 64, 32))
        drop = tmx.gluon.rnn.DropoutCell(0.5)
        with tmx.autograd.record():
            out, _ = drop.unroll(T, x, layout="TNC")
        kept = out.asnumpy()
        assert abs((kept == 0).mean() - 0.5) < 0.02
        assert set(np.unique(kept)) == {0.0, 2.0}
        out, _ = drop.unroll(T, x, layout="TNC")       # predict mode
        assert (out.asnumpy() == 1).all()
        var = tmx.gluon.rnn.VariationalDropoutCell(
            tmx.gluon.rnn.ResidualCell(tmx.gluon.rnn.RNNCell(
                32, input_size=32)), drop_inputs=0.5)
        var.initialize(tmx.init.Zero())
        with tmx.autograd.record():
            out, _ = var.unroll(T, x, layout="TNC")
        steps = out.asnumpy()
        # one mask for the whole sequence: every step drops the same
        # inputs (the zero-weight cell's output is its residual input)
        for t in range(1, T):
            np.testing.assert_array_equal(steps[t] == 0, steps[0] == 0)
        zone = tmx.gluon.rnn.ZoneoutCell(tmx.gluon.rnn.RNNCell(
            32, input_size=32), zoneout_outputs=0.5)
        zone.initialize(tmx.init.One())
        with tmx.autograd.record():
            out, _ = zone.unroll(2, x[:2], layout="TNC")
        first = out.asnumpy()[0]
        assert abs((first == 0).mean() - 0.5) < 0.05


def test_cells_take_torch_tensors():
    """The same cells with torch tensors: torch out, Module.training the
    flag."""
    tmx = port_mx()
    cell = tmx.gluon.rnn.LSTMCell(H, input_size=I, device="cpu")
    cell.initialize(tmx.init.Xavier(), device="cpu", force_reinit=True)
    x = torch.tensor(rand(B, T, I))
    out, states = cell.unroll(T, x)
    assert isinstance(out, torch.Tensor) and out.shape == (B, T, H)
    with tmx.Context("cpu"):
        nd_out, _ = cell.unroll(T, tmx.np.array(x.numpy()))
    np.testing.assert_array_equal(nd_out.asnumpy(), out.detach().numpy())
    assert [tuple(s.shape) for s in states] == [(B, H), (B, H)]
