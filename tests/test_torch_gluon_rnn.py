"""Port parity: every recurrent cell and modifier cell of ``gluon.rnn``
as Gluon blocks against ``mxnet_tpu`` on the CPU (the conv cells in
``test_torch_gluon_rnn_conv.py``, the fused layers in
``test_torch_gluon_rnn_layers.py``).  Each is unrolled over a short
sequence of ``ndarray``s in both packages from the same weights (carried
by ``save_parameters``) with dropout off; the outputs, final states, the
input's gradient and every parameter's gradient agree.
"""
from __future__ import annotations

import pytest

from gluon_parity import check_cell_unroll, rand

# fp32 on both sides: the gate matmuls and the recurrence's
# sigmoid/tanh chain a few ulps apart per step, over 4 steps
TOL = dict(rtol=2e-5, atol=2e-5)
T, B, I, H = 4, 2, 3, 5


def _seq(g, make):
    cell = g.rnn.SequentialRNNCell()
    cell.add(make(g, I))
    cell.add(make(g, H))
    return cell


def _drop_stack(g):
    cell = g.rnn.SequentialRNNCell()
    cell.add(g.rnn.DropoutCell(0.0))
    cell.add(g.rnn.LSTMCell(H, input_size=I))
    return cell


CELLS = {
    "RNNCell": lambda g: g.rnn.RNNCell(H, input_size=I),
    "RNNCell_relu": lambda g: g.rnn.RNNCell(H, activation="relu"),
    "LSTMCell": lambda g: g.rnn.LSTMCell(H, input_size=I),
    "GRUCell": lambda g: g.rnn.GRUCell(H),
    "LSTMPCell": lambda g: g.rnn.LSTMPCell(H, 2, input_size=I),
    "SequentialRNNCell": lambda g: _seq(
        g, lambda g, n: g.rnn.LSTMCell(H, input_size=n)),
    "HybridSequentialRNNCell": lambda g: _seq(
        g, lambda g, n: g.rnn.GRUCell(H, input_size=n)),
    "DropoutCell": _drop_stack,
    "ZoneoutCell": lambda g: g.rnn.ZoneoutCell(g.rnn.GRUCell(H,
                                                             input_size=I)),
    "ResidualCell": lambda g: g.rnn.ResidualCell(g.rnn.RNNCell(
        I, input_size=I)),
    "VariationalDropoutCell": lambda g: g.rnn.VariationalDropoutCell(
        g.rnn.LSTMCell(H, input_size=I)),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(name, tmp_path):
    check_cell_unroll(name, CELLS[name], rand(T, B, I, scale=0.7), tmp_path,
                      TOL)
