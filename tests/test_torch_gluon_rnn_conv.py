"""Port parity: the convolutional recurrent cells of ``gluon.rnn`` (1-D,
2-D, 3-D; RNN, LSTM, GRU) and the bidirectional cell against
``mxnet_tpu`` on the CPU, unrolled as ``test_torch_gluon_rnn.py``
unrolls the others.
"""
from __future__ import annotations

import pytest

from gluon_parity import check_cell_unroll, rand

# fp32 on both sides: the gate convolutions and the recurrence's
# sigmoid/tanh chain a few ulps apart per step, over 4 steps
TOL = dict(rtol=2e-5, atol=2e-5)
T, B, I, H = 4, 2, 3, 5

CELLS = {
    # name: (factory, the spatial shape of an input step)
    "Conv1DRNNCell": (lambda g: g.rnn.Conv1DRNNCell((I, 6), 2), (6,)),
    "Conv2DLSTMCell": (lambda g: g.rnn.Conv2DLSTMCell((I, 4, 4), 2), (4, 4)),
    "Conv3DGRUCell": (lambda g: g.rnn.Conv3DGRUCell((I, 3, 3, 3), 2),
                      (3, 3, 3)),
    "ConvRNNCell": (lambda g: g.rnn.ConvRNNCell((I, 5, 5), 2,
                                                activation="relu"), (5, 5)),
    "BidirectionalCell": (lambda g: g.rnn.BidirectionalCell(
        g.rnn.LSTMCell(H, input_size=I), g.rnn.GRUCell(H, input_size=I)),
        ()),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_jax(name, tmp_path):
    make, spatial = CELLS[name]
    check_cell_unroll(name, make, rand(T, B, I, *spatial, scale=0.7),
                      tmp_path, TOL)
