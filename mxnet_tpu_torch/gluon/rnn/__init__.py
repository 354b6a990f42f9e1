"""Recurrent layers and cells of the port (parity:
``mxnet_tpu/gluon/rnn/``)."""
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (  # noqa: F401
    RecurrentCell, RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
    DropoutCell, ZoneoutCell, ResidualCell, BidirectionalCell,
    HybridSequentialRNNCell, LSTMPCell, VariationalDropoutCell,
    HybridRecurrentCell, ModifierCell)
from .conv_rnn_cell import (  # noqa: F401
    ConvRNNCell, ConvLSTMCell, ConvGRUCell,
    Conv1DRNNCell, Conv2DRNNCell, Conv3DRNNCell,
    Conv1DLSTMCell, Conv2DLSTMCell, Conv3DLSTMCell,
    Conv1DGRUCell, Conv2DGRUCell, Conv3DGRUCell)
from . import rnn_layer, rnn_cell, conv_rnn_cell

__all__ = rnn_layer.__all__ + rnn_cell.__all__ + conv_rnn_cell.__all__
