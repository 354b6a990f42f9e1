"""Recurrent layers and cells of the port (parity:
``mxnet_tpu/gluon/rnn/``)."""
from .rnn_cell import (  # noqa: F401
    GRUCell, LSTMCell, RecurrentCell, RNNCell, SequentialRNNCell)
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell"]
