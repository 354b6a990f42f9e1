"""Convolutional recurrent cells (the port of
``mxnet_tpu/gluon/rnn/conv_rnn_cell.py``; parity: reference
``python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py``): ``ConvRNNCell``,
``ConvLSTMCell``, ``ConvGRUCell`` and their 1-D, 2-D and 3-D variants.

The gates are two convolutions, i2h over the input and h2h over the
state (an odd kernel, padded to keep the state's shape), added
channel-wise; channels-first layouts only.
"""
from __future__ import annotations

import torch

from ...ops import nn as _ops
from ..block import eager_init
from ..parameter import Parameter
from ..nn.basic_layers import _init_of, _zeros_init
from .rnn_cell import RecurrentCell

__all__ = ["ConvRNNCell", "ConvLSTMCell", "ConvGRUCell", "Conv1DRNNCell",
           "Conv2DRNNCell", "Conv3DRNNCell", "Conv1DLSTMCell",
           "Conv2DLSTMCell", "Conv3DLSTMCell", "Conv1DGRUCell",
           "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvRNNCellBase(RecurrentCell):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, conv_dims=2, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", device=None):
        super().__init__()
        self._hidden_channels = hidden_channels
        self._conv_dims = conv_dims
        self._input_shape = tuple(input_shape)          # (C, *spatial)
        self._i2h_kernel = _tuple(i2h_kernel, conv_dims)
        self._h2h_kernel = _tuple(h2h_kernel, conv_dims)
        for k in self._h2h_kernel:
            if k % 2 == 0:
                raise ValueError(
                    "h2h_kernel dims must be odd (state shape must be "
                    "preserved); got %r" % (self._h2h_kernel,))
        self._i2h_pad = _tuple(i2h_pad, conv_dims)
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        G = self._num_gates * hidden_channels
        in_c = self._input_shape[0]
        self.i2h_weight = Parameter("i2h_weight",
                                    shape=(G, in_c) + self._i2h_kernel,
                                    init=_init_of(i2h_weight_initializer))
        self.h2h_weight = Parameter(
            "h2h_weight", shape=(G, hidden_channels) + self._h2h_kernel,
            init=_init_of(h2h_weight_initializer))
        self.i2h_bias = Parameter("i2h_bias", shape=(G,),
                                  init=_zeros_init(i2h_bias_initializer))
        self.h2h_bias = Parameter("h2h_bias", shape=(G,),
                                  init=_zeros_init(h2h_bias_initializer))
        eager_init(self, device)

    def _state_shape(self):
        spatial = tuple((s + 2 * p - k) + 1 for s, p, k in zip(
            self._input_shape[1:], self._i2h_pad, self._i2h_kernel))
        return (self._hidden_channels,) + spatial

    def state_info(self, batch_size=0):
        shape = (batch_size,) + self._state_shape()
        layout = "NC" + "DHW"[3 - (len(shape) - 2):]
        return [{"shape": shape, "__layout__": layout}
                for _ in range(self._num_states)]

    def _conv_gates(self, x, h):
        gx = _ops.convolution(x, self.i2h_weight.leaf, self.i2h_bias.leaf,
                              kernel=self._i2h_kernel, pad=self._i2h_pad)
        gh = _ops.convolution(h, self.h2h_weight.leaf, self.h2h_bias.leaf,
                              kernel=self._h2h_kernel, pad=self._h2h_pad)
        return gx, gh


class ConvRNNCell(_ConvRNNCellBase):
    """Conv-RNN cell (``activation`` tanh by default)."""

    _num_gates = 1
    _num_states = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), activation="tanh",
                 conv_dims=2, **kwargs):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, conv_dims, **kwargs)
        self._activation = activation

    def _forward(self, training, x, states):
        h = states[0] if isinstance(states, (list, tuple)) else states
        gx, gh = self._conv_gates(x, h)
        out = _ops.activation(gx + gh, self._activation)
        return out, [out]


class ConvLSTMCell(_ConvRNNCellBase):
    """Conv-LSTM (Shi et al. 2015); gates i, f, g, o as ``LSTMCell``."""

    _num_gates = 4
    _num_states = 2

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), conv_dims=2, **kwargs):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, conv_dims, **kwargs)

    def _forward(self, training, x, states):
        h, c = states
        gx, gh = self._conv_gates(x, h)
        i, f, u, o = (gx + gh).chunk(4, dim=1)
        next_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
        next_h = torch.sigmoid(o) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class ConvGRUCell(_ConvRNNCellBase):
    """Conv-GRU; gates r, z, n as ``GRUCell``."""

    _num_gates = 3
    _num_states = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_pad=(1, 1), conv_dims=2, **kwargs):
        super().__init__(input_shape, hidden_channels, i2h_kernel,
                         h2h_kernel, i2h_pad, conv_dims, **kwargs)

    def _forward(self, training, x, states):
        h = states[0] if isinstance(states, (list, tuple)) else states
        gx, gh = self._conv_gates(x, h)
        xr, xz, xn = gx.chunk(3, dim=1)
        hr, hz, hn = gh.chunk(3, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        next_h = (1 - z) * n + z * h
        return next_h, [next_h]


def _dim_variant(name, base, dims, default_kernel):
    """The 1-D, 2-D or 3-D cell (the reference's Conv1D/2D/3D cells):
    ``i2h_pad`` defaults to half the kernel."""

    def __init__(self, input_shape, hidden_channels,
                 i2h_kernel=default_kernel, h2h_kernel=default_kernel,
                 i2h_pad=None, **kwargs):
        if i2h_pad is None:
            i2h_pad = tuple(k // 2 for k in _tuple(i2h_kernel, dims))
        base.__init__(self, input_shape, hidden_channels,
                      i2h_kernel=i2h_kernel, h2h_kernel=h2h_kernel,
                      i2h_pad=i2h_pad, conv_dims=dims, **kwargs)

    return type(name, (base,), {"__init__": __init__,
                                "__module__": __name__})


Conv1DRNNCell = _dim_variant("Conv1DRNNCell", ConvRNNCell, 1, (3,))
Conv2DRNNCell = _dim_variant("Conv2DRNNCell", ConvRNNCell, 2, (3, 3))
Conv3DRNNCell = _dim_variant("Conv3DRNNCell", ConvRNNCell, 3, (3, 3, 3))
Conv1DLSTMCell = _dim_variant("Conv1DLSTMCell", ConvLSTMCell, 1, (3,))
Conv2DLSTMCell = _dim_variant("Conv2DLSTMCell", ConvLSTMCell, 2, (3, 3))
Conv3DLSTMCell = _dim_variant("Conv3DLSTMCell", ConvLSTMCell, 3, (3, 3, 3))
Conv1DGRUCell = _dim_variant("Conv1DGRUCell", ConvGRUCell, 1, (3,))
Conv2DGRUCell = _dim_variant("Conv2DGRUCell", ConvGRUCell, 2, (3, 3))
Conv3DGRUCell = _dim_variant("Conv3DGRUCell", ConvGRUCell, 3, (3, 3, 3))
