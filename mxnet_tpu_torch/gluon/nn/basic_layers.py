"""Basic layers (the port of ``Dense``, ``Embedding``, ``LayerNorm`` and
``Dropout`` of ``mxnet_tpu/gluon/nn/basic_layers.py``) as ``nn.Module``s.

Parameter names follow gluon's: ``weight``/``bias``, ``gamma``/``beta``,
so a model built from these has ``named_parameters()`` equal to the JAX
model's ``collect_params()`` keys.  Shapes are given at construction
(``in_units``, ``in_channels``): deferred shape inference is not ported.
Parameters are made on ``device`` (``cuda`` unless ``"cpu"`` is asked
for); :mod:`mxnet_tpu_torch.initializer` fills them.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import context
from ...ops import nn as _ops
from ...ops.kernels.epilogue import fuse_epilogue_enabled

__all__ = ["Dense", "Embedding", "LayerNorm", "Dropout"]


def _param(shape, device, fill=None):
    t = torch.empty(shape, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class Dense(nn.Module):
    """Fully-connected layer: ``activation(x @ weight.T + bias)``, weight
    (units, in_units), fp32.  With activation ``gelu`` and
    ``MXNET_FUSE_EPILOGUE`` on, the GEMM runs bias-free and the fused
    ``bias_gelu`` kernel adds the bias and applies the GELU."""

    def __init__(self, units, activation=None, flatten=True, in_units=0,
                 device=None):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense: in_units must be given (deferred shape "
                             "inference is not ported)")
        dev = context.resolve(device)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = _param((units, in_units), dev)
        self.bias = _param((units,), dev, 0.0)

    def forward(self, x):
        if self._activation == "gelu" and fuse_epilogue_enabled():
            out = _ops.fully_connected(x, self.weight, no_bias=True,
                                       flatten=self._flatten)
            return _ops.bias_gelu(out, self.bias)
        out = _ops.fully_connected(x, self.weight, self.bias,
                                   flatten=self._flatten)
        if self._activation is not None:
            out = _ops.activation(out, self._activation)
        return out

    def extra_repr(self):
        return "%d -> %d, %s" % (self.weight.shape[1], self._units,
                                 self._activation)


class Embedding(nn.Module):
    """Embedding lookup, weight (input_dim, output_dim), fp32."""

    def __init__(self, input_dim, output_dim, device=None):
        super().__init__()
        dev = context.resolve(device)
        self._input_dim, self._output_dim = input_dim, output_dim
        self.weight = _param((input_dim, output_dim), dev)

    def forward(self, x):
        return _ops.embedding(x, self.weight)

    def extra_repr(self):
        return "%d -> %d" % (self._input_dim, self._output_dim)


class LayerNorm(nn.Module):
    """LayerNorm over ``axis`` with fp32 statistics; ``gamma`` starts at 1
    and ``beta`` at 0."""

    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0, device=None):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("LayerNorm: in_channels must be given")
        dev = context.resolve(device)
        self._axis, self._epsilon = axis, epsilon
        self.gamma = _param((in_channels,), dev, 1.0)
        self.beta = _param((in_channels,), dev, 0.0)

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                               eps=self._epsilon)


class Dropout(nn.Module):
    """Inverted dropout in train mode; the mask is drawn from
    ``generator`` (on the input's device; the default one when None)."""

    def __init__(self, rate, axes=(), generator=None):
        super().__init__()
        self._rate, self._axes = rate, axes
        self.generator = generator

    def forward(self, x):
        return _ops.dropout(x, p=self._rate, training=self.training,
                            generator=self.generator, axes=self._axes)

    def extra_repr(self):
        return "p=%g, axes=%s" % (self._rate, self._axes)
