"""Activation layers (the port of ``mxnet_tpu/gluon/nn/activations.py``;
parity: reference ``python/mxnet/gluon/nn/activations.py`` Activation
:29, LeakyReLU :62, PReLU :103, ELU :145, SELU :174, GELU :195,
Swish/SiLU :216/:245), as Gluon blocks over ``ops/nn.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops import nn as _ops
from ..block import _Layer, eager_init
from ..parameter import Parameter

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "SiLU"]


class Activation(_Layer):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def _forward(self, training, x):
        return _ops.activation(x, self._act_type)

    def extra_repr(self):
        return self._act_type


class LeakyReLU(_Layer):
    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def _forward(self, training, x):
        return _ops.leaky_relu(x, self._alpha)

    def extra_repr(self):
        return "%g" % self._alpha


class PReLU(_Layer):
    """Leaky ReLU with a learned slope per channel (axis 1), 0.25 at
    first."""

    def __init__(self, alpha_initializer=None, in_channels=1, device=None):
        super().__init__()
        from ... import initializer as initmod
        self.alpha = Parameter("alpha", shape=(in_channels,),
                               init=alpha_initializer
                               or initmod.Constant(0.25))
        eager_init(self, device)

    def _forward(self, training, x):
        return _ops.prelu(x, self.alpha.leaf)


class ELU(_Layer):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def _forward(self, training, x):
        return _ops.elu(x, self._alpha)


class SELU(_Layer):
    def _forward(self, training, x):
        return _ops.selu(x)


class GELU(_Layer):
    def __init__(self, approximation="erf"):
        super().__init__()
        self._approx = approximation

    def _forward(self, training, x):
        return F.gelu(x, approximate="tanh" if self._approx == "tanh"
                      else "none")


class Swish(_Layer):
    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def _forward(self, training, x):
        if self._beta == 1.0:
            return F.silu(x)
        return x * torch.sigmoid(self._beta * x)


class SiLU(_Layer):
    def _forward(self, training, x):
        return F.silu(x)
