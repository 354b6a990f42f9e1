"""Weight initializers (the port of a subset of ``mxnet_tpu/initializer.py``):
``Zero``, ``One``, ``Uniform``, ``Normal`` and ``Xavier``,
with ``register``/``create``.

An initializer is called on a parameter's name and tensor and fills the
tensor in place.  Names ending in ``bias``, ``beta``, ``running_mean`` or
``moving_mean`` start at 0 and those ending in ``gamma``, ``running_var``
or ``moving_var`` at 1, whatever the initializer, as in the JAX package;
every other tensor takes the initializer's draw.  The layer suffix of the
RNN layers' names (``i2h_bias_l0``, ``h2h_bias_l1_r``) is not part of
the ending.  Draws come from an
explicit CPU ``torch.Generator`` and are copied to the tensor's device, so
one seed gives the same weights on the CPU and on the card.  The JAX
package draws from its global key: the two packages' draws differ.
"""
from __future__ import annotations

import math
import re

import torch

__all__ = ["Initializer", "Zero", "One", "Uniform", "Normal", "Xavier",
           "register", "create"]

_REGISTRY = {}
#: the layer and direction suffix of ``gluon.rnn`` parameter names
_RNN_SUFFIX = re.compile(r"_l\d+(_r)?$")


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _REGISTRY[name.lower()](**kwargs)


class Initializer:
    """Base initializer: ``init(name, tensor, generator=None)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @torch.no_grad()
    def __call__(self, name, arr, generator=None):
        self.init_weight(name, arr, generator)

    def init_weight(self, name, arr, generator=None):
        base = _RNN_SUFFIX.sub("", name)
        if base.endswith(("bias", "beta", "running_mean", "moving_mean")):
            arr.zero_()
        elif base.endswith(("gamma", "running_var", "moving_var")):
            arr.fill_(1.0)
        else:
            arr.copy_(self._draw(name, tuple(arr.shape), generator))

    def _draw(self, name, shape, generator):
        """A float32 CPU tensor of ``shape`` for parameter ``name``."""
        raise NotImplementedError

    def __repr__(self):
        return "%s(%r)" % (type(self).__name__, self._kwargs)


@register
class Zero(Initializer):
    def _draw(self, name, shape, generator):
        return torch.zeros(shape)


@register
class One(Initializer):
    def _draw(self, name, shape, generator):
        return torch.ones(shape)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _draw(self, name, shape, generator):
        return (torch.rand(shape, generator=generator) * 2 - 1) * self.scale


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _draw(self, name, shape, generator):
        return torch.randn(shape, generator=generator) * self.sigma


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale sqrt(magnitude / factor), where factor is the
    average of fan in and fan out (``avg``), or one of them (``in``,
    ``out``); uniform in (-scale, scale) or gaussian with that deviation.
    The defaults (uniform, avg, 3) give bound sqrt(6 / (fan_in +
    fan_out))."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError("bad rnd_type %r" % (rnd_type,))
        if factor_type not in ("avg", "in", "out"):
            raise ValueError("bad factor_type %r" % (factor_type,))
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _draw(self, name, shape, generator):
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim>=2 (param %s: %s)"
                             % (name, shape))
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            return (torch.rand(shape, generator=generator) * 2 - 1) * scale
        return torch.randn(shape, generator=generator) * scale
