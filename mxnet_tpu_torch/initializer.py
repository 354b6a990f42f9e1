"""Weight initializers (the port of ``mxnet_tpu/initializer.py``; parity:
reference ``python/mxnet/initializer.py``): ``Zero``, ``One``,
``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``Load``, ``Mixed`` and
``InitDesc``, with ``register``/``create``.

An initializer is called on a parameter's name (a string or an
:class:`InitDesc`) and a torch tensor or an ``ndarray``, and fills it in
place.  Names ending in ``bias``, ``beta``, ``running_mean`` or
``moving_mean`` start at 0 and those ending in ``gamma``, ``running_var``
or ``moving_var`` at 1, whatever the initializer, as in the JAX package;
every other tensor takes the initializer's draw (``LSTMBias`` draws for
every name).  The layer suffix of the RNN layers' names
(``i2h_bias_l0``, ``h2h_bias_l1_r``) is not part of the ending.

Draws come from a CPU ``torch.Generator``, the one passed in or one
seeded from the global seed (``mx.random.seed``), and are copied to the
tensor's device, so one seed gives the same weights on the CPU and on
the card.  The JAX package draws from its global key: the two packages'
random draws differ; the deterministic initializers agree exactly.
"""
from __future__ import annotations

import math
import re
import sys

import numpy as onp
import torch

from . import _rng

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Load", "Mixed", "InitDesc", "register", "create", "init"]

_REGISTRY = {}
#: the layer and direction suffix of ``gluon.rnn`` parameter names
_RNN_SUFFIX = re.compile(r"_l\d+(_r)?$")


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, (Initializer, Load, Mixed)):
        return name
    return _REGISTRY[name.lower()](**kwargs)


class InitDesc(str):
    """A parameter's name carrying init attributes (reference
    ``InitDesc``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _fill(arr, value):
    """Write tensor ``value`` into ``arr`` (a tensor or an ndarray) in
    place."""
    from .ndarray import ndarray
    if isinstance(arr, ndarray):
        t = arr._data
        arr._set_data(value.to(device=t.device, dtype=t.dtype)
                      .reshape(t.shape))
        return
    with torch.no_grad():
        arr.copy_(value.reshape(arr.shape))


def _shape_of(arr):
    return tuple(arr.shape)


class Initializer:
    """Base initializer: ``init(name, arr, generator=None)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr=None, generator=None):
        if arr is None:
            raise ValueError("need array")
        if generator is None:
            generator = torch.Generator().manual_seed(_rng.next_seed())
        self.init_weight(str(name), arr, generator)

    def init_weight(self, name, arr, generator=None):
        base = _RNN_SUFFIX.sub("", name)
        shape = _shape_of(arr)
        if base.endswith(("bias", "beta", "running_mean", "moving_mean")):
            _fill(arr, torch.zeros(shape))
        elif base.endswith(("gamma", "running_var", "moving_var")):
            _fill(arr, torch.ones(shape))
        else:
            _fill(arr, self._draw(name, shape, generator))

    def _draw(self, name, shape, generator):
        """A float32 CPU tensor of ``shape`` for parameter ``name``."""
        raise NotImplementedError

    def dumps(self):
        import json
        return json.dumps([type(self).__name__.lower(), self._kwargs],
                          default=lambda o: repr(o))

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


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    """A scalar, or an array broadcast to the parameter's shape."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _draw(self, name, shape, generator):
        from .ndarray import ndarray
        v = self.value
        if isinstance(v, ndarray):
            v = v._data
        if isinstance(v, torch.Tensor):
            return torch.broadcast_to(v.detach().float().cpu(), shape)
        return torch.full(shape, float(v)) if not isinstance(
            v, (list, tuple, onp.ndarray)) else torch.broadcast_to(
                torch.tensor(onp.asarray(v, onp.float32)), shape)


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
class Orthogonal(Initializer):
    """``scale`` times an orthonormal basis of a random (out, in) matrix
    (uniform in (-1, 1) or normal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _draw(self, name, shape, generator):
        nout = shape[0]
        nin = int(math.prod(shape[1:]))
        if self.rand_type == "uniform":
            tmp = torch.rand((nout, nin), generator=generator) * 2 - 1
        else:
            tmp = torch.randn((nout, nin), generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        return self.scale * q.reshape(shape)


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


@register
class MSRAPrelu(Xavier):
    """He initialisation for PReLU: gaussian, magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a (C, 1, k, k) deconvolution."""

    def _draw(self, name, shape, generator):
        n = int(onp.prod(shape))
        weight = onp.zeros(n, dtype=onp.float32)
        f = onp.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(n):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight.reshape(shape))


@register
class LSTMBias(Initializer):
    """An LSTM bias: 0, and ``forget_bias`` on the forget gate's quarter
    (gates [i, f, c, o])."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def init_weight(self, name, arr, generator=None):
        _fill(arr, self._draw(name, _shape_of(arr), generator))

    def _draw(self, name, shape, generator):
        b = torch.zeros(shape)
        h = shape[0] // 4
        b[h:2 * h] = self.forget_bias
        return b


class Load:
    """Initialise from saved arrays by name (an ``.npz`` file or a dict),
    with ``default_init`` for the names the arrays lack (reference
    ``initializer.Load``); ``arg:``/``aux:`` prefixes are dropped."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            loaded = onp.load(param)
            param = {k: loaded[k] for k in loaded.files}
        self.param = {}
        for name, arr in param.items():
            key = name.split(":", 1)[1] if name[:4] in ("arg:", "aux:") \
                else name
            self.param[key] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr, generator=None):
        key = str(name)
        if key in self.param:
            src = self.param[key]
            src = onp.asarray(src.asnumpy() if hasattr(src, "asnumpy")
                              else src)
            if tuple(src.shape) != _shape_of(arr):
                raise ValueError("Load: shape mismatch for %r: saved %s vs "
                                 "param %s" % (key, src.shape,
                                               _shape_of(arr)))
            _fill(arr, torch.from_numpy(onp.array(src, onp.float32)))
            if self.verbose:
                print("Load: initialized %s from saved arrays" % key)
        elif self.default_init is not None:
            self.default_init(name, arr, generator)
        else:
            raise ValueError("Load: no saved array for %r and no "
                             "default_init" % key)


class Mixed:
    """The first initializer whose pattern matches the name (reference
    ``initializer.Mixed``)."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr, generator=None):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr, generator)
                return
        raise ValueError("no initializer matched %r" % (name,))


#: the ``mx.init`` namespace (``initializer.init.Xavier``), as in the JAX
#: package
init = sys.modules[__name__]
