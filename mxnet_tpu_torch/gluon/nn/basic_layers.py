"""Basic layers (the port of ``mxnet_tpu/gluon/nn/basic_layers.py``;
parity: reference ``python/mxnet/gluon/nn/basic_layers.py`` Sequential
:37, HybridSequential :104, Dense :181, Dropout :266, BatchNorm :413,
Embedding :541, Flatten :592, InstanceNorm :612, LayerNorm :708,
GroupNorm :792, Lambda :883, HybridLambda :926, Concatenate :973,
Identity :1051, SyncBatchNorm :1071).

Every layer is a Gluon block (``gluon/block.py``): called with
``ndarray``s it computes once through ``apply_op``, called with torch
tensors it runs its torch code directly.  Parameter names are gluon's
(``weight``/``bias``, ``gamma``/``beta``, ``running_mean``/
``running_var``).  A layer built without its input size finishes its
shapes at the first forward.  ``device=`` (the port's earlier
convention) makes the parameters at construction, so every input size
must then be given; otherwise ``initialize()`` makes them.

``Dense(activation="gelu")`` with ``MXNET_FUSE_EPILOGUE`` on runs its
GEMM bias-free and the fused ``bias_gelu`` kernel (#1 forward, #2
backward) adds the bias and applies the GELU, as the JAX layer does.
"""
from __future__ import annotations

import numpy as onp
import torch

from ... import autograd
from ... import numpy as _np
from ... import numpy_extension as _npx
from ...ndarray import ndarray, _wrap
from ...ops import nn as _ops
from ...ops.kernels.epilogue import fuse_epilogue_enabled
from ..block import Block, HybridBlock, _Layer, _flag, eager_init
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "Embedding", "Flatten", "InstanceNorm", "LayerNorm", "GroupNorm",
           "Lambda", "HybridLambda", "Concatenate", "HybridConcatenate",
           "Identity", "SyncBatchNorm", "BatchNormReLU"]


def _zeros_init(spec):
    from ... import initializer as initmod
    if spec is None or spec == "zeros":
        return initmod.Zero()
    if isinstance(spec, str):
        return initmod.create(spec)
    return spec


def _init_of(spec):
    from ... import initializer as initmod
    return initmod.create(spec) if isinstance(spec, str) else spec


class _SequentialMixin:
    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = []
            if isinstance(x, (tuple, list)):
                args = x[1:]
                x = x[0]
        if args:
            return (x,) + tuple(args)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(key, slice):
            net = type(self)()
            net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_SequentialMixin, Block):
    """Blocks run in order, each on the previous one's output
    (basic_layers.py:37)."""


class HybridSequential(_SequentialMixin, HybridBlock):
    """The hybridizable sequential container (basic_layers.py:104)."""


class Dense(_Layer):
    """Fully connected: ``activation(x @ weight.T + bias)``, weight
    (units, in_units) (basic_layers.py:181)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter("weight", shape=(units, in_units),
                                dtype=dtype, init=_init_of(weight_initializer),
                                allow_deferred_init=True)
        self.bias = (Parameter("bias", shape=(units,), dtype=dtype,
                               init=_zeros_init(bias_initializer),
                               allow_deferred_init=True)
                     if use_bias else None)
        eager_init(self, device)

    def infer_shape(self, x, *args):
        in_units = (int(onp.prod(x.shape[1:])) if self._flatten
                    else x.shape[-1])
        self.weight.shape_and_init((self._units, in_units))
        if self.bias is not None:
            self.bias.shape_and_init((self._units,))

    def _forward(self, training, x):
        w = self.weight._var
        if w is None:
            self.infer_shape(x)
            w = self.weight._var
        b = self.bias._var if self.bias is not None else None
        if (self._activation == "gelu" and b is not None
                and fuse_epilogue_enabled()):
            out = _ops.fully_connected(x, w, no_bias=True,
                                       flatten=self._flatten)
            return _ops.bias_gelu(out, b)
        out = _ops.fully_connected(x, w, b, no_bias=b is None,
                                   flatten=self._flatten)
        if self._activation is not None:
            out = _ops.activation(out, self._activation)
        return out

    def extra_repr(self):
        shape = self.weight.shape
        return "%s -> %d, %s" % (shape[1] if shape else None, self._units,
                                 self._activation)


class Dropout(_Layer):
    """Inverted dropout in training (basic_layers.py:266).  An ``ndarray``
    call goes through ``npx.dropout``, its mask from the global seed; a
    torch call draws from ``generator`` (the device's default one when
    None)."""

    def __init__(self, rate, axes=(), generator=None):
        super().__init__()
        self._rate, self._axes = rate, axes
        self.generator = generator

    def forward(self, x):
        if isinstance(x, ndarray):
            return _npx.dropout(x, p=self._rate, axes=self._axes)
        return self._forward(_flag(self), x)

    def _forward(self, training, x):
        return _ops.dropout(x, p=self._rate, training=training,
                            generator=self.generator, axes=self._axes)

    def extra_repr(self):
        return "p=%g, axes=%s" % (self._rate, self._axes)


class _Norm(_Layer):
    """gamma/beta over one channel axis, deferred to the first forward."""

    def _norm_params(self, in_channels, center, scale, beta_initializer,
                     gamma_initializer, dtype="float32"):
        shape = (in_channels,) if in_channels else (0,)
        self.gamma = Parameter("gamma", shape=shape, dtype=dtype,
                               grad_req="write" if scale else "null",
                               init=_init_of(gamma_initializer),
                               allow_deferred_init=True)
        self.beta = Parameter("beta", shape=shape, dtype=dtype,
                              grad_req="write" if center else "null",
                              init=_init_of(beta_initializer),
                              allow_deferred_init=True)

    def _channel_axis(self):
        return 1

    def infer_shape(self, x, *args):
        c = x.shape[self._channel_axis()]
        for p in self._reg_params.values():
            p.shape_and_init((c,))

    def _ensure(self, x):
        if self.gamma._var is None:
            self.infer_shape(x)


class BatchNorm(_Norm):
    """BatchNorm with running statistics (basic_layers.py:413): batch
    statistics in training, the running ones otherwise; the running
    statistics are written in place."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 device=None, **kwargs):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self._norm_params(in_channels, center, scale, beta_initializer,
                          gamma_initializer)
        shape = (in_channels,) if in_channels else (0,)
        self.running_mean = Parameter(
            "running_mean", shape=shape, grad_req="null",
            init=_init_of(running_mean_initializer), allow_deferred_init=True)
        self.running_var = Parameter(
            "running_var", shape=shape, grad_req="null",
            init=_init_of(running_variance_initializer),
            allow_deferred_init=True)
        eager_init(self, device)

    def _channel_axis(self):
        return self._axis

    def _forward(self, training, x):
        self._ensure(x)
        g, b = self.gamma._var, self.beta._var
        rm, rv = self.running_mean._var, self.running_var._var
        if training and not self._use_global_stats:
            out, nm, nv = _ops.batch_norm_train(
                x, g, b, rm.detach(), rv.detach(), momentum=self._momentum,
                eps=self._epsilon, axis=self._axis, fix_gamma=not self._scale)
            with torch.no_grad():
                rm.copy_(nm)
                rv.copy_(nv)
            return out
        return _ops.batch_norm_inference(
            x, g, b, rm, rv, eps=self._epsilon, axis=self._axis,
            fix_gamma=not self._scale)


class BatchNormReLU(BatchNorm):
    """BatchNorm then ReLU (basic_layers.py:477)."""

    def _forward(self, training, x):
        return torch.relu(super()._forward(training, x))


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (basic_layers.py:1071).  The port trains on
    one card, where it is BatchNorm."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class Embedding(_Layer):
    """Rows of ``weight`` (input_dim, output_dim) at integer indices
    (basic_layers.py:541).  ``sparse_grad`` is accepted; the gradient is
    dense (row-sparse storage waits for ROADMAP item 9)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                dtype=dtype, init=_init_of(weight_initializer))
        eager_init(self, device)

    def _forward(self, training, x):
        return _ops.embedding(x, self.weight.leaf)

    def extra_repr(self):
        return "%d -> %d" % (self._input_dim, self._output_dim)


class Flatten(_Layer):
    def _forward(self, training, x):
        return x.reshape(x.shape[0], -1)


class InstanceNorm(_Norm):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self._norm_params(in_channels, center, scale, beta_initializer,
                          gamma_initializer)
        eager_init(self, device)

    def _channel_axis(self):
        return self._axis

    def _forward(self, training, x):
        self._ensure(x)
        return _ops.instance_norm(x, self.gamma._var, self.beta._var,
                                  self._epsilon)


class LayerNorm(_Norm):
    """LayerNorm over ``axis`` with fp32 statistics (basic_layers.py:708)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self._norm_params(in_channels, center, scale, beta_initializer,
                          gamma_initializer)
        if device is not None and not in_channels:
            raise ValueError("LayerNorm: in_channels must be given with "
                             "device=")
        eager_init(self, device)

    def _channel_axis(self):
        return self._axis

    def _forward(self, training, x):
        self._ensure(x)
        return _ops.layer_norm(x, self.gamma._var, self.beta._var,
                               axis=self._axis, eps=self._epsilon)


class GroupNorm(_Norm):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._norm_params(in_channels, center, scale, beta_initializer,
                          gamma_initializer)
        eager_init(self, device)

    def _forward(self, training, x):
        self._ensure(x)
        return _ops.group_norm(x, self.gamma._var, self.beta._var,
                               self._num_groups, self._epsilon)


def _resolve_fn(function):
    if isinstance(function, str):
        fn = getattr(_npx, function, None) or getattr(_np, function)
        return fn, function, True
    return function, getattr(function, "__name__", "lambda"), False


def _call_lambda(block, fn, by_name, args):
    """``fn`` on ``args``; a function named by string is an ``mx.np`` or
    ``mx.npx`` one, so torch tensors go in as ``ndarray``s (recording as
    torch's grad mode says) and come back out as tensors."""
    if not by_name or not args or not isinstance(args[0], torch.Tensor):
        return fn(*args)
    with autograd._RecordingStateScope(torch.is_grad_enabled(),
                                       _flag(block)):
        out = fn(*[_wrap(a) if isinstance(a, torch.Tensor) else a
                   for a in args])
    if isinstance(out, (list, tuple)):
        return type(out)(o._data if isinstance(o, ndarray) else o
                         for o in out)
    return out._data if isinstance(out, ndarray) else out


class Lambda(Block):
    """A function as a block (basic_layers.py:883): a callable, or the
    name of an ``mx.npx``/``mx.np`` function."""

    def __init__(self, function):
        super().__init__()
        self._func, self._fname, self._by_name = _resolve_fn(function)

    def forward(self, *args):
        return _call_lambda(self, self._func, self._by_name, args)

    def extra_repr(self):
        return self._fname


class HybridLambda(HybridBlock):
    def __init__(self, function):
        super().__init__()
        self._func, self._fname, self._by_name = _resolve_fn(function)

    def forward(self, *args):
        return _call_lambda(self, self._func, self._by_name, args)

    def extra_repr(self):
        return self._fname


class Concatenate(HybridSequential):
    """Every child on the same input, outputs concatenated along ``axis``
    (basic_layers.py:973)."""

    def __init__(self, axis=-1):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        out = [block(x) for block in self._modules.values()]
        if isinstance(x, ndarray):
            return _np.concatenate(out, axis=self._axis)
        return torch.cat(out, dim=self._axis)


HybridConcatenate = Concatenate


class Identity(HybridBlock):
    def forward(self, x):
        return x
