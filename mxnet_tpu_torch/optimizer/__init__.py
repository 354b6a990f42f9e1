"""Optimizers (the port of ``Optimizer``, ``SGD``, ``Adam``, ``AdamW`` and
``create``/``register`` of ``mxnet_tpu/optimizer/__init__.py``).

These are MXNet's optimizers, not ``torch.optim``'s.  Adam folds its bias
correction into the learning rate, ``lr * sqrt(1 - beta2**t) / (1 -
beta1**t)`` with ``t`` the parameter's own update count, and adds ``wd *
weight`` to the rescaled, clipped gradient before the moments, so its
epsilon sits where torch's does not.  Updates run in place
(:mod:`mxnet_tpu_torch.ops.optimizer_ops`); states are fp32 tensors on the
weight's device, created at a parameter's first update.
"""
from __future__ import annotations

import torch

from ..ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "register", "create"]

_OPT_REGISTRY = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _OPT_REGISTRY[name.lower()](**kwargs)


class Optimizer:
    """Base optimizer: learning rate, weight decay, ``rescale_grad``,
    ``clip_gradient``, per-index ``lr_mult``/``wd_mult`` (or, for the
    parameters in ``param_dict``, their ``lr_mult``/``wd_mult``
    attributes, 1 when unset), and the per-index update count."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict or {}
        self.num_update = 0
        self._index_update_count = {}
        self.lr_mult = {}
        self.wd_mult = {}

    def _update_count(self, index):
        self._index_update_count[index] = (
            self._index_update_count.get(index, 0) + 1)
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _mult(self, index, table, attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        return table.get(index, 1.0)

    def _get_lr(self, index):
        return self.lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def create_state(self, index, weight):
        return None

    @torch.no_grad()
    def update(self, indices, weights, grads, states):
        """Update each weight in place from its gradient (lists, or one
        of each)."""
        if not isinstance(indices, (list, tuple)):
            indices, weights, grads, states = ([indices], [weights],
                                               [grads], [states])
        for i, w, g, s in zip(indices, weights, grads, states):
            self._update_count(i)
            self.step_one(i, w, g, s)

    def step_one(self, index, weight, grad, state):
        raise NotImplementedError


def _zeros_f32(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


@register
class SGD(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_f32(weight) if self.momentum != 0.0 else None

    def step_one(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        if self.momentum == 0.0:
            _ops.sgd_update(weight, grad, lr, wd, self.rescale_grad,
                            self._clip())
        else:
            _ops.sgd_mom_update(weight, grad, state, lr, self.momentum, wd,
                                self.rescale_grad, self._clip())


@register
class Adam(Optimizer):
    """Adam; the parameters that share a learning rate and a weight decay
    update together, in one ``multi_adam_update``."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_f32(weight), _zeros_f32(weight))

    def _corrected_lr(self, index):
        t = self._index_update_count[index]
        return (self._get_lr(index) * (1.0 - self.beta2 ** t) ** 0.5
                / (1.0 - self.beta1 ** t))

    @torch.no_grad()
    def update(self, indices, weights, grads, states):
        if not isinstance(indices, (list, tuple)):
            indices, weights, grads, states = ([indices], [weights],
                                               [grads], [states])
        groups = {}
        for i, w, g, s in zip(indices, weights, grads, states):
            self._update_count(i)
            key = (self._corrected_lr(i), self._get_wd(i))
            groups.setdefault(key, []).append((w, g, s))
        for (lr, wd), items in groups.items():
            _ops.multi_adam_update(
                [w for w, _, _ in items], [g for _, g, _ in items],
                [s[0] for _, _, s in items], [s[1] for _, _, s in items],
                lr, self.beta1, self.beta2, self.epsilon, wd,
                self.rescale_grad, self._clip(), decoupled=self._decoupled)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay (``eta`` 1)."""

    _decoupled = True
