"""Trainer (the port of ``mxnet_tpu/gluon/trainer.py`` on one card;
parity: reference ``python/mxnet/gluon/trainer.py`` step :334,
allreduce_grads :363, update :411).

``Trainer(params, optimizer, optimizer_params)`` applies an MXNet
optimizer (:mod:`mxnet_tpu_torch.optimizer`) to a set of parameters: a
dict such as ``net.collect_params()`` or ``dict(model.named_parameters())``,
or a list, of Gluon :class:`Parameter`s or of torch ``nn.Parameter``s.
A Gluon parameter's leaf is looked up at each step, so a trainer made
before the first forward sees the parameters that deferred
initialisation makes later.

``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and
updates, in place, every initialised parameter whose ``grad_req`` is not
``"null"``, as the JAX package does: with its gradient, which is the last
one a backward wrote (a layer the step's backward did not reach, or a
second step with no backward, applies it again), or zeros if none ever
was (weight decay and momentum still move the parameter).  MXNet's
backward writes a ``grad_req="write"`` gradient afresh where torch's
adds to it, so ``step`` hands such a gradient back as ``None`` on the
leaf once applied, keeping it as the parameter's gradient
(``Parameter.grad()``): the next backward writes a new one.  A
``grad_req="add"`` gradient keeps its sum until ``zero_grad``.

``amp.init_trainer`` attaches a dynamic loss scaler for fp16 AMP as
``_amp_loss_scaler`` (None otherwise).  ``step`` is the ``trainer.step``
fault site (``faults.check``).

One card, one process: the kvstores ``"device"`` (the default, as in the
JAX package), ``"local"`` and ``None`` update in place, and
``allreduce_grads`` has nothing to reduce.  Distributed stores, gradient
compression, updates on the kvstore, bucketing, ZeRO, ``attach_mesh``,
elastic membership and ``attach_preemption`` belong to the distributed
Trainer (ROADMAP Queue 1 item 7) and raise ``NotImplementedError``
naming it.
"""
from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from .. import faults
from .. import optimizer as opt_mod
from .parameter import Parameter

__all__ = ["Trainer"]

_ONE_DEVICE_STORES = (None, "device", "local")
_ITEM7 = ("is not ported: the port trains on one card; the distributed "
          "Trainer is ROADMAP Queue 1 item 7")


def _distributed(what):
    raise NotImplementedError("Trainer %s %s" % (what, _ITEM7))


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, bucketing=None):
        if isinstance(params, dict):
            items = list(params.items())
        elif isinstance(params, (list, tuple)):
            items = [(None, p) for p in params]
        else:
            raise ValueError("params must be a dict or a list of "
                             "Parameters")
        self._params = []
        for i, (name, p) in enumerate(items):
            if isinstance(p, torch.nn.Parameter):
                p = Parameter._from_leaf(p, name or "param%d" % i)
            elif not isinstance(p, Parameter):
                raise ValueError("invalid parameter %r" % (type(p),))
            self._params.append(p)
        if kvstore not in _ONE_DEVICE_STORES:
            _distributed("kvstore %r" % (kvstore,))
        if compression_params is not None:
            _distributed("gradient compression")
        if update_on_kvstore:
            _distributed("update_on_kvstore")
        if bucketing:
            _distributed("bucketing")
        optimizer_params = dict(optimizer_params or {})
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)
        self._states = {}
        self._amp_loss_scaler = None
        self._step_count = 0

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _leaves(self):
        """The initialised leaves of the trainer's parameters."""
        return [p._var for p in self._params if p._var is not None]

    def step(self, batch_size, ignore_stale_grad=False):
        """Apply one update with gradients normalised by ``batch_size``."""
        faults.check("trainer.step")
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)
        self._step_count += 1

    def allreduce_grads(self):
        """Nothing to reduce on one card (the gradients are whole)."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone, for every initialised parameter whose
        ``grad_req`` is not ``"null"`` (``ignore_stale_grad`` is accepted
        and ignored, as in the JAX package); a ``"write"`` gradient is
        handed back as ``None`` on the leaf."""
        self._optimizer.rescale_grad = self._scale / batch_size
        idxs, ws, gs, sts, live = [], [], [], [], []
        for i, p in enumerate(self._params):
            w = p._var
            if w is None or p.grad_req == "null":
                continue
            if i not in self._states:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, w)
            idxs.append(i)
            ws.append(w)
            gs.append(p._current_grad())
            sts.append(self._states[i])
            live.append(p)
        if idxs:
            self._optimizer.update_multi_precision(idxs, ws, gs, sts)
        for p in live:
            p._spend_grad()

    def save_states(self, fname):
        """Pickle the optimizer states (as numpy) and the optimizer, its
        ``param_dict`` reduced to the learning-rate and weight-decay
        multipliers."""
        opt = copy.copy(self._optimizer)
        opt.param_dict = {
            i: SimpleNamespace(lr_mult=getattr(p, "lr_mult", 1.0),
                               wd_mult=getattr(p, "wd_mult", 1.0))
            for i, p in enumerate(self._params)}
        updater = opt_mod.Updater(opt)
        updater.states = self._states
        with open(fname, "wb") as f:
            f.write(updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        updater = opt_mod.Updater(self._optimizer)
        with open(fname, "rb") as f:
            data = f.read()
        updater.set_states(data)
        states = {}
        for i, s in updater.states.items():
            p = self._params[i] if i < len(self._params) else None
            dev = p._var.device if p is not None and p._var is not None \
                else None
            states[i] = _to_device(s, dev)
        self._states = states
        self._optimizer = updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))

    def comm_stats(self):
        _distributed("comm_stats (gradient communication)")

    def attach_mesh(self, *args, **kwargs):
        _distributed("attach_mesh (elastic mesh resharding)")

    def attach_preemption(self, *args, **kwargs):
        _distributed("attach_preemption (graceful preemption)")


def _to_device(s, dev):
    if s is None or dev is None:
        return s
    if isinstance(s, tuple):
        return tuple(_to_device(v, dev) for v in s)
    return s.to(dev)
