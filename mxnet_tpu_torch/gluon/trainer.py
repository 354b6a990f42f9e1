"""Trainer (the port of ``mxnet_tpu/gluon/trainer.py`` on one device).

``Trainer(params, optimizer, optimizer_params)`` applies an MXNet
optimizer (:mod:`mxnet_tpu_torch.optimizer`) to a set of parameters (a
dict such as ``dict(model.named_parameters())``, or a list).
``step(batch_size)`` sets ``rescale_grad = scale / batch_size`` and
updates, in place, every parameter that holds a gradient; a parameter
without one is left as it is.  MXNet's
backward writes each gradient afresh (``grad_req="write"``) where torch's
adds to it, so ``step`` hands the gradients back as ``None`` once it has
applied them: the next backward writes new ones.

``amp.init_trainer`` attaches a dynamic loss scaler for fp16 AMP as
``_amp_loss_scaler`` (None otherwise); ``amp.unscale`` walks the
parameters in ``_params``.

One card, one process: the kvstores ``"device"`` (the default, as in the
JAX package), ``"local"`` and ``None`` all update in place.  Distributed
stores, gradient compression and updates on the kvstore are not ported
and raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt_mod

__all__ = ["Trainer"]

_ONE_DEVICE_STORES = (None, "device", "local")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = list(params.values())
        params = list(params)
        for p in params:
            if not isinstance(p, torch.nn.Parameter):
                raise ValueError("invalid parameter %r" % (type(p),))
        if kvstore not in _ONE_DEVICE_STORES:
            raise NotImplementedError(
                "kvstore %r is not ported: the port trains on one card "
                "(kvstore 'device', 'local' or None)" % (kvstore,))
        if compression_params is not None or update_on_kvstore:
            raise NotImplementedError("gradient compression and updates on "
                                      "the kvstore are not ported")
        self._params = params
        optimizer_params = dict(optimizer_params or {})
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        param_dict = dict(enumerate(params))
        if isinstance(optimizer, opt_mod.Optimizer):
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)
        self._states = {}
        self._amp_loss_scaler = None

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

    def step(self, batch_size):
        """Apply one update with gradients normalised by ``batch_size``,
        then hand the gradients back as None."""
        self._optimizer.rescale_grad = self._scale / batch_size
        idxs, ws, gs, sts = [], [], [], []
        for i, p in enumerate(self._params):
            if not p.requires_grad or p.grad is None:
                continue
            if i not in self._states:
                self._states[i] = self._optimizer.create_state(i, p)
            idxs.append(i)
            ws.append(p)
            gs.append(p.grad)
            sts.append(self._states[i])
        if idxs:
            self._optimizer.update(idxs, ws, gs, sts)
        for p in ws:
            p.grad = None
