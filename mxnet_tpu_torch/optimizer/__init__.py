"""Optimizers (the port of ``mxnet_tpu/optimizer/__init__.py``; parity:
reference ``python/mxnet/optimizer/``): SGD, NAG, Adam, AdamW, AdaBelief,
Adamax, Nadam, AdaGrad, AdaDelta, RMSProp, Ftrl, Signum, LAMB, LARS,
LANS, FTML, DCASGD, LBSGD and SGLD, with ``register``/``create``,
``Updater`` and ``get_updater``.

These are MXNet's optimizers, not ``torch.optim``'s.  Adam folds its bias
correction into the learning rate, ``lr * sqrt(1 - beta2**t) / (1 -
beta1**t)`` with ``t`` the parameter's own update count, and adds ``wd *
weight`` to the rescaled, clipped gradient before the moments, so its
epsilon sits where torch's does not.  Updates run in place on torch
tensors (:mod:`mxnet_tpu_torch.ops.optimizer_ops`); states are fp32
tensors on the weight's device, created at a parameter's first update.
With ``multi_precision`` an fp16 weight updates through an fp32 master
copy kept in its state, as in the JAX package.  ``lr_scheduler`` sets the
learning rate from the update count.
"""
from __future__ import annotations

import pickle

import torch

from .. import _rng
from ..ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaBelief", "Adamax",
           "Nadam", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl", "Signum",
           "LAMB", "LARS", "LANS", "FTML", "DCASGD", "LBSGD", "SGLD",
           "Updater", "get_updater", "register", "create"]

_OPT_REGISTRY = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _OPT_REGISTRY[name.lower()](**kwargs)


def _zeros_f32(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


class Optimizer:
    """Base optimizer: learning rate (or ``lr_scheduler``), weight decay,
    ``rescale_grad``, ``clip_gradient``, per-index ``lr_mult``/``wd_mult``
    (for the parameters in ``param_dict``, their ``lr_mult``/``wd_mult``
    attributes, 1 when unset; else by index or by ``param_idx2name``),
    and the per-index update count."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, aggregate_num=0,
                 use_fused_step=True, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self.param_dict = param_dict or {}
        self.param_idx2name = param_idx2name or {}
        self.idx2name = self.param_idx2name
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
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        return lr * self._mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._mult(index, self.wd_mult, "wd_mult")

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            self.lr_scheduler.base_lr = lr
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
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

    def create_state_multi_precision(self, index, weight):
        """``(fp32 master copy, state of the master)`` for an fp16 weight
        under ``multi_precision``, else ``create_state``."""
        if self.multi_precision and weight.dtype == torch.float16:
            master = weight.detach().float().clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

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

    @torch.no_grad()
    def update_multi_precision(self, indices, weights, grads, states):
        if not self.multi_precision:
            return self.update(indices, weights, grads, states)
        if not isinstance(indices, (list, tuple)):
            indices, weights, grads, states = ([indices], [weights],
                                               [grads], [states])
        for i, w, g, s in zip(indices, weights, grads, states):
            self._update_count(i)
            if w.dtype == torch.float16 and isinstance(s, tuple) \
                    and isinstance(s[0], torch.Tensor) \
                    and s[0].dtype == torch.float32 and s[0].shape == w.shape:
                master, inner = s
                self.step_one(i, master, g, inner)
                w.copy_(master.to(w.dtype))
            else:
                self.step_one(i, w, g, s)

    def step_one(self, index, weight, grad, state):
        raise NotImplementedError

    def __getstate__(self):
        return self.__dict__.copy()

    def __setstate__(self, d):
        self.__dict__.update(d)


@register
class SGD(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

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
class NAG(Optimizer):
    def __init__(self, learning_rate=0.1, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_f32(weight)

    def step_one(self, index, weight, grad, state):
        _ops.nag_mom_update(weight, grad, state, self._get_lr(index),
                            self.momentum, self._get_wd(index),
                            self.rescale_grad, self._clip())


@register
class Adam(Optimizer):
    """Adam; the parameters that share a learning rate and a weight decay
    update together, in one ``multi_adam_update``."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_f32(weight), _zeros_f32(weight))

    def _corrected_lr(self, index):
        t = self._index_update_count[index]
        return (self._get_lr(index) * (1.0 - self.beta2 ** t) ** 0.5
                / (1.0 - self.beta1 ** t))

    def step_one(self, index, weight, grad, state):
        _ops.multi_adam_update(
            [weight], [grad], [state[0]], [state[1]],
            self._corrected_lr(index), self.beta1, self.beta2, self.epsilon,
            self._get_wd(index), self.rescale_grad, self._clip(),
            decoupled=self._decoupled)

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


class _TwoMoments(Optimizer):
    def create_state(self, index, weight):
        return (_zeros_f32(weight), _zeros_f32(weight))


@register
class AdaBelief(_TwoMoments):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def step_one(self, index, weight, grad, state):
        t = self._index_update_count[index]
        lr = (self._get_lr(index) * (1.0 - self.beta2 ** t) ** 0.5
              / (1.0 - self.beta1 ** t))
        _ops.adabelief_update(weight, grad, state[0], state[1], lr,
                              self.beta1, self.beta2, self.epsilon,
                              self._get_wd(index), self.rescale_grad,
                              self._clip())


@register
class Adamax(_TwoMoments):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def step_one(self, index, weight, grad, state):
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        _ops.adamax_update(weight, grad, state[0], state[1], lr, self.beta1,
                           self.beta2, self._get_wd(index), self.rescale_grad,
                           self._clip())


@register
class Nadam(_TwoMoments):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def step_one(self, index, weight, grad, state):
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        _ops.nadam_update(weight, grad, state[0], state[1],
                          self._get_lr(index), t, self.m_schedule,
                          momentum_t, momentum_t_1, self.beta1, self.beta2,
                          self.epsilon, self._get_wd(index),
                          self.rescale_grad, self._clip())


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_f32(weight)

    def step_one(self, index, weight, grad, state):
        _ops.adagrad_update(weight, grad, state, self._get_lr(index),
                            self.epsilon, self._get_wd(index),
                            self.rescale_grad, self._clip())


@register
class AdaDelta(_TwoMoments):
    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.epsilon = rho, epsilon

    def step_one(self, index, weight, grad, state):
        _ops.adadelta_update(weight, grad, state[0], state[1], self.rho,
                             self.epsilon, self._get_wd(index),
                             self.rescale_grad, self._clip())


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(_zeros_f32(weight) for _ in range(3))
        return _zeros_f32(weight)

    def step_one(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        cw = self.clip_weights if self.clip_weights else -1.0
        if self.centered:
            n, g_avg, delta = state
            _ops.rmspropalex_update(weight, grad, n, g_avg, delta, lr,
                                    self.rho, self.momentum, self.epsilon,
                                    wd, self.rescale_grad, self._clip(), cw)
        else:
            _ops.rmsprop_update(weight, grad, state, lr, self.rho,
                                self.epsilon, wd, self.rescale_grad,
                                self._clip(), cw)


@register
class Ftrl(_TwoMoments):
    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def step_one(self, index, weight, grad, state):
        _ops.ftrl_update(weight, grad, state[0], state[1],
                         self._get_lr(index), self.lamda1, self.beta,
                         self._get_wd(index), self.rescale_grad, self._clip())


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_f32(weight) if self.momentum != 0.0 else None

    def step_one(self, index, weight, grad, state):
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            _ops.signsgd_update(weight, grad, lr, wd, self.rescale_grad,
                                self._clip(), self.wd_lh)
        else:
            _ops.signum_update(weight, grad, state, lr, self.momentum, wd,
                               self.rescale_grad, self._clip(), self.wd_lh)


@register
class LAMB(_TwoMoments):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def step_one(self, index, weight, grad, state):
        _ops.lamb_update(weight, grad, state[0], state[1],
                         self._get_lr(index), self.beta1, self.beta2,
                         self.epsilon, self._get_wd(index),
                         self._index_update_count[index],
                         self.bias_correction, self.rescale_grad,
                         self._clip(), self.lower_bound, self.upper_bound)


@register
class LARS(Optimizer):
    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon

    def create_state(self, index, weight):
        return _zeros_f32(weight)

    def step_one(self, index, weight, grad, state):
        _ops.lars_update(weight, grad, state, self._get_lr(index), self.eta,
                         self.momentum, self._get_wd(index), self.epsilon,
                         self.rescale_grad, self._clip())


@register
class LANS(_TwoMoments):
    """LANS (reference ``contrib/multi_lans.cc``): LAMB on the gradient
    normalised per tensor, with a two-part trust-ratio update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 **kwargs):
        kwargs.setdefault("aggregate_num", 4)
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound

    def step_one(self, index, weight, grad, state):
        _ops.lans_update(weight, grad, state[0], state[1],
                         self._get_lr(index), self.beta1, self.beta2,
                         self.epsilon, self._get_wd(index),
                         self._index_update_count[index], self.rescale_grad,
                         self._clip(), self.lower_bound, self.upper_bound)


@register
class FTML(Optimizer):
    """Follow the Moving Leader (reference ``FTMLUpdate``); states d, v,
    z."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return tuple(_zeros_f32(weight) for _ in range(3))

    def step_one(self, index, weight, grad, state):
        d, v, z = state
        _ops.ftml_update(weight, grad, d, v, z, self._get_lr(index),
                         self._index_update_count[index], self.beta1,
                         self.beta2, self.epsilon, self._get_wd(index),
                         self.rescale_grad, self._clip())


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (reference ``DCASGDUpdate``): states
    the previous weight and the momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (weight.detach().float().clone(), _zeros_f32(weight))

    def step_one(self, index, weight, grad, state):
        prev_w, mom = state
        _ops.dcasgd_update(weight, grad, prev_w, mom, self._get_lr(index),
                           self.momentum, self.lamda, self._get_wd(index),
                           self.rescale_grad, self._clip())


@register
class LBSGD(Optimizer):
    """Large-batch SGD: LARS's layer-wise rate with a warm-up
    (reference ``LBSGD``)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-9, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon
        self.warmup_strategy = warmup_strategy
        self.warmup_updates = max(1, warmup_epochs * updates_per_epoch)
        self.batch_scale = batch_scale

    def create_state(self, index, weight):
        return _zeros_f32(weight)

    def _warmup_lr(self, lr):
        t = min(self.num_update, self.warmup_updates)
        frac = t / float(self.warmup_updates)
        if self.warmup_strategy == "linear":
            return lr * (frac + (1 - frac) / self.batch_scale)
        if self.warmup_strategy == "power":
            return lr * (frac ** 2 + (1 - frac ** 2) / self.batch_scale)
        return lr

    def step_one(self, index, weight, grad, state):
        _ops.lars_update(weight, grad, state,
                         self._warmup_lr(self._get_lr(index)), self.eta,
                         self.momentum, self._get_wd(index), self.epsilon,
                         self.rescale_grad, self._clip())


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: the noise comes from the
    global seed (``mx.random.seed``) on the weight's device."""

    def __init__(self, learning_rate=0.01, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)

    def step_one(self, index, weight, grad, state):
        _ops.sgld_update(weight, grad, self._get_lr(index),
                         _rng.generator(weight.device), self._get_wd(index),
                         self.rescale_grad, self._clip())


def _to_numpy(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_to_numpy(v) for v in s)
    return s.detach().cpu().numpy()


def _to_tensor(s, device):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_to_tensor(v, device) for v in s)
    return torch.from_numpy(s).to(device)


class Updater:
    """Applies the optimizer by index with the states it keeps (reference
    ``optimizer/updater.py``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.aggregate_updates = optimizer.aggregate_num > 0

    def __call__(self, index, grad, weight):
        if not isinstance(index, (list, tuple)):
            index, grad, weight = [index], [grad], [weight]
        for i, g, w in zip(index, grad, weight):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
            self.optimizer.update_multi_precision([i], [w], [g],
                                                  [self.states[i]])

    def get_states(self, dump_optimizer=False):
        states = {k: _to_numpy(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer))
        return pickle.dumps(states)

    def set_states(self, states, device=None):
        data = pickle.loads(states)
        if isinstance(data, tuple):
            states_np, self.optimizer = data
        else:
            states_np = data
        dev = device if device is not None else "cpu"
        self.states = {k: _to_tensor(v, dev) for k, v in states_np.items()}


def get_updater(optimizer):
    return Updater(optimizer)


sgd = SGD
adam = Adam
nag = NAG
rmsprop = RMSProp
adagrad = AdaGrad
adadelta = AdaDelta
ftrl = Ftrl
signum = Signum
lamb = LAMB
lars = LARS
sgld = SGLD
adamw = AdamW
