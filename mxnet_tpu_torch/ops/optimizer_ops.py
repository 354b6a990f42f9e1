"""Optimizer updates (the port of ``sgd_update``, ``sgd_mom_update``,
``adam_update`` and ``adamw_update`` of ``mxnet_tpu/ops/optimizer_ops.py``).

Plain PyTorch, in place: each function overwrites ``weight`` and its
state tensors and returns nothing, where the JAX package returns new
arrays and donates the old buffers.  The math is MXNet's, fp32 throughout:
the gradient is rescaled, clipped to ``[-clip_gradient, clip_gradient]``
when ``clip_gradient > 0``, and (except AdamW) gets ``wd * weight`` added
before the moments.  Callers run these under ``torch.no_grad()``.

``multi_adam_update`` updates a whole list of parameters with
``torch._foreach_*`` calls, a few launches for the list instead of a dozen
per tensor: the counterpart of the JAX package jitting the update over
the parameter list.  Each elementwise step is the same IEEE operation as
in the one-tensor form, in the same order, so both give the same bits.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "adamw_update",
           "multi_adam_update"]


def _rescale_clip(grad, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    return (_rescale_clip(grad, rescale_grad, clip_gradient)
            + wd * weight.float())


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    weight.copy_(weight.float() - lr * g)


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - lr * g)
    weight.copy_(weight.float() + mom)


def multi_adam_update(weights, grads, means, vars_, lr, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0, decoupled=False, eta=1.0):
    """Adam (or, with ``decoupled``, AdamW) over lists of tensors sharing
    ``lr`` and ``wd``; fp32 states.  Adam has no bias correction here: the
    caller folds it into ``lr``."""
    w32 = [w.float() for w in weights]
    g = torch._foreach_mul([t.float() for t in grads], rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(g, -clip_gradient)
        torch._foreach_clamp_max_(g, clip_gradient)
    if wd and not decoupled:
        torch._foreach_add_(g, torch._foreach_mul(w32, wd))
    torch._foreach_mul_(means, beta1)
    torch._foreach_add_(means, torch._foreach_mul(g, 1 - beta1))
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1 - beta2)
    torch._foreach_mul_(vars_, beta2)
    torch._foreach_add_(vars_, sq)
    del g, sq
    denom = torch._foreach_sqrt(vars_)
    torch._foreach_add_(denom, epsilon)
    step = torch._foreach_mul(means, lr)
    torch._foreach_div_(step, denom)
    del denom
    if decoupled:
        # w - eta * (lr * m / (sqrt(v) + eps) + wd * w)
        if wd:
            torch._foreach_add_(step, torch._foreach_mul(w32, wd))
        if eta != 1.0:
            torch._foreach_mul_(step, eta)
    torch._foreach_sub_(w32, step)
    for w, n in zip(weights, w32):
        if n is not w:
            w.copy_(n)


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Adam without bias correction: the caller folds it into ``lr``."""
    multi_adam_update([weight], [grad], [mean], [var], lr, beta1, beta2,
                      epsilon, wd, rescale_grad, clip_gradient)


def adamw_update(weight, grad, mean, var, lr, eta=1.0, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """AdamW: weight decay decoupled from the moments."""
    multi_adam_update([weight], [grad], [mean], [var], lr, beta1, beta2,
                      epsilon, wd, rescale_grad, clip_gradient,
                      decoupled=True, eta=eta)
