"""Optimizer updates (the port of ``mxnet_tpu/ops/optimizer_ops.py``;
parity: reference ``src/operator/optimizer_op.cc``).

Plain PyTorch, in place: each function overwrites ``weight`` and its
state tensors and returns nothing, where the JAX package returns new
arrays and donates the old buffers.  The math is MXNet's, fp32 throughout:
the gradient is rescaled, clipped to ``[-clip_gradient, clip_gradient]``
when ``clip_gradient > 0``, and (where the JAX package does) gets ``wd *
weight`` added before the moments.  Callers run these under
``torch.no_grad()``.

``multi_adam_update`` updates a whole list of parameters with
``torch._foreach_*`` calls, a few launches for the list instead of a dozen
per tensor: the counterpart of the JAX package jitting the update over
the parameter list.  Each elementwise step is the same IEEE operation as
in the one-tensor form, in the same order, so both give the same bits.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "adamw_update",
           "multi_adam_update", "nag_mom_update", "adabelief_update",
           "adamax_update", "nadam_update", "rmsprop_update",
           "rmspropalex_update", "adagrad_update", "adadelta_update",
           "ftrl_update", "signum_update", "signsgd_update", "lamb_update",
           "lars_update", "lans_update", "sgld_update", "ftml_update",
           "dcasgd_update"]


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


def _w32(weight):
    return weight.float()


def _write(weight, new):
    weight.copy_(new.to(weight.dtype))


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom + g)
    _write(weight, _w32(weight) - lr * (g + momentum * mom))


def adabelief_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                     epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                     clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * torch.square(g - mean) + epsilon)
    _write(weight, _w32(weight) - lr * mean / (torch.sqrt(var) + epsilon))


def adamax_update(weight, grad, m, u, lr, beta1=0.9, beta2=0.999, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    """Adamax; ``lr`` carries the bias correction 1 / (1 - beta1**t)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    m.copy_(beta1 * m + (1 - beta1) * g)
    u.copy_(torch.maximum(beta2 * u, torch.abs(g)))
    _write(weight, _w32(weight) - lr * m / (u + 1e-8))


def nadam_update(weight, grad, m, v, lr, t, m_schedule, momentum_t,
                 momentum_t_1, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    """Nadam; ``m_schedule`` is the product of the momenta up to step t,
    which the optimizer keeps."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    m_schedule_next = m_schedule * momentum_t_1
    m.copy_(beta1 * m + (1 - beta1) * g)
    v.copy_(beta2 * v + (1 - beta2) * torch.square(g))
    g_prime = g / (1.0 - m_schedule)
    m_prime = m / (1.0 - m_schedule_next)
    v_prime = v / (1.0 - beta2 ** t)
    m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
    _write(weight, _w32(weight) - lr * m_bar / (torch.sqrt(v_prime)
                                                + epsilon))


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return w.clamp(-clip_weights, clip_weights)
    return w


def rmsprop_update(weight, grad, n, lr, rho=0.9, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n.copy_(rho * n + (1 - rho) * torch.square(g))
    _write(weight, _clip_weights(_w32(weight) - lr * g
                                 / torch.sqrt(n + epsilon), clip_weights))


def rmspropalex_update(weight, grad, n, g_avg, delta, lr, rho=0.9,
                       momentum=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    n.copy_(rho * n + (1 - rho) * torch.square(g))
    g_avg.copy_(rho * g_avg + (1 - rho) * g)
    delta.copy_(momentum * delta - lr * g / torch.sqrt(
        n - torch.square(g_avg) + epsilon))
    _write(weight, _clip_weights(_w32(weight) + delta, clip_weights))


def adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    history.add_(torch.square(g))
    _write(weight, _w32(weight) - lr * g / (torch.sqrt(history) + epsilon))


def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    acc_g.copy_(rho * acc_g + (1 - rho) * torch.square(g))
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(acc_g + epsilon) * g
    acc_delta.copy_(rho * acc_delta + (1 - rho) * torch.square(delta))
    _write(weight, _w32(weight) - delta)


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    w32 = _w32(weight)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    z.copy_(z + g - sigma * w32)
    n.copy_(new_n)
    new_w = torch.where(
        torch.abs(z) <= lamda1, torch.zeros_like(z),
        -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(n)) / lr + wd))
    _write(weight, new_w)


def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom - (1 - momentum) * g)
    _write(weight, (1 - lr * wd_lh) * _w32(weight) + lr * torch.sign(mom))


def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, wd_lh=0.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    _write(weight, (1 - lr * (wd + wd_lh)) * _w32(weight)
           - lr * torch.sign(g))


def _norm(t):
    return torch.linalg.vector_norm(t)


def lamb_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-6, wd=0.0, t=1, bias_correction=True,
                rescale_grad=1.0, clip_gradient=-1.0, lower_bound=None,
                upper_bound=None):
    """lamb_update_phase1 and 2 in one (optimizer_op.cc:919)."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * torch.square(g))
    m, v = mean, var
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    w32 = _w32(weight)
    gw = m / (torch.sqrt(v) + epsilon) + wd * w32
    r1 = _norm(w32)
    if lower_bound is not None:
        r1 = torch.clamp_min(r1, lower_bound)
    if upper_bound is not None:
        r1 = torch.clamp_max(r1, upper_bound)
    r2 = _norm(gw)
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    _write(weight, w32 - lr * ratio * gw)


def lars_update(weight, grad, mom, lr, eta=0.001, momentum=0.9, wd=0.0,
                epsilon=1e-9, rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    w32 = _w32(weight)
    w_norm, g_norm = _norm(w32), _norm(g)
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wd * w_norm + epsilon),
                        torch.ones_like(w_norm))
    mom.copy_(momentum * mom + trust * (g + wd * w32))
    _write(weight, w32 - lr * mom)


def lans_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-6, wd=0.0, t=1, rescale_grad=1.0,
                clip_gradient=-1.0, lower_bound=None, upper_bound=None):
    """LANS (contrib/multi_lans.cc): LAMB on the gradient normalised per
    tensor, with a trust ratio for the momentum part and one for the
    gradient part."""
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    g = g / torch.clamp_min(_norm(g), 1e-12)
    w32 = _w32(weight)
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * torch.square(g))
    m_hat = mean / (1 - beta1 ** t)
    v_hat = var / (1 - beta2 ** t)
    denom = torch.sqrt(v_hat) + epsilon
    r_m = m_hat / denom + wd * w32
    r_g = g / denom + wd * w32
    wnorm = _norm(w32)

    def ratio(direction):
        dnorm = _norm(direction)
        one = torch.ones_like(dnorm)
        r = torch.where(dnorm > 0, wnorm / torch.clamp_min(dnorm, 1e-12), one)
        r = torch.where(wnorm > 0, r, one)
        if lower_bound is not None:
            r = torch.clamp_min(r, lower_bound)
        if upper_bound is not None:
            r = torch.clamp_max(r, upper_bound)
        return r

    update = beta1 * ratio(r_m) * r_m + (1 - beta1) * ratio(r_g) * r_g
    _write(weight, w32 - lr * update)


def sgld_update(weight, grad, lr, generator, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    """SGLD: half a gradient step plus N(0, lr) noise drawn from
    ``generator`` (on the weight's device)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    noise = torch.randn(weight.shape, generator=generator,
                        device=weight.device) * (lr ** 0.5)
    _write(weight, _w32(weight) - lr / 2 * g + noise)


def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """FTML, Follow the Moving Leader (optimizer_op.cc FTMLUpdate)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    w32 = _w32(weight)
    v.copy_(beta2 * v + (1 - beta2) * torch.square(g))
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(v / (1 - beta2 ** t))
                                   + epsilon)
    sigma = d_t - beta1 * d
    z.copy_(beta1 * z + (1 - beta1) * g - sigma * w32)
    d.copy_(d_t)
    _write(weight, -z / d_t)


def dcasgd_update(weight, grad, prev_weight, mom, lr, momentum=0.0,
                  lamda=0.04, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """DCASGD (optimizer_op.cc DCASGDUpdate): the gradient compensated by
    lamda g^2 (w - w_prev)."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    w32 = _w32(weight)
    comp = g + lamda * torch.square(g) * (w32 - prev_weight)
    mom.copy_(momentum * mom - lr * comp)
    prev_weight.copy_(w32)
    _write(weight, w32 + mom)
