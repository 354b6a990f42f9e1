"""Neural-network operators the training slice needs (the port of a subset
of ``mxnet_tpu/ops/nn.py`` and of the ``npx`` entries in
``mxnet_tpu/numpy_extension/__init__.py``).

Plain PyTorch on tensors, differentiable by autograd.  The fused epilogues
(:func:`bias_gelu`, :func:`bias_dropout_residual`) go to the kernels of
``ops/kernels/epilogue.py``.  Dropout draws from an explicit
``torch.Generator`` on the tensor's device (the default one when None),
where the JAX package draws from its global key; the two give different
masks, so parity with JAX holds at rate 0, and at rate > 0 only for the
hash-masked epilogue.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import epilogue as _epilogue

__all__ = ["activation", "fully_connected", "embedding", "layer_norm",
           "dropout", "softmax", "log_softmax", "masked_softmax", "pick",
           "bias_gelu", "bias_dropout_residual"]


def activation(x, act_type):
    """``npx.activation`` for the types the ported models use: tanh and
    gelu (exact erf)."""
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "gelu":
        return F.gelu(x)
    raise ValueError("act_type %r is not ported (tanh, gelu)" % (act_type,))


def fully_connected(x, weight, bias=None, no_bias=False, flatten=True):
    """``x @ weight.T + bias`` with gluon's (out, in) weight layout;
    ``flatten`` folds every axis after the first into the input."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, None if no_bias else bias)


def embedding(data, weight):
    """Rows of ``weight`` (input_dim, output_dim) at integer ``data``."""
    return F.embedding(data.long(), weight)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis``: fp32 statistics (biased variance), the
    result in ``x.dtype``."""
    axis = axis % x.ndim
    xf = x.float().movedim(axis, -1)
    out = F.layer_norm(xf, xf.shape[-1:], gamma.float(), beta.float(), eps)
    return out.movedim(-1, axis).to(x.dtype)


def dropout(x, p=0.5, training=True, generator=None, axes=None):
    """Inverted dropout, active when ``training``: keep each element with
    probability 1 - p and scale it by 1/(1 - p).  ``axes`` share one mask
    draw along those axes."""
    if p <= 0.0 or not training:
        return x
    shape = list(x.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = 1.0 - p
    u = torch.rand(shape, generator=generator, device=x.device)
    return x * ((u < keep).to(x.dtype) / keep)


def _f32(x):
    return x.float() if x.dtype in (torch.float16, torch.bfloat16) else x


def softmax(x, axis=-1):
    return torch.softmax(_f32(x), dim=axis).to(x.dtype)


def log_softmax(x, axis=-1):
    return torch.log_softmax(_f32(x), dim=axis).to(x.dtype)


def masked_softmax(x, mask, axis=-1, temperature=1.0):
    """Softmax over the positions where the boolean ``mask`` (broadcast to
    ``x``) is true; masked positions give 0, and a row masked whole gives
    a zero row.  Masked logits are filled with the dtype's lowest finite
    value, as the JAX package does."""
    xf = _f32(x)
    if temperature != 1.0:
        xf = xf / temperature
    xf = torch.where(mask, xf, torch.finfo(xf.dtype).min)
    out = torch.softmax(xf, dim=axis)
    return torch.where(mask, out, 0.0).to(x.dtype)


def pick(data, index, axis=-1, keepdims=False):
    """``data`` at integer ``index`` along ``axis`` (index has data's shape
    without that axis)."""
    axis = axis % data.ndim
    out = torch.gather(data, axis, index.long().unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


def bias_gelu(data, bias):
    """``npx.bias_gelu``: gelu(data + bias), the fused kernel with its
    gradient."""
    return _epilogue.bias_gelu(data, bias)


def bias_dropout_residual(data, bias, residual, p=0.0, training=False,
                          generator=None):
    """``npx.bias_dropout_residual``: residual + dropout(data + bias).  The
    rate ``p`` applies only when ``training``; the hash mask is rebuilt in
    the backward, so no mask is stored."""
    rate = float(p) if training else 0.0
    return _epilogue.bias_dropout_residual(data, bias, residual, rate=rate,
                                           generator=generator)
