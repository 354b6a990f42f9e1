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

AMP (``mxnet_tpu_torch.amp``) opens a thread-local scope (``_amp_set``);
inside it the ops of the scope's op set (``amp/lists.py``
``TARGET_DTYPE_OPS``: here ``fully_connected``, ``batch_dot``,
``bias_gelu``, ``bias_dropout_residual``, and ``flash_attention`` in
``ops/attention.py``) cast their operands to the scope's dtype, as
``mxnet_tpu/ops/nn.py:26-58`` does, while the parameters stay fp32.
Softmax, log-softmax and layer norm compute in fp32 whatever comes in.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .kernels import epilogue as _epilogue

__all__ = ["activation", "fully_connected", "batch_dot", "embedding",
           "layer_norm", "dropout", "softmax", "log_softmax",
           "masked_softmax", "pick", "bias_gelu", "bias_dropout_residual"]

_AMP = threading.local()


def _amp_state():
    """(dtype, frozenset of op names) while an AMP scope is open, else
    None."""
    return getattr(_AMP, "state", None)


def _amp_set(state):
    _AMP.state = state


def _amp_cast2(op, a, b):
    st = _amp_state()
    if st is not None and op in st[1] and a.is_floating_point():
        return a.to(st[0]), b.to(st[0])
    return a, b


def _amp_cast1(op, a):
    st = _amp_state()
    if st is not None and op in st[1] and a.is_floating_point():
        return a.to(st[0])
    return a


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
    ``flatten`` folds every axis after the first into the input.  Under
    AMP the product runs in the scope's dtype and an fp32 bias is added
    after it, so the sum comes out in fp32, as in the JAX package."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    x, weight = _amp_cast2("fully_connected", x, weight)
    if bias is None or no_bias:
        return F.linear(x, weight)
    if bias.dtype != x.dtype:
        return F.linear(x, weight) + bias
    return F.linear(x, weight, bias)


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    """``npx.batch_dot``: batched ``a @ b`` over the leading axes."""
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    a, b = _amp_cast2("batch_dot", a, b)
    return torch.matmul(a, b)


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
    data, bias = _amp_cast2("bias_gelu", data, bias)
    return _epilogue.bias_gelu(data, bias)


def bias_dropout_residual(data, bias, residual, p=0.0, training=False,
                          generator=None):
    """``npx.bias_dropout_residual``: residual + dropout(data + bias).  The
    rate ``p`` applies only when ``training``; the hash mask is rebuilt in
    the backward, so no mask is stored."""
    rate = float(p) if training else 0.0
    data, bias = _amp_cast2("bias_dropout_residual", data, bias)
    residual = _amp_cast1("bias_dropout_residual", residual)
    return _epilogue.bias_dropout_residual(data, bias, residual, rate=rate,
                                           generator=generator)
