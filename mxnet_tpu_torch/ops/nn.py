"""Neural-network operators (the port of ``mxnet_tpu/ops/nn.py``; parity:
reference ``src/operator/nn/``), the kernels behind ``npx``.

Plain PyTorch on tensors, differentiable by autograd.  Convolution,
deconvolution and pooling call cuDNN through ``torch.nn.functional`` and
``ctc_loss`` calls ``F.ctc_loss``: the JAX package computes them in
``lax``/``jnp`` outside any Pallas kernel.  The fused epilogues
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

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import epilogue as _epilogue

__all__ = ["activation", "fully_connected", "batch_dot", "embedding",
           "layer_norm", "dropout", "softmax", "log_softmax",
           "masked_softmax", "masked_log_softmax", "softmin", "pick",
           "bias_gelu", "bias_dropout_residual", "leaky_relu", "prelu",
           "elu", "selu", "convolution", "deconvolution", "pooling",
           "adaptive_avg_pool2d", "batch_norm_train",
           "batch_norm_inference", "group_norm", "instance_norm",
           "l2_normalization", "lrn", "one_hot", "topk", "gather_nd",
           "scatter_nd", "sequence_mask", "sequence_last",
           "sequence_reverse", "ctc_loss", "all_finite"]

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
    """``npx.activation`` (``src/operator/nn/activation.cc``)."""
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "log_sigmoid":
        return F.logsigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return F.softsign(x)
    if act_type == "mish":
        return x * torch.tanh(F.softplus(x))
    if act_type in ("swish", "silu"):
        return F.silu(x)
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError("unknown act_type %r" % (act_type,))


def leaky_relu(x, slope=0.25):
    return torch.where(x >= 0, x, slope * x)


def prelu(x, alpha):
    """alpha broadcast over channel axis 1 (reference leaky_relu.cc)."""
    if alpha.dim() == 1 and x.dim() > 1:
        shape = [1] * x.dim()
        shape[1] = alpha.shape[0]
        alpha = alpha.reshape(shape)
    return torch.where(x >= 0, x, alpha * x)


def elu(x, alpha=1.0):
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


def selu(x):
    return F.selu(x)


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


def _length_mask(shape, axis, length):
    """Boolean mask of ``shape``: True where the index along ``axis`` is
    below ``length`` (shaped as ``shape`` without ``axis``)."""
    axis = axis % len(shape)
    idx = torch.arange(shape[axis], device=length.device)
    idx = idx.reshape([-1 if d == axis else 1 for d in range(len(shape))])
    return idx < length.long().unsqueeze(axis)


def softmax(x, axis=-1, temperature=None, length=None, use_length=False):
    """Softmax in fp32 (the result in ``x.dtype``); with ``use_length``,
    over the first ``length`` positions along ``axis`` (the rest 0)."""
    xf = _f32(x)
    if temperature is not None and temperature != 1.0:
        xf = xf / temperature
    if use_length and length is not None:
        mask = _length_mask(xf.shape, axis, length)
        out = torch.softmax(xf.masked_fill(~mask, float("-inf")), dim=axis)
        return torch.where(mask, out, 0.0).to(x.dtype)
    return torch.softmax(xf, dim=axis).to(x.dtype)


def log_softmax(x, axis=-1, temperature=None):
    xf = _f32(x)
    if temperature is not None and temperature != 1.0:
        xf = xf / temperature
    return torch.log_softmax(xf, dim=axis).to(x.dtype)


def softmin(x, axis=-1):
    return softmax(-x, axis=axis)


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


def masked_log_softmax(x, mask, axis=-1, temperature=1.0):
    xf = _f32(x)
    if temperature != 1.0:
        xf = xf / temperature
    xf = torch.where(mask, xf, torch.finfo(xf.dtype).min)
    out = torch.log_softmax(xf, dim=axis)
    return torch.where(mask, out, float("-inf")).to(x.dtype)


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at integer ``index`` along ``axis`` (index has data's shape
    without that axis); out-of-range indices clipped (``mode="wrap"``:
    wrapped)."""
    axis = axis % data.ndim
    n = data.shape[axis]
    idx = index.long()
    idx = idx.remainder(n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


# ---------------------------------------------------------------------------
# convolution and pooling (src/operator/nn/convolution.cc, deconvolution.cc,
# pooling.cc) on cuDNN
# ---------------------------------------------------------------------------
def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _channels_first(x, layout):
    """(x in NC... layout, whether it was channels-last)."""
    if layout is None or layout.startswith("NC"):
        return x, False
    return x.movedim(-1, 1), True


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def convolution(x, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout=None):
    """N-d convolution, weight (O, I/groups, *k) as the reference lays it
    out whatever the data's layout, data NC... or channels-last by
    ``layout`` (the JAX package's dimension numbers: rhs ``OI`` + the
    spatial dims)."""
    nd = x.dim() - 2
    x, last = _channels_first(x, layout)
    x, weight = _amp_cast2("convolution", x, weight)
    b = None if (bias is None or no_bias) else bias.to(x.dtype)
    out = _CONV[nd](x, weight, b, _tup(stride or 1, nd), _tup(pad or 0, nd),
                    _tup(dilate or 1, nd), num_group)
    return out.movedim(1, -1) if last else out


def deconvolution(x, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=False, layout=None,
                  target_shape=None):
    """Transposed convolution, weight (I, O/groups, *k) whatever the
    data's layout; ``target_shape`` overrides the padding as in the
    reference."""
    nd = x.dim() - 2
    x, last = _channels_first(x, layout)
    x, weight = _amp_cast2("deconvolution", x, weight)
    stride, dilate = _tup(stride or 1, nd), _tup(dilate or 1, nd)
    pad, adj = _tup(pad or 0, nd), _tup(adj or 0, nd)
    k = weight.shape[2:]
    if target_shape is not None:
        target_shape = _tup(target_shape, nd)
        pad = tuple(((x.shape[2 + i] - 1) * stride[i]
                     + dilate[i] * (k[i] - 1) + 1 + adj[i]
                     - target_shape[i]) // 2 for i in range(nd))
    b = None if (bias is None or no_bias) else bias.to(x.dtype)
    out = _CONV_T[nd](x, weight, b, stride, pad, adj, num_group, dilate)
    return out.movedim(1, -1) if last else out


def pooling(x, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, layout=None):
    nd = x.dim() - 2
    x, last = _channels_first(x, layout)
    sp = tuple(range(2, 2 + nd))
    if global_pool:
        if pool_type == "max":
            out = x.amax(dim=sp, keepdim=True)
        elif pool_type == "avg":
            out = x.mean(dim=sp, keepdim=True)
        elif pool_type == "sum":
            out = x.sum(dim=sp, keepdim=True)
        elif pool_type == "lp":
            out = torch.sqrt((x * x).sum(dim=sp, keepdim=True))
        else:
            raise ValueError(pool_type)
        return out.movedim(1, -1) if last else out
    kernel = _tup(kernel, nd)
    stride = _tup(stride or kernel, nd)
    pad = _tup(pad or 0, nd)
    hi = [0] * nd
    if pooling_convention == "full":
        for i in range(nd):
            size = x.shape[2 + i] + 2 * pad[i]
            rem = (size - kernel[i]) % stride[i]
            if rem:
                hi[i] = stride[i] - rem
    flat = []
    for i in reversed(range(nd)):
        flat += [pad[i], pad[i] + hi[i]]
    if pool_type == "max":
        fill = float("-inf") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        xp = F.pad(x, flat, value=fill)
        out = _window_reduce(xp, kernel, stride, "max")
    elif pool_type in ("avg", "sum"):
        xp = F.pad(x, flat)
        s = _window_reduce(xp, kernel, stride, "sum")
        if pool_type == "sum":
            out = s
        elif count_include_pad:
            out = s / float(np.prod(kernel))
        else:
            ones = F.pad(torch.ones_like(x), flat)
            out = s / _window_reduce(ones, kernel, stride, "sum")
    elif pool_type == "lp":
        xp = F.pad(x, flat)
        out = torch.sqrt(_window_reduce(xp * xp, kernel, stride, "sum"))
    else:
        raise ValueError("unknown pool_type %r" % (pool_type,))
    return out.movedim(1, -1) if last else out


def _window_reduce(x, kernel, stride, op):
    """Max or sum over windows of the spatial dims (no padding)."""
    y = x
    for i, (k, s) in enumerate(zip(kernel, stride)):
        y = y.unfold(2 + i, k, s)
    dims = tuple(range(x.dim(), y.dim()))
    return y.amax(dim=dims) if op == "max" else y.sum(dim=dims)


def adaptive_avg_pool2d(x, output_size):
    """contrib AdaptiveAvgPooling2D (integer bucketing of the reference)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    return F.adaptive_avg_pool2d(x, output_size)


# ---------------------------------------------------------------------------
# normalisation (batch_norm.cc, group_norm.cc, instance_norm.cc,
# l2_normalization.cc, lrn.cc)
# ---------------------------------------------------------------------------
def _bshape(x, axis, n):
    shape = [1] * x.dim()
    shape[axis] = n
    return shape


def batch_norm_train(x, gamma, beta, running_mean, running_var,
                     momentum=0.9, eps=1e-5, axis=1, fix_gamma=False):
    """(out, new running mean, new running var) from the batch's
    statistics (biased variance, fp32)."""
    axis = axis % x.dim()
    axes = tuple(i for i in range(x.dim()) if i != axis)
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, correction=0)
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    shape = _bshape(x, axis, x.shape[axis])
    out = (xf - mean.reshape(shape)) * torch.rsqrt(var + eps).reshape(shape)
    out = out * gamma.reshape(shape) + beta.reshape(shape)
    new_mean = momentum * running_mean + (1 - momentum) * mean
    new_var = momentum * running_var + (1 - momentum) * var
    return (out.to(x.dtype), new_mean.to(running_mean.dtype),
            new_var.to(running_var.dtype))


def batch_norm_inference(x, gamma, beta, running_mean, running_var,
                         eps=1e-5, axis=1, fix_gamma=False):
    axis = axis % x.dim()
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    shape = _bshape(x, axis, x.shape[axis])
    inv = torch.rsqrt(running_var.float() + eps)
    scale = (gamma * inv).reshape(shape)
    shift = (beta - running_mean * gamma * inv).reshape(shape)
    return (x * scale + shift).to(x.dtype)


def group_norm(x, gamma, beta, num_groups, eps=1e-5):
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    xg = xg.float()
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, correction=0, keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = _bshape(x, 1, c)
    return (out * gamma.reshape(shape) + beta.reshape(shape)).to(x.dtype)


def instance_norm(x, gamma, beta, eps=1e-5):
    axes = tuple(range(2, x.dim()))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = xf.var(dim=axes, correction=0, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    shape = _bshape(x, 1, x.shape[1])
    return (out * gamma.reshape(shape) + beta.reshape(shape)).to(x.dtype)


def l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, x.dim()))
    else:
        raise ValueError(mode)
    return x / torch.sqrt((x * x).sum(dim=axes, keepdim=True) + eps)


def lrn(x, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response norm across channels (src/operator/nn/lrn.cc)."""
    half = nsize // 2
    sq = (x * x).movedim(1, -1)
    sq = F.pad(sq, (half, half))
    ssum = sq.unfold(-1, nsize, 1).sum(-1).movedim(-1, 1)
    return x / torch.pow(knorm + alpha * ssum / nsize, beta)


# ---------------------------------------------------------------------------
# indexing (src/operator/tensor/indexing_op.h)
# ---------------------------------------------------------------------------
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    from ..ndarray import torch_dtype
    oh = F.one_hot(indices.long().clamp_min(0), depth) * (indices.long()
                                                            >= 0).unsqueeze(-1)
    oh = oh.to(torch_dtype(dtype))
    return oh * (on_value - off_value) + off_value


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    from ..ndarray import torch_dtype
    axis = axis % data.dim()
    moved = data.movedim(axis, -1)
    # ties go to the lower index, as lax.top_k takes them
    order = torch.sort(moved, dim=-1, descending=not is_ascend,
                       stable=True)[1][..., :k]
    vals = torch.gather(moved, -1, order)
    dt = torch_dtype(dtype)
    if ret_typ == "indices":
        return order.movedim(-1, axis).to(dt)
    if ret_typ == "value":
        return vals.movedim(-1, axis)
    if ret_typ == "both":
        return vals.movedim(-1, axis), order.movedim(-1, axis).to(dt)
    if ret_typ == "mask":
        mask = torch.zeros_like(moved, dtype=dt).scatter(
            -1, order, torch.ones_like(order, dtype=dt))
        return mask.movedim(-1, axis)
    raise ValueError(ret_typ)


def gather_nd(data, indices):
    idx = tuple(indices.long())
    return data[idx]


def scatter_nd(data, indices, shape):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    idx = tuple(indices.long())
    return out.index_put(idx, data)


# ---------------------------------------------------------------------------
# sequence ops (src/operator/sequence_*.cc): data (L, B, ...) at axis 0 or
# (B, L, ...) at axis 1
# ---------------------------------------------------------------------------
def _seq_mask(data, sequence_length, axis):
    L = data.shape[axis]
    batch_axis = 1 - axis
    idx = torch.arange(L, device=data.device).reshape(
        _bshape(data, axis, L))
    lens = sequence_length.long().reshape(
        _bshape(data, batch_axis, data.shape[batch_axis]))
    return idx < lens


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    return torch.where(_seq_mask(data, sequence_length, axis), data,
                       float(value)).to(data.dtype)


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    moved = data.movedim(axis, 0)                  # (L, B, ...)
    last = (sequence_length.long() - 1).clamp(0, moved.shape[0] - 1)
    b = torch.arange(moved.shape[1], device=data.device)
    return moved[last, b]


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.flip(axis)
    moved = data.movedim(axis, 0)                  # (L, B, ...)
    L = moved.shape[0]
    idx = torch.arange(L, device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    src = torch.where(idx < lens, lens - 1 - idx, idx)     # (L, B)
    b = torch.arange(moved.shape[1], device=data.device)[None, :]
    return moved[src, b].movedim(0, axis)


# ---------------------------------------------------------------------------
# losses and checks
# ---------------------------------------------------------------------------
def ctc_loss(data, label, data_lengths=None, label_lengths=None, blank=0):
    """CTC loss per batch row (src/operator/nn/ctc_loss.cc): data (T, B, V)
    logits, label (B, Lmax) padded with -1 or the blank."""
    T, B, _ = data.shape
    logp = torch.log_softmax(data.float(), dim=-1)
    if data_lengths is None:
        data_lengths = torch.full((B,), T, dtype=torch.long,
                                  device=data.device)
    if label_lengths is None:
        label_lengths = ((label != -1) & (label != blank)).sum(-1)
    lab = label.long().clamp_min(0)
    return F.ctc_loss(logp, lab, data_lengths.long(), label_lengths.long(),
                      blank=blank, reduction="none", zero_infinity=False)


def all_finite(arrays):
    """all_finite / multi_all_finite (src/operator/all_finite.cc)."""
    ok = None
    for a in arrays:
        f = torch.isfinite(a).all()
        ok = f if ok is None else ok & f
    return ok if ok is not None else torch.tensor(True)


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
