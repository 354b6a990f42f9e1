"""mx.npx: the NumPy-extension ops, the NN ops Gluon layers call (the port
of ``mxnet_tpu/numpy_extension/__init__.py``; parity: reference
``python/mxnet/ndarray/numpy_extension/_op.py``, ``src/operator/nn/``).

Thin recording wrappers (``apply_op``) over ``ops/nn.py``,
``ops/attention.py`` and ``ops/rnn.py``.  Four of them route to the
hand-written kernels (the CUDA or Triton kernel for a tensor on the card,
its plain version for one on the CPU), their gradients through the
kernels' own ``torch.autograd.Function``s:

- ``bias_gelu`` -> ``ops/kernels/epilogue.bias_gelu`` (#1, #2);
- ``bias_dropout_residual`` -> ``epilogue.bias_dropout_residual`` (#3,
  #4);
- ``flash_attention`` -> ``ops/attention.flash_attention`` (#5, the
  delta kernel, #6, #7);
- ``rnn`` -> ``ops/rnn.rnn`` (the LSTM time loop #10, #11).

Training mode is ``autograd.is_training()``, as in the JAX package:
``dropout`` returns its input itself outside training (or at p 0), and
the rates of the fused epilogue and of attention dropout are 0 there.
``dropout`` draws its mask from a generator built on the data's device
(``_rng.generator``); the hash-dropout kernels take a seed from
``_rng.hash_seed_tensor`` (the next uint32 of the global sequence, copied
to the device without a host wait), so their masks are the same on the
CPU and on the card for one ``mx.random.seed``.  Under an AMP op scope
(``amp.op_scope``) the ops of the scope's list cast their operands, as
``_amp_cast1``/``_amp_cast2`` do in the JAX package.

The JAX package's symbolic dispatch (``mx.sym`` nodes through these
names) waits for ``sym_api.py`` (ROADMAP item 9).
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .. import autograd
from .. import _rng
from ..ndarray import (ndarray, apply_op, array, _unwrap, _wrap,  # noqa
                       torch_dtype)
from ..ops import nn as _nn
from ..ops import rnn as _rnn
from ..ops import attention as _att
from ..ops.kernels import epilogue as _epilogue
from ..util import set_np, reset_np, is_np_array, is_np_shape  # noqa: F401

next_key = _rng.next_seed


def waitall():
    """Full sync point (every device), as ``mx.waitall``."""
    from ..ndarray import waitall as _w
    _w()


__all__ = [
    "activation", "relu", "sigmoid", "leaky_relu", "gelu", "softmax",
    "log_softmax", "masked_softmax", "masked_log_softmax", "fully_connected",
    "convolution", "deconvolution", "pooling", "batch_norm", "layer_norm",
    "group_norm", "instance_norm", "l2_normalization", "lrn", "dropout",
    "embedding", "one_hot", "topk", "pick", "gather_nd", "scatter_nd",
    "sequence_mask", "sequence_last", "sequence_reverse", "rnn", "ctc_loss",
    "batch_dot", "arange_like", "reshape_like", "broadcast_like",
    "smooth_l1", "multibox_prior", "interleaved_matmul_selfatt_qk",
    "interleaved_matmul_selfatt_valatt", "interleaved_matmul_encdec_qk",
    "interleaved_matmul_encdec_valatt", "flash_attention", "save", "load",
    "savez", "set_np", "reset_np", "waitall", "all_finite",
    "bias_gelu", "bias_dropout_residual",
]


def _training():
    return autograd.is_training()


# -- activations ------------------------------------------------------------
def activation(data, act_type="relu", **kw):
    return apply_op(lambda x: _nn.activation(x, act_type), data)


def relu(data, **kw):
    return apply_op(torch.relu, data)


def sigmoid(data, **kw):
    return apply_op(torch.sigmoid, data)


def gelu(data, approximate=False, **kw):
    return apply_op(lambda x: torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none"), data)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **kw):
    """LeakyReLU family (src/operator/leaky_relu.cc): leaky/prelu/elu/selu/
    gelu/rrelu."""
    if act_type == "leaky":
        return apply_op(lambda x: _nn.leaky_relu(x, slope), data)
    if act_type == "prelu":
        return apply_op(_nn.prelu, data, gamma)
    if act_type == "elu":
        return apply_op(lambda x: _nn.elu(x, slope), data)
    if act_type == "selu":
        return apply_op(_nn.selu, data)
    if act_type == "gelu":
        return apply_op(torch.nn.functional.gelu, data)
    if act_type == "rrelu":
        if _training():
            gen = _rng.generator(data.ctx)
            lo, hi = lower_bound, upper_bound

            def f(x):
                a = torch.rand(x.shape, generator=gen, device=x.device) * (
                    hi - lo) + lo
                return torch.where(x >= 0, x, a.to(x.dtype) * x)

            return apply_op(f, data)
        s = (lower_bound + upper_bound) / 2
        return apply_op(lambda x: _nn.leaky_relu(x, s), data)
    raise ValueError(act_type)


# -- softmax family ---------------------------------------------------------
def softmax(data, length=None, axis=-1, temperature=None, use_length=False,
            dtype=None, **kw):
    if use_length and length is not None:
        return apply_op(lambda x, ln: _nn.softmax(
            x, axis=axis, temperature=temperature, length=ln,
            use_length=True), data, length)
    return apply_op(lambda x: _nn.softmax(x, axis=axis,
                                          temperature=temperature), data)


def log_softmax(data, axis=-1, temperature=None, dtype=None, **kw):
    return apply_op(lambda x: _nn.log_softmax(x, axis=axis,
                                              temperature=temperature), data)


def masked_softmax(data, mask, axis=-1, temperature=1.0, **kw):
    return apply_op(lambda x, m: _nn.masked_softmax(
        x, m.to(torch.bool), axis, temperature), data, mask)


def masked_log_softmax(data, mask, axis=-1, temperature=1.0, **kw):
    return apply_op(lambda x, m: _nn.masked_log_softmax(
        x, m.to(torch.bool), axis, temperature), data, mask)


def softmin(data, axis=-1, **kw):
    return apply_op(lambda x: _nn.softmin(x, axis=axis), data)


# -- dense / conv / pool ----------------------------------------------------
def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kw):
    if bias is None or no_bias:
        return apply_op(lambda a, w: _nn.fully_connected(
            a, w, None, no_bias=True, flatten=flatten), x, weight)
    return apply_op(lambda a, w, b: _nn.fully_connected(
        a, w, b, flatten=flatten), x, weight, bias)


def convolution(data=None, weight=None, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **kw):
    args = dict(kernel=kernel, stride=stride, dilate=dilate, pad=pad,
                num_filter=num_filter, num_group=num_group, layout=layout)
    if bias is None or no_bias:
        return apply_op(lambda x, w: _nn.convolution(
            x, w, None, no_bias=True, **args), data, weight)
    return apply_op(lambda x, w, b: _nn.convolution(x, w, b, **args),
                    data, weight, bias)


def deconvolution(data=None, weight=None, bias=None, kernel=None,
                  stride=None, dilate=None, pad=None, adj=None,
                  num_filter=None, num_group=1, no_bias=False, layout=None,
                  target_shape=None, **kw):
    args = dict(kernel=kernel, stride=stride, dilate=dilate, pad=pad,
                adj=adj, num_filter=num_filter, num_group=num_group,
                layout=layout, target_shape=target_shape)
    if bias is None or no_bias:
        return apply_op(lambda x, w: _nn.deconvolution(
            x, w, None, no_bias=True, **args), data, weight)
    return apply_op(lambda x, w, b: _nn.deconvolution(x, w, b, **args),
                    data, weight, bias)


def pooling(data, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, layout=None, **kw):
    return apply_op(lambda x: _nn.pooling(
        x, kernel=kernel, pool_type=pool_type, stride=stride, pad=pad,
        global_pool=global_pool, pooling_convention=pooling_convention,
        count_include_pad=count_include_pad, layout=layout), data)


# -- normalisation ----------------------------------------------------------
def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, **kw):
    """BatchNorm with the reference's semantics: in training (autograd's
    train mode) the batch's statistics, and the running statistics are
    rebound to their new values; otherwise the running statistics."""
    if _training() and not use_global_stats:
        out, nm, nv = apply_op(
            lambda xx, g, b, rm, rv: _nn.batch_norm_train(
                xx, g, b, rm.detach(), rv.detach(), momentum=momentum,
                eps=eps, axis=axis, fix_gamma=fix_gamma),
            x, gamma, beta, running_mean, running_var)
        running_mean._set_data(nm._data.detach())
        running_var._set_data(nv._data.detach())
        return out
    return apply_op(lambda xx, g, b, rm, rv: _nn.batch_norm_inference(
        xx, g, b, rm, rv, eps=eps, axis=axis, fix_gamma=fix_gamma),
        x, gamma, beta, running_mean, running_var)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, **kw):
    return apply_op(lambda x, g, b: _nn.layer_norm(x, g, b, axis, eps),
                    data, gamma, beta)


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5, **kw):
    return apply_op(lambda x, g, b: _nn.group_norm(x, g, b, num_groups, eps),
                    data, gamma, beta)


def instance_norm(data, gamma, beta, eps=1e-5, **kw):
    return apply_op(lambda x, g, b: _nn.instance_norm(x, g, b, eps),
                    data, gamma, beta)


def l2_normalization(data, eps=1e-10, mode="instance", **kw):
    return apply_op(lambda x: _nn.l2_normalization(x, eps, mode), data)


def lrn(data, nsize=5, alpha=1e-4, beta=0.75, knorm=2.0, **kw):
    return apply_op(lambda x: _nn.lrn(x, nsize, alpha, beta, knorm), data)


# -- the fused epilogues (kernels #1-#4) -------------------------------------
def bias_gelu(data, bias, **kw):
    """gelu(data + bias), exact erf, forward and backward in the fused
    kernels (#1 and #2 on the card)."""
    return apply_op(_nn.bias_gelu, data, bias)


def bias_dropout_residual(data, bias, residual, p=0.0, mode="training",
                          **kw):
    """residual + dropout(data + bias) in the fused kernels (#3 and #4 on
    the card).  Dropout as ``dropout``'s: active in training (or
    ``mode="always"``), scaled by 1/(1-p); the hash mask of a seed from
    ``_rng.hash_seed_tensor`` is rebuilt by the backward."""
    rate = float(p) if (_training() or mode == "always") else 0.0
    seed = _rng.hash_seed_tensor(data.ctx) if rate else None

    def f(x, b, r):
        x, b = _nn._amp_cast2("bias_dropout_residual", x, b)
        r = _nn._amp_cast1("bias_dropout_residual", r)
        return _epilogue.bias_dropout_residual(x, b, r, rate=rate, seed=seed)

    return apply_op(f, data, bias, residual)


# -- dropout ----------------------------------------------------------------
def dropout(data, p=0.5, mode="training", axes=None, cudnn_off=False, **kw):
    """Inverted dropout in training (or ``mode="always"``); ``data``
    itself otherwise, or at p 0."""
    if not _training() and mode != "always":
        return data
    if p <= 0:
        return data
    gen = _rng.generator(data.ctx)
    return apply_op(lambda x: _nn.dropout(x, p, True, gen, axes), data)


# -- indexing / embedding ---------------------------------------------------
def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False, **kw):
    return apply_op(_nn.embedding, data, weight)


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32", **kw):
    return apply_op(lambda d: _nn.one_hot(d, depth, on_value, off_value,
                                          dtype), data)


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32", **kw):
    return apply_op(lambda x: _nn.topk(x, axis, k, ret_typ, is_ascend,
                                       dtype), data)


def pick(data, index, axis=-1, keepdims=False, mode="clip", **kw):
    return apply_op(lambda d, i: _nn.pick(d, i, axis, keepdims, mode), data,
                    index)


def gather_nd(data, indices, **kw):
    return apply_op(_nn.gather_nd, data, indices)


def scatter_nd(data, indices, shape, **kw):
    return apply_op(lambda d, i: _nn.scatter_nd(d, i, shape), data, indices)


# -- sequence ops -----------------------------------------------------------
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0, **kw):
    if sequence_length is None:
        return apply_op(lambda d: _nn.sequence_mask(d, None, False, value,
                                                    axis), data)
    return apply_op(lambda d, ln: _nn.sequence_mask(
        d, ln, use_sequence_length, value, axis), data, sequence_length)


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0, **kw):
    if sequence_length is None:
        return apply_op(lambda d: _nn.sequence_last(d, None, False, axis),
                        data)
    return apply_op(lambda d, ln: _nn.sequence_last(
        d, ln, use_sequence_length, axis), data, sequence_length)


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0, **kw):
    if sequence_length is None:
        return apply_op(lambda d: _nn.sequence_reverse(d, None, False, axis),
                        data)
    return apply_op(lambda d, ln: _nn.sequence_reverse(
        d, ln, use_sequence_length, axis), data, sequence_length)


# -- fused RNN (kernels #10, #11 for the forward LSTM layers) ---------------
def rnn(data=None, parameters=None, state=None, state_cell=None, mode="lstm",
        state_size=None, num_layers=1, bidirectional=False, p=0.0,
        state_outputs=True, use_sequence_length=False, sequence_length=None,
        **kw):
    """Fused stacked RNN (parity: npx.rnn -> src/operator/rnn.cc).  data
    (T, B, I); parameters the flat vector; state (L*D, B, H).  Each
    forward LSTM layer's time loop is one launch of #10 forward and #11
    backward on the card."""
    training = _training()
    gen = _rng.generator(data.ctx) if (p > 0 and training) else None

    def f(x, params, h0, *c0):
        return _rnn.rnn(x, params, h0, c0[0] if c0 else None, mode=mode,
                        state_size=state_size, num_layers=num_layers,
                        bidirectional=bidirectional, p=p, training=training,
                        generator=gen)

    if mode == "lstm":
        res = apply_op(f, data, parameters, state, state_cell)
    else:
        res = apply_op(f, data, parameters, state)
    return tuple(res) if state_outputs else res[0]


# -- attention --------------------------------------------------------------
def _interleaved_qk(x, heads):
    L, B, E = x.shape
    d = E // heads // 3
    x = x.reshape(L, B, heads, 3, d)
    q, k = x[:, :, :, 0], x[:, :, :, 1]
    att = torch.einsum("lbhd,mbhd->bhlm", q * (1.0 / math.sqrt(d)), k)
    return att.reshape(B * heads, L, L)


def _interleaved_valatt(x, att, heads):
    L, B, E = x.shape
    d = E // heads // 3
    v = x.reshape(L, B, heads, 3, d)[:, :, :, 2]
    out = torch.einsum("bhlm,mbhd->lbhd", att.reshape(B, heads, L, L), v)
    return out.reshape(L, B, heads * d)


def _encdec_qk(q, kv, heads):
    Lq, B, E = q.shape
    Lk = kv.shape[0]
    d = E // heads
    k = kv.reshape(Lk, B, heads, 2, d)[:, :, :, 0]
    att = torch.einsum("lbhd,mbhd->bhlm",
                       q.reshape(Lq, B, heads, d) * (1.0 / math.sqrt(d)), k)
    return att.reshape(B * heads, Lq, Lk)


def _encdec_valatt(kv, att, heads):
    Lk, B, E2 = kv.shape
    d = E2 // heads // 2
    v = kv.reshape(Lk, B, heads, 2, d)[:, :, :, 1]
    Lq = att.shape[1]
    out = torch.einsum("bhlm,mbhd->lbhd", att.reshape(B, heads, Lq, Lk), v)
    return out.reshape(Lq, B, heads * d)


def interleaved_matmul_selfatt_qk(queries_keys_values, heads, **kw):
    return apply_op(lambda x: _interleaved_qk(
        _nn._amp_cast1("interleaved_matmul_selfatt_qk", x), heads),
        queries_keys_values)


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads,
                                      **kw):
    return apply_op(lambda x, a: _interleaved_valatt(
        *_nn._amp_cast2("interleaved_matmul_selfatt_valatt", x, a), heads),
        queries_keys_values, attention)


def interleaved_matmul_encdec_qk(queries, keys_values, heads, **kw):
    return apply_op(lambda q, kv: _encdec_qk(
        *_nn._amp_cast2("interleaved_matmul_encdec_qk", q, kv), heads),
        queries, keys_values)


def interleaved_matmul_encdec_valatt(keys_values, attention, heads, **kw):
    return apply_op(lambda kv, a: _encdec_valatt(
        *_nn._amp_cast2("interleaved_matmul_encdec_valatt", kv, a), heads),
        keys_values, attention)


def flash_attention(q, k, v, causal=False, window=None, scale=None,
                    dropout=0.0, kv_length=None, **kw):
    """Fused attention: q, k, v (B, H, L, D) -> (B, H, L, D) through the
    flash kernels (#5 forward; the delta kernel, #6 and #7 backward).
    ``dropout`` drops attention probabilities in the kernels while
    training, by the hash mask of a seed from ``_rng.hash_seed_tensor``;
    ``kv_length`` (B,) is a per-sequence count of valid keys."""
    rate = float(dropout) if _training() else 0.0
    seed = _rng.hash_seed_tensor(q.ctx) if rate else None

    def f(a, b, c, *rest):
        return _att.flash_attention(a, b, c, causal=causal, window=window,
                                    scale=scale, dropout=rate, seed=seed,
                                    kv_length=rest[0] if rest else None)

    if kv_length is not None:
        return apply_op(f, q, k, v, kv_length)
    return apply_op(f, q, k, v)


def sldwin_atten(q, k, v, window, symmetric=True, **kw):
    return apply_op(lambda a, b, c: _att.sldwin_atten(a, b, c, window,
                                                      symmetric), q, k, v)


# -- misc tensor helpers ----------------------------------------------------
def batch_dot(a, b, transpose_a=False, transpose_b=False, **kw):
    return apply_op(lambda x, y: _nn.batch_dot(x, y, transpose_a,
                                               transpose_b), a, b)


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None, **kw):
    def f(x):
        n = x.numel() if axis is None else x.shape[axis]
        out = start + step * torch.arange(n, dtype=torch.float32,
                                          device=x.device)
        return out.reshape(x.shape) if axis is None else out

    return apply_op(f, data)


def reshape_like(lhs, rhs, **kw):
    return apply_op(lambda a, b: a.reshape(b.shape), lhs, rhs)


def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None, **kw):
    return apply_op(lambda a, b: torch.broadcast_to(a, b.shape), lhs, rhs)


def smooth_l1(data, scalar=1.0, **kw):
    def f(x):
        s2 = scalar * scalar
        return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                           x.abs() - 0.5 / s2)

    return apply_op(f, data)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first", **kw):
    blank = 0 if blank_label == "first" else data.shape[-1] - 1
    arrays = [data, label]
    if use_data_lengths and data_lengths is not None:
        arrays.append(data_lengths)
    if use_label_lengths and label_lengths is not None:
        arrays.append(label_lengths)

    def f(d, lab, *rest):
        i = 0
        dl = rest[i] if use_data_lengths and data_lengths is not None \
            else None
        if dl is not None:
            i += 1
        ll = rest[i] if use_label_lengths and label_lengths is not None \
            else None
        return _nn.ctc_loss(d, lab, dl, ll, blank)

    return apply_op(f, *arrays)


def all_finite(*arrays):
    return apply_op(lambda *xs: _nn.all_finite(xs), *arrays)


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=None, offsets=(0.5, 0.5), **kw):
    """SSD anchor generation (src/operator/contrib/multibox_prior.cc):
    data (B, C, H, W) -> (1, H*W*(S+R-1), 4) corner anchors."""
    steps = steps if steps else (-1.0, -1.0)

    def f(x):
        H, W = x.shape[-2], x.shape[-1]
        dev = x.device
        step_y = steps[0] if steps[0] > 0 else 1.0 / H
        step_x = steps[1] if steps[1] > 0 else 1.0 / W
        cy = (torch.arange(H, device=dev) + offsets[0]) * step_y
        cx = (torch.arange(W, device=dev) + offsets[1]) * step_x
        cyx = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), -1)
        aspect = H / W
        whs = [(s * aspect * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
               for s in sizes]
        whs += [(sizes[0] * aspect * math.sqrt(r), sizes[0] / math.sqrt(r))
                for r in ratios[1:]]
        whs = torch.tensor(whs, dtype=torch.float32, device=dev)
        cyx = cyx[:, :, None, :].expand(H, W, whs.shape[0], 2)
        w, h = whs[None, None, :, 0], whs[None, None, :, 1]
        boxes = torch.stack([cyx[..., 1] - w / 2, cyx[..., 0] - h / 2,
                             cyx[..., 1] + w / 2, cyx[..., 0] + h / 2], -1)
        boxes = boxes.reshape(1, -1, 4).float()
        return boxes.clamp(0.0, 1.0) if clip else boxes

    return apply_op(f, data)


# -- serialisation (parity: npx.save/savez/load, src/serialization/cnpy) ----
def savez(file, *args, **kwargs):
    arrays = {("arr_%d" % i): a.asnumpy() for i, a in enumerate(args)}
    arrays.update({k: v.asnumpy() for k, v in kwargs.items()})
    onp.savez(file, **arrays)


def save(file, arr):
    if isinstance(arr, dict):
        savez(file, **arr)
    elif isinstance(arr, (list, tuple)):
        savez(file, *arr)
    else:
        savez(file, arr)


def load(file, ctx=None):
    with onp.load(file, allow_pickle=False) as data:
        return {k: array(v, ctx=ctx) for k, v in data.items()}


def gamma(data, **kw):
    return apply_op(lambda x: torch.exp(torch.lgamma(x)), data)


def erf(data, **kw):
    return apply_op(torch.erf, data)


def erfinv(data, **kw):
    return apply_op(torch.erfinv, data)


def _index_tuple(indices, device):
    idx = _unwrap(indices)
    if not isinstance(idx, torch.Tensor):
        idx = torch.as_tensor(onp.asarray(idx), device=device)
    return tuple(idx.long())


def index_add(data, indices, value, **kw):
    return apply_op(lambda d, v: d.index_put(
        _index_tuple(indices, d.device), v.to(d.dtype), accumulate=True),
        data, value)


def index_update(data, indices, value, **kw):
    return apply_op(lambda d, v: d.index_put(
        _index_tuple(indices, d.device), v.to(d.dtype)), data, value)


from ..ops.control_flow import foreach, while_loop, cond  # noqa: E402,F401


def seed(seed_state):
    _rng.seed(seed_state)


def shape_array(data, **kw):
    """The shape of ``data`` as a 1-D int64 array (narrowed to int32
    unless 64-bit values are kept, as in the JAX package)."""
    return array(onp.array(data.shape, dtype="int64"), ctx=data.ctx)


def cast(data, dtype, **kw):
    return data.astype(dtype)


_pyslice = slice


def slice(data, begin, end, step=None, **kw):  # noqa: A001
    """Parity: npx.slice (src/operator/tensor/matrix_op.cc Slice)."""
    nd = data.ndim
    begin = list(begin) + [None] * (nd - len(begin))
    end = list(end) + [None] * (nd - len(end))
    step = (list(step) + [None] * (nd - len(step))) if step else [None] * nd
    key = tuple(_pyslice(b, e, s) for b, e, s in zip(begin, end, step))
    return data[key]


def slice_axis(data, axis, begin, end, **kw):
    return data.slice_axis(axis, begin, end)


def slice_like(data, shape_like, axes=None, **kw):
    tgt = shape_like.shape
    key = [_pyslice(0, tgt[ax]) if (axes is None or ax in axes)
           else _pyslice(None) for ax in range(data.ndim)]
    return data[tuple(key)]


def current_device():
    from ..context import current_context
    return current_context()


def num_gpus():
    from ..context import num_gpus as _n
    return _n()


# -- AMP cast ops (reference src/operator/tensor/amp_cast.cc) ---------------
_FLOAT_WIDTHS = {"float16": 16, "bfloat16": 16, "float32": 32,
                 "float64": 64, "torch.bfloat16": 16}


def _is_float_dtype(dtype):
    return str(dtype) in _FLOAT_WIDTHS


def amp_cast(data, dtype="float16", **kw):
    """Cast only floating inputs to ``dtype``; integer and bool arrays
    pass through (reference amp_cast.cc)."""
    td = torch_dtype(dtype)

    def f(x):
        return x.to(td) if x.is_floating_point() else x

    return apply_op(f, data)


def amp_multicast(*data, num_outputs=None, cast_narrow=False, **kw):
    """Cast a group of arrays to a common float width, the widest (the
    narrowest with ``cast_narrow``); non-float arrays pass through."""
    if num_outputs is not None and num_outputs != len(data):
        raise ValueError("num_outputs must equal len(data)")
    floats = [str(d.dtype) for d in data if _is_float_dtype(d.dtype)]
    if not floats:
        return list(data)
    pick_ = (min if cast_narrow else max)(floats,
                                          key=lambda s: _FLOAT_WIDTHS[s])
    if pick_ == "torch.bfloat16":
        pick_ = "bfloat16"
    return [amp_cast(d, pick_) if _is_float_dtype(d.dtype) else d
            for d in data]


# -- intgemm ops (reference src/operator/contrib/intgemm/*.cc) --------------
def intgemm_maxabsolute(data, **kw):
    """max(|data|), the scale probe."""
    return apply_op(lambda x: x.abs().max(), data)


def intgemm_prepare_data(data, maxabs, **kw):
    """fp32 -> int8 scaled by 127/maxabs."""
    def f(x, m):
        scale = 127.0 / torch.clamp(m, min=1e-12)
        return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)

    return apply_op(f, data, maxabs)


def intgemm_prepare_weight(weight, maxabs=None, already_quantized=False,
                           **kw):
    """Weight pre-quantisation (the reference's CPU interleave is not
    needed: prepared == quantised)."""
    if already_quantized:
        return weight
    if maxabs is None:
        maxabs = intgemm_maxabsolute(weight)
    return intgemm_prepare_data(weight, maxabs)


def intgemm_take_weight(weight, indices, **kw):
    """Row gather of a prepared weight."""
    return apply_op(lambda w, idx: w[idx.long()], weight, indices)


def intgemm_fully_connected(data, weight, scaling=None, bias=None,
                            num_hidden=None, no_bias=False,
                            out_type="float32", **kw):
    """int8 x int8 -> int32 product with an fp32 rescale."""
    def f(*args):
        x, w = args[0], args[1]
        rest = list(args[2:])
        s = rest.pop(0) if scaling is not None else None
        b = rest.pop(0) if (bias is not None and not no_bias) else None
        if x.is_cuda:
            acc = torch.matmul(x.double(), w.double().T).to(torch.int32)
        else:
            acc = torch.matmul(x.to(torch.int32), w.to(torch.int32).T)
        if out_type == "int32":
            return acc
        out = acc.float()
        if s is not None:
            out = out * s
        if b is not None:
            out = out + b
        return out

    call = [data, weight]
    if scaling is not None:
        call.append(scaling)
    if bias is not None and not no_bias:
        call.append(bias)
    return apply_op(f, *call)
