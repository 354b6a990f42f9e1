"""Convolution and pooling layers (the port of
``mxnet_tpu/gluon/nn/conv_layers.py``; parity: reference
``python/mxnet/gluon/nn/conv_layers.py`` Conv1-3D :182-348,
Conv1-3DTranspose :433-616, Max/AvgPool1-3D :745-990, GlobalMax/AvgPool1-3D
:1043-1179, ReflectionPad2D :1207, PixelShuffle1-3D :1634-1748,
DeformableConvolution :1246).

Convolutions are ``npx.convolution``/``deconvolution``'s torch code
(cuDNN on the card, as the JAX package uses XLA's convolution); pools are
``npx.pooling``'s (``ceil_mode`` is the ``full`` convention,
``count_include_pad`` as in the reference).  The deformable convolutions
sample bilinearly and contract in plain PyTorch, a copy of the JAX
package's ``contrib.ops.deformable_convolution`` and
``modulated_deformable_convolution`` (the rest of ``contrib/ops.py``
waits for ROADMAP item 9).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops import nn as _ops
from ..block import _Layer, eager_init
from ..parameter import Parameter
from .basic_layers import _init_of, _zeros_init

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "DeformableConvolution", "ModulatedDeformableConvolution"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(_Layer):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 op_name="convolution", adj=None, dtype="float32",
                 device=None):
        super().__init__()
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._stride = strides
        self._pad = padding
        self._dilate = dilation
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self._op_name = op_name
        self._adj = adj
        if op_name == "convolution":
            wshape = (channels, in_channels // groups if in_channels
                      else 0) + kernel_size
        else:             # deconvolution: (in_channels, channels/groups, *k)
            wshape = (in_channels if in_channels else 0,
                      channels // groups) + kernel_size
        self.weight = Parameter("weight", shape=wshape, dtype=dtype,
                                init=_init_of(weight_initializer),
                                allow_deferred_init=True)
        self.bias = (Parameter("bias", shape=(channels,), dtype=dtype,
                               init=_zeros_init(bias_initializer),
                               allow_deferred_init=True)
                     if use_bias else None)
        eager_init(self, device)

    def infer_shape(self, x, *args):
        c_axis = 1 if self._layout.startswith("NC") else -1
        in_c = x.shape[c_axis]
        if self._op_name == "convolution":
            self.weight.shape_and_init(
                (self._channels, in_c // self._groups) + self._kernel)
        else:
            self.weight.shape_and_init(
                (in_c, self._channels // self._groups) + self._kernel)
        if self.bias is not None:
            self.bias.shape_and_init((self._channels,))

    def _forward(self, training, x):
        w = self.weight._var
        if w is None:
            self.infer_shape(x)
            w = self.weight._var
        b = self.bias._var if self.bias is not None else None
        if self._op_name == "convolution":
            out = _ops.convolution(
                x, w, b, kernel=self._kernel, stride=self._stride,
                dilate=self._dilate, pad=self._pad, num_filter=self._channels,
                num_group=self._groups, no_bias=b is None,
                layout=self._layout)
        else:
            out = _ops.deconvolution(
                x, w, b, kernel=self._kernel, stride=self._stride,
                dilate=self._dilate, pad=self._pad, adj=self._adj,
                num_filter=self._channels, num_group=self._groups,
                no_bias=b is None, layout=self._layout)
        if self._activation:
            out = _ops.activation(out, self._activation)
        return out

    def extra_repr(self):
        return "%s, kernel=%s, stride=%s, pad=%s" % (
            self._channels, self._kernel, self._stride, self._pad)


def _conv_class(name, nd, layout, transpose):
    one = 1 if nd == 1 else (1,) * nd
    zero = 0 if nd == 1 else (0,) * nd

    if transpose:
        def __init__(self, channels, kernel_size, strides=one, padding=zero,
                     output_padding=zero, dilation=one, groups=1,
                     layout=layout, activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kw):
            _Conv.__init__(self, channels, _tup(kernel_size, nd),
                           _tup(strides, nd), _tup(padding, nd),
                           _tup(dilation, nd), groups, layout, in_channels,
                           activation, use_bias, weight_initializer,
                           bias_initializer, op_name="deconvolution",
                           adj=_tup(output_padding, nd), **kw)
    else:
        def __init__(self, channels, kernel_size, strides=one, padding=zero,
                     dilation=one, groups=1, layout=layout, activation=None,
                     use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, **kw):
            _Conv.__init__(self, channels, _tup(kernel_size, nd),
                           _tup(strides, nd), _tup(padding, nd),
                           _tup(dilation, nd), groups, layout, in_channels,
                           activation, use_bias, weight_initializer,
                           bias_initializer, **kw)
    return type(name, (_Conv,), {"__init__": __init__,
                                 "__module__": __name__})


Conv1D = _conv_class("Conv1D", 1, "NCW", False)
Conv2D = _conv_class("Conv2D", 2, "NCHW", False)
Conv3D = _conv_class("Conv3D", 3, "NCDHW", False)
Conv1DTranspose = _conv_class("Conv1DTranspose", 1, "NCW", True)
Conv2DTranspose = _conv_class("Conv2DTranspose", 2, "NCHW", True)
Conv3DTranspose = _conv_class("Conv3DTranspose", 3, "NCDHW", True)


class _Pool(_Layer):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=True):
        super().__init__()
        self._kernel = pool_size
        self._stride = strides if strides is not None else pool_size
        self._pad = padding
        self._pool_type = pool_type
        self._global_pool = global_pool
        self._convention = "full" if ceil_mode else "valid"
        self._layout = layout
        self._count_include_pad = count_include_pad

    def _forward(self, training, x):
        return _ops.pooling(
            x, kernel=self._kernel, pool_type=self._pool_type,
            stride=self._stride, pad=self._pad, global_pool=self._global_pool,
            pooling_convention=self._convention,
            count_include_pad=self._count_include_pad, layout=self._layout)

    def extra_repr(self):
        return "size=%s, stride=%s, padding=%s" % (self._kernel, self._stride,
                                                   self._pad)


def _pool_class(name, nd, layout, pool_type):
    size = 2 if nd == 1 else (2,) * nd

    if pool_type == "max":
        def __init__(self, pool_size=size, strides=None, padding=0,
                     layout=layout, ceil_mode=False, **kw):
            _Pool.__init__(self, _tup(pool_size, nd),
                           _tup(strides, nd) if strides is not None else None,
                           _tup(padding, nd), ceil_mode, False, "max", layout)
    else:
        def __init__(self, pool_size=size, strides=None, padding=0,
                     layout=layout, ceil_mode=False, count_include_pad=True,
                     **kw):
            _Pool.__init__(self, _tup(pool_size, nd),
                           _tup(strides, nd) if strides is not None else None,
                           _tup(padding, nd), ceil_mode, False, "avg", layout,
                           count_include_pad)
    return type(name, (_Pool,), {"__init__": __init__,
                                 "__module__": __name__})


def _global_pool_class(name, nd, layout, pool_type):
    def __init__(self, layout=layout, **kw):
        _Pool.__init__(self, (1,) * nd, None, (0,) * nd, False, True,
                       pool_type, layout)
    return type(name, (_Pool,), {"__init__": __init__,
                                 "__module__": __name__})


MaxPool1D = _pool_class("MaxPool1D", 1, "NCW", "max")
MaxPool2D = _pool_class("MaxPool2D", 2, "NCHW", "max")
MaxPool3D = _pool_class("MaxPool3D", 3, "NCDHW", "max")
AvgPool1D = _pool_class("AvgPool1D", 1, "NCW", "avg")
AvgPool2D = _pool_class("AvgPool2D", 2, "NCHW", "avg")
AvgPool3D = _pool_class("AvgPool3D", 3, "NCDHW", "avg")
GlobalMaxPool1D = _global_pool_class("GlobalMaxPool1D", 1, "NCW", "max")
GlobalMaxPool2D = _global_pool_class("GlobalMaxPool2D", 2, "NCHW", "max")
GlobalMaxPool3D = _global_pool_class("GlobalMaxPool3D", 3, "NCDHW", "max")
GlobalAvgPool1D = _global_pool_class("GlobalAvgPool1D", 1, "NCW", "avg")
GlobalAvgPool2D = _global_pool_class("GlobalAvgPool2D", 2, "NCHW", "avg")
GlobalAvgPool3D = _global_pool_class("GlobalAvgPool3D", 3, "NCDHW", "avg")


class ReflectionPad2D(_Layer):
    """Reflection padding of an NCHW tensor's H and W; ``padding`` an int,
    or 8 numbers (before, after) per axis, N and C 0."""

    def __init__(self, padding=0):
        super().__init__()
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        if any(padding[:4]):
            raise ValueError("ReflectionPad2D pads H and W only")
        self._padding = tuple(padding)

    def _forward(self, training, x):
        p = self._padding
        return F.pad(x, (p[6], p[7], p[4], p[5]), mode="reflect")


class _PixelShuffle(_Layer):
    def __init__(self, factor, ndim):
        super().__init__()
        self._factor = _tup(factor, ndim)

    def extra_repr(self):
        return "factor=%s" % (self._factor,)


class PixelShuffle1D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 1)

    def _forward(self, training, x):
        f = self._factor[0]
        n, c, w = x.shape
        x = x.reshape(n, c // f, f, w).permute(0, 1, 3, 2)
        return x.reshape(n, c // f, w * f)


class PixelShuffle2D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 2)

    def _forward(self, training, x):
        f1, f2 = self._factor
        n, c, h, w = x.shape
        x = x.reshape(n, c // (f1 * f2), f1, f2, h, w)
        x = x.permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (f1 * f2), h * f1, w * f2)


class PixelShuffle3D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 3)

    def _forward(self, training, x):
        f1, f2, f3 = self._factor
        n, c, d, h, w = x.shape
        x = x.reshape(n, c // (f1 * f2 * f3), f1, f2, f3, d, h, w)
        x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
        return x.reshape(n, c // (f1 * f2 * f3), d * f1, h * f2, w * f3)


# ---------------------------------------------------------------------------
# deformable convolution (copied from mxnet_tpu/contrib/ops.py:620-737)
# ---------------------------------------------------------------------------
def _deform_sample(x, ys, xs):
    """Bilinear samples of x (C, H, W) at float coordinates ys/xs (K, Ho,
    Wo), zero outside: (C, K, Ho, Wo)."""
    H, W = x.shape[-2:]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        v = x[:, yc, xc]
        return torch.where(inb[None], v, torch.zeros((), dtype=v.dtype,
                                                     device=v.device))

    return (tap(y0, x0) * ((1 - wy) * (1 - wx))[None]
            + tap(y0, x0 + 1) * ((1 - wy) * wx)[None]
            + tap(y0 + 1, x0) * (wy * (1 - wx))[None]
            + tap(y0 + 1, x0 + 1) * (wy * wx)[None])


def _deformable_conv(x, offset, weight, bias, mask, kernel, stride, pad,
                     dilate, num_deformable_group):
    """x (N, C, H, W); offset (N, 2 G K, Ho, Wo); mask (N, G K, Ho, Wo) or
    None; weight (O, C, kh, kw): the deformable im2col, then one
    contraction with the weight."""
    N, C, H, W = x.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    K = kh * kw
    G = num_deformable_group
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dev = x.device
    base_y = (torch.arange(Ho, device=dev) * sh - ph)[:, None].to(x.dtype)
    base_x = (torch.arange(Wo, device=dev) * sw - pw)[None, :].to(x.dtype)
    ky = (torch.arange(kh, device=dev) * dh)[:, None].repeat(1, kw) \
        .reshape(K).to(x.dtype)
    kx = (torch.arange(kw, device=dev) * dw)[None, :].repeat(kh, 1) \
        .reshape(K).to(x.dtype)
    off = offset.reshape(N, G, K, 2, Ho, Wo)
    m = None if mask is None else mask.reshape(N, G, K, Ho, Wo)
    cpg = C // G
    images = []
    for n in range(N):
        cols = []
        for g in range(G):
            ys = base_y[None] + ky[:, None, None] + off[n, g, :, 0]
            xs = base_x[None] + kx[:, None, None] + off[n, g, :, 1]
            sampled = _deform_sample(x[n, g * cpg:(g + 1) * cpg], ys, xs)
            if m is not None:
                sampled = sampled * m[n, g][None]
            cols.append(sampled)
        images.append(torch.cat(cols, dim=0))
    cols = torch.stack(images)                             # (N, C, K, Ho, Wo)
    wmat = weight.reshape(weight.shape[0], C, K)
    out = torch.einsum("ock,nckhw->nohw", wmat, cols)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformableConvolution(_Layer):
    """2-D deformable convolution v1 (reference conv_layers.py:1246): the
    sampling offsets come from an inner convolution, zero at first, so
    training starts on the regular grid."""

    def __init__(self, channels, kernel_size=(1, 1), strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1,
                 num_deformable_group=1, layout="NCHW", use_bias=True,
                 in_channels=0, activation=None, weight_initializer=None,
                 bias_initializer="zeros",
                 offset_weight_initializer="zeros",
                 offset_bias_initializer="zeros", offset_use_bias=True,
                 modulated=False):
        super().__init__()
        if layout != "NCHW":
            raise ValueError("deformable convolution supports NCHW")
        if groups != 1:
            raise ValueError("deformable convolution supports groups=1")
        k = _tup(kernel_size, 2)
        K = k[0] * k[1]
        self._modulated = modulated
        n_offset = num_deformable_group * (3 if modulated else 2) * K
        self._kernel = k
        self._stride = _tup(strides, 2)
        self._pad = _tup(padding, 2)
        self._dilate = _tup(dilation, 2)
        self._channels = channels
        self._ndg = num_deformable_group
        self._activation = activation
        self.offset_conv = Conv2D(
            n_offset, kernel_size=k, strides=self._stride,
            padding=self._pad, dilation=self._dilate,
            use_bias=offset_use_bias, in_channels=in_channels,
            weight_initializer=_zeros_init(offset_weight_initializer),
            bias_initializer=offset_bias_initializer)
        self.weight = Parameter("weight", shape=(channels, in_channels) + k,
                                init=_init_of(weight_initializer),
                                allow_deferred_init=True)
        self.bias = (Parameter("bias", shape=(channels,),
                               init=_zeros_init(bias_initializer))
                     if use_bias else None)

    def infer_shape(self, x, *args):
        self.weight.shape_and_init((self._channels, x.shape[1])
                                   + self._kernel)

    def _forward(self, training, x):
        if self.weight._var is None:
            self.infer_shape(x)
        off_all = self.offset_conv(x)
        K = self._kernel[0] * self._kernel[1]
        b = self.bias._var if self.bias is not None else None
        args = (self._kernel, self._stride, self._pad, self._dilate,
                self._ndg)
        if self._modulated:
            n_off = self._ndg * 2 * K
            mask = torch.sigmoid(off_all[:, n_off:])
            out = _deformable_conv(x, off_all[:, :n_off], self.weight._var,
                                   b, mask, *args)
        else:
            out = _deformable_conv(x, off_all, self.weight._var, b, None,
                                   *args)
        if self._activation:
            out = _ops.activation(out, self._activation)
        return out


class ModulatedDeformableConvolution(DeformableConvolution):
    """Deformable convolution v2: a learned modulation per sampling tap."""

    def __init__(self, *args, **kwargs):
        kwargs["modulated"] = True
        super().__init__(*args, **kwargs)

