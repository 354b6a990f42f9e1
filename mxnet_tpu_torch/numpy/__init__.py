"""mx.np: the NumPy-compatible array API on torch tensors (the port of
``mxnet_tpu/numpy/__init__.py``; parity: reference
``python/mxnet/numpy/multiarray.py``).

Every function takes and returns ``ndarray``s and records for autograd
through ``apply_op``.  The JAX package lowers each name to ``jax.numpy``;
here each is written over torch ops (:data:`_IMPL`), with the JAX
package's dtypes (x64 off, ``ndarray.py``): the functions that
``jax.numpy`` promotes to an inexact type (``sqrt``, ``rint``,
``reciprocal``, ``fabs``, ``convolve``, ``polyval``, ``mean`` of ints,
...) take an integer input as float32; the rest keep it.  Python scalars
are weakly typed against the arrays they meet.  Array-like arguments
(lists, numpy arrays) are made arrays on the device of the first ndarray
argument, else on the default device (``context.resolve``).

``unique``, ``roots`` and the window functions run on the host, as the
JAX package's do.  The JAX package's symbolic dispatch (``mx.sym`` graphs
through the same names) is not carried over: ``sym_api.py`` is ROADMAP
item 9.
"""
from __future__ import annotations

import builtins
import math
import sys

import numpy as onp
import torch
import torch.nn.functional as F

from ..ndarray import (ndarray, apply_op, array, _unwrap, _wrap, _to_tensor,
                       _device_of, torch_dtype)
from .. import context as _context
from ..context import Context, current_context  # noqa: F401

from . import random  # noqa: E402  (submodule)
from . import linalg  # noqa: E402

_mod = sys.modules[__name__]

# --------------------------------------------------------------------------
# dtype constants & misc scalars
# --------------------------------------------------------------------------
float16 = onp.float16
float32 = onp.float32
float64 = onp.float64
bfloat16 = torch.bfloat16
int8 = onp.int8
int16 = onp.int16
int32 = onp.int32
int64 = onp.int64
uint8 = onp.uint8
uint16 = onp.uint16
uint32 = onp.uint32
uint64 = onp.uint64
bool_ = onp.bool_
bool = onp.bool_
intp = onp.intp
dtype = onp.dtype

pi = onp.pi
e = onp.e
euler_gamma = onp.euler_gamma
inf = onp.inf
nan = onp.nan
newaxis = None
PZERO = 0.0
NZERO = -0.0

finfo = onp.finfo
iinfo = onp.iinfo

_pyabs, _pymax, _pymin, _pyround, _pyrange = (builtins.abs, builtins.max,
                                             builtins.min, builtins.round,
                                             builtins.range)


# --------------------------------------------------------------------------
# tensor helpers
# --------------------------------------------------------------------------
def _as_tensors(args, k):
    """``args`` with its first ``k`` entries made tensors: python scalars
    weakly typed against the first tensor among them (0-dim tensors on the
    CPU), lists and numpy arrays on its device."""
    args = list(args)
    like = next((a for a in args[:k] if isinstance(a, torch.Tensor)), None)
    dev = like.device if like is not None else None
    for i in _pyrange(_pymin(k, len(args))):
        a = args[i]
        if isinstance(a, torch.Tensor) or a is None:
            continue
        if type(a) in (int, float, builtins.bool, complex) \
                and like is not None:
            # a 0-dim CPU tensor: torch takes it beside a CUDA tensor as a
            # scalar, with no host-to-device copy (which would wait for
            # the stream)
            args[i] = torch.tensor(a, dtype=torch.result_type(like, a))
        elif isinstance(a, (list, tuple)) and a and builtins.all(
                isinstance(v, torch.Tensor) for v in a):
            args[i] = torch.stack(list(a))
        else:
            args[i] = _to_tensor(a, device=dev)
    return args


def _inexact(x):
    """``x`` as ``jax.numpy`` computes an inexact-promoting function of
    it: integers and bools as float32."""
    return x if (x.is_floating_point() or x.is_complex()) else x.to(
        torch.float32)


def _promote(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _axes(axis, ndim):
    if axis is None:
        return tuple(_pyrange(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(a % ndim for a in axis) if ndim else tuple(axis)
    return (axis % ndim,) if ndim else (axis,)


def _is_int(x):
    return not (x.is_floating_point() or x.is_complex())


# --------------------------------------------------------------------------
# elementwise
# --------------------------------------------------------------------------
def _fp(fn):
    return lambda x, **kw: fn(_inexact(x), **kw)


def _keep_int(fn):
    return lambda x: x if _is_int(x) else fn(x)


def _spacing(x):
    x = _inexact(x)
    return torch.nextafter(x, torch.copysign(torch.full_like(x, math.inf),
                                             x)) - x


def _cbrt(x):
    x = _inexact(x)
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _square(x):
    return torch.square(x.to(torch.int32) if x.dtype == torch.bool else x)


def _imag(x):
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _angle(x):
    return torch.angle(_inexact(x))


def _abs(x):
    return x.clone() if x.dtype == torch.bool else torch.abs(x)


def _sign(x):
    if x.dtype == torch.bool:
        raise TypeError("sign does not accept dtype bool")
    return torch.sign(x)


_UNARY_IMPL = {
    "abs": _abs, "absolute": _abs, "sign": _sign,
    "sqrt": _fp(torch.sqrt), "cbrt": _cbrt, "square": _square,
    "exp": _fp(torch.exp), "expm1": _fp(torch.expm1), "log": _fp(torch.log),
    "log2": _fp(torch.log2), "log10": _fp(torch.log10),
    "log1p": _fp(torch.log1p), "sin": _fp(torch.sin), "cos": _fp(torch.cos),
    "tan": _fp(torch.tan), "arcsin": _fp(torch.asin),
    "arccos": _fp(torch.acos), "arctan": _fp(torch.atan),
    "sinh": _fp(torch.sinh), "cosh": _fp(torch.cosh),
    "tanh": _fp(torch.tanh), "arcsinh": _fp(torch.asinh),
    "arccosh": _fp(torch.acosh), "arctanh": _fp(torch.atanh),
    "ceil": _keep_int(torch.ceil), "floor": _keep_int(torch.floor),
    "trunc": _keep_int(torch.trunc), "rint": _fp(torch.round),
    "negative": torch.neg, "positive": lambda x: x.clone(),
    "reciprocal": _fp(torch.reciprocal), "invert": torch.bitwise_not,
    "logical_not": torch.logical_not, "isnan": torch.isnan,
    "isinf": torch.isinf, "isfinite": torch.isfinite,
    "isposinf": torch.isposinf, "isneginf": torch.isneginf,
    "degrees": _fp(torch.rad2deg), "radians": _fp(torch.deg2rad),
    "deg2rad": _fp(torch.deg2rad), "rad2deg": _fp(torch.rad2deg),
    "nan_to_num": lambda x, copy=True, nan=0.0, posinf=None, neginf=None:
        torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf),
    "real": lambda x: x.real if x.is_complex() else x.clone(),
    "imag": _imag, "angle": _angle,
    "conj": lambda x: torch.conj_physical(x) if x.is_complex() else x,
    "conjugate": lambda x: torch.conj_physical(x) if x.is_complex() else x,
    "exp2": _fp(torch.exp2), "signbit": torch.signbit,
    "i0": _fp(torch.special.i0), "sinc": _fp(torch.sinc),
    "spacing": _spacing,
}


def _fp2(fn):
    def f(a, b):
        a, b = _promote(_inexact(a), _inexact(b))
        return fn(a, b)
    return f


def _heaviside(a, b):
    a, b = _promote(_inexact(a), _inexact(b))
    return torch.where(a < 0, torch.zeros_like(a),
                       torch.where(a > 0, torch.ones_like(a), b))


def _ldexp(a, b):
    if b.is_floating_point() or b.is_complex():
        raise ValueError("ldexp's second argument must be an integer, got "
                         "%s" % (b.dtype,))
    return torch.ldexp(_inexact(a), b)


def _int_div_safe(a, b):
    """``(a, b, zero)`` promoted to their result type, with ``b``'s zeros
    made ones and ``zero`` marking them: jax.numpy's integer division and
    remainder never divide by zero (torch raises)."""
    a, b = _promote(a, b)
    zero = b == 0
    return a, torch.where(zero, torch.ones_like(b), b), zero


def _floor_divide(a, b):
    """``a // b`` as jax.numpy computes it: integers from XLA's truncating
    division (``x / 0`` is -1, ``x % 0`` is ``x``) floored; floats from
    the remainder (``(a - fmod(a, b)) / b``, so ``x // 0.`` is nan)."""
    dt = torch.result_type(a, b)
    if dt == torch.bool or not (dt.is_floating_point or dt.is_complex):
        a, bs, zero = _int_div_safe(a, b)
        q = torch.where(zero, torch.full_like(a, -1),
                        torch.div(a, bs, rounding_mode="trunc"))
        r = torch.where(zero, a, torch.fmod(a, bs))
        return torch.where((torch.sign(a) != torch.sign(b)) & (r != 0),
                           q - 1, q)
    a, b = _promote(a, b)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    fix = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return torch.round(torch.where(fix, div - 1, div))


def _remainder(a, b):
    """jax.numpy's remainder: an integer ``x % 0`` is 0."""
    dt = torch.result_type(a, b)
    if dt.is_floating_point or dt.is_complex:
        return torch.remainder(a, b)
    a, bs, _ = _int_div_safe(a, b)
    return torch.remainder(a, bs)


def _fmod(a, b):
    """jax.numpy's fmod: an integer ``fmod(x, 0)`` is 0."""
    dt = torch.result_type(a, b)
    if dt.is_floating_point or dt.is_complex:
        return torch.fmod(a, b)
    a, bs, _ = _int_div_safe(a, b)
    return torch.fmod(a, bs)


def _fmod_of_bools(a, b):
    """fmod of two bool operands (as int32): jax.numpy keeps XLA's
    ``fmod(x, 0) = x`` there, since their common type is not an
    integer."""
    a, bs, zero = _int_div_safe(a, b)
    return torch.where(zero, a, torch.fmod(a, bs))


def _bool_via_int(fn):
    """A product-sum of two bool operands is a bool (any pair both
    true), as in jax.numpy; torch has no bool matmul."""
    def f(a, b):
        if a.dtype == torch.bool and b.dtype == torch.bool:
            return fn(a.to(torch.int32), b.to(torch.int32)) != 0
        return fn(a, b)
    return f


def _kron(a, b):
    if a.dtype == torch.bool or b.dtype == torch.bool:
        raise TypeError("kron does not accept dtype bool")
    return torch.kron(*_promote(a, b))


def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1:
        return torch.tensordot(*_promote(a, b), dims=([-1], [0]))
    return torch.tensordot(*_promote(a, b), dims=([-1], [b.dim() - 2]))


def _vdot(a, b):
    if a.numel() != b.numel():
        raise TypeError("vdot needs operands of one size, got %s and %s"
                        % (tuple(a.shape), tuple(b.shape)))
    a, b = _promote(a.reshape(-1), b.reshape(-1))
    return (torch.conj_physical(a) * b).sum() if a.is_complex() else (
        a * b).sum()


def _inner(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.inner(*_promote(a, b))


def _polyval(p, x):
    p, x = _promote(_inexact(p), _inexact(x))
    y = torch.zeros_like(x)
    for i in _pyrange(p.shape[0]):
        y = y * x + p[i]
    return y


def _conv_full(a, v):
    """Full 1-D convolution of ``a`` and ``v`` (float)."""
    n, m = a.shape[0], v.shape[0]
    w = v.flip(0).reshape(1, 1, m)
    return F.conv1d(a.reshape(1, 1, n), w, padding=m - 1).reshape(-1)


def _convolve(a, v, mode="full", precision=None, preferred_element_type=None):
    a, v = _promote(_inexact(a), _inexact(v))
    if a.shape[0] < v.shape[0]:
        a, v = v, a
    full = _conv_full(a, v)
    n, m = a.shape[0], v.shape[0]
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    if mode == "valid":
        return full[m - 1:n]
    raise ValueError("mode must be one of 'full', 'same', 'valid'")


def _correlate(a, v, mode="valid", precision=None,
               preferred_element_type=None):
    a, v = _promote(_inexact(a), _inexact(v))
    vv = torch.conj_physical(v) if v.is_complex() else v
    if a.shape[0] >= v.shape[0]:
        return _convolve(a, vv.flip(0), mode)
    return _convolve(vv.flip(0), a, mode).flip(0)


def _array_equal(a, b, equal_nan=False):
    if tuple(a.shape) != tuple(b.shape):
        return torch.tensor(False, device=a.device)
    eq = a == b
    if equal_nan and (a.is_floating_point() or b.is_floating_point()):
        eq = eq | (torch.isnan(_inexact(a)) & torch.isnan(_inexact(b)))
    return eq.all()


def _array_equiv(a, b):
    try:
        a, b = torch.broadcast_tensors(a, b)
    except RuntimeError:
        return torch.tensor(False, device=a.device)
    return (a == b).all()


def _power(a, b):
    """``a ** b``; a python scalar on either side stays a python number,
    which torch types weakly (a 0-dim host tensor exponent would make the
    backward move a host-side condition to the card, with a wait)."""
    scalar = (int, float)
    if (type(b) in scalar and isinstance(a, torch.Tensor)) or (
            type(a) in scalar and isinstance(b, torch.Tensor)):
        return torch.pow(a, b)
    return torch.pow(*_as_tensors([a, b], 2))


def _matmul(a, b):
    return torch.matmul(*_promote(a, b))


_BINARY_IMPL = {
    "add": torch.add, "subtract": torch.subtract,
    "multiply": torch.multiply, "divide": torch.true_divide,
    "true_divide": torch.true_divide, "floor_divide": _floor_divide,
    "mod": _remainder, "remainder": _remainder,
    "fmod": _fmod, "power": _power,
    "float_power": lambda a, b: torch.pow(*_promote(_inexact(a),
                                                    _inexact(b))),
    "arctan2": _fp2(torch.atan2), "hypot": _fp2(torch.hypot),
    "maximum": lambda a, b: torch.maximum(*_promote(a, b)),
    "minimum": lambda a, b: torch.minimum(*_promote(a, b)),
    "fmax": lambda a, b: torch.fmax(*_promote(a, b)),
    "fmin": lambda a, b: torch.fmin(*_promote(a, b)),
    "copysign": _fp2(torch.copysign), "logaddexp": _fp2(torch.logaddexp),
    "logaddexp2": _fp2(torch.logaddexp2),
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "bitwise_and": torch.bitwise_and,
    "bitwise_or": torch.bitwise_or, "bitwise_xor": torch.bitwise_xor,
    "bitwise_left_shift": torch.bitwise_left_shift,
    "bitwise_right_shift": torch.bitwise_right_shift,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "lcm": lambda a, b: torch.lcm(*_promote(a, b)),
    "gcd": lambda a, b: torch.gcd(*_promote(a, b)),
    "ldexp": _ldexp, "heaviside": _heaviside,
    "nextafter": _fp2(torch.nextafter), "equal": torch.eq,
    "not_equal": torch.ne, "greater": torch.gt, "greater_equal": torch.ge,
    "less": torch.lt, "less_equal": torch.le, "array_equal": _array_equal,
    "array_equiv": _array_equiv, "dot": _bool_via_int(_dot),
    "vdot": _bool_via_int(_vdot), "inner": _bool_via_int(_inner),
    "outer": lambda a, b: torch.outer(*_promote(a.reshape(-1),
                                                b.reshape(-1))),
    "matmul": _bool_via_int(_matmul), "kron": _kron,
    "polyval": _polyval, "convolve": _convolve, "correlate": _correlate,
}


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------
def _keep(r, x, axis, keepdims):
    """``r`` reduced over ``axis`` of ``x`` with the reduced dims put
    back as size 1 when ``keepdims``."""
    if not keepdims:
        return r
    shape = list(x.shape)
    for a in _axes(axis, x.dim()):
        shape[a] = 1
    return r.reshape(shape)


def _flat_axes(x, axis):
    """``x`` with the dims of ``axis`` moved last and merged into one."""
    axes = _axes(axis, x.dim())
    rest = [d for d in _pyrange(x.dim()) if d not in axes]
    y = x.permute(*rest, *axes)
    return y.reshape(*[x.shape[d] for d in rest], -1)


def _masked(x, where, fill):
    return x if where is None else torch.where(where, x, fill)


def _sum(x, axis=None, dtype=None, keepdims=False, initial=None,
         where=None, out=None, promote_integers=True):
    x = _masked(x, where, 0)
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    r = torch.sum(x, dim=_axes(axis, x.dim()), keepdim=keepdims) \
        if x.dim() else x.clone()
    if initial is not None:
        r = r + initial
    return r.to(torch_dtype(dtype)) if dtype is not None else r


def _prod(x, axis=None, dtype=None, keepdims=False, initial=None,
          where=None, out=None, promote_integers=True):
    x = _masked(x, where, 1)
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    r = _flat_axes(x, axis).prod(-1) if x.dim() else x.clone()
    r = _keep(r, x, axis, keepdims)
    if initial is not None:
        r = r * initial
    return r.to(torch_dtype(dtype)) if dtype is not None else r


def _mean(x, axis=None, dtype=None, keepdims=False, where=None, out=None):
    x = _inexact(x)
    if where is not None:
        n = _sum(where.to(x.dtype), axis, keepdims=keepdims)
        r = _sum(x, axis, keepdims=keepdims, where=where) / n
    else:
        r = torch.mean(x, dim=_axes(axis, x.dim()), keepdim=keepdims) \
            if x.dim() else x.clone()
    return r.to(torch_dtype(dtype)) if dtype is not None else r


def _var(x, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
         where=None, correction=None):
    x = _inexact(x)
    ddof = correction if correction is not None else ddof
    if not x.dim():
        return torch.zeros_like(x)
    return torch.var(x, dim=_axes(axis, x.dim()), correction=ddof,
                     keepdim=keepdims)


def _std(x, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
         where=None, correction=None):
    return torch.sqrt(_var(x, axis, dtype, out, ddof, keepdims, where,
                           correction))


def _amax(x, axis=None, out=None, keepdims=False, initial=None, where=None):
    if where is not None:
        x = _masked(x, where, initial)
    r = torch.amax(x, dim=_axes(axis, x.dim()), keepdim=keepdims) \
        if x.dim() else x.clone()
    return r if initial is None else torch.clamp(r, min=initial)


def _amin(x, axis=None, out=None, keepdims=False, initial=None, where=None):
    if where is not None:
        x = _masked(x, where, initial)
    r = torch.amin(x, dim=_axes(axis, x.dim()), keepdim=keepdims) \
        if x.dim() else x.clone()
    return r if initial is None else torch.clamp(r, max=initial)


def _arg(fn):
    def f(x, axis=None, out=None, keepdims=False):
        if axis is None:
            r = fn(x.reshape(-1), 0)
            return r.reshape([1] * x.dim()) if keepdims else r
        return fn(x, axis, keepdim=keepdims)
    return f


def _all(x, axis=None, out=None, keepdims=False, where=None):
    x = _masked(x, where, True).to(torch.bool)
    return torch.all(x, dim=_axes(axis, x.dim()), keepdim=keepdims) \
        if x.dim() else x.clone()


def _any(x, axis=None, out=None, keepdims=False, where=None):
    x = _masked(x, where, False).to(torch.bool)
    return torch.any(x, dim=_axes(axis, x.dim()), keepdim=keepdims) \
        if x.dim() else x.clone()


def _cum(fn):
    def f(x, axis=None, dtype=None, out=None):
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        if axis is None:
            x, axis = x.reshape(-1), 0
        r = fn(x, axis)
        return r.to(torch_dtype(dtype)) if dtype is not None else r
    return f


def _nan_fill(x, fill):
    if not x.is_floating_point():
        return x
    return torch.where(torch.isnan(x), fill, x)


def _nanvar(x, axis=None, dtype=None, out=None, ddof=0, keepdims=False,
            where=None):
    x = _inexact(x)
    ok = ~torch.isnan(x)
    n = _sum(ok.to(x.dtype), axis, keepdims=True)
    m = _sum(_nan_fill(x, 0.0), axis, keepdims=True) / n
    d = torch.where(ok, x - m, torch.zeros_like(x))
    r = _sum(d * d, axis, keepdims=True) / (n - ddof)
    return r if keepdims else r.reshape(
        [s for i, s in enumerate(x.shape) if i not in _axes(axis, x.dim())])


def _nanminmax(fn, fill):
    def f(x, axis=None, out=None, keepdims=False, initial=None, where=None):
        if not x.is_floating_point():
            return fn(x, axis, keepdims=keepdims)
        r = fn(_nan_fill(x, fill), axis, keepdims=keepdims)
        allnan = _all(torch.isnan(x), axis, keepdims=keepdims)
        return torch.where(allnan, torch.full_like(r, math.nan), r)
    return f


def _nanarg(fn, fill):
    def f(x, axis=None, out=None, keepdims=False):
        return _arg(fn)(_nan_fill(x, fill), axis, keepdims=keepdims)
    return f


def _quantile_t(x, q, axis=None, method="linear", keepdims=False,
                nan=False, overwrite_input=False, out=None,
                interpolation=None):
    x = _inexact(x)
    method = interpolation or method
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device) if not \
        isinstance(q, torch.Tensor) else q.to(x.dtype)
    fn = torch.nanquantile if nan else torch.quantile
    if axis is None:
        r = fn(x.reshape(-1), qt, dim=0, interpolation=method)
        if keepdims:
            r = r.reshape(tuple(qt.shape) + (1,) * x.dim())
        return r
    y = _flat_axes(x, axis)
    r = fn(y, qt, dim=-1, interpolation=method)
    if keepdims:
        shape = list(x.shape)
        for a in _axes(axis, x.dim()):
            shape[a] = 1
        r = r.reshape(tuple(qt.shape) + tuple(shape))
    return r


def _median(x, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile_t(x, 0.5, axis, keepdims=keepdims)


def _nanmedian(x, axis=None, out=None, overwrite_input=False,
               keepdims=False):
    return _quantile_t(x, 0.5, axis, keepdims=keepdims, nan=True)


def _count_nonzero(x, axis=None, keepdims=False):
    return _sum((x != 0).to(torch.int32), axis, keepdims=keepdims)


_REDUCTION_IMPL = {
    "sum": _sum, "prod": _prod, "mean": _mean, "std": _std, "var": _var,
    "max": _amax, "min": _amin, "amax": _amax, "amin": _amin,
    "argmax": _arg(torch.argmax), "argmin": _arg(torch.argmin),
    "all": _all, "any": _any, "cumsum": _cum(torch.cumsum),
    "cumprod": _cum(torch.cumprod),
    "nansum": lambda x, axis=None, dtype=None, out=None, keepdims=False,
    **kw: _sum(_nan_fill(x, 0.0), axis, dtype, keepdims),
    "nanprod": lambda x, axis=None, dtype=None, out=None, keepdims=False,
    **kw: _prod(_nan_fill(x, 1.0), axis, dtype, keepdims),
    "nanmean": lambda x, axis=None, dtype=None, out=None, keepdims=False,
    **kw: torch.nanmean(_inexact(x), dim=_axes(axis, x.dim()),
                        keepdim=keepdims),
    "nanstd": lambda *a, **k: torch.sqrt(_nanvar(*a, **k)),
    "nanvar": _nanvar,
    "nanmax": _nanminmax(_amax, -math.inf),
    "nanmin": _nanminmax(_amin, math.inf),
    "nanargmax": _nanarg(torch.argmax, -math.inf),
    "nanargmin": _nanarg(torch.argmin, math.inf),
    "median": _median, "nanmedian": _nanmedian,
    "ptp": lambda x, axis=None, out=None, keepdims=False:
        _amax(x, axis, keepdims=keepdims) - _amin(x, axis, keepdims=keepdims),
    "count_nonzero": _count_nonzero,
    "nancumsum": lambda x, axis=None, dtype=None, out=None:
        _cum(torch.cumsum)(_nan_fill(x, 0.0), axis, dtype),
    "nancumprod": lambda x, axis=None, dtype=None, out=None:
        _cum(torch.cumprod)(_nan_fill(x, 1.0), axis, dtype),
}


# --------------------------------------------------------------------------
# shape manipulation and the rest of the passthrough list
# --------------------------------------------------------------------------
def _reshape(a, newshape=None, order="C", shape=None, copy=None):
    s = newshape if newshape is not None else shape
    if isinstance(s, int):
        s = (s,)
    return a.reshape(tuple(int(v) for v in s))


def _transpose(a, axes=None):
    if axes is None:
        return a.permute(*reversed(_pyrange(a.dim())))
    return a.permute(*axes)


def _rollaxis(a, axis, start=0):
    n = a.dim()
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    return torch.movedim(a, axis, start)


def _expand_dims(a, axis):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    n = a.dim() + len(axes)
    for ax in sorted(x % n for x in axes):
        a = a.unsqueeze(ax)
    return a


def _squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    return a.squeeze(_axes(axis, a.dim()))


def _flip(m, axis=None):
    return m.flip(_axes(axis, m.dim()))


def _atleast(n):
    def f(*arys):
        out = []
        for a in arys:
            if a.dim() < n:
                if n == 3 and a.dim() == 2:
                    a = a.unsqueeze(-1)
                elif n == 3 and a.dim() == 1:
                    a = a.reshape(1, -1, 1)
                else:
                    a = a.reshape((1,) * (n - a.dim()) + tuple(a.shape))
            out.append(a)
        return out[0] if len(out) == 1 else out
    return f


def _delete(arr, obj, axis=None, assume_unique_indices=False):
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    keep = torch.ones(n, dtype=torch.bool, device=arr.device)
    if isinstance(obj, slice):
        keep[torch.arange(*obj.indices(n), device=arr.device)] = False
    else:
        idx = torch.as_tensor(_unwrap(obj), device=arr.device).long()
        keep[idx % n] = False
    return arr.index_select(axis, keep.nonzero().reshape(-1))


def _append(arr, values, axis=None):
    values = _as_tensors([values], 1)[0].to(arr.device)
    arr, values = _promote(arr, values)
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1)])
    return torch.cat([arr, values], dim=axis)


def _trim_zeros(filt, trim="fb", axis=None):
    nz = (filt != 0).nonzero().reshape(-1)
    if nz.numel() == 0:
        return filt[:0]
    lo = int(nz[0]) if "f" in trim.lower() else 0
    hi = int(nz[-1]) + 1 if "b" in trim.lower() else filt.shape[0]
    return filt[lo:hi]


def _pad_widths(pad_width, ndim):
    pw = onp.asarray(_unwrap(pad_width) if not isinstance(
        pad_width, torch.Tensor) else pad_width.cpu().numpy())
    return onp.broadcast_to(pw, (ndim, 2)).astype(int)


def _pad(array, pad_width, mode="constant", **kwargs):
    pw = _pad_widths(pad_width, array.dim())
    if mode == "constant":
        cv = kwargs.get("constant_values", 0)
        flat = [int(v) for row in pw[::-1] for v in row]
        return F.pad(array, flat, value=float(_unwrap(cv)) if not isinstance(
            cv, (list, tuple)) else float(cv[0]))
    out = array
    for ax in _pyrange(array.dim()):
        lo, hi = int(pw[ax][0]), int(pw[ax][1])
        if not lo and not hi:
            continue
        n = out.shape[ax]
        i = torch.arange(-lo, n + hi, device=array.device)
        if mode == "edge":
            i = i.clamp(0, n - 1)
        elif mode == "wrap":
            i = i % n
        elif mode in ("reflect", "symmetric"):
            if mode == "reflect":
                period = 2 * (n - 1) if n > 1 else 1
                i = i % period
                i = torch.where(i >= n, period - i, i)
            else:
                period = 2 * n
                i = i % period
                i = torch.where(i >= n, period - 1 - i, i)
        else:
            raise NotImplementedError("pad mode %r" % (mode,))
        out = out.index_select(ax, i)
    return out


def _resize(a, new_shape):
    if isinstance(new_shape, int):
        new_shape = (new_shape,)
    n = int(onp.prod(new_shape))
    flat = a.reshape(-1)
    if flat.numel() == 0:
        return torch.zeros(new_shape, dtype=a.dtype, device=a.device)
    reps = -(-n // flat.numel())
    return flat.repeat(reps)[:n].reshape(new_shape)


def _trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    r = torch.diagonal(a, offset, axis1, axis2).sum(-1)
    return r.to(torch_dtype(dtype)) if dtype is not None else r


def _diag(v, k=0):
    return torch.diag(v, k)


def _vander(x, N=None, increasing=False):
    N = x.shape[0] if N is None else N
    p = torch.arange(N, device=x.device)
    if not increasing:
        p = p.flip(0)
    return x.unsqueeze(-1) ** p.to(x.dtype if not _is_int(x) else x.dtype)


def _flatnonzero(a, size=None, fill_value=None):
    return a.reshape(-1).nonzero().reshape(-1)


def _argwhere(a, size=None, fill_value=None):
    return torch.argwhere(a)


def _searchsorted(a, v, side="left", sorter=None, method=None):
    if sorter is not None:
        a = a[sorter.long()]
    a, v = _promote(a, v)
    return torch.searchsorted(a, v, side=side)


def _extract(condition, arr, size=None, fill_value=0):
    return arr.reshape(-1)[condition.reshape(-1).to(torch.bool)]


def _compress(condition, a, axis=None, size=None, fill_value=0, out=None):
    c = condition.reshape(-1).to(torch.bool)
    if axis is None:
        a, axis = a.reshape(-1), 0
    idx = c.nonzero().reshape(-1)
    idx = idx[idx < a.shape[axis]]
    return a.index_select(axis, idx)


def _norm_index(idx, n):
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def _take_along_axis(arr, indices, axis, mode=None, fill_value=None):
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    return torch.take_along_dim(arr, _norm_index(indices, arr.shape[axis]),
                                dim=axis)


def _put_along_axis(arr, indices, values, axis, inplace=True, mode=None):
    if inplace:
        raise ValueError("put_along_axis cannot modify arrays in place; "
                         "pass inplace=False")
    if axis is None:
        shape, arr, axis = arr.shape, arr.reshape(-1), 0
    else:
        shape = None
    idx = _norm_index(indices, arr.shape[axis])
    idx, = torch.broadcast_tensors(idx)
    vals = torch.broadcast_to(torch.as_tensor(values, dtype=arr.dtype,
                                              device=arr.device), idx.shape)
    out = arr.scatter(axis, idx, vals)
    return out if shape is None else out.reshape(shape)


def _select(condlist, choicelist, default=0):
    out = torch.as_tensor(default, device=choicelist[0].device)
    res = None
    for c, v in zip(reversed(list(condlist)), reversed(list(choicelist))):
        res = torch.where(c.to(torch.bool), v, out if res is None else res)
    return res


def _piecewise(x, condlist, funclist, *args, **kw):
    if isinstance(condlist, torch.Tensor) and condlist.dim() == x.dim():
        condlist = [condlist]
    condlist = [c.to(torch.bool) for c in condlist]
    funclist = list(funclist)
    if len(funclist) == len(condlist) + 1:
        other = ~torch.stack(condlist).any(0) if condlist else \
            torch.ones_like(x, dtype=torch.bool)
        condlist = condlist + [other]
    out = torch.zeros_like(x)
    for c, f in zip(condlist, funclist):
        v = f(x, *args, **kw) if callable(f) else f
        v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
        out = torch.where(c, v, out)
    return out


def _interp(x, xp, fp, left=None, right=None, period=None):
    x, xp, fp = _promote(_inexact(x), _inexact(xp), _inexact(fp))
    if period is not None:
        x = torch.remainder(x, period)
        xp = torch.remainder(xp, period)
        order = torch.argsort(xp)
        xp, fp = xp[order], fp[order]
        xp = torch.cat([xp[-1:] - period, xp, xp[:1] + period])
        fp = torch.cat([fp[-1:], fp, fp[:1]])
    i = torch.searchsorted(xp, x, side="right").clamp(1, xp.shape[0] - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    w = torch.where(dx == 0, torch.zeros_like(x), (x - x0) / torch.where(
        dx == 0, torch.ones_like(dx), dx))
    y = f0 + w * (f1 - f0)
    if period is None:
        lv = fp[0] if left is None else torch.as_tensor(left, dtype=y.dtype)
        rv = fp[-1] if right is None else torch.as_tensor(right,
                                                          dtype=y.dtype)
        y = torch.where(x < xp[0], lv, y)
        y = torch.where(x > xp[-1], rv, y)
    return y


def _diff(a, n=1, axis=-1, prepend=None, append=None):
    if a.dtype == torch.bool:
        r = a
        for _ in _pyrange(n):
            r = r.narrow(axis, 1, r.shape[axis] - 1) ^ r.narrow(
                axis, 0, r.shape[axis] - 1)
        return r
    kw = {}
    if prepend is not None:
        kw["prepend"] = torch.as_tensor(prepend, dtype=a.dtype,
                                        device=a.device).broadcast_to(
            a.narrow(axis, 0, 1).shape if torch.as_tensor(prepend).dim() == 0
            else torch.as_tensor(prepend).shape)
    if append is not None:
        kw["append"] = torch.as_tensor(append, dtype=a.dtype,
                                       device=a.device).broadcast_to(
            a.narrow(axis, 0, 1).shape if torch.as_tensor(append).dim() == 0
            else torch.as_tensor(append).shape)
    return torch.diff(a, n=n, dim=axis, **kw)


def _ediff1d(ary, to_end=None, to_begin=None):
    d = torch.diff(ary.reshape(-1))
    parts = []
    if to_begin is not None:
        parts.append(torch.as_tensor(to_begin, dtype=d.dtype,
                                     device=d.device).reshape(-1))
    parts.append(d)
    if to_end is not None:
        parts.append(torch.as_tensor(to_end, dtype=d.dtype,
                                     device=d.device).reshape(-1))
    return torch.cat(parts)


def _gradient(f, *varargs, axis=None, edge_order=1):
    f = _inexact(f)
    axes = _axes(axis, f.dim())
    spacing = list(varargs) if varargs else [1.0] * len(axes)
    if len(spacing) == 1 and len(axes) > 1:
        spacing = spacing * len(axes)
    outs = []
    for ax, h in zip(axes, spacing):
        n = f.shape[ax]
        mid = (f.narrow(ax, 2, n - 2) - f.narrow(ax, 0, n - 2)) / (2.0 * h)
        first = (f.narrow(ax, 1, 1) - f.narrow(ax, 0, 1)) / h
        last = (f.narrow(ax, n - 1, 1) - f.narrow(ax, n - 2, 1)) / h
        outs.append(torch.cat([first, mid, last], dim=ax))
    return outs[0] if len(outs) == 1 else outs


def _trapz(y, x=None, dx=1.0, axis=-1):
    y = _inexact(y)
    if x is not None:
        return torch.trapezoid(y, _inexact(x), dim=axis)
    return torch.trapezoid(y, dx=dx, dim=axis)


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    if axis is not None:
        axisa = axisb = axisc = axis
    a = torch.movedim(a, axisa, -1)
    b = torch.movedim(b, axisb, -1)
    a, b = _promote(a, b)
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    if a.shape[-1] == 2:
        a = F.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = F.pad(b, (0, 1))
    a, b = torch.broadcast_tensors(a, b)
    return torch.movedim(torch.linalg.cross(a, b, dim=-1), -1, axisc)


def _tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)) and len(axes) == 2 and builtins.all(
            isinstance(x, int) for x in axes):
        axes = ([axes[0]], [axes[1]])
    return torch.tensordot(*_promote(a, b), dims=axes)


def _clip(a, a_min=None, a_max=None, out=None, min=None, max=None):
    lo = a_min if a_min is not None else min
    hi = a_max if a_max is not None else max
    if isinstance(lo, torch.Tensor):
        lo = lo.to(a.dtype)
    if isinstance(hi, torch.Tensor):
        hi = hi.to(a.dtype)
    return torch.clamp(a, lo, hi)


def _round(a, decimals=0, out=None):
    if _is_int(a):
        return a.clone()
    return torch.round(a, decimals=decimals) if decimals else torch.round(a)


def _sort(a, axis=-1, kind=None, order=None, stable=True, descending=False):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True, descending=descending)[0]


def _argsort(a, axis=-1, kind=None, order=None, stable=True,
             descending=False):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True, descending=descending)[1]


def _partition_idx(a, kth, axis):
    x = torch.movedim(a, axis, -1)
    n = x.shape[-1]
    lo = torch.sort(x, dim=-1, stable=True)[1][..., :kth + 1]
    hi = torch.sort(x, dim=-1, stable=True, descending=True)[1][
        ..., :n - kth - 1]
    return torch.movedim(torch.cat([lo, hi], -1), -1, axis)


def _partition(a, kth, axis=-1):
    idx = _partition_idx(a, kth, axis)
    return torch.take_along_dim(a, idx, dim=axis)


def _argpartition(a, kth, axis=-1):
    return _partition_idx(a, kth, axis)


def _lexsort(keys, axis=-1):
    if isinstance(keys, torch.Tensor):
        keys = list(keys.unbind(0))
    idx = None
    for k in keys:
        if idx is None:
            idx = torch.sort(k, dim=axis, stable=True)[1]
        else:
            kk = torch.take_along_dim(k, idx, dim=axis)
            idx = torch.take_along_dim(
                idx, torch.sort(kk, dim=axis, stable=True)[1], dim=axis)
    return idx


def _unwrap_phase(p, discont=None, axis=-1, period=2 * math.pi):
    p = _inexact(p)
    dd = torch.diff(p, dim=axis)
    half = period / 2
    discont = half if discont is None else builtins.max(discont, half)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    corr = torch.where(dd.abs() < discont, torch.zeros_like(dd), ddmod - dd)
    first = p.narrow(axis, 0, 1)
    return torch.cat([first, p.narrow(axis, 1, p.shape[axis] - 1)
                      + torch.cumsum(corr, dim=axis)], dim=axis)


def _digitize(x, bins, right=False, method=None):
    x, bins = _promote(x, bins)
    if bins.shape[0] > 1 and builtins.bool(bins[-1] < bins[0]):
        n = bins.shape[0]
        return n - torch.bucketize(x, bins.flip(0), right=not right)
    return torch.bucketize(x, bins, right=not right)


def _bincount(x, weights=None, minlength=0, length=None):
    n = length if length is not None else builtins.max(
        int(minlength), int(x.max()) + 1 if x.numel() else 0)
    r = torch.bincount(x.long().clamp(0, builtins.max(n - 1, 0)),
                       weights=weights, minlength=n)[:n]
    return r


def _isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = _promote(a, b)
    if _is_int(a):
        a, b = _inexact(a), _inexact(b)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def _unravel_index(indices, shape):
    return tuple(torch.unravel_index(indices.long(), tuple(shape)))


def _tri_from(fn):
    def f(arr, k=0):
        r, c = fn(arr.shape[-2], arr.shape[-1], k, device=arr.device)
        return r, c
    return f


def _apply_along_axis(func1d, axis, arr, *args, **kwargs):
    x = torch.movedim(arr, axis, -1)
    lead = x.shape[:-1]
    rows = [torch.as_tensor(func1d(r, *args, **kwargs), device=arr.device)
            for r in x.reshape(-1, x.shape[-1])]
    out = torch.stack(rows).reshape(tuple(lead) + tuple(rows[0].shape))
    if rows[0].dim() == 0:
        return out
    return torch.movedim(out, -1, axis % arr.dim())


def _divmod(a, b):
    return torch.floor_divide(a, b), torch.remainder(a, b)


def _modf(x, out=None):
    x = _inexact(x)
    i = torch.trunc(x)
    return x - i, i


def _frexp(x):
    m, ex = torch.frexp(_inexact(x))
    return m, ex


def _bin_edges(a, bins, range):
    if isinstance(bins, torch.Tensor):
        return _inexact(bins)
    a = _inexact(a)
    if range is None:
        lo, hi = (a.min(), a.max()) if a.numel() else (
            torch.tensor(0.0), torch.tensor(1.0))
    else:
        lo, hi = (torch.as_tensor(v, dtype=a.dtype, device=a.device)
                  for v in range)
    lo, hi = lo.to(a.dtype), hi.to(a.dtype)
    same = lo == hi
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    t = torch.linspace(0, 1, bins + 1, dtype=a.dtype, device=a.device)
    return lo + (hi - lo) * t


def _histogram_bin_edges(a, bins=10, range=None, weights=None):
    return _bin_edges(a, bins, range)


def _histogram_t(a, bins=10, range=None, weights=None, density=None):
    edges = _bin_edges(a, bins, range)
    x = _inexact(a).reshape(-1)
    nb = edges.shape[0] - 1
    idx = torch.bucketize(x, edges, right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, nb - 1), idx)
    ok = (idx >= 0) & (idx < nb)
    w = torch.ones_like(x) if weights is None else \
        _inexact(weights).reshape(-1)
    counts = torch.zeros(nb, dtype=w.dtype, device=x.device).index_add(
        0, idx.clamp(0, nb - 1), torch.where(ok, w, torch.zeros_like(w)))
    if density:
        counts = counts / (counts.sum() * torch.diff(edges))
    return counts, edges


def _corrcoef(x, y=None, rowvar=True, dtype=None):
    x = _inexact(x)
    if x.dim() == 1:
        x = x.unsqueeze(0)
    if not rowvar:
        x = x.T
    if y is not None:
        y = _inexact(y)
        y = y.unsqueeze(0) if y.dim() == 1 else (y if rowvar else y.T)
        x = torch.cat([x, y])
    return torch.corrcoef(x)


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
         aweights=None, dtype=None):
    m = _inexact(m)
    if m.dim() == 1:
        m = m.unsqueeze(0)
    if not rowvar and m.shape[0] != 1:
        m = m.T
    if y is not None:
        y = _inexact(y)
        y = y.unsqueeze(0) if y.dim() == 1 else (y if rowvar else y.T)
        m = torch.cat([m, y])
    corr = ddof if ddof is not None else (0 if bias else 1)
    return torch.cov(m, correction=corr, fweights=fweights,
                     aweights=aweights).squeeze()


def _average(a, axis=None, weights=None, returned=False, keepdims=False):
    a = _inexact(a)
    if weights is None:
        avg = _mean(a, axis, keepdims=keepdims)
        n = torch.full_like(avg, a.numel() / builtins.max(avg.numel(), 1))
        return (avg, n) if returned else avg
    w = _inexact(weights).to(a.dtype)
    if w.shape != a.shape:
        shape = [1] * a.dim()
        shape[axis % a.dim()] = w.shape[0]
        w = w.reshape(shape)
    w = torch.broadcast_to(w, a.shape)
    sw = _sum(w, axis, keepdims=keepdims)
    avg = _sum(a * w, axis, keepdims=keepdims) / sw
    return (avg, sw) if returned else avg


def _quantile(a, q, axis=None, out=None, overwrite_input=False,
              method="linear", keepdims=False, interpolation=None):
    return _quantile_t(a, q, axis, method, keepdims, False,
                       interpolation=interpolation)


def _nanquantile(a, q, axis=None, out=None, overwrite_input=False,
                 method="linear", keepdims=False, interpolation=None):
    return _quantile_t(a, q, axis, method, keepdims, True,
                       interpolation=interpolation)


def _percentile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, interpolation=None):
    return _quantile(a, _inexact(torch.as_tensor(q)) / 100.0, axis,
                     method=method, keepdims=keepdims,
                     interpolation=interpolation)


def _nanpercentile(a, q, axis=None, out=None, overwrite_input=False,
                   method="linear", keepdims=False, interpolation=None):
    return _nanquantile(a, _inexact(torch.as_tensor(q)) / 100.0, axis,
                        method=method, keepdims=keepdims,
                        interpolation=interpolation)


def _repeat(a, repeats, axis=None, total_repeat_length=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(a.device).long()
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


def _tile(A, reps):
    if isinstance(reps, int):
        reps = (reps,)
    return torch.tile(A, tuple(reps))


def _rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(m, k, list(axes))


def _roll(a, shift, axis=None):
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def _diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, offset, axis1, axis2)


_OTHER_IMPL = {
    "reshape": _reshape, "ravel": lambda a, order="C": a.reshape(-1),
    "transpose": _transpose,
    "swapaxes": lambda a, axis1, axis2: a.transpose(axis1, axis2),
    "moveaxis": lambda a, source, destination: torch.movedim(
        a, source, destination),
    "rollaxis": _rollaxis, "expand_dims": _expand_dims,
    "squeeze": _squeeze, "flip": _flip,
    "fliplr": lambda m: m.flip(1), "flipud": lambda m: m.flip(0),
    "roll": _roll, "rot90": _rot90, "tile": _tile, "repeat": _repeat,
    "broadcast_to": lambda a, shape: torch.broadcast_to(
        a, (shape,) if isinstance(shape, int) else tuple(shape)),
    "atleast_1d": _atleast(1), "atleast_2d": _atleast(2),
    "atleast_3d": _atleast(3), "delete": _delete, "append": _append,
    "trim_zeros": _trim_zeros, "pad": _pad, "resize": _resize,
    "tril": lambda m, k=0: torch.tril(m, k),
    "triu": lambda m, k=0: torch.triu(m, k), "trace": _trace,
    "diagonal": _diagonal, "diag": _diag,
    "diagflat": lambda v, k=0: torch.diagflat(v, k), "vander": _vander,
    "flatnonzero": _flatnonzero, "argwhere": _argwhere,
    "searchsorted": _searchsorted, "extract": _extract,
    "compress": _compress, "take_along_axis": _take_along_axis,
    "put_along_axis": _put_along_axis, "select": _select,
    "piecewise": _piecewise, "interp": _interp, "diff": _diff,
    "ediff1d": _ediff1d, "gradient": _gradient, "trapz": _trapz,
    "cross": _cross, "tensordot": _tensordot, "clip": _clip,
    "round": _round, "around": _round, "sort": _sort, "argsort": _argsort,
    "partition": _partition, "argpartition": _argpartition,
    "lexsort": _lexsort, "msort": lambda a: _sort(a, axis=0),
    "unwrap": _unwrap_phase, "digitize": _digitize, "bincount": _bincount,
    "isclose": _isclose,
    "isrealobj": lambda x: not x.is_complex(),
    "iscomplexobj": lambda x: x.is_complex(),
    "isreal": lambda x: (x.imag == 0) if x.is_complex() else
        torch.ones_like(x, dtype=torch.bool),
    "iscomplex": lambda x: (x.imag != 0) if x.is_complex() else
        torch.zeros_like(x, dtype=torch.bool),
    "unravel_index": _unravel_index,
    "triu_indices_from": _tri_from(torch.triu_indices),
    "tril_indices_from": _tri_from(torch.tril_indices),
    "apply_along_axis": _apply_along_axis,
    "float_power": _BINARY_IMPL["float_power"], "divmod": _divmod,
    "modf": _modf, "frexp": _frexp,
    "histogram_bin_edges": _histogram_bin_edges, "corrcoef": _corrcoef,
    "cov": _cov, "average": _average, "quantile": _quantile,
    "percentile": _percentile, "nanquantile": _nanquantile,
    "nanpercentile": _nanpercentile,
}

#: how many leading positional arguments of each op are arrays
_NARRAY = {"power": 0, "put_along_axis": 3, "select": 2, "piecewise": 1, "interp": 3,
           "searchsorted": 2, "extract": 2, "compress": 2,
           "take_along_axis": 2, "cross": 2, "tensordot": 2,
           "isclose": 2, "digitize": 2, "divmod": 2, "float_power": 2,
           "corrcoef": 2, "cov": 2, "append": 2, "apply_along_axis": 0,
           "lexsort": 1, "trapz": 2}

# --------------------------------------------------------------------------
# generated wrappers over the lists of the JAX package
# --------------------------------------------------------------------------
_UNARY = list(_UNARY_IMPL)
_BINARY = list(_BINARY_IMPL)
_REDUCTION = list(_REDUCTION_IMPL)
_OTHER_PASSTHROUGH = list(_OTHER_IMPL)

_IMPL = {}
_IMPL.update(_UNARY_IMPL)
_IMPL.update(_BINARY_IMPL)
_IMPL.update(_REDUCTION_IMPL)
_IMPL.update(_OTHER_IMPL)


def _maybe_out(res, out):
    if out is not None:
        if isinstance(res, (list, tuple)):
            raise ValueError("out= unsupported for multi-output op")
        out._set_data(res._data.to(out._data.dtype))
        return out
    return res


#: binary ops whose bool operands jax.numpy computes as int32, also
#: when both are bool
_BOOL_AS_INT = {"floor_divide", "mod", "remainder", "fmod", "power",
                "ldexp", "left_shift", "right_shift", "bitwise_left_shift",
                "bitwise_right_shift"}


def _is_bool(v):
    return type(v) is builtins.bool or (isinstance(v, torch.Tensor)
                                        and v.dtype == torch.bool)


def _as_int32(v):
    return int(v) if type(v) is builtins.bool else v.to(torch.int32)


def _bool_operands(name, a, b, ba, bb):
    """The operands ``a``, ``b`` of binary op ``name`` (``ba``, ``bb``:
    which are bool) with bool ones promoted as jax.numpy promotes them:
    beside an operand of another type, a bool takes that type (a python
    int as int32, a float as float32, so ``1 - (x == y)`` is int32); two
    bools stay bool (``True - True`` raises in both packages), except in
    the ops of :data:`_BOOL_AS_INT`."""
    if name in _BOOL_AS_INT:
        return (_as_int32(a) if ba else a), (_as_int32(b) if bb else b)
    if ba and bb:
        return a, b
    other = b if ba else a
    if isinstance(other, torch.Tensor):
        dt = other.dtype
    else:
        from ..ndarray import _SCALAR_DTYPE
        dt = _SCALAR_DTYPE.get(type(other))
        if dt is None:
            return a, b
    cast = (lambda v: v.to(dt) if isinstance(v, torch.Tensor)
            else other.__class__(v))
    return (cast(a), b) if ba else (a, cast(b))


def _make_wrapper(tfn, name, k):
    binary = name in _BINARY_IMPL and k == 2 or name == "power"

    def fn(*vals, **kwargs):
        if binary and len(vals) >= 2:
            ba, bb = _is_bool(vals[0]), _is_bool(vals[1])
            if ba or bb:
                vals = _bool_operands(name, vals[0], vals[1], ba,
                                      bb) + tuple(vals[2:])
                if ba and bb and name == "fmod":
                    return _fmod_of_bools(*_as_tensors(vals, k), **kwargs)
        if name == "apply_along_axis":
            return tfn(*vals, **kwargs)
        if name in ("select", "lexsort"):
            seqs = [list(_as_tensors(v, len(v))) if isinstance(
                v, (list, tuple)) else v for v in vals[:k]]
            return tfn(*seqs, *vals[k:], **kwargs)
        return tfn(*_as_tensors(vals, k), **kwargs)

    fn.__name__ = name      # the op's name in the profiler's tables

    def wrapper(*args, **kwargs):
        out = kwargs.pop("out", None)
        where = kwargs.get("where")
        if where is not None:
            kwargs["where"] = _unwrap(where)
        res = apply_op(fn, *args, **kwargs)
        return _maybe_out(res, out)

    wrapper.__name__ = name
    wrapper.__qualname__ = name
    wrapper.__doc__ = ("``mx.np.%s`` over torch tensors (parity: "
                       "python/mxnet/numpy/multiarray.py)." % name)
    return wrapper


for _n, _f in _IMPL.items():
    _k = _NARRAY.get(_n, 2 if _n in _BINARY_IMPL else 1)
    setattr(_mod, _n, _make_wrapper(_f, _n, _k))


def fix(x, out=None):
    return _maybe_out(apply_op(lambda v: _keep_int(torch.trunc)(v), x), out)


def astype(x, dtype, copy=True):
    """Module-level dtype cast (``ndarray.astype`` as a free function)."""
    td = torch_dtype(dtype)
    return apply_op(lambda v: v.to(td), x)


def einsum(subscripts, *operands, **kwargs):
    kwargs.pop("optimize", None)

    def f(*ops):
        from ..ops.nn import _amp_cast1
        ops = [_amp_cast1("einsum", o) for o in _promote(*ops)]
        return torch.einsum(subscripts, *ops)
    return apply_op(f, *operands)


def sigmoid(x):
    return apply_op(lambda v: torch.sigmoid(_inexact(v)), x)


def erf(x):
    return apply_op(lambda v: torch.erf(_inexact(v)), x)


def erfinv(x):
    return apply_op(lambda v: torch.erfinv(_inexact(v)), x)


def gamma_fn(x):
    return apply_op(lambda v: torch.exp(torch.lgamma(_inexact(v))), x)


def gammaln(x):
    return apply_op(lambda v: torch.lgamma(_inexact(v)), x)


# --------------------------------------------------------------------------
# creation (ctx=/device= as in the reference; the default device else)
# --------------------------------------------------------------------------
def _ctx_of(kwargs):
    ctx = kwargs.pop("ctx", None)
    dev = kwargs.pop("device", None)
    return _context.resolve(ctx if ctx is not None else dev)


def _shape(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _creation(fn):
    def wrapper(*args, **kwargs):
        dev = _ctx_of(kwargs)
        return _wrap(fn(*args, device=dev, **kwargs))

    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _dt(dtype, default=torch.float32):
    return torch_dtype(dtype) if dtype is not None else default


@_creation
def zeros(shape, dtype=float32, order="C", device=None, **kw):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=device)


@_creation
def ones(shape, dtype=float32, order="C", device=None, **kw):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=device)


@_creation
def empty(shape, dtype=float32, order="C", device=None, **kw):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=device)


@_creation
def full(shape, fill_value, dtype=None, order="C", device=None, **kw):
    fv = _to_tensor(fill_value, device=device)
    return torch.full(_shape(shape), 0, dtype=_dt(dtype, fv.dtype),
                      device=device) + fv.to(_dt(dtype, fv.dtype))


@_creation
def arange(start, stop=None, step=1, dtype=None, device=None, **kw):
    vals = [v for v in (start, stop, step) if v is not None]
    is_float = builtins.any(isinstance(_unwrap(v), float) or (
        isinstance(_unwrap(v), torch.Tensor) and _unwrap(v).is_floating_point())
        for v in vals)
    start, stop, step = (_unwrap(v) for v in (start, stop, step))
    if stop is None:
        start, stop = 0, start
    if isinstance(start, torch.Tensor):
        start = start.item()
    if isinstance(stop, torch.Tensor):
        stop = stop.item()
    if isinstance(step, torch.Tensor):
        step = step.item()
    dt = _dt(dtype, torch_dtype(float if is_float else int))
    if dt.is_floating_point:
        n = builtins.max(int(math.ceil((stop - start) / step)), 0)
        return (start + step * torch.arange(n, dtype=torch.float64,
                                            device=device)).to(dt)
    return torch.arange(start, stop, step, dtype=torch.int64,
                        device=device).to(dt)


@_creation
def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, device=None, **kw):
    start = _to_tensor(start, device=device)
    stop = _to_tensor(stop, device=device)
    dt = _dt(dtype, torch.promote_types(_inexact(start).dtype,
                                        _inexact(stop).dtype))
    div = (num - 1) if endpoint else num
    step = (stop.double() - start.double()) / builtins.max(div, 1)
    t = torch.arange(num, dtype=torch.float64, device=device)
    t = t.reshape((-1,) + (1,) * start.dim())
    out = start.double() + t * step
    if endpoint and num > 1:
        out[-1] = stop.double()
    out = torch.movedim(out, 0, axis).to(dt)
    if retstep:
        return out, step.to(dt)
    return out


@_creation
def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, device=None, **kw):
    lin = linspace(start, stop, num, endpoint, device=device)._data.double()
    return torch.pow(torch.tensor(base, dtype=torch.float64, device=device),
                     lin).to(_dt(dtype))


@_creation
def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0,
              device=None, **kw):
    s, e = float(start), float(stop)
    sign = 1.0 if s > 0 else -1.0
    lin = linspace(math.log10(_pyabs(s)), math.log10(_pyabs(e)), num,
                   endpoint, device=device)._data.double()
    out = sign * torch.pow(10.0, lin)
    out[0] = s
    if endpoint and num > 1:
        out[-1] = e
    return out.to(_dt(dtype))


@_creation
def eye(N, M=None, k=0, dtype=float32, device=None, **kw):
    M = N if M is None else M
    i = torch.arange(N, device=device)[:, None]
    j = torch.arange(M, device=device)[None, :]
    return (j - i == k).to(_dt(dtype))


@_creation
def identity(n, dtype=float32, device=None, **kw):
    return torch.eye(n, dtype=_dt(dtype), device=device)


@_creation
def tri(N, M=None, k=0, dtype=float32, device=None, **kw):
    M = N if M is None else M
    i = torch.arange(N, device=device)[:, None]
    j = torch.arange(M, device=device)[None, :]
    return (j - i <= k).to(_dt(dtype))


@_creation
def indices(dimensions, dtype=int32, device=None, **kw):
    grids = torch.meshgrid(*[torch.arange(d, device=device)
                             for d in dimensions], indexing="ij")
    return torch.stack(grids).to(_dt(dtype))


def zeros_like(a, dtype=None, order="C", ctx=None, device=None):
    return apply_op(lambda x: torch.zeros_like(x, dtype=torch_dtype(dtype)),
                    _arr(a))


def ones_like(a, dtype=None, order="C", ctx=None, device=None):
    return apply_op(lambda x: torch.ones_like(x, dtype=torch_dtype(dtype)),
                    _arr(a))


def full_like(a, fill_value, dtype=None, order="C", ctx=None, device=None):
    def f(x, v):
        dt = torch_dtype(dtype) or x.dtype
        return torch.zeros_like(x, dtype=dt) + torch.as_tensor(
            v, device=x.device).to(dt)
    return apply_op(f, _arr(a), fill_value)


def empty_like(a, dtype=None, order="C", ctx=None, device=None):
    return zeros_like(a, dtype)


def _arr(a):
    return a if isinstance(a, ndarray) else array(a)


def copy(a):
    return apply_op(torch.clone, _arr(a))


def ascontiguousarray(a, dtype=None):
    return array(a, dtype=dtype)


def asarray(a, dtype=None, ctx=None, device=None):
    if isinstance(a, ndarray) and dtype is None and ctx is None \
            and device is None:
        return a
    return array(a, dtype=dtype, ctx=ctx if ctx is not None else device)


def may_share_memory(a, b, max_work=None):
    return False


def shares_memory(a, b, max_work=None):
    return False


# --------------------------------------------------------------------------
# joining / splitting / stacking
# --------------------------------------------------------------------------
def _seq(seq):
    return list(_as_tensors(list(seq), len(seq)))


def concatenate(seq, axis=0, out=None):
    def f(*xs):
        xs = _promote(*_seq(xs))
        if axis is None:
            return torch.cat([x.reshape(-1) for x in xs])
        return torch.cat(xs, dim=axis)
    return _maybe_out(apply_op(f, *seq), out)


concat = concatenate


def stack(seq, axis=0, out=None):
    return _maybe_out(apply_op(
        lambda *xs: torch.stack(_promote(*_seq(xs)), dim=axis), *seq), out)


def vstack(seq):
    return apply_op(lambda *xs: torch.cat(
        _promote(*_atleast(2)(*_seq(xs))) if len(xs) > 1
        else [_atleast(2)(*_seq(xs))], 0), *seq)


row_stack = vstack


def hstack(seq):
    def f(*xs):
        xs = _promote(*[x if x.dim() else x.reshape(1) for x in _seq(xs)])
        return torch.cat(xs, 0 if xs[0].dim() == 1 else 1)
    return apply_op(f, *seq)


def dstack(seq):
    def f(*xs):
        xs = _seq(xs)
        xs = _atleast(3)(*xs) if len(xs) > 1 else [_atleast(3)(*xs)]
        return torch.cat(_promote(*xs), 2)
    return apply_op(f, *seq)


def column_stack(seq):
    return apply_op(lambda *xs: torch.cat(_promote(*[
        x.reshape(-1, 1) if x.dim() < 2 else x for x in _seq(xs)]), 1),
        *seq)


def _split_points(ary, ios, axis, equal):
    if isinstance(ios, ndarray):
        ios = tuple(ios.asnumpy().tolist())
    if isinstance(ios, int):
        n = ary.shape[axis]
        if equal and n % ios:
            raise ValueError("array split does not result in an equal "
                             "division")
        return ios
    return [int(i) for i in ios]


def split(ary, indices_or_sections, axis=0):
    pts = _split_points(ary, indices_or_sections, axis, True)
    return list(apply_op(lambda x: tuple(torch.tensor_split(x, pts, axis)),
                         ary))


def array_split(ary, indices_or_sections, axis=0):
    pts = _split_points(ary, indices_or_sections, axis, False)
    return list(apply_op(lambda x: tuple(torch.tensor_split(x, pts, axis)),
                         ary))


def hsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 0 if ary.ndim == 1 else 1)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, 2)


def broadcast_arrays(*args):
    return list(apply_op(lambda *xs: tuple(torch.broadcast_tensors(
        *_seq(xs))), *args))


def meshgrid(*xi, **kwargs):
    indexing = kwargs.get("indexing", "xy")
    sparse = kwargs.get("sparse", False)

    def f(*xs):
        xs = [x.reshape(-1) for x in _seq(xs)]
        grids = torch.meshgrid(*xs, indexing=indexing)
        if sparse:
            n = len(xs)
            out = []
            for i, x in enumerate(xs):
                shape = [1] * n
                j = i
                if indexing == "xy" and n > 1 and i < 2:
                    j = 1 - i
                shape[j] = x.shape[0]
                out.append(x.reshape(shape))
            return tuple(out)
        return tuple(grids)
    return list(apply_op(f, *xi))


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)

    def f(c, a, b):
        # a python scalar stays one: torch.where types it weakly, and a
        # tensor made of it on the host would be copied with a wait
        scalar = (int, float, builtins.bool)
        c = _as_tensors([c], 1)[0].to(torch.bool)
        if type(a) in scalar or type(b) in scalar:
            a, b = (v if type(v) in scalar else _as_tensors([v], 1)[0]
                    for v in (a, b))
            return torch.where(c, a, b)
        a, b = _promote(*_as_tensors([a, b], 2))
        return torch.where(c, a, b)
    return apply_op(f, condition, x, y)


def nonzero(a):
    return tuple(apply_op(lambda x: tuple(torch.nonzero(
        _as_tensors([x], 1)[0], as_tuple=True)), a))


def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    # dynamic output shape: a host round-trip, as the JAX package's
    dev = _device_of(ar)
    res = onp.unique(ar.asnumpy() if isinstance(ar, ndarray)
                     else onp.asarray(ar),
                     return_index=return_index, return_inverse=return_inverse,
                     return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(array(r, ctx=dev) for r in res)
    return array(res, ctx=dev)


def isin(element, test_elements, assume_unique=False, invert=False):
    def f(e, t):
        e, t = _as_tensors([e, t], 2)
        return torch.isin(*_promote(e, t), invert=invert)
    return apply_op(f, element, test_elements)


def take(a, indices, axis=None, mode="clip", out=None):
    def f(x, idx):
        idx = _as_tensors([idx], 1)[0].to(x.device).long()
        if axis is None:
            x, ax = x.reshape(-1), 0
        else:
            ax = axis
        n = x.shape[ax]
        if mode == "wrap":
            idx = torch.remainder(idx, n)
        else:
            idx = idx.clamp(0, n - 1)
        flat = x.index_select(ax, idx.reshape(-1))
        shape = list(x.shape[:ax]) + list(idx.shape) + list(
            x.shape[ax + 1:])
        return flat.reshape(shape)
    return _maybe_out(apply_op(f, _arr(a), indices), out)


def _index_pair(fn, *args, device=None):
    return tuple(_wrap(t.to(torch.int32) if t.dtype == torch.int64 and
                       not _X64() else t) for t in fn(*args, device=device))


def _X64():
    from ..ndarray import X64
    return X64


def tril_indices(n, k=0, m=None, ctx=None, device=None):
    dev = _context.resolve(ctx if ctx is not None else device)
    return _index_pair(torch.tril_indices, n, n if m is None else m, k,
                       device=dev)


def triu_indices(n, k=0, m=None, ctx=None, device=None):
    dev = _context.resolve(ctx if ctx is not None else device)
    return _index_pair(torch.triu_indices, n, n if m is None else m, k,
                       device=dev)


def diag_indices(n, ndim=2, ctx=None, device=None):
    dev = ctx if ctx is not None else device
    return tuple(array(x, ctx=dev) for x in onp.diag_indices(n, ndim))


def ix_(*args):
    dev = _device_of(*args)
    return tuple(array(a, ctx=dev) for a in onp.ix_(*[
        a.asnumpy() if isinstance(a, ndarray) else onp.asarray(a)
        for a in args]))


def histogram(a, bins=10, range=None, weights=None, density=None):
    b = _unwrap(bins)
    return apply_op(lambda x, w: _histogram_t(x, b, range, w, density), a,
                    weights)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    def f(x, y):
        x, y = _as_tensors([x, y], 2)
        return _isclose(x, y, rtol, atol, equal_nan).all()
    return builtins.bool(apply_op(f, a, b))


def isclose_bool(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return apply_op(lambda x, y: _isclose(*_as_tensors([x, y], 2), rtol,
                                          atol, equal_nan), a, b)


def _np_dtype_of(a):
    d = a.dtype if isinstance(a, ndarray) else a
    return onp.dtype(onp.float32) if d == torch.bfloat16 else d


def result_type(*arrays_and_dtypes):
    return onp.result_type(*[_np_dtype_of(a) for a in arrays_and_dtypes])


def promote_types(t1, t2):
    return onp.promote_types(t1, t2)


def can_cast(from_, to, casting="safe"):
    if isinstance(from_, ndarray):
        from_ = from_.dtype
    return onp.can_cast(from_, to, casting)


def shape(a):
    return a.shape if isinstance(a, ndarray) else onp.shape(a)


def ndim(a):
    return a.ndim if isinstance(a, ndarray) else onp.ndim(a)


def size(a, axis=None):
    if isinstance(a, ndarray):
        return a.size if axis is None else a.shape[axis]
    return onp.size(a, axis)


def moveaxis_list(a, source, destination):
    return apply_op(lambda x: torch.movedim(x, source, destination), a)


def insert(arr, obj, values, axis=None):
    def f(x, v):
        if axis is None:
            x, ax = x.reshape(-1), 0
        else:
            ax = axis
        v = _as_tensors([v], 1)[0].to(x.device).to(x.dtype)
        o = _unwrap(obj)
        n = x.shape[ax]
        if isinstance(o, slice):
            o = list(_pyrange(*o.indices(n)))
        scalar = isinstance(o, int)
        pos = torch.as_tensor([o] if scalar else o, device=x.device).long()
        pos = torch.where(pos < 0, pos + n, pos)
        if scalar:
            moved = torch.movedim(x, ax, 0)
            vv = torch.broadcast_to(v, (1,) + tuple(moved.shape[1:])) \
                if v.dim() <= moved.dim() - 1 else v
            vv = torch.movedim(vv, 0, 0)
            k = int(pos[0])
            res = torch.cat([moved[:k], vv.reshape(-1, *moved.shape[1:]),
                             moved[k:]])
            return torch.movedim(res, 0, ax)
        moved = torch.movedim(x, ax, 0)
        m = pos.shape[0]
        vv = torch.broadcast_to(v.reshape(-1, *([1] * (moved.dim() - 1)))
                                if v.dim() <= 1 else v,
                                (m,) + tuple(moved.shape[1:]))
        order = torch.argsort(pos, stable=True)
        pos_sorted = pos[order] + torch.arange(m, device=x.device)
        total = n + m
        is_new = torch.zeros(total, dtype=torch.bool, device=x.device)
        is_new[pos_sorted] = True
        out = torch.empty((total,) + tuple(moved.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[is_new] = vv[order]
        out[~is_new] = moved
        return torch.movedim(out, 0, ax)
    return apply_op(f, arr, values)


def flatten(a):
    return a.reshape(-1)


def cast(a, dtype):
    return a.astype(dtype)


def abs_(a):  # a builtin-shadow-safe alias
    return apply_op(torch.abs, a)


def bool_array(a):
    return a.astype(onp.bool_)


def topk(a, k, axis=-1, **kw):
    from ..numpy_extension import topk as _npx_topk
    return _npx_topk(a, axis=axis, k=k, **kw)


def bitwise_not(x, out=None):
    return _maybe_out(apply_op(torch.bitwise_not, x), out)


def fabs(x, out=None):
    return _maybe_out(apply_op(lambda v: torch.abs(_inexact(v)), x), out)


def round_(a, decimals=0, out=None):
    return _maybe_out(apply_op(lambda x: _round(x, decimals), a), out)


def diag_indices_from(arr):
    if arr.ndim < 2 or len(set(arr.shape)) != 1:
        raise ValueError("All dimensions of input must be of equal length")
    return diag_indices(arr.shape[0], arr.ndim, ctx=arr.ctx)


def fill_diagonal(a, val, wrap=False):
    """Diagonal fill, rebinding ``a`` to a new tensor."""
    t = a._data.detach().clone()
    n = builtins.min(t.shape)
    v = torch.as_tensor(_unwrap(val), dtype=t.dtype, device=t.device)
    if t.dim() == 2 and wrap and t.shape[0] > t.shape[1]:
        step = t.shape[1] + 1
        flat = t.reshape(-1)
        idx = torch.arange(0, flat.numel(), step, device=t.device)
        flat[idx] = torch.broadcast_to(v.reshape(-1)[:1] if v.dim() == 0
                                       else v.reshape(-1).repeat(
                                           -(-idx.numel() // v.numel()))[
                                           :idx.numel()], idx.shape)
        a._set_data(flat.reshape(t.shape))
        return
    i = torch.arange(n, device=t.device)
    vals = torch.broadcast_to(v, (n,)) if v.dim() == 0 else \
        v.reshape(-1).repeat(-(-n // v.numel()))[:n]
    t[(i,) * t.dim()] = vals
    a._set_data(t)


def _window(fn, *args, dtype=None, ctx=None, device=None):
    return array(fn(*args), dtype=dtype or float32,
                 ctx=ctx if ctx is not None else device)


def hanning(M, dtype=None, ctx=None, device=None):
    return _window(onp.hanning, M, dtype=dtype, ctx=ctx, device=device)


def hamming(M, dtype=None, ctx=None, device=None):
    return _window(onp.hamming, M, dtype=dtype, ctx=ctx, device=device)


def blackman(M, dtype=None, ctx=None, device=None):
    return _window(onp.blackman, M, dtype=dtype, ctx=ctx, device=device)


def bartlett(M, dtype=None, ctx=None, device=None):
    return _window(onp.bartlett, M, dtype=dtype, ctx=ctx, device=device)


def kaiser(M, beta, dtype=None, ctx=None, device=None):
    return _window(onp.kaiser, M, beta, dtype=dtype, ctx=ctx, device=device)


def multi_dot(arrays):
    return apply_op(lambda *xs: torch.linalg.multi_dot(_promote(*xs)),
                    *arrays)


def rot90_(m, k=1, axes=(0, 1)):
    return apply_op(lambda x: _rot90(x, k, axes), m)


_NP_VERSION = "2.0.0"  # API-parity version string (libinfo.py:150)
__version__ = _NP_VERSION


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    def f(*idx):
        idx = _as_tensors(list(idx), len(idx))
        flat = torch.zeros_like(idx[0]).long()
        for i, d in zip(idx, dims):
            i = i.long()
            i = i.clamp(0, d - 1) if mode != "wrap" else torch.remainder(
                i, d)
            flat = flat * d + i
        return flat
    mi = list(multi_index) if isinstance(multi_index, (list, tuple)) \
        else list(multi_index)
    return apply_op(f, *mi)


def sort_complex(a):
    def f(x):
        x = x if x.is_complex() else x.to(torch.complex64)
        order = torch.argsort(x.imag, stable=True)
        x = x[order]
        order = torch.argsort(x.real, stable=True)
        return x[order]
    return apply_op(f, a)


def msort(a):
    return apply_op(lambda x: _sort(x, axis=0), a)


def place(arr, mask, vals):
    """Put ``vals`` (cycled) where ``mask`` is true, rebinding ``arr``."""
    t = arr._data.detach().clone()
    m = _to_tensor(mask, device=t.device).to(torch.bool)
    v = _to_tensor(vals, dtype=t.dtype, device=t.device).reshape(-1)
    n = int(m.sum())
    if n:
        t[m] = v.repeat(-(-n // v.numel()))[:n]
    arr._set_data(t)


def put(a, ind, v, mode="clip"):
    """Write ``v`` at flat indices ``ind``, rebinding ``a``."""
    t = a._data.detach().clone()
    idx = _to_tensor(ind, device=t.device).long().reshape(-1)
    n = t.numel()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    vals = _to_tensor(v, dtype=t.dtype, device=t.device).reshape(-1)
    vals = vals.repeat(-(-idx.numel() // vals.numel()))[:idx.numel()]
    flat = t.reshape(-1)
    flat[idx] = vals
    a._set_data(flat.reshape(t.shape))


def choose(a, choices, out=None, mode="raise"):
    def f(x, *ch):
        ch = _as_tensors(list(ch), len(ch))
        idx = x.long().clamp(0, len(ch) - 1)
        stacked = torch.stack(torch.broadcast_tensors(*_promote(*ch), idx)[
            :len(ch)])
        idx = torch.broadcast_to(idx, stacked.shape[1:])
        return torch.gather(stacked, 0, idx.unsqueeze(0)).squeeze(0)
    return _maybe_out(apply_op(f, a, *choices), out)


def require(a, dtype=None, requirements=None):
    return asarray(a, dtype=dtype)


def trapz(y, x=None, dx=1.0, axis=-1):
    """Trapezoidal integration (parity: np.trapz via the reference's numpy
    fallback list, python/mxnet/numpy/fallback.py)."""
    if x is not None:
        return apply_op(lambda yy, xx: _trapz(yy, xx, axis=axis), y, x)
    return apply_op(lambda yy: _trapz(yy, dx=dx, axis=axis), y)


def _poly_pair(a1, a2):
    a1, a2 = _promote(*_as_tensors([a1, a2], 2))
    n = builtins.max(a1.shape[0], a2.shape[0])
    return (F.pad(a1, (n - a1.shape[0], 0)), F.pad(a2, (n - a2.shape[0], 0)))


def polyadd(a1, a2):
    return apply_op(lambda x, y: torch.add(*_poly_pair(x, y)), a1, a2)


def polysub(a1, a2):
    return apply_op(lambda x, y: torch.sub(*_poly_pair(x, y)), a1, a2)


def polymul(a1, a2):
    def f(x, y):
        x, y = _promote(*_as_tensors([x, y], 2))
        xf, yf = _inexact(x), _inexact(y)
        return _conv_full(xf if xf.shape[0] >= yf.shape[0] else yf,
                          yf if xf.shape[0] >= yf.shape[0] else xf)
    return apply_op(f, a1, a2)


def polydiv(u, v):
    def f(uu, vv):
        uu, vv = _promote(*[_inexact(t) for t in _as_tensors([uu, vv], 2)])
        m, n = uu.shape[0] - 1, vv.shape[0] - 1
        scale = 1.0 / vv[0]
        q = torch.zeros(builtins.max(m - n + 1, 1), dtype=uu.dtype,
                        device=uu.device)
        r = uu.clone()
        for k in _pyrange(0, m - n + 1):
            d = scale * r[k]
            q = torch.cat([q[:k], d.reshape(1), q[k + 1:]])
            r = torch.cat([r[:k], r[k:k + n + 1] - d * vv, r[k + n + 1:]])
        return q, r
    return apply_op(f, u, v)


def roots(p):
    """Polynomial roots (a host LAPACK path, as the JAX package's)."""
    dev = _device_of(p)
    return array(onp.roots(onp.asarray(
        p.asnumpy() if isinstance(p, ndarray) else p)), ctx=dev)


# -- indexing helpers ------------------------------------------------------
def _encode_index(key):
    """JSON-safe encoding of a basic-indexing key (ints / slices /
    Ellipsis)."""
    if not isinstance(key, tuple):
        key = (key,)
    spec = []
    for k in key:
        if isinstance(k, slice):
            spec.append(["slice", k.start, k.stop, k.step])
        elif k is Ellipsis:
            spec.append("ellipsis")
        elif isinstance(k, (int, onp.integer)):
            spec.append(int(k))
        else:
            raise TypeError(
                "symbolic indexing supports ints/slices/Ellipsis, got %r"
                % (k,))
    return spec


def _decode_index(spec):
    key = []
    for k in spec:
        if isinstance(k, (list, tuple)) and len(k) == 4 and k[0] == "slice":
            key.append(slice(k[1], k[2], k[3]))
        elif k == "ellipsis":
            key.append(Ellipsis)
        else:
            key.append(int(k))
    return tuple(key)


def getitem(a, key):
    """Replay of an encoded basic-indexing key (``a[1:3, 0]``)."""
    a = a if isinstance(a, ndarray) else array(a)
    return a[_decode_index(key)]


def onnx_expand(a, shape):
    """Bidirectional broadcast (ONNX Expand semantics)."""
    a = a if isinstance(a, ndarray) else array(a)
    shape = tuple(int(s) for s in shape)
    return apply_op(lambda x: torch.broadcast_to(
        x, onp.broadcast_shapes(tuple(x.shape), shape)), a)

