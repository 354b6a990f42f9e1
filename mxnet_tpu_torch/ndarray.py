"""ndarray: the imperative array over a torch tensor (the port of
``mxnet_tpu/ndarray.py``; parity: reference ``include/mxnet/ndarray.h:82``
and ``python/mxnet/numpy/multiarray.py``).

An ``ndarray`` holds one torch tensor on an explicit device
(``ndarray._data``).  Every operator goes through :func:`apply_op`, the
``Imperative::Invoke`` of the port: it unwraps the ndarray arguments,
runs the torch computation under ``torch.set_grad_enabled(
autograd.is_recording())`` (so torch autograd records inside ``record()``
only, ``autograd.py``) and wraps the tensors that come out.  CUDA streams
are asynchronous already, so there is no op bulking (the JAX package's
``_bulk.py`` batches XLA dispatches; it stays unported) and no buffer
tracking: :func:`waitall` synchronises the devices and raises an error
stashed by :func:`defer_error`.

Decisions, each held by ``tests/test_torch_ndarray.py``:

- **Dtypes follow the JAX package with x64 off.**  A 64-bit value becomes
  32-bit wherever it enters (``array``: an int64 numpy array gives int32,
  float64 float32, a python int int32, a python float float32) and
  wherever an op makes one (torch's int64 sums, argmax indices,
  ``arange``, float64 results are cast back to 32 bits; :func:`_canon`).
  An int64 or uint64 input outside the 32-bit range raises
  ``OverflowError`` instead of wrapping.  ``MXNET_INT64_TENSOR_SIZE=1``
  (read at import) keeps 64-bit values, as JAX's x64 mode does.  Python
  scalars are weak: ``int32 + 2`` stays int32, ``int32 / 2`` and
  ``int32 + 0.5`` are float32, ``float16 * 2.0`` stays float16.
- **Value semantics.**  A JAX array never aliases another; torch's
  views do.  Here no op writes into a tensor it was given or returned:
  ``__setitem__``, the in-place operators, ``copyto``, ``fill_diagonal``,
  ``put``, ``place`` and ``shuffle`` build a new tensor and rebind the
  ndarray to it (``_set_data``), so a reshape or slice taken earlier
  keeps its values.  ``asnumpy()`` returns a copy, and ``array(numpy)``
  copies.  ``__dlpack__`` shares memory by the protocol's nature.
- **bfloat16 to numpy.**  NumPy has no bfloat16 without ``ml_dtypes``,
  which the card's machine lacks, so ``asnumpy()`` of a bfloat16 array
  raises ``TypeError`` on every machine (cast first:
  ``a.astype("float32").asnumpy()``).  ``a.dtype`` of a bfloat16 array
  is ``np.bfloat16`` (``torch.bfloat16``); every other dtype is a numpy
  dtype.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as onp
import torch

from . import autograd
from . import context as _context
from .profiler import _AGG as _profiler_agg

__all__ = ["ndarray", "NDArray", "apply_op", "array", "from_numpy",
           "waitall", "X64"]

#: 64-bit values kept (``MXNET_INT64_TENSOR_SIZE=1``), as JAX's x64 mode
X64 = os.environ.get("MXNET_INT64_TENSOR_SIZE", "0").lower() in (
    "1", "true", "yes", "on")

_T2N = {torch.float32: onp.dtype("float32"),
        torch.float64: onp.dtype("float64"),
        torch.float16: onp.dtype("float16"),
        torch.int8: onp.dtype("int8"), torch.int16: onp.dtype("int16"),
        torch.int32: onp.dtype("int32"), torch.int64: onp.dtype("int64"),
        torch.uint8: onp.dtype("uint8"), torch.bool: onp.dtype("bool"),
        torch.complex64: onp.dtype("complex64"),
        torch.complex128: onp.dtype("complex128")}
for _n in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _n):
        _T2N[getattr(torch, _n)] = onp.dtype(_n)
_N2T = {v: k for k, v in _T2N.items()}
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}
if hasattr(torch, "uint64"):
    _NARROW[torch.uint64] = torch.uint32


def torch_dtype(d):
    """The torch dtype of a numpy dtype, a type, a string or a torch
    dtype (None stays None), narrowed to 32 bits unless :data:`X64`."""
    if d is None:
        return None
    if isinstance(d, torch.dtype):
        t = d
    elif d is bool:
        t = torch.bool
    elif d is int:
        t = torch.int64
    elif d is float:
        t = torch.float64
    elif str(d) in ("bfloat16", "torch.bfloat16") or getattr(
            d, "__name__", None) == "bfloat16":
        t = torch.bfloat16
    else:
        t = _N2T[onp.dtype(d)]
    return t if X64 else _NARROW.get(t, t)


def numpy_dtype(t):
    """The numpy dtype of torch dtype ``t`` (``torch.bfloat16`` for
    bfloat16, which numpy lacks)."""
    return torch.bfloat16 if t == torch.bfloat16 else _T2N[t]


def _canon(t):
    """``t`` with a 64-bit dtype narrowed to 32 bits unless X64."""
    if not X64:
        n = _NARROW.get(t.dtype)
        if n is not None:
            return t.to(n)
    return t


_SCALAR_DTYPE = {bool: torch.bool, int: torch.int64 if X64 else torch.int32,
                 float: torch.float64 if X64 else torch.float32,
                 complex: torch.complex128 if X64 else torch.complex64}


def _guard_int64(src, dtype):
    """OverflowError for an int64/uint64 numpy array whose values do not
    fit the 32 bits they narrow to (x64 off, no explicit narrow dtype)."""
    if X64 or src.dtype not in (onp.int64, onp.uint64) or src.size == 0:
        return
    if dtype is not None and torch_dtype(dtype).itemsize <= 4:
        return
    lo, hi = int(src.min()), int(src.max())
    bound_lo, bound_hi = ((0, 2 ** 32) if src.dtype == onp.uint64
                          else (-2 ** 31, 2 ** 31))
    if lo < bound_lo or hi >= bound_hi:
        raise OverflowError(
            "%s value %d does not fit %s and would be silently truncated; "
            "set MXNET_INT64_TENSOR_SIZE=1 to enable true int64 tensors"
            % (src.dtype.name, hi if hi >= bound_hi else lo,
               "uint32" if src.dtype == onp.uint64 else "int32"))


def _to_tensor(obj, dtype=None, device=None):
    """A tensor of ``obj`` (an ndarray, tensor, python scalar, numpy array
    or nested list) on ``device`` (resolved when None and ``obj`` has no
    device of its own), in ``dtype`` or the canonical dtype of ``obj``."""
    td = torch_dtype(dtype)
    if isinstance(obj, ndarray):
        obj = obj._data
    if isinstance(obj, torch.Tensor):
        t = obj
        if device is not None:
            t = t.to(_context.resolve(device))
        return _canon(t) if td is None else t.to(td)
    dev = _context.resolve(device)
    if type(obj) in _SCALAR_DTYPE:
        return torch.tensor(obj, dtype=td or _SCALAR_DTYPE[type(obj)],
                            device=dev)
    src = onp.asarray(obj)
    if src.dtype == object:
        raise TypeError("cannot make an array of %r" % (obj,))
    if src.dtype.name == "bfloat16":        # an ml_dtypes array
        return torch.tensor(src.astype(onp.float32), device=dev).to(
            td or torch.bfloat16)
    _guard_int64(src, dtype)
    want = td or torch_dtype(src.dtype)
    inter = numpy_dtype(want) if want != torch.bfloat16 else onp.float32
    if want in _N2T.values() and inter != src.dtype:
        src = src.astype(inter)
    return torch.tensor(src, device=dev).to(want)


# --------------------------------------------------------------------------
# wrapping and dispatch
# --------------------------------------------------------------------------
def _wrap(t):
    arr = ndarray.__new__(ndarray)
    arr._data = t
    arr._marked = False
    arr._grad = None
    arr._grad_req = "write"
    return arr


def _wrap_out(out):
    if isinstance(out, torch.Tensor):
        return _wrap(_canon(out))
    if isinstance(out, tuple):
        return tuple(_wrap_out(o) for o in out)
    if isinstance(out, list):
        return [_wrap_out(o) for o in out]
    return out


def _unwrap(x):
    return x._data if isinstance(x, ndarray) else x


def _unwrap_deep(x):
    if isinstance(x, ndarray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap_deep(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap_deep(v) for k, v in x.items()}
    return x


def apply_op(fn, *args, **kwargs):
    """Run ``fn`` over the tensors of ``args`` (ndarrays unwrapped, lists
    and tuples of ndarrays too; any other value passed as it is) with
    ``kwargs``, recording for autograd inside ``record()``; wrap every
    tensor of the result (one, or a tuple or list of them) as an ndarray
    with its dtype made canonical (:func:`_canon`)."""
    if _profiler_agg["enabled"]:
        # per-op aggregate statistics (profiler.set_config(
        # aggregate_stats=True)): the host time of the call
        t0 = time.perf_counter()
        try:
            return _apply(fn, args, kwargs)
        finally:
            from . import profiler
            profiler.record_op_stat(getattr(fn, "__name__", "op"),
                                    time.perf_counter() - t0)
    return _apply(fn, args, kwargs)


def _apply(fn, args, kwargs):
    vals = [_unwrap_deep(a) for a in args]
    with torch.set_grad_enabled(autograd.is_recording()):
        out = fn(*vals, **kwargs)
    return _wrap_out(out)


def _device_of(*args):
    """The device of the first ndarray or tensor among ``args`` (nested
    lists searched), else None."""
    for a in args:
        if isinstance(a, ndarray):
            return a._data.device
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, (list, tuple)):
            d = _device_of(*a)
            if d is not None:
                return d
    return None


_DEFERRED_ERRORS = []
_ERR_LOCK = threading.Lock()


def defer_error(e):
    """Stash an asynchronous failure for the next :func:`waitall`."""
    with _ERR_LOCK:
        _DEFERRED_ERRORS.append(e)


def waitall():
    """Block until all pending work on every device completes (parity:
    ``mx.nd.waitall``): a synchronisation of each CUDA device, then the
    first stashed asynchronous error, if any, is raised."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    with _ERR_LOCK:
        errors = list(_DEFERRED_ERRORS)
        _DEFERRED_ERRORS.clear()
    if errors:
        raise errors[0]


def array(obj, dtype=None, ctx=None, device=None):
    """An ndarray of ``obj`` on ``ctx``/``device`` (the default device
    when neither is given and ``obj`` has no device), always a copy."""
    dev = ctx if ctx is not None else device
    if isinstance(obj, (ndarray, torch.Tensor)):
        t = _to_tensor(obj, dtype, dev)
        src = _unwrap(obj)
        if t is src or t.data_ptr() == src.data_ptr():
            t = t.clone()
        return _wrap(t.detach())
    return _wrap(_to_tensor(obj, dtype, dev))


def from_numpy(a, zero_copy=False):
    return array(a)


def _np():
    from . import numpy as np
    return np


# --------------------------------------------------------------------------
# indexing (torch takes no negative slice step)
# --------------------------------------------------------------------------
def _index_key(key):
    """``key`` with ndarrays unwrapped, numpy arrays and lists of ints as
    tensors, integer index tensors as int64."""
    if not isinstance(key, tuple):
        key = (key,)
    out = []
    for k in key:
        k = _unwrap(k)
        if isinstance(k, onp.ndarray) or (isinstance(k, list) and k and all(
                isinstance(v, (int, bool, onp.integer)) for v in k)):
            k = torch.as_tensor(onp.asarray(k))
        if isinstance(k, torch.Tensor) and k.dtype not in (torch.bool,
                                                           torch.int64):
            k = k.long()
        out.append(k)
    return tuple(out)


def _getitem(t, key):
    key = _index_key(key)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in key):
        return t[key]
    # expand the ellipsis, then take each negative-step slice by an index
    # along its dim first
    n_used = sum(k.ndim if isinstance(k, torch.Tensor) and k.dtype ==
                 torch.bool else (0 if k is None or k is Ellipsis else 1)
                 for k in key)
    full = []
    for k in key:
        if k is Ellipsis:
            full.extend([slice(None)] * (t.ndim - n_used))
        else:
            full.append(k)
    if Ellipsis not in key:
        full.extend([slice(None)] * (t.ndim - n_used))
    dim = 0
    for i, k in enumerate(full):
        if k is None:
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            idx = torch.arange(*k.indices(t.shape[dim]), device=t.device)
            t = t.index_select(dim, idx)
            full[i] = slice(None)
        dim += k.ndim if (isinstance(k, torch.Tensor)
                          and k.dtype == torch.bool) else 1
    return t[tuple(full)]


# --------------------------------------------------------------------------
# the ndarray class
# --------------------------------------------------------------------------
class ndarray:
    """NumPy-compatible imperative array over a torch tensor
    (``mx.np.ndarray`` parity)."""

    __slots__ = ("_data", "_marked", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data=None, dtype=None, ctx=None):
        self._data = _to_tensor(data if data is not None else (), dtype, ctx)
        self._marked = False
        self._grad = None
        self._grad_req = "write"

    # -- properties -------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def itemsize(self):
        return self._data.element_size()

    @property
    def T(self):
        return self.transpose()

    @property
    def ctx(self):
        return self._data.device

    context = ctx
    device = ctx

    @property
    def grad(self):
        return self._grad

    @property
    def stype(self):
        return "default"

    # -- autograd ---------------------------------------------------------
    def _mark(self, grad_req):
        self._marked = True
        self._grad_req = grad_req
        t = self._data.detach()
        if t.is_floating_point() or t.is_complex():
            t.requires_grad_(True)
        self._data = t
        autograd._register_leaf(self)

    def attach_grad(self, grad_req="write"):
        """Make this array a leaf with a zero gradient array (parity:
        ``NDArray.attach_grad``)."""
        self._mark(grad_req)
        self._grad = _wrap(torch.zeros_like(self._data,
                                            requires_grad=False))

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph, train_mode)

    def detach(self):
        return _wrap(self._data.detach())

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)

    # -- sync points ------------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy (bfloat16 raises ``TypeError``: cast first)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            raise TypeError("asnumpy: numpy has no bfloat16; cast first "
                            "(a.astype('float32').asnumpy())")
        if t.is_cuda:
            return t.cpu().numpy()
        return t.numpy().copy()

    def item(self, *args):
        if args:
            return self.asnumpy().item(*args)
        if self.size != 1:
            raise ValueError("can only convert an array of size 1 to a "
                             "Python scalar")
        return self._data.item()

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __array_function__(self, func, types, args, kwargs):
        from .numpy_dispatch import array_function
        return array_function(self, func, types, args, kwargs)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        from .numpy_dispatch import array_ufunc
        return array_ufunc(self, ufunc, method, *inputs, **kwargs)

    def __dlpack__(self, **kw):
        return self._data.detach().__dlpack__(**kw)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    # -- conversion / movement -------------------------------------------
    def astype(self, dtype, copy=True):
        td = torch_dtype(dtype)
        if td == self._data.dtype and not copy:
            return self
        return apply_op(lambda x: x.to(td), self)

    def copy(self):
        return apply_op(torch.clone, self)

    def copyto(self, other):
        if isinstance(other, ndarray):
            other._set_data(torch.broadcast_to(
                self._data.detach(), other.shape).to(other._data.dtype)
                .to(other._data.device).clone())
            return other
        return self.as_in_ctx(other)

    def as_in_ctx(self, ctx):
        dev = _context.resolve(ctx)
        return apply_op(lambda x: x.to(dev), self)

    as_in_context = as_in_ctx
    to_device = as_in_ctx

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    # -- mutation ---------------------------------------------------------
    def _set_data(self, data):
        """Rebind to ``data`` (the one way an ndarray changes value)."""
        if autograd.is_recording() and self._data.grad_fn is not None:
            raise RuntimeError(
                "in-place mutation of an array produced inside a record() "
                "scope is not allowed (reference: kWriteInplace hazard)")
        data = data.detach()
        if self._marked and (data.is_floating_point() or data.is_complex()):
            data.requires_grad_(True)
        self._data = data

    def __setitem__(self, key, value):
        with torch.no_grad():
            t = self._data.detach()
            v = _to_tensor(value, dtype=t.dtype, device=t.device)
            if isinstance(key, tuple) and len(key) == 0:
                key = Ellipsis
            k = _index_key(key)
            new = t.clone()
            if any(isinstance(x, slice) and x.step is not None and x.step < 0
                   for x in k):
                pos = _getitem(torch.arange(t.numel(), device=t.device)
                               .reshape(t.shape), key)
                new.view(-1)[pos.reshape(-1)] = torch.broadcast_to(
                    v, pos.shape).reshape(-1)
            else:
                new[k] = v
        self._set_data(new)

    def __getitem__(self, key):
        if isinstance(key, ndarray) and key._data.dtype == torch.bool:
            key = key._data
        return apply_op(lambda x: _getitem(x, key), self)

    # -- python scalars --------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size != 1:
            raise ValueError(
                "The truth value of an ndarray with %d elements is "
                "ambiguous. Use a.any() or a.all()." % self.size)
        return bool(self._data.item())

    def __float__(self):
        return float(self._data.item())

    def __int__(self):
        return int(self._data.item())

    def __index__(self):
        return int(self._data.item())

    def __repr__(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        s = str(t.cpu().numpy())
        return "array(%s, ctx=%s)" % (s.replace("\n", "\n      "),
                                      self.ctx)

    __hash__ = None

    # -- arithmetic -------------------------------------------------------
    def _binary(self, other, name, reverse=False):
        fn = getattr(_np(), name)
        if isinstance(other, (list, tuple, onp.ndarray)):
            other = array(other, ctx=self._data.device)
        return fn(other, self) if reverse else fn(self, other)

    def __add__(self, o):
        return self._binary(o, "add")

    def __radd__(self, o):
        return self._binary(o, "add", True)

    def __sub__(self, o):
        return self._binary(o, "subtract")

    def __rsub__(self, o):
        return self._binary(o, "subtract", True)

    def __mul__(self, o):
        return self._binary(o, "multiply")

    def __rmul__(self, o):
        return self._binary(o, "multiply", True)

    def __truediv__(self, o):
        return self._binary(o, "true_divide")

    def __rtruediv__(self, o):
        return self._binary(o, "true_divide", True)

    def __floordiv__(self, o):
        return self._binary(o, "floor_divide")

    def __rfloordiv__(self, o):
        return self._binary(o, "floor_divide", True)

    def __mod__(self, o):
        return self._binary(o, "mod")

    def __rmod__(self, o):
        return self._binary(o, "mod", True)

    def __divmod__(self, o):
        return self // o, self % o

    def __pow__(self, o):
        return self._binary(o, "power")

    def __rpow__(self, o):
        return self._binary(o, "power", True)

    def __matmul__(self, o):
        return self._binary(o, "matmul")

    def __rmatmul__(self, o):
        return self._binary(o, "matmul", True)

    def __neg__(self):
        return _np().negative(self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _np().abs(self)

    def __invert__(self):
        return _np().invert(self)

    def __and__(self, o):
        return self._binary(o, "bitwise_and")

    def __or__(self, o):
        return self._binary(o, "bitwise_or")

    def __xor__(self, o):
        return self._binary(o, "bitwise_xor")

    def __rand__(self, o):
        return self._binary(o, "bitwise_and", True)

    def __ror__(self, o):
        return self._binary(o, "bitwise_or", True)

    def __rxor__(self, o):
        return self._binary(o, "bitwise_xor", True)

    def __lshift__(self, o):
        return self._binary(o, "left_shift")

    def __rshift__(self, o):
        return self._binary(o, "right_shift")

    def __eq__(self, o):
        return self._binary(o, "equal")

    def __ne__(self, o):
        return self._binary(o, "not_equal")

    def __lt__(self, o):
        return self._binary(o, "less")

    def __le__(self, o):
        return self._binary(o, "less_equal")

    def __gt__(self, o):
        return self._binary(o, "greater")

    def __ge__(self, o):
        return self._binary(o, "greater_equal")

    # in-place: a new value, rebound (never a write into the tensor), not
    # recorded, as the JAX package's are not
    def _inplace(self, o, name):
        with autograd.pause():
            res = self._binary(o, name)
        self._set_data(res._data.to(self._data.dtype))
        return self

    def __iadd__(self, o):
        return self._inplace(o, "add")

    def __isub__(self, o):
        return self._inplace(o, "subtract")

    def __imul__(self, o):
        return self._inplace(o, "multiply")

    def __itruediv__(self, o):
        return self._inplace(o, "true_divide")

    def __ifloordiv__(self, o):
        return self._inplace(o, "floor_divide")

    def __imod__(self, o):
        return self._inplace(o, "mod")

    def __ipow__(self, o):
        return self._inplace(o, "power")

    # -- methods mirroring mx.np.ndarray ---------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        return apply_op(lambda x: x.reshape(shape), self)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _np().transpose(self, axes if axes else None)

    def swapaxes(self, a, b):
        return _np().swapaxes(self, a, b)

    def flatten(self):
        return self.reshape(-1)

    def ravel(self):
        return self.reshape(-1)

    def squeeze(self, axis=None):
        return _np().squeeze(self, axis)

    def expand_dims(self, axis):
        return _np().expand_dims(self, axis)

    def broadcast_to(self, shape):
        return _np().broadcast_to(self, shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def repeat(self, repeats, axis=None):
        return _np().repeat(self, repeats, axis)

    def tile(self, reps):
        return _np().tile(self, reps)

    def take(self, indices, axis=None, mode="clip"):
        return _np().take(self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False, mode="clip"):
        from . import numpy_extension as npx
        return npx.pick(self, index, axis=axis, keepdims=keepdims,
                        mode=mode)

    def clip(self, a_min=None, a_max=None):
        return _np().clip(self, a_min, a_max)

    def round(self, decimals=0):
        return _np().round(self, decimals)

    def sum(self, axis=None, dtype=None, keepdims=False, **kw):
        return _np().sum(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def mean(self, axis=None, dtype=None, keepdims=False, **kw):
        return _np().mean(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def prod(self, axis=None, dtype=None, keepdims=False, **kw):
        return _np().prod(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return _np().max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return _np().min(self, axis=axis, keepdims=keepdims)

    def std(self, axis=None, dtype=None, ddof=0, keepdims=False, **kw):
        return _np().std(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, dtype=None, ddof=0, keepdims=False, **kw):
        return _np().var(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def argmax(self, axis=None, **kw):
        return _np().argmax(self, axis=axis)

    def argmin(self, axis=None, **kw):
        return _np().argmin(self, axis=axis)

    def argsort(self, axis=-1, is_ascend=True, **kw):
        r = _np().argsort(self, axis=axis)
        return r if is_ascend else _np().flip(r, axis=axis)

    def sort(self, axis=-1, **kw):
        return _np().sort(self, axis=axis)

    def cumsum(self, axis=None, dtype=None):
        return _np().cumsum(self, axis=axis, dtype=dtype)

    def dot(self, other):
        return self._binary(other, "dot")

    def all(self, axis=None, keepdims=False):
        return _np().all(self, axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False):
        return _np().any(self, axis=axis, keepdims=keepdims)

    def nonzero(self):
        return _np().nonzero(self)

    def abs(self):
        return _np().abs(self)

    def sqrt(self):
        return _np().sqrt(self)

    def square(self):
        return _np().square(self)

    def log(self):
        return _np().log(self)

    def exp(self):
        return _np().exp(self)

    def sigmoid(self):
        return _np().sigmoid(self)

    def tanh(self):
        return _np().tanh(self)

    def relu(self):
        return apply_op(torch.relu, self)

    def slice_axis(self, axis, begin, end):
        sl = [slice(None)] * self.ndim
        sl[axis] = slice(begin, end)
        return self[tuple(sl)]

    def tostype(self, stype):
        if stype == "default":
            return self
        raise NotImplementedError(
            "tostype(%r): sparse storage is ROADMAP item 9 (sparse.py)"
            % (stype,))


NDArray = ndarray
