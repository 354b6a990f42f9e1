"""NumPy interop protocol for the port's ndarrays (the port of
``mxnet_tpu/numpy_dispatch.py``).

Parity: reference ``python/mxnet/numpy_dispatch_protocol.py:37`` (registers
the mx ndarray with NumPy's ``__array_function__``/``__array_ufunc__``
protocols) and ``python/mxnet/numpy/fallback.py:25,116-142`` (allow-listed
real-NumPy fallbacks for functions mx does not implement).

Design: instead of a hand-registered per-function dict, dispatch
resolves ``func.__name__`` against the ``mx.np`` / ``mx.np.linalg`` /
``mx.np.random`` namespaces at call time — every op those modules grow is
immediately protocol-visible.  Functions absent from mx but on the fallback
allow-list run real NumPy on host-fetched copies and wrap the result back
into device ndarrays (same contract as the reference's generated wrappers).

Effect: ``numpy.mean(mx_array)``, ``numpy.concatenate([mx, mx])``,
``numpy.where(cond_mx, a, b)`` and mixed numpy/mx user code take the mx
path instead of silently coercing through ``__array__``.
"""
from __future__ import annotations

import re
import warnings

import numpy as onp

# Call-binding TypeError shapes (CPython's "cannot bind these arguments"
# messages).  Only these divert a ufunc call to the host fallback: an mx
# implementation exists but doesn't accept this calling convention (e.g.
# numpy-protocol kwargs like casting=/order= that torch ops do not take).
# Any other TypeError is a genuine user argument error and must surface
# instead of silently moving the work to host NumPy.
_SIG_MISMATCH = re.compile(
    r"unexpected keyword argument|positional argument|"
    r"got multiple values for|missing \d+ required")

_FALLBACK_WARNED = set()


def _warn_ufunc_fallback(name, reason):
    """One-time (per ufunc name, per process) host-fallback warning."""
    if name in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(name)
    warnings.warn(
        "numpy.%s on mxnet_tpu_torch arrays fell back to host NumPy "
        "(mx.np.%s rejected the call signature: %s); the computation ran "
        "on host "
        "copies, not on device" % (name, name, reason),
        RuntimeWarning, stacklevel=4)

# Functions mx.np does not implement but real NumPy may run on host copies
# (reference numpy/fallback.py:25 allow-list, minus entries whose semantics
# need framework support).  Results are wrapped back into mx ndarrays.
FALLBACK = frozenset({
    "allclose", "alltrue", "apply_along_axis", "apply_over_axes",
    "argpartition", "argwhere", "array_equal", "array_equiv", "choose",
    "compress", "corrcoef", "correlate", "count_nonzero", "cov",
    "cumprod", "digitize", "divmod", "extract", "float_power", "frexp",
    "heaviside", "histogram2d", "histogram_bin_edges", "histogramdd",
    "i0", "in1d", "intersect1d", "isclose", "isin", "ix_", "lexsort",
    "min_scalar_type", "mirr", "modf", "msort", "nanargmax", "nanargmin",
    "nancumprod", "nancumsum", "nanmax", "nanmedian", "nanmin",
    "nanpercentile", "nanprod", "nanquantile", "nansum", "ndim", "npv",
    "packbits", "partition", "piecewise", "ptp", "searchsorted",
    "select", "setdiff1d", "setxor1d", "signbit", "size", "spacing",
    "take_along_axis", "trapz", "tril_indices_from", "trim_zeros",
    "union1d", "unpackbits", "unwrap", "vander",
})

# ufunc names whose mx spelling differs from the NumPy ufunc name
_UFUNC_ALIASES = {
    "absolute": "abs",
    "conjugate": "conj",
    "true_divide": "divide",
}


def _mx_np():
    from . import numpy as mxnp
    return mxnp


def _to_host(obj):
    """ndarray → numpy (recursively through containers); else unchanged."""
    from .ndarray import ndarray
    if isinstance(obj, ndarray):
        return obj.asnumpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _wrap_host(res, device=None):
    """numpy results → ndarrays on ``device`` (the first ndarray
    argument's; scalars/bools stay host values)."""
    from .ndarray import array
    if isinstance(res, onp.ndarray):
        return array(res, ctx=device)
    if isinstance(res, (list, tuple)):
        return type(res)(_wrap_host(r, device) for r in res)
    return res


def _resolve(func):
    """Map a NumPy function object to the mx implementation (or None)."""
    mxnp = _mx_np()
    name = getattr(func, "__name__", None)
    if not name:
        return None
    mod = getattr(func, "__module__", "") or ""
    if "linalg" in mod:
        return getattr(mxnp.linalg, name, None)
    if "random" in mod:
        return getattr(mxnp.random, name, None)
    target = getattr(mxnp, name, None)
    # guard against non-function module attributes shadowing (e.g. dtype)
    return target if callable(target) else None


def array_function(self, func, types, args, kwargs):
    """``ndarray.__array_function__`` body.

    Resolution order: mx implementation → allow-listed host fallback
    (wrapped back to device arrays) → generic host fallback returning
    HOST results.  The last tier preserves pre-protocol behavior: before
    __array_function__ existed, numpy.fft.fft(mx_array) etc. coerced
    through __array__ and returned host arrays — they must keep
    working."""
    target = _resolve(func)
    if target is not None:
        return target(*args, **kwargs)
    name = getattr(func, "__name__", "")
    if name in FALLBACK:
        return _wrap_host(func(*_to_host(args), **_to_host(kwargs)),
                          self.ctx)
    return func(*_to_host(args), **_to_host(kwargs))


def array_ufunc(self, ufunc, method, *inputs, **kwargs):
    """``ndarray.__array_ufunc__`` body.

    ``__call__`` dispatches to the same-named mx.np function; other
    methods (reduce/accumulate/outer) and unimplemented ufuncs run real
    NumPy on host copies and wrap back (fallback contract)."""
    from .ndarray import ndarray

    out = kwargs.pop("out", None)
    if method == "__call__":
        mxnp = _mx_np()
        name = _UFUNC_ALIASES.get(ufunc.__name__, ufunc.__name__)
        target = getattr(mxnp, name, None)
        if callable(target):
            try:
                res = target(*inputs, **kwargs)
            except TypeError as e:
                # host fallback ONLY for signature mismatch (mx op exists
                # but doesn't take this calling convention); genuine user
                # argument errors re-raise instead of running on host
                if not _SIG_MISMATCH.search(str(e)):
                    raise
                _warn_ufunc_fallback(name, e)
                res = None  # fall back below
        else:
            res = None
        if res is None:
            res = _wrap_host(getattr(ufunc, method)(
                *_to_host(inputs), **_to_host(kwargs)), self.ctx)
    elif method == "at":
        # in-place scatter (np.add.at): run on a host copy, then write
        # the mutated copy back into the device array — returning the
        # unmutated original would be a silent no-op
        host = [_to_host(i) for i in inputs]
        getattr(ufunc, method)(*host, **_to_host(kwargs))
        target0 = inputs[0]
        if isinstance(target0, ndarray):
            target0[...] = host[0]
        return None  # ufunc.at returns None
    else:
        res = _wrap_host(getattr(ufunc, method)(
            *_to_host(inputs), **_to_host(kwargs)), self.ctx)

    if out is None:
        return res
    targets = out if isinstance(out, tuple) else (out,)
    results = res if isinstance(res, tuple) else (res,)
    for o, r in zip(targets, results):
        val = r.asnumpy() if isinstance(r, ndarray) else onp.asarray(r)
        o[...] = val  # works for both mx ndarrays and numpy out arrays
    # NumPy passes out as a 1-tuple; callers expect the bare array back
    return targets[0] if len(targets) == 1 else out
