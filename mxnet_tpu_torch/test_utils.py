"""Test helpers (the port of ``mxnet_tpu/test_utils.py``; parity:
reference python/mxnet/test_utils.py).

The reference suite's workhorses — `default_context` (:57), `rand_ndarray`
(:484), `assert_almost_equal` (:655), `check_numeric_gradient` (:1043),
`check_consistency` (:1490) — on the port's arrays.  The graph-vs-eager
oracle compares a block run before and after ``hybridize()`` (which runs
eagerly in the port, so the two agree unless a block's hybrid path
differs).  Sparse storage types are ROADMAP Queue 1 item 9: asking
``rand_ndarray`` for one raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import numpy as onp

from .context import Context, current_context
from .ndarray import ndarray, array
from . import numpy as mxnp

__all__ = [
    "default_context", "default_device", "set_default_context",
    "rand_ndarray", "rand_shape_2d", "rand_shape_3d", "rand_shape_nd",
    "same", "almost_equal", "assert_almost_equal", "assert_allclose",
    "check_numeric_gradient", "numeric_grad", "check_consistency",
    "effective_dtype", "environment",
]

_default_ctx = None


def default_context():
    """The context tests run on (reference test_utils.py:57): the one
    ``set_default_context`` set, else the default device, as a
    :class:`Context`."""
    return Context(_default_ctx or current_context())


default_device = default_context


def set_default_context(ctx):
    global _default_ctx
    _default_ctx = ctx


def rand_shape_2d(dim0=10, dim1=10):
    return tuple(onp.random.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(onp.random.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_shape_nd(num_dim, dim=10):
    return tuple(onp.random.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 ctx=None, scale=1.0):
    """Random array, dense or sparse stype (reference :484)."""
    dtype = onp.dtype(dtype or "float32")
    data = (onp.random.uniform(-scale, scale, size=shape)).astype(dtype)
    if stype == "default":
        return array(data, ctx=ctx)
    raise NotImplementedError(
        "rand_ndarray(stype=%r) is not ported yet: it waits for sparse.py "
        "(row_sparse and csr storage), ROADMAP Queue 1 item 9" % (stype,))


def _asnumpy(a):
    if isinstance(a, ndarray):
        return a.asnumpy()
    return onp.asarray(a)


def same(a, b):
    return onp.array_equal(_asnumpy(a), _asnumpy(b))


def almost_equal(a, b, rtol=1e-5, atol=1e-20, equal_nan=False):
    return onp.allclose(_asnumpy(a), _asnumpy(b), rtol=rtol, atol=atol,
                        equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=1e-5, atol=1e-20, names=("a", "b"),
                        equal_nan=False):
    """Assert arrays near-equal with max-violation report (reference :655)."""
    an, bn = _asnumpy(a), _asnumpy(b)
    if an.shape != bn.shape:
        raise AssertionError("shape mismatch: %s is %s, %s is %s"
                             % (names[0], an.shape, names[1], bn.shape))
    if onp.allclose(an, bn, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    diff = onp.abs(an - bn)
    tol = atol + rtol * onp.abs(bn)
    bad = diff > tol
    idx = onp.unravel_index(onp.argmax(diff - tol), an.shape)
    raise AssertionError(
        "%s and %s differ at %d/%d positions; worst at %s: %r vs %r "
        "(rtol=%g atol=%g)" % (names[0], names[1], int(bad.sum()), an.size,
                               idx, an[idx], bn[idx], rtol, atol))


def assert_allclose(a, b, rtol=1e-5, atol=1e-8):
    assert_almost_equal(a, b, rtol=rtol, atol=atol)


def effective_dtype(a):
    return onp.dtype(a.dtype)


class environment:
    """Scoped environment-variable override (reference test_utils)."""

    def __init__(self, *args):
        import os
        self._os = os
        if len(args) == 2:
            self._vars = {args[0]: args[1]}
        else:
            self._vars = dict(args[0])

    def __enter__(self):
        self._saved = {k: self._os.environ.get(k) for k in self._vars}
        for k, v in self._vars.items():
            if v is None:
                self._os.environ.pop(k, None)
            else:
                self._os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                self._os.environ.pop(k, None)
            else:
                self._os.environ[k] = v


def numeric_grad(f, inputs, eps=1e-4):
    """Central-difference gradients of scalar-valued f w.r.t. each input
    (reference numeric_grad inside check_numeric_gradient :1043)."""
    grads = []
    for i, x in enumerate(inputs):
        xn = onp.array(_asnumpy(x), dtype="float64")
        g = onp.zeros_like(xn)
        it = onp.nditer(xn, flags=["multi_index"])
        while not it.finished:
            idx = it.multi_index
            orig = xn[idx]
            xn[idx] = orig + eps
            fp = float(_eval(f, inputs, i, xn))
            xn[idx] = orig - eps
            fm = float(_eval(f, inputs, i, xn))
            xn[idx] = orig
            g[idx] = (fp - fm) / (2 * eps)
            it.iternext()
        grads.append(g)
    return grads


def _eval(f, inputs, i, replaced):
    args = list(inputs)
    args[i] = array(replaced.astype(_asnumpy(inputs[i]).dtype))
    out = f(*args)
    return _asnumpy(out).sum()


def check_numeric_gradient(f, inputs, rtol=1e-2, atol=1e-3, eps=1e-3):
    """Compare autograd gradients of sum(f(*inputs)) against finite
    differences (reference :1043)."""
    from . import autograd
    nds = [x if isinstance(x, ndarray) else array(x) for x in inputs]
    for x in nds:
        x.attach_grad()
    with autograd.record():
        out = f(*nds)
        loss = out.sum() if isinstance(out, ndarray) else sum(
            o.sum() for o in out)
    loss.backward()
    num = numeric_grad(f, nds, eps=eps)
    for i, (x, g) in enumerate(zip(nds, num)):
        assert_almost_equal(x.grad, g.astype(_asnumpy(x).dtype),
                            rtol=rtol, atol=atol,
                            names=("autograd[%d]" % i, "numeric[%d]" % i))


def check_consistency(block, inputs, rtol=1e-4, atol=1e-5):
    """Graph-vs-eager oracle: run `block` before and after
    ``hybridize()``, assert identical outputs and input gradients
    (reference check_consistency :1490 cross-compares devices)."""
    from . import autograd
    import copy

    nds = [x if isinstance(x, ndarray) else array(x) for x in inputs]

    def run(b):
        xs = [array(_asnumpy(x)) for x in nds]
        for x in xs:
            x.attach_grad()
        with autograd.record():
            out = b(*xs)
            loss = out.sum() if isinstance(out, ndarray) else sum(
                o.sum() for o in out)
        loss.backward()
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [_asnumpy(o) for o in outs], [_asnumpy(x.grad) for x in xs]

    eager_out, eager_grads = run(block)
    block.hybridize()
    hyb_out, hyb_grads = run(block)
    for i, (e, h) in enumerate(zip(eager_out, hyb_out)):
        assert_almost_equal(h, e, rtol=rtol, atol=atol,
                            names=("hybrid_out[%d]" % i, "eager_out[%d]" % i))
    for i, (e, h) in enumerate(zip(eager_grads, hyb_grads)):
        assert_almost_equal(h, e, rtol=rtol, atol=atol,
                            names=("hybrid_grad[%d]" % i, "eager_grad[%d]" % i))
