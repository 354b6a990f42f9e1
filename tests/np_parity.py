"""Shared helpers of the port's array-core parity tests
(``tests/test_torch_np_*.py``, ``test_torch_ndarray.py``, ...).

Both packages get the same seeded numpy inputs: the JAX package's
``mx.np`` as its own tests run it (on the CPU), the port's on the CPU
inside an ``mx.Context("cpu")`` scope.  :func:`to_numpy` turns either
package's result (an ndarray, a tuple or list of them, a python scalar)
into numpy values for :func:`assert_same`, which holds value and dtype.
"""
from __future__ import annotations

import numpy as np
import torch


def jax_mx():
    import mxnet_tpu as jmx
    return jmx


def port_mx():
    import mxnet_tpu_torch as tmx
    return tmx


class BF16:
    """A bfloat16 result, held as its float32 values."""

    def __init__(self, values):
        self.values = values


def to_numpy(r):
    """numpy value(s) of a result of either package."""
    if isinstance(r, (list, tuple)):
        return type(r)(to_numpy(v) for v in r)
    if hasattr(r, "asnumpy"):
        if str(r.dtype) in ("bfloat16", "torch.bfloat16"):
            return BF16(np.asarray(r.astype("float32").asnumpy()))
        return r.asnumpy()
    if isinstance(r, torch.Tensor):
        return r.detach().cpu().numpy()
    return r


def assert_same(got, want, rtol=1e-5, atol=1e-6, name="", check_dtype=True):
    """Values within (rtol, atol) and the same dtype, through any nesting
    of tuples and lists (a list and a tuple of the same values are the
    same).  Python scalars compare by value."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)), (name, type(got))
        assert len(got) == len(want), (name, len(got), len(want))
        for g, w in zip(got, want):
            assert_same(g, w, rtol, atol, name, check_dtype)
        return
    if isinstance(want, BF16):
        assert isinstance(got, BF16), name
        got, want = got.values, want.values
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        g, w = np.asarray(got), np.asarray(want)
        if check_dtype:
            assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if g.dtype.kind in "fc":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        return
    if isinstance(want, float):
        assert abs(got - want) <= atol + rtol * abs(want), (name, got, want)
        return
    assert got == want, (name, got, want)


def inputs(seed=0):
    """The seeded inputs of the tables: float32 in (0.1, 0.9) and (1.1,
    1.9), int32, bool, a float32 with NaNs, 1-D vectors."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.1, 0.9, (3, 4)).astype(np.float32)
    return dict(
        F=f, G=rng.uniform(0.1, 0.9, (3, 4)).astype(np.float32),
        H=(f + 1.0).astype(np.float32),
        S=rng.standard_normal((3, 4)).astype(np.float32),
        I=rng.integers(1, 9, (3, 4)).astype(np.int32),
        J=rng.integers(1, 9, (3, 4)).astype(np.int32),
        B=rng.integers(0, 2, (3, 4)).astype(bool),
        C=rng.integers(0, 2, (3, 4)).astype(bool),
        N=np.where(rng.uniform(size=(3, 4)) < 0.3, np.nan,
                   rng.standard_normal((3, 4))).astype(np.float32),
        M=rng.standard_normal((4, 4)).astype(np.float32),
        M2=rng.standard_normal((4, 4)).astype(np.float32),
        V=rng.standard_normal(6).astype(np.float32),
        W=rng.standard_normal(3).astype(np.float32),
        SORTED=np.sort(rng.standard_normal(6)).astype(np.float32),
    )
