"""Port parity: ``mxnet_tpu_torch.test_utils``, as
``tests/test_test_utils.py`` holds the JAX package's (the same cases, in
a CPU scope), its ``__all__`` against the JAX package's, and
``default_context()`` a ``Context``.
"""
from __future__ import annotations

import os

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import np as mnp, npx
from mxnet_tpu_torch import test_utils as tu

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def cpu():
    with mx.cpu():
        yield


def test_same_names_as_jax():
    import mxnet_tpu.test_utils as jtu
    assert sorted(tu.__all__) == sorted(jtu.__all__)
    assert all(hasattr(tu, n) for n in tu.__all__)


def test_default_context_is_a_context():
    ctx = tu.default_context()
    assert isinstance(ctx, mx.Context) and ctx == mx.cpu()
    tu.set_default_context(mx.cpu())
    try:
        assert tu.default_device() == mx.cpu()
    finally:
        tu.set_default_context(None)
    with pytest.raises(NotImplementedError, match="item 9"):
        tu.rand_ndarray((2, 2), stype="csr")


def test_assert_almost_equal_pass_and_fail():
    a = mnp.array([1.0, 2.0])
    tu.assert_almost_equal(a, onp.array([1.0, 2.0]))
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(a, onp.array([1.0, 2.5]))


def test_rand_ndarray_and_shapes():
    s = tu.rand_shape_nd(3, 5)
    assert len(s) == 3 and all(1 <= d <= 5 for d in s)
    a = tu.rand_ndarray((4, 3))
    assert a.shape == (4, 3) and a.ctx == torch.device("cpu")


def test_check_numeric_gradient_matmul():
    w = onp.random.rand(3, 4).astype("float32")
    tu.check_numeric_gradient(lambda x: mnp.dot(x, mnp.array(w)).sum(),
                              [onp.random.rand(2, 3).astype("float32")])


def test_check_numeric_gradient_catches_a_wrong_gradient():
    def f(x):
        # forward x * 2, backward as if x * 3
        return x * 3 - x.detach()
    with pytest.raises(AssertionError, match="autograd"):
        tu.check_numeric_gradient(f, [onp.random.rand(2, 3)
                                      .astype("float32")])


def test_check_consistency_dense_bn():
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
    net.initialize()
    tu.check_consistency(net, [onp.random.rand(4, 5).astype("float32")])


def test_environment_scope():
    with tu.environment("MXNET_TEST_VAR_XYZ", "1"):
        assert os.environ["MXNET_TEST_VAR_XYZ"] == "1"
    assert "MXNET_TEST_VAR_XYZ" not in os.environ


def test_np_small_fills():
    a = mnp.array([[3.0, 1.0], [2.0, 4.0]])
    assert onp.allclose(mnp.msort(a).asnumpy(), onp.sort(a.asnumpy(), axis=0))
    assert mnp.bartlett(5).shape == (5,)
    assert mnp.kaiser(5, 14.0).shape == (5,)
    ch = mnp.choose(mnp.array([0, 1], dtype="int32"),
                    [mnp.array([1.0, 2.0]), mnp.array([10.0, 20.0])])
    assert onp.allclose(ch.asnumpy(), [1.0, 20.0])


def test_npx_slice_family():
    a = mnp.arange(24).reshape(2, 3, 4)
    assert npx.slice(a, (0, 1), (1, 3)).shape == (1, 2, 4)
    assert npx.slice_axis(a, 2, 1, 3).shape == (2, 3, 2)
    assert npx.slice_like(a, mnp.zeros((1, 2, 2))).shape == (1, 2, 2)
    assert npx.cast(a, "float32").dtype == onp.float32
    assert onp.array_equal(npx.shape_array(a).asnumpy(), [2, 3, 4])
