"""``mx.autograd`` of the port against the JAX package's, on the CPU:
grad_req write and add, ``pause``, ``train_mode``/``predict_mode``,
``grad`` with ``create_graph`` (second derivatives), ``Function``,
``mark_variables``, the two errors (``backward`` on unrecorded heads
raises ValueError; mutating a recorded array while recording raises
RuntimeError), head gradients, and how ``record(train_mode=)`` and
``nn.Module.training`` agree.

Tolerance: float32 within rtol 1e-5 (the same products in another order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from np_parity import inputs, jax_mx, port_mx, to_numpy

torch.set_num_threads(2)

X = inputs(4)


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


def both(fn):
    return fn(port_mx()), fn(jax_mx())


def close(a, b):
    for x, y in zip(a, b):
        np.testing.assert_allclose(to_numpy(x), to_numpy(y), rtol=1e-5,
                                   atol=1e-6)


def _loss(m, x, w):
    return (m.np.tanh(m.np.dot(x, w)) ** 2).sum()


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_and_add(req):
    def run(m):
        x, w = m.np.array(X["F"]), m.np.array(X["M"])
        w.attach_grad(grad_req=req)
        g = w.grad
        outs = []
        for _ in range(2):
            with m.autograd.record():
                loss = _loss(m, x, w)
            loss.backward()
            outs.append(w.grad.asnumpy())
        assert w.grad is g            # the same array, written into
        return outs
    close(*both(run))


def test_grad_req_null_leaves_grad():
    tmx = port_mx()
    w = tmx.np.array(X["M"])
    w.attach_grad(grad_req="null")
    with tmx.autograd.record():
        loss = (w * 2).sum()
    loss.backward()
    np.testing.assert_array_equal(w.grad.asnumpy(), 0)


def test_pause_records_nothing():
    def run(m):
        x = m.np.array(X["F"])
        x.attach_grad()
        with m.autograd.record():
            y = x * 3
            with m.autograd.pause():
                z = x * 100            # not recorded: a constant
            loss = (y * z).sum()
        loss.backward()
        return [x.grad]
    close(*both(run))
    tmx = port_mx()
    x = tmx.np.array(X["F"])
    x.attach_grad()
    with tmx.autograd.record():
        with tmx.autograd.pause():
            assert not tmx.autograd.is_recording()
            assert not (x * 2)._data.requires_grad
        assert tmx.autograd.is_recording()


def test_nothing_recorded_outside_record():
    tmx = port_mx()
    x = tmx.np.array(X["F"])
    x.attach_grad()
    y = (x * 2).sum()
    assert y._data.grad_fn is None
    with pytest.raises(ValueError, match="record"):
        y.backward()
    with pytest.raises(ValueError):
        jx = jax_mx().np.array(X["F"])
        jx.attach_grad()
        (jx * 2).sum().backward()


def test_mutating_a_recorded_array_raises():
    for m in (port_mx(), jax_mx()):
        x = m.np.array(X["F"])
        x.attach_grad()
        with m.autograd.record():
            y = x * 2
            with pytest.raises(RuntimeError, match="record"):
                y[0, 0] = 1.0
            with pytest.raises(RuntimeError):
                y += 1
        y[0, 0] = 1.0                    # outside record: allowed


def test_train_and_predict_modes():
    tmx = port_mx()
    ag = tmx.autograd
    assert not ag.is_training() and not ag.is_recording()
    with ag.record():
        assert ag.is_training() and ag.is_recording()
        with ag.predict_mode():
            assert not ag.is_training() and ag.is_recording()
    with ag.record(train_mode=False):
        assert not ag.is_training()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    assert ag.set_training(True) is False
    assert ag.set_training(False) is True
    assert ag.set_recording(False) is False


def test_train_mode_and_module_flag():
    """The np/npx ops, and a Gluon layer called with ndarrays, read
    autograd.is_training(); a Gluon layer called with torch tensors reads
    Module.training.  Neither sets the other: a caller mixing both
    states both."""
    tmx = port_mx()
    from mxnet_tpu_torch.gluon import nn as gnn
    drop = gnn.Dropout(0.5)
    x = tmx.np.array(np.ones((64, 64), np.float32))
    drop.train()
    with tmx.autograd.record(train_mode=False):
        assert tmx.npx.dropout(x, p=0.5) is x          # autograd's flag
        assert drop.training
        assert (drop(x._data) == 0).any()               # the module's flag
    drop.eval()
    with tmx.autograd.record(train_mode=True):
        assert not drop.training
        assert torch.equal(drop(x._data), x._data)
        assert (tmx.npx.dropout(x, p=0.5).asnumpy() == 0).any()
    with tmx.autograd.record(train_mode=drop.training):
        assert tmx.npx.dropout(x, p=0.5) is x
    # the same Dropout and a BatchNorm called with ndarrays: autograd's
    # flag, whatever the module's
    with tmx.Context("cpu"):
        bn = gnn.BatchNorm(in_channels=64)
        bn.initialize()
        y = tmx.np.array(np.random.default_rng(0).standard_normal(
            (4, 64)).astype(np.float32))
        drop.eval()
        bn.eval()
        with tmx.autograd.record(train_mode=True):
            assert (drop(x).asnumpy() == 0).any()
            out = bn(y).asnumpy()
        np.testing.assert_allclose(out.mean(0), 0, atol=1e-5)
        assert not np.allclose(bn.running_mean.data().asnumpy(), 0)
        drop.train()
        bn.train()
        before = bn.running_mean.data().asnumpy().copy()
        with tmx.autograd.record(train_mode=False):
            assert drop(x) is x
            np.testing.assert_allclose(
                bn(y).asnumpy(), y.asnumpy() / np.sqrt(
                    bn.running_var.data().asnumpy() + 1e-5)
                - before / np.sqrt(bn.running_var.data().asnumpy() + 1e-5),
                rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(bn.running_mean.data().asnumpy(),
                                      before)


def test_head_gradients():
    def run(m):
        x = m.np.array(X["F"])
        x.attach_grad()
        with m.autograd.record():
            y = m.np.sin(x) * 2
        y.backward(m.np.array(X["G"]))
        return [x.grad]
    close(*both(run))


def test_grad_with_create_graph():
    """Second derivative of sum(x**3) through grad(create_graph=True)."""
    def run(m):
        x = m.np.array(X["S"])
        x.attach_grad()
        with m.autograd.record():
            y = (x ** 3).sum()
            g = m.autograd.grad(y, x, create_graph=True)
            z = (g * m.np.array(X["F"])).sum()
        z.backward()
        return [g, x.grad]
    close(*both(run))


def test_grad_of_unused_variable_is_zero():
    def run(m):
        x, w = m.np.array(X["F"]), m.np.array(X["G"])
        x.attach_grad()
        w.attach_grad()
        with m.autograd.record():
            y = (x * 2).sum()
        return m.autograd.grad(y, [x, w])
    close(*both(run))


def test_multiple_heads_and_retain_graph():
    def run(m):
        x = m.np.array(X["F"])
        x.attach_grad()
        with m.autograd.record():
            a = (x * x).sum()
            b = m.np.exp(x).sum()
        m.autograd.backward([a, b], retain_graph=True)
        g1 = x.grad.asnumpy()
        m.autograd.backward([a])
        return [g1, x.grad]
    close(*both(run))


class _Square:
    """A custom op: y = x**2 with backward 2x dy, in either package."""

    @staticmethod
    def make(m):
        class Square(m.autograd.Function):
            def forward(self, x):
                self.x = x
                return x * x

            def backward(self, dy):
                return 2 * self.x * dy
        return Square()


def test_custom_function():
    def run(m):
        x = m.np.array(X["S"])
        x.attach_grad()
        f = _Square.make(m)
        with m.autograd.record():
            y = f(x)
            loss = (y * m.np.array(X["F"])).sum()
        loss.backward()
        return [y, x.grad]
    close(*both(run))


def test_mark_variables():
    def run(m):
        x = m.np.array(X["F"])
        g = m.np.zeros((3, 4))
        m.autograd.mark_variables([x], [g])
        with m.autograd.record():
            y = (x * 3).sum()
        y.backward()
        return [g, x.grad]
    close(*both(run))


def test_leaf_stays_a_leaf_after_setitem():
    """Rebinding a leaf (x[:] = ...) outside record keeps it a leaf with
    requires_grad, so the next recorded step reaches it."""
    tmx = port_mx()
    x = tmx.np.array(X["F"])
    x.attach_grad()
    x[:] = 2.0
    x -= 1.0
    with tmx.autograd.record():
        y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2.0)


def test_grad_ready_hooks_fire():
    tmx = port_mx()
    x = tmx.np.array(X["F"])
    x.attach_grad()
    seen = []
    h = tmx.autograd.register_grad_ready_hook(x, lambda a: seen.append(a))
    with tmx.autograd.record():
        y = (x * 2).sum()
    y.backward()
    assert seen == [x]
    tmx.autograd.remove_grad_ready_hook(h)
    with tmx.autograd.record():
        y = (x * 2).sum()
    y.backward()
    assert len(seen) == 1
