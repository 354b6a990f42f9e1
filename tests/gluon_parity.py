"""Shared helpers of the Gluon parity tests (``tests/test_torch_gluon_*``).

A block of each package is built by one factory (``make(gluon)``), the
JAX package's initialised and run once, so deferred shapes finish, and
its weights carried to the port's block by the JAX block's
``save_parameters`` file, read by the port's ``load_parameters``: the
weight-transfer function of the Gluon slice.  :func:`forward_backward`
runs one recorded forward and a backward with a seeded head gradient in
each package and returns the output, the input gradients and every
parameter's gradient as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(2)

# fp32 on both sides: XLA and ATen sum the products of a layer in
# different orders (and XLA's CPU convolution in another blocking), a
# few ulps of each sum apart
TOL = dict(rtol=1e-5, atol=1e-5)
# convolutions and their gradients sum hundreds of products per element
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


def jax_mx():
    import mxnet_tpu as jmx
    return jmx


def port_mx():
    import mxnet_tpu_torch as tmx
    return tmx


def rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def carry(jblock, tblock, path):
    """The JAX block's weights into the port's block, by file."""
    jblock.save_parameters(str(path))
    tblock.load_parameters(str(path), device="cpu")


def build_pair(make, inputs, tmp_path, init=None, jax_kwargs=None):
    """(JAX block, port block) with the same weights; ``inputs`` (numpy)
    finish the JAX block's deferred shapes."""
    jmx, tmx = jax_mx(), port_mx()
    jb = make(jmx.gluon)
    jb.initialize(init(jmx) if init else jmx.init.Normal(0.5))
    with jmx.autograd.pause():
        jb(*[jmx.np.array(a) for a in inputs], **(jax_kwargs or {}))
    with tmx.Context("cpu"):
        tb = make(tmx.gluon)
    carry(jb, tb, tmp_path / "w.npz")
    return jb, tb


def _np(a):
    if isinstance(a, (list, tuple)):
        return [_np(v) for v in a]
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a.asnumpy())


def forward_backward(mx, block, inputs, grad_inputs=(0,), train=True,
                     seed=7, kwargs=None):
    """One recorded forward of ``block`` on numpy ``inputs`` (arrays of
    package ``mx``) and a backward with a seeded head gradient; returns
    (outputs, input grads, {param name: grad})."""
    xs = [mx.np.array(a) for a in inputs]
    for i in grad_inputs:
        xs[i].attach_grad()
    with mx.autograd.record(train_mode=train):
        out = block(*xs, **(kwargs or {}))
    outs = out if isinstance(out, (list, tuple)) else [out]
    flat = []
    for o in outs:
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    heads = [mx.np.array(rand(*o.shape, seed=seed + k))
             for k, o in enumerate(flat)]
    mx.autograd.backward(flat, heads)
    grads = {n: _np(p.grad()) for n, p in block.collect_params().items()
             if p.grad_req != "null"}
    return _np(flat), [_np(xs[i].grad) for i in grad_inputs], grads


def assert_close(got, want, rtol, atol, name=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (name, sorted(set(got) ^ set(want)))
        for k in want:
            assert_close(got[k], want[k], rtol, atol, "%s %s" % (name, k))
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, rtol, atol, "%s[%d]" % (name, i))
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


def check_layer(name, make, shapes, tol, tmp_path):
    """A layer of both packages from the same weights: outputs, input
    gradients and parameter gradients agree (BatchNorm's running
    statistics too)."""
    if name == "Embedding":
        inputs = [np.array([[1, 6, 0], [3, 3, 2]], np.int32)]
        grad_inputs = ()
    else:
        inputs = [rand(*s, seed=i) for i, s in enumerate(shapes)]
        grad_inputs = (0,)
    jb, tb = build_pair(make, inputs, tmp_path)
    if name.startswith(("DeformableConvolution", "Modulated")):
        # a non-zero offset branch, so the sampling leaves the grid
        oc = jb.offset_conv.weight
        oc.set_data(jax_mx().np.array(rand(*oc.shape, seed=9, scale=0.3)))
        carry(jb, tb, tmp_path / "w2.npz")
    want = forward_backward(jax_mx(), jb, inputs, grad_inputs)
    with port_mx().Context("cpu"):
        got = forward_backward(port_mx(), tb, inputs, grad_inputs)
    assert_close(got[0], want[0], name=name + " out", **tol)
    assert_close(got[1], want[1], name=name + " dx", **tol)
    assert_close(got[2], want[2], name=name + " dparams", **tol)
    if "BatchNorm" in name:
        for stat in ("running_mean", "running_var"):
            assert_close(getattr(tb, stat).data().asnumpy(),
                         getattr(jb, stat).data().asnumpy(),
                         name=stat, **TOL)


def check_predict_and_torch_call(name, make, shapes, tol, tmp_path):
    """Outside training (BatchNorm's running statistics) in both
    packages; and the port's layer called with torch tensors (its module
    flag off) gives the ndarray call's values."""
    inputs = [rand(*s, seed=3) for s in shapes]
    jb, tb = build_pair(make, inputs, tmp_path)
    jmx, tmx = jax_mx(), port_mx()
    want = jb(jmx.np.array(inputs[0])).asnumpy()
    with tmx.Context("cpu"):
        got = tb(tmx.np.array(inputs[0])).asnumpy()
    assert_close(got, want, name=name, **tol)
    tb.eval()
    with torch.no_grad():
        direct = tb(torch.tensor(inputs[0])).numpy()
    np.testing.assert_array_equal(direct, got)


class Unrolled:
    """A cell's unroll over TNC inputs of T steps as a block-like
    callable: outputs and final states."""

    def __init__(self, cell, T):
        self.cell, self.T = cell, T

    def __call__(self, x):
        out, states = self.cell.unroll(self.T, x, layout="TNC")
        return [out] + list(states)

    def collect_params(self):
        return self.cell.collect_params()


def check_cell_unroll(name, make, x, tmp_path, tol):
    """A recurrent cell of both packages from the same weights, unrolled
    over ``x`` (TNC): outputs, final states, the input's gradient and
    every parameter's gradient agree, and so do the parameter names."""
    jmx, tmx = jax_mx(), port_mx()
    T = x.shape[0]
    jc = make(jmx.gluon)
    jc.initialize(jmx.init.Normal(0.4))
    jc.unroll(T, jmx.np.array(x), layout="TNC")        # deferred shapes
    with tmx.Context("cpu"):
        tc = make(tmx.gluon)
    carry(jc, tc, tmp_path / "w.npz")
    assert list(tc.collect_params()) == list(jc.collect_params())
    want = forward_backward(jmx, Unrolled(jc, T), [x])
    with tmx.Context("cpu"):
        got = forward_backward(tmx, Unrolled(tc, T), [x])
    assert_close(got[0], want[0], name=name + " out/states", **tol)
    assert_close(got[1], want[1], name=name + " dx", **tol)
    assert_close(got[2], want[2], name=name + " dparams", **tol)
