"""Port parity: the model zoo's BatchNorm in training mode against
``mxnet_tpu`` on the CPU, in both layouts: the running variance of a
channel whose batch variance lies far below eps, and a BatchNorm cast to
bf16 (bench config 2's bf16 run casts the whole net)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gluon_parity import TOL, jax_mx, port_mx, rand

torch.set_num_threads(2)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batchnorm_near_constant_channel_running_var_matches_jax(layout):
    """A channel whose batch variance (~1e-9) lies far below eps (1e-5):
    its running variance is the batch's own, computed directly as the
    JAX package does, not rebuilt from 1 / sqrt(var + eps), which cancels
    to ~1e-3 of it."""
    x = rand(4, 3, 5, 5, seed=5)
    x[:, 1] = 0.7 + 3e-5 * x[:, 1]
    axis = 1
    if layout == "NHWC":
        x, axis = np.ascontiguousarray(x.transpose(0, 2, 3, 1)), 3
    got = {}
    for name, mx in (("jax", jax_mx()), ("port", port_mx())):
        with mx.Context("cpu"):
            bn = mx.gluon.nn.BatchNorm(axis=axis, in_channels=3)
            bn.initialize()
            # from 0, so the new running variance is 0.1 x the batch's
            bn.running_var.set_data(mx.np.zeros(3))
            with mx.autograd.record():
                out = bn(mx.np.array(x))
        got[name] = (out.asnumpy(), bn.running_mean.data().asnumpy(),
                     bn.running_var.data().asnumpy())
    jout, jmean, jvar = got["jax"]
    tout, tmean, tvar = got["port"]
    # the running variances, from 0: 0.1 x the batch's variance of the
    # (fp32) input, held against its exact value.  On the near-constant
    # channel the JAX package's own error is its fp32 mean's (a few ulps
    # of 0.7, squared into the variance: ~5e-5 of it here); the port's
    # must be no larger, within one part in 1e6
    exact = 0.1 * np.moveaxis(x.astype(np.float64), axis, 0).reshape(
        3, -1).var(axis=1)
    assert 1e-11 < exact[1] < 1e-9
    t_err, j_err = np.abs(tvar - exact), np.abs(jvar - exact)
    assert t_err[1] <= j_err[1] + 1e-6 * exact[1], (t_err, j_err, exact)
    np.testing.assert_allclose(tvar[[0, 2]], jvar[[0, 2]], rtol=1e-5,
                               atol=0, err_msg="running_var")
    np.testing.assert_allclose(tmean, jmean, **TOL)
    # the output divides x - mean by sqrt(var + eps) ~ 3.2e-3: the other
    # channels at TOL; on the near-constant one each package's mean of
    # values ~0.7 is a few ulps (6e-8 each) from the other's, which moves
    # every output by that over 3.2e-3, so 8 ulps of 0.7 over sqrt(eps)
    ch = [slice(None)] * 4
    ch[axis] = 1
    near = np.zeros(x.shape, bool)
    near[tuple(ch)] = True
    np.testing.assert_allclose(tout[~near], jout[~near], **TOL)
    np.testing.assert_allclose(tout[near], jout[near], rtol=0,
                               atol=8 * np.spacing(np.float32(0.7))
                               / np.sqrt(1e-5))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batchnorm_bf16_training_matches_jax(layout):
    """BatchNorm cast to bf16 in training mode (bench config 2's bf16 run
    casts the whole net): both packages normalise in fp32 and round the
    output, the input gradient and the parameter gradients to bf16, so
    each agrees to one bf16 rounding (2^-8 of the value, with an absolute
    floor of 2^-8 of the array's largest for values near 0); the running
    statistics stay fp32 in both (TOL)."""
    x = rand(4, 3, 5, 5, seed=9)
    axis = 1
    if layout == "NHWC":
        x, axis = np.ascontiguousarray(x.transpose(0, 2, 3, 1)), 3
    head = rand(*x.shape, seed=10)
    got = {}
    for name, mx in (("jax", jax_mx()), ("port", port_mx())):
        with mx.Context("cpu"):
            bn = mx.gluon.nn.BatchNorm(axis=axis, in_channels=3)
            bn.initialize()
            bn.gamma.set_data(mx.np.array(rand(3, seed=11) + 1.5))
            bn.beta.set_data(mx.np.array(rand(3, seed=12)))
            bn.cast("bfloat16")
            xb = mx.np.array(x).astype("bfloat16")
            xb.attach_grad()
            with mx.autograd.record():
                out = bn(xb)
            out.backward(mx.np.array(head).astype("bfloat16"))
        f32 = lambda a: a.astype("float32").asnumpy()
        got[name] = {"out": f32(out), "dx": f32(xb.grad),
                     "dgamma": f32(bn.gamma.grad()),
                     "dbeta": f32(bn.beta.grad()),
                     "running_mean": f32(bn.running_mean.data()),
                     "running_var": f32(bn.running_var.data())}
    assert got["port"]["out"].dtype == np.float32
    for k, want in got["jax"].items():
        have = got["port"][k]
        assert have.shape == want.shape, k
        if k.startswith("running"):
            np.testing.assert_allclose(have, want, err_msg=k, **TOL)
        else:
            np.testing.assert_allclose(
                have, want, rtol=2.0 ** -8,
                atol=2.0 ** -8 * float(np.abs(want).max()), err_msg=k)
