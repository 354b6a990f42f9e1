"""Port parity: the model zoo's ResNets v1 (``gluon.model_zoo.vision.resnet``)
against ``mxnet_tpu`` on the CPU.

Narrow networks of every block kind (``BasicBlockV1/V2``,
``BottleneckV1/V2``), in both layouts and with and without the
``thumbnail`` stem, are made in the port (Xavier) and their weights
carried to the JAX block by file; one recorded
forward in training mode (BatchNorm on the batch's statistics) and a
backward with a seeded head gradient give the same output, input
gradient and parameter gradients.  Two SGD-momentum steps through each
package's ``gluon.Trainer`` leave the same weights and BatchNorm running
statistics.  The cases are spread over ``test_torch_zoo_resnet*.py``,
a few a file.
"""
from __future__ import annotations

import numpy as np
import pytest

from gluon_parity import (CONV_TOL, TOL, ZOO_REL_TO_MAX, assert_close,
                          assert_close_to_max, build_pair_from_port,
                          forward_backward, jax_mx, port_mx, rand)


def _resnet(version, block, layers, channels, **kw):
    def make(g):
        v = g.model_zoo.vision.resnet
        net_cls = (v.ResNetV1, v.ResNetV2)[version - 1]
        blk = getattr(v, block)
        return net_cls(blk, layers, channels, classes=10, **kw)
    return make


CASES = {
    "v1_basic_nchw": (_resnet(1, "BasicBlockV1", [1, 1], [4, 4, 8]), False),
    "v1_basic_nhwc": (_resnet(1, "BasicBlockV1", [1, 1], [4, 4, 8],
                              layout="NHWC"), True),
    "v1_bottleneck_thumbnail": (_resnet(1, "BottleneckV1", [1, 1],
                                        [4, 8, 16], thumbnail=True), False),
    "v1_bottleneck_nhwc": (_resnet(1, "BottleneckV1", [1, 1], [4, 8, 16],
                                   layout="NHWC"), True),
    "v2_basic_nchw": (_resnet(2, "BasicBlockV2", [1, 1], [4, 4, 8]), False),
    "v2_basic_thumbnail_nhwc": (_resnet(2, "BasicBlockV2", [1, 1], [4, 4, 8],
                                        thumbnail=True, layout="NHWC"), True),
    "v2_bottleneck_nchw": (_resnet(2, "BottleneckV2", [1, 1], [4, 8, 16]),
                           False),
    "v2_bottleneck_nhwc": (_resnet(2, "BottleneckV2", [1, 1], [4, 8, 16],
                                   layout="NHWC"), True),
}


def _input(nhwc, seed=0):
    x = rand(2, 3, 16, 16, seed=seed)
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1)) if nhwc else x


def check_case(case, tmp_path):
    make, nhwc = CASES[case]
    x = _input(nhwc)
    jb, tb = build_pair_from_port(make, [x], tmp_path)
    assert list(tb.collect_params()) == list(jb.collect_params())
    want = forward_backward(jax_mx(), jb, [x])
    with port_mx().Context("cpu"):
        got = forward_backward(port_mx(), tb, [x])
    # convolutions and their gradients sum hundreds of products an
    # element, in another order in XLA than in ATen (ZOO_REL_TO_MAX)
    assert_close_to_max(got[0], want[0], ZOO_REL_TO_MAX, case + " out")
    assert_close_to_max(got[1], want[1], ZOO_REL_TO_MAX, case + " dx")
    assert_close_to_max(got[2], want[2], ZOO_REL_TO_MAX, case + " dparams")


def _train(mx, net, x, y, steps):
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9,
                                "wd": 1e-4})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(mx.np.array(x)), mx.np.array(y))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    return losses, {n: p.data().asnumpy()
                    for n, p in net.collect_params().items()}


def check_two_steps(layout, tmp_path):
    make = _resnet(1, "BottleneckV1", [1, 1], [4, 8, 16], layout=layout)
    x = _input(layout == "NHWC", seed=3)
    y = np.array([1, 7], np.float32)
    jb, tb = build_pair_from_port(make, [x], tmp_path)
    jl, jw = _train(jax_mx(), jb, x, y, 2)
    with port_mx().Context("cpu"):
        tl, tw = _train(port_mx(), tb, x, y, 2)
    np.testing.assert_allclose(tl, jl, **CONV_TOL)
    assert any(k.endswith("running_mean") for k in jw)
    # the weights after two steps: each step's update is lr times a
    # gradient within ZOO_REL_TO_MAX of its largest, so TOL holds the sums
    assert_close(tw, jw, name=layout + " after 2 steps", **TOL)


@pytest.mark.parametrize("case", ["v1_basic_nchw", "v1_basic_nhwc"])
def test_resnet_v1_forward_backward_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def test_two_sgd_momentum_steps_match_jax(tmp_path):
    check_two_steps("NCHW", tmp_path)

