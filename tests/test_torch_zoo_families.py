"""Port parity: one narrow member of each of the model zoo's other
families (MobileNet v1 and v2 at 0.25, a small DenseNet) against
``mxnet_tpu`` on the CPU: the same weights (carried by file), one
recorded forward and a backward with a seeded head gradient give the
same output, input gradient and parameter gradients.

The DenseNet runs in training mode (BatchNorm on the batch's
statistics).  The MobileNets run outside it (BatchNorm on its running
statistics): at 32 x 32 their last layers hold 1 x 1 maps, so each
BatchNorm there normalises 2 values a channel, whose normalised values
are +-1 whatever the input; its gradient is then ill-conditioned, and
the few ulps by which XLA's and ATen's sums differ grow through 27 such
layers to a relative difference of order 1 in the input gradient (1e-4
at 64 x 64, 2e-6 in predict mode).  VGG, AlexNet and SqueezeNet are in
``test_torch_zoo_dense_heads.py``, Inception's blocks in
``test_torch_zoo_inception.py``.
"""
from __future__ import annotations

import pytest

from gluon_parity import (ZOO_REL_TO_MAX, assert_close_to_max,
                          build_pair_from_port, forward_backward, jax_mx,
                          port_mx, rand)


def check_family(name, make, x, train, tmp_path):
    """``make``'s network of both packages on ``x``: parameter names,
    output, input gradient and parameter gradients agree, each array
    within ``ZOO_REL_TO_MAX`` of its largest element (convolutions and
    their gradients sum hundreds of products an element, in another order
    in XLA than in ATen)."""
    # weights made in the port with Xavier, as the zoo's users initialise
    # (Normal(0.5) makes a deep network's activations grow to thousands)
    jb, tb = build_pair_from_port(make, [x], tmp_path)
    assert list(tb.collect_params()) == list(jb.collect_params())
    want = forward_backward(jax_mx(), jb, [x], train=train)
    with port_mx().Context("cpu"):
        got = forward_backward(port_mx(), tb, [x], train=train)
    assert_close_to_max(got[0], want[0], ZOO_REL_TO_MAX, name + " out")
    assert_close_to_max(got[1], want[1], ZOO_REL_TO_MAX, name + " dx")
    assert_close_to_max(got[2], want[2], ZOO_REL_TO_MAX, name + " dparams")


CASES = {
    "mobilenet0.25": (lambda g: g.model_zoo.vision.get_model(
        "mobilenet0.25", classes=10), (2, 3, 32, 32), False),
    "mobilenetv2_0.25": (lambda g: g.model_zoo.vision.get_model(
        "mobilenetv2_0.25", classes=10), (2, 3, 32, 32), False),
    "densenet_small": (lambda g: g.model_zoo.vision.DenseNet(
        4, 2, [1, 1], bn_size=2, classes=10), (2, 3, 56, 56), True),
}


@pytest.mark.parametrize("name", ["mobilenet0.25", "densenet_small"])
def test_family_member_matches_jax(name, tmp_path):
    make, shape, train = CASES[name]
    check_family(name, make, rand(*shape), train, tmp_path)
