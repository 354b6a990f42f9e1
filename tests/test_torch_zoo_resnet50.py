"""Port parity: ``resnet50_v1`` at full width (bench config 2's network,
53 convolutions, 25.6 M parameters at 1000 classes; here 10) against
``mxnet_tpu`` on the CPU, at B 1 and 32 x 32: the same weights (made in
the port with Xavier, carried to the JAX block by file), one recorded
forward and a backward with a seeded head gradient give the same
output, input gradient and parameter gradients.

It runs outside training mode (BatchNorm on its running statistics): at
B 1 and 32 x 32 the last stage holds 1 x 1 maps, where BatchNorm on the
batch's statistics normalises one value a channel to 0 and the output
no longer depends on the input.  The training-mode path is held by the
narrow ResNets (``test_torch_zoo_resnet*.py``).
"""
from __future__ import annotations

import numpy as np

from gluon_parity import (build_pair_from_port, forward_backward, jax_mx,
                          port_mx, rand)

# each value within 1e-4 of the largest element of its array: 53
# convolutions and their gradients, each summing up to 4608 products an
# element in another order in XLA than in ATen, leave ~3e-6 of it here;
# CONV_TOL's absolute 1e-4 would not scale with the gradients' size
REL_TO_MAX = 1e-4


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max())
    assert err <= REL_TO_MAX * scale, (name, err, scale)


def test_resnet50_v1_full_width_matches_jax(tmp_path):
    x = rand(1, 3, 32, 32)
    jb, tb = build_pair_from_port(
        lambda g: g.model_zoo.vision.resnet50_v1(classes=10), [x], tmp_path)
    n_conv = sum(1 for n in tb.collect_params()
                 if n.endswith("weight") and tb.collect_params()[n].ndim == 4)
    assert n_conv == 53
    want = forward_backward(jax_mx(), jb, [x], train=False)
    with port_mx().Context("cpu"):
        got = forward_backward(port_mx(), tb, [x], train=False)
    _close(got[0][0], want[0][0], "out")
    _close(got[1][0], want[1][0], "dx")
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        if "running" not in k:
            _close(got[2][k], want[2][k], k)
