"""Port parity: the activations and basic layers of ``gluon.nn``
(``test_torch_gluon_conv.py`` holds the convolution, pooling, padding,
pixel-shuffle and deformable layers) against ``mxnet_tpu`` on the CPU:
the same weights (carried by the JAX block's ``save_parameters`` file),
the same numpy inputs, one recorded forward in training mode and a
backward with a seeded head gradient; the outputs, the input gradients
and every parameter's gradient agree.
"""
from __future__ import annotations

import numpy as np
import pytest

from gluon_parity import (TOL, check_layer, check_predict_and_torch_call,
                          port_mx)


LAYERS = {
    # name: (factory, input shapes, tolerance)
    "Activation_relu": (lambda g: g.nn.Activation("relu"), [(3, 5)], TOL),
    "Activation_softrelu": (lambda g: g.nn.Activation("softrelu"),
                            [(3, 5)], TOL),
    "LeakyReLU": (lambda g: g.nn.LeakyReLU(0.1), [(3, 5)], TOL),
    "PReLU": (lambda g: g.nn.PReLU(in_channels=4), [(2, 4, 3)], TOL),
    "ELU": (lambda g: g.nn.ELU(0.7), [(3, 5)], TOL),
    "SELU": (lambda g: g.nn.SELU(), [(3, 5)], TOL),
    "GELU": (lambda g: g.nn.GELU(), [(3, 5)], TOL),
    "GELU_tanh": (lambda g: g.nn.GELU("tanh"), [(3, 5)], TOL),
    "Swish": (lambda g: g.nn.Swish(1.5), [(3, 5)], TOL),
    "SiLU": (lambda g: g.nn.SiLU(), [(3, 5)], TOL),
    "Dense": (lambda g: g.nn.Dense(5, activation="tanh"), [(2, 3, 4)], TOL),
    "Dense_noflatten": (lambda g: g.nn.Dense(5, flatten=False,
                                             use_bias=False),
                        [(2, 3, 4)], TOL),
    "Dense_gelu": (lambda g: g.nn.Dense(6, activation="gelu",
                                        flatten=False), [(2, 3, 4)], TOL),
    "Dropout_0": (lambda g: g.nn.Dropout(0.0), [(3, 5)], TOL),
    "BatchNorm": (lambda g: g.nn.BatchNorm(), [(4, 3, 5)], TOL),
    "BatchNorm_momentum": (lambda g: g.nn.BatchNorm(momentum=0.8),
                           [(4, 5, 3)], TOL),
    "BatchNormReLU": (lambda g: g.nn.BatchNormReLU(), [(4, 3, 5)], TOL),
    "SyncBatchNorm": (lambda g: g.nn.SyncBatchNorm(), [(4, 3, 5)], TOL),
    "Embedding": (lambda g: g.nn.Embedding(7, 4), [], TOL),
    "Flatten": (lambda g: g.nn.Flatten(), [(2, 3, 4)], TOL),
    "InstanceNorm": (lambda g: g.nn.InstanceNorm(scale=True),
                     [(2, 3, 6)], TOL),
    "LayerNorm": (lambda g: g.nn.LayerNorm(), [(2, 3, 6)], TOL),
    "GroupNorm": (lambda g: g.nn.GroupNorm(num_groups=2), [(2, 4, 6)], TOL),
    "HybridLambda": (lambda g: g.nn.HybridLambda("tanh"), [(3, 5)], TOL),
    "Lambda": (lambda g: g.nn.Lambda(lambda x: x * 2 + 1), [(3, 5)], TOL),
    "Identity": (lambda g: g.nn.Identity(), [(3, 5)], TOL),
    "HybridSequential": (lambda g: _seq(g.nn.HybridSequential(), g),
                         [(2, 6)], TOL),
    "Sequential": (lambda g: _seq(g.nn.Sequential(), g), [(2, 6)], TOL),
    "Concatenate": (lambda g: _concat(g), [(2, 6)], TOL),
}


def _seq(net, g):
    net.add(g.nn.Dense(5, activation="relu"), g.nn.Dense(3))
    return net


def _concat(g):
    net = g.nn.Concatenate(axis=1)
    net.add(g.nn.Dense(3), g.nn.Activation("sigmoid"))
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name, tmp_path):
    check_layer(name, *LAYERS[name], tmp_path)


@pytest.mark.parametrize("name", ["Dense", "BatchNorm", "LayerNorm"])
def test_layer_predict_mode_and_torch_call_match(name, tmp_path):
    check_predict_and_torch_call(name, *LAYERS[name], tmp_path)


def test_dropout_ndarray_call_reads_autograd_flag():
    tmx = port_mx()
    with tmx.Context("cpu"):
        drop = tmx.gluon.nn.Dropout(0.5)
        x = tmx.np.ones((64, 64))
        drop.eval()                            # the module flag: ignored
        with tmx.autograd.record(train_mode=True):
            y = drop(x).asnumpy()
        assert (y == 0).any() and set(np.unique(y)) <= {0.0, 2.0}
        drop.train()
        with tmx.autograd.record(train_mode=False):
            assert drop(x) is x
        assert drop(x) is x                    # predict mode by default
