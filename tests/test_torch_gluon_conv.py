"""Port parity: the convolution, pooling, padding, pixel-shuffle and
deformable-convolution layers of ``gluon.nn`` against ``mxnet_tpu`` on
the CPU, as ``test_torch_gluon_layers.py`` holds the others: the same
weights, the same inputs, one recorded forward in training mode and a
backward with a seeded head gradient; the outputs, the input gradients
and every parameter's gradient agree.
"""
from __future__ import annotations

import pytest

from gluon_parity import (CONV_TOL, TOL, check_layer,
                          check_predict_and_torch_call)

CONV_LAYERS = {
    "Conv1D": (lambda g: g.nn.Conv1D(4, 3, strides=2, padding=1,
                                     activation="relu"),
               [(2, 3, 9)], CONV_TOL),
    "Conv2D": (lambda g: g.nn.Conv2D(4, 3, padding=1, groups=1),
               [(2, 3, 6, 6)], CONV_TOL),
    "Conv2D_groups_dilation": (lambda g: g.nn.Conv2D(4, 3, dilation=2,
                                                     groups=2),
                               [(2, 4, 7, 7)], CONV_TOL),
    "Conv2D_NHWC": (lambda g: g.nn.Conv2D(4, 3, layout="NHWC"),
                    [(2, 6, 6, 3)], CONV_TOL),
    "Conv3D": (lambda g: g.nn.Conv3D(2, 3), [(1, 2, 5, 5, 5)], CONV_TOL),
    "Conv1DTranspose": (lambda g: g.nn.Conv1DTranspose(3, 3, strides=2),
                        [(2, 4, 5)], CONV_TOL),
    "Conv2DTranspose": (lambda g: g.nn.Conv2DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), [(2, 4, 5, 5)],
        CONV_TOL),
    "Conv3DTranspose": (lambda g: g.nn.Conv3DTranspose(2, 2, strides=2),
                        [(1, 2, 3, 3, 3)], CONV_TOL),
    "MaxPool1D": (lambda g: g.nn.MaxPool1D(3, 2, ceil_mode=True),
                  [(2, 3, 10)], TOL),
    "MaxPool2D": (lambda g: g.nn.MaxPool2D(2), [(2, 3, 6, 6)], TOL),
    "MaxPool2D_pad": (lambda g: g.nn.MaxPool2D(3, 2, padding=1),
                      [(2, 3, 7, 7)], TOL),
    "MaxPool3D": (lambda g: g.nn.MaxPool3D(2), [(1, 2, 4, 4, 4)], TOL),
    "AvgPool1D": (lambda g: g.nn.AvgPool1D(3, 2, padding=1,
                                           count_include_pad=False),
                  [(2, 3, 10)], TOL),
    "AvgPool2D": (lambda g: g.nn.AvgPool2D(3, 2, padding=1, ceil_mode=True),
                  [(2, 3, 7, 7)], TOL),
    "AvgPool3D": (lambda g: g.nn.AvgPool3D(2), [(1, 2, 4, 4, 4)], TOL),
    "GlobalMaxPool1D": (lambda g: g.nn.GlobalMaxPool1D(), [(2, 3, 5)], TOL),
    "GlobalMaxPool2D": (lambda g: g.nn.GlobalMaxPool2D(), [(2, 3, 4, 5)],
                        TOL),
    "GlobalMaxPool3D": (lambda g: g.nn.GlobalMaxPool3D(),
                        [(1, 2, 3, 4, 5)], TOL),
    "GlobalAvgPool1D": (lambda g: g.nn.GlobalAvgPool1D(), [(2, 3, 5)], TOL),
    "GlobalAvgPool2D": (lambda g: g.nn.GlobalAvgPool2D(), [(2, 3, 4, 5)],
                        TOL),
    "GlobalAvgPool3D": (lambda g: g.nn.GlobalAvgPool3D(),
                        [(1, 2, 3, 4, 5)], TOL),
    "ReflectionPad2D": (lambda g: g.nn.ReflectionPad2D(2), [(2, 3, 5, 5)],
                        TOL),
    "PixelShuffle1D": (lambda g: g.nn.PixelShuffle1D(2), [(2, 4, 3)], TOL),
    "PixelShuffle2D": (lambda g: g.nn.PixelShuffle2D((2, 3)),
                       [(1, 12, 2, 3)], TOL),
    "PixelShuffle3D": (lambda g: g.nn.PixelShuffle3D(2), [(1, 16, 2, 1, 2)],
                       TOL),
    "DeformableConvolution": (lambda g: g.nn.DeformableConvolution(
        3, kernel_size=3, padding=1), [(1, 2, 5, 5)], CONV_TOL),
    "ModulatedDeformableConvolution": (
        lambda g: g.nn.ModulatedDeformableConvolution(
            3, kernel_size=3, padding=1, num_deformable_group=2),
        [(1, 4, 5, 5)], CONV_TOL),
}


@pytest.mark.parametrize("name", sorted(CONV_LAYERS))
def test_conv_layer_matches_jax(name, tmp_path):
    check_layer(name, *CONV_LAYERS[name], tmp_path)


@pytest.mark.parametrize("name", ["Conv2D", "MaxPool2D_pad"])
def test_conv_layer_predict_mode_and_torch_call_match(name, tmp_path):
    check_predict_and_torch_call(name, *CONV_LAYERS[name], tmp_path)
