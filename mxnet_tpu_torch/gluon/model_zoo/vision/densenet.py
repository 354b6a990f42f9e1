"""DenseNet 121/161/169/201 (the port of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``; parity:
python/mxnet/gluon/model_zoo/vision/densenet.py)."""
from __future__ import annotations

from .... import numpy as np_mod
from ... import nn
from ...block import HybridBlock

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        out = self.body(x)
        return np_mod.concatenate([x, out], axis=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout):
    out = nn.HybridSequential()
    for _ in range(num_layers):
        out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                    strides=2, padding=3, use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.features.add(_make_dense_block(num_layers, bn_size,
                                                growth_rate, dropout))
            num_features = num_features + num_layers * growth_rate
            if i != len(block_config) - 1:
                num_features = num_features // 2
                self.features.add(_make_transition(num_features))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.AvgPool2D(pool_size=7))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def _get(num_layers, **kwargs):
    init_f, growth, cfg = densenet_spec[num_layers]
    return DenseNet(init_f, growth, cfg, **kwargs)


def densenet121(pretrained=False, ctx=None, root=None, **kw):
    net = _get(121, **kw)
    if pretrained:
        from ._pretrained import load_pretrained
        load_pretrained(net, "densenet121", root=root, ctx=ctx)
    return net


def densenet161(pretrained=False, ctx=None, root=None, **kw):
    net = _get(161, **kw)
    if pretrained:
        from ._pretrained import load_pretrained
        load_pretrained(net, "densenet161", root=root, ctx=ctx)
    return net


def densenet169(pretrained=False, ctx=None, root=None, **kw):
    net = _get(169, **kw)
    if pretrained:
        from ._pretrained import load_pretrained
        load_pretrained(net, "densenet169", root=root, ctx=ctx)
    return net


def densenet201(pretrained=False, ctx=None, root=None, **kw):
    net = _get(201, **kw)
    if pretrained:
        from ._pretrained import load_pretrained
        load_pretrained(net, "densenet201", root=root, ctx=ctx)
    return net
