"""SqueezeNet 1.0/1.1 (the port of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``; parity:
python/mxnet/gluon/model_zoo/vision/squeezenet.py)."""
from __future__ import annotations

from .... import numpy as np_mod
from ... import nn
from ...block import HybridBlock

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels):
        super().__init__()
        self.squeeze = nn.Conv2D(squeeze_channels, kernel_size=1,
                                 activation="relu")
        self.expand1x1 = nn.Conv2D(expand1x1_channels, kernel_size=1,
                                   activation="relu")
        self.expand3x3 = nn.Conv2D(expand3x3_channels, kernel_size=3,
                                   padding=1, activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return np_mod.concatenate([self.expand1x1(x), self.expand3x3(x)],
                                  axis=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000):
        super().__init__()
        assert version in ("1.0", "1.1")
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, kernel_size=7, strides=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_Fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, kernel_size=3, strides=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(_Fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(_Fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           ceil_mode=True))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(48, 192, 192))
            self.features.add(_Fire(64, 256, 256))
            self.features.add(_Fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, root=None, **kw):
    net = SqueezeNet("1.0", **kw)
    if pretrained:
        from ._pretrained import load_pretrained
        load_pretrained(net, "squeezenet1.0", root=root, ctx=ctx)
    return net


def squeezenet1_1(pretrained=False, ctx=None, root=None, **kw):
    net = SqueezeNet("1.1", **kw)
    if pretrained:
        from ._pretrained import load_pretrained
        load_pretrained(net, "squeezenet1.1", root=root, ctx=ctx)
    return net
