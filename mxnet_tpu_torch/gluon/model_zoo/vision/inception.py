"""Inception v3 (the port of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; parity:
python/mxnet/gluon/model_zoo/vision/inception.py)."""
from __future__ import annotations

from .... import numpy as np_mod
from ... import nn
from ...block import HybridBlock

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(channels, **kwargs):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(channels, use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branches(HybridBlock):
    def __init__(self, branches):
        super().__init__()
        for i, b in enumerate(branches):
            self.register_child(b, "b%d" % i)

    def forward(self, x):
        return np_mod.concatenate([b(x) for b in self._children.values()],
                                  axis=1)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        kernel_size, strides, padding, channels = setting
        kw = {}
        if kernel_size is not None:
            kw["kernel_size"] = kernel_size
        if strides is not None:
            kw["strides"] = strides
        if padding is not None:
            kw["padding"] = padding
        out.add(_make_basic_conv(channels, **kw))
    return out


def _make_A(pool_features):
    return _Branches([
        _make_branch(None, (1, None, None, 64)),
        _make_branch(None, (1, None, None, 48), (5, None, 2, 64)),
        _make_branch(None, (1, None, None, 64), (3, None, 1, 96),
                     (3, None, 1, 96)),
        _make_branch("avg", (1, None, None, pool_features)),
    ])


def _make_B():
    return _Branches([
        _make_branch(None, (3, 2, None, 384)),
        _make_branch(None, (1, None, None, 64), (3, None, 1, 96),
                     (3, 2, None, 96)),
        _make_branch("max"),
    ])


def _make_C(channels_7x7):
    return _Branches([
        _make_branch(None, (1, None, None, 192)),
        _make_branch(None, (1, None, None, channels_7x7),
                     ((1, 7), None, (0, 3), channels_7x7),
                     ((7, 1), None, (3, 0), 192)),
        _make_branch(None, (1, None, None, channels_7x7),
                     ((7, 1), None, (3, 0), channels_7x7),
                     ((1, 7), None, (0, 3), channels_7x7),
                     ((7, 1), None, (3, 0), channels_7x7),
                     ((1, 7), None, (0, 3), 192)),
        _make_branch("avg", (1, None, None, 192)),
    ])


def _make_D():
    return _Branches([
        _make_branch(None, (1, None, None, 192), (3, 2, None, 320)),
        _make_branch(None, (1, None, None, 192), ((1, 7), None, (0, 3), 192),
                     ((7, 1), None, (3, 0), 192), (3, 2, None, 192)),
        _make_branch("max"),
    ])


class _BranchesE(HybridBlock):
    """E blocks have nested concats (reference _make_E)."""

    def __init__(self):
        super().__init__()
        self.b0 = _make_branch(None, (1, None, None, 320))
        self.b1_stem = _make_basic_conv(384, kernel_size=1)
        self.b1a = _make_basic_conv(384, kernel_size=(1, 3), padding=(0, 1))
        self.b1b = _make_basic_conv(384, kernel_size=(3, 1), padding=(1, 0))
        self.b2_stem = nn.HybridSequential()
        self.b2_stem.add(_make_basic_conv(448, kernel_size=1))
        self.b2_stem.add(_make_basic_conv(384, kernel_size=3, padding=1))
        self.b2a = _make_basic_conv(384, kernel_size=(1, 3), padding=(0, 1))
        self.b2b = _make_basic_conv(384, kernel_size=(3, 1), padding=(1, 0))
        self.b3 = _make_branch("avg", (1, None, None, 192))

    def forward(self, x):
        o0 = self.b0(x)
        s1 = self.b1_stem(x)
        o1 = np_mod.concatenate([self.b1a(s1), self.b1b(s1)], axis=1)
        s2 = self.b2_stem(x)
        o2 = np_mod.concatenate([self.b2a(s2), self.b2b(s2)], axis=1)
        o3 = self.b3(x)
        return np_mod.concatenate([o0, o1, o2, o3], axis=1)


class Inception3(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_make_basic_conv(32, kernel_size=3, strides=2))
        self.features.add(_make_basic_conv(32, kernel_size=3))
        self.features.add(_make_basic_conv(64, kernel_size=3, padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(80, kernel_size=1))
        self.features.add(_make_basic_conv(192, kernel_size=3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_BranchesE())
        self.features.add(_BranchesE())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        from ._pretrained import load_pretrained
        load_pretrained(net, "inceptionv3", root=root, ctx=ctx)
    return net
