"""ResNet v1/v2 (the port of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``;
parity: python/mxnet/gluon/model_zoo/vision/resnet.py — BasicBlockV1/V2,
BottleneckV1/V2, resnet18-152), built from the port's Gluon layers: the
convolutions, BatchNorm and pools run on PyTorch's ``F.conv2d``,
``F.batch_norm`` and pools (cuDNN on the card).

Every network and block takes ``layout``, ``"NCHW"`` (the default, as in
the reference) or ``"NHWC"``, as the JAX package's do; the parameters'
names and shapes are the same in both layouts, so one weight file serves
either."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from .... import numpy_extension as npx

__all__ = ["ResNetV1", "ResNetV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _bn_axis(layout):
    return 1 if layout == "NCHW" else 3


def _conv(channels, kernel, stride, pad, layout, in_channels=0):
    return nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                     padding=pad, use_bias=False, in_channels=in_channels,
                     layout=layout)


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return _conv(channels, 3, stride, 1, layout, in_channels)


class BasicBlockV1(HybridBlock):
    """conv3x3-BN-relu-conv3x3-BN + projection shortcut, post-activation."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, layout),
                      nn.BatchNorm(axis=ax),
                      nn.Activation("relu"),
                      _conv3x3(channels, 1, channels, layout),
                      nn.BatchNorm(axis=ax))
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(
                _conv(channels, 1, stride, 0, layout, in_channels),
                nn.BatchNorm(axis=ax))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return npx.activation(self.body(x) + residual, "relu")


class BottleneckV1(HybridBlock):
    """1x1-3x3-1x1 bottleneck, post-activation (v1)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        mid = channels // 4
        self.body = nn.HybridSequential()
        self.body.add(
            nn.Conv2D(mid, kernel_size=1, strides=stride, layout=layout),
            nn.BatchNorm(axis=ax),
            nn.Activation("relu"),
            _conv3x3(mid, 1, mid, layout),
            nn.BatchNorm(axis=ax),
            nn.Activation("relu"),
            nn.Conv2D(channels, kernel_size=1, strides=1, layout=layout),
            nn.BatchNorm(axis=ax))
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(
                _conv(channels, 1, stride, 0, layout, in_channels),
                nn.BatchNorm(axis=ax))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return npx.activation(self.body(x) + residual, "relu")


class BasicBlockV2(HybridBlock):
    """Pre-activation variant: BN-relu precede each conv (v2)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        self.downsample = (_conv(channels, 1, stride, 0, layout,
                                 in_channels) if downsample else None)

    def forward(self, x):
        pre = npx.activation(self.bn1(x), "relu")
        residual = x if self.downsample is None else self.downsample(pre)
        h = self.conv1(pre)
        h = self.conv2(npx.activation(self.bn2(h), "relu"))
        return h + residual


class BottleneckV2(HybridBlock):
    """Pre-activation 1x1-3x3-1x1 bottleneck (v2)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        mid = channels // 4
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(mid, 1, 1, use_bias=False, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(mid, stride, mid, layout)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False,
                               layout=layout)
        self.downsample = (_conv(channels, 1, stride, 0, layout,
                                 in_channels) if downsample else None)

    def forward(self, x):
        pre = npx.activation(self.bn1(x), "relu")
        residual = x if self.downsample is None else self.downsample(pre)
        h = self.conv1(pre)
        h = self.conv2(npx.activation(self.bn2(h), "relu"))
        h = self.conv3(npx.activation(self.bn3(h), "relu"))
        return h + residual


def _stage(block, n_layers, channels, stride, in_channels, layout):
    stage = nn.HybridSequential()
    stage.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, layout=layout))
    for _ in range(n_layers - 1):
        stage.add(block(channels, 1, False, in_channels=channels,
                        layout=layout))
    return stage


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW"):
        super().__init__()
        assert len(layers) == len(channels) - 1
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(_conv(channels[0], 7, 2, 3, layout),
                              nn.BatchNorm(axis=ax),
                              nn.Activation("relu"),
                              nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            self.features.add(_stage(block, num_layer, channels[i + 1],
                                     1 if i == 0 else 2, channels[i],
                                     layout))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW"):
        super().__init__()
        assert len(layers) == len(channels) - 1
        self._layout = layout
        ax = _bn_axis(layout)
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(axis=ax, scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, layout))
        else:
            self.features.add(_conv(channels[0], 7, 2, 3, layout),
                              nn.BatchNorm(axis=ax),
                              nn.Activation("relu"),
                              nn.MaxPool2D(3, 2, 1, layout=layout))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            self.features.add(_stage(block, num_layer, channels[i + 1],
                                     1 if i == 0 else 2, in_channels,
                                     layout))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(axis=ax),
                          nn.Activation("relu"),
                          nn.GlobalAvgPool2D(layout=layout),
                          nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    net = resnet_class(block_class, layers, channels, **kwargs)
    if pretrained:
        from ._pretrained import load_pretrained
        load_pretrained(net, "resnet%d_v%d" % (num_layers, version),
                        root=root, ctx=ctx)
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
