"""gluon.model_zoo.vision (the port of
``mxnet_tpu/gluon/model_zoo/vision/``; parity:
python/mxnet/gluon/model_zoo/vision/ — alexnet, densenet, inception,
mobilenet v1/v2, resnet v1/v2 18-152, squeezenet, vgg 11-19[_bn]).

The networks are the JAX package's, built from the port's Gluon layers,
with the same parameter names and shapes, so a weight file saved by
either package loads into the other.  ``pretrained=True`` reads only the
offline store (``model_store.publish`` fills it) and downloads nothing.
"""
from .resnet import (  # noqa: F401
    ResNetV1, ResNetV2, resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
    resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2,
    resnet152_v2, get_resnet)
from .alexnet import AlexNet, alexnet  # noqa: F401
from .vgg import (  # noqa: F401
    VGG, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn,
    get_vgg)
from .mobilenet import (  # noqa: F401
    MobileNet, MobileNetV2, mobilenet1_0, mobilenet0_75, mobilenet0_5,
    mobilenet0_25, mobilenet_v2_1_0, mobilenet_v2_0_75, mobilenet_v2_0_5,
    mobilenet_v2_0_25)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1  # noqa: F401
from .densenet import (  # noqa: F401
    DenseNet, densenet121, densenet161, densenet169, densenet201)
from .inception import Inception3, inception_v3  # noqa: F401

_MODELS = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
}


def get_model(name, **kwargs):
    """Factory (parity: model_zoo/vision/__init__.py get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError("model %r not found; options: %s"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)
