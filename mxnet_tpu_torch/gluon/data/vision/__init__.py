"""gluon.data.vision (the port of ``mxnet_tpu/gluon/data/vision/``)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,  # noqa: F401
                       SyntheticImageDataset)
from . import transforms  # noqa: F401

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "SyntheticImageDataset", "transforms"]
