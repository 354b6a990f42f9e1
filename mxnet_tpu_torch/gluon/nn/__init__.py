"""gluon.nn: the layers of the port (parity: ``mxnet_tpu/gluon/nn/``)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .activations import *  # noqa: F401,F403
from . import basic_layers, conv_layers, activations

from ..block import Block, HybridBlock  # noqa: F401

__all__ = (basic_layers.__all__ + conv_layers.__all__ + activations.__all__
           + ["Block", "HybridBlock"])
