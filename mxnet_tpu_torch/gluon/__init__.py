"""Gluon of the port (the port of ``mxnet_tpu/gluon/``): ``Parameter``,
``Block``/``HybridBlock``, the layers (``nn``, ``rnn``), ``loss``,
``metric``, ``data``, ``utils`` and the one-card ``Trainer``.

``model_zoo`` (ROADMAP Queue 1 item 5), ``contrib`` (the estimator) and
``probability`` (item 9), and ``SymbolBlock`` (item 9) are stand-ins that
raise ``NotImplementedError`` naming their item.
"""
from .parameter import Parameter, Constant, DeferredInitializationError  # noqa
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import metric  # noqa: F401
from . import data  # noqa: F401
from . import utils  # noqa: F401
from . import rnn  # noqa: F401
from .._unported import _Unported

model_zoo = _Unported("mx.gluon.model_zoo", 5, "the model zoo")
contrib = _Unported("mx.gluon.contrib", 9,
                    "gluon/contrib (the estimator and its event handlers)")
probability = _Unported("mx.gluon.probability", 9,
                        "gluon/probability (distributions and stochastic "
                        "blocks)")

__all__ = ["Parameter", "Constant", "DeferredInitializationError", "Block",
           "HybridBlock", "SymbolBlock", "Trainer", "nn", "loss", "metric",
           "data", "utils", "rnn", "model_zoo", "contrib", "probability"]
