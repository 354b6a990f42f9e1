"""mx.nd.contrib: the legacy contrib namespace (the port of
``mxnet_tpu/_nd_contrib.py``; parity: reference
``python/mxnet/ndarray/contrib.py``, foreach :139, while_loop :233, cond
:401).

The npx extension ops and the control-flow ops.  The JAX package also
re-exports its dedicated contrib operators (``contrib/ops.py``: boxes,
ROI, STN, ...), which wait for ``contrib/*`` (ROADMAP item 9).
"""
from .numpy_extension import *  # noqa: F401,F403
from .numpy_extension import __all__ as _npx_all
from .ops.control_flow import foreach, while_loop, cond  # noqa: F401

__all__ = ["foreach", "while_loop", "cond"] + list(_npx_all)
