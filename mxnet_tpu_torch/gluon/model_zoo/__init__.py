"""gluon.model_zoo (the port of ``mxnet_tpu/gluon/model_zoo/``; parity:
python/mxnet/gluon/model_zoo/): the vision networks and the offline
weight store."""
from . import vision  # noqa: F401
from . import model_store  # noqa: F401
