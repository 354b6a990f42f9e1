"""Port parity: the model zoo's catalogue.  ``get_model`` of the port knows
the JAX package's 34 names, refuses any other as it does, and each
network, built at ``classes=10`` in both packages, has the same
parameters: names, order and shapes (a dim that waits for the first
forward is 0 in both).  Building runs nothing, so the big networks are
checked without a forward.
"""
from __future__ import annotations

import pytest

from gluon_parity import jax_mx, port_mx

import mxnet_tpu.gluon.model_zoo.vision as jvision

NAMES = sorted(jvision._MODELS)


def _params(net):
    return [(n, tuple(p.shape)) for n, p in net.collect_params().items()]


def test_get_model_knows_the_same_names():
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    assert len(NAMES) == 34
    assert sorted(tvision._MODELS) == NAMES
    for mod in (jvision, tvision):
        with pytest.raises(ValueError, match="not found"):
            mod.get_model("resnet19_v1")


@pytest.mark.parametrize("name", NAMES)
def test_network_has_the_jax_parameters(name):
    jnet = jax_mx().gluon.model_zoo.vision.get_model(name, classes=10)
    with port_mx().Context("cpu"):
        tnet = port_mx().gluon.model_zoo.vision.get_model(name.upper(),
                                                          classes=10)
    assert type(tnet).__name__ == type(jnet).__name__
    assert _params(tnet) == _params(jnet)
