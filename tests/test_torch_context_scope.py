"""Port parity: ``mx.cpu()`` and ``mx.gpu()`` are ``Context``s, as in
``mxnet_tpu`` (``context.py:87-97``), so ``with mx.cpu():`` is the
package's device scope: arrays, random draws and Gluon layers made inside
it land on the CPU, and on a host without a GPU nothing inside it asks
for CUDA.  The port used to return a ``torch.device`` here, whose
``with`` is torch's own scope and never reached ``context.resolve``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gluon_parity import jax_mx, port_mx

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cpu_and_gpu_are_contexts_as_in_jax():
    jmx, tmx = jax_mx(), port_mx()
    for mx in (jmx, tmx):
        c = mx.cpu()
        assert isinstance(c, mx.Context)
        assert (c.device_type, c.device_id) == ("cpu", 0)
        assert repr(c) == "cpu(0)"
        assert isinstance(mx.gpu(1), mx.Context)
        assert mx.gpu(1).device_id == 1
    assert tmx.gpu(1).device_type == "gpu"
    assert tmx.gpu(1) == torch.device("cuda", 1)
    assert tmx.cpu() == CPU and tmx.cpu() == tmx.Context("cpu")


def test_arrays_and_draws_in_a_cpu_scope_land_on_the_cpu(no_gpu):
    tmx = port_mx()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.np.zeros((2,))
    with tmx.cpu() as ctx:
        assert isinstance(ctx, tmx.Context)
        a = tmx.np.zeros((2, 3))
        b = tmx.np.array([1.0, 2.0])
        r = tmx.np.random.uniform(size=(4,))
        n = tmx.nd.ones((2,))
        assert tmx.current_context() == CPU
    for x in (a, b, r, n):
        assert x.ctx == CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.current_context()


def test_gluon_layers_in_a_cpu_scope_train_on_the_cpu(no_gpu):
    tmx = port_mx()
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(4, activation="relu"),
                tmx.gluon.nn.Dense(2))
        net.initialize(tmx.init.Xavier())
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        x = tmx.np.array(np.ones((3, 5), np.float32))
        with tmx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        trainer.step(3)
        zoo = tmx.gluon.model_zoo.vision.get_model("mobilenet0.25",
                                                   classes=4)
        zoo.initialize()
        zoo(tmx.np.ones((1, 3, 32, 32)))
    for p in list(net.collect_params().values()) + \
            list(zoo.collect_params().values()):
        assert p.data().ctx == CPU


def test_ctx_arguments_take_contexts(no_gpu):
    tmx = port_mx()
    a = tmx.np.array([1.0, 2.0], ctx=tmx.cpu())
    assert a.ctx == CPU
    assert a.as_in_context(tmx.cpu()).ctx == CPU
    assert a.copyto(tmx.cpu()).ctx == CPU
    parts = tmx.gluon.utils.split_and_load(
        tmx.np.array(np.arange(4.0), ctx=tmx.cpu()), [tmx.cpu()])
    assert parts[0].ctx == CPU
    dense = tmx.gluon.nn.Dense(2, in_units=3, device=tmx.cpu())
    dense.initialize(ctx=tmx.cpu())
    assert dense.weight.data().ctx == CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.np.array([1.0], ctx=tmx.gpu(0))
