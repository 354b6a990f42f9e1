"""Port parity: ``gluon.Trainer.step`` updates every parameter whose
``grad_req`` is not ``"null"``, as ``mxnet_tpu``'s does
(``gluon/trainer.py:667-692``): with the last gradient a backward wrote,
or zeros if none ever was, so momentum and weight decay still move it.

Two ``Dense(3, in_units=4)`` layers at constant 0.5, SGD with lr 0.1,
momentum 0.9 and wd 0.1, two steps, in both packages in the same run:
a layer the second step's backward skips, a second step with no backward
at all, a layer no backward ever reaches, and ``grad_req="add"``.  The
weights after each step, ``Parameter.grad()`` after it, and that the next
backward writes a ``"write"`` gradient afresh (no sum with the applied
one) all agree.  The port used to skip a leaf whose ``.grad`` was None.
The port's blocks are also driven with torch tensors and a torch
``backward()``, the path ``chip_smoke.py`` and the BERT trainer take.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gluon_parity import TOL, jax_mx, port_mx

torch.set_num_threads(2)

X = np.random.default_rng(11).standard_normal((2, 4)).astype(np.float32)

#: which layers each step's loss reaches (None: no backward that step)
SCHEDULES = {
    "skipped_in_step_2": [("l1", "l2"), ("l1",)],
    "step_without_backward": [("l1", "l2"), None],
    "never_reached": [("l1",), ("l1",)],
    "add_grad_req": [("l1", "l2"), ("l1", "l2")],
}


def _layers(mx, grad_req):
    g = mx.gluon
    layers = {k: g.nn.Dense(3, in_units=4) for k in ("l1", "l2")}
    for k, blk in layers.items():
        # before initialize(): the JAX package's Parameter takes a
        # grad_req set later for its next initialisation only
        for p in blk.collect_params().values():
            p.grad_req = grad_req
        blk.initialize(mx.init.Constant(0.5))
    params = {"%s.%s" % (k, n): p for k, blk in layers.items()
              for n, p in blk.collect_params().items()}
    return layers, params


def _run(mx, schedule, grad_req, torch_path=False):
    layers, params = _layers(mx, grad_req)
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                               "momentum": 0.9, "wd": 0.1})
    trace = []
    for step, reach in enumerate(schedule):
        if reach is not None:
            if torch_path:
                x = torch.tensor(X)
                loss = sum((layers[k](x) * (step + 1)).sum() for k in reach)
                loss.backward()
            else:
                x = mx.np.array(X)
                with mx.autograd.record():
                    loss = sum((layers[k](x) * (step + 1)).sum()
                               for k in reach)
                loss.backward()
        trainer.step(2)
        trace.append({n: (p.data().asnumpy().copy(),
                          p.grad().asnumpy().copy())
                      for n, p in params.items()})
    return trace


@pytest.mark.parametrize("torch_path", [False, True],
                         ids=["ndarray", "torch"])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_trainer_updates_every_parameter_as_jax(case, torch_path):
    grad_req = "add" if case == "add_grad_req" else "write"
    schedule = SCHEDULES[case]
    want = _run(jax_mx(), schedule, grad_req)
    with port_mx().Context("cpu"):
        got = _run(port_mx(), schedule, grad_req, torch_path)
    for step, (g, w) in enumerate(zip(got, want)):
        for name in w:
            for what, i in (("weight", 0), ("grad", 1)):
                np.testing.assert_allclose(
                    g[name][i], w[name][i], err_msg="%s step %d %s %s"
                    % (case, step + 1, name, what), **TOL)
    if case == "never_reached":
        # weight decay alone moved it: 0.5 - 0.1 * 0.1 * 0.5
        np.testing.assert_allclose(got[0]["l2.weight"][0], 0.495, **TOL)


def test_next_backward_writes_a_write_gradient():
    tmx = port_mx()
    with tmx.Context("cpu"):
        layers, params = _layers(tmx, "write")
        trainer = tmx.gluon.Trainer(params, "sgd", {"learning_rate": 0.0})
        x = tmx.np.array(X)
        for scale in (1.0, 3.0):
            with tmx.autograd.record():
                loss = (layers["l1"](x) * scale).sum()
            loss.backward()
            trainer.step(2)
            g = params["l1.bias"].grad().asnumpy()
            np.testing.assert_allclose(g, np.full(3, 2 * scale), **TOL)
        # a torch backward after the step writes too
        layers["l1"](torch.tensor(X)).sum().backward()
        np.testing.assert_allclose(params["l1.bias"].grad().asnumpy(),
                                   np.full(3, 2.0), **TOL)


@pytest.mark.parametrize("torch_path", [False, True],
                         ids=["ndarray", "torch"])
def test_applied_gradient_released_by_next_backward(torch_path):
    """A step keeps the applied "write" gradient of every leaf; the next
    backward that writes a leaf's gradient releases it (so a leaf never
    holds both past that point), and a leaf the backward skips keeps it."""
    from mxnet_tpu_torch.gluon import parameter as pm
    tmx = port_mx()
    with tmx.Context("cpu"):
        layers, params = _layers(tmx, "write")
        trainer = tmx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1})
        leaves = {n: p.leaf for n, p in params.items()}
        for reach in (("l1", "l2"), ("l1",)):
            if torch_path:
                loss = sum(layers[k](torch.tensor(X)).sum() for k in reach)
                loss.backward()
            else:
                x = tmx.np.array(X)
                with tmx.autograd.record():
                    loss = sum(layers[k](x).sum() for k in reach)
                loss.backward()
            if reach == ("l1",):
                assert all(leaves[n] not in pm._SPENT
                           for n in leaves if n.startswith("l1."))
                assert all(leaves[n] in pm._SPENT
                           for n in leaves if n.startswith("l2."))
            trainer.step(2)
            assert all(leaf in pm._SPENT and leaf.grad is None
                       for leaf in leaves.values())
        np.testing.assert_allclose(params["l2.bias"].grad().asnumpy(),
                                   np.full(3, 2.0), **TOL)
