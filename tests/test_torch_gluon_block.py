"""The port's Gluon blocks and Parameters on the CPU, against
``mxnet_tpu`` where both packages define the behaviour: structural
names, deferred initialisation, ``grad_req="add"``, shared parameters,
``Constant``, ``cast``, ``summary``, hooks, hybridized against not,
parameter files both ways, the one-card ``Trainer`` with SGD and Adam
over three steps, its saved states, the public names of every ported
module and the stand-ins of the names left for later items.
"""
from __future__ import annotations

import io
import contextlib
import types

import numpy as np
import pytest
import torch

from gluon_parity import carry, jax_mx, port_mx, rand

# fp32 on both sides: a few ulps per matmul and update
TOL = dict(rtol=1e-5, atol=1e-6)


class _Net:
    """A Gluon net with every kind of child: a custom block with its own
    Parameter, nested containers, a deferred layer and BatchNorm."""

    @staticmethod
    def make(g, batch_norm=True):
        class Scale(g.HybridBlock):
            def __init__(self):
                super().__init__()
                self.alpha = g.Parameter("alpha", shape=(1, 1))

            def forward(self, x):
                return x * self.alpha.data()

        net = g.nn.HybridSequential()
        body = g.nn.HybridSequential()
        body.add(g.nn.Dense(8, activation="relu"))
        if batch_norm:
            body.add(g.nn.BatchNorm())
        net.add(body, Scale(), g.nn.Dense(3, in_units=8))
        return net


def _pair(tmp_path, x, batch_norm=True):
    jmx, tmx = jax_mx(), port_mx()
    jn = _Net.make(jmx.gluon, batch_norm)
    jn.initialize(jmx.init.Xavier())
    jn(jmx.np.array(x))
    with tmx.Context("cpu"):
        tn = _Net.make(tmx.gluon, batch_norm)
        tn.initialize(tmx.init.Xavier())
    carry(jn, tn, tmp_path / "w.npz")
    return jn, tn


def test_structural_names_match_jax(tmp_path):
    jn, tn = _pair(tmp_path, rand(4, 5))
    names = list(jn.collect_params())
    assert list(tn.collect_params()) == names
    assert [n for n, _ in tn.named_parameters()] == names
    sel = ".*(weight|alpha)"
    assert list(tn.collect_params(sel)) == list(jn.collect_params(sel))


def test_deferred_init_and_trainer_made_before_forward():
    tmx = port_mx()
    with tmx.Context("cpu"):
        net = tmx.gluon.nn.Dense(4)
        net.initialize(tmx.init.One())
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5})
        assert net.weight.shape == (4, 0)
        with pytest.raises(tmx.gluon.DeferredInitializationError):
            net.weight.data()
        x = tmx.np.ones((2, 3))
        with tmx.autograd.record():
            y = net(x)
        y.backward()
        assert net.weight.shape == (4, 3)
        assert [n for n, _ in net.named_parameters()] == ["weight", "bias"]
        trainer.step(2)
    np.testing.assert_allclose(net.weight.data().asnumpy(),
                               np.full((4, 3), 0.5), **TOL)
    np.testing.assert_allclose(net.bias.data().asnumpy(),
                               np.full(4, -0.5), **TOL)


def test_grad_req_add_sums_until_zero_grad_and_survives_step():
    tmx = port_mx()
    with tmx.Context("cpu"):
        net = tmx.gluon.nn.Dense(2, in_units=3, use_bias=False)
        net.initialize(tmx.init.One())
        net.weight.grad_req = "add"
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.0})
        x = tmx.np.ones((1, 3))
        for _ in range(2):
            with tmx.autograd.record():
                y = net(x)
            y.backward()
        np.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                      np.full((2, 3), 2.0))
        trainer.step(1)
        np.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                      np.full((2, 3), 2.0))
        net.zero_grad()
        np.testing.assert_array_equal(net.weight.grad().asnumpy(),
                                      np.zeros((2, 3)))
        net.weight.grad_req = "null"
        assert not net.weight.leaf.requires_grad
        with pytest.raises(RuntimeError):
            net.weight.grad()


def test_shared_parameter_sums_gradients_like_jax():
    x = rand(2, 3)
    out = []
    for mx in (jax_mx(), port_mx()):
        with (mx.Context("cpu") if mx is port_mx()
              else contextlib.nullcontext()):
            a = mx.gluon.nn.Dense(3, in_units=3, use_bias=False)
            b = mx.gluon.nn.Dense(3, in_units=3, use_bias=False)
            b.weight = a.weight
            net = mx.gluon.nn.HybridSequential()
            net.add(a, b)
            net.initialize(mx.init.Constant(0.2))
            xs = mx.np.array(x)
            with mx.autograd.record():
                y = net(xs)
            y.backward()
            out.append(a.weight.grad().asnumpy())
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_constant_parameter():
    tmx = port_mx()
    with tmx.Context("cpu"):
        class WithConst(tmx.gluon.HybridBlock):
            def __init__(self):
                super().__init__()
                self.c = tmx.gluon.Constant(np.array([1.0, 2.0, 3.0],
                                                     np.float32))

            def forward(self, x):
                return x * self.c.data()

        blk = WithConst()
        blk.initialize()
        assert blk.c.grad_req == "null"
        x = tmx.np.ones((2, 3))
        x.attach_grad()
        with tmx.autograd.record():
            y = blk(x)
        y.backward()
    np.testing.assert_array_equal(y.asnumpy(), [[1, 2, 3], [1, 2, 3]])
    np.testing.assert_array_equal(x.grad.asnumpy(), [[1, 2, 3], [1, 2, 3]])
    with pytest.raises(ValueError):
        blk.c.grad_req = "write"


def test_cast_keeps_the_leaf():
    tmx = port_mx()
    with tmx.Context("cpu"):
        net = tmx.gluon.nn.Dense(3, in_units=2)
        net.initialize()
        leaf = net.weight.leaf
        net.cast("float16")
        assert net.weight.leaf is leaf and leaf.dtype == torch.float16
        assert net.weight.dtype == np.float16
        out = net(tmx.np.ones((1, 2), dtype="float16"))
        assert out.dtype == np.float16
        net.cast("bfloat16")
        assert leaf.dtype == torch.bfloat16


def test_data_view_writes_through_and_set_data(tmp_path):
    tmx = port_mx()
    with tmx.Context("cpu"):
        net = tmx.gluon.nn.Dense(2, in_units=2)
        net.initialize(tmx.init.One())
        w = net.weight.data()
        w[:] = 3.0
        assert float(net.weight.leaf.sum()) == 12.0
        w += 1
        assert float(net.weight.leaf.sum()) == 16.0
        net.weight.set_data(np.zeros((2, 2), np.float32))
        assert float(w.sum()) == 0.0
        assert net.weight.data() is w


def test_summary_and_hooks_match_jax(tmp_path):
    x = rand(4, 5)
    jn, tn = _pair(tmp_path, x)
    jmx, tmx = jax_mx(), port_mx()
    outs = []
    for mx, net in ((jmx, jn), (tmx, tn)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            with (mx.Context("cpu") if mx is tmx
                  else contextlib.nullcontext()):
                net.summary(mx.np.array(x))
        outs.append(buf.getvalue().splitlines())
    assert outs[1][0] == outs[0][0]
    assert outs[1][-1] == outs[0][-1]          # Total params
    assert len(outs[1]) == len(outs[0])
    seen = []
    with tmx.Context("cpu"):
        h = tn.register_op_hook(lambda name, op, arr: seen.append(name))
        pre = tn.register_forward_pre_hook(
            lambda blk, inputs: seen.append("pre"))
        tn(tmx.np.array(x))
        h.detach()
        pre.detach()
        n = len(seen)
        tn(tmx.np.array(x))
    assert seen[0] == "pre" and "0.0_output0" in seen and n == len(seen)
    kinds = []
    tn.apply(lambda b: kinds.append(type(b).__name__))
    assert kinds[-1] == "HybridSequential" and "Dense" in kinds


def test_hybridize_runs_eagerly_and_agrees(tmp_path):
    x = rand(4, 5)
    jn, tn = _pair(tmp_path, x)
    tmx = port_mx()
    with tmx.Context("cpu"):
        with tmx.autograd.predict_mode():
            before = tn(tmx.np.array(x)).asnumpy()
            tn.hybridize(static_alloc=True)
            assert tn._active and tn[0]._active
            after = tn(tmx.np.array(x)).asnumpy()
    np.testing.assert_array_equal(after, before)
    want = jn(jax_mx().np.array(x)).asnumpy()
    np.testing.assert_allclose(after, want, rtol=1e-5, atol=1e-5)


def test_parameter_files_both_ways(tmp_path):
    jmx, tmx = jax_mx(), port_mx()
    with tmx.Context("cpu"):
        tn = _Net.make(tmx.gluon)
        tn.initialize(tmx.init.Xavier())
        tn(tmx.np.array(rand(2, 5)))
    f = tmp_path / "port.npz"
    tn.save_parameters(str(f))
    jn = _Net.make(jmx.gluon)
    jn.initialize()
    jn(jmx.np.array(rand(2, 5)))
    jn.load_parameters(str(f))
    for name, p in tn.collect_params().items():
        np.testing.assert_array_equal(
            jn.collect_params()[name].data().asnumpy(),
            p.data().asnumpy(), err_msg=name)
    prefix = str(tmp_path / "m")
    tn.save(prefix)
    with tmx.Context("cpu"):
        again = _Net.make(tmx.gluon)
    again.load(prefix, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        with tmx.Context("cpu"):
            tmx.gluon.nn.Dense(2).load_parameters(str(f), device="cpu")


@pytest.mark.parametrize("opt,kw", [("sgd", dict(learning_rate=0.1,
                                                 momentum=0.9, wd=1e-3)),
                                    ("adam", dict(learning_rate=0.01))])
def test_trainer_three_steps_match_jax(opt, kw, tmp_path):
    xs = [rand(4, 5, seed=s) for s in range(3)]
    ys = [np.random.default_rng(s).integers(0, 3, 4) for s in range(3)]
    # no BatchNorm here: the gradients of the weights before it are
    # differences of nearly equal sums, which Adam's normalisation turns
    # into lr-sized steps (BatchNorm's gradients are held on their own in
    # test_torch_gluon_layers.py)
    jn, tn = _pair(tmp_path, xs[0], batch_norm=False)
    jmx, tmx = jax_mx(), port_mx()
    results = []
    for mx, net in ((jmx, jn), (tmx, tn)):
        with (mx.Context("cpu") if mx is tmx else contextlib.nullcontext()):
            tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kw))
            ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            losses = []
            for x, y in zip(xs, ys):
                with mx.autograd.record():
                    loss = ce(net(mx.np.array(x)), mx.np.array(y))
                loss.backward()
                tr.step(4)
                losses.append(float(loss.mean()))
            results.append((losses, {n: p.data().asnumpy() for n, p in
                                     net.collect_params().items()}))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    for name, want in results[0][1].items():
        np.testing.assert_allclose(results[1][1][name], want, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_trainer_states_learning_rate_and_torch_leaves(tmp_path):
    tmx = port_mx()
    with tmx.Context("cpu"):
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.1})
        with tmx.autograd.record():
            y = net(tmx.np.ones((1, 3)))
        y.backward()
        tr.step(1)
        f = str(tmp_path / "states")
        tr.save_states(f)
        tr2 = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.5})
        tr2.load_states(f)
        assert tr2.learning_rate == pytest.approx(0.1)
        for a, b in zip(tr._states[0], tr2._states[0]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        tr2.learning_rate = 0.3
        assert tr2.optimizer.lr == 0.3
    # a dict of torch leaves, as torch-native models hand it
    lin = torch.nn.Linear(3, 2)
    tr3 = tmx.gluon.Trainer(dict(lin.named_parameters()), "sgd",
                            {"learning_rate": 1.0})
    lin(torch.ones(1, 3)).sum().backward()
    before = lin.bias.detach().clone()
    tr3.step(1)
    np.testing.assert_allclose(lin.bias.detach().numpy(),
                               before.numpy() - 1.0, **TOL)
    assert lin.bias.grad is None


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")
                 and not isinstance(getattr(mod, n), types.ModuleType)
                 and getattr(getattr(mod, n), "__module__", "")
                 == mod.__name__]
    return sorted(names)


@pytest.mark.parametrize("path", [
    "gluon", "gluon.nn", "gluon.rnn", "gluon.loss", "gluon.metric",
    "gluon.data", "gluon.data.vision", "gluon.data.vision.transforms",
    "gluon.data.batchify", "gluon.utils", "initializer", "optimizer",
    "lr_scheduler"])
def test_every_public_name_is_ported(path):
    jmod, tmod = jax_mx(), port_mx()
    for part in path.split("."):
        jmod, tmod = getattr(jmod, part), getattr(tmod, part)
    missing = [n for n in _public(jmod) if not hasattr(tmod, n)]
    assert not missing, (path, missing)


@pytest.mark.parametrize("call,item", [
    (lambda g: g.SymbolBlock.imports("x"), 9),
    (lambda g: g.nn.Dense(2, in_units=2, device="cpu").export("x"), 9),
    (lambda g: g.nn.Dense(2, in_units=2, device="cpu").to_sym(), 9),
    (lambda g: g.nn.Dense(2, in_units=2, device="cpu").optimize_for(None),
     9),
    (lambda g: g.model_zoo.vision.resnet18_v1(), 5),
    (lambda g: g.contrib.estimator, 9),
    (lambda g: g.probability.Normal, 9),
    (lambda g: g.Trainer([], "sgd", kvstore="dist_sync"), 7),
    (lambda g: g.Trainer([], "sgd", update_on_kvstore=True), 7),
    (lambda g: g.Trainer([], "sgd").attach_mesh(None, None), 7),
    (lambda g: g.Trainer([], "sgd").attach_preemption("d"), 7),
])
def test_left_out_names_raise_naming_their_item(call, item):
    with pytest.raises(NotImplementedError, match="item %d" % item):
        call(port_mx().gluon)


def test_layer_without_device_needs_a_gpu_or_a_cpu_scope(monkeypatch):
    tmx = port_mx()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.gluon.nn.Dense(3)
    with tmx.Context("cpu"):
        net = tmx.gluon.nn.Dense(3)
        net.initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmx.gluon.nn.Dense(3, in_units=2, device="cpu").initialize(
            force_reinit=True)
