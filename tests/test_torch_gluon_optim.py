"""Port parity: every optimizer over three updates (with weight decay,
gradient clipping, rescaling, a scheduler, multi-precision fp16), the
``Updater``'s states, the learning-rate schedulers' values and the
initializers, against ``mxnet_tpu`` on the CPU.  The deterministic
initializers agree exactly; the random ones (whose streams differ by
design) by shape and scale.
"""
from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from gluon_parity import jax_mx, port_mx, rand

# fp32 updates on both sides; the square roots, norms and divisions of
# the adaptive rules round a few ulps apart after three steps
TOL = dict(rtol=2e-5, atol=1e-6)

OPTIMIZERS = {
    "sgd": dict(learning_rate=0.1),
    "sgd_mom": dict(learning_rate=0.1, momentum=0.9, wd=0.01),
    "nag": dict(learning_rate=0.1, momentum=0.9, wd=0.01),
    "adam": dict(learning_rate=0.01, clip_gradient=0.5),
    "adamw": dict(learning_rate=0.01, wd=0.1),
    "adabelief": dict(learning_rate=0.01, wd=0.01),
    "adamax": dict(learning_rate=0.01),
    "nadam": dict(learning_rate=0.01),
    "adagrad": dict(learning_rate=0.1, wd=0.01),
    "adadelta": dict(rho=0.8),
    "rmsprop": dict(learning_rate=0.01),
    "rmsprop_centered": dict(learning_rate=0.01, centered=True,
                             clip_weights=0.8),
    "ftrl": dict(learning_rate=0.1, lamda1=0.01, wd=0.01),
    "signum": dict(learning_rate=0.01, momentum=0.9, wd_lh=0.01),
    "signum_nomom": dict(learning_rate=0.01, momentum=0.0, wd=0.01),
    "lamb": dict(learning_rate=0.01, wd=0.01, lower_bound=0.1,
                 upper_bound=10.0),
    "lars": dict(learning_rate=0.1, wd=0.01),
    "lans": dict(learning_rate=0.01, wd=0.01),
    "ftml": dict(learning_rate=0.01, wd=0.01),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9),
    "lbsgd": dict(learning_rate=0.1, warmup_epochs=1, updates_per_epoch=2,
                  batch_scale=2),
}


def _opt_name(key):
    return {"sgd_mom": "sgd", "rmsprop_centered": "rmsprop",
            "signum_nomom": "signum"}.get(key, key)


def _states_np(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [v for x in s for v in _states_np(x)]
    if isinstance(s, torch.Tensor):
        return [s.numpy()]
    return [s.asnumpy()]


def _three_updates(mx, key, w0, grads, to_array, rescale=0.5):
    opt = mx.optimizer.create(_opt_name(key), rescale_grad=rescale,
                              **OPTIMIZERS[key])
    w = to_array(w0)
    state = opt.create_state_multi_precision(0, w)
    for g in grads:
        opt.update_multi_precision([0], [w], [to_array(g)], [state])
    return w, _states_np(state)


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_optimizer_three_updates_match_jax(key):
    w0 = rand(4, 5)
    grads = [rand(4, 5, seed=k + 1) for k in range(3)]
    jmx, tmx = jax_mx(), port_mx()
    jw, js = _three_updates(jmx, key, w0, grads, jmx.np.array)
    tw, ts = _three_updates(tmx, key, w0, grads, torch.tensor)
    np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), err_msg=key, **TOL)
    assert len(ts) == len(js)
    for t, j in zip(ts, js):
        np.testing.assert_allclose(t, j, err_msg=key + " state", **TOL)


def test_multi_precision_fp16_matches_jax():
    w0 = rand(4, 5).astype(np.float16)
    grads = [rand(4, 5, seed=k + 1).astype(np.float16) for k in range(3)]
    jmx, tmx = jax_mx(), port_mx()
    kw = dict(learning_rate=0.1, momentum=0.9, multi_precision=True)
    jopt, topt = jmx.optimizer.SGD(**kw), tmx.optimizer.SGD(**kw)
    jw, tw = jmx.np.array(w0), torch.tensor(w0)
    js = jopt.create_state_multi_precision(0, jw)
    ts = topt.create_state_multi_precision(0, tw)
    assert ts[0].dtype == torch.float32
    for g in grads:
        jopt.update_multi_precision([0], [jw], [jmx.np.array(g)], [js])
        topt.update_multi_precision([0], [tw], [torch.tensor(g)], [ts])
    assert tw.dtype == torch.float16
    np.testing.assert_allclose(ts[0].numpy(), js[0].asnumpy(), **TOL)
    np.testing.assert_array_equal(tw.numpy(), jw.asnumpy())


def test_sgld_noise_scale():
    """SGLD draws its noise from the global seed: the update is half a
    gradient step plus N(0, lr) noise."""
    tmx = port_mx()
    tmx.random.seed(3)
    opt = tmx.optimizer.SGLD(learning_rate=0.04)
    w = torch.zeros(200, 200)
    g = torch.ones(200, 200)
    opt.update([0], [w], [g], [None])
    noise = w + 0.02
    assert abs(float(noise.mean())) < 0.01
    assert abs(float(noise.std()) - 0.2) < 0.005


def test_lr_scheduler_drives_the_optimizer():
    jmx, tmx = jax_mx(), port_mx()
    w0, g = rand(3), rand(3, seed=1)
    out = []
    for mx, arr in ((jmx, jmx.np.array), (tmx, torch.tensor)):
        sched = mx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
        opt = mx.optimizer.SGD(learning_rate=0.4, lr_scheduler=sched)
        w = arr(w0)
        for _ in range(4):
            opt.update([0], [w], [arr(g)], [None])
        out.append(np.asarray(w.asnumpy() if hasattr(w, "asnumpy")
                              else w.numpy()))
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_updater_states_round_trip():
    tmx = port_mx()
    opt = tmx.optimizer.Adam(learning_rate=0.1)
    up = tmx.optimizer.get_updater(opt)
    w = torch.tensor(rand(3, 4))
    up(0, torch.tensor(rand(3, 4, seed=1)), w)
    blob = up.get_states(dump_optimizer=True)
    up2 = tmx.optimizer.get_updater(tmx.optimizer.SGD())
    up2.set_states(blob)
    assert isinstance(up2.optimizer, tmx.optimizer.Adam)
    for a, b in zip(up.states[0], up2.states[0]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    states, _ = pickle.loads(blob)
    assert set(states) == {0}


SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=3, factor=0.7, base_lr=0.5,
                                       warmup_steps=2, warmup_begin_lr=0.1)),
    "multifactor": ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.5,
                                                 base_lr=1.0)),
    "poly": ("PolyScheduler", dict(max_update=12, base_lr=0.3, pwr=2,
                                   final_lr=0.01, warmup_steps=3,
                                   warmup_mode="constant",
                                   warmup_begin_lr=0.05)),
    "cosine": ("CosineScheduler", dict(max_update=10, base_lr=0.2,
                                       final_lr=0.02, warmup_steps=2)),
}


@pytest.mark.parametrize("key", sorted(SCHEDULERS))
def test_scheduler_values_match_jax(key):
    cls, kw = SCHEDULERS[key]
    js = getattr(jax_mx().lr_scheduler, cls)(**kw)
    ts = getattr(port_mx().lr_scheduler, cls)(**kw)
    for t in range(15):
        assert ts(t) == pytest.approx(js(t), rel=1e-12, abs=0), (key, t)


DETERMINISTIC = {
    "zero": (lambda i: i.Zero(), (3, 4), "w"),
    "one": (lambda i: i.One(), (3, 4), "w"),
    "constant": (lambda i: i.Constant(0.3), (3, 4), "w"),
    "bilinear": (lambda i: i.Bilinear(), (2, 1, 4, 4), "up.weight"),
    "lstmbias": (lambda i: i.LSTMBias(2.0), (8,), "lstm0_bias_l0"),
    "bias_rule": (lambda i: i.Uniform(), (5,), "dense.bias"),
    "gamma_rule": (lambda i: i.Normal(), (5,), "ln.gamma"),
    "running_var_rule": (lambda i: i.Xavier(), (5,), "bn.running_var"),
    "mixed": (lambda i: i.Mixed([".*bias", ".*"], [i.One(),
                                                   i.Constant(2.0)]),
              (2, 3), "d.weight"),
}


@pytest.mark.parametrize("key", sorted(DETERMINISTIC))
def test_deterministic_initializers_match_jax(key):
    make, shape, name = DETERMINISTIC[key]
    jmx, tmx = jax_mx(), port_mx()
    ja = jmx.np.zeros(shape)
    make(jmx.init)(name, ja)
    t = torch.full(shape, 7.0)
    make(tmx.init)(name, t)
    np.testing.assert_array_equal(t.numpy(), ja.asnumpy())


def test_load_initializer_matches_jax(tmp_path):
    f = tmp_path / "init.npz"
    np.savez(f, **{"arg:a.weight": rand(2, 3), "b.weight": rand(4, seed=1)})
    jmx, tmx = jax_mx(), port_mx()
    for name, shape in (("a.weight", (2, 3)), ("b.weight", (4,)),
                        ("c.weight", (2, 2))):
        ja = jmx.np.zeros(shape)
        jmx.init.Load(str(f), default_init=jmx.init.One())(name, ja)
        t = torch.zeros(shape)
        tmx.init.Load(str(f), default_init=tmx.init.One())(name, t)
        np.testing.assert_array_equal(t.numpy(), ja.asnumpy())
    with pytest.raises(ValueError):
        tmx.init.Load(str(f))("c.weight", torch.zeros(2))


@pytest.mark.parametrize("key,make,std", [
    ("uniform", lambda i: i.Uniform(0.3), 0.3 / 3 ** 0.5),
    ("normal", lambda i: i.Normal(0.2), 0.2),
    ("xavier", lambda i: i.Xavier(), (2 / (200 + 300)) ** 0.5),
    ("xavier_gaussian_out", lambda i: i.Xavier("gaussian", "out", 2),
     (2 / 200) ** 0.5),
    ("msraprelu", lambda i: i.MSRAPrelu(slope=0.1),
     (2 / 1.01 / 250) ** 0.5),
])
def test_random_initializers_shape_and_scale(key, make, std):
    """The streams differ by design: both packages' draws have the
    shape and, within 3% over 60000 draws, the deviation of the rule."""
    jmx, tmx = jax_mx(), port_mx()
    ja = jmx.np.zeros((200, 300))
    make(jmx.init)("w", ja)
    t = torch.zeros(200, 300)
    make(tmx.init)("w", t)
    for got in (t.numpy(), ja.asnumpy()):
        assert got.shape == (200, 300)
        assert abs(got.std() - std) < 0.03 * std, (key, got.std(), std)
        assert abs(got.mean()) < 0.03 * std


def test_orthogonal_initializer():
    tmx = port_mx()
    t = torch.zeros(6, 2, 5)
    tmx.init.Orthogonal(scale=1.5)("w", t)
    q = t.reshape(6, 10)
    np.testing.assert_allclose((q @ q.T).numpy(), 2.25 * np.eye(6),
                               atol=1e-5)
    t = torch.zeros(8, 3)
    tmx.init.Orthogonal(rand_type="normal")("w", t)
    np.testing.assert_allclose((t.T @ t).numpy(), 1.414 ** 2 * np.eye(3),
                               atol=1e-5)


def test_initializer_on_ndarray_and_seed():
    tmx = port_mx()
    with tmx.Context("cpu"):
        a = tmx.np.zeros((3, 4))
        tmx.random.seed(5)
        tmx.init.Uniform(0.5)("w", a)
        b = tmx.np.zeros((3, 4))
        tmx.random.seed(5)
        tmx.init.Uniform(0.5)("w", b)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert 0 < np.abs(a.asnumpy()).max() <= 0.5
