"""``mx.np.random`` and ``mx.random`` of the port.

The values cannot equal the JAX package's threefry streams, so each
sampler is held, for every public name of the JAX package's
``mx.np.random`` (read from its ``dir()``), to: the JAX sampler's shape
and dtype on the same arguments; its support; its mean (and variance
where the distribution has one) within 6 standard errors over 20000 draws
(about one false failure in 10**8 a moment); and the port's own
reproducibility: the same ``mx.random.seed`` gives the same draws, another
seed others.  ``uniform``/``normal`` are differentiable in their
parameters.
"""
from __future__ import annotations

import math
import types

import numpy as np
import pytest
import torch

from np_parity import jax_mx, port_mx, to_numpy

torch.set_num_threads(2)

N = 20000


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


# name -> (call(m, n), support check, mean, variance) (None: not checked)
def _p(m, v):
    return m.np.array(np.asarray(v, np.float32))


CASES = {
    "uniform": (lambda m, n: m.np.random.uniform(-1.0, 3.0, size=n),
                lambda v: (v >= -1).all() and (v < 3).all(), 1.0, 16 / 12),
    "normal": (lambda m, n: m.np.random.normal(1.0, 2.0, size=n),
               None, 1.0, 4.0),
    "randn": (lambda m, n: m.np.random.randn(n), None, 0.0, 1.0),
    "rand": (lambda m, n: m.np.random.rand(n),
             lambda v: (v >= 0).all() and (v < 1).all(), 0.5, 1 / 12),
    "randint": (lambda m, n: m.np.random.randint(2, 9, size=n),
                lambda v: (v >= 2).all() and (v < 9).all(), 5.0, 4.0),
    "choice": (lambda m, n: m.np.random.choice(5, size=n),
               lambda v: set(np.unique(v)) <= set(range(5)), 2.0, 2.0),
    "beta": (lambda m, n: m.np.random.beta(2.0, 3.0, size=n),
             lambda v: (v > 0).all() and (v < 1).all(), 0.4, 0.04),
    "gamma": (lambda m, n: m.np.random.gamma(2.5, 2.0, size=n),
              lambda v: (v > 0).all(), 5.0, 10.0),
    "exponential": (lambda m, n: m.np.random.exponential(2.0, size=n),
                    lambda v: (v >= 0).all(), 2.0, 4.0),
    "poisson": (lambda m, n: m.np.random.poisson(3.0, size=n),
                lambda v: (v >= 0).all(), 3.0, 3.0),
    "laplace": (lambda m, n: m.np.random.laplace(1.0, 2.0, size=n),
                None, 1.0, 8.0),
    "gumbel": (lambda m, n: m.np.random.gumbel(1.0, 2.0, size=n),
               None, 1.0 + 2.0 * 0.5772156649, math.pi ** 2 / 6 * 4),
    "logistic": (lambda m, n: m.np.random.logistic(1.0, 2.0, size=n),
                 None, 1.0, math.pi ** 2 / 3 * 4),
    "pareto": (lambda m, n: m.np.random.pareto(5.0, size=n),
               lambda v: (v >= 1).all(), 1.25, 5 / (16 * 3)),
    "power": (lambda m, n: m.np.random.power(3.0, size=n),
              lambda v: (v > 0).all() and (v <= 1).all(), 0.75, 3 / 80),
    "rayleigh": (lambda m, n: m.np.random.rayleigh(2.0, size=n),
                 lambda v: (v >= 0).all(), 2.0 * math.sqrt(math.pi / 2),
                 (4 - math.pi) / 2 * 4),
    "weibull": (lambda m, n: m.np.random.weibull(2.0, size=n),
                lambda v: (v >= 0).all(), math.gamma(1.5),
                1 - math.gamma(1.5) ** 2),
    "chisquare": (lambda m, n: m.np.random.chisquare(4.0, size=n),
                  lambda v: (v > 0).all(), 4.0, 8.0),
    "f": (lambda m, n: m.np.random.f(5.0, 10.0, size=n),
          lambda v: (v > 0).all(), 10 / 8, None),
    "binomial": (lambda m, n: m.np.random.binomial(10, 0.3, size=n),
                 lambda v: (v >= 0).all() and (v <= 10).all(), 3.0, 2.1),
    "negative_binomial": (lambda m, n: m.np.random.negative_binomial(
        3.0, 0.4, size=n), lambda v: (v >= 0).all(), 4.5, 11.25),
    "geometric": (lambda m, n: m.np.random.geometric(0.25, size=n),
                  lambda v: (v >= 1).all(), 4.0, 12.0),
    "lognormal": (lambda m, n: m.np.random.lognormal(0.0, 0.5, size=n),
                  lambda v: (v > 0).all(), math.exp(0.125),
                  (math.exp(0.25) - 1) * math.exp(0.25)),
    "bernoulli": (lambda m, n: m.np.random.bernoulli(0.3, size=n),
                  lambda v: set(np.unique(v)) <= {0.0, 1.0}, 0.3, 0.21),
    "categorical": (lambda m, n: m.np.random.categorical(
        _p(m, np.log([0.2, 0.3, 0.5])), shape=(n,)),
        lambda v: set(np.unique(v)) <= {0, 1, 2}, 1.3, 0.61),
    "multinomial": (lambda m, n: m.np.random.multinomial(
        10, _p(m, [0.2, 0.8]), size=(n,))[:, 0],
        lambda v: (v >= 0).all() and (v <= 10).all(), 2.0, 1.6),
    "dirichlet": (lambda m, n: m.np.random.dirichlet(
        _p(m, [1.0, 2.0, 3.0]), size=(n,))[:, 2],
        lambda v: (v > 0).all() and (v < 1).all(), 0.5, 0.5 * 0.5 / 7),
    "multivariate_normal": (lambda m, n: m.np.random.multivariate_normal(
        _p(m, [1.0, -1.0]), _p(m, [[2.0, 0.5], [0.5, 1.0]]),
        size=(n,))[:, 0], None, 1.0, 2.0),
    "permutation": (lambda m, n: m.np.random.permutation(n),
                    lambda v: (np.sort(v) == np.arange(len(v))).all(),
                    None, None),
}
ELSEWHERE = ("shuffle", "seed", "next_key", "apply_op", "ndarray")


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType)
                  and callable(getattr(mod, n)))


def test_every_random_name_has_a_case():
    names = _public(jax_mx().np.random)
    assert len(names) == 34
    assert not [n for n in names if n not in CASES and n not in ELSEWHERE]
    assert all(hasattr(port_mx().np.random, n) for n in names)
    top = [n for n in _public(jax_mx().random)]
    assert all(hasattr(port_mx().random, n) for n in top), top


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampler_shape_dtype_support_moments(name):
    call, support, mean, var = CASES[name]
    want = to_numpy(call(jax_mx(), 64))
    port_mx().random.seed(17)
    got = to_numpy(call(port_mx(), N))
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape[1:] == want.shape[1:] and got.shape[0] == N
    if support is not None:
        assert support(got), name
    v = got.astype(np.float64)
    if mean is not None:
        sd = math.sqrt(var if var is not None else v.var())
        assert abs(v.mean() - mean) <= 6 * sd / math.sqrt(N), (
            name, v.mean(), mean)
    if var is not None:
        # the variance's standard error from the sample's 4th moment
        m4 = ((v - v.mean()) ** 4).mean()
        se = math.sqrt(max(m4 - var ** 2, 1e-12) / N)
        assert abs(v.var() - var) <= 6 * se, (name, v.var(), var)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seed_reproduces_draws(name):
    call = CASES[name][0]
    tmx = port_mx()
    tmx.random.seed(5)
    a = to_numpy(call(tmx, 32))
    b = to_numpy(call(tmx, 32))
    tmx.random.seed(5)
    np.testing.assert_array_equal(to_numpy(call(tmx, 32)), a)
    if name != "permutation":
        assert not np.array_equal(a, b)


def test_shuffle_and_permutation_of_an_array():
    tmx = port_mx()
    x = tmx.np.arange(10)
    view = x.reshape(2, 5)
    tmx.random.seed(1)
    tmx.np.random.shuffle(x)
    assert sorted(x.tolist()) == list(range(10))
    assert x.tolist() != list(range(10))
    assert view.asnumpy().ravel().tolist() == list(range(10))
    p = tmx.np.random.permutation(tmx.np.array(np.eye(4, dtype=np.float32)))
    assert sorted(p.asnumpy().argmax(1).tolist()) == [0, 1, 2, 3]


def test_reparameterised_gradients():
    tmx = port_mx()
    mu = tmx.np.array(np.array([1.0, 2.0], np.float32))
    sig = tmx.np.array(np.array([0.5, 3.0], np.float32))
    for p in (mu, sig):
        p.attach_grad()
    with tmx.autograd.record():
        x = tmx.np.random.normal(mu, sig, size=(1000, 2))
        loss = x.sum()
    loss.backward()
    np.testing.assert_allclose(mu.grad.asnumpy(), [1000.0, 1000.0])
    z = (x.asnumpy() - mu.asnumpy()) / sig.asnumpy()
    np.testing.assert_allclose(sig.grad.asnumpy(), z.sum(0), rtol=1e-3)


def test_random_draws_on_the_default_device(monkeypatch):
    tmx = port_mx()
    assert tmx.np.random.uniform(size=3).ctx == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tmx.Context("gpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmx.np.random.uniform(size=3)
