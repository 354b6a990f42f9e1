"""mx.np.random: NumPy-compatible samplers on torch generators (the port of
``mxnet_tpu/numpy/random.py``; parity: reference
``python/mxnet/numpy/random.py``, ``src/operator/random/``).

Each draw takes a fresh seed from the global state (``_rng.next_seed``:
``seed(s)`` makes the whole sequence of draws reproducible) and builds a
``torch.Generator`` on the device it samples on: ``ctx``/``device`` when
given, else the device of an array parameter, else the default device.
The values cannot equal the JAX package's threefry streams, and the CPU's
and the card's streams for one seed differ; the distributions, shapes,
dtypes and supports are the JAX package's (``pareto`` is JAX's, x >= 1;
``poisson``, ``randint``, ``geometric`` and ``multinomial`` give int32).
The gamma family (``gamma``, ``beta``, ``dirichlet``, ``chisquare``,
``f``, ``negative_binomial``) samples by Marsaglia and Tsang's method with
a fixed number of rounds, so nothing waits on the card.  ``uniform``,
``normal`` and ``multivariate_normal`` are reparameterised: they are
differentiable with respect to array parameters.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import _rng
from .. import context as _context
from .._rng import seed  # noqa: F401  (seed re-exported)
from ..ndarray import (ndarray, apply_op, _unwrap, _wrap, _device_of,  # noqa
                       torch_dtype)

next_key = _rng.next_seed


def _size(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(int(s) for s in size)


def _device(ctx, device, *params):
    d = ctx if ctx is not None else device
    if d is not None:
        return _context.resolve(d)
    dd = _device_of(*params)
    return dd if dd is not None else _context.resolve(None)


def _param(v, dev, dt=torch.float32):
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return torch.as_tensor(onp.asarray(v), device=dev).to(dt)


def _out(res, out):
    if out is not None:
        out._set_data(res._data)
        return out
    return res


def _sample(fn, params, size, ctx=None, device=None, dtype=torch.float32,
            out=None):
    """``fn(gen, shape, *param tensors)`` with a fresh generator on the
    sampling device; array parameters join autograd."""
    dev = _device(ctx, device, *params)
    gen = _rng.generator(dev)
    s = _size(size)

    def f(*ps):
        ps = [_param(p, dev, dtype) for p in ps]
        shape = s if s else torch.broadcast_shapes(*[p.shape for p in ps])
        return fn(gen, tuple(shape), dev, *ps)

    return _out(apply_op(f, *params), out)


def _dtype(dtype, default=torch.float32):
    return torch_dtype(dtype) if dtype is not None else default


def _u(gen, shape, dev, dt=torch.float32, lo=0.0):
    u = torch.rand(shape, generator=gen, device=dev, dtype=dt)
    return u.clamp_min(lo) if lo else u


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, device=None,
            out=None):
    dt = _dtype(dtype)
    return _sample(lambda g, s, d, lo, hi: _u(g, s, d, dt) * (hi - lo) + lo,
                   (low, high), size, ctx, device, dt, out)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, device=None,
           out=None):
    dt = _dtype(dtype)
    return _sample(lambda g, s, d, mu, sig: torch.randn(
        s, generator=g, device=d, dtype=dt) * sig + mu, (loc, scale), size,
        ctx, device, dt, out)


def randn(*size, **kwargs):
    return normal(0.0, 1.0, size=size or None, **kwargs)


def rand(*size, **kwargs):
    return uniform(0.0, 1.0, size=size or None, **kwargs)


def randint(low, high=None, size=None, dtype=None, ctx=None, device=None,
            out=None):
    if high is None:
        low, high = 0, low
    dt = _dtype(dtype, torch.int32)
    dev = _device(ctx, device)
    gen = _rng.generator(dev)
    t = torch.randint(int(low), int(high), _size(size), generator=gen,
                      device=dev, dtype=torch.int64).to(dt)
    return _out(_wrap(t), out)


def choice(a, size=None, replace=True, p=None, ctx=None, device=None,
           out=None):
    dev = _device(ctx, device, a, p)
    gen = _rng.generator(dev)
    aval = _unwrap(a)
    if isinstance(aval, int):
        aval = torch.arange(aval, device=dev).to(torch.int32)
    elif not isinstance(aval, torch.Tensor):
        aval = torch.as_tensor(onp.asarray(aval), device=dev)
    n = aval.shape[0]
    shape = _size(size)
    k = int(onp.prod(shape)) if shape else 1
    if p is not None:
        pt = _param(_unwrap(p), dev)
        idx = torch.multinomial(pt, k, replacement=replace, generator=gen)
    elif replace:
        idx = torch.randint(0, n, (k,), generator=gen, device=dev)
    else:
        idx = torch.randperm(n, generator=gen, device=dev)[:k]
    res = aval[idx].reshape(shape + tuple(aval.shape[1:]))
    return _out(_wrap(res), out)


def shuffle(x):
    """Shuffle along axis 0, rebinding ``x`` (parity:
    mx.np.random.shuffle)."""
    t = x._data.detach()
    gen = _rng.generator(t.device)
    x._set_data(t[torch.randperm(t.shape[0], generator=gen,
                                 device=t.device)])


def permutation(x, **kw):
    if isinstance(x, int):
        dev = _device(kw.get("ctx"), kw.get("device"))
        gen = _rng.generator(dev)
        return _wrap(torch.randperm(x, generator=gen, device=dev).to(
            torch.int32))
    gen = _rng.generator(x._data.device)
    idx = torch.randperm(x.shape[0], generator=gen, device=x._data.device)
    return apply_op(lambda v: v[idx], x)


def _std_gamma(gen, k, rounds=16):
    """Gamma(k, 1) samples of the shape of ``k`` (float): Marsaglia and
    Tsang's method, ``rounds`` proposals each (a round fails with
    probability under 0.05), and the k < 1 boost by u**(1/k)."""
    small = k < 1
    a = torch.where(small, k + 1, k)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    res = torch.zeros_like(a)
    done = torch.zeros_like(a, dtype=torch.bool)
    for _ in range(rounds):
        x = torch.randn(a.shape, generator=gen, device=a.device,
                        dtype=a.dtype)
        v = (1 + c * x) ** 3
        u = _u(gen, a.shape, a.device, a.dtype, 1e-30)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
        res = torch.where(ok & ~done, d * v, res)
        done = done | ok
    u = _u(gen, a.shape, a.device, a.dtype, 1e-30)
    return torch.where(small, res * u ** (1.0 / k), res)


def beta(a, b, size=None, dtype=None, ctx=None, device=None):
    dt = _dtype(dtype)

    def fn(g, s, d, av, bv):
        x = _std_gamma(g, torch.broadcast_to(av, s).to(dt))
        y = _std_gamma(g, torch.broadcast_to(bv, s).to(dt))
        return x / (x + y)
    return _sample(fn, (a, b), size, ctx, device, dt)


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, device=None,
          out=None):
    dt = _dtype(dtype)
    return _sample(lambda g, s, d, k, th: _std_gamma(
        g, torch.broadcast_to(k, s).to(dt)) * th, (shape, scale), size, ctx,
        device, dt, out)


def exponential(scale=1.0, size=None, dtype=None, ctx=None, device=None,
                out=None):
    return _sample(lambda g, s, d, sc: -torch.log1p(-_u(g, s, d)) * sc,
                   (scale,), size, ctx, device, out=out)


def poisson(lam=1.0, size=None, dtype=None, ctx=None, device=None,
            out=None):
    def fn(g, s, d, lm):
        return torch.poisson(torch.broadcast_to(lm, s).float().contiguous(),
                             generator=g).to(torch.int32)
    return _sample(fn, (lam,), size, ctx, device, out=out)


def multinomial(n, pvals, size=None):
    def fn(g, s, d, p):
        k = p.shape[-1]
        shape = _size(size)
        m = int(onp.prod(shape)) if shape else 1
        draws = torch.multinomial(p.reshape(1, k).expand(m, k), int(n),
                                  replacement=True, generator=g)
        counts = torch.nn.functional.one_hot(draws, k).sum(1)
        return counts.reshape(shape + (k,)).to(torch.int32)
    return _sample(fn, (pvals,), (1,), None, None)


def categorical(logits, shape=None):
    def fn(g, s, d, lg):
        batch = _size(shape) or tuple(lg.shape[:-1])
        u = _u(g, batch + (lg.shape[-1],), d, lg.dtype, 1e-30)
        return torch.argmax(lg - torch.log(-torch.log(u)), -1).to(
            torch.int32)
    return _sample(fn, (logits,), (1,), None, None)


def multivariate_normal(mean, cov, size=None, check_valid=None, tol=None):
    def fn(g, s, d, m, c):
        shape = _size(size) + tuple(m.shape[-1:])
        z = torch.randn(shape, generator=g, device=d, dtype=m.dtype)
        L = torch.linalg.cholesky(c)
        return m + z @ L.T
    return _sample(fn, (mean, cov), (1,), None, None)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, ctx=None,
              device=None):
    n = normal(mean, sigma, size=size, dtype=dtype, ctx=ctx, device=device)
    return apply_op(torch.exp, n)


def logistic(loc=0.0, scale=1.0, size=None, ctx=None, device=None, out=None):
    def fn(g, s, d, mu, sc):
        u = _u(g, s, d, lo=1e-7).clamp_max(1 - 1e-7)
        return torch.log(u / (1 - u)) * sc + mu
    return _sample(fn, (loc, scale), size, ctx, device, out=out)


def gumbel(loc=0.0, scale=1.0, size=None, ctx=None, device=None, out=None):
    def fn(g, s, d, mu, sc):
        u = _u(g, s, d, lo=1e-30)
        return -torch.log(-torch.log(u)) * sc + mu
    return _sample(fn, (loc, scale), size, ctx, device, out=out)


def laplace(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, device=None,
            out=None):
    def fn(g, s, d, mu, sc):
        u = _u(g, s, d) - 0.5
        return mu - sc * torch.sign(u) * torch.log1p(
            -2 * u.abs()).clamp_min(-1e30)
    return _sample(fn, (loc, scale), size, ctx, device, out=out)


def rayleigh(scale=1.0, size=None, ctx=None, device=None, out=None):
    return _sample(lambda g, s, d, sc: sc * torch.sqrt(
        -2.0 * torch.log(_u(g, s, d, lo=1e-7))), (scale,), size, ctx,
        device, out=out)


def weibull(a, size=None, ctx=None, device=None, out=None):
    return _sample(lambda g, s, d, av: torch.pow(
        -torch.log(_u(g, s, d, lo=1e-7)), 1.0 / av), (a,), size, ctx,
        device, out=out)


def pareto(a, size=None, ctx=None, device=None, out=None):
    return _sample(lambda g, s, d, av: torch.exp(
        -torch.log1p(-_u(g, s, d)) / av), (a,), size, ctx, device, out=out)


def power(a, size=None, ctx=None, device=None, out=None):
    return _sample(lambda g, s, d, av: torch.pow(
        _u(g, s, d, lo=1e-7), 1.0 / av), (a,), size, ctx, device, out=out)


def chisquare(df, size=None, dtype=None, ctx=None, device=None):
    return gamma(_unwrap(df) / 2.0, 2.0, size=size, dtype=dtype, ctx=ctx,
                 device=device)


def f(dfnum, dfden, size=None, ctx=None, device=None):
    x1 = chisquare(dfnum, size=size, ctx=ctx, device=device)
    x2 = chisquare(dfden, size=size, ctx=ctx, device=device)
    return (x1 / dfnum) / (x2 / dfden)


def binomial(n, p, size=None, dtype=None, ctx=None, device=None):
    def fn(g, s, d, nv, pv):
        return torch.binomial(torch.broadcast_to(nv, s).float().contiguous(),
                              torch.broadcast_to(pv, s).float().contiguous(),
                              generator=g)
    return _sample(fn, (n, p), size, ctx, device)


def negative_binomial(n, p, size=None, dtype=None, ctx=None, device=None):
    pv = _unwrap(p)
    lam = gamma(n, (1.0 - pv) / pv, size=size, ctx=ctx, device=device)
    return poisson(lam)


def geometric(p, size=None, ctx=None, device=None):
    def fn(g, s, d, pv):
        u = _u(g, s, d, lo=1e-30)
        return (torch.floor(torch.log(u) / torch.log1p(-pv)) + 1).to(
            torch.int32)
    return _sample(fn, (p,), size, ctx, device)


def dirichlet(alpha, size=None, ctx=None, device=None):
    def fn(g, s, d, al):
        shape = _size(size) + tuple(al.shape)
        x = _std_gamma(g, torch.broadcast_to(al, shape).contiguous())
        return x / x.sum(-1, keepdim=True)
    return _sample(fn, (alpha,), (1,), ctx, device)


def bernoulli(prob=None, logit=None, size=None, dtype=None, ctx=None,
              device=None):
    dt = _dtype(dtype)
    if prob is None:
        return _sample(lambda g, s, d, lg: (_u(g, s, d) < torch.sigmoid(lg))
                       .to(dt), (logit,), size, ctx, device)
    return _sample(lambda g, s, d, pr: (_u(g, s, d) < pr).to(dt), (prob,),
                   size, ctx, device)
