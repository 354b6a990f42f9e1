"""mx.random: the top-level random namespace (the port of
``mxnet_tpu/random.py``; parity: ``python/mxnet/random.py``).

Delegates to ``mx.np.random``; ``seed`` reseeds the global state of
``_rng`` (every draw after it, on every device, is reproducible)."""
from __future__ import annotations

from ._rng import seed  # noqa: F401
from .numpy.random import (  # noqa: F401
    uniform, normal, randint, randn, rand, choice, shuffle, permutation,
    beta, gamma, exponential, poisson, multinomial, categorical,
    laplace, gumbel, logistic, pareto, power, rayleigh, weibull,
    chisquare, binomial, negative_binomial, geometric, dirichlet, bernoulli,
    lognormal, multivariate_normal,
)
