"""mx.np.linalg: linear algebra over ``torch.linalg`` (the port of
``mxnet_tpu/numpy/linalg.py``; parity: reference
``src/operator/numpy/linalg/``).

Integer inputs are taken as float32, as ``jax.numpy.linalg`` takes them.
``svd`` returns (U, S, Vh) of the reduced decomposition; ``eig`` and
``eigvals`` return complex64 for float32 input; ``lstsq`` returns (x,
residuals, rank, singular values) as numpy does, its residuals empty
unless the system is overdetermined and of full rank.
"""
from __future__ import annotations

import torch

from ..ndarray import apply_op, _unwrap  # noqa: F401


def _f(x):
    return x if (x.is_floating_point() or x.is_complex()) else x.to(
        torch.float32)


def _wrap1(name, fn):
    def f(a, *args, **kw):
        return apply_op(lambda x: fn(_f(x), *args, **kw), a)

    f.__name__ = name
    return f


def norm(x, ord=None, axis=None, keepdims=False):
    return apply_op(lambda v: torch.linalg.norm(
        _f(v), ord=ord, dim=axis, keepdim=keepdims), x)


def norm_(x, ord=None, axis=None, keepdims=False):
    """``norm`` of an array-like (the JAX package's ``norm_`` is
    ``jnp.linalg.norm`` itself)."""
    from ..ndarray import ndarray, array
    return norm(x if isinstance(x, ndarray) else array(x), ord, axis,
                keepdims)


def _matrix_rank(x, tol=None, hermitian=False):
    return torch.linalg.matrix_rank(x, atol=tol, hermitian=hermitian)


def _pinv(x, rcond=None, hermitian=False, rtol=None):
    r = rtol if rtol is not None else rcond
    return torch.linalg.pinv(x, rtol=r, hermitian=hermitian)


cholesky = _wrap1("cholesky", lambda x, upper=False: torch.linalg.cholesky(
    x, upper=upper))
inv = _wrap1("inv", torch.linalg.inv)
pinv = _wrap1("pinv", _pinv)
det = _wrap1("det", torch.linalg.det)
matrix_rank = _wrap1("matrix_rank", _matrix_rank)


def matrix_power(a, n):
    return apply_op(lambda x: torch.linalg.matrix_power(x, n), a)


def slogdet(a):
    return apply_op(lambda x: tuple(torch.linalg.slogdet(_f(x))), a)


def svd(a):
    """(U, S, Vh) of the reduced SVD (the rows of Vh are the right
    singular vectors; reference ``_npi_svd`` layout ut, l, v)."""
    return apply_op(lambda x: tuple(torch.linalg.svd(
        _f(x), full_matrices=False)), a)


def qr(a, mode="reduced"):
    return apply_op(lambda x: tuple(torch.linalg.qr(_f(x), mode=mode)), a)


def eig(a):
    return apply_op(lambda x: tuple(torch.linalg.eig(_f(x))), a)


def eigh(a, UPLO="L"):
    return apply_op(lambda x: tuple(torch.linalg.eigh(_f(x), UPLO=UPLO)), a)


def eigvals(a):
    return apply_op(lambda x: torch.linalg.eigvals(_f(x)), a)


def eigvalsh(a, UPLO="L"):
    return apply_op(lambda x: torch.linalg.eigvalsh(_f(x), UPLO=UPLO), a)


def solve(a, b):
    def f(x, y):
        x, y = _f(x), _f(y).to(_f(x).dtype)
        if y.dim() == 1 or (y.dim() == x.dim() - 1):
            return torch.linalg.solve(x, y.unsqueeze(-1)).squeeze(-1)
        return torch.linalg.solve(x, y)
    return apply_op(f, a, b)


def lstsq(a, b, rcond="warn"):
    rc = None if rcond == "warn" else rcond

    def f(x, y):
        x, y = _f(x), _f(y).to(_f(x).dtype)
        m, n = x.shape[-2], x.shape[-1]
        s = torch.linalg.svdvals(x)
        tol = (rc if rc is not None else torch.finfo(x.dtype).eps * max(m, n)
               ) * s.max()
        rank = (s > tol).sum().to(torch.int32)
        sol = torch.linalg.pinv(x, rtol=(tol / s.max())) @ y
        if int(rank) == n and m > n:
            r = x @ sol - y
            res = (r * r).sum(0) if y.dim() > 1 else (r * r).sum().reshape(1)
        else:
            res = torch.zeros(0, dtype=x.dtype, device=x.device)
        return sol, res, rank, s
    return apply_op(f, a, b)


def tensorinv(a, ind=2):
    return apply_op(lambda x: torch.linalg.tensorinv(_f(x), ind), a)


def tensorsolve(a, b, axes=None):
    return apply_op(lambda x, y: torch.linalg.tensorsolve(
        _f(x), _f(y).to(_f(x).dtype), axes), a, b)


def multi_dot(arrays):
    return apply_op(lambda *xs: torch.linalg.multi_dot([_f(x) for x in xs]),
                    *arrays)


def cond(x, p=None):
    return apply_op(lambda v: torch.linalg.cond(_f(v), p), x)
