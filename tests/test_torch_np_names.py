"""Every public name of the JAX package's ``mx.np`` against the port's,
read from the JAX package itself: its ``_UNARY``, ``_BINARY``,
``_REDUCTION`` and ``_OTHER_PASSTHROUGH`` lists and ``dir()`` of the
namespace, not a copy of them.  Each callable name is either called in
both packages on the same seeded inputs (``np_parity.inputs``; the calls
in ``np_names_tables.py``) and agrees in value and in dtype, or is in the
port's unported tuple (``mxnet_tpu_torch._unported.UNPORTED``) and raises
``NotImplementedError`` naming its ROADMAP item.  The dtype constants are
the same objects (bfloat16 is ``torch.bfloat16`` in the port).  This file
holds the coverage, the elementwise and reduction lists and the
constants; ``test_torch_np_names_other.py`` the passthrough list and
``test_torch_np_names_more.py`` the explicit functions, ``np.linalg``
and ``nd``.

Tolerance: float32 within rtol 1e-5 / atol 1e-6 (XLA's and torch's
elementwise math differ by an ulp or two; reductions sum in different
orders); ``LOOSE`` names (special functions, products, LAPACK routes)
within their stated tolerance.  ``mx.np.random``'s names are held in
``test_torch_np_random.py`` (distributions, not streams).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from np_names_tables import (INT_UNARY, LOOSE, STRUCTURAL, TYPES, X, case,
                             jnp_names)
from np_parity import assert_same, jax_mx, port_mx, to_numpy

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


def _unported():
    from mxnet_tpu_torch._unported import UNPORTED
    return {(ns, n): item for ns, n, item, _ in UNPORTED}


def run_case(name):
    jmx, tmx = jax_mx(), port_mx()
    fn = case(name)
    want = to_numpy(fn(jmx, lambda v: jmx.np.array(v)))
    got = to_numpy(fn(tmx, lambda v: tmx.np.array(v)))
    tol = LOOSE.get(name, 1e-5)
    assert_same(got, want, rtol=tol, atol=tol * 0.1, name=name)


def test_unported_tuple_is_small_and_named():
    """At most 20 names across np, np.linalg, np.random, npx and nd; each
    raises NotImplementedError naming its ROADMAP item."""
    un = _unported()
    assert len(un) <= 20
    tmx = port_mx()
    mods = {"np": tmx.np, "linalg": tmx.np.linalg, "random": tmx.np.random,
            "npx": tmx.npx, "nd": tmx.nd}
    for (ns, name), item in un.items():
        with pytest.raises(NotImplementedError, match="item %d" % item):
            getattr(mods[ns], name)()


def test_every_list_name_has_a_case():
    """Each name of the JAX package's four lists and every other public
    callable of its mx.np is covered, and the port has each."""
    jnp_mod = jax_mx().np
    lists = (jnp_mod._UNARY + jnp_mod._BINARY + jnp_mod._REDUCTION
             + jnp_mod._OTHER_PASSTHROUGH)
    names = set(jnp_names())
    assert set(lists) - {"trapz", "msort"} <= names
    missing = [n for n in names if n not in TYPES and n not in STRUCTURAL
               and case(n) is None and ("np", n) not in _unported()]
    assert not missing, missing
    port = port_mx().np
    absent = [n for n in names if not hasattr(port, n)]
    assert not absent, absent


@pytest.mark.parametrize("name", sorted(set(
    jax_mx().np._UNARY + jax_mx().np._BINARY + jax_mx().np._REDUCTION)))
def test_np_name_value_and_dtype(name):
    run_case(name)


@pytest.mark.parametrize("name", INT_UNARY)
def test_np_unary_on_int32(name):
    """jax.numpy's promotion of an int32 input: sqrt, rint, reciprocal,
    exp, degrees, cbrt, exp2 give float32; ceil, floor, abs, square,
    negative, sign keep int32."""
    jmx, tmx = jax_mx(), port_mx()
    want = to_numpy(getattr(jmx.np, name)(jmx.np.array(X["I"] - 4)))
    got = to_numpy(getattr(tmx.np, name)(tmx.np.array(X["I"] - 4)))
    assert_same(got, want, name=name)


@pytest.mark.parametrize("name", TYPES)
def test_np_type_names_identical(name):
    assert getattr(port_mx().np, name) is getattr(jax_mx().np, name)


def test_np_structural_names():
    tmx = port_mx()
    assert tmx.np.bfloat16 is torch.bfloat16
    assert tmx.np.ndarray is tmx.nd.NDArray
    assert tmx.np.current_context() == torch.device("cpu")
    assert tmx.np.apply_op(torch.add, tmx.np.ones(2), 1).tolist() == [2, 2]
    for const in ("pi", "e", "euler_gamma", "inf", "newaxis", "PZERO",
                  "NZERO"):
        a, b = getattr(tmx.np, const), getattr(jax_mx().np, const)
        assert a == b or (a is None and b is None), const
    assert np.isnan(tmx.np.nan)
