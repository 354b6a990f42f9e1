"""The rest of the name parity of ``test_torch_np_names.py`` (whose
docstring states the method and the tolerances): the JAX package's
explicit ``mx.np`` functions (``test_torch_np_names_other.py`` holds its
``_OTHER_PASSTHROUGH`` list), every public callable of ``mx.np.linalg``,
and ``mx.nd``'s names.

Linear algebra within 1e-4 (the LAPACK routes differ); the
decompositions (svd, qr, eig, eigh, eigvals) are compared through
quantities that do not depend on the choice of signs and order.
"""
from __future__ import annotations

import pytest
import torch

from np_names_tables import EXPLICIT, LINALG, public_callables
from np_parity import assert_same, jax_mx, port_mx, to_numpy
from test_torch_np_names import run_case as _run_case

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


@pytest.mark.parametrize("name", sorted(EXPLICIT))
def test_np_name_value_and_dtype(name):
    _run_case(name)


def test_linalg_names_covered():
    names = [n for n in public_callables(jax_mx().np.linalg)
             if n != "apply_op"]
    assert sorted(names) == sorted(LINALG)
    assert all(hasattr(port_mx().np.linalg, n) for n in names)


@pytest.mark.parametrize("name", sorted(LINALG))
def test_linalg_name_value_and_dtype(name):
    jmx, tmx = jax_mx(), port_mx()
    fn = LINALG[name]
    want = to_numpy(fn(jmx, lambda v: jmx.np.array(v)))
    got = to_numpy(fn(tmx, lambda v: tmx.np.array(v)))
    assert_same(got, want, rtol=1e-4, atol=1e-4, name=name)


def test_nd_names():
    """mx.nd re-exports mx.np, plus the legacy names: every public callable
    of the JAX package's mx.nd exists in the port (or is unported), and
    the np names it shares are the port's np functions."""
    from mxnet_tpu_torch._unported import UNPORTED
    un = {(ns, n) for ns, n, _, _ in UNPORTED}
    jnd, tnd, tnp = jax_mx().nd, port_mx().nd, port_mx().np
    for n in public_callables(jnd):
        if ("nd", n) in un:
            continue
        assert hasattr(tnd, n), n
        if hasattr(tnp, n) and n not in ("split", "array"):
            assert getattr(tnd, n) is getattr(tnp, n), n
