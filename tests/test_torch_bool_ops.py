"""Port parity: arithmetic with bool arrays (``x == y`` and the like).

Every binary op of ``mx.np`` and every operator of ``ndarray`` is held
against ``mxnet_tpu`` on the CPU with a bool array beside a Python int,
a Python float, a Python bool, an int32 array, a float32 array and
another bool array, on either side: the result has the JAX package's
value and dtype, or both packages raise.  jax.numpy promotes a bool
operand to its partner's type (``1 - same`` is int32, ``same - 1.5``
float32); two bools stay bool where the op allows it and raise where it
does not (``same - same``, ``-same``).  The port used to hand the bool
tensor to torch unpromoted, which refuses bool subtraction.  The
ops are spread over three files; the operators, the unary ops and the
example's expression are in ``test_torch_bool_operators.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gluon_parity import jax_mx, port_mx

import mxnet_tpu.numpy as jnp_mod

torch.set_num_threads(2)

A = np.array([1.0, 2.0, 3.0], np.float32)
B = np.array([1.0, 5.0, 3.0], np.float32)
PARTNERS = ("int", "float", "pybool", "int_arr", "float_arr", "bool")


def _operands(mx):
    same = mx.np.array(A) == mx.np.array(B)
    return same, {"int": 1, "float": 1.5, "pybool": True,
                  "int_arr": mx.np.array([1, 2, 3], dtype="int32"),
                  "float_arr": mx.np.array([0.5, 1.5, 2.5],
                                           dtype="float32"),
                  "bool": mx.np.array([True, True, False])}


def _outcome(mx, f, partner, reverse):
    same, partners = _operands(mx)
    other = partners[partner]
    try:
        r = f(other, same) if reverse else f(same, other)
    except Exception as e:            # noqa: BLE001 (compared below)
        return ("raises", type(e).__name__)
    r = r.asnumpy() if hasattr(r, "asnumpy") else np.asarray(r)
    return ("value", str(r.dtype), r)


def _check(f, what):
    jmx, tmx = jax_mx(), port_mx()
    for partner in PARTNERS:
        for reverse in (False, True):
            want = _outcome(jmx, f, partner, reverse)
            with tmx.Context("cpu"):
                got = _outcome(tmx, f, partner, reverse)
            case = (what, partner, "reflected" if reverse else "")
            assert got[0] == want[0], (case, got, want)
            if want[0] == "value":
                assert got[1] == want[1], (case, got, want)
                # the same dtype and elementwise the same value: integers
                # and bools exactly, floats to the last ulp (nan where
                # nan, as an integer-free x // 0. is nan in both)
                np.testing.assert_allclose(
                    got[2].astype(np.float64), want[2].astype(np.float64),
                    rtol=1e-6, atol=0, equal_nan=True, err_msg=str(case))


#: the ops, a third a file (here and in ``test_torch_bool_ops_2.py`` and
#: ``_3.py``)
OPS = [jnp_mod._BINARY[i::3] for i in range(3)]


@pytest.mark.parametrize("op", OPS[0])
def test_np_binary_op_with_bool_operands_matches_jax(op):
    _check(lambda a, b: getattr(_mx_of(a, b).np, op)(a, b), op)


def _mx_of(a, b):
    for v in (a, b):
        mod = type(v).__module__
        if mod.startswith("mxnet_tpu_torch"):
            return port_mx()
        if mod.startswith("mxnet_tpu"):
            return jax_mx()
    raise AssertionError("no array operand")
