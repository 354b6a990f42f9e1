"""Port parity: the ``ndarray`` operators and unary ops on bool arrays,
against ``mxnet_tpu`` on the CPU, as ``test_torch_bool_ops.py`` holds
``mx.np``'s binary ops (its operands and its check): value and dtype, or
both packages raise; and ``1 - (x == y)``, the expression of
``example/gluon/embedding_learning.py:54``.
"""
from __future__ import annotations

import operator

import pytest

from gluon_parity import jax_mx, port_mx
from test_torch_bool_ops import A, B, _check, _operands

OPERATORS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "floordiv": operator.floordiv,
    "mod": operator.mod, "pow": operator.pow, "and": operator.and_,
    "or": operator.or_, "xor": operator.xor, "lshift": operator.lshift,
    "rshift": operator.rshift, "eq": operator.eq, "ne": operator.ne,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt,
    "ge": operator.ge,
}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_with_bool_operands_matches_jax(name):
    _check(OPERATORS[name], name)


@pytest.mark.parametrize("name", ["neg", "abs", "invert", "pos", "sign",
                                  "square", "logical_not", "exp"])
def test_unary_op_of_bool_matches_jax(name):
    fns = {"neg": operator.neg, "abs": abs, "invert": operator.invert,
           "pos": operator.pos}
    jmx, tmx = jax_mx(), port_mx()

    def run(mx):
        same, _ = _operands(mx)
        f = fns.get(name) or getattr(mx.np, name)
        try:
            r = f(same)
        except Exception as e:        # noqa: BLE001
            return ("raises", type(e).__name__)
        return ("value", str(r.asnumpy().dtype), r.asnumpy().tolist())

    want = run(jmx)
    with tmx.Context("cpu"):
        got = run(tmx)
    assert got[0] == want[0], (name, got, want)
    if want[0] == "value":
        assert got[1:] == want[1:], (name, got, want)


def test_embedding_learning_expression():
    """``neg = 1 - same`` (``example/gluon/embedding_learning.py:54``)."""
    jmx, tmx = jax_mx(), port_mx()
    want = 1 - (jmx.np.array(A) == jmx.np.array(B))
    with tmx.Context("cpu"):
        got = 1 - (tmx.np.array(A) == tmx.np.array(B))
        back = (tmx.np.array(A) == tmx.np.array(B)) - 1
    assert str(got.dtype) == str(want.dtype) == "int32"
    assert got.asnumpy().tolist() == want.asnumpy().tolist() == [0, 1, 0]
    assert back.asnumpy().tolist() == [0, -1, 0]
