"""Port parity: ``mx.np``'s binary ops with bool operands against
``mxnet_tpu`` on the CPU, the second third of them (``test_torch_bool_ops.py``
has the check and the first third).
"""
from __future__ import annotations

import pytest

from test_torch_bool_ops import OPS, _check, _mx_of


@pytest.mark.parametrize("op", OPS[1])
def test_np_binary_op_with_bool_operands_matches_jax(op):
    _check(lambda a, b: getattr(_mx_of(a, b).np, op)(a, b), op)
