"""The JAX package's ``_OTHER_PASSTHROUGH`` list of ``mx.np`` against the
port's, by the method and tolerances of ``test_torch_np_names.py``."""
from __future__ import annotations

import pytest
import torch

from np_parity import jax_mx, port_mx
from test_torch_np_names import run_case as _run_case

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


@pytest.mark.parametrize("name", [
    n for n in sorted(set(jax_mx().np._OTHER_PASSTHROUGH))
    if hasattr(jax_mx().np, n)])
def test_np_name_value_and_dtype(name):
    _run_case(name)
