"""Port parity: Inception v3's blocks (``model_zoo.vision.inception``:
the A block at a narrow pool width, B, the C block at a narrow 7x7
width, D and the nested-concat E block) against ``mxnet_tpu`` on the
CPU, at a 9 x 9 input: forward in training mode, input and parameter
gradients.  The whole network needs a 299 x 299 input;
``test_torch_zoo_names.py`` holds its parameters, ``chip_smoke.py`` runs
it.  D and E are in ``test_torch_zoo_inception_de.py``.
"""
from __future__ import annotations

import pytest

from gluon_parity import rand
from test_torch_zoo_families import check_family

BLOCKS = {
    "A": lambda g: g.model_zoo.vision.inception._make_A(4),
    "B": lambda g: g.model_zoo.vision.inception._make_B(),
    "C": lambda g: g.model_zoo.vision.inception._make_C(4),
    "D": lambda g: g.model_zoo.vision.inception._make_D(),
    "E": lambda g: g.model_zoo.vision.inception._BranchesE(),
}


@pytest.mark.parametrize("block", ["A", "B", "C"])
def test_inception_block_matches_jax(block, tmp_path):
    check_family("inception " + block, BLOCKS[block], rand(2, 8, 9, 9),
                 True, tmp_path)
