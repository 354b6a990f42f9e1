"""Port parity: Inception v3's D block and its nested-concat E block
against ``mxnet_tpu`` on the CPU, as ``test_torch_zoo_inception.py``
holds A, B and C (its ``BLOCKS``).
"""
from __future__ import annotations

import pytest

from gluon_parity import rand
from test_torch_zoo_families import check_family
from test_torch_zoo_inception import BLOCKS


@pytest.mark.parametrize("block", ["D", "E"])
def test_inception_block_matches_jax(block, tmp_path):
    check_family("inception " + block, BLOCKS[block], rand(2, 8, 9, 9),
                 True, tmp_path)
