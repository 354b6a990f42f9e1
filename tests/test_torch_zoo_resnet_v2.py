"""Port parity: the model zoo's ResNet v2 basic-block networks against ``mxnet_tpu``
on the CPU, as ``test_torch_zoo_resnet.py`` holds the others (its
``CASES``): forward, input and parameter gradients, with the ``thumbnail`` stem in NHWC, and two SGD-momentum steps in
NHWC.
"""
from __future__ import annotations

import pytest

from test_torch_zoo_resnet import check_case, check_two_steps


@pytest.mark.parametrize("case", ["v2_basic_nchw", "v2_basic_thumbnail_nhwc"])
def test_resnet_v2_forward_backward_matches_jax(case, tmp_path):
    check_case(case, tmp_path)


def test_two_sgd_momentum_steps_nhwc_match_jax(tmp_path):
    check_two_steps("NHWC", tmp_path)
