"""Port parity: the model zoo's ResNet v1 bottleneck networks against ``mxnet_tpu``
on the CPU, as ``test_torch_zoo_resnet.py`` holds the others (its
``CASES``): forward, input and parameter gradients with the ``thumbnail`` stem and in NHWC.
"""
from __future__ import annotations

import pytest

from test_torch_zoo_resnet import check_case


@pytest.mark.parametrize("case", ["v1_bottleneck_thumbnail", "v1_bottleneck_nhwc"])
def test_resnet_v1_bottleneck_forward_backward_matches_jax(case, tmp_path):
    check_case(case, tmp_path)
