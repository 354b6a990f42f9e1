"""Port parity: the model zoo's ResNet v2 bottleneck networks against ``mxnet_tpu``
on the CPU, as ``test_torch_zoo_resnet.py`` holds the others (its
``CASES``): forward, input and parameter gradients in both layouts.
"""
from __future__ import annotations

import pytest

from test_torch_zoo_resnet import check_case


@pytest.mark.parametrize("case", ["v2_bottleneck_nchw", "v2_bottleneck_nhwc"])
def test_resnet_v2_bottleneck_forward_backward_matches_jax(case, tmp_path):
    check_case(case, tmp_path)
