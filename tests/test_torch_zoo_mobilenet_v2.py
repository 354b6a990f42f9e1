"""Port parity: MobileNet v2 at 0.25 (``model_zoo.vision.mobilenet``)
against ``mxnet_tpu`` on the CPU, as ``test_torch_zoo_families.py``
holds MobileNet v1 (its ``CASES``, outside training for the reason given
there).
"""
from __future__ import annotations

from gluon_parity import rand
from test_torch_zoo_families import CASES, check_family


def test_mobilenet_v2_matches_jax(tmp_path):
    make, shape, train = CASES["mobilenetv2_0.25"]
    check_family("mobilenetv2_0.25", make, rand(*shape), train, tmp_path)
