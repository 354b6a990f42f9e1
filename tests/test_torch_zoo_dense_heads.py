"""Port parity: the model zoo's families with dropout in their heads —
VGG (narrow, with and without BatchNorm), AlexNet and SqueezeNet 1.1 —
against ``mxnet_tpu`` on the CPU, as ``test_torch_zoo_families.py``
holds the others.  Dropout draws its own mask in each package, so these
run the recorded forward outside training (BatchNorm on its running
statistics, dropout off) and its backward.
"""
from __future__ import annotations

import pytest

from gluon_parity import rand
from test_torch_zoo_families import check_family

CASES = {
    "vgg_narrow": (lambda g: g.model_zoo.vision.VGG(
        [1, 1], [4, 8], classes=10), (2, 3, 16, 16)),
    "vgg_narrow_bn": (lambda g: g.model_zoo.vision.VGG(
        [1, 2], [4, 8], classes=10, batch_norm=True), (2, 3, 16, 16)),
    "alexnet": (lambda g: g.model_zoo.vision.alexnet(classes=10),
                (1, 3, 67, 67)),
    "squeezenet1.1": (lambda g: g.model_zoo.vision.get_model(
        "squeezenet1.1", classes=10), (2, 3, 32, 32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_family_member_matches_jax(name, tmp_path):
    make, shape = CASES[name]
    check_family(name, make, rand(*shape), False, tmp_path)
