"""The repo's examples run on the port on the CPU (three of four files):
each example script, unedited, runs in a process of its own with
``mxnet_tpu`` imported as ``mxnet_tpu_torch`` and the CPU as the default
device (``tests/example_runner.py``), with its smoke arguments, and must
exit 0 having printed its closing line.  ``chip_smoke.py`` runs the same
list on the card.
"""
from __future__ import annotations

import pytest

from example_runner import check_example


@pytest.mark.parametrize("name", ['serving_resnet50', 'lipnet', 'word_language_model'])
def test_example_runs_on_the_port(name, tmp_path):
    check_example(name, tmp_path)
