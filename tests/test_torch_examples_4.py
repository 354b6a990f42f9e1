"""The repo's examples run on the port on the CPU (four of four files):
each example script, unedited, runs in a process of its own with
``mxnet_tpu`` imported as ``mxnet_tpu_torch`` and the CPU as the default
device (``tests/example_runner.py``), with its smoke arguments, and must
exit 0 having printed its closing line.  ``chip_smoke.py`` runs the same
list on the card.
"""
from __future__ import annotations

import json

import pytest

from example_runner import check_example


@pytest.mark.parametrize("name", ["amp_model_conversion", "mnist"])
def test_example_runs_on_the_port(name, tmp_path):
    check_example(name, tmp_path)


def test_profiler_example_writes_a_chrome_trace(tmp_path):
    res = check_example("profiler_example", tmp_path)
    trace = json.loads((tmp_path / "profile.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"train_step_%d" % i for i in range(5)} <= names, res.stdout
