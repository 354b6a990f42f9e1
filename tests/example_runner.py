"""Run an example script of the repo on the port.

``python tests/example_runner.py [--cpu] SCRIPT [ARGS...]`` runs
``SCRIPT`` as ``__main__`` with ``sys.argv = [SCRIPT, ARGS...]``, with a
meta-path finder that makes ``import mxnet_tpu`` (and every
``mxnet_tpu.X``) import ``mxnet_tpu_torch`` (``mxnet_tpu_torch.X``).  The
examples themselves are left as they are, written against the JAX
package.  ``--cpu`` runs the script inside ``mx.Context("cpu")``, where
arrays and layers made with no device go to the CPU; without it they go
to the card, as every entry point of the port does.

Each example runs in a process of its own (:func:`run_example`): the
alias would make the JAX package unreachable for the rest of a test
process.
"""
from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import os
import runpy
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the examples that run on the port: script, smoke arguments, and a
#: line its end prints
EXAMPLES = {
    "house_prices": ("example/gluon/house_prices.py", ["--smoke"],
                     "cv log-rmse"),
    "actor_critic": ("example/gluon/actor_critic.py", ["--smoke"], "done"),
    "dc_gan": ("example/gluon/dc_gan.py", ["--smoke"], "done"),
    "audio_classification": ("example/gluon/audio_classification.py",
                             ["--smoke"], "done"),
    "lstm_crf": ("example/gluon/lstm_crf.py", ["--smoke"], "viterbi:"),
    "lipnet": ("example/gluon/lipnet.py", ["--smoke"], "done"),
    "word_language_model": ("example/gluon/word_language_model.py",
                            ["--smoke"], "done"),
    "mnist": ("example/gluon/mnist/mnist.py",
              ["--epochs", "1", "--max-batches", "5"],
              "Validation accuracy"),
    "embedding_learning": ("example/gluon/embedding_learning.py",
                           ["--smoke"], "retrieval accuracy"),
    "image_classification": ("example/gluon/image_classification.py",
                             ["--max-batches", "2", "--batch-size", "8"],
                             "Epoch 0: accuracy="),
    "serving_resnet50": ("example/serving/serving_resnet50.py",
                         ["--smoke"], "serving done"),
    "amp_model_conversion": (
        "example/automatic-mixed-precision/amp_model_conversion.py",
        ["--batch-size", "2", "--image-shape", "32", "--iters", "2"],
        "bf16 vs fp32 max relative deviation"),
    "profiler_example": ("example/profiler/profiler_example.py", [],
                         "chrome trace written to"),
}


class _PortFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """``mxnet_tpu[.X]`` imports as ``mxnet_tpu_torch[.X]``: the same
    module object under both names."""

    def find_spec(self, name, path=None, target=None):
        if name != "mxnet_tpu" and not name.startswith("mxnet_tpu."):
            return None
        real = "mxnet_tpu_torch" + name[len("mxnet_tpu"):]
        if importlib.util.find_spec(real) is None:
            return None
        return importlib.util.spec_from_loader(name, self)

    def create_module(self, spec):
        real = "mxnet_tpu_torch" + spec.name[len("mxnet_tpu"):]
        module = importlib.import_module(real)
        self._real_spec = (module, module.__spec__)
        return module

    def exec_module(self, module):
        # the import system stamped the alias's spec on the real module
        mod, spec = self._real_spec
        mod.__spec__ = spec


def install():
    """Alias ``mxnet_tpu`` to ``mxnet_tpu_torch`` in this process."""
    if not any(isinstance(f, _PortFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, _PortFinder())


def main(argv):
    cpu = argv[:1] == ["--cpu"]
    if cpu:
        argv = argv[1:]
    script, args = argv[0], argv[1:]
    sys.path.insert(0, ROOT)
    install()
    import torch
    torch.set_num_threads(int(os.environ.get("EXAMPLE_THREADS", "2")))
    import mxnet_tpu_torch as mx
    sys.argv = [script] + list(args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    if cpu:
        with mx.cpu():
            runpy.run_path(script, run_name="__main__")
    else:
        runpy.run_path(script, run_name="__main__")


def run_example(name, cpu=True, timeout=300, cwd=None, extra=()):
    """Run example ``name`` of :data:`EXAMPLES` on the port in a new
    process, from ``cwd`` (where it writes its files); returns the
    ``CompletedProcess`` (text output)."""
    script, args, _ = EXAMPLES[name]
    cmd = [sys.executable, os.path.abspath(__file__)]
    cmd += ["--cpu"] if cpu else []
    cmd += [os.path.join(ROOT, script)] + list(args) + list(extra)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=cwd or ROOT)


def check_example(name, cwd):
    """Run example ``name`` on the port on the CPU; it must exit 0 and
    print its closing line."""
    res = run_example(name, cwd=str(cwd))
    tail = (res.stdout[-2000:], res.stderr[-3000:])
    assert res.returncode == 0, tail
    assert EXAMPLES[name][2] in res.stdout, tail
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
