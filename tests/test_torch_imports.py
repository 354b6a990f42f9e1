"""The port stands alone: importing ``mxnet_tpu_torch`` and every module of
its serving, training, RNN, tensor-parallel and array-core slices loads
neither ``jax`` nor any ``mxnet_tpu`` module; its
entry points run on CUDA unless the CPU is asked for; and every feature
of the JAX engine that the port lacks is refused, not ignored.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from mxnet_tpu_torch import context
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.serving import DecodeEngine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_import_loads_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import mxnet_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            mxnet_tpu_torch.__path__, "mxnet_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "mxnet_tpu" or m.startswith("mxnet_tpu."))
        assert "mxnet_tpu_torch.serving.generate" in names, names
        assert "mxnet_tpu_torch.ops.kernels.fused_cell" in names, names
        assert "mxnet_tpu_torch.ops.kernels.quant_matmul" in names, names
        assert "mxnet_tpu_torch.serving.quantize" in names, names
        for mod in ("models.bert", "gluon.trainer", "gluon.loss",
                    "gluon.nn.basic_layers", "optimizer", "initializer",
                    "ops.nn", "ops.optimizer_ops",
                    "ops.kernels.dropout_hash", "ops.kernels.epilogue",
                    "ops.attention", "ops.kernels.flash_attention", "amp",
                    "amp.lists", "amp.loss_scaler", "ops.rnn", "gluon.rnn",
                    "gluon.rnn.rnn_layer", "gluon.rnn.rnn_cell",
                    "parallel", "parallel.shardcfg",
                    "serving.speculate", "ndarray", "numpy", "numpy.linalg",
                    "numpy.random", "numpy_extension", "nd", "_nd_contrib",
                    "autograd", "random", "_rng", "util", "numpy_dispatch",
                    "legacy_serialization", "ops.control_flow",
                    "_unported", "gluon.parameter", "gluon.block",
                    "gluon.nn.activations", "gluon.nn.conv_layers",
                    "gluon.metric", "gluon.utils", "gluon.data",
                    "gluon.data.dataset", "gluon.data.sampler",
                    "gluon.data.batchify", "gluon.data.dataloader",
                    "gluon.data.vision", "gluon.data.vision.datasets",
                    "gluon.data.vision.transforms",
                    "gluon.rnn.conv_rnn_cell", "lr_scheduler"):
            assert "mxnet_tpu_torch." + mod in names, (mod, names)
        mx = mxnet_tpu_torch
        for ns in ("np", "npx", "nd", "autograd", "random", "waitall",
                   "gluon", "init", "optimizer", "lr_scheduler"):
            assert hasattr(mx, ns), ns
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def tiny_lm():
    return tdec.decoder_tiny_lm(device="cpu")


def test_engine_without_device_raises_without_gpu(no_gpu, tiny_lm):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(tiny_lm, slots=2, page_size=4, max_ctx=16)


def test_array_without_device_raises_without_gpu(no_gpu):
    """``mx.np.array(...)`` (and a creation op, and a random draw) with no
    device and no open CPU scope is made on cuda, and raises without a
    GPU."""
    import mxnet_tpu_torch as mx
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.np.array([1.0, 2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.np.zeros((2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mx.np.random.uniform(size=2)
    assert mx.np.array([1.0], ctx=mx.cpu()).ctx == torch.device("cpu")


def test_model_without_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.decoder_tiny_lm()


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_resolve_cuda_raises_without_gpu(no_gpu, device):
    with pytest.raises(RuntimeError):
        context.resolve(device)


def test_resolve_cpu():
    assert context.resolve("cpu") == torch.device("cpu")
    assert context.cpu() == torch.device("cpu")
    assert context.gpu(1) == torch.device("cuda", 1)


@pytest.mark.parametrize("kwargs,error", [
    ({"migrate": True}, NotImplementedError),
    ({"pagestore": "localhost:1"}, NotImplementedError),
    # speculative decoding is ported: the engine speculates
    ({"speculate": True}, None),
    ({"speculate": True, "draft_model": "tiny"}, None),
    # tensor parallelism is ported: what is not a ShardingConfig is refused
    ({"sharding": object()}, TypeError),
    ({"role": "prefill"}, NotImplementedError),
], ids=["migrate", "pagestore", "speculate", "draft_model", "sharding",
        "role"])
def test_unported_engine_features_raise(tiny_lm, kwargs, error):
    """The features the port lacks raise; the ported ones (error None)
    build an engine that uses them."""
    if kwargs.get("draft_model") == "tiny":
        kwargs = dict(kwargs, draft_model=tdec.decoder_draft(tiny_lm))
    if error is None:
        eng = DecodeEngine(tiny_lm, device="cpu", slots=2, page_size=4,
                           max_ctx=16, **kwargs)
        drafter = "model" if "draft_model" in kwargs else "ngram"
        assert eng.stats()["speculative"]["drafter"] == drafter
        assert eng.stop()
        return
    with pytest.raises(error):
        DecodeEngine(tiny_lm, device="cpu", slots=2, page_size=4,
                     max_ctx=16, **kwargs)


@pytest.mark.parametrize("var,value", [
    ("MXNET_GEN_PAGESTORE", "localhost:1"),
    ("MXNET_GEN_SPECULATE", "1"), ("MXNET_GEN_ROLE", "decode")])
def test_unported_features_asked_by_env_raise(monkeypatch, tiny_lm, var,
                                              value):
    """The knobs of features the port lacks raise; MXNET_GEN_SPECULATE,
    now ported, turns speculation on."""
    monkeypatch.setenv(var, value)
    if var == "MXNET_GEN_SPECULATE":
        eng = DecodeEngine(tiny_lm, device="cpu", slots=2, page_size=4,
                           max_ctx=16)
        assert eng.stats()["speculative"]["drafter"] == "ngram"
        assert eng.stop()
        return
    with pytest.raises(NotImplementedError):
        DecodeEngine(tiny_lm, device="cpu", slots=2, page_size=4,
                     max_ctx=16)


def test_speculative_engine_runs_on_cuda_by_default(no_gpu, tiny_lm):
    """DecodeEngine(speculate=True) serves on cuda unless the CPU is asked
    for: without a card and without ``device=`` it raises."""
    with pytest.raises(RuntimeError):
        DecodeEngine(tiny_lm, speculate=True, slots=2, page_size=4,
                     max_ctx=16)
    with pytest.raises(RuntimeError):
        tdec.decoder_draft(tiny_lm.config)


@pytest.mark.parametrize("kwargs,env", [
    ({"quantize": "fp8"}, None), ({"kv_dtype": "fp8"}, None),
    ({}, ("MXNET_QUANT_MATMUL", "interpret")),
    ({}, ("MXNET_QUANT_MATMUL", "0"))],
    ids=["quantize-fp8", "kv_dtype-fp8", "quant_matmul-interpret",
         "quant_matmul-0"])
def test_unsupported_quantization_asks_raise(monkeypatch, tiny_lm, kwargs,
                                            env):
    """Formats the JAX engine refuses too, and the JAX package's
    dequant-matmul lanes, which the port does not have: ValueError."""
    if env:
        monkeypatch.setenv(*env)
    with pytest.raises(ValueError):
        DecodeEngine(tiny_lm, device="cpu", slots=2, page_size=4,
                     max_ctx=16, **kwargs)


def test_migrate_out_raises(tiny_lm):
    """Shipping parked sessions needs the fleet page store, which the port
    lacks: ``migrate_out()`` refuses and names it."""
    eng = DecodeEngine(tiny_lm, device="cpu", slots=2, page_size=4,
                       max_ctx=16)
    try:
        with pytest.raises(NotImplementedError, match="page store"):
            eng.migrate_out()
    finally:
        assert eng.stop()


def test_decode_fused_switch(monkeypatch, tiny_lm):
    monkeypatch.setenv("MXNET_DECODE_FUSED", "0")
    eng = DecodeEngine(tiny_lm, device="cpu", slots=2, page_size=4,
                       max_ctx=16)
    assert not eng.decode_fused
    assert eng.stats()["launches"]["kernels"] == {
        "paged_attention": 2, "bias_gelu": 2}
    monkeypatch.setenv("MXNET_DECODE_FUSED", "interpret")
    with pytest.raises(ValueError):
        DecodeEngine(tiny_lm, device="cpu", slots=2, page_size=4,
                     max_ctx=16)
