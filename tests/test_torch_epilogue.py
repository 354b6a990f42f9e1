"""Port parity: ``mxnet_tpu_torch.ops.kernels.epilogue.bias_gelu`` against
``mxnet_tpu.ops.pallas.epilogue.bias_gelu`` on the CPU.

The same numpy inputs go through the JAX function (its XLA path, and the
Pallas kernel in interpret mode) and the port's wrapper, which takes its
plain PyTorch version for CPU tensors.  The Triton kernel itself runs
only on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import epilogue as jep
from mxnet_tpu_torch.ops.kernels import epilogue as tep

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("shape", [(8, 128), (2, 4, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_gelu_matches_jax(monkeypatch, mode, shape, dtype):
    monkeypatch.setenv("MXNET_EPILOGUE_KERNEL",
                       "0" if mode == "xla" else "interpret")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    jdt, tdt = _DT[dtype]
    ref = jep.bias_gelu(jnp.asarray(x, jdt), jnp.asarray(b, jdt))
    assert jep.last_path == ("xla" if mode == "xla" else "pallas-interpret")
    out = tep.bias_gelu(torch.tensor(x).to(tdt), torch.tensor(b).to(tdt))
    assert out.dtype == tdt and tuple(out.shape) == shape
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    # Both compute erf in fp32, and the two erf implementations differ by
    # a few ulps.  In the far negative tail gelu is the cancellation
    # 0.5 u (1 + erf(u / sqrt 2)) of size ~1e-6, where they differ by up
    # to ~1e-6 absolute: hence atol 2e-6.
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=2e-6)
    else:
        # one rounding to bf16 at the end: an erf ulp apart can round to
        # neighbouring bf16 values, at most 2**-7 relative
        np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=2e-6)


def test_bias_gelu_cpu_takes_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    x = torch.randn(4, 16)
    b = torch.randn(16)
    before = tep.bias_gelu.launches
    out = tep.bias_gelu(x, b)
    assert tep.bias_gelu.launches == before
    assert torch.equal(out, tep.bias_gelu_plain(x, b))
