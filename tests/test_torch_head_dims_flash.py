"""Port parity of the flash kernels #5-#7 at the head dims they take beyond
32, 64 and 128: D 16, 48, 80 and 96.  On the card those run the kernels of
the next of 32, 64 and 128 on columns TMA fills with zeros past D
(``csrc/flash_attention.cu:pad_dim``); on the CPU each wrapper takes its
plain version, which ``chip_smoke.py`` holds the card's kernels to.  Here
the plain versions are held against the JAX kernel in Pallas interpret
mode at each new D, in fp32 and bf16, with the tolerances of
``test_torch_flash_attention.py`` (which holds D 16 at other masks):

- the forward's output and lse, causal with a kv_length that leaves one
  batch row no key;
- the gradients of q, k and v through ``flash_attention``;
- the wrappers' head-dim rule on the kernel's path (``meta`` tensors
  stand in for the card): any D in [1, 128] passes (the wrappers pad one
  that is not a multiple of 8, ``test_torch_flash_pad.py``), any other D
  raises naming the rule.  ``test_torch_head_dims_any.py`` holds the other
  multiples of 8.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops.kernels import _build
from mxnet_tpu_torch.ops.kernels import flash_attention as tfa
from flash_parity import DTYPES, close_grads, inputs, jax_grads
from test_torch_flash_attention import jax_fwd, port, port_grads

torch.set_num_threads(2)

NEW_DIMS = (16, 48, 80, 96)
KV_LENGTH = [37, 0]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", NEW_DIMS)
def test_forward_and_lse_match_jax(d, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = inputs((2, 2, 64, d), seed=d)
    ref, ref_lse = jax_fwd(q, k, v, jdt, 32, causal=True,
                           kv_length=np.array(KV_LENGTH))
    out, lse = tfa.flash_attention_plain(
        *port((q, k, v), tdt), causal=True,
        kv_length=torch.tensor(KV_LENGTH))
    assert out.shape == (2, 2, 64, d) and out.dtype == tdt
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(ref_lse))
    fin = np.isfinite(ref_lse)
    np.testing.assert_allclose(lse.numpy()[fin], ref_lse[fin], rtol=1e-5,
                               atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 step of each element, and 2**-9 of the largest beyond
        # it for a rounding of P that fell the other way
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0 ** -7,
                                   atol=2.0 ** -9 * np.abs(ref).max())
    assert not out[1].float().any()          # the row with no key


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", NEW_DIMS)
def test_gradients_match_jax(d, dtype):
    """fp32 gradients within 1e-4 of the largest element
    (``flash_parity.close_grads``); bf16 within one bf16 step (2**-8) of
    it, both sides rounding P keep and dS to bf16 before their products."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, g = inputs((2, 2, 64, d), seed=d + 1, n=4)
    want = jax_grads(q, k, v, g, 64, jdt, causal=True, kv_length=KV_LENGTH)
    _, got = port_grads(q, k, v, g, tdt, causal=True,
                        kv_length=torch.tensor(KV_LENGTH))
    if dtype == "float32":
        close_grads(got, want)
    else:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2.0 ** -8 * np.abs(b).max())
    assert not np.any(got[0][1])      # the row without keys: no gradient


def _meta(d, dtype=torch.bfloat16):
    return [torch.zeros(2, 2, 64, d, dtype=dtype, device="meta")
            for _ in range(3)]


@pytest.mark.parametrize("d", _build.HEAD_DIMS["flash"])
def test_head_dims_taken(d):
    """The forward's and the backward's checks (``_check``, which #5, #6
    and #7 run before building anything) pass every D in [1, 128]; the
    wrappers refuse the ``meta`` device itself."""
    q, k, v = _meta(d)
    for what in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        tfa._check(what, q, k, v, None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_bwd_delta(q, k)


@pytest.mark.parametrize("d", [0, 129, 136, 144, 200, 256])
def test_head_dims_refused(d):
    """A head dim above 128 (or 0) raises, naming the rule, in both
    dtypes; any D in [1, 128] passes (the wrappers pad a D that is not a
    multiple of 8 before the kernels run)."""
    rule = r"head dim %d; the flash kernels .*any D in \[1, 128\]" % d
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _meta(d, dtype)
        for what in ("flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            with pytest.raises(ValueError, match=rule):
                tfa._check(what, q, k, v, None, None)
    with pytest.raises(ValueError, match=rule):
        _build.check_head_dim("flash_attention_bwd_delta", d, "flash")
