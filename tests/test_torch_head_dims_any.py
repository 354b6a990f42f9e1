"""Port parity at the head dims the kernels took beyond PR 22's: every
multiple of 8, up to 256 for the decode kernels (#12, #13, #15) and up to
128 for the flash kernels (#5-#7 and the delta kernel).

On the card the decode kernels run each D that is not a multiple of 16
up to 128 on the kernel of its class (the next of 32, 64, 128 and 256)
with D / E busy lanes a warp (``csrc/decode_common.cuh:split_class``),
the flash kernels on the
kernels of the next of 32, 64 and 128 on zero-filled columns
(``csrc/flash_attention.cu:pad_dim``); ``chip_smoke.py``'s
``check_decode_dims`` and ``check_flash_dims`` hold them against their
plain versions there.  Here:

- the head-dim rule of each family (``_build.HEAD_DIMS``,
  ``check_head_dim``): which D it takes and which it refuses, naming the
  family's rule;
- the plain versions against the JAX package at D 24 and 160 (decode:
  #12 and #13 against the JAX kernels in Pallas interpret mode, #15 over
  fp and int8 pages against the JAX ``paged_attention``) and at D 8, 24
  and 120 (flash: the forward, lse and gradients against the JAX kernel
  in interpret mode), with the bodies and tolerances of
  ``test_torch_head_dims_decode.py`` and ``test_torch_head_dims_flash.py``
  (fp32: 1e-5; bf16: one bf16 step).
"""
from __future__ import annotations

import re

import pytest
import torch

from mxnet_tpu_torch.ops.kernels import _build
from test_torch_head_dims_decode import (
    test_attn_phase_matches_jax_interpret as _attn_phase,
    test_decode_layer_group_matches_jax_interpret as _layer_group,
    test_paged_attention_matches_jax as _paged)
from test_torch_head_dims_flash import (
    test_forward_and_lse_match_jax as _flash_fwd,
    test_gradients_match_jax as _flash_grads)

torch.set_num_threads(2)

DECODE_NEW = (24, 160)
FLASH_NEW = (8, 24, 120)


@pytest.mark.parametrize("family,taken,refused", [
    ("decode", [8, 24, 40, 72, 120, 136, 160, 168, 192, 200, 256],
     [0, 4, 12, 20, 100, 250, 260, 264, 512]),
    ("flash", [1, 4, 8, 12, 20, 24, 40, 56, 72, 88, 100, 104, 120, 127, 128],
     [0, 129, 132, 136, 160, 256])])
def test_head_dim_rule_per_family(family, taken, refused):
    """The decode family takes every multiple of 8 up to 256 and nothing
    else; the flash family any D in [1, 128] (the wrappers pad a D that is
    not a multiple of 8 for the kernels, which run the multiples of 8 up
    to 128).  A refusal names the family and its rule."""
    if family == "decode":
        assert _build.HEAD_DIMS[family] == tuple(range(8, 257, 8))
        rule = "a multiple of 8 in [8, 256]"
    else:
        assert _build.HEAD_DIMS[family] == tuple(range(1, 129))
        assert _build.FLASH_KERNEL_DIMS == tuple(range(8, 129, 8))
        rule = "any D in [1, 128]"
    assert _build.HEAD_DIM_RULE[family] == rule
    for d in taken:
        _build.check_head_dim("k", d, family)
    for d in refused:
        with pytest.raises(ValueError,
                           match=r"k: head dim %d; the %s kernels take a head "
                                 r"dim that is %s"
                           % (d, family, re.escape(rule))):
            _build.check_head_dim("k", d, family)


@pytest.mark.parametrize("d", DECODE_NEW)
def test_decode_layer_group_plain_at_new_dims(d):
    _layer_group(d)


@pytest.mark.parametrize("d", DECODE_NEW)
@pytest.mark.parametrize("H,KVH", [(2, 2), (4, 2)], ids=["g1", "g2"])
def test_attn_phase_plain_at_new_dims(d, H, KVH):
    _attn_phase(d, H, KVH)


@pytest.mark.parametrize("d", DECODE_NEW)
@pytest.mark.parametrize("pages", ["fp", "int8"])
def test_paged_attention_plain_at_new_dims(d, pages):
    _paged(d, pages)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", FLASH_NEW)
def test_flash_forward_plain_at_new_dims(d, dtype):
    _flash_fwd(d, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [24])
def test_flash_gradients_plain_at_new_dims(d, dtype):
    _flash_grads(d, dtype)
