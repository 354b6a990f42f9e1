"""Port parity: ``mxnet_tpu_torch.ops.kernels.paged_attention`` against
``mxnet_tpu.ops.pallas.paged_attention`` on the CPU.

GQA and MHA groupings, a page id aliased across two rows, the scratch
page 0 in unused table entries, and a length-0 row (zeros).  The CUDA
kernel itself runs only on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import paged_attention as jpa
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa

torch.set_num_threads(2)

KVH_P_S_D = (10, 4, 8)            # total pages, page size, head dim
# row 2 shares page 1 with row 0; row 3 is inactive (length 0, scratch)
TABLES = np.array([[1, 2, 3], [4, 0, 0], [1, 5, 0], [0, 0, 0]], np.int32)
LENGTHS = np.array([10, 3, 6, 0], np.int32)


def _inputs(H, KVH, seed=0):
    rng = np.random.default_rng(seed)
    P, S, D = KVH_P_S_D
    q = rng.standard_normal((4, H, D)).astype(np.float32)
    kp = rng.standard_normal((KVH, P, S, D)).astype(np.float32)
    vp = rng.standard_normal((KVH, P, S, D)).astype(np.float32)
    return q, kp, vp


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def test_gather_pages_exact():
    """Pure data movement: bit-identical to the JAX gather."""
    _, kp, _ = _inputs(4, 2)
    ref = np.asarray(jpa.gather_pages(jnp.asarray(kp), jnp.asarray(TABLES)))
    out = tpa.gather_pages(torch.tensor(kp), torch.tensor(TABLES)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("H,KVH", [(4, 2), (4, 4), (4, 1)])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_paged_attention_matches_reference(H, KVH, scale):
    q, kp, vp = _inputs(H, KVH)
    ref = np.asarray(jpa.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(LENGTHS), jnp.asarray(TABLES), scale=scale))
    tq, tk, tv, tl, tt = _t(q, kp, vp, LENGTHS, TABLES)
    out = tpa.paged_attention(tq, tk, tv, tl, tt, scale=scale).numpy()
    # same algorithm in fp32; the two einsum backends sum in other orders
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6)
    assert np.all(out[3] == 0.0)           # length-0 row gives zeros


def test_attend_ctx_matches_jax():
    q, kp, vp = _inputs(4, 2, seed=1)
    kc = np.asarray(jpa.gather_pages(jnp.asarray(kp), jnp.asarray(TABLES)))
    vc = np.asarray(jpa.gather_pages(jnp.asarray(vp), jnp.asarray(TABLES)))
    ref = np.asarray(jpa.attend_ctx(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(LENGTHS),
                                    0.25))
    out = tpa.attend_ctx(*_t(q, kc, vc, LENGTHS), 0.25).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("layout", ["kernel", "engine"])
def test_copy_page_in_place(layout):
    _, kp, _ = _inputs(4, 2)
    if layout == "engine":
        kp = np.stack([kp, kp[::-1].copy()])       # (L, KVH, P, S, D)
    ref = np.asarray(jpa.copy_page(jnp.asarray(kp), 2, 7))
    t = torch.tensor(kp)
    out = tpa.copy_page(t, 2, 7)
    assert out is t
    np.testing.assert_array_equal(t.numpy(), ref)


def test_cpu_tensors_launch_nothing():
    q, kp, vp = _inputs(4, 2)
    before = tpa.paged_attention.launches
    tpa.paged_attention(*_t(q, kp, vp, LENGTHS, TABLES))
    assert tpa.paged_attention.launches == before
