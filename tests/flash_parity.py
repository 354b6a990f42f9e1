"""Shared inputs and references of the flash-attention parity tests
(``test_torch_flash_attention*.py``): the JAX kernel's gradients in
Pallas interpret mode on the CPU."""
from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.pallas import flash_attention as jfa

#: each dtype's name to its (JAX, PyTorch) dtypes
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def inputs(shape, seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def jax_grads(q, k, v, g, block, jdt=jnp.float32, **kw):
    def loss(a, b, c):
        out = jfa.flash_attention_tpu(a, b, c, block_q=block, block_k=block,
                                      interpret=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * g)
    jq = [jnp.asarray(a, jdt) for a in (q, k, v)]
    return [np.asarray(t.astype(jnp.float32))
            for t in jax.grad(loss, argnums=(0, 1, 2))(*jq)]


def close_grads(got, want):
    """Each gradient within 1e-4 of its largest element: fp32 products
    and sums over the keys in another order."""
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
