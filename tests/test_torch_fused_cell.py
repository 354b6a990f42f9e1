"""Port parity: ``mxnet_tpu_torch.ops.kernels.fused_cell.decode_layer_group``
(its plain version, which CPU tensors take) against the JAX
``decode_layer_group(..., mode="interpret")`` — the Pallas kernel run by
the interpreter — on the geometry of ``test_fused_cell.py``'s decode
parity test: vocab 64, 2 layers, units 32, 4 heads over 2 KV heads, page
size 8, 4 slots with one inactive.  The biases and LN affines are random,
so a kernel that dropped or swapped one of them would disagree.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import decoder as jdec
from mxnet_tpu.ops.pallas import fused_cell as jfc
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import fused_cell as tfc
from torch_parity import tiny_lm_with_affine

torch.set_num_threads(2)

GEOM = dict(vocab_size=64, num_layers=2, units=32, hidden_size=64,
            num_heads=4, num_kv_heads=2, max_length=64)
S, B, PPS, TOTAL = 8, 4, 8, 16


@pytest.fixture(scope="module")
def models():
    jlm = tiny_lm_with_affine(**GEOM)
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.CausalLM(**GEOM, device="cpu").load_jax_params(params_np)
    return jlm, tlm


def _inputs():
    cfg_l, kvh, d = GEOM["num_layers"], GEOM["num_kv_heads"], 32 // 4
    rng = np.random.default_rng(1)
    kp = (rng.standard_normal((cfg_l, kvh, TOTAL, S, d)) * 0.2).astype(
        np.float32)
    vp = (rng.standard_normal(kp.shape) * 0.2).astype(np.float32)
    x = rng.standard_normal((B, GEOM["units"])).astype(np.float32)
    tables = np.zeros((B, PPS), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, 0] = 3
    tables[2, :2] = [4, 5]
    pos = np.array([9, 3, 11, 0], np.int32)
    act = np.array([True, True, True, False])
    wp = np.where(act, tables[np.arange(B), pos // S], 0).astype(np.int32)
    ws = np.where(act, pos % S, 0).astype(np.int32)
    lengths = np.where(act, pos + 1, 0).astype(np.int32)[:, None]
    return x, kp, vp, np.stack([wp, ws]), tables, lengths


@pytest.mark.parametrize("layer_group", [0, 1])
def test_decode_layer_group_matches_jax_interpret(models, layer_group):
    jlm, tlm = models
    cfg = jlm.config
    x, kp, vp, meta, tables, lengths = _inputs()
    groups = jdec._group_bounds(cfg.num_layers, layer_group)
    params = jlm.jax_params()

    jx, jkp, jvp = jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp)
    for lo, hi in groups:
        kg, vg, jx = jfc.decode_layer_group(
            jx, jkp[lo:hi], jvp[lo:hi], jdec._stack_layer_params(params, lo, hi),
            jnp.asarray(meta), jnp.asarray(tables), jnp.asarray(lengths),
            cfg, "interpret")
        jkp = jkp.at[lo:hi].set(kg)
        jvp = jvp.at[lo:hi].set(vg)

    tx, tkp, tvp = torch.tensor(x), torch.tensor(kp), torch.tensor(vp)
    layers = tlm.params()["layers"]
    for lo, hi in groups:
        kg, vg, tx = tfc.decode_layer_group(
            tx, tkp[lo:hi], tvp[lo:hi], layers[lo:hi], torch.tensor(meta),
            torch.tensor(tables), torch.tensor(lengths), tlm.config)
        assert kg.data_ptr() == tkp[lo:hi].data_ptr()   # updated in place

    # fp32 on both sides, sums in other orders (the JAX kernel and its own
    # per-op step already differ by ~5e-7 on these pages); page 0 is the
    # scratch page and is left out
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tkp.numpy()[:, :, 1:],
                               np.asarray(jkp)[:, :, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tvp.numpy()[:, :, 1:],
                               np.asarray(jvp)[:, :, 1:], rtol=1e-5, atol=1e-5)
    # every active row's new KV landed at its (page, slot)
    assert not np.array_equal(tkp.numpy(), kp)


def test_cpu_tensors_launch_nothing(models):
    _, tlm = models
    x, kp, vp, meta, tables, lengths = _inputs()
    before = tfc.decode_layer_group.launches
    tfc.decode_layer_group(torch.tensor(x), torch.tensor(kp),
                           torch.tensor(vp), tlm.params()["layers"],
                           torch.tensor(meta), torch.tensor(tables),
                           torch.tensor(lengths), tlm.config)
    assert tfc.decode_layer_group.launches == before
