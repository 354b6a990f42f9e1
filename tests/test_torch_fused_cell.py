"""Port parity: ``mxnet_tpu_torch.ops.kernels.fused_cell.decode_layer_group``
(its plain version, which CPU tensors take, and which ``chip_smoke.py``
holds the card's kernel to) against the JAX
``decode_layer_group(..., mode="interpret")`` — the Pallas kernel run by
the interpreter — on the geometry of ``test_fused_cell.py``'s decode
parity test: vocab 64, 2 layers, units 32, 4 heads over 2 KV heads (and
over 4), page size 8, 8 pages a row, 4 slots.  The biases and LN affines
are random, so a kernel that dropped or swapped one of them would
disagree.  The cases put rows at the lengths the card's split-key
attention units meet: the whole table (8 pages, 64 keys), one key, a row
ending on a page boundary and rows of length 0 (inactive: no unit, no
append).
"""
from __future__ import annotations

import functools

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


#: lengths after this step's append (0: inactive), one case a tuple.
#: "edges": a row over the whole table (64 keys), a row of one key, a row
#: ending on a page boundary and an inactive row; "idle": the first row
#: inactive too
CASES = {"mixed": (10, 4, 12, 0),
         "edges": (S * PPS, 1, 2 * S, 0),
         "idle": (0, 4, 12, 0)}


@functools.lru_cache(maxsize=None)
def _models(kvh):
    geom = dict(GEOM, num_kv_heads=kvh)
    jlm = tiny_lm_with_affine(**geom)
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.CausalLM(**geom, device="cpu").load_jax_params(params_np)
    return jlm, tlm


@pytest.fixture(scope="module")
def models():
    return _models(GEOM["num_kv_heads"])


def _inputs(lengths=CASES["mixed"], kvh=GEOM["num_kv_heads"]):
    """x, the pages, meta, the tables and the lengths of one step whose
    rows reach ``lengths`` after the append; each row's pages distinct,
    from page 1 on (page 0 is the scratch page inactive rows write)."""
    cfg_l, d = GEOM["num_layers"], 32 // 4
    rng = np.random.default_rng(1)
    kp = (rng.standard_normal((cfg_l, kvh, TOTAL, S, d)) * 0.2).astype(
        np.float32)
    vp = (rng.standard_normal(kp.shape) * 0.2).astype(np.float32)
    x = rng.standard_normal((B, GEOM["units"])).astype(np.float32)
    lengths = np.array(lengths, np.int32)
    tables = np.zeros((B, PPS), np.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        need = -(-int(n) // S)
        tables[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    assert nxt <= TOTAL
    pos = np.maximum(lengths - 1, 0)
    act = lengths > 0
    wp = np.where(act, tables[np.arange(B), pos // S], 0).astype(np.int32)
    ws = np.where(act, pos % S, 0).astype(np.int32)
    return x, kp, vp, np.stack([wp, ws]), tables, lengths[:, None]


# (layer_group, case, KV heads): at g 2 (4 heads over 2 KV heads) with
# mixed lengths, one launch for both layers and one a layer; then one
# launch at the edges' lengths at g 2 and g 1, and with the first row
# inactive at g 1
@pytest.mark.parametrize("layer_group,case,kvh", [
    pytest.param(0, "mixed", 2, id="0"),
    pytest.param(1, "mixed", 2, id="1"),
    pytest.param(0, "edges", 2, id="edges-g2"),
    pytest.param(0, "edges", 4, id="edges-g1"),
    pytest.param(0, "idle", 4, id="idle-g1")])
def test_decode_layer_group_matches_jax_interpret(layer_group, case, kvh):
    jlm, tlm = _models(kvh)
    cfg = jlm.config
    x, kp, vp, meta, tables, lengths = _inputs(CASES[case], kvh)
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
    # per-op step already differ by ~5e-7 on these pages; a row over the
    # whole table sums 64 keys); page 0 is the scratch page and is left out
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tkp.numpy()[:, :, 1:],
                               np.asarray(jkp)[:, :, 1:], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tvp.numpy()[:, :, 1:],
                               np.asarray(jvp)[:, :, 1:], rtol=1e-5, atol=1e-5)
    # every active row's new KV landed at its (page, slot), and nothing
    # else changed past page 0
    for li in range(cfg.num_layers):
        for b in np.flatnonzero(lengths[:, 0] > 0):
            page, slot = meta[0, b], meta[1, b]
            assert not np.array_equal(tkp.numpy()[li, :, page, slot],
                                      kp[li, :, page, slot])
    written = np.zeros(kp.shape[2:4], bool)
    written[meta[0][lengths[:, 0] > 0], meta[1][lengths[:, 0] > 0]] = True
    written[0] = True
    np.testing.assert_array_equal(tkp.numpy()[:, :, ~written],
                                  kp[:, :, ~written])


def test_cpu_tensors_launch_nothing(models):
    _, tlm = models
    x, kp, vp, meta, tables, lengths = _inputs()
    before = tfc.decode_layer_group.launches
    tfc.decode_layer_group(torch.tensor(x), torch.tensor(kp),
                           torch.tensor(vp), tlm.params()["layers"],
                           torch.tensor(meta), torch.tensor(tables),
                           torch.tensor(lengths), tlm.config)
    assert tfc.decode_layer_group.launches == before
