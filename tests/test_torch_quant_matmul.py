"""Port parity: the quantized-serving kernels' plain versions and the int8
KV pages against the JAX package on the CPU.

- ``quantize_w8`` / ``quantize_w4`` (groups 128, 32 and two that
  ``group_for`` clamps), ``pack_int4`` / ``unpack_int4`` and
  ``dequantize_weight`` equal the JAX functions exactly (same fp32
  divisions, round half to even in both);
- ``quant_matmul_plain`` matches JAX's ``quant_matmul_reference`` (the
  JAX dispatch takes it on the CPU);
- a JAX-quantized pytree carried across by ``params_from_jax`` equals the
  port's own quantization;
- ``_kv_append`` on ``QPages`` gives the JAX codes and scales exactly, for
  a decode step and for prefill chunks that start mid-page and cross page
  starts; ``gather_pages_deq``, ``copy_page`` and paged attention over
  int8 pages match the JAX functions.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import decoder as jdec
from mxnet_tpu.ops.pallas import paged_attention as jpa
from mxnet_tpu.ops.pallas import quant_matmul as jqmm
from mxnet_tpu.serving import quantize as jquant
from mxnet_tpu_torch.models import decoder as tdec
from mxnet_tpu_torch.ops.kernels import paged_attention as tpa
from mxnet_tpu_torch.ops.kernels import quant_matmul as tqmm
from mxnet_tpu_torch.serving import quantize as tquant

torch.set_num_threads(2)


def _weights(seed, o=48, i=96):
    """Gaussian weights with row scales over two decades, one all-zero row
    (scale 1 in both packages) and one exact .5 code boundary."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((o, i))
         * 10.0 ** rng.uniform(-2, 0, (o, 1))).astype(np.float32)
    w[3] = 0.0
    w[5, :2] = [127.0, 63.5]            # 63.5 / (127 / 127) rounds to even
    return w


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_w8_matches_jax(seed):
    w = _weights(seed)
    ref = jqmm.quantize_w8(jnp.asarray(w))
    got = tqmm.quantize_w8(torch.tensor(w))
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))


@pytest.mark.parametrize("group", [128, 32, 40, 7])
def test_quantize_w4_matches_jax(group):
    """96 inputs: 128 clamps to 96, 40 to 8, 7 to 1 and then to 2."""
    w = _weights(2)
    ref = jqmm.quantize_w4(jnp.asarray(w), group=group)
    got = tqmm.quantize_w4(torch.tensor(w), group=group)
    assert got.q.dtype == torch.uint8
    assert got.s.shape == ref.s.shape
    assert 96 // got.s.shape[1] == tqmm.w4_group(96, group)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))


def test_pack_unpack_int4_matches_jax():
    v = np.random.default_rng(3).integers(-8, 8, (6, 20)).astype(np.int8)
    packed = tqmm.pack_int4(torch.tensor(v))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jqmm.pack_int4(jnp.asarray(v))))
    np.testing.assert_array_equal(tqmm.unpack_int4(packed).numpy(), v)
    np.testing.assert_array_equal(
        tqmm.unpack_int4(packed).numpy(),
        np.asarray(jqmm.unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("fmt", ["w8", "w4"])
def test_dequantize_weight_matches_jax(fmt):
    w = _weights(4)
    jq = (jqmm.quantize_w8 if fmt == "w8"
          else lambda a: jqmm.quantize_w4(a, group=32))(jnp.asarray(w))
    tq = (tqmm.quantize_w8 if fmt == "w8"
          else lambda a: tqmm.quantize_w4(a, group=32))(torch.tensor(w))
    np.testing.assert_array_equal(tqmm.dequantize_weight(tq).numpy(),
                                  np.asarray(jqmm.dequantize_weight(jq)))


@pytest.mark.parametrize("m", [1, 5, 16])
@pytest.mark.parametrize("fmt", ["w8", "w4", "w8-i100", "w4-i200",
                                 "w4-i98"])
def test_quant_matmul_plain_matches_jax_reference(m, fmt):
    """96 inputs (int4 group 32), and input dims no K stage of the kernel
    divides, which it takes since it masks its last stage: int8 I 100,
    int4 I 200 and 98 with the groups w4_group gives for 128 (8 and 98).
    The ragged cases hand JAX the port's codes and scales (equal to JAX's,
    test_quantize_w4_matches_jax), which spares a compile of JAX's
    quantizer at each new shape."""
    fmt, _, i = fmt.partition("-i")
    i = int(i or 96)
    group = 32 if i == 96 else 128
    w = _weights(5, i=i)
    x = np.random.default_rng(m).standard_normal((m, i)).astype(np.float32)
    quant = {"w8": (jqmm.quantize_w8, tqmm.quantize_w8),
             "w4": (lambda a: jqmm.quantize_w4(a, group=group),
                    lambda a: tqmm.quantize_w4(a, group=group))}[fmt]
    tq = quant[1](torch.tensor(w))
    if i == 96:
        jq = quant[0](jnp.asarray(w))
    else:
        jq = (jqmm.QuantW8 if fmt == "w8" else jqmm.QuantW4)(
            q=jnp.asarray(tq.q.numpy()), s=jnp.asarray(tq.s.numpy()))
    if fmt == "w4":
        assert i // tq.s.shape[1] == tqmm.w4_group(i, group)
    ref = np.asarray(jqmm.quant_matmul_reference(jnp.asarray(x), jq))
    got = tqmm.quant_matmul_plain(torch.tensor(x), tq).numpy()
    # the same fp32 product; the two matmul backends sum in other orders
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    # a CPU tensor takes the plain version and launches nothing
    before = (tqmm.quant_matmul.launches_w8, tqmm.quant_matmul.launches_w4)
    lead = tqmm.quant_matmul(torch.tensor(x).reshape(1, m, i), tq)
    assert lead.shape == (1, m, 48)
    np.testing.assert_array_equal(lead[0].numpy(), got)
    assert (tqmm.quant_matmul.launches_w8,
            tqmm.quant_matmul.launches_w4) == before


GEOM = dict(vocab_size=64, num_layers=1, units=32, hidden_size=64,
            num_heads=4, num_kv_heads=2, max_length=64)


@pytest.fixture(scope="module")
def jlm():
    return jdec.decoder_tiny_lm(seed=0, **GEOM)


@pytest.mark.parametrize("mode,group", [("int8", 128), ("int4", 16)])
def test_jax_quantized_pytree_carries_across(jlm, mode, group):
    """``params_from_jax`` of a JAX ``quantize_params`` pytree gives the
    port's own ``quantize_params`` leaves bit for bit, and
    ``QuantizedLM.load_jax_params`` serves them."""
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    qnp = jax.tree.map(np.asarray, jquant.quantize_params(
        jlm.jax_params(), mode, group=group))
    tlm = tdec.CausalLM(**GEOM, device="cpu").load_jax_params(params_np)
    own = tquant.quantize_params(tlm.params(), mode, group=group)
    state = tdec.params_from_jax(qnp)
    for li, lp in enumerate(own["layers"]):
        for k in tdec._QUANT_KINDS:
            got = state["layers.%d.%s" % (li, k)]
            assert type(got) is type(lp[k])
            np.testing.assert_array_equal(got.q.numpy(), lp[k].q.numpy())
            np.testing.assert_array_equal(got.s.numpy(), lp[k].s.numpy())
    qlm = tquant.quantize_lm(tlm, mode, group=group).load_jax_params(qnp)
    for lp, ref in zip(qlm.params()["layers"], own["layers"]):
        for k in tdec.LAYER_KEYS:
            if k in tdec._QUANT_KINDS:
                assert torch.equal(lp[k].q, ref[k].q)
            else:
                assert torch.equal(lp[k], ref[k])
    with pytest.raises(ValueError):
        tdec.CausalLM(**GEOM, device="cpu").load_jax_params(qnp)
    other = "int4" if mode == "int8" else "int8"
    with pytest.raises(ValueError):
        tquant.quantize_lm(tlm, other).load_jax_params(qnp)


# ---------------------------------------------------------------------------
# int8 KV pages
# ---------------------------------------------------------------------------
L, KVH, P, S, D = 2, 3, 8, 4, 5


def _qpages(seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (L, KVH, P, S, D)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (L, KVH, P)).astype(np.float32)
    return q, s


def _append_both(q, s, li, wp, ws, val):
    ref = jdec._kv_append(jpa.QPages(q=jnp.asarray(q), s=jnp.asarray(s)), li,
                          jnp.asarray(wp), jnp.asarray(ws), jnp.asarray(val))
    got = tpa.QPages(q=torch.tensor(q), s=torch.tensor(s))
    tdec._kv_append(got, li, torch.tensor(wp), torch.tensor(ws),
                    torch.tensor(val))
    return (np.asarray(ref.q), np.asarray(ref.s)), (got.q.numpy(),
                                                    got.s.numpy())


def test_kv_append_qpages_decode_matches_jax():
    """One token per slot (B, 1): slots at a page start latch a fresh
    scale, the others reuse their page's scale from the pool; an inactive
    slot writes the scratch page 0."""
    q, s = _qpages(0)
    rng = np.random.default_rng(1)
    wp = np.array([[1], [2], [5], [0]], np.int32)
    ws = np.array([[0], [3], [1], [0]], np.int32)
    val = rng.standard_normal((4, 1, KVH, D)).astype(np.float32)
    val[0, 0, 1] = 0.0                     # all-zero head: scale 1
    (rq, rs), (tq, ts) = _append_both(q, s, 1, wp, ws, val)
    np.testing.assert_array_equal(tq, rq)
    np.testing.assert_array_equal(ts, rs)
    assert ts[1, 1, 1] == 1.0
    assert not np.array_equal(ts[1, :, 1], s[1, :, 1])   # latched fresh
    np.testing.assert_array_equal(ts[1, :, 2], s[1, :, 2])  # reused


@pytest.mark.parametrize("pos0,n_valid", [(2, 9), (3, 6), (4, 12)])
def test_kv_append_qpages_prefill_chunk_matches_jax(pos0, n_valid):
    """A 12-token chunk at cache position ``pos0`` of a sequence whose
    pages are 3, 6, 1, 7, 2: mid-page starts reuse the pool's scale until
    the chunk crosses a page start, whose token latches the scale the rest
    of that page reuses within the window; padded tokens go to the scratch
    page (left out: their duplicate writes race in both packages)."""
    q, s = _qpages(2)
    row = np.array([3, 6, 1, 7, 2], np.int32)
    T = 12
    idx = pos0 + np.arange(T)
    valid = np.arange(T) < n_valid
    wp = np.where(valid, row[np.minimum(idx // S, len(row) - 1)], 0)
    ws = np.where(valid, idx % S, 0)
    val = (np.random.default_rng(pos0).standard_normal((T, KVH, D))
           * 3).astype(np.float32)
    (rq, rs), (tq, ts) = _append_both(q, s, 0, wp.astype(np.int32),
                                      ws.astype(np.int32), val)
    np.testing.assert_array_equal(tq[:, :, 1:], rq[:, :, 1:])
    np.testing.assert_array_equal(ts[:, :, 1:], rs[:, :, 1:])


def test_gather_pages_deq_matches_jax():
    q, s = _qpages(3)
    tables = np.array([[1, 2, 3], [4, 0, 0], [1, 5, 0]], np.int32)
    ref = jpa.gather_pages_deq(jnp.asarray(q[0]), jnp.asarray(s[0]),
                               jnp.asarray(tables))
    got = tpa.gather_pages_deq(torch.tensor(q[0]), torch.tensor(s[0]),
                               torch.tensor(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("layout", ["kernel", "engine"])
def test_copy_page_qpages_matches_jax(layout):
    q, s = _qpages(4)
    if layout == "kernel":
        q, s = q[0], s[0]
    ref = jpa.copy_page(jpa.QPages(q=jnp.asarray(q), s=jnp.asarray(s)), 2, 6)
    got = tpa.QPages(q=torch.tensor(q), s=torch.tensor(s))
    assert tpa.copy_page(got, 2, 6) is got
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))


@pytest.mark.parametrize("H,kvh", [(6, 3), (6, 6), (6, 1)])
def test_paged_attention_int8_pages_matches_jax(H, kvh):
    """GQA groupings, an aliased page, the scratch page in unused entries
    and a length-0 row (zeros)."""
    rng = np.random.default_rng(H + kvh)
    Dh = 8
    kq = rng.integers(-127, 128, (kvh, P, S, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (kvh, P, S, Dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (kvh, P)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (kvh, P)).astype(np.float32)
    qv = rng.standard_normal((4, H, Dh)).astype(np.float32)
    tables = np.array([[1, 2, 3], [4, 0, 0], [1, 5, 0], [0, 0, 0]], np.int32)
    lengths = np.array([10, 3, 6, 0], np.int32)
    ref = np.asarray(jpa.paged_attention(
        jnp.asarray(qv), jpa.QPages(q=jnp.asarray(kq), s=jnp.asarray(ks)),
        jpa.QPages(q=jnp.asarray(vq), s=jnp.asarray(vs)),
        jnp.asarray(lengths), jnp.asarray(tables)))
    before = tpa.paged_attention.launches_int8
    got = tpa.paged_attention(
        torch.tensor(qv), tpa.QPages(q=torch.tensor(kq), s=torch.tensor(ks)),
        tpa.QPages(q=torch.tensor(vq), s=torch.tensor(vs)),
        torch.tensor(lengths), torch.tensor(tables)).numpy()
    assert tpa.paged_attention.launches_int8 == before
    # same algorithm in fp32; the two einsum backends sum in other orders
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-6)
    assert np.all(got[3] == 0.0)
