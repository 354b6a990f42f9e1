"""``mx.npx`` of the port against the JAX package's, on the CPU.

- Every public callable of the JAX package's ``mx.npx`` (read from its
  ``dir()``) is called in both packages on the same seeded inputs and
  agrees in value and dtype (outside training, where nothing is drawn);
- the four ops that route to the hand-written kernels (``bias_gelu``,
  ``bias_dropout_residual``, ``flash_attention``, ``rnn``) through their
  plain versions on the CPU, forward and gradients through
  ``autograd.record()``/``backward()`` against the JAX package's, and
  with dropout: the hash-masked ops give the same mask for the same
  ``mx.random.seed`` (so the CPU and the card agree), ``npx.dropout``
  returns its input itself outside training;
- the training-mode ops (``batch_norm`` updating its running statistics).

Tolerance: float32 within rtol/atol 1e-5 (the kernels' plain versions
and XLA sum in different orders); gradients 1e-4 of the largest element
(sums over the batch).
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from np_parity import assert_same, inputs, jax_mx, port_mx, to_numpy

torch.set_num_threads(2)

X = inputs(2)
R = np.random.default_rng(3)
Q = R.standard_normal((2, 3, 8, 12)).astype(np.float32)
K = R.standard_normal((2, 3, 8, 12)).astype(np.float32)
V = R.standard_normal((2, 3, 8, 12)).astype(np.float32)
IMG = R.standard_normal((2, 3, 6, 6)).astype(np.float32)
WCONV = (0.3 * R.standard_normal((4, 3, 3, 3))).astype(np.float32)
SEQ = R.standard_normal((5, 2, 3)).astype(np.float32)
LENS = np.array([3, 5], np.int32)
EMB = R.standard_normal((10, 3)).astype(np.float32)
CTC = R.standard_normal((6, 2, 5)).astype(np.float32)
QKV = R.standard_normal((5, 3, 24)).astype(np.float32)
ATT_SELF = R.standard_normal((6, 5, 5)).astype(np.float32)
ATT_ENCDEC = R.standard_normal((6, 5, 4)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


def _bn(m, A):
    rm, rv = A(np.zeros(3, np.float32)), A(np.ones(3, np.float32))
    return m.npx.batch_norm(A(IMG), A(np.ones(3, np.float32) * 1.5),
                            A(np.full(3, 0.2, np.float32)), rm, rv,
                            fix_gamma=False)


CASES = {
    "activation": lambda m, A: [m.npx.activation(A(X["S"]), t) for t in (
        "relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
        "log_sigmoid", "mish", "silu")],
    "relu": lambda m, A: m.npx.relu(A(X["S"])),
    "sigmoid": lambda m, A: m.npx.sigmoid(A(X["S"])),
    "gelu": lambda m, A: (m.npx.gelu(A(X["S"])),
                          m.npx.gelu(A(X["S"]), approximate=True)),
    "leaky_relu": lambda m, A: [m.npx.leaky_relu(A(X["S"]), act_type=t)
                                for t in ("leaky", "elu", "selu", "gelu",
                                          "rrelu")]
    + [m.npx.leaky_relu(A(IMG), A(np.array([0.1, 0.2, 0.3], np.float32)),
                        act_type="prelu")],
    "softmax": lambda m, A: (m.npx.softmax(A(X["S"])),
                             m.npx.softmax(A(X["S"]), axis=0,
                                           temperature=2.0),
                             m.npx.softmax(A(X["S"]), A(np.array(
                                 [2, 4, 1], np.int32)), use_length=True)),
    "log_softmax": lambda m, A: m.npx.log_softmax(A(X["S"])),
    "masked_softmax": lambda m, A: m.npx.masked_softmax(A(X["S"]),
                                                        A(X["B"])),
    "masked_log_softmax": lambda m, A: m.npx.masked_log_softmax(
        A(X["S"]), A(X["B"] | np.eye(3, 4, dtype=bool))),
    "softmin": lambda m, A: m.npx.softmin(A(X["S"])),
    "fully_connected": lambda m, A: (
        m.npx.fully_connected(A(X["S"]), A(X["M"]), A(X["V"][:4])),
        m.npx.fully_connected(A(X["S"]), A(X["M"]), None, no_bias=True)),
    "convolution": lambda m, A: m.npx.convolution(
        A(IMG), A(WCONV), A(X["V"][:4]), kernel=(3, 3), pad=(1, 1),
        stride=(2, 1), num_filter=4),
    "deconvolution": lambda m, A: m.npx.deconvolution(
        A(IMG), A(WCONV.transpose(1, 0, 2, 3).copy()), A(X["V"][:4]),
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1), num_filter=4),
    "pooling": lambda m, A: [m.npx.pooling(A(IMG), (2, 2), t, (2, 2))
                             for t in ("max", "avg", "sum", "lp")]
    + [m.npx.pooling(A(IMG), (3, 3), "avg", (2, 2), (1, 1),
                     count_include_pad=False),
       m.npx.pooling(A(IMG), (3, 3), "max", (2, 2),
                     pooling_convention="full"),
       m.npx.pooling(A(IMG), pool_type="avg", global_pool=True)],
    "batch_norm": _bn,
    "layer_norm": lambda m, A: m.npx.layer_norm(
        A(X["S"]), A(X["F"][0]), A(X["G"][0])),
    "group_norm": lambda m, A: m.npx.group_norm(
        A(IMG[:, :2]), A(np.array([1.0, 2.0], np.float32)),
        A(np.array([0.5, -0.5], np.float32)), num_groups=2),
    "instance_norm": lambda m, A: m.npx.instance_norm(
        A(IMG), A(np.ones(3, np.float32)), A(np.zeros(3, np.float32))),
    "l2_normalization": lambda m, A: [m.npx.l2_normalization(A(IMG), mode=t)
                                      for t in ("instance", "channel",
                                                "spatial")],
    "lrn": lambda m, A: m.npx.lrn(A(IMG), nsize=3),
    "dropout": lambda m, A: m.npx.dropout(A(X["S"]), p=0.5),
    "embedding": lambda m, A: m.npx.embedding(A(X["I"]), A(EMB)),
    "one_hot": lambda m, A: m.npx.one_hot(A(X["I"]), 10),
    "topk": lambda m, A: [m.npx.topk(A(X["S"]), k=2, ret_typ=t)
                          for t in ("indices", "value", "both", "mask")]
    + [m.npx.topk(A(X["S"]), axis=0, k=2, is_ascend=True)],
    "pick": lambda m, A: m.npx.pick(A(X["S"]), A(np.array([0, 3, 2],
                                                          np.int32))),
    "gather_nd": lambda m, A: m.npx.gather_nd(A(X["S"]), A(np.array(
        [[0, 2], [1, 3]], np.int32))),
    "scatter_nd": lambda m, A: m.npx.scatter_nd(
        A(np.array([1.0, 2.0], np.float32)),
        A(np.array([[0, 2], [1, 3]], np.int32)), (3, 4)),
    "sequence_mask": lambda m, A: m.npx.sequence_mask(
        A(SEQ), A(np.array([3, 5], np.float32)), use_sequence_length=True,
        value=-1.0),
    "sequence_last": lambda m, A: (m.npx.sequence_last(
        A(SEQ), A(LENS), use_sequence_length=True),
        m.npx.sequence_last(A(SEQ))),
    "sequence_reverse": lambda m, A: (m.npx.sequence_reverse(
        A(SEQ), A(LENS), use_sequence_length=True),
        m.npx.sequence_reverse(A(SEQ))),
    "ctc_loss": lambda m, A: m.npx.ctc_loss(
        A(CTC),
        A(np.array([[1, 2, -1], [3, 3, 4]], np.float32))),
    "batch_dot": lambda m, A: (m.npx.batch_dot(A(Q[0]), A(K[0]),
                                               transpose_b=True),
                               m.npx.batch_dot(A(Q[0]), A(K[0]),
                                               transpose_a=True)),
    "arange_like": lambda m, A: (m.npx.arange_like(A(X["S"])),
                                 m.npx.arange_like(A(X["S"]), 2.0, 0.5,
                                                   axis=1)),
    "reshape_like": lambda m, A: m.npx.reshape_like(A(X["S"]),
                                                    A(X["S"].T)),
    "broadcast_like": lambda m, A: m.npx.broadcast_like(A(X["S"][:1]),
                                                        A(X["S"])),
    "smooth_l1": lambda m, A: m.npx.smooth_l1(A(X["S"]), 2.0),
    "multibox_prior": lambda m, A: m.npx.multibox_prior(
        A(IMG), sizes=(0.5, 0.25), ratios=(1.0, 2.0)),
    "interleaved_matmul_selfatt_qk": lambda m, A: (
        m.npx.interleaved_matmul_selfatt_qk(A(QKV), 2)),
    "interleaved_matmul_selfatt_valatt": lambda m, A: (
        m.npx.interleaved_matmul_selfatt_valatt(
            A(QKV), A(ATT_SELF), 2)),
    "interleaved_matmul_encdec_qk": lambda m, A: (
        m.npx.interleaved_matmul_encdec_qk(
            A(QKV[..., :8]), A(QKV[:4, :, :16]), 2)),
    "interleaved_matmul_encdec_valatt": lambda m, A: (
        m.npx.interleaved_matmul_encdec_valatt(
            A(QKV[:4, :, :16]), A(ATT_ENCDEC), 2)),
    "flash_attention": lambda m, A: (
        m.npx.flash_attention(A(Q), A(K), A(V)),
        m.npx.flash_attention(A(Q), A(K), A(V), causal=True),
        m.npx.flash_attention(A(Q), A(K), A(V),
                              kv_length=A(np.array([8, 3], np.int32)))),
    "sldwin_atten": lambda m, A: m.npx.sldwin_atten(A(Q), A(K), A(V), 2),
    "all_finite": lambda m, A: (m.npx.all_finite(A(X["S"]), A(X["F"])),
                                m.npx.all_finite(A(X["N"]))),
    "bias_gelu": lambda m, A: m.npx.bias_gelu(A(X["S"]), A(X["F"][0])),
    "bias_dropout_residual": lambda m, A: m.npx.bias_dropout_residual(
        A(X["S"]), A(X["F"][0]), A(X["G"]), p=0.3),
    "rnn": lambda m, A: _rnn(m, A),
    "gamma": lambda m, A: m.npx.gamma(A(X["H"])),
    "erf": lambda m, A: m.npx.erf(A(X["S"])),
    "erfinv": lambda m, A: m.npx.erfinv(A(X["F"] - 0.5)),
    "index_add": lambda m, A: m.npx.index_add(
        A(X["S"]), A(np.array([[0, 2, 0], [1, 3, 1]], np.int32)),
        A(np.array([1.0, 2.0, 3.0], np.float32))),
    "index_update": lambda m, A: m.npx.index_update(
        A(X["S"]), A(np.array([[0, 2], [1, 3]], np.int32)),
        A(np.array([1.0, 2.0], np.float32))),
    "foreach": lambda m, A: m.npx.foreach(
        lambda x, s: (x * 2 + s[0], [s[0] + x]), A(X["S"]),
        [A(np.zeros(4, np.float32))]),
    "while_loop": lambda m, A: m.npx.while_loop(
        lambda i, s: i < 3, lambda i, s: (s * 2, [i + 1, s + 1]),
        [A(np.array(0, np.int32)), A(X["F"][0])], max_iterations=5),
    "cond": lambda m, A: (m.npx.cond(A(np.array(1, np.int32)),
                                     lambda: A(X["F"]) + 1,
                                     lambda: A(X["F"]) - 1),
                          m.npx.cond(False, lambda: A(X["F"]) + 1,
                                     lambda: A(X["F"]) - 1)),
    "shape_array": lambda m, A: m.npx.shape_array(A(X["S"])),
    "cast": lambda m, A: m.npx.cast(A(X["S"]), "float16"),
    "slice": lambda m, A: m.npx.slice(A(X["S"]), (0, 1), (2, 4), (1, 2)),
    "slice_axis": lambda m, A: m.npx.slice_axis(A(X["S"]), 1, 1, 3),
    "slice_like": lambda m, A: m.npx.slice_like(A(X["S"]),
                                                A(X["S"][:2, :3])),
    "amp_cast": lambda m, A: (m.npx.amp_cast(A(X["S"]), "float16"),
                              m.npx.amp_cast(A(X["I"]), "float16")),
    "amp_multicast": lambda m, A: m.npx.amp_multicast(
        A(X["S"]).astype("float16"), A(X["F"]), A(X["I"])),
    "intgemm_maxabsolute": lambda m, A: m.npx.intgemm_maxabsolute(A(X["S"])),
    "intgemm_prepare_data": lambda m, A: m.npx.intgemm_prepare_data(
        A(X["S"]), A(np.float32(2.0))),
    "intgemm_prepare_weight": lambda m, A: m.npx.intgemm_prepare_weight(
        A(X["M"])),
    "intgemm_take_weight": lambda m, A: m.npx.intgemm_take_weight(
        A(X["M"]), A(np.array([2, 0], np.int32))),
    "intgemm_fully_connected": lambda m, A: m.npx.intgemm_fully_connected(
        m.npx.intgemm_prepare_data(A(X["S"]), A(np.float32(3.0))),
        m.npx.intgemm_prepare_weight(A(X["M"])), A(np.float32(0.01)),
        A(X["V"][:4])),
    "is_np_array": lambda m, A: m.npx.is_np_array(),
    "is_np_shape": lambda m, A: m.npx.is_np_shape(),
    "set_np": lambda m, A: m.npx.set_np(),
    "reset_np": lambda m, A: m.npx.reset_np(),
    "waitall": lambda m, A: m.npx.waitall(),
    "array": lambda m, A: m.npx.array([1, 2]),
}
#: names held elsewhere in this file or structurally
ELSEWHERE = ("save", "load", "savez", "seed", "next_key", "current_device",
             "num_gpus", "apply_op", "ndarray")


def _rnn(m, A):
    T, B, I, H = 4, 2, 3, 5
    n = 4 * H * (I + H) + 8 * H
    rng = np.random.default_rng(11)
    params = (0.3 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal((T, B, I)).astype(np.float32)
    h0 = rng.standard_normal((1, B, H)).astype(np.float32)
    c0 = rng.standard_normal((1, B, H)).astype(np.float32)
    return m.npx.rnn(A(x), A(params), A(h0), A(c0), mode="lstm",
                     state_size=H, num_layers=1)


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType)
                  and callable(getattr(mod, n)))


def test_every_npx_name_has_a_case():
    names = _public(jax_mx().npx)
    assert len(names) == 82
    missing = [n for n in names if n not in CASES and n not in ELSEWHERE]
    assert not missing, missing
    absent = [n for n in names if not hasattr(port_mx().npx, n)]
    assert not absent, absent


LOOSE = {"ctc_loss": 1e-4, "gamma": 1e-4, "erfinv": 1e-4, "lrn": 1e-4,
         "deconvolution": 1e-4, "convolution": 1e-4, "rnn": 1e-4,
         "flash_attention": 1e-4, "sldwin_atten": 1e-4,
         "interleaved_matmul_selfatt_valatt": 1e-4,
         "interleaved_matmul_encdec_valatt": 1e-4}


@pytest.mark.parametrize("name", sorted(CASES))
def test_npx_name_value_and_dtype(name):
    jmx, tmx = jax_mx(), port_mx()
    want = to_numpy(CASES[name](jmx, lambda v: jmx.np.array(v)))
    got = to_numpy(CASES[name](tmx, lambda v: tmx.np.array(v)))
    tol = LOOSE.get(name, 1e-5)
    assert_same(got, want, rtol=tol, atol=tol, name=name)


KERNEL_OPS = {
    "bias_gelu": lambda m, a, b, c: m.npx.bias_gelu(a, b),
    "bias_dropout_residual": lambda m, a, b, c: m.npx.bias_dropout_residual(
        a, b, c, p=0.0),
    "flash_attention": lambda m, a, b, c: m.npx.flash_attention(
        a, b, c, causal=True),
}


def _grads(m, name, arrays, train):
    A = [m.np.array(v) for v in arrays]
    for a in A:
        a.attach_grad()
    with m.autograd.record(train_mode=train):
        out = KERNEL_OPS[name](m, *A)
        loss = (out * out).sum()
    loss.backward()
    return [to_numpy(out)] + [to_numpy(a.grad) for a in A]


@pytest.mark.parametrize("name", sorted(KERNEL_OPS))
def test_kernel_ops_gradients_match_jax(name):
    """The kernel ops' plain versions with their gradients (through the
    kernels' autograd Functions) against the JAX package's, in training
    mode at dropout 0."""
    arrays = {"bias_gelu": (X["S"], X["F"][0], None),
              "bias_dropout_residual": (X["S"], X["F"][0], X["G"]),
              "flash_attention": (Q, K, V)}[name]
    arrays = [a for a in arrays if a is not None]
    if name == "bias_gelu":
        arrays = arrays[:2]
        KERNEL_OPS[name] = lambda m, a, b: m.npx.bias_gelu(a, b)
    got = _grads(port_mx(), name, arrays, True)
    want = _grads(jax_mx(), name, arrays, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-4 * np.abs(w).max())


def test_rnn_gradients_match_jax():
    def run(m):
        rng = np.random.default_rng(5)
        T, B, I, H = 4, 2, 3, 5
        n = 2 * (4 * H * H + 8 * H) + 4 * H * I + 4 * H * H
        arrs = [m.np.array(v) for v in (
            rng.standard_normal((T, B, I)).astype(np.float32),
            (0.3 * rng.standard_normal(n)).astype(np.float32),
            rng.standard_normal((2, B, H)).astype(np.float32),
            rng.standard_normal((2, B, H)).astype(np.float32))]
        for a in arrs:
            a.attach_grad()
        with m.autograd.record():
            out, hT, cT = m.npx.rnn(*arrs, mode="lstm", state_size=H,
                                    num_layers=2)
            loss = (out * out).sum() + hT.sum() + (cT * cT).sum()
        loss.backward()
        return [to_numpy(out)] + [to_numpy(a.grad) for a in arrs]
    for g, w in zip(run(port_mx()), run(jax_mx())):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_hash_dropout_masks_follow_the_seed():
    """bias_dropout_residual and flash_attention in training draw their
    hash seed from mx.random.seed's sequence: the same seed gives the
    same output (so the CPU's plain versions and the card's kernels agree
    for one seed), another seed another mask; the mask equals the plain
    version's for the seed the sequence yields."""
    tmx = port_mx()
    from mxnet_tpu_torch import _rng
    from mxnet_tpu_torch.ops.kernels import epilogue as ep

    def run(seed):
        tmx.random.seed(seed)
        with tmx.autograd.record():
            a = tmx.npx.bias_dropout_residual(
                tmx.np.array(X["S"]), tmx.np.array(X["F"][0]),
                tmx.np.array(X["G"]), p=0.5)
            b = tmx.npx.flash_attention(tmx.np.array(Q), tmx.np.array(K),
                                        tmx.np.array(V), dropout=0.5)
        return a.asnumpy(), b.asnumpy()

    a1, b1 = run(7)
    a2, b2 = run(7)
    a3, b3 = run(8)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(b1, b2)
    assert not np.array_equal(a1, a3) and not np.array_equal(b1, b3)
    _rng.seed(7)
    s = _rng.next_hash_seed()
    want = ep.bias_dropout_residual(torch.tensor(X["S"]),
                                    torch.tensor(X["F"][0]),
                                    torch.tensor(X["G"]), rate=0.5, seed=s)
    np.testing.assert_array_equal(a1, want.numpy())


def test_pick_clips_out_of_range():
    """``mode="clip"`` clips an index past the axis (the reference's
    semantics; the JAX package's ``take_along_axis`` fills NaN there) and
    ``mode="wrap"`` wraps it."""
    tmx = port_mx()
    idx = tmx.np.array(np.array([0, 9, -6], np.int32))
    got = tmx.npx.pick(tmx.np.array(X["S"]), idx).asnumpy()
    np.testing.assert_array_equal(got, X["S"][[0, 1, 2], [0, 3, 0]])
    got = tmx.npx.pick(tmx.np.array(X["S"]), idx, mode="wrap").asnumpy()
    np.testing.assert_array_equal(got, X["S"][[0, 1, 2], [0, 1, 2]])


def test_dropout_outside_training_is_the_input():
    tmx = port_mx()
    x = tmx.np.array(X["S"])
    assert tmx.npx.dropout(x, p=0.5) is x
    with tmx.autograd.record(train_mode=False):
        assert tmx.npx.dropout(x, p=0.5) is x
    with tmx.autograd.record():
        assert tmx.npx.dropout(x, p=0.0) is x
        y = tmx.npx.dropout(x, p=0.5)
    kept = y.asnumpy() != 0
    np.testing.assert_allclose(y.asnumpy()[kept], 2 * X["S"][kept],
                               rtol=1e-6)
    assert 0 < kept.mean() < 1
    z = tmx.npx.dropout(x, p=0.5, mode="always")
    assert z is not x


def test_batch_norm_training_updates_running_stats():
    def run(m):
        A = m.np.array
        rm, rv = A(np.zeros(3, np.float32)), A(np.ones(3, np.float32))
        g, b = A(np.ones(3, np.float32)), A(np.zeros(3, np.float32))
        x = A(IMG)
        x.attach_grad()
        with m.autograd.record():
            out = m.npx.batch_norm(x, g, b, rm, rv, fix_gamma=False,
                                   momentum=0.8)
            loss = (out * A(IMG)).sum()
        loss.backward()
        return [to_numpy(v) for v in (out, rm, rv, x.grad)]
    for g, w in zip(run(port_mx()), run(jax_mx())):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_save_load_and_seed():
    import tempfile
    tmx = port_mx()
    with tempfile.TemporaryDirectory() as d:
        f = d + "/a.npz"
        tmx.npx.save(f, {"x": tmx.np.array(X["S"]), "i": tmx.np.array(
            X["I"])})
        got = tmx.npx.load(f)
        jgot = jax_mx().npx.load(f)
        for k in ("x", "i"):
            assert_same(to_numpy(got[k]), to_numpy(jgot[k]), name=k)
    tmx.npx.seed(3)
    a = tmx.np.random.uniform(size=4).asnumpy()
    tmx.npx.seed(3)
    np.testing.assert_array_equal(tmx.np.random.uniform(size=4).asnumpy(), a)
    assert isinstance(tmx.npx.next_key(), int)
    assert tmx.npx.current_device() == torch.device("cpu")
    assert tmx.npx.num_gpus() == torch.cuda.device_count()
