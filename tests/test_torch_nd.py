"""``mx.nd`` of the port against the JAX package's, on the CPU:

- ``nd.save``/``nd.load``: a file the JAX package writes loads in the port
  and the reverse, as npz and as the MXNet binary container; the legacy
  files of the two packages are equal byte for byte (lists and dicts,
  every dtype the container names);
- the legacy CamelCase ops and ``nd.split`` (SliceChannel) against the
  JAX package's, in value and dtype;
- ``nd.contrib`` carries npx and the control-flow ops;
- ``nd.Custom`` and ``nd.sparse`` raise NotImplementedError naming ROADMAP
  item 9.

Tolerance: float32 within rtol 1e-5 (convolution and products in another
order); files exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from np_parity import assert_same, inputs, jax_mx, port_mx, to_numpy

torch.set_num_threads(2)

X = inputs(5)
DTYPES = ("float32", "float64", "float16", "uint8", "int32", "int8",
          "int64", "bool")


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


def _arrays(m):
    rng = np.random.default_rng(9)
    out = {}
    for dt in DTYPES:
        v = (rng.standard_normal((2, 3)) * 5).astype(dt)
        out[dt] = m.np.array(v)
    out["scalar"] = m.np.array(np.float32(2.5))
    return out


@pytest.mark.parametrize("fmt", ["npz", "legacy"])
@pytest.mark.parametrize("kind", ["list", "dict"])
def test_files_cross_load(tmp_path, fmt, kind):
    jmx, tmx = jax_mx(), port_mx()
    for writer, reader in ((jmx, tmx), (tmx, jmx)):
        arrs = _arrays(writer)
        data = list(arrs.values()) if kind == "list" else arrs
        f = str(tmp_path / ("%s.%s" % (writer.__name__, fmt)))
        writer.nd.save(f, data, format=fmt)
        got = reader.nd.load(f)
        back = to_numpy(list(got.values()) if isinstance(got, dict)
                        else got)
        src = to_numpy(list(arrs.values()))
        if fmt == "legacy":         # the V2 record stores a scalar as (1,)
            src[-1] = src[-1].reshape(1)
        assert_same(back, src, name=fmt)
        if kind == "dict":
            assert list(got) == list(arrs)


@pytest.mark.parametrize("kind", ["list", "dict"])
def test_legacy_files_byte_equal(tmp_path, kind):
    jmx, tmx = jax_mx(), port_mx()
    paths = []
    for m in (jmx, tmx):
        arrs = _arrays(m)
        data = list(arrs.values()) if kind == "list" else arrs
        p = tmp_path / ("%s.params" % m.__name__)
        m.nd.save(str(p), data, format="legacy")
        paths.append(p.read_bytes())
    assert paths[0] == paths[1]
    from mxnet_tpu import legacy_serialization as jls
    from mxnet_tpu_torch import legacy_serialization as tls
    assert jls.save_legacy([X["F"], X["I"]], ["a", "b"]) == \
        tls.save_legacy([X["F"], X["I"]], ["a", "b"])


def test_load_on_a_device(tmp_path):
    tmx = port_mx()
    f = str(tmp_path / "x.npz")
    tmx.nd.save(f, [tmx.np.array(X["F"])])
    (a,) = tmx.nd.load(f, ctx=tmx.cpu())
    assert a.ctx == torch.device("cpu")


CAMEL = {
    "FullyConnected": lambda m, A: m.nd.FullyConnected(
        A(X["F"]), A(X["M"]), A(X["V"][:4]), num_hidden=4),
    "Convolution": lambda m, A: m.nd.Convolution(
        A(X["S"].reshape(1, 1, 3, 4)), A(np.ones((2, 1, 2, 2), np.float32)),
        None, kernel=(2, 2), num_filter=2, no_bias=True),
    "Activation": lambda m, A: m.nd.Activation(A(X["S"]), act_type="tanh"),
    "Pooling": lambda m, A: m.nd.Pooling(A(X["S"].reshape(1, 1, 3, 4)),
                                         kernel=(2, 2), pool_type="max"),
    "BatchNorm": lambda m, A: m.nd.BatchNorm(
        A(X["S"].reshape(3, 4, 1)), A(np.ones(4, np.float32)),
        A(np.zeros(4, np.float32)), A(np.zeros(4, np.float32)),
        A(np.ones(4, np.float32))),
    "Embedding": lambda m, A: m.nd.Embedding(A(X["I"] % 4), A(X["M"])),
    "Flatten": lambda m, A: m.nd.Flatten(A(X["S"].reshape(3, 2, 2))),
    "Reshape": lambda m, A: (m.nd.Reshape(A(X["S"]), shape=(-1, 0)),
                             m.nd.Reshape(A(X["S"].reshape(3, 2, 2)),
                                          shape=(0, -3)),
                             m.nd.Reshape(A(X["S"]), shape=(-4, 1, 3, -2))),
    "Concat": lambda m, A: m.nd.Concat(A(X["F"]), A(X["G"]), dim=1),
    "Dropout": lambda m, A: m.nd.Dropout(A(X["S"]), p=0.5),
    "LeakyReLU": lambda m, A: m.nd.LeakyReLU(A(X["S"]), slope=0.1),
    "SoftmaxActivation": lambda m, A: m.nd.SoftmaxActivation(A(X["S"])),
    "SequenceMask": lambda m, A: m.nd.SequenceMask(
        A(X["S"]), A(np.array([1, 2, 3, 2], np.float32)),
        use_sequence_length=True),
    "SequenceLast": lambda m, A: m.nd.SequenceLast(A(X["S"])),
    "SequenceReverse": lambda m, A: m.nd.SequenceReverse(A(X["S"])),
    "SliceChannel": lambda m, A: m.nd.SliceChannel(A(X["S"]), num_outputs=2,
                                                   squeeze_axis=False),
    "split": lambda m, A: m.nd.split(A(X["S"]), num_outputs=2),
}


@pytest.mark.parametrize("name", sorted(CAMEL))
def test_camelcase_ops_match_jax(name):
    jmx, tmx = jax_mx(), port_mx()
    want = to_numpy(CAMEL[name](jmx, lambda v: jmx.np.array(v)))
    got = to_numpy(CAMEL[name](tmx, lambda v: tmx.np.array(v)))
    assert_same(got, want, rtol=1e-5, atol=1e-5, name=name)


def test_nd_split_refuses_numpy_style():
    tmx = port_mx()
    with pytest.raises(TypeError, match="mx.np.split"):
        tmx.nd.split(tmx.np.array(X["S"]), [1, 2])


def test_nd_contrib_names():
    jc, tc = jax_mx().nd.contrib, port_mx().nd.contrib
    from mxnet_tpu.numpy_extension import __all__ as npx_all
    for n in ["foreach", "while_loop", "cond"] + list(npx_all):
        assert hasattr(jc, n) and hasattr(tc, n), n


def test_unported_names_raise():
    tmx = port_mx()
    for name in ("Custom", "sparse"):
        with pytest.raises(NotImplementedError, match="item 9"):
            getattr(tmx.nd, name)()
    with pytest.raises(NotImplementedError, match="item 9"):
        tmx.nd.sparse.csr_matrix
