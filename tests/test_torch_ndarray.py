"""The port's ``ndarray`` and its operators against the JAX package's, on
the CPU (``mx.Context("cpu")``), with the decisions of
``mxnet_tpu_torch/ndarray.py`` each held:

- dtypes as the JAX package's with x64 off: int64/float64 inputs narrow
  to 32 bits, python scalars are weak, the operators' result dtypes equal
  JAX's (the same values and dtypes through every operator);
- an int64 value outside int32 raises OverflowError;
- value semantics: no view of an array sees a later mutation of it
  (``__setitem__``, in-place operators, ``copyto``), ``asnumpy()`` and
  ``array(numpy)`` copy;
- bfloat16: ``asnumpy()`` raises TypeError on every machine;
- ``__array_function__``/``__array_ufunc__`` route numpy calls to mx.np,
  ``__dlpack__`` hands the tensor over.

Tolerance: float32 within rtol 1e-5 (the elementwise math of XLA and
torch differ by an ulp); integer and bool results exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from np_parity import assert_same, inputs, jax_mx, port_mx, to_numpy

torch.set_num_threads(2)

X = inputs(1)


@pytest.fixture(autouse=True)
def _cpu_scope():
    with port_mx().Context("cpu"):
        yield


def both(fn):
    jmx, tmx = jax_mx(), port_mx()
    return (to_numpy(fn(tmx, lambda v: tmx.np.array(v))),
            to_numpy(fn(jmx, lambda v: jmx.np.array(v))))


OPS = {
    "add": lambda a, b: a + b, "radd": lambda a, b: 2 + a,
    "sub": lambda a, b: a - b, "rsub": lambda a, b: 1.5 - a,
    "mul": lambda a, b: a * b, "rmul": lambda a, b: 3 * a,
    "truediv": lambda a, b: a / b, "rtruediv": lambda a, b: 1 / b,
    "floordiv": lambda a, b: a // b, "rfloordiv": lambda a, b: 7 // b,
    "mod": lambda a, b: a % b, "rmod": lambda a, b: 7 % b,
    "pow": lambda a, b: a ** 2, "rpow": lambda a, b: 2 ** a,
    "neg": lambda a, b: -a, "pos": lambda a, b: +a, "abs": lambda a, b: abs(a),
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "matmul": lambda a, b: a @ b.T,
}


@pytest.mark.parametrize("kind", ["F", "I"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_operators_match_jax(op, kind):
    other = {"F": "G", "I": "J"}[kind]
    got, want = both(lambda m, A: OPS[op](A(X[kind]), A(X[other])))
    assert_same(got, want, name=op)


@pytest.mark.parametrize("op", ["and", "or", "xor", "invert", "lshift",
                                "rshift"])
def test_bitwise_operators_match_jax(op):
    f = {"and": lambda a, b: a & b, "or": lambda a, b: a | b,
         "xor": lambda a, b: a ^ b, "invert": lambda a, b: ~a,
         "lshift": lambda a, b: a << 2, "rshift": lambda a, b: a >> 1}[op]
    got, want = both(lambda m, A: f(A(X["I"]), A(X["J"])))
    assert_same(got, want, name=op)


@pytest.mark.parametrize("case", [
    "int64_numpy", "float64_numpy", "python_int", "python_float",
    "python_bool", "list_int", "list_float", "int_div_2", "int_plus_half",
    "f16_times_2", "int8_plus_uint8", "bf16_plus_f16", "arange",
    "int_sum", "bool_sum", "argmax", "int_mean", "astype_int64",
    "explicit_float64"])
def test_dtypes_follow_jax(case):
    c = {
        "int64_numpy": lambda m, A: A(np.arange(4, dtype=np.int64)),
        "float64_numpy": lambda m, A: A(np.ones(3, np.float64)),
        "python_int": lambda m, A: A(3),
        "python_float": lambda m, A: A(2.5),
        "python_bool": lambda m, A: A(True),
        "list_int": lambda m, A: A([1, 2, 3]),
        "list_float": lambda m, A: A([1.0, 2.0]),
        "int_div_2": lambda m, A: A(X["I"]) / 2,
        "int_plus_half": lambda m, A: A(X["I"]) + 0.5,
        "f16_times_2": lambda m, A: A(X["F"].astype(np.float16)) * 2.0,
        "int8_plus_uint8": lambda m, A: m.np.add(
            A(X["I"].astype(np.int8)), A(X["J"].astype(np.uint8))),
        "bf16_plus_f16": lambda m, A: (A(X["F"]).astype("bfloat16")
                                       + A(X["G"]).astype("float16")),
        "arange": lambda m, A: m.np.arange(6),
        "int_sum": lambda m, A: A(X["I"]).sum(),
        "bool_sum": lambda m, A: A(X["B"]).sum(axis=0),
        "argmax": lambda m, A: A(X["F"]).argmax(axis=1),
        "int_mean": lambda m, A: A(X["I"]).mean(),
        "astype_int64": lambda m, A: A(X["F"] * 9).astype("int64"),
        "explicit_float64": lambda m, A: m.np.array([1, 2], dtype="float64"),
    }[case]
    got, want = both(c)
    assert_same(got, want, name=case)


def test_int64_out_of_range_raises():
    big = np.array([0, 2 ** 40], np.int64)
    tmx = port_mx()
    with pytest.raises(OverflowError, match="MXNET_INT64_TENSOR_SIZE"):
        tmx.np.array(big)
    with pytest.raises(OverflowError):
        jax_mx().np.array(big)
    assert tmx.np.array(big, dtype="int32").dtype == np.int32
    with pytest.raises(OverflowError):
        tmx.np.array(np.array([2 ** 33], np.uint64))


def test_int64_kept_with_env_flag():
    """MXNET_INT64_TENSOR_SIZE=1 keeps 64-bit values (read at import, so
    in a fresh process)."""
    import os
    import subprocess
    import sys
    code = ("import numpy as np, mxnet_tpu_torch as mx\n"
            "with mx.Context('cpu'):\n"
            "    a = mx.np.array(np.array([2 ** 40], np.int64))\n"
            "    print(a.dtype, int(a[0]), mx.np.arange(3).dtype, "
            "mx.np.array([1.5]).dtype)\n")
    env = dict(os.environ, MXNET_INT64_TENSOR_SIZE="1")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["int64", str(2 ** 40), "int64", "float64"]


def test_views_never_see_a_mutation():
    tmx = port_mx()
    a = tmx.np.array(X["F"])
    r, s, t = a.reshape(12), a[1], a.T
    before = [v.asnumpy() for v in (r, s, t)]
    a[1, 2] = 99.0
    a += 1
    a *= 2
    tmx.np.array(X["G"]).copyto(a)
    tmx.np.fill_diagonal(a, 7.0)
    for v, b in zip((r, s, t), before):
        np.testing.assert_array_equal(v.asnumpy(), b)
    np.testing.assert_array_equal(a.asnumpy()[0, 0], 7.0)


def test_asnumpy_and_array_copy():
    tmx = port_mx()
    src = X["F"].copy()
    a = tmx.np.array(src)
    src[0, 0] = 123.0
    assert float(a[0, 0]) != 123.0
    host = a.asnumpy()
    host[0, 1] = 456.0
    assert float(a[0, 1]) != 456.0
    b = tmx.np.array(a)
    a[0, 2] = 5.0
    assert float(b[0, 2]) != 5.0


def test_setitem_matches_jax():
    def f(m, A):
        a = A(X["F"])
        a[0] = 1.0
        a[:, 1] = A(X["G"][:, 1])
        a[A(X["B"])] = -1.0
        a[::-1, 3] = A(np.array([4.0, 5.0, 6.0], np.float32))
        return a
    got, want = both(f)
    assert_same(got, want, name="setitem")


def test_getitem_matches_jax():
    got, want = both(lambda m, A: (
        A(X["F"])[1], A(X["F"])[:, 1:3], A(X["F"])[::-1],
        A(X["F"])[..., ::-2],
        A(X["F"])[A(np.array([2, 0], np.int32))], A(X["F"])[None, 1, ::2],
        A(X["F"])[[0, 2], 1]))
    assert_same(got, want, name="getitem")
    # a boolean mask (the JAX package takes it only outside its op bulking)
    tmx = port_mx()
    np.testing.assert_array_equal(
        tmx.np.array(X["F"])[tmx.np.array(X["B"])].asnumpy(),
        X["F"][X["B"]])


def test_bfloat16_asnumpy_raises_everywhere():
    tmx = port_mx()
    a = tmx.np.array(X["F"]).astype("bfloat16")
    assert a.dtype == tmx.np.bfloat16
    with pytest.raises(TypeError, match="bfloat16"):
        a.asnumpy()
    np.testing.assert_allclose(a.astype("float32").asnumpy(), X["F"],
                               rtol=2 ** -8)
    assert "array(" in repr(a)


def test_methods_match_jax():
    got, want = both(lambda m, A: (
        A(X["F"]).reshape(2, 6), A(X["F"]).transpose(), A(X["F"]).T,
        A(X["F"]).swapaxes(0, 1), A(X["F"]).flatten(),
        A(X["F"][None]).squeeze(0), A(X["F"]).expand_dims(1),
        A(X["F"]).repeat(2, axis=0), A(X["F"]).tile((1, 2)),
        A(X["F"]).take(A(np.array([1, 30], np.int32))),
        A(X["F"]).clip(0.3, 0.6), A(X["S"]).round(1),
        A(X["S"]).sum(axis=0), A(X["S"]).mean(axis=1, keepdims=True),
        A(X["F"]).prod(), A(X["S"]).max(axis=1), A(X["S"]).min(),
        A(X["S"]).std(), A(X["S"]).var(axis=0), A(X["S"]).argmin(),
        A(X["S"]).argsort(axis=1), A(X["S"]).sort(axis=0),
        A(X["S"]).cumsum(axis=1), A(X["F"]).dot(A(X["G"].T)),
        A(X["B"]).all(axis=1), A(X["B"]).any(), A(X["S"]).abs(),
        A(X["F"]).sqrt(), A(X["F"]).square(), A(X["F"]).log(),
        A(X["F"]).exp(), A(X["S"]).sigmoid(), A(X["S"]).tanh(),
        A(X["S"]).relu(), A(X["F"]).slice_axis(1, 1, 3),
        A(X["F"]).astype("int32"), A(X["F"]).copy(),
        A(X["S"]).pick(A(np.array([0, 3, 1], np.int32))),
        A(X["F"]).broadcast_to((2, 3, 4)), A(X["S"]).nonzero()))
    assert_same(got, want, name="methods")


def test_scalar_protocols():
    tmx = port_mx()
    a = tmx.np.array([3.5])
    assert float(a) == 3.5 and int(a) == 3 and bool(a) and a.item() == 3.5
    assert len(tmx.np.array(X["F"])) == 3
    assert [r.shape for r in tmx.np.array(X["F"])] == [(4,)] * 3
    with pytest.raises(ValueError, match="ambiguous"):
        bool(tmx.np.array(X["F"]))
    assert tmx.np.array([1, 2]).tolist() == [1, 2]
    assert list(range(10))[tmx.np.array(4)] == 4
    with pytest.raises(TypeError):
        hash(a)


def test_array_function_and_ufunc_protocols():
    """numpy functions and ufuncs on port arrays dispatch to mx.np (the
    result is a port ndarray), as on the JAX package's."""
    tmx = port_mx()
    a, b = tmx.np.array(X["F"]), tmx.np.array(X["G"])
    for r, w in ((np.mean(a, axis=1), X["F"].mean(1)),
                 (np.concatenate([a, b]), np.concatenate([X["F"],
                                                          X["G"]])),
                 (np.where(X["B"], a, b), np.where(X["B"], X["F"], X["G"])),
                 (np.add(a, b), X["F"] + X["G"]),
                 (np.sqrt(a), np.sqrt(X["F"])),
                 (np.add.reduce(a, axis=0), X["F"].sum(0))):
        assert isinstance(r, tmx.nd.NDArray), type(r)
        np.testing.assert_allclose(r.asnumpy(), w, rtol=1e-5)
    out = np.empty((3, 4), np.float32)
    np.multiply(a, b, out=out)
    np.testing.assert_allclose(out, X["F"] * X["G"], rtol=1e-6)
    c = tmx.np.array(np.zeros(4, np.float32))
    np.add.at(c, [0, 0, 2], 1.0)
    np.testing.assert_array_equal(c.asnumpy(), [2, 0, 1, 0])
    assert float(np.linalg.norm(tmx.np.array(X["V"]))) == pytest.approx(
        float(np.linalg.norm(X["V"])), rel=1e-5)


def test_dlpack_hands_over_the_tensor():
    tmx = port_mx()
    a = tmx.np.array(X["F"])
    t = torch.from_dlpack(a)
    np.testing.assert_array_equal(t.numpy(), X["F"])
    assert a.__dlpack_device__() == t.__dlpack_device__()
    n = np.from_dlpack(a)
    np.testing.assert_array_equal(n, X["F"])


def test_array_defaults_to_cuda_without_scope(monkeypatch):
    """Outside a CPU scope and without a device, an array is made on cuda:
    with no GPU that raises (``context.resolve``)."""
    tmx = port_mx()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tmx.Context("gpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmx.np.array([1, 2])
    assert tmx.np.array([1, 2], ctx=tmx.cpu()).ctx == torch.device("cpu")


def test_context_scope():
    tmx = port_mx()
    with tmx.Context("cpu") as c:
        assert tmx.current_context() == torch.device("cpu")
        assert c == tmx.cpu() and repr(c) == "cpu(0)"
        assert tmx.np.zeros(2).ctx == torch.device("cpu")
    assert tmx.Context("gpu", 1).device == torch.device("cuda", 1)


def test_waitall_raises_a_deferred_error():
    nda = port_mx()._ndarray_mod
    nda.defer_error(RuntimeError("late failure"))
    with pytest.raises(RuntimeError, match="late failure"):
        port_mx().waitall()
    port_mx().waitall()
