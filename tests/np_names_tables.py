"""The call tables of the port's name-parity tests
(``test_torch_np_names.py``, ``test_torch_np_names_more.py``): for each
public name of the JAX package's ``mx.np`` and ``mx.np.linalg``, a call
``fn(mx, A)`` made the same way in either package (``A(value)`` makes an
array there) on the seeded inputs of ``np_parity.inputs``."""
from __future__ import annotations

import types

import numpy as np

from np_parity import inputs, jax_mx, to_numpy

X = inputs(0)


# (name, fn(mx, A)) where A(value) makes an array in that package
def _unary(name):
    if name in ("arccosh",):
        return lambda m, A: getattr(m.np, name)(A(X["H"]))
    if name in ("invert",):
        return lambda m, A: getattr(m.np, name)(A(X["I"]))
    if name == "logical_not":
        return lambda m, A: getattr(m.np, name)(A(X["B"]))
    if name in ("isnan", "isinf", "isfinite", "isposinf", "isneginf",
                "nan_to_num"):
        return lambda m, A: getattr(m.np, name)(A(X["N"]))
    if name in ("sign", "signbit", "negative", "abs", "absolute", "ceil",
                "floor", "trunc", "rint", "spacing", "cbrt", "sinc",
                "square", "positive", "real", "imag", "angle", "conj",
                "conjugate", "degrees", "radians", "deg2rad", "rad2deg"):
        return lambda m, A: getattr(m.np, name)(A(X["S"]))
    return lambda m, A: getattr(m.np, name)(A(X["F"]))


INT_UNARY = ("sqrt", "ceil", "rint", "reciprocal", "abs", "square",
             "negative", "sign", "exp", "floor", "degrees", "cbrt", "exp2")


def _binary(name):
    if name in ("bitwise_and", "bitwise_or", "bitwise_xor", "lcm", "gcd",
                "bitwise_left_shift", "bitwise_right_shift", "left_shift",
                "right_shift", "floor_divide", "mod", "remainder", "fmod"):
        return lambda m, A: getattr(m.np, name)(A(X["I"]), A(X["J"] % 4 + 1))
    if name in ("logical_and", "logical_or", "logical_xor"):
        return lambda m, A: getattr(m.np, name)(A(X["B"]), A(X["C"]))
    if name in ("dot", "inner", "matmul", "kron", "outer", "vdot"):
        return lambda m, A: getattr(m.np, name)(A(X["M"]), A(X["M2"]))
    if name == "polyval":
        return lambda m, A: m.np.polyval(A(X["W"]), A(X["V"]))
    if name in ("convolve", "correlate"):
        return lambda m, A: getattr(m.np, name)(A(X["V"]), A(X["W"]))
    if name == "ldexp":
        return lambda m, A: m.np.ldexp(A(X["F"]), A(X["I"]))
    if name in ("array_equal", "array_equiv"):
        return lambda m, A: getattr(m.np, name)(A(X["I"]), A(X["I"]))
    if name in ("equal", "not_equal", "greater", "greater_equal", "less",
                "less_equal", "maximum", "minimum", "fmax", "fmin",
                "copysign", "heaviside", "arctan2", "hypot", "subtract",
                "nextafter"):
        return lambda m, A: getattr(m.np, name)(A(X["S"]), A(X["G"]))
    return lambda m, A: getattr(m.np, name)(A(X["F"]), A(X["G"]))


def _reduction(name):
    src = "N" if name.startswith("nan") else "S"
    if name in ("all", "any", "count_nonzero"):
        src = "B"
    return lambda m, A: (getattr(m.np, name)(A(X[src])),
                         getattr(m.np, name)(A(X[src]), axis=1))


def _svd_key(r):
    u, s, vt = r
    return s, np.abs(u @ np.diag(s) @ vt)


OTHER = {
    "reshape": lambda m, A: m.np.reshape(A(X["F"]), (4, 3)),
    "ravel": lambda m, A: m.np.ravel(A(X["F"])),
    "transpose": lambda m, A: m.np.transpose(A(X["F"])),
    "swapaxes": lambda m, A: m.np.swapaxes(A(X["F"]), 0, 1),
    "moveaxis": lambda m, A: m.np.moveaxis(A(X["F"][None]), 0, 2),
    "rollaxis": lambda m, A: m.np.rollaxis(A(X["F"][None]), 2),
    "expand_dims": lambda m, A: m.np.expand_dims(A(X["F"]), (0, 2)),
    "squeeze": lambda m, A: m.np.squeeze(A(X["F"][None, :, None])),
    "flip": lambda m, A: (m.np.flip(A(X["F"])), m.np.flip(A(X["F"]), 1)),
    "fliplr": lambda m, A: m.np.fliplr(A(X["F"])),
    "flipud": lambda m, A: m.np.flipud(A(X["F"])),
    "roll": lambda m, A: (m.np.roll(A(X["F"]), 2), m.np.roll(A(X["F"]), -1,
                                                              axis=1)),
    "rot90": lambda m, A: m.np.rot90(A(X["F"]), 3),
    "tile": lambda m, A: m.np.tile(A(X["F"]), (2, 1)),
    "repeat": lambda m, A: (m.np.repeat(A(X["F"]), 2),
                            m.np.repeat(A(X["F"]), 2, axis=1)),
    "broadcast_to": lambda m, A: m.np.broadcast_to(A(X["W"][:, None]),
                                                   (3, 5)),
    "atleast_1d": lambda m, A: m.np.atleast_1d(A(np.float32(2.0))),
    "atleast_2d": lambda m, A: m.np.atleast_2d(A(X["V"])),
    "atleast_3d": lambda m, A: m.np.atleast_3d(A(X["F"])),
    "delete": lambda m, A: (m.np.delete(A(X["F"]), 1, axis=1),
                            m.np.delete(A(X["F"]), np.array([0, 5]))),
    "append": lambda m, A: m.np.append(A(X["F"]), A(X["G"]), axis=0),
    "trim_zeros": lambda m, A: m.np.trim_zeros(
        A(np.array([0, 0, 1, 2, 0, 3, 0], np.float32))),
    "pad": lambda m, A: (m.np.pad(A(X["F"]), 1),
                         m.np.pad(A(X["F"]), ((1, 2), (0, 1)), mode="edge"),
                         m.np.pad(A(X["F"]), 2, mode="reflect"),
                         m.np.pad(A(X["F"]), 2, mode="wrap"),
                         m.np.pad(A(X["F"]), 2, mode="symmetric")),
    "resize": lambda m, A: m.np.resize(A(X["F"]), (5, 3)),
    "tril": lambda m, A: m.np.tril(A(X["M"]), k=-1),
    "triu": lambda m, A: m.np.triu(A(X["M"]), k=1),
    "trace": lambda m, A: (m.np.trace(A(X["M"])), m.np.trace(A(X["I"]))),
    "diagonal": lambda m, A: m.np.diagonal(A(X["M"]), 1),
    "diag": lambda m, A: (m.np.diag(A(X["V"])), m.np.diag(A(X["M"]), -1)),
    "diagflat": lambda m, A: m.np.diagflat(A(X["W"]), 1),
    "vander": lambda m, A: m.np.vander(A(X["W"]), 4),
    "flatnonzero": lambda m, A: m.np.flatnonzero(A(X["B"])),
    "argwhere": lambda m, A: m.np.argwhere(A(X["B"])),
    "searchsorted": lambda m, A: (
        m.np.searchsorted(A(X["SORTED"]), A(X["W"])),
        m.np.searchsorted(A(X["SORTED"]), A(X["W"]), side="right")),
    "extract": lambda m, A: m.np.extract(A(X["B"]), A(X["F"])),
    "compress": lambda m, A: m.np.compress(A(np.array([True, False, True])),
                                           A(X["F"]), axis=0),
    "take_along_axis": lambda m, A: m.np.take_along_axis(
        A(X["F"]), A(np.array([[0], [3], [-1]], np.int32)), axis=1),
    "put_along_axis": lambda m, A: m.np.put_along_axis(
        A(X["F"]), A(np.array([[0], [3], [1]], np.int32)), 5.0, axis=1,
        inplace=False),
    "select": lambda m, A: m.np.select([X["B"], X["C"]], [X["F"], X["G"]],
                                       0.5),
    "piecewise": lambda m, A: m.np.piecewise(
        A(X["S"]), [A(X["S"] < 0), A(X["S"] >= 0)],
        [lambda v: v * 2, lambda v: v * 3]),
    "interp": lambda m, A: m.np.interp(A(X["W"]), A(X["SORTED"]),
                                       A(X["V"])),
    "diff": lambda m, A: (m.np.diff(A(X["F"])), m.np.diff(A(X["F"]), 2,
                                                           axis=0)),
    "ediff1d": lambda m, A: m.np.ediff1d(A(X["V"])),
    "gradient": lambda m, A: m.np.gradient(A(X["V"])),
    "trapz": lambda m, A: (m.np.trapz(A(X["F"])),
                           m.np.trapz(A(X["V"]), A(X["SORTED"]))),
    "cross": lambda m, A: m.np.cross(A(X["F"][:, :3]), A(X["G"][:, :3])),
    "tensordot": lambda m, A: m.np.tensordot(A(X["F"]), A(X["G"].T), 1),
    "clip": lambda m, A: m.np.clip(A(X["S"]), -0.5, 0.5),
    "round": lambda m, A: m.np.round(A(X["S"]), 2),
    "around": lambda m, A: m.np.around(A(X["S"]), 1),
    "sort": lambda m, A: (m.np.sort(A(X["S"])), m.np.sort(A(X["S"]),
                                                           axis=0)),
    "argsort": lambda m, A: m.np.argsort(A(X["S"])),
    "partition": lambda m, A: m.np.partition(A(X["S"]), 1),
    "argpartition": lambda m, A: m.np.argpartition(A(X["S"]), 1),
    "lexsort": lambda m, A: m.np.lexsort(A(np.array(
        [[1, 5, 1, 4, 3, 4, 4], [9, 4, 0, 4, 0, 2, 1]], np.int32))),
    "msort": lambda m, A: m.np.msort(A(X["S"])),
    "unwrap": lambda m, A: m.np.unwrap(A(np.array(
        [0.0, 1.0, 4.0, 0.5, 7.0, -6.0], np.float32))),
    "digitize": lambda m, A: m.np.digitize(A(X["V"]), A(np.array(
        [-1.0, 0.0, 1.0], np.float32))),
    "bincount": lambda m, A: m.np.bincount(A(X["I"].reshape(-1))),
    "isclose": lambda m, A: m.np.isclose(A(X["F"]), A(X["F"] + 1e-7)),
    "isrealobj": lambda m, A: m.np.isrealobj(A(X["F"])),
    "iscomplexobj": lambda m, A: m.np.iscomplexobj(A(X["F"])),
    "isreal": lambda m, A: m.np.isreal(A(X["F"])),
    "iscomplex": lambda m, A: m.np.iscomplex(A(X["F"])),
    "unravel_index": lambda m, A: m.np.unravel_index(
        A(np.array([1, 5, 11], np.int32)), (3, 4)),
    "triu_indices_from": lambda m, A: m.np.triu_indices_from(A(X["M"]), 1),
    "tril_indices_from": lambda m, A: m.np.tril_indices_from(A(X["M"])),
    "apply_along_axis": lambda m, A: m.np.apply_along_axis(
        lambda v: v.sum(), 1, A(X["F"])),
    "float_power": lambda m, A: m.np.float_power(A(X["F"]), 2.0),
    "divmod": lambda m, A: m.np.divmod(A(X["I"]), A(X["J"])),
    "modf": lambda m, A: m.np.modf(A(X["S"] * 3)),
    "frexp": lambda m, A: m.np.frexp(A(X["S"] * 10)),
    "histogram_bin_edges": lambda m, A: m.np.histogram_bin_edges(
        A(X["S"]), 5),
    "corrcoef": lambda m, A: m.np.corrcoef(A(X["F"])),
    "cov": lambda m, A: m.np.cov(A(X["F"])),
    "average": lambda m, A: (m.np.average(A(X["F"]), axis=1),
                             m.np.average(A(X["F"]), 1, A(X["G"][0]))),
    "quantile": lambda m, A: m.np.quantile(A(X["S"]), 0.3, axis=1),
    "percentile": lambda m, A: m.np.percentile(A(X["S"]), 70.0),
    "nanquantile": lambda m, A: m.np.nanquantile(A(X["N"]), 0.3, axis=1),
    "nanpercentile": lambda m, A: m.np.nanpercentile(A(X["N"]), 40.0),
}

EXPLICIT = {
    "fix": lambda m, A: m.np.fix(A(X["S"] * 3)),
    "astype": lambda m, A: m.np.astype(A(X["S"] * 3), "int32"),
    "einsum": lambda m, A: m.np.einsum("ij,kj->ik", A(X["F"]), A(X["G"])),
    "sigmoid": lambda m, A: m.np.sigmoid(A(X["S"])),
    "erf": lambda m, A: m.np.erf(A(X["S"])),
    "erfinv": lambda m, A: m.np.erfinv(A(X["F"] - 0.5)),
    "gamma_fn": lambda m, A: m.np.gamma_fn(A(X["H"])),
    "gammaln": lambda m, A: m.np.gammaln(A(X["H"])),
    "zeros": lambda m, A: (m.np.zeros((2, 3)), m.np.zeros(4, dtype="int32")),
    "ones": lambda m, A: m.np.ones((2, 3)),
    "empty": lambda m, A: m.np.empty((2, 3)).shape,
    "full": lambda m, A: (m.np.full((2, 3), 7), m.np.full((2,), 2.5)),
    "arange": lambda m, A: (m.np.arange(5), m.np.arange(1, 7, 2),
                            m.np.arange(0.5, 3.0, 0.5)),
    "linspace": lambda m, A: (m.np.linspace(0, 1, 7),
                              m.np.linspace(2.0, 3.0, 5, endpoint=False)),
    "logspace": lambda m, A: m.np.logspace(0, 2, 5),
    "geomspace": lambda m, A: m.np.geomspace(1, 1000, 4),
    "eye": lambda m, A: (m.np.eye(3), m.np.eye(3, 4, 1)),
    "identity": lambda m, A: m.np.identity(3),
    "tri": lambda m, A: m.np.tri(3, 4, 1),
    "indices": lambda m, A: m.np.indices((2, 3)),
    "zeros_like": lambda m, A: m.np.zeros_like(A(X["I"])),
    "ones_like": lambda m, A: m.np.ones_like(A(X["F"])),
    "full_like": lambda m, A: m.np.full_like(A(X["F"]), 3.0),
    "empty_like": lambda m, A: m.np.empty_like(A(X["F"])).shape,
    "copy": lambda m, A: m.np.copy(A(X["F"])),
    "ascontiguousarray": lambda m, A: m.np.ascontiguousarray(X["F"]),
    "asarray": lambda m, A: (m.np.asarray([1, 2]), m.np.asarray([1.5])),
    "array": lambda m, A: (m.np.array([[1, 2]]), m.np.array(X["S"]),
                           m.np.array(np.arange(3, dtype=np.int64)),
                           m.np.array(np.ones(2, np.float64)),
                           m.np.array(3), m.np.array(True)),
    "may_share_memory": lambda m, A: m.np.may_share_memory(A(X["F"]),
                                                           A(X["F"])),
    "shares_memory": lambda m, A: m.np.shares_memory(A(X["F"]), A(X["F"])),
    "concatenate": lambda m, A: (m.np.concatenate([A(X["F"]), A(X["G"])]),
                                 m.np.concatenate([A(X["F"]), A(X["G"])],
                                                  axis=None)),
    "concat": lambda m, A: m.np.concat([A(X["F"]), A(X["G"])], axis=1),
    "stack": lambda m, A: m.np.stack([A(X["F"]), A(X["G"])], axis=1),
    "vstack": lambda m, A: m.np.vstack([A(X["V"]), A(X["V"])]),
    "row_stack": lambda m, A: m.np.row_stack([A(X["F"]), A(X["G"])]),
    "hstack": lambda m, A: (m.np.hstack([A(X["V"]), A(X["W"])]),
                            m.np.hstack([A(X["F"]), A(X["G"])])),
    "dstack": lambda m, A: m.np.dstack([A(X["F"]), A(X["G"])]),
    "column_stack": lambda m, A: m.np.column_stack([A(X["V"]), A(X["V"])]),
    "split": lambda m, A: (m.np.split(A(X["F"]), 2, axis=1),
                           m.np.split(A(X["V"]), [1, 4])),
    "array_split": lambda m, A: m.np.array_split(A(X["V"]), 4),
    "hsplit": lambda m, A: m.np.hsplit(A(X["F"]), 2),
    "vsplit": lambda m, A: m.np.vsplit(A(X["M"]), 2),
    "dsplit": lambda m, A: m.np.dsplit(A(X["F"][:, :, None].repeat(2, 2)),
                                       2),
    "broadcast_arrays": lambda m, A: m.np.broadcast_arrays(
        A(X["W"][:, None]), A(X["V"])),
    "meshgrid": lambda m, A: (m.np.meshgrid(A(X["W"]), A(X["V"])),
                              m.np.meshgrid(A(X["W"]), A(X["V"]),
                                            indexing="ij")),
    "where": lambda m, A: (m.np.where(A(X["B"]), A(X["F"]), A(X["G"])),
                           m.np.where(A(X["B"]), A(X["F"]), 0.0),
                           m.np.where(A(X["B"]))),
    "nonzero": lambda m, A: m.np.nonzero(A(X["B"])),
    "unique": lambda m, A: m.np.unique(A(X["I"]), return_counts=True),
    "isin": lambda m, A: m.np.isin(A(X["I"]), A(np.array([1, 3, 5],
                                                         np.int32))),
    "take": lambda m, A: (m.np.take(A(X["F"]), A(np.array([0, 5, 20],
                                                          np.int32))),
                          m.np.take(A(X["F"]), A(np.array([1, 0],
                                                          np.int32)),
                                    axis=1)),
    "tril_indices": lambda m, A: m.np.tril_indices(3),
    "triu_indices": lambda m, A: m.np.triu_indices(3, 1, 4),
    "diag_indices": lambda m, A: m.np.diag_indices(3),
    "ix_": lambda m, A: m.np.ix_(np.array([0, 1]), np.array([2, 3])),
    "histogram": lambda m, A: m.np.histogram(A(X["S"]), bins=5),
    "allclose": lambda m, A: m.np.allclose(A(X["F"]), A(X["F"])),
    "isclose_bool": lambda m, A: m.np.isclose_bool(A(X["F"]), A(X["G"])),
    "result_type": lambda m, A: m.np.result_type(A(X["F"]), np.int32),
    "promote_types": lambda m, A: m.np.promote_types(np.int8, np.uint8),
    "can_cast": lambda m, A: m.np.can_cast(A(X["I"]), np.float32),
    "shape": lambda m, A: m.np.shape(A(X["F"])),
    "ndim": lambda m, A: m.np.ndim(A(X["F"])),
    "size": lambda m, A: (m.np.size(A(X["F"])), m.np.size(A(X["F"]), 1)),
    "moveaxis_list": lambda m, A: m.np.moveaxis_list(A(X["F"]), 0, 1),
    "insert": lambda m, A: (m.np.insert(A(X["V"]), 2, 9.0),
                            m.np.insert(A(X["F"]), 1, A(X["W"]), axis=1)),
    "flatten": lambda m, A: m.np.flatten(A(X["F"])),
    "cast": lambda m, A: m.np.cast(A(X["F"]), "float16"),
    "abs_": lambda m, A: m.np.abs_(A(X["S"])),
    "bool_array": lambda m, A: m.np.bool_array(A(X["I"] - 3)),
    "topk": lambda m, A: m.np.topk(A(X["S"]), 2),
    "bitwise_not": lambda m, A: m.np.bitwise_not(A(X["I"])),
    "fabs": lambda m, A: m.np.fabs(A(X["I"] - 5)),
    "round_": lambda m, A: m.np.round_(A(X["S"]), 1),
    "diag_indices_from": lambda m, A: m.np.diag_indices_from(A(X["M"])),
    "fill_diagonal": lambda m, A: _mutated(m, A, lambda a: m.np.fill_diagonal(
        a, 5.0)),
    "hanning": lambda m, A: m.np.hanning(5),
    "hamming": lambda m, A: m.np.hamming(5),
    "blackman": lambda m, A: m.np.blackman(5),
    "bartlett": lambda m, A: m.np.bartlett(5),
    "kaiser": lambda m, A: m.np.kaiser(5, 2.0),
    "multi_dot": lambda m, A: m.np.multi_dot([A(X["M"]), A(X["M2"]),
                                              A(X["M"])]),
    "rot90_": lambda m, A: m.np.rot90_(A(X["F"])),
    "ravel_multi_index": lambda m, A: m.np.ravel_multi_index(
        (A(np.array([0, 2], np.int32)), A(np.array([1, 3], np.int32))),
        (3, 4)),
    "sort_complex": lambda m, A: m.np.sort_complex(A(X["V"])),
    "place": lambda m, A: _mutated(m, A, lambda a: m.np.place(
        a, A(X["B"]), A(np.array([7.0, 8.0], np.float32)))),
    "put": lambda m, A: _mutated(m, A, lambda a: m.np.put(
        a, A(np.array([0, 5], np.int32)), A(np.array([7.0, 8.0],
                                                     np.float32)))),
    "choose": lambda m, A: m.np.choose(A(np.array([0, 1, 1, 0], np.int32)),
                                       [A(X["M"][0]), A(X["M"][1])]),
    "require": lambda m, A: m.np.require(A(X["F"]), "float16"),
    "polyadd": lambda m, A: m.np.polyadd(A(X["W"]), A(X["V"])),
    "polysub": lambda m, A: m.np.polysub(A(X["W"]), A(X["V"])),
    "polymul": lambda m, A: m.np.polymul(A(X["W"]), A(X["V"])),
    "polydiv": lambda m, A: m.np.polydiv(A(X["V"]), A(X["W"] + 2.0)),
    "roots": lambda m, A: np.sort_complex(to_numpy(m.np.roots(
        A(np.array([1.0, -3.0, 2.0], np.float32))))),
    "getitem": lambda m, A: m.np.getitem(A(X["F"]), [["slice", 1, 3, None],
                                                     0]),
    "onnx_expand": lambda m, A: m.np.onnx_expand(A(X["W"][:, None]), (1, 5)),
}


def _mutated(m, A, fn):
    a = A(X["F"].copy())
    fn(a)
    return a


# names checked by identity (types, dtype constants) or structurally
TYPES = ("float16", "float32", "float64", "int8", "int16", "int32",
         "int64", "uint8", "uint16", "uint32", "uint64", "bool", "bool_",
         "intp", "dtype", "finfo", "iinfo")
STRUCTURAL = ("ndarray", "apply_op", "Context", "current_context",
              "bfloat16")
LOOSE = {"roots": 1e-4, "multi_dot": 1e-4, "polydiv": 1e-4, "cov": 1e-5,
         "corrcoef": 1e-5, "gamma_fn": 1e-4, "erfinv": 1e-4,
         "gammaln": 1e-5, "i0": 1e-5, "einsum": 1e-5,
         "dot": 1e-5, "matmul": 1e-5, "inner": 1e-5, "vdot": 1e-5}


def public_callables(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and not isinstance(getattr(mod, n), types.ModuleType)
                  and callable(getattr(mod, n)))


def jnp_names():
    jmx = jax_mx()
    return public_callables(jmx.np)


def case(name):
    jnp_mod = jax_mx().np
    if name in jnp_mod._UNARY:
        return _unary(name)
    if name in jnp_mod._BINARY:
        return _binary(name)
    if name in jnp_mod._REDUCTION:
        return _reduction(name)
    if name in OTHER:
        return OTHER[name]
    return EXPLICIT.get(name)


LINALG = {
    "norm": lambda m, A: (m.np.linalg.norm(A(X["M"])),
                          m.np.linalg.norm(A(X["M"]), axis=1)),
    # the JAX package's norm_ is jnp.linalg.norm itself: array-likes in
    "norm_": lambda m, A: m.np.linalg.norm_(X["V"]),
    "cholesky": lambda m, A: m.np.linalg.cholesky(A(_spd())),
    "inv": lambda m, A: m.np.linalg.inv(A(_spd())),
    "pinv": lambda m, A: m.np.linalg.pinv(A(X["F"])),
    "det": lambda m, A: m.np.linalg.det(A(X["M"])),
    "matrix_rank": lambda m, A: m.np.linalg.matrix_rank(A(X["M"])),
    "matrix_power": lambda m, A: m.np.linalg.matrix_power(A(X["M"]), 3),
    "slogdet": lambda m, A: m.np.linalg.slogdet(A(X["M"])),
    "svd": lambda m, A: _svd_key(to_numpy(m.np.linalg.svd(A(X["F"])))),
    "qr": lambda m, A: [np.abs(v) for v in to_numpy(m.np.linalg.qr(
        A(X["M"])))],
    "eig": lambda m, A: np.sort_complex(to_numpy(m.np.linalg.eig(
        A(_spd()))[0])),
    "eigh": lambda m, A: to_numpy(m.np.linalg.eigh(A(_spd()))[0]),
    "eigvals": lambda m, A: np.sort_complex(to_numpy(m.np.linalg.eigvals(
        A(_spd())))),
    "eigvalsh": lambda m, A: m.np.linalg.eigvalsh(A(_spd())),
    "solve": lambda m, A: (m.np.linalg.solve(A(_spd()), A(X["W"][:1].repeat(
        4))), m.np.linalg.solve(A(_spd()), A(X["M"]))),
    "lstsq": lambda m, A: m.np.linalg.lstsq(A(np.vstack([X["M"], X["M2"]])),
                                            A(X["V"].repeat(2)[:8])),
    "tensorinv": lambda m, A: m.np.linalg.tensorinv(
        A(_spd().reshape(4, 2, 2)), 1),
    "tensorsolve": lambda m, A: m.np.linalg.tensorsolve(
        A(_spd()), A(X["W"][:1].repeat(4))),
    "multi_dot": lambda m, A: m.np.linalg.multi_dot([A(X["M"]), A(X["M2"])]),
    "cond": lambda m, A: m.np.linalg.cond(A(_spd())),
}


def _spd():
    m = X["M"]
    return (m @ m.T + 4 * np.eye(4)).astype(np.float32)



