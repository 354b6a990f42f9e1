"""Reference-compatible binary NDArray container (mx.nd.save/load): the
port's host-only copy of ``mxnet_tpu/legacy_serialization.py``, whose
files it reads and writes byte for byte.

Implements the MXNet NDArray list file format so artifacts saved by
actual MXNet (1.x binary containers; 2.0 still loads them) round-trip
with this framework.  Layout (little-endian; reference
src/ndarray/ndarray.cc:1962-1990 `NDArray::Save/Load(list)` and
:1720-1957 per-array V1/V2/V3 records, include/mxnet/tuple.h:731
TShape serialization, include/mxnet/base.h:147 Context serialization):

    uint64  kMXAPINDArrayListMagic = 0x112
    uint64  reserved = 0
    uint64  n_arrays        (dmlc vector serialization)
    n_arrays x NDArray record:
        uint32 magic: 0xF993fac8 (V1) / 0xF993fac9 (V2) / 0xF993faca (V3)
        [V2/V3] int32 storage_type (0 dense / 1 row_sparse / 2 csr)
        [sparse] TShape storage_shape
        TShape shape            (int32 ndim, int64[ndim])
        int32 dev_type, int32 dev_id     (Context)
        int32 type_flag                  (mshadow/base.h:353 enum)
        [sparse] per aux: int32 aux_type, TShape aux_shape
        raw data bytes (C-contiguous)
        [sparse] raw aux data
    uint64  n_names
    n_names x { uint64 len, bytes }      (dmlc string serialization)

Pre-V1 records (magic field = ndim, uint32 dims) are accepted on load,
matching `LegacyTShapeLoad` (ndarray.cc:1805).
"""
from __future__ import annotations

import struct

import numpy as onp

LIST_MAGIC = 0x112
V1_MAGIC = 0xF993FAC8
V2_MAGIC = 0xF993FAC9
V3_MAGIC = 0xF993FACA

# mshadow type flags (3rdparty/mshadow/mshadow/base.h:353-365)
_FLAG_TO_DTYPE = {
    0: onp.dtype("float32"), 1: onp.dtype("float64"),
    2: onp.dtype("float16"), 3: onp.dtype("uint8"),
    4: onp.dtype("int32"), 5: onp.dtype("int8"), 6: onp.dtype("int64"),
    7: onp.dtype("bool"), 8: onp.dtype("int16"), 9: onp.dtype("uint16"),
    10: onp.dtype("uint32"), 11: onp.dtype("uint64"),
}
_DTYPE_TO_FLAG = {v: k for k, v in _FLAG_TO_DTYPE.items()}


class _Reader:
    def __init__(self, data):
        self.b = data
        self.o = 0

    def read(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.b, self.o)
        self.o += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_tuple(self, fmt):
        vals = struct.unpack_from("<" + fmt, self.b, self.o)
        self.o += struct.calcsize("<" + fmt)
        return vals

    def read_bytes(self, n):
        out = self.b[self.o:self.o + n]
        if len(out) != n:
            raise ValueError("truncated NDArray container")
        self.o += n
        return out


def _read_shape(r, dtype="q"):
    ndim = r.read("i")
    if ndim < 0:
        return None  # unknown shape (none array, np semantics)
    return r.read_tuple(str(ndim) + dtype) if ndim else ()


def _write_shape(parts, shape):
    parts.append(struct.pack("<i", len(shape)))
    if shape:
        parts.append(struct.pack("<%dq" % len(shape), *shape))


def _read_array_record(r):
    """One NDArray record → (numpy array | None). Sparse records are
    densified (values scattered into the dense shape) — this framework
    stores row_sparse/csr as wrapped dense-compatible pairs and users
    load checkpoints for their values."""
    magic = r.read("I")
    stype = 0
    sshape = None
    if magic in (V2_MAGIC, V3_MAGIC):
        stype = r.read("i")
        if stype != 0:
            sshape = _read_shape(r)
        shape = _read_shape(r)
        if shape is None or (magic == V2_MAGIC and shape == ()):
            return None
    elif magic == V1_MAGIC:
        shape = _read_shape(r)
        if not shape:
            return None
    else:
        # pre-V1: the magic field IS ndim, dims are uint32
        ndim = magic
        if ndim == 0:
            return None
        shape = r.read_tuple(str(ndim) + "I")
    r.read("ii")  # context (dev_type, dev_id) — ignored: loads land on host
    type_flag = r.read("i")
    dtype = _FLAG_TO_DTYPE.get(type_flag)
    if dtype is None:
        raise ValueError("unsupported type_flag %d in NDArray file"
                         % type_flag)

    if stype == 0:
        n = int(onp.prod(shape, dtype=onp.int64)) if shape else 1
        data = onp.frombuffer(r.read_bytes(n * dtype.itemsize),
                              dtype=dtype).reshape(shape)
        return data.copy()

    # sparse record: aux types/shapes, then values, then aux data
    nad = 1 if stype == 1 else 2  # row_sparse: idx; csr: indptr, idx
    aux = []
    for _ in range(nad):
        aflag = r.read("i")
        ashape = _read_shape(r)
        aux.append((_FLAG_TO_DTYPE[aflag], ashape))
    nval = int(onp.prod(sshape, dtype=onp.int64)) if sshape else 1
    values = onp.frombuffer(r.read_bytes(nval * dtype.itemsize),
                            dtype=dtype).reshape(sshape)
    aux_data = []
    for adtype, ashape in aux:
        cnt = int(onp.prod(ashape, dtype=onp.int64)) if ashape else 1
        aux_data.append(onp.frombuffer(
            r.read_bytes(cnt * adtype.itemsize), dtype=adtype).reshape(ashape))
    dense = onp.zeros(shape, dtype=dtype)
    if stype == 1:  # row_sparse: values (nnz, *shape[1:]), idx (nnz,)
        idx = aux_data[0]
        dense[idx.astype(onp.int64)] = values
    else:  # csr: indptr (m+1,), indices (nnz,)
        indptr, indices = aux_data
        for row in range(shape[0]):
            lo, hi = int(indptr[row]), int(indptr[row + 1])
            dense[row, indices[lo:hi].astype(onp.int64)] = \
                values[lo:hi]
    return dense


def _write_array_record(parts, arr):
    """Dense V2 record (shape-known arrays; V2 loads everywhere —
    reference V3 additionally demands np-shape scope at load time)."""
    a = onp.ascontiguousarray(arr)
    flag = _DTYPE_TO_FLAG.get(a.dtype)
    if flag is None:
        raise TypeError("dtype %s has no MXNet binary type flag (use npz "
                        "format for bfloat16 etc.)" % a.dtype)
    parts.append(struct.pack("<I", V2_MAGIC))
    parts.append(struct.pack("<i", 0))  # kDefaultStorage
    _write_shape(parts, a.shape if a.ndim else (1,))  # V2: () means none
    parts.append(struct.pack("<ii", 1, 0))  # Context: kCPU=1, dev 0
    parts.append(struct.pack("<i", flag))
    parts.append(a.tobytes())


def is_legacy_file(head8):
    """True when the first 8 bytes carry the list container magic."""
    return len(head8) >= 8 and \
        struct.unpack("<Q", head8[:8])[0] == LIST_MAGIC


def load_legacy(data):
    """bytes → (list_of_numpy_or_None, list_of_names)."""
    r = _Reader(data)
    header = r.read("Q")
    if header != LIST_MAGIC:
        raise ValueError("not an MXNet NDArray container (header %#x)"
                         % header)
    r.read("Q")  # reserved
    n = r.read("Q")
    arrays = [_read_array_record(r) for _ in range(n)]
    n_names = r.read("Q")
    names = []
    for _ in range(n_names):
        ln = r.read("Q")
        names.append(r.read_bytes(ln).decode("utf-8"))
    if names and len(names) != len(arrays):
        raise ValueError("invalid NDArray file: %d names for %d arrays"
                         % (len(names), len(arrays)))
    return arrays, names


def save_legacy(arrays, names):
    """list of numpy arrays (+ names, may be empty) → container bytes."""
    parts = [struct.pack("<QQ", LIST_MAGIC, 0),
             struct.pack("<Q", len(arrays))]
    for a in arrays:
        _write_array_record(parts, a)
    parts.append(struct.pack("<Q", len(names)))
    for nm in names:
        raw = nm.encode("utf-8")
        parts.append(struct.pack("<Q", len(raw)))
        parts.append(raw)
    return b"".join(parts)
