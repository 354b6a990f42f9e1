"""Batchify functions (the port's copy of ``mxnet_tpu/gluon/data/batchify.py``;
parity: reference python/mxnet/gluon/data/batchify.py —
Stack, Pad, Group; used as DataLoader batchify_fn for variable-length
data)."""
from __future__ import annotations

import numpy as onp

from ...ndarray import ndarray, array as nd_array

__all__ = ["Stack", "Pad", "Group", "Tuple"]


def _as_np(x):
    if isinstance(x, ndarray):
        return x.asnumpy()
    return onp.asarray(x)


class Stack:
    """Stack equally-shaped samples into a batch (batchify.py Stack)."""

    def __call__(self, data):
        return nd_array(onp.stack([_as_np(d) for d in data]))


class Pad:
    """Pad variable-length samples to the batch max along `axis`
    (batchify.py Pad).  ret_length returns the original lengths too."""

    def __init__(self, axis=0, pad_val=0, ret_length=False, dtype=None):
        self._axis = axis
        self._pad_val = pad_val
        self._ret_length = ret_length
        self._dtype = dtype

    def __call__(self, data):
        arrs = [_as_np(d) for d in data]
        ndim = arrs[0].ndim
        if not (-ndim <= self._axis < ndim):
            raise onp.exceptions.AxisError(self._axis, ndim)
        axis = self._axis % ndim  # negative-axis safe
        max_len = max(a.shape[axis] for a in arrs)
        shape = list(arrs[0].shape)
        shape[axis] = max_len
        out = onp.full([len(arrs)] + shape, self._pad_val,
                       dtype=self._dtype or arrs[0].dtype)
        lengths = []
        for i, a in enumerate(arrs):
            sl = [i] + [slice(None)] * a.ndim
            sl[1 + axis] = slice(0, a.shape[axis])
            out[tuple(sl)] = a
            lengths.append(a.shape[axis])
        batch = nd_array(out)
        if self._ret_length:
            return batch, nd_array(onp.asarray(lengths, onp.int32))
        return batch


class Group:
    """Apply one batchify fn per sample field (batchify.py Group/Tuple)."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data):
        assert len(data[0]) == len(self._fns), \
            "sample has %d fields, Group has %d fns" % (len(data[0]),
                                                        len(self._fns))
        return tuple(fn([d[i] for d in data])
                     for i, fn in enumerate(self._fns))


# reference alias: batchify.Tuple
Tuple = Group
