"""gluon.utils (the port of ``mxnet_tpu/gluon/utils.py``; parity:
reference ``python/mxnet/gluon/utils.py``): ``split_data``,
``split_and_load``, ``clip_global_norm``, ``check_sha1`` and
``download``.

Each takes ``ndarray``s or torch tensors.  ``clip_global_norm`` reads the
global norm to the host once for the whole list (one synchronisation,
where the JAX package reads one sum per array) and scales the arrays in
place: a Gluon parameter's ``grad()`` writes through to its leaf's
gradient.  ``download`` fetches over the network; nothing in the port
calls it.
"""
from __future__ import annotations

import os
import warnings

import numpy as onp
import torch

from ..ndarray import ndarray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices"
            % (str(data.shape), num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        sl = [slice(None)] * data.ndim
        sl[batch_axis] = slice(begin, end)
        slices.append(data[tuple(sl)])
    return slices


def _to(data, ctx):
    if isinstance(data, torch.Tensor):
        from .. import context
        return data.to(context.resolve(ctx))
    return data.as_in_ctx(ctx)


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    if not isinstance(data, (ndarray, torch.Tensor)):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [_to(data, ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [_to(s, ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that the l2 norm of all of them
    together is at most ``max_norm``; returns that norm before scaling."""
    assert len(arrays) > 0
    ts = [a._data if isinstance(a, ndarray) else a for a in arrays]
    with torch.no_grad():
        total_norm = float(torch.stack(
            [torch.square(t.detach().float()).sum() for t in ts]).sum()
            .sqrt())
    if check_isfinite and not onp.isfinite(total_norm):
        warnings.warn("nan or inf found in clip_global_norm")
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            if isinstance(a, ndarray):
                a *= scale
            else:
                with torch.no_grad():
                    a.mul_(scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    import hashlib
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Fetch ``url`` to ``path`` unless a file with ``sha1_hash`` is there
    already (a machine without network raises at the call)."""
    import urllib.request
    fname = path or url.split("/")[-1]
    if os.path.isdir(fname):
        fname = os.path.join(fname, url.split("/")[-1])
    if overwrite or not os.path.exists(fname) or (
            sha1_hash and not check_sha1(fname, sha1_hash)):
        d = os.path.dirname(os.path.abspath(os.path.expanduser(fname)))
        if not os.path.exists(d):
            os.makedirs(d)
        urllib.request.urlretrieve(url, fname)
    return fname
