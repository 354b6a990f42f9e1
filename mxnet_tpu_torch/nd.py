"""mx.nd: the legacy NDArray namespace (the port of ``mxnet_tpu/nd.py``;
parity: ``python/mxnet/ndarray/``).

``mx.nd`` re-exports the ``mx.np`` surface plus the legacy entry points
(``waitall``, ``load``/``save``, ``NDArray``) and the 1.x CamelCase ops,
each mapped onto the npx/np implementation the Gluon layers use.
``save``/``load`` read and write npz (the reference 2.0 format) and the
MXNet binary container (``legacy_serialization.py``), byte for byte the
JAX package's files.  ``nd.Custom`` and ``nd.sparse`` wait for ROADMAP
item 9 (``_unported.py``).
"""
from .numpy import *  # noqa: F401,F403
from .numpy import random, linalg  # noqa: F401
from .ndarray import ndarray as NDArray, array, waitall  # noqa: F401
from .numpy_extension import savez  # noqa: F401
from . import _nd_contrib as contrib  # noqa: F401
from . import _unported

_unported.install("nd", globals())


def save(fname, data, format="npz"):
    """Save a list or dict of arrays to one file (parity: mx.nd.save).

    format='npz' (default — what reference 2.0 writes,
    src/c_api/c_api.cc:1913 MXNDArraySave → npz); format='legacy' writes
    the MXNet binary NDArray container (src/ndarray/ndarray.cc:1962)
    loadable by actual MXNet 1.x/2.0."""
    import numpy as _onp
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        arrays = {"__mx_list_%d" % i: a.asnumpy() for i, a in enumerate(data)}
    elif isinstance(data, dict):
        arrays = {k: v.asnumpy() for k, v in data.items()}
    else:
        raise TypeError("save expects NDArray, list, or dict")
    if format == "legacy":
        from .legacy_serialization import save_legacy
        keys = list(arrays)
        names = [] if isinstance(data, (list, tuple)) else keys
        with open(fname, "wb") as f:
            f.write(save_legacy([arrays[k] for k in keys], names))
        return
    _onp.savez(fname, **arrays)


def load(fname, ctx=None):
    """Load arrays saved by mx.nd.save → list or dict (parity:
    mx.nd.load) on ``ctx`` (the default device when None).  Sniffs the
    container: npz/npy (reference 2.0 format) or the MXNet binary NDArray
    container (1.x artifacts, src/ndarray/ndarray.cc:1720
    NDARRAY_V1/V2/V3)."""
    import os as _os
    import numpy as _onp
    import builtins
    if not _os.path.exists(fname) and _os.path.exists(fname + ".npz"):
        fname = fname + ".npz"
    with open(fname, "rb") as f:
        head = f.read(8)
    from .legacy_serialization import is_legacy_file
    if is_legacy_file(head):
        from .legacy_serialization import load_legacy
        with open(fname, "rb") as f:
            arrays, names = load_legacy(f.read())
        wrapped = [None if a is None else array(a, ctx=ctx) for a in arrays]
        if names:
            return {n: a for n, a in zip(names, wrapped)}
        return wrapped
    data = _onp.load(fname, allow_pickle=False)
    keys = list(data.files)
    if keys and builtins.all(k.startswith("__mx_list_") for k in keys):
        keys.sort(key=lambda k: int(k.rsplit("_", 1)[1]))
        return [array(data[k], ctx=ctx) for k in keys]
    return {k: array(data[k], ctx=ctx) for k in keys}
# ---------------------------------------------------------------------------
# legacy CamelCase eager ops (reference mx.nd op surface: explicit-weight
# signatures, python/mxnet/ndarray/register.py-generated wrappers).  Each
# maps onto the npx/np implementation the Gluon layers use — the same
# kernels, the 1.x calling convention.
# ---------------------------------------------------------------------------
from . import numpy_extension as _npx  # noqa: E402
from . import numpy as _np  # noqa: E402


def FullyConnected(data, weight, bias=None, num_hidden=None, no_bias=False,
                   flatten=True, **kw):
    return _npx.fully_connected(data, weight, bias, num_hidden=num_hidden,
                                no_bias=no_bias or bias is None,
                                flatten=flatten, **kw)


def Convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **kw):
    return _npx.convolution(data, weight, bias, kernel=kernel,
                            stride=stride, dilate=dilate, pad=pad,
                            num_filter=num_filter, num_group=num_group,
                            no_bias=no_bias or bias is None, layout=layout,
                            **kw)


def Activation(data, act_type="relu", **kw):
    return _npx.activation(data, act_type=act_type, **kw)


def Pooling(data, kernel=None, pool_type="max", stride=None, pad=None,
            global_pool=False, **kw):
    return _npx.pooling(data, kernel=kernel, pool_type=pool_type,
                        stride=stride, pad=pad, global_pool=global_pool,
                        **kw)


def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              axis=1, **kw):
    return _npx.batch_norm(data, gamma, beta, moving_mean, moving_var,
                           eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                           use_global_stats=use_global_stats, axis=axis,
                           **kw)


def Embedding(data, weight, input_dim=None, output_dim=None, **kw):
    return _npx.embedding(data, weight, input_dim=input_dim,
                          output_dim=output_dim, **kw)


def Flatten(data, **kw):
    return _np.reshape(data, (data.shape[0], -1))


def _legacy_reshape_shape(in_shape, spec, reverse=False):
    """Resolve the 1.x Reshape special codes (reference
    src/operator/tensor/matrix_op-inl.h InferReshapeShape):
    0 copy input dim; -1 infer; -2 copy ALL remaining input dims;
    -3 merge two consecutive input dims; -4 split a dim into the next
    two spec values (one may be -1)."""
    ishape = list(in_shape[::-1]) if reverse else list(in_shape)
    spec = list(spec[::-1]) if reverse else list(spec)
    out = []
    i = 0   # position in ishape
    j = 0   # position in spec
    infer_at = None
    while j < len(spec):
        v = spec[j]
        if v == 0:
            out.append(ishape[i]); i += 1
        elif v == -1:
            # -1 still consumes one input dim (reference
            # matrix_op-inl.h:114 does src_idx++): a later 0 must copy
            # the NEXT input dim, e.g. (-1, 0) on (2,3) -> (2,3)
            infer_at = len(out); out.append(1); i += 1
        elif v == -2:
            out.extend(ishape[i:]); i = len(ishape)
        elif v == -3:
            out.append(ishape[i] * ishape[i + 1]); i += 2
        elif v == -4:
            a, b = spec[j + 1], spec[j + 2]
            d = ishape[i]; i += 1
            if a == -1:
                a = d // b
            if b == -1:
                b = d // a
            out.extend([a, b]); j += 2
        else:
            out.append(int(v)); i += 1
        j += 1
    if infer_at is not None:
        known = 1
        for k, v in enumerate(out):
            if k != infer_at:
                known *= v
        total = 1
        for v in in_shape:
            total *= v
        # NB: bare max() here would resolve to the star-imported np.max
        import builtins as _bi
        out[infer_at] = total // _bi.max(known, 1)
    return tuple(out[::-1]) if reverse else tuple(out)


def Reshape(data, shape=None, reverse=False, **kw):
    if shape is None:
        raise ValueError("Reshape requires shape=")
    return _np.reshape(data,
                       _legacy_reshape_shape(data.shape, shape, reverse))


def Concat(*data, dim=1, **kw):
    return _np.concatenate(list(data), axis=dim)


def Dropout(data, p=0.5, **kw):
    return _npx.dropout(data, p=p, **kw)


def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25, **kw):
    if act_type == "prelu":
        return _npx.leaky_relu(data, gamma, act_type=act_type, **kw)
    return _npx.leaky_relu(data, act_type=act_type, slope=slope, **kw)


def SoftmaxActivation(data, mode="instance", **kw):
    return _npx.softmax(data, axis=-1 if mode == "instance" else 1)


def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0, **kw):
    return _npx.sequence_mask(data, sequence_length,
                              use_sequence_length=use_sequence_length,
                              value=value, axis=axis, **kw)


def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0, **kw):
    return _npx.sequence_last(data, sequence_length,
                              use_sequence_length=use_sequence_length,
                              axis=axis, **kw)


def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0, **kw):
    return _npx.sequence_reverse(data, sequence_length,
                                 use_sequence_length=use_sequence_length,
                                 axis=axis, **kw)


def SliceChannel(data, num_outputs=None, axis=1, squeeze_axis=False, **kw):
    outs = _np.split(data, num_outputs, axis=axis)
    if squeeze_axis:
        outs = [o.squeeze(axis=axis) for o in outs]
    return outs


def split(data, num_outputs=None, axis=1, squeeze_axis=False, **kw):
    """Legacy ``mx.nd.split`` == SliceChannel: `num_outputs` equal parts
    along ``axis`` (default 1!).

    This name shadows the np-style ``split`` star-exported from mx.np —
    whose signature is ``np.split(a, indices_or_sections, axis=0)``.  A
    NumPy-style call (index-list second argument, or the
    ``sections``/``indices_or_sections`` keyword) used to be silently
    interpreted as a SliceChannel along axis 1; detect it and point the
    caller at ``mx.np.split`` instead."""
    np_style = ("sections" in kw or "indices_or_sections" in kw
                or isinstance(num_outputs, (list, tuple))
                or isinstance(num_outputs, NDArray)
                or (hasattr(num_outputs, "ndim")
                    and getattr(num_outputs, "ndim", 0) > 0))
    if np_style:
        raise TypeError(
            "mx.nd.split is the legacy SliceChannel op (num_outputs equal "
            "parts along axis=%d, axis default 1); it does not accept "
            "NumPy-style split points. For np.split semantics "
            "(indices_or_sections, axis default 0) call mx.np.split "
            "explicitly." % axis)
    return SliceChannel(data, num_outputs=num_outputs, axis=axis,
                        squeeze_axis=squeeze_axis, **kw)
