"""Utility helpers (the port's copy of ``mxnet_tpu/util.py``; parity:
``python/mxnet/util.py``).

The reference gates NumPy semantics behind np_shape/np_array scopes for
1.x compatibility; this framework is NumPy-semantics-only (the mxnet 2.0
default), so the scopes are accepted and always true.
"""
from __future__ import annotations

import contextlib
import functools
import os


def is_np_shape():
    return True


def is_np_array():
    return True


def is_np_default_dtype():
    return True


@contextlib.contextmanager
def np_shape(active=True):
    yield active


@contextlib.contextmanager
def np_array(active=True):
    yield active


def use_np_shape(func):
    return func


def use_np_array(func):
    return func


def use_np(func):
    return func


def use_np_default_dtype(func):
    return func


def set_np(shape=True, array=True, dtype=False):
    if not shape or not array:
        raise ValueError("legacy (non-NumPy) semantics are not supported")


def reset_np():
    pass


def set_np_shape(active):
    return True


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    os.environ[name] = value


def default_array(source_array, ctx=None, dtype=None):
    from .ndarray import array
    return array(source_array, dtype=dtype, ctx=ctx)


def get_gpu_count():
    from .context import num_gpus
    return num_gpus()


def get_gpu_memory(dev_id=0):
    """(bytes in use, total bytes) of card ``dev_id``; (0, 0) without one."""
    import torch
    if not torch.cuda.is_available():
        return 0, 0
    free, total = torch.cuda.mem_get_info(dev_id)
    return total - free, total


def wrap_ctx_to_device_func(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if "ctx" in kwargs and "device" not in kwargs:
            kwargs["device"] = kwargs.pop("ctx")
        return func(*args, **kwargs)

    return wrapper
