"""Device contexts (the port's counterpart of ``mxnet_tpu/context.py``).

``cpu()`` and ``gpu(i)`` name ``torch.device``s.  The default-device rule
of the whole port lives in :func:`resolve`: an entry point given no
device runs on the device of the innermost open :class:`Context` scope,
else on ``cuda``, and raises when ``cuda`` is asked for and no GPU is
present.  It never carries on on the CPU unless the caller asked for the
CPU, by name or by a scope.

:class:`Context` (``Device``) is the JAX package's ``with`` scope:
``with Context("cpu"): ...`` makes the CPU the default of the arrays and
random draws made inside it, per thread.  ``current_context()`` is the
scope's device, or ``cuda`` when no scope is open.  A ``torch.device``
is not a scope of its own here: ``with mx.cpu():`` is torch's default-
device scope and does not reach :func:`resolve`.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["cpu", "gpu", "resolve", "Context", "Device", "current_context",
           "num_gpus"]

_SCOPE = threading.local()


def cpu(device_id=0):
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def _stack():
    if not hasattr(_SCOPE, "stack"):
        _SCOPE.stack = []
    return _SCOPE.stack


def resolve(device=None):
    """The device an entry point runs on: ``device`` when given (a
    ``torch.device``, a :class:`Context` or a string such as
    ``"cpu"``/``"cuda:0"``), else the innermost open :class:`Context`'s,
    else ``cuda``.  Raises ``RuntimeError`` when CUDA is asked for (or
    defaulted to) and no GPU is present."""
    if isinstance(device, Context):
        device = device.device
    if device is None:
        stack = _stack()
        device = stack[-1] if stack else "cuda"
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %r (cpu or cuda)" % (dev,))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Context:
    """A device as a ``with`` scope: ``Context("cpu")``,
    ``Context("gpu", 0)`` (``"gpu"`` and ``"cuda"`` name the same card)
    or ``Context(torch.device(...))``.  Inside the scope :func:`resolve`
    defaults to it."""

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type = device_type.device
        if isinstance(device_type, torch.device):
            dev = device_type
        else:
            kind = "cuda" if device_type in ("gpu", "cuda") else device_type
            if kind not in ("cpu", "cuda"):
                raise ValueError("unknown device_type %r" % (device_type,))
            dev = torch.device(kind, int(device_id)) if kind == "cuda" \
                else torch.device("cpu")
        self.device = dev

    @property
    def device_type(self):
        return "gpu" if self.device.type == "cuda" else "cpu"

    @property
    def device_id(self):
        return self.device.index or 0

    def __eq__(self, other):
        if isinstance(other, Context):
            other = other.device
        if isinstance(other, (torch.device, str)):
            return self.device == torch.device(other)
        return NotImplemented

    def __hash__(self):
        return hash(self.device)

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __enter__(self):
        _stack().append(self.device)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


Device = Context


def current_context():
    """The default device: the innermost open scope's, else ``cuda``
    (resolved by :func:`resolve`, so it raises without a GPU)."""
    return resolve(None)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0
