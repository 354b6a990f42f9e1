"""Device contexts (the port's counterpart of ``mxnet_tpu/context.py``).

``cpu()`` and ``gpu(i)`` name ``torch.device``s.  The default-device rule
of the whole port lives in :func:`resolve`: an entry point given no
device runs on ``cuda``, and raises when no GPU is present.  It never
carries on on the CPU unless the caller asked for the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["cpu", "gpu", "resolve"]


def cpu():
    return torch.device("cpu")


def gpu(device_id=0):
    return torch.device("cuda", int(device_id))


def resolve(device=None):
    """The device an entry point runs on: ``device`` when given (a
    ``torch.device`` or a string such as ``"cpu"``/``"cuda:0"``), else
    ``cuda``.  Raises ``RuntimeError`` when CUDA is asked for (or
    defaulted to) and no GPU is present."""
    dev = torch.device(device if device is not None else "cuda")
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
