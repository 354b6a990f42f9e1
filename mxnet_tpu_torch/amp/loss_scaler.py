"""Dynamic loss scaler (the port of ``mxnet_tpu/amp/loss_scaler.py``;
parity: ``python/mxnet/amp/loss_scaler.py:26``): start at 2**16, double
after every ``scale_window`` overflow-free steps (at most 2**24), halve
on an overflow."""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000, max_scale=2 ** 24):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._max_scale = max_scale
        self._unskipped = 0

    def has_overflow(self, params):
        """Whether any gradient of ``params`` (tensors with ``.grad``) holds
        an inf or a NaN: one device reduction and one host read."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return False
        ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        return not bool(ok)

    @property
    def scale_window(self):
        return self._scale_window

    def update_scale(self, overflow):
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self.loss_scale = min(self.loss_scale * self._scale_factor,
                                      self._max_scale)
                self._unskipped = 0
        return self.loss_scale
