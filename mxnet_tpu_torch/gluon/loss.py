"""Losses (the port of ``Loss`` and ``SoftmaxCrossEntropyLoss`` of
``mxnet_tpu/gluon/loss.py``).

A loss returns one value per sample: the mean over every axis but
``batch_axis``.  MXNet's ``backward()`` of such a vector sums the samples
(a head gradient of ones), and ``Trainer.step(batch_size)`` divides by the
batch size; the port's drive is therefore
``loss.backward(torch.ones_like(loss))`` followed by ``trainer.step(B)``.
"""
from __future__ import annotations

from torch import nn

from ..ops import nn as _ops

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    return loss.mean(dim=axes) if axes else loss


class Loss(nn.Module):
    """Base loss: a global ``weight`` and the ``batch_axis`` kept in the
    per-sample result."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return "batch_axis=%s, w=%s" % (self._batch_axis, self._weight)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of ``log_softmax(pred)`` along ``axis``.  With
    ``sparse_label`` the label holds class indices (pred's shape without
    ``axis``); otherwise a distribution of pred's shape.  ``from_logits``
    takes ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -_ops.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = label.reshape(pred.shape)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
