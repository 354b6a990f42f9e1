"""Losses (the port of ``mxnet_tpu/gluon/loss.py``; parity: reference
``python/mxnet/gluon/loss.py``): the ``Loss`` base and its 14 losses, as
Gluon blocks over torch code (``gluon/block.py``: ``ndarray`` in,
``ndarray`` out; torch in, torch out).

A loss returns one value per sample: the mean over every axis but
``batch_axis`` (``TripletLoss``, ``CosineEmbeddingLoss`` and ``CTCLoss``
one value per sample by construction; ``PoissonNLLLoss`` and
``SDMLLoss`` one scalar).  MXNet's ``backward()`` of such a vector sums
the samples (a head gradient of ones), and ``Trainer.step(batch_size)``
divides by the batch size; with torch tensors the drive is therefore
``loss.backward(torch.ones_like(loss))`` followed by ``trainer.step(B)``.
"""
from __future__ import annotations

import math

import torch

from ..ops import nn as _ops
from .block import _Layer

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    if tuple(pred.shape) != tuple(label.shape):
        label = label.reshape(pred.shape)
    return label


def _batch_mean(loss, batch_axis):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    return loss.mean(dim=axes) if axes else loss


def _log1p_exp_neg_abs(pred):
    return torch.log(1.0 + torch.exp(-torch.abs(pred)))


class Loss(_Layer):
    """Base loss: a global ``weight`` and the ``batch_axis`` kept in the
    per-sample result."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return "batch_axis=%s, w=%s" % (self._batch_axis, self._weight)


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _forward(self, training, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class L1Loss(Loss):
    def _forward(self, training, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(label - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def _forward(self, training, pred, label, sample_weight=None,
                 pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = (torch.clamp_min(pred, 0) - pred * label
                        + _log1p_exp_neg_abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _log1p_exp_neg_abs(pred) + torch.clamp_min(-pred, 0))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of ``log_softmax(pred)`` along ``axis``.  With
    ``sparse_label`` the label holds class indices (pred's shape without
    ``axis``); otherwise a distribution of pred's shape.  ``from_logits``
    takes ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def _forward(self, training, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -_ops.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def _forward(self, training, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _ops.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class CTCLoss(Loss):
    """CTC over ``npx.ctc_loss``'s torch code (blank 0, labels padded with
    -1 or 0)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def _forward(self, training, pred, label, pred_lengths=None,
                 label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        loss = _ops.ctc_loss(pred, label, pred_lengths, label_lengths, 0)
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _forward(self, training, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.abs(label - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _forward(self, training, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.clamp_min(self._margin - pred * label, 0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _forward(self, training, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.square(torch.clamp_min(self._margin - pred * label, 0))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def _forward(self, training, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = (torch.clamp_min(pred, 0) - pred * label
                + _log1p_exp_neg_abs(pred))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _batch_mean(loss, self._batch_axis)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _forward(self, training, pred, positive, negative,
                 sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        axes = tuple(range(1, pred.ndim))
        loss = (torch.square(pred - positive)
                - torch.square(pred - negative)).sum(dim=axes) + self._margin
        loss = torch.clamp_min(loss, 0)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def _forward(self, training, pred, target, sample_weight=None,
                 epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * torch.log(target + 1e-12) - target
                        + 0.5 * torch.log(2 * target * math.pi + 1e-12))
            stirling = torch.where(target <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _forward(self, training, input1, input2, label, sample_weight=None):
        input2 = _reshape_like(input1, input2)
        cos = (input1 * input2).sum(dim=-1) / (
            torch.sqrt(torch.square(input1).sum(dim=-1))
            * torch.sqrt(torch.square(input2).sum(dim=-1)) + 1e-12)
        label = label.reshape(-1)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.clamp_min(cos - self._margin, 0))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smoothing = smoothing_parameter

    def _forward(self, training, x1, x2):
        n = x1.shape[0]
        dist = -torch.sqrt(torch.square(x1.unsqueeze(1) - x2.unsqueeze(0))
                           .sum(dim=2) + 1e-12)
        logp = _ops.log_softmax(dist, axis=-1)
        eye = torch.eye(n, dtype=x1.dtype, device=x1.device)
        target = eye * (1 - self._smoothing) + \
            (1 - eye) * self._smoothing / (n - 1)
        return -(target * logp).sum(dim=1).mean()
