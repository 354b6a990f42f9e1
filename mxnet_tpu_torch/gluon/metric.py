"""gluon.metric (the port's copy of ``mxnet_tpu/gluon/metric.py``;
parity: reference ``python/mxnet/gluon/metric.py`` EvalMetric :68): the
registry, ``create`` and every metric.  Metrics accumulate on the host in
numpy; an ``ndarray`` or a torch tensor is copied to the host at each
``update``."""
from __future__ import annotations

import math

import numpy as onp
import torch

from ..ndarray import ndarray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Fbeta", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy",
           "Perplexity", "NegativeLogLikelihood", "PearsonCorrelation",
           "PCC", "BinaryAccuracy", "MeanCosineSimilarity",
           "MeanPairwiseDistance", "Loss", "CustomMetric", "create",
           "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        m = CompositeEvalMetric()
        for x in metric:
            m.add(create(x, *args, **kwargs))
        return m
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    return _REGISTRY[metric.lower()](*args, **kwargs)


_ARRAY = (ndarray, onp.ndarray, torch.Tensor)


def _np(x):
    if isinstance(x, ndarray):
        x = x._data
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return onp.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_config(self):
        return {"metric": self.__class__.__name__, **self._kwargs}

    def __str__(self):
        return "EvalMetric: %s" % dict(self.get_name_value())


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, axis=axis, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            label = _np(label)
            pred = _np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(onp.int64).ravel()
            label = label.astype(onp.int64).ravel()
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__("%s_%d" % (name, top_k), top_k=top_k, **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            label = _np(label).astype(onp.int64)
            pred = _np(pred)
            idx = onp.argsort(-pred, axis=-1)[..., : self.top_k]
            hit = (idx == label[..., None]).any(axis=-1)
            self.sum_metric += float(hit.sum())
            self.num_inst += hit.size


class _BinaryStats:
    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        pred = pred.argmax(axis=-1) if pred.ndim > 1 else (pred > 0.5)
        pred = pred.astype(onp.int64).ravel()
        label = label.astype(onp.int64).ravel()
        self.tp += int(((pred == 1) & (label == 1)).sum())
        self.fp += int(((pred == 1) & (label == 0)).sum())
        self.tn += int(((pred == 0) & (label == 0)).sum())
        self.fn += int(((pred == 0) & (label == 1)).sum())


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        self.average = average
        self.stats = _BinaryStats()
        super().__init__(name, **kwargs)

    def reset(self):
        self.stats = _BinaryStats()
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            self.stats.update(_np(label), _np(pred))

    def get(self):
        s = self.stats
        prec = s.tp / (s.tp + s.fp) if s.tp + s.fp else 0.0
        rec = s.tp / (s.tp + s.fn) if s.tp + s.fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return self.name, f1


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        self.stats = _BinaryStats()
        super().__init__(name, **kwargs)

    def reset(self):
        self.stats = _BinaryStats()
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            self.stats.update(_np(label), _np(pred))

    def get(self):
        s = self.stats
        denom = math.sqrt((s.tp + s.fp) * (s.tp + s.fn)
                          * (s.tn + s.fp) * (s.tn + s.fn))
        mcc = ((s.tp * s.tn - s.fp * s.fn) / denom) if denom else 0.0
        return self.name, mcc


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(
                onp.abs(label.reshape(pred.shape) - pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            label, pred = _np(label), _np(pred)
            self.sum_metric += float(
                ((label.reshape(pred.shape) - pred) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.sqrt(self.sum_metric / self.num_inst)


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            label = _np(label).astype(onp.int64).ravel()
            pred = _np(pred).reshape((len(label), -1))
            prob = pred[onp.arange(len(label)), label]
            self.sum_metric += float((-onp.log(prob + self.eps)).sum())
            self.num_inst += len(label)


@register
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.ignore_label = ignore_label

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels = []
        self._preds = []

    def reset(self):
        self._labels, self._preds = [], []
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            self._labels.append(_np(label).ravel())
            self._preds.append(_np(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return self.name, float("nan")
        l = onp.concatenate(self._labels)
        p = onp.concatenate(self._preds)
        return self.name, float(onp.corrcoef(l, p)[0, 1])


@register
class PCC(EvalMetric):
    """Multiclass Pearson/Matthews correlation over a K×K confusion
    matrix (reference metric.py PCC :1597) — NOT the continuous Pearson
    correlation (that is PearsonCorrelation above)."""

    def __init__(self, name="pcc", **kwargs):
        self._conf = onp.zeros((0, 0), onp.float64)
        super().__init__(name, **kwargs)

    def reset(self):
        self._conf = onp.zeros((0, 0), onp.float64)
        self.num_inst = 0
        self.sum_metric = 0.0

    def _grow(self, k):
        if k > self._conf.shape[0]:
            new = onp.zeros((k, k), onp.float64)
            old = self._conf.shape[0]
            new[:old, :old] = self._conf
            self._conf = new

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            label = _np(label).astype(onp.int64).ravel()
            pred = _np(pred)
            pred = (pred.argmax(axis=-1) if pred.ndim > 1
                    else (pred > 0.5)).astype(onp.int64).ravel()
            k = int(max(label.max(initial=0), pred.max(initial=0))) + 1
            self._grow(k)
            onp.add.at(self._conf, (label, pred), 1.0)
            self.num_inst += label.size

    def get(self):
        c = self._conf
        if not c.size or self.num_inst == 0:
            return self.name, float("nan")
        s = c.sum()
        trace = onp.trace(c)
        t_k = c.sum(axis=1)  # true counts per class
        p_k = c.sum(axis=0)  # predicted counts per class
        num = trace * s - (t_k * p_k).sum()
        den = math.sqrt(max(s * s - (p_k * p_k).sum(), 0.0)) * \
            math.sqrt(max(s * s - (t_k * t_k).sum(), 0.0))
        return self.name, (num / den) if den else 0.0


@register
class BinaryAccuracy(EvalMetric):
    """Thresholded accuracy over scores (reference BinaryAccuracy)."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        self.threshold = threshold
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            label = _np(label).ravel()
            pred = (_np(pred).ravel() > self.threshold)
            self.sum_metric += float((pred == (label > 0.5)).sum())
            self.num_inst += label.size


@register
class Fbeta(EvalMetric):
    """F-beta over binary stats (reference Fbeta): beta weighs recall;
    beta=1 reduces to F1."""

    def __init__(self, name="fbeta", beta=1.0, **kwargs):
        self.beta = float(beta)
        self.stats = _BinaryStats()
        super().__init__(name, **kwargs)

    def reset(self):
        self.stats = _BinaryStats()
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            self.stats.update(_np(label), _np(pred))

    def get(self):
        s, b2 = self.stats, self.beta ** 2
        prec = s.tp / (s.tp + s.fp) if s.tp + s.fp else 0.0
        rec = s.tp / (s.tp + s.fn) if s.tp + s.fn else 0.0
        den = b2 * prec + rec
        fb = (1 + b2) * prec * rec / den if den else 0.0
        return self.name, fb


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (reference
    MeanCosineSimilarity)."""

    def __init__(self, name="cos_sim", eps=1e-12, **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            a, b = _np(label), _np(pred)
            num = (a * b).sum(axis=-1)
            den = onp.linalg.norm(a, axis=-1) * onp.linalg.norm(b, axis=-1)
            sim = num / onp.maximum(den, self.eps)
            self.sum_metric += float(sim.sum())
            self.num_inst += sim.size


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean p-norm distance along the last axis (reference
    MeanPairwiseDistance)."""

    def __init__(self, name="mpd", p=2.0, **kwargs):
        self.p = float(p)
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            d = onp.abs(_np(pred) - _np(label)) ** self.p
            dist = d.sum(axis=-1) ** (1.0 / self.p)
            self.sum_metric += float(dist.sum())
            self.num_inst += dist.size


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        if isinstance(preds, _ARRAY):
            preds = [preds]
        for pred in preds:
            loss = _np(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        super().__init__(name, **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        if isinstance(labels, _ARRAY):
            labels, preds = [labels], [preds]
        for label, pred in zip(labels, preds):
            v = self._feval(_np(label), _np(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += v
                self.num_inst += 1
