"""Port parity: every metric of ``gluon.metric`` (and ``create``),
``gluon.data`` (datasets, samplers, batchify functions, the DataLoader
with and without worker threads), ``gluon.data.vision`` (the MNIST,
FashionMNIST and CIFAR synthetic fallbacks, ``SyntheticImageDataset``,
the transforms) and ``gluon.utils`` against ``mxnet_tpu`` on the CPU.
Data and metrics are host numpy in both packages: they agree exactly,
except where a metric's float sums round (stated below).
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from gluon_parity import jax_mx, port_mx, rand


def _val(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _labels(n, k, seed=0):
    return np.random.default_rng(seed).integers(0, k, n).astype(np.float32)


def _scores(n, k, seed=1):
    p = np.abs(rand(n, k, seed=seed)) + 0.05
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


METRICS = {
    "acc": (lambda m: m.Accuracy(), lambda: (_labels(8, 3), _scores(8, 3))),
    "topk": (lambda m: m.TopKAccuracy(top_k=2),
             lambda: (_labels(8, 4), _scores(8, 4))),
    "f1": (lambda m: m.F1(), lambda: (_labels(8, 2), _scores(8, 2))),
    "fbeta": (lambda m: m.Fbeta(beta=2.0),
              lambda: (_labels(8, 2), _scores(8, 2))),
    "mcc": (lambda m: m.MCC(), lambda: (_labels(8, 2), _scores(8, 2))),
    "mae": (lambda m: m.MAE(), lambda: (rand(6, 2), rand(6, 2, seed=1))),
    "mse": (lambda m: m.MSE(), lambda: (rand(6, 2), rand(6, 2, seed=1))),
    "rmse": (lambda m: m.RMSE(), lambda: (rand(6, 2), rand(6, 2, seed=1))),
    "ce": (lambda m: m.CrossEntropy(), lambda: (_labels(8, 3),
                                                _scores(8, 3))),
    "perplexity": (lambda m: m.Perplexity(),
                   lambda: (_labels(8, 3), _scores(8, 3))),
    "nll": (lambda m: m.NegativeLogLikelihood(),
            lambda: (_labels(8, 3), _scores(8, 3))),
    "pearson": (lambda m: m.PearsonCorrelation(),
                lambda: (rand(10), rand(10, seed=1))),
    "pcc": (lambda m: m.PCC(), lambda: (_labels(12, 3), _scores(12, 3))),
    "binary_acc": (lambda m: m.BinaryAccuracy(threshold=0.4),
                   lambda: (_labels(8, 2), np.abs(rand(8)))),
    "cos_sim": (lambda m: m.MeanCosineSimilarity(),
                lambda: (rand(5, 3), rand(5, 3, seed=1))),
    "mpd": (lambda m: m.MeanPairwiseDistance(p=3),
            lambda: (rand(5, 3), rand(5, 3, seed=1))),
    "loss": (lambda m: m.Loss(), lambda: (None, np.abs(rand(7)))),
    "custom": (lambda m: m.CustomMetric(lambda l, p: float(np.sum(l * p)),
                                        name="dot"),
               lambda: (rand(4), rand(4, seed=1))),
    "composite": (lambda m: m.create(["accuracy", "crossentropy"]),
                  lambda: (_labels(8, 3), _scores(8, 3))),
    "create": (lambda m: m.create("mae"),
               lambda: (rand(6, 2), rand(6, 2, seed=1))),
}


@pytest.mark.parametrize("key", sorted(METRICS))
def test_metric_matches_jax(key):
    make, data = METRICS[key]
    jmx, tmx = jax_mx(), port_mx()
    jm, tm = make(jmx.gluon.metric), make(tmx.gluon.metric)
    for step in range(2):
        label, pred = data()
        if step:
            pred = pred[::-1].copy()
        jm.update(None if label is None else jmx.np.array(label),
                  jmx.np.array(pred))
        with tmx.Context("cpu"):
            tm.update(None if label is None else tmx.np.array(label),
                      tmx.np.array(pred))
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    # the same float64 host sums in the same order, from float32 inputs
    np.testing.assert_allclose(tv, jv, rtol=1e-12)
    tm.reset()
    assert all(m.num_inst == 0 for m in getattr(tm, "metrics", [tm]))


def test_metric_takes_torch_tensors():
    tmx = port_mx()
    m = tmx.gluon.metric.Accuracy()
    m.update(torch.tensor([0, 2]), torch.tensor([[0.9, 0.1, 0.0],
                                                 [0.2, 0.3, 0.5]]))
    assert m.get() == ("accuracy", 1.0)


def test_mnist_fallback_arrays_equal_jax():
    jmx, tmx = jax_mx(), port_mx()
    for cls in ("MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"):
        for train in (True, False):
            jd = getattr(jmx.gluon.data.vision, cls)(train=train)
            td = getattr(tmx.gluon.data.vision, cls)(train=train)
            assert len(td) == len(jd)
            np.testing.assert_array_equal(td._data, jd._data)
            np.testing.assert_array_equal(td._label, jd._label)
    js = jmx.gluon.data.vision.SyntheticImageDataset(num_samples=10)
    ts = tmx.gluon.data.vision.SyntheticImageDataset(num_samples=10)
    for i in range(10):
        np.testing.assert_array_equal(ts[i][0], js[i][0])
        assert ts[i][1] == js[i][1]


def _loader_batches(mx, num_workers, **kw):
    ds = mx.gluon.data.vision.MNIST(train=False)
    tf = mx.gluon.data.vision.transforms.ToTensor()
    np.random.seed(11)
    loader = mx.gluon.data.DataLoader(ds.transform_first(tf), batch_size=32,
                                      shuffle=True, num_workers=num_workers,
                                      **kw)
    out = []
    for i, (x, y) in enumerate(loader):
        if i == 4:
            break
        out.append((x.asnumpy(), y.asnumpy()))
    return out


@pytest.mark.parametrize("num_workers", [0, 2])
def test_dataloader_batches_equal_jax(num_workers):
    """One numpy seed: the same shuffled batches, element for element
    (the port's from worker threads too)."""
    jmx, tmx = jax_mx(), port_mx()
    want = _loader_batches(jmx, 0)
    with tmx.Context("cpu"):
        got = _loader_batches(tmx, num_workers)
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_datasets_samplers_batchify_match_jax():
    jmx, tmx = jax_mx(), port_mx()
    xs, ys = rand(10, 3), np.arange(10, dtype=np.int32)
    seqs = [np.arange(n, dtype=np.float32) for n in (3, 1, 4, 2)]
    out = []
    for mx in (jmx, tmx):
        with (tmx.Context("cpu") if mx is tmx else contextlib.nullcontext()):
            out.append(_data_pipeline(mx, xs, ys, seqs))
    for g, w in zip(*out[::-1]):
        np.testing.assert_array_equal(g, w)


def _data_pipeline(mx, xs, ys, seqs):
    d = mx.gluon.data
    got = []
    ads = d.ArrayDataset(xs, ys)
    got.append(np.stack([ads[i][0] for i in range(len(ads))]))
    sds = d.SimpleDataset(list(range(7))).transform(lambda v: v * 3)
    got.append(np.array([sds[i] for i in range(len(sds))]))
    got.append(np.array(list(d.SequentialSampler(5))))
    np.random.seed(2)
    got.append(np.array(list(d.RandomSampler(9))))
    for last in ("keep", "discard", "rollover"):
        got.append(np.array(sum(list(d.BatchSampler(
            d.SequentialSampler(7), 3, last)), [])))
    got.append(np.array(list(d.IntervalSampler(7, 3))))
    got.append(np.array(list(d.FilterSampler(lambda v: v % 2 == 0,
                                             list(range(9))))))
    batch, lens = d.batchify.Pad(ret_length=True, pad_val=-1)(seqs)
    got += [_val(batch), _val(lens)]
    got.append(_val(d.batchify.Stack()([xs[0], xs[1]])))
    grp = d.batchify.Group(d.batchify.Stack(), d.batchify.Pad())(
        [(xs[i], seqs[i]) for i in range(4)])
    got += [_val(grp[0]), _val(grp[1])]
    return got


TRANSFORMS = {
    "Cast": lambda t: t.Cast("float16"),
    "ToTensor": lambda t: t.ToTensor(),
    "Normalize": lambda t: t.Compose([t.ToTensor(), t.Normalize(
        (0.1, 0.2, 0.3), (0.5, 0.6, 0.7))]),
    "Resize": lambda t: t.Resize((5, 7)),
    "CenterCrop": lambda t: t.CenterCrop(4),
    "RandomResizedCrop": lambda t: t.RandomResizedCrop(5),
    "RandomFlipLeftRight": lambda t: t.RandomFlipLeftRight(),
    "RandomFlipTopBottom": lambda t: t.RandomFlipTopBottom(),
    "RandomBrightness": lambda t: t.RandomBrightness(0.3),
    "RandomContrast": lambda t: t.RandomContrast(0.3),
    "RandomSaturation": lambda t: t.RandomSaturation(0.3),
    "RandomLighting": lambda t: t.RandomLighting(0.2),
    "RandomColorJitter": lambda t: t.RandomColorJitter(0.1, 0.1, 0.1, 0.1),
    "RandomCrop": lambda t: t.RandomCrop(5, pad=1),
    "CropResize": lambda t: t.CropResize(1, 1, 6, 5, size=(4, 4)),
    "RandomGray": lambda t: t.RandomGray(0.5),
    "RandomHue": lambda t: t.RandomHue(0.2),
    "Rotate": lambda t: t.Rotate(30),
    "RandomRotation": lambda t: t.RandomRotation((-20, 20)),
    "RandomApply": lambda t: t.RandomApply(t.RandomFlipLeftRight(), 0.5),
}


@pytest.mark.parametrize("key", sorted(TRANSFORMS))
def test_transform_matches_jax(key):
    img = (np.abs(rand(8, 9, 3)) * 80).astype(np.uint8)
    jmx, tmx = jax_mx(), port_mx()
    out = []
    for mx in (jmx, tmx):
        np.random.seed(4)
        out.append(_val(TRANSFORMS[key](mx.gluon.data.vision.transforms)(
            img)))
    assert out[1].dtype == out[0].dtype
    np.testing.assert_array_equal(out[1], out[0])


def test_clip_global_norm_matches_jax():
    jmx, tmx = jax_mx(), port_mx()
    arrs = [rand(3, 4) * 3, rand(5, seed=1) * 3]
    ja = [jmx.np.array(a) for a in arrs]
    jn = jmx.gluon.utils.clip_global_norm(ja, 1.0)
    with tmx.Context("cpu"):
        ta = [tmx.np.array(a) for a in arrs]
        tn = tmx.gluon.utils.clip_global_norm(ta, 1.0)
    # one fp32 sum of squares per array in the JAX package, one stacked
    # sum here: the norms round apart by an ulp or two
    assert tn == pytest.approx(jn, rel=1e-6)
    for t, j in zip(ta, ja):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
    tt = [torch.tensor(a) for a in arrs]
    assert tmx.gluon.utils.clip_global_norm(tt, 100.0) == pytest.approx(tn)
    np.testing.assert_array_equal(tt[0].numpy(), arrs[0])


def test_split_and_load_and_sha1(tmp_path):
    jmx, tmx = jax_mx(), port_mx()
    x = rand(6, 2)
    js = jmx.gluon.utils.split_data(jmx.np.array(x), 3)
    with tmx.Context("cpu"):
        ts = tmx.gluon.utils.split_data(tmx.np.array(x), 3)
        tl = tmx.gluon.utils.split_and_load(x, [tmx.cpu()])
        with pytest.raises(ValueError):
            tmx.gluon.utils.split_data(tmx.np.array(x), 4)
    for t, j in zip(ts, js):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    np.testing.assert_array_equal(tl[0].asnumpy(), x)
    f = tmp_path / "blob"
    f.write_bytes(b"gluon")
    import hashlib
    h = hashlib.sha1(b"gluon").hexdigest()
    assert tmx.gluon.utils.check_sha1(str(f), h)
    assert not tmx.gluon.utils.check_sha1(str(f), "0" * 40)
