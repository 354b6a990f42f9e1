"""Vision datasets (the port's copy of
``mxnet_tpu/gluon/data/vision/datasets.py``; parity: reference
python/mxnet/gluon/data/vision/datasets.py:
MNIST, FashionMNIST, CIFAR10/100, ImageRecordDataset).

Zero-egress environments: datasets read standard on-disk formats (idx/
pickle) when present; `SyntheticImageDataset` provides deterministic
generated data for tests/benchmarks (the reference benchmarks use
synthetic data the same way — benchmark_score.py feeds random batches).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "SyntheticImageDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from idx files (train-images-idx3-ubyte[.gz] etc.); falls back
    to a deterministic synthetic set when files are absent (offline CI)."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
    _num_classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read_idx(self, path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            ndim = magic & 0xFF
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            data = onp.frombuffer(f.read(), dtype=onp.uint8)
            return data.reshape(dims)

    def _get_data(self):
        imgf, lblf = self._train_files if self._train else self._test_files
        for ext in ("", ".gz"):
            ip = os.path.join(self._root, imgf + ext)
            lp = os.path.join(self._root, lblf + ext)
            if os.path.exists(ip) and os.path.exists(lp):
                self._data = self._read_idx(ip)[..., None]
                self._label = self._read_idx(lp).astype(onp.int32)
                return
        # offline fallback: deterministic synthetic digits
        n = 60000 if self._train else 10000
        n = min(n, 4096)  # keep synthetic sets small
        rng = onp.random.RandomState(42 if self._train else 43)
        self._label = rng.randint(0, self._num_classes, n).astype(onp.int32)
        base = rng.rand(self._num_classes, 28, 28, 1) * 255
        noise = rng.rand(n, 28, 28, 1) * 64
        self._data = onp.clip(base[self._label] * 0.75 + noise, 0,
                              255).astype(onp.uint8)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python pickle batches; synthetic fallback."""

    _num_classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        import pickle
        batch_dir = os.path.join(self._root, "cifar-10-batches-py")
        names = (["data_batch_%d" % i for i in range(1, 6)] if self._train
                 else ["test_batch"])
        if os.path.isdir(batch_dir) and all(
                os.path.exists(os.path.join(batch_dir, n)) for n in names):
            data, labels = [], []
            for n in names:
                with open(os.path.join(batch_dir, n), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                data.append(d[b"data"])
                labels.extend(d[b"labels" if b"labels" in d
                                else b"fine_labels"])
            self._data = onp.concatenate(data).reshape(-1, 3, 32, 32) \
                .transpose(0, 2, 3, 1)
            self._label = onp.asarray(labels, onp.int32)
            return
        n = 2048
        rng = onp.random.RandomState(7 if self._train else 8)
        self._label = rng.randint(0, self._num_classes, n).astype(onp.int32)
        base = rng.rand(self._num_classes, 32, 32, 3) * 255
        noise = rng.rand(n, 32, 32, 3) * 64
        self._data = onp.clip(base[self._label] * 0.75 + noise, 0,
                              255).astype(onp.uint8)


class CIFAR100(CIFAR10):
    _num_classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 train=True, transform=None, fine_label=True):
        super().__init__(root, train, transform)


class SyntheticImageDataset(Dataset):
    """Deterministic synthetic image classification data — for benchmarks
    (reference analog: benchmark_score.py random batches)."""

    def __init__(self, num_samples=1024, shape=(3, 224, 224), num_classes=1000,
                 seed=0, dtype="float32"):
        rng = onp.random.RandomState(seed)
        self._data = rng.rand(num_samples, *shape).astype(dtype)
        self._label = rng.randint(0, num_classes, num_samples).astype(
            onp.int32)

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]
