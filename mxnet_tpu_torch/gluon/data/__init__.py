"""gluon.data (the port of ``mxnet_tpu/gluon/data/``)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset  # noqa: F401
from .sampler import (  # noqa: F401
    Sampler, SequentialSampler, RandomSampler, BatchSampler, FilterSampler,
    IntervalSampler)
from .dataloader import DataLoader, default_batchify_fn  # noqa: F401
from . import batchify  # noqa: F401
from . import vision  # noqa: F401

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "IntervalSampler", "DataLoader",
           "default_batchify_fn", "batchify", "vision"]
