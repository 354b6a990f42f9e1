"""gluon.data.DataLoader (the port of
``mxnet_tpu/gluon/data/dataloader.py``; parity: reference
``python/mxnet/gluon/data/dataloader.py``).

Batches are assembled on the host (numpy) and become ``ndarray``s on the
default device of the thread that iterates the loader (``context.resolve``:
an open ``Context`` scope, else ``cuda``).  With ``num_workers > 0`` a
thread pool assembles up to ``prefetch`` batches ahead (the JAX package's
thread-pool path, ``dataloader.py:29``), each under the iterating
thread's device.  The JAX package's other worker paths, its native
dependency engine and ``worker_mode="process"`` (spawned processes with
shared-memory batches), are not ported; ``"process"`` raises.
"""
from __future__ import annotations

import multiprocessing.dummy as mp_dummy
import os
from collections import deque

import numpy as onp

from ... import context as _context
from ...ndarray import array
from .dataset import Dataset  # noqa: F401
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (reference ``default_batchify_fn``)."""
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn([d[i] for d in data])
                     for i in range(len(data[0])))
    return array(onp.stack([onp.asarray(d) for d in data]))


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120,
                 try_nopython=None, worker_mode=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._num_workers = max(0, num_workers)
        self._pool = None
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * max(self._num_workers, 1))
        if worker_mode is None:
            worker_mode = os.environ.get("MXNET_WORKER_MODE", "thread")
        if worker_mode not in ("thread", "process"):
            raise ValueError("worker_mode must be 'thread' or 'process'")
        if worker_mode == "process" and self._num_workers > 0:
            raise NotImplementedError(
                "DataLoader worker_mode='process' is not ported: the port's "
                "workers are threads")
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError(
                "batch_size/shuffle/sampler/last_batch are mutually "
                "exclusive with batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _make_batch(self, indices, device=None):
        samples = [self._dataset[i] for i in indices]
        if device is None:
            return self._batchify_fn(samples)
        with _context.Context(device):
            return self._batchify_fn(samples)

    def __iter__(self):
        if self._num_workers <= 0 or self._prefetch <= 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices)
            return
        yield from self._iter_pool(_context.resolve(None))

    def _iter_pool(self, device):
        if self._pool is None:
            self._pool = mp_dummy.Pool(self._num_workers)
        pending = deque()
        it = iter(self._batch_sampler)

        def submit(idx):
            pending.append(self._pool.apply_async(self._make_batch,
                                                  (idx, device)))

        try:
            for _ in range(self._prefetch):
                idx = next(it, None)
                if idx is None:
                    break
                submit(idx)
            while pending:
                batch = pending.popleft().get()
                idx = next(it, None)
                if idx is not None:
                    submit(idx)
                yield batch
        finally:
            for p in pending:
                try:
                    p.get(timeout=1)
                except Exception:
                    pass

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        if self._pool is not None:
            self._pool.terminate()
