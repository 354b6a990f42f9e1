"""Global random state of the imperative random ops (the port of
``mxnet_tpu/_rng.py``; parity: reference ``src/resource.cc`` kRandom,
seeded by ``mx.random.seed``).

The JAX package keeps one process-wide base key and a draw counter under
a lock, and folds the counter into the base for each draw.  The port
keeps that structure with integers: :func:`next_seed` derives each draw's
int64 seed on the host from (base seed, counter) by splitmix64, so two
threads never replay a stream and ``seed(s)`` restarts every thread's.
The draw itself is made where the data lives:

- random ops build a ``torch.Generator`` on their own device from the
  seed (:func:`generator`).  The CPU's and CUDA's streams for one seed
  differ, and neither is JAX's threefry stream;
- the hash-dropout kernels (the bias + dropout + residual epilogue, the
  flash kernels) take the seed's low 32 bits directly
  (:func:`next_hash_seed`), so their masks are the same on the CPU (the
  plain versions) and on the card for one seed.

``trace_keys`` (the JAX package's keys as arguments of a compiled
HybridBlock trace) has no use here: the port's ``hybridize`` runs
eagerly and traces nothing.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "next_seed", "next_hash_seed", "hash_seed_tensor",
           "generator"]

_LOCK = threading.Lock()
_DEFAULT_SEED = 0
_BASE = _DEFAULT_SEED
_COUNTER = 0
_M64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def seed(seed_state, ctx="all"):
    """``mx.random.seed``: process-wide, every device (``ctx`` is
    accepted for parity)."""
    global _BASE, _COUNTER
    with _LOCK:
        _BASE = int(seed_state) & _M64
        _COUNTER = 0


def next_seed():
    """A fresh non-negative int64 seed: splitmix64 of the base seed mixed
    with the next value of the draw counter."""
    global _COUNTER
    with _LOCK:
        _COUNTER += 1
        n, base = _COUNTER, _BASE
    return _splitmix64(_splitmix64(base) ^ n) >> 1


def next_hash_seed():
    """A fresh uint32 seed for the hash-dropout kernels."""
    return next_seed() & 0xFFFFFFFF


def hash_seed_tensor(device):
    """A fresh uint32 hash seed (:func:`next_hash_seed`) as a one-element
    int64 tensor on ``device``, copied from pinned memory without making
    the host wait for the card (``torch.tensor(..., device="cuda")`` from
    pageable memory would synchronise the stream on every draw)."""
    t = torch.tensor([next_hash_seed()], dtype=torch.int64)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def generator(device):
    """A ``torch.Generator`` on ``device`` seeded with :func:`next_seed`."""
    return torch.Generator(device=device).manual_seed(next_seed())
