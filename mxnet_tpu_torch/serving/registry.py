"""Model registry: named, versioned, bucketed served models (the port of
``mxnet_tpu/serving/registry.py``).

A served model is a batch function ``fn(batch_np) -> batch_np`` plus the
metadata the batcher needs (item shape/dtype, batch buckets).  Sources:

- a Gluon block: hybridized, and called with the batch as an ``ndarray``
  on the block's device outside ``autograd.record()`` (predict mode), as
  the JAX package serves it;
- a ``torch.nn.Module`` (the port's ``CausalLM``, for instance): the batch
  goes in as a tensor on the module's device, under ``torch.no_grad()``;
- any plain callable (tests / custom pre-post-processing).

Exported checkpoints (``load_checkpoint``, ``SymbolBlock.imports`` in the
JAX package) wait for the symbolic graph API (ROADMAP Queue 1 item 9)
and raise ``NotImplementedError``.

Batch bucketing: each model declares a sorted tuple of batch buckets
(default: powers of two up to ``max_batch_size``); the batcher pads a
coalesced batch up to the smallest bucket that fits and slices the
padding back off the outputs, so a batch function sees a few shapes only
(on the card: the kernels' launch plans and PyTorch's caching allocator
settle on them).  ``warmup=True`` (default) runs every bucket once at
load time, so no client request pays a first call (a kernel's build).

Hot swap: ``load()`` warms the new version BEFORE publishing it, then
flips the model's latest pointer atomically — in-flight and queued
requests resolve their version at dispatch time, so a swap never
interrupts traffic.
"""
from __future__ import annotations

import threading
import time

import numpy as onp

from .. import config as _config
from .errors import BadRequestError, ModelNotFoundError

__all__ = ["ServedModel", "ModelRegistry", "default_buckets",
           "maybe_enable_compile_cache", "resolve_builder",
           "load_model_spec"]


def maybe_enable_compile_cache(path=None):
    """The JAX package points XLA's persistent compilation cache at
    ``path`` (or ``MXNET_COMPILE_CACHE_DIR``) so a restarted replica reads
    its warmup's programs back.  The port has no XLA cache: PyTorch runs
    eagerly, and its kernels are built once by ``nvcc`` into
    ``mxnet_tpu_torch/_build``, keyed by a hash of their sources and
    flags, where every later process on the host finds them.  So there is
    nothing to enable: with neither ``path`` nor the variable set this
    returns None, and asking for a cache directory raises
    ``NotImplementedError`` rather than being ignored."""
    if path is None:
        path = _config.get("MXNET_COMPILE_CACHE_DIR") or None
    if path:
        raise NotImplementedError(
            "the port has no XLA compile cache to point at %r: its kernels "
            "are built once into mxnet_tpu_torch/_build and reused by every "
            "process (unset MXNET_COMPILE_CACHE_DIR)" % (str(path),))
    return None


def resolve_builder(path):
    """``"package.module:callable"`` → the callable.

    Model specs name models by importable builder instead of shipping
    code: only a callable reachable on the server's own PYTHONPATH can
    ever run."""
    mod, _, fn = str(path).partition(":")
    if not mod or not fn:
        raise BadRequestError(
            "builder must be 'package.module:callable', got %r" % (path,))
    import importlib
    try:
        target = importlib.import_module(mod)
    except ImportError as e:
        raise BadRequestError("cannot import builder module %r: %s"
                              % (mod, e))
    for attr in fn.split("."):
        target = getattr(target, attr, None)
        if target is None:
            raise BadRequestError("builder %r has no attribute %r"
                                  % (path, attr))
    if not callable(target):
        raise BadRequestError("builder %r is not callable" % (path,))
    return target


def load_model_spec(registry, spec):
    """Load ONE model-spec dict into ``registry`` and return the
    ``ServedModel``.  Spec keys: ``name``, ``builder``
    ("module:callable"), optional ``kwargs`` (builder arguments),
    ``version``, ``item_shape``, ``dtype``, ``max_batch_size``,
    ``buckets``, ``warmup``."""
    builder = resolve_builder(spec["builder"])
    model = builder(**(spec.get("kwargs") or {}))
    return registry.load(
        spec["name"], model, version=spec.get("version"),
        item_shape=spec.get("item_shape"),
        dtype=spec.get("dtype", "float32"),
        max_batch_size=spec.get("max_batch_size", 32),
        buckets=spec.get("buckets"),
        warmup=spec.get("warmup", True))


def default_buckets(max_batch_size):
    """Powers of two up to (and always including) max_batch_size."""
    buckets = []
    b = 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return tuple(buckets)


_CHECKPOINT = ("ModelRegistry.load_checkpoint is not ported yet: it imports "
               "an exported artifact pair through SymbolBlock.imports, which "
               "waits for sym_api.py (the symbolic graph API), ROADMAP Queue "
               "1 item 9; register a Gluon block, a torch.nn.Module or a "
               "batch function")


def _block_batch_fn(block):
    """Gluon block -> batch function over host arrays, as the JAX
    package's: the batch as an ``ndarray`` on the block's device, called
    outside ``autograd.record()`` (predict mode, nothing recorded), the
    (first) output back as a numpy array."""
    from ..ndarray import array

    def fn(batch_np):
        dev = next((p._var.device for p in block.collect_params().values()
                    if getattr(p, "_var", None) is not None), None)
        out = block(array(batch_np, ctx=dev))
        if isinstance(out, (list, tuple)):
            out = out[0]
        return out.asnumpy()
    return fn


def _module_batch_fn(module):
    """``torch.nn.Module`` -> batch function over host arrays: the batch
    as a tensor on the module's device, the (first) output back as a
    numpy array."""
    import torch

    def fn(batch_np):
        dev = getattr(module, "device", None)
        if dev is None:
            dev = next(module.parameters()).device
        with torch.no_grad():
            out = module(torch.as_tensor(batch_np, device=dev))
        if isinstance(out, (list, tuple)):
            out = out[0]
        return out.detach().cpu().numpy()
    return fn


class ServedModel:
    """One (name, version) entry: batch fn + signature + buckets."""

    def __init__(self, name, fn, version=1, item_shape=None,
                 dtype="float32", max_batch_size=32, buckets=None):
        self.name = name
        self.version = int(version)
        self.fn = fn
        self.item_shape = tuple(item_shape) if item_shape is not None else None
        self.dtype = str(dtype)
        if buckets:
            self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        else:
            self.buckets = default_buckets(int(max_batch_size))
        self.max_batch_size = self.buckets[-1]
        self.loaded_at = time.time()
        self.warmed = False

    # -- admission-side validation ---------------------------------------
    def check_item(self, item):
        """Validate/coerce ONE request item to (item_shape, dtype)."""
        arr = onp.asarray(item)
        try:
            arr = arr.astype(self.dtype, copy=False)
        except (TypeError, ValueError) as e:
            raise BadRequestError(
                "model %r expects dtype %s: %s" % (self.name, self.dtype, e))
        if self.item_shape is not None and tuple(arr.shape) != self.item_shape:
            raise BadRequestError(
                "model %r expects item shape %s, got %s"
                % (self.name, self.item_shape, tuple(arr.shape)))
        return arr

    # -- bucketing / execution -------------------------------------------
    def bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def run_batch(self, batch_np):
        """Pad to the enclosing bucket, execute, slice padding back off.

        Returns ``(outputs, bucket, seconds)`` where outputs has the REAL
        batch size and ``seconds`` is the batch function's wall time
        (through its copy of the outputs to the host).  Padding rows are
        zeros — per-item independence is the serving contract."""
        n = batch_np.shape[0]
        bucket = self.bucket_for(n)
        if bucket > n:
            pad = onp.zeros((bucket - n,) + batch_np.shape[1:],
                            dtype=batch_np.dtype)
            padded = onp.concatenate([batch_np, pad], axis=0)
        else:
            padded = batch_np
        t0 = time.perf_counter()
        out = self.fn(padded)
        dt = time.perf_counter() - t0
        return onp.asarray(out)[:n], bucket, dt

    def warmup(self):
        """Run every bucket once (zeros input), so serving never pays a
        first call.  Requires item_shape."""
        if self.item_shape is None:
            return 0
        for b in self.buckets:
            self.fn(onp.zeros((b,) + self.item_shape, dtype=self.dtype))
        self.warmed = True
        return len(self.buckets)

    def describe(self):
        return {"name": self.name, "version": self.version,
                "item_shape": (list(self.item_shape)
                               if self.item_shape is not None else None),
                "dtype": self.dtype, "buckets": list(self.buckets),
                "max_batch_size": self.max_batch_size,
                "warmed": self.warmed, "loaded_at": self.loaded_at}


class ModelRegistry:
    """Thread-safe multi-model, multi-version registry."""

    def __init__(self):
        maybe_enable_compile_cache()
        self._lock = threading.RLock()
        self._models = {}   # name -> {version: ServedModel}
        self._latest = {}   # name -> version

    def load(self, name, model, version=None, *, item_shape=None,
             dtype="float32", max_batch_size=32, buckets=None, warmup=True):
        """Register ``model`` (a Gluon block, a ``torch.nn.Module`` or
        ``fn(batch) -> batch``) as ``name``/``version`` (default: current
        latest + 1) and return the ``ServedModel``.  A Gluon block is
        hybridized and called with ``ndarray``s in predict mode, as in the
        JAX package.  With ``warmup`` every bucket runs here, before the
        version becomes routable (hot-swap safety)."""
        import torch
        if not callable(model):
            raise TypeError("model must be a Gluon block, a torch.nn.Module "
                            "or callable, got %r" % (type(model).__name__,))
        if hasattr(model, "collect_params"):
            if hasattr(model, "hybridize") and not getattr(
                    model, "_active", False):
                model.hybridize(active=True)
            fn = _block_batch_fn(model)
        elif isinstance(model, torch.nn.Module):
            fn = _module_batch_fn(model)
        else:
            fn = model
        with self._lock:
            if version is None:
                version = self._latest.get(name, 0) + 1
        served = ServedModel(name, fn, version=version, item_shape=item_shape,
                             dtype=dtype, max_batch_size=max_batch_size,
                             buckets=buckets)
        if warmup:
            served.warmup()  # outside the lock, before publishing
        with self._lock:
            self._models.setdefault(name, {})[served.version] = served
            if served.version >= self._latest.get(name, 0):
                self._latest[name] = served.version  # atomic traffic flip
        return served

    def load_checkpoint(self, name, symbol_file, param_file=None, **kwargs):
        """The JAX package registers an exported artifact pair through
        ``SymbolBlock.imports`` (ROADMAP Queue 1 item 9)."""
        raise NotImplementedError(_CHECKPOINT)

    def get(self, name, version=None):
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFoundError("no model %r (have: %s)"
                                         % (name, sorted(self._models)))
            if version is None:
                version = self._latest[name]
            served = versions.get(int(version))
            if served is None:
                raise ModelNotFoundError(
                    "model %r has no version %s (have: %s)"
                    % (name, version, sorted(versions)))
            return served

    def latest_version(self, name):
        with self._lock:
            if name not in self._latest:
                raise ModelNotFoundError("no model %r" % (name,))
            return self._latest[name]

    def unload(self, name, version=None):
        """Remove one version (or the whole model when version=None)."""
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise ModelNotFoundError("no model %r" % (name,))
            if version is None:
                del self._models[name]
                del self._latest[name]
                return
            if int(version) not in versions:
                raise ModelNotFoundError("model %r has no version %s"
                                         % (name, version))
            del versions[int(version)]
            if not versions:
                del self._models[name]
                del self._latest[name]
            elif self._latest[name] == int(version):
                self._latest[name] = max(versions)

    def models(self):
        """{name: {"latest": v, "versions": {v: describe()}}}"""
        with self._lock:
            return {
                name: {"latest": self._latest[name],
                       "versions": {v: m.describe()
                                    for v, m in versions.items()}}
                for name, versions in self._models.items()
            }

    def __contains__(self, name):
        with self._lock:
            return name in self._models
