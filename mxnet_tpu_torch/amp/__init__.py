"""Automatic mixed precision (the port of ``mxnet_tpu/amp/``; parity:
``python/mxnet/amp/``).

bf16 first: ``convert_hybrid_block(net, "bfloat16")`` returns a wrapper
whose forward opens the op-list scope of ``ops/nn.py``: the ops of
``lists.TARGET_DTYPE_OPS`` (matmuls, flash attention, the fused
epilogues) cast their operands to bf16, the parameters stay fp32 master
copies (autograd carries the gradients back through the casts), and the
outputs return in fp32.  bf16 has fp32's exponent range, so it needs no
loss scaling; ``init("float16")`` + ``init_trainer`` attach the dynamic
:class:`LossScaler` for fp16, as the JAX package does.
"""
from __future__ import annotations

import contextlib
import warnings

import torch

from ..ops import nn as _ops_nn
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "lists", "LossScaler"]

_TARGET = None
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _dtype(target_dtype):
    if isinstance(target_dtype, torch.dtype):
        return target_dtype
    try:
        return _DTYPES[str(target_dtype)]
    except KeyError:
        raise ValueError("amp: unsupported target dtype %r"
                         % (target_dtype,)) from None


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Set AMP's target dtype (reference ``amp.py:308``); the casting
    itself is ``convert_hybrid_block``'s."""
    global _TARGET
    _TARGET = _dtype(target_dtype)


def init_trainer(trainer):
    """Attach a :class:`LossScaler` to ``trainer`` when the target is fp16
    (reference ``amp.py:374``); bf16 needs none."""
    if _TARGET == torch.float16:
        trainer._amp_loss_scaler = LossScaler()
    return trainer


def scale_loss(loss, trainer):
    """A context manager yielding ``loss`` times the trainer's loss scale
    (``loss`` itself without a scaler)."""
    scaler = trainer._amp_loss_scaler
    scaled = loss if scaler is None else loss * scaler.loss_scale

    @contextlib.contextmanager
    def ctx():
        yield scaled

    return ctx()


def unscale(trainer):
    """Divide every gradient of the trainer's parameters by its loss
    scale, in place (nothing without a scaler)."""
    scaler = trainer._amp_loss_scaler
    if scaler is not None:
        for p in trainer._params:
            if p.grad is not None:
                p.grad.div_(scaler.loss_scale)


def convert_hybrid_block(block, target_dtype="bfloat16",
                         target_dtype_ops=None, fp32_ops=None,
                         conditional_fp32_ops=None, excluded_sym_names=None,
                         device=None, cast_params_offline=False):
    """Convert an ``nn.Module`` for mixed precision (reference
    ``amp.py:670``).

    Returns an :class:`_AmpWrapper`: the parameters stay fp32 and the
    scope's ops (``lists.TARGET_DTYPE_OPS`` plus ``target_dtype_ops``,
    less ``fp32_ops``) compute in ``target_dtype``.
    ``excluded_sym_names`` are module paths (``"encoder.layers.0"``)
    whose forward runs with the scope suspended, in fp32.  With
    ``cast_params_offline=True`` the parameters themselves are cast
    (inference) and ``block`` is returned."""
    if isinstance(block, _AmpWrapper):
        block = block._block
    dt = _dtype(target_dtype)
    if cast_params_offline:
        block.to(dt)
        return block
    opset = set(lists.TARGET_DTYPE_OPS) | set(target_dtype_ops or [])
    opset -= set(fp32_ops or [])
    # always (re)attach, so a convert without exclusions clears the hooks
    # of an earlier one on the same block
    _attach_exclusions(block, set(excluded_sym_names or []))
    return _AmpWrapper(block, dt, frozenset(opset))


def _attach_exclusions(block, names):
    for h in getattr(block, "_amp_exclusion_handles", ()):
        h.remove()
    handles = []
    block._amp_exclusion_handles = handles
    matched = set()
    for path, mod in block.named_modules():
        if path not in names:
            continue
        matched.add(path)
        saved = []

        def pre(mod, inputs, saved=saved):
            # a raised forward can strand an entry: start clean
            saved.clear()
            saved.append(_ops_nn._amp_state())
            _ops_nn._amp_set(None)

        def post(mod, inputs, output, saved=saved):
            _ops_nn._amp_set(saved.pop() if saved else None)

        handles.append(mod.register_forward_pre_hook(pre))
        handles.append(mod.register_forward_hook(post))
    unmatched = names - matched
    if unmatched:
        warnings.warn("excluded_sym_names not found in the module tree: %s"
                      % sorted(unmatched))


def _to_fp32(out):
    if isinstance(out, torch.Tensor):
        return out.float() if out.is_floating_point() else out
    if isinstance(out, (list, tuple)):
        return type(out)(_to_fp32(o) for o in out)
    return out


class _AmpWrapper:
    """A module under AMP: calling it opens the op-list scope around the
    module's forward and returns floating outputs in fp32.  Every other
    attribute is the module's (``parameters()``, ``train()``, ...)."""

    def __init__(self, block, dtype, opset):
        self._block = block
        self._dtype = dtype
        self._opset = opset

    def __getattr__(self, name):
        return getattr(self._block, name)

    def __call__(self, *args, **kwargs):
        prev = _ops_nn._amp_state()
        _ops_nn._amp_set((self._dtype, self._opset))
        try:
            out = self._block(*args, **kwargs)
        finally:
            _ops_nn._amp_set(prev)
        return _to_fp32(out)
