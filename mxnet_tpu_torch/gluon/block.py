"""gluon.Block / HybridBlock (the port of ``mxnet_tpu/gluon/block.py``;
parity: reference ``python/mxnet/gluon/block.py`` Block :203,
HybridBlock :998).

A :class:`Block` is a ``torch.nn.Module``.  Child blocks are its
modules (``_children`` is ``_modules``); a :class:`Parameter` set as an
attribute is kept in ``_reg_params`` and its leaf in ``_parameters``
(``gluon/parameter.py``).  Forward hooks and pre-hooks are torch's, whose
signatures are Gluon's (``hook(block, inputs[, output])``); the handles
have ``detach()``.

Two calling conventions, one set of layers:

- called with ``ndarray``s, a block gets and returns ``ndarray``s and its
  ops record per ``autograd.record()``: the JAX package's contract, so a
  user's ``forward`` written on ``mx.np``/``mx.npx`` runs unchanged.
  The built-in layers run their torch code once through
  ``ndarray.apply_op``.  The training flag is ``autograd.is_training()``.
- called with torch tensors, a block returns torch tensors with no
  ``ndarray`` dispatch on the way.  The training flag is
  ``Module.training`` (``.train()``/``.eval()``), as torch modules read
  it.

A built-in layer inside a built-in layer called with ``ndarray``s (an
RNN layer's cells, a modifier cell's base cell) sees the outer call's
flag.

``hybridize()`` records its flags and runs eagerly: the port captures no
graph (CUDA graphs are a later lever).  ``export``, ``to_sym``,
``optimize_for`` and ``SymbolBlock`` need ``sym_api.py`` (ROADMAP Queue
1 item 9) and raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import numpy as onp
import torch

from .. import autograd
from .._unported import _Unported
from ..ndarray import ndarray, apply_op, _unwrap_deep
from .parameter import Parameter, DeferredInitializationError  # noqa: F401

__all__ = ["Block", "HybridBlock", "SymbolBlock"]

_ITEM9 = "sym_api.py (the symbolic graph API)"
SymbolBlock = _Unported("mx.gluon.SymbolBlock", 9, _ITEM9)

_FLAG = threading.local()


def _flag(block):
    """The training flag of a built-in layer's torch code: the ``ndarray``
    call's around it, else its own ``Module.training``."""
    f = getattr(_FLAG, "train", None)
    return block.training if f is None else f


def _nd_mode():
    """True inside a built-in layer's torch code run for an ``ndarray``
    call."""
    return getattr(_FLAG, "train", None) is not None


def _is_nd(args):
    for a in args:
        if isinstance(a, ndarray):
            return True
        if isinstance(a, (list, tuple)) and a and isinstance(a[0], ndarray):
            return True
    return False


def _nd_call(fn, args, kwargs):
    """Run torch code ``fn(training, *tensors, **kw)`` for ``ndarray``
    arguments: once through ``apply_op``, with autograd's training flag."""
    train = autograd.is_training()

    def run(*ts, **kw):
        prev = getattr(_FLAG, "train", None)
        _FLAG.train = train
        try:
            return fn(train, *ts, **kw)
        finally:
            _FLAG.train = prev

    return apply_op(run, *args, **_unwrap_deep(kwargs))


def _flatten_arrays(obj, out):
    if isinstance(obj, (ndarray, torch.Tensor)):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _flatten_arrays(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _flatten_arrays(o, out)


class _HookHandle:
    """A hook's handle: ``detach()`` (Gluon) or ``remove()`` (torch)."""

    def __init__(self, handle):
        self._handle = handle

    def detach(self):
        self._handle.remove()

    remove = detach


class _OpHookHandle:
    """Detaches a ``register_op_hook`` group in one call."""

    def __init__(self, handles):
        self._handles = handles

    def detach(self):
        for h in self._handles:
            h.detach()
        self._handles = []


class Block(torch.nn.Module):
    """Base container (reference block.py:203); see the module
    docstring for the two calling conventions."""

    def __init__(self):
        super().__init__()
        object.__setattr__(self, "_reg_params", OrderedDict())

    # -- attribute registration ------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            regs = self.__dict__.get("_reg_params")
            if regs is None:
                raise AttributeError("Block.__init__ must run before a "
                                     "Parameter is set")
            self._parameters.pop(name, None)
            regs[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            return
        regs = self.__dict__.get("_reg_params")
        if regs is not None and name in regs:
            del regs[name]
            self._parameters.pop(name, None)
            object.__delattr__(self, name)
        super().__setattr__(name, value)

    def __delattr__(self, name):
        regs = self.__dict__.get("_reg_params")
        if regs is not None and name in regs:
            del regs[name]
            self._parameters.pop(name, None)
            object.__delattr__(self, name)
            return
        super().__delattr__(name)

    @property
    def _children(self):
        return self._modules

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._modules))
        self.add_module(name, block)

    # -- parameter collection --------------------------------------------
    def collect_params(self, select=None):
        """``{structural name: Parameter}`` of this block and its children
        (attribute paths such as ``features.0.weight``); ``select`` is a
        regular expression the names must match."""
        out = OrderedDict()

        def walk(block, prefix):
            for pname, p in getattr(block, "_reg_params", {}).items():
                full = prefix + "." + pname if prefix else pname
                p._structure_name = full
                out[full] = p
            for cname, child in block._modules.items():
                if child is not None:
                    walk(child, prefix + "." + cname if prefix else cname)

        walk(self, "")
        if select is not None:
            pat = re.compile(select)
            out = OrderedDict((k, v) for k, v in out.items() if pat.match(k))
        return out

    @property
    def params(self):
        return self.collect_params()

    # -- initialization ---------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, device=None):
        """Initialise every parameter: its own ``init``, else ``init``
        (default ``Uniform()``), on ``device`` (``cuda`` unless the CPU is
        asked for); unknown shapes finish at the first forward."""
        from .. import initializer as _initmod
        init = init or _initmod.Uniform()
        for p in self.collect_params().values():
            p.initialize(init=p.init, ctx=ctx if ctx is not None else device,
                         default_init=init, force_reinit=force_reinit)

    def setattr(self, name, value):
        for p in self.collect_params().values():
            setattr(p, name, value)

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        self._on_cast(dtype)
        return self

    def _on_cast(self, dtype):
        for c in self._modules.values():
            if isinstance(c, Block):
                c._on_cast(dtype)

    def reset_ctx(self, ctx):
        for p in self.collect_params().values():
            p.reset_ctx(ctx)

    reset_device = reset_ctx

    def zero_grad(self, set_to_none=False):
        for p in self.collect_params().values():
            p.zero_grad()

    # -- hooks -------------------------------------------------------------
    def register_forward_hook(self, hook, **kwargs):
        return _HookHandle(super().register_forward_hook(hook, **kwargs))

    def register_forward_pre_hook(self, hook, **kwargs):
        return _HookHandle(super().register_forward_pre_hook(hook, **kwargs))

    def register_op_hook(self, callback, monitor_all=False):
        """Call ``callback(name, op_name, array)`` on every child block's
        outputs (and inputs with ``monitor_all``) at each forward; the
        monitored unit is the child block, as in the JAX package.
        Returns one handle; ``detach()`` it to stop."""
        handles = []

        def attach(blk, path):
            def fwd_hook(b, inputs, output, _path=path):
                outs = output if isinstance(output, (list, tuple)) \
                    else [output]
                for i, o in enumerate(outs):
                    if o is not None and hasattr(o, "shape"):
                        callback("%s_output%d" % (_path, i),
                                 type(b).__name__, o)
                if monitor_all:
                    for i, a in enumerate(inputs):
                        if hasattr(a, "shape"):
                            callback("%s_input%d" % (_path, i),
                                     type(b).__name__, a)
            handles.append(blk.register_forward_hook(fwd_hook))
            for cname, child in blk._modules.items():
                if isinstance(child, Block):
                    attach(child, "%s.%s" % (path, cname) if path else cname)

        attach(self, "")
        return _OpHookHandle(handles)

    # -- serialization -----------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Save the initialised parameters as ``.npz`` under their
        structural names: the JAX package's format, read by either
        package's ``load_parameters`` (bfloat16 values are saved as
        float32, which numpy can hold)."""
        arrays = {}
        for name, p in self.collect_params().items():
            if p._var is not None:
                t = p._var.detach()
                if t.dtype == torch.bfloat16:
                    t = t.float()
                arrays[name] = t.cpu().numpy()
        with open(filename, "wb") as f:
            onp.savez(f, **arrays)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current", device=None):
        """Load an ``.npz`` of ``save_parameters`` (this package's or the
        JAX package's) into the parameters, in place; an uninitialised
        parameter is made on ``device`` (``cuda`` unless the CPU is asked
        for)."""
        loaded = dict(onp.load(filename))
        params = self.collect_params()
        dev = ctx if ctx is not None else device
        for name, p in params.items():
            key = name if name in loaded else name + ":0"
            if key not in loaded:
                if not allow_missing:
                    raise ValueError("Parameter %s missing in file %s"
                                     % (name, filename))
                continue
            arr = loaded[key]
            if cast_dtype and dtype_source == "saved":
                p.dtype = arr.dtype
            p.set_data(arr, device=dev)
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise ValueError("file %s has extra parameters %s"
                                 % (filename, sorted(extra)))

    def save(self, prefix):
        self.save_parameters(prefix + "-model.params.npz")

    def load(self, prefix, device=None):
        self.load_parameters(prefix + "-model.params.npz", device=device)

    def hybridize(self, active=True, **kwargs):
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def summary(self, *inputs):
        """Print each block's output shapes and parameter count for a
        forward of ``inputs`` (reference ``Block.summary``)."""
        rows = []

        def hook(block, _, out):
            outs = []
            _flatten_arrays(out, outs)
            rows.append((type(block).__name__,
                         [tuple(o.shape) for o in outs],
                         sum(int(onp.prod(p.shape)) for p in
                             block._reg_params.values() if p.shape)))

        handles = []

        def attach(b):
            if isinstance(b, Block):
                handles.append(b.register_forward_hook(hook))

        self.apply(attach)
        try:
            self(*inputs)
        finally:
            for h in handles:
                h.detach()
        total = sum(int(onp.prod(p.shape)) for p in
                    self.collect_params().values() if p.shape)
        print("%-30s %-30s %s" % ("Layer", "Output shapes", "Params"))
        for name, shapes, n in rows:
            print("%-30s %-30s %d" % (name, shapes, n))
        print("Total params: %d" % total)
        return rows


class HybridBlock(Block):
    """A block with ``hybridize()`` (reference block.py:998).  The port
    runs every block eagerly: ``hybridize`` records its flags, and a
    hybridized block computes what it computes unhybridized."""

    def __init__(self):
        super().__init__()
        self._active = False
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Layers override it to finish deferred parameter shapes."""

    def export(self, path, epoch=0, remove_amp_cast=True):
        _Unported("HybridBlock.export", 9, _ITEM9)()

    def to_sym(self, input_shapes=None, input_dtypes=None):
        _Unported("HybridBlock.to_sym", 9, _ITEM9)()

    def optimize_for(self, x, *args, backend=None, clear=True, **kwargs):
        _Unported("HybridBlock.optimize_for", 9,
                  "sym_api.py and subgraph.py (backend partitioning)")()


class _Layer(HybridBlock):
    """A built-in layer: its computation is ``_forward(training, *tensors)``
    in torch; an ``ndarray`` call runs it once through ``apply_op``."""

    def forward(self, *args, **kwargs):
        if _is_nd(args):
            return _nd_call(self._forward, args, kwargs)
        return self._forward(_flag(self), *args, **kwargs)

    def _forward(self, training, *args, **kwargs):
        raise NotImplementedError


def eager_init(block, device):
    """With ``device``, initialise ``block``'s parameters there at
    construction: the port's earlier layers took ``device=`` and made
    their tensors at once (biases and betas 0, gammas 1, weights 0 until
    an initializer fills them), so every shape must be known.  Without
    it, only check that the default device exists (``context.resolve``
    raises without a GPU unless a CPU scope is open): ``initialize()``
    makes the parameters."""
    from .. import context as _context
    if device is None:
        _context.resolve(None)
        return
    from .. import initializer as _initmod
    for p in block.collect_params().values():
        if not all(s and s > 0 for s in (p._shape or (0,))):
            raise ValueError(
                "%s: parameter %s has unknown shape %s; give its input size "
                "(in_units, in_channels, input_size) with device=, or leave "
                "device= out and call initialize() for deferred shapes"
                % (type(block).__name__, p.name, p._shape))
        p.initialize(init=p.init or _initmod.Zero(), device=device)
