"""gluon.Parameter (the port of ``mxnet_tpu/gluon/parameter.py``; parity:
reference ``python/mxnet/gluon/parameter.py``).

A :class:`Parameter` owns one torch leaf, an ``nn.Parameter``, from its
initialisation on.  Until then it holds only its shape, which may have
unknown (0) dims: a layer built without its input size finishes the
shape at its first forward (deferred initialisation).

Every block that the parameter is set on as an attribute registers the
leaf in its ``_parameters`` under the attribute's name, so
``named_parameters()`` gives the leaves under the names that
``collect_params()`` gives the parameters (``features.0.weight``).

- ``data()`` is an ``ndarray`` over the leaf itself, not a copy; writing
  into it (``p.data()[:] = 0``, ``+=``, ``copyto``) writes into the leaf
  in place (:class:`_ParamView`), where another ``ndarray`` rebinds.
- ``grad()`` is an ``ndarray`` over the leaf's ``.grad`` (zeros when no
  backward has written one), written through in the same way.
- ``grad_req`` ``"write"`` and ``"add"`` make the leaf require a
  gradient, ``"null"`` does not.  An ``ndarray`` backward
  (``autograd.backward``) writes or adds per ``grad_req``; a torch
  ``backward()`` adds, as torch does, and ``Trainer.step`` hands a
  ``"write"`` parameter's gradient back as ``None`` once applied, so the
  next backward writes; ``grad()`` and the next step still read the
  applied gradient until a backward writes a new one.

A parameter stands in for its leaf where torch expects a tensor, as
the port's layers' attributes were tensors before: torch functions take
it (``__torch_function__``), ``==`` and ``!=`` against a tensor or a
number compare the leaf's values, and tensor attributes (``copy_``,
``device``, ``reshape``) are the leaf's.  ``p.leaf`` is the leaf
itself.
"""
from __future__ import annotations

import weakref

import numpy as onp
import torch
from torch.utils.weak import WeakTensorKeyDictionary

from .. import autograd
from .. import context as _context
from ..ndarray import ndarray, _to_tensor, torch_dtype, numpy_dtype

__all__ = ["Parameter", "Constant", "DeferredInitializationError"]


class DeferredInitializationError(Exception):
    pass


def _shape_is_known(shape):
    if shape is None:
        return False
    return all(s is not None and s > 0 for s in shape)


# A "write" gradient that a Trainer step applied, by leaf: still the
# parameter's gradient (grad(), the next step) while leaf.grad is None, so
# that the next torch backward writes a new one; dropped as soon as a
# backward writes the leaf's next gradient (a post-accumulate hook, or an
# ndarray backward's write), so the old and new gradients of a leaf are
# not both held past that point.
_SPENT = WeakTensorKeyDictionary()
_HOOKED = WeakTensorKeyDictionary()


def _drop_spent(leaf):
    _SPENT.pop(leaf, None)


class _ParamView(ndarray):
    """An ``ndarray`` over a parameter's leaf (or its gradient): a new
    value is written into the tensor in place, under ``no_grad``, so the
    view never leaves the leaf; an ``ndarray`` backward writes the leaf's
    gradient into ``leaf.grad``."""

    __slots__ = ()

    def _set_data(self, data):
        with torch.no_grad():
            t = self._data
            t.copy_(torch.broadcast_to(data.detach().to(t.dtype), t.shape))

    def _write_grad(self, g):
        leaf = self._data
        if self._grad_req == "add" and leaf.grad is not None:
            leaf.grad.add_(g)
        else:
            leaf.grad = g.detach()
        _SPENT.pop(leaf, None)

    @property
    def grad(self):
        g = self._data.grad
        return None if g is None else _view(g)

    def attach_grad(self, grad_req="write"):
        self._grad_req = grad_req
        self._data.requires_grad_(grad_req != "null")
        self._data.grad = torch.zeros_like(self._data)

    def zero_grad(self):
        if self._data.grad is not None:
            self._data.grad.zero_()


def _view(t, leaf=False, grad_req="write"):
    v = ndarray.__new__(_ParamView)
    v._data = t
    v._marked = leaf
    v._grad = None
    v._grad_req = grad_req
    if leaf:
        autograd._register_leaf(v)
    return v


def _register(block, attr, leaf):
    """``block._parameters[attr] = leaf``, kept in the order of the
    block's Gluon parameters (so ``named_parameters()`` lists them as
    ``collect_params()`` does)."""
    params = block._parameters
    params[attr] = leaf
    order = [k for k in block._reg_params if k in params]
    if list(params)[:len(order)] != order:
        rest = [(k, v) for k, v in params.items() if k not in order]
        params.clear()
        for k in order:
            params[k] = block._reg_params[k]._var
        params.update(rest)


def _dtype_name(dtype):
    if dtype in (torch.bfloat16, "bfloat16"):
        return "bfloat16"
    if isinstance(dtype, torch.dtype):
        return str(numpy_dtype(dtype))
    return onp.dtype(dtype).name


def _unwrap_params(x):
    if isinstance(x, Parameter):
        return x.leaf
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap_params(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap_params(v) for k, v in x.items()}
    return x


class Parameter:
    """A learnable tensor of a block (see the module docstring)."""

    def __init__(self, name="weight", grad_req="write", shape=None,
                 dtype=onp.float32, lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._name = name
        self._shape = (tuple(shape) if isinstance(shape, (tuple, list))
                       else (shape,) if shape is not None else None)
        self._dtype = _dtype_name(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        self._stype = stype
        self._grad_stype = grad_stype
        self._var = None
        self._nd = None
        self._deferred_init = None          # (initializer, device)
        self._owners = []                   # [(weakref(block), attr name)]
        self._structure_name = None

    # -- names, shape, dtype ------------------------------------------------
    @property
    def name(self):
        return self._structure_name or self._name

    @name.setter
    def name(self, v):
        self._name = v

    @property
    def shape(self):
        if self._var is not None:
            return tuple(self._var.shape)
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        unknown_ok = all(s1 in (0, -1, None) or s1 == s2
                         for s1, s2 in zip(self._shape, new_shape))
        if not (len(self._shape) == len(new_shape) and unknown_ok):
            raise AssertionError(
                "Expected shape %s is incompatible with given shape %s for "
                "Parameter %s" % (str(new_shape), str(self._shape), self.name))
        self._shape = new_shape

    @property
    def dtype(self):
        if self._dtype == "bfloat16":
            return torch.bfloat16
        return onp.dtype(self._dtype)

    @dtype.setter
    def dtype(self, d):
        self._dtype = _dtype_name(d)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null, got %r"
                             % (req,))
        if not self._differentiable:
            req = "null"
        self._grad_req = req
        if self._var is not None:
            self._var.requires_grad_(req != "null")
            if req == "null":
                self._var.grad = None
                _SPENT.pop(self._var, None)
        if self._nd is not None:
            self._nd._grad_req = req

    @property
    def leaf(self):
        """The ``nn.Parameter`` that holds the value."""
        if self._var is None:
            self._raise_uninitialized()
        return self._var

    # -- registration on blocks --------------------------------------------
    def _attach(self, block, attr):
        self._owners.append((weakref.ref(block), attr))
        if self._var is not None:
            _register(block, attr, self._var)

    def _set_leaf(self, t):
        """Make ``t`` (a tensor) this parameter's leaf and register it on
        every owning block."""
        leaf = torch.nn.Parameter(t.detach(),
                                  requires_grad=self._grad_req != "null")
        self._var = leaf
        # the ndarray view is an autograd leaf from the start, so an
        # ndarray backward reaches the parameter whether or not data()
        # was called
        self._nd = _view(leaf, leaf=True, grad_req=self._grad_req)
        self._shape = tuple(leaf.shape)
        self._deferred_init = None
        alive = []
        for ref, attr in self._owners:
            blk = ref()
            if blk is not None and blk.__dict__.get(attr) is self:
                _register(blk, attr, leaf)
                alive.append((ref, attr))
        self._owners = alive

    @classmethod
    def _from_leaf(cls, leaf, name="param"):
        """A parameter over an existing ``nn.Parameter`` (a torch module's
        leaf handed to ``Trainer``)."""
        p = cls(name, grad_req="write" if leaf.requires_grad else "null",
                shape=tuple(leaf.shape), dtype=leaf.dtype)
        p._var = leaf
        p._nd = _view(leaf, leaf=True, grad_req=p._grad_req)
        return p

    # -- initialisation ------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, device=None):
        """Fill the parameter with ``init`` (else its own ``init``, else
        ``default_init``, else ``Uniform()``) on ``device``
        (``context.resolve``: ``cuda`` unless the CPU is asked for); an
        unknown shape defers it to the first forward."""
        from .. import initializer as _init
        dev = ctx if ctx is not None else device
        if isinstance(dev, (list, tuple)):
            dev = dev[0] if dev else None
        if self._var is not None and not force_reinit:
            return
        dev = _context.resolve(dev)
        initializer = init or self.init or default_init or _init.Uniform()
        if not _shape_is_known(self._shape):
            if not self.allow_deferred_init:
                raise ValueError(
                    "Cannot initialize Parameter %s: unknown shape %s and "
                    "deferred init not allowed" % (self.name, self._shape))
            self._deferred_init = (initializer, dev)
            return
        self._finish_init(initializer, dev)

    def _finish_init(self, initializer, dev):
        from .. import initializer as _init
        if isinstance(initializer, str):
            initializer = _init.create(initializer)
        t = torch.zeros(self._shape, dtype=torch_dtype(self._dtype),
                        device=dev)
        initializer(_init.InitDesc(self.name), t)
        var = self._var
        if var is not None and var.shape == t.shape and var.device == dev:
            with torch.no_grad():       # force_reinit keeps the same leaf
                var.copy_(t.to(var.dtype))
            return
        self._set_leaf(t)

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not _shape_is_known(self._shape):
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s at first forward"
                % (self.name, self._shape))
        initializer, dev = self._deferred_init
        self._finish_init(initializer, dev)

    def shape_and_init(self, inferred_shape):
        """Finish the shape at a layer's first forward, and the deferred
        initialisation with it."""
        self.shape = inferred_shape
        if self._deferred_init is not None:
            self._finish_deferred_init()

    def _raise_uninitialized(self):
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                "Parameter %s has not been initialized yet (deferred "
                "shape); run a forward pass first" % self.name)
        raise RuntimeError("Parameter %s has not been initialized. Call "
                           ".initialize()" % self.name)

    # -- data and gradient ---------------------------------------------------
    def data(self, ctx=None):
        if self._var is None:
            self._raise_uninitialized()
        return self._nd

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        return [self._var.device] if self._var is not None else []

    def set_data(self, data, device=None):
        """Write ``data`` (an ndarray, tensor or array-like) into the
        parameter in place; an uninitialised parameter is made from it, on
        ``device``, its deferred device, or ``data``'s own."""
        if self._var is None:
            if device is None and self._deferred_init is not None:
                device = self._deferred_init[1]
            if device is None and isinstance(data, (ndarray, torch.Tensor)):
                device = data.device if isinstance(data, torch.Tensor) \
                    else data._data.device
            t = _to_tensor(data, dtype=self._dtype,
                           device=_context.resolve(device))
            self.shape = tuple(t.shape)
            self._set_leaf(t.clone())
            return
        with torch.no_grad():
            src = _to_tensor(data, device=self._var.device)
            self._var.copy_(src.reshape(self._var.shape).to(self._var.dtype))

    def grad(self, ctx=None):
        leaf = self.leaf
        if self._grad_req == "null":
            raise RuntimeError("Cannot get gradient of Parameter %s: "
                               "grad_req='null'" % self.name)
        return _view(self._current_grad())

    def _current_grad(self):
        """The gradient a step applies: the leaf's, else the one the last
        step applied (a "write" gradient no backward has written since),
        else zeros, as in the JAX package."""
        leaf = self.leaf
        if leaf.grad is not None:
            return leaf.grad
        spent = _SPENT.get(leaf)
        if spent is not None:
            return spent
        leaf.grad = torch.zeros_like(leaf)
        return leaf.grad

    def _spend_grad(self):
        """After a step: hand a "write" gradient back as ``None`` (the next
        torch backward writes, not adds) and keep it as the gradient until
        a backward writes the leaf's next one."""
        leaf = self._var
        if self._grad_req == "write" and leaf.grad is not None:
            if leaf not in _HOOKED:
                leaf.register_post_accumulate_grad_hook(_drop_spent)
                _HOOKED[leaf] = True
            _SPENT[leaf] = leaf.grad
            leaf.grad = None

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._var is not None and self._var.grad is not None:
            self._var.grad.zero_()
        spent = _SPENT.get(self._var) if self._var is not None else None
        if spent is not None:
            spent.zero_()

    def reset_ctx(self, ctx):
        """Move the leaf to ``ctx`` in place (the same ``nn.Parameter``)."""
        dev = _context.resolve(ctx)
        if self._var is not None:
            with torch.no_grad():
                self._var.data = self._var.data.to(dev)
                if self._var.grad is not None:
                    self._var.grad = self._var.grad.to(dev)
                if self._var in _SPENT:
                    _SPENT[self._var] = _SPENT[self._var].to(dev)
        elif self._deferred_init is not None:
            self._deferred_init = (self._deferred_init[0], dev)

    reset_device = reset_ctx

    def cast(self, dtype):
        """Cast the value (and a gradient) in place: the leaf stays the
        same object."""
        self._dtype = _dtype_name(dtype)
        if self._var is not None:
            td = torch_dtype(self._dtype)
            with torch.no_grad():
                self._var.data = self._var.data.to(td)
                if self._var.grad is not None:
                    self._var.grad = self._var.grad.to(td)
                if self._var in _SPENT:
                    _SPENT[self._var] = _SPENT[self._var].to(td)

    def var(self):
        return self.data()

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, self._dtype)

    # -- the leaf's stand-in -------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_unwrap_params(args), **_unwrap_params(kwargs or {}))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        var = self.__dict__.get("_var")
        if var is None:
            raise AttributeError(
                "Parameter %s has no attribute %r (and no value yet)"
                % (self.__dict__.get("_name"), name))
        return getattr(var, name)

    def __eq__(self, other):
        if isinstance(other, Parameter):
            return self is other
        return self.leaf == other

    def __ne__(self, other):
        if isinstance(other, Parameter):
            return self is not other
        return self.leaf != other

    __hash__ = object.__hash__


class Constant(Parameter):
    """A parameter that holds a constant and takes no gradient (reference
    gluon ``Constant``)."""

    def __init__(self, value, name="const"):
        from .. import initializer as _init
        if isinstance(value, ndarray):
            value = value._data
        if not isinstance(value, torch.Tensor):
            value = _to_tensor(value, device="cpu")
        self.value = value
        super().__init__(name=name, grad_req="null",
                         shape=tuple(value.shape), dtype=value.dtype,
                         init=_init.Constant(value))

    @property
    def grad_req(self):
        return "null"

    @grad_req.setter
    def grad_req(self, req):
        if req != "null":
            raise ValueError("Constant %s takes no gradient" % self.name)
        self._grad_req = "null"
