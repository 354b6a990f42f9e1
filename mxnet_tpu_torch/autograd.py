"""Imperative autograd: record scopes, gradients into ``.grad``, custom
functions (the port of ``mxnet_tpu/autograd.py``; parity: reference
``python/mxnet/autograd.py`` record :121, pause :145, backward :245).

Design: torch autograd is the tape.  ``ndarray`` ops run under
``torch.set_grad_enabled(is_recording())`` (``ndarray.apply_op``), so a
graph is built inside :func:`record` and nowhere else (not outside it,
not inside :func:`pause`).  ``attach_grad(grad_req)`` makes an array a
leaf (its tensor ``requires_grad``) and registers it here;
:func:`backward` takes the gradients of every live leaf with one
``torch.autograd.grad`` call and *writes* (``grad_req="write"``) or
*adds* (``"add"``) each into the leaf's own ``.grad`` array, which stays
the same object across calls (``"null"`` leaves are skipped).  There is
no second tape.

Errors kept from the JAX package: :func:`backward` on heads that no
recorded computation and no leaf stands behind raises ``ValueError``;
mutating an array that an op produced inside ``record()`` (``x[:] = ``,
``x += ``, ``copyto``) while recording raises ``RuntimeError``
(``ndarray._set_data``).

Training mode, one flag for each calling convention:

- ``record(train_mode=True)`` (and ``train_mode()``/``predict_mode()``)
  set :func:`is_training`.  The ``np``/``npx`` ops read it
  (``npx.dropout`` is the identity outside training, ``npx.batch_norm``
  uses batch statistics inside it), and so does every Gluon block called
  with ``ndarray``s, as in the JAX package and MXNet.
- A Gluon block called with torch tensors reads ``Module.training``,
  which ``.train()`` and ``.eval()`` set, as torch modules do.

Neither flag sets the other (``gluon/block.py``; held by
``tests/test_torch_autograd.py::test_train_mode_and_module_flag``).  A
gradient of a Gluon parameter's leaf goes to the leaf's ``.grad``
(``gluon.parameter._ParamView``), per its ``grad_req``.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "Function", "get_symbol",
           "register_grad_ready_hook", "remove_grad_ready_hook"]

_STATE = threading.local()


def _st():
    if not hasattr(_STATE, "recording"):
        _STATE.recording = False
        _STATE.training = False
    return _STATE


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    st = _st()
    prev = st.recording
    st.recording = bool(is_record)
    return prev


def set_training(train_mode):
    st = _st()
    prev = st.training
    st.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    """Flips (recording, training) for a ``with`` block (reference
    ``_RecordingStateScope``, ``python/mxnet/autograd.py:33``)."""

    def __init__(self, is_record, train_mode):
        self._rec = is_record
        self._train = train_mode
        self._prev = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        st = _st()
        st.recording, st.training = self._prev
        return False


def record(train_mode=True):
    """Record the ops run inside the scope (and set the training flag)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------
_LEAVES = {}          # id(arr) -> weakref(arr), every array attach_grad made
_LEAVES_LOCK = threading.Lock()


def _register_leaf(arr):
    key = id(arr)
    with _LEAVES_LOCK:
        ref = _LEAVES.get(key)
        if ref is None or ref() is not arr:
            _LEAVES[key] = weakref.ref(
                arr, lambda _r, k=key: _LEAVES.pop(k, None))


def _live_leaves():
    with _LEAVES_LOCK:
        refs = list(_LEAVES.values())
    out = []
    for r in refs:
        a = r()
        if a is not None and a._marked and a._data.requires_grad:
            out.append(a)
    return out


_GRAD_READY_HOOKS = {}  # id(arr) -> (weakref(arr), [callbacks])


def register_grad_ready_hook(arr, fn):
    """Call ``fn(arr)`` each time a backward pass has written ``arr``'s
    gradient (per its grad_req).  Returns a handle for
    :func:`remove_grad_ready_hook`.  Here every leaf's gradient is final
    when the one ``torch.autograd.grad`` call returns, so the hooks fire
    then, in the order the leaves were marked."""
    key = id(arr)
    entry = _GRAD_READY_HOOKS.get(key)
    if entry is None or entry[0]() is not arr:
        ref = weakref.ref(arr, lambda _r, k=key: _GRAD_READY_HOOKS.pop(k, None))
        entry = (ref, [])
        _GRAD_READY_HOOKS[key] = entry
    entry[1].append(fn)
    return (key, fn)


def remove_grad_ready_hook(handle):
    key, fn = handle
    entry = _GRAD_READY_HOOKS.get(key)
    if entry is not None:
        try:
            entry[1].remove(fn)
        except ValueError:
            pass
        if not entry[1]:
            _GRAD_READY_HOOKS.pop(key, None)


def _fire_grad_ready(arr):
    entry = _GRAD_READY_HOOKS.get(id(arr))
    if entry is not None and entry[0]() is arr:
        for fn in list(entry[1]):
            fn(arr)


def _heads(heads, head_grads):
    """(output tensors, their seeds) of the heads that a recorded op or a
    leaf stands behind; ValueError when none does."""
    from .ndarray import ndarray, _to_tensor
    if isinstance(heads, ndarray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, ndarray):
        head_grads = [head_grads]
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue
        outs.append(t)
        seeds.append(torch.ones_like(t) if hg is None
                     else _to_tensor(hg, dtype=t.dtype, device=t.device))
    if not outs:
        raise ValueError(
            "cannot differentiate: outputs are not connected to any "
            "recorded computation (did you forget autograd.record()?)")
    return outs, seeds


def _write_leaf_grad(arr, g):
    """Write one leaf's gradient per its grad_req into ``arr.grad`` (the
    same array object attach_grad made).  True when written."""
    from .ndarray import _wrap
    req = arr._grad_req
    if req == "null":
        return False
    g = g.to(arr._data.dtype)
    write = getattr(arr, "_write_grad", None)
    if write is not None:           # a gluon Parameter's leaf: leaf.grad
        write(g)
        return True
    if arr._grad is None:
        arr._grad = _wrap(g)
    elif req == "add":
        arr._grad._data = arr._grad._data + g
    else:
        arr._grad._data = g
    return True


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Gradients of ``heads`` with respect to every ``attach_grad()``-ed
    leaf, written into each leaf's ``.grad`` per its grad_req.  With
    ``create_graph`` (inside ``record()``) the gradients are themselves
    recorded, for higher-order differentiation."""
    outs, seeds = _heads(heads, head_grads)
    leaves = _live_leaves()
    if not leaves:
        return
    create = bool(create_graph) and is_recording()
    with torch.set_grad_enabled(create):
        grads = torch.autograd.grad(
            outs, [a._data for a in leaves], seeds,
            retain_graph=bool(retain_graph) or create, create_graph=create,
            allow_unused=True)
    for arr, g in zip(leaves, grads):
        if g is None:
            continue
        if not create:
            g = g.detach()
        if _write_leaf_grad(arr, g):
            _fire_grad_ready(arr)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (leaves or
    arrays recorded on the way to the heads), returned as new arrays and
    written nowhere; zeros for a variable the heads do not depend on.
    ``create_graph=True`` inside ``record()`` records them."""
    from .ndarray import ndarray, _wrap
    single = isinstance(variables, ndarray)
    if single:
        variables = [variables]
    outs, seeds = _heads(heads, head_grads)
    live = [v for v in variables if v._data.requires_grad]
    create = bool(create_graph) and is_recording()
    got = {}
    if live:
        with torch.set_grad_enabled(create):
            gs = torch.autograd.grad(
                outs, [v._data for v in live], seeds,
                retain_graph=bool(retain_graph) or create,
                create_graph=create, allow_unused=True)
        got = {id(v): g for v, g in zip(live, gs)}
    res = []
    for v in variables:
        g = got.get(id(v))
        if g is None:
            g = torch.zeros_like(v._data, requires_grad=False)
        elif not create:
            g = g.detach()
        res.append(_wrap(g))
    return res[0] if single else res


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark arrays as leaves with the given gradient arrays (reference
    ``MXAutogradMarkVariables``)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._mark(req)
        v._grad = g


class Function:
    """A custom differentiable function (reference
    ``python/mxnet/autograd.py:369``): subclass it with ``forward(self,
    *inputs)`` and ``backward(self, *output_grads)`` over ndarrays.

    It maps onto ``torch.autograd.Function``: ``forward`` runs with
    recording paused, and inside ``record()`` its outputs join torch's
    graph through a ``torch.autograd.Function`` whose backward calls
    ``self.backward`` on the output gradients (as ndarrays, recording
    paused) and hands back its input gradients."""

    def __init__(self):
        self._inputs = None

    def __call__(self, *inputs):
        from .ndarray import ndarray, _wrap
        self._inputs = inputs
        with pause():
            outputs = self.forward(*inputs)
        single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if single else list(outputs)
        nd_in = [x for x in inputs if isinstance(x, ndarray)]
        if not (is_recording() and any(x._data.requires_grad
                                       for x in nd_in)):
            return outputs
        fn = self
        results = [o._data for o in outs]

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *ts):
                return tuple(r.detach() for r in results)

            @staticmethod
            def backward(ctx, *gs):
                with pause():
                    igrads = fn.backward(*[_wrap(g) for g in gs])
                if not isinstance(igrads, (list, tuple)):
                    igrads = (igrads,)
                return tuple(None if g is None else g._data for g in igrads)

        with torch.enable_grad():
            ts = _Apply.apply(*[x._data for x in nd_in])
        wrapped = [_wrap(t) for t in ts]
        return wrapped[0] if single else wrapped

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError


def get_symbol(x):  # reference API parity; graph introspection is not ported
    return None
