"""Control-flow operators: foreach / while_loop / cond (the port of
``mxnet_tpu/ops/control_flow.py``; parity: reference
``src/operator/control_flow.cc`` and ``python/mxnet/ndarray/contrib.py``
:139/:233/:401).

The JAX package runs these as Python loops in imperative mode and lowers
them to ``lax.scan``/``lax.cond`` only when tracing inside
``hybridize()``.  The port has no tracing (``hybridize`` is ROADMAP item
4), so each is the imperative loop: the body runs eagerly, ops record
for autograd inside ``record()`` as any other op, and the body may branch
on values.  ``while_loop`` pads its stacked outputs with zeros to
``max_iterations`` rows, as the reference's NDArray mode does.
"""
from __future__ import annotations

from ..ndarray import ndarray

__all__ = ["foreach", "while_loop", "cond"]


def _flatten(obj, out):
    if isinstance(obj, ndarray):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _flatten(o, out)
    elif obj is not None:
        raise TypeError("control-flow states must be ndarrays or nested "
                        "lists/tuples of ndarrays, got %r" % (type(obj),))
    return out


def _rebuild(template, values, idx):
    if isinstance(template, ndarray):
        v = values[idx[0]]
        idx[0] += 1
        return v
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, values, idx) for t in template)
    return template


def foreach(body, data, init_states):
    """Run ``body(data_slice, states) -> (outputs, new_states)`` over axis 0
    of ``data``; returns (the outputs stacked over the steps, the final
    states)."""
    from ..numpy import stack as _stack
    flat_data = _flatten(data, [])
    states = init_states
    outputs = []
    for t in range(flat_data[0].shape[0]):
        slc = _rebuild(data, [d[t] for d in flat_data], [0])
        out, states = body(slc, states)
        outputs.append(out)
    flat_outs = [_flatten(o, []) for o in outputs]
    stacked = [_stack([fo[i] for fo in flat_outs])
               for i in range(len(flat_outs[0]))]
    return _rebuild(outputs[0], stacked, [0]), states


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """``while cond_fn(*loop_vars): outputs, loop_vars = func(*loop_vars)``,
    at most ``max_iterations`` times (required).  Returns (the outputs
    stacked and zero-padded to ``max_iterations`` rows, or [] when the
    loop never ran; the final loop vars)."""
    from ..numpy import stack as _stack, zeros as _zeros, \
        concatenate as _concat
    if max_iterations is None:
        raise ValueError("max_iterations should be specified")
    max_iterations = int(max_iterations)
    steps = 0
    outputs = []
    cur = loop_vars
    while steps < max_iterations and bool(cond_fn(*cur)):
        out, cur = func(*cur)
        if not isinstance(cur, (list, tuple)):
            cur = [cur]
        outputs.append(out)
        steps += 1
    if not outputs:
        return [], list(cur)
    flat_outs = [_flatten(o, []) for o in outputs]
    stacked = []
    for i in range(len(flat_outs[0])):
        s = _stack([fo[i] for fo in flat_outs])
        if steps != max_iterations:
            pad = _zeros((max_iterations - steps,) + s.shape[1:],
                         dtype=s.dtype, ctx=s.ctx)
            s = _concat([s, pad], axis=0)
        stacked.append(s)
    return _rebuild(outputs[0], stacked, [0]), list(cur)


def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` (an ndarray or a python value) holds,
    else ``else_func()``."""
    take_then = bool(pred.item()) if isinstance(pred, ndarray) else bool(pred)
    return then_func() if take_then else else_func()
