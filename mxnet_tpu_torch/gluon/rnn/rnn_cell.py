"""Recurrent cells (the port of ``mxnet_tpu/gluon/rnn/rnn_cell.py``;
parity: reference ``python/mxnet/gluon/rnn/rnn_cell.py`` and the contrib
``LSTMPCell`` and ``VariationalDropoutCell``) as Gluon blocks: one step
per call, ``forward(x, states) -> (out, new_states)``, and ``unroll`` for
a whole sequence (``ndarray``s or torch tensors alike; an ``ndarray``
unroll calls the cell once per step, as the JAX package's does).

Parameters carry gluon's names (``i2h_weight``, ``h2h_weight``,
``i2h_bias``, ``h2h_bias``); without ``input_size`` the input weights
take their shape at the first step.  The cells run plain PyTorch: the
fused layers of ``rnn_layer`` are the path with kernels.  Dropout in the
cells draws from the global seed (``mx.random.seed``) for an ``ndarray``
call and from the device's default generator for a torch call, in
training only.
"""
from __future__ import annotations

import torch

from ... import _rng
from ... import context as _context
from ... import numpy as _np
from ... import numpy_extension as _npx
from ...ndarray import ndarray
from ...ops import nn as _ops
from ..block import _Layer, _nd_mode, eager_init
from ..parameter import Parameter
from ..nn.basic_layers import _init_of, _zeros_init

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell", "LSTMPCell",
           "VariationalDropoutCell", "HybridRecurrentCell", "ModifierCell"]


def _stack(xs, axis):
    if isinstance(xs[0], ndarray):
        return _np.stack(xs, axis=axis)
    return torch.stack(xs, dim=axis)


def _concat(xs, axis):
    if isinstance(xs[0], ndarray):
        return _np.concatenate(xs, axis=axis)
    return torch.cat(xs, dim=axis)


def _seq_mask(x, valid_length, axis):
    if isinstance(x, ndarray):
        return _npx.sequence_mask(x, valid_length, use_sequence_length=True,
                                  axis=axis)
    return _ops.sequence_mask(x, valid_length, use_sequence_length=True,
                              axis=axis)


def _seq_reverse(x, valid_length, axis):
    use = valid_length is not None
    if isinstance(x, ndarray):
        return _npx.sequence_reverse(x, valid_length,
                                     use_sequence_length=use, axis=axis)
    return _ops.sequence_reverse(x, valid_length, use_sequence_length=use,
                                 axis=axis)


def _generator(x):
    return _rng.generator(x.device) if _nd_mode() else None


class RecurrentCell(_Layer):
    """Base cell: ``state_info``, ``begin_state``, ``reset`` and
    ``unroll``."""

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states of ``state_info``'s shapes, in the cell's dtype and
        on its device (the default device before its first step)."""
        p = next(self.parameters(), None)
        dtype = p.dtype if p is not None else torch.float32
        dev = p.device if p is not None else _context.resolve(None)
        return [torch.zeros(info["shape"], dtype=dtype, device=dev)
                for info in self.state_info(batch_size)]

    def reset(self):
        for c in self.children():
            if isinstance(c, RecurrentCell):
                c.reset()

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps over ``inputs`` (layout ``NTC`` or
        ``TNC``); returns (outputs stacked along T unless
        ``merge_outputs`` is False, final states)."""
        self.reset()
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = (self.begin_state(batch) if begin_state is None
                  else begin_state)
        outputs = []
        for t in range(length):
            step = inputs[t] if axis == 0 else inputs[:, t]
            out, states = self(step, states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            outputs = _stack(outputs, axis)
            if valid_length is not None:
                outputs = _seq_mask(outputs, valid_length, axis)
        return outputs, states


HybridRecurrentCell = RecurrentCell


class _BaseCell(RecurrentCell):
    _num_gates = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 device=None):
        super().__init__()
        self._hidden_size = hidden_size
        self._input_size = input_size
        G = self._num_gates * hidden_size
        self.i2h_weight = Parameter("i2h_weight", shape=(G, input_size),
                                    init=_init_of(i2h_weight_initializer),
                                    allow_deferred_init=True)
        self.h2h_weight = Parameter("h2h_weight", shape=(G, hidden_size),
                                    init=_init_of(h2h_weight_initializer),
                                    allow_deferred_init=True)
        self.i2h_bias = Parameter("i2h_bias", shape=(G,),
                                  init=_zeros_init(i2h_bias_initializer),
                                  allow_deferred_init=True)
        self.h2h_bias = Parameter("h2h_bias", shape=(G,),
                                  init=_zeros_init(h2h_bias_initializer),
                                  allow_deferred_init=True)
        self._device = device

    def _eager(self):
        eager_init(self, self._device)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        G = self._num_gates * self._hidden_size
        self.i2h_weight.shape_and_init((G, x.shape[-1]))
        for p in (self.h2h_weight, self.i2h_bias, self.h2h_bias):
            p.shape_and_init(p.shape)

    def _gates(self, x, h):
        if self.i2h_weight._var is None:
            self.infer_shape(x)
        return (_ops.fully_connected(x, self.i2h_weight._var,
                                     self.i2h_bias._var, flatten=False),
                _ops.fully_connected(h, self.h2h_weight._var,
                                     self.h2h_bias._var, flatten=False))


class RNNCell(_BaseCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)
        self._activation = activation
        self._eager()

    def _forward(self, training, x, states):
        h = states[0] if isinstance(states, (list, tuple)) else states
        gx, gh = self._gates(x, h)
        out = _ops.activation(gx + gh, self._activation)
        return out, [out]


class LSTMCell(_BaseCell):
    _num_gates = 4

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)
        self._eager()

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def _forward(self, training, x, states):
        h, c = states
        gx, gh = self._gates(x, h)
        i, f, u, o = (gx + gh).chunk(4, dim=-1)
        next_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
        next_h = torch.sigmoid(o) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_BaseCell):
    _num_gates = 3

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)
        self._eager()

    def _forward(self, training, x, states):
        h = states[0] if isinstance(states, (list, tuple)) else states
        gx, gh = self._gates(x, h)
        xr, xz, xn = gx.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        next_h = (1 - z) * n + z * h
        return next_h, [next_h]


class LSTMPCell(_BaseCell):
    """LSTM with a learned projection of the hidden state (contrib
    ``LSTMPCell``, Sak et al. 2014): h2h and the output see the projected
    state of ``projection_size``."""

    _num_gates = 4

    def __init__(self, hidden_size, projection_size, input_size=0,
                 projection_initializer=None, **kwargs):
        device = kwargs.pop("device", None)
        super().__init__(hidden_size, input_size, **kwargs)
        self._projection_size = projection_size
        self.h2h_weight = Parameter(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=_init_of(kwargs.get("h2h_weight_initializer")),
            allow_deferred_init=True)
        self.projection_weight = Parameter(
            "projection_weight", shape=(projection_size, hidden_size),
            init=_init_of(projection_initializer), allow_deferred_init=True)
        self._device = device
        self._eager()

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        super().infer_shape(x, *args)
        self.projection_weight.shape_and_init(self.projection_weight.shape)

    def _forward(self, training, x, states):
        h, c = states
        gx, gh = self._gates(x, h)
        i, f, u, o = (gx + gh).chunk(4, dim=-1)
        next_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
        hidden = torch.sigmoid(o) * torch.tanh(next_c)
        next_h = _ops.fully_connected(hidden, self.projection_weight._var,
                                      no_bias=True, flatten=False)
        return next_h, [next_h, next_c]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input; the states
    are the cells' states in order."""

    def __init__(self):
        super().__init__()
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return sum((c.state_info(batch_size) for c in self._cells), [])

    def begin_state(self, batch_size=0, **kwargs):
        return sum((c.begin_state(batch_size, **kwargs)
                    for c in self._cells), [])

    def _forward(self, training, x, states):
        next_states, pos = [], 0
        for cell in self._cells:
            n = len(cell.state_info())
            x, s = cell(x, states[pos:pos + n])
            pos += n
            next_states.extend(s)
        return x, next_states

    def __len__(self):
        return len(self._cells)

    def __getitem__(self, i):
        return self._cells[i]


HybridSequentialRNNCell = SequentialRNNCell


class DropoutCell(RecurrentCell):
    """Dropout of the input, no state."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def begin_state(self, batch_size=0, **kwargs):
        return []

    def _forward(self, training, x, states):
        if self._rate > 0:
            x = _ops.dropout(x, self._rate, training, _generator(x),
                             self._axes)
        return x, states


class ModifierCell(RecurrentCell):
    """A cell around ``base_cell``, with its states."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al. 2016): in training, each output and state
    element keeps its previous value with probability ``zoneout_*``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def _forward(self, training, x, states):
        out, next_states = self.base_cell(x, states)
        if self._zo > 0:
            mask = _ops.dropout(torch.ones_like(out), self._zo, training,
                                _generator(out))
            prev = (self._prev_output if self._prev_output is not None
                    else torch.zeros_like(out))
            out = torch.where(mask > 0, out, prev)
        if self._zs > 0:
            next_states = [
                torch.where(_ops.dropout(torch.ones_like(ns), self._zs,
                                         training, _generator(ns)) > 0,
                            ns, s)
                for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states

    def reset(self):
        super().reset()
        self._prev_output = None


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def _forward(self, training, x, states):
        out, next_states = self.base_cell(x, states)
        return out + x, next_states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` forward and ``r_cell`` backward over the sequence, their
    outputs concatenated; unroll only."""

    def __init__(self, l_cell, r_cell):
        super().__init__()
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def begin_state(self, batch_size=0, **kwargs):
        return (self.l_cell.begin_state(batch_size, **kwargs)
                + self.r_cell.begin_state(batch_size, **kwargs))

    def _forward(self, training, x, states):
        raise NotImplementedError("BidirectionalCell runs through unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch)
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(
            length, inputs, begin_state[:nl], layout, True, valid_length)
        rev = _seq_reverse(inputs, valid_length, axis)
        r_out, r_states = self.r_cell.unroll(
            length, rev, begin_state[nl:], layout, True, valid_length)
        r_out = _seq_reverse(r_out, valid_length, axis)
        return _concat([l_out, r_out], -1), l_states + r_states


class VariationalDropoutCell(ModifierCell):
    """One dropout mask per sequence, not per step, on the inputs, the
    first state and the outputs (Gal and Ghahramani 2016); ``reset``
    (which ``unroll`` calls) draws new masks."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._di, self._ds, self._do = drop_inputs, drop_states, drop_outputs
        self._mask_in = self._mask_st = self._mask_out = None

    def reset(self):
        super().reset()
        self._mask_in = self._mask_st = self._mask_out = None

    def _mask(self, cached, x, rate, training):
        if rate == 0.0 or not training:
            return None, cached
        if cached is None:
            keep = 1.0 - rate
            gen = _rng.generator(x.device)
            m = torch.rand(x.shape, generator=gen, device=x.device) < keep
            cached = m.to(x.dtype) / keep
        return cached, cached

    def _forward(self, training, x, states):
        m, self._mask_in = self._mask(self._mask_in, x, self._di, training)
        if m is not None:
            x = x * m
        if self._ds:
            h = states[0]
            m, self._mask_st = self._mask(self._mask_st, h, self._ds,
                                          training)
            if m is not None:
                states = [h * m] + list(states[1:])
        out, new_states = self.base_cell(x, states)
        m, self._mask_out = self._mask(self._mask_out, out, self._do,
                                       training)
        if m is not None:
            out = out * m
        return out, new_states
