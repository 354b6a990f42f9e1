"""Recurrent cells (the port of ``RecurrentCell``, ``RNNCell``,
``LSTMCell``, ``GRUCell`` and ``SequentialRNNCell`` of
``mxnet_tpu/gluon/rnn/rnn_cell.py``) as ``nn.Module``s: one step per call,
and ``unroll`` for a whole sequence.  Parameters carry gluon's names
(``i2h_weight``, ``h2h_weight``, ``i2h_bias``, ``h2h_bias``); shapes are
given at construction (``input_size`` is required); biases start at 0.
The cells run plain PyTorch: the fused layers of ``rnn_layer`` are the
path with kernels.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import context
from ...ops import nn as _ops

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell"]


class RecurrentCell(nn.Module):
    """Base cell: ``forward(x, states) -> (out, new_states)``."""

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0):
        """Zero states of ``state_info``'s shapes, in the cell's dtype and
        on its device."""
        p = next(self.parameters())
        return [torch.zeros(info["shape"], dtype=p.dtype, device=p.device)
                for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Run ``length`` steps over ``inputs`` (layout ``NTC`` or
        ``TNC``); returns (outputs stacked along T unless
        ``merge_outputs`` is False, final states)."""
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        states = (self.begin_state(batch) if begin_state is None
                  else begin_state)
        outputs = []
        for t in range(length):
            out, states = self(inputs.select(axis, t), states)
            outputs.append(out)
        if merge_outputs is None or merge_outputs:
            outputs = torch.stack(outputs, dim=axis)
        return outputs, states


class _BaseCell(RecurrentCell):
    _num_gates = 1

    def __init__(self, hidden_size, input_size=0, device=None):
        super().__init__()
        if input_size <= 0:
            raise ValueError("%s: input_size must be given (deferred shape "
                             "inference is not ported)" % type(self).__name__)
        dev = context.resolve(device)
        self._hidden_size = hidden_size
        G = self._num_gates * hidden_size
        self.i2h_weight = nn.Parameter(torch.empty(G, input_size,
                                                   device=dev))
        self.h2h_weight = nn.Parameter(torch.empty(G, hidden_size,
                                                   device=dev))
        self.i2h_bias = nn.Parameter(torch.zeros(G, device=dev))
        self.h2h_bias = nn.Parameter(torch.zeros(G, device=dev))

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _gates(self, x, h):
        return (_ops.fully_connected(x, self.i2h_weight, self.i2h_bias,
                                     flatten=False),
                _ops.fully_connected(h, self.h2h_weight, self.h2h_bias,
                                     flatten=False))


class RNNCell(_BaseCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 device=None):
        super().__init__(hidden_size, input_size, device)
        if activation not in ("tanh", "relu"):
            raise ValueError("RNNCell: activation %r is not ported (tanh, "
                             "relu)" % (activation,))
        self._activation = activation

    def forward(self, x, states):
        h = states[0] if isinstance(states, (list, tuple)) else states
        gx, gh = self._gates(x, h)
        act = torch.tanh if self._activation == "tanh" else torch.relu
        out = act(gx + gh)
        return out, [out]


class LSTMCell(_BaseCell):
    _num_gates = 4

    def state_info(self, batch_size=0):
        return 2 * super().state_info(batch_size)

    def forward(self, x, states):
        h, c = states
        gx, gh = self._gates(x, h)
        i, f, u, o = (gx + gh).chunk(4, dim=-1)
        next_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
        next_h = torch.sigmoid(o) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_BaseCell):
    _num_gates = 3

    def forward(self, x, states):
        h = states[0] if isinstance(states, (list, tuple)) else states
        gx, gh = self._gates(x, h)
        xr, xz, xn = gx.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        next_h = (1 - z) * n + z * h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input; the states
    are the cells' states in order."""

    def __init__(self):
        super().__init__()
        self._cells = nn.ModuleList()

    def add(self, cell):
        self._cells.append(cell)

    def state_info(self, batch_size=0):
        return sum((c.state_info(batch_size) for c in self._cells), [])

    def begin_state(self, batch_size=0):
        return sum((c.begin_state(batch_size) for c in self._cells), [])

    def forward(self, x, states):
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
