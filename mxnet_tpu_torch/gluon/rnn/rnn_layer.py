"""Fused RNN layers (the port of ``RNN``, ``LSTM`` and ``GRU`` of
``mxnet_tpu/gluon/rnn/rnn_layer.py``) as ``nn.Module``s.

Per-layer parameters carry gluon's names (``i2h_weight_l0``,
``h2h_weight_l0``, ``i2h_bias_l0``, ``h2h_bias_l0``, with ``_r`` for the
reverse direction), so :meth:`load_jax_params` carries a JAX layer's
weights across by name.  They are packed into the fused op's flat vector
at every forward (``ops.rnn``), as in the JAX package; the unidirectional
LSTM layers run the ``lstm_sequence`` kernels.  Shapes are given at
construction (``input_size`` is required: deferred shape inference is
not ported).  Weights are made in fp32 on ``device`` (``cuda`` unless
``"cpu"`` is asked for) and filled by :mod:`mxnet_tpu_torch.initializer`;
biases start at 0.  ``begin_state`` follows the parameters' dtype, so a
layer cast with ``.to(torch.bfloat16)`` starts from bf16 states.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ... import context
from ...ops import rnn as _rnn

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(nn.Module):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, device=None, generator=None):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise ValueError("layout must be TNC or NTC, got %r" % (layout,))
        if input_size <= 0:
            raise ValueError("%s: input_size must be given (deferred shape "
                             "inference is not ported)" % type(self).__name__)
        dev = context.resolve(device)
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        #: the ``torch.Generator`` of inter-layer dropout (None: the
        #: device's default one)
        self.generator = generator
        G = _rnn._gates(mode) * hidden_size
        for suffix, in_sz in self._suffixes():
            for name, shape in (("i2h_weight", (G, in_sz)),
                                ("h2h_weight", (G, hidden_size)),
                                ("i2h_bias", (G,)), ("h2h_bias", (G,))):
                t = torch.empty(shape, device=dev)
                if name.endswith("bias"):
                    t.zero_()
                setattr(self, name + suffix, nn.Parameter(t))

    def _suffixes(self):
        for layer in range(self._num_layers):
            in_sz = (self._input_size if layer == 0
                     else self._hidden_size * self._dir)
            for d in range(self._dir):
                yield "_l%d%s" % (layer, "_r" if d else ""), in_sz

    def _flat_params(self):
        """The flat vector of ``rnn-inl.h``: all weights (layer-major,
        direction-minor), then all biases."""
        sfx = [s for s, _ in self._suffixes()]
        chunks = [getattr(self, k + s).reshape(-1) for s in sfx
                  for k in ("i2h_weight", "h2h_weight")]
        chunks += [getattr(self, k + s) for s in sfx
                   for k in ("i2h_bias", "h2h_bias")]
        return torch.cat(chunks)

    def begin_state(self, batch_size=0):
        """Zero states (h, and c for LSTM) of shape (L*D, B, H), in the
        parameters' dtype and on their device."""
        p = self.i2h_weight_l0
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [torch.zeros(shape, dtype=p.dtype, device=p.device)
                for _ in range(n)]

    def forward(self, x, states=None):
        """``x`` (T, B, C) or (B, T, C) by layout; returns the output, and
        the new states too when ``states`` were given."""
        if self._layout == "NTC":
            x = x.transpose(0, 1)
        ret_states = states is not None
        if states is None:
            states = self.begin_state(x.shape[1])
        elif isinstance(states, torch.Tensor):
            states = [states]
        res = _rnn.rnn(x, self._flat_params(), states[0],
                       states[1] if self._mode == "lstm" else None,
                       mode=self._mode, state_size=self._hidden_size,
                       num_layers=self._num_layers,
                       bidirectional=self._dir == 2, p=self._dropout,
                       training=self.training, generator=self.generator)
        out, new_states = res[0], list(res[1:])
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        return (out, new_states) if ret_states else out

    @torch.no_grad()
    def load_jax_params(self, params_np):
        """Load ``{name: numpy array}`` of the JAX layer's
        ``collect_params()``; names and shapes must match exactly."""
        own = dict(self.named_parameters())
        if set(params_np) != set(own):
            raise ValueError("load_jax_params: parameter names differ: %s"
                             % sorted(set(params_np) ^ set(own)))
        for name, a in params_np.items():
            t = torch.from_numpy(np.array(a, dtype=np.float32))
            if own[name].shape != t.shape:
                raise ValueError("load_jax_params: %s has shape %s, want %s"
                                 % (name, tuple(t.shape),
                                    tuple(own[name].shape)))
            own[name].copy_(t)
        return self

    def extra_repr(self):
        return "%s, hidden=%d, layers=%d%s" % (
            self._layout, self._hidden_size, self._num_layers,
            ", bidirectional" if self._dir == 2 else "")


class RNN(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(mode, hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)
