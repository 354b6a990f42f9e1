"""Fused RNN layers (the port of ``RNN``, ``LSTM`` and ``GRU`` of
``mxnet_tpu/gluon/rnn/rnn_layer.py``) as Gluon blocks.

Per-layer parameters carry gluon's names (``i2h_weight_l0``,
``h2h_weight_l0``, ``i2h_bias_l0``, ``h2h_bias_l0``, with ``_r`` for the
reverse direction), so ``load_parameters`` or :meth:`load_jax_params`
carries a JAX layer's weights across by name.  They are packed into the
fused op's flat vector at every forward (``ops.rnn``), as in the JAX
package; the unidirectional LSTM layers run the ``lstm_sequence`` kernels
(#10 forward, #11 backward).  Without ``input_size`` the first layer's
input weights take their shape at the first forward.  ``begin_state``
gives torch tensors in the parameters' dtype, on their device; an
``ndarray`` call takes them as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import _rng
from ...ops import rnn as _rnn
from ..block import _Layer, _nd_mode, eager_init
from ..parameter import Parameter
from ..nn.basic_layers import _init_of, _zeros_init

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(_Layer):
    def __init__(self, mode, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", dtype="float32", device=None,
                 generator=None):
        super().__init__()
        if layout not in ("TNC", "NTC"):
            raise ValueError("layout must be TNC or NTC, got %r" % (layout,))
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = dtype
        #: the ``torch.Generator`` of inter-layer dropout (None: the
        #: device's default one, or the global seed's for ndarray calls)
        self.generator = generator
        G = _rnn._gates(mode) * hidden_size
        for suffix, in_sz in self._suffixes():
            setattr(self, "i2h_weight" + suffix, Parameter(
                "i2h_weight" + suffix, shape=(G, in_sz), dtype=dtype,
                init=_init_of(i2h_weight_initializer),
                allow_deferred_init=True))
            setattr(self, "h2h_weight" + suffix, Parameter(
                "h2h_weight" + suffix, shape=(G, hidden_size), dtype=dtype,
                init=_init_of(h2h_weight_initializer)))
            setattr(self, "i2h_bias" + suffix, Parameter(
                "i2h_bias" + suffix, shape=(G,), dtype=dtype,
                init=_zeros_init(i2h_bias_initializer)))
            setattr(self, "h2h_bias" + suffix, Parameter(
                "h2h_bias" + suffix, shape=(G,), dtype=dtype,
                init=_zeros_init(h2h_bias_initializer)))
        eager_init(self, device)

    def _suffixes(self):
        for layer in range(self._num_layers):
            in_sz = (self._input_size if layer == 0
                     else self._hidden_size * self._dir)
            for d in range(self._dir):
                yield "_l%d%s" % (layer, "_r" if d else ""), in_sz

    def infer_shape(self, x, *args):
        self._input_size = x.shape[-1]
        G = _rnn._gates(self._mode) * self._hidden_size
        for suffix, in_sz in self._suffixes():
            getattr(self, "i2h_weight" + suffix).shape_and_init((G, in_sz))

    def _flat_params(self):
        """The flat vector of ``rnn-inl.h``: all weights (layer-major,
        direction-minor), then all biases."""
        sfx = [s for s, _ in self._suffixes()]
        p = self._parameters
        chunks = [p[k + s].reshape(-1) for s in sfx
                  for k in ("i2h_weight", "h2h_weight")]
        chunks += [p[k + s] for s in sfx for k in ("i2h_bias", "h2h_bias")]
        return torch.cat(chunks)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": shape, "__layout__": "LNC"} for _ in range(n)]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states (h, and c for LSTM) of shape (L*D, B, H), in the
        parameters' dtype and on their device."""
        w = self.h2h_weight_l0.leaf
        return [torch.zeros(info["shape"], dtype=w.dtype, device=w.device)
                for info in self.state_info(batch_size)]

    def _forward(self, training, x, states=None):
        """``x`` (T, B, C) or (B, T, C) by layout; returns the output, and
        the new states too when ``states`` were given."""
        if self.i2h_weight_l0._var is None:
            self.infer_shape(x)
        if self._layout == "NTC":
            x = x.transpose(0, 1)
        ret_states = states is not None
        if states is None:
            states = self.begin_state(x.shape[1])
        elif isinstance(states, torch.Tensor):
            states = [states]
        gen = self.generator
        if (gen is None and _nd_mode() and training and self._dropout
                and self._num_layers > 1):
            gen = _rng.generator(x.device)
        res = _rnn.rnn(x, self._flat_params(), states[0],
                       states[1] if self._mode == "lstm" else None,
                       mode=self._mode, state_size=self._hidden_size,
                       num_layers=self._num_layers,
                       bidirectional=self._dir == 2, p=self._dropout,
                       training=training, generator=gen)
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
