"""Fused stacked RNN (LSTM/GRU/vanilla): the port of
``mxnet_tpu/ops/rnn.py`` (parity: reference ``src/operator/rnn.cc``,
``rnn-inl.h``).

One op runs the whole stacked, optionally bidirectional sequence over the
reference's flat parameter vector: all weights (``i2h_weight`` then
``h2h_weight`` per layer and direction, layer-major, direction-minor),
then all biases (``i2h_bias``, ``h2h_bias`` in the same order).  Gates in
MXNet order: LSTM [i, f, c, o], GRU [r, z, n].

Each layer hoists its input projection (the i2h GEMM plus ``b_i2h``) over
all T into ``gates_x``.  A unidirectional LSTM layer then runs its time
loop through :func:`..kernels.fused_cell.lstm_sequence`: one kernel
launch forward and one backward on the card, the plain loop on the CPU.
The reverse direction and GRU/vanilla RNN run a plain PyTorch loop over
the steps on every device: they are the counterpart of the JAX
``lax.scan``, and the JAX package has no Pallas kernel for them.  The
JAX package's wavefront schedule and its scan unroll knob are XLA
schedules and are not carried over (the wavefront is numerically the
layer-by-layer loop).

Inter-layer dropout applies in training only, from an explicit
``torch.Generator``.  Under AMP the op is ``"rnn"`` of the op lists: the
input and the flat parameters are cast to the scope's dtype.
"""
from __future__ import annotations

import torch

from .kernels import fused_cell as _fc
from .nn import _amp_cast2, dropout as _dropout

__all__ = ["param_size", "unpack_params", "rnn_forward", "rnn"]

_NGATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _gates(mode):
    try:
        return _NGATES[mode]
    except KeyError:
        raise ValueError("unknown RNN mode %r (lstm, gru, rnn_tanh, "
                         "rnn_relu)" % (mode,)) from None


def param_size(mode, input_size, state_size, num_layers=1,
               bidirectional=False):
    """Length of the flat parameter vector (``rnn-inl.h`` GetParamSize)."""
    ng = _gates(mode)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * (ng * state_size * (in_sz + state_size)
                     + 2 * ng * state_size)
    return size


def unpack_params(params, mode, input_size, state_size, num_layers=1,
                  bidirectional=False):
    """Views of the flat vector as ``[layer][direction]`` dicts of
    ``w_i2h`` (G, I), ``w_h2h`` (G, H), ``b_i2h`` and ``b_h2h`` (G,)."""
    ng = _gates(mode)
    d = 2 if bidirectional else 1
    G = ng * state_size
    want = param_size(mode, input_size, state_size, num_layers,
                      bidirectional)
    if params.numel() != want:
        raise ValueError("rnn: %d parameters, want %d" % (params.numel(),
                                                           want))
    layers, off = [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        dirs = []
        for _ in range(d):
            w_i2h = params[off:off + G * in_sz].reshape(G, in_sz)
            off += G * in_sz
            w_h2h = params[off:off + G * state_size].reshape(G, state_size)
            off += G * state_size
            dirs.append({"w_i2h": w_i2h, "w_h2h": w_h2h})
        layers.append(dirs)
    for layer in range(num_layers):
        for dd in range(d):
            layers[layer][dd]["b_i2h"] = params[off:off + G]
            layers[layer][dd]["b_h2h"] = params[off + G:off + 2 * G]
            off += 2 * G
    return layers


def _cell_step(mode):
    """``step(carry, gates_x_t, w_h2h_t, b_h2h) -> (carry, out)`` over the
    transposed recurrent weight (H, G), as ``rnn.py:_cell_step``."""
    if mode == "lstm":
        def step(carry, gx, w_t, b):
            h, c = carry
            g = gx + torch.matmul(h, w_t) + b
            i, f, u, o = g.chunk(4, dim=-1)
            c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            return (h2, c2), h2
    elif mode == "gru":
        def step(carry, gx, w_t, b):
            (h,) = carry
            gh = torch.matmul(h, w_t) + b
            xr, xz, xn = gx.chunk(3, dim=-1)
            hr, hz, hn = gh.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h2 = (1 - z) * n + z * h
            return (h2,), h2
    else:
        act = torch.relu if mode == "rnn_relu" else torch.tanh

        def step(carry, gx, w_t, b):
            (h,) = carry
            h2 = act(gx + torch.matmul(h, w_t) + b)
            return (h2,), h2
    return step


def _single_layer(x, h0, c0, p, mode, reverse=False):
    """x (T, B, I) -> (out (T, B, H), hT, cT or None).  The i2h GEMM and
    ``b_i2h`` are hoisted over all T; the forward LSTM runs as one
    ``lstm_sequence`` launch, everything else as a loop over the steps."""
    gates_x = torch.matmul(x, p["w_i2h"].T) + p["b_i2h"]
    w_h2h_t = p["w_h2h"].T
    if mode == "lstm" and not reverse:
        c0 = c0 if c0 is not None else torch.zeros_like(h0)
        return _fc.lstm_sequence(gates_x, h0, c0, w_h2h_t, p["b_h2h"])
    step = _cell_step(mode)
    carry = (h0, c0) if mode == "lstm" else (h0,)
    T = x.shape[0]
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry, outs[t] = step(carry, gates_x[t], w_h2h_t, p["b_h2h"])
    return torch.stack(outs), carry[0], (carry[1] if mode == "lstm"
                                         else None)


def rnn_forward(x, params, h0, c0, mode, state_size, num_layers=1,
                bidirectional=False, dropout_rate=0.0, training=False,
                generator=None):
    """The full stacked RNN.  x (T, B, I); params the flat vector; h0 (and
    c0 for LSTM) (L*D, B, H).

    Returns ``(out (T, B, H*D), hT (L*D, B, H), cT or None)``.  Dropout of
    ``dropout_rate`` between layers applies when ``training``, drawn from
    ``generator`` (the device's default one when None)."""
    d = 2 if bidirectional else 1
    layers = unpack_params(params, mode, x.shape[-1], state_size, num_layers,
                           bidirectional)
    hTs, cTs = [], []
    inp = x
    for li, dirs in enumerate(layers):
        outs = []
        for di, p in enumerate(dirs):
            s = li * d + di
            out, hT, cT = _single_layer(
                inp, h0[s], c0[s] if c0 is not None else None, p, mode,
                reverse=(di == 1))
            outs.append(out)
            hTs.append(hT)
            if cT is not None:
                cTs.append(cT)
        inp = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if li < num_layers - 1:
            inp = _dropout(inp, dropout_rate, training, generator)
    return inp, torch.stack(hTs), (torch.stack(cTs) if cTs else None)


def rnn(data, parameters, state, state_cell=None, mode="lstm",
        state_size=None, num_layers=1, bidirectional=False, p=0.0,
        training=False, generator=None):
    """``npx.rnn``: :func:`rnn_forward` in the AMP scope of op ``"rnn"``,
    which casts ``data`` and ``parameters``.  Returns ``(out, hT, cT)``
    for LSTM and ``(out, hT)`` otherwise."""
    x, params = _amp_cast2("rnn", data, parameters)
    out, hT, cT = rnn_forward(
        x, params, state, state_cell if mode == "lstm" else None, mode,
        state_size, num_layers, bidirectional, p, training, generator)
    return (out, hT, cT) if mode == "lstm" else (out, hT)
