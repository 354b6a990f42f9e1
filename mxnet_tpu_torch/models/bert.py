"""BERT with MLM + NSP heads (the port of ``mxnet_tpu/models/bert.py``).

Post-LN transformer encoder layers.  Attention (``use_flash=True``, the
default, as in the JAX package) goes through
``ops.attention.flash_attention``: the flash kernels forward and back,
with the attention-probability dropout in the kernels' hash mask and a
(B,) valid-length mask as ``kv_length``; a dense mask, or
``use_flash=False``, takes batched matmuls and a masked softmax.  With
``MXNET_FUSE_EPILOGUE`` on (the default), each projection before an
epilogue runs bias-free and the epilogue kernels own the bias:

- FFN1 and the MLM transform: ``bias_gelu`` (Triton forward and
  backward);
- the attention output projection and FFN2: ``bias_dropout_residual``
  (CUDA forward and backward), whose hash mask the backward rebuilds.

Off, the layers run the unfused add / GELU / dropout / residual chain.
The pooler is ``Dense(tanh)`` on the first token; the MLM logits are tied
to the word embedding (``h @ word_embed.weight.T + mlm_bias``).

``named_parameters()`` equals the JAX model's ``collect_params()`` keys
(``encoder.layers.0.attention.qkv.weight``, ``embed_ln.gamma``,
``position_embed``, ``mlm_bias``, ...), so :meth:`BERTModel.load_jax_params`
carries a JAX model's weights across by name.

Dropout (train mode only) draws its plain masks from ``model.generator``
on the model's device, and the flash and epilogue kernels' uint32 seeds
from the same generator.  Under ``amp.convert_hybrid_block`` the
projections, attention and epilogues run in bf16 (``ops/nn.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import context
from .. import initializer as _init
from ..gluon import nn as gnn
from ..ops import attention as _attention
from ..ops import nn as _ops
from ..ops.kernels.epilogue import fuse_epilogue_enabled

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerLayer",
           "BERTEncoder", "BERTModel", "bert_base", "bert_large",
           "bert_tiny", "params_from_jax"]

def _dense_nobias(dense, x):
    """A Dense layer's matmul without its bias, which the next fused
    epilogue adds."""
    return _ops.fully_connected(x, dense.weight, no_bias=True, flatten=False)


class MultiHeadAttention(nn.Module):
    """Self-attention: fused QKV projection, then flash attention
    (``use_flash``) or scaled dot products, a masked softmax over the keys
    and attention-probability dropout."""

    def __init__(self, units, num_heads, dropout=0.0, use_flash=True,
                 device=None, generator=None):
        super().__init__()
        if units % num_heads:
            raise ValueError("units must divide into num_heads")
        self._units, self._num_heads = units, num_heads
        self._use_flash = use_flash
        self._head_dim = units // num_heads
        self._dropout = dropout
        self._generator = generator
        self.qkv = gnn.Dense(3 * units, flatten=False, in_units=units,
                             device=device)
        self.proj = gnn.Dense(units, flatten=False, in_units=units,
                              device=device)

    def forward(self, x, mask=None):
        """x (B, L, C); ``mask``: (B,) valid lengths or a boolean mask
        broadcastable to (B, H, L, L).  Returns the output projection, its
        bias left out when the fused epilogues are on."""
        B, L, C = x.shape
        H, D = self._num_heads, self._head_dim
        qkv = self.qkv(x).reshape(B, L, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                      # (B, H, L, D)
        valid_len = mask if (mask is not None and mask.dim() == 1) else None
        if self._use_flash and (mask is None or valid_len is not None):
            out = _attention.flash_attention(
                q, k, v, dropout=self._dropout if self.training else 0.0,
                generator=self._generator, kv_length=valid_len)
        else:
            att = _ops.batch_dot(q, k, transpose_b=True) / math.sqrt(D)
            if mask is not None:
                if valid_len is not None:    # (B,) lengths -> (B, 1, 1, L)
                    keys = torch.arange(L, device=x.device).reshape(1, 1, 1,
                                                                    L)
                    mask = keys < valid_len.reshape(B, 1, 1, 1)
                att = _ops.masked_softmax(att, mask, axis=-1)
            else:
                att = _ops.softmax(att, axis=-1)
            att = _ops.dropout(att, self._dropout, self.training,
                               self._generator)
            out = _ops.batch_dot(att, v)
        out = out.transpose(1, 2).reshape(B, L, C)
        if fuse_epilogue_enabled():
            return _dense_nobias(self.proj, out)
        return self.proj(out)


class PositionwiseFFN(nn.Module):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 device=None, generator=None):
        super().__init__()
        self.ffn1 = gnn.Dense(hidden_size, flatten=False, in_units=units,
                              device=device)
        self.ffn2 = gnn.Dense(units, flatten=False, in_units=hidden_size,
                              device=device)
        self._activation = activation
        self._dropout = dropout
        self._generator = generator

    def forward(self, x):
        """FFN2's output; its bias left out when the fused epilogues are
        on (the layer's bias_dropout_residual adds it)."""
        fused = self._activation == "gelu" and fuse_epilogue_enabled()
        if fused:
            h = _ops.bias_gelu(_dense_nobias(self.ffn1, x), self.ffn1.bias)
        else:
            h = _ops.activation(self.ffn1(x), self._activation)
        h = _ops.dropout(h, self._dropout, self.training, self._generator)
        return _dense_nobias(self.ffn2, h) if fused else self.ffn2(h)


class TransformerLayer(nn.Module):
    """Post-LN encoder layer (BERT convention)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 use_flash=True, device=None, generator=None):
        super().__init__()
        self._generator = generator
        self.attention = MultiHeadAttention(units, num_heads, dropout,
                                            use_flash, device, generator)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout,
                                   device=device, generator=generator)
        self.ln1 = gnn.LayerNorm(in_channels=units, device=device)
        self.ln2 = gnn.LayerNorm(in_channels=units, device=device)
        self._dropout = dropout

    def forward(self, x, mask=None):
        gen = self._generator
        if fuse_epilogue_enabled():
            h = self.attention(x, mask)
            x = self.ln1(_ops.bias_dropout_residual(
                h, self.attention.proj.bias, x, self._dropout, self.training,
                gen))
            h = self.ffn(x)
            return self.ln2(_ops.bias_dropout_residual(
                h, self.ffn.ffn2.bias, x, self._dropout, self.training, gen))
        h = _ops.dropout(self.attention(x, mask), self._dropout,
                         self.training, gen)
        x = self.ln1(x + h)
        h = _ops.dropout(self.ffn(x), self._dropout, self.training, gen)
        return self.ln2(x + h)


class BERTEncoder(nn.Module):
    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, max_length=512, use_flash=True,
                 device=None, generator=None):
        super().__init__()
        self._units = units
        self.layers = nn.ModuleList(
            TransformerLayer(units, hidden_size, num_heads, dropout,
                             use_flash, device, generator)
            for _ in range(num_layers))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(nn.Module):
    """BERT with MLM + NSP heads (pretraining configuration).

    ``forward(tokens, token_types=None, mask=None)`` -> ``(mlm_logits (B,
    L, vocab), nsp_logits (B, 2))``; ``mask`` is a (B,) vector of valid
    lengths or a boolean mask broadcastable to (B, H, L, L).

    Parameters are made on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for) and filled by ``init`` (default ``Uniform(0.07)``, gluon's
    ``initialize()`` default) from a CPU generator seeded with ``seed``;
    ``model.generator`` (on the device, seeded with ``seed`` too) draws the
    dropout masks and seeds in train mode.  ``use_flash`` (default True,
    as in the JAX package) attends through the flash kernels."""

    def __init__(self, vocab_size=30522, num_layers=12, units=768,
                 hidden_size=3072, num_heads=12, dropout=0.1, max_length=512,
                 token_types=2, use_flash=True, tie_embeddings=True, *,
                 device=None, seed=0, init=None):
        super().__init__()
        dev = context.resolve(device)
        self._units, self._max_length = units, max_length
        self._dropout = dropout
        self._generator = torch.Generator(device=dev)
        self.word_embed = gnn.Embedding(vocab_size, units, device=dev)
        self.token_type_embed = gnn.Embedding(token_types, units, device=dev)
        self.position_embed = nn.Parameter(
            torch.empty(max_length, units, device=dev))
        self.embed_ln = gnn.LayerNorm(in_channels=units, device=dev)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   dropout, max_length, use_flash, dev,
                                   self._generator)
        self.pooler = gnn.Dense(units, activation="tanh", flatten=False,
                                in_units=units, device=dev)
        self.mlm_dense = gnn.Dense(units, flatten=False, in_units=units,
                                   device=dev)
        self.mlm_ln = gnn.LayerNorm(in_channels=units, device=dev)
        self._tie = tie_embeddings
        if not tie_embeddings:
            self.mlm_decoder = gnn.Dense(vocab_size, flatten=False,
                                         in_units=units, device=dev)
        self.mlm_bias = nn.Parameter(torch.empty(vocab_size, device=dev))
        self.nsp = gnn.Dense(2, flatten=False, in_units=units, device=dev)
        self.initialize(init, seed)

    @property
    def device(self):
        return self.mlm_bias.device

    @property
    def generator(self):
        """The ``torch.Generator`` (on the model's device) of dropout."""
        return self._generator

    def initialize(self, init=None, seed=0):
        """Fill every parameter with ``init`` (default ``Uniform(0.07)``;
        biases and betas 0, gammas 1) drawn from a CPU generator seeded
        with ``seed``, and reseed the dropout generator with ``seed``."""
        init = _init.create(init) if init is not None else _init.Uniform()
        gen = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            init(name, p, gen)
        self._generator.manual_seed(int(seed))
        return self

    def forward(self, tokens, token_types=None, mask=None):
        B, L = tokens.shape
        x = self.word_embed(tokens)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = x + self.position_embed[:L]
        x = self.embed_ln(x)
        x = _ops.dropout(x, self._dropout, self.training, self.generator)
        seq = self.encoder(x, mask)                           # (B, L, C)
        pooled = self.pooler(seq[:, 0])                       # CLS
        if fuse_epilogue_enabled():
            h = _ops.bias_gelu(_dense_nobias(self.mlm_dense, seq),
                               self.mlm_dense.bias)
        else:
            h = _ops.activation(self.mlm_dense(seq), "gelu")
        h = self.mlm_ln(h)
        if self._tie:
            logits = _ops.fully_connected(h, self.word_embed.weight,
                                          self.mlm_bias, flatten=False)
        else:
            logits = self.mlm_decoder(h) + self.mlm_bias
        return logits, self.nsp(pooled)

    @torch.no_grad()
    def load_jax_params(self, params_np):
        """Load ``{name: numpy array}`` of the JAX model's
        ``collect_params()``; afterwards both packages compute the same
        function.  Names and shapes must match exactly."""
        state = params_from_jax(params_np)
        own = dict(self.named_parameters())
        if set(state) != set(own):
            raise ValueError("load_jax_params: parameter names differ: %s"
                             % sorted(set(state) ^ set(own)))
        for name, t in state.items():
            if own[name].shape != t.shape:
                raise ValueError("load_jax_params: %s has shape %s, want %s"
                                 % (name, tuple(t.shape),
                                    tuple(own[name].shape)))
            own[name].copy_(t)
        return self


def params_from_jax(params_np):
    """``{name: float32 CPU tensor}`` from ``{name: numpy array}`` of a JAX
    ``BERTModel.collect_params()`` (values as ``p.data().asnumpy()``)."""
    return {name: torch.from_numpy(np.array(a, dtype=np.float32))
            for name, a in params_np.items()}


def bert_base(vocab_size=30522, **kw):
    return BERTModel(vocab_size, num_layers=12, units=768, hidden_size=3072,
                     num_heads=12, **kw)


def bert_large(vocab_size=30522, **kw):
    return BERTModel(vocab_size, num_layers=24, units=1024, hidden_size=4096,
                     num_heads=16, **kw)


def bert_tiny(vocab_size=1000, **kw):
    kw.setdefault("max_length", 128)
    return BERTModel(vocab_size, num_layers=2, units=64, hidden_size=128,
                     num_heads=2, **kw)
