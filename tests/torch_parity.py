"""Shared inputs of the port's parity tests (``test_torch_*.py``)."""
from __future__ import annotations

import numpy as np

from mxnet_tpu.models import decoder as jdec


def tiny_lm_with_affine(**geom):
    """The JAX ``decoder_tiny_lm(seed=0)`` with random biases, LN betas,
    and LN gammas about 1.  Its initialiser leaves them at 0 and 1, where
    a port that dropped or swapped one would still agree."""
    jlm = jdec.decoder_tiny_lm(seed=0, **geom)
    rng = np.random.default_rng(7)
    for name, p in jlm.collect_params().items():
        if name.endswith(("bias", "beta", "gamma")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data((base + 0.1 * rng.standard_normal(p.shape))
                       .astype(np.float32))
    return jlm


def tiny_bert_with_affine(seed=0, **kw):
    """A JAX ``bert_tiny`` (``use_flash=False`` and vocab 1000 unless given)
    initialised with ``Normal(0.02)`` from ``seed``, with random biases, LN
    betas and LN gammas about 1, and its parameters as ``{name: numpy
    array}`` for the port's ``BERTModel.load_jax_params``."""
    import mxnet_tpu as mx
    from mxnet_tpu.models import bert as jbert
    mx.random.seed(seed)
    kw.setdefault("dropout", 0.0)
    kw.setdefault("use_flash", False)
    jnet = jbert.bert_tiny(**kw)
    jnet.initialize(mx.init.Normal(0.02))
    rng = np.random.default_rng(7 + seed)
    params = {}
    for name, p in jnet.collect_params().items():
        if name.endswith(("bias", "beta", "gamma")):
            base = 1.0 if name.endswith("gamma") else 0.0
            p.set_data((base + 0.1 * rng.standard_normal(p.shape))
                       .astype(np.float32))
        params[name] = np.asarray(p.data().asnumpy())
    return jnet, params


def carried_models(**geom):
    """``(jlm, tlm)``: :func:`tiny_lm_with_affine` and the port's tiny LM on
    the CPU with its weights, carried across by ``load_jax_params``."""
    import jax
    from mxnet_tpu_torch.models import decoder as tdec
    jlm = tiny_lm_with_affine(**geom)
    params_np = jax.tree.map(np.asarray, jlm.jax_params())
    tlm = tdec.decoder_tiny_lm(device="cpu", **geom).load_jax_params(
        params_np)
    return jlm, tlm


def last_logits(tlm, kv_dtype, toks, page_size, chunk):
    """Last-position logits of ``toks`` through the port's own prefill
    program on a fresh one-sequence pool of ``kv_dtype`` pages."""
    import torch
    from mxnet_tpu_torch.models import decoder as tdec
    from mxnet_tpu_torch.ops.kernels import paged_attention as tpa
    cfg = tlm.config
    pps = -(-len(toks) // page_size)
    shape = (cfg.num_layers, cfg.num_kv_heads, pps + 1, page_size,
             cfg.head_dim)

    def pool():
        if kv_dtype == "int8":
            return tpa.QPages(q=torch.zeros(shape, dtype=torch.int8),
                              s=torch.ones(shape[:3]))
        return torch.zeros(shape)

    kp, vp = pool(), pool()
    fn = tdec.make_prefill_chunk(cfg, page_size, chunk)
    row = torch.arange(1, pps + 1, dtype=torch.int32)
    for p0 in range(0, len(toks), chunk):
        n = min(chunk, len(toks) - p0)
        padded = torch.zeros(chunk, dtype=torch.int64)
        padded[:n] = torch.tensor(toks[p0:p0 + n])
        _, _, _, last = fn(tlm.params(), kp, vp, padded, p0, n, row)
    return last


def check_stream(tlm, kv_dtype, prompt, got, want, page_size, chunk):
    """The port's stream ``got`` equals the JAX package's ``want``; where
    they differ, the port's prefill program over the stream's prefix must
    show a near-tie there (top-2 margin below 1e-4: two fp32 stacks that
    sum in other orders may pick either of two logits that close)."""
    import torch
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    top2 = torch.topk(last_logits(tlm, kv_dtype, prompt + got[:i],
                                  page_size, chunk), 2).values
    margin = float(top2[0] - top2[1])
    assert margin < 1e-4, (
        "streams differ at %d without a near-tie (margin %.3g): %s vs %s"
        % (i, margin, got, want))
