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
