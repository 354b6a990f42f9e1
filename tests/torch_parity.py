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
