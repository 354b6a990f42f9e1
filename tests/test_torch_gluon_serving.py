"""The port's serving registry takes a Gluon block as the JAX registry
does: hybridized and called with ndarrays in predict mode.  The same
block (weights carried by ``save_parameters``) served by both registries
gives the same outputs on the same batch, padded to a bucket and cut
back; ``load_checkpoint`` still waits for ROADMAP item 9.
"""
from __future__ import annotations

import numpy as np
import pytest

from gluon_parity import carry, jax_mx, port_mx, rand


def _net(g):
    net = g.nn.HybridSequential()
    net.add(g.nn.Dense(6, activation="relu"), g.nn.Dropout(0.5),
            g.nn.BatchNorm(), g.nn.Dense(3))
    return net


def test_registry_serves_a_gluon_block_like_jax(tmp_path):
    from mxnet_tpu.serving import registry as jreg
    from mxnet_tpu_torch.serving import registry as treg
    jmx, tmx = jax_mx(), port_mx()
    jn = _net(jmx.gluon)
    jn.initialize(jmx.init.Xavier())
    jn(jmx.np.zeros((1, 5)))
    with tmx.Context("cpu"):
        tn = _net(tmx.gluon)
        tn.initialize(tmx.init.Xavier())
    carry(jn, tn, tmp_path / "w.npz")
    x = rand(3, 5)
    outs = []
    for reg in (jreg.ModelRegistry(), treg.ModelRegistry()):
        served = reg.load("mlp", jn if isinstance(reg, jreg.ModelRegistry)
                          else tn, item_shape=(5,), max_batch_size=4)
        assert served.warmed and served.buckets == (1, 2, 4)
        outs.append(np.asarray(served.run_batch(x)[0]))
    assert tn._active
    assert outs[1].shape == (3, 3)
    # fp32 on both sides, a few ulps per matmul
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="item 9"):
        treg.ModelRegistry().load_checkpoint("c", "net-symbol.json")
