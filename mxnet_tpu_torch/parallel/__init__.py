"""mxnet_tpu_torch.parallel — the port of ``mxnet_tpu/parallel``.

Only :class:`~.shardcfg.ShardingConfig` is ported so far: the mesh's
description that tensor-parallel serving (``serving.DecodeEngine(
sharding=)``) and ``ops.attention.flash_attention_sharded`` read.  The
port runs on one card, so a mesh is a description, not a set of devices:
its shards run in turn on the card and its collectives are fixed-order
sums there.
"""
from .shardcfg import ShardingConfig  # noqa: F401

__all__ = ["ShardingConfig"]
