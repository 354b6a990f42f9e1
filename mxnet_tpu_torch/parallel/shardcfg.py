"""ShardingConfig: the description of a (dp, tp, sp) mesh and of the
Megatron layout of a transformer's parameters on it.

The port's own copy of the part of ``mxnet_tpu/parallel/shardcfg.py``
that tensor-parallel serving reads (``ShardingConfig.__init__``,
``axis_size``, ``describe``, ``signature``, ``param_spec`` and
``for_transformer``, ``shardcfg.py:280-400, 569, 746``).  There is no
device mesh: the port runs every shard in turn on one card
(``models.decoder.TPPlan``), so the config holds the mesh's shape and axis
names and the parameter rules, and nothing else.  A rule's spec is a
plain tuple with one entry per leading dimension, an axis name or None;
:meth:`ShardingConfig.param_spec` resolves it as the JAX package's does,
without its ``PartitionSpec``.
"""
from __future__ import annotations

import re

__all__ = ["ShardingConfig", "MESH_AXES"]

#: the mesh axes this repo names: data, tensor and sequence parallel
MESH_AXES = ("dp", "tp", "sp")

#: Megatron-style rules for the transformer blocks' parameter names:
#: qkv/ffn1 column-parallel (out-features over tp), proj/ffn2 row-parallel
#: (in-features over tp), every other parameter replicated
_MEGATRON_RULES = (
    (r"(qkv|ffn1)\.weight$", ("tp", None)),
    (r"(qkv|ffn1)\.bias$", ("tp",)),
    (r"(attention\.proj|ffn2)\.weight$", (None, "tp")),
)


class ShardingConfig:
    """A mesh's axis names and sizes, and ordered parameter rules.

    ``mesh_shape``: one size per axis; missing trailing sizes are 1, and
    with no shape every axis has size 1.  ``axis_names`` defaults to
    ``("dp",)``.  ``rules``: ``(regex, spec)`` pairs, first match wins."""

    def __init__(self, mesh_shape=None, axis_names=None, rules=()):
        self.axis_names = tuple(axis_names) if axis_names else ("dp",)
        shape = tuple(int(s) for s in (mesh_shape or ()))
        if len(shape) > len(self.axis_names):
            raise ValueError("ShardingConfig: mesh_shape %s has more entries "
                             "than axis_names %s" % (shape, self.axis_names))
        if any(s < 1 for s in shape):
            raise ValueError("ShardingConfig: mesh sizes must be >= 1, got %s"
                             % (shape,))
        self.mesh_shape = shape + (1,) * (len(self.axis_names) - len(shape))
        self.rules = tuple((str(p), tuple(s)) for p, s in rules)
        self._compiled = [(re.compile(p), s) for p, s in self.rules]

    @classmethod
    def for_transformer(cls, mesh_shape=None, axis_names=None):
        """The Megatron dp x tp rules of the JAX package's
        ``ShardingConfig.for_transformer`` on this mesh."""
        return cls(mesh_shape=mesh_shape, axis_names=axis_names,
                   rules=_MEGATRON_RULES)

    def axis_size(self, name):
        """Size of a mesh axis, 1 when the mesh does not carry it."""
        if name not in self.axis_names:
            return 1
        return self.mesh_shape[self.axis_names.index(name)]

    def describe(self):
        """``"dp=4xtp=2"``, as the JAX package describes the mesh."""
        return "x".join("%s=%d" % (a, self.axis_size(a))
                        for a in self.axis_names)

    def signature(self):
        """Hashable identity: configs with equal axes, shape and rules are
        interchangeable."""
        return (self.axis_names, self.mesh_shape, self.rules)

    def param_spec(self, name, shape):
        """The first matching rule's spec for parameter ``name`` of
        ``shape``, resolved as the JAX package resolves it: an axis the
        mesh lacks or whose size does not divide the dimension leaves that
        dimension replicated (None), and trailing None entries are dropped.
        ``()`` when no rule matches (replicated)."""
        for pat, spec in self._compiled:
            if pat.search(name):
                out = []
                for dim, axis in zip(shape, spec):
                    size = self.axis_size(axis) if axis is not None else 1
                    keep = (axis in self.axis_names and size > 1
                            and dim % size == 0)
                    out.append(axis if keep else None)
                while out and out[-1] is None:
                    out.pop()
                return tuple(out)
        return ()

    def __repr__(self):
        return "ShardingConfig(%s, rules=%d)" % (self.describe(),
                                                 len(self.rules))
