"""Pretrained-weight loading shared by the vision zoo's factories.

Every factory takes ``pretrained=True, ctx=..., root=...`` and calls
``net.load_parameters(get_model_file(name, root), ctx)``, as the
reference's do; the file comes from the offline, sha1-checked store
that ``model_store.publish`` fills.  Nothing is downloaded."""
from __future__ import annotations


def load_pretrained(net, name, root=None, ctx=None):
    from ..model_store import get_model_file
    net.load_parameters(get_model_file(name, root=root), ctx=ctx)
    return net
