"""The names of the array and op core the port does not carry yet.

Every entry is (namespace, name, ROADMAP item, what it waits for).  Each
name exists in its namespace as a stand-in that raises
``NotImplementedError`` naming its item when called or when an
attribute of it is asked for.  Every other name of the JAX package's
``np``, ``np.linalg``, ``np.random``, ``npx`` and ``nd`` is ported
(``tests/test_torch_np_names.py`` holds them in value and dtype).
"""
from __future__ import annotations

__all__ = ["UNPORTED", "install"]

UNPORTED = (
    ("nd", "Custom", 9, "operator.py (custom Python operators)"),
    ("nd", "sparse", 9, "sparse.py (row_sparse and csr storage)"),
)


class _Unported:
    """A stand-in for an unported name."""

    def __init__(self, qualname, item, what):
        self._msg = ("%s is not ported yet: it waits for %s, ROADMAP Queue 1 "
                     "item %d" % (qualname, what, item))

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(self._msg)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(self._msg)

    def __repr__(self):
        return "<unported: %s>" % self._msg


def install(namespace, module_globals):
    """Bind the stand-ins of ``namespace``'s unported names."""
    for ns, name, item, what in UNPORTED:
        if ns == namespace:
            module_globals[name] = _Unported("mx.%s.%s" % (ns, name), item,
                                             what)
