"""Page-granular KV-cache allocator for continuous-batching decode.

The allocator half of ``mxnet_tpu/serving/kvcache.py``, copied: it runs
on the host, so both packages share one allocator behaviour, int8 page
accounting included (``kv_dtype``, ``scale_page_bytes``).  The
prefix cache (``PrefixCache``, with the allocator's ``share``/``fork``)
and the session wire format (``pack_session``) come with the slices
that port them.

The vLLM memory model at the serving layer: the device-side KV cache is
a fixed pool of ``total_pages`` pages of ``page_size`` tokens each
(``ops/kernels/paged_attention.py`` owns the device layout and the
attention over it); this module owns the HOST-side bookkeeping —

- a LIFO **free list** (freed pages are re-used hottest-first),
- per-owner **page lists** (the sequence's page table, in allocation
  order == token order),
- per-page **refcounts**: a page returns to the free list only when
  its last reference drops (every page has one owner until the prefix
  cache is ported),
- exact **occupancy accounting** (used/total, peak, shared pages,
  alloc/free/fail counters) — the admission-control signal and the
  serving metric.

Page 0 is reserved as the *scratch page*: inactive batch slots and
padded prefill tokens scatter their (garbage) KV there, so the decode
step never needs a dynamic shape or a host round-trip to mask writes.
It is excluded from the free list and from occupancy math.

The allocator is synchronous and oblivious to device timing: a freed
page goes back on the (LIFO) free list immediately and may be handed
out on the very next ``alloc``.  The port's engine runs the synchronous
decode loop (every step's result is read before the next is
scheduled), so no page is freed while a launch still writes it.

Fault site ``kvcache.alloc`` (``mxnet_tpu_torch.faults``) trips inside
:meth:`PageAllocator.alloc`, so chaos tests can fail allocations
deterministically; genuine exhaustion raises :class:`CacheOOM`, which
the decode engine turns into preemption (evict-youngest + recompute)
rather than an error.  Invariant violations raise the typed
:class:`~.errors.KVLeakError` from :meth:`PageAllocator.check_leaks`.
"""
from __future__ import annotations

import threading

from .. import faults
from .errors import KVLeakError

__all__ = ["CacheOOM", "PageAllocator", "pages_for"]

#: page id reserved for garbage writes from inactive/padded batch rows
SCRATCH_PAGE = 0


class CacheOOM(RuntimeError):
    """The free list cannot satisfy an allocation.  Internal to the
    decode engine: the scheduler responds by preempting (or, with
    nothing to preempt, failing the request typed) — callers outside
    the engine never see this."""


def pages_for(tokens, page_size):
    """Pages needed to hold ``tokens`` cache slots."""
    return -(-int(tokens) // int(page_size))


class PageAllocator:
    """Thread-safe refcounted free-list allocator over a fixed pool.

    ``total_pages`` counts the scratch page, mirroring the device
    arrays' leading page dimension; capacity available to sequences is
    ``total_pages - 1``.  A page freshly allocated has refcount 1;
    :meth:`free` drops it, and the page rejoins the free list at
    refcount zero.
    """

    def __init__(self, total_pages, page_size, kv_dtype="float32",
                 page_bytes=0, scale_page_bytes=0):
        if total_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the scratch page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if str(kv_dtype) not in ("float32", "int8"):
            raise ValueError("kv_dtype must be float32 or int8, got %r"
                             % (kv_dtype,))
        self.total_pages = int(total_pages)
        self.page_size = int(page_size)
        # int8 pages carry a parallel scales pool indexed by the same page
        # ids, so one free list and one conservation check cover both.
        # The byte costs (k+v codes per page, k+v scales per page) let
        # stats() report physical bytes and the per-token cost with the
        # scales spread over the page.
        self.kv_dtype = str(kv_dtype)
        self.page_bytes = int(page_bytes)
        self.scale_page_bytes = int(scale_page_bytes)
        self._lock = threading.Lock()
        # LIFO: freshly freed pages go back out first (warm reuse)
        self._free = list(range(self.total_pages - 1, SCRATCH_PAGE, -1))
        self._owned = {}   # owner -> [page, ...] in allocation order
        self._refs = {}    # page -> live reference count
        self.peak_used = 0
        self.counters = {"allocs": 0, "frees": 0, "failed_allocs": 0,
                         "leak_checks": 0}
        self.last_leak = []

    # -- allocation -------------------------------------------------------
    def alloc(self, owner, n=1):
        """Append ``n`` fresh (refcount-1) pages to ``owner``'s page
        list; returns the new pages.  Raises :class:`CacheOOM` when the
        free list is short (nothing is partially allocated), and
        whatever the ``kvcache.alloc`` fault site injects."""
        n = int(n)
        if n <= 0:
            return []
        faults.check("kvcache.alloc")
        with self._lock:
            if len(self._free) < n:
                self.counters["failed_allocs"] += 1
                raise CacheOOM(
                    "kv cache exhausted: want %d page(s), %d free of %d"
                    % (n, len(self._free), self.total_pages - 1))
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            self._owned.setdefault(owner, []).extend(pages)
            self.counters["allocs"] += n
            self.peak_used = max(self.peak_used, self._used_locked())
            return pages

    def _deref_locked(self, page):
        left = self._refs[page] - 1
        if left:
            self._refs[page] = left
        else:
            del self._refs[page]
            self._free.append(page)
            self.counters["frees"] += 1

    def free(self, owner):
        """Drop ALL of ``owner``'s page references (eviction, EOS,
        drain).  Returns the number of pages actually returned to the
        free list (shared pages survive under their other owners);
        unknown owners free 0 (idempotent — a preempted slot may race
        its own completion)."""
        with self._lock:
            pages = self._owned.pop(owner, None)
            if not pages:
                return 0
            freed0 = self.counters["frees"]
            # reversed: LIFO free list re-issues the owner's last pages
            # first, keeping page ids dense for the next sequence
            for p in reversed(pages):
                self._deref_locked(p)
            return self.counters["frees"] - freed0

    def pages(self, owner):
        """The owner's page list (copy), allocation order == token order."""
        with self._lock:
            return list(self._owned.get(owner, ()))

    def refcount(self, page):
        with self._lock:
            return self._refs.get(page, 0)

    # -- accounting -------------------------------------------------------
    def _used_locked(self):
        return (self.total_pages - 1) - len(self._free)

    @property
    def num_free(self):
        with self._lock:
            return len(self._free)

    @property
    def num_used(self):
        with self._lock:
            return self._used_locked()

    def occupancy(self):
        """Used fraction of the allocatable pool (scratch page excluded)."""
        with self._lock:
            cap = self.total_pages - 1
            return self._used_locked() / cap if cap else 0.0

    def owners(self):
        with self._lock:
            return sorted(self._owned, key=str)

    def _shared_locked(self):
        return sum(1 for c in self._refs.values() if c > 1)

    def check_leaks(self):
        """Conservation check: every allocatable page is either in the
        free list (refcount 0) or referenced by at least one owner list,
        with refcounts exactly matching the table references.  Raises
        the typed :class:`KVLeakError` (leaked/duplicated page ids
        attached) on violation; returns the owner count when clean."""
        with self._lock:
            self.counters["leak_checks"] += 1
            want = dict.fromkeys(range(1, self.total_pages), 0)
            bad = set()
            for pages in self._owned.values():
                for p in pages:
                    if p in want:
                        want[p] += 1
                    else:
                        bad.add(p)   # scratch or out-of-range id
            for p in self._free:
                if p not in want or want[p]:
                    bad.add(p)       # freed while referenced / bogus id
            free = set(self._free)
            if len(free) != len(self._free):
                bad |= {p for p in free if self._free.count(p) > 1}
            for p, n in want.items():
                have = self._refs.get(p, 0)
                in_free = p in free
                if n != have or (n == 0) == (not in_free):
                    # refcount drift, or a page neither free nor held
                    if not (n == 0 and have == 0 and in_free):
                        bad.add(p)
            if bad:
                self.last_leak = sorted(bad)
                raise KVLeakError(
                    "kv page conservation violated: %d page(s) leaked, "
                    "duplicated, or miscounted: %s"
                    % (len(bad), self.last_leak), pages=bad)
            self.last_leak = []
            return len(self._owned)

    def stats(self):
        with self._lock:
            cap = self.total_pages - 1
            used = self._used_locked()
            out = {
                "page_size": self.page_size,
                "total_pages": cap,
                "used_pages": used,
                "free_pages": len(self._free),
                "occupancy": round(used / cap, 4) if cap else 0.0,
                "peak_used_pages": self.peak_used,
                "owners": len(self._owned),
                "shared_pages": self._shared_locked(),
                "leaked_pages": len(self.last_leak),
                "kv_dtype": self.kv_dtype,
                "counters": dict(self.counters),
            }
            if self.page_bytes:
                per_page = self.page_bytes + self.scale_page_bytes
                out["scale_page_bytes"] = self.scale_page_bytes
                out["pool_bytes"] = per_page * cap
                out["used_bytes"] = per_page * used
                out["kv_bytes_per_token"] = round(
                    per_page / self.page_size, 2)
            return out
