"""Page-granular KV-cache allocator, prefix cache and session wire format.

A copy of ``mxnet_tpu/serving/kvcache.py``: everything here runs on the
host, so both packages share one allocator behaviour (int8 page accounting
included), one prefix cache and one session wire format.  Blobs are numpy
arrays in and out, so either package reads the other's.

The vLLM memory model at the serving layer: the device-side KV cache is
a fixed pool of ``total_pages`` pages of ``page_size`` tokens each
(``ops/kernels/paged_attention.py`` owns the device layout and the
attention over it); this module owns the HOST-side bookkeeping —

- a LIFO **free list** (freed pages are re-used hottest-first),
- per-owner **page lists** (the sequence's page table, in allocation
  order == token order),
- per-page **refcounts**: a page may appear in several owners' page
  tables at once (prefix sharing); it returns to the free list only when
  the last reference drops.  :meth:`PageAllocator.share` attaches
  existing pages to another owner, :meth:`PageAllocator.fork` is the
  copy-on-write bookkeeping half (the caller copies the device contents,
  ``paged_attention.copy_page``),
- exact **occupancy accounting** (used/total, peak, shared pages,
  alloc/free/fail counters) — the admission-control signal and the
  serving metric.

Page 0 is reserved as the *scratch page*: inactive batch slots and
padded prefill tokens scatter their (garbage) KV there, so the decode
step never needs a dynamic shape or a host round-trip to mask writes.
It is excluded from the free list and from occupancy math.

On top of the allocator:

- :func:`pack_session` / :func:`unpack_session` — the flat, CRC-guarded
  wire format for one session's page table + live pages (the engine
  owns gathering and scattering the device tensors),
- :class:`PrefixCache` — content-addressed prompt-prefix pages (full
  pages keyed by their exact token prefix, plus the trailing partial
  page), shared copy-on-write so N sequences with a common system
  prompt pay its prefill once.

Tensor-parallel serving changes none of this bookkeeping: the port's
pool is one tensor on the card whatever the tp, and every shard reads
its KV heads' slab of the same pages.

The allocator is synchronous and oblivious to device timing: a freed
page goes back on the (LIFO) free list immediately and may be handed
out on the very next ``alloc``.  The async engine therefore treats
pages referenced by a launched-but-unretired step as PINNED and defers
such frees onto the pinning step's retire (``generate._free_owner``).
Once the pipeline drains, occupancy returns to zero and
``check_leaks`` is clean.

Fault site ``kvcache.alloc`` (``mxnet_tpu_torch.faults``) trips inside
:meth:`PageAllocator.alloc`, so chaos tests can fail allocations
deterministically; genuine exhaustion raises :class:`CacheOOM`, which
the decode engine turns into preemption (evict-youngest + recompute)
rather than an error.  Invariant violations raise the typed
:class:`~.errors.KVLeakError` from :meth:`PageAllocator.check_leaks`.
"""
from __future__ import annotations

import json
import struct
import threading
import zlib

import numpy as onp

from .. import faults
from .errors import KVLeakError

__all__ = ["CacheOOM", "PageAllocator", "PrefixCache", "pages_for",
           "pack_session", "unpack_session"]

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
    :meth:`share` bumps it (prefix hits, cache retention), and
    :meth:`free`/:meth:`fork` drop references — the page rejoins the
    free list only at refcount zero, so occupancy counts every
    physically-resident page exactly once however many tables map it.
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
        # quantized pools: int8 pages carry a parallel scales
        # pool indexed by the SAME page ids, so one refcount/free-list
        # conservation check covers both pools — check_leaks needs no
        # second ledger.  The byte costs are optional engine-supplied
        # geometry (k+v codes per page, k+v scales per page) so stats()
        # can report physical bytes and the per-token cost with the
        # scales amortized over the page.
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
                         "shares": 0, "forks": 0, "trims": 0,
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

    def share(self, owner, pages):
        """Attach already-live ``pages`` to ``owner``'s table as shared
        (read-only by convention) references — the prefix-cache hit
        path.  Refcounts go up; occupancy does not."""
        pages = list(pages)
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError("share: page %d is not live" % p)
            for p in pages:
                self._refs[p] += 1
            self._owned.setdefault(owner, []).extend(pages)
            self.counters["shares"] += len(pages)
        return pages

    def fork(self, owner, page):
        """Copy-on-write bookkeeping: replace ``owner``'s reference to a
        shared ``page`` with a fresh private page (same position in the
        table) and drop the shared reference.  Returns the new page id;
        the CALLER must copy the device contents old -> new before
        writing.  Raises :class:`CacheOOM` when no page is free."""
        with self._lock:
            table = self._owned.get(owner)
            if not table or page not in table:
                raise ValueError("fork: owner %r does not hold page %d"
                                 % (owner, page))
            if not self._free:
                self.counters["failed_allocs"] += 1
                raise CacheOOM("kv cache exhausted: fork needs 1 page")
            new = self._free.pop()
            self._refs[new] = 1
            table[table.index(page)] = new
            self._deref_locked(page)
            self.counters["allocs"] += 1
            self.counters["forks"] += 1
            self.peak_used = max(self.peak_used, self._used_locked())
            return new

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

    def trim(self, owner, keep):
        """Truncate ``owner``'s page list to its first ``keep`` pages,
        dereferencing the tail in reverse allocation order — the
        speculative-decode rollback primitive (rejected draft tokens
        hand their pages straight back).  Copy-on-write aware the same
        way :meth:`free` is: a trimmed page that other owners (a prefix
        cache entry, a peer sequence) still reference only drops this
        owner's refcount and stays resident; it rejoins the free list at
        refcount zero.  The page CONTAINING the new write boundary is
        kept — when it is shared, the caller must :meth:`fork` it before
        re-writing rolled-back offsets (the JAX engine's speculative
        rollback does; the port has no caller yet).  Returns the number
        of references dropped; unknown owners and ``keep >= len(pages)``
        trim 0 (idempotent).
        """
        keep = max(0, int(keep))
        with self._lock:
            pages = self._owned.get(owner)
            if pages is None or len(pages) <= keep:
                return 0
            tail = pages[keep:]
            del pages[keep:]
            if not pages:
                del self._owned[owner]
            # reversed: LIFO free list re-issues the rolled-back pages
            # first, same warm-reuse policy as free()
            for p in reversed(tail):
                self._deref_locked(p)
            self.counters["trims"] += 1
            return len(tail)

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
        with refcounts exactly matching the table references.  With an
        int8 pool the per-page scales ride the SAME page ids as the
        codes (``QPages`` keeps the two device arrays parallel), so
        this single check conserves the scales pool too — a page id can
        no more leak its scale row than its code block.  Raises
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
                # physical footprint incl. the int8 scales pool, and the
                # per-resident-token cost with scales amortized over the
                # page
                per_page = self.page_bytes + self.scale_page_bytes
                out["scale_page_bytes"] = self.scale_page_bytes
                out["pool_bytes"] = per_page * cap
                out["used_bytes"] = per_page * used
                out["kv_bytes_per_token"] = round(
                    per_page / self.page_size, 2)
            return out


# -- session wire format --------------------------------------------------
#
# One exported session is a flat self-describing buffer:
#
#   v1: b"MXKV" | u32 header_len | header JSON | k_pages | v_pages
#   v2: b"MXKV" | u32 header_len | header JSON | k_pages | v_pages
#                                              | k_scales | v_scales
#
# The header carries the session metadata dict, the block shape/dtype of
# the gathered pages (layers, kv_heads, n_pages, page_size, head_dim),
# and a CRC32 over the raw page bytes — a torn transfer fails loudly at
# import instead of decoding against garbage.  numpy round-trips the
# bytes exactly, so serialize -> ship -> import is bit-identical (the
# oracle the migration tests pin).
#
# Format v2 carries an int8-quantized cache: the header gains
# ``kv_dtype`` plus the scales blocks' dtype/shape and their OWN CRC —
# scales are ~1/(4*head_dim) of the payload but corrupting one poisons a
# whole page of tokens, so they fail independently and loudly.  A v1
# blob (no ``kv_dtype`` key) still unpacks: old fp sessions keep
# migrating into new replicas unchanged.

_MAGIC = b"MXKV"
_U32 = struct.Struct(">I")


def pack_session(meta, k_block, v_block, k_scales=None, v_scales=None):
    """Serialize one session: ``meta`` (JSON-safe dict) plus the k/v
    page blocks (numpy arrays, identical shape/dtype) into one buffer.
    With ``k_scales``/``v_scales`` (int8 pages: per-(layer, kv_head,
    page) f32 scales) the blob is format v2; without, the v1 wire is
    emitted byte-for-byte as before."""
    k = onp.ascontiguousarray(k_block)
    v = onp.ascontiguousarray(v_block)
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError("pack_session: k/v block shape or dtype mismatch")
    kb, vb = k.tobytes(), v.tobytes()
    head = {
        "v": 1,
        "meta": meta,
        "dtype": k.dtype.str,
        "shape": list(k.shape),
        "crc": zlib.crc32(vb, zlib.crc32(kb)) & 0xFFFFFFFF,
    }
    tail = []
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pack_session: k/v scales must come together")
    if k_scales is not None:
        ks = onp.ascontiguousarray(k_scales)
        vs = onp.ascontiguousarray(v_scales)
        if ks.shape != vs.shape or ks.dtype != vs.dtype:
            raise ValueError(
                "pack_session: k/v scales shape or dtype mismatch")
        ksb, vsb = ks.tobytes(), vs.tobytes()
        head["v"] = 2
        head["kv_dtype"] = onp.dtype(k.dtype).name
        head["s_dtype"] = ks.dtype.str
        head["s_shape"] = list(ks.shape)
        head["s_crc"] = zlib.crc32(vsb, zlib.crc32(ksb)) & 0xFFFFFFFF
        tail = [ksb, vsb]
    header = json.dumps(head).encode("utf-8")
    return b"".join([_MAGIC, _U32.pack(len(header)), header, kb, vb]
                    + tail)


def unpack_session(blob, with_scales=False):
    """Inverse of :func:`pack_session`; returns ``(meta, k_block,
    v_block)``, or ``(meta, k_block, v_block, k_scales, v_scales)``
    with ``with_scales=True`` (the scales are ``None`` for a v1/fp
    blob).  Raises ``ValueError`` on a torn or corrupt buffer (bad
    magic, truncation, CRC mismatch on either the page payload or the
    v2 scales payload)."""
    if len(blob) < len(_MAGIC) + _U32.size or blob[:4] != _MAGIC:
        raise ValueError("unpack_session: bad magic (torn transfer?)")
    (hlen,) = _U32.unpack_from(blob, 4)
    off = 4 + _U32.size
    if len(blob) < off + hlen:
        raise ValueError("unpack_session: truncated header")
    header = json.loads(blob[off:off + hlen].decode("utf-8"))
    off += hlen
    dtype = onp.dtype(header["dtype"])
    shape = tuple(header["shape"])
    nbytes = dtype.itemsize * int(onp.prod(shape)) if shape else 0
    quantized = "kv_dtype" in header
    if quantized:
        s_dtype = onp.dtype(header["s_dtype"])
        s_shape = tuple(header["s_shape"])
        snbytes = (s_dtype.itemsize * int(onp.prod(s_shape))
                   if s_shape else 0)
    else:
        snbytes = 0
    if len(blob) != off + 2 * nbytes + 2 * snbytes:
        raise ValueError("unpack_session: truncated page payload "
                         "(%d != %d)"
                         % (len(blob) - off, 2 * nbytes + 2 * snbytes))
    kb = blob[off:off + nbytes]
    vb = blob[off + nbytes:off + 2 * nbytes]
    crc = zlib.crc32(vb, zlib.crc32(kb)) & 0xFFFFFFFF
    if crc != header["crc"]:
        raise ValueError("unpack_session: CRC mismatch (torn transfer)")
    k = onp.frombuffer(kb, dtype=dtype).reshape(shape)
    v = onp.frombuffer(vb, dtype=dtype).reshape(shape)
    ks = vs = None
    if quantized:
        soff = off + 2 * nbytes
        ksb = blob[soff:soff + snbytes]
        vsb = blob[soff + snbytes:soff + 2 * snbytes]
        scrc = zlib.crc32(vsb, zlib.crc32(ksb)) & 0xFFFFFFFF
        if scrc != header["s_crc"]:
            raise ValueError(
                "unpack_session: scales CRC mismatch (torn transfer)")
        ks = onp.frombuffer(ksb, dtype=s_dtype).reshape(s_shape)
        vs = onp.frombuffer(vsb, dtype=s_dtype).reshape(s_shape)
    if with_scales:
        return header["meta"], k, v, ks, vs
    return header["meta"], k, v


# -- prefix cache ---------------------------------------------------------
class _PrefixEntry:
    __slots__ = ("key", "page", "tokens", "partial", "owner", "tick")

    def __init__(self, key, page, tokens, partial, owner, tick):
        self.key = key          # exact token prefix this page completes
        self.page = page
        self.tokens = tokens    # cache positions this entry vouches for
        self.partial = partial  # True: trailing partially-filled page
        self.owner = owner      # allocator owner holding the cache's ref
        self.tick = tick        # LRU clock


class PrefixCache:
    """Content-addressed prompt-prefix pages, shared copy-on-write.

    Full pages are keyed by the exact token prefix they complete
    (position-dependent KV makes anything weaker unsound); the trailing
    partial page of a prompt is cached too, keyed by the full prefix it
    holds.  A lookup returns the longest chain of cached pages covering
    a strict prefix of the prompt (at least one token is always left to
    prefill — its logits seed generation).  The cache holds one
    allocator reference per entry, so hit pages stay live across the
    inserting sequence's exit; eviction is LRU and only reclaims pool
    space once no sequence shares the page.

    Writers never mutate a shared full page (decode appends past it);
    a hit on a *partial* page is forked copy-on-write by the engine
    before its first write lands (``cow_forks`` in the metrics).
    """

    def __init__(self, alloc):
        self.alloc = alloc
        self._lock = threading.Lock()
        self._entries = {}   # key tuple -> _PrefixEntry
        self._serial = 0
        self._tick = 0
        self.counters = {"hits": 0, "misses": 0, "inserts": 0,
                         "evictions": 0, "tokens_saved": 0}

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def lookup(self, prompt):
        """Longest cached cover of a strict prefix of ``prompt``;
        returns ``(pages, covered_tokens, partial_hit)`` (all falsy on
        a miss).  The returned pages are NOT yet referenced — the
        caller must :meth:`PageAllocator.share` them immediately."""
        S = self.alloc.page_size
        limit = len(prompt) - 1          # always leave >=1 token to prefill
        with self._lock:
            self._tick += 1
            pages, covered = [], 0
            while covered + S <= limit:
                e = self._entries.get(tuple(prompt[:covered + S]))
                if e is None or e.partial:
                    break
                e.tick = self._tick
                pages.append(e.page)
                covered += S
            partial = False
            for m in range(min(S - 1, limit - covered), 0, -1):
                e = self._entries.get(tuple(prompt[:covered + m]))
                if e is not None and e.partial:
                    e.tick = self._tick
                    pages.append(e.page)
                    covered += m
                    partial = True
                    break
            if covered:
                self.counters["hits"] += 1
                self.counters["tokens_saved"] += covered
            else:
                self.counters["misses"] += 1
            return pages, covered, partial

    def insert(self, tokens, owner_pages):
        """Publish a freshly-prefilled sequence's pages: every full page
        (and the trailing partial one) becomes a cache entry under its
        exact prefix key, with the cache taking one shared reference.
        Existing entries win (first writer published identical KV)."""
        S = self.alloc.page_size
        new = 0
        with self._lock:
            self._tick += 1
            nfull = len(tokens) // S
            for i in range(min(nfull, len(owner_pages))):
                new += self._insert_locked(tuple(tokens[:(i + 1) * S]),
                                           owner_pages[i], S, False)
            m = len(tokens) - nfull * S
            if m and nfull < len(owner_pages):
                new += self._insert_locked(tuple(tokens),
                                           owner_pages[nfull], m, True)
        return new

    def _insert_locked(self, key, page, tokens, partial):
        if key in self._entries:
            self._entries[key].tick = self._tick
            return 0
        self._serial += 1
        owner = ("pfx", self._serial)
        try:
            self.alloc.share(owner, [page])
        except ValueError:      # page raced off (owner already freed)
            return 0
        self._entries[key] = _PrefixEntry(key, page, tokens, partial,
                                          owner, self._tick)
        self.counters["inserts"] += 1
        return 1

    def evict_one(self):
        """Drop the LRU entry (pool pressure).  Returns True when an
        entry was dropped — its page rejoins the pool only if no
        sequence still shares it."""
        with self._lock:
            if not self._entries:
                return False
            key = min(self._entries.values(), key=lambda e: e.tick).key
            e = self._entries.pop(key)
            self.counters["evictions"] += 1
        self.alloc.free(e.owner)
        return True

    def clear(self):
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            self.alloc.free(e.owner)
        return len(entries)

    def stats(self):
        with self._lock:
            return {"entries": len(self._entries),
                    "counters": dict(self.counters)}
