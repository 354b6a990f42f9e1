"""Speculative decoding: draft and verify with exact greedy acceptance.

The port of ``mxnet_tpu/serving/speculate.py``.  A *drafter* proposes up
to ``k`` continuation tokens per decode slot, the target model scores all
``k + 1`` positions in ONE wide verify step
(``models.decoder.make_verify_step``), and longest-prefix acceptance keeps
whatever matches the target's own greedy choices.  Every accepted draft
token plus the verify's last argmax is emitted in one engine step, so a
step can produce ``accepted + 1`` tokens, while the emitted stream stays
the one plain decode would give (Leviathan et al. 2023: with greedy
sampling, exact acceptance is prefix matching).

Rejected positions leave KV in the slot's pages that the causal mask
never reads; the engine hands the pages they opened back through
``PageAllocator.trim`` (copy-on-write aware, ``DecodeEngine._rollback_kv``)
so page accounting stays exact and ``check_leaks()`` clean under any
rejection stream.

Drafters, cheapest first:

- :class:`NGramDrafter` — prompt-lookup decoding (Saxena 2023): the
  transcript's trailing n-gram is matched against its own earlier
  occurrences and the tokens that followed are proposed.  No weights, no
  launches; it pays off on repetitive streams.
- :class:`DraftModelDrafter` — a small ``CausalLM`` sharing the target's
  vocab, decoding ``k`` tokens ahead against its OWN paged KV pool on the
  engine's device, through the port's per-op decode step and prefill
  chunk (the paged-attention and bias_gelu kernels on the card, on the
  engine's stream: the worker thread calls it).

:class:`SpeculativeScheduler` closes the loop per sequence with an
:class:`AdaptiveK` controller: an EMA of the accepted rate opens ``k``
toward the ``MXNET_GEN_SPEC_K`` cap while drafts land and walks it down to
0 (speculation off for that sequence) when acceptance collapses.

Fault sites (``mxnet_tpu_torch.faults``): ``speculate.draft`` trips inside
the propose path and poisons only that sequence's controller;
``speculate.verify`` trips before the wide step and degrades the whole
step to plain decode.  Both leave the engine serving.
"""
from __future__ import annotations

import collections
import logging

import numpy as onp
import torch

from .. import config as _config
from .. import faults
from ..models import decoder as _decoder
from .kvcache import CacheOOM, PageAllocator, pages_for

__all__ = ["Drafter", "NGramDrafter", "DraftModelDrafter", "AdaptiveK",
           "SpeculativeScheduler"]

_log = logging.getLogger(__name__)


class Drafter:
    """Propose up to ``k`` continuation tokens for one sequence.

    ``context`` is the sequence's whole transcript — prompt, generated
    history and the pending last token the target has not consumed yet —
    so a drafter sees exactly what the target will extend.  Fewer than
    ``k`` tokens (or none) shrink this step's speculation; that is never
    an error."""

    name = "null"
    #: whether :meth:`propose` queues work on the engine's stream and reads
    #: it back: such a drafter waits for any verify in flight, so the async
    #: engine drafts for it at launch only, never overlapped
    on_device = False

    def propose(self, owner, context, k):
        return []

    def release(self, owner):
        """Drop any per-sequence state (the sequence finished, failed or
        was preempted: its cache positions are stale)."""

    def stats(self):
        return {}


class NGramDrafter(Drafter):
    """Prompt-lookup decoding: the transcript's trailing n-gram (longest n
    first, the most recent match with a full continuation winning) is
    matched against its own earlier occurrences and the tokens that
    followed are the draft."""

    name = "ngram"

    def __init__(self, max_ngram=None, min_ngram=1):
        self.max_ngram = max(1, int(
            max_ngram if max_ngram is not None
            else _config.get("MXNET_GEN_SPEC_NGRAM")))
        self.min_ngram = max(1, int(min_ngram))
        self.proposals = 0
        self.misses = 0

    def propose(self, owner, context, k):
        ctx = list(context)
        n_ctx = len(ctx)
        k = int(k)
        for n in range(min(self.max_ngram, n_ctx - 1),
                       self.min_ngram - 1, -1):
            pat = ctx[-n:]
            best = None
            for j in range(n_ctx - n - 1, -1, -1):
                if ctx[j:j + n] == pat:
                    out = ctx[j + n:j + n + k]
                    if len(out) >= k:
                        best = out   # the most recent full continuation
                        break
                    # a match close to the suffix cuts its continuation
                    # short; on cyclic content an earlier one carries k
                    if out and (best is None or len(out) > len(best)):
                        best = out
            if best:
                self.proposals += 1
                return best
        self.misses += 1
        return []

    def stats(self):
        return {"proposals": self.proposals, "misses": self.misses}


class DraftModelDrafter(Drafter):
    """A small ``CausalLM`` drafter with its own paged KV pool.

    The draft pool tracks each sequence's CONFIRMED transcript only: each
    :meth:`propose` first catches the pool up to ``context[:-1]`` (chunks
    of ``prefill_chunk`` tokens of what the target accepted since), then
    runs ``k`` greedy one-token decode steps, then trims its own lookahead
    pages back (``PageAllocator.trim``, the engine's rollback primitive).
    The lookahead steps chain on the card (each step's token feeds the
    next without a host read) and the ``k`` tokens come back in one copy.
    Pool pressure evicts peer sequences' draft caches (they re-prefill,
    the model is small); a sequence that cannot be placed proposes
    nothing."""

    name = "model"
    on_device = True

    def __init__(self, model, page_size=8, total_pages=None,
                 prefill_chunk=16, max_seqs=8):
        self.model = model
        self.cfg = model.config
        self.params = model.params()
        self.device = model.device
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk)
        self.max_ctx = self.cfg.max_length
        self.pages_per_seq = pages_for(self.max_ctx, self.page_size)
        total = int(total_pages or 0)
        if not total:
            total = int(max_seqs) * self.pages_per_seq + 1
        self.alloc = PageAllocator(total, self.page_size)
        shape = (self.cfg.num_layers, self.cfg.num_kv_heads, total,
                 self.page_size, self.cfg.head_dim)
        self._kp = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._vp = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._pos = {}   # owner -> confirmed tokens in the draft pool
        self._decode_fn = _decoder.make_decode_step(self.cfg, self.page_size)
        self._prefill_fn = _decoder.make_prefill_chunk(
            self.cfg, self.page_size, self.prefill_chunk)

    def _row(self, owner):
        row = onp.zeros(self.pages_per_seq, onp.int32)
        pages = self.alloc.pages(owner)
        row[:len(pages)] = pages
        return torch.from_numpy(row).to(self.device)

    def _ensure(self, owner, tokens_total):
        """Grow the owner's draft pages to hold ``tokens_total`` positions,
        evicting peer draft caches under pressure.  Returns False when even
        a drained pool cannot fit it."""
        while True:
            need = (pages_for(tokens_total, self.page_size)
                    - len(self.alloc.pages(owner)))
            if need <= 0:
                return True
            try:
                self.alloc.alloc(owner, need)
                return True
            except CacheOOM:
                victims = [o for o in self.alloc.owners() if o != owner]
                if not victims:
                    return False
                self.release(victims[0])

    @torch.no_grad()
    def propose(self, owner, context, k):
        want = len(context) - 1     # cache all but the pending token
        if want < 0:
            return []
        st = self._pos.get(owner, 0)
        if st > want:
            # the target rolled this sequence back (preempt, replay): the
            # draft pool is ahead of it; rebuild from scratch
            self.release(owner)
            st = 0
        # the lookahead writes land at want .. want + k - 1
        k = min(int(k), self.max_ctx - want)
        if k <= 0 or not self._ensure(owner, want + k):
            return []
        dev = self.device
        row = self._row(owner)
        while st < want:            # catch up on the confirmed transcript
            n = min(self.prefill_chunk, want - st)
            padded = onp.zeros(self.prefill_chunk, onp.int64)
            padded[:n] = context[st:st + n]
            self._prefill_fn(self.params, self._kp, self._vp,
                             torch.from_numpy(padded).to(dev), st, n, row)
            st += n
        self._pos[owner] = want
        rows = row[None]
        active = torch.ones(1, dtype=torch.bool, device=dev)
        positions = torch.arange(want, want + k, dtype=torch.int64,
                                 device=dev)
        last = torch.tensor([int(context[-1])], dtype=torch.int64,
                            device=dev)
        toks = []
        for i in range(k):          # greedy k-step lookahead, B = 1
            _, _, last, _ = self._decode_fn(
                self.params, self._kp, self._vp, last, positions[i:i + 1],
                rows, active)
            toks.append(last)
        out = [int(t) for t in torch.cat(toks).cpu()]
        # the lookahead writes are speculative: trim back so that only
        # confirmed tokens stay accounted (the next catch-up overwrites
        # any rolled-back offset before it is read)
        self.alloc.trim(owner, pages_for(want, self.page_size))
        return out

    def release(self, owner):
        self.alloc.free(owner)
        self._pos.pop(owner, None)

    def stats(self):
        return {"sequences": len(self._pos), "kv": self.alloc.stats()}


class AdaptiveK:
    """Per-sequence speculation-depth controller.

    An EMA of the accepted rate (accepted / drafted per verify) steers
    ``k``: above ``hi`` it opens one step toward the cap, below ``lo`` it
    closes one step, and a sequence whose acceptance drives ``k`` to zero
    latches *disabled* (plain decode from then on; the fault sites poison
    the same latch).  Starting at ``k = 1``, a hostile stream pays at most
    one wasted draft before it collapses."""

    __slots__ = ("cap", "k", "ema", "alpha", "lo", "hi", "disabled")

    def __init__(self, cap, alpha=0.4, lo=0.25, hi=0.6):
        self.cap = max(0, int(cap))
        self.k = min(1, self.cap)
        self.ema = None
        self.alpha = float(alpha)
        self.lo = float(lo)
        self.hi = float(hi)
        self.disabled = self.cap == 0

    def current(self):
        return 0 if self.disabled else self.k

    def update(self, drafted, accepted):
        if drafted <= 0:
            return
        rate = accepted / float(drafted)
        self.ema = rate if self.ema is None else (
            self.alpha * rate + (1.0 - self.alpha) * self.ema)
        if self.ema < self.lo:
            self.k -= 1
            if self.k <= 0:
                self.k = 0
                self.disabled = True
        elif self.ema > self.hi and not self.disabled:
            self.k = min(self.k + 1, self.cap)

    def poison(self):
        self.k = 0
        self.disabled = True


class SpeculativeScheduler:
    """The DecodeEngine's per-step speculation policy.

    Owns the drafter and one :class:`AdaptiveK` controller per sequence
    key (the session id of a session request, so that acceptance learned
    in one turn carries to the next, else the slot's owner).  The engine
    asks :meth:`budget` for each decode slot's depth, drafts through
    :meth:`propose`, gates the wide step on :meth:`verify_gate`, and
    reports acceptance through :meth:`observe`.  Faults degrade to plain
    decode by poisoning controllers; the engine never stops serving on a
    speculation failure."""

    #: bound on retained per-sequence controllers (LRU evicted)
    MAX_CONTROLLERS = 4096

    def __init__(self, drafter, k_cap=None, name="llm"):
        self.drafter = drafter
        self.k_cap = max(0, int(k_cap if k_cap is not None
                                else _config.get("MXNET_GEN_SPEC_K")))
        self.name = name
        self._ctl = collections.OrderedDict()
        self.counters = {"proposals": 0, "empty_drafts": 0,
                         "draft_faults": 0, "verify_faults": 0,
                         "predraft_hits": 0, "predraft_misses": 0}

    def _controller(self, key):
        c = self._ctl.get(key)
        if c is None:
            c = self._ctl[key] = AdaptiveK(self.k_cap)
            while len(self._ctl) > self.MAX_CONTROLLERS:
                self._ctl.popitem(last=False)
        else:
            self._ctl.move_to_end(key)
        return c

    def budget(self, key, max_k):
        """Speculation depth for this sequence this step (0: plain)."""
        return max(0, min(self._controller(key).current(), int(max_k)))

    def propose(self, key, owner, context, k):
        """Draft up to ``k`` tokens.  A ``speculate.draft`` fault (or a
        drafter bug) poisons only this sequence's controller and proposes
        nothing: the slot decodes plainly from then on."""
        try:
            faults.check("speculate.draft")
            out = list(self.drafter.propose(owner, context, k))[:int(k)]
        except Exception as e:
            self.counters["draft_faults"] += 1
            self._controller(key).poison()
            _log.warning("drafter fault for %r: %r (sequence degraded to "
                         "plain decode)", key, e)
            return []
        if out:
            self.counters["proposals"] += 1
        else:
            self.counters["empty_drafts"] += 1
        return out

    def verify_gate(self, keys):
        """The ``speculate.verify`` fault site, checked before the wide
        step: a trip poisons every planned sequence's controller and
        returns False; the engine runs this step as plain decode."""
        try:
            faults.check("speculate.verify")
            return True
        except Exception as e:
            self.counters["verify_faults"] += 1
            for key in keys:
                self._controller(key).poison()
            _log.warning("verify fault: %r (step degraded to plain decode)",
                         e)
            return False

    def reuse_predraft(self, pre, emitted, k):
        """Overlapped drafting (async engine): ``pre`` was proposed from
        the context at launch time, before the verify it overlapped had
        emitted anything, with extra lookahead.  If its head predicted
        this step's emission exactly, its tail is a valid draft for the
        context after the emission and the next verify launches without a
        fresh drafting pass.  Any draft is safe under longest-prefix
        acceptance, so a miss only costs the overlap.

        Returns the reusable tail (possibly empty) on a hit, or None."""
        if pre is None or k <= 0:
            return None
        m = len(emitted)
        tail = [int(t) for t in pre[m:m + int(k)]]
        if len(pre) > m and tail \
                and list(pre[:m]) == [int(t) for t in emitted]:
            self.counters["predraft_hits"] += 1
            return tail
        self.counters["predraft_misses"] += 1
        return None

    def observe(self, key, drafted, accepted):
        self._controller(key).update(drafted, accepted)

    def release(self, owner, key=None):
        """Drop the drafter's per-sequence state (and, with ``key``, the
        controller: a session keeps its learned k across turns until the
        session itself ends)."""
        self.drafter.release(owner)
        if key is not None:
            self._ctl.pop(key, None)

    def stats(self):
        out = {"drafter": self.drafter.name, "k_cap": self.k_cap,
               "controllers": len(self._ctl),
               "counters": dict(self.counters)}
        d = self.drafter.stats()
        if d:
            out["drafter_stats"] = d
        return out
