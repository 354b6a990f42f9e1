"""Deterministic fault injection for resilience testing.

A copy of ``mxnet_tpu/faults.py`` carrying the sites the port's serving
slice has so far.  Sites (grep for ``faults.check``):

  decode.step        LLM decode engine, before one whole-batch decode
                     iteration (exception kinds poison the in-flight
                     decode batch typed; the engine keeps serving)
  engine.retire      async decode engine, before one in-flight step's
                     deferred host read (its CUDA event wait); exception
                     kinds typed-fail only that step's lanes, the rest of
                     the pipeline is discarded, and the engine keeps
                     serving
  kvcache.alloc      paged KV-cache page allocation (exception kinds fail
                     only the allocating sequence; genuine exhaustion is
                     NOT a fault — it triggers preemption)
  session.export     decode-session KV export (page table + pages read to
                     the host and packed); a raise aborts the export and
                     the session stays parked
  session.import     decode-session KV import (a blob scattered into fresh
                     pool pages); a raise fails the import typed and
                     installs nothing
  speculate.draft    speculative-decoding draft proposal (exception kinds
                     poison ONE sequence's adaptive-k controller: that
                     sequence degrades to plain decode, the engine keeps
                     serving)
  speculate.verify   speculative-decoding wide verify, before the step
                     (exception kinds degrade the whole step to plain
                     decode and poison the planned sequences' controllers;
                     no token is lost, no reset)

Kinds: ``reset`` (ConnectionResetError), ``timeout`` (socket.timeout),
``error``/``crash`` (RuntimeError), plus site-interpreted kinds that
``check`` *returns* instead of raising: ``drop`` (server kills the
connection without replying), ``torn`` (writer tears the file),
``preempt`` (trainer runs its graceful-preemption path), and ``kill``
(a serving replica hard-exits, SIGKILL-style — no drain, no cleanup).

Configuration — either the env spec (parsed once, on first check):

  MXNET_FAULT_SPEC = rule (";" rule)*
  rule  = site ":" kind [ "@" param ("," param)* ]
  param = "p=" FLOAT   trip with probability p (seeded, deterministic)
        | "n=" INT     trip every Nth call to the site
        | "max=" INT   stop tripping after this many trips (0 = no cap)
        | "seed=" INT  per-rule RNG seed override

  e.g. MXNET_FAULT_SPEC='kvstore.send:reset@p=0.05;checkpoint.write:torn@n=3'

or the context-manager API for tests:

  with faults.inject("kvstore.send", "reset", n=2):
      ...

Determinism: p-based rules draw from a private ``random.Random`` seeded
by (MXNET_FAULT_SEED, site, kind), so a run with a given spec trips the
same calls every time; n-based rules are counters.  Per-site trip
counters are exported through the profiler aggregate table
(``profiler.aggregate_stats()["events"]``) and ``faults.stats()``.
"""
from __future__ import annotations

import os
import random
import socket
import threading
import zlib
from contextlib import contextmanager

__all__ = ["FaultRule", "parse_spec", "inject", "install", "remove",
           "check", "trip", "stats", "reset"]

# kinds that raise from check(); anything else is returned to the site
_EXC_KINDS = {
    "reset": ConnectionResetError,
    "timeout": socket.timeout,
    "error": RuntimeError,
    "crash": RuntimeError,
}
# site-interpreted kinds check() hands back to the caller
_SOFT_KINDS = ("drop", "torn", "preempt", "kill")

KNOWN_SITES = ("decode.step", "engine.retire", "kvcache.alloc",
               "session.export", "session.import", "speculate.draft",
               "speculate.verify")


class FaultRule:
    """One (site, kind) trigger: probability- or every-Nth-call based."""

    def __init__(self, site, kind, p=0.0, n=0, max_trips=0, seed=None):
        if kind not in _EXC_KINDS and kind not in _SOFT_KINDS:
            raise ValueError("unknown fault kind %r (known: %s)"
                             % (kind, sorted(set(_EXC_KINDS) |
                                             set(_SOFT_KINDS))))
        if not p and not n:
            n = 1  # bare "site:kind" trips every call
        self.site = site
        self.kind = kind
        self.p = float(p)
        self.n = int(n)
        self.max_trips = int(max_trips)
        self.calls = 0
        self.trips = 0
        if seed is None:
            seed = int(os.environ.get("MXNET_FAULT_SEED", "0"))
        # decorrelate sites/kinds while staying deterministic per run
        self.rng = random.Random(
            zlib.crc32(("%d:%s:%s" % (seed, site, kind)).encode()))

    def should_trip(self):
        self.calls += 1
        if self.max_trips and self.trips >= self.max_trips:
            return False
        if self.n:
            hit = self.calls % self.n == 0
        else:
            hit = self.rng.random() < self.p
        if hit:
            self.trips += 1
        return hit

    def __repr__(self):
        trig = "n=%d" % self.n if self.n else "p=%g" % self.p
        return "FaultRule(%s:%s@%s trips=%d/%d calls)" % (
            self.site, self.kind, trig, self.trips, self.calls)


def parse_spec(spec):
    """``MXNET_FAULT_SPEC`` grammar → [FaultRule] (see module docstring)."""
    rules = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            head, _, tail = part.partition("@")
            site, _, kind = head.partition(":")
            site, kind = site.strip(), kind.strip()
            if not site or not kind:
                raise ValueError("expected site:kind")
            kwargs = {}
            if tail:
                for item in tail.replace("@", ",").split(","):
                    k, _, v = item.partition("=")
                    k = k.strip()
                    if k == "p":
                        kwargs["p"] = float(v)
                    elif k == "n":
                        kwargs["n"] = int(v)
                    elif k == "max":
                        kwargs["max_trips"] = int(v)
                    elif k == "seed":
                        kwargs["seed"] = int(v)
                    else:
                        raise ValueError("unknown param %r" % k)
            rules.append(FaultRule(site, kind, **kwargs))
        except ValueError as e:
            raise ValueError(
                "bad MXNET_FAULT_SPEC rule %r: %s (grammar: "
                "site:kind[@p=F|n=I[,max=I][,seed=I]] joined by ';')"
                % (part, e)) from None
    return rules


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.rules = {}  # site -> [FaultRule]
        self.tripped = {}  # site -> total trips (survives rule removal)
        self._env_loaded = False

    def _load_env_locked(self):
        self._env_loaded = True
        spec = os.environ.get("MXNET_FAULT_SPEC", "")
        for rule in parse_spec(spec):
            self.rules.setdefault(rule.site, []).append(rule)

    def install(self, rule):
        with self.lock:
            if not self._env_loaded:
                self._load_env_locked()
            self.rules.setdefault(rule.site, []).append(rule)

    def remove(self, rule):
        with self.lock:
            lst = self.rules.get(rule.site, [])
            if rule in lst:
                lst.remove(rule)
            if not lst:
                self.rules.pop(rule.site, None)

    def trip(self, site):
        with self.lock:
            if not self._env_loaded:
                self._load_env_locked()
            for rule in self.rules.get(site, ()):
                if rule.should_trip():
                    self.tripped[site] = self.tripped.get(site, 0) + 1
                    total = self.tripped[site]
                    kind = rule.kind
                    break
            else:
                return None
        # export outside the lock: profiler has its own locking
        from . import profiler
        profiler.record_event_stat("fault.%s" % site)
        profiler.record_counter("fault.%s" % site, trips=total)
        return kind

    def stats(self):
        with self.lock:
            out = {}
            for site, lst in self.rules.items():
                out[site] = [{"kind": r.kind, "calls": r.calls,
                              "trips": r.trips} for r in lst]
            return {"rules": out, "tripped": dict(self.tripped)}

    def reset(self):
        with self.lock:
            self.rules.clear()
            self.tripped.clear()
            self._env_loaded = False  # re-read MXNET_FAULT_SPEC lazily


_REG = _Registry()


def install(rule):
    """Install a FaultRule (removed with remove())."""
    _REG.install(rule)
    return rule


def remove(rule):
    _REG.remove(rule)


@contextmanager
def inject(site, kind, p=0.0, n=0, max_trips=0, seed=None):
    """Scoped injection for tests::

        with faults.inject("server.apply", "drop", n=1, max_trips=1):
            kv.push(...)
    """
    rule = FaultRule(site, kind, p=p, n=n, max_trips=max_trips, seed=seed)
    _REG.install(rule)
    try:
        yield rule
    finally:
        _REG.remove(rule)


def trip(site):
    """Evaluate the site's rules; returns the tripped kind (or None)
    WITHOUT raising.  Prefer check() at real sites."""
    return _REG.trip(site)


def check(site):
    """The injection point: raises the mapped exception for exception
    kinds, returns soft kinds ('drop', 'torn') for the site to act on,
    returns None when nothing trips.  Near-zero cost with no spec/rules
    installed."""
    reg = _REG
    if reg._env_loaded and not reg.rules:
        return None
    kind = reg.trip(site)
    if kind is None:
        return None
    exc = _EXC_KINDS.get(kind)
    if exc is not None:
        raise exc("injected %s fault at %s" % (kind, site))
    return kind


def stats():
    """{'rules': {site: [{kind, calls, trips}]}, 'tripped': {site: n}}."""
    return _REG.stats()


def reset():
    """Drop installed rules and counters; MXNET_FAULT_SPEC is re-read on
    the next check() (tests flip the env between cases)."""
    _REG.reset()
