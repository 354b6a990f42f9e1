"""Host-side profiler counters and per-op aggregate statistics.

The half of ``mxnet_tpu/profiler.py`` that the serving layer calls
(``serving/metrics.py``, ``faults.py``): chrome-trace counter samples
while a trace is recording, and the always-on aggregate tables of op
timings and discrete events.  Device-side tracing is left to
``torch.profiler``.
"""
from __future__ import annotations

import json
import os
import threading
import time

_STATE = {
    "config": {"filename": "profile.json"},
    "running": False,
    "events": [],
    "lock": threading.Lock(),
}

# per-op aggregate statistics; enabled by set_config(aggregate_stats=True)
_AGG = {
    "enabled": False,
    "ops": {},      # name -> [count, total_s, min_s, max_s]
    "events": {},   # name -> count (always on: fault trips)
    "lock": threading.Lock(),
}


def record_op_stat(name, dur_s):
    """Accumulate one op dispatch into the aggregate table (hot path:
    callers check _AGG['enabled'] first)."""
    with _AGG["lock"]:
        st = _AGG["ops"].get(name)
        if st is None:
            _AGG["ops"][name] = [1, dur_s, dur_s, dur_s]
        else:
            st[0] += 1
            st[1] += dur_s
            if dur_s < st[2]:
                st[2] = dur_s
            if dur_s > st[3]:
                st[3] = dur_s


def record_counter(name, **values):
    """Emit one chrome-trace counter sample when a trace is recording,
    else a no-op."""
    if _STATE["running"]:
        _emit(name, "counter", "C", time.time(), dict(values))


def record_event_stat(name, n=1):
    """Count a discrete event (fault-injection trip).  Not gated on
    aggregate_stats=True; read back via aggregate_stats()['events']."""
    with _AGG["lock"]:
        _AGG["events"][name] = _AGG["events"].get(name, 0) + n


def aggregate_stats():
    """Snapshot: {'ops': {name: {count,total_ms,min_ms,max_ms,avg_ms}},
    'events': {name: count}}."""
    with _AGG["lock"]:
        ops = {n: {"count": c, "total_ms": t * 1e3, "min_ms": lo * 1e3,
                   "max_ms": hi * 1e3, "avg_ms": t / c * 1e3}
               for n, (c, t, lo, hi) in _AGG["ops"].items()}
        events = dict(_AGG["events"])
    return {"ops": ops, "events": events}


def reset_stats():
    with _AGG["lock"]:
        _AGG["ops"].clear()
        _AGG["events"].clear()


def set_config(**kwargs):
    """profiler.set_config(filename=..., aggregate_stats=...)"""
    _STATE["config"].update(kwargs)


def start():
    _STATE["running"] = True
    _AGG["enabled"] = bool(_STATE["config"].get("aggregate_stats", False))


def stop():
    _STATE["running"] = False
    _AGG["enabled"] = False  # stats stay readable until reset_stats()


def _emit(name, cat, ph, ts, args=None):
    with _STATE["lock"]:
        _STATE["events"].append({
            "name": name, "cat": cat, "ph": ph, "pid": os.getpid(),
            "tid": threading.get_ident(), "ts": ts * 1e6,
            "args": args or {},
        })


def dump():
    """Write the recorded chrome-trace events to the configured file."""
    fname = _STATE["config"].get("filename", "profile.json")
    with _STATE["lock"]:
        events = list(_STATE["events"])
    with open(fname, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return fname
