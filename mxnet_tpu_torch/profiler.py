"""Profiler (the port of ``mxnet_tpu/profiler.py``; parity:
python/mxnet/profiler.py + src/profiler/ chrome-trace).

The host half is the JAX package's: scoped events (``Task``, ``Frame``,
``Event``, ``Marker``, ``Counter``) recorded to a chrome://tracing JSON
while a trace runs (``start``/``stop``/``pause``/``resume``, ``dump``,
``dumps``), and the aggregate tables of op dispatches (``apply_op`` feeds
them under ``set_config(aggregate_stats=True)``), memory samples, event
counts, gradient-communication launches and fleet events
(``aggregate_stats``, ``get_summary``).

The device half runs on PyTorch where the JAX package runs on XLA:
``set_config(xplane_dir=d)`` records a ``torch.profiler`` trace (host
ops and, with a GPU, the card's kernels through CUPTI) between ``start``
and ``stop`` and writes it to ``d`` as a chrome trace
(``device_trace()`` names the file); ``device_memory_stats`` reads
``torch.cuda.memory_stats``/``mem_get_info`` on the card and counts the
live CPU tensors on the CPU; ``chip_spec`` reads the card's name and
memory from ``torch.cuda``.
"""
from __future__ import annotations

import gc
import json
import os
import threading
import time
import warnings

_STATE = {
    "config": {"filename": "profile.json", "profile_all": False},
    "running": False,
    "events": [],
    "lock": threading.Lock(),
    "device_dir": None,
    "device_prof": None,
    "last_device_trace": None,
}

# Per-op aggregate statistics (reference src/profiler/aggregate_stats.cc +
# MXAggregateProfileStatsPrint, src/c_api/c_api_profile.cc:284).  Enabled
# by set_config(aggregate_stats=True); ndarray.apply_op feeds it.
_AGG = {
    "enabled": False,
    "ops": {},      # name -> [count, total_s, min_s, max_s]
    "memory": {},   # counter name -> [samples, last, peak]
    "events": {},   # name -> count (always on: fault trips)
    "comm": {},     # name -> [buckets, bytes, total_queue_s, max_queue_s]
    "fleet": {},    # name -> [count, total_s, max_s] (router dispatches)
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


def record_comm_stat(name, nbytes=0, queue_s=0.0, n=1):
    """Accumulate one gradient-communication launch (a fused bucket
    pushpull, kvstore/bucketing.py).  Always on, like event stats — the
    per-step bucket count / bytes / queue→launch latency are the
    observables the overlap design is validated against (bench.py asserts
    on them).  Read back via aggregate_stats()['comm']."""
    with _AGG["lock"]:
        st = _AGG["comm"].get(name)
        if st is None:
            _AGG["comm"][name] = [n, nbytes, queue_s, queue_s]
        else:
            st[0] += n
            st[1] += nbytes
            st[2] += queue_s
            if queue_s > st[3]:
                st[3] = queue_s


def record_fleet_stat(name, dur_s=0.0, n=1):
    """Accumulate one serving-fleet router event (a dispatch, a failover
    retry, a shed) with its router-side latency.  Always on, like comm
    stats — the per-replica dispatch/retry/eject counters are the
    observables the failover design is validated against (tools/chaos.py
    --scenario fleet asserts on them).  Read back via
    aggregate_stats()['fleet']."""
    with _AGG["lock"]:
        st = _AGG["fleet"].get(name)
        if st is None:
            _AGG["fleet"][name] = [n, dur_s, dur_s]
        else:
            st[0] += n
            st[1] += dur_s
            if dur_s > st[2]:
                st[2] = dur_s


def record_memory_stat(name, value):
    with _AGG["lock"]:
        st = _AGG["memory"].get(name)
        if st is None:
            _AGG["memory"][name] = [1, value, value]
        else:
            st[0] += 1
            st[1] = value
            if value > st[2]:
                st[2] = value


def aggregate_stats():
    """Snapshot: {'ops': {name: {count,total_ms,min_ms,max_ms,avg_ms}},
    'memory': {name: {samples,last_bytes,peak_bytes}}}."""
    with _AGG["lock"]:
        ops = {n: {"count": c, "total_ms": t * 1e3, "min_ms": lo * 1e3,
                   "max_ms": hi * 1e3, "avg_ms": t / c * 1e3}
               for n, (c, t, lo, hi) in _AGG["ops"].items()}
        mem = {n: {"samples": s, "last_bytes": last, "peak_bytes": peak}
               for n, (s, last, peak) in _AGG["memory"].items()}
        events = dict(_AGG["events"])
        comm = {n: {"count": c, "bytes": b,
                    "queue_total_ms": tq * 1e3, "queue_max_ms": mq * 1e3,
                    "queue_avg_ms": tq / c * 1e3 if c else 0.0}
                for n, (c, b, tq, mq) in _AGG["comm"].items()}
        fleet = {n: {"count": c, "total_ms": t * 1e3, "max_ms": mx * 1e3,
                     "avg_ms": t / c * 1e3 if c else 0.0}
                 for n, (c, t, mx) in _AGG["fleet"].items()}
    return {"ops": ops, "memory": mem, "events": events, "comm": comm,
            "fleet": fleet}


def reset_stats():
    with _AGG["lock"]:
        _AGG["ops"].clear()
        _AGG["memory"].clear()
        _AGG["events"].clear()
        _AGG["comm"].clear()
        _AGG["fleet"].clear()


def get_summary(sort_by="total", ascending=False):
    """Printable per-op-name summary table (the
    MXAggregateProfileStatsPrint analog)."""
    key = {"total": "total_ms", "count": "count", "avg": "avg_ms",
           "min": "min_ms", "max": "max_ms"}.get(sort_by, "total_ms")
    snap = aggregate_stats()
    lines = ["Profile Statistics:",
             "  Operator summary (host dispatch)",
             "  %-28s %10s %12s %12s %12s %12s" % (
                 "Name", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                 "Avg(ms)")]
    rows = sorted(snap["ops"].items(), key=lambda kv: kv[1][key],
                  reverse=not ascending)
    for name, st in rows:
        lines.append("  %-28s %10d %12.4f %12.4f %12.4f %12.4f" % (
            name[:28], st["count"], st["total_ms"], st["min_ms"],
            st["max_ms"], st["avg_ms"]))
    if snap["memory"]:
        lines.append("  Memory counters")
        lines.append("  %-28s %10s %14s %14s" % (
            "Name", "Samples", "Last(bytes)", "Peak(bytes)"))
        for name, st in sorted(snap["memory"].items()):
            lines.append("  %-28s %10d %14d %14d" % (
                name[:28], st["samples"], st["last_bytes"],
                st["peak_bytes"]))
    if snap["events"]:
        lines.append("  Event counters")
        lines.append("  %-28s %10s" % ("Name", "Count"))
        for name, count in sorted(snap["events"].items()):
            lines.append("  %-28s %10d" % (name[:28], count))
    if snap["comm"]:
        lines.append("  Gradient communication (fused buckets)")
        lines.append("  %-28s %10s %14s %12s %12s" % (
            "Name", "Buckets", "Bytes", "QAvg(ms)", "QMax(ms)"))
        for name, st in sorted(snap["comm"].items()):
            lines.append("  %-28s %10d %14d %12.4f %12.4f" % (
                name[:28], st["count"], st["bytes"], st["queue_avg_ms"],
                st["queue_max_ms"]))
    if snap["fleet"]:
        lines.append("  Serving fleet (router)")
        lines.append("  %-28s %10s %12s %12s %12s" % (
            "Name", "Count", "Total(ms)", "Avg(ms)", "Max(ms)"))
        for name, st in sorted(snap["fleet"].items()):
            lines.append("  %-28s %10d %12.4f %12.4f %12.4f" % (
                name[:28], st["count"], st["total_ms"], st["avg_ms"],
                st["max_ms"]))
    return "\n".join(lines)


def set_config(**kwargs):
    """profiler.set_config(filename=..., profile_all=..., ...)"""
    _STATE["config"].update(kwargs)


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        start()
    else:
        stop()


def start(profile_process="worker"):
    _STATE["running"] = True
    _STATE["start_ts"] = time.time()
    _AGG["enabled"] = bool(_STATE["config"].get("aggregate_stats", False))
    dev_dir = _STATE["config"].get("xplane_dir")
    if dev_dir and _STATE["device_prof"] is None:
        _STATE["device_prof"] = _start_device_trace(dev_dir)
        _STATE["device_dir"] = dev_dir


def stop(profile_process="worker"):
    _STATE["running"] = False
    _AGG["enabled"] = False  # stats stay readable until reset_stats()
    prof = _STATE["device_prof"]
    if prof is not None:
        _STATE["device_prof"] = None
        _STATE["last_device_trace"] = _stop_device_trace(
            prof, _STATE["device_dir"])
        _STATE["device_dir"] = None


def _start_device_trace(dev_dir):
    """A ``torch.profiler`` trace of the host and, with a GPU, the card
    (CUPTI): the port's counterpart of the JAX package's xplane trace."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dev_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_device_trace(prof, dev_dir):
    """End the trace and write it to ``dev_dir`` as a chrome trace; the
    path is ``device_trace()``."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    path = os.path.join(dev_dir, "torch_trace.%d.%d.json"
                        % (os.getpid(), int(time.time() * 1e3)))
    prof.export_chrome_trace(path)
    return path


def device_trace():
    """The path of the last ``torch.profiler`` trace that
    ``set_config(xplane_dir=...)`` made, or None."""
    return _STATE.get("last_device_trace")


def _emit(name, cat, ph, ts, args=None):
    with _STATE["lock"]:
        _STATE["events"].append({
            "name": name, "cat": cat, "ph": ph, "pid": os.getpid(),
            "tid": threading.get_ident(), "ts": ts * 1e6,
            "args": args or {},
        })


def dump(finished=True, profile_process="worker"):
    fname = _STATE["config"].get("filename", "profile.json")
    with _STATE["lock"]:
        events = list(_STATE["events"])
    with open(fname, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return fname


def dumps(reset=False, format="json"):
    """format='json' → chrome-trace events; format='table' → the per-op
    aggregate summary (reference profiler.dumps(format='table') →
    MXAggregateProfileStatsPrint)."""
    if format == "table":
        s = get_summary()
        if reset:
            reset_stats()
        return s
    with _STATE["lock"]:
        s = json.dumps({"traceEvents": _STATE["events"]})
        if reset:
            _STATE["events"].clear()
    return s


def pause(profile_process="worker"):
    _STATE["running"] = False


def resume(profile_process="worker"):
    _STATE["running"] = True


class _Scoped:
    _cat = "event"

    def __init__(self, name):
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.time()
        if _STATE["running"]:
            _emit(self.name, self._cat, "B", self._t0)

    def stop(self):
        if _STATE["running"]:
            _emit(self.name, self._cat, "E", time.time())

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class Task(_Scoped):
    _cat = "task"

    def __init__(self, name, domain=None):
        super().__init__(name)


class Frame(_Scoped):
    _cat = "frame"

    def __init__(self, name, domain=None):
        super().__init__(name)


class Event(_Scoped):
    _cat = "event"


class Counter:
    def __init__(self, name, domain=None, value=0):
        self.name = name
        self.value = value

    def set_value(self, value):
        self.value = value
        if _STATE["running"]:
            _emit(self.name, "counter", "C", time.time(),
                  {"value": self.value})

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)


class Marker:
    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        if _STATE["running"]:
            _emit(self.name, "marker", "i", time.time())


def scope(name="<unk>:"):
    return Task(name)


# ---------------------------------------------------------------------------
# device memory
#
# Parity: reference `src/profiler/storage_profiler.h:131` (per-device
# memory aggregates surfaced through `c_api_profile.cc:197`).  On the card
# the caching allocator's own counters; on the CPU a census of live
# tensors.
# ---------------------------------------------------------------------------
_PEAKS = {}  # device -> peak bytes observed by the CPU census

# device name prefix -> dense bf16 tensor-core peak FLOP/s (public spec:
# H100 SXM5); override with MXNET_TPU_PEAK_FLOPS / MXNET_TPU_HBM_BYTES, the
# JAX package's names, for a card not listed
_CARD_PEAKS = (
    ("NVIDIA H100 80GB HBM3", 989e12),
)


def _device(device):
    from . import context
    return context.resolve(device)


def chip_spec(device=None):
    """{'device_kind', 'hbm_bytes', 'peak_flops_bf16'} of a device (None =
    the default device, ``cuda`` unless a CPU scope is open): the card's
    name and total memory from ``torch.cuda``, its bf16 peak from a
    table of known cards; None fields otherwise, unless the environment
    overrides are set."""
    import torch
    dev = _device(device)
    kind, mem, peak = "cpu", None, None
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        kind, mem = props.name, int(props.total_memory)
        for prefix, p in _CARD_PEAKS:
            if kind.startswith(prefix):
                peak = p
                break
    env_hbm = os.environ.get("MXNET_TPU_HBM_BYTES")
    env_peak = os.environ.get("MXNET_TPU_PEAK_FLOPS")
    if env_hbm:
        mem = int(float(env_hbm))
    if env_peak:
        peak = float(env_peak)
    return {"device_kind": kind, "hbm_bytes": mem, "peak_flops_bf16": peak}


def _cpu_census():
    """(bytes, buffers) of the live CPU tensors, each storage once."""
    import torch
    seen = {}
    with warnings.catch_warnings():
        # isinstance() reads deprecated module attributes of some objects
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for o in tensors:
        try:
            if o.device.type != "cpu":
                continue
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        except Exception:
            continue  # a tensor without storage (meta, sparse)
    seen.pop(0, None)
    return sum(seen.values()), len(seen)


def device_memory_stats(device=None):
    """Per-device memory: bytes_in_use / peak_bytes_in_use / bytes_limit.

    On the card (``source='torch.cuda.memory_stats'``) the caching
    allocator's allocated bytes now and at their peak (since the last
    ``torch.cuda.reset_peak_memory_stats``), the card's total memory from
    ``mem_get_info`` and the allocator's count of allocations.  On the CPU
    (``source='live_tensors'``) a census of the live CPU tensors, each
    storage counted once, and the peak of the censuses taken."""
    import torch
    dev = _device(device)
    if dev.type == "cuda":
        st = torch.cuda.memory_stats(dev)
        _, total = torch.cuda.mem_get_info(dev)
        return {"bytes_in_use": int(st.get("allocated_bytes.all.current",
                                           0)),
                "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak",
                                                0)),
                "bytes_limit": int(total),
                "num_allocs": st.get("allocation.all.allocated"),
                "source": "torch.cuda.memory_stats"}
    total, count = _cpu_census()
    peak = max(_PEAKS.get(dev, 0), total)
    _PEAKS[dev] = peak
    return {"bytes_in_use": total, "peak_bytes_in_use": peak,
            "bytes_limit": chip_spec(dev)["hbm_bytes"],
            "num_live_buffers": count, "source": "live_tensors"}


def sample_device_memory(device=None, name="device_memory"):
    """Record the current device-memory reading as a chrome-trace counter
    sample (reference: the storage profiler's per-device counter series)
    and return it."""
    st = device_memory_stats(device)
    if _STATE["running"]:
        _emit(name, "counter", "C", time.time(),
              {"bytes_in_use": st["bytes_in_use"],
               "peak_bytes_in_use": st["peak_bytes_in_use"]})
    if _AGG["enabled"]:
        record_memory_stat(name, st["bytes_in_use"])
    return st
