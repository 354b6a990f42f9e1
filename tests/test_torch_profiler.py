"""Port parity: the profiler (``mxnet_tpu_torch.profiler``), as
``tests/test_profiler.py`` holds the JAX package's: per-op aggregate
statistics fed by ``apply_op``, the printable table, stats off by
default, the chrome trace of scoped events; and the same recorded
sequence in both packages gives the same ``get_summary`` table (times
masked) and the same ``dumps`` events (name, category, phase, args).
The device half: ``set_config(xplane_dir=...)`` writes a
``torch.profiler`` trace there, ``device_memory_stats`` counts the live
CPU tensors on the CPU with the JAX package's census keys, and
``chip_spec`` names the device.
"""
from __future__ import annotations

import json
import re

import numpy as onp
import pytest
import torch

from gluon_parity import jax_mx, port_mx

torch.set_num_threads(2)


@pytest.fixture
def cpu():
    with port_mx().Context("cpu"):
        yield


def _setup(profiler):
    profiler.reset_stats()
    profiler.set_config(aggregate_stats=True)
    profiler.start()


def test_aggregate_counts_known_sequence(cpu):
    mxnp, profiler = port_mx().np, port_mx().profiler
    _setup(profiler)
    a = mxnp.array(onp.ones((4, 4), dtype=onp.float32))
    b = mxnp.array(onp.full((4, 4), 2.0, dtype=onp.float32))
    for _ in range(5):
        c = mxnp.add(a, b)
    for _ in range(3):
        d = mxnp.multiply(a, b)
    c.asnumpy(), d.asnumpy()
    profiler.stop()
    stats = profiler.aggregate_stats()["ops"]
    assert stats["add"]["count"] == 5 and stats["multiply"]["count"] == 3
    one = stats["add"]
    assert one["total_ms"] > 0
    assert one["min_ms"] <= one["avg_ms"] <= one["max_ms"]


def test_aggregate_table_printable(cpu):
    mxnp, profiler = port_mx().np, port_mx().profiler
    _setup(profiler)
    a = mxnp.array(onp.ones((2, 2), dtype=onp.float32))
    (a + a).asnumpy()
    st = profiler.sample_device_memory()
    profiler.stop()
    assert st["source"] == "live_tensors" and st["bytes_in_use"] >= 16
    table = profiler.dumps(format="table")
    assert "Operator summary" in table
    assert "Calls" in table and "Avg(ms)" in table
    assert "Memory counters" in table and "device_memory" in table
    profiler.dumps(format="table", reset=True)
    assert profiler.aggregate_stats()["ops"] == {}


def test_stats_off_by_default(cpu):
    mxnp, profiler = port_mx().np, port_mx().profiler
    profiler.reset_stats()
    profiler.set_config(aggregate_stats=False)
    profiler.start()
    a = mxnp.array(onp.ones((2, 2), dtype=onp.float32))
    (a + a).asnumpy()
    profiler.stop()
    assert profiler.aggregate_stats()["ops"] == {}


def test_chrome_trace_still_works(tmp_path):
    profiler = port_mx().profiler
    profiler.set_config(filename=str(tmp_path / "p.json"))
    profiler.start()
    with profiler.Task("unit_task"):
        pass
    profiler.stop()
    with open(profiler.dump()) as f:
        data = json.load(f)
    assert "unit_task" in [e["name"] for e in data["traceEvents"]]


def _record(mx):
    """One sequence of every recording call, in package ``mx``."""
    p = mx.profiler
    p.reset_stats()
    p.dumps(reset=True)
    p.set_config(aggregate_stats=True)
    p.start()
    a = mx.np.array(onp.ones((3, 3), dtype=onp.float32))
    for _ in range(4):
        a = mx.np.add(a, a)
    mx.np.multiply(a, a).asnumpy()
    with p.Task("task"), p.Frame("frame"):
        p.Marker("mark").mark()
    with p.scope("scoped"):
        p.Event("ev").start()
    c = p.Counter("ctr", value=2)
    c.increment(3)
    c.decrement()
    p.record_counter("queue", depth=4)
    p.pause()
    with p.Task("paused_task"):
        pass
    p.resume()
    p.record_event_stat("fault.trip", 2)
    p.record_comm_stat("bucket", nbytes=4096, queue_s=0.001)
    p.record_comm_stat("bucket", nbytes=1024, queue_s=0.003)
    p.record_fleet_stat("dispatch", dur_s=0.002, n=3)
    p.record_memory_stat("hbm", 100)
    p.record_memory_stat("hbm", 50)
    p.stop()
    return p.get_summary(sort_by="count"), json.loads(p.dumps())


def _mask(table):
    # host times differ between runs and packages; counts and bytes not
    rows = []
    for line in table.splitlines():
        if re.search(r"\d+\.\d{4}", line):
            line = re.sub(r"\s+\d+\.\d{4}", " T", line)
        rows.append(line)
    return rows


def test_summary_and_dumps_match_jax():
    jmx, tmx = jax_mx(), port_mx()
    jt, jd = _record(jmx)
    with tmx.Context("cpu"):
        tt, td = _record(tmx)
    assert _mask(tt) == _mask(jt)
    assert "add" in tt and "fault.trip" in tt and "bucket" in tt

    def events(d):
        return [(e["name"], e["cat"], e["ph"], e["args"])
                for e in d["traceEvents"]]
    assert events(td) == events(jd)
    assert all(e["ts"] > 0 for e in td["traceEvents"])


def test_device_memory_stats_on_the_cpu_has_the_census_keys():
    jst = jax_mx().profiler.device_memory_stats()
    tp = port_mx().profiler
    keep = torch.ones(1024)
    st = tp.device_memory_stats("cpu")
    assert set(st) == set(jst)
    assert st["source"] == "live_tensors" and jst["source"] == "live_arrays"
    assert st["bytes_in_use"] >= keep.numel() * 4
    assert st["peak_bytes_in_use"] >= st["bytes_in_use"]
    assert tp.chip_spec("cpu") == {"device_kind": "cpu", "hbm_bytes": None,
                                   "peak_flops_bf16": None}


def test_device_trace_is_written_where_asked(tmp_path, monkeypatch):
    tp = port_mx().profiler
    monkeypatch.setitem(tp._STATE["config"], "xplane_dir",
                        str(tmp_path / "trace"))
    tp.start()
    torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    tp.stop()
    tp.set_config(xplane_dir=None)
    path = tp.device_trace()
    assert path.startswith(str(tmp_path / "trace"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_no_gpu_means_no_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mx().profiler.device_memory_stats()
