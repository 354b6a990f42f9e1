"""Port parity: the serving registry, the dynamic batcher and the client's
transport rules of ``mxnet_tpu_torch.serving`` against the JAX package's
(``mxnet_tpu/serving/{registry,batcher,client}.py``), on the CPU.

- the registry: versions, latest pointer, unload, buckets and warmup, the
  same descriptions; a ``torch.nn.Module`` served as a batch function;
  Gluon blocks, checkpoints and the XLA compile cache refused;
- ``:predict`` over HTTP through both packages' batchers with the same
  batch function: the same predictions, the same typed errors;
- shedding: a queue at ``max_queue_depth`` refuses with
  ``QueueFullError`` (503 ``queue_full`` over HTTP) in both packages, and
  a poisoned request fails alone;
- the client's retry rules, on a fake connection: a failure while sending
  is retried for any method, one after the request went out only for a
  GET.

Every server binds ``127.0.0.1`` at port 0 and stops in ``finally``;
every client call has a timeout.  No test reads the host's clock: the
batchers' flush windows are either 0 or far longer than any test.
"""
from __future__ import annotations

import http.client
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu.serving as jserving
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.serving import client as tclient

torch.set_num_threads(2)

TIMEOUT = 60.0
PACKAGES = {"jax": jserving, "port": tserving}


def affine(batch):
    """The batch function both packages serve: rows of 3 floats."""
    return batch * 2.0 + 1.0


def poisoned(batch):
    """Fails on any batch holding a row whose first element is -1."""
    if np.any(batch[:, 0] == -1):
        raise ValueError("poisoned row")
    return affine(batch)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_registry_versions_and_buckets(pkg):
    s = PACKAGES[pkg]
    calls = []

    def fn(batch):
        calls.append(batch.shape[0])
        return affine(batch)

    reg = s.ModelRegistry()
    m1 = reg.load("f", fn, item_shape=(3,), max_batch_size=6)
    assert m1.buckets == (1, 2, 4, 6) == s.default_buckets(6)
    assert calls == [1, 2, 4, 6] and m1.warmed     # warmup ran each bucket
    assert [m1.bucket_for(n) for n in (1, 3, 5, 9)] == [1, 4, 6, 6]
    out, bucket, _ = m1.run_batch(np.ones((3, 3), np.float32))
    assert bucket == 4 and out.shape == (3, 3) and np.all(out == 3.0)
    reg.load("f", fn, item_shape=(3,), buckets=[8, 2], warmup=False)
    assert reg.latest_version("f") == 2 and reg.get("f").buckets == (2, 8)
    assert reg.get("f", 1) is m1
    reg.unload("f", 2)
    assert reg.latest_version("f") == 1
    with pytest.raises(s.ModelNotFoundError):
        reg.get("f", 2)
    assert set(reg.models()["f"]["versions"][1]) == {
        "name", "version", "item_shape", "dtype", "buckets",
        "max_batch_size", "warmed", "loaded_at"}
    with pytest.raises(s.BadRequestError):
        m1.check_item([1.0, 2.0])
    reg.unload("f")
    assert "f" not in reg


def test_registry_serves_a_module_and_refuses_gluon(monkeypatch):
    reg = tserving.ModelRegistry()
    lin = torch.nn.Linear(3, 2)
    served = reg.load("lin", lin, item_shape=(3,), max_batch_size=4)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out, _, _ = served.run_batch(x)
    np.testing.assert_allclose(out, lin(torch.tensor(x)).detach().numpy(),
                               rtol=1e-6)

    class Block:
        def __call__(self, x):
            return x

        def collect_params(self):
            return {}

    # a Gluon block is served (tests/test_torch_gluon_serving.py holds its
    # outputs against the JAX registry's); checkpoints wait for item 9
    assert reg.load("blk", Block()).name == "blk"
    with pytest.raises(NotImplementedError, match="item 9"):
        reg.load_checkpoint("ckpt", "net-symbol.json", "net-0000.params")
    assert tserving.registry.maybe_enable_compile_cache() is None
    with pytest.raises(NotImplementedError, match="compile cache"):
        tserving.registry.maybe_enable_compile_cache("/some/dir")
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", "/some/dir")
    with pytest.raises(NotImplementedError):
        tserving.ModelRegistry()


def _server(s, fn, **kw):
    reg = s.ModelRegistry()
    reg.load("f", fn, item_shape=(3,), max_batch_size=8)
    return s.ModelServer(reg, **kw)


def test_predict_over_http_matches_jax():
    items = np.arange(15, dtype=np.float32).reshape(5, 3)
    outs, errs = {}, {}
    for key, s in PACKAGES.items():
        srv = _server(s, poisoned, flush_ms=0.0)
        try:
            srv.start()
            cli = tserving.ServingClient(*srv.address, timeout=TIMEOUT)
            try:
                outs[key] = (cli.predict("f", items),
                             cli.predict("f", items[:2], version=1))
                errs[key] = []
                for bad in (dict(model="g", data=items),
                            dict(model="f", data=[[1.0, 2.0]]),
                            dict(model="f", data=items, version=9),
                            dict(model="f", data=[[-1.0, 0.0, 0.0]])):
                    with pytest.raises(tserving.ServingError) as e:
                        cli.predict(**bad)
                    errs[key].append(type(e.value).__name__)
            finally:
                cli.close()
        finally:
            srv.stop()
    for got, want in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(outs["port"][0], affine(items))
    assert errs["port"] == errs["jax"] == [
        "ModelNotFoundError", "BadRequestError", "ModelNotFoundError",
        "ServingError"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_poisoned_request_fails_alone(pkg):
    """A batch that raises is re-run request by request: only the
    poisoned request's future carries the error."""
    s = PACKAGES[pkg]
    reg = s.ModelRegistry()
    reg.load("f", poisoned, item_shape=(3,), max_batch_size=4)
    # a flush window far longer than the test: the batch dispatches when
    # its 4 requests are in, whatever the host's speed
    b = s.DynamicBatcher(reg, flush_ms=600_000.0)
    try:
        rows = [[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [2.0, 0.0, 0.0],
                [3.0, 0.0, 0.0]]
        futs = [b.submit("f", r) for r in rows]
        with pytest.raises(ValueError, match="poisoned"):
            futs[1].result(timeout=TIMEOUT)
        for i in (0, 2, 3):
            np.testing.assert_array_equal(futs[i].result(timeout=TIMEOUT),
                                          affine(np.array(rows[i])))
        snap = b.metrics.snapshot()["models"]["f"]
        assert snap["counters"]["errors_total"] == 1
    finally:
        assert b.stop(timeout=TIMEOUT)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_full_queue_sheds_typed(pkg):
    """With a flush window far longer than the test, queued requests stay
    queued: at max_queue_depth the next one is shed with QueueFullError
    (503 queue_full over HTTP); a draining stop serves the queued ones
    at once, and a stopped batcher refuses."""
    s = PACKAGES[pkg]
    srv = _server(s, affine, flush_ms=600_000.0, max_queue_depth=2)
    try:
        srv.start()
        b = srv.batcher
        queued = [b.submit("f", [1.0, 2.0, 3.0]) for _ in range(2)]
        with pytest.raises(s.QueueFullError) as e:
            b.submit("f", [1.0, 2.0, 3.0])
        assert e.value.queued == 2
        conn = http.client.HTTPConnection(*srv.address, timeout=TIMEOUT)
        try:
            conn.request("POST", "/v1/models/f:predict",
                         body=b'{"instances": [[1, 2, 3]]}',
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 503
            assert b'"queue_full"' in resp.read()
        finally:
            conn.close()
        assert b.metrics.snapshot()["models"]["f"]["counters"][
            "shed_total"] == 2
        assert b.stop(timeout=TIMEOUT)
        for f in queued:
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT),
                                          [3.0, 5.0, 7.0])
        with pytest.raises(s.ServerClosedError):
            b.submit("f", [1.0, 2.0, 3.0])
    finally:
        srv.stop()


def test_stop_without_drain_fails_queued(monkeypatch):
    """A stop without drain fails the queued requests with
    ServerClosedError, and the worker, woken in its flush window with its
    queue emptied, exits cleanly."""
    errors = []
    monkeypatch.setattr(threading, "excepthook", errors.append)
    reg = tserving.ModelRegistry()
    reg.load("f", affine, item_shape=(3,), max_batch_size=8)
    b = tserving.DynamicBatcher(reg, flush_ms=600_000.0)
    try:
        queued = [b.submit("f", [1.0, 2.0, 3.0]) for _ in range(2)]
    finally:
        assert b.stop(drain=False, timeout=TIMEOUT)
    for f in queued:
        with pytest.raises(tserving.ServerClosedError):
            f.result(timeout=TIMEOUT)
    assert not errors


def test_generate_without_engine_and_tier_order():
    """submit_generate refuses a model with no engine, typed; a bulk-tier
    request queued ahead of a latency-tier one is served after it."""
    reg = tserving.ModelRegistry()
    order, entered, gate = [], threading.Event(), threading.Event()

    def fn(batch):
        if batch[0, 0] == 0:            # hold the worker on the first item
            entered.set()
            assert gate.wait(TIMEOUT)
        order.extend(batch[:, 0].tolist())
        return batch

    reg.load("f", fn, item_shape=(1,), max_batch_size=1, warmup=False)
    b = tserving.DynamicBatcher(reg, flush_ms=0.0)
    try:
        with pytest.raises(tserving.ModelNotFoundError):
            b.submit_generate("f", [1, 2])
        first = b.submit("f", [0.0])
        assert entered.wait(TIMEOUT)
        bulk = b.submit("f", [1.0], tier="bulk")
        fast = b.submit("f", [2.0], tier="latency")
        gate.set()
        for f in (first, bulk, fast):
            f.result(timeout=TIMEOUT)
        assert order == [0.0, 2.0, 1.0]
    finally:
        gate.set()
        assert b.stop(timeout=TIMEOUT)


class _FakeConn:
    """An ``http.client.HTTPConnection`` stand-in that fails its first
    ``fail`` calls of ``where`` ("send": ``request``, "recv":
    ``getresponse``) and then answers ``{"ok": true}``."""

    script = {}

    def __init__(self, host, port, timeout=None):
        assert timeout is not None          # every call has a timeout
        self.s = _FakeConn.script

    def request(self, method, path, body=None, headers=None):
        self.s["sent"] += 1
        if self.s["where"] == "send" and self.s["fail"] > 0:
            self.s["fail"] -= 1
            raise ConnectionResetError("reset while sending")

    def getresponse(self):
        if self.s["where"] == "recv" and self.s["fail"] > 0:
            self.s["fail"] -= 1
            raise http.client.RemoteDisconnected("lost the reply")

        class Resp:
            status = 200

            def read(self):
                return b'{"ok": true, "models": {}}'

            def getheader(self, name):
                return None
        return Resp()

    def close(self):
        pass


@pytest.mark.parametrize("where,method,retried", [
    ("send", "POST", True), ("send", "GET", True),
    ("recv", "GET", True), ("recv", "POST", False)])
def test_client_retry_rules(monkeypatch, where, method, retried):
    monkeypatch.setattr(tclient.http.client, "HTTPConnection", _FakeConn)
    _FakeConn.script = {"where": where, "fail": 2, "sent": 0}
    cli = tserving.ServingClient("127.0.0.1", 1, timeout=5.0, retries=2,
                                 backoff_ms=1.0)
    if retried:
        assert cli._request(method, "/v1/models", None if method == "GET"
                            else {"prompt": [1]}) == {"ok": True,
                                                      "models": {}}
        assert _FakeConn.script["sent"] == 3      # two failures, then ok
    else:
        with pytest.raises(http.client.RemoteDisconnected):
            cli._request(method, "/v1/models/f:predict",
                         {"instances": [[1]]})
        assert _FakeConn.script["sent"] == 1      # never sent twice


def test_client_gives_up_after_its_retries(monkeypatch):
    monkeypatch.setattr(tclient.http.client, "HTTPConnection", _FakeConn)
    _FakeConn.script = {"where": "send", "fail": 5, "sent": 0}
    cli = tserving.ServingClient("127.0.0.1", 1, timeout=5.0, retries=2,
                                 backoff_ms=1.0)
    with pytest.raises(ConnectionResetError):
        cli._request("GET", "/healthz")
    assert _FakeConn.script["sent"] == 3
    assert not cli.server_alive()        # the probe never retries
    assert _FakeConn.script["sent"] == 4
