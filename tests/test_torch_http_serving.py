"""Port parity: the HTTP serving surface.  ``mxnet_tpu_torch.serving``'s
``ModelServer`` (with ``attach_engine``) and ``ServingClient`` against the
JAX package's, each server on ``127.0.0.1`` at an ephemeral port, as
``tests/test_llm_serving.py::test_http_generate_roundtrip_and_metrics``
drives the JAX one.

The model is the JAX ``decoder_tiny_lm(seed=0)`` with random biases and LN
affines, carried across by ``load_jax_params``; both engines run the
synchronous loop with the prefix cache off, so both servers export the
same metrics.  The same generate requests go to both servers: the
streams must be equal, or differ only after a near-tie of the port's own
prefill (top-2 margin below 1e-4, ``torch_parity.check_stream``); the
same bad requests must give the same HTTP status and typed error code;
``/v1/stats`` and the Prometheus text must carry the same metric names.
Every server stops in ``finally``; every client call has a timeout.
"""
from __future__ import annotations

import http.client
import json
import re

import pytest
import torch

import mxnet_tpu.serving as jserving
from mxnet_tpu_torch import serving as tserving
from torch_parity import carried_models, check_stream

torch.set_num_threads(2)

ENGINE = dict(slots=4, page_size=8, prefill_chunk=8, max_ctx=64,
              prefix_cache=False, async_decode=False)
REQUESTS = [([1, 2, 3, 4, 5], 6), ([7, 5], 4), ([2, 9, 4, 1, 3, 3], 5)]
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def servers():
    """The JAX and the port's server, each with its engine attached."""
    jlm, tlm = carried_models()
    jsrv = jserving.ModelServer(jserving.ModelRegistry())
    tsrv = tserving.ModelServer(tserving.ModelRegistry())
    try:
        jsrv.start()
        tsrv.start()
        jsrv.attach_engine("llm", jserving.DecodeEngine(jlm, **ENGINE))
        tsrv.attach_engine("llm", tserving.DecodeEngine(tlm, device="cpu",
                                                        **ENGINE))
        yield {"jax": jsrv, "port": tsrv, "tlm": tlm}
    finally:
        tsrv.stop()
        jsrv.stop()


def _raw(srv, method, path, body=None):
    """(status, reply document) of one request, no client in between."""
    conn = http.client.HTTPConnection(*srv.address, timeout=TIMEOUT)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode() or "{}")
    finally:
        conn.close()


def test_generate_streams_match_jax(servers):
    tlm = servers["tlm"]
    jcli = jserving.ServingClient(*servers["jax"].address, timeout=TIMEOUT)
    tcli = tserving.ServingClient(*servers["port"].address, timeout=TIMEOUT)
    try:
        for prompt, n in REQUESTS:
            want = jcli.generate("llm", prompt, max_tokens=n)
            got = tcli.generate("llm", prompt, max_tokens=n)
            assert got["model"] == want["model"] == "llm"
            assert len(got["tokens"]) == n
            check_stream(tlm, "float32", prompt, got["tokens"],
                         want["tokens"], ENGINE["page_size"],
                         ENGINE["prefill_chunk"])
            if got["tokens"] == want["tokens"]:
                assert got["finish_reason"] == want["finish_reason"]
                assert got["completion_tokens"] == want["completion_tokens"]
        # /v1/generate with the model in the body routes identically
        body = {"model": "llm", "prompt": [1, 2], "max_tokens": 2}
        assert (tcli._request("POST", "/v1/generate", body)["tokens"]
                == tcli.generate("llm", [1, 2], max_tokens=2)["tokens"])
        # a session parks and resumes over the wire
        first = tcli.generate("llm", [3, 1, 4], max_tokens=3, session="s")
        more = tcli.generate("llm", [1], max_tokens=2, session="s",
                             resume=True)
        assert len(first["tokens"]) == 3 and len(more["tokens"]) == 2
    finally:
        jcli.close()
        tcli.close()


#: requests both servers must refuse alike: (method, path, body)
BAD = [
    ("POST", "/v1/models/llm:generate",
     {"prompt": [1], "max_tokens": 2, "session": "nope", "resume": True}),
    ("POST", "/v1/models/nope:generate", {"prompt": [1], "max_tokens": 2}),
    ("POST", "/v1/models/llm:generate", {"prompt": "1 2", "max_tokens": 2}),
    ("POST", "/v1/models/llm:generate", {"prompt": [1], "max_tokens": 0}),
    ("POST", "/v1/models/llm:generate", {"prompt": [10 ** 6]}),
    ("POST", "/v1/generate", {"prompt": [1]}),
    ("POST", "/v1/admin/load", {"name": "x", "builder": "a:b"}),
    ("POST", "/v1/nothing", {}),
    ("GET", "/v1/models/nope", None),
    ("GET", "/v1/nothing", None),
]


@pytest.mark.parametrize("method,path,body", BAD, ids=[
    "resume-unknown-session", "unknown-model", "prompt-not-a-list",
    "max-tokens-0", "token-out-of-vocab", "generate-without-model",
    "admin", "unknown-post-route", "unknown-model-get", "unknown-get-route"])
def test_typed_errors_match_jax(servers, method, path, body):
    js, jdoc = _raw(servers["jax"], method, path, body)
    ts, tdoc = _raw(servers["port"], method, path, body)
    assert js >= 400
    assert (ts, tdoc["code"]) == (js, jdoc["code"])


def test_client_raises_the_typed_error(servers):
    cli = tserving.ServingClient(*servers["port"].address, timeout=TIMEOUT)
    try:
        with pytest.raises(tserving.SessionResetError):
            cli.generate("llm", [1], max_tokens=2, session="gone",
                         resume=True)
        with pytest.raises(tserving.ModelNotFoundError):
            cli.generate("nope", [1], max_tokens=2)
        with pytest.raises(tserving.BadRequestError):
            cli.generate("llm", [10 ** 6], max_tokens=2)
    finally:
        cli.close()


def _metric_names(text):
    return {re.match(r"[a-z_0-9]+", line).group(0)
            for line in text.splitlines() if line}


def test_health_listing_stats_and_prometheus_match_jax(servers):
    docs = {}
    for key in ("jax", "port"):
        srv = servers[key]
        cli = tserving.ServingClient(*srv.address, timeout=TIMEOUT)
        try:
            cli.generate("llm", [5, 6, 7], max_tokens=3)
            assert cli.server_alive() and cli.server_ready()
            assert _raw(srv, "GET", "/healthz") == (200, {"ok": True})
            models = cli.models()
            assert list(models) == ["llm"]
            assert cli.model("llm")["latest"] == 1
            docs[key] = (cli.stats(), cli.metrics_text())
        finally:
            cli.close()
    (jstats, jtext), (tstats, ttext) = docs["jax"], docs["port"]
    assert tstats["generators"]["llm"]["slots"] == 4
    # the JAX engine's "fn_cache" counts its compiled XLA programs; the
    # port runs eagerly and has none
    assert (set(tstats["models"]["llm"]["counters"])
            == set(jstats["models"]["llm"]["counters"]))
    assert (set(tstats["models"]["llm"]["generate"])
            == set(jstats["models"]["llm"]["generate"]) - {"fn_cache"})
    gen = tstats["models"]["llm"]["generate"]
    assert gen["ttft"]["count"] >= 1 and gen["kv_occupancy"] is not None
    assert _metric_names(ttext) == _metric_names(jtext)
    for name in ("mxtpu_serving_ttft_p50_ms", "mxtpu_serving_tokens_per_s",
                 "mxtpu_serving_kv_occupancy",
                 "mxtpu_serving_requests_total"):
        assert name in _metric_names(ttext), name


def test_readyz_turns_503_when_draining():
    """A server with no model is not ready; nor is a draining one."""
    srv = tserving.ModelServer(tserving.ModelRegistry())
    try:
        srv.start()
        status, doc = _raw(srv, "GET", "/readyz")
        assert status == 503 and doc["models"] == 0
        srv.registry.load("f", lambda b: b, item_shape=(2,))
        assert _raw(srv, "GET", "/readyz")[0] == 200
        srv.batcher.stop()
        status, doc = _raw(srv, "GET", "/readyz")
        assert status == 503 and doc["draining"]
    finally:
        srv.stop()
