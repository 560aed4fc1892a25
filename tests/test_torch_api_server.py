"""The port's OpenAI-compatible front door
(paddle_tpu_torch.inference.api_server) against the JAX package's.

The cases of tests/test_api_server.py run on the port's ApiServer over a
port engine (a one-layer LlamaConfig.tiny() in f32 on the CPU, its
weights taken from the JAX model through ``convert``). Beside them:

- ``parse_request_options`` gives the JAX function's result, or the same
  400 with the same body, on every input of a table;
- the same unary and SSE requests sent to a JAX ApiServer over the JAX
  engine and to the port's give the same documents (ids and timestamps
  excepted): text, tokens, ``finish_reason``, status codes and the
  ``Retry-After`` of a 429;
- a fleet-backed port server answers with the fleet's trace ids and
  its ``/statusz`` sections.

Streams are compared exactly. Every server binds port 0 and stops in a
fixture finaliser or a ``finally``; every client call has a timeout, and
each test has its own time limit (SIGALRM)."""

import dataclasses
import json
import math
import signal
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu.inference import api_server as japi
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

from paddle_tpu_torch import convert
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.inference.api_server import (ApiError, ApiServer,
                                                   default_detokenize,
                                                   default_tokenize,
                                                   parse_request_options)
from paddle_tpu_torch.inference.serving import PRIORITY_RANGE
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

pytestmark = pytest.mark.http_api

torch.set_num_threads(1)

ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
              prompt_buckets=(8, 16), greedy=True)
TEST_LIMIT_S = 90


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own time limit: SIGALRM raises in the test, so a hung
    server or client fails it instead of running into the suite's
    clock."""
    def expired(signum, frame):
        raise TimeoutError("API server test exceeded its time limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def models():
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.num_hidden_layers = 1
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    jm.eval()
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tcfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1)
    tm = convert.from_numpy_state_dict(
        LlamaForCausalLM(tcfg, device="cpu"), arrays)
    return {"jax": jm, "torch": tm}


def _engine(models, side="torch", **kw):
    kw = {**ENGINE, **kw}
    if side == "jax":
        return jinf.ContinuousBatchingEngine(models["jax"], **kw)
    return tinf.ContinuousBatchingEngine(models["torch"], device="cpu",
                                         **kw)


_REF = {}


def _reference(models, prompt, n_new, eos=None):
    """The port engine's own uncontended greedy tokens for one request."""
    key = (tuple(prompt), int(n_new), eos)
    if key not in _REF:
        eng = _engine(models)
        eng.add_request(np.asarray(prompt, np.int32), n_new,
                        eos_token_id=eos)
        _REF[key] = [int(t) for t in eng.run()[-1].tokens]
    return _REF[key]


def _post(url, body, headers=None, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def _expect_http_error(url, body=None, headers=None, method=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    return ei.value.code, dict(ei.value.headers), json.loads(
        ei.value.read())


@pytest.fixture(scope="module")
def servers(models):
    """A JAX server over the JAX engine and the port's over the port
    engine, the same model id."""
    out = {}
    try:
        out["jax"] = japi.ApiServer(_engine(models, "jax"),
                                    model_id="tiny-test").start()
        out["torch"] = ApiServer(_engine(models),
                                 model_id="tiny-test").start()
        yield out
    finally:
        for srv in out.values():
            srv.stop()


@pytest.fixture()
def server(servers):
    return servers["torch"]


def _frames(raw):
    frames = raw.decode().split("\n\n")
    assert frames[-1] == ""
    return [f for f in frames if f]


def _strip(doc):
    """A response document without its ids and timestamps."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k not in ("id", "created", "trace_id")}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


# ---- option mapping (pure) -------------------------------------------------

def test_options_tenant_defaulting():
    opts = parse_request_options({}, {})
    assert opts == {"tenant": "default", "priority": 0,
                    "ttft_deadline_s": None, "deadline_s": None}
    assert parse_request_options({"tenant": 7}, {})["tenant"] == "default"
    assert parse_request_options({"tenant": ""}, {})["tenant"] == "default"
    assert parse_request_options({}, {"x-tenant": "acme"})["tenant"] \
        == "acme"


def test_options_priority_clamped_to_range():
    lo, hi = PRIORITY_RANGE
    assert parse_request_options({"priority": hi + 90}, {})["priority"] \
        == hi
    assert parse_request_options({"priority": lo - 90}, {})["priority"] \
        == lo
    assert parse_request_options({}, {"x-priority": str(hi + 1)})[
        "priority"] == hi
    assert parse_request_options({"priority": 2}, {"x-priority": "9"})[
        "priority"] == 2


def test_options_deadlines_ms_to_seconds():
    opts = parse_request_options({"ttft_deadline_ms": 1500,
                                  "deadline_ms": 30000}, {})
    assert opts["ttft_deadline_s"] == pytest.approx(1.5)
    assert opts["deadline_s"] == pytest.approx(30.0)
    assert parse_request_options({}, {"x-deadline-ms": "250"})[
        "deadline_s"] == pytest.approx(0.25)


@pytest.mark.parametrize("body", [
    {"deadline_ms": "soon"}, {"deadline_ms": -5},
    {"deadline_ms": float("nan")}, {"ttft_deadline_ms": 0},
    {"priority": "high"}, {"priority": True}])
def test_options_malformed_raise_400(body):
    with pytest.raises(ApiError) as ei:
        parse_request_options(body, {})
    assert ei.value.status == 400
    doc = ei.value.body()
    assert doc["error"]["type"] == "invalid_request_error"
    assert doc["error"]["code"] == 400


#: (body, headers) inputs of the option door, valid and not
OPTION_CASES = [
    ({}, {}), ({"tenant": " acme "}, {}), ({"tenant": 7}, {}),
    ({"tenant": ""}, {"X-Tenant": "hdr"}), ({}, {"x-tenant": "h2"}),
    ({"priority": 3}, {}), ({"priority": "12"}, {}),
    ({"priority": 10 ** 9}, {}), ({"priority": -4}, {}),
    ({}, {"X-Priority": " 5 "}), ({"priority": 2}, {"x-priority": "9"}),
    ({"priority": 1.5}, {}), ({"priority": None}, {}),
    ({"priority": [1]}, {}), ({"priority": "high"}, {}),
    ({"priority": True}, {}),
    ({"ttft_deadline_ms": 1500, "deadline_ms": 30000}, {}),
    ({}, {"X-Deadline-Ms": "250"}), ({}, {"x-ttft-deadline-ms": "1e3"}),
    ({"deadline_ms": 0.5}, {"x-deadline-ms": "soon"}),
    ({"deadline_ms": "soon"}, {}), ({"deadline_ms": -5}, {}),
    ({"deadline_ms": float("nan")}, {}), ({"deadline_ms": float("inf")}, {}),
    ({"ttft_deadline_ms": 0}, {}), ({"deadline_ms": True}, {}),
    ({"deadline_ms": [1]}, {}), ({}, {"x-ttft-deadline-ms": ""}),
]


@pytest.mark.parametrize("body,headers", OPTION_CASES)
def test_options_match_jax(body, headers):
    """The same result, or the same 400 with the same body."""
    def run(fn, err):
        try:
            return "ok", fn(body, headers)
        except err as e:
            return "400", (e.status, e.body())

    port = run(parse_request_options, ApiError)
    assert port == run(japi.parse_request_options, japi.ApiError)


def test_default_codec_roundtrip():
    assert default_tokenize("5 6 7") == [5, 6, 7]
    assert default_detokenize([5, 6, 7]) == "5 6 7"
    with pytest.raises(ApiError):
        default_tokenize("not tokens")


# ---- the HTTP surface --------------------------------------------------

def test_models_and_healthz(server):
    with urllib.request.urlopen(server.url + "/v1/models", timeout=30) as r:
        doc = json.loads(r.read())
    assert doc["object"] == "list"
    assert doc["data"][0]["id"] == "tiny-test"
    with urllib.request.urlopen(server.url + "/healthz", timeout=30) as r:
        assert r.status == 200


def test_unary_completion_matches_oracle(models, server):
    prompt, n_new = [5, 6, 7], 6
    status, headers, raw = _post(server.url + "/v1/completions",
                                 {"prompt": prompt, "max_tokens": n_new})
    assert status == 200
    doc = json.loads(raw)
    assert doc["object"] == "text_completion"
    choice = doc["choices"][0]
    assert choice["finish_reason"] == "length"
    assert choice["text"] == default_detokenize(
        _reference(models, prompt, n_new))
    assert doc["usage"] == {"prompt_tokens": 3, "completion_tokens": 6,
                            "total_tokens": 9}
    assert headers.get("X-Trace-Id")


def test_sse_framing_and_stream_fidelity(models, server):
    prompt, n_new = [9, 2, 4], 8
    status, headers, raw = _post(
        server.url + "/v1/completions",
        {"prompt": prompt, "max_tokens": n_new, "stream": True})
    assert status == 200
    assert headers["Content-Type"].startswith("text/event-stream")
    assert headers.get("X-Trace-Id")
    frames = _frames(raw)
    assert all(f.startswith("data: ") for f in frames)
    assert frames[-1] == "data: [DONE]"
    chunks = [json.loads(f[len("data: "):]) for f in frames[:-1]]
    assert all(c["object"] == "text_completion" for c in chunks)
    assert all(c["id"].startswith("cmpl-") for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert all(c["choices"][0]["finish_reason"] is None
               for c in chunks[:-1])
    assert "".join(c["choices"][0]["text"] for c in chunks) \
        == default_detokenize(_reference(models, prompt, n_new))


def test_eos_maps_to_stop(models, server):
    prompt = [5, 6, 7]
    eos = _reference(models, prompt, 6)[2]
    status, _, raw = _post(server.url + "/v1/completions",
                           {"prompt": prompt, "max_tokens": 6,
                            "eos_token_id": eos})
    assert status == 200
    doc = json.loads(raw)
    assert doc["choices"][0]["finish_reason"] == "stop"
    assert doc["choices"][0]["text"] == default_detokenize(
        _reference(models, prompt, 6, eos=eos))


def test_chat_completions_both_modes(models, server):
    body = {"messages": [{"role": "system", "content": "1 2"},
                         {"role": "user", "content": "3 4"}],
            "max_tokens": 4}
    want = default_detokenize(_reference(models, [1, 2, 3, 4], 4))
    status, _, raw = _post(server.url + "/v1/chat/completions", body)
    assert status == 200
    doc = json.loads(raw)
    assert doc["object"] == "chat.completion"
    assert doc["choices"][0]["message"] == {"role": "assistant",
                                            "content": want}
    _, _, raw = _post(server.url + "/v1/chat/completions",
                      {**body, "stream": True})
    chunks = [json.loads(f[len("data: "):]) for f in _frames(raw)[:-1]]
    assert chunks[0]["object"] == "chat.completion.chunk"
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    assert "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks) == want


def test_tenant_priority_reach_the_engine(server):
    status, headers, _ = _post(
        server.url + "/v1/completions",
        {"prompt": [3, 1], "max_tokens": 2, "priority": 999},
        headers={"X-Tenant": "acme"})
    assert status == 200
    req = server._backend.live(int(headers["X-Trace-Id"]))
    assert req.tenant == "acme"
    assert req.priority == PRIORITY_RANGE[1]


def test_trace_hops_stamped(server):
    status, headers, _ = _post(server.url + "/v1/completions",
                               {"prompt": [8, 8], "max_tokens": 2,
                                "stream": True})
    assert status == 200
    req = server._backend.live(int(headers["X-Trace-Id"]))
    deadline = time.time() + 10
    while (not any(h["kind"] == "last_byte" for h in req.hops)
           and time.time() < deadline):
        time.sleep(0.005)
    kinds = [h["kind"] for h in req.hops]
    assert kinds.index("http_recv") < kinds.index("first_byte") \
        <= kinds.index("last_byte")


def test_statusz_sections(server):
    _post(server.url + "/v1/completions", {"prompt": [1], "max_tokens": 1})
    with urllib.request.urlopen(server.url + "/statusz", timeout=30) as r:
        doc = json.loads(r.read())
    assert doc["http"]["pump_alive"] is True
    assert doc["http"]["requests"] >= 1
    assert "/v1/completions" in doc["routes"]


# ---- the same requests to the JAX server and the port's --------------------

#: (path, body): unary and SSE, both endpoints, eos, chat
SAME_REQUESTS = [
    ("/v1/completions", {"prompt": [5, 6, 7], "max_tokens": 6}),
    ("/v1/completions", {"prompt": "9 2 4", "max_tokens": 8,
                         "stream": True}),
    ("/v1/completions", {"prompt": [11, 3, 3, 7], "max_tokens": 5,
                         "eos_token_id": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "1 2 3 4"}],
                              "max_tokens": 4}),
    ("/v1/chat/completions", {"messages": [{"role": "system",
                                            "content": "7"},
                                           {"role": "user",
                                            "content": "8 9"}],
                              "max_tokens": 7, "stream": True}),
]


@pytest.mark.parametrize("path,body", SAME_REQUESTS)
def test_responses_match_jax_server(servers, path, body):
    """The same request to each server: the same status, the same
    document or SSE chunks (ids and timestamps excepted), so the same
    text, tokens and finish_reason."""
    out = {}
    for side, srv in servers.items():
        status, headers, raw = _post(srv.url + path, body)
        if body.get("stream"):
            frames = _frames(raw)
            assert frames[-1] == "data: [DONE]"
            doc = [json.loads(f[len("data: "):]) for f in frames[:-1]]
            # the chunking follows each pump's turns; the text does not
            key = "delta" if "chat" in path else "text"
            text = "".join(
                c["choices"][0][key].get("content", "")
                if key == "delta" else c["choices"][0]["text"]
                for c in doc)
            doc = (text, doc[-1]["choices"][0]["finish_reason"],
                   _strip(doc[0])["object"])
        else:
            doc = _strip(json.loads(raw))
        out[side] = (status, headers["Content-Type"], doc)
    assert out["torch"] == out["jax"]


def test_errors_match_jax_server(servers):
    """Malformed bodies, unknown routes and wrong methods answer the same
    status and the same error document."""
    cases = [("/v1/completions", {"prompt": [1], "max_tokens": 2,
                                  "deadline_ms": "soon"}, None),
             ("/v1/completions", {"prompt": "x y", "max_tokens": 2}, None),
             ("/v1/completions", {"prompt": [1], "max_tokens": 0}, None),
             ("/v1/completions", {"prompt": [1] * 60, "max_tokens": 2},
              None),
             ("/v1/chat/completions", {"messages": []}, None),
             ("/v1/nope", {"x": 1}, None),
             ("/v1/completions", None, "GET")]
    for path, body, method in cases:
        got = {side: _expect_http_error(srv.url + path, body,
                                        method=method)
               for side, srv in servers.items()}
        (jc, _, jd), (tc, _, td) = got["jax"], got["torch"]
        assert (tc, td) == (jc, jd), path


def test_malformed_json_is_400(server):
    req = urllib.request.Request(server.url + "/v1/completions",
                                 data=b"{nope",
                                 headers={"Content-Type":
                                          "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    assert json.loads(ei.value.read())["error"]["type"] \
        == "invalid_request_error"


def test_unknown_route_and_method(server):
    code, _, _ = _expect_http_error(server.url + "/v1/nope", {"x": 1})
    assert code == 404
    code, _, _ = _expect_http_error(server.url + "/v1/completions",
                                    method="GET")
    assert code == 405


def test_overloaded_maps_to_429_with_retry_after(models):
    """A full admission queue answers 429 with a Retry-After of the
    controller's retry-after rounded up, as the JAX server does."""
    got = {}
    for side, (inf, server_cls) in {
            "jax": (jinf, japi.ApiServer),
            "torch": (tinf, ApiServer)}.items():
        ctl = inf.AdmissionController(_engine(models, side), max_queue=0,
                                      min_retry_after_s=2.0)
        srv = server_cls(ctl).start()
        try:
            code, headers, doc = _expect_http_error(
                srv.url + "/v1/completions",
                {"prompt": [1, 2], "max_tokens": 2})
        finally:
            srv.stop()
        assert code == 429
        assert doc["error"]["type"] == "overloaded"
        assert doc["error"]["retry_after_s"] >= 2.0
        assert int(headers["Retry-After"]) == math.ceil(
            doc["error"]["retry_after_s"])
        got[side] = (code, headers["Retry-After"], doc)
    assert got["torch"] == got["jax"]


def test_disconnect_mid_stream_cancels_and_reclaims(models):
    eng = _engine(models, max_len=512)
    srv = ApiServer(eng).start()
    try:
        body = json.dumps({"prompt": [4, 4, 4], "max_tokens": 480,
                           "stream": True}).encode()
        with socket.create_connection((srv.host, srv.port),
                                      timeout=30) as sk:
            sk.sendall(b"POST /v1/completions HTTP/1.1\r\n"
                       b"Host: t\r\nContent-Type: application/json\r\n"
                       + f"Content-Length: {len(body)}\r\n\r\n".encode()
                       + body)
            sk.recv(1)
        deadline = time.time() + 60
        while time.time() < deadline:
            m = srv.metrics.get("http/disconnects")
            if m is not None and m.value >= 1:
                break
            time.sleep(0.01)
        assert srv.metrics.get("http/disconnects").value == 1
        with srv._lock:
            assert not srv._streams
    finally:
        srv.stop()
    while eng.has_work():
        eng.step()
    eng.add_request(np.asarray([1, 2], np.int32), 2)
    assert len(eng.run()[-1].tokens) == 2


def test_stream_chunk_knob_preserves_content(models):
    srv = ApiServer(_engine(models), stream_chunk_tokens=64).start()
    try:
        prompt, n_new = [9, 2, 4], 8
        status, _, raw = _post(srv.url + "/v1/completions",
                               {"prompt": prompt, "max_tokens": n_new,
                                "stream": True})
        assert status == 200
        frames = _frames(raw)
        assert frames[-1] == "data: [DONE]"
        chunks = [json.loads(f[len("data: "):]) for f in frames[:-1]]
        assert "".join(c["choices"][0]["text"] for c in chunks) \
            == default_detokenize(_reference(models, prompt, n_new))
    finally:
        srv.stop()


def test_fleet_backed_server(models):
    """Over a ServingFleet the server answers with fleet ids as trace
    ids, streams the fleet's tokens, and its /statusz carries the
    fleet's sections next to its own."""
    fleet = tinf.ServingFleet(
        lambda: tinf.ContinuousBatchingEngine(models["torch"],
                                              device="cpu", **ENGINE),
        num_replicas=2)
    srv = ApiServer(fleet, model_id="tiny-fleet").start()
    try:
        ids = set()
        for prompt in ([5, 6, 7], [9, 2, 4]):
            status, headers, raw = _post(
                srv.url + "/v1/completions",
                {"prompt": prompt, "max_tokens": 6, "stream": True})
            assert status == 200
            ids.add(int(headers["X-Trace-Id"]))
            chunks = [json.loads(f[len("data: "):])
                      for f in _frames(raw)[:-1]]
            assert "".join(c["choices"][0]["text"] for c in chunks) \
                == default_detokenize(_reference(models, prompt, 6))
        assert ids == {0, 1}
        with urllib.request.urlopen(srv.url + "/statusz", timeout=30) as r:
            doc = json.loads(r.read())
        assert {"fleet", "replicas", "slo", "slowest_traces",
                "flight_recorder", "goodput", "http", "routes"} <= set(doc)
        assert doc["fleet"]["completed"] == 2
        assert not any(isinstance(v, dict) and set(v) == {"error"}
                       for v in doc.values()), doc
    finally:
        srv.stop()


def test_server_pump_runs_on_the_engines_device(models, monkeypatch):
    """The server drives its backend on the backend's device: for a
    CPU engine the pump needs no CUDA stream."""
    srv = ApiServer(_engine(models)).start()
    try:
        assert srv._backend.device == torch.device("cpu")
        assert srv._pump_stream is None
    finally:
        srv.stop()
