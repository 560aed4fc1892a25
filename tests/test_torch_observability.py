"""The port's observability plane (paddle_tpu_torch.profiler: metrics and
their federation, the tracer and the request-trace log, the flight
recorder, SLO accounting, the goodput ledger, the exposition server)
against the JAX package's.

The cases of tests/test_exposition.py, tests/test_trace.py (spans, the
chrome export, the request-trace log), tests/test_flight_recorder.py,
tests/test_slo.py (its SLO half) and tests/test_goodput.py (with fit's
ledger, and two rounds of it through a preemption) run on the port's
modules. The parity cases run the same
operations through both packages' modules and require the same
Prometheus text and snapshots, the same SLO burn rates and alert
states, and the same goodput partitions (exactly; the clocks are
frozen, so no float tolerance is needed). The engine and fleet cases use
a one-layer LlamaConfig.tiny() in f32 on the CPU. Sockets bind port 0,
every server is stopped in a ``finally``, and every client call has a
timeout."""

import dataclasses
import errno
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu.profiler import exposition as jexposition
from paddle_tpu.profiler import goodput as jgoodput
from paddle_tpu.profiler import metrics as jmetrics
from paddle_tpu.profiler import slo as jslo
from paddle_tpu.testing import FaultInjector as JFaultInjector

from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.profiler import exposition as texposition
from paddle_tpu_torch.profiler import flight_recorder as fr
from paddle_tpu_torch.profiler import goodput as tgoodput
from paddle_tpu_torch.profiler import metrics as tmetrics
from paddle_tpu_torch.profiler import slo as tslo
from paddle_tpu_torch.profiler import trace
from paddle_tpu_torch.profiler.flight_recorder import (BUNDLE_NAME,
                                                       BUNDLE_SCHEMA,
                                                       FlightRecorder,
                                                       Watchdog)
from paddle_tpu_torch.profiler.goodput import (CATEGORIES, LEDGER_SCHEMA,
                                               GoodputLedger)
from paddle_tpu_torch.profiler.metrics import (FederatedRegistry,
                                               MetricsRegistry)
from paddle_tpu_torch.profiler.slo import SLORule, SLOTracker
from paddle_tpu_torch.testing import FaultInjector

pytestmark = pytest.mark.observability

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the two packages' modules, side by side, for the parity cases
MODS = {"jax": types.SimpleNamespace(metrics=jmetrics, slo=jslo,
                                     goodput=jgoodput,
                                     exposition=jexposition),
        "torch": types.SimpleNamespace(metrics=tmetrics, slo=tslo,
                                       goodput=tgoodput,
                                       exposition=texposition)}

SOCKET_TEST_LIMIT_S = 90

ENGINE = dict(num_slots=2, page_size=8, max_len=48, decode_chunk=4,
              prompt_buckets=(8, 16), greedy=True, device="cpu")


@pytest.fixture()
def time_limit():
    """A socket test's own time limit: SIGALRM raises in the test after
    ``SOCKET_TEST_LIMIT_S``, so a hung server or client fails the test
    instead of running into the suite's clock."""
    def expired(signum, frame):
        raise TimeoutError("socket test exceeded its time limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(SOCKET_TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1)
    return LlamaForCausalLM(cfg, device="cpu", seed=0)


def _factory(model, **kw):
    kw = {**ENGINE, **kw}
    return lambda: tinf.ContinuousBatchingEngine(model, **kw)


def _prompts(n, seed=0, lo=4, hi=9, vocab=LlamaConfig.tiny().vocab_size):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (int(rng.randint(lo, hi)),))
            .astype(np.int32) for _ in range(n)]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


_PROM_LINE = re.compile(r"^[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? (\S+)$")


def _assert_prom_parses(text):
    assert text.endswith("\n")
    types_ = []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            types_.append(line.split()[2])
            continue
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        assert m, f"unparseable prom line: {line!r}"
        float(m.group(2))
    assert len(types_) == len(set(types_)), \
        [t for t in types_ if types_.count(t) > 1]


# ---- the federated registry ------------------------------------------------

def test_federated_counters_sum_with_labels():
    fed = FederatedRegistry(include_default=False)
    fed.counter("fleet/submitted").inc(3)
    r0, r1 = MetricsRegistry(), MetricsRegistry()
    r0.counter("serving/tokens_emitted").inc(10)
    r1.counter("serving/tokens_emitted").inc(7)
    fed.add_source("0", lambda: r0)
    fed.add_source("1", lambda: r1)
    s = fed.snapshot()
    assert s["fleet/submitted"] == 3
    assert s["serving/tokens_emitted"] == 17
    assert s['serving/tokens_emitted{replica="0"}'] == 10
    assert s['serving/tokens_emitted{replica="1"}'] == 7


def test_federated_totals_monotonic_across_registry_swap():
    """A rebuilt engine's fresh registry restarts at zero; the fleet
    total must not go backwards."""
    fed = FederatedRegistry(include_default=False)
    src = {"0": MetricsRegistry()}
    src["0"].counter("serving/tokens_emitted").inc(100)
    fed.add_source("0", lambda: src["0"])
    assert fed.snapshot()["serving/tokens_emitted"] == 100
    src["0"] = MetricsRegistry()
    src["0"].counter("serving/tokens_emitted").inc(2)
    s = fed.snapshot()
    assert s["serving/tokens_emitted"] == 102
    assert s['serving/tokens_emitted{replica="0"}'] == 102
    src["0"].counter("serving/tokens_emitted").set(0)
    assert fed.snapshot()["serving/tokens_emitted"] == 102
    src["0"].counter("serving/tokens_emitted").inc(5)
    assert fed.snapshot()["serving/tokens_emitted"] == 107


def test_federated_rebuild_keeps_unminted_families():
    fed = FederatedRegistry(include_default=False)
    src = {"0": MetricsRegistry()}
    src["0"].counter("serving/requests_cancelled").inc(5)
    src["0"].counter("serving/tokens_emitted").inc(50)
    fed.add_source("0", lambda: src["0"])
    assert fed.snapshot()["serving/requests_cancelled"] == 5
    src["0"] = MetricsRegistry()
    src["0"].counter("serving/tokens_emitted").inc(3)
    s = fed.snapshot()
    assert s["serving/requests_cancelled"] == 5
    assert s['serving/requests_cancelled{replica="0"}'] == 5
    assert s["serving/tokens_emitted"] == 53
    assert "paddle_serving_requests_cancelled 5" in fed.export_prometheus()


def test_federated_remove_source_retires_totals():
    fed = FederatedRegistry(include_default=False)
    r0 = MetricsRegistry()
    r0.counter("serving/prefills").inc(9)
    fed.add_source("0", lambda: r0)
    assert fed.snapshot()["serving/prefills"] == 9
    fed.remove_source("0")
    s = fed.snapshot()
    assert s["serving/prefills"] == 9
    assert 'serving/prefills{replica="0"}' not in s


def test_federated_gauges_stay_per_replica():
    fed = FederatedRegistry(include_default=False)
    r0 = MetricsRegistry()
    r0.gauge("obs/overhead_frac").set(0.01)
    fed.add_source("0", lambda: r0)
    s = fed.snapshot()
    assert s['obs/overhead_frac{replica="0"}'] == 0.01
    assert "obs/overhead_frac" not in s


def test_federated_histogram_merge_deterministic():
    fed = FederatedRegistry(include_default=False)
    r0, r1 = MetricsRegistry(), MetricsRegistry()
    for v in (1.0, 2.0, 3.0):
        r0.histogram("serving/ttft_ms").observe(v)
    for v in (10.0, 20.0):
        r1.histogram("serving/ttft_ms").observe(v)
    fed.add_source("0", lambda: r0)
    fed.add_source("1", lambda: r1)
    a = fed.snapshot()["serving/ttft_ms"]
    assert a == fed.snapshot()["serving/ttft_ms"]
    assert a["count"] == 5 and a["sum"] == 36.0
    assert a["min"] == 1.0 and a["max"] == 20.0
    assert a["p50"] == 3.0
    assert fed.snapshot()['serving/ttft_ms{replica="1"}']["count"] == 2


def test_federated_prometheus_render():
    fed = FederatedRegistry(include_default=False)
    r0 = MetricsRegistry()
    r0.counter("serving/tokens_emitted").inc(4)
    r0.histogram("serving/ttft_ms").observe(5.0)
    fed.add_source("0", lambda: r0)
    txt = fed.export_prometheus()
    assert "paddle_serving_tokens_emitted 4" in txt
    assert 'paddle_serving_tokens_emitted{replica="0"} 4' in txt
    assert 'quantile="0.99"' in txt
    assert "paddle_serving_ttft_ms_count 1" in txt
    _assert_prom_parses(txt)


def test_federated_dead_provider_keeps_last_totals():
    fed = FederatedRegistry(include_default=False)
    r0 = MetricsRegistry()
    r0.counter("serving/prefills").inc(6)
    alive = [True]

    def provider():
        if not alive[0]:
            raise RuntimeError("torn down")
        return r0

    fed.add_source("0", provider)
    assert fed.snapshot()["serving/prefills"] == 6
    alive[0] = False
    assert fed.snapshot()["serving/prefills"] == 6


def test_labels_catalog_and_atomic_exports(tmp_path):
    """Labelled children in snapshots, the declared catalog, and the
    atomic Prometheus and JSON files."""
    tmetrics.declare("unit/lat_ms", "histogram", "a unit histogram")
    with pytest.raises(ValueError):
        tmetrics.declare("unit/lat_ms", "counter", "re-declared")
    with pytest.raises(ValueError):
        tmetrics.declare("NoSlash", "counter", "")
    reg = MetricsRegistry()
    c = reg.counter("unit/reqs")
    c.labels(route="/a").inc(2)
    c.labels(route="/b").inc()
    reg.histogram("unit/lat_ms").observe(3.0)
    snap = reg.snapshot()
    assert snap['unit/reqs{route="/a"}'] == 2
    assert snap['unit/reqs{route="/b"}'] == 1
    assert "| `unit/lat_ms` | histogram | a unit histogram |" \
        in tmetrics.catalog_markdown()
    text = reg.export(tmp_path / "m.prom")
    assert (tmp_path / "m.prom").read_text() == text
    assert "# HELP paddle_unit_lat_ms a unit histogram" in text
    assert json.loads(open(reg.export_json(tmp_path / "m.json")).read()) \
        == json.loads(json.dumps(snap))


def _metrics_workload(M):
    """One sequence of registry and federation operations; returns every
    view the module renders of it."""
    M.metrics.declare("parity/reqs", "counter", "parity requests")
    M.metrics.declare("parity/depth", "gauge", "parity queue depth")
    M.metrics.declare("parity/lat_ms", "histogram", "parity latency")
    reg = M.metrics.MetricsRegistry()
    c = reg.counter("parity/reqs")
    c.inc(3)
    c.labels(route="/v1/completions").inc(2)
    c.labels(route="/healthz").inc()
    reg.gauge("parity/depth").set(7)
    h = reg.histogram("parity/lat_ms", capacity=16)
    rng = np.random.RandomState(3)
    for v in rng.exponential(5.0, size=200):
        h.observe(float(v))              # past capacity: reservoir draws
    h.labels(route="/healthz").observe(1.5)
    fed = M.metrics.FederatedRegistry(include_default=False)
    fed.counter("parity/reqs").inc()
    src = {"0": M.metrics.MetricsRegistry(),
           "1": M.metrics.MetricsRegistry()}
    for label, n in (("0", 10), ("1", 4)):
        src[label].counter("parity/reqs").inc(n)
        src[label].gauge("parity/depth").set(n / 3)
        for v in rng.exponential(2.0, size=40):
            src[label].histogram("parity/lat_ms", capacity=8).observe(
                float(v))
        fed.add_source(label, lambda label=label: src[label])
    views = [fed.snapshot(), fed.export_prometheus()]
    src["0"] = M.metrics.MetricsRegistry()     # an engine rebuild
    src["0"].counter("parity/reqs").inc(2)
    views += [fed.snapshot(), fed.export_prometheus()]
    fed.remove_source("1")
    views += [fed.snapshot(), fed.export_prometheus()]
    return [reg.snapshot(), reg.export_prometheus(), h.samples(),
            h.percentile(37.5)] + views


def test_metrics_parity_with_jax():
    """The same operations give the same snapshots and the same
    Prometheus text, reservoir draws included."""
    port = _metrics_workload(MODS["torch"])
    assert port == _metrics_workload(MODS["jax"])
    for text in port[1::2][1:]:
        if isinstance(text, str):
            _assert_prom_parses(text)


# ---- the exposition server -------------------------------------------------

@pytest.mark.usefixtures("time_limit")
def test_server_endpoints_and_guarded_sections():
    reg = MetricsRegistry()
    reg.counter("serving/tokens_emitted").inc(11)
    reg.histogram("serving/ttft_ms").observe(3.5)
    srv = texposition.ObservabilityServer(registry=reg, sections={
        "ok": lambda: {"n": 1},
        "boom": lambda: (_ for _ in ()).throw(RuntimeError("x"))}).start()
    try:
        m = _get(srv.url + "/metrics")
        _assert_prom_parses(m)
        assert "paddle_serving_tokens_emitted 11" in m
        doc = json.loads(_get(srv.url + "/statusz"))
        assert doc["ok"] == {"n": 1}
        assert "RuntimeError" in doc["boom"]["error"]
        assert _get(srv.url + "/healthz") == "ok\n"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/nope")
        assert ei.value.code == 404
    finally:
        srv.stop()


@pytest.mark.usefixtures("time_limit")
def test_scrapes_are_metered():
    before = tmetrics.get_registry().counter("obs/scrapes").value
    srv = texposition.ObservabilityServer(registry=MetricsRegistry())
    srv.start()
    try:
        _get(srv.url + "/healthz")
        _get(srv.url + "/metrics")
    finally:
        srv.stop()
    assert tmetrics.get_registry().counter("obs/scrapes").value \
        >= before + 2


def test_exposition_renders_match_jax():
    """The same registry state and sections render the same /metrics
    and /statusz documents through both servers (without sockets)."""
    out = {}
    for side, M in MODS.items():
        M.metrics.declare("parity/reqs", "counter", "parity requests")
        reg = M.metrics.MetricsRegistry()
        reg.counter("parity/reqs").inc(5)
        calls = []
        srv = M.exposition.ObservabilityServer(
            registry=reg, sections={"a": lambda: {"x": 1.5},
                                    "b": lambda: 1 / 0},
            pre_scrape=lambda: calls.append(1))
        try:
            out[side] = (srv.render_metrics(), srv.render_statusz(),
                         len(calls))
        finally:
            srv.stop()
    assert out["torch"] == out["jax"]


# ---- gauges() keys: the JAX surfaces -------------------------------------

def test_engine_gauges_are_documented_jax_keys(model):
    """Every key of the port engine's gauges() is one that
    docs/serving.md documents for the JAX engine."""
    with open(os.path.join(REPO, "docs", "serving.md"),
              encoding="utf-8") as f:
        documented = set(re.findall(r"`([A-Za-z0-9_./]+)`", f.read()))
    missing = set(_factory(model)().gauges()) - documented
    assert not missing, sorted(missing)


def test_fleet_surfaces_are_the_jax_fleets(model):
    """The port fleet's gauges() keys are the JAX fleet's, and its
    /statusz sections too (the autoscaler's included)."""
    import paddle_tpu as paddle
    from paddle_tpu import inference as jinf
    from paddle_tpu.models import LlamaConfig as JLlamaConfig
    from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
    cfg = JLlamaConfig.tiny()
    cfg.tensor_parallel = False
    cfg.scan_layers = False
    cfg.num_hidden_layers = 1
    paddle.seed(0)
    jm = JLlamaForCausalLM(cfg)
    kw = {k: v for k, v in ENGINE.items() if k != "device"}
    jfleet = jinf.ServingFleet(
        lambda: jinf.ContinuousBatchingEngine(jm, **kw), num_replicas=1)
    fleet = tinf.ServingFleet(_factory(model), num_replicas=1)
    assert set(fleet.gauges()) == set(jfleet.gauges())
    assert set(fleet.statusz()) == set(jfleet.statusz())


# ---- the fleet's federation end to end -------------------------------------

def test_fleet_metrics_is_federated(model):
    fleet = tinf.ServingFleet(_factory(model), num_replicas=2,
                              retry_backoff_s=0.01)
    fids = [fleet.submit(p, 3) for p in _prompts(6)]
    fr.install(capacity=64)
    try:
        done = fleet.run()
    finally:
        fr.uninstall()
    assert len(done) == len(fids)
    s = fleet.metrics.snapshot()
    total = s["serving/tokens_emitted"]
    per = [s.get(f'serving/tokens_emitted{{replica="{i}"}}', 0)
           for i in (0, 1)]
    assert total == sum(per) and total > 0
    assert s["fleet/completed"] == len(fids)
    assert "obs/ring_events" in s          # the default registry rides


def test_fleet_obs_overhead_under_pin(model):
    """The fleet's own instrumentation (SLO booking, the trace log, the
    timeline rebuild) stays under 2% of the run. Its cost is per
    delivery (about 60 us for a tenant's first request, 15 us after);
    the port's CPU engine serves the JAX test's 4-token requests in
    about 30 ms in all, so the requests here carry 16 tokens to put
    some serving under the ratio."""
    fleet = tinf.ServingFleet(
        _factory(model), num_replicas=2, retry_backoff_s=0.01,
        slo_rules=[SLORule("ttft", kind="ttft", threshold_ms=60_000,
                           target=0.9)])
    fids = [fleet.submit(p, 16, tenant=f"t{i % 2}")
            for i, p in enumerate(_prompts(8, seed=3))]
    done = fleet.run()
    assert len(done) == len(fids)
    frac = fleet.gauges()["obs_overhead_frac"]
    assert 0.0 <= frac < 0.02, frac


@pytest.mark.fault
@pytest.mark.usefixtures("time_limit")
def test_exposition_under_replica_churn(model):
    """/metrics and /statusz scraped while a replica dies past its
    restart budget: every scrape parses, the federated totals never go
    backwards, every statusz section evaluates."""
    fleet = tinf.ServingFleet(_factory(model), num_replicas=3,
                              max_restarts=1, retry_backoff_s=0.01)
    stop = threading.Event()
    metrics_bodies, statusz_bodies, errors = [], [], []
    srv = fleet.observability_server()

    def scraper(path, sink):
        while not stop.is_set():
            try:
                sink.append(_get(srv.url + path))
            except Exception as e:  # noqa: BLE001 — the test failure
                errors.append(repr(e))

    threads = [threading.Thread(target=scraper, args=(p, sink))
               for p, sink in (("/metrics", metrics_bodies),
                               ("/statusz", statusz_bodies))]
    try:
        for t in threads:
            t.start()
        with FaultInjector() as fi:
            fi.kill_replica(1, times=10_000, after_steps=1)
            fids = [fleet.submit(p, 6) for p in _prompts(10, seed=7)]
            done = fleet.run()
        time.sleep(0.1)                # a scrape after the run, too
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        srv.stop()
    assert not errors, errors
    assert len(done) == len(fids)
    assert fleet.gauges()["breaker_open"] >= 1
    assert metrics_bodies and statusz_bodies
    totals = []
    for body in metrics_bodies:
        _assert_prom_parses(body)
        m = re.search(r"^paddle_serving_tokens_emitted ([0-9.]+)$", body,
                      re.M)
        if m:
            totals.append(float(m.group(1)))
        assert 'replica="0"' in body or not m
    assert all(b >= a for a, b in zip(totals, totals[1:])), totals
    for body in statusz_bodies:
        doc = json.loads(body)
        assert {"fleet", "replicas", "slowest_traces"} <= set(doc)
        assert not any(isinstance(v, dict) and set(v) == {"error"}
                       for v in doc.values()), doc


@pytest.mark.fault
def test_bundle_carries_federated_snapshot(model, tmp_path):
    rec = fr.FlightRecorder(bundle_dir=str(tmp_path))
    fr.install(rec)
    try:
        fleet = tinf.ServingFleet(_factory(model), num_replicas=2,
                                  max_restarts=1, retry_backoff_s=0.01)
        with FaultInjector() as fi:
            fi.kill_replica(1, times=10_000, after_steps=1)
            fids = [fleet.submit(p, 6) for p in _prompts(12, seed=5)]
            done = fleet.run()
        assert len(done) == len(fids)
        doc = json.loads((tmp_path / BUNDLE_NAME).read_text())
        assert [k for k in doc["metrics"]
                if k.startswith("serving/tokens_emitted{replica=")]
        assert rec.incidents()
        assert rec.fleet_registry is None
    finally:
        fr.uninstall()


# ---- the tracer ------------------------------------------------------------

class TestSpans:
    def test_nesting_depths_recorded(self):
        tr = trace.Tracer(enabled=True)
        with tr.span("outer"):
            with tr.span("mid"):
                with tr.span("leaf"):
                    pass
            with tr.span("mid2"):
                pass
        by_name = {e.name: e for e in tr.events}
        assert by_name["outer"].depth == 0
        assert by_name["mid"].depth == by_name["mid2"].depth == 1
        assert by_name["leaf"].depth == 2
        assert [e.name for e in tr.events] == ["leaf", "mid", "mid2",
                                               "outer"]

    def test_span_timing_and_containment(self):
        tr = trace.Tracer(enabled=True)
        with tr.span("outer"):
            with tr.span("inner"):
                time.sleep(0.01)
        inner, outer = tr.events
        assert inner.dur >= 10_000
        assert outer.dur >= inner.dur
        assert outer.ts <= inner.ts
        assert inner.ts + inner.dur <= outer.ts + outer.dur + 1.0

    def test_exception_safety(self):
        tr = trace.Tracer(enabled=True)
        with pytest.raises(ValueError, match="boom"):
            with tr.span("will_raise"):
                raise ValueError("boom")
        assert len(tr.events) == 1
        assert "ValueError: boom" in tr.events[0].args["error"]
        with tr.span("after"):
            pass
        assert tr.events[-1].depth == 0

    def test_disabled_tracer_records_nothing(self):
        tr = trace.Tracer(enabled=False)
        with tr.span("x"):
            pass
        tr.counter("c", 1)
        tr.instant("i")
        tr.complete("r", 0.0, 1.0)
        assert tr.events == []

    def test_span_args_and_set_args(self):
        tr = trace.Tracer(enabled=True)
        with tr.span("op", flops=100.0) as sp:
            sp.set_args(bytes=50.0)
        assert tr.events[0].args == {"flops": 100.0, "bytes": 50.0}

    def test_device_sync_point(self):
        """``sync=`` and ``device_sync`` wait on the tensors' device work
        (none on the CPU) and record the wait."""
        tr = trace.Tracer(enabled=True)
        x = torch.ones((4, 4))
        with tr.span("matmul", sync=lambda: [x @ x, {"k": x}]):
            pass
        assert tr.events[0].args["sync_s"] >= 0.0
        assert tr.device_sync(x) >= 0.0
        assert any(e.cat == "sync" for e in tr.events)

    def test_block_on_waits_on_the_cuda_stream(self, monkeypatch):
        """CPU tensors need no wait; CUDA tensors make ``block_on`` wait
        on their device's current stream, once a device."""
        waited = []

        class _Stream:
            def synchronize(self):
                waited.append(1)

        class _CudaTensor(torch.Tensor):
            @property
            def is_cuda(self):
                return True

            @property
            def device(self):
                return torch.device("cuda", 0)

        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: _Stream())
        t = torch.ones(1)
        assert trace.block_on([t, 3, None]) >= 0.0 and not waited
        c = torch.ones(1).as_subclass(_CudaTensor)
        trace.block_on((c, {"k": c}))
        assert waited == [1]


class TestChromeExport:
    def _trace(self):
        tr = trace.Tracer(enabled=True)
        with tr.span("sec", cat="train", flops=1e6):
            pass
        tr.counter("gauge", 0.5)
        tr.instant("marker")
        return tr

    def test_chrome_trace_schema(self, tmp_path):
        tr = self._trace()
        doc = json.load(open(tr.export_chrome_trace(tmp_path / "t.json")))
        evs = doc["traceEvents"]
        assert {e["ph"] for e in evs} == {"X", "C", "i"}
        for e in evs:
            for key in ("name", "ph", "ts", "pid", "tid"):
                assert key in e, e
        x = next(e for e in evs if e["ph"] == "X")
        assert "dur" in x and x["args"]["flops"] == 1e6
        assert next(e for e in evs if e["ph"] == "C")["args"]["value"] \
            == 0.5

    def test_json_export_has_sections(self, tmp_path):
        tr = self._trace()
        doc = json.load(open(tr.export_json(tmp_path / "raw.json")))
        assert doc["sections"]["sec"]["count"] == 1
        assert doc["sections"]["sec"]["flops"] == 1e6

    @pytest.mark.fault
    def test_export_is_atomic_under_fault(self, tmp_path):
        """A full disk mid-export leaves no torn file and no .tmp; a
        retry after the fault succeeds."""
        tr = self._trace()
        target = tmp_path / "trace.json"
        with JFaultInjector() as fi:
            fi.fail_write(str(target), errno_=errno.ENOSPC, after_bytes=10)
            with pytest.raises(OSError):
                tr.export_chrome_trace(target)
            assert fi.fires() == 1
        assert not target.exists()
        assert not os.path.exists(str(target) + ".tmp")
        assert json.load(open(tr.export_chrome_trace(target)))[
            "traceEvents"]

    def test_log_perf_event_dedupes(self, caplog):
        import logging
        with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.perf"):
            assert trace.log_perf_event("unit/evt", "first",
                                        once_key=("unit", 1))
            assert not trace.log_perf_event("unit/evt", "second",
                                            once_key=("unit", 1))
        msgs = [r.message for r in caplog.records]
        assert any("first" in m for m in msgs)
        assert not any("second" in m for m in msgs)


class TestRequestTraceLog:
    def test_slowest_ordering_and_bound(self):
        log = trace.RequestTraceLog(capacity=3)
        for i, ms in enumerate([5.0, 50.0, 20.0, 7.0]):
            log.record({"trace_id": i, "latency_ms": ms})
        assert [e["trace_id"] for e in log.slowest(2)] == [1, 2]
        assert [e["trace_id"] for e in log.recent()] == [1, 2, 3]
        assert log.recorded == 4
        log.clear()
        assert log.recent() == []

    def test_engine_traces_a_sampled_request(self, model):
        """trace_sample_rate=1: with the tracer on, a request's queued /
        prefill / first-token / decode spans land on its own track."""
        tracer = trace.get_tracer()
        tracer.clear()
        tracer.enabled = True
        try:
            eng = _factory(model, trace_sample_rate=1.0)()
            rid = eng.add_request(_prompts(1)[0], 3)
            eng.run()
        finally:
            tracer.enabled = False
        names = {e.name for e in tracer.events if e.tid == rid}
        tracer.clear()
        assert {"req/queued", "req/prefill", "req/first_token_wait",
                "req/decode", "req/hop"} <= names


# ---- the flight recorder ---------------------------------------------------

@pytest.fixture()
def _uninstalled():
    fr.uninstall()
    yield
    fr.uninstall()


def _load_bundle(path):
    doc = json.loads(open(path, encoding="utf-8").read())
    assert doc["schema"] == BUNDLE_SCHEMA
    for key in ("reason", "ts", "pid", "restart_round", "events",
                "threads", "metrics"):
        assert key in doc, key
    return doc


@pytest.mark.usefixtures("_uninstalled")
class TestFlightRecorder:
    def test_ring_keeps_last_capacity_events_in_order(self):
        rec = FlightRecorder(capacity=8)
        for i in range(20):
            rec.record("turn", i=i)
        evs = rec.events()
        assert [e["i"] for e in evs] == list(range(12, 20))
        assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)

    def test_record_event_noop_until_installed(self):
        assert fr.record_event("turn", x=1) is None
        rec = fr.install(capacity=16)
        before = tmetrics.get_registry().counter("obs/ring_events").value
        fr.record_event("turn", x=1)
        assert len(rec.events()) == 1
        assert tmetrics.get_registry().counter("obs/ring_events").value \
            == before + 1

    def test_concurrent_recording_wait_free(self):
        rec = FlightRecorder(capacity=128)
        n_threads, per = 6, 2000
        start = threading.Barrier(n_threads)

        def worker(k):
            start.wait()
            for i in range(per):
                rec.record("turn", k=k, i=i)

        ts = [threading.Thread(target=worker, args=(k,))
              for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        seqs = [e["seq"] for e in rec.events()]
        assert seqs == list(range(n_threads * per - 128, n_threads * per))

    def test_dump_bundle_contents(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("t/frc").inc(7)
        rec = FlightRecorder(capacity=16, bundle_dir=str(tmp_path),
                             registry=reg)
        rec.record("sched_turn", seq=1)
        rec.record("admit", req=0)
        path = rec.dump("unit test")
        assert path == os.path.join(str(tmp_path), BUNDLE_NAME)
        doc = _load_bundle(path)
        assert doc["reason"] == "unit test"
        assert [e["kind"] for e in doc["events"]] == ["sched_turn", "admit"]
        assert doc["metrics"]["t/frc"] == 7
        assert any("MainThread" in k for k in doc["threads"])
        assert any("test_dump_bundle_contents" in line
                   for frames in doc["threads"].values()
                   for line in frames)
        assert reg.counter("obs/bundle_dumps").value == 1

    def test_dump_without_destination_is_none(self):
        assert FlightRecorder(capacity=4).dump("nowhere") is None

    def test_incident_bundle_survives_periodic_overwrite(self, tmp_path):
        rec = FlightRecorder(capacity=8, bundle_dir=str(tmp_path),
                             keep_incidents=2)
        rec.record("sched_turn", seq=1)
        rec.dump("stall: wedged")
        rec.record("heartbeat")
        rec.dump("periodic")
        latest = _load_bundle(os.path.join(str(tmp_path), BUNDLE_NAME))
        assert latest["reason"] == "periodic"
        incidents = sorted(f for f in os.listdir(str(tmp_path))
                           if f.startswith("flight_incident_"))
        assert len(incidents) == 1
        assert _load_bundle(os.path.join(str(tmp_path), incidents[0]))[
            "reason"] == "stall: wedged"
        for i in range(4):
            rec.dump(f"crash: boom {i}")
        assert len([f for f in os.listdir(str(tmp_path))
                    if f.startswith("flight_incident_")]) == 2

    def test_watchdog_ignores_foreign_beats(self, tmp_path):
        rec = FlightRecorder(capacity=8, bundle_dir=str(tmp_path))
        wd = Watchdog(rec, timeout_s=0.25, poll_s=0.05)
        try:
            stale = wd.arm("first region")
            owner = wd.arm("serving run loop")
            deadline = time.time() + 5.0
            bundle = os.path.join(str(tmp_path), BUNDLE_NAME)
            while time.time() < deadline and not os.path.exists(bundle):
                wd.beat(stale)
                time.sleep(0.02)
            assert os.path.exists(bundle)
            assert "serving run loop" in _load_bundle(bundle)["reason"]
            wd.disarm(stale)
            assert wd._armed.is_set()
            wd.disarm(owner)
            assert not wd._armed.is_set()
        finally:
            wd.stop()

    def test_pre_install_arm_token_is_inert(self, tmp_path):
        stale = fr.arm("armed before any watchdog existed")
        assert stale is not None
        rec = FlightRecorder(capacity=8, bundle_dir=str(tmp_path))
        wd = Watchdog(rec, timeout_s=0.25, poll_s=0.05)
        try:
            wd.arm("serving run loop")
            deadline = time.time() + 5.0
            bundle = os.path.join(str(tmp_path), BUNDLE_NAME)
            while time.time() < deadline and not os.path.exists(bundle):
                wd.beat(stale)
                wd.disarm(stale)
                time.sleep(0.02)
            assert os.path.exists(bundle)
            assert "serving run loop" in _load_bundle(bundle)["reason"]
            assert wd._armed.is_set()
        finally:
            wd.stop()

    def test_reinstall_rebinds_live_watchdog_recorder(self, tmp_path):
        fr.install(capacity=8, bundle_dir=str(tmp_path / "old"),
                   watchdog_timeout_s=30.0)
        wd = fr.get_watchdog()
        rec2 = fr.install(capacity=8, bundle_dir=str(tmp_path / "new"))
        assert wd is fr.get_watchdog() and wd.recorder is rec2

    @pytest.mark.fault
    def test_dump_fault_never_leaves_torn_bundle(self, tmp_path):
        rec = FlightRecorder(capacity=16, bundle_dir=str(tmp_path))
        rec.record("turn", i=1)
        p = rec.dump("first")
        rec.record("turn", i=2)
        with JFaultInjector() as fi:
            fi.fail_write(BUNDLE_NAME, errno_=errno.ENOSPC)
            with pytest.raises(OSError):
                rec.dump("second")
        assert _load_bundle(p)["reason"] == "first"
        assert not os.path.exists(p + ".tmp")
        rec.dump("third")
        assert _load_bundle(p)["reason"] == "third"

    def test_watchdog_dumps_on_no_progress(self, tmp_path):
        """An armed region stops beating (a scheduler thread blocked on
        an event) and the watchdog's bundle shows the blocked thread."""
        rec = fr.install(capacity=32, bundle_dir=str(tmp_path))
        wd = Watchdog(rec, timeout_s=0.3, poll_s=0.05)
        release = threading.Event()
        try:
            def stuck_scheduler():
                fr.record_event("sched_turn", seq=1)
                release.wait(30)

            t = threading.Thread(target=stuck_scheduler,
                                 name="stuck-scheduler", daemon=True)
            wd.arm("serving run loop")
            t.start()
            deadline = time.time() + 10.0
            bundle = os.path.join(str(tmp_path), BUNDLE_NAME)
            while time.time() < deadline and not os.path.exists(bundle):
                time.sleep(0.05)
            doc = _load_bundle(bundle)
            assert "stall" in doc["reason"]
            assert "serving run loop" in doc["reason"]
            assert any(e["kind"] == "sched_turn" for e in doc["events"])
            assert any("stuck-scheduler" in k for k in doc["threads"])
            assert wd.stall_dumps == 1
        finally:
            release.set()
            wd.stop()

    def test_watchdog_does_not_dump_while_beating(self, tmp_path):
        rec = FlightRecorder(capacity=8, bundle_dir=str(tmp_path))
        wd = Watchdog(rec, timeout_s=0.3, poll_s=0.05)
        try:
            wd.arm("busy loop")
            for _ in range(10):
                wd.beat()
                time.sleep(0.05)
            wd.disarm()
            time.sleep(0.5)
            assert not os.path.exists(os.path.join(str(tmp_path),
                                                   BUNDLE_NAME))
            assert wd.stall_dumps == 0
        finally:
            wd.stop()

    def test_engine_stall_raises_and_dumps(self, model, tmp_path):
        """The engine's stall guard dumps the bundle before it raises."""
        eng = tinf.ContinuousBatchingEngine(
            model, num_slots=1, page_size=8, max_len=64, decode_chunk=4,
            prompt_buckets=(8,), greedy=True, audit=False, device="cpu")
        eng.add_request(np.arange(5, dtype=np.int32), 4)
        eng._free_pages.clear()
        fr.install(capacity=32, bundle_dir=str(tmp_path))
        with pytest.raises(RuntimeError, match="stalled"):
            eng.run()
        doc = _load_bundle(os.path.join(str(tmp_path), BUNDLE_NAME))
        assert "stalled" in doc["reason"]
        assert any(e["kind"] == "serving_stall" for e in doc["events"])

    def test_engine_feeds_the_ring(self, model):
        """An engine run records admissions, scheduler turns and
        completions; a clean run with a watchdog armed dumps nothing."""
        rec = fr.install(capacity=256, watchdog_timeout_s=30.0)
        eng = _factory(model)()
        for p in _prompts(3):
            eng.add_request(p, 4)
        eng.run()
        kinds = [e["kind"] for e in rec.events()]
        assert kinds.count("admit") == 3 and kinds.count("finish") == 3
        assert "sched_turn" in kinds
        assert fr.get_watchdog().stall_dumps == 0 and rec.dumps == 0

    def test_crash_hook_dumps_on_uncaught_exception(self, tmp_path):
        rec = fr.install(capacity=8, bundle_dir=str(tmp_path))
        rec.record("turn", i=1)
        fr.install_crash_hook()
        prev = sys.excepthook
        try:
            try:
                raise ValueError("boom in turn 1")
            except ValueError:
                ei = sys.exc_info()
            sys.excepthook(*ei)
        finally:
            sys.excepthook = prev
        doc = _load_bundle(os.path.join(str(tmp_path), BUNDLE_NAME))
        assert doc["reason"] == "crash: ValueError: boom in turn 1"

    @pytest.mark.fault
    def test_abrupt_exit_leaves_complete_bundle(self, tmp_path):
        """A process that dies with ``os._exit`` (no atexit, no flush,
        as a SIGKILL looks) right after a breadcrumb leaves a complete
        bundle from the periodic persistence, and imports neither jax
        nor the JAX package."""
        script = tmp_path / "child.py"
        script.write_text(
            "import os, sys\n"
            "from paddle_tpu_torch.profiler import flight_recorder as fr\n"
            "from paddle_tpu_torch.profiler import metrics\n"
            "rec = fr.install(capacity=64, bundle_dir=sys.argv[1],\n"
            "                 persist_every=1)\n"
            "metrics.get_registry().counter('obs/ring_events')\n"
            "for i in range(10):\n"
            "    fr.record_event('sched_turn', seq=i, mode='child')\n"
            "fr.record_event('admit', req=7)\n"
            "assert not [m for m in sys.modules if m == 'jax'\n"
            "            or m.split('.')[0] == 'paddle_tpu']\n"
            "os._exit(41)\n")
        proc = subprocess.run([sys.executable, str(script), str(tmp_path)],
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 41, proc.stderr
        doc = _load_bundle(os.path.join(str(tmp_path), BUNDLE_NAME))
        kinds = [e["kind"] for e in doc["events"]]
        assert kinds.count("sched_turn") == 10 and kinds[-1] == "admit"
        assert doc["metrics"]["obs/ring_events"] >= 10
        assert doc["threads"]


# ---- SLO accounting --------------------------------------------------------

def _req(ttft_s=0.01, total_s=0.1, error=None, tenant="a", priority=0,
         first=True, finish_reason=None):
    return types.SimpleNamespace(t_arrive=0.0,
                                 t_first=ttft_s if first else 0.0,
                                 t_done=total_s, error=error,
                                 tenant=tenant, priority=priority,
                                 finish_reason=finish_reason)


def _tracker(rule, side="torch", **kw):
    M = MODS[side]
    clock = [0.0]
    reg = M.metrics.MetricsRegistry()
    tr = M.slo.SLOTracker([rule], registry=reg, now_fn=lambda: clock[0],
                          **kw)
    return tr, clock, reg


def test_rule_validation():
    with pytest.raises(ValueError):
        SLORule("x", kind="nope")
    with pytest.raises(ValueError):
        SLORule("x", kind="ttft")
    with pytest.raises(ValueError):
        SLORule("x", kind="success", target=1.0)
    with pytest.raises(ValueError):
        SLOTracker([SLORule("a", kind="success"),
                    SLORule("a", kind="success")])


def test_predicates():
    ttft = SLORule("t", kind="ttft", threshold_ms=50)
    assert ttft.good(_req(ttft_s=0.049))
    assert not ttft.good(_req(ttft_s=0.051))
    assert not ttft.good(_req(first=False))
    e2e = SLORule("e", kind="e2e", threshold_ms=200)
    assert e2e.good(_req(total_s=0.199))
    assert not e2e.good(_req(total_s=0.3))
    ok = SLORule("s", kind="success")
    assert ok.good(_req())
    assert not ok.good(_req(error=RuntimeError("x")))


def _burn_scenario(side):
    """target 0.9: ten good then five bad requests fire one alert at the
    third miss; the window ages out and clears it; a fresh breach fires
    a second. Returns every observable the tracker gives."""
    M = MODS[side]
    rule = M.slo.SLORule("ttft", kind="ttft", threshold_ms=50, target=0.9,
                         burn_alert=2.0, min_events=5, window_s=100.0)
    tr, clock, reg = _tracker(rule, side)
    seen = []
    for _ in range(10):
        clock[0] += 1.0
        seen.append(tr.record(_req()))
    fired = []
    for _ in range(5):
        clock[0] += 1.0
        fired += tr.record(_req(ttft_s=9.9))
    seen += [fired, tr.alerts(), tr.summary(), reg.snapshot()]
    clock[0] += 200.0
    seen += [tr.record(_req()), tr.alerts()]
    fired = []
    for _ in range(20):
        clock[0] += 1.0
        fired += tr.record(_req(ttft_s=9.9))
    seen += [fired, tr.summary(), reg.snapshot(), reg.export_prometheus(),
             list(tr.alert_history)]
    return seen


def test_burn_rate_math_and_alert_hysteresis():
    seen = _burn_scenario("torch")
    fired, alerts = seen[10], seen[11]
    assert all(s == [] for s in seen[:10])
    assert len(fired) == 1
    a = fired[0]
    assert a["rule"] == "ttft" and a["labels"] == {"tenant": "a"}
    assert a["burn_rate"] == pytest.approx((3 / 13) / 0.1, rel=1e-3)
    assert alerts[0]["burn_rate"] == pytest.approx((5 / 15) / 0.1,
                                                   rel=1e-3)
    assert seen[14] == [] and seen[15] == []      # aged out, cleared
    assert len(seen[16]) == 1
    assert seen[17]["alerts_fired"] == 2


def test_slo_parity_with_jax():
    """The same timeline gives the same burn rates, alert records,
    summaries, metric snapshots and Prometheus text."""
    assert _burn_scenario("torch") == _burn_scenario("jax")


def test_min_events_guards_cold_windows():
    rule = SLORule("t", kind="ttft", threshold_ms=50, target=0.99,
                   min_events=10)
    tr, clock, _ = _tracker(rule)
    clock[0] += 1.0
    assert tr.record(_req(ttft_s=9.9)) == []
    assert tr.alerts() == []


def _tenant_scenario(side):
    M = MODS[side]
    rule = M.slo.SLORule("t", kind="ttft", threshold_ms=50, target=0.9,
                         min_events=2, burn_alert=2.0)
    tr, clock, reg = _tracker(rule, side)
    for _ in range(4):
        clock[0] += 1.0
        tr.record(_req(tenant="good"))
        tr.record(_req(ttft_s=9.9, tenant="bad"))
    return tr, reg


def test_per_tenant_partitioning_and_metrics():
    tr, reg = _tenant_scenario("torch")
    assert tr.attainment("t", tenant="good") == 1.0
    assert tr.attainment("t", tenant="bad") == 0.0
    alerts = tr.alerts()
    assert len(alerts) == 1 and alerts[0]["labels"] == {"tenant": "bad"}
    snap = reg.snapshot()
    assert snap['slo/attainment{rule="t",tenant="good"}'] == 1.0
    assert snap['slo/misses{rule="t",tenant="bad"}'] == 4
    assert snap['slo/alerts_fired{rule="t",tenant="bad"}'] == 1
    assert snap["slo/alerts_active"] == 1
    s = tr.summary()
    assert s["worst_attainment"] == 0.0
    assert s["rules"]["t"]["labels"]["bad"]["alerting"] is True
    assert s["rules"]["t"]["labels"]["good"]["alerting"] is False
    jtr, jreg = _tenant_scenario("jax")
    assert (tr.summary(), reg.snapshot()) == (jtr.summary(),
                                              jreg.snapshot())


def test_label_space_is_bounded():
    rule = SLORule("t", kind="success", target=0.9, by=("tenant",))
    tr, clock, _ = _tracker(rule, max_labels=8)
    for i in range(50):
        clock[0] += 1.0
        tr.record(_req(tenant=f"tenant-{i}"))
    assert len(tr._windows) <= 9
    assert ("t", ("_overflow",)) in tr._windows


def test_alert_self_resolves_without_new_traffic():
    rule = SLORule("t", kind="ttft", threshold_ms=50, target=0.9,
                   min_events=3, burn_alert=2.0, window_s=100.0)
    tr, clock, reg = _tracker(rule)
    for _ in range(5):
        clock[0] += 1.0
        tr.record(_req(ttft_s=9.9))
    assert tr.alerts()
    clock[0] += 1000.0
    assert tr.alerts() == []
    assert tr.summary()["alerts_active"] == []
    assert reg.snapshot()["slo/alerts_active"] == 0


def test_metrics_scrape_path_refreshes_gauges():
    rule = SLORule("t", kind="ttft", threshold_ms=50, target=0.9,
                   min_events=3, burn_alert=2.0, window_s=100.0)
    tr, clock, reg = _tracker(rule)
    for _ in range(5):
        clock[0] += 1.0
        tr.record(_req(ttft_s=9.9))
    kv = 'slo/burn_rate{rule="t",tenant="a"}'
    assert reg.snapshot()[kv] == 10.0
    assert reg.snapshot()["slo/alerts_active"] == 1
    clock[0] += 1000.0
    srv = texposition.ObservabilityServer(registry=reg,
                                          pre_scrape=tr.refresh)
    try:
        srv.render_metrics()             # what a /metrics scrape runs
    finally:
        srv.stop()
    snap = reg.snapshot()
    assert snap[kv] == 0.0
    assert snap['slo/attainment{rule="t",tenant="a"}'] == 1.0
    assert snap["slo/alerts_active"] == 0


def test_cancelled_requests_do_not_burn_budget():
    rule = SLORule("s", kind="success", target=0.9, min_events=2,
                   burn_alert=2.0)
    tr, clock, _ = _tracker(rule)
    for _ in range(5):
        clock[0] += 1.0
        assert tr.record(_req(error=RuntimeError("cancelled"),
                              finish_reason="cancelled")) == []
    assert tr.attainment("s", tenant="a") == 1.0
    assert tr.alerts() == []
    strict = SLORule("s2", kind="success", target=0.9, min_events=2,
                     burn_alert=2.0, count_cancelled=True)
    tr2, clock2, _ = _tracker(strict)
    for _ in range(5):
        clock2[0] += 1.0
        tr2.record(_req(error=RuntimeError("cancelled"),
                        finish_reason="cancelled"))
    assert tr2.alerts()


def test_partition_by_priority():
    rule = SLORule("t", kind="success", target=0.9,
                   by=("tenant", "priority"))
    tr, clock, _ = _tracker(rule)
    clock[0] += 1.0
    tr.record(_req(tenant="a", priority=1))
    tr.record(_req(tenant="a", priority=0, error=RuntimeError("x")))
    s = tr.summary()["rules"]["t"]["labels"]
    assert s["a,1"]["attainment"] == 1.0
    assert s["a,0"]["attainment"] == 0.0


# ---- the goodput ledger ----------------------------------------------------

def test_partition_math_and_categories():
    led = GoodputLedger(round_=0)
    led.add("input_wait", 1.0)
    led.add("checkpoint_save", 0.5)
    with led.measure("recompile"):
        time.sleep(0.01)
    with pytest.raises(ValueError, match="category"):
        led.add("not_a_category", 1.0)
    s = led.summary()
    assert set(CATEGORIES) == {k[len("lost_"):-len("_s")] for k in s
                               if k.startswith("lost_") and k != "lost_s"}
    assert s["lost_input_wait_s"] == 1.0
    assert s["lost_checkpoint_save_s"] == 0.5
    assert s["lost_recompile_s"] >= 0.01
    assert s["lost_emergency_save_s"] == 0.0
    assert s["lost_s"] == pytest.approx(
        sum(s[f"lost_{c}_s"] for c in CATEGORIES))
    assert s["productive_s"] == pytest.approx(max(0.0, s["wall_s"]
                                                  - s["lost_s"]))
    assert 0.0 <= s["goodput_frac"] <= 1.0


def test_goodput_clamped_when_attribution_exceeds_wall():
    led = GoodputLedger(round_=0)
    led.add("input_wait", 10_000.0)
    s = led.summary()
    assert s["productive_s"] == 0.0 and s["goodput_frac"] == 0.0


def test_close_freezes_wall_clock():
    led = GoodputLedger(round_=0)
    led.add("input_wait", 0.005)
    led.close()
    s0 = led.summary()
    time.sleep(0.05)
    led.close()
    s1 = led.summary()
    assert s1["wall_s"] == s0["wall_s"]
    assert s1["goodput_frac"] == s0["goodput_frac"]


def test_bench_keys_projection():
    led = GoodputLedger(round_=0)
    led.add("restart", 2.0)
    keys = led.bench_keys()
    assert "obs_goodput_frac" in keys and "obs_wall_s" in keys
    for c in CATEGORIES:
        assert f"obs_lost_{c}_s" in keys
    assert keys["obs_lost_restart_s"] == 2.0


def test_persist_and_resume_accumulates_rounds(tmp_path):
    path = tmp_path / "goodput.json"
    led0 = GoodputLedger(path=path, round_=0)
    led0.add("input_wait", 0.25)
    led0.persist()
    doc = json.loads(path.read_text())
    assert doc["schema"] == LEDGER_SCHEMA
    doc["rounds"]["0"]["t_end"] = time.time() - 5.0
    path.write_text(json.dumps(doc))
    led1 = GoodputLedger(path=path, round_=1)
    s = led1.summary()
    assert s["rounds"] == 2
    assert 4.0 < s["lost_restart_s"] < 10.0
    assert s["wall_s"] >= s["lost_restart_s"]
    assert s["lost_input_wait_s"] == 0.25
    led1.persist()
    assert set(json.loads(path.read_text())["rounds"]) == {"0", "1"}
    s2 = GoodputLedger(path=path, round_=1).summary()
    assert abs(s2["lost_restart_s"] - s["lost_restart_s"]) < 1.0


def test_fresh_run_does_not_inherit_stale_ledger(tmp_path):
    path = tmp_path / "goodput.json"
    led0 = GoodputLedger(path=path, round_=0)
    led0.add("input_wait", 9.0)
    led0.persist()
    s = GoodputLedger(path=path, round_=1, load=False).summary()
    assert s["rounds"] == 1
    assert s["lost_restart_s"] == 0.0 and s["lost_input_wait_s"] == 0.0


def test_same_round_repersist_replaces_not_duplicates(tmp_path):
    path = tmp_path / "goodput.json"
    led = GoodputLedger(path=path, round_=0)
    led.add("input_wait", 1.0)
    led.persist()
    led.add("input_wait", 1.0)
    led.persist()
    assert GoodputLedger(path=path, round_=0).summary()[
        "lost_input_wait_s"] == 0.0


def test_corrupt_ledger_warns_and_starts_fresh(tmp_path):
    path = tmp_path / "goodput.json"
    path.write_text("{torn json")
    with pytest.warns(UserWarning, match="unreadable"):
        led = GoodputLedger(path=path, round_=1)
    assert led.summary()["rounds"] == 1


@pytest.mark.fault
def test_persist_fault_keeps_previous_ledger(tmp_path):
    path = tmp_path / "goodput.json"
    led = GoodputLedger(path=path, round_=0)
    led.add("input_wait", 0.5)
    led.persist()
    led.add("input_wait", 0.5)
    with JFaultInjector() as fi:
        fi.fail_write("goodput.json", errno_=errno.ENOSPC)
        with pytest.raises(OSError):
            led.persist()
    assert json.loads(path.read_text())["rounds"]["0"]["lost"][
        "input_wait"] == 0.5
    led.persist()
    assert json.loads(path.read_text())["rounds"]["0"]["lost"][
        "input_wait"] == 1.0


class _Clock:
    """A frozen clock for a goodput module: ``time()``, ``monotonic()``
    and ``perf_counter()`` read ``now``."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    monotonic = perf_counter = time


def _goodput_scenario(side, tmp_path, monkeypatch):
    M = MODS[side]
    clock = _Clock()
    monkeypatch.setattr(M.goodput, "time", clock)
    path = tmp_path / side / "goodput.json"
    led0 = M.goodput.GoodputLedger(path=path, round_=0)
    clock.now += 3.25
    led0.add("input_wait", 0.5)
    led0.add("checkpoint_save", 0.125)
    led0.persist()
    clock.now += 7.0                       # the restart gap
    led1 = M.goodput.GoodputLedger(path=path, round_=1)
    clock.now += 11.5
    led1.add("recompile", 2.0)
    led1.add("input_wait", 1.0 / 3.0)
    out = [led0.summary(), led1.summary(), led1.bench_keys()]
    led1.close()
    clock.now += 100.0
    out.append(led1.summary())
    return out


def test_goodput_parity_with_jax(tmp_path, monkeypatch):
    """Two rounds around a restart gap on frozen clocks: the same
    partitions, goodput fractions and benchmark keys."""
    port = _goodput_scenario("torch", tmp_path, monkeypatch)
    assert port == _goodput_scenario("jax", tmp_path, monkeypatch)
    assert port[1]["lost_restart_s"] == 7.0
    assert port[1]["rounds"] == 2


def test_goodput_section_in_statusz(model):
    """The fleet's /statusz goodput section reads the current ledger."""
    fleet = tinf.ServingFleet(_factory(model), num_replicas=1)
    assert fleet.statusz()["goodput"] is None
    led = GoodputLedger(round_=0)
    led.add("input_wait", 1.0)
    tgoodput.set_current(led)
    try:
        assert fleet.statusz()["goodput"]["lost_input_wait_s"] == 1.0
    finally:
        tgoodput.set_current(None)

def test_persist_fault_keeps_previous_ledger_port_injector(tmp_path):
    """The same fault through the port's own file plans."""
    path = tmp_path / "goodput.json"
    led = GoodputLedger(path=path, round_=0)
    led.add("input_wait", 0.5)
    led.persist()
    with FaultInjector() as fi:
        fi.fail_write("goodput.json", errno_=errno.ENOSPC)
        with pytest.raises(OSError):
            led.persist()
    assert fi.fires() == 1
    assert json.loads(path.read_text())["rounds"]["0"]["lost"][
        "input_wait"] == 0.5


def test_fit_maintains_ledger_and_persists(tmp_path):
    """tests/test_goodput.py's fit case: fit books the input wait and the
    checkpoint saves into its ledger, reports goodput_frac in the epoch
    summary, persists goodput.json beside the checkpoints and makes the
    ledger the current one (what /statusz reads). The port has no
    compiled step, so nothing is booked as ``recompile``."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.models import LlamaPretrainingCriterion
    from paddle_tpu_torch.optimizer import SGD
    cfg = dataclasses.replace(LlamaConfig.tiny(), num_hidden_layers=1)
    net = LlamaForCausalLM(cfg, device="cpu", seed=0)
    m = Model(net)
    m.prepare(SGD(1e-3, parameters=net.parameters()),
              LlamaPretrainingCriterion(cfg))
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 17)).astype(np.int64))
    save_dir = tmp_path / "ckpt"
    try:
        m.fit(TensorDataset([ids, ids]), batch_size=2, epochs=2, verbose=0,
              shuffle=False, save_dir=str(save_dir), legacy_save=False)
        assert tgoodput.get_current() is m._goodput
    finally:
        tgoodput.set_current(None)
    summary = m._last_epoch_summary
    assert 0.0 <= summary["goodput_frac"] <= 1.0
    assert summary["input_wait_ms"] >= 0.0
    doc = json.loads((save_dir / "goodput.json").read_text())
    assert doc["schema"] == LEDGER_SCHEMA
    lost = doc["rounds"]["0"]["lost"]
    assert lost["checkpoint_save"] > 0.0           # epoch saves booked
    assert lost["input_wait"] > 0.0
    assert lost["recompile"] == 0.0 and lost["emergency_save"] == 0.0
    keys = m._goodput.bench_keys()
    assert 0.0 <= keys["obs_goodput_frac"] <= 1.0
    assert tmetrics.get_registry().gauge("hapi/avg_step_ms").value == \
        summary["avg_step_ms"]


def test_fit_ledger_spans_a_preemption_and_its_resume(tmp_path, monkeypatch):
    """Two rounds through one ledger: round 0 books the emergency save
    of a preemption, round 1 (the launcher's PADDLE_RESTART_ROUND=1)
    books the resume's load as reshard, and the summary books the gap
    between the rounds as restart."""
    from paddle_tpu_torch.distributed.fleet.elastic import (
        Preempted, PreemptionGuard)
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.optimizer import Momentum

    def make():
        net = torch.nn.Linear(4, 2)
        m = Model(net)
        m.prepare(Momentum(0.05, parameters=net.parameters()),
                  torch.nn.MSELoss())
        return m

    x = torch.from_numpy(np.random.RandomState(0).randn(12, 4).astype(
        np.float32))
    data = TensorDataset([x, x[:, :2]])
    m0 = make()
    guard = PreemptionGuard()
    real_step = m0._optimizer.step

    def step():
        real_step()
        if m0._optimizer._step_count == 4:     # step 0 of epoch 1
            guard.request()

    m0._optimizer.step = step
    monkeypatch.setenv("PADDLE_RESTART_ROUND", "0")
    with pytest.raises(Preempted):
        m0.fit(data, batch_size=4, epochs=2, verbose=0,
               save_dir=str(tmp_path), preemptible=guard)
    time.sleep(0.05)
    monkeypatch.setenv("PADDLE_RESTART_ROUND", "1")
    m1 = make()
    try:
        m1.fit(data, batch_size=4, epochs=2, verbose=0,
               save_dir=str(tmp_path), resume=True)
    finally:
        tgoodput.set_current(None)
    doc = json.loads((tmp_path / "goodput.json").read_text())
    assert sorted(doc["rounds"]) == ["0", "1"]
    r0, r1 = doc["rounds"]["0"]["lost"], doc["rounds"]["1"]["lost"]
    assert r0["emergency_save"] > 0.0 and r0["reshard"] == 0.0
    assert r1["reshard"] > 0.0 and r1["emergency_save"] == 0.0
    s = m1._goodput.summary()
    assert s["rounds"] == 2 and 0.0 < s["goodput_frac"] < 1.0
    # the gap between the rounds, from the persisted timestamps
    assert s["lost_restart_s"] >= 0.04

