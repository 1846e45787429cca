"""PyTorch port vs the JAX reference: serving telemetry — the metrics
registry and its exports, lifecycle traces, and the contracts the engine
keeps with them (counts equal `stats`, telemetry off gives the same
streams, metrics() has the reference's key set).

The port's serve/telemetry.py and serve/trace.py are copies of the
reference's host-side modules; the same operations on both must give the
same schema, snapshots, Prometheus text and trace decisions. Engine counts
are exact, and so are the registry counters against the reference engine
serving the same requests.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_trace_sweep import port_trace_sweep  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.archs import get_config as jget_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import telemetry as jtel  # noqa: E402
from repro.serve import trace as jtrace  # noqa: E402
from repro_torch.configs.archs import get_config as tget_config  # noqa: E402
from repro_torch.models.convert import from_reference  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import telemetry as tel  # noqa: E402
from repro_torch.serve import trace as trace_lib  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_lm():
    jcfg = jget_config("llama3.2-3b", smoke=True)
    tcfg = tget_config("llama3.2-3b", smoke=True)
    jp, _ = jlm.init_lm(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, from_reference(jp, tcfg, device="cpu")


def make_requests(mod, n, max_new=4, seed=0, sampled=False):
    rng = np.random.default_rng(seed)
    mix = [(0.0, 0, 1.0), (0.8, 40, 0.9), (1.0, 0, 0.95)]
    return [mod.Request(rid=i,
                        prompt=rng.integers(2, 512,
                                            size=int(rng.integers(3, 12))),
                        max_new_tokens=max_new,
                        sampling=(mod.SamplingParams(*mix[i % 3])
                                  if sampled else mod.SamplingParams()))
            for i in range(n)]


def _port(small_lm, **kw):
    _, _, tcfg, tp = small_lm
    base = dict(slots=2, max_seq=64, page_size=8)
    return teng.ServeEngine(tcfg, tp, teng.EngineConfig(**{**base, **kw}),
                            device="cpu")


# ---------------------------------------------------------------------------
# The registry: the reference's schema and exports
# ---------------------------------------------------------------------------

def test_golden_metric_schema_equals_reference():
    """ServingMetrics declares the reference's 30 families, by exact name,
    kind and labels."""
    r, jr = tel.MetricsRegistry(), jtel.MetricsRegistry()
    tel.ServingMetrics(r)
    jtel.ServingMetrics(jr)
    assert r.schema() == jr.schema()
    assert len(r.schema()) == 30


def _exercise(mod):
    """The same operations on a registry of `mod`; returns the registry."""
    r = mod.MetricsRegistry()
    c = r.counter("req_total", "requests", labels=("kind",))
    c.inc(kind='we"ird\n')
    c.labels(kind="a").inc(2.5)
    assert c.labels(kind="a") is c.labels(kind="a")   # cached handle
    g = r.gauge("depth", "queue depth").labels()
    g.set(7)
    h = r.histogram("lat_seconds", "latency", buckets=(0.1, 1.0)).labels()
    for v in (0.05, 5.0, 0.5, 0.1):
        h.observe(v)
    assert r.counter("req_total", labels=("kind",)) is c
    with pytest.raises(ValueError):
        r.gauge("req_total", labels=("kind",))
    with pytest.raises(ValueError):
        r.counter("bad name")
    with pytest.raises(ValueError):
        r.histogram("h2", buckets=(1.0, 0.5))
    return r


def test_registry_operations_match_reference():
    """Counters, gauges, histograms and their validation: identical
    snapshots, JSON and Prometheus text from both packages; snapshots are
    side-effect free."""
    r, jr = _exercise(tel), _exercise(jtel)
    assert r.snapshot() == jr.snapshot()
    assert r.snapshot() == r.snapshot()
    assert r.to_json() == jr.to_json()
    assert r.to_prometheus_text() == jr.to_prometheus_text()
    lines = r.to_prometheus_text().splitlines()
    assert 'req_total{kind="we\\"ird\\n"} 1.0' in lines
    assert 'lat_seconds_bucket{le="0.1"} 2' in lines
    assert 'lat_seconds_bucket{le="+Inf"} 4' in lines
    assert "lat_seconds_count 4" in lines


@pytest.mark.parametrize("n", [0, 1, 5, 200])
def test_percentiles_and_histogram_quantiles_match_reference(n):
    rng = np.random.default_rng(n)
    vals = list(rng.lognormal(-4, 1.5, size=n))
    qs = (0, 50, 90, 99, 100)
    assert tel.percentiles(vals, qs) == jtel.percentiles(vals, qs)
    if n:
        assert tel.percentiles(vals, qs) == [
            float(np.percentile(np.asarray(vals, np.float64), q))
            for q in qs]
    h = tel.Histogram("x", "", (), tel.DEFAULT_LATENCY_BUCKETS).labels()
    jh = jtel.Histogram("x", "", (), jtel.DEFAULT_LATENCY_BUCKETS).labels()
    for v in vals:
        h.observe(v)
        jh.observe(v)
    assert [h.quantile(q) for q in qs] == [jh.quantile(q) for q in qs]


def test_http_metrics_endpoint():
    """/metrics, /metrics.json and a 404 from the exporter on 127.0.0.1 at
    an ephemeral port; stop() releases it."""
    r = tel.MetricsRegistry()
    r.counter("hits_total").labels().inc(3)
    server = tel.start_metrics_server(r, port=0)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics") as resp:
            assert resp.status == 200
            assert "text/plain" in resp.headers["Content-Type"]
            assert "hits_total 3.0" in resp.read().decode()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics.json") as resp:
            assert json.loads(resp.read())["hits_total"] == 3.0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The trace recorder: the reference's decisions
# ---------------------------------------------------------------------------

def _trace_ops(mod):
    rec = mod.TraceRecorder(capacity=4)
    for rid in range(3):
        rec.record(rid, "submit", prompt_len=4, max_new_tokens=2)
        rec.record(rid, "finish", reason="eos", tokens=2, decode_s=0.1,
                   tpot_s=0.05)
    ring = (len(rec.events()), rec.recorded, rec.dropped, rec.open_rids(),
            rec.validate())
    leak = mod.TraceRecorder()
    leak.record(1, "submit", prompt_len=4, max_new_tokens=2)
    leak.record(1, "admit", slot=0, cached_prefix_tokens=0, suffix_tokens=3,
                blocks_reserved=1)
    leak.record(2, "submit", prompt_len=4, max_new_tokens=2)
    leak.record(2, "admit", slot=0, cached_prefix_tokens=0, suffix_tokens=3,
                blocks_reserved=1)
    reuse = mod.TraceRecorder()
    for _ in range(2):
        reuse.record(7, "submit", prompt_len=4, max_new_tokens=2)
        reuse.record(7, "finish", reason="eos", tokens=1, decode_s=0.0,
                     tpot_s=0.0)
    out = (ring, leak.check_leaks(live_rids=[2]), len(leak.validate()),
           reuse.validate(), reuse.check_leaks(live_rids=[]),
           [mod.validate_event(ev) is None for ev in (
               {"ts": 0.0, "rid": 1, "event": "queued", "queue_depth": 2},
               {"ts": 0.0, "rid": 1, "event": "queued"},
               {"ts": 0.0, "rid": 1, "event": "nope"},
               {"rid": 1, "event": "queued"})])
    mod.drain_recorders()          # these leak on purpose
    return out


def test_trace_recorder_matches_reference():
    """Ring bound and exact span accounting, the slot-recycle leak oracle,
    rid reuse, event schema validation: the same answers as the
    reference's recorder."""
    got, want = _trace_ops(trace_lib), _trace_ops(jtrace)
    assert got == want
    ring, leaks, nerr, reuse_errs, reuse_leaks, valid = got
    assert ring[:3] == (4, 6, 2) and ring[3] == set() and ring[4] == []
    assert any("rid 1" in m for m in leaks) and nerr > 0
    assert reuse_errs == [] and reuse_leaks == []
    assert valid == [True, False, False, False]
    assert trace_lib.EVENT_FIELDS == jtrace.EVENT_FIELDS


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def test_request_lifecycle_trace_jsonl(small_lm, tmp_path):
    """A served request leaves a schema-valid JSONL span covering its whole
    lifecycle, in order, with monotonic timestamps after an epoch header."""
    eng = _port(small_lm, prefix_cache=True)
    done = eng.run(make_requests(teng, 3, sampled=True))
    assert len(done) == 3
    path = tmp_path / "trace.jsonl"
    n = eng.export_trace(path)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == n
    header, events = lines[0], lines[1:]
    assert header["event"] == "epoch" and header["rid"] == -1
    assert abs(header["wall_time_s"] - time.time()) < 300.0
    assert all(header["ts"] >= e["ts"] for e in events)
    for ev in lines:
        assert trace_lib.validate_event(ev) is None
    for rid in range(3):
        kinds = [e["event"] for e in events if e["rid"] == rid]
        assert kinds[0] == "submit" and kinds[1] == "queued"
        assert kinds.index("admit") < kinds.index("activate") \
            < kinds.index("first_token")
        assert "prefill_chunk" in kinds and kinds[-1] == "finish"
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)
    assert eng.trace.open_rids() == set()


RETIRE_KEYS = ("serve_requests_submitted_total",
               "serve_requests_admitted_total", "serve_decode_tokens_total",
               "serve_ticks_total", "serve_prefill_tokens_total",
               "serve_requests_retired_total", "serve_preemptions_total",
               "serve_prefix_cache_hits_total",
               "serve_prefix_cache_misses_total", "serve_kv_pool_blocks_live",
               "serve_kv_pool_blocks_leaked", "serve_kv_pool_blocks_total",
               "serve_kv_pool_blocks_free", "serve_radix_nodes",
               "serve_health", "serve_mesh_devices", "serve_slots_active",
               "serve_queue_depth")


def test_registry_counts_match_stats_and_reference(small_lm):
    """The port's registry counts equal its own `stats` and, request for
    request, the reference engine's registry on the same sampled workload
    (prefix cache on, a shared prefix so hits count); the tick-phase
    histograms observe every tick; metrics() has the reference's keys."""
    jcfg, jp, _, _ = small_lm
    kw = dict(slots=2, max_seq=64, page_size=8, prefill_chunk=8,
              prefix_cache=True, seed=3)

    def reqs(mod):
        out = make_requests(mod, 5, max_new=5, sampled=True)
        for r in out:
            r.prompt = np.concatenate([np.arange(2, 18), r.prompt])
        return out
    je = jeng.ServeEngine(jcfg, jp, jeng.EngineConfig(paged_impl="gather",
                                                      **kw))
    te = _port(small_lm, **kw)
    te.warmup()
    jdone, tdone = je.run(reqs(jeng)), te.run(reqs(teng))
    assert ({r.rid: r.out_tokens for r in tdone}
            == {r.rid: r.out_tokens for r in jdone})
    snap, jsnap = te.registry.snapshot(), je.registry.snapshot()
    assert {k: snap[k] for k in RETIRE_KEYS} == \
        {k: jsnap[k] for k in RETIRE_KEYS}
    assert snap["serve_decode_tokens_total"] == te.stats["decode_tokens"]
    assert snap["serve_ticks_total"] == te.stats["ticks"]
    assert snap["serve_prefill_tokens_total"] == {
        "kind=computed": te.stats["prefill_tokens"],
        "kind=cached": te.stats["cached_prefix_tokens"]}
    assert te.stats["cached_prefix_tokens"] > 0
    assert sum(snap["serve_requests_retired_total"].values()) == 5
    assert set(snap["serve_jit_traces_total"].values()) == {0.0}
    phases = snap["serve_tick_phase_seconds"]
    assert phases["phase=schedule"]["count"] >= te.stats["ticks"]
    assert phases["phase=dispatch"]["count"] == te.stats["ticks"]
    assert phases["phase=device_step"]["count"] >= 1
    for name in ("serve_ttft_seconds", "serve_queue_wait_seconds",
                 "serve_tpot_seconds"):
        assert snap[name]["count"] == jsnap[name]["count"] == 5
    assert snap["serve_kv_pool_blocks_leaked"] == 0
    tm, jm = te.metrics(), je.metrics()
    assert set(tm) - set(jm) == {"chunks", "device"}
    assert set(jm) <= set(tm)
    assert tm["compiles"] == 0 and set(tm["compiles_by_fn"]) == set(
        jm["compiles_by_fn"])
    m1, m2 = te.metrics(), te.metrics()
    assert m1 == m2
    m1["ticks"] = -1
    assert te.metrics()["ticks"] == m2["ticks"]


def test_engine_prometheus_export(small_lm):
    eng = _port(small_lm)
    eng.run(make_requests(teng, 2))
    text = eng.prometheus_text()
    r = tel.MetricsRegistry()
    tel.ServingMetrics(r)
    for name, spec in r.schema().items():
        assert f"# TYPE {name} {spec['kind']}" in text
    assert 'serve_jit_traces_total{fn="decode"} 0.0' in text


@pytest.mark.parametrize("sampled", [False, True])
def test_telemetry_off_noops_and_identical_streams(small_lm, sampled):
    """Telemetry off gives the same streams and stubs out every surface (no
    registry, the null recorder, empty exports)."""
    out = {}
    for on in (True, False):
        eng = _port(small_lm, prefix_cache=True, telemetry=on)
        reqs = make_requests(teng, 5, seed=2, sampled=sampled)
        eng.run(reqs)
        out[on] = {r.rid: tuple(r.out_tokens) for r in reqs}
    assert out[True] == out[False]
    assert eng.registry is None
    assert isinstance(eng.trace, trace_lib.NullTraceRecorder)
    assert eng.prometheus_text() == ""
    assert eng.export_trace("/dev/null") == 0
    assert eng.metrics()["telemetry"] is False
    with pytest.raises(ValueError, match="telemetry"):
        eng.serve_metrics(0)


def test_scheduler_histogram_percentiles(small_lm):
    """The O(1) histogram estimates in scheduler.metrics() lie in the
    buckets of the order statistics that the exact (interpolated)
    percentile lies between: from the lower edge of the one below to the
    upper edge of the one above."""
    eng = _port(small_lm)
    eng.run(make_requests(teng, 6, seed=5))
    m = eng.scheduler.metrics()
    ttft = sorted(rs.ttft for rs in eng.scheduler.finished)
    edges = (0.0,) + tel.DEFAULT_LATENCY_BUCKETS
    for q, est in ((50, m["p50_ttft_s"]), (90, m["p90_ttft_s"]),
                   (99, m["p99_ttft_s"])):
        pos = q / 100 * (len(ttft) - 1)
        below, above = ttft[int(np.floor(pos))], ttft[int(np.ceil(pos))]
        lo = max(e for e in edges if e <= below)
        hi = min(e for e in edges if e >= above)
        assert lo <= est <= hi, (q, est, ttft)
    assert m["p50_tpot_s"] is not None and m["p50_queue_wait_s"] is not None


def test_engine_http_endpoint_and_mesh_gauge(small_lm):
    """The engine-owned endpoint on 127.0.0.1 port 0 serves /metrics and
    /healthz; close() stops it; the unsharded mesh gauge reads 1 x 1."""
    eng = _port(small_lm)
    assert eng.registry.snapshot()["serve_mesh_devices"] == {
        "axis=data": 1.0, "axis=model": 1.0}
    server = eng.serve_metrics(0)
    assert eng.serve_metrics(0) is server
    port = server.server_address[1]
    eng.run(make_requests(teng, 2))
    body = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/metrics").read().decode()
    assert "serve_decode_tokens_total" in body
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as resp:
        assert json.load(resp) == {"status": "healthy"}
    eng.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


def test_sampling_params_default_greedy():
    assert SamplingParams().greedy and not SamplingParams(0.5).greedy
