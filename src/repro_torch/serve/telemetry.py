"""Serving metrics registry: counters, gauges, fixed-bucket histograms, and
the export surfaces (Prometheus text format, JSON snapshot) every component
of the serving datapath publishes into.

Design constraints (the whole point of this module):

* **Host-side only.** Nothing here imports torch or touches a tensor —
  publishing a metric can never launch a kernel or force a device sync. The
  engine measures tick phases exclusively at the one host copy its drain
  already makes, and this module is just the ledger those measurements
  land in.
* **Cheap hot path.** A labeled metric resolves to a child handle once
  (`Counter.labels(...)`), and the per-tick cost is a float add on that
  handle. Snapshots (`collect`, `to_prometheus_text`, `snapshot`) walk the
  registry on demand; nothing is recomputed per publish.
* **Bounded memory.** Histograms are fixed-bucket (counts + sum, never the
  raw samples), so a long-lived engine's metrics cost is O(metrics), not
  O(requests served).
* **Stable schema.** Exported names/types/labels are a contract —
  tests/test_torch_telemetry.py pins them (the golden-schema test) so a renamed
  counter fails CI instead of silently breaking the regression gates and
  dashboards that read them. Add metrics freely; rename or retype only with
  the golden schema updated in the same change.

The shared quantile helpers live here too: `percentiles` is the one exact
implementation (serve/scheduler, benchmarks/serving_bench and the engine's
reporting all call it instead of hand-rolling np.percentile), and
`Histogram.quantile` is the bounded-memory estimate the live `metrics()`
snapshot uses.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "ServingMetrics",
    "percentiles", "DEFAULT_LATENCY_BUCKETS", "DEFAULT_TICK_BUCKETS",
    "TICK_PHASES", "start_metrics_server",
]


# ---------------------------------------------------------------------------
# Shared quantile helpers
# ---------------------------------------------------------------------------

def percentiles(values: Sequence[float],
                qs: Sequence[float]) -> List[Optional[float]]:
    """Exact percentiles of `values` at the given 0-100 `qs`.

    The one shared implementation behind every p50/p90/p99 the serving stack
    reports (scheduler metrics, benchmark reports) — bit-identical to
    ``np.percentile`` with linear interpolation, which is what each caller
    hand-rolled before. Returns ``[None, ...]`` for an empty sample instead
    of raising, because every call site wants that."""
    vals = [float(v) for v in values]
    if not vals:
        return [None for _ in qs]
    arr = np.asarray(vals, np.float64)
    return [float(np.percentile(arr, q)) for q in qs]


# Latency buckets (seconds): 1ms .. ~131s, powers of two. TTFT/TPOT/queue
# wait on every backend from host-CPU smoke to card serving land in-range.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    0.001 * 2 ** i for i in range(18))
# Tick-phase buckets (seconds): 10us .. ~1.3s. Host scheduling phases are
# microseconds; the device-step phase is the per-drain compute wait.
DEFAULT_TICK_BUCKETS: Tuple[float, ...] = tuple(
    1e-5 * 2 ** i for i in range(18))


# ---------------------------------------------------------------------------
# Metric primitives
# ---------------------------------------------------------------------------

def _validate_name(name: str) -> None:
    if not name or not all(c.isalnum() or c == "_" for c in name):
        raise ValueError(f"invalid metric name {name!r} "
                         "(use [a-zA-Z0-9_], prometheus-safe)")


class _Child:
    """One labeled series of a metric: the pre-resolved hot-path handle."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        self.value = float(value)


class _HistChild:
    """One labeled histogram series: fixed bucket counts + sum + count."""
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Tuple[float, ...]):
        self.edges = edges                    # upper bounds, ascending
        self.counts = [0] * (len(edges) + 1)  # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        # linear scan: len(edges) is ~18 and observes are per-request /
        # per-drain, never per-token — simplicity beats bisect here
        for i, edge in enumerate(self.edges):
            if v <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate (q in [0, 100]).

        Error is bounded by the bucket width around the true quantile; with
        the default power-of-two ladders that is a <=2x band — the right
        tradeoff for a live snapshot that must not retain raw samples.
        Values above the last edge clamp to it."""
        if self.count == 0:
            return None
        rank = (q / 100.0) * self.count
        seen = 0
        lo = 0.0
        for i, edge in enumerate(self.edges):
            c = self.counts[i]
            if seen + c >= rank and c > 0:
                frac = (rank - seen) / c
                return lo + (edge - lo) * min(max(frac, 0.0), 1.0)
            seen += c
            lo = edge
        return self.edges[-1]


class _Metric:
    """Base: a named family of labeled children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...]):
        _validate_name(name)
        for ln in label_names:
            _validate_name(ln)
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **labels: str):
        """Resolve (and cache) the child for one label assignment. Call once
        at setup; keep the handle for the hot path."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(labels[ln]) for ln in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._make_child()
        return child

    def series(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        return self._children.items()


class Counter(_Metric):
    """Monotonically increasing count (``*_total`` by convention)."""

    kind = "counter"

    def _make_child(self) -> _Child:
        return _Child()

    def inc(self, amount: float = 1.0, **labels) -> None:
        self.labels(**labels).inc(amount)


class Gauge(_Metric):
    """Point-in-time value (occupancy, queue depth, ...)."""

    kind = "gauge"

    def _make_child(self) -> _Child:
        return _Child()

    def set(self, value: float, **labels) -> None:
        self.labels(**labels).set(value)


class Histogram(_Metric):
    """Fixed-bucket histogram: bounded memory, Prometheus-native export,
    interpolated quantiles for live snapshots."""

    kind = "histogram"

    def __init__(self, name: str, help: str, label_names: Tuple[str, ...],
                 buckets: Sequence[float]):
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"{name}: buckets must be ascending and unique, "
                             f"got {buckets}")
        self.buckets = edges
        super().__init__(name, help, label_names)

    def _make_child(self) -> _HistChild:
        return _HistChild(self.buckets)

    def observe(self, value: float, **labels) -> None:
        self.labels(**labels).observe(value)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Holds every metric family a serving process exports.

    One registry per engine (tests may build many engines in one process, so
    a process-global default would cross-contaminate); the launcher hands the
    engine's registry to the HTTP exporter. Thread-safe for the exporter's
    read path: snapshots copy under the same lock that guards registration
    (publishing itself is a GIL-atomic float add on a child handle).
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            prev = self._metrics.get(metric.name)
            if prev is not None:
                if (type(prev) is not type(metric)
                        or prev.label_names != metric.label_names
                        or getattr(prev, "buckets", None)
                        != getattr(metric, "buckets", None)):
                    raise ValueError(
                        f"metric {metric.name!r} re-registered with a "
                        "different type/labels/buckets")
                return prev
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, tuple(labels)))

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, tuple(labels)))

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram(name, help, tuple(labels), buckets))

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def schema(self) -> Dict[str, Dict[str, object]]:
        """{name: {kind, labels}} — what the golden-schema test pins."""
        with self._lock:
            return {m.name: {"kind": m.kind,
                             "labels": tuple(m.label_names)}
                    for m in self._metrics.values()}

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict snapshot of every series (JSON-serializable). Repeated
        calls are side-effect-free: values are copied out, nothing is reset
        or recomputed."""
        out: Dict[str, object] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = {}
            for key, child in m.series():
                label = ",".join(f"{ln}={lv}" for ln, lv
                                 in zip(m.label_names, key))
                if isinstance(child, _HistChild):
                    series[label] = {"count": child.count, "sum": child.sum,
                                     "buckets": list(child.counts)}
                else:
                    series[label] = child.value
            if m.label_names:
                out[m.name] = series
            else:
                empty = ({"count": 0, "sum": 0.0, "buckets": []}
                         if m.kind == "histogram" else 0.0)
                out[m.name] = series.get("", empty)
        return out

    # --- Prometheus text exposition format -----------------------------

    @staticmethod
    def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                    extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [(n, v) for n, v in zip(names, values)] + list(extra)
        if not pairs:
            return ""
        def esc(v: str) -> str:
            return v.replace("\\", r"\\").replace('"', r'\"').replace(
                "\n", r"\n")
        return "{" + ",".join(f'{n}="{esc(v)}"' for n, v in pairs) + "}"

    @staticmethod
    def _fmt_value(v: float) -> str:
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(float(v))

    def to_prometheus_text(self) -> str:
        """Render the registry in the Prometheus text exposition format
        (version 0.0.4: HELP/TYPE headers, histogram ``_bucket``/``_sum``/
        ``_count`` series with cumulative ``le`` buckets)."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in sorted(metrics, key=lambda m: m.name):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, child in sorted(m.series()):
                if isinstance(child, _HistChild):
                    cum = 0
                    for edge, c in zip(child.edges, child.counts):
                        cum += c
                        lab = self._fmt_labels(
                            m.label_names, key,
                            (("le", self._fmt_value(edge)),))
                        lines.append(f"{m.name}_bucket{lab} {cum}")
                    cum += child.counts[-1]
                    lab = self._fmt_labels(m.label_names, key,
                                           (("le", "+Inf"),))
                    lines.append(f"{m.name}_bucket{lab} {cum}")
                    plain = self._fmt_labels(m.label_names, key)
                    lines.append(f"{m.name}_sum{plain} "
                                 f"{self._fmt_value(child.sum)}")
                    lines.append(f"{m.name}_count{plain} {child.count}")
                else:
                    lab = self._fmt_labels(m.label_names, key)
                    lines.append(f"{m.name}{lab} "
                                 f"{self._fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


# ---------------------------------------------------------------------------
# The serving metric catalog
# ---------------------------------------------------------------------------

TICK_PHASES = ("schedule", "dispatch", "device_step", "drain")


class ServingMetrics:
    """Every metric family the serving datapath exports, declared in one
    place (the golden-schema test pins exactly this set), with hot-path child handles pre-resolved so
    publishing from the tick loop is a float add.

    Semantics under a mesh: the engine is SPMD — every device runs the same
    ticks on the same schedule — so all series here are *engine-level
    aggregates*, not per-device values (a per-device decode-token counter
    would just be this one divided by nothing; KV-pool gauges count logical
    blocks, whose storage is sharded over the `model` axis). The
    ``serve_mesh_devices`` gauge records the topology so dashboards can
    derive per-device rates if they want them.
    """

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        r = registry
        # counters
        self.requests_submitted = r.counter(
            "serve_requests_submitted_total",
            "Requests accepted by submit()").labels()
        self.requests_admitted = r.counter(
            "serve_requests_admitted_total",
            "Requests admitted into a decode slot").labels()
        self._retired = r.counter(
            "serve_requests_retired_total",
            "Requests retired, by finish reason", labels=("reason",))
        self.retired_eos = self._retired.labels(reason="eos")
        self.retired_max_tokens = self._retired.labels(reason="max_tokens")
        self.retired_cancelled = self._retired.labels(reason="cancelled")
        self.retired_deadline = self._retired.labels(reason="deadline")
        self.retired_numeric = self._retired.labels(reason="numeric_error")
        self.retired_internal = self._retired.labels(reason="internal_error")
        self.retired_resource = self._retired.labels(
            reason="resource_exhausted")
        self.retired_sink = self._retired.labels(reason="sink_error")
        # one dispatch table for every retire site (scheduler + engine):
        # an unknown reason KeyErrors loudly instead of silently miscounting
        self.retired_by_reason = {
            "eos": self.retired_eos,
            "max_tokens": self.retired_max_tokens,
            "cancelled": self.retired_cancelled,
            "deadline": self.retired_deadline,
            "numeric_error": self.retired_numeric,
            "internal_error": self.retired_internal,
            "resource_exhausted": self.retired_resource,
            "sink_error": self.retired_sink,
        }
        self.preemptions = r.counter(
            "serve_preemptions_total",
            "Decode slots preempted under KV-pool pressure (the victim is "
            "requeued and recomputed bit-exactly; not a retirement)").labels()
        self.decode_tokens = r.counter(
            "serve_decode_tokens_total",
            "Tokens sampled by the decode loop (delivered at drain)").labels()
        self._prefill_tokens = r.counter(
            "serve_prefill_tokens_total",
            "Prompt context tokens, computed vs served from the prefix "
            "cache", labels=("kind",))
        self.prefill_computed = self._prefill_tokens.labels(kind="computed")
        self.prefill_cached = self._prefill_tokens.labels(kind="cached")
        self.ticks = r.counter(
            "serve_ticks_total", "Decode ticks stepped").labels()
        self.jit_traces = r.counter(
            "serve_jit_traces_total",
            "jit traces (compilations) per engine function — must not grow "
            "after warmup", labels=("fn",))
        self.prefix_hits = r.counter(
            "serve_prefix_cache_hits_total",
            "Radix prefix-cache admission hits").labels()
        self.prefix_misses = r.counter(
            "serve_prefix_cache_misses_total",
            "Radix prefix-cache admission misses").labels()
        self.prefix_evictions = r.counter(
            "serve_prefix_cache_evictions_total",
            "Radix prefix-cache blocks evicted under pool pressure").labels()
        self.audit_runs = r.counter(
            "serve_audit_runs_total",
            "Invariant audits executed (on-demand audit() calls plus the "
            "automatic every-audit_interval-ticks runs)").labels()
        self.snapshots = r.counter(
            "serve_snapshots_total",
            "Engine snapshots written (ServeEngine.snapshot)").labels()
        self.restored_requests = r.counter(
            "serve_restored_requests_total",
            "Requests re-admitted from a journal/snapshot/handoff (resumed "
            "bit-exactly via the preemption fold mechanism)").labels()
        self.handoffs = r.counter(
            "serve_handoffs_total",
            "Live handoffs completed (in-flight requests transferred to "
            "another engine; this engine ends DRAINING)").labels()
        self._faults_injected = r.counter(
            "serve_faults_injected_total",
            "Faults fired by an attached FaultPlan, by injection site "
            "(always 0 in production: the plan is test/bench-only)",
            labels=("site",))
        self.faults_injected = self._faults_injected.labels  # site= handle
        # gauges
        self.slots_active = r.gauge(
            "serve_slots_active", "Slots generating or mid-prefill").labels()
        self.queue_depth = r.gauge(
            "serve_queue_depth", "Requests waiting for admission").labels()
        self.pool_blocks_total = r.gauge(
            "serve_kv_pool_blocks_total",
            "KV pool capacity in blocks (incl. the null block)").labels()
        self.pool_blocks_free = r.gauge(
            "serve_kv_pool_blocks_free", "Unallocated KV pool blocks").labels()
        self.pool_blocks_live = r.gauge(
            "serve_kv_pool_blocks_live",
            "Allocated KV pool blocks (any refcount)").labels()
        self.pool_blocks_shared = r.gauge(
            "serve_kv_pool_blocks_shared",
            "Live blocks with refcount > 1 (prefix sharing)").labels()
        self.pool_blocks_leaked = r.gauge(
            "serve_kv_pool_blocks_leaked",
            "Live blocks reachable from no slot and no radix node — "
            "a refcount leak if ever nonzero").labels()
        self.radix_nodes = r.gauge(
            "serve_radix_nodes", "Radix prefix-cache nodes resident").labels()
        self.mesh_devices = r.gauge(
            "serve_mesh_devices",
            "Mesh axis sizes (1 when serving unsharded)", labels=("axis",))
        self.health = r.gauge(
            "serve_health",
            "Engine health state: 0=healthy, 1=degraded, 2=draining, "
            "3=handoff (docs/serving.md, Failure handling)").labels()
        # histograms
        self.ttft = r.histogram(
            "serve_ttft_seconds", "Submit -> first token",
            buckets=DEFAULT_LATENCY_BUCKETS).labels()
        self.tpot = r.histogram(
            "serve_tpot_seconds",
            "Per-request mean time per output token after the first",
            buckets=DEFAULT_LATENCY_BUCKETS).labels()
        self.queue_wait = r.histogram(
            "serve_queue_wait_seconds", "Submit -> admission",
            buckets=DEFAULT_LATENCY_BUCKETS).labels()
        self._tick_phase = r.histogram(
            "serve_tick_phase_seconds",
            "Host wall time per tick phase, measured only at host-sync "
            "boundaries that already exist", labels=("phase",),
            buckets=DEFAULT_TICK_BUCKETS)
        self.phase_schedule = self._tick_phase.labels(phase="schedule")
        self.phase_dispatch = self._tick_phase.labels(phase="dispatch")
        self.phase_device_step = self._tick_phase.labels(phase="device_step")
        self.phase_drain = self._tick_phase.labels(phase="drain")


# ---------------------------------------------------------------------------
# HTTP exporter
# ---------------------------------------------------------------------------

def start_metrics_server(registry: MetricsRegistry, port: int,
                         host: str = "127.0.0.1",
                         health_cb=None):
    """Serve ``/metrics`` (Prometheus text), ``/metrics.json``, and — when
    `health_cb` is given — ``/healthz`` for `registry` on a daemon thread.
    `health_cb` returns the engine health string ("healthy"/"degraded"/
    "draining"); ``/healthz`` answers 200 with a JSON body when healthy and
    503 otherwise, so a load balancer can stop routing to a degraded or
    draining engine while ``/metrics`` keeps working for the post-mortem.
    Returns the live ``HTTPServer`` — its actual port is
    ``server.server_address[1]`` (pass port=0 for an ephemeral port in
    tests). Call ``server.stop()`` to stop it: that ends ``serve_forever``
    *and* closes the listening socket (``shutdown()`` alone leaves the
    socket open until process exit — the leak long-lived embedders must not
    inherit; ``ServeEngine.close()`` and the launcher go through
    ``stop()``)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):          # noqa: N802 (http.server API)
            status = 200
            if self.path.split("?")[0] == "/metrics":
                body = registry.to_prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path.split("?")[0] == "/metrics.json":
                body = registry.to_json().encode()
                ctype = "application/json"
            elif (self.path.split("?")[0] == "/healthz"
                  and health_cb is not None):
                state = str(health_cb())
                body = json.dumps({"status": state}).encode()
                ctype = "application/json"
                status = 200 if state == "healthy" else 503
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # keep scrapes out of stderr
            pass

    server = HTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="metrics-exporter", daemon=True)
    thread.start()

    def stop() -> None:
        server.shutdown()        # stop serve_forever (joins the poll loop)
        server.server_close()    # release the listening socket now
        thread.join(timeout=5.0)

    server.stop = stop           # idempotent enough: second call is a no-op
    # socket close on an already-closed server
    return server
