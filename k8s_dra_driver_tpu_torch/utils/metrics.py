"""Prometheus-format metrics + debug HTTP endpoint.

Role of the reference's controller observability (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-controller/main.go:194-241: prometheus handler + pprof mux) —
extended to the node plugin too, which in the reference exposes no metrics
at all (SURVEY.md §5 gap). stdlib-only: a tiny registry rendering the
Prometheus text exposition format, served by http.server.

Conventions enforced here (and by ``tools/lint.py`` / ``make
verify-metrics``): metric names must match the exposition-format name
grammar, first-party metrics carry the ``tpu_dra_`` prefix and a unit
suffix, label values are escaped per the text-format spec, and non-finite
values render as ``+Inf``/``-Inf``/``NaN`` (``repr(inf)`` is not parseable
by Prometheus). Renamed metrics keep their old name rendering for one
release via ``Registry.alias`` with a ``(deprecated)`` HELP marker.
"""

from __future__ import annotations

import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

# Prometheus text-exposition grammars (data model spec): metric names admit
# colons (recording rules); label names do not.
_METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")


def _validate_metric_name(name: str) -> str:
    if not _METRIC_NAME_RE.match(name):
        raise ValueError(
            f"invalid metric name {name!r}: must match "
            "[a-zA-Z_:][a-zA-Z0-9_:]*"
        )
    return name


def _validate_label_names(labels: dict) -> None:
    for k in labels:
        if not _LABEL_NAME_RE.match(k):
            raise ValueError(
                f"invalid label name {k!r}: must match "
                "[a-zA-Z_][a-zA-Z0-9_]*"
            )


class Counter:
    def __init__(self, name: str, help_: str, registry: "Registry"):
        self.name = _validate_metric_name(name)
        self.help = help_
        self.type = "counter"
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        registry._register(self)

    def inc(self, amount: float = 1.0, **labels) -> None:
        _validate_label_names(labels)
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> list[str]:
        return self.render_as(self.name, self.help)

    def render_as(self, name: str, help_: str) -> list[str]:
        out = [f"# HELP {name} {help_}", f"# TYPE {name} counter"]
        with self._lock:
            for key, val in sorted(self._values.items()):
                out.append(f"{name}{_labels(key)} {_num(val)}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str, registry: "Registry"):
        self.name = _validate_metric_name(name)
        self.help = help_
        self.type = "gauge"
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        registry._register(self)

    def set(self, value: float, **labels) -> None:
        _validate_label_names(labels)
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def remove(self, **labels) -> None:
        """Drop one labeled series entirely. For label sets scoped to a
        finite-lifetime object (a claim UID): zeroing such a series
        keeps it in every future scrape forever — unbounded cardinality
        over churn — while removal is the standard end-of-life."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values.pop(key, None)

    def value(self, **labels) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def render(self) -> list[str]:
        return self.render_as(self.name, self.help)

    def render_as(self, name: str, help_: str) -> list[str]:
        out = [f"# HELP {name} {help_}", f"# TYPE {name} gauge"]
        with self._lock:
            for key, val in sorted(self._values.items()):
                out.append(f"{name}{_labels(key)} {_num(val)}")
        return out


class Histogram:
    """Fixed-bucket histogram (claim-prepare latencies etc.). Optionally
    labeled: ``observe(v, phase="admit")`` keeps an independent bucket
    series per label set, rendered with ``le`` appended last — how the
    serving tick profiler keeps one ``tpu_dra_srv_tick_phase_seconds``
    family across its ``{component, phase}`` enum instead of a family
    per phase. Label-less use renders exactly as before (including the
    zeroed series when nothing was observed yet)."""

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

    def __init__(self, name: str, help_: str, registry: "Registry",
                 buckets=DEFAULT_BUCKETS):
        self.name = _validate_metric_name(name)
        self.help = help_
        self.type = "histogram"
        self.buckets = tuple(sorted(buckets))
        # key -> [per-bucket counts (+overflow), sum, n]
        self._series: dict[tuple, list] = {}
        self._lock = threading.Lock()
        registry._register(self)

    def _cell(self, labels: dict) -> list:
        """Caller must hold the lock."""
        _validate_label_names(labels)
        if "le" in labels:
            raise ValueError(
                "label name 'le' is reserved for histogram buckets"
            )
        key = tuple(sorted(labels.items()))
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = [
                [0] * (len(self.buckets) + 1), 0.0, 0
            ]
        return cell

    def observe(self, value: float, **labels) -> None:
        with self._lock:
            cell = self._cell(labels)
            cell[1] += value
            cell[2] += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    cell[0][i] += 1
                    return
            cell[0][-1] += 1

    def zero(self, **labels) -> None:
        """Materialize an all-zero series for a label set — the explicit-
        zeros convention for labeled histograms (an unscraped enum cell
        must read 0, not be absent)."""
        with self._lock:
            self._cell(labels)

    def time(self):
        """Context manager: observe elapsed seconds (label-less)."""
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.monotonic()
                return self

            def __exit__(self, *exc):
                hist.observe(time.monotonic() - self.t0)

        return _Timer()

    def summary(self, **labels) -> tuple[int, float]:
        """(count, sum) — the scalar view snapshot/doctor reports use.
        With labels: that series only; without: aggregated over all."""
        with self._lock:
            if labels:
                key = tuple(sorted(labels.items()))
                cell = self._series.get(key)
                return (cell[2], cell[1]) if cell else (0, 0.0)
            n = sum(c[2] for c in self._series.values())
            total = sum(c[1] for c in self._series.values())
            return n, total

    def render(self) -> list[str]:
        return self.render_as(self.name, self.help)

    def render_as(self, name: str, help_: str) -> list[str]:
        out = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
        with self._lock:
            series = self._series or {
                (): [[0] * (len(self.buckets) + 1), 0.0, 0]
            }
            for key, (counts, total, n) in sorted(series.items()):
                cum = 0
                for i, b in enumerate(self.buckets):
                    cum += counts[i]
                    out.append(
                        f"{name}_bucket{_bucket_labels(key, _num(b))} {cum}"
                    )
                cum += counts[-1]
                out.append(
                    f'{name}_bucket{_bucket_labels(key, "+Inf")} {cum}'
                )
                out.append(f"{name}_sum{_labels(key)} {_num(total)}")
                out.append(f"{name}_count{_labels(key)} {n}")
        return out


def _escape_label_value(v) -> str:
    """Text-format label-value escaping: backslash, double-quote and
    newline must be escaped or the scrape line is unparseable."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


def _bucket_labels(key: tuple, le: str) -> str:
    """Histogram bucket label block: the series labels with ``le``
    appended last (``le`` is reserved by the text format, never a
    user label — _validate_label_names accepts it, so the histogram
    label path must not be handed an ``le`` of its own)."""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in key
    )
    return "{" + (inner + "," if inner else "") + f'le="{le}"' + "}"


def _num(v: float) -> str:
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    return str(int(f)) if f.is_integer() else repr(f)


class _DeprecatedAlias:
    """Renders a metric once more under its pre-rename name, HELP-marked
    deprecated, so dashboards survive one release of the rename
    (docs/migration.md records the mapping)."""

    def __init__(self, old_name: str, metric):
        self.name = _validate_metric_name(old_name)
        self.metric = metric

    def render(self) -> list[str]:
        return self.metric.render_as(
            self.name,
            f"{self.metric.help} (deprecated; renamed to {self.metric.name})",
        )


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._names: set[str] = set()
        self._lock = threading.Lock()
        self._render_hooks: list[Callable] = []

    def _register(self, metric) -> None:
        with self._lock:
            if metric.name in self._names:
                raise ValueError(f"duplicate metric name {metric.name!r}")
            self._names.add(metric.name)
            self._metrics.append(metric)

    def alias(self, old_name: str, metric) -> None:
        """Keep ``old_name`` rendering (deprecated) for a renamed metric."""
        self._register(_DeprecatedAlias(old_name, metric))

    def add_render_hook(self, hook: Callable) -> None:
        """Run ``hook()`` before every render. The seam for metrics that
        integrate over time (usage allocated-seconds): values must be
        brought current at the scrape instant, not at the last event.
        Hooks run OUTSIDE the registry lock (they set gauges/counters,
        which register nothing) and a raising hook is swallowed — a
        broken integrator must not take /metrics down with it."""
        with self._lock:
            self._render_hooks.append(hook)

    def render(self) -> str:
        with self._lock:
            hooks = list(self._render_hooks)
        for hook in hooks:
            try:
                hook()
            except Exception:
                logging.getLogger(__name__).exception("render hook failed")
        lines: list[str] = []
        with self._lock:
            for m in self._metrics:
                lines.extend(m.render())
        return "\n".join(lines) + "\n"


def _dump_stacks() -> str:
    """All thread stacks (pprof goroutine-profile analog)."""
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {ident} ({names.get(ident, '?')}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def _sample_profile(seconds: float, hz: float = 100.0) -> str:
    """Statistical CPU profile: sample every thread's stack for `seconds`,
    report the hottest aggregated stacks (pprof CPU-profile analog —
    cProfile only sees its own thread, so sampling is the stdlib way to
    profile a multithreaded server in place)."""
    import sys
    import traceback
    from collections import Counter as _Counter

    period = 1.0 / hz
    counts: _Counter = _Counter()
    deadline = time.monotonic() + min(seconds, 60.0)
    n = 0
    me = threading.get_ident()
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            stack = tuple(
                f"{fs.filename.rsplit('/', 1)[-1]}:{fs.lineno}:{fs.name}"
                for fs in traceback.extract_stack(frame)[-8:]
            )
            counts[stack] += 1
        n += 1
        time.sleep(period)
    out = [f"# {n} samples at {hz:g} Hz over {seconds:g}s", ""]
    for stack, c in counts.most_common(30):
        out.append(f"{c} samples ({100.0 * c / max(n, 1):.1f}%):")
        out.extend(f"    {line}" for line in stack)
        out.append("")
    return "\n".join(out) + "\n"


class MetricsServer:
    """/metrics + /healthz + /readyz + /version + /debug/{stacks,profile,
    traces} on a background HTTP server (SetupHTTPEndpoint analog,
    main.go:194-241, incl. the pprof mux at main.go:216-224).

    ``/healthz`` is liveness: the process flag flipped by ``set_healthy``.
    ``/readyz`` is readiness: every CRITICAL check registered with
    ``add_readiness_check`` must pass (the DaemonSet/Deployment
    readinessProbe target — a plugin whose gRPC socket is down or whose
    checkpoint dir is read-only must stop advertising ready, not die).
    Checks registered with ``critical=False`` distinguish DEGRADED from
    dead: when only those fail, /readyz stays 200 but its body ends in
    ``degraded`` and the failing checks are marked ``[~]`` — an apiserver
    outage must not make kubelet abandon a plugin that is still serving
    prepares from checkpointed state.
    ``/debug/traces`` streams the tracer's finished claim traces as JSONL.
    ``/debug/usage`` serves the utilization accountant's JSON snapshot
    when a provider was registered with ``set_usage_provider`` (404
    otherwise). ``/debug/allocations`` streams the allocator's solve
    decisions (candidate funnels, terminal reasons) as JSONL when a
    provider was registered with ``set_allocations_provider`` (404
    otherwise). ``/debug/defrag`` serves the defrag planner's JSON plan
    buffer when a provider was registered with ``set_defrag_provider``
    (404 otherwise). ``/debug/rebalance`` serves the dynamic-sharing
    rebalancer's decision ring + per-claim share view when a provider
    was registered with ``set_rebalance_provider`` (404 otherwise).
    ``/debug/gateway`` serves the fleet serving gateway's snapshot
    (replicas, queues, event ring) when a provider was registered with
    ``set_gateway_provider`` (404 otherwise).
    ``/debug/compute`` serves the compute telemetry's snapshot (compile
    ledger, per-program rooflines, HBM decomposition, collective
    accounting) when a provider was registered with
    ``set_compute_provider`` (404 otherwise).
    ``/debug/requests`` streams the serving telemetry's sealed request
    timelines as JSONL when a provider was registered with
    ``set_requests_provider`` (404 otherwise); ``?view=ticks`` /
    ``exemplars`` / ``slo`` select the tick-profile, violation-exemplar,
    and fleet-SLO-summary views, and an unknown view is a 400.
    All routes are GET-only; other methods get ``405``
    with an ``Allow: GET`` header — the scrape surface mutates nothing.
    """

    def __init__(self, registry: Registry, host: str = "0.0.0.0",
                 port: int = 0, tracer=None):
        self.registry = registry
        self.tracer = tracer
        self.usage_provider: Optional[Callable] = None
        self.allocations_provider: Optional[Callable] = None
        self.defrag_provider: Optional[Callable] = None
        self.rebalance_provider: Optional[Callable] = None
        self.gateway_provider: Optional[Callable] = None
        self.requests_provider: Optional[Callable] = None
        self.kv_provider: Optional[Callable] = None
        self.residency_provider: Optional[Callable] = None
        self.compute_provider: Optional[Callable] = None
        # The JSON debug surfaces share one handler block: path ->
        # (provider attribute, not-enabled message). /debug/allocations
        # stays separate (the provider returns pre-rendered JSONL).
        self._json_debug_routes = {
            "/debug/usage": (
                "usage_provider", "usage accounting not enabled"),
            "/debug/defrag": (
                "defrag_provider", "defrag planning not enabled"),
            "/debug/rebalance": (
                "rebalance_provider",
                "dynamic-sharing rebalancer not enabled"),
            "/debug/gateway": (
                "gateway_provider", "serving gateway not enabled"),
            "/debug/kv": (
                "kv_provider", "kv telemetry not enabled"),
            "/debug/residency": (
                "residency_provider", "residency index not enabled"),
            "/debug/compute": (
                "compute_provider", "compute telemetry not enabled"),
        }
        registry_ref = registry
        health = self._health = {"ok": True}
        self._ready_checks: dict[str, Callable] = {}
        self._ready_lock = threading.Lock()
        server_ref = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                status, ctype, body = self._resolve()
                self._reply(status, ctype, body, include_body=True)

            def do_HEAD(self):
                # Same status line + headers as the GET would produce,
                # no body (RFC 9110) — HEAD-probing health checkers keep
                # working.
                status, ctype, body = self._resolve(head=True)
                self._reply(status, ctype, body, include_body=False)

            def _resolve(self, head=False):
                status = 200
                if self.path == "/metrics":
                    body = registry_ref.render().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path in server_ref._json_debug_routes:
                    attr, missing = server_ref._json_debug_routes[
                        self.path
                    ]
                    provider = getattr(server_ref, attr)
                    if provider is None:
                        body = (missing + "\n").encode()
                        status = 404
                        ctype = "text/plain"
                    else:
                        import json as _json

                        try:
                            body = (
                                _json.dumps(provider(), sort_keys=True)
                                + "\n"
                            ).encode()
                            ctype = "application/json"
                        except Exception as e:
                            what = self.path.rsplit("/", 1)[-1]
                            body = (
                                f"{what} snapshot failed: {e}\n"
                            ).encode()
                            status = 500
                            ctype = "text/plain"
                elif self.path == "/debug/allocations":
                    provider = server_ref.allocations_provider
                    if provider is None:
                        body = b"allocation explainability not enabled\n"
                        status = 404
                        ctype = "text/plain"
                    else:
                        try:
                            body = provider().encode()
                            ctype = "application/x-ndjson"
                        except Exception as e:
                            body = (
                                f"allocations snapshot failed: {e}\n"
                            ).encode()
                            status = 500
                            ctype = "text/plain"
                elif self.path == "/healthz":
                    body = (b"ok" if health["ok"] else b"unhealthy")
                    status = 200 if health["ok"] else 503
                    ctype = "text/plain"
                elif self.path == "/readyz":
                    body, status = server_ref._render_readiness()
                    ctype = "text/plain"
                elif self.path == "/version":
                    from ..version import version_string

                    body = (version_string() + "\n").encode()
                    ctype = "text/plain"
                elif self.path == "/debug/traces":
                    if server_ref.tracer is None:
                        body = b"tracing not enabled\n"
                        status = 404
                        ctype = "text/plain"
                    else:
                        body = server_ref.tracer.export_jsonl().encode()
                        ctype = "application/x-ndjson"
                elif self.path.split("?", 1)[0] == "/debug/requests":
                    provider = server_ref.requests_provider
                    if provider is None:
                        body = b"request tracing not enabled\n"
                        status = 404
                        ctype = "text/plain"
                    else:
                        from urllib.parse import parse_qs, urlparse

                        q = parse_qs(urlparse(self.path).query)
                        view = q.get("view", [""])[0]
                        try:
                            body = provider(view).encode()
                            ctype = "application/x-ndjson"
                        except ValueError as e:
                            body = (str(e) + "\n").encode()
                            status = 400
                            ctype = "text/plain"
                        except Exception as e:
                            body = (
                                f"requests snapshot failed: {e}\n"
                            ).encode()
                            status = 500
                            ctype = "text/plain"
                elif self.path == "/debug/stacks":
                    body = _dump_stacks().encode()
                    ctype = "text/plain"
                elif self.path.startswith("/debug/profile"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        secs = float(q.get("seconds", ["2"])[0])
                    except ValueError:
                        body = b"bad seconds parameter\n"
                        status = 400
                        ctype = "text/plain"
                    else:
                        # NaN fails both bounds checks and lands on 2s.
                        if not (0.0 <= secs <= 60.0):
                            secs = min(max(secs, 0.0), 60.0) if secs == secs else 2.0
                        # A HEAD probe must not pin a handler thread on
                        # seconds of stack sampling just to drop the body.
                        body = b"" if head else _sample_profile(secs).encode()
                        ctype = "text/plain"
                else:
                    body = b"not found"
                    status = 404
                    ctype = "text/plain"
                return status, ctype, body

            def _reply(self, status, ctype, body, include_body):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if include_body:
                    self.wfile.write(body)

            def _method_not_allowed(self):
                body = b"method not allowed; this surface is GET-only\n"
                self.send_response(405)
                self.send_header("Allow", "GET, HEAD")
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            # The debug surface is read-only by contract; a mutating
            # method is a caller bug (or a probe misconfiguration) and
            # must say so rather than fall into BaseHTTPRequestHandler's
            # 501. HEAD is a read and is served above.
            do_POST = _method_not_allowed
            do_PUT = _method_not_allowed
            do_DELETE = _method_not_allowed
            do_PATCH = _method_not_allowed

            def log_message(self, *args):
                pass  # quiet; structured logs carry the signal

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="metrics-http"
        )
        self._thread.start()

    def set_healthy(self, ok: bool) -> None:
        self._health["ok"] = ok

    def set_usage_provider(self, provider: Callable) -> None:
        """Serve ``provider()`` (a JSON-serializable dict) at
        ``/debug/usage``. Safe to call after ``start()``."""
        self.usage_provider = provider

    def set_allocations_provider(self, provider: Callable) -> None:
        """Serve ``provider()`` (a JSONL string, e.g.
        ``ReferenceAllocator.export_allocations_jsonl``) at
        ``/debug/allocations``. Safe to call after ``start()``."""
        self.allocations_provider = provider

    def set_defrag_provider(self, provider: Callable) -> None:
        """Serve ``provider()`` (a JSON-serializable dict, e.g.
        ``DefragPlanner.export_json``) at ``/debug/defrag``. Safe to
        call after ``start()``."""
        self.defrag_provider = provider

    def set_rebalance_provider(self, provider: Callable) -> None:
        """Serve ``provider()`` (a JSON-serializable dict, e.g.
        ``Rebalancer.snapshot``) at ``/debug/rebalance``. Safe to call
        after ``start()``."""
        self.rebalance_provider = provider

    def set_gateway_provider(self, provider: Callable) -> None:
        """Serve ``provider()`` (a JSON-serializable dict, e.g.
        ``ServingGateway.snapshot``) at ``/debug/gateway``. Safe to
        call after ``start()``."""
        self.gateway_provider = provider

    def set_kv_provider(self, provider: Callable) -> None:
        """Serve ``provider()`` (a JSON-serializable dict, e.g.
        ``DecodeEngine.kv_debug``) at ``/debug/kv``. Safe to call
        after ``start()``."""
        self.kv_provider = provider

    def set_residency_provider(self, provider: Callable) -> None:
        """Serve ``provider()`` (a JSON-serializable dict, e.g.
        ``ResidencyIndex.snapshot``) at ``/debug/residency``. Safe to
        call after ``start()``."""
        self.residency_provider = provider

    def set_compute_provider(self, provider: Callable) -> None:
        """Serve ``provider()`` (a JSON-serializable dict, e.g.
        ``ComputeTelemetry.compute_debug``) at ``/debug/compute``. Safe
        to call after ``start()``."""
        self.compute_provider = provider

    def set_requests_provider(self, provider: Callable) -> None:
        """Serve ``provider(view)`` (a JSONL string, e.g.
        ``ServingTelemetry.export_requests``) at ``/debug/requests``;
        ``view`` is the ``?view=`` query value ("" for the default
        timeline ring) and a ``ValueError`` from the provider renders
        as a 400. Safe to call after ``start()``."""
        self.requests_provider = provider

    def add_readiness_check(self, name: str, check: Callable,
                            critical: bool = True) -> None:
        """Register a readiness check. ``check()`` returns ``(ok, detail)``
        (a bare bool is accepted). A check that raises reads as not-ready
        with the exception as the detail — readiness must fail closed.
        ``critical=False`` checks only downgrade /readyz to ``degraded``
        (still 200) when failing. Safe to call after ``start()`` (late
        registration during wiring)."""
        with self._ready_lock:
            self._ready_checks[name] = (check, critical)

    def _render_readiness(self) -> tuple[bytes, int]:
        lines = []
        all_ok = self._health["ok"]
        degraded = False
        if not self._health["ok"]:
            lines.append("[-] healthz: unhealthy")
        with self._ready_lock:
            checks = sorted(self._ready_checks.items())
        for name, (check, critical) in checks:
            try:
                result = check()
            except Exception as e:
                result = (False, f"check raised: {e}")
            if isinstance(result, tuple):
                ok, detail = result
            else:
                ok, detail = bool(result), ""
            if not ok:
                if critical:
                    all_ok = False
                else:
                    degraded = True
            mark = "+" if ok else ("-" if critical else "~")
            lines.append(f"[{mark}] {name}" + (f": {detail}" if detail else ""))
        if not all_ok:
            lines.append("not ready")
        elif degraded:
            lines.append("degraded")
        else:
            lines.append("ready")
        return ("\n".join(lines) + "\n").encode(), (200 if all_ok else 503)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
