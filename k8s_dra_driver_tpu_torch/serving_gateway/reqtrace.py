"""Serving-path request observability: timelines, tick phases, SLO telemetry.

The fleet serving stack (DecodeEngine -> gateway -> autoscaler) exposed
only aggregates — ServingStats percentiles and ``tpu_dra_gw_*`` counters —
so "why was *this* request's TTFT 4x p50?" was unanswerable. This module
is the per-request and per-tick measurement layer that closes that gap,
in three pieces:

1. **Request timelines** (:class:`RequestTimeline`): every gateway submit
   opens a root span on the contextvars tracer (``utils/tracing.py``)
   and starts a timeline that accumulates timestamped events across both
   the gateway (admission, class-queue wait, routing decision) and the
   engine (engine admission, per-prefill-chunk lane/occupancy, first
   token, preemptions, retire). The trace id is stamped on the timeline
   and returned to the caller, so gateway spans, engine events, and JSON
   log lines all join on it. Terminal events (``finished`` / ``shed`` /
   ``expired`` / ``failed``) are never dropped: *every* submitted request
   seals into the bounded finished ring, served as JSONL at
   ``GET /debug/requests``.

2. **Tick phase profiler** (:class:`TickProfiler`): decomposes
   ``ServingGateway.tick()`` and ``DecodeEngine.tick()`` wall time into
   named phases (dispatch, prefill launch, decode dispatch, host harvest,
   autoscale, ...) feeding the ``tpu_dra_srv_tick_phase_seconds``
   histogram plus the ``/debug/requests?view=ticks`` profile view — "the
   engine is slow" becomes "harvest is 60% of the tick". Nested phases
   record *self time* (a parent's recorded seconds exclude its
   children's), so one tick's phases sum to the tick's wall time.

3. **Fleet SLO telemetry** (:class:`ServingTelemetry`): per-latency-class
   TTFT / token-interval / e2e histograms and violation counters — one
   class vocabulary with ``api/v1alpha1/slo.py``, explicit zeros so
   absence-of-traffic and absence-of-instrumentation are
   distinguishable. Each violation *onset* (a class flipping from
   meeting to missing its SLO on a signal) captures the offending
   request's full timeline into a bounded exemplar ledger; repeat
   violations while the class is already in violation count but do not
   re-capture, so the ledger holds regime changes, not every slow
   request of a sustained incident. :meth:`ServingTelemetry.
   fleet_slo_summary` is the JSON artifact a soak harness gates on.

Cost discipline: telemetry is opt-in (``ServingGateway(telemetry=...)``;
``None`` keeps every hot path on its old branch), events are host-side
dict appends bounded per request, and the engine emits only when a
request carries a timeline — ``tools/run_trace_smoke.py`` gates the
overhead (token streams, tick counts, and compile counts must be
identical ON vs OFF; wall-clock req/s within a tripwire).

TPM05 ownership: this module owns the ``tpu_dra_srv_`` metric family
prefix (``tools/lint.py``) — the one serving-observability vocabulary.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Optional

from ..api.v1alpha1.slo import LATENCY_CLASSES
from ..utils.metrics import Counter, Histogram, Registry
from ..utils.tracing import Tracer

# Terminal timeline outcomes (stable label values; /debug/requests and the
# tpu_dra_srv_timelines_total{outcome} enum).
OUTCOME_FINISHED = "finished"
OUTCOME_SHED = "shed"
OUTCOME_EXPIRED = "expired"
OUTCOME_FAILED = "failed"
OUTCOMES = (OUTCOME_FINISHED, OUTCOME_SHED, OUTCOME_EXPIRED, OUTCOME_FAILED)

# SLO signals (the tpu_dra_srv_slo_violations_total{signal} enum).
SIGNAL_TTFT = "ttft"
SIGNAL_E2E = "e2e"
SLO_SIGNALS = (SIGNAL_TTFT, SIGNAL_E2E)

# Tick-phase vocabulary (the tpu_dra_srv_tick_phase_seconds{component,
# phase} enum). Replicas do not get their own component label — replica
# churn under autoscaling would make the cardinality unbounded; the
# per-tick ring entries carry a free-form ``tag`` instead.
COMPONENT_GATEWAY = "gateway"
COMPONENT_ENGINE = "engine"
GATEWAY_PHASES = ("expire", "dispatch", "replicas", "harvest", "autoscale")
ENGINE_PHASES = ("admit", "prefill", "decode", "harvest")

# Timeline phase names derived from event boundaries (dominant-phase
# vocabulary; docs/operations.md has one runbook row per entry).
TIMELINE_PHASES = ("queueWait", "engineQueue", "prefill", "decode")

RING_DEPTH = 256        # finished-timeline ring bound
TICK_RING_DEPTH = 256   # per-tick profile ring bound
EXEMPLAR_DEPTH = 32     # violation exemplar ledger bound
MAX_EVENTS = 512        # per-timeline event bound (terminal event exempt)
SAMPLE_WINDOW = 4096    # per-class latency samples kept for percentiles

# Requests-endpoint views (/debug/requests?view=...).
VIEWS = ("", "requests", "ticks", "exemplars", "slo")

_E2E_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 600)
_INTERVAL_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30)
_PHASE_BUCKETS = (5e-5, 2e-4, 1e-3, 5e-3, 0.02, 0.1, 0.5, 2)


def _pctl(xs, q: float) -> float:
    """Same nearest-rank percentile as ``ServingStats.pctl`` (kept in
    lockstep so fleet_slo_summary p99s are comparable to engine stats
    without importing the model layer here)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    return s[min(len(s) - 1, int(q * len(s)))]


class _NullPhase:
    """No-op phase context: the disabled-telemetry fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


def phase_ctx(profiler: Optional["TickProfiler"], component: str,
              name: str):
    """``profiler.phase(...)`` or a shared no-op when profiling is off —
    the one-liner the gateway/engine tick bodies wrap phases with."""
    if profiler is None:
        return _NULL_PHASE
    return profiler.phase(component, name)


class RequestTimeline:
    """Timestamped event log for one gateway request, gateway and engine
    sides joined by the submit root span's trace id. Events are bounded
    (``MAX_EVENTS``; overflow counted in ``dropped_events``) except the
    terminal event, which is always recorded — a shed/expired/failed
    request must never be silently absent from /debug/requests."""

    __slots__ = (
        "trace_id", "gid", "latency_class", "submitted_at",
        "prompt_tokens", "outcome", "finished_at", "events",
        "dropped_events",
    )

    def __init__(self, latency_class: str, submitted_at: float,
                 trace_id: str = "", prompt_tokens: int = 0):
        self.trace_id = trace_id
        self.gid = ""
        self.latency_class = latency_class
        self.submitted_at = submitted_at
        self.prompt_tokens = prompt_tokens
        self.outcome = ""          # empty while live; OUTCOMES when sealed
        self.finished_at = 0.0
        self.events: list[dict] = []
        self.dropped_events = 0

    def event(self, name: str, t: float, **attrs: Any) -> None:
        if self.outcome or len(self.events) >= MAX_EVENTS:
            if not self.outcome:
                self.dropped_events += 1
            return
        self.events.append({"event": name, "t": round(t, 6), **attrs})

    def _terminal(self, outcome: str, t: float, **attrs: Any) -> None:
        self.events.append({"event": outcome, "t": round(t, 6), **attrs})
        self.outcome = outcome
        self.finished_at = t

    def _first(self, name: str) -> Optional[float]:
        for e in self.events:
            if e["event"] == name:
                return e["t"]
        return None

    def phase_durations(self) -> dict[str, float]:
        """Contiguous named intervals derived from event boundaries:
        submit -> routed -> engine-admit -> first-token -> terminal.
        A missing boundary collapses its phase to zero (an expired
        request that never routed is all ``queueWait``), so the phases
        always sum to the measured e2e latency."""
        end = self.finished_at or (self.events[-1]["t"] if self.events
                                   else self.submitted_at)
        t_first = self._first("first-token")
        if t_first is None:
            t_first = end
        t_admit = self._first("engine-admit")
        if t_admit is None:
            t_admit = t_first
        t_routed = self._first("routed")
        if t_routed is None:
            t_routed = t_admit
        marks = (self.submitted_at, t_routed, t_admit, t_first, end)
        out = {}
        for name, a, b in zip(TIMELINE_PHASES, marks, marks[1:]):
            out[name] = round(max(0.0, b - a), 6)
        return out

    def dominant_phase(self) -> str:
        phases = self.phase_durations()
        return max(TIMELINE_PHASES, key=lambda p: phases[p])

    def to_doc(self) -> dict:
        e2e = max(0.0, self.finished_at - self.submitted_at)
        return {
            "traceId": self.trace_id,
            "gid": self.gid,
            "latencyClass": self.latency_class,
            "outcome": self.outcome,
            "submittedAt": round(self.submitted_at, 6),
            "finishedAt": round(self.finished_at, 6),
            "e2eS": round(e2e, 6),
            "promptTokens": self.prompt_tokens,
            "phases": self.phase_durations(),
            "dominantPhase": self.dominant_phase(),
            "droppedEvents": self.dropped_events,
            "events": list(self.events),
        }


class _PhaseSpan:
    """One open profiler phase. Self-time accounting: on exit, the
    elapsed time minus any nested phases' elapsed is recorded under this
    phase, and the full elapsed is charged to the parent's child total —
    so a tick's recorded phases partition its wall time."""

    __slots__ = ("_prof", "component", "name", "_t0", "_child")

    def __init__(self, prof: "TickProfiler", component: str, name: str):
        self._prof = prof
        self.component = component
        self.name = name
        self._t0 = 0.0
        self._child = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._prof._stack.append(self)
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._t0
        stack = self._prof._stack
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1]._child += elapsed
        self._prof._record(
            self.component, self.name, max(0.0, elapsed - self._child)
        )
        return False


class TickProfiler:
    """Wall-time decomposition of gateway/engine ticks into named phases.

    Single-ticker contract: ``phase()`` / ``end_tick()`` are called from
    the one thread driving the tick loop (the stack is not locked);
    the accumulated state and ring are lock-protected so a concurrent
    ``/debug/requests?view=ticks`` scrape sees a consistent snapshot.
    """

    def __init__(self, observe: Optional[Callable[[str, str, float], None]]
                 = None, ring_depth: int = TICK_RING_DEPTH):
        self._observe = observe
        self._lock = threading.Lock()
        self._stack: list[_PhaseSpan] = []
        self._current: dict[tuple[str, str], float] = {}
        self._cum: dict[tuple[str, str], float] = {}
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=ring_depth
        )
        self._ticks = 0

    def phase(self, component: str, name: str) -> _PhaseSpan:
        return _PhaseSpan(self, component, name)

    def _record(self, component: str, name: str, seconds: float) -> None:
        key = (component, name)
        with self._lock:
            self._current[key] = self._current.get(key, 0.0) + seconds
            self._cum[key] = self._cum.get(key, 0.0) + seconds
        if self._observe is not None:
            self._observe(component, name, seconds)

    def end_tick(self, component: str, tick_no: int, tag: str = "") -> None:
        """Seal ``component``'s phases accumulated since its last
        end_tick into one ring entry (the ?view=ticks line)."""
        with self._lock:
            phases = {
                p: round(s, 9)
                for (c, p), s in self._current.items() if c == component
            }
            for p in phases:
                del self._current[(component, p)]
            entry = {
                "kind": "tick",
                "component": component,
                "tick": tick_no,
                "phases": phases,
                "totalS": round(sum(phases.values()), 9),
            }
            if tag:
                entry["tag"] = tag
            self._ring.append(entry)
            self._ticks += 1

    def summary(self) -> dict:
        """Cumulative seconds per component/phase plus each phase's share
        of its component's total — the "harvest is 60% of the tick"
        readout."""
        with self._lock:
            cum = dict(self._cum)
            ticks = self._ticks
        totals: dict[str, float] = {}
        for (c, _), s in cum.items():
            totals[c] = totals.get(c, 0.0) + s
        return {
            "kind": "summary",
            "ticks": ticks,
            "phaseSeconds": {
                f"{c}/{p}": round(s, 9) for (c, p), s in sorted(cum.items())
            },
            "phaseShare": {
                f"{c}/{p}": round(s / totals[c], 4) if totals[c] else 0.0
                for (c, p), s in sorted(cum.items())
            },
        }

    def export_jsonl(self) -> str:
        """Summary line followed by the per-tick ring, one JSON object
        per line (the ``?view=ticks`` wire format)."""
        with self._lock:
            entries = list(self._ring)
        lines = [json.dumps(self.summary(), sort_keys=True)]
        lines.extend(json.dumps(e, sort_keys=True) for e in entries)
        return "\n".join(lines) + "\n"


class ServingTelemetry:
    """The serving observability spine: owns the request-timeline ring,
    the tick profiler, the ``tpu_dra_srv_*`` metric families, the SLO
    violation/exemplar machinery, and the contextvars tracer the gateway
    opens submit root spans on. One instance per Registry (duplicate
    family names otherwise) — typically one per gateway.

    ``slo`` maps latency class -> ``{"ttftS": ..., "e2eS": ...}`` budgets
    in clock seconds; omitted classes default to the class deadline from
    ``api/v1alpha1/slo.py`` for e2e and a fifth of it for TTFT (a
    request may spend its queueing grace, but first output should come
    well inside it).
    """

    # fleet_slo_summary() contract: key sets are pinned by
    # the parity tests, and soak harnesses parse this.
    SLO_SUMMARY_KEYS = (
        "affinityHitRate", "classes", "exemplars", "requests", "sheds",
        "violations",
    )
    SLO_CLASS_KEYS = (
        "e2eP50S", "e2eP99S", "requests", "sheds", "tokenIntervalP50S",
        "tokenIntervalP99S", "ttftP50S", "ttftP99S", "violationSeconds",
        "violations",
    )

    def __init__(self, registry: Registry, *,
                 tracer: Optional[Tracer] = None,
                 slo: Optional[dict] = None,
                 ring_depth: int = RING_DEPTH,
                 exemplar_depth: int = EXEMPLAR_DEPTH):
        self.tracer = tracer if tracer is not None else Tracer()
        self._lock = threading.Lock()
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=ring_depth
        )
        self._exemplars: "collections.deque[dict]" = collections.deque(
            maxlen=exemplar_depth
        )
        self._slo = {
            cls: {
                "ttftS": float(grace) / 5.0,
                "e2eS": float(grace),
                **dict((slo or {}).get(cls) or {}),
            }
            for cls, grace in LATENCY_CLASSES.items()
        }
        self._in_violation: dict[tuple[str, str], bool] = {}
        self._samples: dict[str, dict[str, collections.deque]] = {
            cls: {
                "ttft": collections.deque(maxlen=SAMPLE_WINDOW),
                "e2e": collections.deque(maxlen=SAMPLE_WINDOW),
                "interval": collections.deque(maxlen=SAMPLE_WINDOW),
            }
            for cls in LATENCY_CLASSES
        }
        self._violation_s: dict[str, float] = dict.fromkeys(
            LATENCY_CLASSES, 0.0
        )
        self._sheds: dict[str, int] = dict.fromkeys(LATENCY_CLASSES, 0)
        self._routed = 0
        self._affinity_routed = 0
        self._affinity_hits = 0

        self._h_ttft = Histogram(
            "tpu_dra_srv_ttft_seconds",
            "Per-class time to first token, gateway submit to first "
            "emitted token",
            registry, buckets=_E2E_BUCKETS,
        )
        self._h_e2e = Histogram(
            "tpu_dra_srv_e2e_seconds",
            "Per-class end-to-end request latency, gateway submit to "
            "harvest",
            registry, buckets=_E2E_BUCKETS,
        )
        self._h_interval = Histogram(
            "tpu_dra_srv_token_interval_seconds",
            "Per-class mean inter-token interval over each finished "
            "request's decode",
            registry, buckets=_INTERVAL_BUCKETS,
        )
        self._h_phase = Histogram(
            "tpu_dra_srv_tick_phase_seconds",
            "Self-time of one named gateway/engine tick phase",
            registry, buckets=_PHASE_BUCKETS,
        )
        self._c_violations = Counter(
            "tpu_dra_srv_slo_violations_total",
            "Requests that missed their class SLO, by signal",
            registry,
        )
        self._c_violation_seconds = Counter(
            "tpu_dra_srv_violation_seconds_total",
            "Cumulative seconds by which violating requests exceeded "
            "their class budget",
            registry,
        )
        self._c_timelines = Counter(
            "tpu_dra_srv_timelines_total",
            "Request timelines sealed into the /debug/requests ring, by "
            "terminal outcome",
            registry,
        )
        self._c_exemplars = Counter(
            "tpu_dra_srv_exemplars_total",
            "Violation-onset timelines captured into the exemplar ledger",
            registry,
        )
        # Explicit zeros: every enum cell exists from scrape one, so
        # "no violations" and "telemetry not wired" are distinguishable.
        for cls in LATENCY_CLASSES:
            self._h_ttft.zero(latency_class=cls)
            self._h_e2e.zero(latency_class=cls)
            self._h_interval.zero(latency_class=cls)
            self._c_exemplars.inc(0, latency_class=cls)
            self._c_violation_seconds.inc(0, latency_class=cls)
            for signal in SLO_SIGNALS:
                self._c_violations.inc(0, latency_class=cls, signal=signal)
        for outcome in OUTCOMES:
            self._c_timelines.inc(0, outcome=outcome)
        for p in GATEWAY_PHASES:
            self._h_phase.zero(component=COMPONENT_GATEWAY, phase=p)
        for p in ENGINE_PHASES:
            self._h_phase.zero(component=COMPONENT_ENGINE, phase=p)

        self.profiler = TickProfiler(observe=self._observe_phase)

    def _observe_phase(self, component: str, phase: str,
                       seconds: float) -> None:
        self._h_phase.observe(seconds, component=component, phase=phase)

    # -- timelines ---------------------------------------------------------

    def new_timeline(self, latency_class: str, now: float,
                     trace_id: str = "",
                     prompt_tokens: int = 0) -> RequestTimeline:
        return RequestTimeline(
            latency_class, now, trace_id=trace_id,
            prompt_tokens=prompt_tokens,
        )

    def finish_timeline(self, tl: RequestTimeline, outcome: str,
                        now: float, **attrs: Any) -> None:
        """Seal ``tl`` with a terminal event and move its doc into the
        finished ring. Idempotent: a timeline seals once."""
        if tl.outcome:
            return
        tl._terminal(outcome, now, **attrs)
        if outcome == OUTCOME_SHED:
            with self._lock:
                if tl.latency_class in self._sheds:
                    self._sheds[tl.latency_class] += 1
        self._c_timelines.inc(outcome=outcome)
        doc = tl.to_doc()
        with self._lock:
            self._ring.append(doc)

    def observe_request(self, tl: RequestTimeline, now: float,
                        tokens: int = 0) -> None:
        """SLO accounting for one *finished* request, then seal it.
        Violation onset (a class flipping from meeting to missing a
        signal's budget) captures the timeline as an exemplar; a
        compliant sample clears the flag."""
        cls = tl.latency_class
        e2e = max(0.0, now - tl.submitted_at)
        t_first = tl._first("first-token")
        ttft = max(0.0, t_first - tl.submitted_at) if t_first is not None \
            else e2e
        interval = 0.0
        if tokens > 1 and t_first is not None:
            interval = max(0.0, now - t_first) / (tokens - 1)
        self._h_ttft.observe(ttft, latency_class=cls)
        self._h_e2e.observe(e2e, latency_class=cls)
        if tokens > 1:
            self._h_interval.observe(interval, latency_class=cls)
        with self._lock:
            samples = self._samples.get(cls)
            if samples is not None:
                samples["ttft"].append(ttft)
                samples["e2e"].append(e2e)
                if tokens > 1:
                    samples["interval"].append(interval)
        budgets = self._slo.get(cls) or {}
        worst = None  # (excess, signal, observed, limit)
        for signal, value, limit in (
            (SIGNAL_TTFT, ttft, budgets.get("ttftS")),
            (SIGNAL_E2E, e2e, budgets.get("e2eS")),
        ):
            if limit is None:
                continue
            key = (cls, signal)
            if value > limit:
                self._c_violations.inc(latency_class=cls, signal=signal)
                self._c_violation_seconds.inc(
                    value - limit, latency_class=cls
                )
                with self._lock:
                    self._violation_s[cls] = (
                        self._violation_s.get(cls, 0.0) + (value - limit)
                    )
                    onset = not self._in_violation.get(key, False)
                    self._in_violation[key] = True
                if onset and (worst is None or value - limit > worst[0]):
                    worst = (value - limit, signal, value, limit)
            else:
                with self._lock:
                    self._in_violation[key] = False
        self.finish_timeline(
            tl, OUTCOME_FINISHED, now,
            ttftS=round(ttft, 6), e2eS=round(e2e, 6), tokens=tokens,
        )
        if worst is not None:
            _, signal, value, limit = worst
            exemplar = {
                "signal": signal,
                "latencyClass": cls,
                "observedS": round(value, 6),
                "thresholdS": round(limit, 6),
                "dominantPhase": tl.dominant_phase(),
                "traceId": tl.trace_id,
                "timeline": tl.to_doc(),
            }
            self._c_exemplars.inc(latency_class=cls)
            with self._lock:
                self._exemplars.append(exemplar)

    # -- gateway-side counters --------------------------------------------

    def note_route(self, affinity_key, affinity_hit: bool) -> None:
        with self._lock:
            self._routed += 1
            if affinity_key is not None:
                self._affinity_routed += 1
                if affinity_hit:
                    self._affinity_hits += 1

    # -- export ------------------------------------------------------------

    def exemplars(self) -> list[dict]:
        with self._lock:
            return list(self._exemplars)

    def timelines(self) -> list[dict]:
        """Sealed timeline docs, oldest first."""
        with self._lock:
            return list(self._ring)

    def fleet_slo_summary(self) -> dict:
        """Per-class SLO snapshot (pinned keys: ``SLO_SUMMARY_KEYS`` /
        ``SLO_CLASS_KEYS``) — what the soak harness gates on."""
        with self._lock:
            samples = {
                cls: {k: list(v) for k, v in per.items()}
                for cls, per in self._samples.items()
            }
            violation_s = dict(self._violation_s)
            sheds = dict(self._sheds)
            n_exemplars = len(self._exemplars)
            affinity_routed = self._affinity_routed
            affinity_hits = self._affinity_hits
        classes = {}
        total_requests = 0
        total_violations = 0
        for cls in sorted(LATENCY_CLASSES):
            per = samples[cls]
            violations = sum(
                int(self._c_violations.value(latency_class=cls,
                                             signal=signal))
                for signal in SLO_SIGNALS
            )
            classes[cls] = {
                "requests": len(per["e2e"]),
                "violations": violations,
                "violationSeconds": round(violation_s.get(cls, 0.0), 6),
                "sheds": sheds.get(cls, 0),
                "ttftP50S": round(_pctl(per["ttft"], 0.50), 6),
                "ttftP99S": round(_pctl(per["ttft"], 0.99), 6),
                "e2eP50S": round(_pctl(per["e2e"], 0.50), 6),
                "e2eP99S": round(_pctl(per["e2e"], 0.99), 6),
                "tokenIntervalP50S": round(
                    _pctl(per["interval"], 0.50), 6),
                "tokenIntervalP99S": round(
                    _pctl(per["interval"], 0.99), 6),
            }
            total_requests += len(per["e2e"])
            total_violations += violations
        return {
            "affinityHitRate": round(
                affinity_hits / affinity_routed, 4
            ) if affinity_routed else 0.0,
            "classes": classes,
            "exemplars": n_exemplars,
            "requests": total_requests,
            "sheds": sum(sheds.values()),
            "violations": total_violations,
        }

    def export_requests(self, view: str = "") -> str:
        """The ``/debug/requests`` wire format: JSONL per view.
        Unknown views raise ``ValueError`` (the endpoint's 400)."""
        if view in ("", "requests"):
            docs = self.timelines()
            out = [json.dumps(d, sort_keys=True) for d in docs]
            return "\n".join(out) + ("\n" if out else "")
        if view == "ticks":
            return self.profiler.export_jsonl()
        if view == "exemplars":
            out = [json.dumps(e, sort_keys=True)
                   for e in self.exemplars()]
            return "\n".join(out) + ("\n" if out else "")
        if view == "slo":
            return json.dumps(self.fleet_slo_summary(),
                              sort_keys=True) + "\n"
        raise ValueError(
            f"unknown view {view!r} (want one of "
            f"{[v for v in VIEWS if v]})"
        )
