"""Claim-lifecycle tracing: stdlib-only spans with claim-UID correlation.

The production DRA debugging question is "which claim, on which node,
failed at which stage, and why" — a question Prometheus counters cannot
answer because they aggregate away the claim. This module gives every
kubelet RPC a root span and every stage underneath it (claim fetch, device
allocation, CDI render, checkpoint write) a child span, all carrying the
claim UID, so one trace shows the full NodePrepareResources decomposition.

Design constraints, in order:

- **stdlib only** (no opentelemetry in the image): ``contextvars`` carries
  the current span, a bounded ring buffer holds finished traces, and JSONL
  is the export format (served by ``MetricsServer`` at ``/debug/traces``).
- **Zero plumbing for leaf modules**: ``child_span()`` parents from the
  contextvar, so ``cdi/spec.py`` or ``plugin/checkpoint.py`` never see a
  Tracer object — outside a traced request they get a no-op span.
- **Cross-signal correlation**: ``current_span()`` is read by
  ``utils.logging.JsonFormatter`` so every log line emitted inside a span
  carries the trace/span/claim ids; metrics observe ``Span.duration`` so
  histograms and traces time the same interval.

Thread propagation follows the ``contextvars`` contract: a thread started
with ``contextvars.copy_context().run`` (or any executor that copies
context) sees the caller's current span and parents correctly.
"""

from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from contextvars import ContextVar
from typing import Any, Optional

# The tag key that correlates spans, logs, and Kubernetes Events.
CLAIM_UID_TAG = "claim_uid"

_current_span: ContextVar[Optional["Span"]] = ContextVar(
    "tpu_dra_current_span", default=None
)


def current_span() -> Optional["Span"]:
    """The innermost active span in this context, or None."""
    return _current_span.get()


def child_span(name: str, **tags: Any) -> "Span":
    """A child of the current span — or a no-op span when nothing is
    being traced. The plumbing-free entry point for leaf modules: the CDI
    renderer and checkpoint store call this and inherit the RPC's trace
    automatically, without ever holding a Tracer reference."""
    parent = _current_span.get()
    if parent is None or parent.tracer is None:
        return Span(None, name, tags=tags)
    return parent.tracer.span(name, tags=tags)


class Span:
    """One timed, tagged operation. Context manager; never raises from
    tracing itself. A span with ``tracer=None`` is a no-op that still
    measures duration (so callers can log latency uniformly)."""

    __slots__ = (
        "tracer", "name", "trace_id", "span_id", "parent_id",
        "tags", "status", "error", "start", "duration",
        "_t0", "_token",
    )

    def __init__(
        self,
        tracer: Optional["Tracer"],
        name: str,
        parent: Optional["Span"] = None,
        tags: Optional[dict] = None,
    ):
        self.tracer = tracer
        self.name = name
        self.tags: dict[str, Any] = dict(tags or {})
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_id = parent.span_id
            # Claim-UID correlation: children inherit the claim id so every
            # span of a prepare carries it, not just the one that set it.
            if CLAIM_UID_TAG in parent.tags:
                self.tags.setdefault(CLAIM_UID_TAG, parent.tags[CLAIM_UID_TAG])
        else:
            self.trace_id = tracer._new_id() if tracer else ""
            self.parent_id = ""
        self.span_id = tracer._new_id() if tracer else ""
        self.status = "ok"
        self.error = ""
        self.start = 0.0
        self.duration = 0.0
        self._t0 = 0.0
        self._token = None

    # -- tagging -----------------------------------------------------------

    def set_tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def set_error(self, message: str) -> "Span":
        self.status = "error"
        self.error = message
        return self

    @property
    def claim_uid(self) -> str:
        return str(self.tags.get(CLAIM_UID_TAG, ""))

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "Span":
        self.start = time.time()
        self._t0 = time.monotonic()
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration = time.monotonic() - self._t0
        if exc_type is not None and self.status == "ok":
            self.set_error(f"{exc_type.__name__}: {exc}")
        if self._token is not None:
            try:
                _current_span.reset(self._token)
            except ValueError:
                # Exited in a different context than it was entered in
                # (cross-thread misuse); clear rather than crash the caller.
                _current_span.set(None)
            self._token = None
        if self.tracer is not None:
            self.tracer._finish(self)
        return False  # never swallow the caller's exception

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "start": round(self.start, 6),
            "duration": round(self.duration, 6),
            "status": self.status,
            "error": self.error,
            "tags": dict(self.tags),
        }


class Tracer:
    """Span factory + bounded ring buffer of finished traces.

    A *trace* is the set of spans sharing a trace id; it is sealed (moved
    into the ring buffer) when its root span finishes. The buffer keeps the
    most recent ``max_traces`` traces; older ones are evicted — this is a
    flight recorder, not a telemetry pipeline.
    """

    # Spans accumulated for roots that never finish (a wedged RPC) must not
    # grow without bound; the oldest open trace is dropped past this.
    MAX_OPEN_TRACES = 256

    def __init__(self, max_traces: int = 256):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._open: "collections.OrderedDict[str, list[dict]]" = (
            collections.OrderedDict()
        )
        self._traces: "collections.deque[dict]" = collections.deque(
            maxlen=max_traces
        )

    def _new_id(self) -> str:
        with self._lock:
            return f"{next(self._ids):08x}"

    def span(self, name: str, claim_uid: str = "",
             tags: Optional[dict] = None, **extra: Any) -> Span:
        """Start a span. Parents from the context's current span when one
        is active (even one belonging to another Tracer — the root's
        tracer owns the trace); otherwise this span is a trace root.
        ``tags`` and keyword extras merge into one FLAT tag dict — the
        /debug/traces schema has no nesting."""
        parent = _current_span.get()
        all_tags = dict(tags or {})
        all_tags.update(extra)
        if claim_uid:
            all_tags[CLAIM_UID_TAG] = claim_uid
        if parent is not None and parent.tracer is not None:
            return Span(parent.tracer, name, parent=parent, tags=all_tags)
        return Span(self, name, tags=all_tags)

    def _finish(self, span: Span) -> None:
        with self._lock:
            bucket = self._open.setdefault(span.trace_id, [])
            bucket.append(span.to_dict())
            if span.parent_id == "":
                spans = self._open.pop(span.trace_id)
                spans.sort(key=lambda s: (s["start"], s["spanId"]))
                self._traces.append(
                    {
                        "traceId": span.trace_id,
                        "root": span.name,
                        "claimUid": span.claim_uid,
                        "duration": round(span.duration, 6),
                        # A DRA RPC succeeds even when a claim inside it
                        # fails (errors are in-band); the trace summary
                        # surfaces any erroring stage, not just the root.
                        "status": (
                            "error"
                            if any(s["status"] == "error" for s in spans)
                            else span.status
                        ),
                        "spans": spans,
                    }
                )
            while len(self._open) > self.MAX_OPEN_TRACES:
                self._open.popitem(last=False)

    # -- export ------------------------------------------------------------

    def traces(self) -> list[dict]:
        """Finished traces, oldest first."""
        with self._lock:
            return list(self._traces)

    def find_trace(self, claim_uid: str) -> Optional[dict]:
        """Most recent finished trace whose root carries this claim UID."""
        with self._lock:
            for trace in reversed(self._traces):
                if trace["claimUid"] == claim_uid or any(
                    s["tags"].get(CLAIM_UID_TAG) == claim_uid
                    for s in trace["spans"]
                ):
                    return trace
        return None

    def find_trace_by_tag(self, key: str, value) -> Optional[dict]:
        """Most recent finished trace with any span tagged ``key=value``
        — the generalization of :meth:`find_trace` the serving gateway
        uses to join a request's submit span on its gateway id."""
        with self._lock:
            for trace in reversed(self._traces):
                if any(s["tags"].get(key) == value
                       for s in trace["spans"]):
                    return trace
        return None

    def export_jsonl(self) -> str:
        """One JSON object per line per finished trace (the
        ``/debug/traces`` wire format)."""
        out = [json.dumps(t, sort_keys=True) for t in self.traces()]
        return "\n".join(out) + ("\n" if out else "")

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._open.clear()
