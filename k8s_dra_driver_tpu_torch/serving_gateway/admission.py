"""SLO-aware admission + backpressure for the fleet gateway.

Every request declares a latency class (``api/v1alpha1/slo.py`` — the
same enum the dynamic-sharing rebalancer arbitrates chips under, so one
vocabulary covers both layers of the stack). Admission is three rules:

- **Priority queues.** Realtime dispatches before interactive before
  batch, strictly: a burst of batch traffic can delay batch, never a
  realtime request that fits.
- **Watermark shedding, batch first.** When the fleet queue depth
  (gateway queues + every replica's backlog) crosses ``shed_watermark``,
  new BATCH requests are rejected with a typed :class:`OverloadedError`
  carrying ``retry_after_s``; past ``hard_watermark`` everything is
  rejected. Shedding at the door is deliberate: an overloaded fleet
  must say so immediately, not accept work it will miss deadlines on.
- **No silent queueing past a deadline.** A queued request that has
  waited longer than its class's grace window (``LATENCY_CLASSES`` —
  realtime seconds, batch minutes) is expired with the same typed
  error instead of eventually serving an answer nobody is waiting for.

The controller is pure queue arithmetic; metrics, ring-buffer records,
and Events live in the gateway. The one observability seam here: a
request carrying a ``timeline`` (serving_gateway/reqtrace.py) gets its
class-queue transitions recorded — enqueue depth, dequeue wait — since
only the queue owner can time the class-queue wait precisely.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

from ..api.v1alpha1.slo import (
    BATCH_CLASS,
    INTERACTIVE_CLASS,
    LATENCY_CLASSES,
    REALTIME_CLASS,
)

# Dispatch order: realtime first. (LATENCY_CLASSES maps class -> grace
# seconds; this tuple fixes priority, which grace alone doesn't imply.)
CLASS_ORDER = (REALTIME_CLASS, INTERACTIVE_CLASS, BATCH_CLASS)

# Shed reasons (stable label values on tpu_dra_gw_shed_total).
SHED_WATERMARK = "watermark"
SHED_DEADLINE = "deadline"
SHED_REASONS = (SHED_WATERMARK, SHED_DEADLINE)


class OverloadedError(RuntimeError):
    """The fleet cannot take (or keep) this request right now. Carries
    ``retry_after_s`` so clients back off instead of hammering, plus
    the shed reason and the queue depth that triggered it."""

    retryable = True

    def __init__(self, message: str, *, latency_class: str,
                 reason: str, retry_after_s: float, queue_depth: int):
        self.latency_class = latency_class
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth
        super().__init__(
            f"{message} (class {latency_class}, fleet queue depth "
            f"{queue_depth}; retry after {retry_after_s:.1f}s)"
        )


@dataclasses.dataclass
class AdmissionPolicy:
    """Operator knobs (docs/serving.md names them)."""

    shed_watermark: int = 256      # fleet depth where batch is shed
    hard_watermark: int = 1024     # fleet depth where everything is shed
    retry_after_s: float = 1.0
    # Per-class queue deadline override; None = the class's grace window
    # from LATENCY_CLASSES (realtime 5s, interactive 60s, batch 600s).
    max_queue_delay_s: Optional[dict] = None

    def deadline_s(self, latency_class: str) -> float:
        if self.max_queue_delay_s and latency_class in self.max_queue_delay_s:
            return float(self.max_queue_delay_s[latency_class])
        return LATENCY_CLASSES[latency_class]

    def to_dict(self) -> dict:
        return {
            "shedWatermark": self.shed_watermark,
            "hardWatermark": self.hard_watermark,
            "retryAfterSeconds": self.retry_after_s,
            "queueDeadlineSeconds": {
                lc: self.deadline_s(lc) for lc in CLASS_ORDER
            },
        }


class AdmissionController:
    """Priority queues + watermark/deadline enforcement. Holds gateway
    requests (anything with ``latency_class`` and ``submitted_at``
    attributes) between ``submit`` and dispatch."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy or AdmissionPolicy()
        self._queues: dict[str, deque] = {
            lc: deque() for lc in CLASS_ORDER
        }

    def depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth_by_class(self) -> dict[str, int]:
        return {lc: len(q) for lc, q in self._queues.items()}

    def check(self, latency_class: str, fleet_depth: int) -> None:
        """Admission gate for a NEW request at the given fleet queue
        depth (gateway queues + replica backlogs). Raises the typed
        overload; no state change."""
        if latency_class not in LATENCY_CLASSES:
            raise ValueError(
                f"unknown latency class {latency_class!r} (want one of "
                f"{sorted(LATENCY_CLASSES)})"
            )
        p = self.policy
        if fleet_depth >= p.hard_watermark:
            raise OverloadedError(
                "fleet past its hard watermark",
                latency_class=latency_class, reason=SHED_WATERMARK,
                retry_after_s=p.retry_after_s, queue_depth=fleet_depth,
            )
        if latency_class == BATCH_CLASS and fleet_depth >= p.shed_watermark:
            raise OverloadedError(
                "batch traffic shed first past the watermark",
                latency_class=latency_class, reason=SHED_WATERMARK,
                retry_after_s=p.retry_after_s, queue_depth=fleet_depth,
            )

    def enqueue(self, request) -> None:
        q = self._queues[request.latency_class]
        q.append(request)
        tl = getattr(request, "timeline", None)
        if tl is not None:
            tl.event(
                "class-queued", request.submitted_at,
                latencyClass=request.latency_class, depth=len(q),
            )

    def requeue_front(self, request) -> None:
        """Put a re-routed (drained/failed-over) request back at the
        FRONT of its class queue: it keeps its arrival priority."""
        self._queues[request.latency_class].appendleft(request)

    def pop(self, now: Optional[float] = None) -> Optional[object]:
        """Next request in strict class-priority order (FIFO within a
        class); None when all queues are empty. ``now`` (when the
        caller has a clock in hand) times the class-queue wait onto the
        request's timeline."""
        for lc in CLASS_ORDER:
            if self._queues[lc]:
                request = self._queues[lc].popleft()
                tl = getattr(request, "timeline", None)
                if tl is not None and now is not None:
                    tl.event(
                        "dequeued", now,
                        waitedS=round(
                            max(0.0, now - request.submitted_at), 6
                        ),
                    )
                return request
        return None

    def push_back(self, request) -> None:
        """Undo a pop (routing found no replica): back to the front so
        order is preserved."""
        self._queues[request.latency_class].appendleft(request)

    def expire(self, now: float) -> list:
        """Remove and return every queued request past its class
        deadline — the caller fails them with a typed error. Never
        silent: a request leaves these queues dispatched or rejected."""
        expired = []
        for lc, q in self._queues.items():
            limit = self.policy.deadline_s(lc)
            keep = deque()
            while q:
                r = q.popleft()
                if now - r.submitted_at > limit:
                    expired.append(r)
                else:
                    keep.append(r)
            self._queues[lc] = keep
        return expired
