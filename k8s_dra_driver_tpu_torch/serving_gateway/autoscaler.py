"""Replica autoscaler: the closed loop from fleet load to claim count.

Same shape as the dynamic-sharing rebalancer (observe -> decide -> apply ->
narrate), one level up the stack: the observed signal is fleet queue
depth per replica (and TTFT p99 when a target is set), and the actuator
is the replica set itself — scale-up solves a new ResourceClaim through
the allocator and spins an engine onto it; scale-down drains a replica
(admission closed, in-flight requests finish, queued ones re-route) and
releases its claim.

Stability machinery, because claims are expensive to flap:

- **Hysteresis (dwell).** A scale signal must hold for ``dwell_ticks``
  consecutive evaluations before acting — one bursty tick moves
  nothing.
- **Cooldown.** After any scale action (either direction, applied OR
  failed) the loop sleeps ``cooldown_seconds``: the new replica needs
  time to absorb load before the signal is trusted again, and a failing
  provisioner must not be hammered every tick.
- **Bounds.** ``min_replicas``/``max_replicas`` clamp the loop; the
  decision record says when a needed scale was clamped so the operator
  sees saturation rather than silence.

The provisioner is an injected seam (:class:`ReplicaProvisioner`): the
cluster sim backs it with a real ``ReferenceAllocator`` solve +
``DeviceState.prepare``, production would back
it with a ResourceClaim create. The autoscaler itself never touches
kube types.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Protocol

from .router import Replica

logger = logging.getLogger(__name__)

# Decision labels (stable values on tpu_dra_gw_scale_decisions_total and
# in /debug/gateway records).
DIRECTION_UP = "up"
DIRECTION_DOWN = "down"
DIRECTIONS = (DIRECTION_UP, DIRECTION_DOWN)

OUTCOME_APPLIED = "applied"
OUTCOME_FAILED = "failed"
OUTCOME_COOLDOWN = "cooldown"
OUTCOME_DWELL = "dwell"
OUTCOME_CLAMPED = "clamped"
OUTCOMES = (OUTCOME_APPLIED, OUTCOME_FAILED, OUTCOME_COOLDOWN,
            OUTCOME_DWELL, OUTCOME_CLAMPED)


class ScaleError(RuntimeError):
    """A provisioner scale-up/down failed (e.g. the allocator solve went
    unsat). Typed so the gateway records outcome=failed instead of
    crashing its tick loop; carries the underlying cause message."""


class ReplicaProvisioner(Protocol):
    """The claim-lifecycle seam the autoscaler actuates through."""

    def scale_up(self) -> Replica:
        """Provision one replica (solve a claim, build an engine).
        Raise :class:`ScaleError` (or anything — it's wrapped) when the
        fleet has no capacity."""
        ...

    def scale_down(self, replica: Replica) -> None:
        """Release the (already drained) replica's claim."""
        ...


@dataclasses.dataclass
class AutoscalerPolicy:
    """Operator knobs (docs/serving.md names them)."""

    min_replicas: int = 1
    max_replicas: int = 8
    # Mean backlog per replica (fleet queue depth / replicas) bands.
    queue_high_water: float = 6.0
    queue_low_water: float = 0.5
    # TTFT p99 above this also demands scale-up; 0 disables the signal.
    ttft_p99_target_ms: float = 0.0
    dwell_ticks: int = 3
    cooldown_seconds: float = 60.0

    def to_dict(self) -> dict:
        return {
            "minReplicas": self.min_replicas,
            "maxReplicas": self.max_replicas,
            "queueHighWater": self.queue_high_water,
            "queueLowWater": self.queue_low_water,
            "ttftP99TargetMs": self.ttft_p99_target_ms,
            "dwellTicks": self.dwell_ticks,
            "cooldownSeconds": self.cooldown_seconds,
        }


class Autoscaler:
    """Evaluate the fleet signal and decide; the gateway executes
    (it owns draining and the fault site) and reports back."""

    def __init__(self, policy: Optional[AutoscalerPolicy] = None,
                 provisioner: Optional[ReplicaProvisioner] = None):
        self.policy = policy or AutoscalerPolicy()
        self.provisioner = provisioner
        self._dwell = {DIRECTION_UP: 0, DIRECTION_DOWN: 0}
        self._last_scaled = float("-inf")

    def note_scaled(self, now: float) -> None:
        """Stamp the cooldown clock (the gateway calls this after any
        applied OR failed scale — both must back off)."""
        self._last_scaled = now
        self._dwell = {DIRECTION_UP: 0, DIRECTION_DOWN: 0}

    def evaluate(self, *, n_replicas: int, fleet_queue_depth: int,
                 ttft_p99_ms: float, now: float) -> Optional[dict]:
        """One observation -> a decision dict (direction/reason/outcome)
        or None when the fleet is in band. ``outcome`` is None for an
        actionable decision (the gateway applies it and fills the
        outcome); dwell/cooldown/clamp skips come back pre-outcome'd,
        observable but not actionable."""
        p = self.policy
        per_replica = fleet_queue_depth / max(n_replicas, 1)
        want = None
        reason = ""
        if per_replica > p.queue_high_water:
            want = DIRECTION_UP
            reason = (f"queue depth {fleet_queue_depth} = "
                      f"{per_replica:.1f}/replica > high water "
                      f"{p.queue_high_water}")
        elif p.ttft_p99_target_ms > 0 and ttft_p99_ms > p.ttft_p99_target_ms:
            want = DIRECTION_UP
            reason = (f"ttft p99 {ttft_p99_ms:.0f}ms > target "
                      f"{p.ttft_p99_target_ms:.0f}ms")
        elif per_replica < p.queue_low_water and n_replicas > p.min_replicas:
            want = DIRECTION_DOWN
            reason = (f"queue depth {fleet_queue_depth} = "
                      f"{per_replica:.1f}/replica < low water "
                      f"{p.queue_low_water}")
        for d in DIRECTIONS:
            if d != want:
                self._dwell[d] = 0
        if want is None:
            return None
        decision = {"direction": want, "reason": reason, "outcome": None}
        if want == DIRECTION_UP and n_replicas >= p.max_replicas:
            return {**decision, "outcome": OUTCOME_CLAMPED,
                    "detail": f"already at max_replicas={p.max_replicas}"}
        if want == DIRECTION_DOWN and n_replicas <= p.min_replicas:
            # The band check above already guards this; kept for belt
            # and braces when min_replicas changes at runtime.
            return {**decision, "outcome": OUTCOME_CLAMPED,
                    "detail": f"already at min_replicas={p.min_replicas}"}
        self._dwell[want] += 1
        if self._dwell[want] < p.dwell_ticks:
            return {**decision, "outcome": OUTCOME_DWELL,
                    "detail": (f"signal held {self._dwell[want]}/"
                               f"{p.dwell_ticks} ticks")}
        if now - self._last_scaled < p.cooldown_seconds:
            return {**decision, "outcome": OUTCOME_COOLDOWN,
                    "detail": (f"{now - self._last_scaled:.0f}s since "
                               f"last scale < cooldown "
                               f"{p.cooldown_seconds:.0f}s")}
        return decision
