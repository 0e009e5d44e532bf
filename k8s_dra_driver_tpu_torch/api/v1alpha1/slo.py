"""Per-claim SLO declarations for dynamically shared chips.

The sharing API (sharing.py) describes a claim's STATIC grant: how many
processes, what HBM budget, what TensorCore percentage. This module adds
the claim's *intent* — the contract the dynamic-sharing rebalancer
(plugin/rebalancer.py) closes the loop on, following MISO's
profile-then-repartition model and SGDRC's software-defined dynamic
resource control (PAPERS.md):

- **latency class**: how long the claim tolerates running below its
  minimum share before that counts as an SLO violation. ``realtime``
  tenants get seconds, ``batch`` tenants minutes — the grace window the
  doctor's ``slo`` check and ``tpu_dra_slo_violations_total`` key on.
- **min/burst shares**: the floor the rebalancer must never take the
  claim below, and the ceiling it may grow the claim to when co-tenants
  are idle. Declared per resource (TensorCore percentage, HBM
  percentage of the chip) so compute and memory can move independently.
- **priority**: tie-breaker when two needy tenants contend for the same
  idle share (higher wins; donors are picked lowest-priority-first).

Wire form rides inside ``processSharedConfig`` (the only sharing mode
with per-claim limits to rebalance)::

    "processSharedConfig": {
      "maxProcesses": 2,
      "defaultActiveCorePercentage": 30,
      "defaultHbmLimit": "4Gi",
      "slo": {
        "latencyClass": "realtime",
        "minTensorCorePercent": 30, "burstTensorCorePercent": 80,
        "minHbmPercent": 25, "burstHbmPercent": 75,
        "priority": 10
      }
    }

Same contract as every config type here: ``from_dict`` is strict,
``normalize()`` then ``validate()``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Latency class -> grace seconds: how long a claim may sit below its
# declared minimum share before the condition is an SLO violation.
REALTIME_CLASS = "realtime"
INTERACTIVE_CLASS = "interactive"
BATCH_CLASS = "batch"

LATENCY_CLASSES = {
    REALTIME_CLASS: 5.0,
    INTERACTIVE_CLASS: 60.0,
    BATCH_CLASS: 600.0,
}

DEFAULT_LATENCY_CLASS = BATCH_CLASS


@dataclasses.dataclass
class SloConfig:
    """A claim's dynamic-sharing contract (see module docstring)."""

    latency_class: str = DEFAULT_LATENCY_CLASS
    min_tensorcore_percent: Optional[int] = None
    burst_tensorcore_percent: Optional[int] = None
    min_hbm_percent: Optional[int] = None
    burst_hbm_percent: Optional[int] = None
    priority: int = 0

    FIELDS = {
        "latencyClass": "latency_class",
        "minTensorCorePercent": "min_tensorcore_percent",
        "burstTensorCorePercent": "burst_tensorcore_percent",
        "minHbmPercent": "min_hbm_percent",
        "burstHbmPercent": "burst_hbm_percent",
        "priority": "priority",
    }

    @classmethod
    def from_dict(cls, d: dict) -> "SloConfig":
        unknown = set(d) - set(cls.FIELDS)
        if unknown:
            raise ValueError(f"unknown field(s) in slo: {sorted(unknown)}")
        kwargs = {
            attr: d[wire] for wire, attr in cls.FIELDS.items() if wire in d
        }
        return cls(**kwargs)

    def to_dict(self) -> dict:
        out: dict = {"latencyClass": self.latency_class}
        for wire, attr in self.FIELDS.items():
            if wire == "latencyClass":
                continue
            val = getattr(self, attr)
            if wire == "priority":
                if val:
                    out[wire] = val
            elif val is not None:
                out[wire] = val
        return out

    def normalize(self) -> None:
        if not self.latency_class:
            self.latency_class = DEFAULT_LATENCY_CLASS
        # A declared min without a burst may still burst to the whole
        # chip. (The converse — burst without a min — is rejected by
        # validate(): the rebalancer arbitrates around the min floor,
        # so a floorless burst would silently never participate.)
        if (self.min_tensorcore_percent is not None
                and self.burst_tensorcore_percent is None):
            self.burst_tensorcore_percent = 100
        if (self.min_hbm_percent is not None
                and self.burst_hbm_percent is None):
            self.burst_hbm_percent = 100

    def validate(self) -> None:
        if self.latency_class not in LATENCY_CLASSES:
            raise ValueError(
                f"unknown latencyClass: {self.latency_class!r} "
                f"(want one of {sorted(LATENCY_CLASSES)})"
            )
        for name, lo, hi in (
            ("minTensorCorePercent", self.min_tensorcore_percent,
             self.burst_tensorcore_percent),
            ("minHbmPercent", self.min_hbm_percent, self.burst_hbm_percent),
        ):
            for label, val in ((name, lo), (name.replace("min", "burst", 1),
                                            hi)):
                if val is None:
                    continue
                if not isinstance(val, int) or not (0 < val <= 100):
                    raise ValueError(
                        f"{label} must be an integer in (0, 100], got "
                        f"{val!r}"
                    )
            if lo is not None and hi is not None and lo > hi:
                raise ValueError(
                    f"{name}={lo} exceeds its burst ceiling {hi}"
                )
            if hi is not None and lo is None:
                # The rebalancer arbitrates around the min floor; a
                # burst with no floor would never participate — an
                # inert SLO is a config bug, not a default.
                raise ValueError(
                    f"{name.replace('min', 'burst', 1)} declared "
                    f"without {name}: a burst needs a min floor"
                )
        if not isinstance(self.priority, int):
            raise ValueError(
                f"priority must be an integer, got {self.priority!r}"
            )

    def grace_seconds(self) -> float:
        """How long below-min is tolerable for this latency class."""
        return LATENCY_CLASSES[self.latency_class]
