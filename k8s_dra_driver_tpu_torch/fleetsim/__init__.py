"""Deterministic fleet soak simulator: the production acceptance
harness (see ROADMAP's chaos-first north star).

One shared virtual clock drives the REAL gateway, admission,
autoscaler, rebalancer, allocator, elastic resize, defrag execution,
and state auditor together through a scripted day of diurnal traffic
and chaos, gates the outcome on typed SLOs, and emits the
``FLEET_r*.json`` artifact — byte-reproducible for a given seed.

Entry points: ``smoke_scenario()``/``mini_scenario()`` build a
:class:`ScenarioSpec`; ``FleetSim(spec).run()`` returns the gated
report; ``write_artifact`` serializes it. The port's copy runs the
same soak on the same TPU fakes and scripted engines (the soak runs no
model), so its artifact is byte-identical to the reference's for a seed;
``chip_smoke.py`` replays the mini profile on the card's host.
"""

from .cluster import FleetCluster
from .harness import (
    ARTIFACT_SCHEMA,
    GATES,
    REQUEST_OUTCOMES,
    FleetSim,
    write_artifact,
)
from .scenario import (
    ChaosEvent,
    FlashCrowd,
    ScenarioSpec,
    TrafficClass,
    build_class_prompts,
    mini_scenario,
    poisson_draw,
    smoke_scenario,
)

__all__ = [
    "ARTIFACT_SCHEMA",
    "GATES",
    "REQUEST_OUTCOMES",
    "ChaosEvent",
    "FlashCrowd",
    "FleetCluster",
    "FleetSim",
    "ScenarioSpec",
    "TrafficClass",
    "build_class_prompts",
    "mini_scenario",
    "poisson_draw",
    "smoke_scenario",
    "write_artifact",
]
