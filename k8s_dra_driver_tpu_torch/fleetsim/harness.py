"""The fleet soak harness: one virtual clock, every closed loop closed.

:class:`FleetSim` runs a :class:`~.scenario.ScenarioSpec` against a
:class:`~.cluster.FleetCluster` as a discrete-event simulation: each
iteration advances the shared virtual clock by ``tick_s``, fires due
chaos events, draws seeded Poisson arrivals per tenant class, ticks the
REAL gateway (admission → routing → engines → autoscaler), and every
``driver_tick_every_s`` drives the REAL plugin loop
(``Driver.tick_once``: health transitions → republish → elastic resize
→ rebalancer → defrag execution → audit). No threads, no sleeps, no
wall-clock reads anywhere on the simulated path — the same seed replays
the same soak byte-for-byte.

Loss accounting is CLASSIFIED, never inferred: every submission is
tracked to a typed terminal outcome — served, shed at the door
(``OverloadedError`` watermark), expired in queue (``OverloadedError``
deadline), retried after a typed ``ReplicaLostError`` (the harness
plays the client's retry loop, capped), lost after exhausting retries,
or unclassified (any other error). The zero-admitted-loss gate requires
the last three buckets to be zero; a request the gateway dropped
silently would land in ``unclassified`` and fail the run loudly.

The run report doubles as the ``FLEET_r*.json`` artifact body
(``write_artifact``): deterministic fields only, ``sort_keys`` JSON.
The ``tpu_dra_fleet_*`` metric family mirrors it on the harness's
registry (explicit zeros for every enum cell, per the TPM04 discipline)
so scrapes see fleet results the way dashboards expect them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import random
import tempfile
from typing import Optional

from ..kube.errors import ApiError
from ..serving_gateway import OverloadedError
from ..serving_gateway.gateway import (
    REPLICA_DRAINING,
    REPLICA_HEALTHY,
    ReplicaLostError,
)
from ..utils import faults
from ..utils.metrics import Counter, Gauge, Registry
from .cluster import BURST_GANG_UID, NODE_NAME, FleetCluster, chip_claim
from .scenario import ScenarioSpec, build_class_prompts, poisson_draw

logger = logging.getLogger(__name__)

ARTIFACT_SCHEMA = "tpu-dra-fleet-v1"

# Terminal request outcomes (tpu_dra_fleet_requests_total's outcome
# label). "lost" (retry cap exhausted) and "unclassified" (untyped
# failure) are the zero-gated admitted-loss buckets.
REQUEST_OUTCOMES = (
    "served",
    "shed-watermark",
    "expired-deadline",
    "retried",
    "lost",
    "unclassified",
)

# Gated SLOs (tpu_dra_fleet_gate_failures_total's gate label; one row
# per gate in docs/operations.md's fleet-soak runbook).
GATES = (
    "admitted-loss",
    "auditor-silence",
    "gang-admitted",
    "p99-realtime",
    "p99-interactive",
    "p99-batch",
    "autoscaler-efficiency",
    "rebalancer-min-floor",
    "kv-hit-rate",
)

SLO_SIGNALS = ("ttft", "e2e")

# End-of-soak drain bound: generous (the backlog after the flash crowd
# plus every retry must finish), but finite so a wedged fleet fails the
# run instead of spinning forever.
MAX_DRAIN_TICKS = 20000


@dataclasses.dataclass
class _Tracked:
    """One admitted request the harness-as-client is waiting on."""

    req: object
    latency_class: str
    retries: int = 0


class FleetSim:
    """See module docstring. ``registry`` receives the
    ``tpu_dra_fleet_*`` family only; the cluster's component families
    live on the cluster's own registry so a host process can embed a
    mini-soak without metric-name collisions."""

    def __init__(self, spec: ScenarioSpec,
                 registry: Optional[Registry] = None):
        self.spec = spec
        self.registry = registry if registry is not None else Registry()
        self._m_ticks = Counter(
            "tpu_dra_fleet_ticks_total",
            "Virtual gateway ticks driven by the fleet soak",
            self.registry,
        )
        self._m_requests = Counter(
            "tpu_dra_fleet_requests_total",
            "Soak requests by tenant class and classified terminal "
            "outcome (lost/unclassified are the zero-gated buckets)",
            self.registry,
        )
        self._m_p99 = Gauge(
            "tpu_dra_fleet_slo_p99_seconds",
            "Per-class p99 latencies (virtual seconds) from the soak's "
            "fleet_slo_summary",
            self.registry,
        )
        self._m_chip_seconds = Gauge(
            "tpu_dra_fleet_chip_seconds",
            "Serving chip-seconds consumed, actual schedule vs the "
            "oracle computed from the known arrival curve",
            self.registry,
        )
        self._m_efficiency = Gauge(
            "tpu_dra_fleet_autoscaler_efficiency_ratio",
            "Oracle chip-seconds / actual chip-seconds (1.0 = the "
            "autoscaler matched the clairvoyant schedule)",
            self.registry,
        )
        self._m_audit_findings = Counter(
            "tpu_dra_fleet_audit_findings_total",
            "StateAuditor findings across every soak tick (gated to "
            "zero)",
            self.registry,
        )
        self._m_gate_failures = Counter(
            "tpu_dra_fleet_gate_failures_total",
            "Fleet soak gate failures, by gate",
            self.registry,
        )

    # -- the soak ----------------------------------------------------------

    def run(self) -> dict:
        spec = self.spec
        with tempfile.TemporaryDirectory(prefix="fleetsim-") as tmp:
            cluster = FleetCluster(spec, tmp)
            return self._drive(cluster)

    def _drive(self, cluster: FleetCluster) -> dict:
        spec = self.spec
        gw = cluster.gateway
        arrival_rng = random.Random(spec.seed)
        prompts = build_class_prompts(spec)
        flash_cls = spec.class_named(spec.flash.latency_class)

        pending: dict[int, _Tracked] = {}
        stats = {(c.name, o): 0
                 for c in spec.classes for o in REQUEST_OUTCOMES}
        events = spec.events_abs()
        next_event = 0
        blackout_plan = None
        chaos_log: list[dict] = []
        audit_passes = 0
        audit_findings = 0
        actual_chip_s = 0.0
        oracle_chip_s = 0.0
        failovers = 0
        lost_in_flight = 0
        gang_state: dict = {"arrived": False, "unsatReason": None}

        driver_every = max(1, round(spec.driver_tick_every_s / spec.tick_s))
        n_ticks = int(round(spec.duration_s / spec.tick_s))

        def classify(tr: _Tracked) -> None:
            """Route one finished tracked request to its typed bucket;
            retryable losses resubmit through normal admission until the
            cap."""
            req = tr.req
            if req.state == "finished":
                stats[(tr.latency_class, "served")] += 1
                return
            err = req.error
            if isinstance(err, ReplicaLostError):
                stats[(tr.latency_class, "retried")] += 1
                if tr.retries >= spec.retry_cap:
                    stats[(tr.latency_class, "lost")] += 1
                    return
                try:
                    again = gw.resubmit(req)
                except OverloadedError:
                    stats[(tr.latency_class, "shed-watermark")] += 1
                    return
                pending[again.gid] = _Tracked(
                    again, tr.latency_class, retries=tr.retries + 1
                )
                return
            if isinstance(err, OverloadedError) and err.reason == "deadline":
                stats[(tr.latency_class, "expired-deadline")] += 1
                return
            stats[(tr.latency_class, "unclassified")] += 1
            logger.error("unclassified request loss: %r", err)

        def submit(cls, system_idx: int) -> None:
            prompt = prompts[cls.name][system_idx] + [
                arrival_rng.randrange(spec.vocab)
                for _ in range(cls.tail_len)
            ]
            try:
                req = gw.submit(prompt, cls.max_new_tokens,
                                latency_class=cls.name)
            except OverloadedError:
                stats[(cls.name, "shed-watermark")] += 1
                return
            pending[req.gid] = _Tracked(req, cls.name)

        def fire(event) -> None:
            nonlocal blackout_plan, failovers, lost_in_flight
            t = cluster.clock()
            entry = {"atS": round(t, 6), "kind": event.kind,
                     "chip": event.chip}
            if event.kind == "gang-arrive":
                from ..kube.allocator import AllocationError

                gang_state["arrived"] = True
                try:
                    cluster.allocator.allocate(
                        chip_claim(BURST_GANG_UID, 2), node_name=NODE_NAME,
                    )
                    gang_state["unsatReason"] = "admitted-immediately"
                except AllocationError as e:
                    gang_state["unsatReason"] = e.reason
                entry["unsatReason"] = gang_state["unsatReason"]
            elif event.kind == "chip-unplug":
                cluster.chiplib.unplug_chip(
                    event.chip, reason="fleet-soak chaos"
                )
                replica = cluster.replica_on_chip(event.chip)
                if replica is not None:
                    lost = gw.fail_replica(
                        replica.replica_id, reason="chip unplugged"
                    )
                    cluster.release_claim(replica.claim_uid)
                    failovers += 1
                    lost_in_flight += lost
                    entry["failedReplica"] = replica.replica_id
                    entry["lostInFlight"] = lost
            elif event.kind == "chip-restore":
                cluster.chiplib.restore_chip(event.chip)
            elif event.kind == "flap-start":
                cluster.chiplib.set_flap(event.chip, period=2)
            elif event.kind == "flap-stop":
                cluster.chiplib.restore_chip(event.chip)
            elif event.kind == "blackout-start":
                blackout_plan = faults.FaultPlan()
                for verb in ("get", "list", "create", "update", "delete"):
                    blackout_plan.fail(
                        f"kube.{verb}",
                        ApiError("fleet-soak apiserver blackout"),
                    )
                faults.REGISTRY.arm(blackout_plan)
            elif event.kind == "blackout-end":
                faults.REGISTRY.disarm()
                blackout_plan = None
            else:
                raise ValueError(f"unknown chaos kind {event.kind!r}")
            chaos_log.append(entry)

        def drive_tick(i: int, arrivals: bool) -> None:
            nonlocal next_event, audit_passes, audit_findings
            nonlocal actual_chip_s, oracle_chip_s
            t = i * spec.tick_s
            cluster.clock_box[0] = t
            while next_event < len(events) and events[next_event][0] <= t:
                fire(events[next_event][1])
                next_event += 1
            if arrivals:
                for cls in spec.classes:
                    lam = spec.rate(cls, t) * spec.tick_s
                    for _ in range(poisson_draw(arrival_rng, lam)):
                        submit(cls, arrival_rng.randrange(cls.n_systems))
                lam = spec.flash_rate(t) * spec.tick_s
                for _ in range(poisson_draw(arrival_rng, lam)):
                    submit(flash_cls, spec.flash.system)
            gw.tick()
            self._m_ticks.inc()
            for gid, tr in list(pending.items()):
                if tr.req.done:
                    del pending[gid]
                    classify(tr)
            chips_held = sum(
                1 for r in gw.router.replicas()
                if r.state in (REPLICA_HEALTHY, REPLICA_DRAINING)
            )
            actual_chip_s += chips_held * spec.tick_s
            oracle_chip_s += spec.oracle_replicas(min(t, spec.duration_s)) \
                * spec.tick_s
            if i % driver_every == 0:
                report = cluster.driver.tick_once(now=t)
                audit_passes += 1
                found = report.get("auditFindings")
                audit_findings += abs(found) if found else 0

        drained_ticks = 0
        try:
            for i in range(n_ticks):
                drive_tick(i, arrivals=True)
            # Wind-down: no new arrivals; every admitted request must
            # reach a typed terminal state before the books close.
            while pending and drained_ticks < MAX_DRAIN_TICKS:
                drive_tick(n_ticks + drained_ticks, arrivals=False)
                drained_ticks += 1
        finally:
            if blackout_plan is not None:
                faults.REGISTRY.disarm()

        # Anything still pending after the drain bound is admitted loss.
        for gid, tr in list(pending.items()):
            stats[(tr.latency_class, "lost")] += 1
            del pending[gid]

        return self._report(
            cluster, stats,
            chaos_log=chaos_log,
            gang_state=gang_state,
            audit_passes=audit_passes,
            audit_findings=audit_findings,
            actual_chip_s=actual_chip_s,
            oracle_chip_s=oracle_chip_s,
            failovers=failovers,
            lost_in_flight=lost_in_flight,
            drained_ticks=drained_ticks,
        )

    # -- reporting ---------------------------------------------------------

    def _report(self, cluster: FleetCluster, stats: dict, *, chaos_log,
                gang_state, audit_passes, audit_findings, actual_chip_s,
                oracle_chip_s, failovers, lost_in_flight,
                drained_ticks) -> dict:
        spec = self.spec
        gw = cluster.gateway

        summary = cluster.telemetry.fleet_slo_summary()
        efficiency = (
            oracle_chip_s / actual_chip_s if actual_chip_s else 0.0
        )
        gang_devices = cluster.claim_devices(BURST_GANG_UID)
        executions = cluster.executor.export_executions()
        plans = cluster.planner.recent_plans()
        last_plan = plans[-1] if plans else None
        reb = cluster.driver.rebalancer.snapshot()
        below_min_s = sum(
            c.get("belowMinSeconds", 0.0)
            for c in reb.get("claims", {}).values()
        )

        # Two independent KV rollups for the kv-hit-rate gate: the
        # gateway's measured ResidencyIndex vs a direct walk of every
        # engine's own counters.
        residency = gw.residency.snapshot()
        prefix_rollup = self._prefix_cache_rollup(cluster)

        loss = {"submitted": 0}
        for (cls_name, outcome), n in sorted(stats.items()):
            loss.setdefault(outcome, 0)
            loss[outcome] += n
            if outcome in ("served", "shed-watermark", "expired-deadline",
                           "lost", "unclassified"):
                loss["submitted"] += n

        gates = {
            "admitted-loss": {
                "pass": (loss.get("lost", 0) == 0
                         and loss.get("unclassified", 0) == 0
                         and loss.get("expired-deadline", 0) == 0),
                "value": (loss.get("lost", 0) + loss.get("unclassified", 0)
                          + loss.get("expired-deadline", 0)),
                "budget": 0,
            },
            "auditor-silence": {
                "pass": audit_findings == 0 and audit_passes > 0,
                "value": audit_findings,
                "budget": 0,
            },
            "gang-admitted": {
                "pass": (len(gang_devices) == 2
                         and gang_state["unsatReason"] == "gang"
                         and any(e.get("state") == "completed"
                                 for e in executions)),
                "value": len(gang_devices),
                "budget": 2,
            },
            "autoscaler-efficiency": {
                "pass": efficiency >= spec.efficiency_floor,
                "value": round(efficiency, 6),
                "budget": spec.efficiency_floor,
            },
            "rebalancer-min-floor": {
                "pass": below_min_s == 0.0,
                "value": round(below_min_s, 6),
                "budget": 0,
            },
            # Measured, not predicted: the ResidencyIndex aggregation
            # must agree with a direct walk of the engines' own hit
            # counters (two independent rollup paths), and the agreed
            # number must clear the scenario floor.
            "kv-hit-rate": {
                "pass": (residency["fleet"]["hits"]
                         == prefix_rollup["hits"]
                         and residency["fleet"]["measuredHitRate"]
                         >= spec.min_fleet_hit_rate),
                "value": {
                    "measuredHitRate":
                        residency["fleet"]["measuredHitRate"],
                    "measuredHits": residency["fleet"]["hits"],
                    "engineHits": prefix_rollup["hits"],
                },
                "budget": {
                    "measuredHitRate": spec.min_fleet_hit_rate,
                    "agreement": "measuredHits == engineHits",
                },
            },
        }
        for name, ttft_budget, e2e_budget in spec.p99_budgets:
            cls_summary = summary["classes"].get(name, {})
            ttft = cls_summary.get("ttftP99S", 0.0)
            e2e = cls_summary.get("e2eP99S", 0.0)
            gates[f"p99-{name}"] = {
                "pass": ttft <= ttft_budget and e2e <= e2e_budget,
                "value": {"ttftP99S": ttft, "e2eP99S": e2e},
                "budget": {"ttftP99S": ttft_budget, "e2eP99S": e2e_budget},
            }

        report = {
            "schema": ARTIFACT_SCHEMA,
            "scenario": {
                "name": spec.name,
                "seed": spec.seed,
                "durationS": spec.duration_s,
                "tickS": spec.tick_s,
                "topology": spec.topology,
                "classes": [c.name for c in spec.classes],
            },
            "pass": all(g["pass"] for g in gates.values()),
            "gates": gates,
            "loss": loss,
            "lossByClass": {
                cls.name: {
                    o: stats[(cls.name, o)] for o in REQUEST_OUTCOMES
                } for cls in spec.classes
            },
            "slo": summary,
            "autoscaler": {
                "actualChipSeconds": round(actual_chip_s, 6),
                "oracleChipSeconds": round(oracle_chip_s, 6),
                "efficiency": round(efficiency, 6),
                "scale": {
                    k: v for k, v in sorted(gw.counters.items())
                    if k.startswith("scale_")
                },
            },
            "rebalancer": {
                "belowMinSeconds": round(below_min_s, 6),
                "decisions": reb.get("decisions", {}),
            },
            "defrag": {
                "plan": {
                    "planId": last_plan.get("planId"),
                    "outcome": last_plan.get("outcome"),
                    "box": last_plan.get("box"),
                    "migrations": [
                        {"claimUid": m["claimUid"],
                         "devices": m["devices"], "to": m["to"]}
                        for m in last_plan.get("migrations", [])
                    ],
                } if last_plan else None,
                "executions": [
                    {"planId": e.get("planId"), "state": e.get("state")}
                    for e in executions
                ],
                "gangDevices": gang_devices,
                "unsatReason": gang_state["unsatReason"],
            },
            "elastic": [
                {k: v for k, v in r.to_dict().items() if k != "at"}
                for r in cluster.resizes
            ],
            "audit": {
                "passes": audit_passes,
                "findings": audit_findings,
            },
            "chaos": {
                "timeline": chaos_log,
                "failovers": failovers,
                "lostInFlight": lost_in_flight,
                "sliceSyncErrors": cluster.slice_controller.sync_errors,
                "drainedTicks": drained_ticks,
            },
            "prefixCache": prefix_rollup,
            # Post-drain measured residency: fleet duplication ratio
            # plus, per surviving replica, the measured digest counters
            # and the predicted-vs-measured ledger divergence.
            "kvResidency": {
                "fleet": residency["fleet"],
                "replicas": {
                    rid: {
                        "indexedBlocks": rep["indexedBlocks"],
                        "evictedBlocks": rep["evictedBlocks"],
                        "measuredKeys": rep["measuredKeys"],
                        "counterDrift": rep["counterDrift"],
                        "ledger": rep["ledger"],
                    }
                    for rid, rep in sorted(residency["replicas"].items())
                },
            },
            "counters": dict(sorted(gw.counters.items())),
        }
        self._publish_metrics(report, stats, summary)
        return report

    def _prefix_cache_rollup(self, cluster: FleetCluster) -> dict:
        lookups = hits = hit_tokens = 0
        for r in cluster.gateway.router.replicas():
            snap = r.engine.snapshot()
            lookups += snap["prefixLookups"]
            hits += snap["prefixHits"]
            hit_tokens += snap["prefixHitTokens"]
        return {
            "lookups": lookups,
            "hits": hits,
            "hitTokens": hit_tokens,
            "hitRate": round(hits / lookups, 6) if lookups else 0.0,
        }

    def _publish_metrics(self, report, stats, summary) -> None:
        for (cls_name, outcome), n in sorted(stats.items()):
            self._m_requests.inc(n, latency_class=cls_name,
                                 outcome=outcome)
        for name, cls_summary in sorted(summary["classes"].items()):
            for signal in SLO_SIGNALS:
                self._m_p99.set(
                    cls_summary.get(f"{signal}P99S", 0.0),
                    latency_class=name, signal=signal,
                )
        auto = report["autoscaler"]
        self._m_chip_seconds.set(auto["actualChipSeconds"],
                                 schedule="actual")
        self._m_chip_seconds.set(auto["oracleChipSeconds"],
                                 schedule="oracle")
        self._m_efficiency.set(auto["efficiency"])
        self._m_audit_findings.inc(report["audit"]["findings"])
        for gate in GATES:
            failed = not report["gates"][gate]["pass"]
            self._m_gate_failures.inc(1.0 if failed else 0.0, gate=gate)


def write_artifact(report: dict, path: str,
                   wall_clock: Optional[dict] = None) -> None:
    """Write the FLEET_r*.json artifact: the deterministic report plus
    an optional ``wallClock`` section — the ONE nondeterministic key,
    excluded by the byte-identity tests."""
    doc = dict(report)
    if wall_clock is not None:
        doc["wallClock"] = wall_clock
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
