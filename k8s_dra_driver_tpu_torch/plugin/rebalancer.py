"""SLO-aware dynamic sharing: the closed loop from usage to shares.

The ``UsageAccountant`` measures per-chip occupancy by sharing mode;
the sharing shim enforces per-claim limits; nothing *acted* on either —
partitions and limits were frozen at prepare time. This module is the
missing controller, after MISO's profile-then-repartition loop and
SGDRC's software-defined dynamic resource control for concurrent
inference (PAPERS.md): observe what each co-tenant of a chip actually
uses, compare against its declared SLO (api/v1alpha1/slo.py), and move
TensorCore/HBM shares between tenants — hitlessly, through the
two-phase ``DeviceState.resize_claim_limits`` protocol and the
generation-stamped limits file the workload shim re-applies at a safe
step boundary. Idle shares flow to the tenant that needs them and flow
back under pressure, without restarting anyone.

The pieces:

- **demand**: workload processes publish their recent utilization via
  ``parallel.shim.report_usage`` (a ``usage-slot-N.json`` beside their
  slot lock); :class:`FileDemandSource` aggregates the fresh samples
  per claim. Tests inject demand directly.
- **policy** (:class:`MisoPolicy`): *steal idle, respect min, return on
  pressure* — one bounded move per resource per co-tenant group per
  tick, donors never pushed below their declared min, gainers never
  above their burst, with a busy-band **hysteresis** (a move needs a
  hungry tenant above the high-water mark AND a donor below the
  low-water mark, and must shift at least ``hysteresis_percent``) and a
  per-claim **cool-down** so oscillating load cannot flap shares.
  Restoring a claim to its declared min bypasses both (an SLO floor is
  not negotiable on a timer).
- **apply**: ``DeviceState.resize_claim_limits`` — checkpointed
  intent → session re-render → finalize, crash-consistent, audited by
  the ``sharing-limits`` check.
- **observability**: every decision (applied, failed, or skipped and
  why) lands in a ring buffer served at ``/debug/rebalance``; the
  ``tpu_dra_slo_*`` metric families track decisions by outcome/action,
  per-claim granted-vs-min shares, rebalance latency, and SLO
  violations (a claim below its min longer than its latency class
  tolerates); ``SharesRebalanced``/``SloViolation`` Events are deduped
  by the recorder.

The loop is ticked from the driver's device-watch thread
(``Driver._device_watch_loop`` → :meth:`Rebalancer.maybe_tick`), so it
needs no thread of its own and pauses exactly when the node's inventory
machinery does.

The port's copy of the reference module.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
import time
from typing import Any, Callable, Optional

from ..api.v1alpha1 import SloConfig, parse_quantity, to_mebibytes_string
from ..kube.events import EventRecorder, ObjectRef
from ..utils.metrics import Counter, Gauge, Histogram, Registry
from .device_state import DeviceState, LimitResizeError

logger = logging.getLogger(__name__)

# Decision outcomes (stable label values; /debug/rebalance contract).
OUTCOME_APPLIED = "applied"
OUTCOME_FAILED = "failed"
OUTCOME_COOLDOWN = "cooldown"
OUTCOME_HYSTERESIS = "hysteresis"
OUTCOMES = (OUTCOME_APPLIED, OUTCOME_FAILED, OUTCOME_COOLDOWN,
            OUTCOME_HYSTERESIS)

# Decision actions.
ACTION_STEAL_IDLE = "steal-idle"
ACTION_RETURN = "return-on-pressure"
ACTION_RESTORE_MIN = "restore-min"
ACTIONS = (ACTION_STEAL_IDLE, ACTION_RETURN, ACTION_RESTORE_MIN)

RESOURCES = ("tensorcore", "hbm")

RING_DEPTH = 256


@dataclasses.dataclass
class ClaimShareView:
    """One ProcessShared claim as the rebalancer sees it: identity,
    chips, granted shares (percent of chip), and the declared SLO."""

    claim_uid: str
    namespace: str
    name: str
    chips: tuple[str, ...]          # governing chip uuids, sorted
    chip_hbm_bytes: int             # smallest chip's HBM (the env floor)
    slo: SloConfig
    granted: dict[str, Optional[int]]   # resource -> percent (None=uncapped)
    # The EXACT checkpointed limit values ("tensorcore" -> percent int,
    # "hbm" -> quantity string, None = uncapped): what a restore must
    # replay — the rounded percent view above is for arithmetic only.
    raw_limits: dict[str, Any] = dataclasses.field(default_factory=dict)
    generation: int = 1

    def min_share(self, resource: str) -> Optional[int]:
        return (self.slo.min_tensorcore_percent if resource == "tensorcore"
                else self.slo.min_hbm_percent)

    def burst_share(self, resource: str) -> Optional[int]:
        return (self.slo.burst_tensorcore_percent
                if resource == "tensorcore"
                else self.slo.burst_hbm_percent)


class FileDemandSource:
    """Per-claim demand from the usage files workload processes publish
    (``parallel.shim.report_usage``): the max ``busy`` fraction across
    the claim's fresh slot samples — any hungry process means the claim
    wants more. Stale samples (older than ``staleness_seconds``) are
    ignored; a claim with no fresh sample yields None (unknown demand:
    never a donor, never needy)."""

    def __init__(self, run_dir: str, staleness_seconds: float = 120.0,
                 clock: Callable[[], float] = time.time):
        self.run_dir = run_dir
        self.staleness = staleness_seconds
        self._clock = clock

    def __call__(self, view: ClaimShareView) -> Optional[dict]:
        import json

        try:
            session_dirs = [
                os.path.join(self.run_dir, e)
                for e in os.listdir(self.run_dir)
                if e.startswith(view.claim_uid)
            ]
        except OSError:
            return None
        now = self._clock()
        busy: list[float] = []
        hbm: list[float] = []
        for d in session_dirs:
            try:
                entries = os.listdir(d)
            except OSError:
                continue
            for e in entries:
                if not (e.startswith("usage-slot-")
                        and e.endswith(".json")):
                    continue
                try:
                    with open(os.path.join(d, e)) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue
                if now - float(doc.get("ts", 0.0)) > self.staleness:
                    continue
                busy.append(float(doc.get("busy", 0.0)))
                if doc.get("hbm") is not None:
                    hbm.append(float(doc["hbm"]))
        if not busy:
            return None
        out: dict = {"busy": max(busy)}
        if hbm:
            out["hbm"] = max(hbm)
        return out


@dataclasses.dataclass
class MisoPolicy:
    """Steal idle, respect min, return on pressure — with hysteresis and
    a cool-down so the loop never flaps (the operator knobs the
    docs/operations.md runbook names)."""

    high_water: float = 0.85        # busy >= this -> wants more
    low_water: float = 0.35         # busy <= this -> can donate
    step_percent: int = 10          # max share moved per decision
    hysteresis_percent: int = 5     # moves smaller than this are noise
    cooldown_seconds: float = 60.0  # per-claim floor between moves

    def to_dict(self) -> dict:
        return {
            "highWater": self.high_water,
            "lowWater": self.low_water,
            "stepPercent": self.step_percent,
            "hysteresisPercent": self.hysteresis_percent,
            "cooldownSeconds": self.cooldown_seconds,
        }

    def decide(
        self,
        views: list[ClaimShareView],
        demand: dict[str, Optional[dict]],
        baselines: dict[tuple[str, str], int],
        last_moved: dict[str, float],
        now: float,
    ) -> list[dict]:
        """Proposed moves and recorded skips for one tick.

        ``baselines`` maps (claim_uid, resource) to the share the claim
        held when first observed — a donor giving back share it stole
        earlier is a *return-on-pressure*, a donor dipping below its
        own baseline is being *stolen from*. Groups are co-tenants with
        IDENTICAL chip sets (partial overlaps are not rebalanced — a
        move would change the share on chips the counterparty does not
        touch)."""
        groups: dict[tuple[str, ...], list[ClaimShareView]] = {}
        for v in views:
            groups.setdefault(v.chips, []).append(v)
        decisions: list[dict] = []
        for chips, tenants in sorted(groups.items()):
            if len(tenants) < 2:
                continue
            for resource in RESOURCES:
                d = self._decide_resource(
                    tenants, resource, demand, baselines, last_moved, now
                )
                if d is not None:
                    decisions.append(d)
        return decisions

    @staticmethod
    def _granted(view: ClaimShareView, resource: str) -> Optional[int]:
        g = view.granted.get(resource)
        if g is None and view.min_share(resource) is not None:
            # Uncapped but with a declared floor: effectively the whole
            # chip; a donor candidate.
            return 100
        return g

    def _decide_resource(
        self, tenants, resource, demand, baselines, last_moved, now
    ) -> Optional[dict]:
        # Participants: tenants with a granted share AND an SLO floor
        # for this resource (no floor means no contract to arbitrate).
        parts = []
        for v in tenants:
            if resource == "hbm" and v.chip_hbm_bytes <= 0:
                # Without a known chip size an HBM share can neither be
                # read nor rendered (a computed limit of 0 bytes would
                # just fail validation every tick).
                continue
            g = self._granted(v, resource)
            if g is None or v.min_share(resource) is None:
                continue
            sample = demand.get(v.claim_uid) or {}
            key = "busy" if resource == "tensorcore" else "hbm"
            parts.append((v, g, sample.get(key)))
        if len(parts) < 2:
            return None

        def mk(action, gainer, donor, g_from, d_from, amount, outcome,
               reason):
            return {
                "action": action, "resource": resource,
                "gainer": {"claim": gainer.claim_uid,
                           "from": g_from, "to": g_from + amount},
                "donor": {"claim": donor.claim_uid,
                          "from": d_from, "to": d_from - amount},
                "outcome": outcome, "reason": reason,
            }

        # 1) Restore-min: a claim below its declared floor is an SLO
        # breach in progress — fix it now, cool-down or not.
        below = sorted(
            (p for p in parts if p[1] < p[0].min_share(resource)),
            key=lambda p: -p[0].slo.priority,
        )
        for needy, g, _busy in below:
            deficit = needy.min_share(resource) - g
            donors = sorted(
                (p for p in parts
                 if p[0] is not needy
                 and p[1] > p[0].min_share(resource)),
                key=lambda p: (p[0].slo.priority,
                               -(p[1] - p[0].min_share(resource))),
            )
            for donor, dg, _dbusy in donors:
                headroom = dg - donor.min_share(resource)
                amount = min(deficit, headroom)
                if amount <= 0:
                    continue
                return mk(
                    ACTION_RESTORE_MIN, needy, donor, g, dg, amount,
                    None,
                    f"claim below its declared min {resource} share "
                    f"({g}% < {needy.min_share(resource)}%)",
                )

        # 2) Steal idle / return on pressure: pressure above the high
        # water meets idleness below the low water. The band between
        # the two marks IS the hysteresis — demand wandering inside it
        # moves nothing.
        needy_list = sorted(
            (p for p in parts
             if p[2] is not None and p[2] >= self.high_water
             and p[0].burst_share(resource) is not None
             and p[1] < p[0].burst_share(resource)),
            key=lambda p: (-p[0].slo.priority, -p[2]),
        )
        donor_list = sorted(
            (p for p in parts
             if p[2] is not None and p[2] <= self.low_water
             and p[1] > p[0].min_share(resource)),
            key=lambda p: (p[0].slo.priority, p[2]),
        )
        # A damped (hysteresis/cooldown) pair must not shadow an
        # actionable one further down the donor ranking: keep scanning
        # and only surface the FIRST skip when no pair is actionable.
        skip: Optional[dict] = None
        for needy, g, busy in needy_list:
            for donor, dg, dbusy in donor_list:
                if donor is needy:
                    continue
                amount = min(
                    self.step_percent,
                    needy.burst_share(resource) - g,
                    dg - donor.min_share(resource),
                )
                if amount <= 0:
                    continue
                baseline = baselines.get(
                    (donor.claim_uid, resource), dg
                )
                action = (ACTION_RETURN if dg > baseline
                          else ACTION_STEAL_IDLE)
                reason = (
                    f"{needy.claim_uid} busy {busy:.2f} >= "
                    f"{self.high_water}, {donor.claim_uid} busy "
                    f"{dbusy:.2f} <= {self.low_water}"
                )
                if amount < self.hysteresis_percent:
                    skip = skip or mk(
                        action, needy, donor, g, dg, amount,
                        OUTCOME_HYSTERESIS,
                        reason + f"; move {amount}% below the "
                        f"{self.hysteresis_percent}% hysteresis")
                    continue
                cooling = [
                    uid for uid in (needy.claim_uid, donor.claim_uid)
                    if now - last_moved.get(uid, float("-inf"))
                    < self.cooldown_seconds
                ]
                if cooling:
                    skip = skip or mk(
                        action, needy, donor, g, dg, amount,
                        OUTCOME_COOLDOWN,
                        reason + f"; {cooling} inside the "
                        f"{self.cooldown_seconds:.0f}s cool-down")
                    continue
                return mk(action, needy, donor, g, dg, amount, None,
                          reason)
        return skip


class Rebalancer:
    """The node-side control loop: read demand, decide under the
    policy, apply hitlessly, and narrate everything."""

    def __init__(
        self,
        state: DeviceState,
        registry: Registry,
        node_name: str = "",
        node_uid: str = "",
        events: Optional[EventRecorder] = None,
        policy: Optional[MisoPolicy] = None,
        demand_source: Optional[Callable] = None,
        interval_seconds: float = 60.0,
        clock: Callable[[], float] = time.time,
        api_version: str = "resource.k8s.io/v1beta1",
    ):
        self.state = state
        self.node_name = node_name
        self.node_uid = node_uid
        self.events = events
        self.policy = policy or MisoPolicy()
        self.demand_source = demand_source or FileDemandSource(
            state.ps_manager.run_dir, clock=clock
        )
        self.interval = interval_seconds
        self._clock = clock
        self.api_version = api_version
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=RING_DEPTH
        )
        self._last_tick = float("-inf")
        self._last_moved: dict[str, float] = {}
        self._baselines: dict[tuple[str, str], int] = {}
        self._below_min_since: dict[tuple[str, str], float] = {}
        self._violated: set[tuple[str, str]] = set()
        self._seen_gauge_keys: set[tuple[str, str]] = set()
        self.ticks = 0

        self._m_decisions = Counter(
            "tpu_dra_slo_rebalance_decisions_total",
            "Rebalance decisions by outcome (applied, failed, cooldown, "
            "hysteresis) and action (steal-idle, return-on-pressure, "
            "restore-min)",
            registry,
        )
        self._m_granted = Gauge(
            "tpu_dra_slo_granted_share",
            "Share (percent of chip) currently granted to each "
            "ProcessShared claim with a declared SLO, by resource",
            registry,
        )
        self._m_min = Gauge(
            "tpu_dra_slo_min_share",
            "Share (percent of chip) the claim's SLO declares as its "
            "floor, by resource",
            registry,
        )
        self._m_rebalance_seconds = Histogram(
            "tpu_dra_slo_rebalance_seconds",
            "End-to-end latency of applying one rebalance decision "
            "(both two-phase limit resizes)",
            registry,
        )
        self._m_violations = Counter(
            "tpu_dra_slo_violations_total",
            "SLO violations: a claim stayed below its declared min "
            "share for longer than its latency class tolerates",
            registry,
        )
        # Explicit zeros so dashboards see the family before the first
        # (hopefully never) violation.
        from ..api.v1alpha1 import LATENCY_CLASSES

        for lc in sorted(LATENCY_CLASSES):
            self._m_violations.inc(0.0, latency_class=lc)

    # -- wiring ------------------------------------------------------------

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Run one pass when the interval has elapsed — the driver's
        device-watch loop calls this every wake, so the rebalancer needs
        no thread of its own. No-op (False) while disabled
        (``interval <= 0``) or inside the interval. ``now`` overrides
        the clock for this pacing decision AND the pass itself — the
        fleet soak (fleetsim/) drives the loop on its virtual clock
        through ``Driver.tick_once(now=...)``."""
        if self.interval <= 0:
            return False
        if now is None:
            now = self._clock()
        if now - self._last_tick < self.interval:
            return False
        self.run_once(now=now)
        return True

    # -- one pass ----------------------------------------------------------

    def run_once(self, now: Optional[float] = None) -> list[dict]:
        """One observe→decide→apply pass; returns this tick's decision
        records (also appended to the ring). ``now`` pins the pass to a
        caller-supplied (virtual) time instead of the wall clock."""
        if now is None:
            now = self._clock()
        self._last_tick = now
        self.ticks += 1
        views = self._claim_views()
        demand = {}
        for v in views:
            try:
                demand[v.claim_uid] = self.demand_source(v)
            except Exception:
                logger.exception(
                    "demand source failed for claim %s", v.claim_uid
                )
                demand[v.claim_uid] = None
        for v in views:
            for resource in RESOURCES:
                g = v.granted.get(resource)
                if g is not None:
                    self._baselines.setdefault(
                        (v.claim_uid, resource), g
                    )
        self._track_slo(views, now)
        proposals = self.policy.decide(
            views, demand, self._baselines, self._last_moved, now
        )
        views_by_uid = {v.claim_uid: v for v in views}
        records = []
        for d in proposals:
            if d["outcome"] is not None:
                # A recorded skip (cooldown/hysteresis): observable, not
                # actionable.
                rec = self._record(d, now, demand)
            else:
                rec = self._apply(d, views_by_uid, now, demand)
            records.append(rec)
        if any(r["outcome"] == OUTCOME_APPLIED for r in records):
            # Re-read so the gauges show POST-apply shares, not the
            # tick's opening position.
            views = self._claim_views()
        self._refresh_gauges(views)
        return records

    # -- internals ---------------------------------------------------------

    def _claim_views(self) -> list[ClaimShareView]:
        from ..tpulib.deviceinfo import chip_uuid_of_device_uuid

        try:
            recs = self.state.checkpoint.read()
        except Exception:
            return []
        # Chip sizes from the live map PLUS the base-spec pins: a
        # prepared claim's device may be transiently absent mid-rebind
        # (the case _resolve_claimed_device exists for) and must not be
        # misread as an HBM-uncapped tenant meanwhile.
        chip_hbm: dict[str, int] = {}
        for source in (self.state._base_spec_devices,
                       self.state.allocatable):
            for dev in source.values():
                if dev.chip is not None:
                    chip_hbm[dev.chip.uuid] = dev.chip.hbm_bytes
        views = []
        for uid, rec in sorted(recs.items()):
            if "resize" in rec:
                continue  # mid-protocol: recovery/auditor territory
            try:
                gi = DeviceState._limits_group_index(rec)
            except LimitResizeError:
                continue
            group = rec["groups"][gi]
            psc = (
                ((group.get("config") or {}).get("sharing") or {})
                .get("processSharedConfig") or {}
            )
            slo_dict = psc.get("slo")
            if not slo_dict:
                continue  # no declared SLO: nothing to arbitrate
            try:
                slo = SloConfig.from_dict(slo_dict)
                slo.normalize()
                slo.validate()
            except ValueError:
                logger.warning(
                    "claim %s carries an invalid SLO; skipping", uid
                )
                continue
            chips = tuple(sorted({
                chip_uuid_of_device_uuid(u)
                for d in group.get("devices", [])
                for u in d.get("uuids", [])
            }))
            hbm_bytes = min(
                (chip_hbm[c] for c in chips if c in chip_hbm), default=0
            )
            granted: dict[str, Optional[int]] = {
                "tensorcore": psc.get("defaultActiveCorePercentage"),
                "hbm": None,
            }
            limit = psc.get("defaultHbmLimit")
            if limit and hbm_bytes:
                try:
                    granted["hbm"] = round(
                        parse_quantity(limit) / hbm_bytes * 100
                    )
                except ValueError:
                    pass
            views.append(ClaimShareView(
                claim_uid=uid,
                namespace=rec.get("namespace", ""),
                name=rec.get("name", ""),
                chips=chips,
                chip_hbm_bytes=hbm_bytes,
                slo=slo,
                granted=granted,
                raw_limits={
                    "tensorcore": psc.get("defaultActiveCorePercentage"),
                    "hbm": psc.get("defaultHbmLimit"),
                },
                generation=int(
                    (rec.get("sharing") or {}).get("generation", 1)
                ),
            ))
        return views

    def _track_slo(self, views: list[ClaimShareView], now: float) -> None:
        # Under the lock: snapshot() copies _below_min_since from the
        # metrics HTTP thread while this (watch-thread) pass mutates it.
        live_keys = set()
        for v in views:
            for resource in RESOURCES:
                g = v.granted.get(resource)
                mn = v.min_share(resource)
                key = (v.claim_uid, resource)
                live_keys.add(key)
                if g is None or mn is None or g >= mn:
                    with self._lock:
                        self._below_min_since.pop(key, None)
                    self._violated.discard(key)
                    continue
                with self._lock:
                    since = self._below_min_since.setdefault(key, now)
                if (now - since > v.slo.grace_seconds()
                        and key not in self._violated):
                    self._violated.add(key)
                    self._m_violations.inc(
                        latency_class=v.slo.latency_class
                    )
                    logger.warning(
                        "SLO violation: claim %s below its min %s "
                        "share (%s%% < %s%%) for %.1fs (class %s "
                        "allows %.1fs)",
                        v.claim_uid, resource, g, mn, now - since,
                        v.slo.latency_class, v.slo.grace_seconds(),
                    )
                    if self.events is not None:
                        self.events.warning(
                            self._claim_ref(v), "SloViolation",
                            f"claim below its min {resource} share "
                            f"({g}% < {mn}%) for {now - since:.0f}s on "
                            f"{self.node_name} — latency class "
                            f"{v.slo.latency_class} allows "
                            f"{v.slo.grace_seconds():.0f}s",
                        )
        with self._lock:
            for key in list(self._below_min_since):
                if key not in live_keys:
                    self._below_min_since.pop(key, None)
                    self._violated.discard(key)

    def _claim_ref(self, view: ClaimShareView) -> ObjectRef:
        return ObjectRef.claim(
            view.name, view.namespace, view.claim_uid,
            api_version=self.api_version,
        )

    def _share_kwargs(
        self, view: ClaimShareView, resource: str, to_percent: int
    ) -> dict:
        if resource == "tensorcore":
            return {"tensorcore_percent": to_percent}
        return {"hbm_limit": to_mebibytes_string(
            to_percent * view.chip_hbm_bytes // 100
        )}

    def _restore_kwargs(self, view: ClaimShareView, resource: str) -> dict:
        """Kwargs replaying the claim's ORIGINAL checkpointed limit —
        the exact value (not the rounded percent), or a clear when the
        claim was uncapped."""
        from .device_state import CLEAR_LIMIT

        raw = view.raw_limits.get(resource)
        key = ("tensorcore_percent" if resource == "tensorcore"
               else "hbm_limit")
        return {key: raw if raw is not None else CLEAR_LIMIT}

    def _apply(
        self, d: dict, views_by_uid: dict, now: float, demand: dict
    ) -> dict:
        gainer = views_by_uid[d["gainer"]["claim"]]
        donor = views_by_uid[d["donor"]["claim"]]
        resource = d["resource"]
        outcome = OUTCOME_APPLIED
        detail = ""
        generations = {}
        t0 = time.monotonic()
        try:
            # Donor shrinks FIRST so the group's summed share never
            # exceeds the chip mid-move.
            res = self.state.resize_claim_limits(
                donor.claim_uid,
                **self._share_kwargs(donor, resource, d["donor"]["to"]),
            )
            generations[donor.claim_uid] = res.get("generation")
            try:
                res = self.state.resize_claim_limits(
                    gainer.claim_uid,
                    **self._share_kwargs(
                        gainer, resource, d["gainer"]["to"]
                    ),
                )
                generations[gainer.claim_uid] = res.get("generation")
            except Exception as e:
                # Donor already shrunk but the gainer never grew: give
                # the share BACK (a persistently failing gainer must not
                # drain the donor to its min, one step per tick, with
                # the share granted to nobody) and record the failure.
                outcome = OUTCOME_FAILED
                detail = (
                    f"gainer resize failed after donor shrank: {e}"
                )
                try:
                    res = self.state.resize_claim_limits(
                        donor.claim_uid,
                        **self._restore_kwargs(donor, resource),
                    )
                    generations[donor.claim_uid] = res.get("generation")
                    detail += "; donor share restored"
                except Exception as e2:
                    detail += f"; donor restore ALSO failed: {e2}"
        except Exception as e:
            outcome = OUTCOME_FAILED
            detail = f"donor resize failed: {e}"
        self._m_rebalance_seconds.observe(time.monotonic() - t0)
        if outcome == OUTCOME_FAILED:
            # Failed moves cool down too: without the stamp, the next
            # tick re-proposes the identical move immediately and a
            # persistent failure becomes a per-tick resize storm.
            self._last_moved[gainer.claim_uid] = now
            self._last_moved[donor.claim_uid] = now
        if outcome == OUTCOME_APPLIED:
            self._last_moved[gainer.claim_uid] = now
            self._last_moved[donor.claim_uid] = now
            if self.events is not None:
                self.events.normal(
                    self._claim_ref(gainer), "SharesRebalanced",
                    f"{d['action']}: {resource} share "
                    f"{d['gainer']['from']}% -> {d['gainer']['to']}% "
                    f"(from {donor.namespace}/{donor.name}, now "
                    f"{d['donor']['to']}%) on {self.node_name}",
                )
        d = dict(d, outcome=outcome)
        if detail:
            d["detail"] = detail
        if generations:
            d["generations"] = generations
        return self._record(d, now, demand)

    def _record(self, d: dict, now: float, demand: dict) -> dict:
        rec = {
            "ts": round(now, 6),
            "tick": self.ticks,
            **d,
            "busy": {
                uid: (demand.get(uid) or {}).get("busy")
                for uid in (d["gainer"]["claim"], d["donor"]["claim"])
            },
        }
        self._m_decisions.inc(outcome=rec["outcome"], action=rec["action"])
        with self._lock:
            self._ring.append(rec)
        logger.info(
            "rebalance decision: %s %s %s: %s -> %s",
            rec["outcome"], rec["action"], rec["resource"],
            rec["donor"], rec["gainer"],
        )
        return rec

    def _refresh_gauges(self, views: list[ClaimShareView]) -> None:
        live = set()
        for v in views:
            for resource in RESOURCES:
                key = (v.claim_uid, resource)
                g = v.granted.get(resource)
                mn = v.min_share(resource)
                if g is None and mn is None:
                    continue
                live.add(key)
                self._m_granted.set(
                    g if g is not None else 100,
                    claim=v.claim_uid, resource=resource,
                )
                self._m_min.set(
                    mn or 0, claim=v.claim_uid, resource=resource
                )
        # Departed claims DROP their series (claim uids are unique per
        # claim lifetime — zeroing would grow /metrics without bound
        # over claim churn; cf. accounting.py's seen-sets, which are
        # bounded by hardware and so zero instead).
        for uid, resource in self._seen_gauge_keys - live:
            self._m_granted.remove(claim=uid, resource=resource)
            self._m_min.remove(claim=uid, resource=resource)
        self._seen_gauge_keys = live

    # -- export ------------------------------------------------------------

    def decisions(self) -> list[dict]:
        """Newest-last decision records (the ring's current content)."""
        with self._lock:
            return list(self._ring)

    def snapshot(self) -> dict[str, Any]:
        """The /debug/rebalance document: recent decisions plus every
        SLO-carrying claim's current granted-vs-declared shares and its
        below-min clock — the doctor's ``slo`` check input."""
        now = self._clock()
        views = self._claim_views()
        # Locked copy: the watch thread mutates this dict while the
        # metrics HTTP thread serves snapshots.
        with self._lock:
            below_since = dict(self._below_min_since)
        claims: dict[str, Any] = {}
        for v in views:
            below = [
                round(now - since, 6)
                for r in RESOURCES
                if (since := below_since.get((v.claim_uid, r))) is not None
            ]
            claims[v.claim_uid] = {
                "namespace": v.namespace,
                "name": v.name,
                "chips": list(v.chips),
                "latencyClass": v.slo.latency_class,
                "priority": v.slo.priority,
                "generation": v.generation,
                "granted": dict(v.granted),
                "min": {r: v.min_share(r) for r in RESOURCES},
                "burst": {r: v.burst_share(r) for r in RESOURCES},
                "belowMinSeconds": max(below) if below else 0.0,
                "graceSeconds": v.slo.grace_seconds(),
            }
        return {
            "node": self.node_name,
            "generatedAt": round(now, 6),
            "ticks": self.ticks,
            "policy": self.policy.to_dict(),
            "decisions": self.decisions(),
            "claims": claims,
        }
