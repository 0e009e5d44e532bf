"""Utilization accounting: how busy is this node's TPU inventory?

The packing/sharing work on the ROADMAP (MISO/ParvaGPU-style slice
packing) needs occupancy you can trust before any placement optimization
is possible — and the reference driver measures nothing (its plugin has
no metrics at all). This module turns the prepare/unprepare stream into
fleet-consumable accounting:

- **allocated device-seconds** (`tpu_dra_usage_allocated_device_seconds_
  total{type}`): integral of held devices over time, integrated lazily —
  a render hook brings the counters current at every scrape, so a
  12-hour hold is visible long before it releases;
- **occupancy gauges** (`tpu_dra_usage_occupied_devices{type,mode}`,
  `tpu_dra_usage_capacity_devices{type}`,
  `tpu_dra_usage_occupancy_ratio{type}`): distinct devices held, split
  by sharing mode (exclusive / time-shared / process-shared / admin /
  channel);
- **per-chip claim counts** (`tpu_dra_usage_chip_claims{chip}`): bounded
  by the node's chip count (tools/lint.py TPM04 keeps per-chip labels
  confined to this module and audit.py);
- **claim-hold-duration histogram**
  (`tpu_dra_usage_claim_hold_seconds`): observed at unprepare, with
  buckets sized for workloads, not RPCs.

Everything is also exported as one JSON document (``snapshot()``) served
at ``/debug/usage`` — the doctor CLI's raw material.

Restart safety: the accountant rebuilds its live holds from the
checkpoint (``rebuild``), so occupancy and hold durations survive a
DaemonSet crash; the monotonic counters restart at zero, which
Prometheus ``rate()`` handles as an ordinary counter reset.

Locking: hooks fired from DeviceState run under the DeviceState lock and
only take the accountant's lock (state → accountant). The scrape path
(sync/snapshot) reads the inventory provider BEFORE taking the
accountant lock, so the two orders can never deadlock.

The port's copy of the reference module.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from ..utils.metrics import Counter, Gauge, Histogram, Registry
from .prepared import PreparedClaim

# Sharing-mode label values (the wire strategies, lowered to label form).
MODE_EXCLUSIVE = "exclusive"
MODE_TIME_SHARED = "time-shared"
MODE_PROCESS_SHARED = "process-shared"
MODE_ADMIN = "admin"
MODE_CHANNEL = "channel"


def group_mode(config: dict) -> str:
    """Sharing-mode label for one prepared group's recorded (wire-form)
    config — the same dict ``DeviceState._config_strategy`` reads."""
    if config.get("adminAccess"):
        return MODE_ADMIN
    if config.get("kind") == "IciChannelConfig":
        return MODE_CHANNEL
    strategy = (config.get("sharing") or {}).get("strategy", "")
    return {
        "TimeShared": MODE_TIME_SHARED,
        "ProcessShared": MODE_PROCESS_SHARED,
    }.get(strategy, MODE_EXCLUSIVE)


class _Hold:
    """One live prepared claim, as accounting sees it."""

    __slots__ = (
        "claim_uid", "namespace", "name", "prepared_at",
        "last_accounted", "devices",
    )

    def __init__(self, pc: PreparedClaim, now: float):
        self.claim_uid = pc.claim_uid
        self.namespace = pc.namespace
        self.name = pc.name
        # 0.0 on pre-field checkpoint records: treat "unknown" as "now"
        # so hold durations never report a bogus 50-year hold.
        self.prepared_at = pc.prepared_at or now
        # Allocated-seconds integrate from here, NOT from prepared_at: on
        # rebuild the counter restarted at zero and must not re-count (or
        # count downtime); rate() handles the reset.
        self.last_accounted = now
        self.devices: list[dict] = []
        for group in pc.groups:
            mode = group_mode(group.config)
            for dev in group.devices:
                self.devices.append({
                    "name": dev.name,
                    "type": dev.type,
                    "mode": mode,
                    "uuids": list(dev.uuids),
                })


class UsageAccountant:
    """Occupancy/accounting state fed by DeviceState's prepare/unprepare
    hooks and drained by /metrics, /debug/usage, and the doctor CLI."""

    HOLD_BUCKETS = (1, 10, 60, 300, 1800, 3600, 6 * 3600, 24 * 3600)

    def __init__(
        self,
        registry: Registry,
        node_name: str = "",
        inventory: Optional[Callable[[], dict]] = None,
        clock: Callable[[], float] = time.time,
    ):
        """``inventory`` returns ``{"capacity": {type: n}, "chips":
        {uuid: {"state", "since", "reason"}}}`` and MUST be callable
        without the accountant lock held (DeviceState.usage_inventory
        qualifies: it reads atomically-replaced references, no lock)."""
        self.node_name = node_name
        self._inventory = inventory
        self._clock = clock
        self._lock = threading.Lock()
        self._holds: dict[str, _Hold] = {}
        # Gauge keys previously written, so emptied (type, mode) series
        # drop to zero instead of freezing at their last value.
        self._seen_occupied: set[tuple[str, str]] = set()
        self._seen_chips: set[str] = set()
        self._seen_types: set[str] = set()
        self._prepare_latency: Optional[Histogram] = None

        self._m_alloc_seconds = Counter(
            "tpu_dra_usage_allocated_device_seconds_total",
            "Device-seconds held by prepared claims, integrated at scrape "
            "time, by device type",
            registry,
        )
        self._m_occupied = Gauge(
            "tpu_dra_usage_occupied_devices",
            "Distinct devices currently held by prepared claims, by device "
            "type and sharing mode",
            registry,
        )
        self._m_capacity = Gauge(
            "tpu_dra_usage_capacity_devices",
            "Allocatable devices currently enumerated, by device type",
            registry,
        )
        self._m_occupancy = Gauge(
            "tpu_dra_usage_occupancy_ratio",
            "Occupied / allocatable devices, by device type",
            registry,
        )
        self._m_chip_claims = Gauge(
            "tpu_dra_usage_chip_claims",
            "Prepared claims holding each chip (directly or via a core "
            "partition); per-chip label, bounded by the node's chip count",
            registry,
        )
        self._m_hold_seconds = Histogram(
            "tpu_dra_usage_claim_hold_seconds",
            "How long claims held their devices (observed at unprepare)",
            registry,
            buckets=self.HOLD_BUCKETS,
        )
        # Counters must be current at the scrape instant, not at the last
        # prepare/unprepare event.
        registry.add_render_hook(self.sync)

    # -- wiring ------------------------------------------------------------

    def attach_prepare_latency(self, histogram: Histogram) -> None:
        """Reference the driver's existing prepare-latency histogram so
        the JSON snapshot can summarize it (count + sum) without minting
        a duplicate metric family."""
        self._prepare_latency = histogram

    def rebuild(self, checkpoint_records: dict[str, dict]) -> None:
        """Seed live holds from checkpointed prepared claims (restart
        path). Hold identity and prepared_at survive the crash; the
        allocated-seconds counters restart at zero (a normal Prometheus
        counter reset)."""
        now = self._clock()
        with self._lock:
            for uid, rec in checkpoint_records.items():
                if uid in self._holds:
                    continue
                try:
                    self._holds[uid] = _Hold(
                        PreparedClaim.from_dict(rec), now
                    )
                except Exception:
                    continue  # malformed record: the auditor's department
        self.sync()

    # -- DeviceState hooks -------------------------------------------------

    def note_prepared(self, pc: PreparedClaim) -> None:
        """Idempotent: kubelet retries replay prepares of claims already
        held; accounting must not double-book them."""
        now = self._clock()
        with self._lock:
            if pc.claim_uid not in self._holds:
                self._holds[pc.claim_uid] = _Hold(pc, now)
        self.sync()

    def note_unprepared(self, claim_uid: str) -> None:
        now = self._clock()
        with self._lock:
            hold = self._holds.pop(claim_uid, None)
            if hold is not None:
                self._integrate_hold_locked(hold, now)
                self._m_hold_seconds.observe(max(0.0, now - hold.prepared_at))
        self.sync()

    # -- integration / gauges ---------------------------------------------

    def _integrate_hold_locked(self, hold: _Hold, now: float) -> None:
        elapsed = max(0.0, now - hold.last_accounted)
        hold.last_accounted = now
        if elapsed == 0.0:
            return
        for dev in hold.devices:
            self._m_alloc_seconds.inc(elapsed, type=dev["type"])

    def sync(self) -> None:
        """Bring counters/gauges current (render hook + after every
        mutation). Reads the inventory provider before locking."""
        inv = self._read_inventory()
        now = self._clock()
        with self._lock:
            for hold in self._holds.values():
                self._integrate_hold_locked(hold, now)
            self._refresh_gauges_locked(inv)

    def _read_inventory(self) -> dict:
        if self._inventory is None:
            return {"capacity": {}, "chips": {}}
        try:
            return self._inventory()
        except Exception:
            return {"capacity": {}, "chips": {}}

    @staticmethod
    def _chip_of_uuid(uuid: str) -> str:
        from ..tpulib.deviceinfo import chip_uuid_of_device_uuid

        return chip_uuid_of_device_uuid(uuid)

    def _occupied_locked(self) -> dict[tuple[str, str], set[str]]:
        """(type, mode) -> distinct device names currently held."""
        occupied: dict[tuple[str, str], set[str]] = {}
        for hold in self._holds.values():
            for dev in hold.devices:
                occupied.setdefault(
                    (dev["type"], dev["mode"]), set()
                ).add(dev["name"])
        return occupied

    def _chip_claims_locked(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for hold in self._holds.values():
            chips = set()
            for dev in hold.devices:
                for u in dev["uuids"]:
                    if dev["type"] in ("chip", "tensorcore"):
                        chips.add(self._chip_of_uuid(u))
            for c in chips:
                counts[c] = counts.get(c, 0) + 1
        return counts

    def _refresh_gauges_locked(self, inv: dict) -> None:
        capacity: dict[str, int] = dict(inv.get("capacity") or {})
        occupied = self._occupied_locked()

        for key in self._seen_occupied - set(occupied):
            t, m = key
            self._m_occupied.set(0, type=t, mode=m)
        for (t, m), names in occupied.items():
            self._m_occupied.set(len(names), type=t, mode=m)
        self._seen_occupied |= set(occupied)

        occupied_by_type: dict[str, set[str]] = {}
        for (t, _m), names in occupied.items():
            occupied_by_type.setdefault(t, set()).update(names)
        # Like _seen_occupied/_seen_chips: a type that vanishes from both
        # capacity and holds must read an explicit zero, not freeze the
        # gauge at its last value for the life of the process.
        live_types = set(capacity) | set(occupied_by_type)
        for t in self._seen_types - live_types:
            self._m_capacity.set(0, type=t)
            self._m_occupancy.set(0.0, type=t)
        self._seen_types |= live_types
        for t in live_types:
            cap = capacity.get(t, 0)
            used = len(occupied_by_type.get(t, ()))
            self._m_capacity.set(cap, type=t)
            # max(cap, used): devices still held after their capacity
            # vanished (mass unplug, broken enumeration) must read as
            # FULLY occupied, not 0.0-idle, during exactly that incident.
            self._m_occupancy.set(
                used / max(cap, used) if (cap or used) else 0.0, type=t
            )

        chip_claims = self._chip_claims_locked()
        for uuid in self._seen_chips - set(chip_claims):
            self._m_chip_claims.set(0, chip=uuid)
        for uuid, n in chip_claims.items():
            self._m_chip_claims.set(n, chip=uuid)
        self._seen_chips |= set(chip_claims)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """The /debug/usage document: one JSON object describing this
        node's live utilization — the doctor CLI's per-node input."""
        inv = self._read_inventory()
        now = self._clock()
        with self._lock:
            for hold in self._holds.values():
                self._integrate_hold_locked(hold, now)
            self._refresh_gauges_locked(inv)
            occupied = self._occupied_locked()
            capacity: dict[str, int] = dict(inv.get("capacity") or {})
            occupied_by_type: dict[str, set[str]] = {}
            occupied_json: dict[str, dict[str, int]] = {}
            # Previously-seen (type, mode) pairs report an explicit zero,
            # mirroring the gauge series (a vanished key would read as
            # "never measured" rather than "released").
            for t, m in self._seen_occupied - set(occupied):
                occupied_json.setdefault(t, {})[m] = 0
            for (t, m), names in occupied.items():
                occupied_by_type.setdefault(t, set()).update(names)
                occupied_json.setdefault(t, {})[m] = len(names)
            holds = [
                {
                    "claimUid": h.claim_uid,
                    "namespace": h.namespace,
                    "name": h.name,
                    "preparedAt": round(h.prepared_at, 6),
                    "heldSeconds": round(max(0.0, now - h.prepared_at), 6),
                    "devices": [
                        {
                            "name": d["name"],
                            "type": d["type"],
                            "mode": d["mode"],
                            "uuids": list(d["uuids"]),
                        }
                        for d in h.devices
                    ],
                }
                for h in sorted(
                    self._holds.values(), key=lambda h: h.claim_uid
                )
            ]
            alloc_totals = {
                t: round(self._m_alloc_seconds.value(type=t), 6)
                for t in sorted(
                    set(capacity)
                    | {d["type"] for h in self._holds.values()
                       for d in h.devices}
                )
            }
            chip_claims = self._chip_claims_locked()
        out: dict[str, Any] = {
            "node": self.node_name,
            "generatedAt": round(now, 6),
            "capacity": capacity,
            "occupied": occupied_json,
            "occupancyRatio": {
                # max(cap, used), as for the gauge: held-but-capacity-
                # gone must read fully occupied, not idle or absent.
                t: round(
                    len(occupied_by_type.get(t, ()))
                    / max(capacity.get(t, 0),
                          len(occupied_by_type.get(t, ()))),
                    6,
                )
                for t in set(capacity) | set(occupied_by_type)
                if capacity.get(t) or occupied_by_type.get(t)
            },
            "allocatedSecondsTotal": alloc_totals,
            "holds": holds,
            "chips": {
                uuid: {
                    "claims": chip_claims.get(uuid, 0),
                    **{k: meta.get(k) for k in ("state", "since", "reason")},
                }
                for uuid, meta in sorted(
                    (inv.get("chips") or {}).items()
                )
            },
        }
        if self._prepare_latency is not None:
            n, total = self._prepare_latency.summary()
            out["prepareLatency"] = {
                "count": n, "sumSeconds": round(total, 6)
            }
        return out
