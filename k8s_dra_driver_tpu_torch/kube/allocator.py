"""Reference DRA allocator: scheduler-sim for tests and dev clusters.

The real allocation happens in the Kubernetes scheduler's structured-
parameters allocator (SURVEY.md §3.5 — the layer deliberately NOT in the
reference repo). This module re-implements the subset this driver's
published attributes exercise, so the full claim lifecycle can be simulated
hermetically: DeviceClass → device-type mapping, request counts, attribute
selectors, and cross-request ``matchAttribute`` constraints (the gang /
same-parent mechanism of tpu-test4/6).

Selectors come in two forms: programmatic (attribute, op, value) triples,
and real CEL expressions from DeviceClass specs / request ``selectors``
(evaluated by the cel module's subset engine, so the demo specs run through
the sim verbatim). The production path still uses the real scheduler.

**Allocation explainability.** Every solve records a per-request *candidate
funnel* — how many devices entered, how many each named stage rejected and
why — plus backtrack count and per-stage latency, into an
:class:`Explanation`. Failures raise :class:`AllocationError` carrying the
explanation and a terminal ``reason`` drawn from :data:`REASONS`;
successes keep a compact funnel (counts, no per-device samples). Decisions
land in a bounded ring buffer served as JSONL at ``/debug/allocations``
(``MetricsServer.set_allocations_provider``) and feed the
``tpu_dra_alloc_*`` metric families, so "why won't my claim schedule?" is
answerable from a scrape instead of a debugger (kube-scheduler's
``Unschedulable`` filter messages are the model; docs/operations.md maps
each terminal reason to an operator action).

**Fleet-scale solving.** Three mechanisms keep the solver fast and the
fleet defragmented at north-star scale (thousands of nodes, high claim
churn):

- *Incremental re-solve* (:class:`InventoryIndex`): the flattened
  inventory, shared-counter capacities, and the static filter verdicts
  (invalid-slice / class CEL / request CEL per device) persist across
  solves in a generation-keyed index, invalidated per-pool by
  ResourceSlice deltas detected with a cheap ``list_meta`` signature
  probe. Steady-state solves re-evaluate nothing; only the delta after a
  health transition / device add/remove is re-filtered. Reservation
  changes never invalidate the index — the ``reserved`` stage is applied
  per solve on top of the cached survivors. ``incremental=False`` forces
  a from-scratch rebuild per solve (the bench baseline and the parity
  oracle in tests/test_allocator_scale.py).
- *Topology-aware placement* (:meth:`ReferenceAllocator._score_placement`):
  instead of first-fit in inventory order, multi-chip gangs are placed
  best-fit into the smallest free contiguous sub-mesh that satisfies
  them, with a corner/edge bias (ParvaGPU's spatial-packing discipline),
  so churn stops shredding the large contiguous boxes future gangs need.
  The chosen box and its score land in the decision record
  (``placements``) so ``/debug/allocations`` explains *why this
  placement* as well as why-not.
- *Batch solving* (:meth:`ReferenceAllocator.allocate_batch`): queued
  claims solve most-constrained-first (largest gangs before singles)
  under one :meth:`ReferenceAllocator.snapshot`, sharing one index
  refresh instead of re-probing per claim; every claim still emits its
  own funnel.

When a gang goes unsat with terminal reason ``gang``/``shortfall`` and a
:class:`~.defrag.DefragPlanner` is attached (``self.defrag``), a
read-only migration plan is computed and surfaced at ``/debug/defrag``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Optional

from ..tpulib.topology import (
    GENERATIONS,
    Coord,
    MeshShape,
    box_shapes,
    free_components,
    is_contiguous_submesh,
)
from ..utils.metrics import Counter, Histogram, Registry
from ..utils.tracing import child_span
from .cel import CelError, evaluate_detailed as cel_evaluate_detailed
from .client import KubeClient
from .resourceapi import ResourceApi

logger = logging.getLogger(__name__)

# DeviceClass name → the `type` attribute the node plugin publishes.
DEVICE_CLASS_TYPES = {
    "tpu.google.com": "chip",
    "tensorcore.tpu.google.com": "tensorcore",
    "ici.tpu.google.com": "ici",
}

# -- funnel stages (pipeline order; the enum `stage` metric labels and
#    /debug/allocations records are confined to — lint rule TPM06) --------
STAGE_INVALID_SLICE = "invalid-slice"
STAGE_CLASS_CEL = "class-cel"
STAGE_REQUEST_CEL = "request-cel"
STAGE_UNHEALTHY = "unhealthy"
STAGE_RESERVED = "reserved"
STAGE_COUNTERS = "counters"
STAGE_CONSTRAINT = "constraint"
STAGE_GANG = "gang"

STAGES = (
    STAGE_INVALID_SLICE,
    STAGE_CLASS_CEL,
    STAGE_REQUEST_CEL,
    STAGE_UNHEALTHY,
    STAGE_RESERVED,
    STAGE_COUNTERS,
    STAGE_CONSTRAINT,
    STAGE_GANG,
)
# Filter stages timed per candidate pass (everything before the search).
_CANDIDATE_STAGES = STAGES[:5]

# Stages applied while FILTERING candidates (before the search): a deepest
# rejection here with survivors left means the request simply wants more
# devices than match — reported as `shortfall`, not as the filter stage.
_FILTER_STAGES = (STAGE_INVALID_SLICE, STAGE_CLASS_CEL, STAGE_REQUEST_CEL,
                  STAGE_UNHEALTHY)

# -- terminal reasons (the enum `reason` metric labels are confined to).
#    Kept a full literal (not STAGES + extras) so tools/lint.py TPM06 can
#    read the values without evaluating expressions; the assert below
#    keeps the two in sync.
REASON_SHORTFALL = "shortfall"
REASON_NO_DEVICES = "no-devices"
REASON_CEL_ERROR = "cel-error"
REASON_UNKNOWN_CLASS = "unknown-class"
REASON_UNKNOWN_MODE = "unknown-mode"
REASON_BACKTRACK_BUDGET = "backtrack-budget"
REASON_INTERNAL = "internal"

REASONS = (
    "invalid-slice",
    "class-cel",
    "request-cel",
    "unhealthy",
    "reserved",
    "counters",
    "constraint",
    "gang",
    "shortfall",
    "no-devices",
    "cel-error",
    "unknown-class",
    "unknown-mode",
    "backtrack-budget",
    "internal",
)
assert set(STAGES) <= set(REASONS)

# Terminal reason → the operator's next move. Single source for the
# doctor's `explain` cross-check, the inspector's live view, and the
# "why won't my claim schedule?" runbook in docs/operations.md.
RUNBOOK_HINTS = {
    "invalid-slice": (
        "a published ResourceSlice is misconfigured (devices consume "
        "counters their slice never declared); fix the slice publisher "
        "and check plugin logs for 'undeclared counters'"
    ),
    "class-cel": (
        "no device satisfies the DeviceClass selector; inspect `kubectl "
        "get deviceclass -o yaml` for a typo'd expression or a "
        "class/driver mismatch"
    ),
    "request-cel": (
        "the claim's request selectors reject every device; check the "
        "request's CEL expressions and attribute names against the "
        "published ResourceSlice attributes"
    ),
    "unhealthy": (
        "every matching device sits on a chip the health poll marked "
        "degraded; this solve required healthy devices (an elastic "
        "gang re-solve always does) — wait for recovery, drain the sick "
        "chips, or add capacity"
    ),
    "reserved": (
        "every matching device is already held by another claim; free "
        "capacity (delete idle claims) or wait for running workloads to "
        "finish"
    ),
    "counters": (
        "the shared counter budget is exhausted (e.g. chips already "
        "carved into core partitions); deallocate partition claims or "
        "target another pool"
    ),
    "constraint": (
        "the matchAttribute constraint cannot be satisfied by the "
        "remaining devices (e.g. the gang would span ICI slices); relax "
        "the constraint or free devices on one slice"
    ),
    "gang": (
        "no contiguous ICI submesh of the requested shape is free; the "
        "slice is fragmented — drain/repack smaller claims or request a "
        "smaller gang"
    ),
    "shortfall": (
        "fewer matching devices exist than the request asks for; lower "
        "the request count or add capacity"
    ),
    "no-devices": (
        "no ResourceSlices are published for this driver; check that the "
        "node plugin and controller are running and publishing"
    ),
    "cel-error": (
        "a selector expression is malformed and cannot be evaluated; fix "
        "the expression quoted in the error"
    ),
    "unknown-class": (
        "the request names a DeviceClass this driver does not serve; "
        "check the deviceClassName spelling"
    ),
    "unknown-mode": (
        "the request uses an allocationMode this driver does not "
        "implement; use ExactCount or All"
    ),
    "backtrack-budget": (
        "the solver hit its backtrack budget before finding a placement; "
        "the claim is pathologically constrained — simplify constraints "
        "or raise TPU_DRA_MAX_BACKTRACK_STEPS"
    ),
    "internal": (
        "the allocator failed unexpectedly; check plugin logs for the "
        "stack trace"
    ),
}
assert set(RUNBOOK_HINTS) == set(REASONS)

# Distinct request shapes whose static filter verdicts the inventory
# index retains (LRU): each record holds one verdict per device, so
# per-claim-unique selectors (coord pins etc.) must recycle old records
# instead of leaking one O(#devices) map per claim forever — and every
# retained record is re-filtered against a pool's devices on each delta,
# so the bound also caps delta-application work.
MAX_FILTER_RECORDS = 64
# A pathological claim (dense matchAttribute groups over a fragmented
# slice) can drive the backtracking search exponential. The budget turns
# that into a typed `backtrack-budget` failure instead of a wedged
# allocator; generous enough that every legitimate solve in the scale
# suite stays orders of magnitude below it.
DEFAULT_MAX_BACKTRACK_STEPS = 200_000
# Solve decisions kept for /debug/allocations.
DEFAULT_DECISION_BUFFER = 256


class AllocationError(RuntimeError):
    """An unallocatable claim. ``reason`` is the terminal cause (one of
    :data:`REASONS`); ``explanation`` carries the full candidate funnel
    once ``allocate()`` has finalized the solve record."""

    def __init__(self, message: str, reason: str = REASON_INTERNAL,
                 explanation: Optional["Explanation"] = None):
        super().__init__(message)
        self.reason = reason
        self.explanation = explanation


@dataclasses.dataclass
class RequestFunnel:
    """One request's candidate funnel: devices entering, per-stage
    rejection counts with sampled per-device reasons, survivors, and the
    count the request wanted."""

    request: str
    entering: int = 0
    wanted: int = 0
    survivors: int = 0
    rejected: dict[str, int] = dataclasses.field(default_factory=dict)
    reasons: dict[str, list[str]] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "request": self.request,
            "entering": self.entering,
            "wanted": self.wanted,
            "survivors": self.survivors,
            "rejected": dict(self.rejected),
            "reasons": {k: list(v) for k, v in self.reasons.items()},
        }


class Explanation:
    """Structured record of one solve: the per-request funnels, the
    terminal reason on failure, backtrack count, CEL evaluation count
    (the memo's effectiveness is observable), and per-stage + end-to-end
    latency. Rendered as one JSONL line at ``/debug/allocations``."""

    # Per-device reason strings kept per (request, stage); counts are
    # exact, samples are bounded so a 192-device funnel stays one line.
    MAX_REASON_SAMPLES = 4

    def __init__(self, claim_uid: str = "", claim_name: str = "",
                 claim_namespace: str = ""):
        self.claim_uid = claim_uid
        self.claim_name = claim_name
        self.claim_namespace = claim_namespace
        self.outcome = "ok"  # ok | unsat | error
        self.reason = ""
        self.detail = ""
        self.failing_request = ""
        self.backtracks = 0
        self.cel_evaluations = 0
        self.duration_seconds = 0.0
        self.stage_seconds: dict[str, float] = {}
        self.timestamp = 0.0
        # request name -> placement-score record (the topology scorer's
        # "why THIS placement" half of the explanation).
        self.placements: dict[str, dict] = {}
        self._funnels: dict[str, RequestFunnel] = {}
        self._seen: set = set()
        self._fail_depth = -1

    # -- recording (solver side) ------------------------------------------

    def funnel(self, request: str) -> RequestFunnel:
        f = self._funnels.get(request)
        if f is None:
            f = self._funnels[request] = RequestFunnel(request=request)
        return f

    def reject(self, request: str, stage: str, key: Any,
               detail: str = "") -> None:
        """Count one rejection of candidate ``key`` at ``stage``. Deduped
        per (request, stage, key): backtracking revisits the same device
        under different partial solutions, and re-counting each probe
        would turn the funnel into a measure of search effort, not of
        inventory."""
        seen_key = (request, stage, key)
        if seen_key in self._seen:
            return
        self._seen.add(seen_key)
        f = self.funnel(request)
        f.rejected[stage] = f.rejected.get(stage, 0) + 1
        if detail:
            samples = f.reasons.setdefault(stage, [])
            if len(samples) < self.MAX_REASON_SAMPLES \
                    and detail not in samples:
                samples.append(detail)

    def add_stage_seconds(self, stage: str, seconds: float) -> None:
        self.stage_seconds[stage] = (
            self.stage_seconds.get(stage, 0.0) + seconds
        )

    def note_request_failure(self, depth: int, request: str) -> None:
        """The DEEPEST request to exhaust its candidates is the terminal
        one — earlier requests failing merely means the solver is
        unwinding through them."""
        if depth > self._fail_depth:
            self._fail_depth = depth
            self.failing_request = request

    # -- reading ----------------------------------------------------------

    @property
    def funnels(self) -> list[RequestFunnel]:
        return list(self._funnels.values())

    def terminal(self) -> tuple[str, str]:
        """(reason, human detail) for a failed solve, derived from the
        terminal request's funnel: the deepest stage that rejected
        candidates — except that filter-stage rejections with survivors
        left read as `shortfall` (the devices that DID match were simply
        too few)."""
        f = self._funnels.get(self.failing_request)
        if f is None:
            return (
                REASON_INTERNAL,
                "solver failed before exploring any request",
            )
        deepest = None
        for stage in STAGES:
            if f.rejected.get(stage):
                deepest = stage
        prefix = f"request {f.request!r}"
        if deepest is None and f.entering == 0:
            return REASON_NO_DEVICES, (
                f"{prefix}: no published devices to consider"
            )
        if (
            f.survivors > 0
            and f.survivors < max(f.wanted, 1)
            and (deepest is None or deepest in _FILTER_STAGES)
        ):
            return REASON_SHORTFALL, (
                f"{prefix}: only {f.survivors} of {f.wanted} matching "
                "device(s) available"
            )
        if deepest is None:
            return REASON_INTERNAL, (
                f"{prefix}: search exhausted with no recorded rejections"
            )
        msg = (
            f"{prefix}: {f.rejected[deepest]} candidate(s) rejected at "
            f"stage {deepest!r}"
        )
        samples = f.reasons.get(deepest)
        if samples:
            msg += f" (e.g. {samples[0]})"
        return deepest, msg

    def compact(self) -> None:
        """Successes keep the funnel counts but drop per-device samples —
        the ring buffer must stay cheap on the happy path."""
        for f in self._funnels.values():
            f.reasons = {}

    def to_dict(self) -> dict[str, Any]:
        return {
            "ts": round(self.timestamp, 3),
            "claim": {
                "uid": self.claim_uid,
                "name": self.claim_name,
                "namespace": self.claim_namespace,
            },
            "outcome": self.outcome,
            "reason": self.reason,
            "detail": self.detail,
            "failingRequest": self.failing_request,
            "backtracks": self.backtracks,
            "celEvaluations": self.cel_evaluations,
            "durationSeconds": round(self.duration_seconds, 6),
            "stageSeconds": {
                k: round(v, 6)
                for k, v in sorted(self.stage_seconds.items())
            },
            "placements": {k: dict(v) for k, v in self.placements.items()},
            "funnels": [f.to_dict() for f in self._funnels.values()],
        }


@dataclasses.dataclass
class Selector:
    """Attribute predicate: op ∈ {eq, ne, lt, le, gt, ge, in}."""

    attribute: str
    op: str
    value: Any

    def matches(self, attrs: dict) -> bool:
        raw = attrs.get(self.attribute)
        if raw is None:
            return False
        val = next(iter(raw.values())) if isinstance(raw, dict) else raw
        if self.op == "eq":
            return val == self.value
        if self.op == "ne":
            return val != self.value
        if self.op == "lt":
            return val < self.value
        if self.op == "le":
            return val <= self.value
        if self.op == "gt":
            return val > self.value
        if self.op == "ge":
            return val >= self.value
        if self.op == "in":
            return val in self.value
        raise ValueError(f"unknown op {self.op!r}")


def _attr_value(attrs: dict, name: str):
    raw = attrs.get(name)
    if raw is None:
        return None
    return next(iter(raw.values())) if isinstance(raw, dict) else raw


def _meshless(attrs: dict) -> bool:
    """True for a chip of a generation that forms no interconnect mesh
    (``ici_dims`` 0 in ``GENERATIONS``: the H100, whose GPUs reach each
    other through an NVLink switch). Its published coordinate is an
    index, not a mesh position, so it takes no part in the gang check,
    the placement scorer's boxes or the defrag planner's meshes."""
    spec = GENERATIONS.get(_attr_value(attrs, "generation"))
    return spec is not None and spec.ici_dims == 0


def _consumption_entries(dev: dict):
    """(pool, counter set, counter, amount) for each counter a device
    consumes. Index-built devices carry the parsed list precomputed
    (``_consumes``); plain dicts fall back to parsing."""
    cached = dev.get("_consumes")
    if cached is not None:
        return cached
    out = []
    for cc in dev.get("consumes", []):
        for cname, cval in cc.get("counters", {}).items():
            out.append(
                (dev["pool"], cc["counterSet"], cname, int(cval["value"]))
            )
    return out


def _gang_contiguous(chosen: list[dict]) -> tuple[bool, str]:
    """A multi-chip request is a gang: its chips must be one contiguous
    ICI sub-mesh within a single slice (SURVEY.md §7 hard part (a); the
    reference's analog is same-parent MIG constraints,
    demo/specs/quickstart/gpu-test4.yaml:42-44). XLA's collective
    performance model assumes mesh neighbours, so a fragmented pick is
    useless to the workload and must be rejected, not granted.

    Chips of a meshless generation (``_meshless``) need no contiguity.

    Returns (ok, why_not) so the explainer can say WHICH invariant the
    combination broke.
    """
    chips = [
        d for d in chosen
        if _attr_value(d["attributes"], "type") == "chip"
        and not _meshless(d["attributes"])
    ]
    if len(chips) < 2:
        return True, ""
    slice_ids = {_attr_value(d["attributes"], "sliceId") for d in chips}
    if len(slice_ids) > 1:
        return False, f"gang:chips span ICI slices {sorted(map(str, slice_ids))}"
    coords = []
    for d in chips:
        c = _attr_value(d["attributes"], "coord")
        if c is None:
            return False, f"gang:chip {d['name']!r} publishes no coord"
        coords.append(Coord.parse(c))
    if not is_contiguous_submesh(coords):
        return False, (
            "gang:non-contiguous coords "
            f"[{', '.join(str(c) for c in coords)}]"
        )
    return True, ""


def _cel_mismatch_detail(expr: str, why: str) -> str:
    return f"cel:mismatch expr={expr!r}" + (f" ({why})" if why else "")


class _FilterRecord:
    """Static filter verdicts for one request shape: per device key,
    ``None`` (survivor) or ``(stage, detail)`` for the rejecting stage.
    The shape is (device class, CEL selector expressions, programmatic
    selector signature) — everything about a request that is stable
    across solves. Reservations and health gating are deliberately NOT
    part of the record; they are applied per solve on top."""

    __slots__ = ("class_name", "cel_exprs", "prog_selectors", "by_device")

    def __init__(self, class_name, cel_exprs, prog_selectors):
        self.class_name = class_name
        self.cel_exprs = cel_exprs
        self.prog_selectors = prog_selectors
        self.by_device: dict[tuple, Optional[tuple[str, str]]] = {}


class InventoryIndex:
    """Persistent, generation-keyed view of the published inventory.

    Replaces the per-solve ``_inventory()`` pass: the flattened device
    dicts, shared-counter capacities, per-slice topology metadata, and
    the per-request-shape static filter verdicts all survive across
    solves. ``refresh()`` probes slice (name, resourceVersion)
    signatures via ``KubeClient.list_meta`` — O(#slices), no device
    copying — and rebuilds only the pools whose slices changed,
    re-filtering only those pools' devices into every cached
    :class:`_FilterRecord`. ``generation`` increments on every applied
    delta, so solve records can say which inventory they solved against.

    All access runs under the owning allocator's lock.
    """

    def __init__(self, allocator: "ReferenceAllocator"):
        self._alloc = allocator
        self.generation = 0
        self.devices: list[dict] = []
        self.by_key: dict[tuple[str, str], dict] = {}
        self.capacity: dict[tuple[str, str, str], int] = {}
        # Observability: list_meta probes vs pools actually rebuilt, and
        # CEL evaluated eagerly while applying deltas (bench + tests).
        self.probes = 0
        self.rebuilds = 0
        self.refresh_cel_evaluations = 0
        self._sig: dict[str, str] = {}
        self._slice_pool: dict[str, str] = {}         # slice name -> pool
        self._pool_slices: dict[str, list[dict]] = {}  # pool -> slice dicts
        self._pool_devices: dict[str, list[dict]] = {}
        self._filters: dict[tuple, _FilterRecord] = {}
        # sliceId -> (MeshShape, {coord tuple: chip device dict})
        self._slice_meta: dict[str, tuple[MeshShape, dict]] = {}

    # -- refresh ----------------------------------------------------------

    def refresh(self, force: bool = False) -> bool:
        """Bring the index up to date; returns True when anything
        changed. ``force`` rebuilds everything (the from-scratch
        baseline), dropping every cached verdict."""
        client, api = self._alloc.client, self._alloc.api
        self.probes += 1
        sig = dict(client.list_meta(api.slices))
        if not force and sig == self._sig:
            return False
        slices = [
            api.slice_from_wire(s)
            for s in client.list(api.slices)
            if s["spec"].get("driver") == self._alloc.driver_name
        ]
        by_pool: dict[str, list[dict]] = {}
        slice_pool: dict[str, str] = {}
        for s in slices:
            pool = s["spec"]["pool"]["name"]
            by_pool.setdefault(pool, []).append(s)
            name = (s.get("metadata") or {}).get("name", "")
            if name:
                slice_pool[name] = pool
        if force:
            affected = set(by_pool) | set(self._pool_devices)
            self._filters.clear()
        else:
            changed = {
                n for n in set(sig) | set(self._sig)
                if sig.get(n) != self._sig.get(n)
            }
            affected = {
                self._slice_pool[n] for n in changed if n in self._slice_pool
            } | {
                slice_pool[n] for n in changed if n in slice_pool
            }
        self._sig = sig
        self._slice_pool = slice_pool
        if not affected:
            # Foreign-driver churn only: signatures moved, our pools
            # did not.
            return False
        for pool in sorted(affected):
            self._rebuild_pool(pool, by_pool.get(pool, []))
        self._reflatten()
        self.generation += 1
        return True

    def _rebuild_pool(self, pool: str, pool_slices: list[dict]) -> None:
        self.rebuilds += 1
        old = self._pool_devices.pop(pool, [])
        old_keys = [d["_key"] for d in old]
        self._pool_slices.pop(pool, None)
        for key in [k for k in self.capacity if k[0] == pool]:
            del self.capacity[key]
        new_devs: list[dict] = []
        if pool_slices:
            # Highest pool generation wins — a half-rolled-out republish
            # must not double-count devices.
            gen = max(s["spec"]["pool"]["generation"] for s in pool_slices)
            live = sorted(
                (s for s in pool_slices
                 if s["spec"]["pool"]["generation"] == gen),
                key=lambda s: (s.get("metadata") or {}).get("name", ""),
            )
            self._pool_slices[pool] = live
            for s in live:
                for cs in s["spec"].get("sharedCounters", []):
                    for cname, cval in cs.get("counters", {}).items():
                        self.capacity[(pool, cs["name"], cname)] = int(
                            cval["value"]
                        )
            for s in live:
                for dev in s["spec"].get("devices", []):
                    new_devs.append(self._build_device(pool, s, dev))
            for d in new_devs:
                self._finalize_device(d)
            self._pool_devices[pool] = new_devs
        # Update every cached filter record for just this pool's delta:
        # stale verdicts out, fresh devices evaluated in. A record whose
        # selectors cannot be evaluated any more (CEL error, vanished
        # device class) is dropped and will rebuild — and raise its
        # typed failure — on the next solve that wants it.
        for fkey, rec in list(self._filters.items()):
            for k in old_keys:
                rec.by_device.pop(k, None)
            try:
                for d in new_devs:
                    rec.by_device[d["_key"]] = self.static_verdict(
                        d, rec.class_name, rec.prog_selectors,
                        rec.cel_exprs, on_cel_miss=self._count_refresh_cel,
                    )
            except AllocationError:
                del self._filters[fkey]

    def _count_refresh_cel(self) -> None:
        self.refresh_cel_evaluations += 1

    def _build_device(self, pool: str, s: dict, dev: dict) -> dict:
        basic = dev.get("basic", {})
        d = {
            "pool": pool,
            "node": s["spec"].get("nodeName", ""),
            "node_selector": s["spec"].get("nodeSelector"),
            "name": dev["name"],
            "attributes": basic.get("attributes", {}),
            "capacity": basic.get("capacity", {}),
            "consumes": basic.get("consumesCounters", []),
        }
        d["_key"] = (pool, dev["name"])
        attrs = d["attributes"]
        d["_type"] = _attr_value(attrs, "type")
        d["_healthy"] = _attr_value(attrs, "healthy")
        d["_slice_id"] = _attr_value(attrs, "sliceId")
        coord = _attr_value(attrs, "coord")
        d["_coord"] = (
            Coord.parse(coord)
            if coord is not None and not _meshless(attrs) else None
        )
        d["_consumes"] = [
            (pool, cc["counterSet"], cname, int(cval["value"]))
            for cc in d["consumes"]
            for cname, cval in cc.get("counters", {}).items()
        ]
        d["_cel"] = {}
        return d

    def _finalize_device(self, d: dict) -> None:
        """Invalid-slice detection (undeclared counters), against the
        pool's freshly rebuilt capacity."""
        missing = [
            (cset, cname)
            for _, cset, cname, _ in d["_consumes"]
            if (d["pool"], cset, cname) not in self.capacity
        ]
        if missing:
            d["invalid"] = True
            warned = self._alloc._warned_invalid
            if d["_key"] not in warned:
                warned.add(d["_key"])
                logger.warning(
                    "device %r in pool %r consumes undeclared counters "
                    "%s; treating device as unallocatable",
                    d["name"], d["pool"], missing,
                )

    def _reflatten(self) -> None:
        ordered = []
        for pool in sorted(self._pool_devices):
            ordered.extend(self._pool_devices[pool])
        self.devices = ordered
        self.by_key = {d["_key"]: d for d in ordered}
        meta: dict[str, tuple[MeshShape, dict]] = {}
        coords: dict[str, dict] = {}
        for d in ordered:
            if d["_type"] == "chip" and d["_coord"] is not None \
                    and d["_slice_id"]:
                coords.setdefault(str(d["_slice_id"]), {})[
                    d["_coord"].as_tuple()
                ] = d
        for slice_id, cells in coords.items():
            shape = MeshShape(
                max(c[0] for c in cells) + 1,
                max(c[1] for c in cells) + 1,
                max(c[2] for c in cells) + 1,
            )
            meta[slice_id] = (shape, cells)
        self._slice_meta = meta

    # -- reading ----------------------------------------------------------

    def slice_meta(
        self, slice_id
    ) -> Optional[tuple[MeshShape, dict]]:
        """(mesh shape, {coord tuple -> chip device}) for a published
        ICI slice, or None when it publishes no grounded chip coords."""
        return self._slice_meta.get(str(slice_id))

    def slice_ids(self) -> list[str]:
        return sorted(self._slice_meta)

    # -- static filtering -------------------------------------------------

    def cel_on(self, d: dict, expr: str, on_miss=None) -> tuple[bool, str]:
        """CEL verdict for one (expression, device), cached on the device
        dict — rebuilt devices shed their cache with their dict. CelError
        maps to the allocator's typed cel-error contract."""
        cache = d["_cel"]
        hit = cache.get(expr)
        if hit is None:
            if on_miss is not None:
                on_miss()
            try:
                hit = cel_evaluate_detailed(
                    expr, self._alloc.driver_name, d["attributes"],
                    d.get("capacity"),
                )
            except CelError as e:
                raise AllocationError(
                    f"invalid CEL selector: {e}",
                    reason=REASON_CEL_ERROR,
                ) from e
            cache[expr] = hit
        return hit

    def class_verdict(
        self, class_name: str, d: dict, on_miss=None
    ) -> tuple[bool, str]:
        device_classes = self._alloc.device_classes
        if device_classes is not None:
            exprs = device_classes.get(class_name)
            if exprs is None:
                raise AllocationError(
                    f"unknown device class {class_name!r}",
                    reason=REASON_UNKNOWN_CLASS,
                )
            for e in exprs:
                ok, why = self.cel_on(d, e, on_miss)
                if not ok:
                    return False, _cel_mismatch_detail(e, why)
            return True, ""
        dtype = DEVICE_CLASS_TYPES.get(class_name)
        if dtype is None:
            raise AllocationError(
                f"unknown device class {class_name!r}",
                reason=REASON_UNKNOWN_CLASS,
            )
        if d["_type"] != dtype:
            return False, f"class:device type {d['_type']!r} != {dtype!r}"
        return True, ""

    def static_verdict(
        self, d: dict, class_name: str, prog_selectors, cel_exprs,
        on_cel_miss=None, stage_seconds: Optional[dict] = None,
    ) -> Optional[tuple[str, str]]:
        """The request-independent-of-state filter pipeline for one
        device: invalid-slice -> class CEL -> request selectors. Returns
        (stage, detail) for a rejection, None for a survivor. With
        ``stage_seconds`` the per-stage cost is accumulated (the
        cache-build pass keeps the PR-4 stage-latency contract)."""
        t = time.perf_counter()
        invalid = d.get("invalid", False)
        if stage_seconds is not None:
            stage_seconds[STAGE_INVALID_SLICE] += time.perf_counter() - t
        if invalid:
            return (
                STAGE_INVALID_SLICE,
                "slice:device consumes counters its slice never declared",
            )
        t = time.perf_counter()
        ok, why = self.class_verdict(class_name, d, on_cel_miss)
        if stage_seconds is not None:
            stage_seconds[STAGE_CLASS_CEL] += time.perf_counter() - t
        if not ok:
            return (STAGE_CLASS_CEL, why)
        t = time.perf_counter()
        why = ""
        for s in prog_selectors:
            if not s.matches(d["attributes"]):
                why = (
                    f"selector:{s.attribute} {s.op} {s.value!r} mismatch"
                )
                break
        if not why:
            for e in cel_exprs:
                ok, cel_why = self.cel_on(d, e, on_cel_miss)
                if not ok:
                    why = _cel_mismatch_detail(e, cel_why)
                    break
        if stage_seconds is not None:
            stage_seconds[STAGE_REQUEST_CEL] += time.perf_counter() - t
        if why:
            return (STAGE_REQUEST_CEL, why)
        return None

    def filter_record(
        self, class_name: str, prog_selectors, cel_exprs,
        on_cel_miss=None, stage_seconds: Optional[dict] = None,
    ) -> _FilterRecord:
        """The cached static verdicts for a request shape, building (and
        persisting) them on first sight. The build pass covers the WHOLE
        index, not just a node scope — the record must be reusable by
        any later solve."""
        prog_sig = tuple(
            (s.attribute, s.op, repr(s.value)) for s in prog_selectors
        )
        key = (class_name, tuple(cel_exprs), prog_sig)
        rec = self._filters.get(key)
        if rec is not None:
            # LRU touch (dicts iterate in insertion order).
            del self._filters[key]
            self._filters[key] = rec
            return rec
        rec = _FilterRecord(class_name, list(cel_exprs),
                            list(prog_selectors))
        for d in self.devices:
            rec.by_device[d["_key"]] = self.static_verdict(
                d, class_name, prog_selectors, cel_exprs,
                on_cel_miss=on_cel_miss, stage_seconds=stage_seconds,
            )
        while len(self._filters) >= MAX_FILTER_RECORDS:
            self._filters.pop(next(iter(self._filters)))
        self._filters[key] = rec
        return rec


class ReferenceAllocator:
    """Allocates claims against published ResourceSlices."""

    def __init__(
        self,
        client: KubeClient,
        driver_name: str = "tpu.google.com",
        device_classes: Optional[dict[str, list[str]]] = None,
        resource_api: Optional[ResourceApi] = None,
        registry: Optional[Registry] = None,
        recorder=None,
        max_backtrack_steps: Optional[int] = None,
        incremental: bool = True,
        placement_scoring: Optional[bool] = None,
    ):
        """``device_classes`` maps DeviceClass name → CEL selector
        expressions (from the class spec). When given, class membership is
        decided by evaluating those (the production mechanism); otherwise
        the built-in DEVICE_CLASS_TYPES name → type mapping applies.
        ``resource_api`` selects the resource.k8s.io dialect slices are
        read in (default: discover from the client). ``registry`` receives
        the attempt/backtrack counters and the ``tpu_dra_alloc_*``
        explainability families. ``recorder`` (an
        ``events.EventRecorder``) gets a deduped ``UnsatisfiableClaim``
        Warning on the claim for every failed solve.
        ``max_backtrack_steps`` bounds the search (default
        ``TPU_DRA_MAX_BACKTRACK_STEPS`` env or
        ``DEFAULT_MAX_BACKTRACK_STEPS``). ``incremental=False`` disables
        the persistent inventory index — every solve rebuilds and
        re-filters from scratch (the bench baseline; production wants the
        default). ``placement_scoring`` toggles the topology-aware
        best-fit scorer (default: ``TPU_DRA_PLACEMENT_SCORING`` env, on
        unless set to ``0``); off means first-fit in inventory order.
        """
        self.client = client
        self.driver_name = driver_name
        self.device_classes = device_classes
        self.api = resource_api or ResourceApi.discover(client)
        self.recorder = recorder
        if max_backtrack_steps is None:
            max_backtrack_steps = int(os.environ.get(
                "TPU_DRA_MAX_BACKTRACK_STEPS", DEFAULT_MAX_BACKTRACK_STEPS
            ))
        self.max_backtrack_steps = max_backtrack_steps
        self.incremental = incremental
        if placement_scoring is None:
            placement_scoring = os.environ.get(
                "TPU_DRA_PLACEMENT_SCORING", "1"
            ) != "0"
        self.placement_scoring = placement_scoring
        # A DefragPlanner (kube/defrag.py) attaches itself here; gang/
        # shortfall unsats then get a read-only migration plan computed.
        self.defrag = None
        # Re-entrant: snapshot() holds the lock across a batch while the
        # per-claim allocate() calls re-enter it.
        self._lock = threading.RLock()
        self._snapshot_depth = 0
        reg = registry if registry is not None else Registry()
        self._m_attempts = Counter(
            "tpu_dra_allocation_attempts_total",
            "Claim allocation attempts by result",
            reg,
        )
        self._m_backtracks = Counter(
            "tpu_dra_allocation_backtracks_total",
            "Device picks undone by the allocation solver",
            reg,
        )
        self._m_solve_seconds = Histogram(
            "tpu_dra_alloc_solve_seconds",
            "End-to-end allocation solve latency",
            reg,
        )
        self._m_funnel_rejections = Counter(
            "tpu_dra_alloc_funnel_rejections_total",
            "Candidate devices rejected by the allocation funnel, by stage",
            reg,
        )
        self._m_unsat = Counter(
            "tpu_dra_alloc_unsat_total",
            "Failed allocation attempts by terminal reason",
            reg,
        )
        # Steps undone during the current solve; folded into the counter
        # once per allocate() (all access is under self._lock).
        self._backtrack_steps = 0
        # Solve decisions (Explanation dicts) for /debug/allocations.
        self._decisions: collections.deque = collections.deque(
            maxlen=int(os.environ.get(
                "TPU_DRA_ALLOC_DECISION_BUFFER", DEFAULT_DECISION_BUFFER
            ))
        )
        # (pool, device) -> claim uid holding it. reservation_version
        # bumps on every mutation — cheap change detection for the
        # defrag planner's retry dedup (hashing 10k reservations per
        # unsat would cost more than the planning it avoids).
        self._reservations: dict[tuple[str, str], str] = {}
        self.reservation_version = 0
        # (pool, counter set, counter) -> amount consumed by reservations.
        self._consumed: dict[tuple[str, str, str], int] = {}
        # claim uid -> [(pool, counter set, counter, amount)] for release.
        self._claim_consumption: dict[str, list[tuple[str, str, str, int]]] = {}
        # (pool, device) pairs already warned about misconfigured counters,
        # so a static slice defect is diagnosed once, not per allocate().
        self._warned_invalid: set[tuple[str, str]] = set()
        # The persistent inventory index (see module docstring): flattened
        # devices, capacities, topology metadata, and static filter
        # verdicts, invalidated by ResourceSlice deltas only.
        self.index = InventoryIndex(self)

    # -- inventory ---------------------------------------------------------

    def _inventory(self) -> tuple[list[dict], dict[tuple[str, str, str], int]]:
        """The index-backed inventory: flattened (pool, node, device)
        dicts + shared-counter capacities keyed (pool, counter set,
        counter). Refreshes the index first unless a snapshot is pinned
        (``snapshot()``); with ``incremental=False`` every call rebuilds
        from scratch."""
        if self._snapshot_depth == 0:
            self.index.refresh(force=not self.incremental)
        return self.index.devices, self.index.capacity

    @contextlib.contextmanager
    def snapshot(self):
        """Pin ONE refreshed inventory snapshot across several solves.

        The batch path and the elastic descending re-solve both probe
        many candidate solutions against the same moment-in-time
        inventory; re-probing the apiserver per attempt buys nothing but
        latency (and lets the inventory shift mid-descent). Re-entrant
        and lock-holding: a snapshot serializes against concurrent
        solves by construction. Reservations still move inside a
        snapshot — only the published inventory is pinned.
        """
        with self._lock:
            self.index.refresh(force=not self.incremental)
            self._snapshot_depth += 1
            try:
                yield self.index
            finally:
                self._snapshot_depth -= 1

    # -- decision record ---------------------------------------------------

    def recent_decisions(self) -> list[dict]:
        """Newest-last snapshot of the solve-decision ring buffer."""
        with self._lock:
            return list(self._decisions)

    def export_allocations_jsonl(self) -> str:
        """The ``/debug/allocations`` payload: one JSON object per solve,
        oldest first (the newest decision is the last line)."""
        return "".join(
            json.dumps(d, sort_keys=True) + "\n"
            for d in self.recent_decisions()
        )

    def _finish(self, expl: Explanation, t0: float, outcome: str,
                reason: str = "", detail: str = "") -> None:
        """Finalize the solve record: stamp outcome/latency, feed the
        funnel-rejection counters, and push onto the ring buffer."""
        expl.outcome = outcome
        expl.reason = reason
        if detail:
            expl.detail = detail
        expl.duration_seconds = time.monotonic() - t0
        expl.timestamp = time.time()
        self._m_solve_seconds.observe(expl.duration_seconds)
        for f in expl.funnels:
            for stage, n in f.rejected.items():
                self._m_funnel_rejections.inc(n, stage=stage)
        if outcome == "ok":
            expl.compact()
        self._decisions.append(expl.to_dict())

    def _emit_unsat_event(self, expl: Explanation) -> None:
        """Deduped UnsatisfiableClaim Warning on the claim — the kubectl-
        describe-visible form of the explanation. Best-effort by the
        recorder's own contract; a nameless claim (pure sim object) is
        skipped."""
        if self.recorder is None or not expl.claim_name:
            return
        from .events import ObjectRef

        hint = RUNBOOK_HINTS.get(expl.reason, "")
        message = f"cannot allocate: {expl.detail or expl.reason}"
        if hint:
            message += f" — {hint}"
        self.recorder.warning(
            ObjectRef.claim(
                expl.claim_name,
                expl.claim_namespace,
                expl.claim_uid,
                api_version=self.api.api_version,
            ),
            "UnsatisfiableClaim",
            message,
        )

    # -- allocation --------------------------------------------------------

    def allocate(
        self,
        claim: dict,
        node_name: Optional[str] = None,
        selectors: Optional[dict[str, list[Selector]]] = None,
        require_healthy: bool = False,
    ) -> dict:
        """Fill claim.status.allocation; returns the claim (mutated).

        ``selectors`` maps request name → extra Selector predicates (the
        CEL-lite substitute). ``node_name`` restricts node-local pools.
        ``require_healthy`` rejects devices whose published ``healthy``
        attribute is false (the elastic gang re-solve: a shrink must
        never land back on the chip that just sickened) — rejections are
        funnel-visible at the ``unhealthy`` stage. On failure raises
        :class:`AllocationError` with ``reason`` and ``explanation``
        populated; either way the decision is recorded for
        ``/debug/allocations``.
        """
        spec = claim.get("spec", {}).get("devices", {})
        requests = spec.get("requests", [])
        constraints = spec.get("constraints", [])
        selectors = selectors or {}
        md = claim.get("metadata", {})
        expl = Explanation(
            claim_uid=md.get("uid", ""),
            claim_name=md.get("name", ""),
            claim_namespace=md.get("namespace", ""),
        )
        # adminAccess requests "ignore all ordinary claims with respect to
        # access modes and any resource allocations" (types.go:448-456):
        # they may land on reserved devices and neither reserve nor consume
        # counters themselves.
        admin_reqs = {r["name"] for r in requests if r.get("adminAccess")}
        with self._lock, child_span(
            "allocator/allocate",
            claim_uid=md.get("uid", ""),
        ) as sp:
            t0 = time.monotonic()
            devices, capacity = self._inventory()
            inventory = [
                d
                for d in devices
                if (not node_name or not d["node"] or d["node"] == node_name)
            ]
            self._backtrack_steps = 0
            try:
                results, picked_devs = self._solve(
                    requests, constraints, selectors, inventory, capacity,
                    expl, require_healthy=require_healthy,
                )
            except Exception as e:
                if self._backtrack_steps:
                    self._m_backtracks.inc(self._backtrack_steps)
                expl.backtracks = self._backtrack_steps
                sp.set_tag("backtracks", self._backtrack_steps)
                self._m_attempts.inc(result="error")
                sp.set_error(str(e))
                if isinstance(e, AllocationError):
                    self._finish(expl, t0, "unsat", e.reason, str(e))
                    if e.explanation is None:
                        e.explanation = expl
                    self._emit_unsat_event(expl)
                else:
                    self._finish(
                        expl, t0, "error", REASON_INTERNAL, str(e)
                    )
                self._m_unsat.inc(reason=expl.reason)
                sp.set_tag("reason", expl.reason)
                # Fragmentation diagnosis: a gang/shortfall unsat on a
                # fleet whose free capacity would fit the claim gets a
                # read-only migration plan (kube/defrag.py). Planning is
                # best-effort; it must never turn an unsat into a crash.
                if self.defrag is not None and expl.reason in (
                    REASON_SHORTFALL, STAGE_GANG,
                ):
                    try:
                        self.defrag.note_unsat(
                            claim, expl, selectors=selectors,
                            require_healthy=require_healthy,
                        )
                    except Exception:
                        logger.exception("defrag planning failed")
                raise
            if self._backtrack_steps:
                self._m_backtracks.inc(self._backtrack_steps)
            expl.backtracks = self._backtrack_steps
            sp.set_tag("backtracks", self._backtrack_steps)
            self._m_attempts.inc(result="ok")
            sp.set_tag("devices", len(picked_devs))
            uid = claim["metadata"]["uid"]
            self.reservation_version += 1
            for r, d in zip(results, picked_devs):
                if r["request"] in admin_reqs:
                    continue
                self._reservations[(r["pool"], r["device"])] = uid
                for pool, cset, cname, amount in _consumption_entries(d):
                    self._consumed[(pool, cset, cname)] = (
                        self._consumed.get((pool, cset, cname), 0) + amount
                    )
                    self._claim_consumption.setdefault(uid, []).append(
                        (pool, cset, cname, amount)
                    )
            self._finish(expl, t0, "ok")
        claim.setdefault("status", {})["allocation"] = {
            "devices": {
                "results": results,
                "config": self._carry_config(spec),
            }
        }
        return claim

    def allocate_batch(
        self,
        claims: list[dict],
        node_name: Optional[str] = None,
        selectors_by_claim: Optional[dict[str, dict[str, list["Selector"]]]] = None,
        require_healthy: bool = False,
    ) -> list[tuple[dict, Optional[AllocationError]]]:
        """Solve a queue of pending claims as one batch.

        All claims share a single index snapshot (one inventory probe,
        one filter-cache warmup) and solve in descending constrainedness
        order — largest device ask first, constraint count as the
        tie-break — because a big gang placed after the singles have
        shredded the mesh is a self-inflicted ``gang`` unsat. Every
        claim still runs through :meth:`allocate`, so per-claim funnels,
        metrics, and ``/debug/allocations`` records are emitted exactly
        as in the one-at-a-time path.

        Returns ``[(claim, error-or-None)]`` in the INPUT order;
        successfully allocated claims carry ``status.allocation``.
        ``selectors_by_claim`` maps claim uid -> the per-request Selector
        lists ``allocate`` takes.
        """
        selectors_by_claim = selectors_by_claim or {}

        def constrainedness(claim: dict) -> tuple[int, int]:
            spec = claim.get("spec", {}).get("devices", {})
            wanted = 0
            for r in spec.get("requests", []):
                if r.get("adminAccess"):
                    continue
                if r.get("allocationMode", "ExactCount") == "ExactCount":
                    wanted += int(r.get("count", 1))
            return (wanted, len(spec.get("constraints", [])))

        order = sorted(
            range(len(claims)),
            key=lambda i: constrainedness(claims[i]),
            reverse=True,
        )
        outcomes: list[Optional[AllocationError]] = [None] * len(claims)
        with self.snapshot():
            for i in order:
                claim = claims[i]
                uid = claim.get("metadata", {}).get("uid", "")
                try:
                    self.allocate(
                        claim,
                        node_name=node_name,
                        selectors=selectors_by_claim.get(uid),
                        require_healthy=require_healthy,
                    )
                except AllocationError as e:
                    outcomes[i] = e
        return [(claims[i], outcomes[i]) for i in range(len(claims))]

    def _carry_config(self, spec: dict) -> list[dict]:
        """Claim-spec configs become FromClaim allocation configs (the
        scheduler does this verbatim copy)."""
        out = []
        for cfg in spec.get("config", []):
            entry = dict(cfg)
            entry["source"] = "FromClaim"
            out.append(entry)
        return out

    def _note_backtrack(self, n: int) -> None:
        self._backtrack_steps += n
        if self._backtrack_steps > self.max_backtrack_steps:
            raise AllocationError(
                f"backtrack budget exhausted after "
                f"{self._backtrack_steps} steps (max "
                f"{self.max_backtrack_steps}; TPU_DRA_MAX_BACKTRACK_STEPS "
                "overrides)",
                reason=REASON_BACKTRACK_BUDGET,
            )

    def _solve(self, requests, constraints, selectors, inventory, capacity,
               expl: Explanation, require_healthy: bool = False):
        """Greedy backtracking over requests with matchAttribute checks,
        shared-counter budgets, and ICI contiguity for multi-chip gangs.

        Returns (allocation results, picked device dicts). Every
        rejection is recorded into ``expl``'s per-request funnels, and
        both candidate lists and CEL evaluations are memoized per solve —
        the search re-enters ``candidates()`` on every probe, and before
        the memo each re-entry re-ran every CEL expression against every
        device (quadratic-and-worse under backtracking).
        """
        match_groups = [
            (set(c.get("requests", [])), c["matchAttribute"].split("/")[-1])
            for c in constraints
            if "matchAttribute" in c
        ]
        # Counters consumed by the in-progress solution, on top of the
        # amounts already reserved by other claims.
        tentative: dict[tuple[str, str, str], int] = {}
        # Per-solve candidate memo: (request name, include_reserved) →
        # candidate list — the search re-enters candidates() on every
        # probe. The static filtering BEHIND it (class/request CEL,
        # invalid-slice) persists across solves in the InventoryIndex;
        # only health and reservations are re-checked here.
        cand_memo: dict[tuple, list] = {}
        index = self.index

        def on_cel_miss():
            expl.cel_evaluations += 1

        def candidates(req, include_reserved=False):
            memo_key = (req["name"], bool(include_reserved))
            memoized = cand_memo.get(memo_key)
            if memoized is not None:
                return memoized
            cel_selectors = [
                s["cel"]["expression"]
                for s in req.get("selectors", [])
                if "cel" in s
            ]
            admin = req.get("adminAccess", False)
            # Static verdicts, cached across solves; the build pass (a
            # cold request shape, or a from-scratch solve) records exact
            # per-stage latencies through static_verdict. CelError and
            # unknown-class surface from here as typed AllocationErrors.
            stage_t = dict.fromkeys(_CANDIDATE_STAGES, 0.0)
            rec = index.filter_record(
                req.get("deviceClassName", ""),
                selectors.get(req["name"], []),
                cel_selectors,
                on_cel_miss=on_cel_miss,
                stage_seconds=stage_t,
            )
            # Only the primary pass populates the funnel: the
            # include_reserved variant exists solely for allocationMode=
            # All's completeness check.
            record = not include_reserved
            if record:
                expl.funnel(req["name"]).entering = len(inventory)
            t0 = time.perf_counter()
            out = []
            reservations = self._reservations
            for d in inventory:
                dk = d["_key"]
                verdict = rec.by_device.get(dk)
                if verdict is not None:
                    # Misconfigured slice / class CEL / request CEL —
                    # replayed from the cached verdict so the funnel
                    # reads identically to a from-scratch solve.
                    if record:
                        expl.reject(req["name"], verdict[0], dk,
                                    verdict[1])
                    continue
                # Health gate (opt-in): the elastic re-solve must steer
                # around chips the node marked degraded — a gone chip is
                # already absent from the republished slice, but a wedged
                # one stays published with healthy=false and would
                # otherwise be picked right back.
                if require_healthy and d["_healthy"] is False:
                    if record:
                        expl.reject(
                            req["name"], STAGE_UNHEALTHY, dk,
                            "unhealthy:published healthy=false",
                        )
                    continue
                # Ordinary requests never see reserved devices; admin
                # requests observe them (monitoring over live workloads).
                # Checked LAST so the funnel reads "the right devices
                # exist but are held", not "nothing matched".
                if not (admin or include_reserved) and dk in reservations:
                    if record:
                        expl.reject(
                            req["name"], STAGE_RESERVED, dk,
                            "reserved:held by claim "
                            f"{reservations[dk]}",
                        )
                    continue
                out.append(d)
            # Replay + per-solve gates run as ONE fused pass (that is the
            # hot-path point); its cost is amortized evenly across the
            # candidate stages, on top of the exact build-pass times.
            share = (time.perf_counter() - t0) / len(_CANDIDATE_STAGES)
            if record:
                expl.funnel(req["name"]).survivors = len(out)
                for stage in _CANDIDATE_STAGES:
                    expl.add_stage_seconds(stage, stage_t[stage] + share)
            cand_memo[memo_key] = out
            return out

        def counters_fit(dev) -> tuple[bool, str]:
            for pool, cset, cname, amount in _consumption_entries(dev):
                key = (pool, cset, cname)
                cap = capacity.get(key)
                if cap is None:
                    # unreachable: _inventory flags these as invalid
                    return False, f"counters:{cset}/{cname} undeclared"
                used = self._consumed.get(key, 0) + tentative.get(key, 0)
                if used + amount > cap:
                    return False, (
                        f"counters:{cset}/{cname} {used}/{cap} used, "
                        f"need {amount}"
                    )
            return True, ""

        def consume(dev) -> None:
            for pool, cset, cname, amount in _consumption_entries(dev):
                key = (pool, cset, cname)
                tentative[key] = tentative.get(key, 0) + amount

        def unconsume(dev) -> None:
            for pool, cset, cname, amount in _consumption_entries(dev):
                key = (pool, cset, cname)
                tentative[key] -= amount

        picked: list[tuple[str, dict]] = []  # (request name, device)
        admin_request_names = {
            r["name"] for r in requests if r.get("adminAccess")
        }

        def picked_blocker(req_admin: bool, d) -> Optional[str]:
            """Admin picks are invisible to ordinary placement and vice
            versa (types.go:448-456) — exclusion applies only between
            requests of the same access kind. Returns the blocking
            request's name (for the funnel) or None."""
            for other_name, p in picked:
                if p is d and (
                    (other_name in admin_request_names) == req_admin
                ):
                    return other_name
            return None

        def consistent(req_name, dev) -> tuple[bool, str]:
            for group, attr in match_groups:
                if req_name not in group:
                    continue
                want = _attr_value(dev["attributes"], attr)
                for other_name, other in picked:
                    if other_name in group:
                        have = _attr_value(other["attributes"], attr)
                        if have != want:
                            return False, (
                                f"constraint:{attr} {want!r} conflicts "
                                f"with request {other_name!r} ({have!r})"
                            )
            return True, ""

        def backtrack(ri: int) -> bool:
            if ri == len(requests):
                return True
            req = requests[ri]
            admin = req.get("adminAccess", False)
            mode = req.get("allocationMode", "ExactCount")
            cands = []
            for d in candidates(req):
                blocker = picked_blocker(admin, d)
                if blocker is not None:
                    # Held by an earlier request of this same claim: a
                    # funnel-visible rejection, or multi-request
                    # contention would misread as whatever filter stage
                    # happened to reject unrelated devices.
                    expl.reject(
                        req["name"], STAGE_RESERVED,
                        (d["pool"], d["name"]),
                        f"reserved:held by request {blocker!r} of "
                        "this claim",
                    )
                    continue
                cands.append(d)
            if mode == "All":
                # Every matching device in scope (types.go:427-429): fails
                # when some are already allocated — unless adminAccess,
                # whose candidates() already includes reserved devices.
                count = len(cands)
                if count == 0:
                    expl.note_request_failure(ri, req["name"])
                    return False
                if not admin:
                    with_reserved = candidates(
                        req, include_reserved=True
                    )
                    if count != len(with_reserved):
                        # Some matching devices already allocated.
                        for d in with_reserved:
                            dk = (d["pool"], d["name"])
                            holder = self._reservations.get(dk)
                            if holder is not None:
                                expl.reject(
                                    req["name"], STAGE_RESERVED, dk,
                                    "reserved:allocationMode=All needs "
                                    "every matching device; held by "
                                    f"claim {holder}",
                                )
                        expl.note_request_failure(ri, req["name"])
                        return False
            elif mode == "ExactCount":
                count = req.get("count", 1)
            else:
                # "Clients must refuse to handle requests with unknown
                # modes" (types.go:435-436).
                raise AllocationError(
                    f"unknown allocationMode {mode!r} in request "
                    f"{req.get('name')!r}",
                    reason=REASON_UNKNOWN_MODE,
                )
            expl.funnel(req["name"]).wanted = count
            # Topology scoring: order candidates so the DFS lands the
            # gang best-fit into the smallest free contiguous sub-mesh
            # (corner-biased) instead of first-fit in inventory order.
            # Pure reordering — the search stays complete, so anything
            # first-fit could satisfy, the scored order can too. The one
            # exception is deliberate: for a pure chip gang (every
            # candidate a coordinate-grounded chip, count >= 2) the box
            # enumeration is COMPLETE — a contiguous sub-mesh IS a dense
            # axis-aligned box — so "no box anywhere" proves the gang
            # unsat and short-circuits what would otherwise be an
            # exponential doomed backtracking search.
            if (
                self.placement_scoring and not admin
                and mode == "ExactCount" and len(cands) > count > 0
            ):
                t = time.perf_counter()
                cands, placement, provably_unsat = self._score_placement(
                    req["name"], cands, count, match_groups
                )
                expl.add_stage_seconds(
                    STAGE_GANG, time.perf_counter() - t
                )
                if placement is not None:
                    expl.placements[req["name"]] = placement
                if provably_unsat and count >= 2:
                    last = cands[-1]
                    expl.reject(
                        req["name"], STAGE_GANG,
                        (last["pool"], last["name"]),
                        f"gang:no free contiguous {count}-chip sub-mesh "
                        "on any slice (scored placement exhausted every "
                        "box)",
                    )
                    expl.note_request_failure(ri, req["name"])
                    return False

            def pick_n(chosen: list) -> bool:
                if len(chosen) == count:
                    # Contiguity is a WORKLOAD constraint (ICI collectives);
                    # admin picks observe, so fragmented sets are fine.
                    if not admin:
                        t = time.perf_counter()
                        ok, why = _gang_contiguous(chosen)
                        expl.add_stage_seconds(
                            STAGE_GANG, time.perf_counter() - t
                        )
                        if not ok:
                            # Keyed by the device that completed the
                            # failing combination — NOT the combination
                            # itself, which backtracking enumerates in
                            # exponential numbers and would turn the
                            # funnel into a measure of search effort.
                            last = chosen[-1]
                            expl.reject(
                                req["name"], STAGE_GANG,
                                (last["pool"], last["name"]), why,
                            )
                            return False
                    for d in chosen:
                        picked.append((req["name"], d))
                    if backtrack(ri + 1):
                        return True
                    for _ in chosen:
                        picked.pop()
                    self._note_backtrack(len(chosen))
                    return False
                start = cands.index(chosen[-1]) + 1 if chosen else 0
                for d in cands[start:]:
                    if d in chosen:
                        continue
                    blocker = picked_blocker(admin, d)
                    if blocker is not None:
                        expl.reject(
                            req["name"], STAGE_RESERVED,
                            (d["pool"], d["name"]),
                            f"reserved:held by request {blocker!r} of "
                            "this claim",
                        )
                        continue
                    t = time.perf_counter()
                    ok, why = consistent(req["name"], d)
                    expl.add_stage_seconds(
                        STAGE_CONSTRAINT, time.perf_counter() - t
                    )
                    if not ok:
                        expl.reject(
                            req["name"], STAGE_CONSTRAINT,
                            (d["pool"], d["name"]), why,
                        )
                        continue
                    # Admin picks consume nothing, so counters are moot.
                    if not admin:
                        t = time.perf_counter()
                        ok, why = counters_fit(d)
                        expl.add_stage_seconds(
                            STAGE_COUNTERS, time.perf_counter() - t
                        )
                        if not ok:
                            expl.reject(
                                req["name"], STAGE_COUNTERS,
                                (d["pool"], d["name"]), why,
                            )
                            continue
                    chosen.append(d)
                    if not admin:
                        consume(d)
                    # Intra-request matchAttribute consistency.
                    if not self._group_ok(req["name"], chosen, match_groups):
                        # Keyed by the newly-added device (see the gang
                        # rejection above): counts stay bounded by
                        # inventory, not by combinations explored.
                        expl.reject(
                            req["name"], STAGE_CONSTRAINT,
                            (d["pool"], d["name"]),
                            "constraint:matchAttribute conflict within "
                            "request",
                        )
                        group_ok = False
                    else:
                        group_ok = True
                    if group_ok and pick_n(chosen):
                        return True
                    if not admin:
                        unconsume(d)
                    chosen.pop()
                    self._note_backtrack(1)
                return False

            ok = pick_n([])
            if not ok:
                expl.note_request_failure(ri, req["name"])
            return ok

        if not backtrack(0):
            reason, detail = expl.terminal()
            raise AllocationError(
                f"no satisfying allocation found: {detail}",
                reason=reason,
            )
        if expl.placements:
            # Did the search land on the scorer's box, or did later
            # stages (counters, constraints, other requests) push it
            # elsewhere? /debug/allocations should say which.
            picked_by_req: dict[str, set] = {}
            for name, dev in picked:
                picked_by_req.setdefault(name, set()).add(dev["name"])
            for rname, pl in expl.placements.items():
                pl["applied"] = (
                    set(pl.get("devices", ())) == picked_by_req.get(rname)
                )
        return [
            {
                "request": name,
                "driver": self.driver_name,
                "pool": dev["pool"],
                "device": dev["name"],
            }
            for name, dev in picked
        ], [dev for _, dev in picked]

    @staticmethod
    def _group_ok(req_name, chosen, match_groups) -> bool:
        for group, attr in match_groups:
            if req_name not in group:
                continue
            vals = {_attr_value(d["attributes"], attr) for d in chosen}
            if len(vals) > 1:
                return False
        return True

    # -- topology scoring --------------------------------------------------

    def _score_placement(
        self, req_name: str, cands: list[dict], count: int, match_groups,
    ) -> tuple[list[dict], Optional[dict], bool]:
        """Best-fit gang placement over the free ICI topology.

        Enumerates every dense ``count``-cell box over each slice's free
        candidate cells and scores it ``(free-component size, corner
        distance)``, both minimized: the smallest free contiguous
        sub-mesh that still fits the gang is consumed first (ParvaGPU's
        best-fit spatial packing), and within it the box hugs a mesh
        corner, so the remaining free cells stay one large unbroken
        region instead of a ring. Boxes that would break a
        ``matchAttribute`` group containing this request are skipped
        up front rather than discovered by backtracking.

        Returns ``(candidates, placement, provably_unsat)``: the
        candidate list reordered (box cells first) plus the placement
        record for ``/debug/allocations``. ``(cands, None, False)``
        when the request is not scorable (non-chip devices, missing or
        duplicated coords) — the solver then behaves exactly as before.
        ``provably_unsat`` is True only when the enumeration covered the
        ENTIRE candidate space (every candidate a scorable chip) and no
        dense box exists: since a contiguous sub-mesh is exactly a
        dense axis-aligned box on one slice, the caller may fail the
        gang immediately instead of backtracking through doomed
        combinations.
        """
        chips = [
            d for d in cands
            if d.get("_type") == "chip" and d.get("_coord") is not None
            and d.get("_slice_id")
        ]
        if len(chips) != len(cands) or len(chips) < count:
            return cands, None, False
        per_slice: dict[str, list[dict]] = {}
        for d in chips:
            per_slice.setdefault(str(d["_slice_id"]), []).append(d)
        group_attrs = [
            attr for group, attr in match_groups if req_name in group
        ]
        best = None  # (comp size, corner, slice_id, origin, dims, cells)
        # Best-fit at slice granularity first: slices ordered by free
        # candidate count ascending, and the scan STOPS at the first
        # slice that yields any box — the tightest slice that still fits
        # the gang absorbs it, keeping emptier slices whole for larger
        # gangs. (Scanning every slice per solve was the allocator's
        # hottest path at 10k devices; provable unsat still requires —
        # and gets — the full scan, because no slice yields a box.)
        ordered_slices = sorted(
            per_slice.items(), key=lambda kv: (len(kv[1]), kv[0])
        )
        for slice_id, devs in ordered_slices:
            if len(devs) < count:
                continue
            meta = self.index.slice_meta(slice_id)
            if meta is None:
                continue
            shape, _ = meta
            by_coord = {d["_coord"].as_tuple(): d for d in devs}
            if len(by_coord) != len(devs):
                return cands, None, False  # duplicated coords: not scorable
            free = set(by_coord)
            comp_size: dict[tuple, int] = {}
            for comp in free_components(free):
                if len(comp) < count:
                    continue  # a count-cell box cannot fit there anyway
                for cell in comp:
                    comp_size[cell] = len(comp)
            for dx, dy, dz in box_shapes(count, shape):
                for ox in range(shape.x - dx + 1):
                    for oy in range(shape.y - dy + 1):
                        for oz in range(shape.z - dz + 1):
                            origin = (ox, oy, oz)
                            comp = comp_size.get(origin)
                            if comp is None:
                                continue
                            cells = [
                                (ox + ix, oy + iy, oz + iz)
                                for ix in range(dx)
                                for iy in range(dy)
                                for iz in range(dz)
                            ]
                            if not free.issuperset(cells):
                                continue
                            if group_attrs and not self._box_uniform(
                                by_coord, cells, group_attrs
                            ):
                                continue
                            corner = (
                                min(ox, shape.x - ox - dx)
                                + min(oy, shape.y - oy - dy)
                                + min(oz, shape.z - oz - dz)
                            )
                            key = (comp, corner, slice_id, origin,
                                   (dx, dy, dz), cells)
                            if best is None or key[:4] < best[:4]:
                                best = key
                                if comp == count and corner == 0:
                                    break  # perfect fit; stop searching
                        else:
                            continue
                        break
                    else:
                        continue
                    break
                if best is not None and best[0] == count and best[1] == 0:
                    break
            if best is not None:
                break  # tightest fitting slice found; emptier ones stay whole
        if best is None:
            # Provable only without matchAttribute involvement: a box
            # skipped for group non-uniformity would fail the solver at
            # the `constraint` stage, and that terminal reason (not
            # `gang`) is the explainability contract for it.
            return cands, None, not group_attrs
        comp, corner, slice_id, origin, dims, cells = best
        chosen = {
            c: d for c, d in (
                (d["_coord"].as_tuple(), d) for d in per_slice[slice_id]
            ) if c in set(cells)
        }
        ordered = [chosen[c] for c in cells]
        ordered_keys = {d["_key"] for d in ordered}
        rest = [d for d in cands if d["_key"] not in ordered_keys]
        placement = {
            "strategy": "best-fit",
            "sliceId": slice_id,
            "origin": f"{origin[0]},{origin[1]},{origin[2]}",
            "box": f"{dims[0]}x{dims[1]}x{dims[2]}",
            "score": {"freeComponent": comp, "cornerDistance": corner},
            "devices": [d["name"] for d in ordered],
            "applied": False,
        }
        return ordered + rest, placement, False

    @staticmethod
    def _box_uniform(by_coord, cells, group_attrs) -> bool:
        """Every matchAttribute group value uniform across the box."""
        for attr in group_attrs:
            vals = {
                _attr_value(by_coord[c]["attributes"], attr) for c in cells
            }
            if len(vals) > 1:
                return False
        return True

    # -- release -----------------------------------------------------------

    def deallocate(self, claim_uid: str) -> None:
        with self._lock:
            self.reservation_version += 1
            self._reservations = {
                k: v for k, v in self._reservations.items() if v != claim_uid
            }
            for pool, cset, cname, amount in self._claim_consumption.pop(
                claim_uid, []
            ):
                self._consumed[(pool, cset, cname)] -= amount

    def restore_reservations(
        self, claim_uid: str, results: list[dict]
    ) -> None:
        """Re-register reservations (and counter consumption) for a
        claim whose devices are ALREADY prepared on a node.

        The elastic coordinator's failure seam: a gang re-solve starts
        with ``deallocate``, and when every candidate size goes unsat
        the claim keeps running on its existing devices — which must not
        be left looking free, or the next solve double-books chips that
        are exclusively held. ``results`` is the claim's current
        allocation (wire form); devices already reserved by this claim
        are skipped, so the call is idempotent.
        """
        with self._lock:
            self.reservation_version += 1
            devices, _ = self._inventory()
            by_key = {(d["pool"], d["name"]): d for d in devices}
            for r in results:
                key = (r["pool"], r["device"])
                if self._reservations.get(key) == claim_uid:
                    continue
                holder = self._reservations.get(key)
                if holder is not None:
                    logger.warning(
                        "restore_reservations: device %s/%s already held "
                        "by %s; leaving it", key[0], key[1], holder,
                    )
                    continue
                self._reservations[key] = claim_uid
                dev = by_key.get(key)
                if dev is None:
                    continue
                for pool, cset, cname, amount in _consumption_entries(dev):
                    self._consumed[(pool, cset, cname)] = (
                        self._consumed.get((pool, cset, cname), 0) + amount
                    )
                    self._claim_consumption.setdefault(
                        claim_uid, []
                    ).append((pool, cset, cname, amount))
