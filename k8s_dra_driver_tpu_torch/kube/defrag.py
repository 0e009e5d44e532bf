"""Read-only defragmentation planner for gang claims stuck on a
fragmented fleet.

When a gang claim goes unsat with terminal reason ``gang`` or
``shortfall`` even though the fleet's total free chip capacity would fit
it, the capacity exists but is shredded across the ICI mesh. This module
answers the operator's next question — *which* claims would have to move
*where* to admit the gang — without moving anything: it proposes a
minimal migration plan (fewest displaced claims first), scored with the
same best-fit/corner-bias discipline the allocator's placement scorer
uses, so the plan it proposes is one the scorer would actually have
picked.

The planner attaches to a :class:`~.allocator.ReferenceAllocator`
(``allocator.defrag = planner``, done by the constructor); the allocator
calls :meth:`note_unsat` from its unsat path, under its own lock. Plans
land in a bounded ring buffer served as JSON at ``/debug/defrag``
(``MetricsServer.set_defrag_provider``) and feed the
``tpu_dra_defrag_*`` metric families.

The planner itself never moves anything. Execution lives in
:mod:`.defrag_executor` (opt-in, ``--defrag-execute`` on the driver):
each plan is stamped with a ``planId`` and the ``sig`` (inventory
generation + reservation version) it was computed against, so the
executor can refuse a stale plan, and when an executor is attached
(``planner.executor``, set by its constructor) the ``/debug/defrag``
payload grows an ``executions`` trail next to the plans.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, Optional

from ..tpulib.topology import box_shapes, free_components
from ..utils.metrics import Counter, Gauge, Histogram, Registry

logger = logging.getLogger(__name__)

# Plan outcomes (the `outcome` label on tpu_dra_defrag_plans_total).
OUTCOME_PLANNED = "planned"
OUTCOME_UNPLANNABLE = "unplannable"
OUTCOME_INSUFFICIENT = "insufficient-capacity"
OUTCOME_NO_TOPOLOGY = "no-topology"

OUTCOMES = (
    OUTCOME_PLANNED,
    OUTCOME_UNPLANNABLE,
    OUTCOME_INSUFFICIENT,
    OUTCOME_NO_TOPOLOGY,
)

# Plans kept for /debug/defrag.
DEFAULT_PLAN_BUFFER = 32
# Candidate target boxes examined per plan, across all slices — planning
# runs inline on the unsat path and must stay bounded no matter how
# pathological the mesh is.
DEFAULT_MAX_BOXES = 512


class DefragPlanner:
    """Proposes (never executes) migrations that would free a contiguous
    sub-mesh for a stuck gang claim."""

    def __init__(
        self,
        allocator,
        registry: Optional[Registry] = None,
        max_plans: int = DEFAULT_PLAN_BUFFER,
        max_boxes: int = DEFAULT_MAX_BOXES,
    ):
        self.allocator = allocator
        self.max_boxes = max_boxes
        reg = registry if registry is not None else Registry()
        self._m_plans = Counter(
            "tpu_dra_defrag_plans_total",
            "Defragmentation plans computed for unsat gang claims, by "
            "outcome",
            reg,
        )
        self._m_migrations = Gauge(
            "tpu_dra_defrag_last_plan_migrations",
            "Migrations proposed by the most recent defrag plan "
            "(0 when the last plan found no feasible migration set)",
            reg,
        )
        self._m_freed = Gauge(
            "tpu_dra_defrag_last_plan_freed_devices",
            "Devices the most recent plan's target box would free for "
            "the stuck gang",
            reg,
        )
        self._m_seconds = Histogram(
            "tpu_dra_defrag_plan_seconds",
            "Defrag planning latency per unsat gang claim",
            reg,
        )
        self._plans: collections.deque = collections.deque(maxlen=max_plans)
        # claim uid -> (index generation, reservation version) of the
        # last computed plan: a scheduler retrying a stuck claim every
        # sync period must not re-plan (and re-append near-identical
        # plans, evicting everyone else's) while nothing has changed.
        self._last_sig: dict[str, tuple] = {}
        # Monotonic plan-id counter; an attached DefragExecutor (set by
        # its constructor) contributes the executions view to
        # export_json and keys its trail on these ids.
        self._plan_seq = 0
        self.executor = None
        allocator.defrag = self

    # -- reading -----------------------------------------------------------

    def recent_plans(self) -> list[dict]:
        """Newest-last snapshot of the plan ring buffer."""
        return list(self._plans)

    def export_json(self) -> dict[str, Any]:
        """The ``/debug/defrag`` payload."""
        out: dict[str, Any] = {
            "plans": self.recent_plans(),
            "note": (
                "plans are proposals until executed; execution (opt-in "
                "--defrag-execute) drains/reshards the listed claims "
                "through the gateway and elastic resize protocols "
                "(docs/operations.md: fleet is fragmented)"
            ),
        }
        if self.executor is not None:
            out["executions"] = self.executor.export_executions()
        return out

    # -- planning ----------------------------------------------------------

    def note_unsat(
        self, claim: dict, expl, selectors=None,
        require_healthy: bool = False,
    ) -> dict:
        """Compute (and record) a plan for one unsat gang claim.

        Called by the allocator under its lock, so reservations and the
        inventory index are coherent for the duration. ``selectors`` /
        ``require_healthy`` are the solve's own arguments: the target
        box is restricted to devices the CLAIM could actually use, so a
        "planned" outcome is never a proposal on a slice the claim's
        selectors exclude (or on the wedged chip a healthy-only re-solve
        is steering around). Never raises into the solve path — the
        allocator wraps it — but returns the plan record for tests and
        tools.
        """
        t0 = time.monotonic()
        md = claim.get("metadata", {})
        uid = md.get("uid", "")
        # Retry dedup: same inventory generation + same reservation
        # state = same plan; return the recorded one instead of
        # re-enumerating boxes inline on the solve path.
        sig = (
            self.allocator.index.generation,
            self.allocator.reservation_version,
        )
        if self._last_sig.get(uid) == sig:
            for p in reversed(self._plans):
                if p["claim"]["uid"] == uid:
                    return p
        plan: dict[str, Any] = {
            "ts": round(time.time(), 3),
            "claim": {
                "uid": md.get("uid", ""),
                "name": md.get("name", ""),
                "namespace": md.get("namespace", ""),
            },
            "reason": expl.reason,
            "wanted": 0,
            "outcome": OUTCOME_UNPLANNABLE,
            "detail": "",
            "migrations": [],
        }
        wanted = self._wanted_chips(claim)
        plan["wanted"] = wanted
        if wanted < 1:
            plan["outcome"] = OUTCOME_NO_TOPOLOGY
            plan["detail"] = (
                "claim requests no chip-class devices; defrag plans only "
                "cover ICI chip gangs"
            )
            return self._finish(plan, t0)
        index = self.allocator.index
        reservations = self.allocator._reservations
        slice_ids = index.slice_ids()
        if not slice_ids:
            plan["outcome"] = OUTCOME_NO_TOPOLOGY
            plan["detail"] = "no slice publishes grounded chip coordinates"
            return self._finish(plan, t0)
        # Devices the stuck claim could actually land on (its class +
        # selectors + health gate); None = not derivable (multi-request
        # gang), plan on the full topology as a best effort.
        eligible = self._eligible_keys(claim, selectors, require_healthy)
        free_total = 0
        per_slice: list[tuple[str, Any, dict, dict, set]] = []
        for sid in slice_ids:
            shape, cells = index.slice_meta(sid)
            free = {}
            held = {}
            dest_free = set()  # mover destinations: any unreserved cell
            for coord, dev in cells.items():
                if dev.get("invalid"):
                    continue
                holder = reservations.get(dev["_key"])
                usable = eligible is None or dev["_key"] in eligible
                if holder is None:
                    dest_free.add(coord)
                    if usable:
                        free[coord] = dev
                elif usable:
                    held[coord] = (dev, holder)
            free_total += len(free)
            per_slice.append((sid, shape, free, held, dest_free))
        if free_total < wanted:
            plan["outcome"] = OUTCOME_INSUFFICIENT
            plan["detail"] = (
                f"only {free_total} free chip(s) fleet-wide for a "
                f"{wanted}-chip gang — this is a capacity problem, not "
                "fragmentation"
            )
            return self._finish(plan, t0)
        plan["freeDevices"] = free_total
        best = None
        examined = 0
        # Claim uid -> all its reserved device keys (movability needs the
        # claim's WHOLE holding, not just the chips inside one box).
        holdings: dict[str, list] = {}
        for dev_key, uid in reservations.items():
            holdings.setdefault(uid, []).append(dev_key)
        for sid, shape, free, held, dest_free in per_slice:
            if len(free) + len(held) < wanted:
                continue
            candidate = self._plan_slice(
                sid, shape, free, held, dest_free, holdings, wanted,
                index, budget=self.max_boxes - examined,
            )
            examined += candidate.pop("examined", 0)
            if candidate.get("migrations") is not None and (
                best is None
                or len(candidate["migrations"]) < len(best["migrations"])
            ):
                best = candidate
            if examined >= self.max_boxes:
                break
        plan["examinedBoxes"] = examined
        if best is None:
            plan["detail"] = (
                f"no {wanted}-chip box can be freed by migrating movable "
                f"claims (examined {examined} candidate box(es))"
            )
            return self._finish(plan, t0)
        plan.update(best)
        plan["outcome"] = OUTCOME_PLANNED
        plan["detail"] = (
            f"moving {len(best['migrations'])} claim(s) frees a "
            f"{best['box']} box at {best['origin']} on slice "
            f"{best['sliceId']} for the {wanted}-chip gang"
        )
        return self._finish(plan, t0)

    def _finish(self, plan: dict, t0: float) -> dict:
        # Execution pinning: the id names this plan in the executor's
        # trail, and the sig is the exact allocator state the migrations
        # were computed against — the executor refuses to run a plan
        # whose sig no longer matches (anything could have moved).
        self._plan_seq += 1
        plan["planId"] = f"plan-{self._plan_seq}"
        plan["sig"] = {
            "generation": self.allocator.index.generation,
            "reservationVersion": self.allocator.reservation_version,
        }
        self._m_plans.inc(outcome=plan["outcome"])
        self._m_seconds.observe(time.monotonic() - t0)
        self._m_migrations.set(len(plan["migrations"]))
        self._m_freed.set(
            plan["wanted"] if plan["outcome"] == OUTCOME_PLANNED else 0
        )
        self._plans.append(plan)
        if len(self._last_sig) > 512:
            self._last_sig.clear()  # crude bound; dedup rebuilds fast
        self._last_sig[plan["claim"]["uid"]] = (
            self.allocator.index.generation,
            self.allocator.reservation_version,
        )
        return plan

    def _eligible_keys(
        self, claim: dict, selectors, require_healthy: bool,
    ) -> Optional[set]:
        """Device keys the claim's (single) chip request accepts, via
        the allocator's own cached filter machinery — the plan's target
        box must be placeable FOR THIS CLAIM, not just geometrically
        free. None when the claim has several chip requests (their
        per-request filters differ; plan unrestricted, best-effort)."""
        from .allocator import DEVICE_CLASS_TYPES

        spec = claim.get("spec", {}).get("devices", {})
        reqs = [
            r for r in spec.get("requests", [])
            if not r.get("adminAccess")
            and r.get("allocationMode", "ExactCount") == "ExactCount"
            and DEVICE_CLASS_TYPES.get(
                r.get("deviceClassName", ""), "chip") == "chip"
        ]
        if len(reqs) != 1:
            return None
        req = reqs[0]
        cel_exprs = [
            s["cel"]["expression"]
            for s in req.get("selectors", []) if "cel" in s
        ]
        prog = (selectors or {}).get(req.get("name", ""), [])
        index = self.allocator.index
        try:
            rec = index.filter_record(
                req.get("deviceClassName", ""), prog, cel_exprs,
            )
        except Exception:
            return None  # malformed selectors: plan unrestricted
        out = set()
        for key, verdict in rec.by_device.items():
            if verdict is not None:
                continue
            if require_healthy:
                dev = index.by_key.get(key)
                if dev is not None and dev.get("_healthy") is False:
                    continue
            out.add(key)
        return out

    @staticmethod
    def _wanted_chips(claim: dict) -> int:
        """Total chip-class devices the claim asks for (the gang size a
        freed box must cover)."""
        from .allocator import DEVICE_CLASS_TYPES

        wanted = 0
        spec = claim.get("spec", {}).get("devices", {})
        for r in spec.get("requests", []):
            if r.get("adminAccess"):
                continue
            if r.get("allocationMode", "ExactCount") != "ExactCount":
                continue
            cls = r.get("deviceClassName", "")
            # With class CEL the type is not derivable from the name;
            # assume chip (the planner's output is advisory either way).
            if DEVICE_CLASS_TYPES.get(cls, "chip") == "chip":
                wanted += int(r.get("count", 1))
        return wanted

    def _plan_slice(
        self, sid, shape, free, held, dest_free, holdings, wanted, index,
        budget,
    ) -> dict:
        """Try to free one ``wanted``-cell box on this slice. Returns a
        dict with ``migrations`` (None when no box works) plus the count
        of boxes ``examined``."""
        all_cells = set(free) | set(held)
        candidates = []  # (n blocker claims, blocked cells, corner, ...)
        examined = 0
        for dims in box_shapes(wanted, shape):
            dx, dy, dz = dims
            for ox in range(shape.x - dx + 1):
                for oy in range(shape.y - dy + 1):
                    for oz in range(shape.z - dz + 1):
                        if examined >= budget:
                            break
                        examined += 1
                        cells = [
                            (ox + ix, oy + iy, oz + iz)
                            for ix in range(dx)
                            for iy in range(dy)
                            for iz in range(dz)
                        ]
                        if not all(c in all_cells for c in cells):
                            continue  # box leaves the published mesh
                        blockers = {
                            held[c][1] for c in cells if c in held
                        }
                        if not blockers:
                            # A fully-free box exists — the claim's unsat
                            # was not this slice's fragmentation; no plan
                            # from here.
                            continue
                        corner = (
                            min(ox, shape.x - ox - dx)
                            + min(oy, shape.y - oy - dy)
                            + min(oz, shape.z - oz - dz)
                        )
                        candidates.append(
                            (len(blockers),
                             sum(1 for c in cells if c in held),
                             corner, (ox, oy, oz), dims, cells, blockers)
                        )
                    if examined >= budget:
                        break
                if examined >= budget:
                    break
            if examined >= budget:
                break
        candidates.sort(key=lambda c: c[:4])
        for nblock, _, _, origin, dims, cells, blockers in candidates:
            migrations = self._relocate_blockers(
                sid, shape, dest_free, holdings, cells, blockers, index,
            )
            if migrations is not None:
                return {
                    "examined": examined,
                    "sliceId": sid,
                    "origin": f"{origin[0]},{origin[1]},{origin[2]}",
                    "box": f"{dims[0]}x{dims[1]}x{dims[2]}",
                    "migrations": migrations,
                }
        return {"examined": examined, "migrations": None}

    def _relocate_blockers(
        self, sid, shape, dest_free, holdings, box_cells, blockers, index,
    ) -> Optional[list[dict]]:
        """Greedy sequential re-placement of every blocker claim out of
        the target box; None when any blocker cannot move. Earlier
        movers' vacated cells (outside the box) become destinations for
        later movers — the order is smallest holding first, so the easy
        moves don't strand the hard ones. Destinations draw from EVERY
        unreserved cell (``dest_free``), not just cells the stuck claim
        could use: the movers' own constraints are unknown, so their
        placements are advisory."""
        _, slice_cells = index.slice_meta(sid)
        box = set(box_cells)
        avail = {c for c in dest_free if c not in box}
        migrations = []
        for uid in sorted(
            blockers, key=lambda u: (len(holdings.get(u, [])), u)
        ):
            dev_keys = holdings.get(uid, [])
            coords = []
            for dk in dev_keys:
                dev = index.by_key.get(dk)
                if (
                    dev is None or dev.get("_type") != "chip"
                    or dev.get("_coord") is None
                    or str(dev.get("_slice_id")) != str(sid)
                ):
                    # The claim holds devices the planner cannot re-place
                    # (partitions, other slices, unpublished): immovable.
                    return None
                coords.append(dev["_coord"].as_tuple())
            dims = self._bounding_dims(coords)
            if dims is None:
                return None  # not a dense box; re-placement ill-defined
            dest = self._find_destination(shape, avail, dims)
            if dest is None:
                return None
            dest_cells, score = dest
            for c in dest_cells:
                avail.discard(c)
            for c in coords:
                if c not in box:
                    avail.add(c)
            migrations.append({
                "claimUid": uid,
                "devices": sorted(
                    slice_cells[c]["name"] for c in coords
                    if c in slice_cells
                ),
                "to": sorted(
                    slice_cells[c]["name"] for c in dest_cells
                    if c in slice_cells
                ),
                # Destination coordinates in selector form ("x,y,z"):
                # the executor re-solves each mover pinned to exactly
                # these cells, so the applied placement IS the planned
                # one (not merely a placement of the same shape).
                "toCoords": sorted(
                    f"{c[0]},{c[1]},{c[2]}" for c in dest_cells
                ),
                "box": f"{dims[0]}x{dims[1]}x{dims[2]}",
                "score": score,
            })
        return migrations

    @staticmethod
    def _bounding_dims(coords) -> Optional[tuple[int, int, int]]:
        xs = [c[0] for c in coords]
        ys = [c[1] for c in coords]
        zs = [c[2] for c in coords]
        dims = (
            max(xs) - min(xs) + 1,
            max(ys) - min(ys) + 1,
            max(zs) - min(zs) + 1,
        )
        if dims[0] * dims[1] * dims[2] != len(set(coords)):
            return None
        return dims

    @staticmethod
    def _find_destination(shape, avail, dims):
        """Best-fit placement of a dims-shaped box into the available
        cells: smallest free component, then corner bias — the same
        scoring the allocator applies, so a plan's destinations are ones
        a subsequent scored re-solve would actually choose."""
        comp_size = {}
        need = dims[0] * dims[1] * dims[2]
        for comp in free_components(avail):
            if len(comp) < need:
                continue
            for cell in comp:
                comp_size[cell] = len(comp)
        best = None
        dx, dy, dz = dims
        for ox in range(shape.x - dx + 1):
            for oy in range(shape.y - dy + 1):
                for oz in range(shape.z - dz + 1):
                    origin = (ox, oy, oz)
                    if origin not in comp_size:
                        continue
                    cells = [
                        (ox + ix, oy + iy, oz + iz)
                        for ix in range(dx)
                        for iy in range(dy)
                        for iz in range(dz)
                    ]
                    if not all(c in avail for c in cells):
                        continue
                    corner = (
                        min(ox, shape.x - ox - dx)
                        + min(oy, shape.y - oy - dy)
                        + min(oz, shape.z - oz - dz)
                    )
                    key = (comp_size[origin], corner, origin)
                    if best is None or key < best[0]:
                        best = (key, cells)
        if best is None:
            return None
        (comp, corner, _), cells = best
        return cells, {"freeComponent": comp, "cornerDistance": corner}
