"""Defrag plan execution: orchestrated live migrations that un-strand
gang claims.

The :mod:`.defrag` planner proposes which blocker claims must move where
to free a contiguous box for a stuck gang claim — and stops there. This
module is the actuation half: it takes one ``planned`` plan and executes
it end to end, crash-consistently, with zero admitted-request loss for
drained serving replicas and loss continuity for live-resharded training
gangs.

Execution discipline (the PR-6/PR-10 two-phase intent protocol extended
from one claim to a multi-claim plan):

1. **Pin.** The whole execution runs under one ``allocator.snapshot()``;
   the plan's ``sig`` (inventory generation + reservation version) must
   still match, or the plan is refused as stale (:class:`StalePlanError`)
   — anything could have moved since it was computed.
2. **Intent.** A per-plan execution intent (the plan, each blocker's
   current holdings in allocation wire form, per-step status) is written
   atomically to ``intent_path`` BEFORE anything moves
   (``defrag.intent-write``). From here a crash rolls *forward*.
3. **Migrate.** Per blocker: drain its serving replicas through the
   gateway's zero-loss drain (``defrag.drain``), re-place it with the
   allocator's best-fit scorer pinned to the planned destination cells
   (``defrag.replace``), rewrite node state through the elastic resize
   protocol when the claim is prepared locally, notify migration
   listeners (training gangs live-reshard via
   ``ElasticTrainer.relocate``), resume the drained replicas, then
   checkpoint the step as done.
4. **Admit.** Solve the originally-stuck claim (``defrag.admit``), clear
   the intent, and record the execution as ``completed``.

A NON-crash failure at any step rolls the whole plan back in reverse —
movers return to their original devices (``restore_reservations`` + an
elastic resize back), drained replicas resume — and the intent is
cleared; the execution records as ``rolled-back``. A crash
(``faults.CrashPoint``, the SIGKILL analog) runs no rollback: the intent
stays on disk and the restarted executor's :meth:`DefragExecutor.recover`
converges it, forward when the migrations can still complete, back
otherwise. An intent neither path can clear is surfaced by the
StateAuditor's ``defrag`` check — loud, never silent.

Executions land in a bounded ring served as the ``executions`` view of
``/debug/defrag`` (the planner delegates here when an executor is
attached) and feed the ``tpu_dra_defrag_exec_*`` metric family.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from ..utils import faults
from ..utils.fs import atomic_write_json
from ..utils.metrics import Counter, Gauge, Histogram, Registry
from .allocator import Selector
from .defrag import OUTCOME_PLANNED

logger = logging.getLogger(__name__)

# Execution record states (the /debug/defrag `executions` view).
STATE_IN_FLIGHT = "in-flight"
STATE_COMPLETED = "completed"
STATE_ROLLED_BACK = "rolled-back"
STATE_REFUSED = "refused"
STATE_FAILED = "failed"

# tpu_dra_defrag_exec_executions_total outcome labels. "stale-plan" is a
# refusal because the allocator moved under the plan; "refused" a
# refusal for any other reason (not a planned plan, execution already in
# flight); "failed" means the rollback itself failed and the intent was
# left on disk for the auditor.
EXEC_OUTCOMES = (
    "completed", "rolled-back", "stale-plan", "refused", "failed",
)
STEP_KINDS = ("intent-write", "drain", "replace", "admit")
STEP_OUTCOMES = ("ok", "failed")

DEFAULT_EXECUTION_BUFFER = 32


class DefragExecutionError(RuntimeError):
    """A defrag execution was refused or failed. Unless the message says
    the intent was left on disk, the fleet reads exactly as before the
    attempt."""


class StalePlanError(DefragExecutionError):
    """The plan's ``sig`` no longer matches the allocator: reservations
    or inventory moved since it was computed, so its migrations describe
    a fleet that no longer exists. Re-plan (the next unsat solve does)
    and execute the fresh plan instead."""


class DefragExecutor:
    """Executes one ``planned`` DefragPlanner plan crash-consistently.

    Collaborators are all optional except the planner/allocator pair:
    ``state`` (a :class:`~..plugin.device_state.DeviceState`) rewrites
    node-local holds/CDI through the elastic resize protocol for movers
    prepared on this node; ``gateway`` (a
    :class:`~..serving_gateway.gateway.ServingGateway`) drains and
    resumes serving replicas bound to a mover's claim; ``events`` (a
    :class:`~.events.EventRecorder`) narrates the execution on the stuck
    claim. Migration listeners registered with
    :meth:`add_migration_listener` are told each mover's new device set
    (and, on rollback, its original one) — the seam training harnesses
    use to live-reshard an :class:`~..parallel.elastic.ElasticTrainer`
    onto the relocated gang.
    """

    def __init__(
        self,
        planner,
        allocator,
        *,
        intent_path: str,
        state=None,
        gateway=None,
        registry: Optional[Registry] = None,
        events=None,
        driver_name: str = "tpu.google.com",
        device_class: str = "tpu.google.com",
        node_name: str = "",
        max_executions: int = DEFAULT_EXECUTION_BUFFER,
    ):
        self.planner = planner
        self.allocator = allocator
        self.intent_path = intent_path
        self.state = state
        self.gateway = gateway
        self.events = events
        self.driver_name = driver_name
        self.device_class = device_class
        self.node_name = node_name
        self._listeners: list[Callable[[str, list[str]], None]] = []
        self._executions: collections.deque = collections.deque(
            maxlen=max_executions
        )
        self._lock = threading.RLock()
        self._executing = False
        self._inflight: frozenset[str] = frozenset()
        reg = registry if registry is not None else Registry()
        self._m_execs = Counter(
            "tpu_dra_defrag_exec_executions_total",
            "Defrag plan executions, by outcome (completed, rolled-back, "
            "stale-plan, refused, failed)",
            reg,
        )
        self._m_steps = Counter(
            "tpu_dra_defrag_exec_steps_total",
            "Defrag execution steps, by kind (intent-write/drain/replace/"
            "admit) and outcome",
            reg,
        )
        self._m_seconds = Histogram(
            "tpu_dra_defrag_exec_seconds",
            "End-to-end defrag plan execution latency (including "
            "rollback when one runs)",
            reg,
        )
        self._m_last_ts = Gauge(
            "tpu_dra_defrag_exec_last_execution_timestamp_seconds",
            "Wall-clock time of the most recently finished defrag "
            "execution (0 until one runs)",
            reg,
        )
        self._m_in_flight = Gauge(
            "tpu_dra_defrag_exec_in_flight",
            "1 while a defrag plan execution (or crash recovery) is in "
            "flight, else 0",
            reg,
        )
        for o in EXEC_OUTCOMES:
            self._m_execs.inc(0, outcome=o)
        for k in STEP_KINDS:
            for o in STEP_OUTCOMES:
                self._m_steps.inc(0, kind=k, outcome=o)
        self._m_last_ts.set(0)
        self._m_in_flight.set(0)
        planner.executor = self

    # -- reading -----------------------------------------------------------

    def export_executions(self) -> list[dict]:
        """Newest-last execution records (the ``executions`` view the
        planner splices into ``/debug/defrag``). JSON round-trip so the
        HTTP thread never serializes a record mid-mutation."""
        with self._lock:
            return json.loads(json.dumps(list(self._executions)))

    def add_migration_listener(
        self, fn: Callable[[str, list[str]], None]
    ) -> None:
        """``fn(claim_uid, device_names)`` is called after each mover's
        placement is applied (and again with the ORIGINAL names if the
        plan rolls back). A listener exception fails the migration —
        loss continuity for a training gang depends on the reshard
        actually happening, so it must not be fire-and-forget."""
        self._listeners.append(fn)

    def in_flight_uids(self) -> frozenset[str]:
        """Claim uids an in-flight execution is allowed to leave
        mid-transition (the auditor's resize-check exclusion)."""
        if not self._executing:
            return frozenset()
        return self._inflight

    def orphaned_intent(self) -> Optional[dict]:
        """The on-disk execution intent when NO execution is in flight —
        recovery/rollback should have cleared it, so its existence is
        drift (the auditor's ``defrag`` check reports it)."""
        if self._executing:
            return None
        doc = self._load_intent()
        if doc is not None and "error" not in doc:
            doc = dict(doc)
            doc["path"] = self.intent_path
        return doc

    # -- execution ---------------------------------------------------------

    def execute(
        self,
        plan: dict,
        claim: Optional[dict] = None,
        *,
        selectors: Optional[dict[str, list[Selector]]] = None,
        require_healthy: bool = False,
    ) -> dict:
        """Execute one ``planned`` plan; returns the execution record.

        ``claim``/``selectors``/``require_healthy`` are the stuck
        claim's own solve arguments when the caller has them (the admit
        step re-runs the exact solve that went unsat); without them the
        admit claim is synthesized from the plan. Raises
        :class:`StalePlanError` when the allocator moved under the plan,
        :class:`DefragExecutionError` after a successful rollback (the
        message says why) or a failed one (the message says the intent
        was left on disk). A simulated crash (``CrashPoint``) propagates
        with NO rollback — that is the point: :meth:`recover` on the
        restarted executor converges the on-disk intent.
        """
        t0 = time.monotonic()
        with self._lock:
            record = self._new_record(
                plan.get("planId", ""), plan.get("claim", {})
            )
            if self._executing:
                record["state"] = STATE_REFUSED
                record["detail"] = "an execution is already in flight"
                self._finish(record, t0, "refused")
                raise DefragExecutionError(record["detail"])
            if plan.get("outcome") != OUTCOME_PLANNED:
                record["state"] = STATE_REFUSED
                record["detail"] = (
                    f"plan outcome {plan.get('outcome')!r} is not "
                    f"executable (only {OUTCOME_PLANNED!r} plans are)"
                )
                self._finish(record, t0, "refused")
                raise DefragExecutionError(record["detail"])
            self._begin(record, plan)
            try:
                with self.allocator.snapshot():
                    try:
                        self._check_sig(plan)
                        intent = self._build_intent(
                            plan, claim, selectors, require_healthy
                        )
                    except StalePlanError as e:
                        record["state"] = STATE_REFUSED
                        record["detail"] = str(e)
                        self._finish(record, t0, "stale-plan")
                        raise
                    try:
                        self._write_intent(intent, record)
                        for mig in intent["migrations"]:
                            self._run_migration(intent, mig, record)
                            mig["status"] = "done"
                            atomic_write_json(self.intent_path, intent)
                        self._admit(intent, record)
                    except Exception as e:
                        self._fail_and_rollback(intent, record, t0, e)
                    # The admit solved a sanitized copy; hand the
                    # allocation back so the caller's claim reads
                    # exactly as a normal admission would have left it.
                    if claim is not None and "status" in intent["admitClaim"]:
                        claim["status"] = intent["admitClaim"]["status"]
                self._clear_intent()
                record["state"] = STATE_COMPLETED
                record["detail"] = (
                    f"executed {len(intent['migrations'])} migration(s) "
                    f"and admitted the {intent['wanted']}-chip gang"
                )
                self._finish(record, t0, "completed")
                return record
            finally:
                self._end()

    def recover(self) -> Optional[dict]:
        """Converge a crashed execution's on-disk intent: roll it
        FORWARD (each non-done migration re-runs or is recognized as
        already applied, then the stuck claim is admitted), or — when
        forward progress fails — roll the whole plan BACK. Returns the
        execution record, or None when there is no intent. Idempotent
        and re-entrant: a crash during recovery leaves an intent a later
        :meth:`recover` converges the same way. Call once at startup
        before enabling execution."""
        intent = self._load_intent()
        if intent is None:
            return None
        t0 = time.monotonic()
        with self._lock:
            record = self._new_record(
                intent.get("planId", ""), intent.get("claim", {})
            )
            record["recovered"] = True
            if "error" in intent:
                record["state"] = STATE_FAILED
                record["detail"] = intent["error"]
                self._finish(record, t0, "failed")
                raise DefragExecutionError(record["detail"])
            self._begin(record, intent)
            try:
                with self.allocator.snapshot():
                    try:
                        for mig in intent["migrations"]:
                            if mig.get("status") == "done":
                                # Crash can land between the done-write
                                # and the next step; resume is a no-op
                                # when the step finished cleanly.
                                self._resume(mig)
                                continue
                            self._recover_migration(intent, mig, record)
                            mig["status"] = "done"
                            atomic_write_json(self.intent_path, intent)
                        self._recover_admit(intent, record)
                    except Exception as e:
                        self._fail_and_rollback(intent, record, t0, e)
                self._clear_intent()
                record["state"] = STATE_COMPLETED
                record["detail"] = (
                    "crash recovery rolled the plan forward: "
                    f"{len(intent['migrations'])} migration(s) applied, "
                    f"{intent['wanted']}-chip gang admitted"
                )
                self._finish(record, t0, "completed")
                return record
            finally:
                self._end()

    def abort(self) -> Optional[dict]:
        """Operator escape hatch (runbook: aborting a stuck plan): roll
        the on-disk intent BACK without attempting forward progress —
        movers return to their original devices, drained replicas
        resume, the intent is cleared. Returns the execution record, or
        None when there is nothing to abort. Raises when the rollback
        itself fails (the intent stays for the auditor)."""
        intent = self._load_intent()
        if intent is None:
            return None
        t0 = time.monotonic()
        with self._lock:
            record = self._new_record(
                intent.get("planId", ""), intent.get("claim", {})
            )
            record["recovered"] = True
            if "error" in intent:
                record["state"] = STATE_FAILED
                record["detail"] = intent["error"]
                self._finish(record, t0, "failed")
                raise DefragExecutionError(record["detail"])
            self._begin(record, intent)
            try:
                with self.allocator.snapshot():
                    self._fail_and_rollback(
                        intent, record, t0,
                        DefragExecutionError("operator abort"),
                    )
            except DefragExecutionError:
                if record["state"] == STATE_ROLLED_BACK:
                    return record
                raise
            finally:
                self._end()

    # -- plan pinning ------------------------------------------------------

    def _check_sig(self, plan: dict) -> None:
        sig = plan.get("sig") or {}
        want = (sig.get("generation"), sig.get("reservationVersion"))
        cur = (
            self.allocator.index.generation,
            self.allocator.reservation_version,
        )
        if want != cur:
            raise StalePlanError(
                f"stale plan {plan.get('planId')}: computed against "
                f"generation={want[0]} reservationVersion={want[1]}, "
                f"allocator is at generation={cur[0]} "
                f"reservationVersion={cur[1]} — re-plan and retry"
            )

    def _build_intent(
        self, plan, claim, selectors, require_healthy,
    ) -> dict:
        migrations = []
        for mig in plan.get("migrations", []):
            uid = mig["claimUid"]
            held = self._holdings(uid)
            if {n for _, n in held} != set(mig["devices"]):
                raise StalePlanError(
                    f"stale plan {plan.get('planId')}: claim {uid} no "
                    "longer holds the devices the plan would move"
                )
            reqname = self._request_name(uid)
            migrations.append({
                "claimUid": uid,
                "devices": list(mig["devices"]),
                "to": list(mig["to"]),
                "toCoords": list(mig.get("toCoords", [])),
                "requestName": reqname,
                "originalResults": [
                    {"request": reqname, "driver": self.driver_name,
                     "pool": p, "device": n}
                    for p, n in sorted(held)
                ],
                "status": "pending",
            })
        if claim is not None:
            admit_claim = {
                "metadata": dict(claim.get("metadata", {})),
                "spec": claim.get("spec", {}),
            }
        else:
            admit_claim = self._synth_admit_claim(plan)
        return {
            "planId": plan.get("planId", ""),
            "ts": round(time.time(), 3),
            "node": self.node_name,
            "claim": dict(plan.get("claim", {})),
            "sliceId": plan.get("sliceId"),
            "wanted": plan.get("wanted", 0),
            "sig": plan.get("sig"),
            "admitClaim": admit_claim,
            "admitSelectors": _serialize_selectors(selectors),
            "requireHealthy": bool(require_healthy),
            "migrations": migrations,
        }

    def _synth_admit_claim(self, plan: dict) -> dict:
        c = plan.get("claim", {})
        return {
            "metadata": {
                "uid": c.get("uid", ""),
                "name": c.get("name", ""),
                "namespace": c.get("namespace", ""),
            },
            "spec": {"devices": {"requests": [{
                "name": "r0",
                "deviceClassName": self.device_class,
                "allocationMode": "ExactCount",
                "count": int(plan.get("wanted", 0)),
            }]}},
        }

    # -- steps -------------------------------------------------------------

    def _write_intent(self, intent: dict, record: dict) -> None:
        try:
            faults.fire("defrag.intent-write")
            atomic_write_json(self.intent_path, intent)
        except Exception as e:
            self._step(record, "intent-write", "", "failed", str(e))
            raise
        self._step(record, "intent-write", "", "ok",
                   f"execution intent checkpointed to {self.intent_path}")

    def _run_migration(self, intent, mig, record) -> None:
        uid = mig["claimUid"]
        try:
            faults.fire("defrag.drain")
            drained = []
            if self.gateway is not None:
                drained = self.gateway.drain_claim(
                    uid, reason=f"defrag {intent['planId']}"
                )
            mig["drainedReplicas"] = drained
        except Exception as e:
            self._step(record, "drain", uid, "failed", str(e))
            raise
        self._step(
            record, "drain", uid, "ok",
            f"drained {len(drained)} serving replica(s)" if drained
            else "no serving replicas bound to this claim",
        )
        try:
            faults.fire("defrag.replace")
            self._replace(intent, mig)
        except Exception as e:
            self._step(record, "replace", uid, "failed", str(e))
            raise
        self._resume(mig)
        self._step(
            record, "replace", uid, "ok",
            f"re-placed onto {len(mig['to'])} device(s): "
            + ", ".join(mig["to"]),
        )

    def _replace(self, intent, mig) -> None:
        """Move one blocker: deallocate, re-solve pinned to the planned
        destination cells, rewrite node state, notify listeners. Any
        failure restores the allocator to the mover's original devices
        before re-raising (the caller then rolls the whole plan back)."""
        uid = mig["claimUid"]
        self.allocator.deallocate(uid)
        synth = {
            "metadata": {
                "uid": uid,
                "name": f"defrag-move-{uid}",
                "namespace": "",
            },
            "spec": {"devices": {"requests": [{
                "name": mig["requestName"],
                "deviceClassName": self.device_class,
                "allocationMode": "ExactCount",
                "count": len(mig["to"]),
            }]}},
        }
        sels = []
        if intent.get("sliceId") is not None:
            sels.append(Selector("sliceId", "eq", str(intent["sliceId"])))
        if mig.get("toCoords"):
            sels.append(Selector("coord", "in", list(mig["toCoords"])))
        try:
            self.allocator.allocate(
                synth, selectors={mig["requestName"]: sels}
            )
        except Exception:
            self.allocator.restore_reservations(
                uid, mig["originalResults"]
            )
            raise
        results = synth["status"]["allocation"]["devices"]["results"]
        mig["newResults"] = results
        try:
            if (
                self.state is not None
                and self.state.gang_view(uid) is not None
            ):
                self.state.resize_claim(uid, results)
            self._notify(uid, [r["device"] for r in results])
        except Exception:
            # The allocator restore must not mask the real error; a
            # failure in IT leaves the intent for the auditor instead.
            try:
                self.allocator.deallocate(uid)
                self.allocator.restore_reservations(
                    uid, mig["originalResults"]
                )
            except Exception:
                logger.exception(
                    "defrag: allocator restore failed for %s", uid
                )
            raise

    def _admit(self, intent, record) -> None:
        uid = intent["claim"].get("uid", "")
        claim = intent["admitClaim"]
        selectors = _deserialize_selectors(intent.get("admitSelectors"))
        try:
            faults.fire("defrag.admit")
            self.allocator.allocate(
                claim,
                selectors=selectors,
                require_healthy=intent.get("requireHealthy", False),
            )
        except Exception as e:
            self._step(record, "admit", uid, "failed", str(e))
            raise
        self._step(
            record, "admit", uid, "ok",
            f"admitted the {intent['wanted']}-chip gang onto slice "
            f"{intent.get('sliceId')}",
        )

    # -- crash recovery ----------------------------------------------------

    def _recover_migration(self, intent, mig, record) -> None:
        uid = mig["claimUid"]
        held = {n for _, n in self._holdings(uid)}
        if held == set(mig["to"]):
            # The re-place landed before the crash: converge node state
            # and listeners onto it, resume replicas, and move on.
            results = [
                {"request": mig["requestName"], "driver": self.driver_name,
                 "pool": p, "device": n}
                for p, n in sorted(self._holdings(uid))
            ]
            mig["newResults"] = results
            if self.state is not None:
                view = self.state.gang_view(uid)
                if view is not None and {
                    n for n, _ in view["devices"]
                } != set(mig["to"]):
                    self.state.resize_claim(uid, results)
            self._notify(uid, sorted(mig["to"]))
            self._resume(mig)
            self._step(record, "replace", uid, "ok",
                       "recovered: planned placement already applied")
            return
        if held != set(mig["devices"]):
            # Crash mid-transition (e.g. inside the node-state resize):
            # pin the allocator back to the originals so the re-run
            # starts from a clean slate. restore_reservations is
            # idempotent and skips devices held by others.
            self.allocator.deallocate(uid)
            self.allocator.restore_reservations(
                uid, mig["originalResults"]
            )
        self._run_migration(intent, mig, record)

    def _recover_admit(self, intent, record) -> None:
        uid = intent["claim"].get("uid", "")
        held = self._holdings(uid)
        if len(held) >= int(intent.get("wanted", 0)) and held:
            self._step(record, "admit", uid, "ok",
                       "recovered: gang already admitted")
            return
        self._admit(intent, record)

    # -- rollback ----------------------------------------------------------

    def _fail_and_rollback(self, intent, record, t0, err) -> None:
        """Roll the whole plan back and raise DefragExecutionError; on
        rollback failure, record the execution as failed and leave the
        intent on disk for the auditor."""
        try:
            self._rollback(intent, record)
        except Exception as re:
            record["state"] = STATE_FAILED
            record["detail"] = f"{err}; rollback failed: {re}"
            self._finish(record, t0, "failed")
            raise DefragExecutionError(record["detail"]) from err
        record["state"] = STATE_ROLLED_BACK
        record["detail"] = f"rolled back: {err}"
        self._finish(record, t0, "rolled-back")
        raise DefragExecutionError(record["detail"]) from err

    def _rollback(self, intent, record) -> None:
        failures = []
        with contextlib.suppress(Exception):
            # The admit step is last, so reaching rollback means it did
            # not commit; dropping any partial reservation is a no-op in
            # the common case and a repair after a recovery re-admit.
            self.allocator.deallocate(intent["claim"].get("uid", ""))
        for mig in reversed(intent.get("migrations", [])):
            entry = {
                "claimUid": mig["claimUid"],
                "outcome": "ok",
                "detail": "restored original placement",
            }
            try:
                self._revert_mover(mig)
            except Exception as e:
                logger.exception(
                    "defrag rollback failed for mover %s",
                    mig["claimUid"],
                )
                entry["outcome"] = "failed"
                entry["detail"] = str(e)
                failures.append(mig["claimUid"])
            record["rollbacks"].append(entry)
        if failures:
            raise DefragExecutionError(
                f"rollback failed for mover(s) {', '.join(failures)}; "
                f"execution intent left at {self.intent_path} "
                "(surfaces as the auditor's 'defrag' finding)"
            )
        self._clear_intent()

    def _revert_mover(self, mig) -> None:
        """Return one mover to its original devices. Idempotent: safe on
        a mover that never moved (the allocator ends where it started)
        and on one that fully moved (reservations, node state, replicas
        and listeners all return)."""
        uid = mig["claimUid"]
        self.allocator.deallocate(uid)
        self.allocator.restore_reservations(uid, mig["originalResults"])
        if self.state is not None:
            view = self.state.gang_view(uid)
            if view is not None and {
                n for n, _ in view["devices"]
            } == set(mig["to"]) and set(mig["to"]) != set(mig["devices"]):
                self.state.resize_claim(uid, mig["originalResults"])
        self._notify(
            uid, [r["device"] for r in mig["originalResults"]]
        )
        self._resume(mig)

    # -- plumbing ----------------------------------------------------------

    def _holdings(self, uid: str) -> list[tuple[str, str]]:
        """(pool, device) pairs the allocator currently reserves for
        ``uid``. Called under snapshot(), which holds the allocator
        lock, so the read is coherent."""
        return [
            (p, n)
            for (p, n), holder in self.allocator._reservations.items()
            if holder == uid
        ]

    def _request_name(self, uid: str) -> str:
        if self.state is not None:
            view = self.state.gang_view(uid)
            if view and view.get("request_names"):
                return view["request_names"][0]
        return "r0"

    def _notify(self, uid: str, devices: list[str]) -> None:
        for fn in self._listeners:
            fn(uid, list(devices))

    def _resume(self, mig) -> None:
        if self.gateway is not None:
            self.gateway.resume_claim(mig["claimUid"])

    def _step(self, record, kind, uid, outcome, detail) -> None:
        record["steps"].append({
            "kind": kind,
            "claimUid": uid,
            "outcome": outcome,
            "detail": detail,
        })
        self._m_steps.inc(kind=kind, outcome=outcome)

    def _new_record(self, plan_id: str, claim: dict) -> dict:
        return {
            "planId": plan_id,
            "ts": round(time.time(), 3),
            "claim": {
                "uid": claim.get("uid", ""),
                "name": claim.get("name", ""),
                "namespace": claim.get("namespace", ""),
            },
            "state": STATE_IN_FLIGHT,
            "detail": "",
            "steps": [],
            "rollbacks": [],
        }

    def _begin(self, record: dict, plan_or_intent: dict) -> None:
        self._executions.append(record)
        self._executing = True
        uids = {
            m["claimUid"] for m in plan_or_intent.get("migrations", [])
        }
        uids.add(record["claim"].get("uid", ""))
        self._inflight = frozenset(uids)
        self._m_in_flight.set(1)
        self._emit(record, "DefragExecutionStarted", warning=False)

    def _end(self) -> None:
        self._executing = False
        self._inflight = frozenset()
        self._m_in_flight.set(0)

    def _finish(self, record: dict, t0: float, outcome: str) -> None:
        self._m_execs.inc(outcome=outcome)
        self._m_seconds.observe(time.monotonic() - t0)
        self._m_last_ts.set(time.time())
        reason = {
            STATE_COMPLETED: "DefragExecutionCompleted",
            STATE_ROLLED_BACK: "DefragExecutionRolledBack",
            STATE_REFUSED: "DefragExecutionRefused",
            STATE_FAILED: "DefragExecutionFailed",
        }.get(record["state"], "DefragExecutionFinished")
        self._emit(record, reason,
                   warning=record["state"] != STATE_COMPLETED)

    def _emit(self, record: dict, reason: str, warning: bool) -> None:
        if self.events is None or not record["claim"].get("name"):
            return
        from .events import ObjectRef

        ref = ObjectRef.claim(
            record["claim"]["name"],
            record["claim"].get("namespace", ""),
            record["claim"].get("uid", ""),
        )
        msg = f"defrag plan {record['planId']}: {record['detail'] or record['state']}"
        try:
            if warning:
                self.events.warning(ref, reason, msg)
            else:
                self.events.normal(ref, reason, msg)
        except Exception:
            logger.exception("defrag event emit failed")

    def _load_intent(self) -> Optional[dict]:
        if not os.path.exists(self.intent_path):
            return None
        try:
            with open(self.intent_path) as f:
                return json.load(f)
        except Exception as e:
            return {
                "error": f"unreadable execution intent: {e}",
                "path": self.intent_path,
            }

    def _clear_intent(self) -> None:
        with contextlib.suppress(FileNotFoundError):
            os.remove(self.intent_path)


def _serialize_selectors(selectors) -> Optional[dict]:
    if not selectors:
        return None
    return {
        req: [
            {"attribute": s.attribute, "op": s.op, "value": s.value}
            for s in sels
        ]
        for req, sels in selectors.items()
    }


def _deserialize_selectors(doc) -> Optional[dict]:
    if not doc:
        return None
    return {
        req: [
            Selector(s["attribute"], s["op"], s["value"]) for s in sels
        ]
        for req, sels in doc.items()
    }
