"""State-drift auditor: do the four sources of truth still agree?

After the crash/blackout scenarios the chaos harness injects
(tests/test_chaos.py), a node's state can silently diverge: a CDI claim
spec with no checkpointed claim, a checkpoint torn by a node crash, a
sharing hold whose claim is gone, published ResourceSlices describing
chips that no longer exist. Each chaos invariant is asserted in tests —
this module runs the SAME cross-checks continuously in production and
turns disagreement into operator signal instead of latent corruption.

The four sources of truth, cross-checked every pass:

1. **checkpointed claims** (plugin/checkpoint.py) — what Prepare says it
   did;
2. **on-disk CDI specs** (cdi/spec.py) — what containers will actually
   receive;
3. **published ResourceSlice devices** (via the kube client; skipped
   without one) — what the scheduler believes this node offers;
4. **live chip inventory + health** (DeviceState.allocatable /
   chip_health) — what the hardware says.

Checks (stable ``check`` label values):

- ``checkpoint``     unreadable/corrupt checkpoint file;
- ``cdi``            orphaned claim spec, missing claim spec, missing
                     base spec (chaos invariant I2);
- ``channels``       one ICI channel recorded prepared by two claims
                     (invariant I3);
- ``health``         a claim prepared onto a chip that was ALREADY
                     unhealthy (invariant I4: HealthStatus.since must
                     not precede PreparedClaim.prepared_at);
- ``sharing``        phantom/corrupt sharing holds with no checkpointed
                     claim;
- ``sharing-limits`` a ProcessShared claim's per-chip store meta
                     (limits + generation the workload shim is being
                     served) disagrees with its checkpointed config —
                     a half-applied rebalance that escaped the
                     two-phase resize protocol, or a hold the resize
                     never reached;
- ``resize``         a gang-resize intent still checkpointed: the
                     two-phase resize protocol (DeviceState.resize_claim)
                     finalizes or rolls forward at startup, and live
                     resizes run under the DeviceState lock this audit
                     also takes — an observable intent is a crash
                     leftover recovery could not complete;
- ``slices``         published node slice devices differ from the local
                     allocatable view (stale publish; transient during a
                     blackout while republishes queue — which is exactly
                     why the /readyz check registered for this auditor
                     is NON-critical).

Findings surface three ways: ``tpu_dra_audit_*`` metrics, a deduped
``StateDrift`` Warning Event on the Node, and the non-critical
``state-consistent`` /readyz check. The doctor CLI re-runs the same
checks fleet-wide from scraped state.

The port's copy of the reference module.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional

from ..kube.events import EventRecorder, ObjectRef
from ..utils.metrics import Counter, Gauge, Registry
from .checkpoint import CorruptCheckpointError
from .device_state import DeviceState

logger = logging.getLogger(__name__)

# Every check name, so gauges render an explicit zero when clean.
CHECKS = ("checkpoint", "cdi", "channels", "health", "sharing",
          "sharing-limits", "resize", "defrag", "slices")


@dataclasses.dataclass(frozen=True)
class AuditFinding:
    """One concrete disagreement between two sources of truth."""

    check: str    # one of CHECKS
    subject: str  # claim uid / chip uuid / device name
    detail: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.subject}: {self.detail}"


class StateAuditor:
    """Periodic cross-check pass over one node's driver state."""

    def __init__(
        self,
        state: DeviceState,
        registry: Registry,
        kube_client=None,
        resource_api=None,
        node_name: str = "",
        node_uid: str = "",
        events: Optional[EventRecorder] = None,
        interval_seconds: float = 300.0,
    ):
        self.state = state
        self.kube_client = kube_client
        # Callable so the auditor always sees the LIVE negotiated dialect
        # (same contract as OrphanCleaner's resource_api seam).
        self._api_source = (
            resource_api if callable(resource_api)
            else (lambda: resource_api)
        )
        self.node_name = node_name
        self.node_uid = node_uid
        self.events = events
        self.interval = interval_seconds
        # Attached by Driver.enable_defrag_execution: lets the resize
        # check skip claims an in-flight defrag plan is legitimately
        # moving, and the defrag check report orphaned intents.
        self.defrag_executor = None
        self.findings: list[AuditFinding] = []
        self.passes = 0
        self._ran = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        self._m_runs = Counter(
            "tpu_dra_audit_runs_total",
            "Audit passes by outcome (clean, drift, error)",
            registry,
        )
        self._m_findings = Gauge(
            "tpu_dra_audit_findings",
            "Drift findings open as of the last audit pass, by check",
            registry,
        )
        self._m_drift_total = Counter(
            "tpu_dra_audit_drift_findings_total",
            "Cumulative drift findings reported, by check",
            registry,
        )
        self._m_last_run = Gauge(
            "tpu_dra_audit_last_run_timestamp_seconds",
            "Wall-clock time of the last completed audit pass",
            registry,
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="state-auditor"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.interval):
            try:
                self.run_once()
            except Exception:
                logger.exception("audit pass failed")
                self._m_runs.inc(outcome="error")

    # -- one pass ----------------------------------------------------------

    def run_once(self) -> list[AuditFinding]:
        """One full cross-check; returns (and records) the findings."""
        findings: list[AuditFinding] = []
        # Local-file checks run under the DeviceState lock, like the
        # orphan cleaner's: a prepare caught between its CDI write and
        # checkpoint write must not read as drift.
        with self.state._lock:
            ckpt = self._check_checkpoint(findings)
            self._check_cdi(findings, ckpt)
            self._check_channels(findings, ckpt)
            self._check_health_ordering(findings, ckpt)
            self._check_sharing(findings, ckpt)
            self._check_sharing_limits(findings, ckpt)
            self._check_resize(findings, ckpt)
        self._check_defrag(findings)
        # The apiserver comparison runs outside the lock (network) and is
        # skipped — not reported as drift — when the server is dark.
        self._check_slices(findings)

        now = time.time()
        with self._lock:
            previous = {(f.check, f.subject) for f in self.findings}
            self.findings = findings
            self.passes += 1
            self._ran = True
        by_check = {c: 0 for c in CHECKS}
        for f in findings:
            by_check[f.check] = by_check.get(f.check, 0) + 1
        for check, n in by_check.items():
            self._m_findings.set(n, check=check)
        for f in findings:
            if (f.check, f.subject) not in previous:
                self._m_drift_total.inc(check=f.check)
        self._m_last_run.set(now)
        self._m_runs.inc(outcome="drift" if findings else "clean")
        if findings:
            logger.warning(
                "state audit found %d drift finding(s): %s",
                len(findings), "; ".join(str(f) for f in findings[:5]),
            )
            self._emit_event(findings, by_check)
        return findings

    def _emit_event(self, findings, by_check) -> None:
        if self.events is None or not self.node_name:
            return
        summary = ", ".join(
            f"{check}={n}" for check, n in sorted(by_check.items()) if n
        )
        first = "; ".join(str(f) for f in findings[:3])
        # Deduped by the recorder on (Node, Warning, StateDrift): repeat
        # passes aggregate count onto one Event instead of spamming.
        self.events.warning(
            ObjectRef.node(self.node_name, self.node_uid),
            "StateDrift",
            f"node state drift detected ({summary}): {first}",
        )

    # -- readiness ---------------------------------------------------------

    def readiness_check(self):
        """Non-critical /readyz input: drift reads 'degraded', not dead —
        the plugin still serves prepares while an operator investigates."""
        with self._lock:
            if not self._ran:
                return True, "no audit pass yet"
            if not self.findings:
                return True, f"state consistent ({self.passes} passes)"
            by_check: dict[str, int] = {}
            for f in self.findings:
                by_check[f.check] = by_check.get(f.check, 0) + 1
            return False, "state drift: " + ", ".join(
                f"{c}={n}" for c, n in sorted(by_check.items())
            )

    # -- the checks --------------------------------------------------------

    def _check_checkpoint(self, findings) -> dict[str, dict]:
        try:
            return self.state.checkpoint.read()
        except FileNotFoundError:
            return {}
        except CorruptCheckpointError as e:
            findings.append(AuditFinding(
                "checkpoint", self.state.checkpoint.path, str(e)
            ))
            return {}

    def _check_cdi(self, findings, ckpt: dict) -> None:
        cdi = self.state.cdi
        on_disk = set(cdi.list_claim_spec_uids())
        for uid in sorted(on_disk - set(ckpt)):
            findings.append(AuditFinding(
                "cdi", uid,
                "CDI claim spec on disk but claim not in checkpoint "
                "(crash between CDI write and checkpoint write?)",
            ))
        for uid in sorted(set(ckpt) - on_disk):
            findings.append(AuditFinding(
                "cdi", uid,
                "claim checkpointed but its CDI claim spec is missing "
                "(container restarts of this claim will fail CDI "
                "resolution)",
            ))
        if not cdi.base_spec_exists():
            findings.append(AuditFinding(
                "cdi", "base-spec",
                "base CDI spec file missing from the CDI root",
            ))

    def _check_channels(self, findings, ckpt: dict) -> None:
        seen: dict[int, str] = {}
        for uid, rec in sorted(ckpt.items()):
            for group in rec.get("groups", []):
                for dev in group.get("devices", []):
                    ch = dev.get("channel")
                    if ch is None:
                        continue
                    owner = seen.setdefault(ch, uid)
                    if owner != uid:
                        findings.append(AuditFinding(
                            "channels", f"channel-{ch}",
                            f"ICI channel {ch} recorded prepared by both "
                            f"{owner} and {uid}",
                        ))

    def _check_health_ordering(self, findings, ckpt: dict) -> None:
        from ..tpulib.deviceinfo import chip_uuid_of_device_uuid

        health = self.state.chip_health
        for uid, rec in sorted(ckpt.items()):
            prepared_at = rec.get("preparedAt", 0.0)
            for group in rec.get("groups", []):
                # adminAccess prepares are deliberately NOT health-gated
                # (draining a sick chip is exactly when a monitoring pod
                # needs on, device_state.py) — a sanctioned prepare onto
                # an already-unhealthy chip is not drift.
                if (group.get("config") or {}).get("adminAccess"):
                    continue
                for dev in group.get("devices", []):
                    for u in dev.get("uuids", []):
                        base = chip_uuid_of_device_uuid(u)
                        st = health.get(base)
                        if st is None or st.is_healthy():
                            continue
                        if st.since < prepared_at:
                            findings.append(AuditFinding(
                                "health", uid,
                                f"claim prepared at {prepared_at:.3f} on "
                                f"chip {base}, which was already "
                                f"{st.state} since {st.since:.3f}",
                            ))

    def _check_sharing(self, findings, ckpt: dict) -> None:
        from .sharing import CorruptShareStateError

        store = self.state.share_state
        for uuid in store.list_chips():
            try:
                st = store.get(uuid)
            except CorruptShareStateError as e:
                findings.append(AuditFinding("sharing", uuid, str(e)))
                continue
            for claim_uid in sorted(set(st.claims) - set(ckpt)):
                findings.append(AuditFinding(
                    "sharing", uuid,
                    f"sharing hold by claim {claim_uid} ({st.mode}) with "
                    "no checkpointed claim (phantom hold; the orphan "
                    "cleaner should release it)",
                ))

    def _check_sharing_limits(self, findings, ckpt: dict) -> None:
        """Checkpointed per-claim limits vs the sharing store's meta.

        The limits-resize protocol (DeviceState.resize_claim_limits)
        rewrites three renderings of one truth — the checkpointed
        config, the per-chip store meta, and the session limits file —
        under a checkpointed intent. A disagreement between the first
        two visible here is a half-applied rebalance the protocol did
        not cover (or external mutation): the workload shim may be
        enforcing limits the checkpoint never granted. Claims still
        carrying a ``resize`` intent are skipped — the ``resize`` check
        owns those, and their store is legitimately mid-flight."""
        from ..tpulib.deviceinfo import chip_uuid_of_device_uuid
        from .sharing import CorruptShareStateError

        store = self.state.share_state
        for uid, rec in sorted(ckpt.items()):
            if rec.get("resize"):
                continue
            expected_gen = int(
                (rec.get("sharing") or {}).get("generation", 1)
            )
            for group in rec.get("groups", []):
                cfg = group.get("config") or {}
                sharing = cfg.get("sharing") or {}
                if sharing.get("strategy") != "ProcessShared":
                    continue
                psc = sharing.get("processSharedConfig") or {}
                expected = {
                    "maxProcesses": psc.get("maxProcesses"),
                    "tensorcorePercent": psc.get(
                        "defaultActiveCorePercentage"
                    ),
                    "hbmLimit": psc.get("defaultHbmLimit"),
                    "generation": expected_gen,
                }
                chips = sorted({
                    chip_uuid_of_device_uuid(u)
                    for dev in group.get("devices", [])
                    for u in dev.get("uuids", [])
                })
                for chip in chips:
                    try:
                        st = store.get(chip)
                    except CorruptShareStateError:
                        continue  # the sharing check owns corruption
                    meta = st.claims.get(uid)
                    if meta is None:
                        findings.append(AuditFinding(
                            "sharing-limits", uid,
                            f"claim checkpointed ProcessShared on chip "
                            f"{chip} but the sharing store records no "
                            "hold for it",
                        ))
                        continue
                    if expected_gen == 1 and "generation" not in meta:
                        # A pre-limits-resize binary wrote this hold
                        # (meta was just {"maxProcesses": N} then): a
                        # never-rebalanced claim from before the
                        # upgrade is legacy rendering, not drift —
                        # compare only the field both versions wrote.
                        diffs = (
                            {"maxProcesses": (
                                meta.get("maxProcesses"),
                                expected["maxProcesses"],
                            )}
                            if meta.get("maxProcesses")
                            != expected["maxProcesses"] else {}
                        )
                    else:
                        diffs = {
                            k: (meta.get(k), v)
                            for k, v in expected.items()
                            if meta.get(k) != v
                        }
                    if diffs:
                        findings.append(AuditFinding(
                            "sharing-limits", uid,
                            f"chip {chip} sharing meta disagrees with "
                            "the checkpointed limits "
                            f"(store vs checkpoint: {diffs}) — "
                            "half-applied rebalance?",
                        ))

    def _check_resize(self, findings, ckpt: dict) -> None:
        """No checkpointed claim may still carry a ``resize`` intent.

        Live resizes hold the DeviceState lock this pass also takes, and
        startup recovery rolls crash-left intents forward — so any
        intent visible here is one recovery could NOT complete (e.g. the
        added spare vanished while the plugin was down). The claim's
        container env and its checkpointed gang may disagree until an
        operator re-prepares or deletes the claim."""
        in_flight = frozenset()
        if self.defrag_executor is not None:
            # A defrag execution resizes claims mid-pass by design; its
            # own intent file (not this check) owns their convergence
            # until the execution finishes.
            in_flight = self.defrag_executor.in_flight_uids()
        for uid, rec in sorted(ckpt.items()):
            intent = rec.get("resize")
            if not intent or uid in in_flight:
                continue
            findings.append(AuditFinding(
                "resize", uid,
                "gang-resize intent (started "
                f"{intent.get('startedAt', 0.0):.3f}, target "
                f"{intent.get('to')}) was never finalized and startup "
                "recovery could not roll it forward; the claim's CDI "
                "spec may not match its checkpointed gang — re-prepare "
                "or delete the claim",
            ))

    def _check_defrag(self, findings) -> None:
        """No defrag execution intent may exist outside an execution.

        The executor clears its intent on completion AND rollback, and
        recovery converges a crash-left one at startup — so an intent
        visible here (while nothing is executing) is a plan neither
        path could finish: holds, node state, or replicas may disagree
        with the planned placement until an operator intervenes
        (``docs/operations.md``: fleet is fragmented → aborting a stuck
        plan)."""
        if self.defrag_executor is None:
            return
        orphan = self.defrag_executor.orphaned_intent()
        if orphan is None:
            return
        if "error" in orphan:
            findings.append(AuditFinding(
                "defrag", orphan.get("path", ""), orphan["error"],
            ))
            return
        uid = (orphan.get("claim") or {}).get("uid", "")
        done = sum(
            1 for m in orphan.get("migrations", [])
            if m.get("status") == "done"
        )
        findings.append(AuditFinding(
            "defrag", uid or orphan.get("planId", ""),
            f"defrag execution intent for plan {orphan.get('planId')} "
            f"({done}/{len(orphan.get('migrations', []))} migration(s) "
            "checkpointed done) was left on disk with no execution in "
            "flight — recovery/rollback could not converge it; run the "
            "executor's recover() (plugin restart does) or abort() to "
            "roll it back",
        ))

    def _check_slices(self, findings) -> None:
        """Published ResourceSlice devices vs the local allocatable view.
        Requires a kube client; list failures are SKIPPED, not drift —
        during a blackout the republish queue makes staleness expected
        and the degraded-mode signal already covers it."""
        if self.kube_client is None:
            return
        api = self._api_source()
        if api is None:
            return
        try:
            slices = self.kube_client.list(api.slices)
        except Exception as e:
            logger.debug("slice audit skipped (list failed: %s)", e)
            return
        published: set[str] = set()
        for sl in slices:
            sl = api.slice_from_wire(sl)
            spec = sl.get("spec") or {}
            if spec.get("driver") != self.state.driver_name:
                continue
            if spec.get("nodeName") != self.node_name:
                continue
            published.update(
                d.get("name", "") for d in spec.get("devices", [])
            )
        local = {
            d["name"] for d in self.state.published_resources()["devices"]
        }
        if not published:
            # No slice for this node at all: the FIRST publish hasn't
            # landed yet (an audit pass can beat it at startup) or a
            # blackout queued it — "not yet published" is not a stale
            # publish. Diffing only makes sense against a publish that
            # exists; the republish loop owns getting one there.
            logger.debug("slice audit skipped (no slice published yet)")
            return
        for name in sorted(published - local):
            findings.append(AuditFinding(
                "slices", name,
                "device published in a ResourceSlice but absent from the "
                "node's allocatable view (stale publish)",
            ))
        for name in sorted(local - published):
            findings.append(AuditFinding(
                "slices", name,
                "allocatable device not published in any ResourceSlice "
                "for this node",
            ))
