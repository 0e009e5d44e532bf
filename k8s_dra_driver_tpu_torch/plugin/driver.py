"""Driver: the DRA node-service implementation.

Analog of the reference's driver.go (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/driver.go:38-166): wires DeviceState to the gRPC
surface, serializes Prepare/Unprepare under a mutex, isolates per-claim
errors in-band (a failing claim never fails the whole RPC), publishes
node-local devices as ResourceSlices, and verifies claim UIDs against the
API server before preparing.

The port's copy of the reference module. Its messages are the hand-written
codec's (``kube/protos/``: a map field is a dict, so
``response.claims[uid] = x`` where the reference calls ``CopyFrom``), and
the kubelet reaches it through ``DriverConfig.transport``: by default
``grpc_uds.SocketTransport``, the gRPC services on the plugin's two unix
sockets as the reference serves them; ``kubeletplugin.LocalTransport``
for callers that keep many Drivers in one process.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import Optional

from ..cdi.spec import CDIHandler
from ..kube.client import KubeClient
from ..kube.events import EventRecorder, ObjectRef
from ..kube.protos import dra_v1alpha4 as drapb
from ..kube.resourceapi import ResourceApi
from ..kube.resourceslice import DriverResources, Pool
from ..tpulib.chiplib import ChipLib
from ..utils import tracing
from ..utils.metrics import Counter, Gauge, Histogram, Registry
from ..utils.tracing import Tracer
from .checkpoint import CheckpointManager
from .device_state import DeviceState
from .grpc_services import NodeServicer
from .grpc_uds import SocketTransport
from .kubeletplugin import KubeletPlugin

logger = logging.getLogger(__name__)

DRIVER_NAME = "tpu.google.com"

# Gang resizes kept for the resize trace (driver.resize_trace()).
ELASTIC_TRACE_DEPTH = 64

# Device type (PreparedDevice.type) -> DeviceClass the elastic re-solve
# requests. ICI channels are deliberately absent: they cannot be resized.
_ELASTIC_DEVICE_CLASSES = {
    "chip": "tpu.google.com",
    "tensorcore": "tensorcore.tpu.google.com",
}


@dataclasses.dataclass(frozen=True)
class GangResize:
    """The typed resize protocol message (plugin → workload).

    Emitted once per COMPLETED gang resize: the claim's checkpoint, CDI
    spec, and sharing holds already reflect ``devices`` when a listener
    sees this. The workload side (parallel/elastic.ElasticTrainer) takes
    ``devices`` as its gang's members, maps them to its devices and
    reshards; ``generation`` is the
    claim's monotonically increasing resize counter so late/duplicate
    deliveries are detectable."""

    claim_uid: str
    claim_name: str
    namespace: str
    direction: str                # "shrink" | "grow"
    reason: str
    removed: tuple[str, ...]      # device names dropped by this resize
    added: tuple[str, ...]        # device names admitted by this resize
    devices: tuple[str, ...]      # post-resize gang, allocation order
    desired: int                  # gang size the claim wants back
    generation: int
    at: float                     # epoch seconds

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ClaimVerifyError(RuntimeError):
    """The claim could not be VERIFIED (no kube client, or the apiserver's
    copy has a different UID) — distinct from 'the apiserver is down',
    which the degraded-mode path may absorb."""


def _is_outage(e: Exception) -> bool:
    """Whether an exception from a claim fetch means the apiserver is
    UNREACHABLE (degraded-mode territory) rather than answering. 429 and
    5xx are load-shedding/outage; any other ApiError is a definitive
    answer. URLError/socket timeouts subclass OSError."""
    from ..kube.errors import ApiError

    if isinstance(e, ApiError):
        return e.code == 429 or e.code >= 500
    return isinstance(e, (OSError, TimeoutError))


@dataclasses.dataclass
class DriverConfig:
    """Flags/env surface (main.go:73-123 analog)."""

    node_name: str
    chiplib: ChipLib
    kube_client: Optional[KubeClient] = None
    driver_name: str = DRIVER_NAME
    cdi_root: str = "/var/run/cdi"
    plugin_root: str = "/var/lib/kubelet/plugins/tpu.google.com"
    registrar_root: str = "/var/lib/kubelet/plugins_registry"
    state_root: str = "/var/lib/tpu-dra"
    driver_root: str = "/"
    driver_root_ctr_path: str = "/"
    device_classes: frozenset = frozenset({"chip", "tensorcore", "ici"})
    node_uid: str = ""
    # Versions advertised on the registration socket: ("1.0.0",) for k8s
    # 1.31 kubelets, ("v1beta1.DRAPlugin",) for 1.32+ (see kubeletplugin).
    registration_versions: tuple = ("1.0.0",)
    # Served resource.k8s.io REST dialect; None = discover at startup
    # (1.31 serves v1alpha3, 1.32+ serves v1beta1 — the gRPC and REST
    # generations are probed independently because managed clusters skew).
    resource_api: Optional[ResourceApi] = None
    cleanup_interval_seconds: float = 600.0  # 0 disables the orphan cleaner
    # Device-inventory watch: re-enumerate (woken early by the chip
    # library's inotify, where available) and republish on change. 0
    # disables; the reference enumerates once at startup only.
    device_watch_interval_seconds: float = 30.0
    # State-drift auditor pass cadence (plugin/audit.py). 0 disables the
    # periodic thread; run_once stays callable either way (doctor/tests).
    audit_interval_seconds: float = 300.0
    # Dynamic-sharing rebalancer cadence (plugin/rebalancer.py), ticked
    # from the device-watch loop. 0 disables the loop; run_once stays
    # callable either way (sim/tests).
    rebalance_interval_seconds: float = 60.0
    # Opt-in defrag plan EXECUTION (`--defrag-execute`). Default off:
    # the planner stays advisory-only and /debug/defrag plans are
    # proposals. On (and once enable_defrag_execution attaches an
    # executor), the device-watch loop executes each fresh `planned`
    # plan through kube/defrag_executor.py.
    defrag_execute: bool = False
    # How the kubelet reaches the plugin's services: an object with
    # start(plugin), stop(), serving, detail and call(method, bytes).
    # The default serves the two unix sockets; kubeletplugin's
    # LocalTransport answers in process.
    transport: object = dataclasses.field(default_factory=SocketTransport)

    @property
    def plugin_socket(self) -> str:
        return f"{self.plugin_root}/dra.sock"

    @property
    def registrar_socket(self) -> str:
        return f"{self.registrar_root}/{self.driver_name}-dra.sock"

    @property
    def checkpoint_path(self) -> str:
        return f"{self.state_root}/checkpoint.json"

    @property
    def defrag_intent_path(self) -> str:
        """Per-plan defrag execution intent checkpoint — next to the
        prepared-claim checkpoint so both survive the same pod
        restart."""
        return f"{self.state_root}/defrag-intent.json"


class Driver(NodeServicer):
    """NewDriver analog (driver.go:38-84)."""

    # Floor between NotFound-triggered dialect re-discoveries (_fetch_claim).
    REDISCOVER_INTERVAL_S = 30.0

    def __init__(self, config: DriverConfig, registry: Optional[Registry] = None,
                 tracer: Optional[Tracer] = None):
        self.config = config
        self.resource_api = config.resource_api or ResourceApi.discover(
            config.kube_client
        )
        self._last_rediscover = float("-inf")
        self._lock = threading.Lock()  # serializes claim ops (driver.go:32)
        # Node-plugin metrics — a gap in the reference, whose plugin exposes
        # none (SURVEY.md §5).
        self.registry = registry or Registry()
        # Claim-lifecycle tracing: one root span per DRA RPC (wired into the
        # gRPC layer via KubeletPlugin), child spans per prepare stage.
        self.tracer = tracer or Tracer()
        self._m_prepares = Counter(
            "tpu_dra_claim_prepare_attempts_total", "Claim prepare attempts",
            self.registry,
        )
        self.registry.alias("tpu_dra_claim_prepares_total", self._m_prepares)
        self._m_unprepares = Counter(
            "tpu_dra_claim_unprepare_attempts_total",
            "Claim unprepare attempts", self.registry,
        )
        self.registry.alias(
            "tpu_dra_claim_unprepares_total", self._m_unprepares
        )
        self._m_prepare_latency = Histogram(
            "tpu_dra_claim_prepare_seconds", "Prepare latency", self.registry
        )
        self._m_inventory_refreshes = Counter(
            "tpu_dra_inventory_refreshes_total",
            "Device inventory changes republished",
            self.registry,
        )
        self._m_health_transitions = Counter(
            "tpu_dra_chip_health_transitions_total",
            "Chip health state transitions observed by the health poll",
            self.registry,
        )
        self._m_degraded_prepares = Counter(
            "tpu_dra_degraded_prepares_total",
            "Prepares served from checkpointed state while the apiserver "
            "was unreachable (degraded mode)",
            self.registry,
        )
        # Elastic gang-resize telemetry (populated only when
        # enable_elastic() wires an allocator; families exist either way
        # so dashboards see explicit zeros).
        self._m_elastic_resizes = Counter(
            "tpu_dra_elastic_resizes_total",
            "Gang resizes attempted by the elastic coordinator, by "
            "direction and outcome",
            self.registry,
        )
        self._m_elastic_resize_seconds = Histogram(
            "tpu_dra_elastic_resize_seconds",
            "End-to-end gang-resize latency: re-solve, checkpointed "
            "intent, holds/CDI rewrite, finalize",
            self.registry,
        )
        self._m_elastic_last_resize = Gauge(
            "tpu_dra_elastic_last_resize_timestamp_seconds",
            "Wall-clock time of the last completed gang resize",
            self.registry,
        )
        self._elastic_allocator = None
        self._resize_trace: collections.deque = collections.deque(
            maxlen=ELASTIC_TRACE_DEPTH
        )
        self._resize_listeners: list = []
        self._defrag_executor = None
        # Plan ids already attempted (success OR failure): an execution
        # is tried once per plan — a failed plan is re-planned by the
        # next unsat solve, never blindly retried.
        self._executed_defrag_plans: set[str] = set()
        # Failures (and recoveries) become kubectl-visible Events on the
        # ResourceClaim; no-op without a kube client.
        self.events = EventRecorder(
            config.kube_client,
            component=f"tpu-dra-plugin/{config.node_name}",
            registry=self.registry,
        )
        # Readiness inputs: monotonic time of the last successful inventory
        # enumeration (the DeviceState constructor below does the first).
        self._last_inventory_ok = time.monotonic()
        # Degraded-mode inputs: whether the last apiserver round-trip from
        # the claim path succeeded (served by the non-critical /readyz
        # check, so an apiserver outage reads "degraded", not "dead").
        self._apiserver_ok = True
        self._apiserver_err = ""
        self._apiserver_failed_at = 0.0  # monotonic, of the last failure
        # Serializes the claim path's failure/success writes against the
        # readiness thread's evidence-based recovery (check-then-act on
        # the three fields above would otherwise let a recovery write
        # clobber a newer failure).
        self._apiserver_state_lock = threading.Lock()
        self.state = DeviceState(
            chiplib=config.chiplib,
            cdi=CDIHandler(
                config.cdi_root,
                driver_name=config.driver_name,
                driver_root=config.driver_root,
                driver_root_ctr_path=config.driver_root_ctr_path,
            ),
            checkpoint=CheckpointManager(config.checkpoint_path),
            driver_name=config.driver_name,
            pool_name=config.node_name,
            state_dir=f"{config.state_root}/state",
            device_classes=set(config.device_classes),
        )
        # Utilization accounting: holds rebuilt from the checkpoint so a
        # DaemonSet crash never zeroes the node's occupancy view.
        from .accounting import UsageAccountant

        self.usage = UsageAccountant(
            self.registry,
            node_name=config.node_name,
            inventory=self.state.usage_inventory,
        )
        self.usage.attach_prepare_latency(self._m_prepare_latency)
        try:
            self.usage.rebuild(self.state.startup_prepared_records)
        except Exception:
            logger.exception("usage rebuild from checkpoint failed")
        self.state.accountant = self.usage
        # State-drift auditor: the chaos invariants, run continuously.
        from .audit import StateAuditor

        self.auditor = StateAuditor(
            state=self.state,
            registry=self.registry,
            kube_client=config.kube_client,
            resource_api=lambda: self.resource_api,
            node_name=config.node_name,
            node_uid=config.node_uid,
            events=self.events,
            interval_seconds=config.audit_interval_seconds,
        )
        # SLO-aware dynamic sharing: the closed loop from the usage
        # accounting above to hitless repartitioning. Ticked from the
        # device-watch loop; run_once stays callable for the sim.
        from .rebalancer import Rebalancer

        self.rebalancer = Rebalancer(
            state=self.state,
            registry=self.registry,
            node_name=config.node_name,
            node_uid=config.node_uid,
            events=self.events,
            interval_seconds=config.rebalance_interval_seconds,
            api_version=self.resource_api.api_version,
        )
        self.plugin = KubeletPlugin(
            node_server=self,
            driver_name=config.driver_name,
            node_name=config.node_name,
            plugin_socket=config.plugin_socket,
            registrar_socket=config.registrar_socket,
            kube_client=config.kube_client,
            node_uid=config.node_uid,
            registration_versions=list(config.registration_versions),
            resource_api=self.resource_api,
            tracer=self.tracer,
            transport=config.transport,
        )

    def start(self) -> None:
        self.plugin.start()
        if self.config.kube_client is not None:
            self.publish_resources()
        # Orphan cleanup (the reference's acknowledged TODO, driver.go:154-166).
        from .cleanup import OrphanCleaner

        self.cleaner = OrphanCleaner(
            self.state,
            self.config.kube_client,
            interval_seconds=self.config.cleanup_interval_seconds,
            resource_api=lambda: self.resource_api,
            on_dialect_change=self._adopt_resource_api,
        )
        if self.config.cleanup_interval_seconds > 0:
            self.cleaner.start()
        if self.config.audit_interval_seconds > 0:
            self.auditor.start()
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        if self.config.device_watch_interval_seconds > 0:
            self._watch_thread = threading.Thread(
                target=self._device_watch_loop,
                name="device-watch",
                daemon=True,
            )
            self._watch_thread.start()

    def shutdown(self) -> None:
        if getattr(self, "_watch_thread", None) is not None:
            self._watch_stop.set()
            # Wake an event-based waiter (FakeChipLib) so teardown is
            # immediate; a native inotify wait is not interruptible, so the
            # daemon thread just gets a short bounded join and dies with
            # the process. The loop re-checks _watch_stop before touching
            # state, so a late wake does nothing.
            waker = getattr(self.state.chiplib, "device_event", None)
            if waker is not None:
                waker.set()
            self._watch_thread.join(timeout=1.0)
        if getattr(self, "cleaner", None) is not None:
            self.cleaner.stop()
        self.auditor.stop()
        self.plugin.stop()
        self.state.chiplib.shutdown()

    def _device_watch_loop(self) -> None:
        """Keep the published inventory true to the hardware: wake on a
        device event (or every interval as a resync), re-enumerate, and
        republish when the chip set changed. The reference has no analog —
        its slices go stale on any post-start device change."""
        interval = self.config.device_watch_interval_seconds
        while not self._watch_stop.is_set():
            try:
                woke = self.state.chiplib.wait_device_event(interval)
                # Debounce: a vfio rebind is a delete-then-create burst and
                # the first event fires at the worst instant. Absorb events
                # until the device tree has been quiet for a beat — but
                # bounded, so sustained unrelated /dev churn (tty ATTRIB
                # noise etc.) cannot starve the refresh forever.
                settle_deadline = time.monotonic() + 2.0
                while (woke and not self._watch_stop.is_set()
                       and time.monotonic() < settle_deadline):
                    woke = self.state.chiplib.wait_device_event(
                        min(0.2, interval)
                    )
            except Exception:
                logger.exception("device watch failed; falling back to pacing")
                if self._watch_stop.wait(interval):
                    break
            if self._watch_stop.is_set():
                break
            self.tick_once()

    def tick_once(self, now: Optional[float] = None) -> dict:
        """One device-watch tick body, reentrant: health transitions →
        republish-on-change → elastic resize → rebalancer → defrag
        execution → audit, in the watch loop's order. The watch thread
        calls this on every wake; the fleet soak (fleetsim/) calls it
        directly with its virtual ``now`` so every plugin-side loop
        advances on one shared clock without threads or sleeps.

        ``now`` (when given) paces the rebalancer's interval; the audit
        step runs only on such virtual-clock drives, and only while the
        periodic auditor thread is disabled (``audit_interval_seconds
        <= 0``) — on the real watch thread the auditor keeps its own
        pacing, so thread-driven behavior is unchanged. Returns a small
        report of what the tick did (the soak's per-tick gate input)."""
        report: dict = {"changed": False, "transitions": 0,
                       "rebalanced": False, "auditFindings": None}
        try:
            changed = self.state.refresh_allocatable()
            self._last_inventory_ok = time.monotonic()
            transitions = self.state.drain_health_transitions()
            report["transitions"] = len(transitions)
            self._report_health_transitions(transitions)
            if changed:
                report["changed"] = True
                # Trace only actual inventory changes: a root trace per
                # idle 30s tick would evict the claim traces the ring
                # buffer exists to keep.
                with self.tracer.span("inventory-refresh"):
                    self._m_inventory_refreshes.inc()
                    logger.info("device inventory changed; republishing")
                    if self.config.kube_client is not None:
                        self.publish_resources()
                        if (transitions
                                and self._elastic_allocator is not None):
                            self._sync_slices_for_resolve()
            # Elastic gang resize runs AFTER the republish: the
            # re-solve reads published slices, which must already
            # reflect the transition (a shrink re-solving against
            # stale slices could pick the dead chip right back).
            self._maybe_elastic_resize(transitions)
        except Exception:
            logger.exception("device inventory refresh failed")
        try:
            # Dynamic-sharing tick rides the same wake: paced by its
            # own interval (against ``now`` when the soak supplies it),
            # and deliberately after the transitions — rebalancing must
            # see post-transition health and holds.
            report["rebalanced"] = self.rebalancer.maybe_tick(now=now)
        except Exception:
            logger.exception("rebalance tick failed")
        try:
            # Defrag execution rides the same wake, after the
            # rebalancer: a plan must execute against settled holds.
            self._maybe_execute_defrag()
        except Exception:
            logger.exception("defrag execution tick failed")
        if now is not None and self.config.audit_interval_seconds <= 0:
            # Virtual-clock drive with no auditor thread: the audit IS
            # part of the tick — the soak's "auditor silent at every
            # tick" gate reads this count.
            try:
                report["auditFindings"] = len(self.auditor.run_once())
            except Exception:
                logger.exception("audit pass failed")
                report["auditFindings"] = -1
        return report

    def _report_health_transitions(self, transitions) -> None:
        """Turn health transitions into the metric and, when the chip
        carries a PREPARED claim, a Kubernetes Event on that claim — the
        operator-visible signal that a running workload's hardware
        sickened (or recovered). Republishing itself rides the ordinary
        changed-inventory path."""
        for uuid, old_state, status in transitions:
            self._m_health_transitions.inc(
                from_state=old_state, to=status.state
            )
            recovered = status.is_healthy()
            logger.warning(
                "chip %s health: %s -> %s (%s)",
                uuid, old_state, status.state, status.reason or "recovered",
            )
            for pc in self.state.prepared_claims_on_chip(uuid):
                ref = ObjectRef.claim(
                    pc.name, pc.namespace, pc.claim_uid,
                    api_version=self.resource_api.api_version,
                )
                if recovered:
                    self.events.normal(
                        ref, "ChipRecovered",
                        f"chip {uuid} on {self.config.node_name} recovered "
                        f"(was {old_state})",
                    )
                else:
                    self.events.warning(
                        ref, "ChipUnhealthy",
                        f"chip {uuid} on {self.config.node_name} is "
                        f"{status.state}: {status.reason or 'unknown'} — "
                        "this claim holds a prepared device on it",
                    )

    # ------------------------------------------------------------------
    # Elastic gang resize (chip health → claim shrink/grow)
    # ------------------------------------------------------------------

    def enable_elastic(self, allocator) -> None:
        """Arm chip-health-driven gang resizing.

        ``allocator`` is the structured-parameters solver the coordinator
        re-solves claims against (the ReferenceAllocator in the sim; in a
        real cluster this seam is the scheduler). Once armed: a chip
        going unhealthy shrinks every exclusive multi-device gang it
        carries to the largest healthy contiguous sub-gang, and a chip
        recovering grows previously-shrunk gangs back toward their
        desired size. Every completed resize is checkpoint-backed
        (DeviceState.resize_claim), lands in the resize trace, emits a
        GangResized Event and the tpu_dra_elastic_* metrics, and is
        delivered to listeners as a typed :class:`GangResize` message."""
        self._elastic_allocator = allocator

    def enable_defrag_execution(self, executor) -> None:
        """Arm defrag plan execution (the ``--defrag-execute`` path).

        ``executor`` is a :class:`~..kube.defrag_executor.DefragExecutor`
        wired to the same allocator the planner watches (its intent file
        belongs under ``config.defrag_intent_path`` so it survives pod
        restarts). Arming: (1) runs crash recovery NOW, converging any
        intent a previous incarnation left mid-plan; (2) attaches the
        executor to the auditor, so in-flight plans are excluded from
        the resize check and orphaned intents surface as ``defrag``
        drift; (3) lets the device-watch loop execute each fresh
        ``planned`` plan (config.defrag_execute gates the loop — an
        executor attached with the flag off is recovery + observability
        only, the advisory default)."""
        try:
            executor.recover()
        except Exception:
            # A failed recovery leaves the intent for the auditor; the
            # driver still starts (degraded + loud, never dead).
            logger.exception("defrag intent recovery failed")
        self._defrag_executor = executor
        self.auditor.defrag_executor = executor

    def _maybe_execute_defrag(self) -> None:
        """Watch-loop trigger: execute the newest not-yet-attempted
        ``planned`` plan. One plan per tick — every execution re-solves
        under one allocator snapshot, and admitting one gang changes the
        fleet enough that any other outstanding plan is stale by
        construction."""
        executor = self._defrag_executor
        if not self.config.defrag_execute or executor is None:
            return
        planner = executor.planner
        candidates = [
            p for p in planner.recent_plans()
            if p.get("outcome") == "planned"
            and p.get("planId") not in self._executed_defrag_plans
        ]
        if not candidates:
            return
        plan = candidates[-1]
        self._executed_defrag_plans.add(plan["planId"])
        with self._lock:
            try:
                executor.execute(plan)
            except Exception:
                logger.exception(
                    "defrag plan %s execution failed", plan["planId"]
                )

    def add_resize_listener(self, callback) -> None:
        """Register ``callback(GangResize)`` — the workload-side hook.

        Called on the device-watch thread after the resize is durable
        (outside the claim lock, so prepares are never blocked — but
        health polling IS paused while callbacks run). Callbacks must
        return quickly: record the message and let the training loop
        perform the actual reshard (ElasticTrainer.resize), as the
        acceptance tests and ``make elastic`` do. Exceptions are logged,
        never propagated into the watch loop."""
        self._resize_listeners.append(callback)

    def resize_trace(self) -> list[dict]:
        """Newest-last gang-resize records (the operator's trace; each
        entry is a GangResize dict)."""
        return [m.to_dict() for m in self._resize_trace]

    def _sync_slices_for_resolve(self) -> None:
        """Land the republish before the elastic re-solve reads it. The
        slice controller syncs on its own thread, so a re-solve right
        after ``publish_resources`` could read the slice as it was: a grow
        then finds only the devices that were already there ("only 3 of
        4"). A failed sync (the apiserver down) is logged and the re-solve
        reads what is published, as it did before."""
        try:
            self.plugin.sync_slices()
        except Exception:
            logger.warning("slice sync before the elastic re-solve failed; "
                           "re-solving against the published slices",
                           exc_info=True)

    def _maybe_elastic_resize(self, transitions) -> None:
        if self._elastic_allocator is None or not transitions:
            return
        completed: list[GangResize] = []
        # Under the claim lock: a resize must not interleave with a
        # concurrent Prepare/Unprepare of the same claim (same order as
        # the RPC path: driver lock, then DeviceState lock).
        with self._lock:
            recovered: list[str] = []
            for uuid, old_state, status in transitions:
                try:
                    if status.is_healthy():
                        recovered.append(
                            f"chip {uuid} recovered (was {old_state})"
                        )
                    else:
                        completed.extend(
                            self._elastic_shrink_chip(uuid, status)
                        )
                except Exception:
                    logger.exception(
                        "elastic resize for chip %s transition failed",
                        uuid,
                    )
            if recovered:
                # ONE grow scan per transition batch: a whole host
                # coming back flips many chips healthy at once, and each
                # scan reads the full checkpoint.
                try:
                    completed.extend(
                        self._elastic_grow_all("; ".join(recovered))
                    )
                except Exception:
                    logger.exception("elastic grow scan failed")
        # Listener delivery OUTSIDE the claim lock, so a slow listener
        # never stalls NodePrepare/NodeUnprepare RPCs. It still runs ON
        # the device-watch thread (the resizes are already durable):
        # listeners must return quickly and hand heavy work — the actual
        # reshard — to the training loop (see add_resize_listener).
        for msg in completed:
            for cb in self._resize_listeners:
                try:
                    cb(msg)
                except Exception:
                    logger.exception("resize listener failed")

    def _elastic_shrink_chip(
        self, chip_uuid: str, status
    ) -> list[GangResize]:
        reason = (
            f"chip {chip_uuid} {status.state}: "
            f"{status.reason or 'unknown'}"
        )
        completed = []
        for view in self.state.gangs_on_chip(chip_uuid):
            health = self.state.chip_health
            surviving = []
            lost = []
            for name, cuuid in view["devices"]:
                st = health.get(cuuid)
                if st is None or st.is_healthy():
                    surviving.append(name)
                else:
                    lost.append(name)
            if not lost:
                continue
            if len(view["devices"]) < 2:
                # A single-device claim has nothing to shrink TO; the
                # ChipUnhealthy Event already covers it.
                continue
            if not surviving:
                self._elastic_failed(
                    view, "shrink", reason + " — no surviving devices"
                )
                continue
            msg = self._elastic_resize_claim(
                view, "shrink", len(surviving), reason
            )
            if msg is not None:
                completed.append(msg)
        return completed

    def _elastic_grow_all(self, reason: str) -> list[GangResize]:
        completed = []
        for view in self.state.elastic_claims():
            desired = view.get("desired")
            if not desired or len(view["devices"]) >= desired:
                continue
            msg = self._elastic_resize_claim(view, "grow", desired, reason)
            if msg is not None:
                completed.append(msg)
        return completed

    def _elastic_resize_claim(
        self, view: dict, direction: str, want: int, reason: str
    ) -> Optional[GangResize]:
        """Re-solve the claim for the largest satisfiable gang size
        ``<= want`` and apply the result through the checkpointed resize
        protocol; returns the completed GangResize (None on failure —
        the caller delivers messages to listeners outside the lock). The
        descending-count retry IS the incremental re-solve: gang
        contiguity may make the full survivor count unsat (three
        survivors of a 2x2 block form no box) while a smaller one works."""
        from ..kube.allocator import AllocationError

        uid = view["claim_uid"]
        t0 = time.monotonic()
        device_class = self._elastic_device_class(view)
        if device_class is None:
            self._elastic_failed(
                view, direction,
                reason + " — gang mixes device types; not resizable",
            )
            return None
        # The re-solve reuses the claim's OWN request name: results feed
        # straight back into KubeletDevice.request_names, which kubelet
        # matches against the ResourceClaim spec — an invented name
        # would strand added devices on a request that does not exist.
        req_names = view.get("request_names") or []
        if len(req_names) != 1:
            self._elastic_failed(
                view, direction,
                reason + f" — gang spans request names {req_names}; "
                "only single-request gangs are resizable",
            )
            return None
        request_name = req_names[0]
        current = len(view["devices"])
        floor = current + 1 if direction == "grow" else 1
        # The claim's CURRENT allocation, for restoring allocator state
        # when the re-solve or apply fails: its live, exclusively-held
        # devices must not be left looking free.
        current_results = [
            {"request": request_name, "driver": self.config.driver_name,
             "pool": self.config.node_name, "device": name}
            for name, _ in view["devices"]
        ]
        # The whole descent runs under ONE allocator snapshot: the
        # republish already happened, so every candidate size must solve
        # against the same moment-in-time slices — and re-probing the
        # apiserver per attempt made the descent O(sizes × inventory)
        # for nothing. Each attempt still emits its own funnel into
        # /debug/allocations (the snapshot pins inventory, not records).
        # A FakeAllocator in tests may not implement snapshot();
        # fall back to the old per-attempt refresh there.
        snapshot = getattr(
            self._elastic_allocator, "snapshot", contextlib.nullcontext
        )
        with self.tracer.span(
            "gang-resize", claim_uid=uid,
            tags={"direction": direction, "reason": reason},
        ) as span, snapshot():
            self._elastic_allocator.deallocate(uid)
            allocated = None
            count = want
            last_err: Optional[Exception] = None
            while count >= floor:
                synth = {
                    "metadata": {
                        "uid": uid,
                        "name": view["name"],
                        "namespace": view["namespace"],
                    },
                    "spec": {"devices": {"requests": [{
                        "name": request_name,
                        "deviceClassName": device_class,
                        "allocationMode": "ExactCount",
                        "count": count,
                    }]}},
                }
                try:
                    allocated = self._elastic_allocator.allocate(
                        synth,
                        node_name=self.config.node_name,
                        require_healthy=True,
                    )
                    break
                except AllocationError as e:
                    last_err = e
                    count -= 1
            if allocated is None:
                span.set_error(str(last_err))
                self._elastic_allocator.restore_reservations(
                    uid, current_results
                )
                self._elastic_failed(
                    view, direction,
                    f"{reason} — re-solve unsat down to gang size "
                    f"{floor} ({last_err})",
                )
                return None
            results = (
                allocated["status"]["allocation"]["devices"]["results"]
            )
            try:
                self.state.resize_claim(
                    uid, results,
                    desired=view.get("desired") or current,
                )
            except Exception as e:
                span.set_error(str(e))
                # The allocator holds the NEW allocation but the claim
                # kept its OLD gang: put the allocator back in step.
                self._elastic_allocator.deallocate(uid)
                self._elastic_allocator.restore_reservations(
                    uid, current_results
                )
                self._elastic_failed(
                    view, direction, f"{reason} — apply failed: {e}"
                )
                return None
            span.set_tag("devices", len(results))

        old_names = [n for n, _ in view["devices"]]
        new_names = [r["device"] for r in results]
        msg = GangResize(
            claim_uid=uid,
            claim_name=view["name"],
            namespace=view["namespace"],
            direction=direction,
            reason=reason,
            removed=tuple(n for n in old_names if n not in new_names),
            added=tuple(n for n in new_names if n not in old_names),
            devices=tuple(new_names),
            desired=view.get("desired") or current,
            generation=view["generation"] + 1,
            at=time.time(),
        )
        self._resize_trace.append(msg)
        self._m_elastic_resizes.inc(direction=direction, outcome="ok")
        self._m_elastic_resize_seconds.observe(time.monotonic() - t0)
        self._m_elastic_last_resize.set(msg.at)
        logger.warning(
            "gang %s of claim %s: %d -> %d device(s) (%s)",
            direction, uid, len(old_names), len(new_names), reason,
        )
        self.events.normal(
            self._elastic_claim_ref(view), "GangResized",
            f"gang {direction} on {self.config.node_name}: "
            f"{len(old_names)} -> {len(new_names)} device(s) "
            f"[{', '.join(new_names)}] — {reason}",
        )
        return msg

    def _elastic_device_class(self, view: dict) -> Optional[str]:
        """The DeviceClass to re-solve with, from the gang's
        CHECKPOINTED device types (PreparedDevice.type — name re-parsing
        would misclassify non-1c tensorcore partitions); None for
        mixed/unknown gangs."""
        types = view.get("device_types") or []
        if len(types) != 1:
            return None
        return _ELASTIC_DEVICE_CLASSES.get(types[0])

    def _elastic_claim_ref(self, view: dict) -> ObjectRef:
        return ObjectRef.claim(
            view["name"], view["namespace"], view["claim_uid"],
            api_version=self.resource_api.api_version,
        )

    def _elastic_failed(
        self, view: dict, direction: str, detail: str
    ) -> None:
        self._m_elastic_resizes.inc(direction=direction, outcome="failed")
        logger.error(
            "gang %s of claim %s failed: %s",
            direction, view["claim_uid"], detail,
        )
        self.events.warning(
            self._elastic_claim_ref(view), "GangResizeFailed",
            f"gang {direction} on {self.config.node_name} failed: "
            f"{detail}",
        )

    def _adopt_resource_api(self, api: ResourceApi) -> None:
        """Take a re-discovered dialect observed by a sibling component
        (the orphan cleaner), so the next claim fetch uses it directly."""
        logger.warning(
            "adopting re-discovered resource.k8s.io dialect %s", api.version
        )
        self.resource_api = api

    def publish_resources(self) -> None:
        """Publish node-local devices (driver.go:69-80 analog; ICI channels
        are excluded — the cluster controller publishes those as network
        resources, mirroring IMEX)."""
        res = self.state.published_resources()
        self.plugin.publish_resources(
            DriverResources(
                pools={
                    self.config.node_name: Pool(
                        devices=res["devices"],
                        shared_counters=res["sharedCounters"],
                        node_name=self.config.node_name,
                    )
                }
            )
        )

    # ------------------------------------------------------------------
    # Readiness (consumed by MetricsServer.add_readiness_check)
    # ------------------------------------------------------------------

    def readiness_checks(self) -> dict:
        """Named readiness probes for /readyz: serving ∧ fresh inventory ∧
        writable checkpoint. A plugin failing any of these can still be
        alive (liveness stays green) but must stop advertising ready."""
        return {
            "grpc-serving": self._check_grpc_serving,
            "inventory-fresh": self._check_inventory_fresh,
            "checkpoint-writable": self._check_checkpoint_writable,
        }

    def degraded_checks(self) -> dict:
        """Non-critical /readyz probes: failing these reads DEGRADED (HTTP
        200, body says so), not dead — during an apiserver outage the
        plugin still serves prepares from checkpointed state, and flipping
        readiness would make kubelet stop talking to a working plugin.
        State drift is equally non-fatal: the plugin keeps serving while
        an operator (or the doctor CLI) investigates the findings."""
        return {
            "apiserver-reachable": self._check_apiserver,
            "state-consistent": self.auditor.readiness_check,
        }

    def _check_apiserver(self):
        if self.config.kube_client is None:
            return True, "kube-less dev mode"
        problems = []
        slice_ok, detail = self.plugin.slice_sync_health()
        if not slice_ok:
            problems.append(detail)
        with self._apiserver_state_lock:
            if not self._apiserver_ok:
                # The claim path only re-probes when kubelet sends a
                # claim — which may be never on a quiet node. A slice
                # reconcile that SUCCEEDED after the claim fetch failed
                # is equally good evidence the server is back; don't stay
                # degraded on stale news. (Under the state lock: a fresh
                # failure recorded concurrently must not be clobbered by
                # this recovery write.)
                if (slice_ok and self.plugin.slice_sync_success_at()
                        > self._apiserver_failed_at):
                    self._apiserver_ok = True
                    self._apiserver_err = ""
                else:
                    problems.append(
                        f"claim fetch failing: {self._apiserver_err}"
                    )
        if problems:
            return False, "; ".join(problems)
        return True, "apiserver reachable"

    def _check_grpc_serving(self):
        # The check keeps the reference's name (dashboards and /readyz
        # read the same); its detail names the transport.
        if self.plugin.serving:
            return True, f"dra serving: {self.plugin.transport.detail}"
        return False, "DRA services not started"

    def _check_inventory_fresh(self):
        interval = self.config.device_watch_interval_seconds
        if interval <= 0:
            return True, "device watch disabled"
        age = time.monotonic() - self._last_inventory_ok
        # Three missed resync rounds (plus debounce slack) means the watch
        # loop is wedged or enumeration keeps failing.
        limit = max(3 * interval, 90.0)
        if age <= limit:
            return True, f"last refresh {age:.0f}s ago"
        return False, f"inventory stale: last refresh {age:.0f}s ago"

    def _check_checkpoint_writable(self):
        import os

        # atomic_write_json writes a temp file beside the checkpoint and
        # renames it over; only DIRECTORY writability matters — the
        # existing file's own mode bits never gate a write.
        probe = os.path.dirname(self.state.checkpoint.path)
        if os.access(probe, os.W_OK):
            return True, "checkpoint writable"
        return False, f"checkpoint dir not writable: {probe}"

    # ------------------------------------------------------------------
    # DRA node service (driver.go:94-152)
    # ------------------------------------------------------------------

    def NodePrepareResources(self, request, context):
        response = drapb.NodePrepareResourcesResponse()
        for claim in request.claims:
            response.claims[claim.uid] = self._prepare_claim(claim)
        return response

    def _prepare_claim(self, claim) -> drapb.NodePrepareResourceResponse:
        """nodePrepareResource analog (driver.go:116-139): per-claim errors
        are returned in-band, never raised. The whole operation runs under
        a claim-UID-tagged span (child of the RPC root span); its duration
        feeds the prepare-latency histogram, so traces and metrics time
        the same interval."""
        claim_ref = ObjectRef.claim(
            claim.name, claim.namespace, claim.uid,
            api_version=self.resource_api.api_version,
        )
        with self._lock:
            span = self.tracer.span(
                "prepare", claim_uid=claim.uid,
                tags={"claim": f"{claim.namespace}/{claim.name}"},
            )
            error: Optional[Exception] = None
            with span:
                try:
                    devices = self._fetch_and_prepare(claim)
                    logger.debug(
                        "prepared claim %s: %d device(s)",
                        claim.uid, len(devices),
                    )
                except Exception as e:
                    error = e
                    span.set_error(str(e))
            self._m_prepare_latency.observe(span.duration)
            if error is not None:
                self._m_prepares.inc(result="error")
                logger.error("prepare of claim %s failed", claim.uid,
                             exc_info=error)
                self.events.warning(
                    claim_ref, "PrepareFailed",
                    f"preparing devices on {self.config.node_name} failed: "
                    f"{error}",
                )
                return drapb.NodePrepareResourceResponse(
                    error=f"error preparing devices for claim {claim.uid}: "
                          f"{error}"
                )
            self._m_prepares.inc(result="ok")
            self.events.normal(
                claim_ref, "Prepared",
                f"prepared {len(devices)} device(s) on "
                f"{self.config.node_name}",
            )
            return drapb.NodePrepareResourceResponse(
                devices=[
                    drapb.Device(
                        request_names=d.request_names,
                        pool_name=d.pool_name,
                        device_name=d.device_name,
                        cdi_device_ids=d.cdi_device_ids,
                    )
                    for d in devices
                ]
            )

    def _fetch_and_prepare(self, claim):
        """Fetch-verify-prepare, with the degraded-mode fallback.

        When the apiserver cannot be reached at all, an ALREADY-PREPARED
        claim (present in the checkpoint) is served from its recorded
        result: a kubelet retry or container restart must not fail just
        because the control plane is dark — the devices are already set
        up on this node. A claim the checkpoint does not know still fails
        (preparing something new requires the allocation spec, which only
        the apiserver holds). Apiserver ANSWERS are NOT absorbed —
        NotFound, identity failures, and any non-outage ApiError (a 403
        from an RBAC regression must surface as a prepare failure, not be
        masked as an outage); only transport errors, timeouts, and
        429/5xx load-shedding count as unreachable.
        """
        from ..kube.errors import NotFoundError

        try:
            with tracing.child_span("fetch-claim"):
                resource_claim = self._fetch_claim(claim)
        except (NotFoundError, ClaimVerifyError):
            self._note_apiserver(ok=True)  # the server answered
            raise
        except Exception as e:
            if not _is_outage(e):
                self._note_apiserver(ok=True)  # answered, not usefully
                raise
            self._note_apiserver(ok=False, err=str(e))
            cached = self.state.cached_devices(claim.uid)
            if cached is None:
                raise
            self._m_degraded_prepares.inc()
            logger.warning(
                "apiserver unreachable (%s); serving prepare of claim %s "
                "from checkpointed state (degraded mode)", e, claim.uid,
            )
            return cached
        self._note_apiserver(ok=True)
        with tracing.child_span("allocate"):
            return self.state.prepare(resource_claim)

    def _note_apiserver(self, ok: bool, err: str = "") -> None:
        with self._apiserver_state_lock:
            self._apiserver_ok = ok
            self._apiserver_err = err
            if not ok:
                self._apiserver_failed_at = time.monotonic()

    def _fetch_claim(self, claim) -> dict:
        """GET the ResourceClaim and verify identity (driver.go:120-131).

        A NotFound may mean the claim is gone — or that startup discovery
        fell back to the wrong resource.k8s.io dialect while the apiserver
        was unreachable: re-discover once and retry before treating it as
        a missing claim, so a bad boot self-heals without a pod restart.
        """
        if self.config.kube_client is None:
            raise ClaimVerifyError("no kube client configured")
        from ..kube.errors import NotFoundError

        try:
            obj = self.config.kube_client.get(
                self.resource_api.claims, claim.name, namespace=claim.namespace
            )
        except NotFoundError:
            # Rate-limited (claims legitimately vanish all the time — each
            # re-discovery is a synchronous GET under the claim lock) and
            # fallback-free (try_discover: a FAILED discovery must not
            # read as "the server moved dialects").
            now = time.monotonic()
            if now - self._last_rediscover < self.REDISCOVER_INTERVAL_S:
                raise
            self._last_rediscover = now
            rediscovered = ResourceApi.try_discover(self.config.kube_client)
            if (
                rediscovered is None
                or rediscovered.version == self.resource_api.version
            ):
                raise
            logger.warning(
                "resource.k8s.io dialect changed %s -> %s; re-targeting",
                self.resource_api.version, rediscovered.version,
            )
            self.resource_api = rediscovered
            obj = self.config.kube_client.get(
                self.resource_api.claims, claim.name, namespace=claim.namespace
            )
        obj = self.resource_api.claim_from_wire(obj)
        uid = obj["metadata"].get("uid", "")
        if uid != claim.uid:
            raise ClaimVerifyError(
                f"claim {claim.namespace}/{claim.name} UID mismatch: "
                f"kubelet={claim.uid} apiserver={uid} (deleted+recreated?)"
            )
        return obj

    def NodeUnprepareResources(self, request, context):
        response = drapb.NodeUnprepareResourcesResponse()
        for claim in request.claims:
            with self._lock:
                with self.tracer.span("unprepare",
                                      claim_uid=claim.uid) as span:
                    try:
                        self.state.unprepare(claim.uid)
                        self._m_unprepares.inc(result="ok")
                        response.claims[claim.uid] = (
                            drapb.NodeUnprepareResourceResponse()
                        )
                    except Exception as e:
                        span.set_error(str(e))
                        self._m_unprepares.inc(result="error")
                        logger.exception("unprepare of claim %s failed",
                                         claim.uid)
                        self.events.warning(
                            ObjectRef.claim(
                                claim.name, claim.namespace, claim.uid,
                                api_version=self.resource_api.api_version,
                            ),
                            "UnprepareFailed",
                            f"unpreparing on {self.config.node_name} "
                            f"failed: {e}",
                        )
                        response.claims[claim.uid] = (
                            drapb.NodeUnprepareResourceResponse(
                                error=f"error unpreparing claim "
                                      f"{claim.uid}: {e}"
                            )
                        )
        return response
