"""Cluster assembly for the fleet soak: the REAL subsystems, one clock.

:class:`FleetCluster` wires the production objects — a full
:class:`~..plugin.driver.Driver` (DeviceState, auditor, rebalancer,
elastic coordinator, defrag execution), the
:class:`~..kube.allocator.ReferenceAllocator` with its attached
:class:`~..kube.defrag.DefragPlanner`/:class:`~..kube.defrag_executor.DefragExecutor`
pair, and a :class:`~..serving_gateway.gateway.ServingGateway` with
admission, affinity routing, autoscaling, and telemetry — against a
FakeKubeClient cluster and a FakeChipLib mesh, all reading ONE virtual
clock owned by the harness. Nothing here starts a thread: the driver is
constructed but never ``start()``ed, slice publication is made
synchronous (see :class:`SyncingSliceController`), and every loop
advances only when the harness calls ``Driver.tick_once(now=...)`` or
``ServingGateway.tick()``.

The initial workload layout follows the scenario's chip roles (see
``scenario.py``): a prepared 2-chip elastic training gang, two
ProcessShared co-tenants with SLOs on the shared chip, and pinned
serving replicas provisioned through the same
:class:`ChipProvisioner` the autoscaler scales with — so a scale-up
mid-soak is exactly the initial provisioning path, not a sim shortcut.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..kube import NODES, FakeKubeClient
from ..kube.allocator import ReferenceAllocator, Selector
from ..kube.defrag import DefragPlanner
from ..kube.defrag_executor import DefragExecutor
from ..kube.resourceslice import ResourceSliceController
from ..plugin.driver import Driver, DriverConfig
from ..serving_gateway import (
    AdmissionPolicy,
    Autoscaler,
    AutoscalerPolicy,
    Replica,
    Router,
    ServingGateway,
    ServingTelemetry,
)
from ..serving_gateway.sim import ScriptedEngine
from ..tpulib import FakeChipLib
from ..utils.metrics import Registry
from .scenario import ScenarioSpec

logger = logging.getLogger(__name__)

NODE_NAME = "node-a"
NODE_UID = "fleet-node-uid"
DRIVER_NAME = "tpu.google.com"

# The shared chip's co-tenants: a realtime inference tenant the diurnal
# curve loads up, and a batch tenant whose idle cores the rebalancer
# steals at peak (and returns at the trough).
SHARED_INFER_UID = "uid-share-rt"
SHARED_BATCH_UID = "uid-share-batch"
TRAIN_UID = "uid-train"
BURST_GANG_UID = "uid-burst-gang"


class SyncingSliceController(ResourceSliceController):
    """Slice publication on the virtual timeline: ``update()``
    reconciles IMMEDIATELY instead of nudging a reconciler thread, so
    the auditor's slices check — which runs at the end of the same
    ``tick_once`` that republished — never diffs against a publish
    still sitting in a queue. During the apiserver blackout the sync
    raises; that is expected staleness, not an error: it is swallowed
    (counted), and the next post-blackout publish converges."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.sync_errors = 0

    def update(self, resources) -> None:
        super().update(resources)
        try:
            self.sync_once()
        except Exception as e:
            self.sync_errors += 1
            logger.debug("virtual-clock slice sync deferred: %s", e)


def chip_claim(uid: str, count: int, config: Optional[list] = None) -> dict:
    """A minimal ExactCount chip ResourceClaim in wire shape."""
    return {
        "metadata": {"name": f"wl-{uid}", "namespace": "fleetsim",
                     "uid": uid},
        "spec": {"devices": {
            "requests": [{
                "name": "r0", "deviceClassName": DRIVER_NAME,
                "allocationMode": "ExactCount", "count": count,
            }],
            **({"config": config} if config else {}),
        }},
    }


def _process_shared_config(pct: int, hbm: str, slo: dict) -> list:
    return [{
        "requests": [], "source": "FromClaim",
        "opaque": {"driver": DRIVER_NAME, "parameters": {
            "apiVersion": "tpu.google.com/v1alpha1",
            "kind": "TpuChipConfig",
            "sharing": {
                "strategy": "ProcessShared",
                "processSharedConfig": {
                    "maxProcesses": 2,
                    "defaultActiveCorePercentage": pct,
                    "defaultHbmLimit": hbm,
                    "slo": slo,
                },
            },
        }},
    }]


class ChipProvisioner:
    """The autoscaler's ReplicaProvisioner over the REAL allocation
    path: scale-up solves a fresh 1-chip claim (optionally pinned),
    prepares it on the driver's DeviceState, and returns a replica on a
    new ScriptedEngine; scale-down (after the gateway's zero-loss
    drain) unprepares and deallocates the victim's claim. An allocate
    failure (no free healthy chip, blackout) raises — the autoscaler
    records the scale as ``failed`` and backs off, exactly the
    production contract."""

    def __init__(self, cluster: "FleetCluster"):
        self.cluster = cluster
        self._seq = 0

    def scale_up(self, coord: Optional[str] = None) -> Replica:
        c = self.cluster
        uid = f"uid-serve-{self._seq}"
        self._seq += 1
        claim = chip_claim(uid, 1)
        selectors = None
        if coord is not None:
            selectors = {"r0": [Selector("coord", "eq", coord)]}
        c.allocator.allocate(claim, node_name=NODE_NAME,
                             selectors=selectors, require_healthy=True)
        try:
            c.driver.state.prepare(claim)
        except Exception:
            c.allocator.deallocate(uid)
            raise
        engine = c.new_engine()
        return Replica(f"rep-{uid}", engine, claim_uid=uid)

    def scale_down(self, replica: Replica) -> None:
        self.cluster.release_claim(replica.claim_uid)


class FleetCluster:
    """Everything the harness drives, assembled. ``clock`` is the one
    virtual clock; advance it by assigning ``clock_box[0]``."""

    def __init__(self, spec: ScenarioSpec, tmp: str,
                 registry: Optional[Registry] = None):
        self.spec = spec
        self.clock_box = [0.0]
        # One registry for every component family (tpu_dra_claim_*,
        # tpu_dra_gw_*, tpu_dra_alloc_*, ...); the harness keeps the
        # tpu_dra_fleet_* family on its own registry so a host process
        # (verify_metrics) can absorb fleet metrics without colliding
        # with its own component sims.
        self.registry = registry if registry is not None else Registry()

        self.client = FakeKubeClient()
        self.client.create(NODES, {
            "metadata": {"name": NODE_NAME, "uid": NODE_UID},
        })
        self.chiplib = FakeChipLib(generation=spec.generation,
                                   topology=spec.topology)
        self.driver = Driver(DriverConfig(
            node_name=NODE_NAME,
            chiplib=self.chiplib,
            kube_client=self.client,
            cdi_root=f"{tmp}/cdi",
            plugin_root=f"{tmp}/plugin",
            registrar_root=f"{tmp}/registrar",
            state_root=f"{tmp}/state",
            node_uid=NODE_UID,
            cleanup_interval_seconds=0,
            device_watch_interval_seconds=0,
            audit_interval_seconds=0,
            rebalance_interval_seconds=spec.rebalance_interval_s,
            defrag_execute=True,
        ), registry=self.registry)

        # Synchronous slice publication (no reconciler thread), then the
        # first publish so the allocator has an inventory to solve
        # against.
        self.slice_controller = SyncingSliceController(
            self.client, DRIVER_NAME, scope=NODE_NAME,
            owner={"apiVersion": "v1", "kind": "Node",
                   "name": NODE_NAME, "uid": NODE_UID},
            api=self.driver.resource_api,
        )
        self.driver.plugin.attach_slice_controller(self.slice_controller)
        self.driver.publish_resources()

        # The driver builds its rebalancer on the wall clock and a
        # file-based demand source; the soak re-points both at the
        # virtual timeline — snapshot()'s belowMinSeconds math must use
        # the same clock maybe_tick(now=...) advances, and demand is the
        # scenario's diurnal curve, not usage files nobody writes here.
        self.driver.rebalancer._clock = self.clock
        self.driver.rebalancer.demand_source = self._shared_demand

        self.allocator = ReferenceAllocator(self.client,
                                            registry=self.registry)
        self.driver.enable_elastic(self.allocator)
        self.planner = DefragPlanner(self.allocator, registry=self.registry)

        # Gateway stack on the virtual clock.
        budgets = {name: {"ttftS": ttft, "e2eS": e2e}
                   for name, ttft, e2e in spec.p99_budgets}
        self.telemetry = ServingTelemetry(self.registry, slo=budgets)
        self.provisioner = ChipProvisioner(self)
        self.gateway = ServingGateway(
            self.registry,
            router=Router(policy="affinity", block_size=spec.block_size,
                          affinity_blocks=4, seed=spec.seed),
            admission_policy=AdmissionPolicy(
                shed_watermark=spec.shed_watermark,
                hard_watermark=spec.hard_watermark,
                max_queue_delay_s={
                    c.name: c.max_queue_delay_s for c in spec.classes
                },
            ),
            autoscaler=Autoscaler(AutoscalerPolicy(
                min_replicas=spec.min_replicas,
                max_replicas=spec.max_replicas,
                queue_high_water=spec.queue_high_water,
                queue_low_water=spec.queue_low_water,
                dwell_ticks=spec.dwell_ticks,
                cooldown_seconds=spec.cooldown_s,
            ), self.provisioner),
            events=self.driver.events,
            node_name=NODE_NAME,
            node_uid=NODE_UID,
            clock=self.clock,
            telemetry=self.telemetry,
        )

        self.executor = DefragExecutor(
            self.planner, self.allocator,
            intent_path=self.driver.config.defrag_intent_path,
            state=self.driver.state,
            gateway=self.gateway,
            registry=self.registry,
            events=self.driver.events,
            node_name=NODE_NAME,
        )
        self.driver.enable_defrag_execution(self.executor)

        self.resizes: list = []
        self.driver.add_resize_listener(self.resizes.append)

        self._place_initial_workloads()

    # -- clock -------------------------------------------------------------

    def clock(self) -> float:
        return self.clock_box[0]

    def _shared_demand(self, view) -> Optional[dict]:
        """Deterministic per-claim demand for the rebalancer, derived
        from the scenario's diurnal phase: the realtime co-tenant's
        busyness follows the traffic curve (idle donor at the trough,
        hungry past the high-water near the peak), the batch co-tenant
        idles just under the low-water mark — so the soak exercises
        steal-idle at peak and return/restore on the way down."""
        import math

        t = self.clock()
        day = 0.5 * (1.0 - math.cos(
            2.0 * math.pi * min(t, self.spec.duration_s)
            / self.spec.duration_s
        ))
        if view.claim_uid == SHARED_INFER_UID:
            return {"busy": round(0.15 + 0.80 * day, 6)}
        if view.claim_uid == SHARED_BATCH_UID:
            return {"busy": 0.30}
        return None

    # -- engines / claims --------------------------------------------------

    def new_engine(self) -> ScriptedEngine:
        return ScriptedEngine(
            batch_slots=self.spec.batch_slots,
            prefill_chunk=self.spec.prefill_chunk,
            block_size=self.spec.block_size,
            clock=self.clock,
        )

    def release_claim(self, uid: str) -> None:
        """Unprepare + deallocate, tolerating a device that is already
        gone (the failover path releases the claim of an unplugged
        chip)."""
        try:
            self.driver.state.unprepare(uid)
        except Exception:
            logger.exception("unprepare of %s failed", uid)
        self.allocator.deallocate(uid)

    def _place_initial_workloads(self) -> None:
        spec = self.spec
        state = self.driver.state

        # Elastic training gang, pinned to its scenario chips.
        coords = [f"{c},0,0" for c in spec.train_chips]
        train = chip_claim(TRAIN_UID, len(coords))
        self.allocator.allocate(
            train, node_name=NODE_NAME,
            selectors={"r0": [Selector("coord", "in", coords)]},
        )
        state.prepare(train)

        # ProcessShared co-tenants on the shared chip. The inference
        # tenant's claim carries the allocator reservation (one holder
        # per device as far as placement is concerned); the batch
        # tenant shares the chip through the sharing holds the prepare
        # path enforces (maxProcesses=2).
        shared_coord = f"{spec.shared_chip},0,0"
        infer = chip_claim(SHARED_INFER_UID, 1, config=_process_shared_config(
            30, "4Gi", {"latencyClass": "realtime",
                        "minTensorCorePercent": 30,
                        "burstTensorCorePercent": 80, "priority": 10},
        ))
        self.allocator.allocate(
            infer, node_name=NODE_NAME,
            selectors={"r0": [Selector("coord", "eq", shared_coord)]},
        )
        state.prepare(infer)
        shared_device = (
            infer["status"]["allocation"]["devices"]["results"][0]["device"]
        )
        batch = chip_claim(SHARED_BATCH_UID, 1)
        batch["status"] = {"allocation": {"devices": {
            "results": [{
                "request": "r0", "driver": DRIVER_NAME,
                "pool": NODE_NAME, "device": shared_device,
            }],
            "config": _process_shared_config(
                60, "12Gi", {"latencyClass": "batch",
                             "minTensorCorePercent": 20},
            ),
        }}}
        state.prepare(batch)

        # Pinned serving replicas through the provisioner — the same
        # path autoscaler scale-ups take mid-soak.
        for chip in spec.serving_chips:
            replica = self.provisioner.scale_up(coord=f"{chip},0,0")
            self.gateway.add_replica(replica.engine, replica.replica_id,
                                     claim_uid=replica.claim_uid)

    # -- harness queries ---------------------------------------------------

    def claim_devices(self, uid: str) -> list:
        """Device names the allocator currently reserves for ``uid``."""
        return sorted(
            name for (_, name), holder
            in self.allocator._reservations.items() if holder == uid
        )

    def replica_on_chip(self, chip: int) -> Optional[Replica]:
        """The serving replica whose claim holds ``tpu-<chip>``, if
        any (the failover path's target resolution)."""
        device = f"tpu-{chip}"
        for r in self.gateway.router.replicas():
            if device in self.claim_devices(r.claim_uid):
                return r
        return None
