"""IciSliceManager: cluster-level publisher of interconnect-channel pools.

Analog of the reference's IMEX manager (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-controller/imex.go:67-422). The mapping:

- IMEX *domain* (nodes labeled ``nvidia.com/gpu.imex-domain``, imex.go:39)
  → TPU *pod slice*: nodes labeled ``tpu.google.com/slice-id``. All hosts of
  one multi-host slice share the label, the way IMEX-domain nodes do.
- IMEX *clique* (``nvidia.com/gpu.clique``) → optional
  ``tpu.google.com/clique-id`` sub-domain (e.g. an ICI sub-ring).
- IMEX channels 0-2047, 128 per ResourceSlice (imex.go:42-45) → ICI
  channels with identical capacity constants.
- Channel pools are **network resources**: ResourceSlices with a
  NodeSelector on the slice label instead of a nodeName
  (imex.go:381-422), so the scheduler can place a claim on any host of
  the slice, which is exactly the gang-scheduling seam multi-host jobs
  need.

Workloads claim one channel per pod; Prepare on the node then materialises
the channel device node + the distributed-init env (see plugin side).

The port's copy of the reference module. A GPU node carries no slice label
(its cards reach each other over NVLink, not an interconnect mesh), so the
manager publishes no channel pool for it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
from typing import Optional

from ..kube.client import NODES, KubeClient, Watch
from ..kube.events import EventRecorder, ObjectRef
from ..kube.resourceslice import (
    DriverResources,
    Pool,
    ResourceSliceController,
)
from ..tpulib.deviceinfo import IciChannelInfo, is_ici_channel_device_name
from ..utils.backoff import Backoff
from ..utils.metrics import Counter, Gauge, Histogram, Registry
from ..utils.tracing import Tracer

logger = logging.getLogger(__name__)

SLICE_LABEL = "tpu.google.com/slice-id"
CLIQUE_LABEL = "tpu.google.com/clique-id"

# Capacity constants mirroring imex.go:42-45 / nvlib.go:441-444.
CHANNELS_PER_DRIVER = 2048
CHANNELS_PER_POOL = 128


@dataclasses.dataclass(frozen=True)
class DomainKey:
    """(slice, clique) identity (imex.go's domain+cliqueID offsets)."""

    slice_id: str
    clique_id: str = ""

    @property
    def pool_name(self) -> str:
        # Slice/clique ids may themselves contain hyphens, so plain
        # concatenation is ambiguous (("a-b","") vs ("a","b")); a short
        # digest of the unambiguous identity disambiguates.
        digest = hashlib.sha256(
            f"{self.slice_id}/{self.clique_id}".encode()
        ).hexdigest()[:6]
        base = f"ici-{self.slice_id}"
        if self.clique_id:
            base = f"{base}-{self.clique_id}"
        return f"{base}-{digest}"


class OffsetAllocator:
    """Slots of CHANNELS_PER_POOL within CHANNELS_PER_DRIVER
    (offset allocator analog, imex.go:329-368)."""

    def __init__(self):
        self._offsets: dict[DomainKey, int] = {}

    def add(self, key: DomainKey) -> int:
        if key in self._offsets:
            return self._offsets[key]
        used = set(self._offsets.values())
        for offset in range(0, CHANNELS_PER_DRIVER, CHANNELS_PER_POOL):
            if offset not in used:
                self._offsets[key] = offset
                return offset
        raise RuntimeError(
            f"out of ICI channel capacity ({CHANNELS_PER_DRIVER}) for {key}"
        )

    def remove(self, key: DomainKey) -> None:
        self._offsets.pop(key, None)

    def restore(self, key: DomainKey, offset: int) -> None:
        """Pin a known offset during crash recovery."""
        self._offsets[key] = offset

    def get(self, key: DomainKey) -> Optional[int]:
        return self._offsets.get(key)


class IciSliceManager:
    """StartIMEXManager analog (imex.go:67-118)."""

    SCOPE = "controller"  # OWNER_LABEL value for cluster-published slices

    def __init__(
        self,
        client: KubeClient,
        driver_name: str = "tpu.google.com",
        owner: Optional[dict] = None,
        resource_api=None,
        registry: Optional[Registry] = None,
        tracer: Optional[Tracer] = None,
        events: Optional[EventRecorder] = None,
    ):
        from ..kube.resourceapi import ResourceApi

        self.client = client
        self.driver_name = driver_name
        self.slice_controller = ResourceSliceController(
            client, driver_name, scope=self.SCOPE, owner=owner,
            api=resource_api or ResourceApi.discover(client),
        )
        # Reconcile-loop observability — the reference controller emits
        # nothing per reconcile; a wedged watch or thrashing republish was
        # invisible until slices went stale.
        reg = registry if registry is not None else Registry()
        self.tracer = tracer or Tracer()
        self.events = events  # Warning on the Node whose event failed
        self._m_reconcile_seconds = Histogram(
            "tpu_dra_reconcile_seconds",
            "Node-event reconcile latency", reg,
        )
        self._m_reconciles = Counter(
            "tpu_dra_reconciles_total",
            "Node-event reconciles by outcome", reg,
        )
        self._m_published_pools = Gauge(
            "tpu_dra_published_ici_pools",
            "ICI channel pools currently published as ResourceSlices", reg,
        )
        self._m_domain_nodes = Gauge(
            "tpu_dra_ici_domain_nodes",
            "Nodes currently labeled into any ICI slice domain", reg,
        )
        # Controller-side utilization accounting: the node plugins see
        # chips; only the controller can see the whole channel pool, so
        # ICI occupancy is measured here (refresh_channel_occupancy)
        # rather than summed from nodes.
        self._m_channels_published = Gauge(
            "tpu_dra_usage_ici_channels_published",
            "ICI channels currently offered across all published pools",
            reg,
        )
        self._m_channels_allocated = Gauge(
            "tpu_dra_usage_ici_channels_allocated",
            "ICI channels currently held by allocated ResourceClaims",
            reg,
        )
        self.offsets = OffsetAllocator()
        # DomainKey -> set of node names carrying the label
        self._domains: dict[DomainKey, set[str]] = {}
        # node name -> its current DomainKey (for relabel/delete handling)
        self._node_domain: dict[str, DomainKey] = {}
        self._lock = threading.Lock()
        self._watch: Optional[Watch] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._recover_offsets()
        self.slice_controller.start()
        # Seed domains from a synchronous node list BEFORE settling, so
        # recovered offsets are only dropped for domains that are truly gone
        # — never because watch events were slow to arrive.
        try:
            seed = self.client.list(NODES, label_selector=SLICE_LABEL)
        except Exception:
            logger.exception("initial node list failed; watch will recover")
            seed = []
        with self._lock:
            for node in seed:
                labels = (node["metadata"].get("labels")) or {}
                slice_id = labels.get(SLICE_LABEL, "")
                if slice_id:
                    self._add_node(
                        node["metadata"]["name"],
                        DomainKey(slice_id, labels.get(CLIQUE_LABEL, "")),
                    )
            self._settle_recovery_locked()
        self._watch = self.client.watch(NODES, label_selector=SLICE_LABEL)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ici-slice-manager"
        )
        self._thread.start()

    def _settle_recovery_locked(self) -> None:
        """Drop recovered offsets whose domain no longer has nodes, and
        publish the now-authoritative pool set (prunes stale pools of
        domains that vanished while the controller was down)."""
        live = set(self._domains)
        for key in [k for k in self.offsets._offsets if k not in live]:
            logger.info(
                "dropping recovered offset for vanished domain %s",
                key.pool_name,
            )
            self.offsets.remove(key)
        self._publish_locked()

    def _recover_offsets(self) -> None:
        """Re-seed the offset allocator from slices published by a previous
        controller incarnation, so a restart never renumbers a domain's
        channels while claims referencing the old device names are live
        (the durability imex.go gets implicitly from deleting+rebuilding
        all slices under a single long-lived process)."""
        try:
            existing = self.slice_controller._list_driver_slices()
        except Exception:
            logger.exception("offset recovery list failed; starting fresh")
            return
        for sl in existing:
            devices = sl.get("spec", {}).get("devices", [])
            if not devices:
                continue
            attrs0 = devices[0].get("basic", {}).get("attributes", {})
            slice_id = attrs0.get("sliceId", {}).get("string", "")
            first_channel = attrs0.get("channel", {}).get("int")
            if not slice_id or first_channel is None:
                continue
            clique = ""
            sel = (sl["spec"].get("nodeSelector") or {}).get(
                "nodeSelectorTerms", []
            )
            for term in sel:
                for expr in term.get("matchExpressions", []):
                    if expr.get("key") == CLIQUE_LABEL and expr.get("values"):
                        clique = expr["values"][0]
            key = DomainKey(slice_id, clique)
            offset = (first_channel // CHANNELS_PER_POOL) * CHANNELS_PER_POOL
            self.offsets.restore(key, offset)
            logger.info(
                "recovered ICI domain %s at offset %d", key.pool_name, offset
            )

    def stop(self, cleanup: bool = True) -> None:
        """Stop + optionally delete all our slices
        (cleanupResourceSlices analog, imex.go:308-326)."""
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # The reconcile thread may have re-established a fresh watch after
        # the stop above raced it; close whatever is current too.
        if self._watch is not None:
            self._watch.stop()
        self.slice_controller.stop(delete_slices=cleanup)

    # -- node event stream (streamImexDomains analog, imex.go:217-305) -----

    def _run(self) -> None:
        """Consume node events forever, RE-ESTABLISHING the watch when the
        stream dies without ``stop()``.

        The stream ending is normal life, not shutdown: API servers close
        watches on timeouts, network partitions sever them, a fake client's
        test harness stops them. The old behavior — return, leaving
        readiness red until a pod restart — is exactly the wedge this
        subsystem exists to avoid. Recovery is a jittered-backoff loop:
        fresh node LIST to resync membership (events missed during the gap
        included REMOVALS, so the list must be reconciled as truth, not
        merged), then a new watch.
        """
        assert self._watch is not None
        backoff = Backoff(initial=0.2, cap=30.0, jitter=True)
        try:
            while not self._stop.is_set():
                for ev in self._watch.events():
                    if self._stop.is_set():
                        return
                    self._reconcile_event(ev)
                delay = backoff.next_delay()
                if self._stop.is_set():
                    return
                self._m_reconciles.inc(outcome="watch-restart")
                logger.warning(
                    "node watch stream ended unexpectedly; re-establishing "
                    "in %.1fs", delay,
                )
                if self._stop.wait(delay):
                    return
                try:
                    self._reestablish_watch()
                    # Success = the apiserver is answering again; the next
                    # stream death (server-side timeouts are routine) must
                    # not inherit an escalated membership-blind delay.
                    backoff.reset()
                except Exception:
                    logger.exception(
                        "node watch re-establishment failed; will retry"
                    )
        finally:
            # stop() may have timed out its join while this thread was
            # blocked re-establishing and then installed a fresh watch;
            # whoever finishes last closes the current one.
            if self._stop.is_set() and self._watch is not None:
                self._watch.stop()

    def _reconcile_event(self, ev) -> None:
        node_name = (ev.object.get("metadata") or {}).get("name", "")
        span = self.tracer.span(
            "reconcile", tags={"event": ev.type, "node": node_name}
        )
        try:
            with span:
                self._handle(ev.type, ev.object)
            self._m_reconciles.inc(outcome="ok")
        except Exception as e:
            self._m_reconciles.inc(outcome="error")
            logger.exception("error handling node event")
            if self.events is not None and node_name:
                # kubectl describe node must show why this node's
                # domain membership failed to reconcile.
                self.events.warning(
                    ObjectRef.node(
                        node_name,
                        (ev.object.get("metadata") or {}).get("uid", ""),
                    ),
                    "ReconcileFailed",
                    f"ICI slice reconcile for node event {ev.type} "
                    f"failed: {e}",
                )
        self._m_reconcile_seconds.observe(span.duration)

    def _reestablish_watch(self) -> None:
        """Fresh seed list + new watch stream after an unexpected stream
        death. The NEW watch opens BEFORE the seed list: a node deleted
        in the window between the two is then either absent from the
        list (pruned by the stale sweep) or present in it with its
        DELETED event buffered on the already-open watch — no ordering
        lets a missed removal leak a stale channel pool. The list is
        reconciled as the authoritative membership: vanished nodes
        removed (their domains pruned), changed labels re-homed;
        duplicate events from the overlap are idempotent in _handle."""
        new_watch = self.client.watch(NODES, label_selector=SLICE_LABEL)
        try:
            seed = self.client.list(NODES, label_selector=SLICE_LABEL)
            seen = {n["metadata"]["name"] for n in seed}
            for node in seed:
                self._handle("MODIFIED", node)
            with self._lock:
                stale = [n for n in self._node_domain if n not in seen]
            for name in stale:
                self._handle("DELETED", {"metadata": {"name": name}})
        except BaseException:
            # ANY failure before installation (list, or a seed-replay
            # reconcile raising) must close the fresh watch, or each
            # failed retry leaks a live producer thread.
            new_watch.stop()
            raise
        old = self._watch
        self._watch = new_watch
        if old is not None:
            old.stop()
        logger.info("node watch re-established (%d labeled nodes)", len(seed))

    def _handle(self, ev_type: str, node: dict) -> None:
        name = node["metadata"]["name"]
        labels = (node["metadata"].get("labels")) or {}
        slice_id = labels.get(SLICE_LABEL, "")
        with self._lock:
            changed = False
            old_key = self._node_domain.get(name)
            if ev_type == "DELETED" or not slice_id:
                if old_key is not None:
                    changed |= self._remove_node(name, old_key)
            else:
                new_key = DomainKey(slice_id, labels.get(CLIQUE_LABEL, ""))
                if old_key is not None and old_key != new_key:
                    changed |= self._remove_node(name, old_key)
                changed |= self._add_node(name, new_key)
            # Republish only on membership change — node heartbeats arrive
            # as MODIFIED events continuously and must not trigger reconciles.
            if changed:
                self._publish_locked()

    def _add_node(self, name: str, key: DomainKey) -> bool:
        if self._node_domain.get(name) == key:
            return False
        if key not in self._domains:
            # Allocate BEFORE inserting the domain: on capacity exhaustion
            # nothing is left half-registered (an offset-less domain would
            # wedge every subsequent publish).
            try:
                offset = self.offsets.add(key)
            except RuntimeError:
                logger.error(
                    "cannot admit ICI domain %s: all %d channels are "
                    "assigned (%d domains × %d channels/pool)",
                    key.pool_name, CHANNELS_PER_DRIVER,
                    CHANNELS_PER_DRIVER // CHANNELS_PER_POOL,
                    CHANNELS_PER_POOL,
                )
                return False
            logger.info(
                "ICI domain %s appeared (offset %d)", key.pool_name, offset
            )
        self._node_domain[name] = key
        self._domains.setdefault(key, set()).add(name)
        return True

    def _remove_node(self, name: str, key: DomainKey) -> bool:
        self._node_domain.pop(name, None)
        members = self._domains.get(key)
        if members is None:
            return False
        members.discard(name)
        if not members:
            del self._domains[key]
            self.offsets.remove(key)
            logger.info("ICI domain %s vanished", key.pool_name)
        return True

    # -- pool generation (generateImexChannelPool analog, imex.go:381-422) --

    def _channel_pool(self, key: DomainKey) -> Pool:
        offset = self.offsets.get(key)
        assert offset is not None
        devices = []
        for i in range(offset, offset + CHANNELS_PER_POOL):
            info = IciChannelInfo(channel=i, slice_id=key.slice_id)
            devices.append(info.get_device())
        match_exprs = [
            {"key": SLICE_LABEL, "operator": "In", "values": [key.slice_id]}
        ]
        if key.clique_id:
            match_exprs.append(
                {"key": CLIQUE_LABEL, "operator": "In",
                 "values": [key.clique_id]}
            )
        return Pool(
            devices=devices,
            node_selector={
                "nodeSelectorTerms": [{"matchExpressions": match_exprs}]
            },
        )

    def _publish_locked(self) -> None:
        pools = {}
        for key in self._domains:
            if self.offsets.get(key) is None:
                continue  # not admitted (capacity exhausted)
            pools[key.pool_name] = self._channel_pool(key)
        self._m_published_pools.set(len(pools))
        self._m_domain_nodes.set(len(self._node_domain))
        self._m_channels_published.set(len(pools) * CHANNELS_PER_POOL)
        self.slice_controller.update(DriverResources(pools=pools))

    # -- channel occupancy (controller-side utilization accounting) --------

    def refresh_channel_occupancy(self) -> Optional[int]:
        """Count ICI channels held by allocated claims and update the
        occupancy gauge; returns the count, or None when the claim list
        failed (apiserver dark — keep the last good value rather than
        reporting a phantom zero). This is a full cluster-wide claims
        LIST: the controller main loop calls it on a ~60s cadence, well
        below the 10s status tick, and nothing else should call it in a
        tight loop."""
        api = self.slice_controller.api
        try:
            claims = self.client.list(api.claims)
        except Exception:
            logger.debug("channel occupancy refresh skipped (list failed)")
            return None
        allocated = 0
        for claim in claims:
            results = (
                ((claim.get("status") or {}).get("allocation") or {})
                .get("devices", {}).get("results")
            ) or []
            for r in results:
                if (r.get("driver") == self.driver_name
                        and is_ici_channel_device_name(
                            r.get("device", ""))):
                    allocated += 1
        self._m_channels_allocated.set(allocated)
        return allocated

    # -- introspection -----------------------------------------------------

    def domains(self) -> dict[DomainKey, set[str]]:
        with self._lock:
            return {k: set(v) for k, v in self._domains.items()}

    def healthy(self):
        """Readiness input for /readyz: the reconcile thread must be
        consuming a live node watch."""
        if self._thread is None or not self._thread.is_alive():
            return False, "reconcile thread not running"
        if self._watch is None or self._watch.stopped:
            return False, "node watch stopped"
        return True, "reconciling node events"
