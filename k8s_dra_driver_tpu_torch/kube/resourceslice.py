"""ResourceSlice publishing controller.

Re-implementation of the vendored resourceslice controller the reference
relies on (lengrongfu/k8s-dra-driver,
vendor/k8s.io/dynamic-resource-allocation/resourceslice/
resourceslicecontroller.go:55-472): a reconciler that keeps the cluster's
``ResourceSlice`` objects in sync with a driver-provided ``DriverResources``
snapshot. Supports node-local pools (owner = the node, spec.nodeName set)
and network pools (spec.nodeSelector set — how ICI channels are published
per slice-domain, mirroring IMEX's network resources).

Differences from upstream: deterministic slice names (``<pool>-<driver>-<i>``)
instead of GenerateName, so reconcile is a pure name-keyed diff; and a
plain worker thread + event trigger instead of an informer/workqueue stack.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

from ..utils.backoff import Backoff
from .client import GVR, KubeClient
from .errors import AlreadyExistsError, ConflictError, NotFoundError
from .resourceapi import ResourceApi

logger = logging.getLogger(__name__)

# Canonical (in-memory) stamp; the served dialect is negotiated per
# controller via ResourceApi and applied at the wire boundary.
API_VERSION = "resource.k8s.io/v1beta1"

# Devices per ResourceSlice (the reference publishes IMEX channels 128 per
# slice, imex.go:43; upstream's limit is 128 devices/slice).
MAX_DEVICES_PER_SLICE = 128

# Label marking which publisher instance owns a slice. Multiple publishers
# (one per node plugin + the cluster controller) share one driver name; each
# must only prune its own slices.
OWNER_LABEL = "tpu.google.com/owned-by"


@dataclasses.dataclass
class Pool:
    """One pool of devices (DriverResources.Pools entry analog). The pool
    generation is managed by the controller (bumped on content change), not
    supplied by callers."""

    devices: list[dict]
    shared_counters: list[dict] = dataclasses.field(default_factory=list)
    node_name: str = ""                       # node-local pools
    node_selector: Optional[dict] = None      # network pools


@dataclasses.dataclass
class DriverResources:
    """Desired state handed to the controller (draplugin.go:376-420 analog)."""

    pools: dict[str, Pool] = dataclasses.field(default_factory=dict)


class ResourceSliceController:
    """Syncs DriverResources → ResourceSlice objects."""

    def __init__(
        self,
        client: KubeClient,
        driver_name: str,
        scope: str,
        owner: Optional[dict] = None,
        resync_seconds: float = 600.0,
        gvr: Optional[GVR] = None,
        api: Optional[ResourceApi] = None,
    ):
        """``scope`` identifies THIS publisher (node name for node plugins,
        e.g. "controller" for the cluster controller); create/update/delete
        only ever touches slices labeled with it. ``api`` selects the served
        resource.k8s.io dialect (default: discover it from the client —
        never silently pin: a pinned v1alpha3 404s on a 1.32+ server);
        ``gvr`` overrides the collection address for tests."""
        self.client = client
        self.driver_name = driver_name
        self.scope = scope
        self.owner = owner  # ownerReference dict (node or pod), optional
        self.resync_seconds = resync_seconds
        self.api = api or ResourceApi.discover(client)
        self.gvr = gvr or self.api.slices
        self._gvr_pinned = gvr is not None  # test override: never re-target
        self._desired = DriverResources()
        self._lock = threading.Lock()
        self._sync_lock = threading.Lock()  # one reconcile pass at a time
        self._trigger = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sync_errors = 0  # observability counter
        self._last_sync_error = ""  # "" = last pass succeeded
        self.last_success_monotonic = 0.0  # of the last successful pass

    # -- public API --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="resourceslice-controller"
        )
        self._thread.start()

    def stop(self, delete_slices: bool = False) -> None:
        """Stop reconciling; optionally remove everything we published
        (cleanupResourceSlices analog, imex.go:308-326)."""
        self._stop.set()
        self._trigger.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if delete_slices:
            for sl in self._list_driver_slices():
                self._delete(sl["metadata"]["name"])

    def update(self, resources: DriverResources) -> None:
        """Replace desired state and nudge the reconciler
        (DRAPlugin.PublishResources analog, draplugin.go:376-420)."""
        with self._lock:
            self._desired = resources
        self._trigger.set()

    def sync_once(self) -> None:
        """One reconcile pass (exposed for tests and for callers that want
        synchronous publication before serving). Serialized against the
        background reconciler.

        A NotFoundError from the verbs may mean the served dialect changed
        out from under us (startup discovery fell back during an apiserver
        outage, or the control plane was upgraded in place): re-discover,
        and when the answer differs, re-target and retry the pass — the
        pod must not need a restart to recover."""
        import time as _time

        with self._sync_lock:
            with self._lock:
                desired = self._desired
            try:
                self._sync(desired)
            except NotFoundError:
                if not self._rediscover():
                    raise
                self._sync(desired)
            self._last_sync_error = ""
            self.last_success_monotonic = _time.monotonic()

    def _rediscover(self) -> bool:
        """Re-run version discovery; returns True when the dialect moved
        (and the controller now targets the new one)."""
        if self._gvr_pinned:
            return False
        new = ResourceApi.try_discover(self.client)
        if new is None or new.version == self.api.version:
            return False
        logger.warning(
            "resource.k8s.io dialect changed %s -> %s; re-targeting "
            "slice publication", self.api.version, new.version,
        )
        self.api = new
        self.gvr = new.slices
        return True

    # -- reconcile loop ----------------------------------------------------

    def _run(self) -> None:
        # Jittered exponential retry: during an apiserver blackout every
        # plugin's publisher queues republishes behind this — full jitter
        # keeps a node-pool's worth of them from stampeding the recovering
        # server in lockstep.
        backoff = Backoff(
            initial=0.5, cap=min(60.0, self.resync_seconds), jitter=True
        )
        while not self._stop.is_set():
            self._trigger.wait(timeout=self.resync_seconds)
            self._trigger.clear()
            if self._stop.is_set():
                return
            try:
                self.sync_once()  # clears _last_sync_error on success
                backoff.reset()
            except Exception as e:
                self.sync_errors += 1
                self._last_sync_error = str(e)
                delay = backoff.next_delay()
                logger.exception(
                    "resourceslice sync failed; retrying in %.1fs", delay
                )
                # Transient-error retry (imex.go:143-162 analog).
                self._trigger.set()
                self._stop.wait(timeout=delay)

    def sync_health(self):
        """(ok, detail): whether the last reconcile pass against the
        apiserver succeeded — the plugin's degraded-readiness input."""
        if self._last_sync_error:
            return False, f"slice republish failing: {self._last_sync_error}"
        return True, "slices in sync"

    def _slice_name(self, pool_name: str, index: int) -> str:
        return f"{pool_name}-{self.driver_name.replace('.', '-')}-{index}"

    def _build_slices(
        self, pool_name: str, pool: Pool, generation: int
    ) -> list[dict]:
        chunks = [
            pool.devices[i : i + MAX_DEVICES_PER_SLICE]
            for i in range(0, len(pool.devices), MAX_DEVICES_PER_SLICE)
        ] or [[]]
        out = []
        for i, chunk in enumerate(chunks):
            spec: dict = {
                "driver": self.driver_name,
                "pool": {
                    "name": pool_name,
                    "generation": generation,
                    "resourceSliceCount": len(chunks),
                },
                "devices": chunk,
            }
            if pool.node_name:
                spec["nodeName"] = pool.node_name
            if pool.node_selector is not None:
                spec["nodeSelector"] = pool.node_selector
            if pool.shared_counters:
                spec["sharedCounters"] = pool.shared_counters
            md: dict = {
                "name": self._slice_name(pool_name, i),
                "labels": {OWNER_LABEL: self.scope},
            }
            if self.owner is not None:
                md["ownerReferences"] = [self.owner]
            out.append(
                {
                    "apiVersion": API_VERSION,
                    "kind": "ResourceSlice",
                    "metadata": md,
                    "spec": spec,
                }
            )
        return out

    def _list_driver_slices(self) -> list[dict]:
        """Slices published by THIS instance: same driver AND same scope
        label — never another node's or the controller's slices. Returned
        in canonical form so the reconcile diff runs in one shape."""
        return [
            self.api.slice_from_wire(s)
            for s in self.client.list(
                self.gvr, label_selector=f"{OWNER_LABEL}={self.scope}"
            )
            if s.get("spec", {}).get("driver") == self.driver_name
        ]

    @staticmethod
    def _spec_sans_generation(spec: dict) -> dict:
        clone = dict(spec)
        clone["pool"] = {
            k: v for k, v in spec.get("pool", {}).items() if k != "generation"
        }
        return clone

    def _sync(self, desired: DriverResources) -> None:
        """Name-keyed create/update/delete diff.

        Pool generation is bumped whenever the pool's content changes, so
        during a multi-slice transition (some slices updated, stale ones not
        yet deleted) schedulers can discard lower-generation slices — the
        upstream resourceslice controller's protocol.
        """
        have = {s["metadata"]["name"]: s for s in self._list_driver_slices()}
        gen_by_pool: dict[str, int] = {}
        for s in have.values():
            pool_md = s.get("spec", {}).get("pool", {})
            name = pool_md.get("name", "")
            gen_by_pool[name] = max(
                gen_by_pool.get(name, 0), pool_md.get("generation", 0)
            )

        want: dict[str, dict] = {}
        for pool_name, pool in desired.pools.items():
            current_gen = gen_by_pool.get(pool_name, 0) or 1
            trial = self._build_slices(pool_name, pool, current_gen)
            changed = False
            for sl in trial:
                existing = have.get(sl["metadata"]["name"])
                if existing is None or self._spec_sans_generation(
                    existing["spec"]
                ) != self._spec_sans_generation(sl["spec"]):
                    changed = True
                    break
            # Any stale slice of this pool beyond the trial set also counts
            # as a change (shrinking pool).
            trial_names = {sl["metadata"]["name"] for sl in trial}
            stale = [
                n for n, s in have.items()
                if s["spec"].get("pool", {}).get("name") == pool_name
                and n not in trial_names
            ]
            if stale:
                changed = True
            if changed and gen_by_pool.get(pool_name):
                trial = self._build_slices(pool_name, pool, current_gen + 1)
            for sl in trial:
                want[sl["metadata"]["name"]] = sl

        for name, sl in want.items():
            existing = have.get(name)
            if existing is None:
                try:
                    self.client.create(self.gvr, self.api.slice_to_wire(sl))
                except AlreadyExistsError:
                    # Raced a concurrent writer; converge next pass.
                    self._trigger.set()
            elif existing.get("spec") != sl["spec"]:
                merged = dict(sl)
                merged["metadata"] = dict(sl["metadata"])
                merged["metadata"]["resourceVersion"] = existing["metadata"].get(
                    "resourceVersion", ""
                )
                try:
                    self.client.update(self.gvr, self.api.slice_to_wire(merged))
                except ConflictError:
                    # Raced another writer; next pass will converge.
                    self._trigger.set()
        for name in set(have) - set(want):
            self._delete(name)

    def _delete(self, name: str) -> None:
        try:
            self.client.delete(self.gvr, name)
        except NotFoundError:
            pass
