"""Minimal typed Kubernetes client: the interface and its in-memory fake.

The two pieces the serving gateway's Event recorder (``kube/events.py``)
needs, dict-native (k8s wire shape):

- ``KubeClient``     — get/list/create/update/delete/watch on any resource
- ``FakeKubeClient`` — in-memory store with resourceVersions and watch
  streams, the hermetic seam the recorder's tests write through

Objects are plain dicts; callers address resources with a ``GVR``
(group/version + plural), e.g. ``GVR("v1", "events", namespaced=True)``.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import itertools
import logging
import queue
import re
import threading
from typing import Callable, Iterator, Optional

from ..utils import faults
from .errors import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class GVR:
    """GroupVersionResource: addresses a resource collection.

    ``api_version`` is "v1" for core or "group/version" otherwise;
    ``resource`` is the lowercase plural ("resourceslices").
    """

    api_version: str
    resource: str
    namespaced: bool = False

    @property
    def path_prefix(self) -> str:
        if "/" in self.api_version:
            return f"/apis/{self.api_version}"
        return f"/api/{self.api_version}"


# The resources this driver touches.
RESOURCE_SLICES = GVR("resource.k8s.io/v1alpha3", "resourceslices")
RESOURCE_CLAIMS = GVR("resource.k8s.io/v1alpha3", "resourceclaims", namespaced=True)
DEVICE_CLASSES = GVR("resource.k8s.io/v1alpha3", "deviceclasses")
NODES = GVR("v1", "nodes")
PODS = GVR("v1", "pods", namespaced=True)
EVENTS = GVR("v1", "events", namespaced=True)


def parse_label_selector(selector: str | None) -> dict[str, str]:
    """Parse "k=v,k2=v2" equality selectors (the only form we emit).

    Unsupported operators (!=, in, notin) raise rather than being silently
    mangled into their inverse — real API servers would honour them, and a
    fake that inverts their meaning is worse than one that refuses.
    """
    if not selector:
        return {}
    out = {}
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part or re.search(r"\b(in|notin)\b", part):
            raise ValueError(
                f"unsupported label selector operator in {part!r}; "
                "only equality and existence are implemented"
            )
        if "=" in part:
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip().lstrip("=")
        else:
            out[part] = None  # existence check
    return out


def matches_labels(obj: dict, selector: str | None) -> bool:
    wanted = parse_label_selector(selector)
    if not wanted:
        return True
    labels = (obj.get("metadata") or {}).get("labels") or {}
    for k, v in wanted.items():
        if k not in labels:
            return False
        if v is not None and labels[k] != v:
            return False
    return True


@dataclasses.dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED | ERROR
    object: dict


class Watch:
    """A cancellable stream of WatchEvents."""

    def __init__(self):
        self._q: "queue.Queue[Optional[WatchEvent]]" = queue.Queue()
        self._stopped = threading.Event()
        # Optional teardown hook (e.g. closing a streaming HTTP response
        # so a blocked reader thread unblocks immediately).
        self._on_stop: Optional[Callable[[], None]] = None

    def stop(self) -> None:
        if not self._stopped.is_set():
            self._stopped.set()
            self._q.put(None)
            if self._on_stop is not None:
                try:
                    self._on_stop()
                except Exception:
                    pass

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def _emit(self, ev: WatchEvent) -> None:
        if not self._stopped.is_set():
            self._q.put(ev)

    def events(self, timeout: Optional[float] = None) -> Iterator[WatchEvent]:
        """Yield events until stopped; with a timeout, returns when idle."""
        while not self._stopped.is_set():
            try:
                ev = self._q.get(timeout=timeout)
            except queue.Empty:
                return
            if ev is None:
                return
            yield ev


class KubeClient(abc.ABC):
    """The API-server seam (role of client-go clientsets)."""

    @abc.abstractmethod
    def get(self, gvr: GVR, name: str, namespace: str = "") -> dict: ...

    @abc.abstractmethod
    def list(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[dict]: ...

    @abc.abstractmethod
    def create(self, gvr: GVR, obj: dict, namespace: str = "") -> dict: ...

    @abc.abstractmethod
    def update(self, gvr: GVR, obj: dict, namespace: str = "") -> dict: ...

    @abc.abstractmethod
    def delete(self, gvr: GVR, name: str, namespace: str = "") -> None: ...

    @abc.abstractmethod
    def watch(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> Watch: ...

    # -- conveniences shared by impls --------------------------------------

    def list_meta(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[tuple[str, str]]:
        """(name, resourceVersion) pairs for a collection — the cheap
        change-detection probe behind the allocator's incremental
        inventory index: comparing signatures per solve must not pay for
        deep-copying 10k device specs. Default: derived from ``list()``
        (full cost); ``FakeKubeClient`` overrides with a copy-free scan."""
        out = []
        for obj in self.list(gvr, namespace, label_selector):
            md = obj.get("metadata") or {}
            out.append((md.get("name", ""), md.get("resourceVersion", "")))
        return out

    def api_group_versions(self, group: str) -> list[str]:
        """Versions the server serves for an API group, preferred first
        (k8s group discovery, GET ``/apis/<group>``). Empty when the group
        is not served. Default: unknown — callers fall back to their
        pinned default version."""
        return []

    def close(self) -> None:
        """Release client resources (stop watches, join poll threads).

        Default no-op: the fake client's watches are push-driven and own no
        threads. ``RealKubeClient`` overrides this.
        """

    def apply(self, gvr: GVR, obj: dict, namespace: str = "") -> dict:
        """Create-or-update by name (server-side-apply-lite)."""
        name = obj["metadata"]["name"]
        try:
            existing = self.get(gvr, name, namespace)
        except NotFoundError:
            return self.create(gvr, obj, namespace)
        merged = copy.deepcopy(obj)
        merged["metadata"]["resourceVersion"] = existing["metadata"].get(
            "resourceVersion", ""
        )
        return self.update(gvr, merged, namespace)


# ---------------------------------------------------------------------------
# Fake
# ---------------------------------------------------------------------------


class FakeKubeClient(KubeClient):
    """In-memory API server with resourceVersion + watch semantics."""

    def __init__(self):
        self._lock = threading.RLock()
        # (gvr.resource, namespace, name) -> object
        self._store: dict[tuple[str, str, str], dict] = {}
        self._rv = itertools.count(1)
        # (gvr.resource) -> list of (namespace-filter, selector, Watch)
        self._watches: list[tuple[str, str, Optional[str], Watch]] = []
        # Optional fault injection: callable(verb, gvr, name) -> Exception|None
        self.fault_injector: Optional[Callable[[str, GVR, str], Optional[Exception]]] = None
        # group -> served versions (preferred first). Tests shrink this to
        # impersonate one cluster generation: a 1.31 server is
        # {"resource.k8s.io": ["v1alpha3"]}, a 1.32+ one ["v1beta1"].
        # Requests addressed to an unserved group version 404, as the real
        # API server's would.
        self.served_api_versions: dict[str, list[str]] = {
            "resource.k8s.io": ["v1beta1", "v1alpha3"],
        }

    # -- helpers -----------------------------------------------------------

    def _key(self, gvr: GVR, namespace: str, name: str):
        return (gvr.resource, namespace if gvr.namespaced else "", name)

    def _maybe_fault(self, verb: str, gvr: GVR, name: str):
        # Chaos seam: the global fault registry fires before the per-client
        # injector, so env-armed schedules reach the fake API server too.
        faults.fire(f"kube.{verb}")
        if "/" in gvr.api_version:
            group, _, version = gvr.api_version.partition("/")
            served = self.served_api_versions.get(group)
            if served is not None and version not in served:
                raise NotFoundError(
                    f"the server could not find the requested resource "
                    f"({gvr.api_version} {gvr.resource}; served: {served})"
                )
        if self.fault_injector is not None:
            err = self.fault_injector(verb, gvr, name)
            if err is not None:
                raise err

    def _notify(self, gvr: GVR, ev_type: str, obj: dict):
        ns = (obj.get("metadata") or {}).get("namespace", "")
        for res, wns, selector, w in list(self._watches):
            if res != gvr.resource or w.stopped:
                continue
            if gvr.namespaced and wns and wns != ns:
                continue
            if not matches_labels(obj, selector):
                continue
            w._emit(WatchEvent(ev_type, copy.deepcopy(obj)))

    # -- KubeClient --------------------------------------------------------

    def get(self, gvr: GVR, name: str, namespace: str = "") -> dict:
        self._maybe_fault("get", gvr, name)
        with self._lock:
            obj = self._store.get(self._key(gvr, namespace, name))
            if obj is None:
                raise NotFoundError(f"{gvr.resource}/{name} not found")
            return copy.deepcopy(obj)

    def list(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[dict]:
        self._maybe_fault("list", gvr, "")
        with self._lock:
            out = []
            for (res, ns, _), obj in sorted(self._store.items()):
                if res != gvr.resource:
                    continue
                if gvr.namespaced and namespace and ns != namespace:
                    continue
                if not matches_labels(obj, label_selector):
                    continue
                out.append(copy.deepcopy(obj))
            return out

    def create(self, gvr: GVR, obj: dict, namespace: str = "") -> dict:
        name = obj["metadata"]["name"]
        self._maybe_fault("create", gvr, name)
        with self._lock:
            key = self._key(gvr, namespace or obj["metadata"].get("namespace", ""), name)
            if key in self._store:
                raise AlreadyExistsError(f"{gvr.resource}/{name} already exists")
            stored = copy.deepcopy(obj)
            md = stored.setdefault("metadata", {})
            md["resourceVersion"] = str(next(self._rv))
            md.setdefault("uid", f"uid-{md['resourceVersion']}")
            if gvr.namespaced:
                md.setdefault("namespace", namespace)
            self._store[key] = stored
            self._notify(gvr, "ADDED", stored)
            return copy.deepcopy(stored)

    def update(self, gvr: GVR, obj: dict, namespace: str = "") -> dict:
        name = obj["metadata"]["name"]
        self._maybe_fault("update", gvr, name)
        with self._lock:
            key = self._key(gvr, namespace or obj["metadata"].get("namespace", ""), name)
            existing = self._store.get(key)
            if existing is None:
                raise NotFoundError(f"{gvr.resource}/{name} not found")
            rv = obj["metadata"].get("resourceVersion", "")
            if rv and rv != existing["metadata"]["resourceVersion"]:
                raise ConflictError(
                    f"{gvr.resource}/{name}: resourceVersion {rv} != "
                    f"{existing['metadata']['resourceVersion']}"
                )
            stored = copy.deepcopy(obj)
            stored["metadata"]["resourceVersion"] = str(next(self._rv))
            stored["metadata"].setdefault("uid", existing["metadata"].get("uid"))
            self._store[key] = stored
            self._notify(gvr, "MODIFIED", stored)
            return copy.deepcopy(stored)

    def delete(self, gvr: GVR, name: str, namespace: str = "") -> None:
        self._maybe_fault("delete", gvr, name)
        with self._lock:
            key = self._key(gvr, namespace, name)
            obj = self._store.pop(key, None)
            if obj is None:
                raise NotFoundError(f"{gvr.resource}/{name} not found")
            self._notify(gvr, "DELETED", obj)

    def list_meta(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> list[tuple[str, str]]:
        # Same filters and fault site as list(), but no deep copies: the
        # point of the probe is to be cheap at 10k-device inventories.
        self._maybe_fault("list", gvr, "")
        with self._lock:
            out = []
            for (res, ns, _), obj in sorted(self._store.items()):
                if res != gvr.resource:
                    continue
                if gvr.namespaced and namespace and ns != namespace:
                    continue
                if not matches_labels(obj, label_selector):
                    continue
                md = obj.get("metadata") or {}
                out.append((md.get("name", ""), md.get("resourceVersion", "")))
            return out

    def watch(
        self,
        gvr: GVR,
        namespace: str = "",
        label_selector: str | None = None,
    ) -> Watch:
        self._maybe_fault("watch", gvr, "")
        w = Watch()
        with self._lock:
            # Seed with current state (informer-style list+watch).
            for obj in self.list(gvr, namespace, label_selector):
                w._emit(WatchEvent("ADDED", obj))
            self._watches.append((gvr.resource, namespace, label_selector, w))
        return w

    def api_group_versions(self, group: str) -> list[str]:
        return list(self.served_api_versions.get(group, []))
