"""Kubernetes Event emission: best-effort, async, deduped, count-aggregated.

Role of client-go's EventBroadcaster/EventAggregator (the reference driver
emits no Events at all — a prepare failure is invisible to ``kubectl
describe``). This recorder makes claim-lifecycle failures show up where
operators actually look: Events on the ResourceClaim (plugin side) and on
the Node (controller reconcile errors).

Semantics, mirroring the client-go correlator:

- **Async delivery**: ``normal()``/``warning()`` only enqueue; a single
  daemon worker does the API I/O. The claim hot path (which runs under
  the driver's global claim lock) never blocks on the API server — an
  overloaded apiserver retrying 429s must not serialize every other
  claim's Prepare behind an Event write.
- **Dedup + aggregation**: repeats with the same (object, type, reason)
  become one Event with ``count`` incremented, ``lastTimestamp`` advanced,
  and the message refreshed — NOT keyed on the message text, because
  callers embed raw exception strings and any variability there would
  defeat dedup and flood etcd with near-duplicate objects.
- **Best-effort**: a full queue or an API error drops the Event (logged at
  debug, counted in ``tpu_dra_events_emit_failures_total``) and never
  surfaces to the caller.
- **Deterministic names**: the Event name derives from a digest of the
  dedup key, so a restarted plugin aggregates onto the Event its previous
  incarnation created instead of duplicating it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import threading
import time
from typing import Optional

from ..utils.metrics import Counter, Registry
from .client import EVENTS, KubeClient
from .errors import AlreadyExistsError, ConflictError, NotFoundError

logger = logging.getLogger(__name__)

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"


@dataclasses.dataclass(frozen=True)
class ObjectRef:
    """The involved object an Event attaches to."""

    kind: str
    name: str
    namespace: str = ""
    uid: str = ""
    api_version: str = "v1"

    @classmethod
    def claim(cls, name: str, namespace: str, uid: str = "",
              api_version: str = "resource.k8s.io/v1beta1") -> "ObjectRef":
        """``api_version`` should be the dialect the driver discovered
        (``ResourceApi.api_version``) so involvedObject resolves on every
        cluster generation; the default matches 1.32 clusters."""
        return cls(
            kind="ResourceClaim",
            name=name,
            namespace=namespace,
            uid=uid,
            api_version=api_version,
        )

    @classmethod
    def node(cls, name: str, uid: str = "") -> "ObjectRef":
        return cls(kind="Node", name=name, uid=uid)


def _iso_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class EventRecorder:
    """Emit v1 Events through a KubeClient; ``client=None`` is a no-op
    recorder (kube-less dev mode keeps the same call sites)."""

    # Bounded delivery queue: past this, emits drop (counted) rather than
    # block the caller or grow without bound during an apiserver outage.
    QUEUE_SIZE = 256
    # Bounded dedup cache: key -> event name. Past this, oldest entries
    # fall out and a repeat re-aggregates via the AlreadyExists path.
    MAX_CACHE = 512

    def __init__(
        self,
        client: Optional[KubeClient],
        component: str,
        namespace: str = "default",
        registry: Optional[Registry] = None,
    ):
        self.client = client
        self.component = component
        self.namespace = namespace
        self._queue: "queue.Queue[tuple]" = queue.Queue(maxsize=self.QUEUE_SIZE)
        self._worker: Optional[threading.Thread] = None
        self._worker_lock = threading.Lock()
        self._seen: dict[str, str] = {}  # dedup key -> event name (worker-only)
        reg = registry or Registry()
        self._m_emitted = Counter(
            "tpu_dra_events_emitted_total",
            "Kubernetes Events written (aggregated repeats count once here "
            "per API write)",
            reg,
        )
        self._m_failures = Counter(
            "tpu_dra_events_emit_failures_total",
            "Kubernetes Events dropped (queue full or API write failed; "
            "best-effort)",
            reg,
        )

    # -- public API --------------------------------------------------------

    def normal(self, ref: ObjectRef, reason: str, message: str) -> None:
        self._enqueue(EVENT_TYPE_NORMAL, ref, reason, message)

    def warning(self, ref: ObjectRef, reason: str, message: str) -> None:
        self._enqueue(EVENT_TYPE_WARNING, ref, reason, message)

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every enqueued Event has been delivered (or dropped).
        Test/shutdown seam; returns False on timeout."""
        deadline = time.monotonic() + timeout
        while self._queue.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True

    # -- enqueue side (caller threads; must never block) -------------------

    def _enqueue(self, type_: str, ref: ObjectRef, reason: str,
                 message: str) -> None:
        if self.client is None:
            return
        self._ensure_worker()
        try:
            self._queue.put_nowait((type_, ref, reason, message))
        except queue.Full:
            self._m_failures.inc()
            logger.debug(
                "event queue full; dropping %s/%s on %s/%s",
                type_, reason, ref.kind, ref.name,
            )

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        with self._worker_lock:
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(
                target=self._run, daemon=True, name="event-recorder"
            )
            self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                self._deliver(*item)
            except Exception as e:
                type_, ref, reason, _ = item
                self._m_failures.inc()
                logger.debug(
                    "event %s/%s on %s/%s dropped: %s",
                    type_, reason, ref.kind, ref.name, e,
                )
            finally:
                self._queue.task_done()

    # -- delivery side (worker thread only) --------------------------------

    def _key(self, type_: str, ref: ObjectRef, reason: str) -> str:
        """Aggregation key: (object, type, reason) — deliberately NOT the
        message, which embeds variable exception text (client-go's
        aggregator likewise collapses differing messages)."""
        ident = "/".join((
            type_, ref.kind, ref.namespace, ref.name, ref.uid, reason,
        ))
        return hashlib.sha256(ident.encode()).hexdigest()[:16]

    def _deliver(self, type_: str, ref: ObjectRef, reason: str,
                 message: str) -> None:
        key = self._key(type_, ref, reason)
        # Deterministic, collision-resistant, ≤253 chars (DNS subdomain).
        name = f"{ref.name[:230].lower().rstrip('.-') or 'event'}.{key}"
        namespace = ref.namespace or self.namespace
        if key in self._seen:
            try:
                self._aggregate(name, namespace, message)
            except NotFoundError:
                # Evicted server-side (Events are TTL'd): recreate.
                self.client.create(
                    EVENTS,
                    self._new_event(name, namespace, type_, ref,
                                    reason, message),
                    namespace=namespace,
                )
        else:
            try:
                self.client.create(
                    EVENTS,
                    self._new_event(name, namespace, type_, ref,
                                    reason, message),
                    namespace=namespace,
                )
            except AlreadyExistsError:
                # A previous incarnation (or a cache eviction) already
                # created it: aggregate onto the existing Event.
                self._aggregate(name, namespace, message)
        self._m_emitted.inc(type=type_)
        self._seen[key] = name
        while len(self._seen) > self.MAX_CACHE:
            self._seen.pop(next(iter(self._seen)))

    def _new_event(self, name: str, namespace: str, type_: str,
                   ref: ObjectRef, reason: str, message: str) -> dict:
        now = _iso_now()
        return {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": namespace},
            "involvedObject": {
                "apiVersion": ref.api_version,
                "kind": ref.kind,
                "name": ref.name,
                "namespace": ref.namespace,
                "uid": ref.uid,
            },
            "reason": reason,
            "message": message,
            "type": type_,
            "count": 1,
            "firstTimestamp": now,
            "lastTimestamp": now,
            "source": {"component": self.component},
            "reportingComponent": self.component,
        }

    def _aggregate(self, name: str, namespace: str, message: str) -> None:
        """count+1 / lastTimestamp / latest message on the existing Event;
        one conflict retry (another replica may be aggregating too)."""
        for attempt in (0, 1):
            ev = self.client.get(EVENTS, name, namespace=namespace)
            ev["count"] = int(ev.get("count", 1)) + 1
            ev["lastTimestamp"] = _iso_now()
            ev["message"] = message
            try:
                self.client.update(EVENTS, ev, namespace=namespace)
                return
            except ConflictError:
                if attempt:
                    raise
