"""The fleet serving gateway: route, admit, tick, scale, narrate.

`ServingGateway` fronts N DecodeEngine replicas (models/serving.py) with
the cluster-level request path the node layer cannot provide alone:

- requests enter through SLO-aware admission (admission.py: priority
  queues, watermark shedding, queue deadlines — typed
  :class:`OverloadedError`, never silent queueing),
- dispatch routes prefix-affinity-first with a least-loaded fallback
  (router.py), so the single-engine prefix cache becomes a fleet
  property: same-system-prompt traffic keeps landing where its KV is
  already warm,
- a per-tick autoscaler (autoscaler.py) closes the loop from fleet
  backlog to replica count through a pluggable provisioner (a batch
  allocator in a cluster sim),
- drain/failover is loss-classified: a DRAINING replica finishes its
  admitted requests and hands its queued ones back for re-routing (zero
  admitted loss); a GONE replica's in-flight requests surface as typed
  retryable :class:`ReplicaLostError`, never as silence.

Everything observable lands in three places: ``tpu_dra_gw_*`` metric
families, a 256-deep ring buffer served at ``/debug/gateway``
(``MetricsServer.set_gateway_provider``, same GET-only contract as
usage/defrag/rebalance), and deduped ``Gateway*`` Events. Chaos sites
``gateway.route`` / ``gateway.drain`` / ``gateway.scale`` make the
three state transitions injectable (utils/faults.py).

Per-request observability is opt-in via ``telemetry=`` (a
``serving_gateway/reqtrace.ServingTelemetry``): every submit then opens
a root span on the contextvars tracer (its trace id is returned on the
handle — and on the typed shed error — so callers, JSON log lines, and
engine events all correlate), a timeline follows the request through
class queue, routing, engine admission, prefill, decode, and its
terminal outcome, tick wall time decomposes into named phases, and
per-class SLO histograms/violations/exemplars accumulate for
``fleet_slo_summary()``. ``telemetry=None`` (the default) keeps every
hot path on its pre-observability branch.

The tick loop is host-side and single-threaded by design, like the
engine's: ``tick()`` advances admission, dispatch, every replica's
engine, and the autoscaler exactly once, so tests and benches replay
deterministically.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import time
from typing import Callable, Optional

from ..api.v1alpha1.slo import BATCH_CLASS, LATENCY_CLASSES
from ..kube.events import EventRecorder, ObjectRef
from ..utils import faults
from ..utils.metrics import Counter, Gauge, Registry
# Imported as a module: reqtrace's OUTCOME_* terminal-outcome names
# would shadow the autoscaler's OUTCOME_* decision names below.
from . import reqtrace
from .admission import (
    SHED_DEADLINE,
    SHED_REASONS,
    AdmissionController,
    AdmissionPolicy,
    OverloadedError,
)
from .autoscaler import (
    DIRECTION_UP,
    DIRECTIONS,
    OUTCOME_APPLIED,
    OUTCOME_FAILED,
    OUTCOMES,
    Autoscaler,
    ScaleError,
)
from .residency import ResidencyIndex
from .router import (
    POLICIES,
    REPLICA_DRAINING,
    REPLICA_GONE,
    REPLICA_HEALTHY,
    NoReplicaAvailableError,
    Replica,
    Router,
)

logger = logging.getLogger(__name__)

# Gateway-request lifecycle.
GW_QUEUED = "queued"
GW_DISPATCHED = "dispatched"
GW_FINISHED = "finished"
GW_FAILED = "failed"

RING_DEPTH = 256

# tpu_dra_gw_replicas only renders REGISTERED states: a GONE replica is
# deregistered from the router in the same call that marks it (its
# departure is observable in the ring records and Gateway* Events, and
# REPLICA_GONE stays readable on the returned handle).
_GAUGE_STATES = (REPLICA_HEALTHY, REPLICA_DRAINING)


class ReplicaLostError(RuntimeError):
    """The replica serving this request went away before finishing it.
    Retryable by contract: the prompt is intact on the handle and a
    resubmit re-routes it (usually onto a still-warm prefix)."""

    retryable = True

    def __init__(self, replica_id: str, reason: str = ""):
        self.replica_id = replica_id
        super().__init__(
            f"replica {replica_id} lost mid-flight"
            + (f": {reason}" if reason else "")
        )


@dataclasses.dataclass
class GatewayRequest:
    """One fleet request and its gateway-side state. ``tokens`` only
    means anything once ``state == "finished"``; a failed request
    carries its typed error in ``error``."""

    gid: int
    prompt: list[int]
    max_new_tokens: int
    latency_class: str
    submitted_at: float
    state: str = GW_QUEUED
    replica_id: str = ""
    engine_req: Optional[object] = None
    error: Optional[BaseException] = None
    dispatches: int = 0
    finished_at: Optional[float] = None
    # Filled only when the gateway runs with telemetry: the root span's
    # trace id (joins gateway and engine spans/log lines) and the
    # request's reqtrace timeline.
    trace_id: str = ""
    timeline: Optional[object] = None

    @property
    def done(self) -> bool:
        return self.state in (GW_FINISHED, GW_FAILED)

    @property
    def tokens(self) -> list[int]:
        return list(self.engine_req.tokens) if self.engine_req else []


class ServingGateway:
    """See module docstring. ``registry`` may be shared with the rest
    of the process, but metric families register once — construct ONE
    gateway per registry (a second raises the registry's duplicate-name
    error). ``autoscaler`` is optional; without it the replica set only
    changes through add_replica/drain_replica/fail_replica."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        *,
        router: Optional[Router] = None,
        admission_policy: Optional[AdmissionPolicy] = None,
        autoscaler: Optional[Autoscaler] = None,
        events: Optional[EventRecorder] = None,
        node_name: str = "",
        node_uid: str = "",
        clock: Callable[[], float] = time.monotonic,
        telemetry: Optional["reqtrace.ServingTelemetry"] = None,
    ):
        self.router = router or Router()
        self.admission = AdmissionController(admission_policy)
        self.autoscaler = autoscaler
        self.events = events
        self.telemetry = telemetry
        self.node_name = node_name
        self.node_uid = node_uid
        self._clock = clock
        self._gid = 0
        self.ticks = 0
        self._live: dict[int, GatewayRequest] = {}
        # replica_id -> {id(engine_req): GatewayRequest} for every
        # dispatched-but-unfinished request.
        self._dispatched: dict[str, dict[int, GatewayRequest]] = {}
        self._ring: collections.deque = collections.deque(maxlen=RING_DEPTH)
        self.counters = collections.Counter()

        registry = registry or Registry()
        self._m_routed = Counter(
            "tpu_dra_gw_routed_total",
            "Requests dispatched to a replica, by routing policy "
            "(affinity, p2c, round-robin)",
            registry,
        )
        self._m_affinity_lookups = Counter(
            "tpu_dra_gw_affinity_lookups_total",
            "Dispatches that computed a prefix-affinity key (the prompt "
            "had at least one full KV block)",
            registry,
        )
        self._m_affinity_hits = Counter(
            "tpu_dra_gw_affinity_hits_total",
            "Affinity dispatches whose target replica had served the "
            "same prefix key before (its KV cache is warm)",
            registry,
        )
        self._m_queue_depth = Gauge(
            "tpu_dra_gw_queue_depth",
            "Requests waiting in the gateway's admission queues, by "
            "latency class",
            registry,
        )
        self._m_shed = Counter(
            "tpu_dra_gw_shed_total",
            "Requests rejected with a typed Overloaded error, by "
            "latency class and reason (watermark, deadline)",
            registry,
        )
        self._m_replicas = Gauge(
            "tpu_dra_gw_replicas",
            "Registered replicas by state (healthy, draining); a lost "
            "or removed replica deregisters",
            registry,
        )
        self._m_scale = Counter(
            "tpu_dra_gw_scale_decisions_total",
            "Autoscaler decisions by direction and outcome (applied, "
            "failed, cooldown, dwell, clamped)",
            registry,
        )
        self._m_requests = Counter(
            "tpu_dra_gw_requests_total",
            "Gateway requests finished, by outcome (completed, failed)",
            registry,
        )
        self._m_affinity_ledger = Gauge(
            "tpu_dra_gw_affinity_ledger_keys",
            "Prefix keys in the router's per-replica affinity ledger "
            "(seen_keys), by replica; the series is removed when the "
            "replica deregisters",
            registry,
        )
        # Explicit zeros: dashboards must see every family (and the
        # label enums) before the first shed/scale ever happens.
        for policy in POLICIES:
            self._m_routed.inc(0.0, policy=policy)
        for lc in sorted(LATENCY_CLASSES):
            self._m_queue_depth.set(0, latency_class=lc)
            for reason in SHED_REASONS:
                self._m_shed.inc(0.0, latency_class=lc, reason=reason)
        for d in DIRECTIONS:
            for o in OUTCOMES:
                self._m_scale.inc(0.0, direction=d, outcome=o)
        for state in _GAUGE_STATES:
            self._m_replicas.set(0, state=state)
        for outcome in ("completed", "failed"):
            self._m_requests.inc(0.0, outcome=outcome)
        # Fleet-wide measured KV residency (residency.py): joins every
        # replica's engine-published digest against the affinity ledger
        # above. Shares this registry — its tpu_dra_residency_* gauges
        # refresh at scrape, and the /debug/residency provider is
        # self.residency.snapshot.
        self.residency = ResidencyIndex(self.router, registry=registry)
        registry.add_render_hook(self._sync_ledger_gauge)

    def _sync_ledger_gauge(self) -> None:
        # Scrape-time sync: ledger size changes on every dispatch, so a
        # render hook beats touching the gauge on the serving path.
        for r in self.router.replicas():
            self._m_affinity_ledger.set(
                len(r.seen_keys), replica=r.replica_id
            )

    def _forget_replica_series(self, replica: Replica) -> None:
        # Honest ledger bounds on deregistration (drain(remove=True) /
        # fail): drop the ledger itself — the Replica handle outlives
        # the router entry and must not pin thousands of keys — and
        # remove, not zero, its per-replica gauge series (the departed-
        # claim series pattern; a dead replica scraping as a live 0
        # forever is unbounded cardinality over churn).
        replica.seen_keys.clear()
        self._m_affinity_ledger.remove(replica=replica.replica_id)
        self.residency.forget_replica(replica.replica_id)

    # -- replica lifecycle -------------------------------------------------

    def add_replica(self, engine, replica_id: Optional[str] = None,
                    claim_uid: str = "") -> Replica:
        if replica_id is None:
            replica_id = f"replica-{len(self.router.replicas())}"
        replica = Replica(replica_id, engine, claim_uid=claim_uid)
        self.router.add(replica)
        self._dispatched.setdefault(replica_id, {})
        self._attach_profiler(replica)
        self._refresh_replica_gauge()
        return replica

    def _attach_profiler(self, replica: Replica) -> None:
        # Engine ticks share ONE TickProfiler (component="engine"); the
        # replica id travels as the ring entry's free-form tag, never a
        # metric label (replica ids are unbounded cardinality).
        if self.telemetry is None:
            return
        if hasattr(replica.engine, "set_profiler"):
            replica.engine.set_profiler(
                self.telemetry.profiler, tag=replica.replica_id
            )

    def replicas(self) -> list[Replica]:
        return self.router.replicas()

    def _refresh_replica_gauge(self) -> None:
        by_state = collections.Counter(
            r.state for r in self.router.replicas()
        )
        for state in _GAUGE_STATES:
            self._m_replicas.set(by_state.get(state, 0), state=state)

    # -- submission --------------------------------------------------------

    def fleet_queue_depth(self) -> int:
        """Gateway queues + every registered replica's backlog — the
        admission watermark and autoscaler signal. (GONE replicas never
        appear here: they deregister in the call that marks them.)"""
        return self.admission.depth() + sum(
            r.queue_depth() for r in self.router.replicas()
        )

    def submit(self, prompt, max_new_tokens: int,
               latency_class: str = BATCH_CLASS) -> GatewayRequest:
        """Admit a request into the fleet (or shed it, typed). The
        handle's tokens fill in as some replica serves it. With
        telemetry, the handle (and a shed's OverloadedError) carries
        ``trace_id`` so callers can join gateway and engine records."""
        now = self._clock()
        tel = self.telemetry
        span = None
        tl = None
        with contextlib.ExitStack() as stack:
            if tel is not None:
                span = stack.enter_context(tel.tracer.span(
                    "gateway/submit", latency_class=latency_class,
                ))
                tl = tel.new_timeline(
                    latency_class, now, trace_id=span.trace_id,
                    prompt_tokens=len(prompt),
                )
            try:
                self.admission.check(
                    latency_class, self.fleet_queue_depth()
                )
            except OverloadedError as e:
                if tel is not None:
                    span.set_error(f"shed: {e.reason}")
                    e.trace_id = span.trace_id
                    logger.warning(
                        "shed a %s request (%s) at fleet queue depth %d",
                        latency_class, e.reason, e.queue_depth,
                    )
                    tel.finish_timeline(
                        tl, reqtrace.OUTCOME_SHED, now,
                        reason=e.reason, queueDepth=e.queue_depth,
                    )
                self._shed(latency_class, e, now)
                raise
            req = GatewayRequest(
                gid=self._gid, prompt=[int(t) for t in prompt],
                max_new_tokens=max_new_tokens,
                latency_class=latency_class, submitted_at=now,
            )
            if tel is not None:
                req.trace_id = span.trace_id
                req.timeline = tl
                tl.gid = req.gid
                span.set_tag("gid", req.gid)
            self._gid += 1
            self._live[req.gid] = req
            self.admission.enqueue(req)
            return req

    def _shed(self, latency_class: str, err: OverloadedError,
              now: float) -> None:
        self.counters["shed"] += 1
        self._m_shed.inc(latency_class=latency_class, reason=err.reason)
        self._record({
            "kind": "shed", "latencyClass": latency_class,
            "reason": err.reason, "queueDepth": err.queue_depth,
        }, now)
        if self.events is not None:
            self.events.warning(
                self._node_ref(), "GatewayOverloaded",
                f"shed a {latency_class} request ({err.reason}) at fleet "
                f"queue depth {err.queue_depth} on {self.node_name}",
            )

    # -- the tick ----------------------------------------------------------

    def tick(self) -> None:
        """One gateway scheduling round: expire deadlines, dispatch in
        class-priority order while capacity exists, advance every
        replica engine one tick, harvest completions, then let the
        autoscaler look at the result. With telemetry the round runs
        inside a ``gateway/tick`` span (engine/scale log lines inherit
        its trace id) and decomposes into the GATEWAY_PHASES buckets of
        ``tpu_dra_srv_tick_phase_seconds``."""
        tel = self.telemetry
        if tel is None:
            self._tick_once(None)
            return
        with tel.tracer.span("gateway/tick", tick=self.ticks + 1):
            self._tick_once(tel.profiler)
        tel.profiler.end_tick("gateway", self.ticks)

    def _tick_once(self, prof) -> None:
        now = self._clock()
        self.ticks += 1
        with reqtrace.phase_ctx(prof, "gateway", "expire"):
            for req in self.admission.expire(now):
                err = OverloadedError(
                    "queued past its class deadline",
                    latency_class=req.latency_class,
                    reason=SHED_DEADLINE,
                    retry_after_s=self.admission.policy.retry_after_s,
                    queue_depth=self.fleet_queue_depth(),
                )
                self._fail(req, err, now)
                self._shed(req.latency_class, err, now)
        with reqtrace.phase_ctx(prof, "gateway", "dispatch"):
            self._dispatch(now)
        with reqtrace.phase_ctx(prof, "gateway", "replicas"):
            for replica in self.router.replicas():
                if replica.engine.idle:
                    continue
                replica.engine.tick()
        with reqtrace.phase_ctx(prof, "gateway", "harvest"):
            for replica in self.router.replicas():
                self._harvest(replica, now)
        with reqtrace.phase_ctx(prof, "gateway", "autoscale"):
            if self.autoscaler is not None:
                self._autoscale(now)
        for lc, depth in self.admission.depth_by_class().items():
            self._m_queue_depth.set(depth, latency_class=lc)

    def run(self, max_ticks: int = 100000) -> None:
        """Drive ticks until every submitted request has finished or
        failed."""
        for _ in range(max_ticks):
            if not self._live:
                return
            self.tick()
        raise RuntimeError(
            f"gateway not drained after {max_ticks} ticks "
            f"({len(self._live)} live requests)"
        )

    def _dispatch(self, now: float) -> None:
        while self.router.has_capacity():
            req = self.admission.pop(now)
            if req is None:
                return
            try:
                faults.fire("gateway.route")
                decision = self.router.route(req.prompt)
            except NoReplicaAvailableError:
                self.admission.push_back(req)
                return
            except faults.CrashPoint:
                # A simulated hard crash must not half-dispatch: the
                # request stays queued for the restarted gateway.
                self.admission.push_back(req)
                raise
            except Exception as e:
                # An injected routing fault: the request stays queued
                # and retries next tick; the failure is observable.
                self.admission.push_back(req)
                self._record({"kind": "route-failed", "error": str(e)},
                             now)
                return
            try:
                engine_req = decision.replica.engine.submit(
                    req.prompt, req.max_new_tokens
                )
            except Exception as e:
                # Typed engine-side refusal (pool too small for this
                # request, admission raced closed): surface it on the
                # handle — queueing it forever would be the silent
                # failure mode this layer exists to prevent.
                self._fail(req, e, now)
                continue
            req.state = GW_DISPATCHED
            req.replica_id = decision.replica.replica_id
            req.engine_req = engine_req
            req.dispatches += 1
            self._dispatched[decision.replica.replica_id][
                id(engine_req)
            ] = req
            self.counters["routed"] += 1
            self._m_routed.inc(policy=decision.policy)
            if decision.affinity_key is not None:
                self.counters["affinity_lookups"] += 1
                self._m_affinity_lookups.inc()
                if decision.affinity_hit:
                    self.counters["affinity_hits"] += 1
                    self._m_affinity_hits.inc()
            if req.timeline is not None:
                req.timeline.event(
                    "routed", now,
                    replica=decision.replica.replica_id,
                    policy=decision.policy,
                    affinityHit=decision.affinity_hit,
                    affinityKey=decision.affinity_key is not None,
                    replicaQueueDepth=decision.queue_depth,
                    dispatch=req.dispatches,
                )
                # Hand the timeline to the engine request so engine-side
                # events (admit, prefill chunks, first token, preemption,
                # retire) land on the same record.
                engine_req.timeline = req.timeline
            if self.telemetry is not None:
                self.telemetry.note_route(
                    decision.affinity_key, decision.affinity_hit
                )

    def _harvest(self, replica: Replica, now: float) -> None:
        table = self._dispatched.get(replica.replica_id) or {}
        finished = [
            (k, greq) for k, greq in table.items()
            if greq.engine_req is not None and greq.engine_req.done
        ]
        for k, greq in finished:
            del table[k]
            greq.state = GW_FINISHED
            greq.finished_at = now
            self._live.pop(greq.gid, None)
            self.counters["completed"] += 1
            self._m_requests.inc(outcome="completed")
            if greq.timeline is not None and self.telemetry is not None:
                # observe_request feeds the per-class SLO histograms and
                # violation/exemplar ledger, then seals the timeline.
                self.telemetry.observe_request(
                    greq.timeline, now,
                    tokens=len(
                        getattr(greq.engine_req, "generated", []) or []
                    ),
                )

    def _fail(self, req: GatewayRequest, err: BaseException,
              now: float) -> None:
        req.state = GW_FAILED
        req.error = err
        req.finished_at = now
        self._live.pop(req.gid, None)
        self.counters["failed"] += 1
        self._m_requests.inc(outcome="failed")
        if req.timeline is not None and self.telemetry is not None:
            outcome = (
                reqtrace.OUTCOME_EXPIRED
                if isinstance(err, OverloadedError)
                and err.reason == SHED_DEADLINE
                else reqtrace.OUTCOME_FAILED
            )
            self.telemetry.finish_timeline(
                req.timeline, outcome, now,
                error=f"{type(err).__name__}: {err}",
            )

    # -- drain / failover --------------------------------------------------

    def _maybe_span(self, name: str, **tags):
        """A tracer span when telemetry is on, else a no-op context —
        so drain/failover log lines and engine events correlate under
        one trace id without a second code path."""
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.tracer.span(name, tags=tags)

    def drain_replica(self, replica_id: str, *, remove: bool = False,
                      reason: str = "") -> int:
        """Gracefully stop a replica: admission closes, its queued
        (never-prefilled) requests re-enter the gateway queues at the
        front, and its admitted requests run to completion — zero
        admitted-request loss. Returns the number of re-routed
        requests. ``remove=True`` deregisters it afterwards (the
        scale-down path)."""
        with self._maybe_span("gateway/drain", replica=replica_id,
                              reason=reason):
            return self._drain_replica(replica_id, remove=remove,
                                       reason=reason)

    def _drain_replica(self, replica_id: str, *, remove: bool,
                       reason: str) -> int:
        faults.fire("gateway.drain")
        now = self._clock()
        replica = self.router.get(replica_id)
        replica.state = REPLICA_DRAINING
        replica.state_reason = reason
        self._refresh_replica_gauge()
        rerouted = replica.engine.drain()
        table = self._dispatched.get(replica_id) or {}
        requeue = []
        for engine_req in rerouted:
            greq = table.pop(id(engine_req), None)
            if greq is None:
                continue
            greq.state = GW_QUEUED
            greq.replica_id = ""
            greq.engine_req = None
            if greq.timeline is not None:
                greq.timeline.event(
                    "requeued", now, replica=replica_id, reason="drain",
                )
            requeue.append(greq)
        # requeue_front is an appendleft: push in REVERSE so the oldest
        # re-routed request ends up at the head — arrival order within
        # the class is preserved, as the admission contract promises.
        for greq in reversed(requeue):
            self.admission.requeue_front(greq)
        n_rerouted = len(requeue)
        logger.info(
            "draining replica %s%s: %d queued request(s) re-routed",
            replica_id, f" ({reason})" if reason else "", n_rerouted,
        )
        # Everything admitted finished inside drain(): harvest them.
        self._harvest(replica, now)
        leftovers = list((self._dispatched.get(replica_id) or {}).values())
        for greq in leftovers:
            # Should be empty by construction; surfacing (not silently
            # dropping) any straggler keeps the zero-loss claim honest.
            self._fail(greq, ReplicaLostError(replica_id, "drain race"),
                       now)
        if remove:
            replica.state = REPLICA_GONE
            self.router.remove(replica_id)
            self._dispatched.pop(replica_id, None)
            self._forget_replica_series(replica)
        else:
            self._dispatched[replica_id] = {}
        self._refresh_replica_gauge()
        self._record({
            "kind": "drain", "replicaId": replica_id, "reason": reason,
            "rerouted": n_rerouted, "lost": len(leftovers),
            "removed": remove,
        }, now)
        if self.events is not None:
            self.events.normal(
                self._node_ref(), "GatewayReplicaDrained",
                f"replica {replica_id} drained on {self.node_name}"
                + (f" ({reason})" if reason else "")
                + f": {n_rerouted} queued request(s) re-routed, "
                  "admitted requests completed",
            )
        return n_rerouted

    def drain_claim(self, claim_uid: str, *, reason: str = "") -> list[str]:
        """Defrag executor drain contract: drain every live replica
        bound to ``claim_uid`` (each through the zero-loss
        :meth:`drain_replica` path) and return their ids so the caller
        can resume them once the claim's devices have moved. A claim
        with no serving replicas returns ``[]`` — draining is then a
        no-op, not an error (the claim may be a training gang)."""
        drained = []
        for r in self.router.replicas():
            if r.claim_uid != claim_uid or r.state == REPLICA_GONE:
                continue
            if r.state != REPLICA_DRAINING:
                self.drain_replica(r.replica_id, reason=reason)
            drained.append(r.replica_id)
        return drained

    def resume_replica(self, replica_id: str) -> None:
        """Reopen a drained replica for dispatch (the defrag executor's
        post-migration counterpart of :meth:`drain_replica`, and the
        rollback path's undo). Only DRAINING replicas transition; GONE
        ones stay gone."""
        now = self._clock()
        replica = self.router.get(replica_id)
        if replica.state != REPLICA_DRAINING:
            return
        replica.state = REPLICA_HEALTHY
        replica.state_reason = ""
        # drain() closed engine-level admission; a resumed replica must
        # accept dispatches again or it sits healthy-but-deaf.
        if hasattr(replica.engine, "resume_admission"):
            replica.engine.resume_admission()
        self._refresh_replica_gauge()
        self._record({"kind": "resume", "replicaId": replica_id}, now)

    def resume_claim(self, claim_uid: str) -> list[str]:
        """Resume every DRAINING replica bound to ``claim_uid``; returns
        the resumed ids. Idempotent — the executor calls it after a
        migration lands AND during rollback/recovery, where any subset
        of the claim's replicas may have been drained."""
        resumed = []
        for r in self.router.replicas():
            if r.claim_uid != claim_uid or r.state != REPLICA_DRAINING:
                continue
            self.resume_replica(r.replica_id)
            resumed.append(r.replica_id)
        return resumed

    def fail_replica(self, replica_id: str, reason: str = "") -> int:
        """Hard failover: the replica is gone (chip unplugged, pod
        killed). Its queued requests re-route — they held no computed
        state — and its in-flight ones fail with a typed, retryable
        :class:`ReplicaLostError`. Returns the number of lost in-flight
        requests."""
        with self._maybe_span("gateway/failover", replica=replica_id,
                              reason=reason):
            return self._fail_replica(replica_id, reason)

    def _fail_replica(self, replica_id: str, reason: str) -> int:
        now = self._clock()
        replica = self.router.get(replica_id)
        replica.state = REPLICA_GONE
        replica.state_reason = reason
        table = self._dispatched.get(replica_id) or {}
        waiting_ids = {id(r) for r in replica.engine.waiting}
        requeue = []
        lost = []
        for k, greq in list(table.items()):
            del table[k]
            if k in waiting_ids:
                greq.state = GW_QUEUED
                greq.replica_id = ""
                greq.engine_req = None
                if greq.timeline is not None:
                    greq.timeline.event(
                        "requeued", now, replica=replica_id,
                        reason="replica-lost",
                    )
                requeue.append(greq)
            else:
                lost.append(greq)
                self._fail(
                    greq, ReplicaLostError(replica_id, reason), now
                )
        # Reversed for the same arrival-order reason as drain_replica.
        for greq in reversed(requeue):
            self.admission.requeue_front(greq)
        n_rerouted = len(requeue)
        logger.warning(
            "replica %s lost%s: %d queued re-routed, %d in-flight "
            "failed retryable",
            replica_id, f" ({reason})" if reason else "",
            n_rerouted, len(lost),
        )
        self.router.remove(replica_id)
        self._dispatched.pop(replica_id, None)
        self._forget_replica_series(replica)
        self._refresh_replica_gauge()
        self._record({
            "kind": "replica-lost", "replicaId": replica_id,
            "reason": reason, "rerouted": n_rerouted, "lost": len(lost),
        }, now)
        if self.events is not None:
            self.events.warning(
                self._node_ref(), "GatewayReplicaLost",
                f"replica {replica_id} lost on {self.node_name}"
                + (f" ({reason})" if reason else "")
                + f": {n_rerouted} queued re-routed, {len(lost)} "
                  "in-flight surfaced as retryable errors",
            )
        return len(lost)

    def resubmit(self, req: GatewayRequest) -> GatewayRequest:
        """Retry a failed request (the ReplicaLostError contract): a
        fresh handle through normal admission, same prompt and class."""
        return self.submit(req.prompt, req.max_new_tokens,
                           latency_class=req.latency_class)

    # -- autoscaling -------------------------------------------------------

    def _fleet_ttft_p99_ms(self) -> float:
        # Only computed when the TTFT signal is armed: the percentile
        # sorts ServingStats' unbounded sample lists, so running it per
        # tick for a disabled signal would make a long-lived gateway's
        # loop progressively slower for nothing.
        vals = []
        for r in self.router.replicas():
            if r.state != REPLICA_HEALTHY:
                continue
            stats = getattr(r.engine, "stats", None)
            if stats is not None and hasattr(stats, "p99_ttft_ms"):
                vals.append(stats.p99_ttft_ms())
            else:
                vals.append(r.engine.snapshot().get("ttftP99Ms", 0.0))
        return max(vals) if vals else 0.0

    def _autoscale(self, now: float) -> None:
        # The replica count the policy bands (and min/max clamps) apply
        # to is the HEALTHY set — a draining replica is already leaving
        # and must neither count as capacity nor shield the last
        # healthy replica from the scale-down clamp (the victim pool
        # below is healthy-only too, so clamp and victim agree).
        healthy = [r for r in self.router.replicas()
                   if r.state == REPLICA_HEALTHY]
        ttft = (
            self._fleet_ttft_p99_ms()
            if self.autoscaler.policy.ttft_p99_target_ms > 0 else 0.0
        )
        decision = self.autoscaler.evaluate(
            n_replicas=len(healthy),
            fleet_queue_depth=self.fleet_queue_depth(),
            ttft_p99_ms=ttft,
            now=now,
        )
        if decision is None:
            return
        if decision["outcome"] is None:
            decision = self._apply_scale(decision, now)
        self.counters[f"scale_{decision['outcome']}"] += 1
        self._m_scale.inc(direction=decision["direction"],
                          outcome=decision["outcome"])
        self._record({"kind": "scale", **decision}, now)

    def _apply_scale(self, decision: dict, now: float) -> dict:
        direction = decision["direction"]
        try:
            faults.fire("gateway.scale")
            if direction == DIRECTION_UP:
                replica = self.autoscaler.provisioner.scale_up()
                self.router.add(replica)
                self._dispatched.setdefault(replica.replica_id, {})
                self._attach_profiler(replica)
                decision = {**decision, "outcome": OUTCOME_APPLIED,
                            "replicaId": replica.replica_id}
                if self.events is not None:
                    self.events.normal(
                        self._node_ref(), "GatewayScaleUp",
                        f"scaled up to {len(self.router.replicas())} "
                        f"replica(s) on {self.node_name}: "
                        f"{decision['reason']}",
                    )
            else:
                healthy = [r for r in self.router.replicas()
                           if r.state == REPLICA_HEALTHY]
                if not healthy:
                    raise ScaleError(
                        "no healthy replica to scale down"
                    )
                victim = min(healthy, key=lambda r: r.queue_depth())
                self.drain_replica(victim.replica_id, remove=True,
                                   reason="scale-down")
                self.autoscaler.provisioner.scale_down(victim)
                decision = {**decision, "outcome": OUTCOME_APPLIED,
                            "replicaId": victim.replica_id}
                if self.events is not None:
                    self.events.normal(
                        self._node_ref(), "GatewayScaleDown",
                        f"scaled down to {len(self.router.replicas())} "
                        f"replica(s) on {self.node_name}: "
                        f"{decision['reason']}",
                    )
        except faults.CrashPoint:
            raise
        except Exception as e:
            decision = {**decision, "outcome": OUTCOME_FAILED,
                        "detail": f"{type(e).__name__}: {e}"}
            logger.warning("gateway scale %s failed: %s", direction, e)
        if decision.get("outcome") == OUTCOME_APPLIED:
            # Inside the tick span when telemetry is on: the log line
            # carries the tick's trace id.
            logger.info(
                "gateway scale %s applied (replica %s): %s",
                direction, decision.get("replicaId", ""),
                decision.get("reason", ""),
            )
        self._refresh_replica_gauge()
        self.autoscaler.note_scaled(now)
        return decision

    # -- observability -----------------------------------------------------

    def _node_ref(self) -> ObjectRef:
        return ObjectRef.node(self.node_name, self.node_uid)

    def _record(self, doc: dict, now: float) -> None:
        self._ring.append({"ts": round(now, 6), "tick": self.ticks,
                           **doc})

    def affinity_hit_rate(self) -> float:
        return (self.counters["affinity_hits"]
                / max(self.counters["affinity_lookups"], 1))

    def fleet_slo_summary(self) -> Optional[dict]:
        """The soak-harness SLO artifact (reqtrace's pinned-key JSON
        document), or None when the gateway runs without telemetry."""
        if self.telemetry is None:
            return None
        return self.telemetry.fleet_slo_summary()

    def snapshot(self) -> dict:
        """The /debug/gateway document: replicas, queues, counters,
        policy knobs, and the recent event ring."""
        now = self._clock()
        depth = self.fleet_queue_depth()
        doc = {
            "node": self.node_name,
            "generatedAt": round(now, 6),
            "ticks": self.ticks,
            "policy": {
                "router": {
                    "policy": self.router.policy,
                    "blockSize": self.router.block_size,
                    "affinityBlocks": self.router.affinity_blocks,
                    "saturationDepth": self.router.saturation_depth,
                },
                "admission": self.admission.policy.to_dict(),
                **(
                    {"autoscaler": self.autoscaler.policy.to_dict()}
                    if self.autoscaler is not None else {}
                ),
            },
            "replicas": {
                r.replica_id: r.snapshot()
                for r in self.router.replicas()
            },
            "queues": self.admission.depth_by_class(),
            "fleetQueueDepth": depth,
            "overloaded": depth >= self.admission.policy.shed_watermark,
            "counters": {
                "routed": self.counters["routed"],
                "completed": self.counters["completed"],
                "failed": self.counters["failed"],
                "shed": self.counters["shed"],
                "affinityLookups": self.counters["affinity_lookups"],
                "affinityHits": self.counters["affinity_hits"],
                "affinityHitRate": round(self.affinity_hit_rate(), 4),
            },
            "events": list(self._ring),
        }
        return doc
