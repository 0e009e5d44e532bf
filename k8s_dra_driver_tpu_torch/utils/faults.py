"""Deterministic fault injection: named sites, seeded schedules, no-op off.

The chaos seam the driver's robustness story runs on. Production code is
instrumented with *named sites* — ``faults.fire("checkpoint.write")`` at the
top of the checkpoint writer, ``faults.fire("kube.get")`` in the fake API
server, and so on — and each site is a single attribute check while the
registry is disarmed (the default), so the hooks are free in production.

Tests (and operators reproducing a failure) arm a :class:`FaultPlan`:

    plan = FaultPlan()
    plan.fail("kube.update", ApiError("apiserver blackout", code=503),
              times=5)
    plan.crash("checkpoint.write", on_call=1)
    plan.call("cdi.claim-write", lambda: lib.unplug_chip(1))
    with faults.armed(plan):
        ...drive the system...

Rules are matched per-site on the 1-based hit count, so a schedule is fully
deterministic given the same interleaving; :meth:`FaultPlan.seeded` derives
a randomized-but-reproducible schedule from an integer seed for the long
chaos soak tests. ``arm_from_env()`` lets a flag/env arm simple plans on a
real binary (``TPU_DRA_FAULTS="checkpoint.write@2=oserror,kube.get=api503"``)
— unset, it does nothing, which is the production state.

Site naming convention: ``<component>.<operation>``. The canonical
registry of instrumented sites is :data:`ALL_SITES` (grouped by family:
``kube.*``, ``chiplib.*``, ``checkpoint.*``, ``cdi.*``, ``sharing.*``
and ``rebalance.*`` for the dynamic-sharing state/resize path, the
model-side ``train.*`` family — ``train.step`` fires at the top of every
elastic train step, ``train.reshard`` at the top of every gang resize —
``gateway.*`` for the fleet serving gateway's route/drain/scale
transitions, and ``defrag.*`` for the defrag executor's
intent-write/drain/replace/admit orchestration steps).
Seeded schedules should draw their site lists from it via
:func:`sites_in` so new families are automatically soak-covered.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import random
import threading
from typing import Callable, Optional

logger = logging.getLogger(__name__)

# Canonical registry of instrumented fault sites — the seeded-schedule
# site list. Every site name fired in production code must be listed
# here (tests/test_faults.py cross-checks the source tree), so a chaos
# soak drawing from a family prefix cannot silently miss a site.
ALL_SITES = (
    # Kubernetes API round-trips (kube/client.py).
    "kube.get",
    "kube.list",
    "kube.create",
    "kube.update",
    "kube.delete",
    "kube.watch",
    # Chip library hardware probes (tpulib/chiplib.py).
    "chiplib.enumerate",
    "chiplib.create-channel",
    # Prepared-claim checkpoint store (plugin/checkpoint.py).
    "checkpoint.read",
    "checkpoint.write",
    # CDI spec writes (cdi/spec.py).
    "cdi.base-write",
    "cdi.claim-write",
    # Durable sharing state (plugin/sharing.py): every acquire/release/
    # limits-meta rewrite funnels through the state store's put/clear.
    "sharing.state-write",
    # Dynamic-sharing rebalance path: the hitless session limits
    # re-render (plugin/sharing.py ProcessShareSession.resize) and the
    # workload shim's re-apply of a new limits generation
    # (parallel/shim.py poll_sharing_update).
    "rebalance.session-resize",
    "rebalance.shim-apply",
    # Model-side training loop (parallel/elastic.py): injectable like the
    # driver sites, so chaos schedules can unplug a chip mid-step or
    # crash mid-reshard.
    "train.step",
    "train.reshard",
    # Fleet serving gateway (serving_gateway/gateway.py): the three
    # state transitions of the cluster-level request path — dispatch
    # routing, replica drain, and autoscaler apply.
    "gateway.route",
    "gateway.drain",
    "gateway.scale",
    # Defrag execution (kube/defrag_executor.py): the orchestration
    # steps of a live migration plan — the per-plan intent checkpoint,
    # then per migration the serving drain, the blocker re-place, and
    # finally the stuck-claim admit. A crash at any of them must leave
    # state the executor's restart recovery converges (forward or back).
    "defrag.intent-write",
    "defrag.drain",
    "defrag.replace",
    "defrag.admit",
)


def sites_in(*families: str) -> list[str]:
    """Registered sites under the given family prefixes (e.g.
    ``sites_in("kube.", "train.")``) — the building block for seeded-
    schedule site lists."""
    return [s for s in ALL_SITES if s.startswith(families)]


class FaultError(RuntimeError):
    """Generic injected failure (used when a schedule needs *an* error and
    the site's callers only care that one surfaced)."""


class CrashPoint(BaseException):
    """Simulated hard crash (SIGKILL/OOM analog).

    Deliberately a ``BaseException``: rollback/except-Exception recovery
    paths must NOT observe it — a real SIGKILL runs none of them. Harness
    code catches it at the top level and rebuilds the component from its
    on-disk state, the way a restarted pod would.
    """


@dataclasses.dataclass
class FaultRule:
    """One scheduled behavior at a site.

    ``on_calls`` is a set of 1-based per-site hit indices (None = every
    hit); ``times`` bounds total firings. Exactly one of ``exc`` (an
    exception instance or zero-arg factory) or ``action`` (a callable run
    in-line at the site, e.g. "unplug chip 1 now") is set.
    """

    site: str
    exc: Optional[object] = None
    action: Optional[Callable[[], None]] = None
    on_calls: Optional[frozenset[int]] = None
    times: Optional[int] = None
    fired: int = 0

    def wants(self, hit: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        return self.on_calls is None or hit in self.on_calls

    def make_exc(self) -> Optional[BaseException]:
        if self.exc is None:
            return None
        return self.exc() if callable(self.exc) else self.exc


class FaultPlan:
    """A deterministic schedule of rules, keyed by site name."""

    def __init__(self):
        self.rules: list[FaultRule] = []

    def _add(self, rule: FaultRule) -> "FaultPlan":
        self.rules.append(rule)
        return self

    def fail(self, site: str, exc, on_calls=None,
             times: Optional[int] = None) -> "FaultPlan":
        """Raise ``exc`` at ``site`` (every hit, or the given 1-based
        call indices, at most ``times`` total)."""
        return self._add(FaultRule(
            site=site, exc=exc,
            on_calls=frozenset(on_calls) if on_calls else None, times=times,
        ))

    def crash(self, site: str, on_call: int = 1) -> "FaultPlan":
        """Simulate a hard crash at the ``on_call``-th hit of ``site``."""
        return self._add(FaultRule(
            site=site, exc=CrashPoint(f"simulated crash at {site}"),
            on_calls=frozenset({on_call}), times=1,
        ))

    def call(self, site: str, action: Callable[[], None], on_calls=None,
             times: Optional[int] = 1) -> "FaultPlan":
        """Run ``action`` when ``site`` is hit (then continue normally) —
        the hook for 'unplug the chip exactly here'."""
        return self._add(FaultRule(
            site=site, action=action,
            on_calls=frozenset(on_calls) if on_calls else None, times=times,
        ))

    @classmethod
    def seeded(cls, seed: int, sites: list[str], exc_factory=None,
               rounds: int = 8, fail_rate: float = 0.3,
               max_call: int = 6) -> "FaultPlan":
        """Reproducible random schedule over ``sites``: ``rounds`` draws,
        each failing a random site at a random upcoming call index with
        probability ``fail_rate``. Same seed → same schedule."""
        rng = random.Random(seed)
        plan = cls()
        exc_factory = exc_factory or (lambda s: FaultError(f"chaos@{s}"))
        for _ in range(rounds):
            if rng.random() >= fail_rate:
                continue
            site = rng.choice(sites)
            plan.fail(site, exc_factory(site),
                      on_calls={rng.randint(1, max_call)}, times=1)
        return plan


class FaultRegistry:
    """Process-wide arm point. Disarmed, ``fire()`` is one attr check."""

    def __init__(self):
        self.armed = False
        self._plan: Optional[FaultPlan] = None
        self._hits: dict[str, int] = {}
        self._lock = threading.Lock()

    def arm(self, plan: FaultPlan) -> None:
        with self._lock:
            self._plan = plan
            self._hits = {}
            self.armed = True

    def disarm(self) -> None:
        with self._lock:
            self.armed = False
            self._plan = None
            self._hits = {}

    def hits(self, site: str) -> int:
        """How many times ``site`` fired while armed (test observability)."""
        with self._lock:
            return self._hits.get(site, 0)

    def fire(self, site: str) -> None:
        """Hit ``site``: count it, run any matching action, raise any
        matching exception. No-op when disarmed."""
        if not self.armed:
            return
        with self._lock:
            plan = self._plan
            if plan is None:
                return
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            exc: Optional[BaseException] = None
            action: Optional[Callable[[], None]] = None
            for rule in plan.rules:
                if rule.site != site or not rule.wants(hit):
                    continue
                rule.fired += 1
                if rule.action is not None:
                    action = rule.action
                else:
                    exc = rule.make_exc()
                break
        # Outside the lock: actions/exceptions may re-enter other sites.
        if action is not None:
            logger.info("fault site %s (hit %d): running injected action",
                        site, hit)
            action()
        if exc is not None:
            logger.info("fault site %s (hit %d): raising %r", site, hit, exc)
            raise exc


REGISTRY = FaultRegistry()


def fire(site: str) -> None:
    """Module-level hook production code calls at each named site."""
    if REGISTRY.armed:
        REGISTRY.fire(site)


def arm(plan: FaultPlan) -> None:
    REGISTRY.arm(plan)


def disarm() -> None:
    REGISTRY.disarm()


@contextlib.contextmanager
def armed(plan: FaultPlan):
    """Arm for the duration of a with-block; always disarms."""
    REGISTRY.arm(plan)
    try:
        yield REGISTRY
    finally:
        REGISTRY.disarm()


# Named exception kinds arm_from_env understands. API errors are built
# lazily so importing this module never drags the kube package in.
def _env_exc(kind: str, site: str):
    kind = kind.strip().lower()
    if kind == "crash":
        return CrashPoint(f"TPU_DRA_FAULTS crash at {site}")
    if kind == "oserror":
        return OSError(f"TPU_DRA_FAULTS injected OSError at {site}")
    if kind.startswith("api"):
        from ..kube.errors import ApiError

        try:
            code = int(kind[3:] or 500)
        except ValueError:
            code = 500
        return ApiError(f"TPU_DRA_FAULTS injected {code} at {site}",
                        code=code)
    return FaultError(f"TPU_DRA_FAULTS injected fault at {site}")


def arm_from_env(env_var: str = "TPU_DRA_FAULTS") -> bool:
    """Arm a plan described by ``env_var`` (the flag/env arm point both
    binaries call at startup). Format: comma-separated ``site[@call]=kind``
    where kind ∈ {fault, oserror, crash, api<code>}. Unset/empty → no-op
    (production). Returns True when a plan was armed."""
    spec = os.environ.get(env_var, "").strip()
    if not spec:
        return False
    plan = FaultPlan()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        site_part, _, kind = part.partition("=")
        site, _, call_s = site_part.partition("@")
        on_calls = None
        if call_s:
            try:
                on_calls = {int(call_s)}
            except ValueError:
                logger.warning("TPU_DRA_FAULTS: bad call index in %r", part)
                continue
        plan.fail(site.strip(), _env_exc(kind or "fault", site.strip()),
                  on_calls=on_calls, times=1)
    if not plan.rules:
        return False
    logger.warning(
        "FAULT INJECTION ARMED from %s: %d rule(s) — this is a chaos/"
        "debug configuration, never production", env_var, len(plan.rules),
    )
    arm(plan)
    return True
