"""Replica registry + two-level request router for the fleet gateway.

Routing policy (serving_gateway/gateway.py drives it):

1. **Prefix affinity first.** The affinity key is the request's leading
   *full KV blocks* of prompt tokens — the same block-granularity radix
   key scheme ``models/paged.PrefixCache`` indexes cached KV under, so
   "two prompts share an affinity key" is exactly "two prompts would hit
   the same cached prefix blocks". The key is consistent-hashed onto a
   ring of replica virtual nodes: same-system-prompt traffic lands on
   the replica whose prefix cache is already warm, and adding/removing a
   replica only remaps the keys adjacent to its ring points (no fleet-
   wide cache invalidation on a scale event).
2. **Least-loaded fallback.** When the prompt has no full block, the
   affinity target is saturated (queue depth at or past the saturation
   threshold), or affinity is disabled, the router picks the less-loaded
   of two seeded-random candidates (power-of-two-choices): near-optimal
   load spread at O(1) cost, without the thundering-herd coordination a
   global argmin would need.

A ``round-robin`` policy is kept as the A/B baseline that affinity is
compared against.

The registry tracks which affinity keys each replica has already been
routed (a bounded LRU): an affinity route whose target has seen the key
before is an **affinity hit** — the router-level analog of the engine's
prefix-cache hit rate, and the ``tpu_dra_gw_affinity_hits_total``
numerator.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional

# Replica lifecycle states (stable label values; /debug/gateway contract).
REPLICA_HEALTHY = "healthy"
REPLICA_DRAINING = "draining"
REPLICA_GONE = "gone"
REPLICA_STATES = (REPLICA_HEALTHY, REPLICA_DRAINING, REPLICA_GONE)

# Routing policy labels (the tpu_dra_gw_routed_total{policy} enum).
POLICY_AFFINITY = "affinity"
POLICY_P2C = "p2c"
POLICY_ROUND_ROBIN = "round-robin"
POLICIES = (POLICY_AFFINITY, POLICY_P2C, POLICY_ROUND_ROBIN)

_VNODES = 32          # ring points per replica
_SEEN_KEYS_MAX = 4096  # per-replica affinity-key LRU bound


class NoReplicaAvailableError(RuntimeError):
    """No healthy, admitting replica to route to. Retryable: the
    autoscaler may be mid-scale-up, or every replica is draining."""

    retryable = True


def _hash64(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big"
    )


def prefix_affinity_key(
    prompt, block_size: int, max_blocks: int
) -> Optional[str]:
    """Affinity key for a prompt: a digest of its leading full blocks
    (up to ``max_blocks``), block-aligned exactly like the PrefixCache
    radix edges. ``None`` when the prompt has no full block — nothing
    cacheable to be affine to."""
    n_blocks = min(len(prompt) // block_size, max_blocks)
    if n_blocks <= 0:
        return None
    span = prompt[: n_blocks * block_size]
    return hashlib.blake2b(
        ",".join(str(int(t)) for t in span).encode(), digest_size=8
    ).hexdigest()


class Replica:
    """One registered DecodeEngine replica: identity, the engine (or any
    object with its serving surface — see serving_gateway/sim.py), the
    backing ResourceClaim, and gateway-side health state."""

    def __init__(self, replica_id: str, engine, claim_uid: str = ""):
        self.replica_id = replica_id
        self.engine = engine
        self.claim_uid = claim_uid
        self.state = REPLICA_HEALTHY
        self.state_reason = ""
        # Affinity keys this replica has served (bounded LRU): the hit-
        # rate ledger, and what a drain hands to no one — the ring remap
        # re-warms naturally.
        self.seen_keys: "OrderedDict[str, None]" = OrderedDict()

    @property
    def accepting(self) -> bool:
        return (self.state == REPLICA_HEALTHY
                and getattr(self.engine, "admission_open", True))

    def queue_depth(self) -> int:
        """Demand signal for routing: waiting + occupied slots."""
        return len(self.engine.waiting) + self.engine.num_active

    def note_key(self, key: str) -> bool:
        """Record an affinity key routed here; True when already seen
        (an affinity hit)."""
        hit = key in self.seen_keys
        if hit:
            self.seen_keys.move_to_end(key)
        else:
            self.seen_keys[key] = None
            while len(self.seen_keys) > _SEEN_KEYS_MAX:
                self.seen_keys.popitem(last=False)
        return hit

    def snapshot(self) -> dict:
        # kvResidency is the measured prefix-residency digest (engines
        # that predate the ledger, or run with caching off, publish
        # None). Duck-typed so sim engines can participate; computed
        # here — not in engine.snapshot() — because the digest walks
        # the radix index and only the scrape path should pay for it.
        kv = getattr(self.engine, "kv_residency", None)
        return {
            "replicaId": self.replica_id,
            "claimUid": self.claim_uid,
            "state": self.state,
            "stateReason": self.state_reason,
            "queueDepth": self.queue_depth(),
            "affinityKeys": len(self.seen_keys),
            "kvResidency": kv() if callable(kv) else None,
            "engine": self.engine.snapshot(),
        }


@dataclasses.dataclass
class RouteDecision:
    replica: Replica
    policy: str                      # POLICIES member
    affinity_key: Optional[str] = None
    affinity_hit: bool = False       # key previously routed to replica
    affinity_spilled: bool = False   # key existed but target saturated
    queue_depth: int = 0             # chosen replica's depth at decision

    def __post_init__(self):
        # Snapshot the target's load at decision time: the request
        # timeline records what the router actually saw, not what the
        # replica looks like when someone reads the timeline later.
        self.queue_depth = self.replica.queue_depth()


class Router:
    """The two-level policy over a replica registry (see module
    docstring). Pure scheduling — metrics/events/fault sites live in
    the gateway, which owns the observable surface."""

    def __init__(
        self,
        *,
        policy: str = POLICY_AFFINITY,
        block_size: int = 64,
        affinity_blocks: int = 4,
        saturation_depth: Optional[int] = None,
        seed: int = 0,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r} (want one of "
                f"{POLICIES})"
            )
        import random

        self.policy = policy
        self.block_size = block_size
        self.affinity_blocks = affinity_blocks
        # Default saturation: an affinity target with more than 2x its
        # batch slots queued spills to least-loaded — cache warmth never
        # justifies unbounded queueing behind one replica.
        self.saturation_depth = saturation_depth
        self._rng = random.Random(seed)
        self._replicas: dict[str, Replica] = {}
        self._ring: list[tuple[int, str]] = []
        self._rr_next = 0

    # -- registry ----------------------------------------------------------

    def add(self, replica: Replica) -> None:
        if replica.replica_id in self._replicas:
            raise ValueError(
                f"replica {replica.replica_id!r} already registered"
            )
        self._replicas[replica.replica_id] = replica
        self._rebuild_ring()

    def remove(self, replica_id: str) -> Replica:
        replica = self._replicas.pop(replica_id)
        self._rebuild_ring()
        return replica

    def get(self, replica_id: str) -> Replica:
        return self._replicas[replica_id]

    def replicas(self) -> list[Replica]:
        return [self._replicas[k] for k in sorted(self._replicas)]

    def _rebuild_ring(self) -> None:
        self._ring = sorted(
            (_hash64(f"{rid}#{v}"), rid)
            for rid in self._replicas
            for v in range(_VNODES)
        )

    # -- routing -----------------------------------------------------------

    def has_capacity(self) -> bool:
        """True when some accepting replica is below its saturation
        depth — the gateway's dispatch gate. Holding the rest in the
        class-priority queues (instead of stuffing replica FIFOs) is
        what preserves SLO ordering under overload."""
        return any(
            r.accepting and not self._saturated(r)
            for r in self._replicas.values()
        )

    def _saturated(self, replica: Replica) -> bool:
        limit = self.saturation_depth
        if limit is None:
            limit = 2 * getattr(replica.engine, "batch_slots", 4)
        return replica.queue_depth() >= limit

    def _ring_target(self, key: str, accepting: set[str]) -> Optional[Replica]:
        """First ring point at or after hash(key) owned by an accepting
        replica — the consistent-hash successor walk."""
        if not self._ring:
            return None
        h = _hash64(key)
        # Binary search would be O(log n); the ring is small (replicas x
        # vnodes) and this runs per request on the host, so a biased
        # linear scan from the successor index keeps it simple.
        import bisect

        i = bisect.bisect_left(self._ring, (h, ""))
        for j in range(len(self._ring)):
            _, rid = self._ring[(i + j) % len(self._ring)]
            if rid in accepting:
                return self._replicas[rid]
        return None

    def route(self, prompt) -> RouteDecision:
        """Pick a replica for ``prompt`` under the configured policy.
        Raises :class:`NoReplicaAvailableError` when nothing accepts."""
        candidates = [r for r in self.replicas() if r.accepting]
        if not candidates:
            raise NoReplicaAvailableError(
                "no healthy replica is accepting admissions"
            )
        if self.policy == POLICY_ROUND_ROBIN:
            choice = candidates[self._rr_next % len(candidates)]
            self._rr_next += 1
            return RouteDecision(choice, POLICY_ROUND_ROBIN)
        key = None
        spilled = False
        if self.policy == POLICY_AFFINITY:
            key = prefix_affinity_key(
                prompt, self.block_size, self.affinity_blocks
            )
            if key is not None:
                target = self._ring_target(
                    key, {r.replica_id for r in candidates}
                )
                if target is not None and not self._saturated(target):
                    return RouteDecision(
                        target, POLICY_AFFINITY, affinity_key=key,
                        affinity_hit=target.note_key(key),
                    )
                spilled = target is not None
        # Power-of-two-choices fallback (also the whole policy when
        # affinity is off): prefer unsaturated candidates so a spilled
        # affinity key doesn't bounce straight back into the hot spot.
        pool = [r for r in candidates if not self._saturated(r)] or candidates
        if len(pool) == 1:
            choice = pool[0]
        else:
            a, b = self._rng.sample(pool, 2)
            choice = a if a.queue_depth() <= b.queue_depth() else b
        if key is not None:
            choice.note_key(key)
        return RouteDecision(
            choice, POLICY_P2C, affinity_key=key,
            affinity_spilled=spilled,
        )
