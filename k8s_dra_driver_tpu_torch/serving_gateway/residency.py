"""Fleet-wide measured KV residency: the gateway-global index over
replica residency digests.

The router's affinity ledger (router.py ``Replica.seen_keys``) is a
*prediction*: it remembers which prefix keys were routed where, but has
no idea what each engine actually evicted since. Engines now export a
*measured* digest (models/paged.PrefixCache.residency_digest — cached
prefix runs with their affinity key chains), published through the
replica snapshot scrape. :class:`ResidencyIndex` joins the two:

- **which replica holds which prefix run** (the ``byKey`` join, capped),
- **fleet-wide measured hit rate** (summed engine hit counters — the
  number the router's affinity hit rate merely approximates),
- **cross-replica duplication ratio** (key instances / unique keys:
  how much cache capacity the fleet burns holding the same prefix in
  several places — the signal item 3's residency router will minimize),
- **evicted-but-ledgered staleness** (keys the router still believes a
  replica holds whose engine no longer does — predicted-vs-measured
  divergence, per replica),
- **counter drift** (a replica whose digest violates ``indexedBlocks ==
  insertedBlocks - evictedBlocks`` — the doctor's drift finding).

Both key schemes hash the same block-aligned token spans
(``models/paged.prefix_run_key`` == ``router.prefix_affinity_key``; a
test pins them equal), so the join is exact, not heuristic.

Everything here is pull-model: ``snapshot()`` walks the live replicas
on demand (the ``/debug/residency`` provider), and the
``tpu_dra_residency_*`` gauges refresh from a registry render hook —
nothing touches the serving path.
"""

from __future__ import annotations

from typing import Optional

from ..utils.metrics import Gauge, Registry

#: Cap on the per-key holder join exported in the snapshot (the full
#: join lives in memory only for the duration of one snapshot call).
_MAX_EXPORTED_KEYS = 32


class ResidencyIndex:
    """See module docstring. Construct once per gateway, with the
    gateway's router (the replica registry is the source of truth for
    liveness — a removed replica vanishes from the index on the next
    refresh) and optionally its metric registry."""

    def __init__(self, router, registry: Optional[Registry] = None):
        self.router = router
        self._g_hit_rate = self._g_dup = None
        self._g_unique = self._g_stale = self._g_indexed = None
        if registry is not None:
            self._g_hit_rate = Gauge(
                "tpu_dra_residency_fleet_hit_rate_ratio",
                "Measured fleet prefix-cache hit rate: summed engine "
                "hit counters over summed lookups (not the router's "
                "predicted affinity hit rate).",
                registry,
            )
            self._g_dup = Gauge(
                "tpu_dra_residency_duplication_ratio",
                "Cross-replica prefix duplication: measured key "
                "instances over unique keys (1.0 = every cached prefix "
                "lives on exactly one replica).",
                registry,
            )
            self._g_unique = Gauge(
                "tpu_dra_residency_unique_keys",
                "Distinct prefix keys measured resident anywhere in "
                "the fleet.",
                registry,
            )
            self._g_stale = Gauge(
                "tpu_dra_residency_stale_ledger_keys",
                "Affinity-ledger keys the router predicts warm on a "
                "replica whose measured digest no longer holds them "
                "(evicted-but-ledgered), by replica.",
                registry,
            )
            self._g_indexed = Gauge(
                "tpu_dra_residency_replica_indexed_blocks",
                "Blocks each replica's prefix cache measures as "
                "indexed, by replica.",
                registry,
            )
            self._g_hit_rate.set(0.0)
            self._g_dup.set(0.0)
            self._g_unique.set(0)
            registry.add_render_hook(self._sync)

    def forget_replica(self, replica_id: str) -> None:
        """Drop a deregistered replica's per-replica gauge series (the
        departed-series pattern — a gone replica must not scrape
        as a live zero forever). The snapshot join forgets it
        automatically: it only walks currently registered replicas."""
        if self._g_stale is not None:
            self._g_stale.remove(replica=replica_id)
            self._g_indexed.remove(replica=replica_id)

    def _measured_keys(self, digest: Optional[dict]) -> set:
        keys = set()
        if digest:
            for run in digest.get("runs", ()):
                keys.update(run.get("keys", ()))
        return keys

    def snapshot(self) -> dict:
        """The ``/debug/residency`` document. Walks every registered
        replica's measured digest and affinity ledger; on-demand only."""
        replicas_doc = {}
        holders: dict[str, list] = {}
        lookups = hits = hit_tokens = instances = 0
        for rep in self.router.replicas():
            rid = rep.replica_id
            kv = getattr(rep.engine, "kv_residency", None)
            digest = kv() if callable(kv) else None
            esnap = rep.engine.snapshot()
            lookups += esnap.get("prefixLookups", 0)
            hits += esnap.get("prefixHits", 0)
            hit_tokens += esnap.get("prefixHitTokens", 0)
            measured = self._measured_keys(digest)
            for k in measured:
                holders.setdefault(k, []).append(rid)
            instances += len(measured)
            predicted = set(rep.seen_keys)
            stale = len(predicted - measured)
            inserted = digest.get("insertedBlocks", 0) if digest else 0
            evicted = digest.get("evictedBlocks", 0) if digest else 0
            indexed = digest.get("indexedBlocks", 0) if digest else 0
            replicas_doc[rid] = {
                "state": rep.state,
                "indexedBlocks": indexed,
                "insertedBlocks": inserted,
                "evictedBlocks": evicted,
                "runs": (
                    len(digest.get("runs", ()))
                    + digest.get("truncatedRuns", 0)
                ) if digest else 0,
                "measuredKeys": len(measured),
                "counterDrift": (
                    digest is not None
                    and indexed != inserted - evicted
                ),
                "ledger": {
                    "predictedKeys": len(predicted),
                    "measuredAndPredicted": len(predicted & measured),
                    "staleKeys": stale,
                    "unledgeredKeys": len(measured - predicted),
                    "divergence": round(
                        stale / max(len(predicted), 1), 4
                    ),
                },
            }
        unique = len(holders)
        duplicated = sorted(
            (k for k, v in holders.items() if len(v) > 1),
        )
        doc = {
            "schema": "tpu-dra-residency-v1",
            "replicas": replicas_doc,
            "fleet": {
                "lookups": lookups,
                "hits": hits,
                "hitTokens": hit_tokens,
                "measuredHitRate": round(hits / max(lookups, 1), 4),
                "uniqueKeys": unique,
                "keyInstances": instances,
                "duplicationRatio": round(
                    instances / unique, 4
                ) if unique else 1.0,
                "duplicatedKeys": len(duplicated),
            },
            "duplicated": [
                {"key": k, "replicas": sorted(holders[k])}
                for k in duplicated[:_MAX_EXPORTED_KEYS]
            ],
            "truncatedDuplicated": max(
                0, len(duplicated) - _MAX_EXPORTED_KEYS
            ),
        }
        return doc

    def _sync(self) -> None:
        doc = self.snapshot()
        fleet = doc["fleet"]
        self._g_hit_rate.set(fleet["measuredHitRate"])
        self._g_dup.set(fleet["duplicationRatio"])
        self._g_unique.set(fleet["uniqueKeys"])
        for rid, rep in doc["replicas"].items():
            self._g_stale.set(rep["ledger"]["staleKeys"], replica=rid)
            self._g_indexed.set(rep["indexedBlocks"], replica=rid)
