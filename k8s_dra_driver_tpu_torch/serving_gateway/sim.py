"""A dependency-free DecodeEngine stand-in for gateway sims.

The gateway only needs the engine's *serving surface* — submit / tick /
drain / snapshot and the queue-depth properties — not its jitted
programs. :class:`ScriptedEngine` implements exactly that surface with
deterministic, scriptable timing, so unit tests
(tests/test_torch_gateway.py) and chaos schedules can drive every REAL
gateway code path (routing, shedding, scaling, drain/failover, the
metrics and the ring) without building a model or touching a device.

Timing model: a request "prefills" for ``ceil((len(prompt) -
cached_tokens) / prefill_chunk)`` ticks after admission (at least one —
the real engine recomputes the trailing block copy-on-write even on a
full cache cover), then "decodes" one token per tick. ``batch_slots``
bounds concurrency; admission is FIFO like the real engine's. There is
no KV pool — ``assert_no_leaks`` checks slot accounting only — because
pool behavior is the real engine's job and is covered by the
real-engine tests and the bench.

Prefix-cache model: like the real engine's radix cache, each replica
remembers the leading FULL blocks (``block_size`` tokens each,
defaulting to ``prefill_chunk``) of every prompt it has prefilled, and
a later prompt sharing that leading run skips its cached tokens'
prefill work. Blocks are published when a request's prefill completes,
first-writer-wins per replica (a block already cached is never
re-attributed), and the cache is bounded (oldest-block eviction). The
hit counters in :meth:`snapshot` are what make prefix-affinity routing
and flash-crowd scenarios *measurable* in the deterministic fleet soak:
affinity landing same-prefix traffic on one replica shows up directly
as skipped prefill ticks there.

Observability surface parity: like the real engine, a ``SimRequest``
carrying a ``timeline`` (serving_gateway/reqtrace.py) gets
``engine-admit`` / ``prefill-chunk`` / ``first-token`` /
``engine-retire`` events, and ``set_profiler`` decomposes ticks into
phases — so the telemetry stack is exercisable (and its forced-SLO-
violation paths testable via ``decode_ticks_per_token``) without a
model.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Optional

from .router import prefix_affinity_key


class SimAdmissionClosedError(RuntimeError):
    """Mirror of ``models.serving.AdmissionClosedError`` for the sim —
    its own class so importing this module never imports the model
    layer (the gateway catches engine-submit failures generically,
    never by the model layer's type)."""


@dataclasses.dataclass
class SimRequest:
    """Mirror of models/serving.Request's handle surface."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    state: str = "waiting"
    prefill_left: int = 0
    # Leading tokens served from the replica's prefix cache at submit
    # time (full blocks only; their prefill ticks are skipped).
    cached_tokens: int = 0
    generated: list = dataclasses.field(default_factory=list)
    # Optional reqtrace timeline, attached by the gateway (mirrors
    # models/serving.Request.timeline).
    timeline: Optional[object] = None

    @property
    def done(self) -> bool:
        return self.state == "finished"

    @property
    def tokens(self) -> list[int]:
        return list(self.prompt) + list(self.generated)


class ScriptedEngine:
    """See module docstring. ``decode_ticks_per_token`` slows a replica
    down (a degraded chip); ``stall=True`` freezes it entirely (queue
    depths grow — the p2c and autoscaler tests' knob)."""

    def __init__(self, *, batch_slots: int = 4, prefill_chunk: int = 32,
                 decode_ticks_per_token: int = 1, stall: bool = False,
                 clock=time.monotonic, prefix_cache: bool = True,
                 block_size: Optional[int] = None,
                 max_cached_blocks: int = 4096):
        self.batch_slots = batch_slots
        self.prefill_chunk = prefill_chunk
        self.decode_ticks_per_token = decode_ticks_per_token
        self.stall = stall
        self._clock = clock
        # Prefix-cache model (on by default, mirroring the real engine):
        # a per-replica map of leading-full-block digests. Insertion
        # order doubles as the eviction order (oldest block first).
        # Each entry carries residency metadata (depth, the router-
        # scheme affinity key for its span, its parent chain digest,
        # last-touch stamp) so kv_residency() can publish the same
        # measured digest the real engine does.
        self.prefix_cache = prefix_cache
        self.block_size = block_size or prefill_chunk
        self.max_cached_blocks = max_cached_blocks
        self._cached_blocks: dict[bytes, dict] = {}
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self._touch = 0
        self.waiting: deque = deque()
        self.running: list[SimRequest] = []
        self._admission_open = True
        self._rid = 0
        self._tick_no = 0
        self.ticks = 0
        self.completed = 0
        self._profiler = None
        self._profile_tag = ""

    def set_profiler(self, profiler, tag: str = "") -> None:
        """Mirror of ``DecodeEngine.set_profiler`` (reqtrace
        TickProfiler duck type)."""
        self._profiler = profiler
        self._profile_tag = tag

    # -- the DecodeEngine serving surface ---------------------------------

    @property
    def admission_open(self) -> bool:
        return self._admission_open

    @property
    def num_active(self) -> int:
        return len(self.running)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

    def _block_keys(self, prompt: list[int]) -> list[bytes]:
        """Digest chain over the prompt's leading FULL blocks: key i
        commits to blocks 0..i, so a hit on key i means the whole
        leading run matches (radix-cache semantics without the trie)."""
        keys = []
        h = hashlib.blake2b(digest_size=16)
        for start in range(0, len(prompt) - len(prompt) % self.block_size,
                           self.block_size):
            block = prompt[start:start + self.block_size]
            h.update(b"|".join(str(t).encode() for t in block))
            keys.append(h.digest())
        return keys

    def submit(self, prompt, max_new_tokens: int) -> SimRequest:
        if not self._admission_open:
            raise SimAdmissionClosedError(
                "sim engine admission is closed"
            )
        prompt = [int(t) for t in prompt]
        cached = 0
        if self.prefix_cache and prompt:
            self.prefix_lookups += 1
            self._touch += 1
            for key in self._block_keys(prompt):
                meta = self._cached_blocks.get(key)
                if meta is None:
                    break
                meta["touch"] = self._touch
                cached += self.block_size
            # Like the real engine, never cover the whole prompt: the
            # trailing block is recomputed copy-on-write, so at least
            # one token always prefills.
            cached = min(cached, len(prompt) - 1)
            if cached > 0:
                self.prefix_hits += 1
                self.prefix_hit_tokens += cached
        req = SimRequest(
            rid=self._rid, prompt=prompt,
            max_new_tokens=max_new_tokens,
            prefill_left=max(
                1, -(-(len(prompt) - cached) // self.prefill_chunk)
            ) if prompt else 0,
            cached_tokens=cached,
        )
        self._rid += 1
        self.waiting.append(req)
        return req

    def stop_admission(self) -> None:
        self._admission_open = False

    def resume_admission(self) -> None:
        self._admission_open = True

    def tick(self) -> None:
        self.ticks += 1
        if self.stall:
            return
        self._tick_no += 1
        prof = self._profiler
        if prof is None:
            self._admit_tick()
            self._decode_tick()
            return
        with prof.phase("engine", "admit"):
            self._admit_tick()
        with prof.phase("engine", "decode"):
            self._decode_tick()
        prof.end_tick("engine", self.ticks, tag=self._profile_tag)

    def _admit_tick(self) -> None:
        while self.waiting and len(self.running) < self.batch_slots:
            req = self.waiting.popleft()
            req.state = "prefill"
            self.running.append(req)
            if req.timeline is not None:
                req.timeline.event(
                    "engine-admit", self._clock(),
                    slot=self.running.index(req),
                    cachedTokens=req.cached_tokens,
                    cachedBlocks=req.cached_tokens // self.block_size,
                    cow=req.cached_tokens > 0,
                    readmission=False,
                )

    def _publish_blocks(self, req: SimRequest) -> None:
        """Prefill done: publish the prompt's leading full blocks.
        First-writer-wins (an already-cached block keeps its slot and
        its age); oldest-block eviction keeps the cache bounded."""
        if not self.prefix_cache:
            return
        self._touch += 1
        prev = None
        for i, key in enumerate(self._block_keys(req.prompt)):
            if key in self._cached_blocks:
                prev = key
                continue
            self._cached_blocks[key] = {
                "depth": i + 1,
                "key": prefix_affinity_key(
                    req.prompt, self.block_size, i + 1
                ),
                "parent": prev,
                "touch": self._touch,
            }
            self.inserted_blocks += 1
            prev = key
            while len(self._cached_blocks) > self.max_cached_blocks:
                self._cached_blocks.pop(next(iter(self._cached_blocks)))
                self.evicted_blocks += 1

    def _decode_tick(self) -> None:
        for req in list(self.running):
            if req.prefill_left > 0:
                req.prefill_left -= 1
                if req.timeline is not None:
                    req.timeline.event(
                        "prefill-chunk", self._clock(), lane=0,
                        tokens=min(self.prefill_chunk, len(req.prompt)),
                        occupancy=1.0,
                        cachedTokensSkipped=req.cached_tokens,
                    )
                if req.prefill_left == 0:
                    self._publish_blocks(req)
                continue
            req.state = "running"
            if self._tick_no % self.decode_ticks_per_token == 0:
                first = not req.generated
                req.generated.append(0)
                if first and req.timeline is not None:
                    req.timeline.event("first-token", self._clock())
            if len(req.generated) >= req.max_new_tokens:
                req.state = "finished"
                self.running.remove(req)
                self.completed += 1
                if req.timeline is not None:
                    req.timeline.event(
                        "engine-retire", self._clock(),
                        tokens=len(req.generated), preemptions=0,
                        cachedTokens=req.cached_tokens,
                    )

    def drain(self) -> list[SimRequest]:
        self.stop_admission()
        rerouted = list(self.waiting)
        self.waiting.clear()
        stalled = self.stall
        self.stall = False  # a drain must still finish admitted work
        for _ in range(100000):
            if self.idle:
                self.stall = stalled
                return rerouted
            self.tick()
        raise RuntimeError("sim drain did not complete")

    def assert_no_leaks(self) -> None:
        if self.running or self.waiting:
            raise AssertionError("sim engine not idle")

    def kv_residency(self) -> dict:
        """Measured residency digest, same schema the real engine's
        ``DecodeEngine.kv_residency`` publishes (models/paged.py) so
        sim fleets exercise the gateway's ResidencyIndex for real.
        Runs are the cache's maximal digest chains (leaf back to root,
        truncating where an interior block was already evicted); keys
        use the router's affinity scheme, so the ledger join is exact.
        Invariant: indexedBlocks == insertedBlocks - evictedBlocks."""
        parents = {
            meta["parent"] for meta in self._cached_blocks.values()
            if meta["parent"] is not None
        }
        runs = []
        for digest, meta in self._cached_blocks.items():
            if digest in parents:
                continue
            chain = []
            node = digest
            while node is not None:
                m = self._cached_blocks.get(node)
                if m is None:
                    break  # parent evicted under it: truncated chain
                chain.append(m)
                node = m["parent"]
            chain.reverse()
            runs.append({
                "keys": [m["key"] for m in chain[:8] if m["key"]],
                "blocks": len(chain),
                # The sim holds no refcounts: everything resident is a
                # parked cached block.
                "refs": {"cached": len(chain), "live": 0, "shared": 0},
                "lastTouch": max(m["touch"] for m in chain),
            })
        runs.sort(
            key=lambda r: (-r["blocks"], r["keys"][0] if r["keys"] else "")
        )
        return {
            "schema": "tpu-dra-kv-residency-v1",
            "blockSize": self.block_size,
            "indexedBlocks": len(self._cached_blocks),
            "insertedBlocks": self.inserted_blocks,
            "evictedBlocks": self.evicted_blocks,
            "runs": runs[:32],
            "truncatedRuns": max(0, len(runs) - 32),
        }

    def snapshot(self) -> dict:
        return {
            "queueDepth": len(self.waiting),
            "slotsBusy": len(self.running),
            "batchSlots": self.batch_slots,
            "admissionOpen": self._admission_open,
            "completed": self.completed,
            "ticks": self.ticks,
            "ttftP99Ms": 0.0,
            "prefixLookups": self.prefix_lookups,
            "prefixHits": self.prefix_hits,
            "prefixHitTokens": self.prefix_hit_tokens,
            "prefixHitRate": (
                self.prefix_hits / self.prefix_lookups
                if self.prefix_lookups else 0.0
            ),
            "cachedBlocks": len(self._cached_blocks),
        }


def replica_engines(n: int, **kwargs) -> list[ScriptedEngine]:
    """n identically configured scripted engines (sim fleets)."""
    return [ScriptedEngine(**kwargs) for _ in range(n)]


def shared_prefix_prompts(
    n_requests: int, *, n_systems: int = 8, system_len: int = 64,
    tail_len: int = 8, vocab: int = 1000, seed: int = 0,
    block_size: Optional[int] = None,
) -> list[list[int]]:
    """The production traffic shape (system prompts x random tails)
    without numpy: deterministic pseudo-random token lists whose leading
    ``system_len`` tokens repeat across requests with the same system.
    ``block_size`` only documents intent (affinity keys are block-
    aligned); lengths should be multiples of it."""
    del block_size
    import random

    rng = random.Random(seed)
    systems = [
        [rng.randrange(vocab) for _ in range(system_len)]
        for _ in range(n_systems)
    ]
    return [
        systems[i % n_systems]
        + [rng.randrange(vocab) for _ in range(tail_len)]
        for i in range(n_requests)
    ]
