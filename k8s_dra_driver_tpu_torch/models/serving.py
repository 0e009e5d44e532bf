"""Continuous-batching decode engine over the paged KV cache, with
cross-request prefix reuse and an overlapped serving tick. Counterpart of
``k8s_dra_driver_tpu/models/serving.py`` (its module docstring states the
scheduling contract, which this port keeps unchanged):

- a fixed number of batch slots share one paged KV pool; requests are
  admitted and retired at token granularity;
- retired (and fully prefilled) prompts return their full KV blocks to a
  radix prefix index; admission maps the longest cached prefix into the
  block table, and a fully cached prompt recomputes its trailing block
  into a private copy (copy-on-write by recompute);
- up to ``prefill_batch`` requests' right-padded prompt chunks advance in
  one packed prefill launch per tick;
- preemption evicts the youngest request, prefill-state first, and
  requeues it at the front;
- the overlapped tick dispatches decode step N+1 before the host consumes
  step N's tokens. A request that finishes by EOS after its next step was
  dispatched drains for one tick (the wasted token is discarded);
  length-bounded finishes are predicted on the host and never dispatch a
  wasted step, so greedy streams are identical with overlap on or off.

On a CUDA device each of the two step functions runs as a CUDA graph,
the twin of the reference's ``jax.jit`` of ``_decode_fn`` and
``_prefill_fn`` (``models/step_graph.py``): captured once per static
shape -- (variant, ``batch_slots``, block-table width) for decode,
(``prefill_batch``, ``prefill_chunk``) for prefill, both at the full
``max_blocks_per_seq`` table, so an engine captures each step once -- and
replayed every tick, each graph in a memory pool of its own.
``compile_counts`` counts the captures, as the reference counts traces
(1 each for the engine's lifetime once it has run). On the CPU, or with
``capture=False`` (the twin of ``jax.disable_jit``), the steps run
eagerly and ``compile_counts`` counts each step's first use. Pools are
updated in place. The host's int arrays reach the device packed into one
pinned staging buffer per step (two, used in turn) and one copy sent
without blocking; a decode step's tokens come back through a pinned
buffer and an event recorded right after the step, so fetching step N
does not wait for step N+1.

The engine keeps its KV lifecycle ledger as plain counters and bounded
rings (the allocator's, ``models/paged.py``); ``kv_debug`` renders it as
the ``/debug/kv`` document and :class:`KVTelemetry` syncs it into the
``tpu_dra_kv_*`` families at scrape time only.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..parallel.layout import Layout, check_heads
from .decode import _forward_with_cache, _require_supported, sample
from .moe import resolve_moe_impl
from .paged import (
    BlockAllocator,
    OutOfBlocksError,
    PagedKVCache,
    PagedQuantKVCache,
    PrefixCache,
    _init_pools,
    place_pools,
)
from .step_graph import StepGraph

WAITING = "waiting"
PREFILL = "prefill"
RUNNING = "running"
DRAINING = "draining"   # finished, but a dispatched step still uses its blocks
FINISHED = "finished"

logger = logging.getLogger(__name__)


class AdmissionClosedError(RuntimeError):
    """``submit()`` on an engine whose admission is closed."""


@dataclasses.dataclass
class Request:
    """One generation request and its scheduling state."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    state: str = WAITING
    slot: int = -1
    blocks: list[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0                 # prompt tokens written to the pool
    cached_tokens: int = 0             # prompt tokens served from the cache
    generated: list[int] = dataclasses.field(default_factory=list)
    pending: int = -1                  # sampled, kv not yet written
    admit_seq: int = -1                # admission order (victim choice)
    preemptions: int = 0
    arrived_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # Optional per-request event log (anything with ``.event(name, t,
    # **attrs)``); None keeps every hot path on one attribute check.
    timeline: Optional[object] = None

    @property
    def done(self) -> bool:
        return self.state == FINISHED

    @property
    def tokens(self) -> list[int]:
        return list(self.prompt) + list(self.generated)


@dataclasses.dataclass
class ServingStats:
    """Counters + latency samples (the reference's, key for key)."""

    completed: int = 0
    preemptions: int = 0
    ticks: int = 0
    decode_steps: int = 0
    prefill_chunks: int = 0
    tokens_generated: int = 0
    prefix_lookups: int = 0
    prefix_hits: int = 0
    prefix_hit_tokens: int = 0
    cow_recomputes: int = 0
    prompt_tokens: int = 0
    prefill_tokens: int = 0
    prefill_lanes_used: int = 0
    prefill_lanes_launched: int = 0
    kv_footprint_blocks: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=1024)
    )
    kv_footprint_total: int = 0
    queue_depth: list = dataclasses.field(default_factory=list)
    ttft_s: list = dataclasses.field(default_factory=list)
    token_interval_s: list = dataclasses.field(default_factory=list)
    request_latency_s: list = dataclasses.field(default_factory=list)

    @staticmethod
    def pctl(xs, q):
        if not xs:
            return 0.0
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def p50_token_ms(self) -> float:
        return self.pctl(self.token_interval_s, 0.50) * 1e3

    def p99_token_ms(self) -> float:
        return self.pctl(self.token_interval_s, 0.99) * 1e3

    def p50_ttft_ms(self) -> float:
        return self.pctl(self.ttft_s, 0.50) * 1e3

    def p99_ttft_ms(self) -> float:
        return self.pctl(self.ttft_s, 0.99) * 1e3

    def hit_rate(self) -> float:
        return self.prefix_hit_tokens / max(self.prompt_tokens, 1)

    def prefill_batch_occupancy(self) -> float:
        return (self.prefill_lanes_used
                / max(self.prefill_lanes_launched, 1))

    def queue_depth_mean(self) -> float:
        return (sum(self.queue_depth) / len(self.queue_depth)
                if self.queue_depth else 0.0)

    def queue_depth_max(self) -> int:
        return max(self.queue_depth) if self.queue_depth else 0

    # The scrape contract, identical to the reference's.
    SNAPSHOT_KEYS = (
        "completed", "preemptions", "ticks", "decodeSteps",
        "prefillChunks", "prefillBatchOccupancy", "tokensGenerated",
        "prefixHitRate", "prefillTokensSaved", "cowRecomputes",
        "prefixLookups", "prefixHits", "prefixHitTokens",
        "kvFootprintBlocksP50", "kvFootprintBlocksMax",
        "queueDepthMean", "queueDepthMax", "ttftP50Ms", "ttftP99Ms",
        "tokenIntervalP50Ms", "tokenIntervalP99Ms",
    )

    def snapshot(self) -> dict:
        return {
            "completed": self.completed,
            "preemptions": self.preemptions,
            "ticks": self.ticks,
            "decodeSteps": self.decode_steps,
            "prefillChunks": self.prefill_chunks,
            "prefillBatchOccupancy": round(
                self.prefill_batch_occupancy(), 4
            ),
            "tokensGenerated": self.tokens_generated,
            "prefixHitRate": round(self.hit_rate(), 4),
            "prefillTokensSaved": self.prefix_hit_tokens,
            "cowRecomputes": self.cow_recomputes,
            "prefixLookups": self.prefix_lookups,
            "prefixHits": self.prefix_hits,
            "prefixHitTokens": self.prefix_hit_tokens,
            "kvFootprintBlocksP50": self.pctl(
                list(self.kv_footprint_blocks), 0.50
            ),
            "kvFootprintBlocksMax": (
                max(self.kv_footprint_blocks)
                if self.kv_footprint_blocks else 0
            ),
            "queueDepthMean": round(self.queue_depth_mean(), 2),
            "queueDepthMax": self.queue_depth_max(),
            "ttftP50Ms": round(self.p50_ttft_ms(), 3),
            "ttftP99Ms": round(self.p99_ttft_ms(), 3),
            "tokenIntervalP50Ms": round(self.p50_token_ms(), 3),
            "tokenIntervalP99Ms": round(self.p99_token_ms(), 3),
        }


def _start_fetch(x: torch.Tensor):
    """Begin copying ``x`` to the host without waiting for later work on
    its stream; :func:`_finish_fetch` returns it as a numpy array."""
    if x.device.type != "cuda":
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _finish_fetch(handle) -> np.ndarray:
    host, done = handle
    if done is not None:
        done.synchronize()
    return host.numpy()


class DecodeEngine:
    """Fixed-slot continuous-batching engine (see the module docstring).

    ``prefix_cache=False`` disables cross-request KV reuse;
    ``overlap=False`` consumes every decode step's tokens synchronously;
    ``prefill_batch`` caps the requests one packed prefill launch advances
    (default ``min(4, batch_slots)``); ``quantize_cache=True`` keeps the
    pool in int8 with per-position scales (``PagedQuantKVCache``), read by
    the int8 branches of the paged kernels; ``params`` may carry int8
    weights from ``quant.quantize_params``. ``device`` defaults to CUDA and the
    engine raises when no CUDA device is present; ``params`` must live on
    that device. On a CUDA device the decode and prefill steps are
    captured as CUDA graphs and replayed (see the module docstring);
    ``capture=False`` runs them eagerly there too, to compare the two:
    the same kernels on the same inputs, so the same streams, counters
    and launch counts. ``mesh`` (``parallel/mesh.py``) serves on the
    reference's ``mesh``: ``params`` whole or placed by ``shard_pytree(
    params, mesh, param_specs(config))`` (``quantize_specs`` of them for
    int8 weights), the pools cut on kv heads (``paged.cache_specs``),
    every step's stack per batch group and tensor shard inside the
    captured steps (``decode._mesh_forward_with_cache``; on an expert
    mesh ``auto`` resolves to einsum, ``moe_impl="dropless"`` runs the
    ring or psum path, K9's twin inside the captured steps), the host
    bookkeeping on the mesh's first device, which is the engine's device
    unless ``device`` says otherwise. ``batch_slots`` and
    ``prefill_batch`` must split over data x fsdp.
    """

    def __init__(
        self,
        params: dict,
        config,
        *,
        batch_slots: int = 4,
        num_blocks: int = 64,
        block_size: int = 16,
        max_seq_len: int | None = None,
        prefill_chunk: int = 32,
        prefill_batch: int | None = None,
        quantize_cache: bool = False,
        eos_id: int | None = None,
        temperature: float = 0.0,
        prefix_cache: bool = True,
        overlap: bool = True,
        mesh=None,
        clock=time.monotonic,
        device=None,
        capture: bool = True,
    ):
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        _require_supported(config)
        if mesh is not None:
            check_heads(config, mesh)
            Layout(mesh, "DecodeEngine").rows(batch_slots)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs "
                f"on {self.device}"
            )
        self.params = params
        self.config = config
        self.batch_slots = batch_slots
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        if prefill_batch is None:
            prefill_batch = min(4, batch_slots)
        self.prefill_batch = max(1, min(prefill_batch, batch_slots))
        if mesh is not None:
            # The packed prefill's lanes split over the batch groups too.
            Layout(mesh, "DecodeEngine").rows(self.prefill_batch)
        self.quantize_cache = quantize_cache
        self.eos_id = eos_id
        self.temperature = temperature
        self.overlap = overlap
        self.mesh = mesh
        self._clock = clock
        # What the MoE MLP runs per program, as the reference surfaces it.
        # The prefill program pins its impl at the per-lane chunk width:
        # resolving at the packed prefill_batch * chunk token count could
        # flip dropless to the capacity-dropping einsum on large experts,
        # and packed lanes would then route differently than one lane at a
        # time. Pinned, routing is a function of the chunk alone.
        self.moe_impl = {}
        self._prefill_config = config
        if hasattr(config, "moe_impl"):
            expert_mesh = (
                mesh is not None and mesh.shape.get("expert", 1) > 1
            )
            prefill_impl = resolve_moe_impl(config, prefill_chunk,
                                            expert_mesh=expert_mesh)
            self._prefill_config = dataclasses.replace(
                config, moe_impl=prefill_impl
            )
            self.moe_impl = {
                "decode_step": resolve_moe_impl(config, batch_slots,
                                                expert_mesh=expert_mesh),
                "prefill_chunk": prefill_impl,
            }
        span = max_seq_len or min(config.max_seq_len,
                                  num_blocks * block_size)
        self.max_blocks_per_seq = -(-span // block_size)
        self.max_seq_len = self.max_blocks_per_seq * block_size

        self.allocator = BlockAllocator(num_blocks)
        self.prefix_cache = (
            PrefixCache(self.allocator, block_size) if prefix_cache
            else None
        )
        self._pools = _init_pools(config, num_blocks, block_size,
                                  quantized=quantize_cache,
                                  device=self.device)
        if mesh is not None:
            self._pools = place_pools(self._pools, mesh)
        b = batch_slots
        self._tables = np.zeros((b, self.max_blocks_per_seq), np.int32)
        self._lengths = np.zeros((b,), np.int32)
        self._slots: list[Optional[Request]] = [None] * b
        self._slot_last_token_t: list[float] = [0.0] * b
        self.waiting: deque[Request] = deque()
        self.stats = ServingStats()
        # Captures of each step (first uses, eager); the reference counts
        # traces under the same keys.
        self.compile_counts = {"decode_step": 0, "prefill_chunk": 0}
        self._rid = 0
        self._admit_seq = 0
        self._admission_open = True
        self._profiler = None
        self._profile_tag = ""
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        drawn = self._generator if temperature > 0.0 else None
        self._decode = StepGraph(
            self._decode_fn, self.device, counts=self.compile_counts,
            name="decode_step", capture=capture, generator=drawn)
        self._prefill = StepGraph(
            self._prefill_fn, self.device, counts=self.compile_counts,
            name="prefill_chunk", capture=capture, generator=drawn)
        # Double-buffer state: (on-device [B] next tokens, host fetch
        # handle, [(req, slot), ...] it was dispatched for). At most one
        # step in flight.
        self._inflight = None
        self._zero_tokens = None

    # -- device steps -----------------------------------------------------

    def _cache(self, tables, lengths) -> "PagedKVCache | PagedQuantKVCache":
        if self.quantize_cache:
            k, v, ks, vs = self._pools
            return PagedQuantKVCache(k=k, k_scale=ks, v=v, v_scale=vs,
                                     block_tables=tables, lengths=lengths,
                                     block_size=self.block_size)
        k, v = self._pools
        return PagedKVCache(k=k, v=v, block_tables=tables, lengths=lengths,
                            block_size=self.block_size)

    # The step functions take int32 device views (flags as 0/1) from
    # their StepGraph's staging; nothing in them waits for the device.

    def _decode_fn(self, tables, lengths, override, use_override, active,
                   prev_tokens) -> torch.Tensor:
        # Slots carried from the previous step read their pending token
        # straight from that step's on-device output; everyone else is
        # overridden from host state. The merge stays on the device.
        tokens = torch.where(use_override != 0, override, prev_tokens)
        logits, _ = _forward_with_cache(
            self.params, tokens[:, None], self._cache(tables, lengths),
            self.config, positions=lengths[:, None], active=active != 0,
            mesh=self.mesh,
        )
        return sample(logits[:, 0], self.temperature, self._generator)

    def _prefill_fn(self, tables, starts, n_valid, active,
                    chunks) -> torch.Tensor:
        # The packed prefill launch: padded columns and idle lanes write
        # only the scratch row and never enter a valid query's attention.
        positions = starts[:, None] + torch.arange(
            chunks.shape[1], device=self.device
        )
        logits, _ = _forward_with_cache(
            self.params, chunks, self._cache(tables, starts),
            self._prefill_config, positions, n_valid=n_valid,
            active=active != 0, mesh=self.mesh,
        )
        # Each lane's last VALID column samples its first token.
        last = logits[
            torch.arange(chunks.shape[0], device=self.device),
            (n_valid.long() - 1).clamp(min=0),
        ]
        return sample(last, self.temperature, self._generator)

    # -- public API --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> Request:
        """Queue a request; returns its handle."""
        if not self._admission_open:
            raise AdmissionClosedError(
                "engine admission is closed (draining); re-route this "
                "request to another replica"
            )
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        total = len(prompt) + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request needs {total} positions but the engine's "
                f"per-sequence span is {self.max_seq_len}"
            )
        blocks_needed = -(-total // self.block_size)
        if blocks_needed > self.allocator.num_blocks:
            raise OutOfBlocksError(
                blocks_needed, self.allocator.num_free,
                self.allocator.num_blocks,
                reclaimable=self.allocator.num_cached,
            )
        req = Request(
            rid=self._rid, prompt=prompt, max_new_tokens=max_new_tokens,
            arrived_at=self._clock(),
        )
        self._rid += 1
        self.waiting.append(req)
        return req

    @property
    def num_active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def idle(self) -> bool:
        return (self.num_active == 0 and not self.waiting
                and self._inflight is None)

    @property
    def admission_open(self) -> bool:
        return self._admission_open

    def stop_admission(self) -> None:
        """Close the front door; preempted requests still re-admit."""
        self._admission_open = False

    def resume_admission(self) -> None:
        self._admission_open = True

    def snapshot(self) -> dict:
        """Live scheduling state + the stats snapshot (the reference's key
        set)."""
        occ = self.allocator.occupancy()
        pc = self.prefix_cache
        evicted_blocks = (
            pc.evicted_blocks if pc is not None
            else self.allocator.evictions
        )
        return {
            "queueDepth": len(self.waiting),
            "slotsBusy": self.num_active,
            "batchSlots": self.batch_slots,
            "admissionOpen": self._admission_open,
            "blocksFree": self.allocator.num_free,
            "blocksAvailable": self.allocator.num_available,
            "blocksTotal": self.allocator.num_blocks,
            "blocksPrivate": occ["private"],
            "blocksIndexed": occ["indexed"],
            "blocksShared": occ["shared"],
            "blocksCached": occ["cached"],
            "kvEvictedBlocks": evicted_blocks,
            "kvEvictedTokens": evicted_blocks * self.block_size,
            "kvRevivals": self.allocator.revivals,
            "kvAllocMisses": self.allocator.alloc_misses,
            "computeCompiles": dict(self.compile_counts),
            **self.stats.snapshot(),
        }

    def kv_residency(self) -> dict:
        """The replica's measured-residency digest (empty but well-formed
        with the prefix cache disabled)."""
        if self.prefix_cache is None:
            return {
                "schema": "tpu-dra-kv-residency-v1",
                "blockSize": self.block_size,
                "indexedBlocks": 0,
                "insertedBlocks": 0,
                "evictedBlocks": 0,
                "runs": [],
                "truncatedRuns": 0,
            }
        return self.prefix_cache.residency_digest()

    def kv_debug(self) -> dict:
        """The ``/debug/kv`` document: pool occupancy, the eviction/
        reclaim ledger, LRU-age and footprint sample summaries, and the
        full residency digest. Computed on demand only -- wire it up via
        ``MetricsServer.set_kv_provider(engine.kv_debug)``."""
        a = self.allocator
        ages = sorted(a.eviction_ages)
        feet = sorted(self.stats.kv_footprint_blocks)

        def _pct(xs, q):
            return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0

        return {
            "schema": "tpu-dra-kv-debug-v1",
            "blockSize": self.block_size,
            "blocksTotal": a.num_blocks,
            "occupancy": a.occupancy(),
            "evictions": a.evictions,
            "allocMisses": a.alloc_misses,
            "revivals": a.revivals,
            "cowRecomputes": self.stats.cow_recomputes,
            "prefixLookups": self.stats.prefix_lookups,
            "prefixHits": self.stats.prefix_hits,
            "prefixHitTokens": self.stats.prefix_hit_tokens,
            "evictionAgeOps": {
                "samples": len(ages), "p50": _pct(ages, 0.50),
                "p99": _pct(ages, 0.99),
                "max": ages[-1] if ages else 0,
            },
            "footprintBlocks": {
                "samples": len(feet), "p50": _pct(feet, 0.50),
                "max": feet[-1] if feet else 0,
            },
            "residency": self.kv_residency(),
        }

    def drain(self, max_ticks: int = 100000) -> list[Request]:
        """Graceful stop: close admission, hand back never-admitted
        requests, run every admitted request to completion."""
        self.stop_admission()
        rerouted = [r for r in self.waiting if r.admit_seq < 0]
        self.waiting = deque(
            r for r in self.waiting if r.admit_seq >= 0
        )
        for _ in range(max_ticks):
            if self.idle:
                return rerouted
            self.tick()
        raise RuntimeError(f"drain not complete after {max_ticks} ticks")

    def set_profiler(self, profiler, tag: str = "") -> None:
        """Attach a tick-phase profiler (``phase(component, name)``
        context managers + ``end_tick``); ``None`` detaches."""
        self._profiler = profiler
        self._profile_tag = tag

    def tick(self) -> None:
        """One scheduling round: admit, one packed prefill launch, one
        decode step for every running slot."""
        self.stats.ticks += 1
        self.stats.queue_depth.append(len(self.waiting))
        prof = self._profiler
        if prof is None:
            self._admit()
            self._prefill_tick()
            self._decode_tick()
            return
        with prof.phase("engine", "admit"):
            self._admit()
        with prof.phase("engine", "prefill"):
            self._prefill_tick()
        with prof.phase("engine", "decode"):
            self._decode_tick()
        prof.end_tick("engine", self.stats.ticks, tag=self._profile_tag)

    def run(self, max_ticks: int = 100000) -> None:
        """Drive ticks until every submitted request has finished."""
        for _ in range(max_ticks):
            if self.idle:
                return
            self.tick()
        raise RuntimeError(f"engine not idle after {max_ticks} ticks")

    def assert_no_leaks(self) -> None:
        """After drain: no block held, free + cached == pool."""
        if not self.idle:
            raise AssertionError("engine not idle")
        a = self.allocator
        if a.num_allocated:
            raise AssertionError(
                f"{a.num_allocated} block(s) leaked (held refs after "
                f"drain)"
            )
        if a.num_free + a.num_cached != a.num_blocks:
            raise AssertionError(
                f"pool accounting broken: {a.num_free} free + "
                f"{a.num_cached} cached != {a.num_blocks} total"
            )

    # -- scheduling internals ---------------------------------------------

    def _admit(self) -> None:
        # Same-tick admissions reserve their headroom against one budget.
        budget = self.allocator.num_available
        while self.waiting:
            free_slot = next(
                (i for i, r in enumerate(self._slots) if r is None), None
            )
            if free_slot is None:
                return
            req = self.waiting[0]
            if not self._admission_open and req.admit_seq < 0:
                return
            bs = self.block_size
            lifetime = -(-(len(req.prompt) + req.max_new_tokens) // bs)
            hit: list[int] = []
            cow = False
            if self.prefix_cache is not None:
                hit = self.prefix_cache.lookup(
                    req.prompt
                )[: self.max_blocks_per_seq]
                if hit and len(hit) * bs >= len(req.prompt):
                    # Full-prompt cover: recompute the final matched block
                    # into a private copy (copy-on-write by recompute).
                    hit = hit[:-1]
                    cow = True
            # Uncached prompt span + one block of headroom (capped at the
            # lifetime need); revived hit blocks are not headroom.
            need = min(
                -(-len(req.prompt) // bs) + 1, lifetime
            ) - len(hit)
            revived = sum(
                1 for b in hit if self.allocator.ref_count(b) == 0
            )
            if budget - revived < need:
                return
            budget -= need + revived
            self.waiting.popleft()
            req.state = PREFILL
            req.slot = free_slot
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self._slots[free_slot] = req
            self._tables[free_slot, :] = 0
            st = self.stats
            st.prompt_tokens += len(req.prompt)
            if self.prefix_cache is not None:
                st.prefix_lookups += 1
            if hit:
                self.allocator.share(hit)
                req.blocks = list(hit)
                self._tables[free_slot, : len(hit)] = hit
                req.prefilled = len(hit) * bs
                st.prefix_hits += 1
                st.prefix_hit_tokens += req.prefilled
            else:
                req.prefilled = 0
            req.cached_tokens = req.prefilled
            st.cow_recomputes += int(cow)
            self._lengths[free_slot] = req.prefilled
            if req.timeline is not None:
                req.timeline.event(
                    "engine-admit", self._clock(), slot=free_slot,
                    cachedTokens=req.cached_tokens,
                    cachedBlocks=len(hit), cow=cow,
                    readmission=req.preemptions > 0,
                )

    def _ensure_blocks(self, req: Request, positions: int) -> None:
        """Grow ``req``'s block table to cover ``positions`` tokens,
        preempting younger requests if the pool is dry."""
        need = -(-positions // self.block_size)
        while len(req.blocks) < need:
            while self.allocator.num_available == 0:
                self._preempt_for(req)
            new = self.allocator.alloc(1)[0]
            self._tables[req.slot, len(req.blocks)] = new
            req.blocks.append(new)

    def _preempt_for(self, needy: Request) -> None:
        """Evict the youngest other request (prefill-state preferred);
        draining requests are released by consuming the in-flight step."""
        candidates = [
            r for r in self._slots
            if r is not None and r is not needy
            and r.state in (PREFILL, RUNNING)
        ]
        if not candidates:
            if self._inflight is not None and any(
                r.state == DRAINING for r, _ in self._inflight[2]
            ):
                self._consume_inflight()
                return
            raise OutOfBlocksError(
                1, 0, self.allocator.num_blocks,
                reclaimable=self.allocator.num_cached,
            )
        in_prefill = [r for r in candidates if r.state == PREFILL]
        pool = in_prefill or candidates
        victim = max(pool, key=lambda r: r.admit_seq)
        victim_state = victim.state
        self._evict(victim, requeue=True)
        self.stats.preemptions += 1
        if victim.timeline is not None:
            victim.timeline.event(
                "preempted", self._clock(), victimState=victim_state,
                preemptions=victim.preemptions,
                forRid=needy.rid,
            )
        logger.debug(
            "preempted request %d (%s, preemption #%d) to feed "
            "request %d", victim.rid, victim_state,
            victim.preemptions, needy.rid,
        )

    def _evict(self, req: Request, requeue: bool) -> None:
        slot = req.slot
        self.allocator.free(req.blocks)
        req.blocks = []
        req.slot = -1
        self._slots[slot] = None
        self._lengths[slot] = 0
        self._tables[slot, :] = 0
        if requeue:
            req.prefilled = 0
            req.cached_tokens = 0
            req.generated = []
            req.pending = -1
            req.first_token_at = None
            req.state = WAITING
            req.preemptions += 1
            self.waiting.appendleft(req)

    def _complete(self, req: Request, slot: int) -> None:
        """The request's final token was consumed: record stats, then
        release its blocks unless a dispatched step still reads them."""
        req.finished_at = self._clock()
        self.stats.completed += 1
        self.stats.request_latency_s.append(
            req.finished_at - req.arrived_at
        )
        if req.timeline is not None:
            req.timeline.event(
                "engine-retire", req.finished_at,
                tokens=len(req.generated),
                preemptions=req.preemptions,
                cachedTokens=req.cached_tokens,
                engineLatencyS=round(
                    req.finished_at - req.arrived_at, 6
                ),
            )
        if self._covered_by_inflight(req, slot):
            req.state = DRAINING
        else:
            self._release(req)

    def _covered_by_inflight(self, req: Request, slot: int) -> bool:
        return self._inflight is not None and any(
            r is req and s == slot for r, s in self._inflight[2]
        )

    def _release(self, req: Request) -> None:
        """Retire: index full blocks whose KV is written in every tick
        mode, then free."""
        req.state = FINISHED
        self.stats.kv_footprint_blocks.append(len(req.blocks))
        self.stats.kv_footprint_total += 1
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.tokens[:-1], req.blocks)
        self._evict(req, requeue=False)

    def _prefill_tick(self) -> None:
        reqs = sorted(
            (r for r in self._slots
             if r is not None and r.state == PREFILL),
            key=lambda r: r.admit_seq,
        )[: self.prefill_batch]
        if not reqs:
            return
        # Block growth first, oldest lane first (it may preempt a younger
        # lane of this very batch); survivors are re-collected.
        for req in reqs:
            if req.state != PREFILL:
                continue
            n = min(self.prefill_chunk, len(req.prompt) - req.prefilled)
            self._ensure_blocks(req, req.prefilled + n)
        reqs = [r for r in reqs if r.state == PREFILL]
        if not reqs:
            return
        pb = self.prefill_batch
        chunks = np.zeros((pb, self.prefill_chunk), np.int32)
        starts = np.zeros((pb,), np.int32)
        n_valid = np.zeros((pb,), np.int32)
        active = np.zeros((pb,), bool)
        tables = np.zeros((pb, self.max_blocks_per_seq), np.int32)
        for lane, req in enumerate(reqs):
            lo = req.prefilled
            chunk = req.prompt[lo:lo + self.prefill_chunk]
            chunks[lane, : len(chunk)] = chunk
            starts[lane] = lo
            n_valid[lane] = len(chunk)
            active[lane] = True
            # Idle lanes keep all-zero rows + active=False.
            tables[lane] = self._tables[req.slot]
        toks_dev = self._prefill((tables, starts, n_valid, active, chunks))
        # Fetch tokens only when some lane finishes its prompt this launch.
        toks = (
            _finish_fetch(_start_fetch(toks_dev))
            if any(int(starts[i]) + int(n_valid[i]) == len(r.prompt)
                   for i, r in enumerate(reqs))
            else None
        )
        st = self.stats
        st.prefill_lanes_used += len(reqs)
        st.prefill_lanes_launched += pb
        for lane, req in enumerate(reqs):
            nv = int(n_valid[lane])
            st.prefill_chunks += 1
            st.prefill_tokens += nv
            req.prefilled = int(starts[lane]) + nv
            self._lengths[req.slot] = req.prefilled
            if req.timeline is not None:
                req.timeline.event(
                    "prefill-chunk", self._clock(), lane=lane,
                    tokens=nv,
                    occupancy=round(len(reqs) / pb, 4),
                    cachedTokensSkipped=req.cached_tokens,
                )
            if req.prefilled != len(req.prompt):
                continue
            if self.prefix_cache is not None:
                self.prefix_cache.insert(req.prompt, req.blocks)
            now = self._clock()
            first = int(toks[lane])
            req.state = RUNNING
            req.first_token_at = now
            req.generated.append(first)
            req.pending = first
            st.tokens_generated += 1
            st.ttft_s.append(now - req.arrived_at)
            self._slot_last_token_t[req.slot] = now
            if req.timeline is not None:
                req.timeline.event(
                    "first-token", now,
                    engineTtftS=round(now - req.arrived_at, 6),
                )
            if self._is_final(req, first):
                self._complete(req, req.slot)

    def _is_final(self, req: Request, tok: int) -> bool:
        return (
            len(req.generated) >= req.max_new_tokens
            or (self.eos_id is not None and tok == self.eos_id)
        )

    def _prev_tokens_input(self) -> torch.Tensor:
        # Under a graph this is the decode graph's own static output; its
        # replay copies it into the static input on the stream first.
        if self._inflight is not None:
            return self._inflight[0]
        if self._zero_tokens is None:
            self._zero_tokens = torch.zeros(
                (self.batch_slots,), dtype=torch.int32, device=self.device
            )
        return self._zero_tokens

    def _decode_tick(self) -> None:
        def runnable():
            return [
                r for r in self._slots
                if r is not None and r.state == RUNNING
            ]

        inflight_slots = (
            {id(r): s for r, s in self._inflight[2]}
            if self._inflight is not None else {}
        )

        def carried(r):
            return inflight_slots.get(id(r)) == r.slot

        # A slot whose in-flight token is certain to reach max_new_tokens
        # finishes when that token lands: do not dispatch it again.
        dispatch = [
            r for r in runnable()
            if not (carried(r)
                    and len(r.generated) + 1 >= r.max_new_tokens)
        ]
        for r in dispatch:
            if r.state != RUNNING:
                continue
            self._ensure_blocks(r, int(self._lengths[r.slot]) + 1)
        # Preemption (or a forced drain) may have demoted someone.
        inflight_slots = (
            {id(r): s for r, s in self._inflight[2]}
            if self._inflight is not None else {}
        )
        dispatch = [
            r for r in dispatch
            if r.state == RUNNING and not (
                carried(r) and len(r.generated) + 1 >= r.max_new_tokens
            )
        ]
        if not dispatch:
            self._consume_inflight()
            return
        b = self.batch_slots
        active = np.zeros((b,), bool)
        override = np.zeros((b,), np.int32)
        use_override = np.zeros((b,), bool)
        for r in dispatch:
            active[r.slot] = True
            if not carried(r):
                use_override[r.slot] = True
                override[r.slot] = r.pending
        # The call stages the host arrays, so they may change right after.
        nxt = self._decode(
            (self._tables, self._lengths, override, use_override, active),
            self._prev_tokens_input(),
        )
        # The write at position lengths[b] is in flight from here on.
        for r in dispatch:
            self._lengths[r.slot] += 1
        self.stats.decode_steps += 1
        # Under a graph ``nxt`` is the graph's static output: its fetch is
        # enqueued here, before the next replay overwrites it.
        prev, self._inflight = (
            self._inflight,
            (nxt, _start_fetch(nxt), [(r, r.slot) for r in dispatch]),
        )
        if prev is not None:
            # The device runs step N+1 while the host consumes step N.
            self._consume(prev)
        if not self.overlap:
            self._consume_inflight()

    def _consume_inflight(self) -> None:
        if self._inflight is not None:
            cur, self._inflight = self._inflight, None
            self._consume(cur)

    def _consume(self, inflight) -> None:
        if self._profiler is not None:
            with self._profiler.phase("engine", "harvest"):
                self._consume_inner(inflight)
            return
        self._consume_inner(inflight)

    def _consume_inner(self, inflight) -> None:
        _, fetch, ran = inflight
        nxt = _finish_fetch(fetch)    # the single batched fetch per tick
        now = self._clock()
        for r, slot in ran:
            if r.state == DRAINING and r.slot == slot:
                # The wasted step of an EOS finish: discard its token.
                self._release(r)
                continue
            if r.state != RUNNING or r.slot != slot:
                continue              # preempted since dispatch
            tok = int(nxt[slot])
            r.generated.append(tok)
            r.pending = tok
            self.stats.tokens_generated += 1
            self.stats.token_interval_s.append(
                now - self._slot_last_token_t[slot]
            )
            self._slot_last_token_t[slot] = now
            if self._is_final(r, tok):
                self._complete(r, slot)


class KVTelemetry:
    """Pull-model exporter for the ``tpu_dra_kv_*`` family.

    The serving path never touches a metric object: engines keep plain
    int counters and bounded sample rings (``models/paged.py``'s
    lifecycle ledger), and this class syncs them into the registry from
    a render hook -- i.e. at scrape time only. That is the whole
    zero-cost contract: telemetry ON vs OFF leaves tokens, tick counts,
    and compile counts identical, because ON only adds a reader.

    Usage::

        telemetry = KVTelemetry(registry)
        telemetry.attach(engine, replica="r0")

    Counters are published as deltas against the engines' cumulative
    ledger values; histograms drain exactly the samples that arrived
    since the previous scrape (the rings are bounded, so a long
    scrape gap keeps at most the newest ring's worth)."""

    def __init__(self, registry):
        from ..utils.metrics import Counter, Gauge, Histogram

        self._engines: dict[str, DecodeEngine] = {}
        self._published: dict[tuple, int] = {}
        self._g_pool = Gauge(
            "tpu_dra_kv_pool_blocks",
            "KV pool occupancy by block state (free/private/indexed/"
            "shared/cached); states are mutually exclusive and sum to "
            "the pool size.",
            registry,
        )
        self._g_indexed = Gauge(
            "tpu_dra_kv_indexed_blocks",
            "Blocks currently indexed by the prefix-cache radix tree "
            "(insertedBlocks - evictedBlocks on a healthy cache).",
            registry,
        )
        self._g_runs = Gauge(
            "tpu_dra_kv_prefix_runs",
            "Cached prefix runs (root-to-leaf radix paths) in the "
            "replica's residency digest.",
            registry,
        )
        self._c_evicted_blocks = Counter(
            "tpu_dra_kv_evicted_blocks_total",
            "Prefix-cached KV blocks dropped under allocation pressure "
            "(LRU-leaf-first reclaim).",
            registry,
        )
        self._c_evicted_tokens = Counter(
            "tpu_dra_kv_evicted_tokens_total",
            "Prompt tokens whose cached KV was dropped with evicted "
            "blocks (evicted blocks x block size).",
            registry,
        )
        self._c_misses = Counter(
            "tpu_dra_kv_alloc_misses_total",
            "Block allocations the pool could not cover even after "
            "reclaiming cached blocks (OutOfBlocksError raises).",
            registry,
        )
        self._c_revivals = Counter(
            "tpu_dra_kv_revivals_total",
            "Cache hits that revived a zero-ref block out of the "
            "reclaimable LRU back into the held state.",
            registry,
        )
        self._c_cow = Counter(
            "tpu_dra_kv_cow_recomputes_total",
            "Full-prompt cache hits whose trailing block was recomputed "
            "into a private copy (copy-on-write by recompute).",
            registry,
        )
        self._h_age = Histogram(
            "tpu_dra_kv_eviction_lru_age_ops",
            "LRU residence, in allocator ops, of each cached block at "
            "the moment it was reclaimed — low ages mean the cache is "
            "churning faster than it is reused.",
            registry,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        )
        self._h_foot = Histogram(
            "tpu_dra_kv_request_footprint_blocks",
            "KV blocks a request held at retire (its pool footprint).",
            registry,
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        registry.add_render_hook(self._sync)

    def attach(self, engine: "DecodeEngine", replica: str = "r0") -> None:
        """Register ``engine``'s ledger under the ``replica`` label and
        materialize its series (the explicit-zeros convention: an
        unchurned replica must read 0, not be absent)."""
        self._engines[replica] = engine
        for c in (self._c_evicted_blocks, self._c_evicted_tokens,
                  self._c_misses, self._c_revivals, self._c_cow):
            c.inc(0.0, replica=replica)
        self._h_age.zero(replica=replica)
        self._h_foot.zero(replica=replica)
        self._sync()

    def detach(self, replica: str) -> None:
        """Stop syncing a departed replica. Its counter/histogram series
        keep their final values (monotone history); the per-replica
        gauges are removed so a gone replica does not scrape as a live
        zero forever."""
        self._engines.pop(replica, None)
        for state in ("free", "private", "indexed", "shared", "cached"):
            self._g_pool.remove(replica=replica, state=state)
        self._g_indexed.remove(replica=replica)
        self._g_runs.remove(replica=replica)

    def _bump(self, counter, replica: str, current: int) -> None:
        key = (counter.name, replica)
        delta = current - self._published.get(key, 0)
        if delta > 0:
            counter.inc(delta, replica=replica)
        self._published[key] = current

    def _sync(self) -> None:
        for rid, eng in self._engines.items():
            a = eng.allocator
            for state, n in a.occupancy().items():
                self._g_pool.set(n, replica=rid, state=state)
            digest = eng.kv_residency()
            self._g_indexed.set(digest["indexedBlocks"], replica=rid)
            self._g_runs.set(
                len(digest["runs"]) + digest["truncatedRuns"],
                replica=rid,
            )
            self._bump(self._c_evicted_blocks, rid,
                       digest["evictedBlocks"])
            self._bump(self._c_evicted_tokens, rid,
                       digest["evictedBlocks"] * eng.block_size)
            self._bump(self._c_misses, rid, a.alloc_misses)
            self._bump(self._c_revivals, rid, a.revivals)
            self._bump(self._c_cow, rid, eng.stats.cow_recomputes)
            new = a.evictions - self._published.get(("ages", rid), 0)
            if new > 0:
                ring = list(a.eviction_ages)
                for v in ring[-min(new, len(ring)):]:
                    self._h_age.observe(v, replica=rid)
            self._published[("ages", rid)] = a.evictions
            total = eng.stats.kv_footprint_total
            new = total - self._published.get(("feet", rid), 0)
            if new > 0:
                ring = list(eng.stats.kv_footprint_blocks)
                for v in ring[-min(new, len(ring)):]:
                    self._h_foot.observe(v, replica=rid)
            self._published[("feet", rid)] = total
