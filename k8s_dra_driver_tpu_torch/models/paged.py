"""Paged KV cache: block pool, block tables, ref-counted allocator, and a
radix prefix index for cross-request KV reuse. Counterpart of
``k8s_dra_driver_tpu/models/paged.py``.

The host classes (:class:`BlockAllocator`, :class:`PrefixCache`,
:func:`prefix_run_key`) are near-copies of the reference: their state
must equal the reference's bit for bit under the same op sequence.

Pools are torch tensors ``[L, H_kv, P + 1, D]`` with ``P = num_blocks *
block_size`` flat token rows (block ``n`` owns rows ``[n*bs, (n+1)*bs)``)
and ONE trailing scratch row ``P`` that no block table addresses; the
int8 cache (:class:`PagedQuantKVCache`) adds f32 scale pools ``[L, H_kv,
P + 1]`` with the same scratch row. torch
has no dropping scatter (the reference writes with ``mode="drop"``), and
masking writes with a boolean index would force a host sync; instead
every invalid write position is routed to the scratch row. Pools are
updated in place by the forward pass (the reference donates them).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque
from typing import Callable, Optional

import torch

from .. import resolve_device
from ..ops.attention import gather_indices
from ..parallel.sharding import P, shard_pytree

DEFAULT_BLOCK_SIZE = 64
_EVICTION_AGE_SAMPLES = 512
_DIGEST_MAX_RUNS = 32
_DIGEST_KEY_BLOCKS = 8

__all__ = [
    "BlockAllocator",
    "OutOfBlocksError",
    "PagedKVCache",
    "PagedQuantKVCache",
    "PrefixCache",
    "cache_specs",
    "place_cache",
    "place_pools",
    "flat_write_positions",
    "gather_indices",
    "prefix_run_key",
]


def prefix_run_key(span) -> str:
    """Digest of a block-aligned leading token span, byte-identical to the
    reference's (and so to the gateway router's affinity key)."""
    return hashlib.blake2b(
        ",".join(str(int(t)) for t in span).encode(), digest_size=8
    ).hexdigest()


class OutOfBlocksError(RuntimeError):
    """The pool cannot cover a required allocation (see the reference)."""

    def __init__(self, requested: int, free: int, total: int,
                 reclaimable: int = 0):
        self.requested = requested
        self.free = free
        self.total = total
        self.reclaimable = reclaimable
        super().__init__(
            f"requested {requested} KV block(s) but only {free} of "
            f"{total} are free ({reclaimable} more reclaimable from the "
            f"prefix cache)"
        )


class BlockAllocator:
    """Ref-counted allocator over ``num_blocks`` fixed-size cache blocks.

    A block is free (on the LIFO free list), held (refcount >= 1), or
    cached (refcount 0, registered by the prefix cache, parked in an LRU
    and reclaimed only when ``alloc`` finds the free list dry). The
    lifecycle ledger -- ``evictions``, ``alloc_misses``, ``revivals``,
    ``eviction_ages`` -- is kept exactly as the reference keeps it."""

    def __init__(self, num_blocks: int):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self._refs: dict[int, int] = {}
        self._cached_flag: set[int] = set()
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.on_evict: Optional[Callable[[int], None]] = None
        self.evict_filter: Optional[Callable[[int], bool]] = None
        self.evictions = 0
        self.alloc_misses = 0
        self.revivals = 0
        self._op = 0
        self._lru_entered: dict[int, int] = {}
        self.eviction_ages: deque = deque(maxlen=_EVICTION_AGE_SAMPLES)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._refs)

    @property
    def num_cached(self) -> int:
        return len(self._lru)

    @property
    def num_available(self) -> int:
        return len(self._free) + len(self._lru)

    def ref_count(self, block: int) -> int:
        return self._refs.get(block, 0)

    def is_cached(self, block: int) -> bool:
        return block in self._cached_flag

    def alloc(self, n: int = 1) -> list[int]:
        """Take ``n`` blocks at refcount 1; all-or-nothing, evicting
        zero-ref cached blocks LRU-first when the free list runs dry."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        self._op += 1
        if n > self.num_available:
            self.alloc_misses += 1
            raise OutOfBlocksError(n, len(self._free), self.num_blocks,
                                   reclaimable=len(self._lru))
        out = []
        for _ in range(n):
            if not self._free:
                self._reclaim_one()
            b = self._free.pop()
            self._refs[b] = 1
            out.append(b)
        return out

    def _reclaim_one(self) -> None:
        victim = None
        if self.evict_filter is not None:
            for b in self._lru:
                if self.evict_filter(b):
                    victim = b
                    break
        if victim is None:
            victim = next(iter(self._lru))
        del self._lru[victim]
        self._cached_flag.discard(victim)
        self.evictions += 1
        self.eviction_ages.append(
            self._op - self._lru_entered.pop(victim, self._op)
        )
        if self.on_evict is not None:
            self.on_evict(victim)
        self._free.append(victim)

    def incref(self, block: int) -> None:
        """Add an owner to a held block, or revive a cached one."""
        if block in self._refs:
            self._refs[block] += 1
        elif block in self._lru:
            del self._lru[block]
            self._lru_entered.pop(block, None)
            self._refs[block] = 1
            self.revivals += 1
        else:
            raise ValueError(
                f"block {block} is neither held nor cached (foreign id)"
            )

    def share(self, blocks) -> None:
        for b in blocks:
            self.incref(b)

    def free(self, blocks) -> None:
        """Drop one owner per block; at refcount 0 a block returns to the
        free list, or parks in the LRU if the prefix cache registered it.
        Double-free and foreign ids fail loudly."""
        self._op += 1
        for b in blocks:
            r = self._refs.get(b)
            if r is None:
                raise ValueError(
                    f"block {b} is not allocated (double free or foreign id)"
                )
            if r > 1:
                self._refs[b] = r - 1
            else:
                del self._refs[b]
                if b in self._cached_flag:
                    self._lru[b] = None
                    self._lru_entered[b] = self._op
                else:
                    self._free.append(b)

    def mark_cached(self, block: int) -> None:
        if block not in self._refs and block not in self._lru:
            raise ValueError(f"block {block} is not allocated")
        self._cached_flag.add(block)

    def uncache(self, block: int) -> None:
        self._cached_flag.discard(block)
        if block in self._lru:
            del self._lru[block]
            self._lru_entered.pop(block, None)
            self._free.append(block)

    def occupancy(self) -> dict[str, int]:
        """Pool decomposition by block state; sums to ``num_blocks``."""
        private = indexed = shared = 0
        for b, r in self._refs.items():
            if r >= 2:
                shared += 1
            elif b in self._cached_flag:
                indexed += 1
            else:
                private += 1
        return {
            "free": len(self._free),
            "private": private,
            "indexed": indexed,
            "shared": shared,
            "cached": len(self._lru),
        }


class _RadixNode:
    __slots__ = ("key", "block", "parent", "children", "last_touch")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[tuple, "_RadixNode"] = {}
        self.last_touch = 0


class PrefixCache:
    """Block-granularity radix index over cached KV blocks, keyed on token
    ids. Each edge consumes ``block_size`` token ids; ``lookup`` returns
    the longest cached full-block prefix, ``insert`` registers full blocks
    (first writer wins). Eviction is driven by the allocator, leaf blocks
    first."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self._root = _RadixNode(None, -1, None)
        self._by_block: dict[int, _RadixNode] = {}
        allocator.on_evict = self._on_evict
        allocator.evict_filter = self._evictable
        self.lookups = 0
        self.hit_blocks = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self._touch = 0

    def __len__(self) -> int:
        return len(self._by_block)

    def lookup(self, tokens) -> list[int]:
        bs = self.block_size
        node = self._root
        out: list[int] = []
        self._touch += 1
        for i in range(len(tokens) // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            child.last_touch = self._touch
            out.append(child.block)
            node = child
        self.lookups += 1
        self.hit_blocks += len(out)
        return out

    def insert(self, tokens, blocks) -> int:
        bs = self.block_size
        node = self._root
        new = 0
        self._touch += 1
        for i in range(min(len(tokens) // bs, len(blocks))):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                b = blocks[i]
                if b in self._by_block:
                    break
                child = _RadixNode(key, b, node)
                node.children[key] = child
                self._by_block[b] = child
                self.allocator.mark_cached(b)
                new += 1
            child.last_touch = self._touch
            node = child
        self.inserted_blocks += new
        return new

    def residency_digest(
        self,
        max_runs: int = _DIGEST_MAX_RUNS,
        key_blocks: int = _DIGEST_KEY_BLOCKS,
    ) -> dict:
        """Every root-to-leaf radix path as a cached prefix run: its
        affinity key chain, block count, ref distribution and newest
        touch stamp (the reference's ``tpu-dra-kv-residency-v1``)."""
        paths: list[list[_RadixNode]] = []
        stack = [(c, [c]) for c in self._root.children.values()]
        while stack:
            node, path = stack.pop()
            if node.children:
                for c in node.children.values():
                    stack.append((c, path + [c]))
            else:
                paths.append(path)
        alloc = self.allocator
        runs = []
        for path in paths:
            tokens: list[int] = []
            keys: list[str] = []
            for node in path[:key_blocks]:
                tokens.extend(node.key)
                keys.append(prefix_run_key(tokens))
            refs = {"cached": 0, "live": 0, "shared": 0}
            for node in path:
                r = alloc.ref_count(node.block)
                if r == 0:
                    refs["cached"] += 1
                elif r == 1:
                    refs["live"] += 1
                else:
                    refs["shared"] += 1
            runs.append({
                "keys": keys,
                "blocks": len(path),
                "refs": refs,
                "lastTouch": max(n.last_touch for n in path),
            })
        runs.sort(key=lambda r: (-r["blocks"], r["keys"][0] if r["keys"]
                                 else ""))
        return {
            "schema": "tpu-dra-kv-residency-v1",
            "blockSize": self.block_size,
            "indexedBlocks": len(self._by_block),
            "insertedBlocks": self.inserted_blocks,
            "evictedBlocks": self.evicted_blocks,
            "runs": runs[:max_runs],
            "truncatedRuns": max(0, len(runs) - max_runs),
        }

    def _evictable(self, block: int) -> bool:
        node = self._by_block.get(block)
        return node is None or not node.children

    def _on_evict(self, block: int) -> None:
        node = self._by_block.pop(block, None)
        if node is None:
            return
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        self.evicted_blocks += 1
        stack = list(node.children.values())
        while stack:
            d = stack.pop()
            self._by_block.pop(d.block, None)
            self.evicted_blocks += 1
            self.allocator.uncache(d.block)
            stack.extend(d.children.values())


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV cache: pools + block tables + per-sequence lengths.

    k, v:          [L, H_kv, P + 1, D]; row P is the write scratch row
    block_tables:  [B, max_blocks_per_seq] int32 pool-block ids; entries
                   beyond a sequence's allocated prefix are sentinel 0
    lengths:       [B] int32 committed tokens per sequence
    """

    k: torch.Tensor
    v: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    block_size: int

    @classmethod
    def init(
        cls,
        config,
        batch: int,
        max_len: int,
        block_size: int | None = None,
        num_blocks: int | None = None,
        device=None,
    ) -> "PagedKVCache":
        """Every sequence pre-owns a contiguous run of blocks covering
        ``max_len`` (the fixed reservation of ``prefill``/``generate``)."""
        dev = resolve_device(device)
        bs = block_size or _fit_block_size(max_len)
        nbps = -(-max_len // bs)
        nb = num_blocks if num_blocks is not None else batch * nbps
        k, v = _init_pools(config, nb, bs, device=dev)
        tables = torch.arange(
            batch * nbps, dtype=torch.int32, device=dev
        ).reshape(batch, nbps)
        return cls(
            k=k, v=v, block_tables=tables,
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
            block_size=bs,
        )

    @property
    def max_len(self) -> int:
        return self.block_tables.shape[1] * self.block_size

    @property
    def scratch_row(self) -> int:
        """The pool row invalid writes are routed to (addressed by no
        table)."""
        return self.k.shape[2] - 1

    @property
    def num_blocks(self) -> int:
        return self.scratch_row // self.block_size


@dataclasses.dataclass
class PagedQuantKVCache:
    """int8 paged cache with per-(position, head) scales.

    k, v:               int8 [L, H_kv, P + 1, D]; row P is the scratch row
    k_scale, v_scale:   f32  [L, H_kv, P + 1]
    The table and length bookkeeping of :class:`PagedKVCache`; half its
    bytes at bf16.
    """

    k: torch.Tensor
    k_scale: torch.Tensor
    v: torch.Tensor
    v_scale: torch.Tensor
    block_tables: torch.Tensor
    lengths: torch.Tensor
    block_size: int

    @classmethod
    def init(
        cls,
        config,
        batch: int,
        max_len: int,
        block_size: int | None = None,
        num_blocks: int | None = None,
        device=None,
    ) -> "PagedQuantKVCache":
        dev = resolve_device(device)
        bs = block_size or _fit_block_size(max_len)
        nbps = -(-max_len // bs)
        nb = num_blocks if num_blocks is not None else batch * nbps
        k, v, ks, vs = _init_pools(config, nb, bs, quantized=True,
                                   device=dev)
        tables = torch.arange(
            batch * nbps, dtype=torch.int32, device=dev
        ).reshape(batch, nbps)
        return cls(
            k=k, k_scale=ks, v=v, v_scale=vs, block_tables=tables,
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
            block_size=bs,
        )

    max_len = PagedKVCache.max_len
    scratch_row = PagedKVCache.scratch_row
    num_blocks = PagedKVCache.num_blocks


def _fit_block_size(max_len: int) -> int:
    bs = DEFAULT_BLOCK_SIZE
    while bs > max_len and bs > 8:
        bs //= 2
    return bs


def _init_pools(config, num_blocks: int, block_size: int,
                quantized: bool = False, device=None):
    """Zeroed k and v pools ``[L, H_kv, num_blocks * block_size + 1, D]``
    (the last row is the write scratch row): in ``config.dtype``, or int8
    with f32 scale pools ``[L, H_kv, P + 1]`` as ``(k, v, k_scale,
    v_scale)`` when ``quantized``."""
    dev = resolve_device(device)
    p = num_blocks * block_size
    shape = (config.n_layers, config.n_kv_heads, p + 1, config.head_dim)
    if quantized:
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
    return (torch.zeros(shape, dtype=config.dtype, device=dev),
            torch.zeros(shape, dtype=config.dtype, device=dev))


def flat_write_positions(
    block_tables: torch.Tensor,   # [B, NBPS] int
    positions: torch.Tensor,      # [B, T] absolute positions (may be invalid)
    block_size: int,
    scratch_row: int,
    valid: torch.Tensor | None = None,   # [B, T] bool, extra mask
) -> torch.Tensor:
    """Map per-sequence absolute positions to flat pool rows [B, T] (int64).

    Invalid entries (outside the sequence's addressable span, or masked by
    ``valid``) map to ``scratch_row`` -- where the reference maps them out
    of bounds for a dropping scatter."""
    span = block_tables.shape[1] * block_size
    positions = positions.long()
    ok = (positions >= 0) & (positions < span)
    if valid is not None:
        ok = ok & valid
    blk = torch.gather(
        block_tables.long(), 1, positions.clamp(0, span - 1) // block_size
    )
    flat = blk * block_size + positions % block_size
    return torch.where(ok, flat, torch.full_like(flat, scratch_row))


#: The pools' placement on a mesh, the reference's serving layout
#: (``tests/test_decode_sharded.py::cache_specs``): kv heads cut over
#: ``tensor``, the rest of a pool whole; block tables and lengths
#: replicated.
POOL_SPEC = P(None, "tensor", None, None)
SCALE_SPEC = P(None, "tensor", None)


def cache_specs(quantized: bool = False, block_size: int = 0):
    """The spec tree of a cache (``block_size`` carried as it is)."""
    if quantized:
        return PagedQuantKVCache(k=POOL_SPEC, k_scale=SCALE_SPEC,
                                 v=POOL_SPEC, v_scale=SCALE_SPEC,
                                 block_tables=P(), lengths=P(),
                                 block_size=block_size)
    return PagedKVCache(k=POOL_SPEC, v=POOL_SPEC, block_tables=P(),
                        lengths=P(), block_size=block_size)


def place_pools(pools: tuple, mesh) -> tuple:
    """``(k, v)`` or ``(k, v, k_scale, v_scale)`` pools placed by
    :func:`cache_specs` on ``mesh``: each tensor shard's kv heads are the
    view ``pool[:, h0:h1]`` of the whole pool (one layer's ``pool[l,
    h0:h1]`` is contiguous, as the paged kernels take it), so the forward
    writes the whole pool in place."""
    specs = (POOL_SPEC, POOL_SPEC, SCALE_SPEC, SCALE_SPEC)
    return tuple(shard_pytree(p, mesh, spec) for p, spec in zip(pools, specs))


def place_cache(cache, mesh):
    """``cache`` with its pools placed by :func:`cache_specs`."""
    if isinstance(cache, PagedQuantKVCache):
        k, v, ks, vs = place_pools((cache.k, cache.v, cache.k_scale,
                                    cache.v_scale), mesh)
        return dataclasses.replace(cache, k=k, v=v, k_scale=ks, v_scale=vs)
    k, v = place_pools((cache.k, cache.v), mesh)
    return dataclasses.replace(cache, k=k, v=v)
