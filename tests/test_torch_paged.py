"""The port's paged-KV host classes against the JAX package's.

The same seeded op sequence (alloc, share, free, mark_cached, lookup,
insert, eviction under pressure) drives both packages' BlockAllocator and
PrefixCache; free lists, refcounts, cached sets, LRU order, the lifecycle
ledger, ``residency_digest`` and ``prefix_run_key`` must be EQUAL. The
index arithmetic (``flat_write_positions``, ``gather_indices``) is held
against the reference on seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import paged as jpaged
from k8s_dra_driver_tpu.models.llama import PRESETS as JPRESETS
from k8s_dra_driver_tpu.serving_gateway.router import prefix_affinity_key
from k8s_dra_driver_tpu_torch.models import paged as tpaged
from k8s_dra_driver_tpu_torch.models.llama import PRESETS


def _state(alloc, cache):
    return {
        "free": list(alloc._free),
        "refs": dict(alloc._refs),
        "cached": sorted(alloc._cached_flag),
        "lru": list(alloc._lru),
        "lru_entered": dict(alloc._lru_entered),
        "ledger": (alloc.evictions, alloc.alloc_misses, alloc.revivals,
                   alloc._op, list(alloc.eviction_ages)),
        "occupancy": alloc.occupancy(),
        "cache": (len(cache), cache.lookups, cache.hit_blocks,
                  cache.inserted_blocks, cache.evicted_blocks,
                  cache._touch),
        "digest": cache.residency_digest(),
    }


def _drive(mod, seed, num_blocks=12, bs=4):
    """A seeded op sequence; returns the state after every op."""
    rng = np.random.RandomState(seed)
    alloc = mod.BlockAllocator(num_blocks)
    cache = mod.PrefixCache(alloc, bs)
    system = list(rng.randint(0, 50, size=8))
    owners: list[tuple[list, list]] = []
    trace = []
    for step in range(60):
        op = rng.randint(5)
        if op <= 1:
            # Admit: look up a prompt, share the hit, allocate the tail.
            tail = list(rng.randint(0, 50, size=rng.randint(1, 9)))
            prompt = (system + tail) if rng.rand() < 0.6 else tail
            hit = cache.lookup(prompt)
            need = -(-len(prompt) // bs) - len(hit)
            try:
                alloc.share(hit)
                blocks = hit + alloc.alloc(need)
            except mod.OutOfBlocksError as e:
                alloc.free(hit)
                trace.append(("oob", e.requested, e.free, e.reclaimable))
                continue
            owners.append((prompt, blocks))
        elif op == 2 and owners:
            # Retire: index the full blocks, then drop the owner refs.
            prompt, blocks = owners.pop(rng.randint(len(owners)))
            cache.insert(prompt, blocks)
            alloc.free(blocks)
        elif op == 3 and owners:
            # Preempt: drop refs without indexing.
            _, blocks = owners.pop(rng.randint(len(owners)))
            alloc.free(blocks)
        elif op == 4 and owners:
            prompt, blocks = owners[rng.randint(len(owners))]
            cache.insert(prompt, blocks)
        trace.append(_state(alloc, cache))
    for _, blocks in owners:
        alloc.free(blocks)
    trace.append(_state(alloc, cache))
    return trace


class TestHostStateEqual:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_ops_same_state(self, seed):
        ours = _drive(tpaged, seed)
        ref = _drive(jpaged, seed)
        assert len(ours) == len(ref)
        for i, (a, b) in enumerate(zip(ours, ref)):
            assert a == b, i
        assert ref[-1]["ledger"][0] > 0, "the sequence must evict"

    def test_double_free_and_foreign_ids_fail_loudly(self):
        alloc = tpaged.BlockAllocator(4)
        (b,) = alloc.alloc(1)
        alloc.free([b])
        with pytest.raises(ValueError, match="double free"):
            alloc.free([b])
        with pytest.raises(ValueError, match="foreign"):
            alloc.incref(3)
        with pytest.raises(tpaged.OutOfBlocksError):
            alloc.alloc(5)


class TestPrefixRunKey:
    def test_matches_reference_and_router(self):
        rng = np.random.RandomState(3)
        for n in (1, 16, 64):
            span = rng.randint(0, 128256, size=n).tolist()
            assert tpaged.prefix_run_key(span) == jpaged.prefix_run_key(span)
            assert tpaged.prefix_run_key(span) == prefix_affinity_key(
                span, 1, len(span))


class TestIndexArithmetic:
    def _tables(self, rng, b=3, nbps=4, nb=16):
        return rng.permutation(nb)[: b * nbps].reshape(b, nbps).astype(
            np.int32)

    def test_flat_write_positions(self):
        rng = np.random.RandomState(4)
        bs = 8
        tables = self._tables(rng)
        span = tables.shape[1] * bs
        positions = rng.randint(-3, span + 5, size=(3, 6)).astype(np.int32)
        valid = rng.rand(3, 6) < 0.7
        scratch = 16 * bs
        want = np.asarray(jpaged.flat_write_positions(
            jnp.asarray(tables), jnp.asarray(positions), bs,
            valid=jnp.asarray(valid)))
        got = tpaged.flat_write_positions(
            torch.from_numpy(tables), torch.from_numpy(positions), bs,
            scratch, valid=torch.from_numpy(valid)).numpy()
        dropped = want == np.iinfo(np.int32).max
        assert dropped.any() and (~dropped).any()
        np.testing.assert_array_equal(got[~dropped], want[~dropped])
        assert (got[dropped] == scratch).all()

    def test_gather_indices(self):
        rng = np.random.RandomState(5)
        tables = self._tables(rng)
        want = np.asarray(jpaged.gather_indices(jnp.asarray(tables), 8))
        got = tpaged.gather_indices(torch.from_numpy(tables), 8).numpy()
        np.testing.assert_array_equal(got, want)

    def test_cache_pools_carry_one_scratch_row(self):
        cfg = PRESETS["tiny"]
        cache = tpaged.PagedKVCache.init(cfg, batch=2, max_len=20,
                                         block_size=8, device="cpu")
        ref = jpaged.PagedKVCache.init(
            JPRESETS["tiny"], batch=2, max_len=20, block_size=8)
        assert cache.k.shape[:2] + cache.k.shape[3:] == (
            ref.k.shape[:2] + ref.k.shape[3:])
        assert cache.k.shape[2] == ref.k.shape[2] + 1
        assert cache.scratch_row == ref.k.shape[2]
        assert cache.num_blocks == ref.num_blocks
        assert cache.max_len == ref.max_len
        np.testing.assert_array_equal(cache.block_tables.numpy(),
                                      np.asarray(ref.block_tables))
