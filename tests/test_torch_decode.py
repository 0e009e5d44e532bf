"""The port's cached forward and generation against the JAX package's, on
the CPU at the ``tiny`` preset (f32).

The JAX parameters are converted with ``params_from_numpy``, so both
packages compute the same function: logits and written pools agree to
atol/rtol 1e-4 (f32, different summation order across two layers), and
greedy token streams are EQUAL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import decode as jdecode
from k8s_dra_driver_tpu.models import paged as jpaged
from k8s_dra_driver_tpu.models.llama import PRESETS as JPRESETS
from k8s_dra_driver_tpu.models.llama import init_params as jinit
from k8s_dra_driver_tpu_torch.models import decode as tdecode
from k8s_dra_driver_tpu_torch.models import paged as tpaged
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.models.llama import PRESETS

JTINY, TINY = JPRESETS["tiny"], PRESETS["tiny"]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jinit(JTINY, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), TINY,
                                 device="cpu")


def _caches(b, nbps, bs, nb, seed):
    """The same scrambled block tables on both sides."""
    rng = np.random.RandomState(seed)
    tables = rng.permutation(nb)[: b * nbps].reshape(b, nbps).astype(
        np.int32)
    jk, jv = jpaged._init_pools(JTINY, nb, bs)
    jc = jpaged.PagedKVCache(k=jk, v=jv, block_tables=jnp.asarray(tables),
                             lengths=jnp.zeros((b,), jnp.int32),
                             block_size=bs)
    tk, tv = tpaged._init_pools(TINY, nb, bs, device="cpu")
    tc = tpaged.PagedKVCache(k=tk, v=tv,
                             block_tables=torch.from_numpy(tables),
                             lengths=torch.zeros((b,), dtype=torch.int32),
                             block_size=bs)
    return jc, tc


def _pools_equal(jc, tc):
    p = jc.k.shape[2]
    np.testing.assert_allclose(tc.k[:, :, :p].numpy(), np.asarray(jc.k),
                               **TOL)
    np.testing.assert_allclose(tc.v[:, :, :p].numpy(), np.asarray(jc.v),
                               **TOL)


class TestForwardWithCache:
    def test_ragged_prefill_then_decode_matches_jax(self, params):
        """A packed chunk with ragged n_valid and an idle lane, then one
        decode step with an inactive lane: logits of every valid column,
        every written pool row, and the new lengths match; padded columns
        and inactive lanes write nothing (their pool rows stay zero, as in
        the reference's dropping scatter)."""
        jp, tp = params
        b, t, bs, nb, nbps = 3, 8, 8, 12, 4
        jc, tc = _caches(b, nbps, bs, nb, seed=1)
        rng = np.random.RandomState(2)
        tokens = rng.randint(0, TINY.vocab_size, size=(b, t)).astype(
            np.int32)
        starts = np.array([0, 5, 0], np.int32)
        n_valid = np.array([8, 3, 0], np.int32)
        active = np.array([True, True, False])
        positions = starts[:, None] + np.arange(t, dtype=np.int32)
        jl, jc = jdecode._forward_with_cache(
            jp, jnp.asarray(tokens), jc, JTINY, jnp.asarray(positions),
            n_valid=jnp.asarray(n_valid), active=jnp.asarray(active))
        tl, tc = tdecode._forward_with_cache(
            tp, torch.from_numpy(tokens), tc, TINY,
            torch.from_numpy(positions), n_valid=torch.from_numpy(n_valid),
            active=torch.from_numpy(active))
        for lane in range(2):
            np.testing.assert_allclose(
                tl[lane, : n_valid[lane]].numpy(),
                np.asarray(jl)[lane, : n_valid[lane]], **TOL)
        _pools_equal(jc, tc)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        # Decode: lane 1 inactive -> no write, frozen length.
        tok = np.array([7, 9, 11], np.int32)
        dact = np.array([True, False, True])
        pos = np.array(jc.lengths)[:, None]
        jl, jc = jdecode._forward_with_cache(
            jp, jnp.asarray(tok)[:, None], jc, JTINY, jnp.asarray(pos),
            active=jnp.asarray(dact))
        tl, tc = tdecode._forward_with_cache(
            tp, torch.from_numpy(tok)[:, None], tc, TINY,
            torch.from_numpy(pos), active=torch.from_numpy(dact))
        np.testing.assert_allclose(tl[dact].numpy(), np.asarray(jl)[dact],
                                   **TOL)
        _pools_equal(jc, tc)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        # Everything the reference dropped went to the scratch row only.
        written = np.abs(np.asarray(jc.k)).sum(axis=(0, 1, 3)) > 0
        assert written.sum() == 8 + 3 + 2
        assert tc.k[:, :, -1].abs().sum() > 0

    def test_use_kernels_false_is_the_same_function_on_cpu(self, params):
        _, tp = params
        out = {}
        for flag in (True, False):
            cache = tpaged.PagedKVCache.init(TINY, 2, 24, block_size=8,
                                             device="cpu")
            tokens = torch.arange(12, dtype=torch.int32).reshape(2, 6)
            out[flag], _ = tdecode._forward_with_cache(
                tp, tokens, cache, TINY, torch.arange(6), use_kernels=flag)
        torch.testing.assert_close(out[True], out[False], atol=0, rtol=0)

    def test_first_use_counter(self, params):
        _, tp = params
        seen = []
        tdecode.TRACE_OBSERVERS.append(lambda *a: seen.append(a))
        try:
            for _ in range(2):
                cache = tpaged.PagedKVCache.init(TINY, 1, 16, block_size=8,
                                                 device="cpu")
                tdecode._forward_with_cache(
                    tp, torch.zeros((1, 3), dtype=torch.int32), cache, TINY,
                    torch.arange(3))
        finally:
            tdecode.TRACE_OBSERVERS.pop()
        assert tdecode.TRACE_COUNTS["forward:bf16:t3"] == 1
        assert seen in ([], [("forward", "bf16", {"batch": 1, "tokens": 3})])


class TestGenerate:
    def test_greedy_streams_equal_jax(self, params):
        jp, tp = params
        rng = np.random.RandomState(3)
        prompt = rng.randint(0, TINY.vocab_size, size=(2, 7)).astype(np.int32)
        ref = np.asarray(jdecode.generate(jp, jnp.asarray(prompt), JTINY, 8))
        ours = tdecode.generate(tp, prompt, TINY, 8, device="cpu")
        assert ours.tolist() == ref.tolist()

    def test_sampling_follows_its_generator(self, params):
        """temperature > 0 draws from the caller's generator: the same
        seed gives the same stream (JAX's streams differ by design)."""
        _, tp = params
        outs = []
        for _ in range(2):
            gen = torch.Generator().manual_seed(7)
            outs.append(tdecode.generate(tp, [[5, 6, 7]], TINY, 6,
                                         temperature=1.0, generator=gen,
                                         device="cpu").tolist())
        assert outs[0] == outs[1]
        assert all(0 <= t < TINY.vocab_size for t in outs[0][0])

    def test_prefill_cached_cow_hit_equals_cold(self, params):
        """A fully cached prompt maps all but its trailing block and
        recomputes it: same last logits as the cold prefill."""
        _, tp = params
        bs, max_len = 8, 40
        alloc = tpaged.BlockAllocator(16)
        cache = tpaged.PrefixCache(alloc, bs)
        pools = tpaged._init_pools(TINY, 16, bs, device="cpu")
        prompt = list(range(3, 19))
        cold, _, blocks, hit = tdecode.prefill_cached(
            tp, prompt, TINY, max_len, pools, alloc, bs, prefix_cache=cache)
        assert hit == 0
        cache.insert(prompt, blocks)
        alloc.free(blocks)
        hot, _, blocks2, hit2 = tdecode.prefill_cached(
            tp, prompt, TINY, max_len, pools, alloc, bs, prefix_cache=cache)
        assert hit2 == bs
        torch.testing.assert_close(hot, cold, **TOL)
        alloc.free(blocks2)

    def test_unported_variants_raise(self, params):
        """What the port still refuses: a config of no ported family, and
        a parameter leaf that is neither an array nor a QuantTensor. (The
        int8 variants are ported: tests/test_torch_quant.py.)"""
        jp, tp = params
        _, cache = tdecode.prefill(tp, [[1, 2]], TINY, 8, quantize_cache=True)
        assert isinstance(cache, tpaged.PagedQuantKVCache)
        with pytest.raises(NotImplementedError):
            tdecode._require_supported(dataclasses.make_dataclass(
                "MoeConfig", [])())
        bad = dict(jax.tree.map(np.asarray, jp))
        bad["layers"] = dict(bad["layers"], wqkv=object())
        with pytest.raises(NotImplementedError):
            params_from_numpy(bad, TINY, device="cpu")
