"""The port's speculative decoding (``models/speculative.py``) against the
JAX package's, on the CPU at ``tiny`` / ``tiny-moe`` in f32.

Mirrors the reference's tests/test_speculative.py with the reference run
beside the port on the same parameters (``params_from_numpy``) and
prompt: every case's tokens equal the reference's
``speculative_generate`` and the port's own ``generate`` exactly, and
``rounds`` / ``accepted`` / ``acceptance_rate`` equal the reference's.
One JAX compile per reference run, each cached for the module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import moe as jmoe
from k8s_dra_driver_tpu.models.llama import PRESETS as REF_PRESETS
from k8s_dra_driver_tpu.models.llama import init_params as ref_init
from k8s_dra_driver_tpu.models.speculative import (
    speculative_generate as ref_speculative,
)
from k8s_dra_driver_tpu_torch.models import generate, moe, params_from_numpy
from k8s_dra_driver_tpu_torch.models.decode import prefill_cached
from k8s_dra_driver_tpu_torch.models.llama import PRESETS
from k8s_dra_driver_tpu_torch.models.paged import (
    BlockAllocator,
    PrefixCache,
    _init_pools,
)
from k8s_dra_driver_tpu_torch.models.speculative import speculative_generate
from k8s_dra_driver_tpu_torch.ops import (
    attention_impl_label,
    grouped_matmul_label,
    paged_prefill_impl_label,
    set_attention_impl,
)

JCFG, CFG = REF_PRESETS["tiny"], PRESETS["tiny"]
N = 12
SMALL = dict(hidden=32, n_layers=1, n_heads=2, n_kv_heads=1, mlp_hidden=64)
# (draft seed or None for the target itself, draft widths, k)
CASES = {
    "bad-k1": (99, {}, 1),
    "bad-k3": (99, {}, 3),
    "bad-k5": (99, {}, 5),
    "perfect-k4": (None, {}, 4),
    "smaller-k3": (7, SMALL, 3),
}


def _convert(jp, cfg):
    return params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                             device="cpu")


@functools.lru_cache(maxsize=None)
def _draft(seed, widths: tuple):
    jcfg = dataclasses.replace(JCFG, **dict(widths))
    jp = ref_init(jcfg, jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(CFG, **dict(widths))
    return jcfg, jp, cfg, _convert(jp, cfg)


@pytest.fixture(scope="module")
def target():
    jp = ref_init(JCFG, jax.random.PRNGKey(0))
    return jp, _convert(jp, CFG)


@pytest.fixture(scope="module")
def prompt():
    return np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 6), 0,
                                         JCFG.vocab_size))


def _stats(stats) -> dict:
    return {key: float(stats[key])
            for key in ("rounds", "accepted", "acceptance_rate")}


def _run_both(jt, tt, jd, td, jcfg_t, cfg_t, jcfg_d, cfg_d, prompt, k,
              **kw):
    """(reference tokens, reference stats, port tokens, port stats)."""
    ref, ref_stats = jax.jit(
        lambda tp, dp, t: ref_speculative(
            tp, dp, t, jcfg_t, jcfg_d, N, k=k, return_stats=True, **kw)
    )(jt, jd, jnp.asarray(prompt))
    out, stats = speculative_generate(
        tt, td, prompt, cfg_t, cfg_d, N, k=k, return_stats=True,
        device="cpu", **kw)
    return np.asarray(ref), _stats(ref_stats), out.numpy(), stats


@pytest.fixture(scope="module")
def runs(target, prompt):
    """Each case of CASES through both packages, run once."""
    jt, tt = target
    done = {}

    def get(case):
        if case not in done:
            seed, widths, k = CASES[case]
            if seed is None:
                jd, td, jcfg, cfg = jt, tt, JCFG, CFG
            else:
                jcfg, jd, cfg, td = _draft(seed, tuple(widths.items()))
            done[case] = _run_both(jt, tt, jd, td, JCFG, CFG, jcfg, cfg,
                                   prompt, k)
        return done[case]

    return get


@pytest.fixture(scope="module")
def plain(target, prompt):
    """The port's target-alone greedy stream."""
    return generate(target[1], prompt, CFG, N, device="cpu").numpy()


class TestSpeculative:
    @pytest.mark.parametrize("case", list(CASES))
    def test_tokens_and_stats_equal_reference(self, runs, plain, case):
        """Bad drafts (k 1, 3, 5), a perfect draft (the target itself) and
        a structurally smaller draft: every token equals target-alone
        greedy and the reference's, and the stats equal the
        reference's."""
        ref, ref_stats, out, stats = runs(case)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, plain)
        assert _stats(stats) == ref_stats
        assert stats["compile_counts"] == {"draft_step": 1,
                                           "verify_window": 1}
        assert stats["graphs"] == 0

    def test_stats_reflect_draft_quality(self, runs):
        k = CASES["perfect-k4"][2]
        good = runs("perfect-k4")[3]
        bad = runs("bad-k3")[3]
        assert good["accepted"] / good["rounds"] == k
        assert good["acceptance_rate"] == 1.0
        assert 0.0 <= bad["acceptance_rate"] < 1.0
        assert bad["rounds"] >= good["rounds"]
        assert bad["acceptance_rate"] == pytest.approx(
            bad["accepted"] / (bad["rounds"] * 3), abs=1e-6)

    def test_int8_cache_composes_exactly(self, target, prompt):
        """Requantizing identical k/v values is deterministic, so the
        equivalence survives the int8 cache: token-exact against the
        reference and the port's quantized-cache ``generate``."""
        jt, tt = target
        jcfg, jd, cfg, td = _draft(99, ())
        ref, ref_stats, out, stats = _run_both(
            jt, tt, jd, td, JCFG, CFG, jcfg, cfg, prompt, 3,
            quantize_cache=True)
        plain = generate(tt, prompt, CFG, N, quantize_cache=True,
                         device="cpu").numpy()
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, plain)
        assert _stats(stats) == ref_stats

    def test_checks(self, target, prompt):
        _, tt = target
        with pytest.raises(ValueError, match="B=1"):
            speculative_generate(tt, tt, np.zeros((2, 4), np.int32), CFG,
                                 CFG, N, device="cpu")
        other = dataclasses.replace(CFG, vocab_size=128)
        with pytest.raises(ValueError, match="vocabulary"):
            speculative_generate(tt, tt, prompt, CFG, other, N,
                                 device="cpu")


class TestFusedVerify:
    """The T=k+1 verify window: the port runs K3's plain version on the
    CPU; the reference runs its Pallas kernel in interpret mode
    (``set_attention_impl("interpret")``), as its own test does. Tokens
    equal, in f32 and bf16."""

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_verify_tokens_equal_reference_kernel(self, target, prompt,
                                                  dtype):
        from k8s_dra_driver_tpu.ops import attention as jatt

        jt, tt = target
        jcfg, jd, cfg, td = _draft(99, ())
        if dtype == "bf16":
            jcfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
            cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
            to16 = functools.partial(
                jax.tree_util.tree_map,
                lambda x: x.astype(jnp.bfloat16)
                if x.dtype == jnp.float32 else x)
            jt, jd = to16(jt), to16(jd)
            tt, td = _convert(jt, cfg), _convert(jd, cfg)
        else:
            jcfg = JCFG
        try:
            jatt.set_attention_impl("interpret")
            ref = np.asarray(jax.jit(
                lambda tp, dp, t: ref_speculative(tp, dp, t, jcfg, jcfg, N,
                                                  k=3)
            )(jt, jd, jnp.asarray(prompt)))
        finally:
            jatt.set_attention_impl("auto")
        out = speculative_generate(tt, td, prompt, cfg, cfg, N, k=3,
                                   device="cpu")
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_impl_labels(self):
        """The port's labels name what its wrappers run: the kernel on a
        CUDA tensor ("cuda", the reference's "pallas"), the plain version
        on a CPU tensor ("plain", the reference's "xla"). No override
        sends a CUDA tensor to the plain version."""
        for label in (paged_prefill_impl_label, attention_impl_label):
            assert label("cpu") == "plain"
            assert label("cuda") == "cuda"
            assert label() == ("cuda" if torch.cuda.is_available()
                               else "plain")
        assert grouped_matmul_label(16, 64, 128, device="cpu") == "plain"
        assert grouped_matmul_label(16, 64, 128, device="cuda") == "cuda"
        with pytest.raises(ValueError, match="multiples"):
            grouped_matmul_label(16, 48, 100, device="cuda")
        set_attention_impl("auto")
        for impl in ("interpret", "pallas", "xla", "plain"):
            with pytest.raises(ValueError, match="only 'auto'"):
                set_attention_impl(impl)


class TestSharedPrefixBlocks:
    """Speculative decoding against shared/COW prefix blocks
    (``prefill_cached`` over a shared paged pool): draft and verify writes
    never mutate a cached block, and the cache-hot run is token-exact
    against the cache-cold one and the reference's."""

    def _pool(self, config, num_blocks, bs):
        alloc = BlockAllocator(num_blocks)
        return (tuple(_init_pools(config, num_blocks, bs, device="cpu")),
                alloc, PrefixCache(alloc, bs))

    def test_cache_hot_exact_and_cached_blocks_immutable(self, target,
                                                         prompt):
        jt, tt = target
        bs, k, n_new = 4, 3, 8
        # Block-aligned 8-token prompt: a full-cover cache hit, so both
        # models' trailing matched blocks take the COW-recompute path.
        prompt = np.concatenate([prompt, prompt[:, :2]], axis=1)
        s = prompt.shape[1]
        prompt_list = [int(t) for t in prompt[0]]
        max_len = s + n_new + k + 1
        jcfg_d, jd, cfg_d, td = _draft(7, tuple(SMALL.items()))
        reference = np.asarray(ref_speculative(
            jt, jd, jnp.asarray(prompt), JCFG, jcfg_d, n_new, k=k))

        pools_t, alloc_t, pc_t = self._pool(CFG, 12, bs)
        pools_d, alloc_d, pc_d = self._pool(cfg_d, 12, bs)

        def prefill_both():
            lt, ct, bt, ht = prefill_cached(
                tt, prompt_list, CFG, max_len, pools_t, alloc_t, bs,
                prefix_cache=pc_t)
            _, cd, bd, hd = prefill_cached(
                td, prompt_list, cfg_d, max_len, pools_d, alloc_d, bs,
                prefix_cache=pc_d)
            return (lt, ct, bt, ht), (cd, bd, hd)

        # Cache-cold pass seeds both prefix caches.
        (lt, ct, bt, hit_t0), (cd, bd, hit_d0) = prefill_both()
        assert hit_t0 == 0 and hit_d0 == 0
        out_cold = speculative_generate(
            tt, td, prompt, CFG, cfg_d, n_new, k=k, target_state=(lt, ct),
            draft_cache=cd, device="cpu")
        np.testing.assert_array_equal(out_cold.numpy(), reference)
        pc_t.insert(prompt_list, bt)
        pc_d.insert(prompt_list, bd)
        alloc_t.free(bt)
        alloc_d.free(bd)

        # Cache-hot pass: full-cover hit, trailing block COW-recomputed.
        (lt2, ct2, bt2, hit_t), (cd2, bd2, hit_d) = prefill_both()
        assert hit_t == s - bs and hit_d == s - bs
        n_shared = hit_t // bs
        assert bt2[:n_shared] == bt[:n_shared]     # same physical blocks
        assert bt2[n_shared] != bt[n_shared]       # COW'd a private copy

        def rows_of(blocks):
            return [r for b in blocks[:n_shared]
                    for r in range(b * bs, (b + 1) * bs)]

        rows_t, rows_d = rows_of(bt2), rows_of(bd2)
        before = [pool[:, :, rows].clone()
                  for pools, rows in ((pools_t, rows_t), (pools_d, rows_d))
                  for pool in pools]
        out_hot, (fct, fcd) = speculative_generate(
            tt, td, prompt, CFG, cfg_d, n_new, k=k, target_state=(lt2, ct2),
            draft_cache=cd2, return_caches=True, device="cpu")
        np.testing.assert_array_equal(out_hot.numpy(), reference)
        # Draft proposals and verify windows wrote plenty -- but never
        # into a cached block: k and v of both models byte-identical.
        after = [pool[:, :, rows]
                 for pools, rows in (((fct.k, fct.v), rows_t),
                                     ((fcd.k, fcd.v), rows_d))
                 for pool in pools]
        for a, b in zip(after, before):
            assert torch.equal(a, b)
        # The rewind left each cache at the committed length less the
        # pending token.
        assert int(fct.lengths[0]) == int(fcd.lengths[0])
        assert s + n_new - 1 <= int(fct.lengths[0]) <= s + n_new + k
        alloc_t.free(bt2)
        alloc_d.free(bd2)
        # Pool-exact: every non-cached block is back on the free list.
        assert alloc_t.num_allocated == 0
        assert alloc_t.num_free + alloc_t.num_cached == alloc_t.num_blocks


class TestMoeTarget:
    @pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
    def test_moe_target_dense_draft_exact(self, capacity_factor):
        """A ``tiny-moe`` target verified in windows, a small dense draft
        proposing. A T=k+1 window can overflow per-expert capacity where
        T=1 decode cannot, so the verify forward runs dropless -- the T=1
        routing at any width. Both capacities are token-exact against the
        reference and the port's target-alone ``generate``."""
        jcfg_t = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"],
                                     capacity_factor=capacity_factor)
        cfg_t = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"],
                                    capacity_factor=capacity_factor)
        jcfg_d = dataclasses.replace(JCFG, vocab_size=jcfg_t.vocab_size)
        cfg_d = dataclasses.replace(CFG, vocab_size=cfg_t.vocab_size)
        jt = jmoe.init_params(jcfg_t, jax.random.PRNGKey(0))
        jd = ref_init(jcfg_d, jax.random.PRNGKey(7))
        prompt = np.array(jax.random.randint(
            jax.random.PRNGKey(2), (1, 8), 0, jcfg_t.vocab_size))
        tt, td = _convert(jt, cfg_t), _convert(jd, cfg_d)
        ref, ref_stats, out, stats = _run_both(
            jt, tt, jd, td, jcfg_t, cfg_t, jcfg_d, cfg_d, prompt, 3)
        plain = generate(tt, prompt, cfg_t, N, device="cpu").numpy()
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, plain)
        assert _stats(stats) == ref_stats
