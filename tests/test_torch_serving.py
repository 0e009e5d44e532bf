"""The port's DecodeEngine against the JAX package's, on the CPU at the
``tiny`` preset (f32), with parameters converted by ``params_from_numpy``.

The same mixed-length requests go through both engines with the prefix
cache, the overlapped tick and packed prefill on: token streams, the
``stats.snapshot()`` counters (every key but the timing ones), preemption
counts and prefix hits must be EQUAL, and ``assert_no_leaks()`` must
hold. The classes mirror the reference's tests/test_serving.py as far as
this port reaches.
"""

import jax
import numpy as np
import pytest

from k8s_dra_driver_tpu.models.llama import PRESETS as JPRESETS
from k8s_dra_driver_tpu.models.llama import init_params as jinit
from k8s_dra_driver_tpu.models.serving import DecodeEngine as JEngine
from k8s_dra_driver_tpu.models.serving import ServingStats as JStats
from k8s_dra_driver_tpu_torch.models import (
    AdmissionClosedError,
    DecodeEngine,
    OutOfBlocksError,
    ServingStats,
    generate,
    params_from_numpy,
)
from k8s_dra_driver_tpu_torch.models.serving import RUNNING

N_NEW = 6
TIMING_KEYS = {"ttftP50Ms", "ttftP99Ms", "tokenIntervalP50Ms",
               "tokenIntervalP99Ms"}


@pytest.fixture(scope="module")
def params():
    from k8s_dra_driver_tpu_torch.models.llama import PRESETS

    jp = jinit(JPRESETS["tiny"], jax.random.PRNGKey(0))
    cfg = PRESETS["tiny"]
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu"), cfg


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, 256, size=n)) for n in lens]


def _port(params, **kw):
    _, tp, cfg = params
    return DecodeEngine(tp, cfg, device="cpu", **kw)


def _serve_both(params, prompts, n_new=N_NEW, later=(), **kw):
    """Serve ``prompts`` (then ``later``, submitted once the first
    request runs) on both engines; returns (jax engine, port engine,
    jax streams, port streams)."""
    out = []
    for eng in (JEngine(params[0], JPRESETS["tiny"], **kw), _port(params, **kw)):
        reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        if later:
            while reqs[0].state != RUNNING and not reqs[0].done:
                eng.tick()
            reqs += [eng.submit(p, max_new_tokens=n_new) for p in later]
        eng.run()
        eng.assert_no_leaks()
        out.append((eng, [r.tokens for r in reqs]))
    (je, jt), (te, tt) = out
    return je, te, jt, tt


def _counters_equal(je, te):
    js, ts = je.stats.snapshot(), te.stats.snapshot()
    assert set(js) == set(ts)
    assert {k: v for k, v in ts.items() if k not in TIMING_KEYS} == {
        k: v for k, v in js.items() if k not in TIMING_KEYS}
    assert te.allocator.occupancy() == je.allocator.occupancy()
    assert te.kv_residency() == je.kv_residency()


def _solo(params, prompt, n=N_NEW):
    _, tp, cfg = params
    return generate(tp, [prompt], cfg, n, device="cpu")[0].tolist()


class TestTokenFidelity:
    def test_mixed_prompt_lengths_match_jax_engine(self, params):
        prompts = _prompts(0, (5, 11, 3, 17, 9))
        je, te, jt, tt = _serve_both(
            params, prompts, batch_slots=3, num_blocks=24, block_size=8,
            max_seq_len=64, prefill_chunk=8)
        assert tt == jt
        _counters_equal(je, te)
        assert te.compile_counts == je.compile_counts == {
            "decode_step": 1, "prefill_chunk": 1}
        for toks, p in zip(tt, prompts):
            assert toks == _solo(params, p)

    def test_slot_reuse_after_finish(self, params):
        prompts = _prompts(2, (6,) * 6)
        eng = _port(params, batch_slots=2, num_blocks=8, block_size=8,
                    max_seq_len=32, prefill_chunk=8)
        reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        assert eng.stats.completed == 6
        for r, p in zip(reqs, prompts):
            assert r.tokens == _solo(params, p)


    def test_long_prompt_does_not_stall_running_decodes(self, params):
        short, long_ = _prompts(1, (4, 40))
        eng = _port(params, batch_slots=2, num_blocks=16, block_size=8,
                    max_seq_len=64, prefill_chunk=8)
        r_short = eng.submit(short, max_new_tokens=12)
        while r_short.state != RUNNING:
            eng.tick()
        r_long = eng.submit(long_, max_new_tokens=4)
        produced = []
        while r_long.state != RUNNING and not r_short.done:
            before = len(r_short.generated)
            eng.tick()
            produced.append(len(r_short.generated) - before)
        assert sum(produced) >= 3, produced
        eng.run()
        eng.assert_no_leaks()
        assert r_short.tokens == _solo(params, short, 12)
        assert r_long.tokens == _solo(params, long_, 4)

    def test_eos_stops_early(self, params):
        prompt = _prompts(3, (6,))[0]
        ref = _solo(params, prompt, 12)
        gen = ref[len(prompt):]
        k = next(i for i in range(2, 12) if gen[i] not in gen[:i])
        eng = _port(params, batch_slots=1, num_blocks=8, block_size=8,
                    max_seq_len=32, prefill_chunk=8, eos_id=gen[k])
        r = eng.submit(prompt, max_new_tokens=12)
        eng.run()
        eng.assert_no_leaks()
        assert r.generated[-1] == gen[k] and len(r.generated) == k + 1
        assert r.tokens == ref[: len(prompt) + k + 1]


class TestPreemption:
    def _starved_engine(self, params):
        return _port(params, batch_slots=3, num_blocks=6, block_size=8,
                     max_seq_len=48, prefill_chunk=8)

    def test_never_evicts_running_when_prefill_victim_exists(self, params):
        from k8s_dra_driver_tpu_torch.models.serving import PREFILL

        eng = self._starved_engine(params)
        orig_preempt, orig_evict = eng._preempt_for, eng._evict
        ctx = {"needy": None}

        def spy_preempt(needy):
            ctx["needy"] = needy
            orig_preempt(needy)

        def spy_evict(req, requeue):
            if requeue and req.state == RUNNING:
                assert not [
                    r for r in eng._slots
                    if r is not None and r is not req
                    and r is not ctx["needy"] and r.state == PREFILL
                ]
            orig_evict(req, requeue)

        eng._preempt_for, eng._evict = spy_preempt, spy_evict
        prompts = _prompts(5, (16, 16, 16, 16))
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        assert eng.stats.completed == 4
        for r, p in zip(reqs, prompts):
            assert r.tokens == _solo(params, p, 8)

    def test_mid_tick_preemption_does_not_grow_evicted_request(self, params):
        eng = _port(params, batch_slots=2, num_blocks=4, block_size=4,
                    max_seq_len=16, prefill_chunk=4)
        prompts = _prompts(30, (3, 3))
        reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        assert eng.stats.preemptions > 0
        for r, p in zip(reqs, prompts):
            assert r.done and r.tokens == _solo(params, p, 12)

    def test_zero_block_victim_does_not_abort_preemption(self, params):
        from k8s_dra_driver_tpu_torch.models.serving import PREFILL, WAITING

        eng = _port(params, batch_slots=3, num_blocks=4, block_size=4,
                    max_seq_len=16, prefill_chunk=4)
        a, b, c = (eng.submit([1, 2, 3], max_new_tokens=4) for _ in range(3))
        eng._admit()
        eng._admit()
        for req in (a, c):
            blocks = eng.allocator.alloc(2)
            req.blocks.extend(blocks)
            for i, blk in enumerate(blocks):
                eng._tables[req.slot, i] = blk
            req.state = RUNNING
        assert b.state == PREFILL and not b.blocks
        eng._ensure_blocks(a, 9)
        assert len(a.blocks) == 3
        assert b.state == WAITING and c.state == WAITING
        assert eng.stats.preemptions == 2

    def test_prompt_filling_exact_block_budget_still_admits(self, params):
        eng = _port(params, batch_slots=1, num_blocks=4, block_size=8,
                    max_seq_len=32)
        r = eng.submit(list(np.arange(25) % 256), max_new_tokens=7)
        eng.run()
        eng.assert_no_leaks()
        assert r.done and len(r.generated) == 7

    def test_starved_pool_matches_jax_engine(self, params):
        """3 slots over 6 blocks of 8: decode growth must preempt; the
        same victims, the same counts, the same streams."""
        prompts = _prompts(4, (7, 9, 6, 8, 7))
        je, te, jt, tt = _serve_both(
            params, prompts, n_new=10, batch_slots=3, num_blocks=6,
            block_size=8, max_seq_len=48, prefill_chunk=8)
        assert te.stats.preemptions > 0
        assert tt == jt
        _counters_equal(je, te)

    def test_request_too_large_for_pool_is_typed_error(self, params):
        eng = _port(params, batch_slots=1, num_blocks=4, block_size=8,
                    max_seq_len=64, prefill_chunk=8)
        with pytest.raises(OutOfBlocksError):
            eng.submit(list(range(30)), max_new_tokens=10)
        with pytest.raises(ValueError, match="span"):
            eng.submit(list(range(60)), max_new_tokens=10)


class TestBatchedPrefill:
    @pytest.mark.parametrize("prefix_cache", [True, False])
    def test_batched_matches_serial_streams(self, params, prefix_cache):
        prompts = _prompts(7, (5, 19, 11, 23, 7, 13))
        streams = {}
        for pb in (4, 1):
            eng = _port(params, batch_slots=4, num_blocks=26, block_size=8,
                        max_seq_len=48, prefill_chunk=8, prefill_batch=pb,
                        prefix_cache=prefix_cache)
            reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
            eng.run()
            eng.assert_no_leaks()
            streams[pb] = [r.tokens for r in reqs]
        assert streams[4] == streams[1]

    def test_pressure_mid_batch_matches_jax_engine(self, params):
        prompts = _prompts(12, (15, 15, 15, 15))
        je, te, jt, tt = _serve_both(
            params, prompts, batch_slots=4, num_blocks=7, block_size=8,
            max_seq_len=48, prefill_chunk=8, prefill_batch=4,
            prefix_cache=False)
        assert te.stats.preemptions > 0
        assert tt == jt
        _counters_equal(je, te)

    def test_matches_solo_generate(self, params):
        prompts = _prompts(8, (6, 14, 9, 17))
        eng = _port(params, batch_slots=4, num_blocks=26, block_size=8,
                    max_seq_len=48, prefill_chunk=8, prefill_batch=4)
        reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        for r, p in zip(reqs, prompts):
            assert r.tokens == _solo(params, p), r.rid

    def test_prefill_batch_clamped_to_slots(self, params):
        assert _port(params, batch_slots=2, num_blocks=12, block_size=8,
                     max_seq_len=32, prefill_batch=16).prefill_batch == 2
        assert _port(params, batch_slots=8, num_blocks=40, block_size=8,
                     max_seq_len=32).prefill_batch == 4

    def test_burst_ttft_improves_in_ticks(self, params):
        prompts = _prompts(11, (24,) * 6)

        def run(pb):
            box = [0.0]
            eng = _port(params, batch_slots=4, num_blocks=20, block_size=8,
                        max_seq_len=48, prefill_chunk=8, prefill_batch=pb,
                        prefix_cache=False, clock=lambda: box[0])
            reqs = [eng.submit(p, max_new_tokens=3) for p in prompts]
            while not eng.idle:
                eng.tick()
                box[0] += 1.0
            eng.assert_no_leaks()
            st = eng.stats
            return ([r.tokens for r in reqs], st.pctl(st.ttft_s, 0.99),
                    st.pctl(st.token_interval_s, 0.99))

        toks_b, ttft_b, tok_b = run(4)
        toks_s, ttft_s, tok_s = run(1)
        assert toks_b == toks_s
        assert ttft_s / max(ttft_b, 1e-9) >= 1.5, (ttft_b, ttft_s)
        assert tok_b <= tok_s

    def test_occupancy_ledger(self, params):
        eng = _port(params, batch_slots=4, num_blocks=26, block_size=8,
                    max_seq_len=48, prefill_chunk=8, prefill_batch=4)
        eng.submit(_prompts(10, (16,))[0], max_new_tokens=2)
        eng.run()
        assert eng.stats.prefill_batch_occupancy() == 0.25
        assert eng.snapshot()["prefillBatchOccupancy"] == 0.25


class TestPrefixReuse:
    def test_shared_system_prompt_family_matches_jax_engine(self, params):
        """One system prompt, many tails, plus a block-aligned prompt that
        the cache covers whole (the copy-on-write recompute)."""
        rng = np.random.RandomState(42)
        system = list(rng.randint(0, 256, size=16))
        first = [system + list(rng.randint(0, 256, size=5))]
        later = [system + list(rng.randint(0, 256, size=n)) for n in (3, 9)]
        later.append(list(system))
        je, te, jt, tt = _serve_both(
            params, first, later=later, batch_slots=2, num_blocks=24,
            block_size=8, max_seq_len=64, prefill_chunk=8, prefill_batch=2)
        assert tt == jt
        _counters_equal(je, te)
        assert te.stats.prefix_hits >= 3
        assert te.stats.cow_recomputes == 1
        for toks, p in zip(tt, first + later):
            assert toks == _solo(params, p)

    def test_cache_hot_matches_cold_and_saves_prefill(self, params):
        prompt = _prompts(40, (20,))[0]
        eng = _port(params, batch_slots=2, num_blocks=16, block_size=8,
                    max_seq_len=64, prefill_chunk=8)
        a = eng.submit(prompt, max_new_tokens=N_NEW)
        eng.run()
        chunks_cold = eng.stats.prefill_chunks
        b = eng.submit(prompt, max_new_tokens=N_NEW)
        eng.run()
        eng.assert_no_leaks()
        assert a.tokens == b.tokens == _solo(params, prompt)
        assert b.cached_tokens > 0
        assert eng.stats.prefix_hit_tokens == b.cached_tokens
        assert eng.stats.prefill_chunks - chunks_cold < chunks_cold

    def test_disabled_cache_is_bitwise_identical_to_enabled(self, params):
        prompts = _prompts(43, (9, 21, 9))
        outs = []
        for flag in (True, False):
            eng = _port(params, batch_slots=2, num_blocks=16, block_size=8,
                        max_seq_len=48, prefill_chunk=8, prefix_cache=flag)
            reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
            eng.run()
            eng.assert_no_leaks()
            outs.append([r.tokens for r in reqs])
        assert outs[0] == outs[1]

    def test_preempting_shared_request_decrefs_not_frees(self, params):
        prompt = _prompts(44, (16,))[0]
        eng = _port(params, batch_slots=3, num_blocks=7, block_size=8,
                    max_seq_len=56, prefill_chunk=8)
        a = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        b = eng.submit(prompt, max_new_tokens=8)
        others = [eng.submit(p, max_new_tokens=10)
                  for p in _prompts(45, (12, 14))]
        eng.run()
        eng.assert_no_leaks()
        assert eng.stats.preemptions > 0
        assert b.tokens == a.tokens == _solo(params, prompt, 8)
        for r, p in zip(others, _prompts(45, (12, 14))):
            assert r.tokens == _solo(params, p, 10)

    def test_admission_headroom_discounts_own_revived_hit_blocks(
        self, params
    ):
        big = _prompts(60, (16,))[0]
        eng = _port(params, batch_slots=2, num_blocks=3, block_size=8,
                    max_seq_len=24, prefill_chunk=8)
        a = eng.submit(big, max_new_tokens=8)
        eng.run()
        assert eng.allocator.num_cached == 2
        small = _prompts(61, (6,))[0]
        b = eng.submit(small, max_new_tokens=2)
        c = eng.submit(big, max_new_tokens=8)
        eng.run()
        eng.assert_no_leaks()
        assert eng.stats.preemptions == 0
        assert b.tokens == _solo(params, small, 2)
        assert c.tokens == a.tokens == _solo(params, big, 8)

    def test_cow_leaves_the_cached_block_untouched(self, params):
        prompt = _prompts(41, (16,))[0]
        eng = _port(params, batch_slots=1, num_blocks=12, block_size=8,
                    max_seq_len=48, prefill_chunk=8)
        a = eng.submit(prompt, max_new_tokens=N_NEW)
        eng.run()
        hit = eng.prefix_cache.lookup(prompt)
        assert len(hit) == 2
        rows = slice(hit[-1] * 8, hit[-1] * 8 + 8)
        before = eng._pools[0][:, :, rows].clone()
        b = eng.submit(prompt, max_new_tokens=N_NEW)
        eng.run()
        eng.assert_no_leaks()
        assert b.tokens == a.tokens
        assert eng.stats.cow_recomputes == 1 and b.cached_tokens == 8
        assert (eng._pools[0][:, :, rows] == before).all()


class TestOverlap:
    def _serve(self, params, overlap, prompts, eos_id=None, n_new=8):
        eng = _port(params, batch_slots=2, num_blocks=12, block_size=8,
                    max_seq_len=48, prefill_chunk=8, overlap=overlap,
                    eos_id=eos_id)
        reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        return eng, [r.tokens for r in reqs]

    def test_overlap_matches_synchronous_tick(self, params):
        prompts = _prompts(50, (5, 17, 9, 4))
        eng_a, toks_a = self._serve(params, True, prompts)
        eng_b, toks_b = self._serve(params, False, prompts)
        assert toks_a == toks_b
        assert eng_a.compile_counts == {"decode_step": 1, "prefill_chunk": 1}

    def test_length_bounded_finish_never_wastes_a_step(self, params):
        prompts = _prompts(52, (5, 9))
        eng_o, _ = self._serve(params, True, prompts)
        eng_s, _ = self._serve(params, False, prompts)
        assert eng_o.stats.decode_steps == eng_s.stats.decode_steps

    def test_eos_surprise_drains_wasted_step(self, params):
        """EOS lands while the next step is in flight. Expectation from
        the documented semantics: the stream ends at the FIRST generated
        token equal to eos_id, the wasted in-flight token is computed but
        never committed, and the stream equals the synchronous engine's
        and the JAX engine's. The eos is taken at a generated position
        whose value does not occur earlier in the stream."""
        prompt = _prompts(51, (6,))[0]
        gen = _solo(params, prompt, 12)[len(prompt):]
        k = next(i for i in range(2, 12) if gen[i] not in gen[:i])
        eos = gen[k]
        eng_o, toks_o = self._serve(params, True, [prompt], eos, n_new=12)
        eng_s, toks_s = self._serve(params, False, [prompt], eos, n_new=12)
        assert toks_o == toks_s == [prompt + gen[: k + 1]]
        assert eng_o.stats.decode_steps > eng_s.stats.decode_steps
        assert eng_o.stats.tokens_generated == eng_s.stats.tokens_generated
        ref = JEngine(params[0], JPRESETS["tiny"], batch_slots=2,
                      num_blocks=12, block_size=8, max_seq_len=48,
                      prefill_chunk=8, eos_id=eos)
        r = ref.submit(prompt, max_new_tokens=12)
        ref.run()
        assert [r.tokens] == toks_o
        assert ref.stats.decode_steps == eng_o.stats.decode_steps


class TestDrain:
    def test_stop_admission_closes_submit(self, params):
        eng = _port(params, batch_slots=1, num_blocks=8, block_size=8,
                    max_seq_len=32)
        eng.stop_admission()
        assert not eng.admission_open
        with pytest.raises(AdmissionClosedError):
            eng.submit([1, 2, 3], max_new_tokens=2)
        eng.resume_admission()
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run()
        eng.assert_no_leaks()

    def test_drain_finishes_admitted_and_returns_queued(self, params):
        prompts = _prompts(70, (5, 9, 7, 11, 6))
        eng = _port(params, batch_slots=2, num_blocks=24, block_size=8,
                    max_seq_len=40, prefill_chunk=8)
        reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
        eng.tick()
        admitted = [r for r in reqs if r.admit_seq >= 0]
        assert len(admitted) == 2
        rerouted = eng.drain()
        assert [r.rid for r in rerouted] == [
            r.rid for r in reqs if r.admit_seq < 0]
        for r in admitted:
            assert r.done and r.tokens == _solo(params, r.prompt)
        for r in rerouted:
            assert r.state == "waiting" and not r.generated
        eng.assert_no_leaks()


    def test_drain_under_block_pressure_loses_nothing(self, params):
        prompts = _prompts(71, (9, 13, 11))
        eng = _port(params, batch_slots=3, num_blocks=7, block_size=8,
                    max_seq_len=40, prefill_chunk=8)
        reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
        for _ in range(2):
            eng.tick()
        admitted = [r for r in reqs if r.admit_seq >= 0]
        assert admitted
        eng.drain()
        for r in admitted:
            assert r.done and r.tokens == _solo(params, r.prompt)
        eng.assert_no_leaks()


class TestStats:
    def test_latency_and_throughput_accounting(self, params):
        t = [0.0]

        def clock():
            t[0] += 0.01
            return t[0]

        eng = _port(params, batch_slots=2, num_blocks=8, block_size=8,
                    max_seq_len=32, prefill_chunk=8, clock=clock)
        reqs = [eng.submit(p, max_new_tokens=4) for p in _prompts(6, (5, 7))]
        eng.run()
        s = eng.stats
        assert s.completed == 2
        assert s.tokens_generated == sum(len(r.generated) for r in reqs)
        assert len(s.ttft_s) == 2 and all(x > 0 for x in s.ttft_s)
        assert len(s.request_latency_s) == 2
        assert s.p99_token_ms() >= s.p50_token_ms() > 0
        for r in reqs:
            assert r.finished_at >= r.first_token_at

    def test_profiler_sees_every_phase(self, params):
        import contextlib

        seen, ticks = [], []

        class Profiler:
            @contextlib.contextmanager
            def phase(self, component, name):
                seen.append((component, name))
                yield

            def end_tick(self, component, tick, tag=""):
                ticks.append((component, tick, tag))

        eng = _port(params, batch_slots=2, num_blocks=8, block_size=8,
                    max_seq_len=32, prefill_chunk=8)
        eng.set_profiler(Profiler(), tag="r0")
        eng.submit([1, 2, 3, 4], max_new_tokens=3)
        eng.run()
        assert {n for _, n in seen} == {"admit", "prefill", "decode",
                                       "harvest"}
        assert ticks and ticks[-1] == ("engine", eng.stats.ticks, "r0")


class TestSnapshot:
    def test_stats_keys_equal_reference(self):
        assert ServingStats.SNAPSHOT_KEYS == JStats.SNAPSHOT_KEYS
        assert tuple(ServingStats().snapshot()) == JStats.SNAPSHOT_KEYS

    def test_engine_snapshot_keys_equal_reference(self, params):
        kw = dict(batch_slots=2, num_blocks=8, block_size=8, max_seq_len=32)
        ours = _port(params, **kw)
        ref = JEngine(params[0], JPRESETS["tiny"], **kw)
        for eng in (ours, ref):
            eng.submit([1, 2, 3, 4, 5], max_new_tokens=2)
        assert set(ours.snapshot()) == set(ref.snapshot())
        assert ours.snapshot()["queueDepth"] == 1
        ours.run()
        snap = ours.snapshot()
        assert snap["completed"] == 1 and snap["queueDepth"] == 0
        assert snap["computeCompiles"] == {"decode_step": 1,
                                           "prefill_chunk": 1}
