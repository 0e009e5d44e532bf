"""The serving engine's captured steps (``models/step_graph.py``). Imports
no JAX, so it runs on the machine with the GPU:

    python -m pytest tests/test_torch_step_graph.py -q

On the CPU: the launch-counter bookkeeping (pure functions on tuples),
the list of counters against the wrappers that count, the staging of host
int arrays, the counting of shapes, captures and warm-ups, the sampler's
draw against ``torch.multinomial``, and a CPU ``DecodeEngine``, which
builds no graph and counts each step's first use.

On the card (``cuda``-marked; skipped without a CUDA device): the captured
engine against a ``capture=False`` engine on ``160m-gqa`` (bf16) and
``8x160m`` (bf16, and int8 weights with the int8 KV cache), random
weights from a seed, through waves of requests whose prefill chunks and
decode steps interleave, with preemption, prefix hits and a
copy-on-write recompute: greedy streams, stats counters, allocator state
and every launch count EQUAL (the kernels are bitwise equal on repeat, and
a replay runs the captured launches on the same inputs), and
``compile_counts`` 1 per step. A captured speculative call against an
eager one (160m-gqa, and 8x160m int8 with the int8 KV cache, each with a
160m draft): equal tokens, stats and launches, one host sync a round.
Also: no host sync in a replayed tick, a
capture that syncs raises (in a child process: a failed capture leaves
its stream's state behind), and a temperature > 0 step draws new numbers
on every replay.
"""

import gc
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu_torch import ops
from k8s_dra_driver_tpu_torch.models import (
    MOE_PRESETS,
    PRESETS,
    DecodeEngine,
    init_params,
    moe,
    quantize_params,
)
from k8s_dra_driver_tpu_torch.models import decode as tdecode
from k8s_dra_driver_tpu_torch.models import step_graph as sg
from k8s_dra_driver_tpu_torch.models.serving import RUNNING

ROOT = Path(__file__).resolve().parents[1]
TIMING_KEYS = {"ttftP50Ms", "ttftP99Ms", "tokenIntervalP50Ms",
               "tokenIntervalP99Ms"}


# -- the CPU ----------------------------------------------------------------


def test_launch_delta_and_add_are_inverse():
    before, after = (3, 0, 7), (5, 0, 10)
    delta = sg.launch_delta(before, after)
    assert delta == (2, 0, 3)
    assert sg.add_launches(before, delta) == after
    assert sg.add_launches(sg.add_launches((0, 0, 0), delta), delta) == \
        (4, 0, 6)
    with pytest.raises(ValueError):
        sg.launch_delta((1, 2), (1, 2, 3))


def test_read_and_write_launches_round_trip():
    saved = sg.read_launches()
    try:
        values = tuple(range(len(ops.LAUNCH_COUNTERS)))
        sg.write_launches(values)
        assert sg.read_launches() == values
        assert ops.int8_matmul.wide_prologue_launches == values[-1]
    finally:
        sg.write_launches(saved)
    assert sg.read_launches() == saved


def test_launch_counters_list_every_counting_wrapper():
    """Every ``*launches`` attribute of an ops function (and of the ring
    hop's kernel wrapper, ``parallel/ring.py``) is in the one list a
    captured step reads."""
    from k8s_dra_driver_tpu_torch.parallel import ring

    listed = {(id(fn), attr) for fn, attr in ops.LAUNCH_COUNTERS}
    found = set()
    for module in (ops.attention, ops.moe_dispatch, ops.norms,
                   ops.quant_matmul, ring):
        for obj in vars(module).values():
            if callable(obj):
                for attr in vars(obj) if hasattr(obj, "__dict__") else ():
                    if attr.endswith("launches"):
                        found.add((id(obj), attr))
    assert found and found == listed
    assert len(ops.LAUNCH_COUNTERS) == len(listed)


def test_cpu_step_stages_ints_and_counts_each_shape():
    counts = {"step": 0}
    seen = []

    def fn(a, flags, x):
        seen.append((a.dtype, flags.dtype))
        return a.sum(dim=-1) + flags * 10 + x

    step = sg.StepGraph(fn, "cpu", counts=counts, name="step")
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    flags = np.array([True, False])
    x = torch.tensor([100, 200], dtype=torch.int32)
    out = step((a, flags), x)
    assert out.tolist() == [3 + 10 + 100, 12 + 200]
    assert seen[-1] == (torch.int32, torch.int32)
    a[:] = 1                                  # the host may mutate after
    assert step((a, ~flags), x).tolist() == [103, 3 + 10 + 200]
    assert counts == {"step": 1} and step.graphs == 0
    step((np.zeros((3, 3), np.int32), np.zeros(3, bool)),
         torch.zeros(3, dtype=torch.int32))
    assert counts == {"step": 2} and step.graphs == 0


def test_cpu_step_takes_device_tensors_alone():
    """A step with no host arrays (the speculative loop's draft step and
    verify window) stages nothing and still counts its shape once."""
    counts = {"step": 0}
    step = sg.StepGraph(lambda x, y: x * 2 + y, "cpu", counts=counts,
                        name="step")
    x = torch.tensor([1, 2], dtype=torch.int32)
    assert step((), x, x).tolist() == [3, 6]
    assert step((), x + 1, x).tolist() == [5, 8]
    assert counts == {"step": 1} and step.graphs == 0


def test_trace_counts_count_captures_not_warmups():
    key = "forward:bf16:t777"
    tdecode.TRACE_COUNTS.pop(key, None)
    seen = []
    tdecode.TRACE_OBSERVERS.append(lambda *a: seen.append(a))
    try:
        with sg._in_phase("warmup"):
            tdecode._note_first_use("bf16", 2, 777)
        assert key not in tdecode.TRACE_COUNTS and not seen
        tdecode._note_first_use("bf16", 2, 777)     # eager: first use
        tdecode._note_first_use("bf16", 2, 777)
        assert tdecode.TRACE_COUNTS[key] == 1
        for _ in range(2):                          # each capture counts
            with sg._in_phase("capture"):
                tdecode._note_first_use("bf16", 2, 777)
        assert tdecode.TRACE_COUNTS[key] == 3 and len(seen) == 3
        assert sg.phase() is None
    finally:
        tdecode.TRACE_OBSERVERS.pop()
        tdecode.TRACE_COUNTS.pop(key, None)


def test_sample_draws_as_multinomial_does():
    logits = torch.randn(5, 300, generator=torch.Generator().manual_seed(1))
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    for _ in range(3):
        ours = tdecode.sample(logits, 0.7, g1)
        ref = torch.multinomial(torch.softmax(logits / 0.7, -1), 1,
                                generator=g2)[:, 0]
        assert ours.dtype == torch.int32
        assert ours.tolist() == ref.tolist()


def _tiny_engine(**kw):
    cfg = PRESETS["tiny"]
    params = init_params(cfg, seed=0, device="cpu")
    return DecodeEngine(params, cfg, batch_slots=3, num_blocks=32,
                        block_size=8, prefill_chunk=8, prefill_batch=2,
                        device="cpu", **kw)


@pytest.mark.parametrize("capture", [True, False])
def test_cpu_engine_builds_no_graph(capture):
    rng = np.random.RandomState(0)
    eng = _tiny_engine(capture=capture)
    reqs = [eng.submit(rng.randint(0, 256, size=n), max_new_tokens=5)
            for n in (5, 19, 11, 30)]
    eng.run()
    eng.assert_no_leaks()
    assert all(len(r.generated) == 5 for r in reqs)
    assert eng.compile_counts == {"decode_step": 1, "prefill_chunk": 1}
    assert eng.snapshot()["computeCompiles"] == eng.compile_counts
    assert not eng._decode.capture and not eng._prefill.capture
    assert eng._decode.graphs == 0 and eng._prefill.graphs == 0


def test_cpu_capture_flag_changes_nothing():
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, size=n) for n in (7, 23, 14)]
    streams = []
    for capture in (True, False):
        eng = _tiny_engine(capture=capture)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


# -- the card ---------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


_MODELS = {}


def _model(name: str, dev):
    """(config, params, quantize_cache) of a card case, built once."""
    if name not in _MODELS:
        if name == "160m-gqa":
            cfg = PRESETS[name]
            entry = (cfg, init_params(cfg, seed=0, device=dev), False)
        else:
            cfg = MOE_PRESETS["8x160m"]
            params = moe.init_params(cfg, seed=0, device=dev)
            if name == "8x160m-int8+kvq":
                params = quantize_params(params)
            entry = (cfg, params, name.endswith("kvq"))
        _MODELS[name] = entry
    return _MODELS[name]


def _engine(name, dev, **kw):
    cfg, params, kvq = _model(name, dev)
    # 24 blocks of 16 for 4 slots: the pool runs dry and preempts.
    return DecodeEngine(params, cfg, batch_slots=4, num_blocks=24,
                        block_size=16, prefill_chunk=32, prefill_batch=2,
                        quantize_cache=kvq, device=dev, **kw), cfg


def _serve(eng, cfg, sync_check=False):
    """Waves of requests: four of 57-120 tokens, then (once the first
    holder of the 64-token prefix has prefilled it) three sharing it, the
    first of them the prefix alone (a copy-on-write recompute). With
    ``sync_check`` every tick after both captures runs under
    ``set_sync_debug_mode("error")``."""
    rng = np.random.RandomState(7)

    def toks(n):
        return list(rng.randint(0, cfg.vocab_size, size=n))

    prefix = toks(64)
    first = [prefix + toks(40), toks(120), toks(57), toks(96)]
    later = [list(prefix), prefix + toks(33), prefix + toks(80)]
    reqs = [eng.submit(p, max_new_tokens=40) for p in first]
    checking = False
    try:
        for _ in range(10000):
            if eng.idle:
                break
            if sync_check and not checking and all(
                    eng.compile_counts.values()):
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                checking = True
            if len(reqs) == len(first) and reqs[0].state == RUNNING:
                reqs += [eng.submit(p, max_new_tokens=40) for p in later]
            eng.tick()
        else:
            raise AssertionError("engine not idle")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    eng.assert_no_leaks()
    assert not sync_check or checking
    return reqs


def _run(name, dev, capture, sync_check=False):
    before = sg.read_launches()
    eng, cfg = _engine(name, dev, capture=capture)
    reqs = _serve(eng, cfg, sync_check)
    launches = sg.launch_delta(before, sg.read_launches())
    return eng, [r.tokens for r in reqs], launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["160m-gqa", "8x160m", "8x160m-int8+kvq"])
def test_captured_engine_equals_eager_engine(dev, name):
    cap, cap_streams, cap_launches = _run(name, dev, capture=True)
    eag, eag_streams, eag_launches = _run(name, dev, capture=False)
    assert cap._decode.graphs == 1 and cap._prefill.graphs == 1
    assert eag._decode.graphs == 0 and eag._prefill.graphs == 0
    st = cap.stats
    assert st.preemptions > 0 and st.prefix_hits > 0 \
        and st.cow_recomputes > 0, st.snapshot()
    assert cap_streams == eag_streams
    cs, es = cap.stats.snapshot(), eag.stats.snapshot()
    assert {k: v for k, v in cs.items() if k not in TIMING_KEYS} == \
        {k: v for k, v in es.items() if k not in TIMING_KEYS}
    assert cap.allocator.occupancy() == eag.allocator.occupancy()
    assert cap.kv_residency() == eag.kv_residency()
    assert cap_launches == eag_launches
    counted = dict(zip(((fn.__name__, attr)
                        for fn, attr in ops.LAUNCH_COUNTERS), cap_launches))
    kvq = name.endswith("kvq")
    decode = ("paged_decode_int8" if kvq else "paged_decode_attention",
              "launches")
    # One K2 launch per layer and decode step, none from the warm-ups.
    assert counted[decode] == cap.config.n_layers * st.decode_steps
    assert cap.compile_counts == {"decode_step": 1, "prefill_chunk": 1}
    assert eag.compile_counts == {"decode_step": 1, "prefill_chunk": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["160m-gqa", "8x160m-int8+kvq"])
def test_replayed_ticks_never_sync(dev, name):
    eng, streams, _ = _run(name, dev, capture=True, sync_check=True)
    assert eng._decode.graphs == 1 and eng._prefill.graphs == 1
    assert all(len(s) > 0 for s in streams)


def _speculate(target, dev, capture, n_new, draft_seed=1):
    """A speculative call on the card: a 160m-gqa target (or 8x160m int8
    weights with the int8 KV cache) and a 160m draft from a seed, k 4, a
    100-token prompt. Returns (tokens, stats, launches, host syncs, pool
    rows)."""
    import warnings

    from k8s_dra_driver_tpu_torch.models import speculative_generate

    cfg, params, kvq = _model(target, dev)
    dcfg = PRESETS["160m"]
    if ("draft", draft_seed) not in _MODELS:
        _MODELS["draft", draft_seed] = init_params(dcfg, seed=draft_seed,
                                                   device=dev)
    draft = _MODELS["draft", draft_seed]
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size,
                                              size=(1, 100))
    before = sg.read_launches()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out, stats, caches = speculative_generate(
                params, draft, prompt, cfg, dcfg, n_new, k=4,
                quantize_cache=kvq, return_stats=True, return_caches=True,
                capture=capture, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchronizing CUDA operation" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    # Both caches' pools but their scratch row, and their lengths.
    rows = [pool[:, :, :-1] for cache in caches
            for pool in (cache.k, cache.v)]
    rows += [cache.lengths for cache in caches]
    return (out.cpu().tolist(), stats,
            sg.launch_delta(before, sg.read_launches()), syncs, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["160m-gqa", "8x160m-int8+kvq"])
def test_captured_speculation_equals_eager(dev, target):
    """The draft's T=1 step and the target's T=k+1 window captured on the
    call's caches, against the same call run eagerly: equal tokens,
    stats, launches and rewound lengths; two graphs captured, none
    eagerly; every pool row but the scratch row
    bitwise equal (the warm-ups write only that row); and the rounds' one
    host sync each: a call 16 tokens longer syncs exactly once more a
    round."""
    cap, cap_stats, cap_launches, syncs, cap_rows = _speculate(
        target, dev, True, 48)
    eag, eag_stats, eag_launches, _, eag_rows = _speculate(
        target, dev, False, 48)
    assert cap == eag
    # The warm-ups (zeroed inputs, every row inactive) wrote only the
    # scratch row: every other pool row bitwise equal.
    assert all(torch.equal(a, b) for a, b in zip(cap_rows, eag_rows))
    keys = ("rounds", "accepted", "acceptance_rate", "compile_counts")
    assert {k: cap_stats[k] for k in keys} == {k: eag_stats[k] for k in keys}
    assert cap_stats["compile_counts"] == {"draft_step": 1,
                                           "verify_window": 1}
    assert cap_stats["graphs"] == 2 and eag_stats["graphs"] == 0
    assert cap_launches == eag_launches
    _, longer, _, more_syncs, _ = _speculate(target, dev, True, 64)
    assert more_syncs - syncs == longer["rounds"] - cap_stats["rounds"] > 0


@pytest.mark.cuda
def test_a_capture_that_syncs_raises(dev):
    """A step that reads a value on the host cannot be captured: the
    StepGraph raises (it never runs the step eagerly instead)."""
    script = (
        "import numpy as np, torch\n"
        "from k8s_dra_driver_tpu_torch.models.step_graph import StepGraph\n"
        "counts = {'s': 0}\n"
        "step = StepGraph(lambda a: a * int(a.sum().item()), 'cuda',\n"
        "                 counts=counts, name='s')\n"
        "try:\n"
        "    step((np.ones(4, np.int32),))\n"
        "except RuntimeError as e:\n"
        "    assert counts == {'s': 0} and step.graphs == 0, counts\n"
        "    print('raised:', str(e).splitlines()[0])\n"
        "else:\n"
        "    raise SystemExit('the capture did not raise')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raised:" in proc.stdout


@pytest.mark.cuda
def test_a_collection_during_a_capture_leaves_it_whole(dev):
    """A captured step whose last holder is a reference cycle that dies
    inside another step's capture, with the collector made to run at
    every allocation: it must not be collected there (destroying its
    graph is a CUDA call a capture forbids), and the capture holds."""
    counts = {"s": 0}
    holder = [sg.StepGraph(lambda a: a + 1, dev, counts=counts, name="s")]
    holder[0]((np.zeros(4, np.int32),))
    assert holder[0].graphs == 1

    def fn(a):
        if sg.phase() == "capture" and holder:
            cycle = [holder.pop()]          # a young cycle, its only holder
            cycle.append(cycle)
            del cycle
            [[] for _ in range(1000)]       # allocations: collections
        return a * 2

    step = sg.StepGraph(fn, dev, counts=counts, name="s")
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        out = step((np.arange(4, dtype=np.int32),))
    finally:
        gc.set_threshold(*thresholds)
    assert not holder and step.graphs == 1
    assert out.tolist() == [0, 2, 4, 6]
    gc.collect()


@pytest.mark.cuda
def test_sampled_replays_draw_new_numbers(dev):
    """temperature > 0: the generator is registered with the graph, so
    each replay advances it (otherwise every replay repeats one draw)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def fn(x):
        logits = torch.zeros(8, 4096, device=x.device) + x[:, None]
        return tdecode.sample(logits, 1.0, gen)

    counts = {"s": 0}
    step = sg.StepGraph(fn, dev, counts=counts, name="s", generator=gen)
    draws = [step((np.zeros(8, np.int32),)).tolist() for _ in range(4)]
    assert step.graphs == 1 and counts == {"s": 1}
    assert len({tuple(d) for d in draws}) == 4, draws


@pytest.mark.cuda
def test_sampled_engine_serves_on_the_card(dev):
    eng, cfg = _engine("160m-gqa", dev, temperature=1.0)
    rng = np.random.RandomState(3)
    reqs = [eng.submit(rng.randint(0, cfg.vocab_size, size=n),
                       max_new_tokens=16) for n in (20, 50)]
    eng.run()
    eng.assert_no_leaks()
    assert eng.compile_counts == {"decode_step": 1, "prefill_chunk": 1}
    for r in reqs:
        assert len(r.generated) == 16
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
        assert len(set(r.generated)) > 1
