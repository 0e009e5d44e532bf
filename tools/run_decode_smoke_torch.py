#!/usr/bin/env python3
"""Fast fixed-seed decode smoke on the PyTorch port.

Twin of ``tools/run_decode_smoke.py`` (``make decodebench``) over
``k8s_dra_driver_tpu_torch``'s ``DecodeEngine``: the same gates, seed,
traffic, pool sizes, ``TPU_DRA_DECODE_SMOKE_*`` variables, printed
lines and exit codes, per serving variant (bf16 / int8 weights / int8 KV
cache), with the ``tiny`` preset on the CPU (the 8b preset's widths cut
to 2 layers on the card):

1. **Compile-once**: driving the continuous-batching engine from the
   first token to a span-crossing length must build exactly one decode
   step and one prefill chunk. On the card the engine captures each
   step as a CUDA graph and ``compile_counts`` counts the captures; on
   the CPU it counts each step's first (eager) use. The prefix cache and
   the overlapped tick are both ON here: cache hits, COW recomputes and
   double-buffered dispatch must not add programs.
2. **Determinism**: two engines fed the same seeded traffic produce
   identical token streams.
3. **Shared-prefix determinism**: the same request served cache-cold
   and then cache-hot must produce identical tokens, and the hot pass
   must actually hit (prefill tokens saved > 0).
4. **Spread**: repeated timed runs of the same traffic must agree within
   ``TPU_DRA_DECODE_SMOKE_SPREAD`` (default 50%; a wall-clock tripwire).
5. **Batched-prefill determinism**: the packed prefill (prefill_batch=4)
   vs the serial one-chunk-per-tick engine (prefill_batch=1) emit
   identical streams per variant, prefix cache on AND off, with
   compile_counts still one decode + one prefill.
6. **TTFT**: under a burst of concurrent arrivals on a shared virtual
   tick clock, the batched-prefill engine must improve TTFT p99 by
   >= 1.5x (tick-normalized) over the serial engine at equal-or-better
   decode-token p99, with identical token streams.

``run(params, config, device)`` returns every engine's decisions (token
streams, ``compile_counts``, ticks) and the gates, each marked as a
deterministic gate or a wall-clock tripwire; ``main()`` prints as the
reference does. The tool runs on the card unless ``--device cpu`` is
given; without a card it raises, and never falls back.

Exit 0 = all gates pass; 1 = a gate failed. Run from the repo root:
``python tools/run_decode_smoke_torch.py [--device cpu]``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _gate_torch import Gates, gate_device, model_config  # noqa: E402

SPREAD_LIMIT = float(os.environ.get("TPU_DRA_DECODE_SMOKE_SPREAD", "0.5"))
SEED = int(os.environ.get("TPU_DRA_DECODE_SMOKE_SEED", "1234"))
ONES = {"decode_step": 1, "prefill_chunk": 1}
REPEATS = 3


def build_engine(params, config, quant_kv, device, **kw):
    from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine

    kw.setdefault("batch_slots", 2)
    kw.setdefault("num_blocks", 12)
    return DecodeEngine(
        params, config, block_size=8,
        max_seq_len=48, prefill_chunk=8, quantize_cache=quant_kv,
        device=device, **kw,
    )


def drive(engine, prompts, n_new):
    reqs = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
    engine.run()
    engine.assert_no_leaks()
    return [tuple(r.tokens) for r in reqs]


def run(params, config, device, emit=print) -> dict:
    """Every gate of the smoke on ``params`` (a float parameter tree on
    ``device``). Returns the gates, every engine it built (``engines``,
    in order), and per variant the streams and ``compile_counts`` of
    each engine, the spread, and the TTFT pair's decisions. ``emit`` takes the reference's summary lines."""
    import numpy as np

    from k8s_dra_driver_tpu_torch.models.quant import quantize_params

    gate = Gates()
    out = {"gates": gate, "variants": {}, "engines": []}

    def engine(*args, **kwargs):
        eng = build_engine(*args, **kwargs)
        out["engines"].append(eng)
        return eng

    rng = np.random.RandomState(SEED)
    prompts = [
        rng.randint(0, config.vocab_size, size=n).tolist()
        for n in (5, 11, 7)
    ]

    for label, p, qkv in (
        ("bf16", params, False),
        ("int8", quantize_params(params), False),
        ("kvq", params, True),
    ):
        rec = out["variants"][label] = {}
        eng = engine(p, config, qkv, device)
        tokens_a = drive(eng, prompts, n_new=30)   # crosses 4 block edges
        counts = dict(eng.compile_counts)
        rec.update(streams=tokens_a, compile_counts=counts,
                   ticks=eng.stats.ticks)
        gate(counts == ONES, f"{label}: compile counts {counts} != 1/1")
        # Determinism: a fresh engine, same traffic, same tokens.
        tokens_b = drive(engine(p, config, qkv, device), prompts,
                         n_new=30)
        rec["determinism_streams"] = tokens_b
        gate(tokens_a == tokens_b, f"{label}: nondeterministic token streams")
        # Shared-prefix determinism: the same request cache-cold vs
        # cache-hot.
        hot_eng = engine(p, config, qkv, device)
        shared = prompts[1]                  # 11 tokens: one full block
        (cold,) = drive(hot_eng, [shared], n_new=12)
        saved_before = hot_eng.stats.prefix_hit_tokens
        (hot,) = drive(hot_eng, [shared], n_new=12)
        saved = hot_eng.stats.prefix_hit_tokens - saved_before
        rec.update(cold=cold, hot=hot, saved=saved,
                   hot_compile_counts=dict(hot_eng.compile_counts))
        gate(cold == hot, f"{label}: cache-hot tokens diverge from cache-cold")
        gate(saved > 0, f"{label}: cache-hot pass saved no prefill tokens "
                        f"(prefix cache dead?)")
        gate(dict(hot_eng.compile_counts) == ONES,
             f"{label}: prefix-cache path compiled extra programs: "
             f"{hot_eng.compile_counts}")
        # Batched-prefill determinism, prefix cache on AND off.
        wide = [
            rng2.randint(0, config.vocab_size, size=n).tolist()
            for rng2 in (np.random.RandomState(SEED + 1),)
            for n in (5, 19, 11, 23, 7, 13)
        ]
        rec["batched"] = {}
        for cache_on in (True, False):
            pair = {}
            for pb in (4, 1):
                e = engine(
                    p, config, qkv, device, batch_slots=4, num_blocks=26,
                    prefill_batch=pb, prefix_cache=cache_on,
                )
                pair[pb] = drive(e, wide, n_new=12)
                rec["batched"][(cache_on, pb)] = dict(
                    streams=pair[pb], compile_counts=dict(e.compile_counts))
                gate(dict(e.compile_counts) == ONES,
                     f"{label}: prefill_batch={pb} cache={cache_on} "
                     f"compiled extra programs: {e.compile_counts}")
            gate(pair[4] == pair[1],
                 f"{label}: batched-prefill tokens diverge from the "
                 f"serial engine (prefix_cache={cache_on})")
        # Spread: repeat the drained run on the warm engine (compile paid).
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            drive(eng, prompts, n_new=30)
            times.append(time.perf_counter() - t0)
        mean = sum(times) / len(times)
        spread = (max(times) - min(times)) / 2
        rel = spread / mean if mean else 0.0
        rec["spread"] = rel
        status = "ok" if rel <= SPREAD_LIMIT else "FAIL"
        emit(f"decodebench {label}: compile={counts} "
             f"spread={rel:.1%} (limit {SPREAD_LIMIT:.0%}) {status}")
        gate(rel <= SPREAD_LIMIT,
             f"{label}: repeat spread {rel:.1%} "
             f"{'<=' if rel <= SPREAD_LIMIT else '>'} {SPREAD_LIMIT:.0%}",
             kind="wall")

    # TTFT gate: a burst of concurrent arrivals on a shared virtual tick
    # clock; bf16, prefix cache off.
    rng3 = np.random.RandomState(SEED + 2)
    burst = [
        rng3.randint(0, config.vocab_size, size=24).tolist()
        for _ in range(8)
    ]

    def ttft_run(pb):
        box = [0.0]
        e = engine(
            params, config, False, device, batch_slots=4, num_blocks=18,
            prefill_batch=pb, prefix_cache=False, clock=lambda: box[0],
        )
        reqs = [e.submit(q, max_new_tokens=4) for q in burst]
        while not e.idle:
            e.tick()
            box[0] += 1.0
        e.assert_no_leaks()
        s = e.stats
        return (
            [tuple(r.tokens) for r in reqs],
            s.pctl(s.ttft_s, 0.99),
            s.pctl(s.token_interval_s, 0.99),
            dict(e.compile_counts),
        )

    toks_b, ttft_b, tok_p99_b, counts_b = ttft_run(4)
    toks_s, ttft_s, tok_p99_s, counts_s = ttft_run(1)
    speedup = ttft_s / max(ttft_b, 1e-9)
    out["ttft"] = dict(streams={4: toks_b, 1: toks_s},
                       ttft_p99={4: ttft_b, 1: ttft_s},
                       token_p99={4: tok_p99_b, 1: tok_p99_s},
                       compile_counts={4: counts_b, 1: counts_s})
    emit(f"decodebench ttft: p99 {ttft_b:.0f} ticks batched vs "
         f"{ttft_s:.0f} serial ({speedup:.2f}x, gate >= 1.5x), "
         f"decode p99 {tok_p99_b:.0f} vs {tok_p99_s:.0f} ticks")
    gate(toks_b == toks_s, "ttft: batched vs serial token streams diverge")
    gate(speedup >= 1.5,
         f"ttft: tick-normalized p99 speedup {speedup:.2f}x < 1.5x")
    gate(tok_p99_b <= tok_p99_s,
         f"ttft: batched decode-token p99 {tok_p99_b} ticks worse "
         f"than serial {tok_p99_s}")
    for nm, c in (("batched", counts_b), ("serial", counts_s)):
        gate(c == ONES, f"ttft: {nm} engine compile counts {c} != 1/1")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="where the engines run (default cuda)")
    args = parser.parse_args(argv)
    from k8s_dra_driver_tpu_torch.models.llama import init_params

    dev = gate_device(args.device)
    config = model_config(dev)
    out = run(init_params(config, seed=0, device=dev), config, dev)
    failures = out["gates"].failures()
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print("decodebench: all variants compile once, deterministic "
          "(incl. batched prefill), ttft gate passed, spread within "
          "limit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
