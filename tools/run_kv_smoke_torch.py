#!/usr/bin/env python3
"""KV-telemetry zero-cost smoke on the PyTorch port.

Twin of ``tools/run_kv_smoke.py`` (``make kvsmoke``) over
``k8s_dra_driver_tpu_torch``: the same fixed-seed churn profile, pool,
gates, ``TPU_DRA_KV_SMOKE_*`` variables, printed lines and exit codes.
The profile is driven through a real ``DecodeEngine`` twice per
quantization variant (bf16 / int8 / kvq) -- lifecycle ledger unexported
(no KVTelemetry) vs exported (KVTelemetry attached, the registry
scraped between rounds so the render hook runs):

1. **Token streams identical** ON vs OFF, warm run and every repeat.
2. **Tick counts identical** ON vs OFF.
3. **Compile-once unchanged** in both runs: exactly one decode step and
   one prefill chunk (on the card: one CUDA-graph capture of each).
4. **Ledger self-consistent** ON: ``indexedBlocks == insertedBlocks -
   evictedBlocks`` after churn, pool occupancy states sum to the pool
   size, the request footprint histogram saw the retired requests, and
   /debug/kv's document is JSON-serializable.
5. **Wall-clock tripwire**: best-of-N ON within
   ``TPU_DRA_KV_SMOKE_OVERHEAD`` (default 50%) of OFF.

``run(params, config, device)`` returns the decisions (streams, ticks,
``compile_counts``, the residency digest and occupancy per variant) and
the gates, each a deterministic gate or a wall-clock tripwire;
``main()`` prints as the reference does. The tool runs on the card
unless ``--device cpu`` is given; without a card it raises.

Exit 0 = all gates pass; 1 = a gate failed. Run from the repo root:
``python tools/run_kv_smoke_torch.py [--device cpu]``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _gate_torch import Gates, gate_device, model_config  # noqa: E402

OVERHEAD_LIMIT = float(os.environ.get("TPU_DRA_KV_SMOKE_OVERHEAD", "0.50"))
SEED = int(os.environ.get("TPU_DRA_KV_SMOKE_SEED", "1234"))
N_NEW = 12
REPEATS = 5
ONES = {"decode_step": 1, "prefill_chunk": 1}


def build_engine(params, config, quant_kv, device):
    from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine

    # A deliberately tight pool (12 blocks, 2 slots): the shared-prefix
    # traffic below must force real evictions, revivals, and COW
    # recomputes so the ledger has lifecycle events to get wrong.
    return DecodeEngine(
        params, config, batch_slots=2, num_blocks=12, block_size=8,
        max_seq_len=48, prefill_chunk=8, quantize_cache=quant_kv,
        device=device,
    )


def drive(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=N_NEW) for p in prompts]
    engine.run()
    engine.assert_no_leaks()
    return [tuple(r.tokens) for r in reqs]


def churn_prompts(vocab_size: int) -> list:
    """A shared system prefix x varied tails, each submitted twice per
    round: the repeats hit the radix cache (COW on the trailing block),
    the variety plus the 12-block pool forces evictions."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    base = rng.randint(0, vocab_size, size=16).tolist()
    tails = [
        rng.randint(0, vocab_size, size=int(n)).tolist()
        for n in rng.randint(1, 14, size=4)
    ]
    return [base + t for t in tails] * 2


def check_ledger(gate, label, eng):
    digest = eng.kv_residency()
    gate(
        digest["indexedBlocks"]
        == digest["insertedBlocks"] - digest["evictedBlocks"],
        f"{label}: digest invariant indexed == inserted - evicted "
        f"({digest['indexedBlocks']} == {digest['insertedBlocks']} - "
        f"{digest['evictedBlocks']})",
    )
    debug = eng.kv_debug()
    occ = debug["occupancy"]
    gate(
        sum(occ.values()) == debug["blocksTotal"],
        f"{label}: occupancy states sum to the pool "
        f"({occ} vs {debug['blocksTotal']})",
    )
    gate(
        debug["footprintBlocks"]["samples"] > 0,
        f"{label}: footprint histogram saw retired requests "
        f"({debug['footprintBlocks']['samples']} samples)",
    )
    try:
        json.dumps(debug)
        json.dumps(digest)
        gate(True, f"{label}: /debug/kv + residency docs JSON-clean")
    except (TypeError, ValueError) as e:
        gate(False, f"{label}: debug docs not JSON-serializable: {e}")
    return digest, occ


def run(params, config, device, emit=print) -> dict:
    """Every gate of the smoke on ``params`` (a float parameter tree on
    ``device``); returns the gates, every engine it built (``engines``)
    and per variant its decisions."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import KVTelemetry
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    gate = Gates(emit)
    out = {"gates": gate, "variants": {}, "engines": []}
    prompts = churn_prompts(config.vocab_size)
    for label, p, qkv in (
        ("bf16", params, False),
        ("int8", quantize_params(params), False),
        ("kvq", params, True),
    ):
        runs = {}
        for on in (False, True):
            eng = build_engine(p, config, qkv, device)
            out["engines"].append(eng)
            registry = None
            if on:
                registry = Registry()
                KVTelemetry(registry).attach(eng, replica="r0")
            warm = drive(eng, prompts)   # compiles
            if on:
                registry.render()        # first scrape: hook + deltas
            times, rounds = [], []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                tokens = drive(eng, prompts)
                times.append(time.perf_counter() - t0)
                rounds.append(tokens)
                if on:
                    # Scrape between rounds: the render hook must
                    # observe mid-churn state without perturbing it.
                    registry.render()
            runs[on] = {
                "warm": warm, "rounds": rounds,
                "ticks": eng.stats.ticks, "best": min(times),
                "eng": eng, "registry": registry,
                "compile_counts": dict(eng.compile_counts),
            }

        off, on_run = runs[False], runs[True]
        gate(off["warm"] == on_run["warm"]
             and off["rounds"] == on_run["rounds"],
             f"{label}: token streams identical with KV telemetry "
             "ON vs OFF")
        gate(off["ticks"] == on_run["ticks"],
             f"{label}: tick counts identical ON vs OFF "
             f"({on_run['ticks']} vs {off['ticks']})")
        for tag, r in (("OFF", off), ("ON", on_run)):
            counts = r["compile_counts"]
            gate(counts == ONES,
                 f"{label}: compile-once unchanged {tag}: {counts}")
        digest, occ = check_ledger(gate, label, on_run["eng"])
        text = on_run["registry"].render()
        gate("tpu_dra_kv_pool_blocks" in text
             and "tpu_dra_kv_evicted_blocks_total" in text,
             f"{label}: tpu_dra_kv_* families render")
        evicted = digest["evictedBlocks"]
        emit(f"  {label}: {evicted} block(s) evicted over the run "
             "(churn the ledger must survive)")

        ratio = on_run["best"] / max(off["best"], 1e-9)
        emit(f"  {label} wall: best-of-{REPEATS} {on_run['best']:.3f}s "
             f"ON vs {off['best']:.3f}s OFF ({(ratio - 1):+.1%}, limit "
             f"+{OVERHEAD_LIMIT:.0%} CPU tripwire)")
        gate(ratio <= 1.0 + OVERHEAD_LIMIT,
             f"{label}: wall-clock overhead {(ratio - 1):+.1%} within "
             f"+{OVERHEAD_LIMIT:.0%}", kind="wall")
        out["variants"][label] = dict(
            streams={on: [r["warm"]] + r["rounds"] for on, r in runs.items()},
            ticks={on: r["ticks"] for on, r in runs.items()},
            compile_counts={on: r["compile_counts"]
                            for on, r in runs.items()},
            digest=digest, occupancy=occ, overhead=ratio - 1)
        del runs
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="where the engines run (default cuda)")
    args = parser.parse_args(argv)
    from k8s_dra_driver_tpu_torch.models.llama import init_params

    dev = gate_device(args.device)
    config = model_config(dev)
    emit = lambda line: print(line, flush=True)  # noqa: E731
    out = run(init_params(config, seed=0, device=dev), config, dev, emit)
    failures = out["gates"].failures()
    if failures:
        print(f"kv smoke: {len(failures)} gate(s) failed",
              file=sys.stderr)
        return 1
    print("kv smoke: the KV ledger is a pure observer — tokens, ticks, "
          "and compile counts unchanged; digest self-consistent under "
          "churn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
