#!/usr/bin/env python3
"""Compute-telemetry zero-cost smoke on the PyTorch port.

Twin of ``tools/run_compute_smoke.py`` (``make computesmoke``) over
``k8s_dra_driver_tpu_torch``: the same fixed-seed serving profile, pool,
gates, ``TPU_DRA_COMPUTE_SMOKE_*`` variables, printed lines and exit
codes. The profile is driven through a real ``DecodeEngine`` twice per
quantization variant (bf16 / int8 / kvq) -- compute plane unobserved (no
ComputeTelemetry) vs observed (ComputeTelemetry attached, the registry
scraped between rounds):

1. **Token streams identical** ON vs OFF, warm run and every repeat.
2. **Tick counts identical** ON vs OFF.
3. **Compile-once unchanged** in both runs: exactly one decode step and
   one prefill chunk. On the card the engine captures each step as a
   CUDA graph and the ``CompileLedger`` times the capture as the build.
4. **Ledger exact** ON: the CompileLedger's per-program build counts
   equal the engine's own ``compile_counts``, zero recompiles after the
   warm horizon (marked after the warm drive), the roofline windows
   saw the steady-state steps, and /debug/compute's document is
   JSON-serializable.
5. **Wall-clock tripwire**: best-of-N ON within
   ``TPU_DRA_COMPUTE_SMOKE_OVERHEAD`` (default 50%) of OFF.

``run(params, config, device)`` returns the decisions (streams, ticks,
``compile_counts`` and the ledger's builds per variant) and the gates,
each a deterministic gate or a wall-clock tripwire; ``main()`` prints as
the reference does. The tool runs on the card unless ``--device cpu``
is given; without a card it raises.

Exit 0 = all gates pass; 1 = a gate failed. Run from the repo root:
``python tools/run_compute_smoke_torch.py [--device cpu]``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _gate_torch import Gates, gate_device, model_config  # noqa: E402

OVERHEAD_LIMIT = float(
    os.environ.get("TPU_DRA_COMPUTE_SMOKE_OVERHEAD", "0.50")
)
SEED = int(os.environ.get("TPU_DRA_COMPUTE_SMOKE_SEED", "1234"))
N_NEW = 12
REPEATS = 5
ONES = {"decode_step": 1, "prefill_chunk": 1}


def build_engine(params, config, quant_kv, device):
    from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine

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
    import numpy as np

    rng = np.random.RandomState(SEED)
    base = rng.randint(0, vocab_size, size=16).tolist()
    tails = [
        rng.randint(0, vocab_size, size=int(n)).tolist()
        for n in rng.randint(1, 14, size=4)
    ]
    return [base + t for t in tails] * 2


def check_ledger(gate, label, telemetry, eng) -> dict:
    snap = telemetry.ledger.snapshot()
    counts = dict(eng.compile_counts)
    gate(
        all(
            snap["builds"].get(program) == counts.get(program)
            for program in ("decode_step", "prefill_chunk")
        ),
        f"{label}: CompileLedger builds == engine compile_counts "
        f"({ {p: snap['builds'].get(p) for p in counts} } == {counts})",
    )
    gate(
        not snap["recompilesSinceWarm"],
        f"{label}: zero recompiles after the warm horizon "
        f"({snap['recompilesSinceWarm']})",
    )
    timed = [
        r for r in snap["records"]
        if r["replica"] and r["compileS"] is not None
        and r["flops"] is not None
    ]
    gate(
        len(timed) == 2,
        f"{label}: both engine programs carry build wall time + cost "
        f"estimate ({len(timed)} timed record(s))",
    )
    debug = telemetry.compute_debug()
    roofs = debug["programs"].get("decode_step", {}).get("r0", {})
    gate(
        (roofs.get("steps") or 0) > 0
        and roofs.get("boundBy") in ("memory", "compute"),
        f"{label}: decode roofline window saw steady-state steps "
        f"({roofs.get('steps')} step(s), {roofs.get('boundBy')}-bound)",
    )
    hbm = debug["hbm"].get("r0", {})
    gate(
        hbm.get("totalBytes")
        == hbm.get("weightsBytes", 0) + hbm.get("kvPoolBytes", 0),
        f"{label}: HBM decomposition sums exactly "
        f"({hbm.get('totalBytes')} B)",
    )
    try:
        json.dumps(debug)
        gate(True, f"{label}: /debug/compute doc JSON-clean")
    except (TypeError, ValueError) as e:
        gate(False, f"{label}: /debug/compute not JSON-serializable: {e}")
    return dict(builds=dict(snap["builds"]),
                recompiles=snap["recompilesSinceWarm"], timed=len(timed))


def run(params, config, device, emit=print) -> dict:
    """Every gate of the smoke on ``params`` (a float parameter tree on
    ``device``); returns the gates, every engine it built (``engines``)
    and per variant its decisions."""
    import torch

    from k8s_dra_driver_tpu_torch.models.compute_telemetry import (
        ComputeTelemetry,
        device_peaks,
    )
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    gate = Gates(emit)
    out = {"gates": gate, "variants": {}, "engines": []}
    prompts = churn_prompts(config.vocab_size)
    # The card's row of the peak table, or the CPU's calibrated fake (the
    # reference's row for its CPU backend).
    peaks = device_peaks(
        "cpu" if torch.device(device).type == "cpu" else None)
    for label, p, qkv in (
        ("bf16", params, False),
        ("int8", quantize_params(params), False),
        ("kvq", params, True),
    ):
        runs = {}
        for on in (False, True):
            eng = build_engine(p, config, qkv, device)
            out["engines"].append(eng)
            registry = telemetry = None
            if on:
                registry = Registry()
                telemetry = ComputeTelemetry(registry, peaks=peaks)
                telemetry.attach(eng, replica="r0", claim_uid="uid-smoke")
            warm = drive(eng, prompts)   # builds both programs
            if on:
                telemetry.mark_warm()    # steady state must not rebuild
                registry.render()        # first scrape: hook + deltas
            times, rounds = [], []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                tokens = drive(eng, prompts)
                times.append(time.perf_counter() - t0)
                rounds.append(tokens)
                if on:
                    registry.render()
            runs[on] = {
                "warm": warm, "rounds": rounds,
                "ticks": eng.stats.ticks, "best": min(times),
                "eng": eng, "registry": registry,
                "telemetry": telemetry,
                "compile_counts": dict(eng.compile_counts),
            }

        off, on_run = runs[False], runs[True]
        gate(off["warm"] == on_run["warm"]
             and off["rounds"] == on_run["rounds"],
             f"{label}: token streams identical with compute telemetry "
             "ON vs OFF")
        gate(off["ticks"] == on_run["ticks"],
             f"{label}: tick counts identical ON vs OFF "
             f"({on_run['ticks']} vs {off['ticks']})")
        for tag, r in (("OFF", off), ("ON", on_run)):
            counts = r["compile_counts"]
            gate(counts == ONES,
                 f"{label}: compile-once unchanged {tag}: {counts}")
        ledger = check_ledger(gate, label, on_run["telemetry"],
                              on_run["eng"])
        text = on_run["registry"].render()
        gate("tpu_dra_compute_compiles_total" in text
             and "tpu_dra_compute_mfu_ratio" in text
             and "tpu_dra_compute_hbm_bytes" in text,
             f"{label}: tpu_dra_compute_* families render")
        on_run["telemetry"].close()

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
            ledger=ledger, overhead=ratio - 1)
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
        print(f"compute smoke: {len(failures)} gate(s) failed",
              file=sys.stderr)
        return 1
    print("compute smoke: the compute telemetry is a pure observer — "
          "tokens, ticks, and compile counts unchanged; ledger exact, "
          "zero recompiles past the warm horizon")
    return 0


if __name__ == "__main__":
    sys.exit(main())
