#!/usr/bin/env python3
"""Request-observability overhead smoke on the PyTorch port.

Twin of ``tools/run_trace_smoke.py`` (``make tracesmoke``) over
``k8s_dra_driver_tpu_torch``: the same fixed-seed serving profile, pool,
gates, ``TPU_DRA_TRACE_SMOKE_*`` variables, printed lines and exit
codes. The profile is driven through a gateway over a real
``DecodeEngine`` twice -- telemetry OFF (``telemetry=None``) and ON
(request timelines + tick profiler + SLO histograms + tracing):

1. **Token streams identical** ON vs OFF.
2. **Tick counts identical** ON vs OFF: the tick-normalized req/s agree
   to 0%.
3. **Compile-once unchanged** with tracing ON: exactly one decode step
   and one prefill chunk (on the card: one CUDA-graph capture of each).
4. **Timelines complete**: every submitted request in the ON run ends
   sealed in /debug/requests.
5. **Wall-clock tripwire**: best-of-N drained-run wall time ON within
   ``TPU_DRA_TRACE_SMOKE_OVERHEAD`` (default 50%) of OFF.

``run(params, config, device)`` returns the decisions (streams, ticks,
``compile_counts``, sealed timelines) and the gates, each a
deterministic gate or a wall-clock tripwire; ``main()`` prints as the
reference does. The tool runs on the card unless ``--device cpu`` is
given; without a card it raises.

Exit 0 = all gates pass; 1 = a gate failed. Run from the repo root:
``python tools/run_trace_smoke_torch.py [--device cpu]``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _gate_torch import Gates, gate_device, model_config  # noqa: E402

OVERHEAD_LIMIT = float(
    os.environ.get("TPU_DRA_TRACE_SMOKE_OVERHEAD", "0.50"))
SEED = int(os.environ.get("TPU_DRA_TRACE_SMOKE_SEED", "1234"))
N_REQUESTS = 24
N_NEW = 4
REPEATS = 5
ONES = {"decode_step": 1, "prefill_chunk": 1}


def build(params, config, telemetry_on, device):
    from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine
    from k8s_dra_driver_tpu_torch.serving_gateway import (
        Router,
        ServingGateway,
        ServingTelemetry,
    )
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    box = [0.0]
    registry = Registry()
    telemetry = ServingTelemetry(registry) if telemetry_on else None
    gw = ServingGateway(
        registry,
        router=Router(policy="affinity", block_size=16,
                      affinity_blocks=2, seed=0),
        node_name="trace-smoke",
        clock=lambda: box[0],
        telemetry=telemetry,
    )
    eng = DecodeEngine(
        params, config, batch_slots=4, num_blocks=26, block_size=8,
        max_seq_len=48, prefill_chunk=8, prefill_batch=4,
        clock=lambda: box[0], device=device,
    )
    gw.add_replica(eng, "r0")
    return gw, eng, telemetry, box


def drive(gw, box, prompts):
    handles = [gw.submit(p, N_NEW, latency_class="interactive")
               for p in prompts]
    ticks0 = gw.ticks
    for _ in range(100000):
        if all(h.state in ("finished", "failed") for h in handles):
            break
        box[0] += 0.01
        gw.tick()
    else:
        raise RuntimeError("trace smoke: gateway did not drain")
    tokens = [tuple(h.engine_req.tokens) for h in handles
              if h.state == "finished"]
    return tokens, gw.ticks - ticks0, len(handles)


def run(params, config, device, emit=print) -> dict:
    """Every gate of the smoke on ``params`` (a float parameter tree on
    ``device``); returns the gates, both runs' engines (``engines``) and
    their decisions."""
    import numpy as np

    gate = Gates(emit)
    rng = np.random.RandomState(SEED)
    prompts = [
        rng.randint(0, config.vocab_size, size=int(n)).tolist()
        for n in rng.randint(5, 24, size=N_REQUESTS)
    ]

    runs = {}
    for on in (False, True):
        gw, eng, telemetry, box = build(params, config, on, device)
        tokens, ticks, submitted = drive(gw, box, prompts)  # warm: builds
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            tokens_r, ticks_r, _ = drive(gw, box, prompts)
            times.append(time.perf_counter() - t0)
            if tokens_r != tokens:
                gate(False, f"telemetry={on}: repeat run token streams "
                            "diverge (nondeterministic scheduler)")
        runs[on] = {
            "tokens": tokens, "ticks": ticks, "best": min(times),
            "engine": eng, "telemetry": telemetry,
            "submitted": submitted * (REPEATS + 1),
            "compile_counts": dict(eng.compile_counts),
        }

    off, on = runs[False], runs[True]
    gate(off["tokens"] == on["tokens"],
         "token streams identical with telemetry ON vs OFF")
    gate(off["ticks"] == on["ticks"],
         f"tick counts identical ON vs OFF ({on['ticks']} vs "
         f"{off['ticks']}): tick-normalized req/s within 0% (<= 3% bar)")
    counts = on["compile_counts"]
    gate(counts == ONES,
         f"compile-once unchanged with tracing ON: {counts}")

    telemetry = on["telemetry"]
    docs = telemetry.timelines()
    sealed = sum(1 for d in docs if d["outcome"])
    # The ring is bounded; all submissions here fit inside it.
    gate(sealed == min(on["submitted"], len(docs)) and len(docs) > 0,
         f"every submitted request sealed a timeline "
         f"({sealed} sealed, {on['submitted']} submitted)")
    summary = telemetry.profiler.summary()
    gate("gateway/dispatch" in summary["phaseSeconds"]
         and "engine/decode" in summary["phaseSeconds"],
         "tick profiler recorded gateway and engine phases")

    ratio = on["best"] / max(off["best"], 1e-9)
    emit(f"trace smoke wall: best-of-{REPEATS} {on['best']:.3f}s ON vs "
         f"{off['best']:.3f}s OFF ({(ratio - 1):+.1%}, limit "
         f"+{OVERHEAD_LIMIT:.0%} CPU tripwire; the 3% TPU bar runs with "
         "TPU_DRA_TRACE_SMOKE_OVERHEAD=0.03)")
    gate(ratio <= 1.0 + OVERHEAD_LIMIT,
         f"wall-clock overhead {(ratio - 1):+.1%} within "
         f"+{OVERHEAD_LIMIT:.0%}", kind="wall")
    return dict(
        gates=gate, engines=[r["engine"] for r in runs.values()],
        streams={k: r["tokens"] for k, r in runs.items()},
        ticks={k: r["ticks"] for k, r in runs.items()},
        compile_counts={k: r["compile_counts"] for k, r in runs.items()},
        sealed=sealed, submitted=on["submitted"], timelines=len(docs),
        overhead=ratio - 1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default=None,
                        help="where the engine runs (default cuda)")
    args = parser.parse_args(argv)
    from k8s_dra_driver_tpu_torch.models.llama import init_params

    dev = gate_device(args.device)
    config = model_config(dev)
    emit = lambda line: print(line, flush=True)  # noqa: E731
    out = run(init_params(config, seed=0, device=dev), config, dev, emit)
    failures = out["gates"].failures()
    if failures:
        print(f"trace smoke: {len(failures)} gate(s) failed",
              file=sys.stderr)
        return 1
    print("trace smoke: observability is a pure observer — tokens, "
          "ticks, and compile counts unchanged; overhead within limit")
    return 0


if __name__ == "__main__":
    sys.exit(main())
