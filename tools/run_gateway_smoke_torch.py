#!/usr/bin/env python3
"""Fleet-gateway smoke on the PyTorch port.

Twin of ``tools/run_gateway_smoke.py`` (``make gatewaybench``) over
``k8s_dra_driver_tpu_torch``: the same arguments, gates, printed lines
and exit codes. Fixed-seed shared-prefix traffic runs through two real
``DecodeEngine`` replicas (``_decodebench_torch.run_gateway_bench``),
prefix-affinity routing against the round-robin baseline, with the
``tiny`` preset on the CPU (the 8b preset's widths cut to 2 layers on
the card), plus a drain over scripted engines.

Gates, on the deterministic tick-normalized numbers (one gateway tick =
one decode step + at most one prefill chunk per engine; a round-robin
tick carries more prefill work, so the normalization understates the
affinity advantage):

1. affinity fleet req/s >= 1.3x round-robin, at equal-or-lower p99
   token latency, with zero sheds and zero lost requests, and a higher
   engine-level prefix hit rate;
2. each replica engine builds exactly two steps (on the card: captures
   two CUDA graphs);
3. tick counts identical across repeats (the routing-nondeterminism
   tripwire; a wall-clock spread past 2% is a warning only);
4. a mid-traffic replica drain re-routes its queued requests and loses
   zero admitted requests (scripted engines).

``run(params, config, device)`` returns the bench's result, the gates
and the drain's decisions; ``main()`` prints as the reference does. The
tool runs on the card unless ``--device cpu`` is given; without a card
it raises, and never falls back.

Exit 0 = all gates pass; 1 = a gate failed. Run from the repo root:
``python tools/run_gateway_smoke_torch.py [--device cpu]``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _gate_torch import CARD_PRESET, Gates, gate_device, model_config  # noqa: E402

# The reference smoke's bench arguments. Its traffic is drawn from the
# ``tiny`` vocabulary (256 tokens) wherever the tool runs: on the card the
# 8b widths serve the same prompts, so the tick counts are the CPU's.
# Drawn from the 8b vocabulary, the same seed gives other prompts, whose
# systems split otherwise over the two replicas' hash ranges.
TRAFFIC_VOCAB = 256
BENCH_ARGS = dict(n_replicas=2, batch_slots=4, n_requests=128, n_systems=16,
                  system_len=64, tail_len=8, max_new_tokens=4, block_size=16,
                  num_blocks=52, seed=0, repeats=2)
ONES = {"decode_step": 1, "prefill_chunk": 1}


def bench_gate(params, config, device, gate, emit, engines=None) -> dict:
    """The bench at ``BENCH_ARGS`` on ``params`` and its gates; returns
    the bench's result. ``engines`` (a list) receives each replica engine
    with its warm-up's stats."""
    import torch

    from _decodebench_torch import run_gateway_bench, spread_flags

    preset = "tiny" if torch.device(device).type != "cuda" else CARD_PRESET
    r = run_gateway_bench(preset=preset, params=params, config=config,
                          device=device, engines=engines,
                          vocab_size=TRAFFIC_VOCAB, **BENCH_ARGS)
    d = r["detail"]
    emit(
        f"gateway {r['metric']}: {r['value']} req/s affinity vs "
        f"{d['rps_round_robin']} round-robin (wall "
        f"{d['speedup_rps']}x, tick-normalized "
        f"{d['speedup_rps_ticks']}x over {d['ticks']:.0f} vs "
        f"{d['ticks_round_robin']:.0f} ticks), p99 token "
        f"{d['p99_token_ticks']} vs "
        f"{d['p99_token_ticks_round_robin']} ticks, hit rate "
        f"{d['prefix_hit_rate']} vs {d['prefix_hit_rate_round_robin']}"
    )
    gate(d["speedup_rps_ticks"] >= 1.3,
         f"affinity speedup {d['speedup_rps_ticks']}x >= 1.3x "
         "round-robin (tick-normalized)")
    gate(
        d["p99_token_ticks"] <= d["p99_token_ticks_round_robin"],
        f"affinity p99 token {d['p99_token_ticks']} ticks <= "
        f"round-robin {d['p99_token_ticks_round_robin']}",
    )
    gate(d["shed_rate"] == 0, "zero sheds on the throughput profile")
    gate(all(c == ONES for c in d["compile_counts"]),
         f"compile-once per replica: {d['compile_counts']}")
    gate(d["prefix_hit_rate"] > d["prefix_hit_rate_round_robin"],
         "affinity raises the engine-level prefix hit rate")
    gate(len(set(d["ticks_all"])) == 1,
         f"tick counts identical across repeats: {d['ticks_all']}")
    if spread_flags([r]):
        emit(
            f"WARNING: gateway wall-clock rps spread {r['spread']} "
            "exceeds 2% of the mean (host is time-shared; the gated "
            "numbers are tick-normalized)"
        )
    return r


def drain_gate(gate) -> dict:
    """Scripted-engine drain: zero admitted-request loss, queued requests
    re-routed, the drained replica removable mid-traffic."""
    from k8s_dra_driver_tpu_torch.serving_gateway import Router, ServingGateway
    from k8s_dra_driver_tpu_torch.serving_gateway.sim import (
        ScriptedEngine,
        shared_prefix_prompts,
    )

    gw = ServingGateway(
        router=Router(policy="affinity", block_size=16,
                      affinity_blocks=2, seed=0),
        node_name="smoke",
    )
    engines = [ScriptedEngine(batch_slots=2, prefill_chunk=16)
               for _ in range(3)]
    for i, e in enumerate(engines):
        gw.add_replica(e, f"smoke-{i}")
    reqs = [
        gw.submit(p, 4, latency_class="interactive")
        for p in shared_prefix_prompts(36, n_systems=6, system_len=32,
                                       tail_len=4, seed=1)
    ]
    for _ in range(3):
        gw.tick()
    rerouted = gw.drain_replica("smoke-1", remove=True,
                                reason="smoke drain")
    gw.run()
    lost = [r for r in reqs if r.state != "finished"]
    gate(not lost, f"drain loses zero requests ({len(lost)} lost, "
                   f"{rerouted} re-routed)")
    for e in engines:
        e.assert_no_leaks()
    gate(True, "all scripted engines idle and leak-free after drain")
    return dict(lost=len(lost), rerouted=rerouted,
                states=[r.state for r in reqs])


def run(params, config, device, emit=print, engines=None) -> dict:
    """Every gate of the smoke on ``params`` (a float parameter tree of
    ``config`` on ``device``), each gate's line through ``emit`` as the
    reference prints it. Returns the gates, the bench's result and the
    drain's decisions; ``engines`` as ``bench_gate`` takes it."""
    gate = Gates(emit=emit)
    bench = bench_gate(params, config, device, gate, emit, engines)
    drain = drain_gate(gate)
    return dict(gates=gate, bench=bench, drain=drain)


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
        print(f"gateway smoke: {len(failures)} gate(s) FAILED",
              file=sys.stderr, flush=True)
        return 1
    print("gateway smoke: all gates passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
