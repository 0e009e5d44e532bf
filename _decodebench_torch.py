"""The fleet-gateway bench on the PyTorch port.

Twin of ``_decodebench.py``'s ``run_gateway_bench`` and ``spread_flags``
over ``k8s_dra_driver_tpu_torch``: the same arguments, the same seeded
traffic, shuffled arrival and pool sizing, the same virtual tick clock,
and the same returned metric names and ``detail`` keys. The rest of
``_decodebench.py`` (the decode, prefill and speculative benches) has no
twin here yet.

``run_gateway_bench`` runs on the card unless ``device="cpu"`` is given;
without a card it raises and never falls back. It takes the parameters
it serves as ``params=`` (a float tree on ``device``); without them it
initialises the preset from seed 0 on ``device``, as the reference does
from ``PRNGKey(0)``.

It imports nothing of JAX.
"""

import time


def spread_flags(metrics, rel: float = 0.02) -> list:
    """Flag any ``*_decode_toks_*``, ``*_prefill_toks_*`` or
    ``*_gateway_rps_*`` metric whose repeat spread exceeds ``rel`` of
    its mean -- the signature of per-shape recompilation or, for the
    fleet bench, of routing nondeterminism. Mutates the dicts in place
    (``spread_flag: true``) and returns the flagged metric names."""
    flagged = []
    for m in metrics:
        name = m.get("metric", "")
        if ("_decode_toks_" not in name
                and "_prefill_toks_" not in name
                and "_gateway_rps_" not in name):
            continue
        spread = m.get("spread")
        value = m.get("value")
        if spread is None or not value:
            continue
        if spread > rel * value:
            m["spread_flag"] = True
            flagged.append(name)
    return flagged


def run_gateway_bench(
    preset: str = "160m",
    n_replicas: int = 2,
    batch_slots: int = 4,
    n_requests: int = 64,
    n_systems: int = 8,
    system_len: int = 256,
    tail_len: int = 32,
    max_new_tokens: int = 16,
    block_size: int = 64,
    num_blocks: int | None = None,
    quant: bool = False,
    quant_kv: bool = False,
    seed: int = 0,
    repeats: int = 2,
    params=None,
    config=None,
    device=None,
    engines=None,
    vocab_size: int | None = None,
) -> dict:
    """The fleet-gateway acceptance pair: shared-prefix traffic served
    through ``n_replicas`` ``DecodeEngine`` replicas twice --
    prefix-affinity routing against the round-robin baseline --
    reporting fleet requests/s at the measured p99 token latency, the
    engine-level prefix hit rate and the shed rate. ``value`` is the
    affinity fleet req/s; the acceptance gate
    (``tools/run_gateway_smoke_torch.py``) is the tick-normalized
    ``speedup_rps_ticks >= 1.3`` at equal-or-lower p99 token latency, not
    the wall-clock ``speedup_rps``, which is reported beside it.

    ``config`` overrides the preset's config (the card runs the 8b
    widths cut in depth under the name ``preset``); ``params`` must then
    be of that config. ``engines``, a list where given, receives each
    replica engine with its warm-up's stats (the stats are reset after
    the warm-up), so that a caller can count what every engine ran.
    ``vocab_size`` is the range the traffic's tokens are drawn from,
    default the model's vocabulary: with no EOS the ticks depend on the
    traffic alone, so a model of another vocabulary serves the same
    traffic (and takes the same ticks) when it is given the first one's.

    Per-replica pools are sized so that one replica's cache cannot hold
    every system prompt but can hold its consistent-hash share: affinity
    keeps each replica's working set inside its pool while round-robin
    makes every replica churn through all of them.
    """
    import numpy as np
    import torch

    from k8s_dra_driver_tpu_torch import resolve_device
    from k8s_dra_driver_tpu_torch.models.llama import PRESETS, init_params
    from k8s_dra_driver_tpu_torch.models.moe import MOE_PRESETS
    from k8s_dra_driver_tpu_torch.models.moe import init_params as moe_init
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params
    from k8s_dra_driver_tpu_torch.models.serving import (
        DecodeEngine,
        ServingStats,
    )
    from k8s_dra_driver_tpu_torch.serving_gateway import (
        AdmissionPolicy,
        Router,
        ServingGateway,
    )

    dev = resolve_device(device)
    is_moe = preset in MOE_PRESETS
    if config is None:
        config = MOE_PRESETS[preset] if is_moe else PRESETS[preset]
    if params is None:
        init = moe_init if is_moe else init_params
        params = init(config, seed=0, device=dev)
    if quant:
        params = quantize_params(params)

    vocab = vocab_size or config.vocab_size
    if vocab > config.vocab_size:
        raise ValueError(f"traffic vocabulary {vocab} exceeds the model's "
                         f"{config.vocab_size}")
    rng = np.random.RandomState(seed)
    systems = [
        rng.randint(0, vocab, size=system_len).tolist()
        for _ in range(n_systems)
    ]
    prompts = [
        systems[i % n_systems]
        + rng.randint(0, vocab, size=tail_len).tolist()
        for i in range(n_requests)
    ]
    # Shuffled arrival order: round-robin over an interleaved system
    # sequence would otherwise pin system s to replica (s mod n_replicas)
    # by accident -- perfect affinity for free.
    rng.shuffle(prompts)
    span = system_len + tail_len + max_new_tokens
    if num_blocks is None:
        live = batch_slots * (-(-span // block_size))
        sys_blocks = n_systems * (system_len // block_size)
        # Between "my hash share fits" (sys_blocks / n_replicas) and
        # "everything fits" (sys_blocks): the bench's fleet effect.
        num_blocks = live + max(
            -(-sys_blocks // n_replicas) + 2,
            int(sys_blocks * 1.5 / n_replicas),
        )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def one_run(policy: str) -> dict:
        # Engines and gateway share a virtual clock that advances one unit
        # per gateway tick: every latency and throughput statistic is in
        # ticks -- one decode step plus at most one prefill chunk per
        # engine -- and exactly reproducible on a noisy host. A
        # round-robin tick carries more prefill work than an affinity
        # tick (cold prompts), so the normalization understates the
        # affinity advantage; wall time is measured beside it.
        clock_box = [0.0]

        def clk():
            return clock_box[0]

        replicas = [
            DecodeEngine(
                params, config, batch_slots=batch_slots,
                num_blocks=num_blocks, block_size=block_size,
                max_seq_len=span, prefill_chunk=block_size,
                # One prefill chunk per engine per tick is the clock's
                # cost unit: the packed prefill would let a tick carry up
                # to prefill_batch chunks for free, discounting exactly
                # the prefill work round-robin pays more of. The bench
                # measures routing, so its engines run the serial prefill.
                prefill_batch=1,
                quantize_cache=quant_kv, clock=clk, device=dev,
            )
            for _ in range(n_replicas)
        ]
        gw = ServingGateway(
            router=Router(
                policy=policy, block_size=block_size,
                affinity_blocks=system_len // block_size,
                # Throughput profile: affinity must not spill under the
                # submit-everything burst.
                saturation_depth=10 ** 6, seed=seed,
            ),
            # No shedding, no deadline expiry: every request completes or
            # the bench is invalid.
            admission_policy=AdmissionPolicy(
                shed_watermark=10 ** 9, hard_watermark=10 ** 9,
                max_queue_delay_s={
                    lc: 10 ** 9
                    for lc in ("realtime", "interactive", "batch")
                },
            ),
            node_name="bench",
            clock=clk,
        )
        for i, eng in enumerate(replicas):
            gw.add_replica(eng, f"bench-{policy}-{i}")
        # Build (on the card: capture) each replica's two steps outside
        # the timed window; stats reset after.
        for eng in replicas:
            eng.submit(prompts[0][: block_size // 2], max_new_tokens=2)
            eng.run()
            if engines is not None:
                engines.append((eng, eng.stats))
            eng.stats = ServingStats()
        reqs = [
            gw.submit(p, max_new_tokens, latency_class="interactive")
            for p in prompts
        ]
        sync()
        t0 = time.perf_counter()
        while gw._live:
            gw.tick()
            clock_box[0] += 1.0
        sync()
        wall = time.perf_counter() - t0
        failed = [r for r in reqs if r.state != "finished"]
        if failed:
            raise RuntimeError(
                f"gateway bench lost {len(failed)} request(s) "
                f"(policy {policy})"
            )
        for eng in replicas:
            eng.assert_no_leaks()
        intervals = sorted(
            t for eng in replicas for t in eng.stats.token_interval_s
        )
        prompt_tokens = sum(e.stats.prompt_tokens for e in replicas)
        hit_tokens = sum(e.stats.prefix_hit_tokens for e in replicas)
        ticks = clock_box[0]
        tick_ms = wall / max(ticks, 1) * 1e3
        p99_ticks = (
            intervals[min(len(intervals) - 1, int(0.99 * len(intervals)))]
            if intervals else 0.0
        )
        return {
            "rps": n_requests / wall,
            "ticks": ticks,
            "rp1k_ticks": n_requests / ticks * 1e3,
            "tick_ms": tick_ms,
            "p99_token_ticks": p99_ticks,
            "p99_token_ms": p99_ticks * tick_ms,
            "hit_rate": hit_tokens / max(prompt_tokens, 1),
            "shed": gw.counters["shed"],
            "affinity_hit_rate": gw.affinity_hit_rate(),
            "compile_counts": [dict(e.compile_counts) for e in replicas],
            "evictions": sum(e.allocator.evictions for e in replicas),
        }

    base = one_run("round-robin")
    runs = [one_run("affinity") for _ in range(max(1, repeats))]
    runs.sort(key=lambda r: r["rps"])
    hot = runs[len(runs) // 2]
    spread = (runs[-1]["rps"] - runs[0]["rps"]) / 2
    tags = "".join(
        t for t, on in (("-int8", quant), ("-kvq", quant_kv)) if on
    )
    family = "mixtral" if is_moe else "llama3"
    return {
        "metric": (
            f"{family}_{preset}{tags}_gateway_rps_r{n_replicas}"
            f"_b{batch_slots}"
        ),
        "value": round(hot["rps"], 2),
        "unit": "requests_per_s",
        "vs_baseline": 0.0,
        "repeats": max(1, repeats),
        "spread": round(spread, 2),
        "detail": {
            "n_replicas": n_replicas,
            "n_requests": n_requests,
            "n_systems": n_systems,
            "num_blocks_per_replica": num_blocks,
            # The acceptance pair (gate: >= 1.3x at equal-or-lower p99
            # token latency). speedup_rps_ticks is the deterministic
            # tick-normalized ratio; speedup_rps the wall-clock one.
            "speedup_rps": round(
                hot["rps"] / max(base["rps"], 1e-9), 3
            ),
            "speedup_rps_ticks": round(
                base["ticks"] / max(hot["ticks"], 1), 3
            ),
            "ticks": hot["ticks"],
            "ticks_all": [r["ticks"] for r in runs],
            "ticks_round_robin": base["ticks"],
            "rps_round_robin": round(base["rps"], 2),
            "p99_token_ticks": hot["p99_token_ticks"],
            "p99_token_ticks_round_robin": base["p99_token_ticks"],
            "p99_token_ms": round(hot["p99_token_ms"], 2),
            "p99_token_ms_round_robin": round(base["p99_token_ms"], 2),
            "prefix_hit_rate": round(hot["hit_rate"], 4),
            "prefix_hit_rate_round_robin": round(base["hit_rate"], 4),
            "affinity_hit_rate": round(hot["affinity_hit_rate"], 4),
            "shed_rate": round(hot["shed"] / n_requests, 4),
            "evictions": hot["evictions"],
            "evictions_round_robin": base["evictions"],
            "compile_counts": hot["compile_counts"],
        },
    }
