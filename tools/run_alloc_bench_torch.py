#!/usr/bin/env python3
"""Allocator throughput + fragmentation bench on the PyTorch port.

Twin of ``tools/run_alloc_bench.py`` (``make allocbench``) over
``k8s_dra_driver_tpu_torch``'s ``kube/allocator.py``, ``kube/client.py``
and ``tpulib`` topology. It imports nothing of JAX or of the JAX
package. The same two phases, seeded and deterministic, with the same
``PROFILES``, gates and exit codes:

1. **Throughput**: a fleet of v5p slices with pending claims solving
   under churn (deallocations and periodic ResourceSlice deltas); the
   incremental solver's solves/sec against a from-scratch baseline
   (``incremental=False``). GATE: the speedup is at least the profile's
   ``min_speedup``.
2. **Fragmentation**: first-fit (``placement_scoring=False``) against
   the topology scorer over one seeded churn schedule with periodic
   large-gang probes, ``largest_free_submesh`` sampled every step. GATE:
   the scorer admits at least as many probes as first-fit, and
   ``min_extra_probes`` more.

A third section, **h100**, is reported and gated by nothing: the same
TPU fleet with a pool of H100 nodes beside it (``h100`` chips, 8 a node,
``ici_dims`` 0, published from the port's ``FakeChipLib``), and one
churn of v5p claims and whole-GPU claims through one incremental
allocator. Both kinds of claim take their sizes from ``claim_mix``, the
reference tool's own mix (1, 4 or 8 devices: on an 8-GPU node one GPU,
half a node, a node), and a claim goes to the H100 pool with the pool's
share of the fleet's devices. No public trace of a mixed TPU and GPU
fleet backs that split, so the section is illustrative: it shows that
the allocator places GPU claims beside TPU ones, not how a real fleet
fares. The two TPU sections stay comparable with the reference's
document, key for key.

The document is printed, and written only to an explicit ``--out``:
``ALLOC_r01.json`` is the reference's record, never this tool's. Exit 0
= all gates passed, 1 = a gate failed.

Run from the repo root: ``python tools/run_alloc_bench_torch.py --profile
smoke`` (seconds on a CPU) or ``--profile full``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DRIVER = "tpu.google.com"
CLASS_EXPR = "device.attributes['tpu.google.com'].type == 'chip'"

PROFILES = {
    # devices = slices * sx*sy*sz
    "full": {
        "slices": 40, "shape": (16, 4, 4), "claims": 1000,
        "scratch_sample": 15, "delta_every": 100, "min_speedup": 10.0,
        "frag_shape": (8, 8, 1), "frag_steps": 240, "frag_probe": 16,
        "frag_probe_every": 8, "min_extra_probes": 1,
        "h100_nodes": 128,
    },
    "smoke": {
        "slices": 8, "shape": (4, 4, 2), "claims": 100,
        "scratch_sample": 8, "delta_every": 25, "min_speedup": 3.0,
        "frag_shape": (8, 8, 1), "frag_steps": 120, "frag_probe": 16,
        "frag_probe_every": 8, "min_extra_probes": 0,
        "h100_nodes": 16,
    },
}


def _slice_obj(api, slice_id: int, shape) -> dict:
    sx, sy, sz = shape
    devices = []
    i = 0
    for x in range(sx):
        for y in range(sy):
            for z in range(sz):
                devices.append({
                    "name": f"tpu-{i}",
                    "basic": {"attributes": {
                        "type": {"string": "chip"},
                        "coord": {"string": f"{x},{y},{z}"},
                        "sliceId": {"string": f"slice-{slice_id:03d}"},
                        "healthy": {"bool": True},
                        "generation": {"string": "v5p"},
                    }},
                })
                i += 1
    return {
        "apiVersion": "resource.k8s.io/v1beta1",
        "kind": "ResourceSlice",
        "metadata": {"name": f"bench-pool-{slice_id:03d}"},
        "spec": {
            "driver": DRIVER,
            "pool": {
                "name": f"bench-pool-{slice_id:03d}",
                "generation": 1,
                "resourceSliceCount": 1,
            },
            "devices": devices,
        },
    }


def build_cluster(profile):
    from k8s_dra_driver_tpu_torch.kube import FakeKubeClient
    from k8s_dra_driver_tpu_torch.kube.resourceapi import ResourceApi

    client = FakeKubeClient()
    # The bench publishes wire objects directly (the controller path is
    # benched elsewhere); schema validation of 10k devices per publish
    # is not the system under test.
    client.validate_schemas = False
    api = ResourceApi.discover(client)
    for s in range(profile["slices"]):
        client.create(api.slices, _slice_obj(api, s, profile["shape"]))
    return client, api


def make_allocator(client, registry=None, **kw):
    from k8s_dra_driver_tpu_torch.kube.allocator import ReferenceAllocator
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    return ReferenceAllocator(
        client,
        driver_name=DRIVER,
        device_classes={DRIVER: [CLASS_EXPR]},
        registry=registry or Registry(),
        **kw,
    )


def gang_claim(uid: str, count: int) -> dict:
    return {
        "metadata": {"name": f"wl-{uid}", "namespace": "bench", "uid": uid},
        "spec": {"devices": {"requests": [{
            "name": "r0",
            "deviceClassName": DRIVER,
            "count": count,
        }]}},
    }


def claim_mix(rng: random.Random, n: int) -> list[int]:
    """60% singles, 30% 2x2 gangs, 10% 8-gangs — the decode/train mix
    the north star implies."""
    return [
        1 if r < 0.6 else (4 if r < 0.9 else 8)
        for r in (rng.random() for _ in range(n))
    ]


def flip_slice_delta(client, api, slice_id: int, profile, flip: int):
    """Republish one slice with a toggled attribute — a real
    ResourceSlice delta (health transition shape), so the incremental
    run pays its invalidation cost honestly."""
    obj = _slice_obj(api, slice_id, profile["shape"])
    obj["spec"]["devices"][0]["basic"]["attributes"]["healthy"] = {
        "bool": flip % 2 == 0
    }
    existing = client.get(api.slices, obj["metadata"]["name"])
    obj["metadata"]["resourceVersion"] = (
        existing["metadata"]["resourceVersion"]
    )
    client.update(api.slices, obj)


def bench_throughput(profile, seed: int) -> dict:
    from k8s_dra_driver_tpu_torch.kube.allocator import AllocationError

    rng = random.Random(seed)
    client, api = build_cluster(profile)
    n_devices = profile["slices"] * (
        profile["shape"][0] * profile["shape"][1] * profile["shape"][2]
    )
    sizes = claim_mix(rng, profile["claims"])

    def churn_run(alloc) -> tuple[float, list[float], int]:
        """Solve every claim with ~30% random release churn and periodic
        slice deltas; returns (elapsed, per-solve latencies, unsats)."""
        live: list[str] = []
        latencies: list[float] = []
        unsat = 0
        deltas = 0
        t0 = time.monotonic()
        for i, count in enumerate(sizes):
            if i and i % profile["delta_every"] == 0:
                deltas += 1
                flip_slice_delta(
                    client, api, i % profile["slices"], profile, deltas
                )
            uid = f"uid-{i:04d}"
            t = time.monotonic()
            try:
                alloc.allocate(gang_claim(uid, count))
                live.append(uid)
            except AllocationError:
                unsat += 1
            latencies.append(time.monotonic() - t)
            if live and rng.random() < 0.3:
                alloc.deallocate(live.pop(rng.randrange(len(live))))
        elapsed = time.monotonic() - t0
        for uid in live:
            alloc.deallocate(uid)
        return elapsed, latencies, unsat

    inc = make_allocator(client)
    inc_elapsed, inc_lat, inc_unsat = churn_run(inc)
    inc_rate = len(sizes) / inc_elapsed

    # From-scratch baseline: same claim mix, sampled (a full 1k-claim
    # run at 10k devices re-filtering everything per solve would take
    # minutes and measure nothing new — rates are per-solve).
    scratch = make_allocator(client, incremental=False)
    sample = sizes[: profile["scratch_sample"]]
    t0 = time.monotonic()
    for i, count in enumerate(sample):
        try:
            scratch.allocate(gang_claim(f"uid-s{i:04d}", count))
        except AllocationError:
            pass
    scratch_elapsed = time.monotonic() - t0
    scratch_rate = len(sample) / scratch_elapsed

    lat_sorted = sorted(inc_lat)
    return {
        "devices": n_devices,
        "claims": len(sizes),
        "unsat": inc_unsat,
        "incremental_solves_per_sec": round(inc_rate, 2),
        "from_scratch_solves_per_sec": round(scratch_rate, 2),
        "from_scratch_sample": len(sample),
        "speedup": round(inc_rate / scratch_rate, 2),
        "p50_solve_seconds": round(statistics.median(inc_lat), 6),
        "p99_solve_seconds": round(
            lat_sorted[max(0, int(len(lat_sorted) * 0.99) - 1)], 6
        ),
        "index_rebuilds": inc.index.rebuilds,
        "index_generation": inc.index.generation,
    }


def bench_fragmentation(profile, seed: int) -> dict:
    """Seeded churn over one slice, scored vs first-fit, identical
    schedules. The probe gang (e.g. 4x4) is attempted periodically and
    immediately released on success — admissions count placement
    quality, not capacity."""
    from k8s_dra_driver_tpu_torch.kube.allocator import AllocationError
    from k8s_dra_driver_tpu_torch.tpulib.topology import (
        MeshShape,
        largest_free_submesh,
    )

    sx, sy, sz = profile["frag_shape"]
    shape = MeshShape(sx, sy, sz)
    frag_profile = dict(profile, slices=1, shape=profile["frag_shape"])

    def run(scored: bool) -> dict:
        rng = random.Random(seed)  # identical schedule for both runs
        client, api = build_cluster(frag_profile)
        # Bounded search budget for BOTH runs: a production scheduler
        # cannot burn 200k backtracks per pod, and first-fit's failure
        # mode on a fragmented mesh is exactly that pathological search
        # (the scorer proves gang-unsat without searching at all).
        alloc = make_allocator(
            client, placement_scoring=scored, max_backtrack_steps=2000,
        )
        live: list[str] = []
        probes = probes_ok = 0
        timeline: list[int] = []
        serial = 0
        for step in range(profile["frag_steps"]):
            r = rng.random()
            if r < 0.55 or not live:
                serial += 1
                uid = f"frag-{serial:04d}"
                count = rng.choice((1, 1, 2, 4))
                try:
                    alloc.allocate(gang_claim(uid, count))
                    live.append(uid)
                except AllocationError:
                    pass
            else:
                alloc.deallocate(live.pop(rng.randrange(len(live))))
            if step % profile["frag_probe_every"] == 0:
                probes += 1
                try:
                    alloc.allocate(
                        gang_claim(f"probe-{step:04d}",
                                   profile["frag_probe"])
                    )
                    probes_ok += 1
                    alloc.deallocate(f"probe-{step:04d}")
                except AllocationError:
                    pass
            _, cells = alloc.index.slice_meta("slice-000")
            free = {
                c for c, d in cells.items()
                if d["_key"] not in alloc._reservations
            }
            timeline.append(largest_free_submesh(shape, free))
        return {
            "probes": probes,
            "admitted": probes_ok,
            "unsat": probes - probes_ok,
            "largest_free_submesh_mean": round(
                statistics.mean(timeline), 2
            ),
            "largest_free_submesh_min": min(timeline),
            "timeline_tail": timeline[-10:],
        }

    first_fit = run(scored=False)
    scored = run(scored=True)
    return {
        "shape": f"{sx}x{sy}x{sz}",
        "steps": profile["frag_steps"],
        "probe_gang": profile["frag_probe"],
        "first_fit": first_fit,
        "scored": scored,
    }


GPUS_PER_NODE = 8


def _gpu_slice_obj(node: str) -> dict:
    """One H100 node's pool: its GPUs as the port's FakeChipLib
    publishes them (generation ``h100``, no ICI coordinates)."""
    from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib

    lib = FakeChipLib(generation="h100", topology=f"{GPUS_PER_NODE}x1x1",
                      slice_id=node)
    devices = lib.enumerate_all_possible_devices({"chip"})
    return {
        "apiVersion": "resource.k8s.io/v1beta1",
        "kind": "ResourceSlice",
        "metadata": {"name": f"{node}-chips"},
        "spec": {
            "driver": DRIVER,
            "pool": {"name": node, "generation": 1,
                     "resourceSliceCount": 1},
            "nodeName": node,
            "devices": [d.get_device() for _, d in sorted(devices.items())],
        },
    }


def generation_claim(uid: str, count: int, generation: str) -> dict:
    claim = gang_claim(uid, count)
    claim["spec"]["devices"]["requests"][0]["selectors"] = [{"cel": {
        "expression": f"device.attributes['{DRIVER}'].generation == "
                      f"'{generation}'"}}]
    return claim


def bench_h100(profile, seed: int) -> dict:
    """The TPU fleet with ``h100_nodes`` H100 nodes beside it: one
    seeded churn of ``claim_mix`` sizes, each claim on the H100 pool with
    the pool's share of the devices and on v5p otherwise, through one
    incremental allocator. Illustrative, and reported only."""
    from k8s_dra_driver_tpu_torch.kube.allocator import AllocationError

    rng = random.Random(seed)
    client, api = build_cluster(profile)
    nodes = [f"gpu-node-{h:02d}" for h in range(profile["h100_nodes"])]
    for node in nodes:
        client.create(api.slices, _gpu_slice_obj(node))
    gpus = len(nodes) * GPUS_PER_NODE
    tpus = profile["slices"] * (
        profile["shape"][0] * profile["shape"][1] * profile["shape"][2])
    schedule = [("h100" if rng.random() < gpus / (gpus + tpus) else "v5p",
                 size) for size in claim_mix(rng, profile["claims"])]
    alloc = make_allocator(client)
    claims = {g: {"claims": 0, "devices": 0, "unsat": 0}
              for g in ("v5p", "h100")}
    live: list[str] = []
    latencies: list[float] = []
    gangs = gangs_across_nodes = 0
    t0 = time.monotonic()
    for i, (generation, count) in enumerate(schedule):
        uid = f"mix-{i:04d}"
        claims[generation]["claims"] += 1
        t = time.monotonic()
        try:
            out = alloc.allocate(generation_claim(uid, count, generation))
            live.append(uid)
            claims[generation]["devices"] += count
            if generation == "h100" and count > 1:
                results = out["status"]["allocation"]["devices"]["results"]
                gangs += 1
                gangs_across_nodes += len({r["pool"] for r in results}) > 1
        except AllocationError:
            claims[generation]["unsat"] += 1
        latencies.append(time.monotonic() - t)
        if live and rng.random() < 0.3:
            alloc.deallocate(live.pop(rng.randrange(len(live))))
    elapsed = time.monotonic() - t0
    lat_sorted = sorted(latencies)
    return {
        "gpu_nodes": len(nodes),
        "gpus": gpus,
        "tpu_devices": tpus,
        "claims": claims,
        "solves_per_sec": round(len(schedule) / elapsed, 2),
        "p50_solve_seconds": round(statistics.median(latencies), 6),
        "p99_solve_seconds": round(
            lat_sorted[max(0, int(len(lat_sorted) * 0.99) - 1)], 6),
        "gpu_gangs": gangs,
        "gpu_gangs_across_nodes": gangs_across_nodes,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--profile", choices=sorted(PROFILES),
                        default="full")
    parser.add_argument("--seed", type=int,
                        default=int(os.environ.get("ALLOC_BENCH_SEED",
                                                   "1234")))
    parser.add_argument(
        "--out", default="",
        help="write the JSON document here (default: print it only)",
    )
    args = parser.parse_args(argv)
    profile = PROFILES[args.profile]

    t0 = time.monotonic()
    throughput = bench_throughput(profile, args.seed)
    frag = bench_fragmentation(profile, args.seed)
    h100 = bench_h100(profile, args.seed)
    doc = {
        "bench": "alloc",
        "package": "k8s_dra_driver_tpu_torch",
        "revision": "r01",
        "profile": args.profile,
        "seed": args.seed,
        "throughput": throughput,
        "fragmentation": frag,
        "h100": h100,
        "wall_seconds": round(time.monotonic() - t0, 1),
    }

    failures = []
    if throughput["speedup"] < profile["min_speedup"]:
        failures.append(
            f"incremental speedup {throughput['speedup']}x < required "
            f"{profile['min_speedup']}x"
        )
    extra = frag["scored"]["admitted"] - frag["first_fit"]["admitted"]
    if extra < profile["min_extra_probes"]:
        failures.append(
            f"scorer admitted {frag['scored']['admitted']} probe gangs "
            f"vs first-fit {frag['first_fit']['admitted']} (need "
            f"+{profile['min_extra_probes']})"
        )
    doc["gates"] = {
        "min_speedup": profile["min_speedup"],
        "min_extra_probes": profile["min_extra_probes"],
        "failures": failures,
    }

    out_path = args.out
    rendered = json.dumps(doc, indent=2, sort_keys=True)
    print(rendered)
    if out_path:
        with open(out_path, "w") as f:
            f.write(rendered + "\n")
        print(f"wrote {out_path}", file=sys.stderr)
    if failures:
        for f in failures:
            print(f"GATE FAILED: {f}", file=sys.stderr)
        return 1
    print(
        f"allocbench[{args.profile}]: "
        f"{throughput['incremental_solves_per_sec']} solves/s "
        f"({throughput['speedup']}x from-scratch), probe admissions "
        f"{frag['scored']['admitted']}/{frag['scored']['probes']} scored "
        f"vs {frag['first_fit']['admitted']}/"
        f"{frag['first_fit']['probes']} first-fit; h100 section "
        f"{h100['solves_per_sec']} solves/s, unsat "
        f"{h100['claims']['v5p']['unsat']} v5p / "
        f"{h100['claims']['h100']['unsat']} h100",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
