#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``k8s_dra_driver_tpu_torch`` -- no JAX -- through its five paths,
serving at the full width and depth of Llama-3-8B, training at the
Llama-3-8B widths cut to 8 layers (``8b-L8``), MoE serving at the
Mixtral-8x7B widths cut to 16 layers (``8x7b`` with ``n_layers=16``: 47 GB
of bf16 weights, where all 32 layers would not fit one 80 GB card), MoE
training at the Mixtral-8x7B widths cut to one layer (``8x7b-L1``,
dropless), all bf16, and int8 MoE serving at the full 32 layers of
Mixtral-8x7B (int8 weights and KV cache, 47 GB), with random weights from a
fixed seed, and checks every hand-written kernel of those paths:

1. builds the CUDA sources of ``k8s_dra_driver_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and the Triton RMSNorm;
2. holds each kernel against its plain PyTorch version on the same inputs
   at its path's shapes (paged attention and RMSNorm at the engine's,
   flash attention forward and backward at the train step's), and times
   kernel, plain version and (where one PyTorch call computes the same
   function) that call; the split-KV decode kernel K2 also at one sequence
   of the model's longest window (valid_len 8191, its most splits), a row
   of its own (``paged_decode_long``) in the kernels line;
3. runs one 8B forward -- a prefill chunk, then decode steps -- through the
   kernels and through the plain versions, and compares the logits;
4. serves 8 requests (prompts of 96 to 700 tokens, four sharing a
   256-token prefix, 32 new tokens each) through ``DecodeEngine`` with the
   prefix cache and the overlapped tick on (the serving path), its decode
   and prefill steps captured as CUDA graphs and replayed; then serves the
   same traffic through a ``capture=False`` engine, outside the counted
   run, and holds the two equal (greedy streams but for near-ties, stats
   counters, allocator state, every launch count; ``compile_counts`` 1
   per step); then profiles one decode step of the 8B model (8 sequences
   at 384 cached positions: device time by kernel group, K2's share,
   device over host time; then the same step captured by ``StepGraph``:
   host time over 5 replays, device time by CUDA events) and one packed 4
   x 128 prefill launch (device time, K3's share), both outside the
   counted run;
5. frees the 8B weights and compares one ``loss_fn`` value and gradient at
   the 8b-L8 widths (2 layers, batch 2 x 2048) through the kernels with
   the plain path on the same weights and tokens;
6. trains 8b-L8 with ``make_train_step`` (batch 8 x 2048, remat "full",
   AdamW): one warm-up step, 5 timed steps and one step under
   ``torch.profiler`` (device time by kernel group, the device's busy
   share) on one fixed batch (the training path);
7. frees the training state, builds 8x7b-L16, and holds the fused MoE
   dispatch kernels (K7 ``moe_gateup``, K8 ``moe_down_combine``) against
   their plain versions on layer 0's experts and a plan from its router,
   at the decode step's shape (8 tokens, tile 8) and the packed prefill
   chunk's (512 tokens, tile 128), and times both;
8. runs one 8x7b-L16 forward -- a prefill chunk, then decode steps --
   through the kernels and through the plain versions, and compares the
   logits;
9. serves phase 4's traffic through ``DecodeEngine`` on 8x7b-L16 (the
   MoE serving path), captured and then eager as phase 4 does, checks
   that K7 and K8 ran once per layer and forward, and profiles a decode
   step as phase 4 does;
10. frees the 8x7b-L16 weights and holds the grouped kernels (K10a
    ``grouped_matmul``, K10b ``grouped_weight_grad``) against their plain
    versions at the five calls of one 8x7b layer's MoE backward (T 8192,
    a plan from the layer's router), on unaligned groups, and through the
    gradients of ``GroupedMatmulFunction`` and ``FusedMoeMlpFunction``,
    and times them beside ``torch._grouped_mm``; then holds K7 and K8 at
    that training shape against their plain versions and times them
    beside ``gmm`` on the same product;
11. compares one 8x7b-L1 ``loss_fn`` value and every gradient leaf
    (batch 1 x 2048, remat "full") through the kernels with the plain
    path, the plain run replaying the kernel run's expert choices;
12. trains 8x7b-L1 (dropless) with ``make_train_step`` at batch 4 x 2048
    as phase 6 does (the MoE training path) and checks the launches per
    step;
13. frees that state, builds all 32 layers of 8x7b in int8 (``quant.
    quantize_params``, one layer drawn and quantized at a time), and holds
    the int8 branches of K2 and K3 (at phase 2's shapes, the long decode
    shape included, pools quantized from random bf16 K/V by the cache's
    own recipe) and of K7 and K8 (on layer 0's int8 experts, at phase 7's
    shapes, and again at one int8 layer of 8x160m, where K8 splits its
    contracted axis) against their plain versions, and times them;
14. runs one full-depth int8+kvq forward -- a prefill chunk, then 4 decode
    steps -- through the kernels and through the plain versions (routing
    replayed as in phase 8), and compares the logits;
15. serves phase 4's traffic through ``DecodeEngine(quantize_cache=True)``
    on the full-depth int8 model (the int8 serving path), captured and
    then eager as phase 4 does, checks the launches of every int8 branch
    per layer and forward (and none of the bf16 branches; the int8 seams'
    ``int8_matmul`` 2L+1 times a forward), and profiles one decode step,
    in which the only int8 -> float copy must be the embedding's gathered
    rows;
16. holds ``int8_matmul`` (``csrc/quant_matmul.cu``) in both modes against
    its plain version at the seams' shapes (M 8 and 512, K 4096 to N 6144,
    4096, 32000) and at the einsum MoE body's expert product ([8, 512,
    4096] against [8, 4096, 28672]), and times it beside a bf16
    ``torch.matmul`` on a converted weight: M 8 runs its M <= 64 body, M
    512 and the experts its wgmma body;
17. runs one ``prefill`` of a 1024-token prompt on the full-depth int8 model
    (``auto`` takes the einsum MoE body, its expert products through
    ``int8_matmul``'s prologue mode), holds it against the plain forward
    with routing replayed, checks that the peak memory above the weights
    stays below one layer's ``w_gateup`` in bf16 and that every
    ``int8_matmul`` launch took the wgmma body, then profiles the same
    prefill by kernel group.

18. frees that model and serves 24 requests through ``ServingGateway`` (the
    system's serving entry point) over two 8B replicas ``r0`` and ``r1``,
    each with its own weights from the seed and phase 4's engine settings,
    warmed (its steps captured) by one direct request, with affinity
    routing, ``KVTelemetry`` and a ``ServingTelemetry`` on one registry:
    4 systems of 256 tokens shared by 6 requests each, user tails of 32 to
    448 tokens, 16 ``interactive`` and 8 ``batch``, in two waves of 12 (the
    second once the first has prefilled); after 4 gateway ticks of the
    second wave ``r1`` drains and then resumes. It holds zero loss across
    the drain, one replica per system before it, the residency index's
    hits equal to the engines' counters with no counter drift, the
    ``tpu_dra_gw_*``, ``tpu_dra_residency_*``, ``tpu_dra_srv_*`` and
    ``tpu_dra_kv_*`` families rendered, K1-K3 launched as the two
    replicas' forwards count, and every stream equal to a solo engine's
    on the same prompts but for near-ties (listed), and prints a
    ``gateway:`` line;
19. keeps ``r0``'s weights as the target of greedy speculative decoding
    (``speculative_generate``, k 4) with a ``1b`` draft from the seed, on
    two prompts of about 512 tokens, 64 new tokens each: the draft's T=1
    step (K1, K2 at B 1) and the target's T=5 verify window (K1, K3)
    captured as CUDA graphs on each call's caches. It holds K2 at B 1 and
    K3 at T 5 against their plain versions first, then the launches as
    counted; the draft's streams equal the target as its own draft's (the
    perfect draft: with no flip, every proposal accepted), and both equal
    the target alone's (its T=1 steps from the same prefill) but for
    near-ties (within 1e-2 or one bf16 step of the logits, or, on an MoE
    target, explained by near-tie routing flips with the routing
    replayed); 8 tokens of the first prompt captured and eager, equal in
    tokens, stats, launches and every pool row but the scratch row; one
    host sync a round; and prints a ``speculative:`` line a run (rounds,
    acceptance, tokens a round, tokens/s against the eager ``generate``
    and a captured ``DecodeEngine(batch_slots=1)``, the draft step's and
    the verify window's device ms, captures, peak memory);
20. attaches ``ComputeTelemetry`` (the card's peak row) to a
    phase-4-shaped engine on the same weights behind a ``MetricsServer``,
    serves phase 4's traffic (streams held to phase 4's) and then, after
    ``mark_warm``, a decode-heavy second wave scraped every tick, and
    holds the ledger's builds equal to ``compile_counts``, no recompile
    after warm-up, the HBM ledger equal to the tensors' bytes and
    ``/debug/compute`` answering 200; prints a ``compute:`` line (the
    roofline gauges per program);
21. rebuilds the int8 8x7b of phases 13-17 and runs phase 19's speculation
    on it with a ``160m`` draft, both on the int8 KV cache (K2-int8 at B 1
    and head_dim 64, K3-int8 at T 5, K7/K8-int8 and ``int8_matmul`` in the
    verify window), with phase 19's holds, and no int8 -> float copy in
    the eager call but the embedding's rows;
22. trains 8b-L8 at batch 8 x 2048 under each of the named remat policies
    "full", "flash", "flash_qkv", "flash_mlp" and "flash_min" (selective
    activation checkpointing, ``models/remat.py``), each from the same
    seeded state through ``loss_fn(..., remat=True, remat_policy=p)`` and
    AdamW's ``update_`` (as ``bench.py`` drives its step): one warm-up
    step, whose loss and gradients are held to "full"'s, 3 timed steps and
    one profiled step; holds K4, K5, K6 and K1 to the launches each policy
    implies (K4 once per layer and step where ``flash_out`` is saved) and
    prints a ``remat:`` line per policy (step p50, tokens/s, peak memory,
    device ms by kernel group);
23. does the same on 8x7b-L1 at batch 4 x 2048: dropless (the fused
    pipeline) under "flash" and "flash_moe", and ``moe_impl="binned"``
    under "full" and "flash_moe", binned's first step held to the einsum
    formulation's on the same weights and tokens (routing equal), and
    prints a ``moe remat:`` line per run;
24. trains 8b-L8 cut to 2 layers (full width) for 2 AdamW steps through
    ``make_train_step``, saves a checkpoint (``save_checkpoint``), trains
    2 more steps, restores the checkpoint into a fresh state's template
    (``restore_template``, ``restore_checkpoint``) and trains the same 2
    steps: losses, parameters and both moments bitwise equal; prints the
    save and restore seconds and GB/s (``checkpoint:`` line);
25. frees that state and brings up the node plugin's device layer on the
    card (``tpulib``, ``cdi``, ``plugin``, with state under
    ``build/dra``): ``RealChipLib`` over the host's ``libnvidia-ml.so.1``
    finds the card, whose uuid, name and PCI bus id (where NVML reports
    one) must equal torch's;
    it reads healthy, a 0.1 s ``wait_device_event`` returns False, and
    ``DeviceState.published_resources()`` renders it as one ``h100``
    device (printed, beside NVML's memory, driver and power limit and
    torch's memory);
26. prepares an exclusive claim on it. The stand-in for kubelet and a
    container runtime reads the claim's CDI spec files, checks that every
    device node and mount exists on the host, and starts this script in
    a worker mode (``--dra-worker``) with the spec's env merged over the
    environment: the worker must see exactly that GPU
    (``CUDA_VISIBLE_DEVICES=<uuid>``) and serve phase 4's traffic on its
    own 8B engine (the same seed and settings) with phase 4's streams and
    K1-K3 launches; unprepare removes the claim spec and the checkpoint
    entry;
27. prepares a process-shared claim (``maxProcesses`` 2, a 36Gi limit):
    two workers at once take slots 0 and 1 through the shim
    (``parallel/shim.py``), cap PyTorch's allocator at the limit's
    fraction (an allocation just under the cap succeeds, one just over
    raises ``torch.OutOfMemoryError``), and serve phase 4's traffic
    together with phase 4's streams; a third worker is refused a slot;
    then ``resize_claim_limits`` lowers the limit to 24Gi and each worker,
    at its step boundary, applies the new generation
    (``poll_sharing_update``) and hits the new cap;
28. prepares a time-shared claim: two workers serve phase 4's traffic
    with each engine tick inside ``timeshare_lease``, record their lease
    intervals on CLOCK_MONOTONIC (no two overlap) and match phase 4's
    streams;
29. runs the scheduler side of the control plane (``kube/``) on that card:
    the port's ``ResourceSliceController`` publishes
    ``published_resources()`` into an in-memory ``FakeKubeClient`` (there
    is no API server), and the port's ``ReferenceAllocator``, under a
    DeviceClass selector for chips, allocates a claim whose CEL request
    selector reads the card's ``generation`` and ``hbm`` capacity: the
    allocation must name the card's device in this node's pool. A second
    claim asks for one byte more HBM than the card has and must fail with
    the same terminal reason in ``AllocationError.reason``, the newest
    ``export_allocations_jsonl()`` record and
    ``tpu_dra_alloc_unsat_total``. ``DeviceState.prepare`` takes the
    allocated claim as the allocator wrote it; one exclusive worker serves
    phase 4's traffic with phase 4's streams and K1-K3 launches; then
    unprepare, deallocate, and a third claim allocates the same device.
    Times 20 allocate/deallocate pairs and prints a ``scheduler:`` line;
30. runs the port's kubelet-facing node plugin on the card
    (``plugin/driver.py`` over ``RealChipLib``, a ``FakeKubeClient``, state
    under ``build/dra/plugin``): ``Driver.start`` publishes the card's
    ResourceSlice, which must equal phase 29's, and ``GetInfo`` through
    the in-process transport (``kubeletplugin.LocalTransport``) names the
    driver and its socket. The allocator places a process-shared claim
    with a ``realtime`` SLO on the card, and a ``batch`` co-tenant claim
    on the same device is written in wire form; a kubelet stand-in sends
    one ``NodePrepareResourcesRequest`` for both, encoded by the port's
    codec (``kube/protos/``), through the transport, and each claim's CDI
    ids must name spec files on disk. One worker per claim serves phase
    4's traffic with phase 4's streams and K1-K3 launches; the realtime
    worker reports itself busy (``shim.report_usage``), the batch worker
    idle, and ``Driver.tick_once`` must apply a rebalancer move from the
    batch claim to the realtime one, which each worker applies at its
    step boundary: its probed cap rises (realtime) or falls (batch). The
    auditor reads no drift; ``/readyz``, ``/metrics`` and
    ``plugin.inspect`` on a ``MetricsServer`` wired as ``plugin.main``
    wires it show the prepares, the card's occupancy and the move.
    Unprepare of the realtime claim goes through the transport; the
    batch claim is deleted from the API and the orphan cleaner
    unprepares it. 20 prepare/unprepare pairs of a third claim time the
    transport's round trip. Last, ``plugin.main`` runs as a process on
    ``RealChipLib``, answers ``/readyz`` and ``/metrics`` (one device)
    and exits 0 on SIGTERM. Prints a ``driver:`` line.
31. runs the port's fleet doctor against the card's live node: a
    ``Driver`` over ``RealChipLib`` (state under ``build/dra/doctor``)
    publishing into a ``FakeKubeClient`` that holds the card's Node (no
    slice label), one ``MetricsServer`` wired as the doctor-ready node of
    ``tools/run_doctor_sim_torch.py`` wires it (readiness, usage,
    allocations, rebalance) plus a phase-4-shaped 8B ``DecodeEngine``
    behind a ``ServingGateway`` with ``ComputeTelemetry`` and
    ``KVTelemetry`` (gateway, residency and compute documents). The
    allocator places one exclusive claim on the card, prepared through the
    transport; a warm-up request captures both programs, then
    ``mark_warm``; phase 4's traffic goes through the gateway (streams
    held to phase 4's, K1-K3 launches counted) and a decode wave scraped
    every tick. ``IciSliceManager`` over the same client publishes no
    channel pool. ``doctor.run`` then reads: clean (status 0, the node's
    occupancy the claim's device, ICI 0 of 0, a ``--bundle`` tar holding
    the compute, gateway and residency documents); ``python -m
    k8s_dra_driver_tpu_torch.doctor --no-kube --json`` exits 0; an
    orphaned CDI spec (status 1, the auditor naming it); a claim whose
    selector matches nothing on the card (an ``explain`` finding with
    the allocator's runbook hint); after a second decode wave, no
    ``mfu-regression`` against a ``BENCH_r01.json`` holding the decode
    MFU that ``/debug/compute`` reported and exactly one against a
    baseline 3x that. Last, the fleet soak's mini profile
    (``fleetsim``) replays on this host and its artifact must hash to
    FLEET_MINI_SHA256. Prints a ``doctor:`` line.

Every kernel's launch count is set to 0 just before each path (phases 4,
6, 9, 12, 15, 17, 18, 19, 20, 21, 22, 23, 24 and 31, and in each worker
of phases 26-30) and read just after.
Each phase prints its seconds. Prints the card's name and power limit,
one
``{"kernels": [...]}`` line, the engine's and the trainer's metrics, and
as its last line
``{"ok": true, "device": {...}}``. Any failed check raises: the script
then exits nonzero without that line. It also exits nonzero, printing no
result, where no CUDA device is present or the package is missing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), for the bounds below.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SEED = 0
BLOCK_SIZE = 16
NUM_BLOCKS = 1024
BATCH_SLOTS = 8
PREFILL_CHUNK = 128
PREFILL_BATCH = 4
NEW_TOKENS = 32
PREFIX_LEN = 256
TRAIN_BATCH = 8
TRAIN_SEQ = 2048
TRAIN_STEPS = 5
# Phases 22-23: each remat policy's run is one warm-up step, these timed
# steps and one profiled step.
POLICY_STEPS = 3
DENSE_POLICIES = ("full", "flash", "flash_qkv", "flash_mlp", "flash_min")
MOE_POLICY_RUNS = (("dropless", "flash"), ("dropless", "flash_moe"),
                   ("binned", "full"), ("binned", "flash_moe"))
# Phase 24: 8b-L8 cut to this depth; steps before and after the save.
CKPT_LAYERS = 2
CKPT_STEPS = 2
MOE_LAYERS = 16
# Phases 10-12: the MoE training path at 8x7b-L1 (Mixtral-8x7B widths, one
# layer), dropless; batch x TRAIN_SEQ tokens.
MOE_TRAIN_BATCH = 4
MOE_COMPARE_BATCH = 1
# Phase 10's unaligned groups: an empty group, rows past the last group.
RAGGED_ROWS = 1000
RAGGED_SIZES = (300, 0, 157, 201, 0, 99, 50, 101)
# Phase 8: the routing flips that kernel noise may cause (compare_forward).
FLIP_MARGIN_LIMIT = 1e-2
FLIP_SHARE_LIMIT = 2e-2
# Phase 14 (32 layers, int8 KV cache): each run quantizes its own k and v,
# so a last-bit difference at a rounding boundary moves an element by a
# whole int8 step (1/127 of its row's largest value) and the kernels' bf16
# noise reaches the routers amplified; flips still sit at near-ties (the
# first full run: 120 flips of 8448 choices, median margin 1.3e-3, the
# largest 1.29e-2), so the margin limit doubles and the share limit stays.
FLIP_MARGIN_LIMIT_KVQ = 2e-2
# The engine's stats that are host-clock times: the rest must agree between
# the captured engine and the eager one.
TIMING_KEYS = ("ttftP50Ms", "ttftP99Ms", "tokenIntervalP50Ms",
               "tokenIntervalP99Ms")


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out


_FLUSH = []


# Device cycles (~1 ms) the card spins before each timed call.
HOLD_CYCLES = 2_000_000


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device milliseconds of one ``fn()`` call (CUDA events).

    Before each call a 256 MB write evicts the 50 MB L2, as the engine's
    layer loop does (each layer reads other weights and other pools), and
    the card then spins for HOLD_CYCLES while the host enqueues the timed
    launch, so the host's launch latency stays outside the timed span
    even when a busy host takes longer than the write to enqueue a
    kernel of a few microseconds."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.float32,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _FLUSH[0].zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel(name, out, ref, rel_max=2e-2, rel_mean=1e-2):
    """Kernel output against its plain version: the largest error within
    ``rel_max`` of the plain output's largest magnitude, the mean error
    within ``rel_mean`` of its mean magnitude. The defaults fit a bf16
    output (its rounding alone is 0.4%); an f32 output that the kernel
    sums in f32 is held to tighter limits. Returns (max abs error,
    relative)."""
    import torch

    err = (out.float() - ref.float()).abs()
    top = ref.float().abs().max().item()
    r = err.max().item() / top
    m = err.mean().item() / ref.float().abs().mean().item()
    finite = bool(torch.isfinite(out.float()).all())
    log(f"{name}: max_abs_err={err.max().item():.3e} rel_max={r:.3e} "
        f"rel_mean={m:.3e} finite={finite}")
    if not finite or r > rel_max or m > rel_mean:
        raise AssertionError(
            f"{name} disagrees with its plain version: max error "
            f"{r} of the largest value (limit {rel_max}), mean {m} of the "
            f"mean value (limit {rel_mean})")
    return err.max().item(), r


# K8 writes f32 and sums in f32 from bf16 operands, so it differs from its
# plain version only by summation order (~2e-5 relative on the H100); these
# limits fail a bf16 accumulator or a bf16 output (~2-4e-3).
K8_REL_MAX, K8_REL_MEAN = 1e-3, 1e-4


def paged_inputs(torch, gen, dev, lens_needed, nbps, hkv, d):
    """Random pools for one layer of the engine's pool and block tables
    whose first ceil(n / bs) entries are distinct random blocks."""
    p = NUM_BLOCKS * BLOCK_SIZE
    k = torch.randn((hkv, p + 1, d), generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn((hkv, p + 1, d), generator=gen, device=dev).to(
        torch.bfloat16)
    perm = torch.randperm(NUM_BLOCKS, generator=gen, device=dev).to(
        torch.int32)
    tables = torch.zeros((len(lens_needed), nbps), dtype=torch.int32,
                         device=dev)
    used = 0
    for i, n in enumerate(lens_needed):
        nb = -(-n // BLOCK_SIZE)
        tables[i, :nb] = perm[used:used + nb]
        used += nb
    if used > NUM_BLOCKS:
        raise RuntimeError("test windows exceed the pool")
    return k, v, tables


def attn_errors(torch, out, ref, name):
    """Paged attention against its plain version: max abs error within
    2e-2, mean within 2e-3 (bf16 output rounding, another summation
    order)."""
    err = (out.float() - ref.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    finite = bool(torch.isfinite(out.float()).all())
    log(f"{name}: max_abs_err={max_err:.3e} mean_abs_err="
        f"{mean_err:.3e} finite={finite}")
    if not finite or max_err > 2e-2 or mean_err > 2e-3:
        raise AssertionError(
            f"{name} disagrees with its plain version: max {max_err} "
            f"(limit 2e-2), mean {mean_err} (limit 2e-3)")
    return max_err


def bound_fields(name, nbytes, ops, peak) -> dict:
    """The row's bound (the larger of the bytes and operations times) with
    both times beside it, logged."""
    t_b, by = bound(nbytes, ops, peak)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    log(f"{name} bound: {nbytes / 1e9:.4f} GB -> {t_bytes:.4f} ms, "
        f"{ops:.3e} operations -> {t_ops:.4f} ms; {by} bind")
    return dict(bound_ms=t_b, bound_by=by, bytes_bound_ms=t_bytes,
                ops_bound_ms=t_ops)


def check_paged(torch, cfg, dev, quantized: bool) -> dict:
    """K2 and K3 against their plain versions at the engine's shapes: the
    bf16 branch (phase 2), or the int8 branch (phase 13) on pools and
    scales quantized from the same random bf16 K/V by the cache's own
    recipe (``decode._quantize_kv``)."""
    from k8s_dra_driver_tpu_torch.models.decode import _quantize_kv
    from k8s_dra_driver_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + (50 if quantized else 0))
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nbps = cfg.max_seq_len // BLOCK_SIZE
    scale = d ** -0.5
    suffix = "_int8" if quantized else ""
    # Bytes of one position and kv head: K and V, plus their f32 scales.
    kv_bytes = 2 * d + 8 if quantized else 2 * d * 2
    results = {}

    def pools(lens):
        k, v, tables = paged_inputs(torch, gen, dev, lens, nbps, hkv, d)
        if not quantized:
            return (k, v, tables), {}
        (k8, ks), (v8, vs) = _quantize_kv(k[None]), _quantize_kv(v[None])
        return (k8[0], v8[0], tables), dict(k_scale=ks[0], v_scale=vs[0])

    def decode_case(name, vlen_list):
        (k, v, tables), sc = pools(vlen_list)
        q = torch.randn((len(vlen_list), hq, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        vlen = torch.tensor(vlen_list, dtype=torch.int32, device=dev)
        pos = (vlen.long() - 1)[:, None]
        out = att.paged_decode_attention(q, k, v, tables, vlen, BLOCK_SIZE,
                                         scale, **sc)
        ref = att.paged_attention_reference(q[:, :, None], k, v, tables, pos,
                                            BLOCK_SIZE, scale, **sc)[:, :, 0]
        torch.cuda.synchronize()
        err = attn_errors(torch, out, ref, name)
        s = sum(vlen_list)
        results[name] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: att.paged_decode_attention(
                q, k, v, tables, vlen, BLOCK_SIZE, scale, **sc)),
            plain_ms=time_ms(lambda: att.paged_attention_reference(
                q[:, :, None], k, v, tables, pos, BLOCK_SIZE, scale, **sc)),
            library_ms=None,
            shape=f"q[{len(vlen_list)},{hq},{d}] valid_len sum {s}",
            **bound_fields(name, s * hkv * kv_bytes + 2 * q.numel() * 2
                           + sum(-(-n // BLOCK_SIZE) for n in vlen_list) * 4,
                           s * hq * d * 4, BF16_FLOPS),
        )

    # K2: one decode step of the engine run (batch 8, the prompts plus
    # their generated tokens), then one sequence at the model's longest
    # window (max_seq_len - 1 cached positions: the most kv splits).
    decode_case("paged_decode" + suffix,
                [96 + 32, 180 + 32, 300 + 32, 700 + 32, 320 + 32, 406 + 32,
                 700 + 1, 256 + 16])
    decode_case("paged_decode" + suffix + "_long", [cfg.max_seq_len - 1])

    # K3: one packed prefill launch (4 lanes x 128 tokens), windows from
    # position 0, after a 256-token prefix hit, mid-prompt, and the
    # straddling last chunk of a 700-token prompt.
    t = PREFILL_CHUNK
    starts_list = [0, 256, 384, 572]
    (k, v, tables), sc = pools([s0 + t for s0 in starts_list])
    q = torch.randn((PREFILL_BATCH, hq, t, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    pos = (torch.tensor(starts_list, device=dev)[:, None]
           + torch.arange(t, device=dev)[None, :])
    out = att.paged_prefill_attention(q, k, v, tables, pos, BLOCK_SIZE, scale,
                                      **sc)
    ref = att.paged_attention_reference(q, k, v, tables, pos, BLOCK_SIZE,
                                        scale, **sc)
    torch.cuda.synchronize()
    name = "paged_prefill" + suffix
    err = attn_errors(torch, out, ref, name)
    visible = sum(s0 + i + 1 for s0 in starts_list for i in range(t))
    results[name] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: att.paged_prefill_attention(
            q, k, v, tables, pos, BLOCK_SIZE, scale, **sc)),
        plain_ms=time_ms(lambda: att.paged_attention_reference(
            q, k, v, tables, pos, BLOCK_SIZE, scale, **sc)),
        library_ms=None,
        shape=f"q[{PREFILL_BATCH},{hq},{t},{d}] starts {starts_list}",
        **bound_fields(name, sum(s0 + t for s0 in starts_list) * hkv
                       * kv_bytes + 2 * q.numel() * 2,
                       visible * hq * d * 4, BF16_FLOPS),
    )
    return results


def check_kernels(torch, cfg, dev) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes."""
    from k8s_dra_driver_tpu_torch.ops import norms

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 60)
    t = PREFILL_CHUNK
    results = check_paged(torch, cfg, dev, quantized=False)

    # K1: the prefill chunk's norm input [4, 128, 4096].
    x = torch.randn((PREFILL_BATCH, t, cfg.hidden), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((cfg.hidden,), generator=gen,
                               device=dev)).to(torch.bfloat16)
    eps = cfg.norm_eps
    out = norms.rmsnorm(x, w, eps)
    ref = norms.rmsnorm_reference(x, w, eps)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    rel = (diff.max() / ref.float().abs().max()).item()
    log(f"rmsnorm: max_abs_err={diff.max().item():.3e} rel_err={rel:.3e}")
    if not bool(torch.isfinite(out.float()).all()) or rel > 1e-2:
        raise AssertionError(f"rmsnorm rel error {rel} (limit 1e-2)")
    rows = x.numel() // cfg.hidden
    t_b, by = bound(2 * x.numel() * 2 + w.numel() * 2,
                    4 * x.numel(), F32_FLOPS)
    lib = getattr(torch.nn.functional, "rms_norm", None)
    results["rmsnorm"] = dict(
        max_abs_err=diff.max().item(),
        ms=time_ms(lambda: norms.rmsnorm(x, w, eps)),
        plain_ms=time_ms(lambda: norms.rmsnorm_reference(x, w, eps)),
        bound_ms=t_b, bound_by=by,
        library_ms=(time_ms(lambda: lib(x, (cfg.hidden,), w, eps))
                    if lib is not None else None),
        shape=f"x[{rows},{cfg.hidden}]",
    )
    return results


def flash_bounds(b, hq, hkv, s, d, causal):
    """(forward, dK/dV, dQ) as (bytes, operations): each input read once and
    each output written once; operations over the visible score pairs."""
    pairs = s * (s + 1) // 2 if causal else s * s
    q_bytes, kv_bytes, row_bytes = b * hq * s * d * 2, b * hkv * s * d * 2, \
        b * hq * s * 4
    fwd = (2 * q_bytes + 2 * kv_bytes + row_bytes, 4 * b * hq * d * pairs)
    dkdv = (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
            8 * b * hq * d * pairs)
    dq = (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 6 * b * hq * d * pairs)
    return fwd, dkdv, dq


def check_flash_kernels(torch, cfg, dev) -> dict:
    """Phase 2, training half: K4-K6 against their plain versions at the
    train step's attention shape (q [8, 32, 2048, 128], k/v [8, 8, 2048,
    128], bf16, causal)."""
    from k8s_dra_driver_tpu_torch.ops import attention as att

    F = torch.nn.functional
    b, s = TRAIN_BATCH, TRAIN_SEQ
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v, do = rand(b, hq, s, d), rand(b, hkv, s, d), rand(b, hkv, s, d), \
        rand(b, hq, s, d)
    shape = f"q[{b},{hq},{s},{d}] k/v[{b},{hkv},{s},{d}] causal"

    out, lse = att.flash_fwd(q, k, v, True, scale)
    ref_out, ref_lse = att.flash_fwd_reference(q, k, v, True, scale)
    torch.cuda.synchronize()
    out_err, out_rel = rel("flash_fwd out", out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    log(f"flash_fwd lse: max_abs_err={lse_err:.3e}")
    if not lse_err <= 1e-3:
        raise AssertionError(f"flash_fwd lse error {lse_err} (limit 1e-3)")
    del out, lse
    delta = (do.float() * ref_out.float()).sum(-1)
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, ref_lse, delta, True, scale)
    ref_dk, ref_dv = att.flash_bwd_dkdv_reference(q, k, v, do, ref_lse,
                                                  delta, True, scale)
    torch.cuda.synchronize()
    dk_err, dk_rel = rel("flash_bwd_dkdv dk", dk, ref_dk)
    dv_err, dv_rel = rel("flash_bwd_dkdv dv", dv, ref_dv)
    del dk, dv, ref_dk, ref_dv
    dq = att.flash_bwd_dq(q, k, v, do, ref_lse, delta, True, scale)
    ref_dq = att.flash_bwd_dq_reference(q, k, v, do, ref_lse, delta, True,
                                        scale)
    torch.cuda.synchronize()
    dq_err, dq_rel = rel("flash_bwd_dq dq", dq, ref_dq)
    del dq, ref_dq
    torch.cuda.empty_cache()

    # The library's yardstick: one SDPA call forward, and its autograd
    # backward (dq, dk and dv together) for the two backward kernels.
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa: E731
        q_, k_, v_, is_causal=True, scale=scale, enable_gqa=True)
    lib_fwd = time_ms(lambda: sdpa(q, k, v), iters=10)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    lib_out = sdpa(*leaves)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do, retain_graph=True), iters=10)
    del lib_out, leaves

    fb, kb, qb = flash_bounds(b, hq, hkv, s, d, True)
    results = {}
    for name, (nbytes, ops), kernel_fn, plain_fn, err, extra, lib in (
        ("flash_fwd", fb,
         lambda: att.flash_fwd(q, k, v, True, scale),
         lambda: att.flash_fwd_reference(q, k, v, True, scale),
         out_err, dict(rel_err=out_rel, lse_max_abs_err=lse_err), lib_fwd),
        ("flash_bwd_dkdv", kb,
         lambda: att.flash_bwd_dkdv(q, k, v, do, ref_lse, delta, True, scale),
         lambda: att.flash_bwd_dkdv_reference(q, k, v, do, ref_lse, delta,
                                              True, scale),
         max(dk_err, dv_err), dict(dk_max_abs_err=dk_err, dk_rel_err=dk_rel,
                                   dv_max_abs_err=dv_err, dv_rel_err=dv_rel),
         lib_bwd),
        ("flash_bwd_dq", qb,
         lambda: att.flash_bwd_dq(q, k, v, do, ref_lse, delta, True, scale),
         lambda: att.flash_bwd_dq_reference(q, k, v, do, ref_lse, delta,
                                            True, scale),
         dq_err, dict(rel_err=dq_rel), lib_bwd),
    ):
        t_b, by = bound(nbytes, ops, BF16_FLOPS)
        log(f"{name} bound: {nbytes / 1e9:.3f} GB, {ops:.3e} operations "
            f"-> {t_b:.4f} ms ({by})")
        ms = time_ms(kernel_fn, iters=10)
        plain_ms = time_ms(plain_fn, warmup=1, iters=3)
        torch.cuda.empty_cache()
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=t_b,
            bound_by=by, library_ms=lib, shape=shape, **extra,
        )
        if name != "flash_fwd":
            results[name]["library_covers"] = "sdpa backward: dq, dk, dv"
    return results


class RoutingReplay:
    """Stands in for ``moe._topk_masks`` inside a ``with`` block, so it
    sees the routing of every MoE formulation (the sorted paths' top-k and
    the einsum body's). In mode "record" it keeps each call's expert
    choices; in mode "replay" it hands them back in call order (as one-hot
    masks, gates taken from the caller's own router probabilities, so they
    stay differentiable), counts the routed tokens, and records for each
    token whose own choice differs (a flip) the margin by which the choice
    was made: the k-th largest of its own probabilities less the largest
    own probability of an expert only the recorded run chose. Mode None
    routes as usual."""

    def __init__(self, moe):
        self.moe = moe
        self.topk = moe._topk_masks
        self.mode = None
        self.recorded, self.margins, self.routed = [], [], 0

    def __enter__(self):
        self.moe._topk_masks = self
        return self

    def __exit__(self, *exc):
        self.moe._topk_masks = self.topk

    def __call__(self, probs, c):
        import torch

        masks, gates, aux = self.topk(probs, c)
        if self.mode is None:
            return masks, gates, aux
        e = probs.shape[-1]
        experts = torch.stack([m.reshape(-1, e).argmax(-1) for m in masks],
                              dim=1)
        if self.mode == "record":
            self.recorded.append(experts)
            return masks, gates, aux
        ref = self._next(experts)
        p = probs.reshape(-1, e)
        flipped = (ref.sort(1).values != experts.sort(1).values).any(1)
        self.routed += experts.shape[0]
        if bool(flipped.any()):
            pf, theirs = p[flipped], ref[flipped]
            ours = torch.zeros_like(pf, dtype=torch.bool).scatter_(
                1, experts[flipped], True)
            kth = pf.topk(c.top_k, dim=1).values[:, -1]
            only_theirs = torch.where(torch.gather(ours, 1, theirs),
                                      torch.full_like(kth[:, None], -1),
                                      torch.gather(pf, 1, theirs))
            self.margins.extend((kth - only_theirs.max(1).values).tolist())
        masks = [self.moe._one_hot(ref[:, i], e, probs.dtype).reshape(
            probs.shape) for i in range(ref.shape[1])]
        gates = [torch.sum(probs * m, dim=-1) for m in masks]
        token_axes = tuple(range(probs.dim() - 1))
        aux = e * torch.sum(masks[0].mean(dim=token_axes)
                            * probs.mean(dim=token_axes))
        return masks, gates, aux

    def _next(self, experts):
        """The recorded choices the call now routing ``experts`` takes."""
        return self.recorded.pop(0)

    def summary(self) -> dict:
        margins = sorted(self.margins)
        return dict(routing_flips=len(margins),
                    routed_token_layers=self.routed,
                    flip_margin_max=max(margins, default=0.0),
                    flip_margins=margins)

    def check(self, what: str, margin_limit=FLIP_MARGIN_LIMIT) -> None:
        """Raises where a flip is not a near-tie (margin >= margin_limit)
        or the flips exceed FLIP_SHARE_LIMIT of the routed choices."""
        share = len(self.margins) / max(self.routed, 1)
        largest = max(self.margins, default=0.0)
        if share > FLIP_SHARE_LIMIT or largest >= margin_limit:
            raise AssertionError(
                f"{what}: {len(self.margins)} routing flips of "
                f"{self.routed} ({share}, limit {FLIP_SHARE_LIMIT}), "
                f"largest margin {largest} (limit {margin_limit})")


def compare_forward(torch, params, cfg, dev, quantize_cache=False) -> dict:
    """Phase 3 (phase 8 on the MoE config, phase 14 on its full-depth int8
    weights with the int8 KV cache): one forward through the kernels and
    through the plain versions, on identical caches and tokens.

    On an MoE config the router's top-2 choice is discrete: the bf16 noise
    of the attention and norm kernels flips near-tie choices, and one flip
    changes a token's hidden state far more than any kernel's error. So
    the plain forward runs twice there: free, on its own routing (its
    logit difference and the number of tokens whose expert set differs
    are reported), and with the kernel run's expert choices replayed
    (gates recomputed from its own router probabilities), which isolates
    the kernels' error and is what the limit holds. The replayed run also
    counts where its own router would have chosen another expert set
    (a flip) and, for each flip, the margin by which the choice was made:
    the k-th largest of the plain router's probabilities less the largest
    plain probability of an expert only the kernel run chose. A flip from
    kernel noise sits at a near-tie, so every margin must be under
    ``FLIP_MARGIN_LIMIT`` (``FLIP_MARGIN_LIMIT_KVQ`` with the int8 KV
    cache) and the flips at most ``FLIP_SHARE_LIMIT`` of the routed (token,
    layer) choices: a fault that moves routing fails."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.decode import _forward_with_cache
    from k8s_dra_driver_tpu_torch.models.paged import (
        PagedKVCache,
        PagedQuantKVCache,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    b, t, steps = 2, PREFILL_CHUNK, 4
    is_moe = isinstance(cfg, moe.MoeConfig)
    runs = {"kernels": "record", "plain": None}
    if is_moe:
        runs["replayed"] = "replay"
    cache_cls = PagedQuantKVCache if quantize_cache else PagedKVCache
    caches = {
        name: cache_cls.init(cfg, b, 512, block_size=BLOCK_SIZE, device=dev)
        for name in runs
    }
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen,
                           device=dev, dtype=torch.int32)
    positions = torch.arange(t, device=dev)
    worst, agree, total, rel = 0.0, 0, 0, 0.0
    free_worst, free_agree, free_rel = 0.0, 0, 0.0
    with RoutingReplay(moe) as replay:
        for step in range(steps + 1):
            logits = {}
            for name, how in runs.items():
                replay.mode = how
                logits[name], caches[name] = _forward_with_cache(
                    params, tokens, caches[name], cfg, positions,
                    use_kernels=name == "kernels")
            replay.recorded.clear()
            a = logits["kernels"][:, -1]
            p = logits["replayed" if is_moe else "plain"][:, -1]
            f = logits["plain"][:, -1]
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"non-finite logits at step {step}")
            worst = max(worst, (a - p).abs().max().item())
            rel = max(rel, ((a - p).norm() / p.norm()).item())
            agree += int((a.argmax(-1) == p.argmax(-1)).sum())
            free_worst = max(free_worst, (a - f).abs().max().item())
            free_rel = max(free_rel, ((a - f).norm() / f.norm()).item())
            free_agree += int((a.argmax(-1) == f.argmax(-1)).sum())
            total += b
            tokens = a.argmax(-1).to(torch.int32)[:, None]
            positions = caches["kernels"].lengths[:, None]
    result = dict(max_logit_diff=worst, rel_logit_diff=rel,
                  top1_agreement=agree / total, positions_compared=total)
    if is_moe:
        result.update(free_max_logit_diff=free_worst,
                      free_rel_logit_diff=free_rel,
                      free_top1_agreement=free_agree / total,
                      **replay.summary())
    log("forward kernels vs plain:", json.dumps(result))
    if rel > 5e-2:
        raise AssertionError(f"forward: relative logit difference {rel} "
                             f"(limit 5e-2)")
    if is_moe:
        replay.check("forward", FLIP_MARGIN_LIMIT_KVQ if quantize_cache
                     else FLIP_MARGIN_LIMIT)
    return result


def smoke_engine(params, cfg, dev, quantize_cache=False, capture=True):
    """The engine every serving phase runs: 8 slots, a 1024-block pool
    of 16-token blocks, 4 x 128 packed prefill, prefix cache and
    overlapped tick on."""
    from k8s_dra_driver_tpu_torch.models import DecodeEngine

    return DecodeEngine(
        params, cfg, batch_slots=BATCH_SLOTS, num_blocks=NUM_BLOCKS,
        block_size=BLOCK_SIZE, prefill_chunk=PREFILL_CHUNK,
        prefill_batch=PREFILL_BATCH, prefix_cache=True, overlap=True,
        quantize_cache=quantize_cache, device=dev, capture=capture)


def step_objects(eng) -> tuple:
    """The engine's two ``StepGraph``s, also while ``ComputeTelemetry``
    wraps them (``__wrapped__``)."""
    return tuple(getattr(x, "__wrapped__", x)
                 for x in (eng._decode, eng._prefill))


def serve(torch, params, cfg, dev, quantize_cache=False,
          capture=True, attach=None, lease=None) -> dict:
    """Phase 4 (phase 9 on the MoE config, phase 15 on its full-depth int8
    weights with the int8 KV cache): the engine run (a main path), its
    steps captured as CUDA graphs, or eager with ``capture=False``.
    Returns its metrics; the keys that start with "_" hold what
    ``same_engines`` compares (streams, counters, allocator state).
    ``attach(engine)``, where given, runs before the engine's first tick
    (phase 20's telemetry), and the metrics then hold the engine under
    "_engine". ``lease``, where given, is a context manager factory that
    every tick and the engine's construction run inside (phase 28's
    time-shared workers)."""
    from k8s_dra_driver_tpu_torch.models.serving import RUNNING

    hold = lease if lease is not None else contextlib.nullcontext

    rng = torch.Generator()
    rng.manual_seed(SEED + 2)

    def toks(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    prefix = toks(PREFIX_LEN)
    first = [toks(96), toks(180), toks(300), toks(700), prefix + toks(64)]
    later = [prefix + toks(150), prefix + toks(444), list(prefix)]
    with hold():
        eng = smoke_engine(params, cfg, dev, quantize_cache, capture)
    if attach is not None:
        attach(eng)

    def tick():
        with hold():
            eng.tick()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in first]
    # The shared-prefix family arrives once the first holder of the
    # prefix has prefilled it (so the radix index can serve it).
    for _ in range(10000):
        if reqs[-1].state == RUNNING or reqs[-1].done:
            break
        tick()
    else:
        raise AssertionError("the first shared-prefix request never ran")
    reqs += [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in later]
    for _ in range(100000):
        if eng.idle:
            break
        tick()
    else:
        raise AssertionError("the engine never drained")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.assert_no_leaks()
    st = eng.stats
    bad = [(r.rid, len(r.generated)) for r in reqs
           if not r.done or len(r.generated) != NEW_TOKENS]
    if len(reqs) != 8 or bad:
        raise AssertionError(f"requests not finished with {NEW_TOKENS} "
                             f"tokens: {bad}")
    if st.prefix_hits <= 0 or st.cow_recomputes <= 0:
        raise AssertionError(f"prefix hits {st.prefix_hits}, COW "
                             f"recomputes {st.cow_recomputes}")
    for r in reqs:
        if not all(0 <= x < cfg.vocab_size for x in r.generated):
            raise AssertionError(f"request {r.rid}: token out of range")
    metrics = dict(
        requests=len(reqs),
        prompt_lens=[len(r.prompt) for r in reqs],
        tokens_generated=st.tokens_generated,
        wall_s=wall,
        tokens_per_s=st.tokens_generated / wall,
        ttft_p50_ms=st.p50_ttft_ms(), ttft_p99_ms=st.p99_ttft_ms(),
        decode_step_p50_ms=st.p50_token_ms(),
        decode_steps=st.decode_steps, prefill_chunks=st.prefill_chunks,
        prefill_launches=st.prefill_lanes_launched // eng.prefill_batch,
        prefix_hits=st.prefix_hits, prefix_hit_tokens=st.prefix_hit_tokens,
        cow_recomputes=st.cow_recomputes, preemptions=st.preemptions,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        # The graphs' private pools show here: memory they hold is
        # reserved, not allocated, between replays.
        peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        compile_counts=dict(eng.compile_counts),
        graphs=sum(x.graphs for x in step_objects(eng)),
        # Host seconds of the steps' warm-ups and captures, once per
        # engine, inside the run (and so in the first requests' TTFT).
        capture_s=sum(x.build_s for x in step_objects(eng)),
        _streams=[r.tokens for r in reqs],
        _prompt_lens=[len(r.prompt) for r in reqs],
        _stats={k: v for k, v in st.snapshot().items()
                if k not in TIMING_KEYS},
        _allocator=eng.allocator.occupancy(),
        _residency=eng.kv_residency(),
    )
    if eng.moe_impl:
        from k8s_dra_driver_tpu_torch.ops.moe_dispatch import (
            dispatch_impl_label,
        )

        metrics.update(moe_impl=eng.moe_impl, dispatch=dispatch_impl_label(
            cfg.hidden, cfg.mlp_hidden, device=dev))
    if attach is not None:
        metrics["_engine"] = eng
    return metrics


def next_logits(torch, params, cfg, dev, tokens, quantize_cache):
    """The last position's logits [V] of one sequence, a prefill through
    the kernels on a fresh cache."""
    from k8s_dra_driver_tpu_torch.models.decode import prefill

    logits, _ = prefill(params, torch.tensor([tokens], device=dev), cfg,
                        len(tokens) + 1, quantize_cache=quantize_cache,
                        block_size=BLOCK_SIZE)
    return logits[0].float()


def same_engines(torch, what, captured, eager, counts, eager_counts, params,
                 cfg, dev, quantize_cache=False) -> list:
    """The captured engine's run against the eager one's on the same
    traffic: ``compile_counts`` 1 per step (the eager engine's counts
    first uses), the stats counters, allocator state and every launch
    count equal, and the greedy streams equal except where a stream takes
    another token at a near-tie: at its first differing token, the two
    tokens' logits (a prefill of the common prefix through the kernels)
    must lie within FLIP_MARGIN_LIMIT (FLIP_MARGIN_LIMIT_KVQ with the int8
    KV cache). Returns the flips."""
    ones = {"decode_step": 1, "prefill_chunk": 1}
    if captured["compile_counts"] != ones \
            or eager["compile_counts"] != ones:
        raise AssertionError(f"{what}: compile counts "
                             f"{captured['compile_counts']} (captured), "
                             f"{eager['compile_counts']} (eager); want "
                             f"{ones}")
    if captured["graphs"] != 2 or eager["graphs"] != 0:
        raise AssertionError(f"{what}: {captured['graphs']} graphs "
                             f"captured, {eager['graphs']} eager; want 2, 0")
    if counts != eager_counts:
        raise AssertionError(f"{what}: launches {counts} (captured), "
                             f"{eager_counts} (eager)")
    limit = FLIP_MARGIN_LIMIT_KVQ if quantize_cache else FLIP_MARGIN_LIMIT
    flips = stream_flips(torch, captured["_streams"], eager["_streams"],
                         captured["_prompt_lens"], ("captured", "eager"),
                         params, cfg, dev, quantize_cache)
    log(f"{what}: captured vs eager stream flips {json.dumps(flips)}")
    bad = [f for f in flips if f["logit_margin"] >= limit]
    if bad:
        raise AssertionError(f"{what}: streams differ beyond a near-tie "
                             f"(logit margin limit {limit}): {bad}")
    # The residency digest hashes the tokens of the indexed blocks, so a
    # flipped stream changes it.
    for key in ("_stats", "_allocator") + (() if flips else ("_residency",)):
        if captured[key] != eager[key]:
            raise AssertionError(f"{what}: {key[1:]} {captured[key]} "
                                 f"(captured), {eager[key]} (eager)")
    return flips


def compare_train(torch, dev, cfg, batch: int, counted: dict,
                  seed: int) -> dict:
    """Phase 5 (and phase 11 on the MoE config): one loss value and every
    gradient leaf through the kernels and through the plain path, on the
    same weights (from ``seed``) and tokens, remat "full". ``counted``
    names the wrappers that must launch with the kernels and never
    without. On an MoE config the plain run replays the kernel run's
    expert choices, as phase 8 does (``RoutingReplay``), and its flips
    are held to phase 8's limits."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.train import _model_fns, leaves

    init_params, loss_fn = _model_fns(cfg)
    is_moe = isinstance(cfg, moe.MoeConfig)
    params = init_params(cfg, seed=seed, device=dev)
    names = param_names(params)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    runs = {}
    with RoutingReplay(moe) as replay:
        for flag in (True, False):
            if is_moe:
                replay.mode = "record" if flag else "replay"
            before = [w.launches for w in counted.values()]
            loss = loss_fn(params, tokens, cfg, remat=True,
                           use_kernels=flag)
            grads = torch.autograd.grad(loss, flat)
            ran = dict(zip(counted, (w.launches - b_ for w, b_ in
                                     zip(counted.values(), before))))
            if flag and min(ran.values()) <= 0 or not flag and any(
                    ran.values()):
                raise AssertionError(f"use_kernels={flag}: launches {ran}")
            runs[flag] = (loss.item(), grads, ran)
    lk, gk, ran = runs[True]
    lp, gp, _ = runs[False]
    loss_rel, grad_rel = loss_grad_rel(names, (lk, gk), (lp, gp))
    result = dict(loss_kernels=lk, loss_plain=lp, loss_rel_diff=loss_rel,
                  grad_rel_diff=grad_rel, batch=batch, seq=TRAIN_SEQ,
                  layers=cfg.n_layers, kernel_launches=ran)
    if is_moe:
        result.update(replay.summary())
    log("loss/grad kernels vs plain:", json.dumps(result))
    hold_loss_grads("kernels vs plain", loss_rel, grad_rel)
    if is_moe:
        replay.check("loss/grad")
    return result


def param_names(params: dict) -> list:
    """The leaf names of a parameter dict, in ``train.leaves`` order."""
    return (["embed"] + [f"layers/{n}" for n in params["layers"]]
            + ["final_norm", "lm_head"])


def loss_grad_rel(names, got, want) -> tuple:
    """(loss relative difference, {leaf: |got - want| / |want|}) of two
    (loss, gradient leaves) pairs; the leaves of ``want`` may lie on the
    host. Raises where a norm is zero or not finite."""
    loss_g, grads_g = got
    loss_w, grads_w = want
    rel_diff = {}
    for name, a, b_ in zip(names, grads_g, grads_w):
        b_ = b_.to(a.device).float()
        ref = b_.norm().item()
        diff = (a.float() - b_).norm().item()
        if not (math.isfinite(diff) and ref > 0 and a.float().norm() > 0):
            raise AssertionError(f"{name}: gradient norms {a.float().norm()}"
                                 f" and {ref} (the run held to)")
        rel_diff[name] = diff / ref
    return abs(loss_g - loss_w) / abs(loss_w), rel_diff


def hold_loss_grads(what: str, loss_rel: float, grad_rel: dict) -> None:
    """§2's limits: the loss within 1e-2, each gradient leaf within
    5e-2 (relative)."""
    if not loss_rel <= 1e-2:
        raise AssertionError(f"{what}: loss relative difference {loss_rel} "
                             f"(limit 1e-2)")
    bad = {n: r for n, r in grad_rel.items() if not r <= 5e-2}
    if bad:
        raise AssertionError(f"{what}: gradient relative differences over "
                             f"5e-2: {bad}")


def train(torch, dev, cfg, preset: str, batch: int) -> dict:
    """Phase 6 (and phase 12 on the MoE config): the training path (a main
    path) on ``cfg`` at batch ``batch`` x 2048, remat "full", AdamW (lr
    1e-3, warm-up 1, 100 total steps) on one fixed batch: one warm-up
    step, 5 timed steps and one profiled step."""
    from k8s_dra_driver_tpu_torch.models import (
        init_train_state,
        make_optimizer,
        make_train_step,
        moe,
    )

    n = cfg.num_params()
    # bf16 weights, gradients and both AdamW moments: 8 bytes a parameter,
    # plus the activations of one recomputed layer and one CE chunk.
    log(f"{preset}: {n / 1e9:.3f}B parameters; weights + grads + moments "
        f"{8 * n / 1e9:.1f} GB before activations")
    torch.cuda.reset_peak_memory_stats()
    opt = make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    state = init_train_state(cfg, opt, seed=SEED, device=dev)
    step = make_train_step(cfg, opt, remat=True, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    moe.MOE_TRACE_COUNTS.clear()
    losses, times = [], []
    for _ in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    if state.step != 1 + TRAIN_STEPS:
        raise AssertionError(f"step counter {state.step}")
    step_s = statistics.median(times[1:])
    profile = profile_step(torch, step, state, tokens)
    tokens_per_step = batch * TRAIN_SEQ
    metrics = dict(
        preset=preset, batch=batch, seq=TRAIN_SEQ, remat="full",
        params=n, losses=losses, warmup_step_ms=times[0] * 1e3,
        step_ms=[t * 1e3 for t in times[1:]], step_ms_p50=step_s * 1e3,
        tokens_per_s=tokens_per_step / step_s,
        model_flops_per_step=cfg.flops_per_token(TRAIN_SEQ) * tokens_per_step,
        mfu=cfg.flops_per_token(TRAIN_SEQ) * tokens_per_step / step_s
        / BF16_FLOPS,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        profile=profile,
    )
    if isinstance(cfg, moe.MoeConfig):
        from k8s_dra_driver_tpu_torch.ops.moe_dispatch import (
            dispatch_impl_label,
        )

        metrics.update(moe_blocks=dict(moe.MOE_TRACE_COUNTS),
                       dispatch=dispatch_impl_label(
                           cfg.hidden, cfg.mlp_hidden, device=dev))
        log("moe train:", json.dumps(metrics))
    else:
        log("train:", json.dumps(metrics))
    return metrics


def remat_run(torch, dev, cfg, preset: str, batch: int, policy: str,
              wrappers: dict, hold=None) -> dict:
    """One run of phases 22-23: ``cfg`` from the seeded state at batch
    ``batch`` x 2048 under ``policy``, AdamW (lr 1e-3, warm-up 1, 100
    total steps) on one fixed batch, stepped as ``bench.py`` steps:
    ``loss_fn(..., remat=True, remat_policy=policy)``, the gradients and
    the optimizer's ``update_``. One warm-up step, whose loss and
    gradients are held to ``hold`` (names, (loss, host gradients)) where
    given and returned (``first``, the gradients on the host), then
    POLICY_STEPS timed steps and one profiled step (``peak_mem_gb``: their
    peak). On an MoE config the warm-up's routing is recorded
    (``routing``: the forward's expert choices per layer). ``launches``
    is each wrapper's launches a step."""
    from k8s_dra_driver_tpu_torch.models import (
        init_train_state,
        make_optimizer,
        moe,
    )
    from k8s_dra_driver_tpu_torch.models.train import _model_fns, leaves

    loss_fn = _model_fns(cfg)[1]
    opt = make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(cfg, opt, seed=SEED, device=dev)
    flat = leaves(state.params)
    names = param_names(state.params)
    before = {name: w.launches for name, w in wrappers.items()}

    def step():
        loss = loss_fn(state.params, tokens, cfg, remat=True,
                       remat_policy=policy)
        grads = torch.autograd.grad(loss, flat)
        opt.update_(flat, grads, state.opt_state)
        state.step += 1
        return loss.detach(), grads

    is_moe = isinstance(cfg, moe.MoeConfig)
    with RoutingReplay(moe) as replay:
        replay.mode = "record" if is_moe else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step()
        losses = [loss.item()]
        warmup_s = time.perf_counter() - t0
    result = dict(preset=preset, policy=policy, batch=batch, seq=TRAIN_SEQ,
                  layers=cfg.n_layers, warmup_step_ms=warmup_s * 1e3)
    if hold is not None:
        loss_rel, grad_rel = loss_grad_rel(names, (losses[0], grads),
                                           hold[1])
        result.update(loss_rel_diff=loss_rel, grad_rel_diff=grad_rel)
        hold_loss_grads(f"{preset} {policy}", loss_rel, grad_rel)
    first = (names, (losses[0], [g.cpu() for g in grads]))
    del loss, grads
    # The peak of the steady steps: the hold's f32 copies stay out of it.
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(POLICY_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step()[0].item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    profile = device_profile(torch, step, 1)
    steps = 1 + POLICY_STEPS + 1
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{preset} {policy}: losses {losses}")
    step_s = statistics.median(times)
    tokens_per_step = batch * TRAIN_SEQ
    flops = cfg.flops_per_token(TRAIN_SEQ) * tokens_per_step
    result.update(
        losses=losses, step_ms=[t * 1e3 for t in times],
        step_ms_p50=step_s * 1e3, tokens_per_s=tokens_per_step / step_s,
        mfu=flops / step_s / BF16_FLOPS,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches={name: (w.launches - before[name]) / steps
                  for name, w in wrappers.items()},
        profile=profile, first=first,
        routing=[e.cpu() for e in replay.recorded[:cfg.n_layers]])
    del state, flat
    return result


def remat_launches(cfg, impl: str, policy: str) -> dict:
    """The launches a train step implies under ``policy``: K4 once a
    layer where ``flash_out`` is saved (twice under "full": the
    recompute), K5 and K6 once, K1 at both norms of a layer in the
    forward and the recompute plus the final norm; the fused dropless
    pipeline K7 and K8 twice (``moe_act`` is in no policy), 3 gmm and 2
    tgmm in its backward."""
    from k8s_dra_driver_tpu_torch.models.llama import REMAT_POLICIES

    layers = cfg.n_layers
    saved = REMAT_POLICIES[policy] or ()
    fused = impl == "dropless"
    return {"flash_fwd": layers * (1 if "flash_out" in saved else 2),
            "flash_bwd_dkdv": layers, "flash_bwd_dq": layers,
            "rmsnorm": 4 * layers + 1,
            "moe_gateup": 2 * layers * fused,
            "moe_down_combine": 2 * layers * fused,
            "grouped_matmul": 3 * layers * fused,
            "grouped_weight_grad": 2 * layers * fused}


def hold_launches(what: str, run: dict, want: dict) -> None:
    got = {name: run["launches"].get(name) for name in want}
    if got != want:
        raise AssertionError(f"{what}: launches a step {got}, expected "
                             f"{want}")


def log_remat(label: str, run: dict) -> None:
    groups = {k: round(v, 3) for k, v in run["profile"]["group_ms"].items()
              if v}
    log(f"{label}: {run['preset']} {run['policy']}: step p50 "
        f"{run['step_ms_p50']:.1f} ms, {run['tokens_per_s']:.0f} tokens/s, "
        f"MFU {run['mfu']:.4f}, peak {run['peak_mem_gb']:.2f} GB, device "
        f"{run['profile']['device_ms']:.1f} ms by group {json.dumps(groups)}"
        f"; loss vs held {run.get('loss_rel_diff')}, largest gradient "
        f"difference {max(run.get('grad_rel_diff', {0: None}).values())}")


def remat_dense(torch, dev, cfg, preset: str, batch: int,
                wrappers: dict) -> dict:
    """Phase 22: each of DENSE_POLICIES on ``cfg`` (``remat_run``), every
    later policy's first step held to "full"'s, the launches held to
    ``remat_launches``."""
    runs, ref = {}, None
    for policy in DENSE_POLICIES:
        run = remat_run(torch, dev, cfg, preset, batch, policy, wrappers,
                        hold=ref)
        first = run.pop("first")
        run.pop("routing")
        if ref is None:
            ref = first
        hold_launches(f"{preset} {policy}", run,
                      remat_launches(cfg, "dense", policy))
        log_remat("remat", run)
        runs[policy] = run
    del ref
    return runs


def remat_moe(torch, dev, cfg, batch: int, wrappers: dict) -> dict:
    """Phase 23: the einsum formulation under "full" (the hold of binned:
    routing equal, loss and gradients within §2's limits), then each of
    MOE_POLICY_RUNS; the second dropless run is held to the first, and
    every run's launches to ``remat_launches``."""
    from k8s_dra_driver_tpu_torch.models import moe

    moe.MOE_TRACE_COUNTS.clear()
    runs, held = {}, {}
    for impl, policy in (("einsum", "full"),) + MOE_POLICY_RUNS:
        label = f"8x7b-L1 {impl}"
        run = remat_run(torch, dev, dataclasses.replace(cfg, moe_impl=impl),
                        label, batch, policy, wrappers,
                        hold=held.get("einsum" if impl == "binned"
                                      else impl))
        first, routing = run.pop("first"), run.pop("routing")
        held.setdefault(impl, first)
        if impl == "einsum":
            held["routing"] = routing
        elif impl == "binned":
            same = [torch.equal(a, b) for a, b in zip(routing,
                                                      held["routing"])]
            run["routing_equal_layers"] = sum(same)
            if not all(same) or len(same) != cfg.n_layers:
                raise AssertionError(f"{label} {policy}: routing differs "
                                     f"from einsum's ({same})")
        hold_launches(f"{label} {policy}", run,
                      remat_launches(cfg, impl, policy))
        log_remat("moe remat", run)
        runs[f"{impl}/{policy}"] = run
    held.clear()
    want = {f"{impl}:fused:t{batch * TRAIN_SEQ}"
            for impl in ("einsum", "dropless", "binned")}
    if set(moe.MOE_TRACE_COUNTS) != want:
        raise AssertionError(f"MoE blocks {dict(moe.MOE_TRACE_COUNTS)}, "
                             f"expected {want}")
    return runs


def checkpoint_resume(torch, dev, cfg, batch: int) -> dict:
    """Phase 24: ``make_train_step`` (remat "full") on ``cfg`` at batch
    ``batch`` x 2048: CKPT_STEPS AdamW steps, ``save_checkpoint``,
    CKPT_STEPS more steps; then ``restore_checkpoint`` into a fresh
    state's template (``restore_template``) and the same CKPT_STEPS
    steps. Losses, parameters and both moments must be bitwise equal. The
    checkpoint goes to ``build/checkpoints`` (removed after), whose disk
    must hold it twice."""
    from k8s_dra_driver_tpu_torch.models import (
        init_train_state,
        latest_step,
        make_optimizer,
        make_train_step,
        restore_checkpoint,
        restore_template,
        save_checkpoint,
    )
    from k8s_dra_driver_tpu_torch.models.train import leaves

    directory = ROOT / "build" / "checkpoints"
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    opt = make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    state = init_train_state(cfg, opt, seed=SEED, device=dev)

    def tensors(st):
        return (leaves(st.params) + leaves(st.opt_state.mu)
                + leaves(st.opt_state.nu))

    state_bytes = sum(t.numel() * t.element_size() for t in tensors(state))
    free = shutil.disk_usage(directory).free
    if free < 2 * state_bytes:
        raise AssertionError(f"checkpoint: {free / 1e9:.2f} GB free under "
                             f"{directory}, the phase needs "
                             f"{2 * state_bytes / 1e9:.2f} GB")
    step = make_train_step(cfg, opt, remat=True, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 24)
    batches = [torch.randint(0, cfg.vocab_size, (batch, TRAIN_SEQ + 1),
                             generator=gen, device=dev)
               for _ in range(2 * CKPT_STEPS)]
    losses = [step(state, b)[1].item() for b in batches[:CKPT_STEPS]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(directory), state, state.step)
    save_s = time.perf_counter() - t0
    saved_step = latest_step(str(directory))
    file_bytes = (directory / str(saved_step) / "state.pt").stat().st_size
    straight = [step(state, b)[1].item() for b in batches[CKPT_STEPS:]]

    template = restore_template(
        init_train_state(cfg, opt, seed=SEED + 1, device=dev), None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = restore_checkpoint(str(directory), template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if resumed.step != saved_step or resumed.opt_state.count != saved_step:
        raise AssertionError(f"restored step {resumed.step}, count "
                             f"{resumed.opt_state.count}; saved {saved_step}")
    again = [step(resumed, b)[1].item() for b in batches[CKPT_STEPS:]]
    unequal = sum(not torch.equal(a, b)
                  for a, b in zip(tensors(state), tensors(resumed)))
    shutil.rmtree(directory)
    result = dict(layers=cfg.n_layers, batch=batch, seq=TRAIN_SEQ,
                  params=cfg.num_params(), state_gb=state_bytes / 1e9,
                  file_gb=file_bytes / 1e9, save_s=save_s,
                  restore_s=restore_s,
                  save_gb_per_s=file_bytes / 1e9 / save_s,
                  restore_gb_per_s=file_bytes / 1e9 / restore_s,
                  losses=losses + straight, resumed_losses=again,
                  unequal_tensors=unequal, step=state.step)
    log(f"checkpoint: {json.dumps(result)}")
    if again != straight or unequal:
        raise AssertionError(f"checkpoint: the resumed run differs: losses "
                             f"{again} vs {straight}, {unequal} tensors "
                             f"unequal")
    return result


KERNEL_GROUPS = (  # (group, substrings of the kernel names it takes)
    # int8_matmul's wgmma body (M > 64), then its M <= 64 body and the
    # split-K pass both bodies share.
    ("int8_matmul_wide", ("int8_matmul_wide_kernel",)),
    ("int8_matmul", ("int8_matmul_kernel", "int8_matmul_reduce")),
    # The int8 branches first: the bf16 groups' substrings match them too.
    # K2 and K3 by kernel; each group also takes the names of the earlier
    # single-body design (paged_attention_kernel<D, ROWS, DECODE, QUANT>),
    # so a tree from before the redesign is profiled the same way.
    ("paged_decode_int8", tuple(f"paged_decode_kernel<{d}, {g}, true>"
                                for d in (64, 128) for g in (1, 2, 4, 8))
     + ("paged_attention_kernel<64, 8, true, true>",
        "paged_attention_kernel<128, 8, true, true>")),
    ("paged_prefill_int8", ("paged_prefill_kernel<64, true>",
                            "paged_prefill_kernel<128, true>",
                            "paged_attention_kernel<64, 64, false, true>",
                            "paged_attention_kernel<128, 64, false, true>")),
    ("paged_decode_merge", ("paged_decode_merge_kernel",)),
    ("paged_decode", ("paged_decode_kernel",
                      "paged_attention_kernel<64, 8, true",
                      "paged_attention_kernel<128, 8, true")),
    ("paged_prefill", ("paged_prefill_kernel", "paged_attention_kernel")),
    # K7 and K8 by branch: the body (moe_dispatch_kernel<GATEUP, INT8, SB,
    # FORM>) and the int8 K8's split pass (moe_split_reduce); each group also
    # takes the names of the mma.sync design before it (moe_grouped_kernel<
    # BM, GATEUP, INT8>), so a tree from before the redesign is profiled
    # the same way.
    ("moe_gateup_int8", ("moe_dispatch_kernel<true, true",
                         "moe_grouped_kernel<16, true, true>",
                         "moe_grouped_kernel<64, true, true>",
                         "moe_grouped_kernel<128, true, true>")),
    ("moe_down_combine_int8", ("moe_dispatch_kernel<false, true",
                               "moe_split_reduce",
                               "moe_grouped_kernel<16, false, true>",
                               "moe_grouped_kernel<64, false, true>",
                               "moe_grouped_kernel<128, false, true>")),
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd_dkdv", ("flash_bwd_dkdv_kernel",)),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("moe_gateup", ("moe_dispatch_kernel<true, false",
                    "moe_grouped_kernel<16, true", "moe_grouped_kernel<64, "
                    "true", "moe_grouped_kernel<128, true")),
    ("moe_down_combine", ("moe_dispatch_kernel<false, false",
                          "moe_grouped_kernel<16, false",
                          "moe_grouped_kernel<64, false",
                          "moe_grouped_kernel<128, false")),
    # K10a and K10b are one template, grouped_kernel<KIND, ...>: KIND 0 is
    # gmm, 1 is tgmm.
    ("tgmm", ("grouped_kernel<1,",)),
    ("gmm", ("grouped_kernel<0,",)),
    ("rmsnorm", ("_rmsnorm_row",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
)


def profile_step(torch, step, state, tokens) -> dict:
    """One more train step under ``torch.profiler``: device time by kernel
    group, and the device's busy share of the step's wall time."""
    return device_profile(torch, lambda: step(state, tokens), 1)


def device_profile(torch, fn, calls: int, allow_empty=False) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``: per call, the
    wall time, the device time by kernel group, and the device's busy
    share of the wall time. Raises where the profiler saw no device time,
    unless ``allow_empty``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / calls
        kernels.append((ms, e.count // calls, e.key[:80]))
        group = next((name for name, keys in KERNEL_GROUPS
                      if any(k in e.key for k in keys)), "other")
        groups[group] += ms
    device_ms = sum(groups.values())
    if device_ms <= 0 and not allow_empty:
        raise AssertionError("the profiler saw no device time")
    kernels.sort(reverse=True)
    return dict(
        wall_ms=wall_ms, device_ms=device_ms,
        device_busy_share=device_ms / wall_ms, group_ms=groups,
        top_kernels=[dict(ms=ms, count=n, name=name)
                     for ms, n, name in kernels[:12]],
    )


def profile_decode(torch, params, cfg, dev, quantize_cache=False) -> dict:
    """One decode step at the engine's shape (8 sequences at 384 cached
    positions, kernels on): its host-clock time over 5 steps, then 3 steps
    under ``torch.profiler``, and the ratio of the two; then the same step
    captured by ``StepGraph``, as the engine runs it (``captured_*``)."""
    from k8s_dra_driver_tpu_torch.models.decode import _forward_with_cache
    from k8s_dra_driver_tpu_torch.models.paged import (
        PagedKVCache,
        PagedQuantKVCache,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 30)
    cache_cls = PagedQuantKVCache if quantize_cache else PagedKVCache
    cache = cache_cls.init(cfg, BATCH_SLOTS, 1024, block_size=BLOCK_SIZE,
                           device=dev)
    chunk = 64           # 8 x 64 = 512 tokens a chunk: dropless, as served
    for c in range(6):
        toks = torch.randint(0, cfg.vocab_size, (BATCH_SLOTS, chunk),
                             generator=gen, device=dev, dtype=torch.int32)
        _, cache = _forward_with_cache(
            params, toks, cache, cfg,
            torch.arange(c * chunk, (c + 1) * chunk, device=dev))
    state = {"cache": cache,
             "tok": torch.randint(0, cfg.vocab_size, (BATCH_SLOTS, 1),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)}

    def step():
        c = state["cache"]
        logits, state["cache"] = _forward_with_cache(
            params, state["tok"], c, cfg, c.lengths[:, None])
        state["tok"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    result = dict(step_ms=step_ms, **device_profile(torch, step, 3))
    # The profiled steps' device time over the unprofiled steps' host time:
    # the busy share without the profiler's own host cost (two
    # measurements of one run; device_busy_share is the profiled one).
    result["device_ms_over_step_ms"] = result["device_ms"] / step_ms
    result["int8_to_float_copies"] = int8_casts(torch, step)
    result.update(captured_decode(torch, params, cfg, state))
    log("decode step profile:", json.dumps(result))
    return result


def captured_decode(torch, params, cfg, state) -> dict:
    """``profile_decode``'s step captured by ``StepGraph`` and replayed as
    the engine replays its decode step (host ints staged, the previous
    tokens copied in, lengths advanced on the host): the host-clock time
    a step over 5 replays, the device time of one replay by CUDA events
    (median of 5, the card held busy first so the host's enqueue stays
    outside), and 3 replays under ``torch.profiler``, which may not see
    the kernels inside a graph; where it sees none, the line says so and
    the group split is the eager step's."""
    from k8s_dra_driver_tpu_torch.models.decode import _forward_with_cache
    from k8s_dra_driver_tpu_torch.models.step_graph import StepGraph

    cache = state["cache"]
    tables = cache.block_tables.cpu().numpy()
    lengths = cache.lengths.cpu().numpy().copy()

    def fn(tables, lengths, tok):
        # Zeroed lengths (the warm-up's inputs) write no pool row.
        c = dataclasses.replace(cache, block_tables=tables, lengths=lengths)
        logits, _ = _forward_with_cache(params, tok, c, cfg,
                                        lengths[:, None], active=lengths > 0)
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    counts = {"decode_step": 0}
    graph = StepGraph(fn, cache.lengths.device, counts=counts,
                      name="decode_step")
    tok = [state["tok"]]

    def step():
        tok[0] = graph((tables, lengths), tok[0])
        lengths[:] += 1

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 5
    pairs = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        step()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    device_ms = statistics.median(s.elapsed_time(e) for s, e in pairs)
    prof = device_profile(torch, step, 3, allow_empty=True)
    if counts != {"decode_step": 1} or graph.graphs != 1:
        raise AssertionError(f"captured decode step: {counts}, "
                             f"{graph.graphs} graphs")
    seen = prof["device_ms"] > 0
    return dict(
        captured_step_ms=step_ms, captured_device_ms=device_ms,
        captured_device_over_step=device_ms / step_ms,
        captured_profiler_sees_kernels=seen,
        captured_profile=(
            {k: prof[k] for k in ("wall_ms", "device_ms", "group_ms")}
            if seen else "the profiler saw no kernel inside the replays: "
            "device time from CUDA events, the group split the eager "
            "step's"))


def profile_prefill(torch, params, cfg, dev, quantize_cache=False) -> dict:
    """One packed prefill launch at the engine's shape (4 lanes x 128
    tokens, windows from phase 2's K3 starts 0/256/384/572), kernels on:
    per launch, the device time by kernel group over 3 launches under
    ``torch.profiler``."""
    from k8s_dra_driver_tpu_torch.models.decode import _forward_with_cache
    from k8s_dra_driver_tpu_torch.models.paged import (
        PagedKVCache,
        PagedQuantKVCache,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)
    cache_cls = PagedQuantKVCache if quantize_cache else PagedKVCache
    cache = cache_cls.init(cfg, PREFILL_BATCH, 1024, block_size=BLOCK_SIZE,
                           device=dev)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_CHUNK),
                         generator=gen, device=dev, dtype=torch.int32)
    pos = (torch.tensor([0, 256, 384, 572], device=dev)[:, None]
           + torch.arange(PREFILL_CHUNK, device=dev)[None, :])

    def launch():
        _forward_with_cache(params, toks, cache, cfg, pos)

    launch()
    result = device_profile(torch, launch, 3)
    log("prefill launch profile:", json.dumps(result))
    return result


def int8_casts(torch, fn) -> list:
    """The element count of every copy from an int8 tensor to a floating
    one that ``fn()`` makes (``aten._to_copy`` and ``aten.copy_``, seen
    through a dispatch mode): a seam that converts its weight shows here
    at the weight's size."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    seen = []

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (aten._to_copy.default, aten.copy_.default):
                src = args[1] if func is aten.copy_.default else args[0]
                if (src.dtype == torch.int8 and isinstance(out, torch.Tensor)
                        and out.dtype.is_floating_point):
                    seen.append(src.numel())
            return out

    with Casts():
        fn()
    torch.cuda.synchronize()
    return seen


def moe_bounds(plan, h, m, wbytes=2):
    """(K7, K8) as (bytes, operations) of one call from its plan: each
    touched expert's weights read once (``wbytes`` a weight; int8 experts
    add their f32 per-column scales), each live row's input read once,
    each output written once; operations over the live rows only."""
    live = int((plan.row_ids < plan.n_tokens).sum())
    touched = int((plan.sizes_aligned > 0).sum())
    scales = 4 if wbytes == 1 else 0
    gateup = (touched * 2 * m * (h * wbytes + scales) + live * h * 2
              + plan.r_pad * m * 2,
              2 * live * h * 2 * m)
    down = (touched * h * (m * wbytes + scales) + plan.r_pad * m * 2
            + plan.n_pairs * h * 4,
            2 * live * m * h)
    return gateup, down, live, touched


def check_moe_kernels(torch, params, cfg, dev, tag="") -> dict:
    """Phase 7 (bf16 experts) and phase 13 (int8 experts, the kernels'
    int8 branches): K7 and K8 against their plain versions on layer 0's
    experts, with plans from layer 0's router over normed random hidden
    states, at the decode step's shape and the packed prefill chunk's.
    Each row carries the launch ``dispatch_plan`` picked; ``tag`` names
    the widths in the log."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md
    from k8s_dra_driver_tpu_torch.ops import norms
    from k8s_dra_driver_tpu_torch.ops._device import sm_count

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    layer = {k: w[0] for k, w in params["layers"].items()}
    (q_gu, s_gu), (q_dn, s_dn) = (md._quant_parts(layer["w_gateup"]),
                                  md._quant_parts(layer["w_down"]))
    int8 = s_gu is not None
    suffix = "_int8" if int8 else ""
    h, m, e, k = cfg.hidden, cfg.mlp_hidden, cfg.n_experts, cfg.top_k

    def gateup(xf, plan, use_kernels=True, n_exp=e):
        sc = None if s_gu is None else s_gu[:n_exp]
        fn = md.moe_gateup if use_kernels else md.moe_gateup_reference
        return fn(xf, q_gu[:n_exp], plan, sc)

    def down(act, gates_pad, plan, use_kernels=True, n_exp=e):
        sc = None if s_dn is None else s_dn[:n_exp]
        fn = md.moe_down_combine if use_kernels \
            else md.moe_down_combine_reference
        return fn(act, q_dn[:n_exp], gates_pad, plan, sc)

    shapes = {}
    for name, t, tile in (("decode", BATCH_SLOTS, 8),
                          ("prefill", PREFILL_BATCH * PREFILL_CHUNK, 128)):
        x = torch.randn((t, h), generator=gen, device=dev).to(torch.bfloat16)
        xf = norms.rmsnorm_reference(x, layer["ln_mlp"], cfg.norm_eps)
        gates, experts, _, _ = moe._route_topk(xf, layer["wr"], cfg)
        plan = md.build_plan(experts.reshape(-1), t, e, k)
        if plan.tile_rows != tile:
            raise AssertionError(f"{name}: tile {plan.tile_rows}, want {tile}")
        gates_pad = md._take_rows(gates.reshape(-1), plan.pair_ids)
        act = gateup(xf, plan)
        ref_act = gateup(xf, plan, use_kernels=False)
        y = down(ref_act, gates_pad, plan)
        ref_y = down(ref_act, gates_pad, plan, use_kernels=False)
        torch.cuda.synchronize()
        act_err, act_rel = rel(f"moe_gateup{suffix} {name}{tag}", act,
                               ref_act)
        y_err, y_rel = rel(f"moe_down_combine{suffix} {name}{tag}", y, ref_y,
                           K8_REL_MAX, K8_REL_MEAN)
        launch = md.dispatch_plan(tile, plan.r_pad, h, m, int8,
                                  sm_count(dev))._asdict()
        sentinel = plan.row_ids >= plan.n_tokens
        if not bool((act[sentinel] == 0).all()):
            raise AssertionError(f"moe_gateup{suffix} {name}: a sentinel "
                                 f"row is not exactly 0")
        extra = {}
        if name == "decode":
            # The expert-parallel local view: experts 0-3 local, pairs of
            # 4-7 foreign. Their slots, and every sentinel row, must be
            # exactly 0.
            flat = experts.reshape(-1)
            local = torch.where(flat < 4, flat, torch.full_like(flat, 4))
            lplan = md.build_plan(local, t, 4, k)
            lgates = md._take_rows(gates.reshape(-1), lplan.pair_ids)
            lact = gateup(xf, lplan, n_exp=4)
            ly = down(lact, lgates, lplan, n_exp=4)
            ref_ly = down(gateup(xf, lplan, use_kernels=False, n_exp=4),
                          lgates, lplan, use_kernels=False, n_exp=4)
            torch.cuda.synchronize()
            # K7 then K8 against both plain versions: K7's bf16 act error
            # reaches ly, so the bf16 limits hold here.
            rel(f"moe_dispatch{suffix} decode{tag}, experts 0-3 local",
                ly, ref_ly)
            foreign = flat >= 4
            if not (bool(foreign.any()) and bool((ly[foreign] == 0).all())
                    and bool((lact[lplan.row_ids >= t] == 0).all())):
                raise AssertionError("foreign pair slots or sentinel rows "
                                     "are not exactly 0")
            extra = dict(foreign_pairs=int(foreign.sum()))
        (gb, gops), (db, dops), live, touched = moe_bounds(
            plan, h, m, wbytes=1 if int8 else 2)
        rows = {}
        for kname, nbytes, ops, kernel_fn, plain_fn, err, r in (
            ("moe_gateup" + suffix, gb, gops,
             lambda: gateup(xf, plan),
             lambda: gateup(xf, plan, use_kernels=False),
             act_err, act_rel),
            ("moe_down_combine" + suffix, db, dops,
             lambda: down(ref_act, gates_pad, plan),
             lambda: down(ref_act, gates_pad, plan, use_kernels=False),
             y_err, y_rel),
        ):
            rows[kname] = dict(
                max_abs_err=err, rel_err=r,
                ms=time_ms(kernel_fn), plain_ms=time_ms(plain_fn, warmup=1,
                                                        iters=5),
                library_ms=None,
                shape=(f"T {t}, tile {tile}, r_pad {plan.r_pad}, live rows "
                       f"{live}, experts touched {touched}, h {h}, m {m}"
                       + (", int8 experts" if int8 else "")),
                **bound_fields(f"{kname} {name}{tag}", nbytes, ops,
                               BF16_FLOPS),
                plan=launch, **extra,
            )
        shapes[name] = rows
        torch.cuda.empty_cache()
    # The kernels line carries the decode step's numbers (the shape launched
    # most) with the prefill chunk's beside them.
    return {kname: dict(shapes["decode"][kname],
                        max_abs_err=max(shapes[s][kname]["max_abs_err"]
                                        for s in shapes),
                        prefill=shapes["prefill"][kname])
            for kname in ("moe_gateup" + suffix, "moe_down_combine" + suffix)}


def grouped_bounds(live: int, touched: int, k: int, n: int, r_pad: int,
                   weight_grad: bool):
    """(bytes, operations) of one grouped call from the run's plan:
    operations over the live rows only (K7's convention); gmm reads the
    touched experts' [K, N] weights and the live lhs rows and writes
    r_pad output rows in bf16; tgmm reads the live rows of both operands
    and writes [E, K, N] f32."""
    ops = 2 * live * k * n
    if weight_grad:
        return live * (k + n) * 2 + touched * k * n * 4, ops
    return touched * k * n * 2 + live * k * 2 + r_pad * n * 2, ops


def library_grouped_mm(torch, lhs, rhs, offs, weight_grad: bool) -> tuple:
    """The time of one ``torch._grouped_mm`` call computing the same
    function (bf16, cumulative int32 offsets: for gmm lhs [rows, K] by rhs
    [E, K, N]; for tgmm the 2-D x 2-D form lhs^T [K, rows] by rhs [rows,
    N], offsets on the contracted axis), with the operands as given or,
    if the card's torch refuses that layout, copied contiguous outside the
    timed call; and the refusals. A yardstick only: the port never calls
    it."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, ["torch has no _grouped_mm"]
    a = lhs.t() if weight_grad else lhs
    layouts = ((lambda: (a, rhs)),
               (lambda: (a.contiguous(), rhs.contiguous())))
    errors = []
    for layout in layouts:
        args = (*layout(), offs)
        try:
            fn(*args)
            torch.cuda.synchronize()
        except Exception as exc:  # the refusal is the number's record
            errors.append(f"{type(exc).__name__}: {exc}"[:300])
            continue
        return time_ms(lambda: fn(*args), iters=10), errors
    return None, errors


def check_grouped_kernels(torch, cfg, dev) -> dict:
    """Phase 10: K10a ``gmm`` and K10b ``tgmm`` against their plain
    versions at the five calls of one 8x7b layer's MoE backward
    (``FusedMoeMlpFunction.backward``): T = 8192 tokens (batch 4 x 2048)
    routed by the layer's router over normed random hidden states (tile
    128, r_pad 17408), a random cotangent, the backward's own operands
    (dgu and dys from the plain products). Then an unaligned case (empty
    groups, rows past the last group: exactly 0), and the gradients of
    ``GroupedMatmulFunction`` and ``FusedMoeMlpFunction``, kernels against
    plain versions on the same inputs and cotangent. Times each call
    (L2 flushed, CUDA events) beside its bound and ``torch._grouped_mm``.
    Also holds K7 and K8 (bf16) against their plain versions on the same
    plan and times them (rows ``moe_gateup_train`` and
    ``moe_down_combine_train``), beside ``gmm`` on the same product."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md
    from k8s_dra_driver_tpu_torch.ops import norms

    params = moe.init_params(cfg, seed=SEED + 5, device=dev)
    layer = {k: w[0] for k, w in params["layers"].items()}
    del params
    w_gu, w_down = layer["w_gateup"], layer["w_down"]
    h, m, e, k = cfg.hidden, cfg.mlp_hidden, cfg.n_experts, cfg.top_k
    t = MOE_TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 40)
    x = torch.randn((t, h), generator=gen, device=dev).to(torch.bfloat16)
    xf = norms.rmsnorm_reference(x, layer["ln_mlp"], cfg.norm_eps)
    gates, experts, _, _ = moe._route_topk(xf, layer["wr"], cfg)
    gates = gates.reshape(-1)
    plan = md.build_plan(experts.reshape(-1), t, e, k)
    if plan.tile_rows != 128 or plan.r_pad != 17408:
        raise AssertionError(f"plan tile {plan.tile_rows}, r_pad "
                             f"{plan.r_pad}; want 128 and 17408")
    sizes = plan.sizes_aligned
    valid = (plan.pair_ids < plan.n_pairs)[:, None]
    live = int(valid.sum())
    touched = int((sizes > 0).sum())
    dy = torch.randn((plan.n_pairs, h), generator=gen, device=dev)
    dyw32 = md._take_rows(dy, plan.pair_ids)
    dyw = dyw32.to(torch.bfloat16)
    xs = md._take_rows(xf, plan.row_ids)
    act = md.moe_gateup_reference(xf, w_gu, plan)
    w2 = md._gu_2d(w_gu)
    # The backward's other two operands, as FusedMoeMlpFunction.backward
    # computes them (from the plain products: both sides take the same).
    q = md.grouped_matmul_reference(dyw, w_down.transpose(1, 2),
                                    sizes).float() * valid
    gates_pad = md._take_rows(gates, plan.pair_ids)
    dact = q * gates_pad[:, None]
    del q
    gu = md.grouped_matmul_reference(xs, w2, sizes).float() * valid
    dgu = md.swiglu_backward(gu, dact).to(torch.bfloat16)
    del gu, dact
    dys = (dyw32 * gates_pad[:, None]).to(torch.bfloat16)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    r_pad = plan.r_pad

    # (name, lhs, rhs, K, N, weight_grad)
    calls = (
        ("gmm dyw.w_down^T", dyw, w_down.transpose(1, 2), h, m, False),
        ("gmm xs.w2", xs, w2, h, 2 * m, False),
        ("gmm dgu.w2^T", dgu, w2.transpose(1, 2), 2 * m, h, False),
        ("tgmm xs^T.dgu", xs, dgu, h, 2 * m, True),
        ("tgmm act^T.dys", act, dys, m, h, True),
    )
    row_group = plan.tile_expert.long().repeat_interleave(plan.tile_rows)
    rows = {"grouped_matmul": {}, "grouped_weight_grad": {}}
    for name, lhs, rhs, kk, nn, wgrad in calls:
        if wgrad:
            kernel = lambda: md.grouped_weight_grad(  # noqa: E731
                lhs, rhs, sizes, row_group, e)
            plain = lambda: md.grouped_weight_grad_reference(  # noqa: E731
                lhs, rhs, row_group, e)
            limits = (K8_REL_MAX, K8_REL_MEAN)
        else:
            kernel = lambda: md.grouped_matmul(lhs, rhs, sizes)  # noqa: E731
            plain = lambda: md.grouped_matmul_reference(  # noqa: E731
                lhs, rhs, sizes)
            limits = (2e-2, 1e-2)
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, r = rel(name, out, ref, *limits)
        if not wgrad and not bool((out[int(offs[-1]):] == 0).all()):
            raise AssertionError(f"{name}: rows past the groups are not 0")
        del out, ref
        nbytes, ops = grouped_bounds(live, touched, kk, nn, r_pad, wgrad)
        t_b, by = bound(nbytes, ops, BF16_FLOPS)
        log(f"{name} bound: {nbytes / 1e9:.3f} GB, {ops:.3e} operations "
            f"-> {t_b:.4f} ms ({by})")
        lib_ms, lib_errors = library_grouped_mm(torch, lhs, rhs, offs,
                                                wgrad)
        rows["grouped_weight_grad" if wgrad else "grouped_matmul"][name] = dict(
            max_abs_err=err, rel_err=r, ms=time_ms(kernel, iters=10),
            plain_ms=time_ms(plain, warmup=1, iters=3), bound_ms=t_b,
            bound_by=by, library_ms=lib_ms, library_errors=lib_errors,
            shape=(f"lhs {list(lhs.shape)}, K {kk}, N {nn}, live rows "
                   f"{live}, experts touched {touched}"))
        torch.cuda.empty_cache()
    del xs, dgu, dys, dyw, dyw32

    # K7 and K8 (bf16) at the training shape, on the same plan: their rows
    # moe_gateup_train and moe_down_combine_train, beside gmm on the same
    # product (xs . w2, and act . w_down) as a yardstick.
    (gb, gops), (db, dops), _, _ = moe_bounds(plan, h, m)
    gates_pad = gates_pad.contiguous()
    train_rows = {}
    for kname, nbytes, ops, kernel, plain, limits, gmm_ms in (
        ("moe_gateup_train", gb, gops,
         lambda: md.moe_gateup(xf, w_gu, plan),
         lambda: md.moe_gateup_reference(xf, w_gu, plan), (2e-2, 1e-2),
         rows["grouped_matmul"]["gmm xs.w2"]["ms"]),
        ("moe_down_combine_train", db, dops,
         lambda: md.moe_down_combine(act, w_down, gates_pad, plan),
         lambda: md.moe_down_combine_reference(act, w_down, gates_pad, plan),
         (K8_REL_MAX, K8_REL_MEAN),
         time_ms(lambda: md.grouped_matmul(act, w_down, sizes), iters=10)),
    ):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, r = rel(f"{kname} T {t}", out, ref, *limits)
        if kname == "moe_gateup_train" and not bool(
                (out[plan.row_ids >= plan.n_tokens] == 0).all()):
            raise AssertionError("moe_gateup_train: a sentinel row is not 0")
        del out, ref
        train_rows[kname] = dict(
            max_abs_err=err, rel_err=r, ms=time_ms(kernel, iters=10),
            plain_ms=time_ms(plain, warmup=1, iters=3), library_ms=None,
            gmm_ms=gmm_ms,
            shape=(f"T {t}, tile {plan.tile_rows}, r_pad {r_pad}, live rows "
                   f"{live}, experts touched {touched}, h {h}, m {m}"),
            **bound_fields(f"{kname} T {t}", nbytes, ops, BF16_FLOPS))
        torch.cuda.empty_cache()
    log("K7/K8 at the training shape:", json.dumps(train_rows))

    # Unaligned groups: an empty group, 92 rows past the last one.
    rsizes = torch.tensor(RAGGED_SIZES, dtype=torch.int32, device=dev)
    total = sum(RAGGED_SIZES)
    lhs = torch.randn((RAGGED_ROWS, h), generator=gen, device=dev).to(
        torch.bfloat16)
    out = md.grouped_matmul(lhs, w_down.transpose(1, 2), rsizes)
    ref = md.grouped_matmul_reference(lhs, w_down.transpose(1, 2), rsizes)
    wg = md.grouped_weight_grad(act[:RAGGED_ROWS], lhs, rsizes, None, e)
    wg_ref = md.grouped_weight_grad_reference(
        act[:RAGGED_ROWS], lhs, md._row_groups(rsizes, RAGGED_ROWS), e)
    torch.cuda.synchronize()
    rel("gmm unaligned groups", out, ref)
    rel("tgmm unaligned groups", wg, wg_ref, K8_REL_MAX, K8_REL_MEAN)
    empty = [i for i, n in enumerate(RAGGED_SIZES) if n == 0]
    if not (bool((out[total:] == 0).all())
            and all(bool((wg[i] == 0).all()) for i in empty)):
        raise AssertionError("unaligned groups: rows past the groups or "
                             "empty groups are not exactly 0")
    ragged = dict(rows=RAGGED_ROWS, sizes=list(RAGGED_SIZES),
                  rows_past_groups=RAGGED_ROWS - total, empty_groups=empty)
    del out, ref, wg, wg_ref, lhs

    # Gradients, kernels against plain versions on the same cotangent.
    grads = {}
    cot = torch.randn((r_pad, h), generator=gen, device=dev).to(
        torch.bfloat16)
    runs = []
    for flag in (True, False):
        leaves = [act.clone().requires_grad_(),
                  w_down.clone().requires_grad_()]
        out = md.GroupedMatmulFunction.apply(*leaves, sizes, flag)
        runs.append(torch.autograd.grad(out, leaves, cot))
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dlhs", "drhs"), *runs):
        grads[f"GroupedMatmulFunction {name}"] = rel(
            f"GroupedMatmulFunction {name}", a, b_)[1]
    del runs, cot
    runs = []
    for flag in (True, False):
        leaves = [x_.clone().requires_grad_()
                  for x_ in (xf, w_gu, w_down, gates)]
        out = md.fused_moe_mlp(*leaves, plan, use_kernels=flag)
        runs.append(torch.autograd.grad(out, leaves, dy))
        del out, leaves
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dxf", "dw_gu", "dw_down", "dgates"), *runs):
        grads[f"FusedMoeMlpFunction {name}"] = rel(
            f"FusedMoeMlpFunction {name}", a, b_)[1]
    del runs
    torch.cuda.empty_cache()

    result = {}
    for kname, by_call in rows.items():
        # The row's numbers: the calls of one layer's backward, summed.
        result[kname] = dict(
            max_abs_err=max(c["max_abs_err"] for c in by_call.values()),
            **{key: sum(c[key] for c in by_call.values())
               for key in ("ms", "plain_ms", "bound_ms")},
            bound_by="operations" if all(
                c["bound_by"] == "operations" for c in by_call.values())
            else "bytes",
            library_ms=(sum(c["library_ms"] for c in by_call.values())
                        if all(c["library_ms"] is not None
                               for c in by_call.values()) else None),
            shape=(f"the {len(by_call)} calls of one layer's MoE backward "
                   f"at T {t}, tile 128, r_pad {r_pad}, summed"),
            calls=by_call, unaligned=ragged, function_grad_rel=grads,
        )
    log("grouped kernels:", json.dumps(result))
    return {**result, **train_rows}


def int8_moe_params(torch, cfg, dev) -> dict:
    """Phase 14's weights: ``cfg`` at full depth, int8 from
    ``quantize_params``, built without the bf16 tree (93 GB at 8x7b): layer
    i is drawn alone (``moe.init_params`` of the one-layer config, seed
    SEED + i), quantized and copied into preallocated stacks. The
    embedding, LM head and final norm are layer 0's draw."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.quant import (
        QuantTensor,
        quantize_params,
    )

    one = dataclasses.replace(cfg, n_layers=1)
    n = cfg.n_layers

    def stack(w):
        if isinstance(w, QuantTensor):
            return QuantTensor(q=stack(w.q), scale=stack(w.scale))
        return torch.empty((n,) + tuple(w.shape[1:]), dtype=w.dtype,
                           device=dev)

    out = None
    for i in range(n):
        part = quantize_params(moe.init_params(one, seed=SEED + i,
                                               device=dev))
        if out is None:
            out = dict(part, layers={name: stack(w) for name, w in
                                     part["layers"].items()})
        for name, w in part["layers"].items():
            dst = out["layers"][name]
            if isinstance(w, QuantTensor):
                dst.q[i].copy_(w.q[0])
                dst.scale[i].copy_(w.scale[0])
            else:
                dst[i].copy_(w[0])
        del part
    return out


# Phase 16: the int8 seams of Mixtral-8x7B (K -> N) and its einsum MoE
# body's expert product (E, capacity rows, K -> N).
INT8_SEAMS = (("wqkv", 4096, 6144), ("wo", 4096, 4096),
              ("lm_head", 4096, 32000))
INT8_EXPERTS = (8, 512, 4096, 28672)


def int8pack_ms(torch, x, q, scale):
    """The time of ``torch._weight_int8pack_mm`` on the same weight (stored
    [N, K], copied so outside the timed call), or None and its refusal:
    a yardstick the port never calls."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "torch has no _weight_int8pack_mm"
    try:
        qt = q.t().contiguous()
        sc = scale.reshape(-1).to(x.dtype)
        fn(x, qt, sc)
        torch.cuda.synchronize()
    except Exception as exc:  # the refusal is the number's record
        return None, f"{type(exc).__name__}: {exc}"[:300]
    return time_ms(lambda: fn(x, qt, sc)), None


def check_int8_matmul(torch, dev) -> dict:
    """Phase 16: ``int8_matmul`` in both modes against its plain version at
    the seams' shapes (decode M 8 and a packed prefill's M 512, K 4096 to
    N 6144, 4096 and 32000) and in the prologue mode at the einsum MoE
    body's expert shape ([8, 512, 4096] against [8, 4096, 28672]). Random
    int8 weights and per-column scales, random bf16 activations. Times each
    call beside its bound, its plain version and the library's yardsticks
    (a bf16 ``torch.matmul`` on a weight converted beforehand, and
    ``torch._weight_int8pack_mm`` where it runs)."""
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm
    from k8s_dra_driver_tpu_torch.ops._device import sm_count

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 70)

    def weight(*shape):
        q = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        k = shape[-2]
        scale = (0.5 + torch.rand(shape[:-2] + (1, shape[-1]), generator=gen,
                                  device=dev)) / (127 * k ** 0.5)
        return q, scale

    cases = []
    for name, k, n in INT8_SEAMS:
        q, scale = weight(k, n)
        for m in (BATCH_SLOTS, PREFILL_BATCH * PREFILL_CHUNK):
            for prologue in (False, True):
                cases.append((f"{name} M {m}" + (" prologue" if prologue
                                                 else ""),
                              m, None, q, scale, prologue))
    e, m_e, k_e, n_e = INT8_EXPERTS
    q, scale = weight(e, k_e, n_e)
    cases.append((f"experts [{e},{m_e},{k_e}]x[{e},{k_e},{n_e}] prologue",
                  m_e, e, q, scale, True))
    calls = {}
    for name, m, e_, q, scale, prologue in cases:
        k, n = q.shape[-2:]
        shape = (m, k) if e_ is None else (e_, m, k)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        out = qm.int8_matmul(x, q, scale, prologue)
        ref = qm.int8_matmul_reference(x, q, scale, prologue)
        torch.cuda.synchronize()
        err, r = rel(f"int8_matmul {name}", out, ref)
        del out, ref
        ne = e_ or 1
        nbytes = ne * (k * n + 4 * n + 2 * m * k + 2 * m * n)
        ops = 2 * ne * m * k * n
        wb = (q.float() * scale).to(torch.bfloat16)
        lib_ms = time_ms(lambda: torch.matmul(x, wb))
        del wb
        pack_ms, pack_error = (int8pack_ms(torch, x, q, scale)
                               if e_ is None else (None, "batched"))
        calls[name] = dict(
            max_abs_err=err, rel_err=r,
            ms=time_ms(lambda: qm.int8_matmul(x, q, scale, prologue)),
            plain_ms=time_ms(lambda: qm.int8_matmul_reference(
                x, q, scale, prologue), warmup=1, iters=5),
            library_ms=lib_ms, int8pack_ms=pack_ms,
            int8pack_error=pack_error,
            plan=qm.plan(ne, m, n, k, sm_count(dev))._asdict(),
            **bound_fields(f"int8_matmul {name}", nbytes, ops, BF16_FLOPS))
        torch.cuda.empty_cache()
    # The kernels line carries one decode step's three seam calls (M 8,
    # the epilogue mode the seams run, the mma.sync body), summed, with
    # every call beside; a packed prefill's three (M 512, the wgmma body),
    # summed; and the einsum MoE body's expert product (the wgmma body,
    # prologue mode).
    def summed(m, body):
        step = [calls[f"{name} M {m}"] for name, _, _ in INT8_SEAMS]
        return dict(
            max_abs_err=max(c["max_abs_err"] for c in step),
            **{key: sum(c[key] for c in step)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            bound_by="bytes" if all(c["bound_by"] == "bytes" for c in step)
            else "operations",
            shape=(" + ".join(name for name, _, _ in INT8_SEAMS)
                   + f" at M {m} ("
                   + ", ".join(f"K {k} -> N {n}" for _, k, n in INT8_SEAMS)
                   + f"), epilogue mode, {body}, summed; library: bf16 "
                   f"torch.matmul on weights converted beforehand"))

    rows = {"int8_matmul": dict(summed(BATCH_SLOTS, "the M <= 64 body"),
                                calls=calls),
            "int8_matmul_prefill": summed(PREFILL_BATCH * PREFILL_CHUNK,
                                          "the wgmma body")}
    experts = calls[f"experts [{e},{m_e},{k_e}]x[{e},{k_e},{n_e}] prologue"]
    rows["int8_matmul_experts"] = dict(
        {key: experts[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "plan")},
        shape=(f"experts [{e},{m_e},{k_e}] x [{e},{k_e},{n_e}], prologue "
               f"mode, the wgmma body; library: batched bf16 torch.matmul "
               f"on weights converted beforehand"))
    for name in ("int8_matmul_prefill", "int8_matmul_experts"):
        log(f"{name}:", json.dumps(rows[name]))
    log("int8_matmul:", json.dumps(rows["int8_matmul"]))
    return rows


# Phase 17: a prompt long enough that ``auto`` runs the einsum MoE body.
EINSUM_PROMPT = 1024


def einsum_prefill(torch, params, cfg, dev) -> dict:
    """Phase 17: one ``prefill`` of an EINSUM_PROMPT-token prompt on the
    full-depth int8 model (``auto`` sends it to the einsum MoE body, whose
    expert products run ``int8_matmul``'s prologue mode), held against the
    plain forward on the same tokens with the kernel run's expert choices
    replayed (phase 14's limits). The peak device memory above the weights
    must stay below one layer's ``w_gateup`` in bf16: a whole-stack
    dequantized copy would pass it."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.decode import (
        _forward_with_cache,
        prefill,
    )
    from k8s_dra_driver_tpu_torch.models.paged import PagedQuantKVCache
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

    t = EINSUM_PROMPT
    impl = moe.resolve_moe_impl(cfg, t)
    if impl != "einsum":
        raise AssertionError(f"a {t}-token prefill resolves to {impl}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 80)
    tokens = torch.randint(0, cfg.vocab_size, (1, t), generator=gen,
                           device=dev, dtype=torch.int32)
    max_len = t + BLOCK_SIZE
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    moe.MOE_TRACE_COUNTS.clear()
    counters = ("launches", "wide_launches", "wide_prologue_launches")
    before = [getattr(qm.int8_matmul, c) for c in counters]
    with RoutingReplay(moe) as replay:
        replay.mode = "record"
        t0 = time.perf_counter()
        logits, _ = prefill(params, tokens, cfg, max_len, quantize_cache=True,
                            block_size=BLOCK_SIZE)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launched, wide, wide_prologue = (
            getattr(qm.int8_matmul, c) - b for c, b in zip(counters, before))
        blocks = dict(moe.MOE_TRACE_COUNTS)
        replay.mode = "replay"
        cache = PagedQuantKVCache.init(cfg, 1, max_len,
                                       block_size=BLOCK_SIZE, device=dev)
        plain, _ = _forward_with_cache(params, tokens, cache, cfg,
                                       torch.arange(t, device=dev),
                                       use_kernels=False)
        plain = plain[:, -1]
    if qm.int8_matmul.launches - before[0] != launched:
        raise AssertionError("the plain forward launched int8_matmul")
    layers = cfg.n_layers
    # Per layer wqkv and wo (epilogue), w_gateup and w_down (prologue); the
    # LM head once.
    if launched != 4 * layers + 1:
        raise AssertionError(f"int8_matmul launched {launched} times, "
                             f"expected {4 * layers + 1}")
    # Every call here has M > 64 (the prompt's 1024 rows, the experts'
    # capacity): all of them run the wgmma body, the expert products in the
    # prologue mode.
    if (wide, wide_prologue) != (launched, 2 * layers):
        raise AssertionError(f"int8_matmul's wgmma body launched {wide} of "
                             f"{launched} times, {wide_prologue} in the "
                             f"prologue mode; expected all, {2 * layers}")
    if not any(key.startswith("einsum:") for key in blocks):
        raise AssertionError(f"MoE blocks {blocks}: no einsum body ran")
    gateup_bf16 = cfg.n_experts * cfg.hidden * 2 * cfg.mlp_hidden * 2
    result = dict(
        prompt=t, impl=impl, moe_blocks=blocks, int8_matmul_launches=launched,
        int8_matmul_wide_launches=wide,
        int8_matmul_wide_prologue_launches=wide_prologue,
        prefill_s=prefill_s, peak_mem_gb=peak / 1e9,
        transient_gb=(peak - base) / 1e9,
        layer_gateup_bf16_gb=gateup_bf16 / 1e9,
        max_logit_diff=(logits - plain).abs().max().item(),
        rel_logit_diff=((logits - plain).norm() / plain.norm()).item(),
        top1_agreement=float((logits.argmax(-1) == plain.argmax(-1)).all()),
        **replay.summary())
    log("einsum prefill kernels vs plain:", json.dumps(result))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("einsum prefill: non-finite logits")
    if not result["rel_logit_diff"] <= 5e-2:
        raise AssertionError(f"einsum prefill: relative logit difference "
                             f"{result['rel_logit_diff']} (limit 5e-2)")
    replay.check("einsum prefill", FLIP_MARGIN_LIMIT_KVQ)
    if not peak - base < gateup_bf16:
        raise AssertionError(f"einsum prefill: {result['transient_gb']} GB "
                             f"above the weights, at least one layer's "
                             f"w_gateup in bf16 ({gateup_bf16 / 1e9} GB)")
    return result


def profile_einsum_prefill(torch, params, cfg, dev) -> dict:
    """Phase 17's prefill once more under ``torch.profiler``, outside the
    counted run: its device time by kernel group, so ``int8_matmul``'s
    share of a long int8 prompt's time to first token is measured."""
    from k8s_dra_driver_tpu_torch.models.decode import prefill

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 80)
    tokens = torch.randint(0, cfg.vocab_size, (1, EINSUM_PROMPT),
                           generator=gen, device=dev, dtype=torch.int32)
    profile = device_profile(torch, lambda: prefill(
        params, tokens, cfg, EINSUM_PROMPT + BLOCK_SIZE, quantize_cache=True,
        block_size=BLOCK_SIZE), 1)
    int8_ms = profile["group_ms"]["int8_matmul_wide"] \
        + profile["group_ms"]["int8_matmul"]
    log(f"einsum prefill profile: {profile['device_ms']:.3f} ms of device "
        f"time, {profile['wall_ms']:.3f} ms on the host clock; int8_matmul "
        f"{int8_ms:.3f} ms ({int8_ms / profile['device_ms']:.1%}); groups "
        f"{json.dumps(profile['group_ms'])}")
    return profile


# Phase 18: the serving gateway over two 8B replicas.
GW_REQUESTS = 24
GW_SYSTEMS = 4
GW_TAIL = (32, 448)
GW_DRAIN_AFTER = 4          # gateway ticks into wave 2
GW_WARMUP_PROMPT = 200
GW_WARMUP_NEW = 4


def gateway_traffic(torch, cfg) -> list:
    """Phase 18's requests, (prompt, latency class): 4 seeded 256-token
    system prompts, each shared by 6 requests, with seeded user tails of
    32-448 tokens; every third request is ``batch``, the rest
    ``interactive``. Requests 0-11 are wave 1 (3 per system), 12-23
    wave 2."""
    rng = torch.Generator()
    rng.manual_seed(SEED + 90)

    def toks(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()

    systems = [toks(PREFIX_LEN) for _ in range(GW_SYSTEMS)]
    out = []
    for i in range(GW_REQUESTS):
        n = int(torch.randint(GW_TAIL[0], GW_TAIL[1] + 1, (1,),
                              generator=rng))
        out.append((systems[i % GW_SYSTEMS] + toks(n),
                    "batch" if i % 3 == 2 else "interactive"))
    return out


def build_fleet(torch, cfg, dev) -> dict:
    """Phase 18's fleet: two replicas ``r0`` and ``r1``, each its own
    weights from the same seed, each warmed by one direct request (its
    steps captured there, outside the gateway's traffic), behind one
    ``ServingGateway`` with affinity routing, ``KVTelemetry`` on both
    engines and a ``ServingTelemetry`` (with its ``TickProfiler``), all
    on one registry. Each warm-up must write only its own request's
    rows (and the scratch row) of its own pool: r0's pools are held
    bitwise across r1's build and capture."""
    from k8s_dra_driver_tpu_torch.models import init_params
    from k8s_dra_driver_tpu_torch.models.serving import KVTelemetry
    from k8s_dra_driver_tpu_torch.serving_gateway import (
        Router,
        ServingGateway,
        ServingTelemetry,
    )
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    gen = torch.Generator()
    gen.manual_seed(SEED + 91)
    engines, params, held = {}, {}, None
    t0 = time.perf_counter()
    for rid in ("r0", "r1"):
        params[rid] = init_params(cfg, seed=SEED, device=dev)
        eng = smoke_engine(params[rid], cfg, dev)
        warm = torch.randint(0, cfg.vocab_size, (GW_WARMUP_PROMPT,),
                             generator=gen).tolist()
        eng.submit(warm, max_new_tokens=GW_WARMUP_NEW)
        eng.run()
        torch.cuda.synchronize()
        rows = -(-(GW_WARMUP_PROMPT + GW_WARMUP_NEW) // BLOCK_SIZE) \
            * BLOCK_SIZE
        for pool in eng._pools:
            # Rows past the warm-up's blocks, up to the scratch row.
            stray = pool[:, :, rows:-1].abs().amax().item()
            if stray != 0:
                raise AssertionError(f"{rid}: the warm-up wrote outside its "
                                     f"request's rows (max {stray})")
        if held is not None:
            if not all(torch.equal(a, b)
                       for a, b in zip(engines["r0"]._pools, held)):
                raise AssertionError("r1's build and capture changed r0's "
                                     "pools")
        else:
            held = [pool.clone() for pool in eng._pools]
        engines[rid] = eng
    del held
    torch.cuda.empty_cache()
    registry = Registry()
    telemetry = ServingTelemetry(registry)
    gw = ServingGateway(registry, router=Router(policy="affinity",
                                                block_size=BLOCK_SIZE),
                        node_name="chip-smoke", telemetry=telemetry)
    kv = KVTelemetry(registry)
    for rid, eng in engines.items():
        gw.add_replica(eng, rid)
        kv.attach(eng, replica=rid)
    return dict(gw=gw, registry=registry, telemetry=telemetry,
                engines=engines, params=params,
                build_s=time.perf_counter() - t0,
                capture_s={rid: e._decode.build_s + e._prefill.build_s
                           for rid, e in engines.items()})


def serve_fleet(torch, cfg, fleet: dict) -> dict:
    """Phase 18's traffic through the gateway (a main path): wave 1, then
    wave 2 once every wave-1 request has prefilled (its prompt's blocks
    are published, so wave 2's lookups can hit); ``drain_replica("r1")``
    after GW_DRAIN_AFTER gateway ticks of wave 2 and ``resume_replica``
    once it is idle; then run to the end. Returns the handles, what each
    system's requests were routed to before the drain, and the run's
    host time."""
    from k8s_dra_driver_tpu_torch.models.serving import PREFILL, WAITING

    gw, engines = fleet["gw"], fleet["engines"]
    traffic = gateway_traffic(torch, cfg)
    half = GW_REQUESTS // 2
    base = {rid: (e.stats.decode_steps,
                  e.stats.prefill_lanes_launched // e.prefill_batch,
                  len(e.stats.token_interval_s), e.stats.ticks)
            for rid, e in engines.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = [gw.submit(p, NEW_TOKENS, latency_class=lc)
            for p, lc in traffic[:half]]
    for _ in range(10000):
        if all(r.done or (r.engine_req is not None and r.engine_req.state
                          not in (WAITING, PREFILL))
               for r in reqs):
            break
        gw.tick()
    else:
        raise AssertionError("wave 1 never finished its prefills")
    reqs += [gw.submit(p, NEW_TOKENS, latency_class=lc)
             for p, lc in traffic[half:]]
    for _ in range(GW_DRAIN_AFTER):
        gw.tick()
    placed = [r.replica_id for r in reqs]
    rerouted = gw.drain_replica("r1", reason="chip smoke drain")
    if not engines["r1"].idle:
        raise AssertionError("r1 not idle after its drain")
    gw.resume_replica("r1")
    gw.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(reqs=reqs, traffic=traffic, placed=placed,
                rerouted=rerouted, wall_s=wall, base=base,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)


def fleet_metrics(torch, cfg, fleet: dict, run: dict, counts: dict) -> dict:
    """Phase 18's holds and figures: zero loss across the drain, one
    replica per system before it, residency hits equal to the engines'
    counters with no counter drift, the four metric families rendered,
    and K1/K2/K3 launched exactly as the two replicas' forwards count."""
    gw, engines, reqs = fleet["gw"], fleet["engines"], run["reqs"]
    bad = [(r.gid, r.state, len(r.tokens) - len(r.prompt)) for r in reqs
           if r.state != "finished"
           or len(r.tokens) - len(r.prompt) != NEW_TOKENS]
    if bad or gw.counters["failed"] or len(reqs) != GW_REQUESTS:
        raise AssertionError(f"gateway lost requests: {bad}, counters "
                             f"{dict(gw.counters)}")
    for r in reqs:
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.gid}: token out of range")
    by_system = {}
    for i, rid in enumerate(run["placed"]):
        by_system.setdefault(i % GW_SYSTEMS, set()).add(rid)
    if any(len(v) != 1 for v in by_system.values()):
        raise AssertionError(f"a system's requests landed on several "
                             f"replicas before the drain: {by_system}")
    doc = gw.residency.snapshot()
    hits = sum(e.snapshot()["prefixHits"] for e in engines.values())
    drift = [rid for rid, rep in doc["replicas"].items()
             if rep["counterDrift"]]
    if doc["fleet"]["hits"] != hits or drift or hits <= 0:
        raise AssertionError(f"residency hits {doc['fleet']['hits']}, "
                             f"engines' prefixHits {hits}, drift {drift}")
    text = fleet["registry"].render()
    for family in ("tpu_dra_gw_", "tpu_dra_residency_", "tpu_dra_srv_",
                   "tpu_dra_kv_"):
        if f"\n{family}" not in text:
            raise AssertionError(f"the registry renders no {family}* "
                                 f"family")
    steps = {rid: (e.stats.decode_steps - run["base"][rid][0],
                   e.stats.prefill_lanes_launched // e.prefill_batch
                   - run["base"][rid][1])
             for rid, e in engines.items()}
    decode = sum(d for d, _ in steps.values())
    prefill = sum(p for _, p in steps.values())
    layers = cfg.n_layers
    want = {"paged_decode": layers * decode,
            "paged_prefill": layers * prefill,
            "rmsnorm": (2 * layers + 1) * (decode + prefill)}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"gateway launches {counts}, expected {want} "
                             f"(steps {steps})")
    intervals = sorted(
        x for rid, e in engines.items()
        for x in e.stats.token_interval_s[run["base"][rid][2]:])
    slo = gw.fleet_slo_summary()
    summary = fleet["telemetry"].profiler.summary()
    # The profiler sees every tick since the replicas joined the gateway
    # (their warm-ups ran before).
    ticks = {"gateway": gw.ticks,
             "engine": sum(e.stats.ticks - run["base"][rid][3]
                           for rid, e in engines.items())}
    host_ms = {}
    for key, seconds in summary["phaseSeconds"].items():
        comp = key.split("/")[0]
        host_ms[key] = seconds * 1e3 / max(ticks[comp], 1)
    tokens = sum(len(r.tokens) - len(r.prompt) for r in reqs)
    return dict(
        requests=len(reqs), tokens_generated=tokens,
        wall_s=run["wall_s"], tokens_per_s=tokens / run["wall_s"],
        decode_p50_ms=statistics.median(intervals) * 1e3,
        ttft_ms={lc: {"p50": c["ttftP50S"] * 1e3, "p99": c["ttftP99S"] * 1e3,
                      "requests": c["requests"]}
                 for lc, c in slo["classes"].items() if c["requests"]},
        routed=gw.counters["routed"], rerouted=run["rerouted"],
        shed=gw.counters["shed"], failed=gw.counters["failed"],
        affinity_hit_rate=gw.affinity_hit_rate(),
        affinity_lookups=gw.counters["affinity_lookups"],
        prefix_hits=hits, residency_fleet=doc["fleet"],
        placed=run["placed"], steps=steps, gateway_ticks=gw.ticks,
        engine_ticks={rid: e.stats.ticks - run["base"][rid][3]
                      for rid, e in engines.items()},
        gateway_host_ms_per_tick=sum(
            v for k, v in host_ms.items() if k.startswith("gateway/")),
        engine_host_ms_per_tick=sum(
            v for k, v in host_ms.items() if k.startswith("engine/")),
        phase_ms_per_tick=host_ms,
        peak_mem_gb=run["peak_mem_gb"],
        peak_reserved_gb=run["peak_reserved_gb"],
        build_s=fleet["build_s"], capture_s=fleet["capture_s"])


def stream_flips(torch, streams, other, prompt_lens, names, params, cfg,
                 dev, quantize_cache=False) -> list:
    """The requests whose greedy streams differ between two runs: at the
    first differing token, the two tokens' logit margin (a prefill of
    the common prefix through the kernels)."""
    flips = []
    for rid, (a, b) in enumerate(zip(streams, other)):
        if a == b:
            continue
        i = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        logits = next_logits(torch, params, cfg, dev, a[:i], quantize_cache)
        margin = abs(float(logits[a[i]] - logits[b[i]]))
        flips.append({"request": rid,
                      "generated_index": i - prompt_lens[rid],
                      names[0]: a[i], names[1]: b[i],
                      "logit_margin": margin,
                      "logits": [float(logits[a[i]]), float(logits[b[i]])]})
    return flips


def solo_streams(torch, params, cfg, dev, traffic) -> list:
    """The same prompts served directly by one engine with the same
    settings, no gateway: the streams phase 18 is held to."""
    eng = smoke_engine(params, cfg, dev)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p, _ in traffic]
    eng.run()
    eng.assert_no_leaks()
    return [r.tokens for r in reqs]


# Phases 19 and 21: speculative decoding. Two seeded prompts of about 512
# tokens (at most 512, so an MoE target's prefill runs dropless, as its
# verify window does), SPEC_NEW new tokens each, SPEC_K drafts a round; the
# eager comparison and the eager `generate` baseline take SPEC_EAGER_NEW
# tokens of the first prompt (an eager round of the int8 target takes
# ~0.2 s).
SPEC_PROMPT_LENS = (496, 512)
SPEC_NEW = 64
SPEC_K = 4
SPEC_EAGER_NEW = 8


def bf16_spacing(x: float) -> float:
    """The distance from |x| to the next bf16 value (8 significant bits):
    the logits' resolution, since the LM head's product is rounded to
    bf16."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def near_tie(flip: dict, limit: float) -> bool:
    """A flip whose two logits lie within ``limit`` or within one bf16 step
    of each other: at logits of 4 to 8 one step is 0.03125, above
    PERF.md's 1e-2, so two adjacent bf16 values are a tie there."""
    step = bf16_spacing(max(abs(v) for v in flip["logits"]))
    return flip["logit_margin"] < limit or flip["logit_margin"] <= step


def spec_prompts(torch, cfg) -> list:
    rng = torch.Generator()
    rng.manual_seed(SEED + 100)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
            for n in SPEC_PROMPT_LENS]


def check_spec_kernels(torch, tcfg, dcfg, dev, quantized: bool) -> dict:
    """The paged kernels at the speculative loop's shapes against their
    plain versions, timed with their bounds: K2 at the draft's step (one
    sequence, B 1, at the first prompt's length plus half the new tokens)
    and K3 at the target's verify window (T = SPEC_K + 1, B 1, from that
    position); the int8 branches with ``quantized`` (pools quantized by
    the cache's own recipe, as ``check_paged`` does)."""
    from k8s_dra_driver_tpu_torch.models.decode import _quantize_kv
    from k8s_dra_driver_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + (102 if quantized else 101))
    start = SPEC_PROMPT_LENS[0] + SPEC_NEW // 2
    suffix = "_int8" if quantized else ""
    results = {}
    for name, cfg, t in (("paged_decode" + suffix + "_b1", dcfg, 1),
                         ("paged_prefill" + suffix + "_verify", tcfg,
                          SPEC_K + 1)):
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        nbps = cfg.max_seq_len // BLOCK_SIZE
        scale = d ** -0.5
        kv_bytes = 2 * d + 8 if quantized else 2 * d * 2
        k, v, tables = paged_inputs(torch, gen, dev, [start + t], nbps,
                                    hkv, d)
        sc = {}
        if quantized:
            (k8, ks), (v8, vs) = _quantize_kv(k[None]), _quantize_kv(v[None])
            k, v, sc = k8[0], v8[0], dict(k_scale=ks[0], v_scale=vs[0])
        q = torch.randn((1, hq, t, d), generator=gen, device=dev).to(
            torch.bfloat16)
        pos = start + torch.arange(t, device=dev)[None, :]
        if t == 1:
            vlen = (pos[:, 0] + 1).to(torch.int32)
            q1 = q[:, :, 0].contiguous()

            def kernel():
                return att.paged_decode_attention(q1, k, v, tables, vlen,
                                                  BLOCK_SIZE, scale, **sc)
            shape = f"q[1,{hq},{d}] valid_len {start + 1}"
        else:
            def kernel():
                return att.paged_prefill_attention(q, k, v, tables, pos,
                                                   BLOCK_SIZE, scale, **sc)
            shape = f"q[1,{hq},{t},{d}] start {start}"

        def plain():
            return att.paged_attention_reference(q, k, v, tables, pos,
                                                 BLOCK_SIZE, scale, **sc)
        out = kernel()
        ref = plain()
        if t == 1:
            ref = ref[:, :, 0]
        torch.cuda.synchronize()
        err = attn_errors(torch, out, ref, name)
        visible = sum(start + i + 1 for i in range(t))
        results[name] = dict(
            max_abs_err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
            library_ms=None, shape=shape,
            **bound_fields(name, (start + t) * hkv * kv_bytes
                           + 2 * q.numel() * 2
                           + -(-(start + t) // BLOCK_SIZE) * 4,
                           visible * hq * d * 4, BF16_FLOPS))
    return results


def spec_alone(torch, params, cfg, dev, quantize_cache, prompts) -> list:
    """The target alone, from the state a speculative call starts in:
    ``prefill`` of each prompt as ``speculative_generate`` calls it (the
    same first token and prompt cache), then SPEC_NEW - 1 greedy T=1 steps
    captured as the draft's step is (``StepGraph``, B 1). The streams
    speculation is held to: the T=1 steps and the T=k+1 verify window
    are the only difference."""
    from k8s_dra_driver_tpu_torch.models.decode import (
        _forward_with_cache,
        prefill,
    )
    from k8s_dra_driver_tpu_torch.models.step_graph import StepGraph

    streams = []
    for prompt in prompts:
        s = len(prompt)
        logits, cache = prefill(params, torch.tensor([prompt], device=dev),
                                cfg, s + SPEC_NEW + SPEC_K + 1,
                                quantize_cache=quantize_cache)

        def step(tok, pos, on, cache=cache):
            out, _ = _forward_with_cache(params, tok[:, None], cache, cfg,
                                         pos, active=on != 0)
            return out[:, 0].argmax(dim=-1).to(torch.int32)

        graph = StepGraph(step, dev, counts={"step": 0}, name="step")
        tok = logits.argmax(dim=-1).to(torch.int32)
        live = torch.ones((1,), dtype=torch.int32, device=dev)
        pos = torch.tensor([s], device=dev)
        out = [tok]
        for _ in range(SPEC_NEW - 1):
            tok = graph((), tok, pos, live)
            out.append(tok.clone())
            pos = pos + 1
        streams.append(prompt + torch.cat(out).tolist())
    return streams


class WindowReplay(RoutingReplay):
    """``RoutingReplay`` from T=1 steps into T=k+1 windows: a recorded call
    that routed fewer tokens than the call replaying it stands for its
    first rows; the other rows keep their own choice and are not
    counted."""

    def _next(self, experts):
        import torch

        ref = self.recorded.pop(0)
        self._extra = experts.shape[0] - ref.shape[0]
        return torch.cat([ref, experts[ref.shape[0]:]])

    def __call__(self, probs, c):
        self._extra = 0
        out = super().__call__(probs, c)
        self.routed -= self._extra
        return out


def explain_moe_flip(torch, params, cfg, dev, quantize_cache, prompt,
                     stream, other, i) -> dict:
    """An MoE target's speculative stream and the target alone's first
    differ at generated token i beyond a logit near-tie. A router's top-2
    choice is discrete, so the bf16 noise between the T=1 step and the
    T=k+1 window flips near-tie choices, and one flipped expert moves a
    token's logits far more than that noise. So both ways are rerun
    eagerly over the common prefix, from the same ``prefill``: the target
    alone's (T=1 steps, routing recorded) and the verify window's (each
    token fed as the first row of a T=k+1 window whose other rows are
    filler, as in a round that accepts nothing; a row does not depend on
    the rows after it), first routing freely, which must give both
    streams' tokens at i, then with the T=1 routing replayed into the
    windows' first rows. Held as phase 14 holds a forward: every routing
    flip a near-tie (``FLIP_MARGIN_LIMIT``, ``FLIP_MARGIN_LIMIT_KVQ`` with
    the int8 KV cache), at most FLIP_SHARE_LIMIT of the routed choices,
    and, routing replayed, the window choosing the target alone's token or
    the two tokens' logits within a near-tie (``near_tie``)."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.decode import (
        _forward_with_cache,
        prefill,
    )

    s = len(prompt)
    limit = FLIP_MARGIN_LIMIT_KVQ if quantize_cache else FLIP_MARGIN_LIMIT
    fed = stream[s:s + i]
    t = SPEC_K + 1

    def run(window: bool) -> torch.Tensor:
        logits, cache = prefill(params, torch.tensor([prompt], device=dev),
                                cfg, s + SPEC_NEW + SPEC_K + 1,
                                quantize_cache=quantize_cache)
        last = logits[0]
        for j, tok in enumerate(fed):
            row = [tok] + [0] * (t - 1 if window else 0)
            out, cache = _forward_with_cache(
                params, torch.tensor([row], device=dev), cache, cfg,
                s + j + torch.arange(len(row), device=dev))
            last = out[0, 0]
        return last.float()

    with WindowReplay(moe) as replay:
        replay.mode = "record"
        alone = run(False)
        replay.mode = None
        free = run(True)
        replay.mode = "replay"
        replayed = run(True)
        if replay.recorded:
            raise AssertionError("the windows replayed fewer routings than "
                                 "the steps recorded")
    a, b = stream[s + i], other[s + i]
    if int(free.argmax()) != a or int(alone.argmax()) != b:
        raise AssertionError(
            f"the eager rerun does not reproduce the flip at {i}: window "
            f"{int(free.argmax())} (speculative {a}), step "
            f"{int(alone.argmax())} (alone {b})")
    replay.check(f"the routing flips behind the flip at {i}", limit)
    flip = {"logit_margin": abs(float(replayed[a] - replayed[b])),
            "logits": [float(replayed[a]), float(replayed[b])]}
    chosen = int(replayed.argmax())
    if chosen != b and not near_tie(flip, limit):
        raise AssertionError(f"with the T=1 routing replayed the window "
                             f"chooses {chosen} at {i}, not the target "
                             f"alone's {b}: {flip}")
    return dict(replay.summary(), replayed_choice=chosen,
                replayed_logit_margin=flip["logit_margin"],
                replayed_logits=flip["logits"])


def spec_engine(torch, params, cfg, dev, quantize_cache, prompts) -> dict:
    """The fair baseline: the target alone in a captured
    ``DecodeEngine(batch_slots=1)``, warmed by one request (its steps
    captured there), then serving the prompts one after another."""
    from k8s_dra_driver_tpu_torch.models import DecodeEngine

    eng = DecodeEngine(params, cfg, batch_slots=1, num_blocks=64,
                       block_size=BLOCK_SIZE, prefill_chunk=PREFILL_CHUNK,
                       prefill_batch=1, prefix_cache=False,
                       quantize_cache=quantize_cache, device=dev)
    eng.submit(prompts[0][:PREFILL_CHUNK], max_new_tokens=4)
    eng.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng.assert_no_leaks()
    return dict(streams=[r.tokens for r in reqs], wall_s=wall,
                tokens_per_s=len(prompts) * SPEC_NEW / wall,
                decode_p50_ms=eng.stats.p50_token_ms())


def spec_generate_eager(torch, params, cfg, dev, quantize_cache,
                        prompt) -> dict:
    """The port's eager ``generate`` on the first prompt, SPEC_EAGER_NEW
    new tokens."""
    from k8s_dra_driver_tpu_torch.models import generate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, [prompt], cfg, SPEC_EAGER_NEW,
                   quantize_cache=quantize_cache, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=out[0].tolist(), wall_s=wall,
                tokens_per_s=SPEC_EAGER_NEW / wall)


def cache_rows(cache) -> list:
    """A cache's pools without their scratch row: what a call may write."""
    pools = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                  if hasattr(cache, "k_scale") else [])
    return [pool[:, :, :-1] for pool in pools]


def speculate(torch, target, draft, tcfg, dcfg, dev, quantize_cache,
              prompts, new=SPEC_NEW, capture=True, timed=False) -> dict:
    """``speculative_generate`` on each prompt in turn (a solo call each,
    its steps captured on its own caches unless ``capture=False``), with
    the host syncs it makes counted (``set_sync_debug_mode("warn")``).
    Returns the streams, each call's stats and syncs, the totals, and
    the last call's final caches' rows (``cache_rows``)."""
    import warnings

    from k8s_dra_driver_tpu_torch.models import speculative_generate

    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for prompt in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out, stats, caches = speculative_generate(
                    target, draft, [prompt], tcfg, dcfg, new, k=SPEC_K,
                    quantize_cache=quantize_cache, return_stats=True,
                    return_caches=True, capture=capture, device=dev,
                    timed=timed)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sites = collections.Counter(
            f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "synchronizing CUDA operation" in str(w.message))
        calls.append(dict(stats, tokens=out[0].tolist(), wall_s=wall,
                          syncs=sum(sites.values()), sync_sites=sites))
    rounds = sum(c["rounds"] for c in calls)
    accepted = sum(c["accepted"] for c in calls)
    capture_s = sum(c["capture_s"] for c in calls)
    wall = sum(c["wall_s"] for c in calls)
    result = dict(
        streams=[c["tokens"] for c in calls], calls=calls, rounds=rounds,
        accepted=accepted, acceptance_rate=accepted / (rounds * SPEC_K),
        tokens_per_round=len(prompts) * (new - 1) / rounds,
        wall_s=wall, capture_s=capture_s,
        # Prefills included, the solo calls' captures excluded.
        tokens_per_s=len(prompts) * new / (wall - capture_s),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        rows=[r for cache in caches for r in cache_rows(cache)])
    if timed:
        for key in ("draft_step_ms", "verify_window_ms"):
            result[key] = statistics.median(c[key] for c in calls)
    return result


def spec_launches(tcfg, dcfg, calls: int, rounds: int, int8: bool) -> dict:
    """The launches ``calls`` speculative calls of ``rounds`` rounds in all
    make: each call prefills both models (K3 once a layer, K1 2L+1
    times), each round feeds the draft SPEC_K + 1 times (K2) and verifies
    once (K3); with int8 target weights, K7/K8-int8 once a layer and
    ``int8_matmul`` 2L+1 times a target forward."""
    lt, ld = tcfg.n_layers, dcfg.n_layers
    feeds = (SPEC_K + 1) * rounds
    suffix = "_int8" if int8 else ""
    want = {"paged_decode" + suffix: ld * feeds,
            "paged_prefill" + suffix: calls * (lt + ld) + lt * rounds,
            "rmsnorm": (2 * lt + 1) * (calls + rounds)
            + (2 * ld + 1) * (calls + feeds)}
    if int8:
        target = calls + rounds
        want.update({"paged_decode": 0, "paged_prefill": 0,
                     "moe_gateup": 0, "moe_down_combine": 0,
                     "moe_gateup_int8": lt * target,
                     "moe_down_combine_int8": lt * target,
                     "int8_matmul": (2 * lt + 1) * target})
    return want


def speculative_phase(torch, label, target, draft, tcfg, dcfg, dev,
                      quantize_cache, drive, counted, path) -> dict:
    """Phases 19 and 21. The counted run (``drive(path, ...)``, its
    launches ``counted(path)``): the draft's speculation on both prompts,
    steps captured and timed. Then, outside it: the target as its own
    draft (the perfect draft), whose streams the draft's must equal; the
    target alone (``spec_alone``), whose streams both runs are held to
    but for near-ties (``near_tie``; on an MoE target, or
    ``explain_moe_flip``); the baselines (``spec_engine``, the eager
    ``generate``); the first prompt at SPEC_EAGER_NEW tokens captured and
    eager, held equal (tokens, stats, launches, pool rows), the eager
    run's int8 -> float copies counted, and the captured run's host syncs
    against the counted run's (one more a round). Returns the two runs'
    metrics."""
    from k8s_dra_driver_tpu_torch.models.moe import MoeConfig
    from k8s_dra_driver_tpu_torch.models.step_graph import (
        launch_delta,
        read_launches,
    )

    prompts = spec_prompts(torch, tcfg)
    limit = FLIP_MARGIN_LIMIT_KVQ if quantize_cache else FLIP_MARGIN_LIMIT
    main_run = drive(path, speculate, torch, target, draft, tcfg, dcfg, dev,
                     quantize_cache, prompts, SPEC_NEW, True, True)
    counts = counted(path)
    want = spec_launches(tcfg, dcfg, len(prompts), main_run["rounds"],
                         quantize_cache)
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    perfect = speculate(torch, target, target, tcfg, tcfg, dev,
                        quantize_cache, prompts)
    alone = spec_engine(torch, target, tcfg, dev, quantize_cache, prompts)
    alone_streams = spec_alone(torch, target, tcfg, dev, quantize_cache,
                               prompts)
    eager_gen = spec_generate_eager(torch, target, tcfg, dev,
                                    quantize_cache, prompts[0])
    lens = [len(p) for p in prompts]
    for run, name in ((main_run, "draft"), (perfect, "perfect")):
        for c in run["calls"]:
            if c["compile_counts"] != {"draft_step": 1,
                                       "verify_window": 1} \
                    or c["graphs"] != 2:
                raise AssertionError(f"{label} ({name}): captures "
                                     f"{c['compile_counts']}, "
                                     f"{c['graphs']} graphs")
        flips = stream_flips(torch, run["streams"], alone_streams, lens,
                             ("speculative", "alone"), target, tcfg, dev,
                             quantize_cache)
        log(f"{label} ({name}) vs the target alone: stream flips "
            f"{json.dumps(flips)}")
        for f in flips:
            if near_tie(f, limit):
                continue
            if not isinstance(tcfg, MoeConfig):
                raise AssertionError(f"{label} ({name}): streams differ from "
                                     f"the target alone beyond a near-tie "
                                     f"(limit {limit} or one bf16 step): {f}")
            rid = f["request"]
            f["routing"] = explain_moe_flip(
                torch, target, tcfg, dev, quantize_cache, prompts[rid],
                run["streams"][rid], alone_streams[rid],
                f["generated_index"])
            log(f"{label} ({name}): flip {rid}/{f['generated_index']} "
                f"explained by routing near-ties {json.dumps(f['routing'])}")
        run["stream_flips"] = flips
    # The draft changes how many rounds run, never the output: a row of
    # the verify window does not depend on the rows after it.
    if main_run["streams"] != perfect["streams"]:
        raise AssertionError(f"{label}: the draft's streams differ from the "
                             f"perfect draft's")
    # The perfect draft's T=1 steps are the target alone's, so each
    # rejection makes its stream flip: no flip, every proposal accepted.
    if not perfect["stream_flips"] and perfect["acceptance_rate"] != 1.0:
        raise AssertionError(f"{label}: the perfect draft accepted "
                             f"{perfect['acceptance_rate']} with no flip")
    first = prompts[:1]
    before = read_launches()
    # Timed as the counted run is, whose closing read of the events syncs.
    short = speculate(torch, target, draft, tcfg, dcfg, dev, quantize_cache,
                      first, SPEC_EAGER_NEW, timed=True)
    short_launches = launch_delta(before, read_launches())
    before = read_launches()
    runs = []

    def eager_call():
        runs.append(speculate(torch, target, draft, tcfg, dcfg, dev,
                              quantize_cache, first, SPEC_EAGER_NEW,
                              capture=False))

    # With int8 weights, every int8 -> float copy the eager call makes is
    # seen (a dispatch mode, which slows the call down).
    eager = int8_casts(torch, eager_call) if quantize_cache else eager_call()
    eager_launches = launch_delta(before, read_launches())
    eager_run = runs[0]
    keys = ("rounds", "accepted", "acceptance_rate", "compile_counts")
    got = [{k: c[k] for k in keys} for c in short["calls"]]
    # Every pool row but the scratch row bitwise equal: the captures'
    # warm-ups wrote only the scratch row.
    same_rows = all(torch.equal(a, b)
                    for a, b in zip(short["rows"], eager_run["rows"]))
    if short["streams"] != eager_run["streams"] or not same_rows \
            or got != [{k: c[k] for k in keys} for c in eager_run["calls"]] \
            or short_launches != eager_launches:
        raise AssertionError(f"{label}: captured {got} "
                             f"{short['streams']}, pool rows equal "
                             f"{same_rows}; eager "
                             f"{eager_run['calls']} "
                             f"{eager_run['streams']}")
    # One host sync a round: the longer call syncs once more a round.
    extra = main_run["calls"][0]["syncs"] - short["calls"][0]["syncs"]
    more = main_run["calls"][0]["rounds"] - short["calls"][0]["rounds"]
    if extra != more:
        raise AssertionError(
            f"{label}: {extra} more host syncs for {more} more rounds: "
            f"{dict(main_run['calls'][0]['sync_sites'])} against "
            f"{dict(short['calls'][0]['sync_sites'])}")
    # int8 -> float copies in the eager call: the embedding's rows only,
    # the prompt's once and each verify window's.
    h = tcfg.hidden
    rounds = eager_run["rounds"]
    allowed = sorted([lens[0] * h] + [(SPEC_K + 1) * h] * rounds)
    if quantize_cache and sorted(eager) != allowed:
        raise AssertionError(f"{label}: int8 -> float copies {eager}; "
                             f"expected the embedding's rows {allowed}")
    baselines = dict(
        engine_b1_tokens_per_s=alone["tokens_per_s"],
        engine_b1_decode_p50_ms=alone["decode_p50_ms"],
        eager_generate_tokens_per_s=eager_gen["tokens_per_s"],
        eager_generate_new_tokens=SPEC_EAGER_NEW)
    checks = dict(
        captured_vs_eager_equal=True, eager_new_tokens=SPEC_EAGER_NEW,
        syncs_per_round=extra / more,
        int8_to_float_copies=len(eager) if quantize_cache else None,
        eager_wall_s=eager_run["wall_s"])
    out = {}
    for run, name in ((main_run, "draft"), (perfect, "perfect")):
        m = {k: v for k, v in run.items()
             if k not in ("streams", "calls", "rows")}
        m.update(baselines, checks=checks, prompt_lens=lens,
                 new_tokens=SPEC_NEW, k=SPEC_K,
                 captures=[c["compile_counts"] for c in run["calls"]],
                 capture_s_each=[c["capture_s"] for c in run["calls"]],
                 syncs=[c["syncs"] for c in run["calls"]],
                 speedup_vs_engine_b1=run["tokens_per_s"]
                 / alone["tokens_per_s"],
                 speedup_vs_eager_generate=run["tokens_per_s"]
                 / eager_gen["tokens_per_s"])
        log(f"speculative: {label} ({name}) {json.dumps(m)}")
        out[name] = m
    return out


# Phase 20: after phase 4's traffic (the builds), a second wave of
# TEL_REQUESTS requests of TEL_PROMPT tokens and TEL_NEW new tokens each
# (one prefill launch a lane, then decode at 8 slots), scraped every tick.
TEL_REQUESTS = 8
TEL_PROMPT = 64
TEL_NEW = 64


def compute_telemetry(torch, params, cfg, dev, phase4) -> dict:
    """Phase 20: ``ComputeTelemetry`` (the card's peak row) attached to a
    phase-4-shaped engine before its first tick, behind the port's
    ``MetricsServer``. Phase 4's traffic first (both programs built; the
    streams held to phase 4's, which ran the same traffic on the same
    weights without telemetry, but for near-ties), then ``mark_warm`` and
    a decode-heavy second wave scraped every tick, so the roofline window
    (the last 32 scrapes) covers steady decode at 8 slots. Holds: the
    ledger's engine builds equal ``compile_counts`` (1 each), no recompile
    after ``mark_warm``, the HBM ledger's weights equal the parameters'
    tensor bytes and its pool bytes the pools', and ``/debug/compute``
    answers 200 with the document. Returns the roofline gauges."""
    import urllib.request

    from k8s_dra_driver_tpu_torch.models.compute_telemetry import (
        ComputeTelemetry,
    )
    from k8s_dra_driver_tpu_torch.utils.metrics import (
        MetricsServer,
        Registry,
    )

    registry = Registry()
    tel = ComputeTelemetry(registry)
    server = MetricsServer(registry, host="127.0.0.1", port=0)
    server.set_compute_provider(tel.compute_debug)
    server.start()
    # No proxy: the request goes to this process's own server.
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        peaks = tel.compute_debug()["device"]
        if peaks["matched"] != "h100 80gb hbm3":
            raise AssertionError(f"device peaks {peaks}: not the H100 row")
        first = serve(torch, params, cfg, dev, attach=lambda e: tel.attach(
            e, replica="r0", claim_uid="chip-smoke"))
        eng = first.pop("_engine")
        ones = {"decode_step": 1, "prefill_chunk": 1}
        snap = tel.ledger.snapshot()
        builds = {p: snap["builds"].get(p, 0) for p in ones}
        if dict(eng.compile_counts) != ones or builds != ones:
            raise AssertionError(f"ledger builds {builds}, compile_counts "
                                 f"{eng.compile_counts}; want {ones}")
        flips = stream_flips(torch, first["_streams"], phase4["streams"],
                             phase4["prompt_lens"], ("telemetry", "phase 4"),
                             params, cfg, dev)
        bad = [f for f in flips if f["logit_margin"] >= FLIP_MARGIN_LIMIT]
        if bad:
            raise AssertionError(f"streams with telemetry differ from phase "
                                 f"4's beyond a near-tie: {bad}")
        tel.mark_warm()
        rng = torch.Generator()
        rng.manual_seed(SEED + 110)
        reqs = [eng.submit(torch.randint(0, cfg.vocab_size, (TEL_PROMPT,),
                                         generator=rng).tolist(),
                           max_new_tokens=TEL_NEW)
                for _ in range(TEL_REQUESTS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scrapes = 0
        while not eng.idle:
            eng.tick()
            registry.render()
            scrapes += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.assert_no_leaks()
        if not all(r.done and len(r.generated) == TEL_NEW for r in reqs):
            raise AssertionError("the second wave did not finish")
        base = f"http://127.0.0.1:{server.port}/debug/compute"
        with opener.open(base, timeout=60) as resp:
            status = resp.status
            doc = json.loads(resp.read().decode())
        if status != 200 or doc["schema"] != "tpu-dra-compute-debug-v1":
            raise AssertionError(f"/debug/compute answered {status}")
        if doc["recompilesSinceWarm"] or dict(eng.compile_counts) != ones:
            raise AssertionError(f"recompiles after warm-up: "
                                 f"{doc['recompilesSinceWarm']}, "
                                 f"{eng.compile_counts}")
        hbm = doc["hbm"]["r0"]
        pools = sum(p.numel() * p.element_size() for p in eng._pools)
        if hbm["weightsBytes"] != nbytes(params) \
                or hbm["kvPoolBytes"] != pools:
            raise AssertionError(f"HBM ledger {hbm}; tensor bytes "
                                 f"{nbytes(params)} weights, {pools} pools")
        gauges = {}
        for program, reps in doc["programs"].items():
            for replica, r in reps.items():
                gauges[f"{replica}/{program}"] = dict(
                    boundBy=r["boundBy"], mfu=r["mfu"],
                    membwFraction=r["bytesPerS"] / peaks["peakBytesPerS"],
                    bytesPerS=r["bytesPerS"], flopsPerS=r["flopsPerS"],
                    intensity=r["intensity"], ridge=r["ridge"],
                    windowS=r["windowS"], steps=r["steps"])
        decode = gauges["r0/decode_step"]
        if decode["boundBy"] != "memory" or decode["steps"] <= 0:
            raise AssertionError(f"decode gauges {decode}")
        text = registry.render()
        for family in ("tpu_dra_compute_compiles_total",
                       "tpu_dra_compute_hbm_bytes",
                       "tpu_dra_compute_mfu_ratio"):
            if family not in text:
                raise AssertionError(f"the registry renders no {family}")
        return dict(
            device=peaks, builds=snap["builds"],
            compile_s={r["program"]: r["compileS"] for r in snap["records"]
                       if r["program"] in ones},
            recompiles_since_warm=doc["recompilesSinceWarm"],
            hbm=hbm, weights_gb=hbm["weightsBytes"] / 1e9,
            kv_pool_gb=hbm["kvPoolBytes"] / 1e9, gauges=gauges,
            stream_flips=flips, second_wave_wall_s=wall,
            second_wave_tokens_per_s=TEL_REQUESTS * TEL_NEW / wall,
            decode_p50_ms=eng.stats.p50_token_ms(), scrapes=scrapes,
            debug_compute_status=status,
            first_wave_tokens_per_s=first["tokens_per_s"],
            decode_steps=eng.stats.decode_steps,
            prefill_launches=eng.stats.prefill_lanes_launched
            // eng.prefill_batch)
    finally:
        tel.close()
        server.stop()


# ---------------------------------------------------------------------------
# Phases 25-29: the node plugin's device layer and the scheduler side on
# the card
# ---------------------------------------------------------------------------

DRA_DRIVER = "tpu.google.com"
DRA_LIMIT = "36Gi"        # phase 27's HBM limit: about 45% of an H100
DRA_RESIZED = "24Gi"      # what resize_claim_limits lowers it to
DRA_MARGIN = 64 << 20     # the cap probes' distance from the cap
DRA_TIMEOUT = 300         # seconds a worker may take to answer
# How a worker process starts: this script in its worker mode.
WORKER_ARGV = [sys.executable, str(ROOT / "chip_smoke.py"), "--dra-worker"]


def dra_state(root: Path, nvml=None):
    """The node plugin's device layer over the host's GPUs: ``RealChipLib``
    on NVML (``nvml`` overrides the binding), CDI specs, checkpoint and
    sharing state under ``root``."""
    from k8s_dra_driver_tpu_torch.cdi import CDIHandler
    from k8s_dra_driver_tpu_torch.plugin import CheckpointManager, DeviceState
    from k8s_dra_driver_tpu_torch.tpulib import ChipLibConfig, RealChipLib

    lib = RealChipLib(ChipLibConfig(state_dir=str(root / "modes")),
                      nvml=nvml)
    return DeviceState(
        chiplib=lib, cdi=CDIHandler(str(root / "cdi")),
        checkpoint=CheckpointManager(str(root / "checkpoint.json")),
        driver_name=DRA_DRIVER, pool_name=os.uname().nodename,
        state_dir=str(root / "state"), device_classes={"chip"})


def dra_claim(uid: str, device: str, sharing=None) -> dict:
    """A ResourceClaim allocated ``device``, in wire form, with a
    ``TpuChipConfig`` of ``sharing`` where given."""
    configs = [] if sharing is None else [{
        "source": "FromClaim", "requests": [],
        "opaque": {"driver": DRA_DRIVER, "parameters": {
            "apiVersion": "tpu.google.com/v1alpha1",
            "kind": "TpuChipConfig", "sharing": sharing}}}]
    return {
        "apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
        "metadata": {"name": uid, "namespace": "chip-smoke", "uid": uid},
        "spec": {"devices": {"requests": [
            {"name": "gpu", "deviceClassName": DRA_DRIVER}]}},
        "status": {"allocation": {"devices": {
            "results": [{"request": "gpu", "driver": DRA_DRIVER,
                         "pool": os.uname().nodename, "device": device}],
            "config": configs}}},
    }


def cdi_container(cdi_root: str, devices) -> dict:
    """The stand-in for kubelet and a container runtime: the edits that
    the CDI ids of a prepared claim's devices name, read from the spec
    files (each spec's common edits, then each device's). Every device
    node and every mount's host path must exist on this host. With no
    mount namespace here, a variable naming a mount's container path is
    pointed at its host path."""
    # (kind, device name) -> its spec file; each prepared claim has a
    # spec file of its own, all of one kind.
    specs = {}
    for name in sorted(os.listdir(cdi_root)):
        with open(os.path.join(cdi_root, name)) as f:
            spec = json.load(f)
        for d in spec["devices"]:
            specs[spec["kind"], d["name"]] = (name, spec)
    env, nodes, mounts, kinds, files = {}, [], [], [], []

    def take(edits):
        env.update(e.split("=", 1) for e in edits.get("env", []))
        nodes.extend(n["path"] for n in edits.get("deviceNodes", []))
        # The base and the claim spec both carry the driver libraries.
        mounts.extend(m for m in edits.get("mounts", []) if m not in mounts)

    for dev in devices:
        for cdi_id in dev.cdi_device_ids:
            kind, name = cdi_id.split("=", 1)
            if (kind, name) not in specs:
                raise AssertionError(f"CDI id {cdi_id} names no spec file "
                                     f"in {cdi_root}")
            file, spec = specs[kind, name]
            if kind not in kinds:
                kinds.append(kind)
            if file not in files:
                files.append(file)
                take(spec.get("containerEdits", {}))
            take(next(d for d in spec["devices"]
                      if d["name"] == name)["containerEdits"])
    paths = nodes + [m["hostPath"] for m in mounts]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"CDI edits name paths the host lacks: "
                             f"{missing}")
    for m in mounts:
        for key, value in env.items():
            if value == m["containerPath"]:
                env[key] = m["hostPath"]
    return dict(env=env, device_nodes=sorted(set(nodes)), mounts=mounts,
                kinds=kinds, files=files)


class Worker:
    """``chip_smoke.py --dra-worker MODE`` in a process of its own with a
    claim's container env: commands go to its stdin, its events (one JSON
    object a line) come from its stdout, its log goes to ``log_path``."""

    def __init__(self, mode: str, env: dict, log_path: Path):
        import queue
        import threading

        self.mode = mode
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen(
            [*WORKER_ARGV, mode], env=env, cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._log, text=True)
        self._lines = queue.Queue()
        self._empty = queue.Empty
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def tail(self) -> str:
        self._log.flush()
        return self.log_path.read_text()[-4000:]

    def send(self, command: str) -> None:
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()

    def expect(self, event: str) -> dict:
        try:
            line = self._lines.get(timeout=DRA_TIMEOUT)
        except self._empty:
            raise AssertionError(f"{self.mode} worker: no {event!r} within "
                                 f"{DRA_TIMEOUT} s:\n{self.tail()}") from None
        if line is None:
            raise AssertionError(
                f"{self.mode} worker exited (rc {self.proc.wait()}) before "
                f"{event!r}:\n{self.tail()}")
        msg = json.loads(line)
        if msg.get("event") != event:
            raise AssertionError(f"{self.mode} worker sent {msg} where "
                                 f"{event!r} was due:\n{self.tail()}")
        return msg

    def finish(self) -> None:
        """Close its stdin and wait for it; it must exit 0."""
        self.proc.stdin.close()
        rc = self.proc.wait(timeout=DRA_TIMEOUT)
        self._log.close()
        if rc != 0:
            raise AssertionError(f"{self.mode} worker exited {rc}:\n"
                                 f"{self.log_path.read_text()[-4000:]}")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()


# Phase 29's DeviceClass: every chip the driver publishes.
DRA_CLASS_CEL = (f"device.driver == '{DRA_DRIVER}' && "
                 f"device.attributes['{DRA_DRIVER}'].type == 'chip'")
DRA_ALLOC_PAIRS = 20      # allocate/deallocate pairs timed in phase 29


def hbm_claim(uid: str, generation: str, hbm: int) -> dict:
    """A ResourceClaim for one chip of ``generation`` with at least
    ``hbm`` bytes, as a user writes it (no status)."""
    attrs = f"device.attributes['{DRA_DRIVER}']"
    return {
        "apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
        "metadata": {"name": uid, "namespace": "chip-smoke", "uid": uid},
        "spec": {"devices": {"requests": [{
            "name": "gpu", "deviceClassName": DRA_DRIVER,
            "selectors": [{"cel": {"expression": (
                f"{attrs}.generation == '{generation}' && "
                f"device.capacity['{DRA_DRIVER}'].hbm >= {hbm}")}}]}]}},
    }


def scheduler(state, chip, device: str) -> dict:
    """Phase 29's control plane on ``state``'s card, up to the prepare:
    publish, allocate a claim the card meets (returned allocated) and one
    it cannot (its reason checked three ways)."""
    from k8s_dra_driver_tpu_torch.kube import FakeKubeClient
    from k8s_dra_driver_tpu_torch.kube.allocator import (
        AllocationError,
        ReferenceAllocator,
    )
    from k8s_dra_driver_tpu_torch.kube.resourceslice import (
        DriverResources,
        Pool,
        ResourceSliceController,
    )
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    node = state.pool_name
    client = FakeKubeClient()
    published = state.published_resources()
    ctrl = ResourceSliceController(client, DRA_DRIVER, scope=node)
    ctrl.update(DriverResources(pools={node: Pool(
        devices=published["devices"],
        shared_counters=published["sharedCounters"], node_name=node)}))
    ctrl.sync_once()
    reg = Registry()
    alloc = ReferenceAllocator(client, registry=reg,
                               device_classes={DRA_DRIVER: [DRA_CLASS_CEL]})
    want = [{"request": "gpu", "driver": DRA_DRIVER, "pool": node,
             "device": device}]
    # 64 GiB: the selector the card meets.
    claim = alloc.allocate(hbm_claim("dra-allocated", "h100", 64 << 30))
    got = claim["status"]["allocation"]["devices"]["results"]
    if [{k: r[k] for k in want[0]} for r in got] != want:
        raise AssertionError(f"allocation {got}, want {want}")
    too_big = hbm_claim("dra-too-big", "h100", chip.hbm_bytes + 1)
    try:
        alloc.allocate(too_big)
    except AllocationError as e:
        reason = e.reason
    else:
        raise AssertionError(f"a claim for {chip.hbm_bytes + 1} bytes of "
                             f"HBM was allocated")
    newest = json.loads(alloc.export_allocations_jsonl().splitlines()[-1])
    metric = alloc._m_unsat.value(reason=reason)
    line = f'tpu_dra_alloc_unsat_total{{reason="{reason}"}} 1'
    if (newest["claim"]["uid"], newest["reason"]) != (
            "dra-too-big", reason) or metric != 1 or \
            line not in reg.render():
        raise AssertionError(f"unsat reason {reason!r}: newest record "
                             f"{newest}, metric {metric}")
    return dict(alloc=alloc, claim=claim, reason=reason,
                newest_record=newest, slices=client.list(ctrl.api.slices))


def allocate_ms(alloc) -> list:
    """Milliseconds of each of DRA_ALLOC_PAIRS allocations of one chip on
    ``alloc``'s inventory, each deallocated before the next."""
    times = []
    for i in range(DRA_ALLOC_PAIRS):
        uid = f"dra-timed-{i}"
        t = time.perf_counter()
        alloc.allocate(hbm_claim(uid, "h100", 64 << 30))
        times.append((time.perf_counter() - t) * 1e3)
        alloc.deallocate(uid)
    return times


def cuda_uuid(props) -> str:
    """NVML's form of a device's uuid (``GPU-`` and the 8-4-4-4-12 hex)."""
    u = str(props.uuid)
    return u if u.startswith("GPU-") else f"GPU-{u}"


def torch_pci_bus_id(props):
    """NVML's bus id form of the device's PCI address, where this torch
    exposes it."""
    if not all(hasattr(props, a) for a in ("pci_domain_id", "pci_bus_id",
                                          "pci_device_id")):
        return None
    return (f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
            f"{props.pci_device_id:02X}.0")


def probe_cap(torch, fraction: float) -> dict:
    """Two allocations beside the allocator's cap (``fraction`` x the
    card's memory, less what the allocator already holds): DRA_MARGIN
    under it must succeed, DRA_MARGIN over it must raise
    ``torch.OutOfMemoryError`` naming the cap ("allowed")."""
    torch.cuda.empty_cache()
    total = torch.cuda.mem_get_info()[1]
    cap = int(fraction * total)
    reserved = torch.cuda.memory_reserved()
    room = cap - reserved
    under = torch.empty(room - DRA_MARGIN, dtype=torch.uint8, device="cuda")
    del under
    torch.cuda.empty_cache()
    try:
        torch.empty(room + DRA_MARGIN, dtype=torch.uint8, device="cuda")
    except torch.OutOfMemoryError as e:
        message = str(e)
    else:
        raise AssertionError(f"an allocation {DRA_MARGIN} bytes over the "
                             f"cap ({cap} bytes) did not raise")
    if "allowed" not in message:
        raise AssertionError(f"the allocation over the cap failed for "
                             f"another reason: {message}")
    torch.cuda.empty_cache()
    return dict(cap_bytes=cap, device_total=total, reserved_bytes=reserved,
                under_bytes=room - DRA_MARGIN, over_bytes=room + DRA_MARGIN,
                over_message=message.splitlines()[0][:300])


def worker_serve(torch, lease=None, dev="cuda") -> tuple:
    """Phase 4's traffic on phase 4's 8B engine (the same seed and
    settings); returns (params, metrics with the streams and the
    serving path's launches)."""
    from k8s_dra_driver_tpu_torch.models import PRESETS, init_params
    from k8s_dra_driver_tpu_torch.models.step_graph import write_launches
    from k8s_dra_driver_tpu_torch.ops import LAUNCH_COUNTERS, attention, norms

    cfg = PRESETS["8b"]
    dev = torch.device(dev)
    with (lease or contextlib.nullcontext)():
        params = init_params(cfg, seed=SEED, device=dev)
    write_launches([0] * len(LAUNCH_COUNTERS))
    m = serve(torch, params, cfg, dev, lease=lease)
    launches = {"paged_decode": attention.paged_decode_attention.launches,
                "paged_prefill": attention.paged_prefill_attention.launches,
                "rmsnorm": norms.rmsnorm.launches}
    gc.collect()
    free, total = torch.cuda.mem_get_info()
    return params, dict(
        streams=m["_streams"], launches=launches, wall_s=m["wall_s"],
        tokens_per_s=m["tokens_per_s"], ttft_p50_ms=m["ttft_p50_ms"],
        decode_step_p50_ms=m["decode_step_p50_ms"],
        capture_s=m["capture_s"], peak_mem_gb=m["peak_mem_gb"],
        reserved_bytes=torch.cuda.memory_reserved(),
        device_used_bytes=total - free)


def dra_worker(mode: str) -> int:
    """The workload a container runtime would start for a prepared claim
    (phases 26-28): ``exclusive`` serves phase 4's traffic; ``shared``
    takes a process slot through the shim, caps PyTorch's allocator and
    answers ``probe``, ``serve`` and ``poll`` (a limits update at a step
    boundary); ``timeshared`` serves with every tick under
    ``timeshare_lease`` and reports its lease intervals on
    CLOCK_MONOTONIC. Events go to stdout as JSON lines."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 2
    from k8s_dra_driver_tpu_torch.parallel import shim

    def emit(event, **fields):
        print(json.dumps({"event": event, **fields}), flush=True)

    def command(want):
        got = sys.stdin.readline().strip()
        if got != want:
            raise AssertionError(f"command {got!r} where {want!r} was due")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt = None
    if mode in ("shared", "timeshared", "tenant"):
        # Before the card is touched, as the shim asks.
        try:
            rt = shim.apply_sharing_env()
        except shim.SharingRuntimeError as e:
            emit("refused", error=str(e))
            return 0
    free, total = torch.cuda.mem_get_info()
    props = torch.cuda.get_device_properties(0)
    seen = dict(count=torch.cuda.device_count(), uuid=cuda_uuid(props),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                device_used_bytes=total - free)
    if mode == "exclusive":
        emit("device", **seen)
        _, served = worker_serve(torch)
        emit("served", **served)
        return 0
    if mode == "shared":
        fraction = shim.apply_memory_fraction()
        emit("slot", slot=rt.slot, fraction=fraction, **seen)
        command("probe")
        emit("probe", **probe_cap(torch, fraction))
        command("serve")
        params, served = worker_serve(torch)
        emit("served", **served)
        command("poll")
        update = shim.poll_sharing_update()
        if update is None:
            raise AssertionError("no new limits generation to apply")
        fraction = shim.apply_memory_fraction()
        emit("resized", generation=update.generation, fraction=fraction,
             hbm_limit_bytes=update.hbm_limit_bytes,
             **probe_cap(torch, fraction))
        del params
        command("exit")
        return 0
    if mode == "tenant":
        # Phase 30: a co-tenant of a process-shared claim under the
        # rebalancer.
        fraction = shim.apply_memory_fraction()
        emit("slot", slot=rt.slot, fraction=fraction, **seen)
        command("probe")
        emit("probe", **probe_cap(torch, fraction))
        command("serve")
        params, served = worker_serve(torch)
        emit("served", **served)
        busy, hbm = (float(x) for x in sys.stdin.readline().split()[1:])
        if not shim.report_usage(busy, hbm):
            raise AssertionError("report_usage wrote no sample")
        emit("reported", busy=busy, hbm=hbm)
        command("poll")
        update = shim.poll_sharing_update()
        if update is None:
            raise AssertionError("no new limits generation to apply")
        fraction = shim.apply_memory_fraction()
        emit("resized", generation=update.generation, fraction=fraction,
             hbm_limit_bytes=update.hbm_limit_bytes,
             tensorcore_percent=update.tensorcore_percent,
             **probe_cap(torch, fraction))
        del params
        command("exit")
        return 0
    if mode == "timeshared":
        emit("ready", **seen)
        command("go")
        intervals = []

        @contextlib.contextmanager
        def lease():
            with shim.timeshare_lease():
                start = time.clock_gettime(time.CLOCK_MONOTONIC)
                yield
                torch.cuda.synchronize()
                intervals.append(
                    (start, time.clock_gettime(time.CLOCK_MONOTONIC)))

        _, served = worker_serve(torch, lease)
        emit("served", intervals=intervals, **served)
        return 0
    raise ValueError(f"unknown worker mode {mode!r}")


def hold_serving(what: str, served: dict, streams: list,
                 launches: dict) -> None:
    if served["streams"] != streams:
        raise AssertionError(f"{what}: streams differ from phase 4's")
    if served["launches"] != launches:
        raise AssertionError(f"{what}: launches {served['launches']}, "
                             f"phase 4 {launches}")


def device_layer(torch, streams: list, launches: dict, phase_done) -> dict:
    """Phases 25-29 (module docstring). ``streams`` and ``launches`` are
    phase 4's, which every worker's serving must equal."""
    from k8s_dra_driver_tpu_torch.tpulib import _nvml

    root = ROOT / "build" / "dra"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {}
    workers = []

    def worker(mode, env, tag):
        w = Worker(mode, {**os.environ, **env}, root / f"{tag}.log")
        workers.append(w)
        return w

    t0 = time.perf_counter()
    state = dra_state(root)
    try:
        # Phase 25: discovery.
        lib = state.chiplib
        chips = lib.enumerate_chips()
        props = torch.cuda.get_device_properties(0)
        mine = [c for c in chips if c.uuid == cuda_uuid(props)]
        if len(mine) != 1:
            raise AssertionError(f"NVML's GPUs {[c.uuid for c in chips]} "
                                 f"hold no {cuda_uuid(props)}")
        chip = mine[0]
        nv = _nvml.load()
        nv.init()
        try:
            handle = nv.handle_by_uuid(chip.uuid)
            nvml = dict(name=nv.name(handle), uuid=chip.uuid,
                        memory_total=chip.hbm_bytes,
                        pci_bus_id=chip.pci_address or None,
                        driver=chip.driver_version,
                        vbios=chip.firmware_version,
                        power_limit_w=nv.power_limit_mw(handle) / 1000,
                        minor_node=chip.device_paths[0],
                        numa_node=chip.numa_node, gpus=len(chips))
        finally:
            nv.shutdown()
        cuda = dict(name=torch.cuda.get_device_name(0),
                    uuid=cuda_uuid(props), total_memory=props.total_memory,
                    pci_bus_id=torch_pci_bus_id(props),
                    count=torch.cuda.device_count())
        if nvml["name"] != cuda["name"]:
            raise AssertionError(f"NVML names {nvml['name']}, torch "
                                 f"{cuda['name']}")
        if cuda["pci_bus_id"] is not None and chip.pci_address and \
                cuda["pci_bus_id"].upper() != chip.pci_address.upper():
            raise AssertionError(f"PCI bus id: NVML {chip.pci_address}, "
                                 f"torch {cuda['pci_bus_id']}")
        health = lib.chip_health()
        if not health[chip.uuid].is_healthy():
            raise AssertionError(f"chip health: {health[chip.uuid]}")
        t = time.perf_counter()
        if lib.wait_device_event(0.1):
            raise AssertionError("a device event arrived on an idle card")
        waited = time.perf_counter() - t
        published = state.published_resources()
        gpus = [d for d in published["devices"]
                if d["basic"]["attributes"]["uuid"] == {"string": chip.uuid}]
        if len(gpus) != 1 or gpus[0]["basic"]["attributes"][
                "generation"] != {"string": "h100"}:
            raise AssertionError(f"published: {published}")
        device = gpus[0]["name"]
        log(f"device layer: NVML {json.dumps(nvml)}")
        log(f"device layer: torch {json.dumps(cuda)}")
        log(f"device layer: published {json.dumps(published)}")
        out["discovery"] = dict(nvml=nvml, torch=cuda, device=device,
                                health=health[chip.uuid].state,
                                event_wait_s=waited,
                                published_devices=len(published["devices"]))
        out["discovery"]["s"] = time.perf_counter() - t0
        phase_done(f"phase 25: NVML found {chip.uuid} ({nvml['name']}, "
                   f"{chip.hbm_bytes} bytes; torch {props.total_memory}), "
                   f"as torch names it; healthy; published as {device}")

        def serve_exclusive(claim, tag):
            """Prepare ``claim``, serve phase 4's traffic in one worker
            with its CDI env, unprepare; (CDI edits, what the worker saw,
            what it served)."""
            ctr = cdi_container(state.cdi.cdi_root, state.prepare(claim))
            if ctr["env"].get("CUDA_VISIBLE_DEVICES") != chip.uuid:
                raise AssertionError(f"claim env {ctr['env']}")
            w = worker("exclusive", ctr["env"], tag)
            seen = w.expect("device")
            if (seen["count"], seen["uuid"]) != (1, chip.uuid):
                raise AssertionError(f"the worker sees {seen}")
            served = w.expect("served")
            w.finish()
            hold_serving(f"{tag} claim", served, streams, launches)
            state.unprepare(claim["metadata"]["uid"])
            return ctr, seen, served

        # Phase 26: an exclusive claim.
        t0 = time.perf_counter()
        uid = "dra-exclusive"
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        parent_used = total - free
        ctr, seen, served = serve_exclusive(dra_claim(uid, device),
                                            "exclusive")
        if uid in state.cdi.list_claim_spec_uids() or \
                uid in state.checkpoint.read() or \
                state.share_state.list_chips():
            raise AssertionError("unprepare left the claim behind")
        out["exclusive"] = dict(
            cdi=ctr, worker_device=seen,
            **{k: served[k] for k in ("tokens_per_s", "wall_s",
                                      "ttft_p50_ms", "decode_step_p50_ms",
                                      "capture_s", "peak_mem_gb")},
            # What the worker holds on the card outside PyTorch's
            # allocator: its CUDA context at start; after serving, the
            # context, the kernels' code and what else CUDA keeps.
            context_bytes=seen["device_used_bytes"] - parent_used,
            outside_allocator_bytes=(served["device_used_bytes"]
                                     - parent_used
                                     - served["reserved_bytes"]),
            s=time.perf_counter() - t0)
        phase_done(f"phase 26: an exclusive claim's worker saw one GPU "
                   f"({chip.uuid}) and served phase 4's streams; "
                   f"unprepared")

        # Phase 27: a process-shared claim, two workers, a third refused,
        # then the cap lowered under the running workers.
        t0 = time.perf_counter()
        uid = "dra-shared"
        devices = state.prepare(dra_claim(uid, device, {
            "strategy": "ProcessShared", "processSharedConfig": {
                "maxProcesses": 2, "defaultHbmLimit": DRA_LIMIT,
                "defaultActiveCorePercentage": 50}}))
        ctr = cdi_container(state.cdi.cdi_root, devices)
        env = ctr["env"]
        want = {"TPU_DRA_RUNTIME": "cuda", "CUDA_VISIBLE_DEVICES": chip.uuid,
                "TPU_DRA_MAX_PROCESSES": "2",
                "TPU_DRA_HBM_LIMIT_BYTES": str(36 << 30),
                "TPU_DRA_CHIP_HBM_BYTES": str(chip.hbm_bytes),
                "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE": "50"}
        if any(env.get(k) != v for k, v in want.items()) or \
                "XLA_PYTHON_CLIENT_MEM_FRACTION" in env:
            raise AssertionError(f"process-shared env {env}")
        pair = [worker("shared", env, f"shared{i}") for i in range(2)]
        slots = [w.expect("slot") for w in pair]
        if sorted(s["slot"] for s in slots) != [0, 1] or any(
                (s["count"], s["uuid"]) != (1, chip.uuid) for s in slots):
            raise AssertionError(f"slots {slots}")
        third = worker("shared", env, "shared2")
        refused = third.expect("refused")
        third.finish()
        probes = []
        for w in pair:              # one at a time: each fills its cap
            w.send("probe")
            probes.append(w.expect("probe"))
        for w in pair:
            w.send("serve")
        served2 = [w.expect("served") for w in pair]
        for i, s in enumerate(served2):
            hold_serving(f"process-shared worker {i}", s, streams, launches)
        resized = state.resize_claim_limits(uid, hbm_limit=DRA_RESIZED)
        after = []
        for w in pair:
            w.send("poll")
            after.append(w.expect("resized"))
        for a in after:
            if a["generation"] != resized["generation"] or \
                    a["hbm_limit_bytes"] != 24 << 30:
                raise AssertionError(f"resize {resized}, worker {a}")
        for w in pair:
            w.send("exit")
            w.finish()
        state.unprepare(uid)
        out["shared"] = dict(
            limit_bytes=36 << 30, slots=slots, refused=refused["error"],
            probes=probes,
            served=[{k: s[k] for k in ("tokens_per_s", "wall_s",
                                       "ttft_p50_ms", "decode_step_p50_ms",
                                       "capture_s", "peak_mem_gb")}
                    for s in served2],
            resized_limit_bytes=24 << 30,
            generation=resized["generation"], after_resize=after,
            s=time.perf_counter() - t0)
        phase_done(f"phase 27: a process-shared claim's two workers took "
                   f"slots 0 and 1, a third was refused, each hit its cap "
                   f"({[p['cap_bytes'] for p in probes]} bytes for a "
                   f"{36 << 30}-byte limit), served phase 4's streams at "
                   f"once, and after the resize to {DRA_RESIZED} hit the "
                   f"new cap ({[a['cap_bytes'] for a in after]})")

        # Phase 28: a time-shared claim, two workers taking turns.
        t0 = time.perf_counter()
        uid = "dra-timeshared"
        devices = state.prepare(dra_claim(uid, device, {
            "strategy": "TimeShared",
            "timeSharedConfig": {"interval": "Short"}}))
        ctr = cdi_container(state.cdi.cdi_root, devices)
        pair = [worker("timeshared", ctr["env"], f"timeshared{i}")
                for i in range(2)]
        for w in pair:
            seen = w.expect("ready")
            if (seen["count"], seen["uuid"]) != (1, chip.uuid):
                raise AssertionError(f"the worker sees {seen}")
        for w in pair:
            w.send("go")
        served3 = [w.expect("served") for w in pair]
        for w in pair:
            w.finish()
        for i, s in enumerate(served3):
            hold_serving(f"time-shared worker {i}", s, streams, launches)
        merged = sorted((a, b, i) for i, s in enumerate(served3)
                        for a, b in s["intervals"])
        for (a0, b0, i0), (a1, b1, i1) in zip(merged, merged[1:]):
            if a1 < b0:
                raise AssertionError(f"leases overlap: worker {i0} "
                                     f"[{a0}, {b0}], worker {i1} [{a1}, {b1}]")
        handoffs = sum(x[2] != y[2] for x, y in zip(merged, merged[1:]))
        state.unprepare(uid)
        held = sum(b - a for a, b, _ in merged)
        out["timeshared"] = dict(
            leases=[len(s["intervals"]) for s in served3],
            handoffs=handoffs, leased_s=held,
            span_s=merged[-1][1] - merged[0][0],
            lease_ms_p50=statistics.median(
                (b - a) * 1e3 for a, b, _ in merged),
            served=[{k: s[k] for k in ("tokens_per_s", "wall_s",
                                       "ttft_p50_ms", "decode_step_p50_ms",
                                       "capture_s", "peak_mem_gb")}
                    for s in served3],
            longest_lease_s=max(b - a for a, b, _ in merged),
            s=time.perf_counter() - t0)
        phase_done(f"phase 28: a time-shared claim's two workers served "
                   f"phase 4's streams in {len(merged)} disjoint leases "
                   f"({handoffs} handoffs)")

        # Phase 29: the scheduler side allocates the claim that is
        # prepared and served.
        t0 = time.perf_counter()
        sched = scheduler(state, chip, device)
        alloc, claim = sched["alloc"], sched["claim"]
        _, _, served = serve_exclusive(claim, "allocated")
        alloc.deallocate(claim["metadata"]["uid"])
        again = alloc.allocate(hbm_claim("dra-again", "h100", 64 << 30))
        if again["status"]["allocation"] != claim["status"]["allocation"]:
            raise AssertionError(f"re-allocated {again['status']}, first "
                                 f"{claim['status']}")
        alloc.deallocate("dra-again")
        times = allocate_ms(alloc)
        out["scheduler"] = dict(
            allocation=claim["status"]["allocation"],
            unsat_reason=sched["reason"],
            unsat_record=sched["newest_record"], slices=sched["slices"],
            allocate_ms=times, allocate_ms_p50=statistics.median(times),
            ttft_p50_ms=served["ttft_p50_ms"],
            decode_step_p50_ms=served["decode_step_p50_ms"],
            tokens_per_s=served["tokens_per_s"],
            s=time.perf_counter() - t0)
        log("scheduler: " + json.dumps(
            {k: out["scheduler"][k] for k in (
                "allocate_ms_p50", "unsat_reason", "ttft_p50_ms",
                "decode_step_p50_ms", "tokens_per_s", "s")}))
        phase_done(f"phase 29: the allocator placed a CEL-selected claim "
                   f"on {device}, refused one for {chip.hbm_bytes + 1} "
                   f"bytes ({sched['reason']}), and its prepared worker "
                   f"served phase 4's streams; re-allocated after release")
    finally:
        for w in workers:
            w.stop()
        state.chiplib.shutdown()
    return out


# ---------------------------------------------------------------------------
# Phase 30: the kubelet-facing node plugin on the card
# ---------------------------------------------------------------------------

# The two tenants' SLOs (tests/test_rebalancer.py's INFER_SLO, BATCH_SLO).
DRA_REALTIME_SLO = {"latencyClass": "realtime", "minTensorCorePercent": 30,
                    "burstTensorCorePercent": 80, "minHbmPercent": 25,
                    "burstHbmPercent": 75, "priority": 10}
DRA_BATCH_SLO = {"latencyClass": "batch", "minTensorCorePercent": 20,
                 "burstTensorCorePercent": 100, "minHbmPercent": 25,
                 "burstHbmPercent": 100}
# Each tenant starts at phase 27's limit, DRA_LIMIT (36Gi, about 45% of
# the card, so two 8B engines fit side by side), and half the cores. The
# rebalancer's move is MisoPolicy's step: 10% of the card, which leaves
# the batch tenant about 28Gi, above phase 27's 24Gi.
DRA_TENANT_CORES = 50
DRA_BUSY = (0.95, 0.95)     # realtime: above MisoPolicy's high water 0.85
DRA_IDLE = (0.05, 0.05)     # batch: below its low water 0.35
DRA_PREPARE_PAIRS = 20      # prepare/unprepare pairs timed in phase 30
DRA_PROFILED_PAIRS = 5      # and profiled after them
DRA_PROFILE_LINES = 25
DRA_NS = "chip-smoke"
# Seconds plugin.main may take to exit on SIGTERM: its device watch must
# not hold it (a pod's default grace period is 30 s).
DRA_STOP_S = 5.0
DRA_TENANTS = ("dra-realtime", "dra-batch")


def tenant_claim(uid: str, slo: dict, device=None) -> dict:
    """A process-shared claim (``maxProcesses`` 2, DRA_LIMIT, half the
    cores) declaring ``slo``, as a user writes it; with ``device``, also
    allocated there, in wire form (tests/test_rebalancer.py's
    ``shared_claim``, with the fields the API server's schema wants)."""
    opaque = {"driver": DRA_DRIVER, "parameters": {
        "apiVersion": "tpu.google.com/v1alpha1", "kind": "TpuChipConfig",
        "sharing": {"strategy": "ProcessShared", "processSharedConfig": {
            "maxProcesses": 2, "defaultActiveCorePercentage": DRA_TENANT_CORES,
            "defaultHbmLimit": DRA_LIMIT, "slo": slo}}}}
    claim = {
        "apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
        "metadata": {"name": uid, "namespace": DRA_NS, "uid": uid},
        "spec": {"devices": {
            "requests": [{"name": "gpu", "deviceClassName": DRA_DRIVER}],
            "config": [{"requests": [], "opaque": opaque}]}},
    }
    if device is not None:
        claim["status"] = {"allocation": {"devices": {
            "results": [{"request": "gpu", "driver": DRA_DRIVER,
                         "pool": os.uname().nodename, "device": device}],
            "config": [{"requests": [], "source": "FromClaim",
                        "opaque": opaque}]}}}
    return claim


def kubelet_call(transport, method: str, message, reply_cls) -> tuple:
    """The kubelet stand-in's call: ``message`` encoded by the port's
    codec, sent through the plugin's transport, the reply decoded;
    (reply, round trip in host ms)."""
    t = time.perf_counter()
    reply = reply_cls.FromString(
        transport.call(method, message.SerializeToString()))
    return reply, (time.perf_counter() - t) * 1e3


def http_get(url: str, timeout: float = 10.0) -> tuple:
    """(status, body) of a GET; an HTTP error status is returned, not
    raised."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def metric_lines(text: str, name: str, **labels) -> list:
    """The sample lines of ``name`` carrying every label in ``labels``."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    return [ln for ln in text.splitlines()
            if ln.startswith((name + "{", name + " "))
            and all(w in ln for w in want)]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plugin_cli(root: Path) -> dict:
    """``python3 -m k8s_dra_driver_tpu_torch.plugin.main`` on the card:
    ``/readyz`` 200 and one chip in ``/metrics``, exit 0 on SIGTERM."""
    import signal

    t0 = time.perf_counter()
    port = free_port()
    log_path = root / "plugin-main.log"
    argv = [sys.executable, "-m", "k8s_dra_driver_tpu_torch.plugin.main",
            "--no-kube", "--node-name", "chip-smoke", "--http-port", str(port),
            "--plugin-root", str(root / "cli" / "plugin"),
            "--registrar-root", str(root / "cli" / "registry"),
            "--state-root", str(root / "cli" / "state"),
            "--cdi-root", str(root / "cli" / "cdi")]
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=logf,
                                stderr=subprocess.STDOUT)
        try:
            url = f"http://127.0.0.1:{port}"
            deadline = time.monotonic() + 120
            ready = None
            while time.monotonic() < deadline:
                if proc.poll() is not None:
                    raise AssertionError(f"plugin.main exited {proc.returncode}:"
                                         f"\n{log_path.read_text()[-4000:]}")
                try:
                    ready = http_get(url + "/readyz", timeout=2)
                except OSError:
                    ready = None
                if ready and ready[0] == 200:
                    break
                time.sleep(0.2)
            if not ready or ready[0] != 200:
                raise AssertionError(f"plugin.main /readyz: {ready}\n"
                                     f"{log_path.read_text()[-4000:]}")
            ready_s = time.perf_counter() - t0
            status, text = http_get(url + "/metrics")
            chips = metric_lines(text, "tpu_dra_usage_capacity_devices",
                                 type="chip")
            if status != 200 or [ln.split()[-1] for ln in chips] != ["1"]:
                raise AssertionError(f"plugin.main /metrics: {status} "
                                     f"{chips}")
            t = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            stop_s = time.perf_counter() - t
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logged = log_path.read_text()
    if rc != 0 or stop_s > DRA_STOP_S:
        raise AssertionError(f"plugin.main exited {rc} {stop_s:.1f} s after "
                             f"SIGTERM:\n{logged[-4000:]}")
    if "no kubelet socket is served" not in logged:
        raise AssertionError("plugin.main did not warn that no kubelet "
                             "socket is served")
    return dict(ready_s=ready_s, readyz=ready[1].strip().splitlines(),
                capacity=chips, rc=rc, stop_s=stop_s,
                s=time.perf_counter() - t0)


def plugin_phase(torch, streams: list, launches: dict, published: list,
                 phase_done) -> dict:
    """Phase 30 (module docstring). ``streams`` and ``launches`` are
    phase 4's, ``published`` phase 29's ResourceSlices."""
    import cProfile
    import io
    import pstats

    from k8s_dra_driver_tpu_torch.kube import EVENTS, FakeKubeClient
    from k8s_dra_driver_tpu_torch.kube.allocator import ReferenceAllocator
    from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb
    from k8s_dra_driver_tpu_torch.kube.protos import (
        pluginregistration_v1 as regpb,
    )
    from k8s_dra_driver_tpu_torch.plugin import inspect
    from k8s_dra_driver_tpu_torch.plugin.driver import Driver, DriverConfig
    from k8s_dra_driver_tpu_torch.tpulib import ChipLibConfig, RealChipLib
    from k8s_dra_driver_tpu_torch.utils.metrics import MetricsServer, Registry

    t0 = time.perf_counter()
    root = ROOT / "build" / "dra" / "plugin"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    node = os.uname().nodename
    uuid = cuda_uuid(torch.cuda.get_device_properties(0))
    client = FakeKubeClient()
    config = DriverConfig(
        node_name=node,
        chiplib=RealChipLib(ChipLibConfig(state_dir=str(root / "modes"))),
        kube_client=client, cdi_root=str(root / "cdi"),
        plugin_root=str(root / "plugin"),
        registrar_root=str(root / "registry"),
        state_root=str(root / "state"), device_classes=frozenset({"chip"}),
        cleanup_interval_seconds=0, device_watch_interval_seconds=0,
        audit_interval_seconds=0)
    driver = Driver(config)
    transport = config.transport
    state = driver.state
    workers, server, out = [], None, {}
    prepare = "/v1beta1.DRAPlugin/NodePrepareResources"
    unprepare = "/v1beta1.DRAPlugin/NodeUnprepareResources"

    def claims_of(*uids):
        return [drapb.Claim(namespace=DRA_NS, uid=u, name=u) for u in uids]

    try:
        # 1. Start: the Driver publishes the card and answers GetInfo.
        driver.start()
        slices_gvr = driver.resource_api.slices
        deadline = time.monotonic() + 30
        while not client.list(slices_gvr) and time.monotonic() < deadline:
            time.sleep(0.05)
        mine = client.list(slices_gvr)
        if [s["spec"] for s in mine] != [s["spec"] for s in published]:
            raise AssertionError(f"the Driver published {mine}, phase 29 "
                                 f"{published}")
        info, _ = kubelet_call(
            transport, "/pluginregistration.Registration/GetInfo",
            regpb.InfoRequest(), regpb.PluginInfo)
        if (info.type, info.name, info.endpoint) != (
                "DRAPlugin", DRA_DRIVER, config.plugin_socket):
            raise AssertionError(f"GetInfo answered {info}")
        start_s = time.perf_counter() - t0

        # 2. Allocate, and prepare both tenants through the transport.
        alloc = ReferenceAllocator(client, registry=Registry(),
                                   device_classes={DRA_DRIVER:
                                                   [DRA_CLASS_CEL]})
        realtime = alloc.allocate(tenant_claim(DRA_TENANTS[0],
                                               DRA_REALTIME_SLO),
                                  node_name=node)
        (result,) = realtime["status"]["allocation"]["devices"]["results"]
        device = result["device"]
        batch = tenant_claim(DRA_TENANTS[1], DRA_BATCH_SLO, device)
        for claim in (realtime, batch):
            client.create(driver.resource_api.claims, claim,
                          namespace=DRA_NS)
        reply, prepare_pair_ms = kubelet_call(
            transport, prepare,
            drapb.NodePrepareResourcesRequest(claims=claims_of(*DRA_TENANTS)),
            drapb.NodePrepareResourcesResponse)
        ctr = {}
        for uid in DRA_TENANTS:
            got = reply.claims[uid]
            if got.error or [d.device_name for d in got.devices] != [device]:
                raise AssertionError(f"prepare of {uid}: {got}")
            ctr[uid] = cdi_container(config.cdi_root, got.devices)
            env = ctr[uid]["env"]
            want = {"TPU_DRA_RUNTIME": "cuda", "CUDA_VISIBLE_DEVICES": uuid,
                    "TPU_DRA_MAX_PROCESSES": "2",
                    "TPU_DRA_HBM_LIMIT_BYTES": str(36 << 30)}
            if any(env.get(k) != v for k, v in want.items()):
                raise AssertionError(f"{uid} env {env}")
        tenants = {}
        for uid in DRA_TENANTS:
            tenants[uid] = Worker("tenant", {**os.environ, **ctr[uid]["env"]},
                                  root / f"{uid}.log")
            workers.append(tenants[uid])
        slots = {uid: w.expect("slot") for uid, w in tenants.items()}
        if any((s["count"], s["uuid"]) != (1, uuid) for s in slots.values()):
            raise AssertionError(f"slots {slots}")
        before = {}
        for uid, w in tenants.items():   # one at a time: each fills its cap
            w.send("probe")
            before[uid] = w.expect("probe")
        for w in tenants.values():
            w.send("serve")
        served = {uid: w.expect("served") for uid, w in tenants.items()}
        for uid, s in served.items():
            hold_serving(f"{uid} worker", s, streams, launches)

        # 3. Rebalance: the realtime tenant busy, the batch one idle.
        for uid, (busy, hbm) in zip(DRA_TENANTS, (DRA_BUSY, DRA_IDLE)):
            tenants[uid].send(f"report {busy} {hbm}")
            tenants[uid].expect("reported")
        t = time.perf_counter()
        tick = driver.tick_once(now=time.time())
        tick_ms = (time.perf_counter() - t) * 1e3
        if not tick["rebalanced"] or tick["transitions"] or \
                tick["auditFindings"] != 0:
            raise AssertionError(f"tick {tick}")
        snap = driver.rebalancer.snapshot()
        moves = [d for d in snap["decisions"] if d["outcome"] == "applied"]
        if sorted(d["resource"] for d in moves) != ["hbm", "tensorcore"] or \
                any((d["gainer"]["claim"], d["donor"]["claim"])
                    != DRA_TENANTS for d in moves):
            raise AssertionError(f"rebalance decisions {snap['decisions']}")
        after = {}
        for uid, w in tenants.items():   # at each worker's step boundary
            w.send("poll")
            after[uid] = w.expect("resized")
        rt, bt = DRA_TENANTS
        if not (after[rt]["cap_bytes"] > before[rt]["cap_bytes"]
                and after[bt]["cap_bytes"] < before[bt]["cap_bytes"]):
            raise AssertionError(f"caps before {before}, after {after}")
        generations = {uid: snap["claims"][uid]["generation"]
                       for uid in DRA_TENANTS}
        if any(after[u]["generation"] != generations[u] for u in DRA_TENANTS):
            raise AssertionError(f"workers {after}, claims {generations}")
        drift = driver.auditor.run_once()
        if drift:
            raise AssertionError(f"audit after the move: {drift}")
        n, total = driver.rebalancer._m_rebalance_seconds.summary()

        # 4. Observe: /readyz, /metrics and inspect, wired as main wires.
        server = MetricsServer(driver.registry, host="127.0.0.1", port=0,
                               tracer=driver.tracer)
        for name, check in driver.readiness_checks().items():
            server.add_readiness_check(name, check)
        for name, check in driver.degraded_checks().items():
            server.add_readiness_check(name, check, critical=False)
        server.set_usage_provider(driver.usage.snapshot)
        server.set_rebalance_provider(driver.rebalancer.snapshot)
        server.start()
        url = f"http://127.0.0.1:{server.port}"
        ready = http_get(url + "/readyz")
        status, text = http_get(url + "/metrics")
        scraped = dict(
            prepares=metric_lines(text, "tpu_dra_claim_prepare_attempts_total",
                                  result="ok"),
            occupied=metric_lines(text, "tpu_dra_usage_occupied_devices",
                                  type="chip"),
            capacity=metric_lines(text, "tpu_dra_usage_capacity_devices",
                                  type="chip"),
            decisions=metric_lines(text,
                                   "tpu_dra_slo_rebalance_decisions_total",
                                   outcome="applied"),
            granted=metric_lines(text, "tpu_dra_slo_granted_share"))
        if ready[0] != 200 or status != 200 or \
                [ln.split()[-1] for ln in scraped["prepares"]] != ["2"] or \
                [ln.split()[-1] for ln in scraped["capacity"]] != ["1"] or \
                not any(ln.endswith(" 1") and "process-shared" in ln
                        for ln in scraped["occupied"]) or \
                sum(float(ln.split()[-1]) for ln in scraped["decisions"]) \
                != 2:
            raise AssertionError(f"/readyz {ready}; /metrics {scraped}")
        seen = inspect.collect(config.state_root, config.cdi_root,
                               http_url=url)
        rendered = inspect.render(seen)
        if sorted(c["uid"] for c in seen["preparedClaims"]) != \
                sorted(DRA_TENANTS) or not any(
                    d.get("outcome") == "applied"
                    for d in seen["live"].get("rebalanceDecisions", [])):
            raise AssertionError(f"inspect: {rendered}")
        log("driver inspect:\n" + rendered)

        # 5. Health and release.
        quiet = driver.tick_once()
        if quiet["transitions"] or quiet["changed"]:
            raise AssertionError(f"tick on the card: {quiet}")
        for w in tenants.values():
            w.send("exit")
            w.finish()
        reply, _ = kubelet_call(
            transport, unprepare,
            drapb.NodeUnprepareResourcesRequest(claims=claims_of(rt)),
            drapb.NodeUnprepareResourcesResponse)
        if reply.claims[rt].error or rt in state.cdi.list_claim_spec_uids() \
                or rt in state.checkpoint.read():
            raise AssertionError(f"unprepare of {rt}: {reply}")
        client.delete(driver.resource_api.claims, bt, namespace=DRA_NS)
        driver.cleaner.clean_once()
        if driver.cleaner.unprepared_deleted != 1 or state.checkpoint.read():
            raise AssertionError("the orphan cleaner left "
                                 f"{list(state.checkpoint.read())}")
        drift = driver.auditor.run_once()
        if drift:
            raise AssertionError(f"audit after release: {drift}")

        # The transport's round trip: prepare/unprepare pairs of a third
        # claim, with no worker.
        alloc.deallocate(rt)
        timed = alloc.allocate(hbm_claim("dra-timed", "h100", 64 << 30),
                               node_name=node)
        client.create(driver.resource_api.claims, timed, namespace=DRA_NS)
        def prepare_pair():
            times = []
            for method, request, reply_cls in (
                    (prepare, drapb.NodePrepareResourcesRequest,
                     drapb.NodePrepareResourcesResponse),
                    (unprepare, drapb.NodeUnprepareResourcesRequest,
                     drapb.NodeUnprepareResourcesResponse)):
                reply, ms = kubelet_call(
                    transport, method,
                    request(claims=claims_of("dra-timed")), reply_cls)
                if reply.claims["dra-timed"].error:
                    raise AssertionError(f"timed {method}: {reply}")
                times.append(ms)
            return times

        prepare_ms, unprepare_ms = zip(*(prepare_pair()
                                         for _ in range(DRA_PREPARE_PAIRS)))
        # Where a pair's host time goes: more pairs under cProfile (its
        # overhead stays out of the times above).
        profiler = cProfile.Profile()
        profiler.enable()
        for _ in range(DRA_PROFILED_PAIRS):
            prepare_pair()
        profiler.disable()
        text_io = io.StringIO()
        pstats.Stats(profiler, stream=text_io).sort_stats(
            "tottime").print_stats(DRA_PROFILE_LINES)
        log(f"driver prepare/unprepare profile ({DRA_PROFILED_PAIRS} pairs, "
            f"host, cProfile by own time):\n" + text_io.getvalue())
        driver.events.flush()
        events = sorted({(e["reason"], e["involvedObject"]["name"])
                         for e in client.list(EVENTS)})
        server.stop()
        server = None
        t = time.perf_counter()
        driver.shutdown()
        shutdown_s = time.perf_counter() - t
        driver = None
        cli = plugin_cli(root)
        out = dict(
            device=device, start_s=start_s, published=len(mine),
            get_info=dict(name=info.name, endpoint=info.endpoint,
                          versions=list(info.supported_versions)),
            prepare_two_ms=prepare_pair_ms, slots=slots,
            cdi_files=ctr[rt]["files"] + ctr[bt]["files"],
            served={uid: {k: s[k] for k in (
                "tokens_per_s", "wall_s", "ttft_p50_ms",
                "decode_step_p50_ms", "capture_s", "peak_mem_gb")}
                for uid, s in served.items()},
            caps_before={u: before[u]["cap_bytes"] for u in DRA_TENANTS},
            caps_after={u: after[u]["cap_bytes"] for u in DRA_TENANTS},
            moves=[{k: d[k] for k in ("action", "resource", "gainer",
                                      "donor", "generations")}
                   for d in moves],
            rebalance_apply_ms=total / n * 1e3 if n else None,
            tick_ms=tick_ms, generations=generations, metrics=scraped,
            readyz=ready[1].strip().splitlines(), events=events,
            prepare_ms=list(prepare_ms), unprepare_ms=list(unprepare_ms),
            prepare_ms_p50=statistics.median(prepare_ms),
            unprepare_ms_p50=statistics.median(unprepare_ms),
            shutdown_s=shutdown_s, cli=cli, s=time.perf_counter() - t0)
    finally:
        for w in workers:
            w.stop()
        if server is not None:
            server.stop()
        if driver is not None:
            driver.shutdown()
    log("driver: " + json.dumps({
        "prepare_ms_p50": out["prepare_ms_p50"],
        "unprepare_ms_p50": out["unprepare_ms_p50"],
        "moves": [f"{d['resource']} {d['donor']['claim']} "
                  f"{d['donor']['from']}->{d['donor']['to']}% to "
                  f"{d['gainer']['claim']} {d['gainer']['from']}->"
                  f"{d['gainer']['to']}%" for d in out["moves"]],
        "rebalance_apply_ms": out["rebalance_apply_ms"],
        "tick_ms": out["tick_ms"], "caps_before": out["caps_before"],
        "caps_after": out["caps_after"],
        "ttft_p50_ms": {u: s["ttft_p50_ms"] for u, s in out["served"].items()},
        "decode_step_p50_ms": {u: s["decode_step_p50_ms"]
                               for u, s in out["served"].items()},
        "cli_ready_s": out["cli"]["ready_s"],
        "cli_stop_s": out["cli"]["stop_s"], "s": out["s"]}))
    phase_done(f"phase 30: the Driver published {device} as phase 29 did, "
               f"prepared both tenants through the transport, moved "
               f"{len(out['moves'])} shares from the batch tenant to the "
               f"realtime one (caps {out['caps_before']} -> "
               f"{out['caps_after']}), released both (one as an orphan); "
               f"plugin.main answered and exited 0")
    return out


# ---------------------------------------------------------------------------
# Phase 31: the fleet doctor against the card's live node
# ---------------------------------------------------------------------------

DOCTOR_NS = "chip-smoke"
DOCTOR_CLAIM = "doctor-serve"     # the exclusive claim the engine serves on
DOCTOR_ORPHAN = "doctor-orphan"   # the CDI spec planted for the drift pass
DOCTOR_UNSAT = "doctor-unsat"     # the claim no device on the card meets
DOCTOR_MFU_OVER = 3.0             # the regressed baseline over the measured
DOCTOR_CLI_S = 120                # seconds the doctor's CLI may take
# The fleet soak's mini profile, written by ``fleetsim.write_artifact``
# with no wall-clock section, as the reference package writes it on
# Python 3.12: its sha256, and each top-level key's (the first 16 hex
# digits of the sha256 of ``json.dumps(value, indent=2, sort_keys=True)``)
# to name the first key that differs.
FLEET_MINI_SHA256 = ("273e0fdc2686467f8e67e87bd232302c"
                     "3353c7beff431d1e8febd18314cbc505")
FLEET_MINI_KEYS = {
    "audit": "592c03b2a66d3da5", "autoscaler": "59cff234dc83ff24",
    "chaos": "6f7b26ba107bf1cb", "counters": "e1a067069f28398d",
    "defrag": "e8663e430e70e2aa", "elastic": "ffd386fcbbee96a5",
    "gates": "d728a15c94d235b7", "kvResidency": "7620f920e8e1d7e4",
    "loss": "9e0c5890fc9dd893", "lossByClass": "d0e4ed678b224117",
    "pass": "b5bea41b6c623f7c", "prefixCache": "d452834ad333b86f",
    "rebalancer": "17aec1ae2533a83f", "scenario": "30be104985d9d0fe",
    "schema": "635298700503838e", "slo": "2ba74892b1b9ace0",
}


def key_digest(value) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(value, indent=2, sort_keys=True)
                          .encode()).hexdigest()[:16]


def bench_round(root: Path, name: str, mfu: float, kind: str) -> str:
    """A directory holding one ``BENCH_r01.json`` in ``bench.py``'s format
    whose one metric is the decode program's MFU ``mfu`` on ``kind``; the
    doctor's ``--bench-dir``."""
    d = root / name
    d.mkdir()
    parsed = {"metric": "h100_8b_decode_mfu", "value": mfu,
              "unit": "mfu_fraction", "vs_baseline": None, "repeats": 1,
              "spread": 0.0, "detail": {"device": kind,
                                        "program": "decode_step"}}
    doc = {"n": 1, "cmd": "python3 chip_smoke.py", "rc": 0,
           "tail": json.dumps(parsed), "parsed": parsed}
    (d / "BENCH_r01.json").write_text(json.dumps(doc, indent=2) + "\n")
    return str(d)


def by_check(findings) -> dict:
    """{check: {severity: count}} of a doctor pass's findings."""
    out = {}
    for f in findings:
        cell = out.setdefault(f.check, {})
        cell[f.severity] = cell.get(f.severity, 0) + 1
    return out


def doctor_phase(torch, params, cfg, dev, phase4) -> dict:
    """Phase 31 (module docstring). ``params`` are phase 4's weights from
    the seed and ``phase4`` its streams and prompt lengths. Returns the
    figures and the gateway's streams (held to phase 4's by the caller,
    outside the counted run)."""
    import hashlib
    import tarfile

    from k8s_dra_driver_tpu_torch import doctor
    from k8s_dra_driver_tpu_torch.controller import IciSliceManager
    from k8s_dra_driver_tpu_torch.fleetsim import (
        FleetSim,
        mini_scenario,
        write_artifact,
    )
    from k8s_dra_driver_tpu_torch.kube import NODES, FakeKubeClient
    from k8s_dra_driver_tpu_torch.kube.allocator import (
        RUNBOOK_HINTS,
        AllocationError,
        ReferenceAllocator,
    )
    from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb
    from k8s_dra_driver_tpu_torch.models.compute_telemetry import (
        ComputeTelemetry,
    )
    from k8s_dra_driver_tpu_torch.models.serving import RUNNING, KVTelemetry
    from k8s_dra_driver_tpu_torch.plugin.driver import Driver, DriverConfig
    from k8s_dra_driver_tpu_torch.serving_gateway import (
        Router,
        ServingGateway,
    )
    from k8s_dra_driver_tpu_torch.tpulib import ChipLibConfig, RealChipLib
    from k8s_dra_driver_tpu_torch.utils.metrics import MetricsServer, Registry

    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    root = ROOT / "build" / "dra" / "doctor"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    node = os.uname().nodename
    client = FakeKubeClient()
    client.create(NODES, {"metadata": {"name": node, "uid": f"uid-{node}"}})
    config = DriverConfig(
        node_name=node,
        chiplib=RealChipLib(ChipLibConfig(state_dir=str(root / "modes"))),
        kube_client=client, cdi_root=str(root / "cdi"),
        plugin_root=str(root / "plugin"),
        registrar_root=str(root / "registry"),
        state_root=str(root / "state"), node_uid=f"uid-{node}",
        device_classes=frozenset({"chip"}), cleanup_interval_seconds=0,
        device_watch_interval_seconds=0, audit_interval_seconds=0)
    driver = Driver(config)
    registry = driver.registry
    server = mgr = tel = eng = gw = None
    ones = {"decode_step": 1, "prefill_chunk": 1}
    try:
        # a. The node: the Driver publishes the card, the allocator
        # places one exclusive claim there, prepared through the
        # transport, and the engine serves behind the gateway on the
        # Driver's registry, every document on one server.
        driver.start()
        deadline = time.monotonic() + 30
        while not client.list(driver.resource_api.slices) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        alloc = ReferenceAllocator(client, registry=Registry(),
                                   device_classes={DRA_DRIVER:
                                                   [DRA_CLASS_CEL]})
        claim = alloc.allocate(hbm_claim(DOCTOR_CLAIM, "h100", 64 << 30),
                               node_name=node)
        (result,) = claim["status"]["allocation"]["devices"]["results"]
        device = result["device"]
        client.create(driver.resource_api.claims, claim, namespace=DOCTOR_NS)
        reply, prepare_ms = kubelet_call(
            config.transport, "/v1beta1.DRAPlugin/NodePrepareResources",
            drapb.NodePrepareResourcesRequest(claims=[drapb.Claim(
                namespace=DOCTOR_NS, uid=DOCTOR_CLAIM, name=DOCTOR_CLAIM)]),
            drapb.NodePrepareResourcesResponse)
        got = reply.claims[DOCTOR_CLAIM]
        if got.error or [d.device_name for d in got.devices] != [device]:
            raise AssertionError(f"prepare of {DOCTOR_CLAIM}: {got}")
        eng = smoke_engine(params, cfg, dev)
        tel = ComputeTelemetry(registry)
        tel.attach(eng, replica="r0", claim_uid=DOCTOR_CLAIM)
        KVTelemetry(registry).attach(eng, replica="r0")
        gw = ServingGateway(registry, router=Router(policy="affinity",
                                                    block_size=BLOCK_SIZE),
                            node_name=node)
        gw.add_replica(eng, "r0", claim_uid=DOCTOR_CLAIM)
        server = MetricsServer(registry, host="127.0.0.1", port=0,
                               tracer=driver.tracer)
        for name, check in driver.readiness_checks().items():
            server.add_readiness_check(name, check)
        for name, check in driver.degraded_checks().items():
            server.add_readiness_check(name, check, critical=False)
        server.set_usage_provider(driver.usage.snapshot)
        server.set_rebalance_provider(driver.rebalancer.snapshot)
        server.set_allocations_provider(alloc.export_allocations_jsonl)
        server.set_gateway_provider(gw.snapshot)
        server.set_residency_provider(gw.residency.snapshot)
        server.set_compute_provider(tel.compute_debug)
        server.start()
        url = f"http://127.0.0.1:{server.port}"
        urls = {node: url}

        # Both programs captured by a warm-up request, then mark_warm:
        # every capture after it would read as a recompile.
        gen = torch.Generator()
        gen.manual_seed(SEED + 131)
        warm = gw.submit(torch.randint(0, cfg.vocab_size,
                                       (GW_WARMUP_PROMPT,),
                                       generator=gen).tolist(),
                         GW_WARMUP_NEW)
        gw.run()
        if warm.state != "finished" or dict(eng.compile_counts) != ones:
            raise AssertionError(f"warm-up {warm.state}, compile_counts "
                                 f"{eng.compile_counts}")
        tel.mark_warm()
        prompts = [s[:n] for s, n in zip(phase4["streams"],
                                          phase4["prompt_lens"])]
        torch.cuda.synchronize()
        t = time.perf_counter()
        reqs = [gw.submit(p, NEW_TOKENS) for p in prompts[:5]]
        # The shared-prefix family once the first holder of the prefix
        # runs, as phase 4 submits it.
        for _ in range(10000):
            if reqs[-1].done or (reqs[-1].engine_req is not None
                                 and reqs[-1].engine_req.state == RUNNING):
                break
            gw.tick()
        else:
            raise AssertionError("the first shared-prefix request never ran")
        reqs += [gw.submit(p, NEW_TOKENS) for p in prompts[5:]]
        gw.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        bad = [(r.gid, r.state) for r in reqs if r.state != "finished"
               or len(r.tokens) - len(r.prompt) != NEW_TOKENS]
        if bad:
            raise AssertionError(f"gateway requests not finished: {bad}")

        def mfu_wave(seed):
            """A decode-heavy wave through the gateway, the registry
            scraped every tick (the roofline window is the last 32
            scrapes); the decode program's MFU as /debug/compute reports
            it just after."""
            g = torch.Generator()
            g.manual_seed(seed)
            wave = [gw.submit(torch.randint(0, cfg.vocab_size, (TEL_PROMPT,),
                                            generator=g).tolist(), TEL_NEW)
                    for _ in range(TEL_REQUESTS)]
            for _ in range(100000):
                if all(r.done for r in wave):
                    break
                gw.tick()
                registry.render()
            else:
                raise AssertionError("the decode wave never finished")
            if any(r.state != "finished" for r in wave):
                raise AssertionError("the decode wave lost requests")
            status, body = http_get(url + "/debug/compute")
            if status != 200:
                raise AssertionError(f"/debug/compute answered {status}")
            return json.loads(body)["programs"]["decode_step"]["r0"]["mfu"]

        def diagnose(**kwargs):
            t = time.perf_counter()
            report, findings, status = doctor.run(urls, kube_client=client,
                                                  **kwargs)
            return report, findings, status, (time.perf_counter() - t) * 1e3

        # b. The controller: the card's Node has no slice label.
        mgr = IciSliceManager(client, DRA_DRIVER, registry=Registry())
        mgr.start()
        deadline = time.monotonic() + 10
        while not mgr.healthy()[0] and time.monotonic() < deadline:
            time.sleep(0.05)
        if not mgr.healthy()[0] or mgr.domains():
            raise AssertionError(f"slice manager {mgr.healthy()}, domains "
                                 f"{mgr.domains()}")
        audit = driver.auditor.run_once()
        if audit:
            raise AssertionError(f"audit before the doctor: {audit}")

        # c. Clean, against a baseline of this run's own decode MFU.
        mfu_c = mfu_wave(SEED + 132)
        clean_dir = bench_round(root, "bench-clean", mfu_c, kind)
        bundle = root / "bundle.tar"
        report, found, status, clean_ms = diagnose(bench_dir=clean_dir,
                                                   bundle=str(bundle))
        loud = [str(f) for f in found if f.severity != doctor.SEVERITY_INFO]
        line = next((ln for ln in report.splitlines()
                     if ln.startswith(f"[{node}] ")), "")
        if status != 0 or loud or "chip 1/1" not in line \
                or "holds: 1" not in line \
                or "ICI channels 0/0 allocated" not in report:
            raise AssertionError(f"clean pass: status {status}, {loud}\n"
                                 f"{report}")
        held = {d["name"] for h in doctor.collect_node(node, url).holds
                for d in h.get("devices", [])}
        if held != {device}:
            raise AssertionError(f"the doctor reads holds {held}, the claim "
                                 f"holds {device}")
        with tarfile.open(bundle) as tar:
            members = tar.getnames()
        want = {f"nodes/{node}/{doc}.json"
                for doc in ("compute", "gateway", "residency")}
        if not want <= set(members):
            raise AssertionError(f"bundle members {members}")
        clean = dict(ms=clean_ms, status=status, findings=by_check(found),
                     mfu=mfu_c, report=report)
        log("doctor report (clean pass):\n" + report)

        # g. The CLI, as an operator runs it, on this node alone.
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "k8s_dra_driver_tpu_torch.doctor",
             "--node", f"{node}={url}", "--no-kube", "--json"],
            cwd=ROOT, capture_output=True, text=True, timeout=DOCTOR_CLI_S)
        cli_s = time.perf_counter() - t
        try:
            listed = json.loads(proc.stdout)
        except ValueError:
            listed = None
        if proc.returncode != 0 or not isinstance(listed, list):
            raise AssertionError(f"doctor CLI exited {proc.returncode}: "
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        cli = dict(rc=proc.returncode, s=cli_s, findings=len(listed))

        # d. Drift: an orphaned CDI claim spec, as a crash leaves it.
        driver.state.cdi.create_claim_spec_file(DOCTOR_ORPHAN, {}, {})
        audit = driver.auditor.run_once()
        if not any(f.check == "cdi" and f.subject == DOCTOR_ORPHAN
                   for f in audit):
            raise AssertionError(f"the auditor missed the orphan: {audit}")
        report, found, status, drift_ms = diagnose()
        audit_drift = [f for f in found if f.check == "node-audit"
                       and f.severity == doctor.SEVERITY_DRIFT]
        if status != 1 or [f.subject for f in audit_drift] != [f"{node}/cdi"]:
            raise AssertionError(f"drift pass: status {status}\n{report}")
        driver.state.cdi.delete_claim_spec_file(DOCTOR_ORPHAN)
        audit_after = driver.auditor.run_once()
        if audit_after:
            raise AssertionError(f"audit after the orphan: {audit_after}")
        drift = dict(ms=drift_ms, status=status, findings=by_check(found),
                     auditor=[f"[{f.check}] {f.subject}" for f in audit])

        # e. Explain: a claim whose selector nothing on the card meets.
        unsat = hbm_claim(DOCTOR_UNSAT, "h100", 0)
        unsat["spec"]["devices"]["requests"][0]["selectors"] = [{"cel": {
            "expression": f"device.attributes['{DRA_DRIVER}'].type == "
                          "'optical-interconnect'"}}]
        try:
            alloc.allocate(unsat)
        except AllocationError as e:
            reason = e.reason
        else:
            raise AssertionError("a claim nothing meets was allocated")
        client.create(driver.resource_api.claims, unsat, namespace=DOCTOR_NS)
        report, found, status, explain_ms = diagnose()
        hint = RUNBOOK_HINTS.get(reason, "")
        explain = [f for f in found if f.check == "explain"]
        if status != 1 or not hint or len(explain) != 1 \
                or explain[0].subject != f"{DOCTOR_NS}/{DOCTOR_UNSAT}" \
                or hint not in explain[0].detail:
            raise AssertionError(f"explain pass (reason {reason!r}): status "
                                 f"{status}\n{report}")
        explained = dict(ms=explain_ms, status=status, reason=reason,
                         findings=by_check(found), detail=explain[0].detail)

        # f. mfu-regression against this run's measurement and 3x it.
        mfu_f = mfu_wave(SEED + 133)
        measured_dir = bench_round(root, "bench-measured", mfu_f, kind)
        over_dir = bench_round(root, "bench-3x", DOCTOR_MFU_OVER * mfu_f,
                               kind)
        _, found_ok, _, mfu_ok_ms = diagnose(bench_dir=measured_dir)
        _, found_over, _, mfu_over_ms = diagnose(bench_dir=over_dir)
        reg_ok = [f for f in found_ok if f.check == "mfu-regression"]
        reg_over = [f for f in found_over if f.check == "mfu-regression"]
        if reg_ok or [(f.severity, f.subject) for f in reg_over] != [
                (doctor.SEVERITY_DRIFT, f"{node}/r0/decode_step")]:
            raise AssertionError(f"mfu-regression: {reg_ok} against the "
                                 f"measured baseline, {reg_over} against "
                                 f"{DOCTOR_MFU_OVER}x")
        if any(f.check == "recompile-storm" for f in found_over) \
                or dict(eng.compile_counts) != ones:
            raise AssertionError(f"captures after warm-up: "
                                 f"{eng.compile_counts}")
        mfu = dict(measured=mfu_f, ok_ms=mfu_ok_ms, over_ms=mfu_over_ms,
                   findings_ok=by_check(found_ok),
                   findings_over=by_check(found_over),
                   detail=reg_over[0].detail)
        st = eng.stats
        serving = dict(
            device=device, prepare_ms=prepare_ms, serve_s=serve_s,
            streams=[r.tokens for r in reqs],
            decode_p50_ms=st.p50_token_ms(), ttft_p50_ms=st.p50_ttft_ms(),
            decode_steps=st.decode_steps,
            prefill_launches=st.prefill_lanes_launched // eng.prefill_batch,
            compile_counts=dict(eng.compile_counts))
    finally:
        if mgr is not None:
            mgr.stop(cleanup=False)
        if tel is not None:
            tel.close()
        if server is not None:
            server.stop()
        driver.shutdown()
        gw = eng = None
        gc.collect()
        torch.cuda.empty_cache()

    # h. The fleet soak's mini profile on this host: byte for byte.
    t = time.perf_counter()
    fleet = FleetSim(mini_scenario()).run()
    path = root / "FLEET_mini.json"
    write_artifact(fleet, str(path))
    soak_s = time.perf_counter() - t
    sha = hashlib.sha256(path.read_bytes()).hexdigest()
    if sha != FLEET_MINI_SHA256:
        keys = sorted(set(fleet) | set(FLEET_MINI_KEYS))
        first = next((k for k in keys if k not in fleet
                      or key_digest(fleet[k]) != FLEET_MINI_KEYS.get(k)),
                     None)
        raise AssertionError(f"the fleet soak's artifact hashes to {sha}, "
                             f"not {FLEET_MINI_SHA256}; the first differing "
                             f"top-level key is {first!r}")
    return dict(serving=serving, clean=clean, cli=cli, drift=drift,
                explain=explained, mfu=mfu, bundle_members=len(members),
                soak=dict(s=soak_s, sha256=sha, passed=fleet["pass"]),
                s=time.perf_counter() - t0)


def nbytes(tree) -> int:
    """Bytes of every tensor in a parameter dict (QuantTensors: q and
    scale)."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if hasattr(tree, "q"):
        return nbytes(tree.q) + nbytes(tree.scale)
    return tree.numel() * tree.element_size()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from k8s_dra_driver_tpu_torch.models import (
            MOE_PRESETS,
            PRESETS,
            init_params,
            moe,
        )
        from k8s_dra_driver_tpu_torch.models.step_graph import (
            write_launches,
        )
        from k8s_dra_driver_tpu_torch.ops import (
            LAUNCH_COUNTERS,
            _build,
            attention,
            moe_dispatch,
            norms,
            quant_matmul,
        )
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    clock = [time.perf_counter()]

    def phase_done(msg: str) -> None:
        """Logs a phase's line with its seconds (since the last one)."""
        now = time.perf_counter()
        log(f"{msg} ({now - clock[0]:.1f}s)")
        clock[0] = now

    _build.build()
    phase_done(f"phase 1: built {_build.sources()}")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning")):
                log(f"  {name}: {line.strip()}")

    cfg = PRESETS["8b"]
    kernels = check_kernels(torch, cfg, dev)
    kernels.update(check_flash_kernels(torch, PRESETS["8b-L8"], dev))
    phase_done("phase 2: kernels agree with their plain versions")

    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"8b params ({cfg.num_params() / 1e9:.2f}B) initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    forward = compare_forward(torch, params, cfg, dev)
    phase_done("phase 3: 8B forward through kernels matches the plain "
               "forward")

    wrappers = {
        "paged_decode": attention.paged_decode_attention,
        "paged_prefill": attention.paged_prefill_attention,
        "rmsnorm": norms.rmsnorm,
        "flash_fwd": attention.flash_fwd,
        "flash_bwd_dkdv": attention.flash_bwd_dkdv,
        "flash_bwd_dq": attention.flash_bwd_dq,
        "moe_gateup": moe_dispatch.moe_gateup,
        "moe_down_combine": moe_dispatch.moe_down_combine,
        "grouped_matmul": moe_dispatch.grouped_matmul,
        "grouped_weight_grad": moe_dispatch.grouped_weight_grad,
        "paged_decode_int8": attention.paged_decode_int8,
        "paged_prefill_int8": attention.paged_prefill_int8,
        "moe_gateup_int8": moe_dispatch.moe_gateup_int8,
        "moe_down_combine_int8": moe_dispatch.moe_down_combine_int8,
        "int8_matmul": quant_matmul.int8_matmul,
    }
    paths = {"serving": ("paged_decode", "paged_prefill", "rmsnorm"),
             "training": ("rmsnorm", "flash_fwd", "flash_bwd_dkdv",
                          "flash_bwd_dq"),
             "moe_serving": ("moe_gateup", "moe_down_combine",
                             "paged_decode", "paged_prefill", "rmsnorm"),
             "moe_training": ("moe_gateup", "moe_down_combine",
                              "grouped_matmul", "grouped_weight_grad",
                              "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                              "rmsnorm"),
             "moe_serving_int8": ("moe_gateup_int8", "moe_down_combine_int8",
                                  "paged_decode_int8", "paged_prefill_int8",
                                  "rmsnorm", "int8_matmul",
                                  "int8_matmul_wide"),
             "int8_prefill": ("int8_matmul_wide", "int8_matmul_wide_prologue"),
             "gateway": ("paged_decode", "paged_prefill", "rmsnorm"),
             "speculative": ("paged_decode", "paged_prefill", "rmsnorm"),
             "telemetry": ("paged_decode", "paged_prefill", "rmsnorm"),
             "speculative_int8": ("paged_decode_int8", "paged_prefill_int8",
                                  "moe_gateup_int8", "moe_down_combine_int8",
                                  "int8_matmul", "rmsnorm"),
             "remat_dense": ("rmsnorm", "flash_fwd", "flash_bwd_dkdv",
                             "flash_bwd_dq"),
             "remat_moe": ("moe_gateup", "moe_down_combine",
                           "grouped_matmul", "grouped_weight_grad",
                           "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                           "rmsnorm"),
             "checkpoint": ("rmsnorm", "flash_fwd", "flash_bwd_dkdv",
                            "flash_bwd_dq"),
             "doctor": ("paged_decode", "paged_prefill", "rmsnorm")}
    by_path = {}

    def reset_counts():
        write_launches([0] * len(LAUNCH_COUNTERS))

    def read_counts() -> dict:
        counts = {name: w.launches for name, w in wrappers.items()}
        counts["int8_matmul_wide"] = quant_matmul.int8_matmul.wide_launches
        counts["int8_matmul_wide_prologue"] = \
            quant_matmul.int8_matmul.wide_prologue_launches
        return counts

    def drive(path, fn, *args):
        reset_counts()
        out = fn(*args)
        by_path[path] = read_counts()
        missing = [name for name in paths[path] if by_path[path][name] <= 0]
        if missing:
            raise AssertionError(f"the {path} path never launched {missing}")
        return out

    kept = {}      # each engine path's captured streams (phase 20 reads)

    def serve_twice(path, label, params, cfg, quantize_cache=False):
        """The engine's run (the main path, steps captured), then the same
        traffic through a ``capture=False`` engine, outside the counted
        run, held equal to it (``same_engines``). Logs both engines'
        metrics on one line."""
        captured = drive(path, serve, torch, params, cfg, dev,
                         quantize_cache)
        gc.collect()                  # the captured engine's graphs
        torch.cuda.empty_cache()
        reset_counts()
        eager = serve(torch, params, cfg, dev, quantize_cache,
                      capture=False)
        flips = same_engines(torch, label, captured, eager, by_path[path],
                             read_counts(), params, cfg, dev, quantize_cache)
        gc.collect()
        torch.cuda.empty_cache()
        kept[path] = dict(streams=captured["_streams"],
                          prompt_lens=captured["_prompt_lens"])
        for m in (captured, eager):
            for key in [k for k in m if k.startswith("_")]:
                del m[key]
        captured["stream_flips"] = flips
        captured["eager"] = {k: eager[k] for k in (
            "wall_s", "tokens_per_s", "decode_step_p50_ms", "ttft_p50_ms",
            "ttft_p99_ms", "peak_mem_gb", "peak_reserved_gb",
            "compile_counts", "capture_s")}
        log(f"{label}:", json.dumps(captured))
        return captured

    engine = serve_twice("serving", "engine", params, cfg)
    # The dense decode step's profile (K2's share: its split kernel and the
    # merge) and one packed prefill launch's, outside the counted run.
    profile = profile_decode(torch, params, cfg, dev)
    engine["decode_profile"] = profile
    engine["prefill_profile"] = profile_prefill(torch, params, cfg, dev)
    k2_ms = (profile["group_ms"]["paged_decode"]
             + profile["group_ms"]["paged_decode_merge"])
    log(f"dense decode step: {profile['device_ms']:.3f} ms of device time, "
        f"{profile['step_ms']:.3f} ms on the host clock; K2 {k2_ms:.3f} ms "
        f"({k2_ms / profile['device_ms']:.1%}); captured: "
        f"{profile['captured_step_ms']:.3f} ms on the host clock, "
        f"{profile['captured_device_ms']:.3f} ms of device time (ratio "
        f"{profile['captured_device_over_step']:.3f}); a 4 x 128 prefill "
        f"launch {engine['prefill_profile']['device_ms']:.3f} ms of device "
        f"time, K3 "
        f"{engine['prefill_profile']['group_ms']['paged_prefill']:.3f} ms")
    phase_done("phase 4: engine served 8 requests through every kernel, "
               "steps captured, and as many again eagerly with equal "
               "results; decode step and prefill launch profiled")

    del params
    torch.cuda.empty_cache()
    grads = compare_train(
        torch, dev, dataclasses.replace(PRESETS["8b-L8"], n_layers=2), 2,
        {name: wrappers[name] for name in paths["training"]}, SEED + 3)
    phase_done("phase 5: 8b-L8 loss and gradients through the kernels match "
               "the plain path")
    torch.cuda.empty_cache()
    trained = drive("training", train, torch, dev, PRESETS["8b-L8"], "8b-L8",
                    TRAIN_BATCH)
    counts = by_path["training"]
    layers = PRESETS["8b-L8"].n_layers
    steps = 1 + TRAIN_STEPS + 1    # warm-up, timed, profiled
    # Remat "full" re-runs each layer's forward in the backward: K4 runs
    # twice per layer and step, K5 and K6 once.
    want = {"flash_fwd": 2 * layers * steps,
            "flash_bwd_dkdv": layers * steps, "flash_bwd_dq": layers * steps}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"training launches {counts}, expected {want}")
    phase_done(f"phase 6: trained 8b-L8 for {steps} steps through every "
               f"kernel (launches {counts})")

    torch.cuda.empty_cache()
    mcfg = dataclasses.replace(MOE_PRESETS["8x7b"], n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    mparams = moe.init_params(mcfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"8x7b-L{MOE_LAYERS} params ({mcfg.num_params() / 1e9:.2f}B, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB) initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    kernels.update(check_moe_kernels(torch, mparams, mcfg, dev))
    phase_done("phase 7: K7 and K8 agree with their plain versions at the "
               "decode and prefill shapes")
    before = (moe_dispatch.moe_gateup.launches,
              moe_dispatch.moe_down_combine.launches)
    moe_forward = compare_forward(torch, mparams, mcfg, dev)
    ran = (moe_dispatch.moe_gateup.launches - before[0],
           moe_dispatch.moe_down_combine.launches - before[1])
    # A prefill chunk and 4 decode steps through the kernels, once each
    # per layer; the plain forwards launch nothing.
    if ran != (5 * MOE_LAYERS, 5 * MOE_LAYERS):
        raise AssertionError(f"phase 8 launched K7/K8 {ran} times, "
                             f"expected {5 * MOE_LAYERS} each")
    phase_done(f"phase 8: 8x7b-L{MOE_LAYERS} forward through kernels matches "
               f"the plain forward")
    moe_engine = serve_twice("moe_serving", "moe engine", mparams, mcfg)
    counts = by_path["moe_serving"]
    forwards = moe_engine["decode_steps"] + moe_engine["prefill_launches"]
    want = {"moe_gateup": MOE_LAYERS * forwards,
            "moe_down_combine": MOE_LAYERS * forwards}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"MoE serving launches {counts}, expected "
                             f"{want} ({forwards} forwards)")
    if moe_engine["moe_impl"] != {"decode_step": "dropless",
                                  "prefill_chunk": "dropless"} \
            or moe_engine["dispatch"] != "fused":
        raise AssertionError(f"MoE impl {moe_engine['moe_impl']}, dispatch "
                             f"{moe_engine['dispatch']}")
    phase_done(f"phase 9: engine served 8 requests on 8x7b-L{MOE_LAYERS} "
               f"through every kernel, steps captured, and eagerly with "
               f"equal results (launches {counts})")
    moe_engine["decode_profile"] = profile_decode(torch, mparams, mcfg, dev)
    del mparams
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(MOE_PRESETS["8x7b-L1"], moe_impl="dropless")
    kernels.update(check_grouped_kernels(torch, tcfg, dev))
    phase_done("phase 10: gmm and tgmm agree with their plain versions at the "
               "MoE backward's five calls, on unaligned groups and through "
               "both autograd Functions; K7 and K8 at the training shape")
    torch.cuda.empty_cache()
    moe_grads = compare_train(
        torch, dev, tcfg, MOE_COMPARE_BATCH,
        {name: wrappers[name] for name in ("moe_gateup", "moe_down_combine",
                                           "grouped_matmul",
                                           "grouped_weight_grad")},
        SEED + 5)
    phase_done("phase 11: 8x7b-L1 loss and gradients through the kernels "
               "match the plain path with routing replayed")
    torch.cuda.empty_cache()
    moe_trained = drive("moe_training", train, torch, dev, tcfg, "8x7b-L1",
                        MOE_TRAIN_BATCH)
    counts = by_path["moe_training"]
    layers = tcfg.n_layers
    # Remat "full": K7, K8 and K4 run twice per layer (forward and the
    # recompute), the backward 3 gmm, 2 tgmm, K5 and K6 once; RMSNorm twice
    # per norm of a layer plus the final norm.
    want = {"moe_gateup": 2 * layers * steps,
            "moe_down_combine": 2 * layers * steps,
            "grouped_matmul": 3 * layers * steps,
            "grouped_weight_grad": 2 * layers * steps,
            "flash_fwd": 2 * layers * steps,
            "flash_bwd_dkdv": layers * steps, "flash_bwd_dq": layers * steps,
            "rmsnorm": (4 * layers + 1) * steps}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"MoE training launches {counts}, expected "
                             f"{want}")
    blocks = {f"dropless:fused:t{MOE_TRAIN_BATCH * TRAIN_SEQ}"}
    if moe_trained["dispatch"] != "fused" \
            or set(moe_trained["moe_blocks"]) != blocks:
        raise AssertionError(f"MoE training dispatch "
                             f"{moe_trained['dispatch']}, blocks "
                             f"{moe_trained['moe_blocks']}; want fused "
                             f"{blocks}")
    phase_done(f"phase 12: trained 8x7b-L1 (dropless) for {steps} steps "
               f"through every kernel (launches {counts})")
    torch.cuda.empty_cache()

    # Phases 13-15: Mixtral-8x7B at its full 32 layers, int8 weights
    # (quantize_params) and the int8 KV cache.
    qcfg = MOE_PRESETS["8x7b"]
    t0 = time.perf_counter()
    qparams = int8_moe_params(torch, qcfg, dev)
    torch.cuda.synchronize()
    pool_rows = NUM_BLOCKS * BLOCK_SIZE + 1
    pool_bytes = (qcfg.n_layers * qcfg.n_kv_heads * pool_rows
                  * (2 * qcfg.head_dim + 8))
    int8_sizes = dict(weights_gb=nbytes(qparams) / 1e9,
                      engine_pool_gb=pool_bytes / 1e9,
                      layers=qcfg.n_layers)
    log(f"8x7b int8 params ({qcfg.num_params() / 1e9:.2f}B parameters, "
        f"{int8_sizes['weights_gb']:.2f} GB of int8 weights and scales; the "
        f"engine's int8 KV pool {int8_sizes['engine_pool_gb']:.3f} GB) built "
        f"in {time.perf_counter() - t0:.1f}s")
    kernels.update(check_paged(torch, qcfg, dev, quantized=True))
    kernels.update(check_moe_kernels(torch, qparams, qcfg, dev))
    # The int8 K8 splits its contracted axis only where its blocks leave
    # SMs idle: 8x160m's narrow widths (H 768), not 8x7b's.
    scfg = dataclasses.replace(MOE_PRESETS["8x160m"], n_layers=1)
    narrow = check_moe_kernels(torch, int8_moe_params(torch, scfg, dev),
                               scfg, dev, tag=" (8x160m)")
    splits = [narrow["moe_down_combine_int8"]["plan"]["split"],
              narrow["moe_down_combine_int8"]["prefill"]["plan"]["split"]]
    if min(splits) < 2:
        raise AssertionError(f"the int8 K8 at 8x160m's decode and prefill "
                             f"shapes split {splits} ways; want >= 2")
    for kname, row in narrow.items():
        kernels[kname]["8x160m"] = row
    phase_done("phase 13: the int8 branches of K2, K3, K7 and K8 agree with "
               "their plain versions (K8 split at 8x160m's widths)")
    counted = ("moe_gateup", "moe_down_combine", "moe_gateup_int8",
               "moe_down_combine_int8", "int8_matmul")
    before = [wrappers[n].launches for n in counted]
    int8_forward = compare_forward(torch, qparams, qcfg, dev,
                                   quantize_cache=True)
    ran = [wrappers[n].launches - b_ for n, b_ in zip(counted, before)]
    # A prefill chunk and 4 decode steps, once each per layer, through the
    # int8 branches only (the seams: wqkv and wo per layer, the LM head);
    # the plain forwards launch nothing.
    want = [0, 0, 5 * qcfg.n_layers, 5 * qcfg.n_layers,
            5 * (2 * qcfg.n_layers + 1)]
    if ran != want:
        raise AssertionError(f"phase 14 launched {dict(zip(counted, ran))}, "
                             f"expected {dict(zip(counted, want))}")
    int8_forward.update(int8_sizes)
    phase_done("phase 14: full-depth 8x7b int8+kvq forward through kernels "
               "matches the plain forward")
    int8_engine = serve_twice("moe_serving_int8", "int8 moe engine",
                              qparams, qcfg, True)
    counts = by_path["moe_serving_int8"]
    forwards = int8_engine["decode_steps"] + int8_engine["prefill_launches"]
    layers = qcfg.n_layers
    want = {"moe_gateup_int8": layers * forwards,
            "moe_down_combine_int8": layers * forwards,
            "paged_decode_int8": layers * int8_engine["decode_steps"],
            "paged_prefill_int8": layers * int8_engine["prefill_launches"],
            # The seams: wqkv and wo per layer, the LM head once.
            "int8_matmul": (2 * layers + 1) * forwards,
            "moe_gateup": 0, "moe_down_combine": 0, "paged_decode": 0,
            "paged_prefill": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"int8 MoE serving launches {counts}, expected "
                             f"{want} ({forwards} forwards)")
    if int8_engine["moe_impl"] != {"decode_step": "dropless",
                                   "prefill_chunk": "dropless"} \
            or int8_engine["dispatch"] != "fused":
        raise AssertionError(f"int8 MoE impl {int8_engine['moe_impl']}, "
                             f"dispatch {int8_engine['dispatch']}")
    profile = profile_decode(torch, qparams, qcfg, dev, quantize_cache=True)
    int8_engine["decode_profile"] = profile
    # The seams stream their weights as int8: the only int8 -> float copy a
    # decode step may make is the embedding's gathered rows.
    copies = profile["int8_to_float_copies"]
    if len(copies) != 1 or max(copies) > BATCH_SLOTS * qcfg.hidden:
        raise AssertionError(f"decode step int8 -> float copies {copies}; "
                             f"expected only the embedding rows "
                             f"({BATCH_SLOTS * qcfg.hidden})")
    log(f"int8 decode step: {profile['device_ms']:.2f} ms of device time "
        f"(41.87 ms before the int8 seams' kernel: NVIDIA H100 80GB HBM3, "
        f"700.00 W), int8_matmul "
        f"{profile['group_ms']['int8_matmul']:.2f} ms, int8 -> float "
        f"copies {copies}")
    phase_done(f"phase 15: engine served 8 requests on full-depth 8x7b "
               f"int8+kvq through the int8 kernels, steps captured, and "
               f"eagerly with equal results (launches {counts})")
    kernels.update(check_int8_matmul(torch, dev))
    phase_done("phase 16: int8_matmul agrees with its plain version at the "
               "seams' and the expert product's shapes")
    int8_prefill = drive("int8_prefill", einsum_prefill, torch, qparams,
                         qcfg, dev)
    int8_prefill["prefill_profile"] = profile_einsum_prefill(
        torch, qparams, qcfg, dev)
    phase_done(f"phase 17: a {EINSUM_PROMPT}-token int8 prefill through the "
               f"einsum MoE body matches the plain forward; profiled")
    del qparams
    torch.cuda.empty_cache()

    fleet = build_fleet(torch, cfg, dev)
    log(f"gateway fleet: two {cfg.n_layers}-layer 8B replicas built and "
        f"warmed in {fleet['build_s']:.1f}s (captures "
        f"{json.dumps(fleet['capture_s'])} s)")
    run = drive("gateway", serve_fleet, torch, cfg, fleet)
    gateway = fleet_metrics(torch, cfg, fleet, run, by_path["gateway"])
    streams = [r.tokens for r in run["reqs"]]
    params = fleet["params"]["r0"]
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    solo = solo_streams(torch, params, cfg, dev, run["traffic"])
    flips = stream_flips(torch, streams, solo,
                         [len(p) for p, _ in run["traffic"]],
                         ("gateway", "solo"), params, cfg, dev)
    log(f"gateway vs solo engine stream flips {json.dumps(flips)}")
    bad = [f for f in flips if f["logit_margin"] >= FLIP_MARGIN_LIMIT]
    if bad:
        raise AssertionError(f"gateway streams differ from the solo "
                             f"engine's beyond a near-tie (logit margin "
                             f"limit {FLIP_MARGIN_LIMIT}): {bad}")
    gateway["stream_flips"] = flips
    del run        # r0's weights stay: phases 19 and 20 serve them
    gc.collect()
    torch.cuda.empty_cache()
    ttft = " ".join(f"{lc} {v['p50']:.1f}/{v['p99']:.1f}"
                    for lc, v in gateway["ttft_ms"].items())
    log(f"gateway: {gateway['tokens_per_s']:.1f} tokens/s over "
        f"{gateway['requests']} requests ({gateway['wall_s']:.3f} s), decode "
        f"p50 {gateway['decode_p50_ms']:.3f} ms, TTFT p50/p99 ms {ttft}; "
        f"routed {gateway['routed']}, rerouted {gateway['rerouted']}, shed "
        f"{gateway['shed']}, affinity hit rate "
        f"{gateway['affinity_hit_rate']:.4f}; host ms a tick: gateway "
        f"{gateway['gateway_host_ms_per_tick']:.3f} (of {gateway['gateway_ticks']} "
        f"ticks), engines {gateway['engine_host_ms_per_tick']:.3f}; peak "
        f"memory {gateway['peak_mem_gb']:.2f} GB allocated, "
        f"{gateway['peak_reserved_gb']:.2f} GB reserved")
    log(f"gateway: {json.dumps(gateway)}")
    phase_done(f"phase 18: the gateway served {gateway['requests']} requests "
               f"over two 8B replicas with a drain and no loss; streams equal "
               f"a solo engine's but {len(flips)} near-tie(s) (launches "
               f"{by_path['gateway']})")

    # Phase 19: speculative decoding, phase 18's r0 weights as the 8B
    # target and a 1b draft from the seed.
    dcfg = PRESETS["1b"]
    dparams = init_params(dcfg, seed=SEED + 103, device=dev)
    kernels.update(check_spec_kernels(torch, cfg, dcfg, dev, False))
    spec = speculative_phase(torch, "8b/1b", params, dparams, cfg, dcfg, dev,
                             False, drive, by_path.get, "speculative")
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    phase_done(f"phase 19: speculative decoding on the 8B target with a 1b "
               f"draft and with itself, streams equal the target alone's "
               f"but near-ties, captured equal to eager (launches "
               f"{by_path['speculative']})")

    # Phase 20: compute telemetry on a phase-4-shaped engine (the same
    # weights as phase 4's).
    telemetry = drive("telemetry", compute_telemetry, torch, params, cfg,
                      dev, kept["serving"])
    counts = by_path["telemetry"]
    forwards = telemetry["decode_steps"] + telemetry["prefill_launches"]
    want = {"paged_decode": cfg.n_layers * telemetry["decode_steps"],
            "paged_prefill": cfg.n_layers * telemetry["prefill_launches"],
            "rmsnorm": (2 * cfg.n_layers + 1) * forwards}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"telemetry launches {counts}, expected {want}")
    gauges = " ".join(
        f"{key} {g['boundBy']} membw {g['membwFraction']:.4f} mfu "
        f"{g['mfu']:.5f}" for key, g in telemetry["gauges"].items())
    log(f"compute: {gauges}; {json.dumps(telemetry)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase_done(f"phase 20: compute telemetry on an 8B engine: builds equal "
               f"compile_counts, no recompile after warm-up, HBM ledger "
               f"equal to the tensors' bytes (launches {counts})")

    # Phase 21: speculative decoding on the int8 8x7b target (rebuilt) with
    # a 160m draft, both on the int8 KV cache.
    t0 = time.perf_counter()
    qparams = int8_moe_params(torch, qcfg, dev)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    log(f"8x7b int8 params rebuilt in {rebuild_s:.1f}s")
    d8cfg = PRESETS["160m"]
    d8params = init_params(d8cfg, seed=SEED + 104, device=dev)
    kernels.update(check_spec_kernels(torch, qcfg, d8cfg, dev, True))
    spec_int8 = speculative_phase(torch, "8x7b-int8/160m", qparams, d8params,
                                  qcfg, d8cfg, dev, True, drive, by_path.get,
                                  "speculative_int8")
    spec_int8["rebuild_s"] = rebuild_s
    del qparams, d8params
    gc.collect()
    torch.cuda.empty_cache()
    phase_done(f"phase 21: speculative decoding on the int8 8x7b target with "
               f"a 160m draft and with itself, streams equal the target "
               f"alone's but near-ties, captured equal to eager, no int8 -> "
               f"float weight copy (launches {by_path['speculative_int8']})")

    # Phases 22-24: the rest of training. The named remat policies on the
    # dense and the MoE trainer (binned among the MoE formulations), then
    # a checkpoint and resume.
    remat = drive("remat_dense", remat_dense, torch, dev, PRESETS["8b-L8"],
                  "8b-L8", TRAIN_BATCH, wrappers)
    phase_done(f"phase 22: trained 8b-L8 under the remat policies "
               f"{list(remat)}, each policy's first step held to full's "
               f"(launches {by_path['remat_dense']})")
    moe_remat = drive("remat_moe", remat_moe, torch, dev, tcfg,
                      MOE_TRAIN_BATCH, wrappers)
    phase_done(f"phase 23: trained 8x7b-L1 as {list(moe_remat)}, binned "
               f"held to einsum with equal routing (launches "
               f"{by_path['remat_moe']})")
    ckpt_cfg = dataclasses.replace(PRESETS["8b-L8"], n_layers=CKPT_LAYERS)
    ckpt = drive("checkpoint", checkpoint_resume, torch, dev, ckpt_cfg,
                 TRAIN_BATCH)
    counts = by_path["checkpoint"]
    # Steps before the save, after it, and after the restore.
    want = {name: n * 3 * CKPT_STEPS for name, n in
            remat_launches(ckpt_cfg, "dense", "full").items()}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"checkpoint launches {counts}, expected "
                             f"{want}")
    phase_done(f"phase 24: saved and restored a {ckpt['file_gb']:.2f} GB "
               f"train state (save {ckpt['save_s']:.2f} s, restore "
               f"{ckpt['restore_s']:.2f} s); the resumed run is bitwise "
               f"equal (launches {counts})")
    # Phases 25-29: the node plugin's device layer prepares the card for
    # claims whose workers (processes of this script, started with each
    # claim's CDI edits) serve phase 4's traffic; in phase 29 the
    # scheduler side allocates the claim.
    gc.collect()
    torch.cuda.empty_cache()
    dra = device_layer(torch, kept["serving"]["streams"],
                       {k: by_path["serving"][k] for k in paths["serving"]},
                       phase_done)
    # Phase 30: the kubelet-facing node plugin on the card, its tenants'
    # workers serving phase 4's traffic.
    gc.collect()
    torch.cuda.empty_cache()
    plugin = plugin_phase(torch, kept["serving"]["streams"],
                          {k: by_path["serving"][k]
                           for k in paths["serving"]},
                          dra["scheduler"]["slices"], phase_done)
    # Phase 31: the fleet doctor against the card's live node, its engine
    # on phase 4's weights from the seed.
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=SEED, device=dev)
    diag = drive("doctor", doctor_phase, torch, params, cfg, dev,
                 kept["serving"])
    served = diag["serving"]
    counts = by_path["doctor"]
    forwards = served["decode_steps"] + served["prefill_launches"]
    want = {"paged_decode": cfg.n_layers * served["decode_steps"],
            "paged_prefill": cfg.n_layers * served["prefill_launches"],
            "rmsnorm": (2 * cfg.n_layers + 1) * forwards}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"doctor launches {counts}, expected {want}")
    flips = stream_flips(torch, served.pop("streams"),
                         kept["serving"]["streams"],
                         kept["serving"]["prompt_lens"],
                         ("doctor", "phase 4"), params, cfg, dev)
    bad = [f for f in flips if f["logit_margin"] >= FLIP_MARGIN_LIMIT]
    if bad:
        raise AssertionError(f"streams through the doctor's node differ "
                             f"from phase 4's beyond a near-tie: {bad}")
    diag["stream_flips"] = flips
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("doctor: " + json.dumps({
        "card": card,
        "clean_ms": diag["clean"]["ms"], "drift_ms": diag["drift"]["ms"],
        "explain_ms": diag["explain"]["ms"],
        "mfu_ms": [diag["mfu"]["ok_ms"], diag["mfu"]["over_ms"]],
        "findings": {"clean": diag["clean"]["findings"],
                     "drift": diag["drift"]["findings"],
                     "explain": diag["explain"]["findings"],
                     "mfu_measured": diag["mfu"]["findings_ok"],
                     "mfu_3x": diag["mfu"]["findings_over"]},
        "decode_mfu": [diag["clean"]["mfu"], diag["mfu"]["measured"]],
        "bundle_members": diag["bundle_members"],
        "cli_rc": diag["cli"]["rc"], "cli_s": diag["cli"]["s"],
        "soak_s": diag["soak"]["s"], "soak_sha256": diag["soak"]["sha256"],
        "decode_p50_ms": served["decode_p50_ms"],
        "ttft_p50_ms": served["ttft_p50_ms"],
        "stream_flips": len(flips), "s": diag["s"]}))
    phase_done(f"phase 31: the doctor read the card's node clean, caught "
               f"the orphan and explained the unsatisfiable claim, flagged "
               f"mfu-regression only against the {DOCTOR_MFU_OVER:g}x "
               f"baseline; the CLI exited 0 and the fleet soak replayed "
               f"byte for byte (launches {counts})")
    # int8_matmul's launches, each in one row: the M <= 64 body's
    # (int8_matmul), the wgmma body's in the epilogue mode (the seams at
    # M > 64: int8_matmul_prefill) and in the prologue mode (the expert
    # products: int8_matmul_experts).
    # K7's and K8's launches in the MoE training path go to their training
    # rows (moe_gateup_train, moe_down_combine_train), the serving paths'
    # to their decode/prefill rows.
    by_path = {p: {**c, "int8_matmul": c["int8_matmul"]
                   - c["int8_matmul_wide"],
                   "int8_matmul_prefill": c["int8_matmul_wide"]
                   - c["int8_matmul_wide_prologue"],
                   "int8_matmul_experts": c["int8_matmul_wide_prologue"],
                   **{k + suffix: (c[k] if (p in ("moe_training",
                                                  "remat_moe"))
                                   == (suffix == "_train") else 0)
                      for k in ("moe_gateup", "moe_down_combine")
                      for suffix in ("", "_train")}}
               for p, c in by_path.items()}
    # The speculative loop's shapes, each in a row of its own: K2 at B 1
    # (every draft feed) and K3 at T = k+1 (every verify window).
    verify = {"speculative": (spec["draft"]["rounds"], cfg.n_layers, ""),
              "speculative_int8": (spec_int8["draft"]["rounds"],
                                   qcfg.n_layers, "_int8")}
    for p, c in by_path.items():
        for suffix in ("", "_int8"):
            rounds, layers, mine = verify.get(p, (0, 0, None))
            on = mine == suffix
            c[f"paged_decode{suffix}_b1"] = (
                c[f"paged_decode{suffix}"] if on else 0)
            c[f"paged_prefill{suffix}_verify"] = layers * rounds if on else 0
    launches = {name: sum(by_path[p][name] for p in by_path)
                for name in by_path["serving"]}

    meta = {
        "paged_decode": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                         "paged_attention.cu",
                         "k8s_dra_driver_tpu/ops/attention.py:618"),
        "paged_prefill": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                          "paged_attention.cu",
                          "k8s_dra_driver_tpu/ops/attention.py:772"),
        "rmsnorm": ("triton", "k8s_dra_driver_tpu_torch/ops/norms.py",
                    "k8s_dra_driver_tpu/ops/norms.py:26"),
        "flash_fwd": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                      "flash_attention.cu",
                      "k8s_dra_driver_tpu/ops/attention.py:58"),
        "flash_bwd_dkdv": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                           "flash_attention.cu",
                           "k8s_dra_driver_tpu/ops/attention.py:228"),
        "flash_bwd_dq": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                         "flash_attention.cu",
                         "k8s_dra_driver_tpu/ops/attention.py:314"),
        "moe_gateup": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                       "moe_dispatch.cu",
                       "k8s_dra_driver_tpu/ops/moe_dispatch.py:491"),
        "moe_down_combine": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                             "moe_dispatch.cu",
                             "k8s_dra_driver_tpu/ops/moe_dispatch.py:537"),
        "grouped_matmul": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                           "grouped_matmul.cu",
                           "k8s_dra_driver_tpu/ops/moe_dispatch.py:407"),
        "grouped_weight_grad": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                                "grouped_matmul.cu",
                                "k8s_dra_driver_tpu/ops/moe_dispatch.py:437"),
        "paged_decode_int8": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                              "paged_attention.cu",
                              "k8s_dra_driver_tpu/ops/attention.py:618 "
                              "(int8 branch)"),
        "paged_prefill_int8": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                               "paged_attention.cu",
                               "k8s_dra_driver_tpu/ops/attention.py:772 "
                               "(int8 branch)"),
        "moe_gateup_int8": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                            "moe_dispatch.cu",
                            "k8s_dra_driver_tpu/ops/moe_dispatch.py:491 "
                            "(int8 branch)"),
        "moe_down_combine_int8": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                                  "moe_dispatch.cu",
                                  "k8s_dra_driver_tpu/ops/moe_dispatch.py:537 "
                                  "(int8 branch)"),
        "int8_matmul": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                        "quant_matmul.cu",
                        "k8s_dra_driver_tpu/models/quant.py:92 (_mixed_dot, "
                        "XLA; no Pallas kernel)"),
        "int8_matmul_prefill": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                                "quant_matmul.cu",
                                "k8s_dra_driver_tpu/models/quant.py:92 "
                                "(_mixed_dot, XLA; no Pallas kernel)"),
        "int8_matmul_experts": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                                "quant_matmul.cu",
                                "k8s_dra_driver_tpu/models/quant.py:169 "
                                "(q_dequant, then XLA's einsum; no Pallas "
                                "kernel)"),
    }
    for name in ("moe_gateup", "moe_down_combine"):
        meta[name + "_train"] = meta[name]
    for suffix in ("", "_int8"):
        meta[f"paged_decode{suffix}_b1"] = meta[f"paged_decode{suffix}"]
        meta[f"paged_prefill{suffix}_verify"] = meta[f"paged_prefill{suffix}"]
    # K2 at the longest window: the same kernels and launch counts as its
    # row at the engine's shape.
    for name in ("paged_decode", "paged_decode_int8"):
        meta[name + "_long"] = meta[name]
        launches[name + "_long"] = launches[name]
        by_path = {p: {**c, name + "_long": c[name]}
                   for p, c in by_path.items()}
    rows = []
    for name, (route, source, replaces) in meta.items():
        k = dict(kernels[name])
        rows.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=k.pop("max_abs_err"),
            ms=k.pop("ms"), plain_ms=k.pop("plain_ms"),
            bound_ms=k.pop("bound_ms"), bound_by=k.pop("bound_by"),
            library_ms=k.pop("library_ms"),
            launches_by_path={p: by_path[p][name] for p in by_path},
            **k,
        ))
        # kernel_ms and max_err repeat ms and max_abs_err under a second
        # pair of names, both read by the port's records.
        rows[-1].update(kernel_ms=rows[-1]["ms"],
                        max_err=rows[-1]["max_abs_err"])
    for row in rows:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not math.isfinite(row[key]):
                raise AssertionError(f"{row['name']}: {key} not finite")
    log(card)
    log(json.dumps({"forward": forward, "engine": engine, "grads": grads,
                    "train": trained, "moe_forward": moe_forward,
                    "moe_engine": moe_engine, "moe_grads": moe_grads,
                    "moe_train": moe_trained, "int8_forward": int8_forward,
                    "int8_engine": int8_engine,
                    "int8_einsum_prefill": int8_prefill,
                    "gateway": gateway, "speculative": spec,
                    "compute": telemetry, "speculative_int8": spec_int8,
                    "remat": remat, "moe_remat": moe_remat,
                    "checkpoint": ckpt, "device_layer": dra,
                    "plugin": plugin, "doctor": diag}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dra-worker"]:
        sys.exit(dra_worker(sys.argv[2]))
    sys.exit(main())
