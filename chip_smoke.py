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
   ``nvcc`` per source, all started together);
2. holds each kernel against its plain PyTorch version on the same inputs
   at its path's shapes (paged attention at the engine's, RMSNorm at
   every row count the paths launch and its gradient at the train steps',
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
    its plain version at the seams' shapes (M 1, 5, 8, 16, 64 and 512, K
    4096 to N 6144, 4096, 32000) and at the einsum MoE body's expert
    product ([8, 512, 4096] against [8, 4096, 28672]), and times it beside
    a bf16 ``torch.matmul`` on a converted weight: M <= 64 runs its
    swapped form, M 512 and the experts its wgmma body;
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
32. rebuilds phase 8's 8x7b-L16 from the seed and serves it expert
    parallel on a single-controller mesh of 4 ``expert`` shards, all on
    the card (``build_mesh(MeshConfig(expert=4), devices=[card] * 4)``,
    the expert stacks placed by ``shard_pytree(params, mesh,
    param_specs(cfg))`` as views, no new memory; 2 experts a shard).
    Holds K9's twin (``csrc/ring_permute.cu``, the ring hop) bit for bit
    against its plain version for rings of 2 and 4, shifts 1, -1 and 3,
    bf16, f32 and int8, at a size of no whole 16-byte word with a nonzero
    storage offset and at the hop chunk, and as grouped launches (several
    rings, mixed dtypes, empty pairs, one launch); its gradient as the
    inverse rotation, of one ring and of a group; times it at the hop
    buffers ([128, 4096] bf16 chunk and f32 carrier), at 256 MB a shard,
    and as the hop's grouped launch at the prefill and the decode shapes,
    by CUDA events and inside a CUDA graph, beside the plain version and
    ``torch._foreach_copy_`` (``ring_permute:`` lines). Runs the dropless
    EP forward at 4 x 128 tokens (the ring) and at 13 (the psum path under
    ``"auto"``; ``"ring"`` must raise) against the single-device forward
    on the same weights (phase 8's limits, the single run's routing
    replayed; K7 and K8 launched n_ep**2 L times on the ring and n_ep L
    on psum, K9 n_ep L times on the ring -- one grouped launch a hop, the
    shards sharing the card -- and never on psum). Then serves phase 9's
    traffic through ``DecodeEngine(mesh=mesh)`` with
    ``moe_impl="dropless"``, its steps captured with K9 inside, holds its
    launches (K7 and K8 n_ep**2 L, K9 n_ep L a forward), prints how many
    streams equal phase 9's single-device engine's (the first divergence
    where one exists) and its TTFT and decode p50 beside phase 9's. (K9's
    share of a profiled EP decode step is ``tools/ring_permute_bench.py``'s.)
33. trains phase 12's 8x7b-L1 (dropless, its seeded weights and batch of
    4 x 2048 tokens) expert parallel on the same mesh shape: one
    ``loss_fn(..., mesh=mesh)`` value and every gradient leaf against the
    single-device ones with the single run's routing replayed (losses
    1e-2, leaves 5e-2; the backward through the grouped inverse rotation
    and each shard's ``FusedMoeMlpFunction``), then ``make_train_step(...,
    mesh=mesh)`` for phase 12's 7 steps, its launches held a step (K9
    3 n_ep L: forward, recompute, backward), and prints step p50,
    tokens/s, peak memory and K9's launches beside phase 12's (``EP
    train:`` line).
34. rebuilds phase 4's 8B from the seed and serves it Megatron-style on a
    single-controller mesh of ``MeshConfig(data=2, tensor=4)`` over 8
    shards of the card (weights placed by ``shard_pytree(params, mesh,
    llama.param_specs(cfg))`` as views, no new memory): a prefill and 4
    decode steps' logits within 5e-2 relative of the single device's,
    then phase 4's traffic through ``DecodeEngine(mesh=mesh)``, steps
    captured, and again eagerly, held equal as phase 4's are; the streams
    equal phase 4's but near-ties (FLIP_MARGIN_LIMIT); launches held: K2
    and K3 once per (data, tensor) shard a layer, K1 at both norms of a
    layer and the final norm once per data group; then the mesh decode
    step profiled and captured (``megatron serving:`` line: decode p50,
    TTFT p50 and the captured step's device ms beside phase 4's).
35. rebuilds phase 15's int8 8x7b (32 layers, int8 KV cache) and serves
    it on ``MeshConfig(tensor=4)``: dropless takes the primitive path per
    tensor shard, its expert products through ``grouped_matmul_int8``
    (``csrc/grouped_matmul_int8.cu``, A7b) on each shard's M block of
    every expert (the gate/up block a strided view, no copy); first the
    kernel against its plain version at the decode (8 tokens) and prefill
    (4 x 128) shapes on layer 0's shard-0 blocks, gate/up and down, and
    on ragged groups with rows past the last (exactly 0), timed by CUDA
    events and inside a CUDA graph beside its bound, the plain version
    and ``torch._grouped_mm`` on a bf16 copy of the weight, each row
    naming its body (``int8_gmm_plan``: the swapped form at decode, the
    wgmma image body at prefill); then phase
    15's traffic, the streams equal phase 15's but near-ties
    (FLIP_MARGIN_LIMIT_KVQ), launches held (the kernel 2 a tensor shard
    a layer a forward, ``int8_matmul`` 2L + 1 a shard a forward, K2-int8
    and K3-int8 a shard a layer, K7/K8 never), no int8 -> float copy of
    a weight in a decode step, the peak memory above the weights
    (``megatron int8 moe:`` line).
36. trains phase 6's 8b-L8 at 8 x 2048, remat "full", on
    ``MeshConfig(data=2, fsdp=2, tensor=2)`` over 8 shards of the card:
    one loss and every gradient leaf against the single device's on the
    same state and tokens (loss 1e-2, leaves 5e-2), then 3 steps of
    ``make_train_step(..., mesh=mesh)``, launches held (K4 2L, K5 and K6
    L per (group, tensor shard) a step; K1 (4L + 1) and its gradient
    (2L + 1) per group), step p50, tokens/s, MFU and peak memory beside
    phase 6's (``megatron train:`` line).
37. the sequence axis: K4, K5 and K6 not causal at a ring hop's shape
    (q [2, 16, 2048, 128], k/v [2, 4, 2048, 128]) against their plain
    versions (rows ``flash_*_hop``, SDPA beside them) and K9 at the ring's
    backward hop (32 pairs in one launch, ``ring_permute_ring_hop``);
    ``ring_attention`` and ``ulysses_attention`` at q [2, 32, 8192, 128]
    on ``MeshConfig(sequence=4, tensor=2)`` against one
    ``flash_attention`` (bf16 gates; dq/dk/dv 5e-2); 8b-L8 at 2 x 8192
    with ``use_ring``: one loss and every gradient leaf against the single
    device's, then 3 timed ``make_train_step(mesh=, use_ring=True)``
    steps beside the single device's at the same batch, launches held to
    ``sequence_train_launches`` (``sequence train:`` line).
38. the pipe axis: K9 at a stage hop (``ring_permute_pipe_hop``); 8b-L8
    at 8 x 2048 through ``forward_pipelined`` on ``MeshConfig(pipe=2,
    data=2, tensor=2)``, 4 microbatches, each stage's layers under remat
    "full": one loss and every gradient leaf against the single device's,
    then 3 timed forward + backward steps beside the single device's,
    launches held to ``pipe_train_launches``, the bubble share printed
    (``pipeline train:`` line); Mixtral-8x7B widths cut to 2 layers
    (einsum) on ``MeshConfig(data=2, expert=2, pipe=2)`` at 4 x 512, 2
    microbatches: one forward and backward (every gradient finite,
    ``w_gateup``'s nonzero), the logits against the single device's
    forward replaying the pipeline's routing, the aux against the single
    device's forwards of the same row blocks (``pipeline moe:`` line).
39. elastic training (``parallel/elastic.py``). First an uninterrupted
    ``ElasticTrainer`` run of 8b-L8 at 8 x 2048 on ``MeshConfig(tensor=2)``
    over two members of the card, 7 steps (one batch from the seed each),
    outside the counted run, then freed. Then the port's ``Driver`` over a
    ``FakeChipLib`` v5p 4x1x1 node (one card cannot make a 4-chip gang),
    elastic resizes armed: the ``ReferenceAllocator`` places a 4-device
    gang claim, prepared through the transport, and an ``ElasticTrainer``
    from the same init (held bitwise) runs on ``MeshConfig(data=2,
    tensor=2)`` over the gang's members ``tpu-0`` .. ``tpu-3``, every one
    on the card. A seeded ``train.step`` fault unplugs one chip at the top
    of step 4; the driver shrinks the claim (republished, re-solved once
    the slice shows it) and the trainer resizes onto the message's
    members: live, 2 used, 1 idled, tensor 2 kept; steps 4-6, every loss
    within 1e-2 of the uninterrupted run's. The chip returns, the claim
    grows, the trainer resizes live onto 4 members with every leaf in
    place and bitwise unchanged, and steps twice. The auditor reads clean
    after each resize, a ``GangResized`` Event lands, the driver counts
    one shrink and one grow; every step's K1, K1-gradient and K4-K6
    launches equal ``megatron_train_launches`` for its mesh. Then the cold
    path at phase 24's depth: 8b-L8 cut to 2 layers on ``MeshConfig(
    fsdp=4)``, 2 steps, a save, a step past it, a resize onto 2 members
    (no replica covers the state): cold, back at step 2 on fsdp 2, and
    the lost step's batch within 1e-2 of its loss. Last,
    ``initialize_distributed()`` under a time-shared envelope applies it
    and forms no process group. Prints each resize's seconds, the step
    p50 before and after the shrink, the ``train.reshard`` ledger bytes,
    the peak memory and the members' devices (``elastic:`` line).
40. the expert axis beside tensor, serving: phase 15's int8 8x7b at 32
    layers on ``MeshConfig(expert=2, tensor=2)``, placed by
    ``quantize_specs(param_specs)`` (views, no new memory). One prefill of
    8 x 96 tokens and 4 decode steps with ``moe_impl="einsum"`` (what
    ``auto`` resolves to there: each expert shard's experts per tensor
    shard, ``int8_matmul``'s experts mode on the strided halves) and
    again with ``"dropless"`` (the EP ring, A7b per (expert shard, tensor
    shard)), each against the single device's with routing replayed:
    logits within TP_LOGITS_REL, flips near-ties under
    TP_FLIP_SHARE_LIMIT. Then phase 15's traffic through the captured
    ``DecodeEngine(mesh=)`` (einsum), its launches held to
    ``ep_tp_serving_launches``, and its captured decode step profiled
    (the embedding's rows the only int8 -> float copies); decode p50,
    TTFT, device ms and peak memory beside phases 15 and 35. Last,
    ``int8_matmul``'s experts mode on the strided blocks the einsum body
    hands it (each gate/up half and the down block of one expert x tensor
    shard, at the prefill's 240 rows and a decode step's 8) against its
    plain version on contiguous copies at phase 16's limits, timed (row
    ``int8_matmul_experts_blocks``).
41. the expert axis beside tensor, training: 8x7b-L1 dropless at 4 x
    2048 on data 2 x expert 2 x tensor 2 -- one loss and every gradient
    leaf against the single device's (routing replayed, phase 36's
    limits) with its launches held to ``ep_tp_train_launches``, then
    phase 12's steps through ``train(..., mesh)``, their launches held
    too (step p50 beside phases 12 and 33); then the reference test's
    composition at full width, einsum on expert 2 x sequence 2 x tensor 2
    with ring attention and remat "full" at 2 x 4096: the loss within
    5e-3 of the single device's, every leaf within 5e-2, routing
    replayed, launches held to ``ep_sp_train_launches``.
42. int8 weights through the pipeline: the 8B in int8
    (``quantize_params``) pipelined on pipe 2 x tensor 2 in 4
    microbatches at 8 x 512 tokens, its logits within PIPE_LOGITS_REL of
    the single device's unpipelined int8 forward, its launches (K9 once a
    hop, M + P - 2 hops) held to ``pipe_int8_launches``.
43. MIG, the card's partitions (``mig_phase``): a C program compiled by
    ``nvcc`` against the toolkit's ``nvml.h`` prints ``sizeof`` and every
    field's ``offsetof`` of each struct the port's NVML binding declares
    (``_nvml.STRUCTS``) and the MIG constants, each held to the binding's;
    the live ``/proc/driver/nvidia-caps/mig-minors`` is parsed where it
    exists; the binding reads the current and pending MIG mode, the most
    MIG devices the card takes and each H100 profile's info (each answer
    or NVML's named error is printed; an answer must match
    ``deviceinfo.MIG_PROFILES``). A line of its own names the branch.
    With MIG disabled: ``RealChipLib`` publishes the GPU whole and no
    ``tensorcore`` device, and the ``Driver`` allocates, prepares
    (CUDA_VISIBLE_DEVICES the GPU's uuid, no core variable) and
    unprepares it as phase 30 does. With MIG enabled by an admin: the MIG
    devices are published and the GPU is not, the ``Driver`` prepares one
    (its ``MIG-`` uuid, its access nodes), and a child process under the
    prepared env launches K1 on it, held to ``rmsnorm_reference``. The
    phase never sets the MIG mode.

Every kernel's launch count is set to 0 just before each path (phases 4,
6, 9, 12, 15, 17, 18, 19, 20, 21, 22, 23, 24, 31, 32, 33, 34, 35, 36, 37,
38, 39, 40, 41 and 42, and in each worker of phases 26-30) and read just
after.
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
import functools
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
# Phase 35 (the mesh against the single device, int8 KV cache): the
# tensor split moves the routers' inputs by bf16 noise, which flips
# near-tie choices more often than a kernel against its plain version does
# (tools/tp_flip_share.py, one H100: 541 of 25600 choices, 2.1%, largest
# margin 1.96e-2; the same with the shards' partial products summed in f32,
# 540; 510 with a bf16 KV cache, 414 with both; none on one tensor shard).
# A psum that loses one shard's expert partial flips 50.5% (largest margin
# 0.327, logits 0.60 relative). The margin limit stays FLIP_MARGIN_LIMIT_KVQ;
# the share limit doubles phase 14's, between the two.
TP_FLIP_SHARE_LIMIT = 4e-2
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


def graph_ms(torch, call, n: int = 50) -> float:
    """Device ms a launch of ``call`` takes among ``n`` back to back in one
    CUDA graph (median of 5 replays): a captured step's setting, where the
    host's launch cost is gone and small inputs stay hot in L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            call()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


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
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 60)
    results = check_paged(torch, cfg, dev, quantized=False)
    results.update(check_rmsnorm(torch, cfg, dev, gen))
    return results


# K1's rows in the kernels line: (row, rows, width) at every shape the
# paths launch it: a packed prefill chunk (4 x 128 tokens, the row of
# earlier trees), the decode step, a `1b` draft's step at B 1, the 8B's
# verify window (k 4 + 1), and the train steps' token counts (4 x 2048 at
# 8x7b-L1, 8 x 2048 at 8b-L8). The gradient at the two train shapes.
RMSNORM_SHAPES = (("rmsnorm", 512, 4096), ("rmsnorm_decode", 8, 4096),
                  ("rmsnorm_draft", 1, 2048), ("rmsnorm_verify", 5, 4096),
                  ("rmsnorm_train_8k", 8192, 4096),
                  ("rmsnorm_train", 16384, 4096))
RMSNORM_BACKWARD_SHAPES = (("rmsnorm_backward_8k", 8192, 4096),
                           ("rmsnorm_backward", 16384, 4096))


def check_rmsnorm(torch, cfg, dev, gen) -> dict:
    """Phase 2, K1: the forward at each of RMSNORM_SHAPES and its gradient
    at RMSNORM_BACKWARD_SHAPES (bf16, the 8B's eps), each against its
    plain version (the forward within 1e-2 of the largest output, the
    gradient by the bf16 2% / 1% rule) and timed beside its bound and the
    library: ``F.rms_norm``, and its autograd backward for the gradient.
    Each row names its launch (``norms.plan``, ``norms.backward_plan``)."""
    from k8s_dra_driver_tpu_torch.ops import norms
    from k8s_dra_driver_tpu_torch.ops._device import sm_count

    F = torch.nn.functional
    eps = cfg.norm_eps
    results = {}

    def inputs(rows, d):
        x = torch.randn((rows, d), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (1 + 0.1 * torch.randn((d,), generator=gen,
                                   device=dev)).to(torch.bfloat16)
        return x, w

    for name, rows, d in RMSNORM_SHAPES:
        x, w = inputs(rows, d)
        out = norms.rmsnorm(x, w, eps)
        ref = norms.rmsnorm_reference(x, w, eps)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        r = (diff.max() / ref.float().abs().max()).item()
        log(f"{name}: max_abs_err={diff.max().item():.3e} rel_err={r:.3e}")
        if not bool(torch.isfinite(out.float()).all()) or r > 1e-2:
            raise AssertionError(f"{name} rel error {r} (limit 1e-2)")
        results[name] = dict(
            max_abs_err=diff.max().item(),
            ms=time_ms(lambda: norms.rmsnorm(x, w, eps)),
            plain_ms=time_ms(lambda: norms.rmsnorm_reference(x, w, eps)),
            library_ms=time_ms(lambda: F.rms_norm(x, (d,), w, eps)),
            plan=norms.plan(rows, d)._asdict(),
            shape=f"x[{rows},{d}]",
            **bound_fields(name, 2 * x.numel() * 2 + w.numel() * 2,
                           4 * x.numel(), F32_FLOPS))
        del x, w, out, ref, diff

    for name, rows, d in RMSNORM_BACKWARD_SHAPES:
        x, w = inputs(rows, d)
        g = torch.randn((rows, d), generator=gen, device=dev).to(
            torch.bfloat16)
        dx, dw = norms.rmsnorm_backward(x, w, g, eps)
        ref_dx, ref_dw = norms.rmsnorm_backward_reference(x, w, g, eps)
        torch.cuda.synchronize()
        err_dx, _ = rel(f"{name} dx", dx, ref_dx)
        err_dw, _ = rel(f"{name} dw", dw, ref_dw)
        del dx, dw, ref_dx, ref_dw
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        yl = F.rms_norm(xl, (d,), wl, eps)
        results[name] = dict(
            max_abs_err=max(err_dx, err_dw),
            ms=time_ms(lambda: norms.rmsnorm_backward(x, w, g, eps)),
            plain_ms=time_ms(lambda: norms.rmsnorm_backward_reference(
                x, w, g, eps)),
            library_ms=time_ms(lambda: torch.autograd.grad(
                yl, (xl, wl), g, retain_graph=True)),
            plan=norms.backward_plan(rows, d, sm_count(dev))._asdict(),
            shape=f"x, g, dx [{rows},{d}]; dw [{d}]",
            **bound_fields(name, 3 * x.numel() * 2 + 2 * w.numel() * 2,
                           8 * x.numel(), F32_FLOPS))
        del x, w, g, xl, wl, yl
        torch.cuda.empty_cache()
    log("rmsnorm:", json.dumps(results))
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


def check_flash_kernels(torch, cfg, dev, b=TRAIN_BATCH, s=TRAIN_SEQ,
                        heads=None, causal=True, suffix="") -> dict:
    """Phase 2, training half: K4-K6 against their plain versions at the
    train step's attention shape (q [8, 32, 2048, 128], k/v [8, 8, 2048,
    128], bf16, causal). Phase 37 calls it at a ring hop's shape (``b``,
    ``s``, ``heads`` = (q heads, kv heads), ``causal`` False), its rows
    named with ``suffix``."""
    from k8s_dra_driver_tpu_torch.ops import attention as att

    F = torch.nn.functional
    hq, hkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    d = cfg.head_dim
    scale = d ** -0.5
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, v, do = rand(b, hq, s, d), rand(b, hkv, s, d), rand(b, hkv, s, d), \
        rand(b, hq, s, d)
    shape = (f"q[{b},{hq},{s},{d}] k/v[{b},{hkv},{s},{d}] "
             + ("causal" if causal else "not causal"))

    out, lse = att.flash_fwd(q, k, v, causal, scale)
    ref_out, ref_lse = att.flash_fwd_reference(q, k, v, causal, scale)
    torch.cuda.synchronize()
    out_err, out_rel = rel("flash_fwd out", out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    log(f"flash_fwd lse: max_abs_err={lse_err:.3e}")
    if not lse_err <= 1e-3:
        raise AssertionError(f"flash_fwd lse error {lse_err} (limit 1e-3)")
    del out, lse
    delta = (do.float() * ref_out.float()).sum(-1)
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, ref_lse, delta, causal, scale)
    ref_dk, ref_dv = att.flash_bwd_dkdv_reference(q, k, v, do, ref_lse,
                                                  delta, causal, scale)
    torch.cuda.synchronize()
    dk_err, dk_rel = rel("flash_bwd_dkdv dk", dk, ref_dk)
    dv_err, dv_rel = rel("flash_bwd_dkdv dv", dv, ref_dv)
    del dk, dv, ref_dk, ref_dv
    dq = att.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale)
    ref_dq = att.flash_bwd_dq_reference(q, k, v, do, ref_lse, delta, causal,
                                        scale)
    torch.cuda.synchronize()
    dq_err, dq_rel = rel("flash_bwd_dq dq", dq, ref_dq)
    del dq, ref_dq
    torch.cuda.empty_cache()

    # The library's yardstick: one SDPA call forward, and its autograd
    # backward (dq, dk and dv together) for the two backward kernels.
    sdpa = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa: E731
        q_, k_, v_, is_causal=causal, scale=scale, enable_gqa=True)
    lib_fwd = time_ms(lambda: sdpa(q, k, v), iters=10)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    lib_out = sdpa(*leaves)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, leaves, do, retain_graph=True), iters=10)
    del lib_out, leaves

    fb, kb, qb = flash_bounds(b, hq, hkv, s, d, causal)
    results = {}
    for name, (nbytes, ops), kernel_fn, plain_fn, err, extra, lib in (
        ("flash_fwd", fb,
         lambda: att.flash_fwd(q, k, v, causal, scale),
         lambda: att.flash_fwd_reference(q, k, v, causal, scale),
         out_err, dict(rel_err=out_rel, lse_max_abs_err=lse_err), lib_fwd),
        ("flash_bwd_dkdv", kb,
         lambda: att.flash_bwd_dkdv(q, k, v, do, ref_lse, delta, causal,
                                    scale),
         lambda: att.flash_bwd_dkdv_reference(q, k, v, do, ref_lse, delta,
                                              causal, scale),
         max(dk_err, dv_err), dict(dk_max_abs_err=dk_err, dk_rel_err=dk_rel,
                                   dv_max_abs_err=dv_err, dv_rel_err=dv_rel),
         lib_bwd),
        ("flash_bwd_dq", qb,
         lambda: att.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale),
         lambda: att.flash_bwd_dq_reference(q, k, v, do, ref_lse, delta,
                                            causal, scale),
         dq_err, dict(rel_err=dq_rel), lib_bwd),
    ):
        name += suffix
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
        if not name.startswith("flash_fwd"):
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

    def check(self, what: str, margin_limit=FLIP_MARGIN_LIMIT,
              share_limit=FLIP_SHARE_LIMIT) -> None:
        """Raises where a flip is not a near-tie (margin >= margin_limit)
        or the flips exceed ``share_limit`` of the routed choices."""
        share = len(self.margins) / max(self.routed, 1)
        largest = max(self.margins, default=0.0)
        if share > share_limit or largest >= margin_limit:
            raise AssertionError(
                f"{what}: {len(self.margins)} routing flips of "
                f"{self.routed} ({share}, limit {share_limit}), "
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


def smoke_engine(params, cfg, dev, quantize_cache=False, capture=True,
                 mesh=None):
    """The engine every serving phase runs: 8 slots, a 1024-block pool
    of 16-token blocks, 4 x 128 packed prefill, prefix cache and
    overlapped tick on (phase 32: on ``mesh``)."""
    from k8s_dra_driver_tpu_torch.models import DecodeEngine

    return DecodeEngine(
        params, cfg, batch_slots=BATCH_SLOTS, num_blocks=NUM_BLOCKS,
        block_size=BLOCK_SIZE, prefill_chunk=PREFILL_CHUNK,
        prefill_batch=PREFILL_BATCH, prefix_cache=True, overlap=True,
        quantize_cache=quantize_cache, device=dev, capture=capture,
        mesh=mesh)


def step_objects(eng) -> tuple:
    """The engine's two ``StepGraph``s, also while ``ComputeTelemetry``
    wraps them (``__wrapped__``)."""
    return tuple(getattr(x, "__wrapped__", x)
                 for x in (eng._decode, eng._prefill))


def serve(torch, params, cfg, dev, quantize_cache=False,
          capture=True, attach=None, lease=None, mesh=None) -> dict:
    """Phase 4 (phase 9 on the MoE config, phase 15 on its full-depth int8
    weights with the int8 KV cache): the engine run (a main path), its
    steps captured as CUDA graphs, or eager with ``capture=False``.
    Returns its metrics; the keys that start with "_" hold what
    ``same_engines`` compares (streams, counters, allocator state).
    ``attach(engine)``, where given, runs before the engine's first tick
    (phase 20's telemetry), and the metrics then hold the engine under
    "_engine". ``lease``, where given, is a context manager factory that
    every tick and the engine's construction run inside (phase 28's
    time-shared workers). ``mesh``, where given, is the expert-parallel
    engine's (phase 32)."""
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
        eng = smoke_engine(params, cfg, dev, quantize_cache, capture, mesh)
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


def train(torch, dev, cfg, preset: str, batch: int, mesh=None,
          steps: int = TRAIN_STEPS, profile: bool = True,
          seq: int = TRAIN_SEQ, use_ring: bool = False) -> dict:
    """Phase 6 (and phase 12 on the MoE config, phase 33 on it with an
    expert ``mesh``, phase 36 on 8b-L8 with a data x fsdp x tensor one,
    phase 37 at ``seq`` 8192 with ring attention on a sequence x tensor
    one): the training path (a main path) on ``cfg`` at batch ``batch`` x
    ``seq``, remat "full", AdamW (lr 1e-3, warm-up 1, 100 total steps) on
    one fixed batch: one warm-up step, ``steps`` timed steps and, with
    ``profile``, one profiled step."""
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
    state = init_train_state(cfg, opt, seed=SEED, device=dev, mesh=mesh)
    step = make_train_step(cfg, opt, remat=True, device=dev, mesh=mesh,
                           use_ring=use_ring)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev)
    moe.MOE_TRACE_COUNTS.clear()
    losses, times = [], []
    for _ in range(1 + steps):
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
    if state.step != 1 + steps:
        raise AssertionError(f"step counter {state.step}")
    step_s = statistics.median(times[1:])
    profile = profile_step(torch, step, state, tokens) if profile else None
    tokens_per_step = batch * seq
    metrics = dict(
        preset=preset, batch=batch, seq=seq, remat="full",
        params=n, losses=losses, warmup_step_ms=times[0] * 1e3,
        step_ms=[t * 1e3 for t in times[1:]], step_ms_p50=step_s * 1e3,
        tokens_per_s=tokens_per_step / step_s,
        model_flops_per_step=cfg.flops_per_token(seq) * tokens_per_step,
        mfu=cfg.flops_per_token(seq) * tokens_per_step / step_s
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
        log("ep train:" if mesh else "moe train:", json.dumps(metrics))
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
    forward and the recompute plus the final norm, its gradient kernel at
    both norms of a layer plus the final norm; the fused dropless
    pipeline K7 and K8 twice (``moe_act`` is in no policy), 3 gmm and 2
    tgmm in its backward."""
    from k8s_dra_driver_tpu_torch.models.llama import REMAT_POLICIES

    layers = cfg.n_layers
    saved = REMAT_POLICIES[policy] or ()
    fused = impl == "dropless"
    return {"flash_fwd": layers * (1 if "flash_out" in saved else 2),
            "flash_bwd_dkdv": layers, "flash_bwd_dq": layers,
            "rmsnorm": 4 * layers + 1,
            "rmsnorm_backward": 2 * layers + 1,
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
    # int8_matmul's wgmma body (M > 64), then its M <= 64 body (the
    # swapped form; int8_matmul_kernel: the mma.sync body before it, so a
    # tree from before the redesign is profiled the same way) and the
    # split-K pass both bodies share.
    ("int8_matmul_wide", ("int8_matmul_wide_kernel",)),
    ("int8_matmul", ("int8_matmul_swap_kernel", "int8_matmul_kernel",
                     "int8_matmul_reduce")),
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
    # K1: the forward, the gradient kernel and its dw pass
    # (csrc/rmsnorm.cu); _rmsnorm_row, the Triton kernel before them.
    ("rmsnorm", ("rmsnorm_fwd", "rmsnorm_bwd", "rmsnorm_dw_reduce",
                 "_rmsnorm_row")),
    # K9, the ring hop (csrc/ring_permute.cu).
    ("ring_permute", ("ring_permute_kernel",)),
    # A7b, the int8 grouped product (csrc/grouped_matmul_int8.cu): its
    # narrow and wide bodies, and the wmma body before them.
    ("grouped_matmul_int8", ("grouped_matmul_int8_narrow",
                             "grouped_matmul_int8_wide",
                             "grouped_matmul_int8_kernel")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
)


def profile_step(torch, step, state, tokens) -> dict:
    """One more train step under ``torch.profiler``: device time by kernel
    group, and the device's busy share of the step's wall time."""
    return device_profile(torch, lambda: step(state, tokens), 1)


def device_profile(torch, fn, calls: int, allow_empty=False) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``: per call, the
    wall time, the device time and the kernel count by kernel group, and
    the device's busy share of the wall time. Raises where the profiler
    saw no device time, unless ``allow_empty``."""
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
    launches = dict.fromkeys(groups, 0)
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / calls
        kernels.append((ms, e.count // calls, e.key[:80]))
        group = next((name for name, keys in KERNEL_GROUPS
                      if any(k in e.key for k in keys)), "other")
        groups[group] += ms
        launches[group] += e.count // calls
    device_ms = sum(groups.values())
    if device_ms <= 0 and not allow_empty:
        raise AssertionError("the profiler saw no device time")
    kernels.sort(reverse=True)
    return dict(
        wall_ms=wall_ms, device_ms=device_ms,
        device_busy_share=device_ms / wall_ms, group_ms=groups,
        group_launches=launches, top_kernels=[dict(ms=ms, count=n, name=name)
                     for ms, n, name in kernels[:12]],
    )


def profile_decode(torch, params, cfg, dev, quantize_cache=False,
                   mesh=None, eager=True) -> dict:
    """One decode step at the engine's shape (8 sequences at 384 cached
    positions, kernels on): its host-clock time over 5 steps, then 3 steps
    under ``torch.profiler``, and the ratio of the two; then the same step
    captured by ``StepGraph``, as the engine runs it (``captured_*``). On
    a ``mesh`` the step runs there (``tools/ring_permute_bench.py``: the
    expert-parallel one); ``eager=False`` skips the eager step's timing and
    profile (phases 34-35: the captured step's profile splits its device
    time) and runs it once, for its int8 -> float copies."""
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
            torch.arange(c * chunk, (c + 1) * chunk, device=dev), mesh=mesh)
    state = {"cache": cache,
             "tok": torch.randint(0, cfg.vocab_size, (BATCH_SLOTS, 1),
                                  generator=gen, device=dev,
                                  dtype=torch.int32)}

    def step():
        c = state["cache"]
        logits, state["cache"] = _forward_with_cache(
            params, state["tok"], c, cfg, c.lengths[:, None], mesh=mesh)
        state["tok"] = logits[:, -1].argmax(-1).to(torch.int32)[:, None]

    result = {}
    if eager:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        result = dict(step_ms=step_ms, **device_profile(torch, step, 3))
        # The profiled steps' device time over the unprofiled steps' host
        # time: the busy share without the profiler's own host cost (two
        # measurements of one run; device_busy_share is the profiled one).
        result["device_ms_over_step_ms"] = result["device_ms"] / step_ms
    result["int8_to_float_copies"] = int8_casts(torch, step)
    result.update(captured_decode(torch, params, cfg, state, mesh))
    log("decode step profile:", json.dumps(result))
    return result


def captured_decode(torch, params, cfg, state, mesh=None) -> dict:
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
                                        lengths[:, None], active=lengths > 0,
                                        mesh=mesh)
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
            {k: prof[k] for k in ("wall_ms", "device_ms", "group_ms",
                                  "group_launches")}
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
# body's expert product (E, capacity rows, K -> N). The seams' M <= 64
# rows (the swapped form): a B 1 draft's step, a verify window (k 4 + 1),
# the decode step, and 16 and 64 rows; M 512 a packed prefill.
INT8_SEAMS = (("wqkv", 4096, 6144), ("wo", 4096, 4096),
              ("lm_head", 4096, 32000))
INT8_SEAM_MS = (1, 5, BATCH_SLOTS, 16, 64)
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
    the seams' shapes (M 1, 5, 8, 16 and 64, the swapped form, and a
    packed prefill's M 512; K 4096 to N 6144, 4096 and 32000) and in the
    prologue mode at the einsum MoE
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
        for m in INT8_SEAM_MS + (PREFILL_BATCH * PREFILL_CHUNK,):
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
    # the epilogue mode the seams run, the swapped form), summed, with
    # every call beside; the same at M 1, 5, 16 and 64; a packed
    # prefill's three (M 512, the wgmma body), summed; and the einsum MoE
    # body's expert product (the wgmma body, prologue mode).
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

    rows = {"int8_matmul": dict(summed(BATCH_SLOTS, "the swapped form"),
                                calls=calls),
            "int8_matmul_prefill": summed(PREFILL_BATCH * PREFILL_CHUNK,
                                          "the wgmma body")}
    for m in INT8_SEAM_MS:
        if m != BATCH_SLOTS:
            rows[f"int8_matmul_m{m}"] = summed(m, "the swapped form")
    experts = calls[f"experts [{e},{m_e},{k_e}]x[{e},{k_e},{n_e}] prologue"]
    rows["int8_matmul_experts"] = dict(
        {key: experts[key] for key in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "plan")},
        shape=(f"experts [{e},{m_e},{k_e}] x [{e},{k_e},{n_e}], prologue "
               f"mode, the wgmma body; library: batched bf16 torch.matmul "
               f"on weights converted beforehand"))
    for name in [r for r in rows if r != "int8_matmul"]:
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
    if mode == "mig":
        # Phase 43: K1 on the MIG device the claim's env names.
        from k8s_dra_driver_tpu_torch.ops import norms

        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn((512, 4096), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (1 + 0.1 * torch.randn((4096,), generator=gen,
                                   device="cuda")).to(torch.bfloat16)
        before = norms.rmsnorm.launches
        out = norms.rmsnorm(x, w, 1e-5)
        launches = norms.rmsnorm.launches - before
        ref = norms.rmsnorm_reference(x, w, 1e-5)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        emit("rmsnorm", launches=launches,
             max_abs_err=diff.max().item(),
             rel_err=(diff.max() / ref.float().abs().max()).item(),
             finite=bool(torch.isfinite(out.float()).all()),
             total_memory=props.total_memory,
             sms=props.multi_processor_count, **seen)
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


# Phase 32: expert-parallel MoE serving on a single-controller mesh
# (parallel/mesh.py) of EP_SHARDS shards, all on the one card, its ring hops
# through K9's twin (csrc/ring_permute.cu).
EP_SHARDS = 4
EP_PSUM_TOKENS = 13             # does not divide the ring: "auto" takes psum
RING_CHECK_SHAPE = (37, 129)    # no whole 16-byte word in any dtype
RING_BIG_BYTES = 256 << 20      # K9's largest timed size, per shard


def ring_inputs(torch, gen, dev, n, shape, dtype, offset=0) -> list:
    """``n`` shard buffers of ``shape``, views into one buffer from
    ``offset`` elements on (a nonzero storage offset where ``offset`` is),
    random values (int8: from [-127, 127])."""
    numel = math.prod(shape)
    whole = torch.randn(offset + n * numel, generator=gen, device=dev)
    whole = ((whole * 40).clamp(-127, 127).to(dtype) if dtype == torch.int8
             else whole.to(dtype))
    return [whole[offset + i * numel:offset + (i + 1) * numel].view(shape)
            for i in range(n)]


def same_bytes(torch, out, ref) -> bool:
    return all(o.device == r.device and o.dtype == r.dtype
               and torch.equal(o.reshape(-1).view(torch.uint8),
                               r.reshape(-1).view(torch.uint8))
               for o, r in zip(out, ref))


def ring_rows(torch, h: int) -> tuple:
    """K9's timed rows: (name, rings as (shape, dtype)) -- the prefill
    hop's bf16 chunk and f32 carrier alone, 256 MB a shard, and the hop as
    one grouped launch at the prefill chunk and at the decode step's
    (BATCH_SLOTS // EP_SHARDS rows a shard)."""
    chunk, decode = (PREFILL_CHUNK, h), (BATCH_SLOTS // EP_SHARDS, h)
    return (
        ("ring_permute", ((chunk, torch.bfloat16),)),
        ("ring_permute_carrier", ((chunk, torch.float32),)),
        ("ring_permute_256mb", (((RING_BIG_BYTES // 2,), torch.bfloat16),)),
        ("ring_permute_hop", ((chunk, torch.bfloat16),
                              (chunk, torch.float32))),
        ("ring_permute_hop_decode", ((decode, torch.bfloat16),
                                     (decode, torch.float32))),
    )


def time_ring_rows(torch, ring, gen, dev, h: int) -> dict:
    """Every ``ring_rows`` row of ``ring`` (the port's ``parallel/ring.py``
    of this tree or another) on EP_SHARDS shards of the card: the kernel by
    CUDA events (``ms``) and as a launch among 50 in one CUDA graph
    (``graph_ms``, 10 at 256 MB) -- a row of several rings as one grouped
    launch where the tree has ``ring_permute_group``, and also as one
    launch a ring (``two_launches_ms``, ``two_launches_graph_ms``) --
    beside the plain version and ``torch._foreach_copy_`` into
    preallocated buffers (the library yardstick: one call, the same
    bytes). The bound reads and writes every byte once at the card's
    memory rate."""
    rows = {}
    grouped = hasattr(ring, "ring_permute_group")
    for name, specs in ring_rows(torch, h):
        rings = [ring_inputs(torch, gen, dev, EP_SHARDS, shape, dtype)
                 for shape, dtype in specs]
        moved = 2 * sum(x.numel() * x.element_size() for r in rings
                        for x in r)
        dst = [torch.empty_like(x) for r in rings for x in r]
        rotated = [r[(j - 1) % EP_SHARDS] for r in rings
                   for j in range(EP_SHARDS)]

        def apart():
            for r in rings:
                ring.ring_permute_kernel(r, 1)

        def launch():
            ring.ring_permute_group(rings, 1)

        in_graph = 10 if name == "ring_permute_256mb" else 50
        row = dict(
            plain_ms=time_ms(
                lambda: [ring.ring_permute_reference(r, 1) for r in rings]),
            library_ms=time_ms(lambda: torch._foreach_copy_(dst, rotated)),
            shape=(f"{EP_SHARDS} shards of "
                   + " + ".join(f"{list(shape)} {dtype}"
                                for shape, dtype in specs)
                   + " on one card, shift 1"),
            **bound_fields(name, moved, 0.0, BF16_FLOPS),
        )
        if len(rings) > 1:
            row.update(two_launches_ms=time_ms(apart),
                       two_launches_graph_ms=graph_ms(torch, apart))
        if len(rings) == 1 or grouped:
            call = apart if len(rings) == 1 else launch
            row.update(ms=time_ms(call),
                       graph_ms=graph_ms(torch, call, in_graph))
            row["gb_per_s"] = moved / row["ms"] / 1e6
        rows[name] = row
        del rings, dst, rotated
        torch.cuda.empty_cache()
    return rows


def check_ring_permute(torch, cfg, dev) -> dict:
    """Phase 32's first step: K9's twin against its plain version, bit for
    bit. One ring (``ring_permute_kernel``) of 2 and 4 shards of the card,
    shifts 1, -1 and 3, in bf16, f32 and int8, at a size of no whole
    16-byte word whose shards start one element into a buffer (a nonzero
    storage offset, 1-, 2- or 4-byte aligned) and at the phase's hop chunk
    [128, H]; then groups of rings in one launch (``ring_permute_group``,
    one launch each): those three misaligned rings beside a ring of empty
    pairs, and the hop's bf16 chunk beside its f32 carrier. The gradients
    (``RingPermuteFunction``) are the inverse rotations, of one ring and of
    a group. Then times every ``ring_rows`` row (``time_ring_rows``)."""
    from k8s_dra_driver_tpu_torch.parallel import ring

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 32)
    h = cfg.hidden
    checked = groups = 0
    for n in (2, EP_SHARDS):
        for shift in (1, -1, 3):
            for dtype in (torch.bfloat16, torch.float32, torch.int8):
                for shape, offset in ((RING_CHECK_SHAPE, 1), ((128, h), 0)):
                    xs = ring_inputs(torch, gen, dev, n, shape, dtype, offset)
                    out = ring.ring_permute_kernel(xs, shift)
                    ref = ring.ring_permute_reference(xs, shift)
                    torch.cuda.synchronize()
                    if not same_bytes(torch, out, ref):
                        raise AssertionError(
                            f"ring_permute n {n} shift {shift} {dtype} "
                            f"{shape} offset {offset}: not the plain "
                            f"version's bytes")
                    checked += 1
            for rings in (
                    [ring_inputs(torch, gen, dev, n, RING_CHECK_SHAPE, dt, 1)
                     for dt in (torch.int8, torch.bfloat16, torch.float32)]
                    + [ring_inputs(torch, gen, dev, n, (0, h),
                                   torch.float32)],
                    [ring_inputs(torch, gen, dev, n, (128, h), dt)
                     for dt in (torch.bfloat16, torch.float32)]):
                before = ring.ring_permute_kernel.launches
                out = ring.ring_permute_group(rings, shift % n)
                ref = ring.ring_permute_many_reference(rings, shift)
                torch.cuda.synchronize()
                if ring.ring_permute_kernel.launches != before + 1 or not all(
                        same_bytes(torch, o, r) for o, r in zip(out, ref)):
                    raise AssertionError(
                        f"ring_permute_group n {n} shift {shift} "
                        f"{[(tuple(r[0].shape), r[0].dtype) for r in rings]}"
                        f": not the plain version's bytes, or not one "
                        f"launch")
                groups += 1
    rings = [[x.clone().requires_grad_() for x in ring_inputs(
        torch, gen, dev, EP_SHARDS, shape, dtype)] for shape, dtype in (
            (RING_CHECK_SHAPE, torch.float32), ((128, h), torch.float32),
            ((128, h), torch.bfloat16))]
    w = [ring_inputs(torch, gen, dev, EP_SHARDS, r[0].shape, r[0].dtype)
         for r in rings]
    out = [ring.ring_permute(rings[0], "expert", EP_SHARDS)] + \
        ring.ring_permute_many(rings[1:], "expert", EP_SHARDS,
                               sites=("x", "y"))
    sum((o.float() * wi.float()).sum() for os_, ws in zip(out, w)
        for o, wi in zip(os_, ws)).backward()
    for r, ws in zip(rings, w):
        if not same_bytes(torch, [x.grad for x in r],
                          ring.ring_permute_reference(ws, -1)):
            raise AssertionError("ring_permute's gradient is not the "
                                 "inverse rotation")
    log(f"ring_permute: {checked} rotations, {groups} grouped launches and "
        f"the gradients (one ring, a group) bitwise equal to the plain "
        f"version")
    rows = time_ring_rows(torch, ring, gen, dev, h)
    for row in rows.values():
        row["max_abs_err"] = 0.0
        log(f"ring_permute: {row['shape']}: kernel {row['ms']:.4f} ms "
            f"({row['gb_per_s']:.1f} GB/s read + write), in a graph "
            f"{row['graph_ms']:.4f} ms"
            + (f" (one launch a ring: {row['two_launches_ms']:.4f}, in a "
               f"graph {row['two_launches_graph_ms']:.4f})"
               if "two_launches_ms" in row else "")
            + f", plain {row['plain_ms']:.4f} ms, _foreach_copy_ "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms; "
            f"{card_line()}")
    rows["ring_permute"].update(checked_rotations=checked,
                                checked_groups=groups)
    return rows


class EpRoutingReplay(RoutingReplay):
    """``RoutingReplay`` for the ring path: the single-device forward
    records one [T, k] choice a layer, the ring routes chunk by chunk --
    per batch group (``groups`` of them, each holding its contiguous share
    of the tokens) n_ep * n_ep calls a layer, hop-major, shard i at hop h
    holding chunk (i - h) mod n_ep -- and each call replays its chunk's
    rows of its layer's record. Beside tensor a chunk is routed once per
    expert shard, so the calls are the same. The forward runs the groups
    in order; with ``layers`` (a loss under remat "full" of that many
    layers) the calls after the forward's are the backward's recompute,
    which runs the (layer, group) blocks in reverse, as the single
    device's recompute records its layers."""

    def __init__(self, moe, n_ep: int, groups: int = 1, layers=None):
        super().__init__(moe)
        self.n_ep = n_ep
        self.groups = groups
        self.layers = layers
        self.calls = 0

    def _next(self, experts):
        block, j = divmod(self.calls, self.n_ep ** 2)
        self.calls += 1
        layer, g = divmod(block, self.groups)
        if self.layers is not None and layer >= self.layers:
            g = self.groups - 1 - g
        hop, i = divmod(j, self.n_ep)
        chunk = g * self.n_ep + (i - hop) % self.n_ep
        t_loc = experts.shape[0]
        return self.recorded[layer][chunk * t_loc:(chunk + 1) * t_loc]


def ep_forward(torch, params, sharded, mesh, cfg, dev, read_counts) -> dict:
    """Phase 32's forwards: ``moe.forward(..., mesh=mesh)`` with dropless
    at B 4 x 128 (512 tokens: the ring) and at 13 tokens (the psum path
    under ``"auto"``) against the single-device dropless forward on the
    same weights and tokens, through the kernels both. As in phase 8 the
    EP run is compared with the single run's expert choices replayed (the
    limit: relative logit difference 5e-2), and its own choices must
    differ only at near-ties (FLIP_MARGIN_LIMIT, FLIP_SHARE_LIMIT); its
    free run's difference is reported. Holds each EP forward's launches:
    K7 and K8 n_ep**2 L times on the ring (every shard at every hop), n_ep
    L on psum; K9 n_ep L times on the ring (the mesh's shards share the
    card: one grouped launch a hop), never on psum. At 13
    tokens ``ep_overlap="ring"`` must raise. On the ring every shard routes
    each chunk at its hop, so the flips and routed choices count each
    chunk's routing n_ep times (their share is the distinct ones')."""
    from k8s_dra_driver_tpu_torch.models import moe

    n_ep, layers = mesh.shape["expert"], cfg.n_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 33)
    dropless = dataclasses.replace(cfg, moe_impl="dropless")
    result = {}
    for name, (b, s) in (("ring", (PREFILL_BATCH, PREFILL_CHUNK)),
                         ("psum", (1, EP_PSUM_TOKENS))):
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=dev, dtype=torch.int32)
        with torch.no_grad():
            with RoutingReplay(moe) as single:
                single.mode = "record"
                want, want_aux = moe.forward(params, tokens, dropless)
            before = read_counts()
            free, free_aux = moe.forward(sharded, tokens, dropless, mesh=mesh)
            torch.cuda.synchronize()
            after = read_counts()
            replay = (EpRoutingReplay(moe, n_ep) if name == "ring"
                      else RoutingReplay(moe))
            replay.recorded = list(single.recorded)
            with replay:
                replay.mode = "replay"
                got, _ = moe.forward(sharded, tokens, dropless, mesh=mesh)
        pairs = n_ep * n_ep if name == "ring" else n_ep
        want_counts = {"moe_gateup": pairs * layers,
                       "moe_down_combine": pairs * layers,
                       "ring_permute": (n_ep * layers
                                        if name == "ring" else 0)}
        launched = {k: after[k] - before[k] for k in want_counts}
        if launched != want_counts:
            raise AssertionError(f"EP {name} forward launches {launched}, "
                                 f"expected {want_counts}")
        for x in (got, free):
            if not bool(torch.isfinite(x).all()) or x.shape != want.shape:
                raise AssertionError(f"EP {name} forward: logits "
                                     f"{tuple(x.shape)}, finite "
                                     f"{bool(torch.isfinite(x).all())}")
        a, w, f = got[:, -1], want[:, -1], free[:, -1]
        row = dict(
            tokens=b * s,
            rel_logit_diff=((got - want).norm() / want.norm()).item(),
            max_logit_diff=(got - want).abs().max().item(),
            free_rel_logit_diff=((free - want).norm() / want.norm()).item(),
            free_max_logit_diff=(free - want).abs().max().item(),
            free_top1_agreement=float((f.argmax(-1) == w.argmax(-1))
                                      .float().mean()),
            top1_agreement=float((a.argmax(-1) == w.argmax(-1))
                                 .float().mean()),
            aux_diff=abs(float(free_aux) - float(want_aux)),
            launches=launched,
            **{k: v for k, v in replay.summary().items()
               if k != "flip_margins"})
        log(f"EP {name} forward vs single-device:", json.dumps(row))
        if row["rel_logit_diff"] > 5e-2:
            raise AssertionError(f"EP {name} forward: relative logit "
                                 f"difference {row['rel_logit_diff']} "
                                 f"(limit 5e-2)")
        replay.check(f"EP {name} forward")
        result[name] = row
    try:
        moe.forward(sharded, tokens, dataclasses.replace(
            dropless, ep_overlap="ring"), mesh=mesh)
    except ValueError as e:
        if "ep_overlap='ring'" not in str(e):
            raise
    else:
        raise AssertionError(f"ep_overlap='ring' at {EP_PSUM_TOKENS} "
                             f"tokens did not raise")
    return result


def ep_phase(torch, cfg, dev, single: dict, kept_streams: dict,
             drive, read_counts) -> dict:
    """Phase 32: expert-parallel MoE serving. Rebuilds phase 8's model
    (``cfg``, the seed's weights) and shards its expert stacks over
    ``build_mesh(MeshConfig(expert=EP_SHARDS), devices=[card] *
    EP_SHARDS)`` by ``shard_pytree(params, mesh, param_specs(cfg))``: views
    of the stacks, no new memory. Then K9 against its plain version and
    its times (``check_ring_permute``), the EP forwards
    (``ep_forward``), and the EP engine: ``DecodeEngine(mesh=mesh)`` with
    ``moe_impl="dropless"`` (decode steps of BATCH_SLOTS tokens and packed
    prefills of PREFILL_BATCH x PREFILL_CHUNK both divide the ring) serves
    phase 9's traffic, its steps captured (the main path, through
    ``drive``); its streams are compared with phase 9's single-device
    engine on the same weights (``kept_streams``), the count equal and
    the first divergence reported, not required, and its launches held:
    K7 and K8 n_ep**2 L, K9 n_ep L times a forward."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.parallel import Sharded, shard_pytree

    t0 = time.perf_counter()
    params = moe.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    mesh = ep_mesh(dev)
    sharded = shard_pytree(params, mesh, moe.param_specs(cfg))
    stack = sharded["layers"]["w_gateup"]
    whole = params["layers"]["w_gateup"]
    if not (isinstance(stack, Sharded) and len(stack.shards) == EP_SHARDS
            and all(s.untyped_storage().data_ptr()
                    == whole.untyped_storage().data_ptr()
                    for s in stack.shards)
            and torch.cuda.memory_allocated() == held):
        raise AssertionError("shard_pytree copied the expert stacks on one "
                             "card")
    log(f"phase 32: {mesh}, {cfg.n_experts // EP_SHARDS} experts a shard, "
        f"weights {held / 1e9:.1f} GB sharded in place "
        f"({time.perf_counter() - t0:.1f}s)")
    kernels = check_ring_permute(torch, cfg, dev)
    forwards = ep_forward(torch, params, sharded, mesh, cfg, dev,
                          read_counts)
    dropless = dataclasses.replace(cfg, moe_impl="dropless")
    served = drive("ep_serving", serve, torch, sharded, dropless, dev,
                   False, True, None, None, mesh)
    if served["moe_impl"] != {"decode_step": "dropless",
                              "prefill_chunk": "dropless"} \
            or served["compile_counts"] != {"decode_step": 1,
                                            "prefill_chunk": 1}:
        raise AssertionError(f"EP engine: moe_impl {served['moe_impl']}, "
                             f"compile counts {served['compile_counts']}")
    streams = served.pop("_streams")
    prompt_lens = served.pop("_prompt_lens")
    for key in [k for k in served if k.startswith("_")]:
        del served[key]
    # Where a stream differs: the first differing token of each, and the
    # two tokens' logit margin after the common prefix on the single-device
    # model (reported, not held: chunked routing flips near-ties).
    flips = stream_flips(torch, streams, kept_streams["streams"],
                         prompt_lens, ("ep", "single"), params, cfg, dev)
    same = len(streams) - len(flips)
    served.update(streams_equal_single=same, stream_flips=flips,
                  single_ttft_p50_ms=single["ttft_p50_ms"],
                  single_decode_step_p50_ms=single["decode_step_p50_ms"])
    log(f"EP engine: {same} of {len(streams)} streams equal phase 9's "
        f"single-device engine's; first divergences {json.dumps(flips)}; "
        f"TTFT p50 {served['ttft_p50_ms']:.2f} ms (phase 9: "
        f"{single['ttft_p50_ms']:.2f}), decode p50 "
        f"{served['decode_step_p50_ms']:.3f} ms (phase 9: "
        f"{single['decode_step_p50_ms']:.3f}), capture "
        f"{served['capture_s']:.2f} s; {card_line()}")
    del sharded, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(kernels=kernels, forward=forwards, engine=served,
                s=time.perf_counter() - t0)


def ep_train_launches(n_ep: int, layers: int) -> dict:
    """The EP ring's kernel launches a train step under remat "full": the
    forward and its recompute each run every (shard, hop) pair's K7 and K8
    and n_ep K9 launches a layer (one group a hop); the backward runs each
    pair's three gmm and two tgmm and one K9 launch a group (the inverse
    rotation)."""
    pairs = n_ep * n_ep * layers
    return {"ring_permute": 3 * n_ep * layers,
            "moe_gateup": 2 * pairs, "moe_down_combine": 2 * pairs,
            "grouped_matmul": 3 * pairs, "grouped_weight_grad": 2 * pairs}


def ep_mesh(dev):
    return card_mesh(dev, expert=EP_SHARDS)


def ep_compare_train(torch, cfg, dev, read_counts, mesh=None,
                     want=None) -> dict:
    """Phase 33's first step: one ``loss_fn`` value and every gradient
    leaf of ``cfg`` (phase 12's 8x7b-L1 dropless, its seeded weights and
    its batch of MOE_TRAIN_BATCH x 2048 tokens, remat "full") expert
    parallel on ``ep_mesh`` -- the ring, the expert stacks cut into views
    inside the loss -- against the single-device loss on the same weights
    and tokens, the EP run replaying the single run's expert choices
    (``EpRoutingReplay``, the recompute's too). Holds §2's limits (loss
    1e-2, leaves 5e-2), the flips to near-ties, and the EP run's launches
    to ``ep_train_launches`` (phase 41 (a): on ``mesh``, its launches to
    ``want``)."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.train import leaves
    from k8s_dra_driver_tpu_torch.parallel import shard_pytree

    mesh = ep_mesh(dev) if mesh is None else mesh
    n_ep = mesh.shape["expert"]
    groups = mesh.shape["data"] * mesh.shape["fsdp"]
    params = moe.init_params(cfg, seed=SEED, device=dev)
    names, flat = param_names(params), leaves(params)
    for p in flat:
        p.requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size,
                           (MOE_TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen,
                           device=dev)
    with RoutingReplay(moe) as single:
        single.mode = "record"
        loss_s = moe.loss_fn(params, tokens, cfg, remat=True)
        grads_s = torch.autograd.grad(loss_s, flat)
    replay = EpRoutingReplay(moe, n_ep, groups, cfg.n_layers)
    replay.recorded = list(single.recorded)
    if want is None:
        want = ep_train_launches(n_ep, cfg.n_layers)
    torch.cuda.synchronize()
    before = read_counts()
    with replay:
        replay.mode = "replay"
        loss_e = moe.loss_fn(shard_pytree(params, mesh,
                                          moe.param_specs(cfg)),
                             tokens, cfg, mesh=mesh, remat=True)
        grads_e = torch.autograd.grad(loss_e, flat)
    torch.cuda.synchronize()
    after = read_counts()
    launched = {k: after[k] - before[k] for k in want}
    if launched != want:
        raise AssertionError(f"EP loss and gradients launched {launched}, "
                             f"expected {want}")
    loss_rel, grad_rel = loss_grad_rel(names, (loss_e.item(), grads_e),
                                       (loss_s.item(), grads_s))
    result = dict(loss_ep=loss_e.item(), loss_single=loss_s.item(),
                  loss_rel_diff=loss_rel, grad_rel_diff=grad_rel,
                  batch=MOE_TRAIN_BATCH, seq=TRAIN_SEQ, layers=cfg.n_layers,
                  shards=n_ep, mesh=str(mesh), launches=launched,
                  **{k: v for k, v in replay.summary().items()
                     if k != "flip_margins"})
    log("EP loss/grad vs single-device:", json.dumps(result))
    hold_loss_grads("EP vs single-device", loss_rel, grad_rel)
    replay.check("EP loss/grad")
    del params, flat, grads_s, grads_e, loss_s, loss_e
    gc.collect()
    torch.cuda.empty_cache()
    return result


# Phases 34-36: the data, fsdp and tensor axes of a single-controller mesh,
# every shard on the card. Megatron serving of phase 4's 8B on data 2 x
# tensor 4, phase 15's int8 8x7b on tensor 4 (the int8 grouped product,
# A7b), and phase 6's 8b-L8 training on data 2 x fsdp 2 x tensor 2.
TP_SERVE_MESH = dict(data=2, tensor=4)
TP_MOE_MESH = dict(tensor=4)
TP_TRAIN_MESH = dict(data=2, fsdp=2, tensor=2)
TP_TRAIN_STEPS = 2          # timed, after the warm-up step: 3 steps
TP_LOGITS_PROMPT = 96
TP_LOGITS_DECODE = 4
TP_LOGITS_REL = 5e-2


def card_mesh(dev, **axes):
    """A single-controller mesh of ``axes`` with every shard on the card."""
    from k8s_dra_driver_tpu_torch.parallel import MeshConfig, build_mesh

    mc = MeshConfig(**axes)
    return build_mesh(mc, devices=[dev] * mc.num_devices)


def shard_in_place(torch, params, mesh, specs):
    """``shard_pytree(params, mesh, specs)``, held to take no new memory:
    on one card every block is a view of the whole leaf."""
    from k8s_dra_driver_tpu_torch.parallel import shard_pytree

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    sharded = shard_pytree(params, mesh, specs)
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != held:
        raise AssertionError(f"shard_pytree on {mesh} took "
                             f"{torch.cuda.memory_allocated() - held} bytes")
    return sharded


@contextlib.contextmanager
def primitive_dispatch():
    """The single device's dropless MoE on the primitive path (the grouped
    products), the path the mesh runs without an expert axis as the
    reference's GSPMD program does: the two then differ only by the
    tensor shards' partial sums."""
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch

    moe_dispatch.set_dispatch_impl("primitive")
    try:
        yield
    finally:
        moe_dispatch.set_dispatch_impl("auto")


def mesh_logits_rel(torch, params, sharded, cfg, dev, mesh,
                    quantize_cache=False, replay_cls=None) -> dict:
    """A prefill of 8 seeded TP_LOGITS_PROMPT-token prompts, then
    TP_LOGITS_DECODE decode steps, on the single device and on ``mesh``:
    each step's logits within TP_LOGITS_REL of the single device's
    largest magnitude. On an MoE config the single device runs the
    primitive path (``primitive_dispatch``) and the mesh run replays its
    expert choices (``RoutingReplay``, as phase 14 holds a forward): every
    routing flip a near-tie, at most TP_FLIP_SHARE_LIMIT of them
    (``replay_cls``: ``RoutingReplay`` by default, the EP ring's
    ``EpRoutingReplay`` where the mesh routes chunk by chunk)."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.decode import decode_step, prefill

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 50)
    n = TP_LOGITS_PROMPT + TP_LOGITS_DECODE
    toks = torch.randint(0, cfg.vocab_size, (BATCH_SLOTS, n), generator=gen,
                         device=dev, dtype=torch.int32)
    runs = []
    with (replay_cls or RoutingReplay)(moe) as replay:
        for p, m, how in ((params, None, "record"),
                          (sharded, mesh, "replay")):
            replay.mode = how
            with (primitive_dispatch() if m is None
                  else contextlib.nullcontext()):
                logits, cache = prefill(p, toks[:, :TP_LOGITS_PROMPT], cfg,
                                        n + 1, quantize_cache=quantize_cache,
                                        block_size=BLOCK_SIZE, mesh=m)
                seq = [logits.float()]
                for i in range(TP_LOGITS_PROMPT, n):
                    logits, cache = decode_step(p, toks[:, i], cache, cfg,
                                                mesh=m)
                    seq.append(logits.float())
            del cache
            runs.append(seq)
    rels = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(runs[1], runs[0])]
    if not max(rels) <= TP_LOGITS_REL:
        raise AssertionError(f"mesh logits against the single device's: "
                             f"relative differences {rels} (limit "
                             f"{TP_LOGITS_REL})")
    result = dict(prefill_rel=rels[0], decode_rel=rels[1:])
    if isinstance(cfg, moe.MoeConfig):
        replay.check("mesh vs single routing", FLIP_MARGIN_LIMIT_KVQ
                     if quantize_cache else FLIP_MARGIN_LIMIT,
                     TP_FLIP_SHARE_LIMIT)
        result.update(replay.summary())
        del result["flip_margins"]
    return result


def explain_mesh_flips(torch, params, sharded, cfg, dev, mesh, flips,
                       other, prompt_lens, quantize_cache) -> list:
    """An MoE model's mesh stream and the single device's first differ
    beyond a logit near-tie: a router's top-2 choice is discrete, so the
    bf16 noise of another summation order flips near-tie choices, and one
    flipped expert moves a token's logits far more than that noise. So
    the common prefix is prefilled (dropless) on the single device (the
    primitive path, ``primitive_dispatch``), its routing recorded, and on
    the mesh with that routing replayed: every
    routing flip must be a near-tie, and the mesh must then choose the
    single device's token or one within a near-tie of it
    (``near_tie``). Returns what each flip's rerun found."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.decode import prefill

    limit = FLIP_MARGIN_LIMIT_KVQ if quantize_cache else FLIP_MARGIN_LIMIT
    dropless = dataclasses.replace(cfg, moe_impl="dropless")
    found = []
    for f in flips:
        if near_tie(f, limit):
            continue
        rid, i = f["request"], f["generated_index"]
        prefix = torch.tensor([other[rid][:prompt_lens[rid] + i]],
                              device=dev)
        out = []
        with RoutingReplay(moe) as replay:
            for p, m, how in ((params, None, "record"),
                              (sharded, mesh, "replay")):
                replay.mode = how
                with (primitive_dispatch() if m is None
                      else contextlib.nullcontext()):
                    logits, _ = prefill(p, prefix, dropless,
                                        prefix.shape[1] + 1,
                                        quantize_cache=quantize_cache,
                                        block_size=BLOCK_SIZE, mesh=m)
                out.append(logits[0].float())
        replay.check(f"the routing behind flip {rid}/{i}", limit,
                     TP_FLIP_SHARE_LIMIT)
        single, meshed = out
        a, b = int(single.argmax()), int(meshed.argmax())
        tie = {"logit_margin": abs(float(meshed[a] - meshed[b])),
               "logits": [float(meshed[a]), float(meshed[b])]}
        if a != b and not near_tie(tie, limit):
            raise AssertionError(f"with the single device's routing replayed "
                                 f"the mesh chooses {b} at {rid}/{i}, the "
                                 f"single device {a}: {tie}")
        summary = replay.summary()
        del summary["flip_margins"]
        f["routing"] = dict(summary, single_choice=a, mesh_replayed_choice=b,
                            replayed_logit_margin=tie["logit_margin"])
        found.append(f)
    return found


def hold_streams(torch, what, streams, phase_streams, prompt_lens, params,
                 cfg, dev, quantize_cache, limit) -> list:
    """The streams equal another phase's but near-ties: at each first
    differing token the two tokens' logits on the single-device model
    within ``limit`` or one bf16 step (``near_tie``). Returns the flips."""
    flips = stream_flips(torch, streams, phase_streams, prompt_lens,
                         ("mesh", "single"), params, cfg, dev,
                         quantize_cache)
    log(f"{what}: stream flips against the single device "
        f"{json.dumps(flips)}")
    bad = [f for f in flips if not near_tie(f, limit)]
    if bad:
        raise AssertionError(f"{what}: streams differ beyond a near-tie "
                             f"(limit {limit} or one bf16 step): {bad}")
    return flips


def int8_grouped_inputs(torch, qlayer, cfg, dev, t: int, tp: int, seed: int):
    """The primitive path's operands at ``t`` tokens on tensor shard 0's
    blocks of one int8 layer: the plan of ``t`` routed random hidden
    states, the sorted rows, the gate/up block [E, H, 2, M / tp] (a
    strided view) and the down block [E, M / tp, H] with their scales."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.quant import QuantTensor
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md
    from k8s_dra_driver_tpu_torch.ops import norms

    m_loc = cfg.mlp_hidden // tp
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((t, cfg.hidden), generator=gen, device=dev).to(
        torch.bfloat16)
    xf = norms.rmsnorm_reference(x, qlayer["ln_mlp"], cfg.norm_eps)
    gates, experts, _, _ = moe._route_topk(xf, qlayer["wr"], cfg)
    plan = md.build_plan(experts.reshape(-1), t, cfg.n_experts, cfg.top_k)
    gu, dn = qlayer["w_gateup"], qlayer["w_down"]
    gu_blk = QuantTensor(q=gu.q[..., :m_loc], scale=gu.scale[..., :m_loc])
    dn_blk = QuantTensor(q=dn.q[:, :m_loc], scale=dn.scale)
    xs = md._take_rows(xf, plan.row_ids)
    act = torch.randn((plan.r_pad, m_loc), generator=gen, device=dev).to(
        torch.bfloat16)
    return plan, xs, act, gu_blk, dn_blk


def check_grouped_int8(torch, qparams, cfg, dev, tp: int) -> dict:
    """Phase 35: A7b (``grouped_matmul_int8``) against its plain version at
    the decode (BATCH_SLOTS tokens) and prefill (PREFILL_BATCH x
    PREFILL_CHUNK) shapes on layer 0's tensor-shard-0 blocks, gate/up
    (the strided [E, H, 2, M / tp] view, both halves in one launch) and
    down, at the bf16 gate; on ragged groups with rows past the last
    (exactly 0). Each row timed by CUDA events (L2 flushed) and, at
    decode, as a launch among 50 in a CUDA graph, beside its bound (the
    touched experts' int8 weights and scales, the live lhs rows and the
    output at 3.35 TB/s, or 2 x live x K x N at 989 TFLOP/s), its plain
    version and ``torch._grouped_mm`` on a bf16 copy of the weight (a
    yardstick: no PyTorch call computes the int8 function). Each row
    names the launch ``int8_gmm_plan`` chose (its body: narrow at
    decode, wide at prefill)."""
    from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md

    qlayer = {k: w[0] for k, w in qparams["layers"].items()}
    rows = {}
    for tag, t, seed in (("", BATCH_SLOTS, SEED + 60),
                         ("_prefill", PREFILL_BATCH * PREFILL_CHUNK,
                          SEED + 61)):
        plan, xs, act, gu_blk, dn_blk = int8_grouped_inputs(
            torch, qlayer, cfg, dev, t, tp, seed)
        sizes = plan.sizes_aligned
        live = int((plan.pair_ids < plan.n_pairs).sum())
        touched = int((sizes > 0).sum())
        offs = torch.cumsum(sizes, 0).to(torch.int32)
        for part, lhs, w in (("_gateup", xs, gu_blk),
                             ("_down", act, dn_blk)):
            name = f"grouped_matmul_int8{tag}{part}"
            e, k = w.q.shape[0], w.q.shape[1]
            n = (2 * w.q.shape[-1]) if w.q.dim() == 4 else w.q.shape[-1]

            def kernel(lhs=lhs, w=w):
                return md.grouped_matmul_int8(lhs, w.q, w.scale, sizes)

            def plain(lhs=lhs, w=w):
                return md.grouped_matmul_int8_reference(lhs, w.q, w.scale,
                                                        sizes)

            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            err, r = rel(f"{name} r_pad {plan.r_pad}", out, ref)
            total = int(sizes.sum())
            if not bool((out[total:] == 0).all()):
                raise AssertionError(f"{name}: rows past the groups not 0")
            del out, ref
            nbytes = (touched * k * n + touched * n * 4 + live * k * 2
                      + plan.r_pad * n * 2)
            ops = 2 * live * k * n
            wb = md._int8_flat(w.q, w.scale)[0].to(torch.bfloat16)
            library_ms, refused = library_grouped_mm(torch, lhs, wb, offs,
                                                     False)
            del wb
            row = dict(
                max_abs_err=err, rel_err=r, ms=time_ms(kernel),
                plain_ms=time_ms(plain, warmup=1, iters=3),
                library_ms=library_ms, library_refusals=refused,
                shape=(f"T {t}, tile {plan.tile_rows}, r_pad {plan.r_pad}, "
                       f"live rows {live}, experts touched {touched}, K {k},"
                       f" N {n}, tensor shard 0 of {tp}"),
                plan=md.int8_gmm_launch(lhs, w.q, w.scale,
                                        sizes).plan._asdict(),
                **bound_fields(name, nbytes, ops, BF16_FLOPS))
            if not tag:
                row["graph_ms"] = graph_ms(torch, kernel)
            rows[name] = row
            torch.cuda.empty_cache()
    # Ragged groups: an empty group, rows past the last one.
    plan, xs, act, gu_blk, _ = int8_grouped_inputs(
        torch, qlayer, cfg, dev, RAGGED_ROWS // 2, tp, SEED + 62)
    rsizes = torch.tensor(RAGGED_SIZES, dtype=torch.int32, device=dev)
    total = sum(RAGGED_SIZES)
    lhs = xs[:RAGGED_ROWS].contiguous()
    out = md.grouped_matmul_int8(lhs, gu_blk.q, gu_blk.scale, rsizes)
    ref = md.grouped_matmul_int8_reference(lhs, gu_blk.q, gu_blk.scale,
                                           rsizes)
    torch.cuda.synchronize()
    rel("grouped_matmul_int8 ragged groups", out, ref)
    if not bool((out[total:] == 0).all()):
        raise AssertionError("grouped_matmul_int8: rows past ragged groups "
                             "not 0")
    rows["grouped_matmul_int8_gateup"]["ragged"] = dict(
        rows=RAGGED_ROWS, sizes=list(RAGGED_SIZES),
        plan=md.int8_gmm_launch(lhs, gu_blk.q, gu_blk.scale,
                                rsizes).plan._asdict())
    log("grouped_matmul_int8:", json.dumps(rows))
    return rows


def megatron_serving(torch, dev, serve_twice, kept, phase4) -> dict:
    """Phase 34 (see the module docstring). Returns the phase's record."""
    from k8s_dra_driver_tpu_torch.models import PRESETS, init_params, llama

    t0 = time.perf_counter()
    cfg = PRESETS["8b"]
    params = init_params(cfg, seed=SEED, device=dev)
    mesh = card_mesh(dev, **TP_SERVE_MESH)
    sharded = shard_in_place(torch, params, mesh, llama.param_specs(cfg))
    log(f"phase 34: {mesh}, weights placed in place "
        f"({time.perf_counter() - t0:.1f}s)")
    logits = mesh_logits_rel(torch, params, sharded, cfg, dev, mesh)
    served = serve_twice("megatron_serving", "megatron engine", sharded,
                         cfg, mesh=mesh, whole=params)
    mine = kept["megatron_serving"]
    flips = hold_streams(torch, "megatron engine", mine["streams"],
                         kept["serving"]["streams"], mine["prompt_lens"],
                         params, cfg, dev, False, FLIP_MARGIN_LIMIT)
    profile = profile_decode(torch, sharded, cfg, dev, mesh=mesh,
                             eager=False)
    base = phase4["decode_profile"]
    served.update(
        mesh=str(mesh), logits=logits, phase4_stream_flips=flips,
        streams_equal_phase4=len(mine["streams"]) - len(flips),
        decode_profile=profile,
        phase4={k: phase4[k] for k in ("decode_step_p50_ms", "ttft_p50_ms",
                                       "tokens_per_s")},
        phase4_captured_device_ms=base["captured_device_ms"])
    log(f"megatron serving: {mesh}; decode p50 "
        f"{served['decode_step_p50_ms']:.3f} ms (phase 4: "
        f"{phase4['decode_step_p50_ms']:.3f}), TTFT p50 "
        f"{served['ttft_p50_ms']:.2f} ms ({phase4['ttft_p50_ms']:.2f}), "
        f"captured decode step {profile['captured_device_ms']:.3f} device "
        f"ms ({base['captured_device_ms']:.3f}); logits rel "
        f"{json.dumps(logits)}; {served['streams_equal_phase4']} of 8 "
        f"streams equal phase 4's; {card_line()}")
    del sharded, params
    gc.collect()
    torch.cuda.empty_cache()
    return served


def megatron_int8_moe(torch, dev, qcfg, drive, kept, phase15) -> tuple:
    """Phase 35 (see the module docstring). Returns (the kernel's rows,
    the phase's record)."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.quant import quantize_specs

    t0 = time.perf_counter()
    tp = TP_MOE_MESH["tensor"]
    qparams = int8_moe_params(torch, qcfg, dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    mesh = card_mesh(dev, **TP_MOE_MESH)
    sharded = shard_in_place(torch, qparams, mesh,
                             quantize_specs(moe.param_specs(qcfg)))
    log(f"phase 35: {mesh}, int8 weights {weights / 1e9:.1f} GB placed in "
        f"place ({time.perf_counter() - t0:.1f}s)")
    rows = check_grouped_int8(torch, qparams, qcfg, dev, tp)
    logits = mesh_logits_rel(torch, qparams, sharded, dataclasses.replace(
        qcfg, moe_impl="dropless"), dev, mesh, True)
    log(f"megatron int8 moe: logits against the single device, routing "
        f"replayed {json.dumps(logits)}")
    served = drive("megatron_int8", serve, torch, sharded, qcfg, dev, True,
                   True, None, None, mesh)
    if served["moe_impl"] != {"decode_step": "dropless",
                              "prefill_chunk": "dropless"}:
        raise AssertionError(f"tensor-mesh int8 MoE impl "
                             f"{served['moe_impl']}")
    streams, lens = served.pop("_streams"), served.pop("_prompt_lens")
    for key in [k for k in served if k.startswith("_")]:
        del served[key]
    single = kept["moe_serving_int8"]["streams"]
    flips = stream_flips(torch, streams, single, lens, ("mesh", "single"),
                         qparams, qcfg, dev, True)
    log(f"megatron int8 moe engine: stream flips against the single device "
        f"{json.dumps(flips)}")
    explained = explain_mesh_flips(torch, qparams, sharded, qcfg, dev, mesh,
                                   flips, single, lens, True)
    log(f"megatron int8 moe engine: flips beyond a logit near-tie explained "
        f"by routing near-ties {json.dumps(explained)}")
    profile = profile_decode(torch, sharded, qcfg, dev, quantize_cache=True,
                             mesh=mesh, eager=False)
    # The only int8 -> float copies a decode step may make are the
    # embedding's gathered rows, one per tensor shard's vocabulary block:
    # no weight is converted.
    copies = profile["int8_to_float_copies"]
    weight_copies = [c for c in copies if c > BATCH_SLOTS * qcfg.hidden]
    if weight_copies or len(copies) > tp:
        raise AssertionError(f"tensor-mesh decode step int8 -> float copies "
                             f"{copies}; expected the embedding rows only")
    served.update(
        mesh=str(mesh), weights_gb=weights / 1e9, logits=logits,
        peak_above_weights_gb=served["peak_mem_gb"] - weights / 1e9,
        phase15_stream_flips=flips,
        routing_explained_flips=len(explained),
        streams_equal_phase15=len(streams) - len(flips),
        int8_to_float_copies=copies, int8_weight_copies=len(weight_copies),
        decode_profile=profile,
        phase15={k: phase15[k] for k in ("decode_step_p50_ms",
                                         "ttft_p50_ms", "tokens_per_s",
                                         "peak_mem_gb")})
    log(f"megatron int8 moe: {mesh}; decode p50 "
        f"{served['decode_step_p50_ms']:.3f} ms (phase 15: "
        f"{phase15['decode_step_p50_ms']:.3f}), TTFT p50 "
        f"{served['ttft_p50_ms']:.2f} ms ({phase15['ttft_p50_ms']:.2f}), "
        f"peak {served['peak_mem_gb']:.2f} GB, "
        f"{served['peak_above_weights_gb']:.2f} GB above the weights; "
        f"int8 -> float copies {copies}; {served['streams_equal_phase15']} "
        f"of 8 streams equal phase 15's; captured decode step "
        f"{profile['captured_device_ms']:.3f} device ms; {card_line()}")
    del sharded, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return rows, served


def megatron_compare_train(torch, cfg, dev, mesh, batch=TRAIN_BATCH,
                           seq=TRAIN_SEQ, use_ring=False) -> dict:
    """Phase 36's hold: one loss and every gradient leaf of 8b-L8 at 8 x
    2048 (remat "full") on ``mesh`` against the single device's, the same
    seeded state and tokens as ``train``'s (phase 37's: ``batch`` x
    ``seq`` with ``use_ring``)."""
    from k8s_dra_driver_tpu_torch.models import llama
    from k8s_dra_driver_tpu_torch.models.train import leaves

    params = llama.init_params(cfg, seed=SEED, device=dev)
    names = param_names(params)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev)
    runs = []
    for m in (None, mesh):
        loss = llama.loss_fn(params, tokens, cfg, remat=True, mesh=m,
                             use_ring=use_ring and m is not None)
        grads = torch.autograd.grad(loss, flat)
        runs.append((loss.item(), [g.cpu() for g in grads]))
        del loss, grads
        torch.cuda.empty_cache()
    (l_single, g_single), (l_mesh, g_mesh) = runs
    loss_rel, grad_rel = loss_grad_rel(names, (l_mesh, g_mesh),
                                       (l_single, g_single))
    hold_loss_grads("mesh vs single device", loss_rel, grad_rel)
    del params, flat
    torch.cuda.empty_cache()
    return dict(loss_single=l_single, loss_mesh=l_mesh,
                loss_rel_diff=loss_rel, grad_rel_diff=grad_rel)


def megatron_train_launches(layers: int, groups: int, tp: int) -> dict:
    """A mesh train step's launches under remat "full": K4 twice a layer
    per (group, tensor shard) (forward and recompute), K5 and K6 once; K1
    at both norms of a layer twice and the final norm once per group, its
    gradient at each once."""
    shards = groups * tp
    return {"flash_fwd": 2 * layers * shards,
            "flash_bwd_dkdv": layers * shards,
            "flash_bwd_dq": layers * shards,
            "rmsnorm": (4 * layers + 1) * groups,
            "rmsnorm_backward": (2 * layers + 1) * groups}


# ---------------------------------------------------------------------------
# Phase 37: the sequence axis at full width -- ring attention over K4-K6 per
# hop and Ulysses (parallel/ring.py), 8b-L8 trained on sequence 4 x tensor 2
# of the one card.
# ---------------------------------------------------------------------------

SEQ_MESH = dict(sequence=4, tensor=2)
SEQ_BATCH = 2
SEQ_LEN = 8192
SEQ_STEPS = 3               # timed, after the warm-up step
SEQ_GRAD_REL = 5e-2         # dq/dk/dv through autograd against one device


def hop_rings(torch, gen, dev, specs, n):
    """Rings of ``n`` shard buffers, one per (shape, dtype) of ``specs``."""
    return [ring_inputs(torch, gen, dev, n, shape, dtype)
            for shape, dtype in specs]


def time_hop(torch, name, rings) -> dict:
    """One grouped K9 launch of ``rings`` (``ring_permute_group``) timed
    beside its plain version and ``torch._foreach_copy_`` of the same
    bytes, with the bytes bound (every byte read and written once)."""
    from k8s_dra_driver_tpu_torch.parallel import ring

    n = len(rings[0])
    moved = 2 * sum(x.numel() * x.element_size() for r in rings for x in r)
    dst = [torch.empty_like(x) for r in rings for x in r]
    rotated = [r[(j - 1) % n] for r in rings for j in range(n)]
    out = ring.ring_permute_group(rings, 1)
    ref = ring.ring_permute_many_reference(rings, 1)
    if not all(same_bytes(torch, o, r) for o, r in zip(out, ref)):
        raise AssertionError(f"{name}: K9 differs from its plain version")
    row = dict(
        ms=time_ms(lambda: ring.ring_permute_group(rings, 1)),
        plain_ms=time_ms(lambda: ring.ring_permute_many_reference(rings, 1)),
        library_ms=time_ms(lambda: torch._foreach_copy_(dst, rotated)),
        max_abs_err=0.0, pairs=sum(len(r) for r in rings),
        shape=" + ".join(f"{n} shards of {list(r[0].shape)} {r[0].dtype}"
                         for r in rings) + " on one card, one launch",
        **bound_fields(name, moved, 0.0, BF16_FLOPS))
    row["gb_per_s"] = moved / row["ms"] / 1e6
    log(f"{name}: {row['shape']}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f}, foreach_copy {row['library_ms']:.4f}, bound "
        f"{row['bound_ms']:.4f}")
    return row


def grad_rel(torch, got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def check_sequence_attention(torch, cfg, dev, mesh) -> dict:
    """Phase 37 (b): ``ring_attention`` and ``ulysses_attention`` on
    ``mesh`` at q [2, 32, 8192, 128], k/v [2, 8, 8192, 128] (bf16, causal)
    against one ``flash_attention`` call over the whole sequence: the
    output within phase 2's bf16 gates, dq/dk/dv through autograd within
    SEQ_GRAD_REL (relative norm). Each timed forward and backward beside
    the single call's."""
    from k8s_dra_driver_tpu_torch.ops.attention import flash_attention
    from k8s_dra_driver_tpu_torch.parallel import (
        ring_attention,
        ulysses_attention,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 37)
    b, s, d = SEQ_BATCH, SEQ_LEN, cfg.head_dim

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    base = (rand(b, cfg.n_heads, s, d), rand(b, cfg.n_kv_heads, s, d),
            rand(b, cfg.n_kv_heads, s, d))
    do = rand(b, cfg.n_heads, s, d)
    fns = {"single": flash_attention,
           "ring": lambda q, k, v: ring_attention(q, k, v, mesh),
           "ulysses": lambda q, k, v: ulysses_attention(q, k, v, mesh)}
    runs, out = {}, {}
    for name, fn in fns.items():
        leaves = [x.clone().requires_grad_() for x in base]
        o = fn(*leaves)
        grads = torch.autograd.grad(o, leaves, do)
        runs[name] = (o.detach(), grads)

        def step(fn=fn):
            ls = [x.detach().requires_grad_() for x in base]
            torch.autograd.grad(fn(*ls), ls, do)
        out[name] = dict(fwd_bwd_ms=time_ms(step, warmup=1, iters=3))
    ref_o, ref_g = runs.pop("single")
    for name, (o, grads) in runs.items():
        err, r = rel(f"{name} attention out", o, ref_o)
        out[name].update(max_abs_err=err, rel_err=r)
        for g_name, g, want in zip(("dq", "dk", "dv"), grads, ref_g):
            out[name][f"{g_name}_rel_diff"] = grad_rel(torch, g, want)
        bad = {k: v for k, v in out[name].items()
               if k.endswith("_rel_diff") and not v <= SEQ_GRAD_REL}
        if bad:
            raise AssertionError(f"{name} attention gradients against one "
                                 f"device over {SEQ_GRAD_REL}: {bad}")
    log("sequence attention:", json.dumps(out))
    return out


def sequence_train_launches(layers: int, n: int, groups: int,
                            tp: int) -> dict:
    """A ring train step's launches under remat "full" on sequence ``n``
    x tensor ``tp`` (all on one card): per layer and ring (group, tensor
    shard) K4 on the n(n+1)/2 hops the causal mask leaves visible, twice
    (forward and recompute), K5 and K6 once on the same hops; K9 per
    layer and group n - 1 grouped launches forward, again in the
    recompute, and n backward (k, v and both carriers, then the carriers'
    last hop home); K1 at both norms of each token block twice and the
    final norm once a block, its gradient at each once."""
    pairs = n * (n + 1) // 2
    rings = groups * tp
    blocks = groups * n
    return {"flash_fwd": 2 * layers * rings * pairs,
            "flash_bwd_dkdv": layers * rings * pairs,
            "flash_bwd_dq": layers * rings * pairs,
            "ring_permute": layers * groups * (3 * n - 2),
            "rmsnorm": (4 * layers + 1) * blocks,
            "rmsnorm_backward": (2 * layers + 1) * blocks}


# ---------------------------------------------------------------------------
# Phase 38: the pipe axis at full width (parallel/pipeline.py): 8b-L8 on
# pipe 2 x data 2 x tensor 2, then 8x7b cut to 2 layers on data 2 x expert 2
# x pipe 2, the stage-to-stage hops through K9.
# ---------------------------------------------------------------------------

PIPE_MESH = dict(pipe=2, data=2, tensor=2)
PIPE_MICRO = 4
PIPE_STEPS = 3              # timed forward + backward, after a warm-up
PIPE_MOE_MESH = dict(data=2, expert=2, pipe=2)
PIPE_MOE_LAYERS = 2
PIPE_MOE_BATCH = 4
PIPE_MOE_SEQ = 512
PIPE_MOE_MICRO = 2
PIPE_LOGITS_REL = 5e-2
PIPE_AUX_REL = 1e-2         # against the microbatches' aux on one device


def pipe_train_launches(layers: int, stages: int, micro: int, groups: int,
                        tp: int, remat: bool = True) -> dict:
    """A pipelined forward + backward's launches (all on one card): each
    layer runs once per (group, microbatch) on its stage, K4 per tensor
    shard (twice under remat "full"), K5 and K6 once; K1 at both norms
    of a layer per (group, microbatch) (twice under remat) and the final
    norm once, outside the pipeline; K9 once a hop, M + P - 2 hops
    forward and their inverses backward."""
    slots = groups * micro
    runs = 2 if remat else 1
    return {"flash_fwd": runs * layers * slots * tp,
            "flash_bwd_dkdv": layers * slots * tp,
            "flash_bwd_dq": layers * slots * tp,
            "rmsnorm": 2 * runs * layers * slots + 1,
            "rmsnorm_backward": 2 * layers * slots + 1,
            "ring_permute": 2 * (micro + stages - 2)}


def pipe_tokens(torch, cfg, dev, batch: int, seq: int):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                         device=dev)


def pipe_loss(torch, params, tokens, cfg, mesh):
    """The dense loss: the single device's ``loss_fn`` (remat "full"), or
    ``forward_pipelined(..., return_hidden=True)`` over ``mesh`` (each
    stage's layers under remat "full") then the chunked CE."""
    from k8s_dra_driver_tpu_torch.models import llama

    if mesh is None:
        return llama.loss_fn(params, tokens, cfg, remat=True)
    hidden = llama.forward_pipelined(params, tokens[:, :-1], cfg, mesh,
                                     PIPE_MICRO, return_hidden=True,
                                     remat=True)
    return llama.chunked_cross_entropy(hidden, params["lm_head"],
                                       tokens[:, 1:])


def pipe_compare(torch, cfg, dev, mesh) -> dict:
    """Phase 38's dense hold: one loss and every gradient leaf of the
    pipelined 8b-L8 against the single device's, the same seeded weights
    and tokens (phase 36's limits)."""
    from k8s_dra_driver_tpu_torch.models import llama
    from k8s_dra_driver_tpu_torch.models.train import leaves

    params = llama.init_params(cfg, seed=SEED, device=dev)
    names = param_names(params)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    tokens = pipe_tokens(torch, cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    runs = []
    for m in (None, mesh):
        loss = pipe_loss(torch, params, tokens, cfg, m)
        grads = torch.autograd.grad(loss, flat)
        runs.append((loss.item(), [g.cpu() for g in grads]))
        del loss, grads
        torch.cuda.empty_cache()
    (l_single, g_single), (l_pipe, g_pipe) = runs
    loss_rel, grad_rel_ = loss_grad_rel(names, (l_pipe, g_pipe),
                                        (l_single, g_single))
    hold_loss_grads("pipeline vs single device", loss_rel, grad_rel_)
    del params, flat
    torch.cuda.empty_cache()
    return dict(loss_single=l_single, loss_pipe=l_pipe,
                loss_rel_diff=loss_rel, grad_rel_diff=grad_rel_)


def pipe_steps(torch, cfg, dev, mesh) -> dict:
    """Phase 38's timing: a warm-up and PIPE_STEPS timed forward +
    backward steps of the dense loss (``pipe_loss``) at TRAIN_BATCH x
    TRAIN_SEQ on ``mesh`` or the single device (None): step p50,
    tokens/s, MFU and the steps' peak memory."""
    from k8s_dra_driver_tpu_torch.models import llama
    from k8s_dra_driver_tpu_torch.models.train import leaves

    gc.collect()
    torch.cuda.empty_cache()
    params = llama.init_params(cfg, seed=SEED, device=dev)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    tokens = pipe_tokens(torch, cfg, dev, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(1 + PIPE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = pipe_loss(torch, params, tokens, cfg, mesh)
        grads = torch.autograd.grad(loss, flat)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del loss, grads
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    step_s = statistics.median(times[1:])
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    out = dict(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, remat="full", losses=losses,
        warmup_step_ms=times[0] * 1e3, step_ms=[t * 1e3 for t in times[1:]],
        step_ms_p50=step_s * 1e3, tokens_per_s=tokens_per_step / step_s,
        mfu=cfg.flops_per_token(TRAIN_SEQ) * tokens_per_step / step_s
        / BF16_FLOPS,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, flat
    gc.collect()
    torch.cuda.empty_cache()
    return out


class PipelineReplay(RoutingReplay):
    """Replays a pipelined forward's recorded routing in single-device
    forwards: ``order`` names each recorded call's (layer, row block) in
    the pipeline's call order, ``calls`` each replaying call's (layer, row
    blocks) in the replaying runs' order; a call takes its blocks'
    recorded choices concatenated."""

    def __init__(self, moe, recorded, order, calls):
        super().__init__(moe)
        import torch

        by = dict(zip(order, recorded))
        self.recorded = [torch.cat([by[layer, b] for b in blocks])
                         for layer, blocks in calls]


def pipeline_call_order(layers: int, stages: int, micro: int,
                        groups: int) -> list:
    """(layer, row block) of each MoE block call of the pipelined forward,
    in call order: step t, group g, stage p (microbatch t - p), the
    stage's layers; row block g * micro + j."""
    per = layers // stages
    order = []
    for t in range(micro + stages - 1):
        for g in range(groups):
            for p in range(stages):
                j = t - p
                if 0 <= j < micro:
                    order += [(p * per + i, g * micro + j)
                              for i in range(per)]
    return order


def pipe_moe_run(torch, dev, mesh) -> dict:
    """Phase 38's MoE half, the counted run: Mixtral-8x7B widths cut to
    PIPE_MOE_LAYERS layers (einsum) pipelined on ``mesh`` at
    PIPE_MOE_BATCH x PIPE_MOE_SEQ in PIPE_MOE_MICRO microbatches, its
    routing recorded, then one backward: every gradient finite and
    ``w_gateup``'s nonzero. Returns what ``pipe_moe_check`` holds."""
    from k8s_dra_driver_tpu_torch.models import MOE_PRESETS, llama, moe
    from k8s_dra_driver_tpu_torch.models.train import leaves

    cfg = dataclasses.replace(MOE_PRESETS["8x7b"], n_layers=PIPE_MOE_LAYERS,
                              moe_impl="einsum")
    params = moe.init_params(cfg, seed=SEED, device=dev)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    tokens = pipe_tokens(torch, cfg, dev, PIPE_MOE_BATCH, PIPE_MOE_SEQ)
    with RoutingReplay(moe) as record:
        record.mode = "record"
        hidden, aux = moe.forward_pipelined(
            params, tokens[:, :-1], cfg, mesh, PIPE_MOE_MICRO,
            return_hidden=True)
    loss = (llama.chunked_cross_entropy(hidden, params["lm_head"],
                                        tokens[:, 1:]) + cfg.aux_coef * aux)
    grads = torch.autograd.grad(loss, flat)
    names = param_names(params)
    bad = [n for n, g in zip(names, grads) if not torch.isfinite(g).all()]
    if bad:
        raise AssertionError(f"pipelined MoE gradients not finite: {bad}")
    gu = grads[names.index("layers/w_gateup")].float().abs().sum().item()
    if not gu > 0:
        raise AssertionError("pipelined MoE: w_gateup's gradient is zero")
    for p in flat:
        p.requires_grad_(False)
    return dict(cfg=cfg, params=params, tokens=tokens,
                hidden=hidden.detach(), aux=aux.item(),
                recorded=record.recorded, w_gateup_grad_abs_sum=gu)


def pipe_moe_check(torch, run: dict, mesh) -> dict:
    """Phase 38's MoE holds, outside the counted run: the pipelined logits
    against the single device's einsum forward replaying the pipeline's
    routing (within PIPE_LOGITS_REL of the largest magnitude; the single
    device's own choices may differ only at near-ties). The aux is the
    reference's pipelined one, a mean of per-(batch group, microbatch)
    statistics: it is held within PIPE_AUX_REL of the single device's
    forwards of the same row blocks, routing replayed, and its distance
    from the whole batch's aux is reported."""
    from k8s_dra_driver_tpu_torch.models import moe

    cfg, params, tokens = run["cfg"], run["params"], run["tokens"]
    blocks = PIPE_MOE_MESH["data"] * PIPE_MOE_MICRO
    rows = PIPE_MOE_BATCH // blocks
    layers = range(cfg.n_layers)
    calls = [(l, tuple(range(blocks))) for l in layers] + [
        (l, (b,)) for b in range(blocks) for l in layers]
    with torch.no_grad():
        logits = (run["hidden"] @ params["lm_head"]).float()
        single, aux_single = moe.forward(params, tokens[:, :-1], cfg)
        order = pipeline_call_order(cfg.n_layers, PIPE_MOE_MESH["pipe"],
                                    PIPE_MOE_MICRO, PIPE_MOE_MESH["data"])
        with PipelineReplay(moe, run["recorded"], order, calls) as replay:
            replay.mode = "replay"
            replayed, _ = moe.forward(params, tokens[:, :-1], cfg)
            aux_blocks = [moe.forward(params, tokens[b * rows:(b + 1) * rows,
                                                     :-1], cfg)[1].item()
                          for b in range(blocks)]
    aux_micro = sum(aux_blocks) / blocks
    logits_rel = ((logits - replayed).abs().max().item()
                  / replayed.abs().max().item())
    free_rel = ((logits - single).abs().max().item()
                / single.abs().max().item())
    aux_rel = abs(run["aux"] - aux_micro) / aux_micro
    out = dict(preset="8x7b", layers=cfg.n_layers, batch=PIPE_MOE_BATCH,
               seq=PIPE_MOE_SEQ, microbatches=PIPE_MOE_MICRO,
               mesh=str(mesh), logits_rel_replayed=logits_rel,
               logits_rel_free=free_rel, aux=run["aux"],
               aux_microbatches_single=aux_micro, aux_rel=aux_rel,
               aux_whole_batch_single=aux_single.item(),
               aux_rel_whole_batch=abs(run["aux"] - aux_single.item())
               / aux_single.item(),
               w_gateup_grad_abs_sum=run["w_gateup_grad_abs_sum"],
               **replay.summary())
    del out["flip_margins"]
    log("pipeline moe:", json.dumps(out))
    if not logits_rel <= PIPE_LOGITS_REL:
        raise AssertionError(f"pipelined MoE logits {logits_rel} of the "
                             f"largest (limit {PIPE_LOGITS_REL})")
    if not aux_rel <= PIPE_AUX_REL:
        raise AssertionError(f"pipelined MoE aux {run['aux']} against the "
                             f"microbatches' {aux_micro} on one device "
                             f"(limit {PIPE_AUX_REL})")
    replay.check("pipelined MoE")
    return out


# ---------------------------------------------------------------------------
# Phase 39: elastic training. The port's Driver over a fake 4-chip node
# resizes a gang claim; ElasticTrainer reshards 8b-L8 live across the shrink
# and the grow on members that all share the card; a 2-layer cut of it takes
# the cold path through a checkpoint.
# ---------------------------------------------------------------------------

ELASTIC_MESH = dict(data=2, tensor=2)
ELASTIC_SURVIVOR_MESH = dict(tensor=2)   # what a 3-member gang keeps
ELASTIC_COLD_MESH = dict(fsdp=4)
ELASTIC_STEPS = 7              # the uninterrupted run; the elastic run's too
ELASTIC_UNPLUG_AT = 4          # the train.step call at whose top a chip goes
ELASTIC_GROW_STEPS = 2         # finite steps after the grow
ELASTIC_COLD_STEPS = 2         # steps before the cold path's save
ELASTIC_LOSS_REL = 1e-2        # phase 36's loss limit (bf16 on the card)
ELASTIC_CHAOS_SEED = 1234      # the chaos harness's default seed: an end
ELASTIC_NODE = "node-a"        # chip of the gang goes, 3 stay contiguous
ELASTIC_CLAIM = "train"


def elastic_tokens(torch, cfg, dev, n: int) -> list:
    """``n`` batches of TRAIN_BATCH x (TRAIN_SEQ + 1) tokens from the
    seed, one a step."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 39)
    return [torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                          generator=gen, device=dev) for _ in range(n)]


def leaf_sums(torch, state) -> list:
    """Per tensor of a train state (params, both moments): its storage
    address and the sum of its bits as int64 -- equal sums at one address
    before and after a resize mean no byte of it moved or changed."""
    from k8s_dra_driver_tpu_torch.models.train import leaves

    out = []
    for t in (leaves(state.params) + leaves(state.opt_state.mu)
              + leaves(state.opt_state.nu)):
        bits = {2: torch.int16, 4: torch.int32}[t.element_size()]
        out.append((t.data_ptr(), t.detach().view(bits).sum(
            dtype=torch.int64).item()))
    return out


def train_state_gb(state) -> float:
    """GB of a train state's tensors: params and both moments."""
    from k8s_dra_driver_tpu_torch.models.train import leaves

    return sum(t.numel() * t.element_size() for t in (
        leaves(state.params) + leaves(state.opt_state.mu)
        + leaves(state.opt_state.nu))) / 1e9


def elastic_trainer(cfg, dev, members, axes, **kw):
    """``ElasticTrainer`` on ``cfg`` over ``members``, every member of the
    node (``tpu-0`` .. ``tpu-3``) on the card; AdamW as phase 6's, the
    init from the seed."""
    from k8s_dra_driver_tpu_torch.models import make_optimizer
    from k8s_dra_driver_tpu_torch.parallel import MeshConfig
    from k8s_dra_driver_tpu_torch.parallel.elastic import ElasticTrainer

    return ElasticTrainer(
        cfg, make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100),
        list(members), mesh_config=MeshConfig(**axes),
        global_batch=TRAIN_BATCH, seed=SEED,
        device_of={f"tpu-{i}": dev for i in range(4)}, **kw)


def elastic_reference(torch, cfg, dev) -> dict:
    """Phase 39's uninterrupted run, outside the counted run: ELASTIC_STEPS
    steps on the surviving topology (tensor 2 over two members of the
    card) from the elastic run's init and tokens; its losses, step times
    and initial bits. The state is freed before the elastic trainer is
    built: an 8b-L8 state takes about 20 GB."""
    trainer = elastic_trainer(cfg, dev, ("tpu-0", "tpu-1"),
                              ELASTIC_SURVIVOR_MESH)
    init = [s for _, s in leaf_sums(torch, trainer.state)]
    losses, times = [], []
    for tokens in elastic_tokens(torch, cfg, dev, ELASTIC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.step(tokens))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=[t * 1e3 for t in times],
                step_ms_p50=statistics.median(times[1:]) * 1e3,
                init_bit_sums=init)


def elastic_node(root: Path) -> tuple:
    """The plugin half: the port's Driver over a ``FakeChipLib`` v5p
    4x1x1 node (one card cannot make a 4-chip gang) with elastic resizes
    armed, a ``FakeKubeClient`` holding the node, state under ``root``;
    started, its slice published. (driver, client, lib, allocator)."""
    from k8s_dra_driver_tpu_torch.kube import (
        NODES,
        RESOURCE_SLICES,
        FakeKubeClient,
    )
    from k8s_dra_driver_tpu_torch.kube.allocator import ReferenceAllocator
    from k8s_dra_driver_tpu_torch.plugin.driver import Driver, DriverConfig
    from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    shutil.rmtree(root, ignore_errors=True)
    (root / "driver").mkdir(parents=True)
    client = FakeKubeClient()
    client.create(NODES, {"metadata": {"name": ELASTIC_NODE,
                                       "uid": "node-uid"}})
    lib = FakeChipLib(generation="v5p", topology="4x1x1")
    driver = Driver(DriverConfig(
        node_name=ELASTIC_NODE, chiplib=lib, kube_client=client,
        cdi_root=str(root / "cdi"), plugin_root=str(root / "plugin"),
        registrar_root=str(root / "registry"),
        state_root=str(root / "state"), node_uid="node-uid",
        driver_root=str(root / "driver"),
        driver_root_ctr_path=str(root / "driver"),
        cleanup_interval_seconds=0, device_watch_interval_seconds=0,
        audit_interval_seconds=0))
    allocator = ReferenceAllocator(client, registry=Registry())
    driver.enable_elastic(allocator)
    driver.start()
    deadline = time.monotonic() + 30
    while not client.list(RESOURCE_SLICES) and time.monotonic() < deadline:
        time.sleep(0.02)
    if not client.list(RESOURCE_SLICES):
        raise AssertionError("elastic: the Driver published no slice")
    return driver, client, lib, allocator


def elastic_gang(driver, client, allocator) -> list:
    """A 4-device gang claim, allocated by the allocator and prepared
    through the transport as a kubelet would; its device names in
    allocation order."""
    from k8s_dra_driver_tpu_torch.kube import RESOURCE_CLAIMS
    from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb

    claim = {
        "apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
        "metadata": {"name": ELASTIC_CLAIM, "namespace": "default",
                     "uid": "uid-gang"},
        "spec": {"devices": {"requests": [{
            "name": "workers", "deviceClassName": DRA_DRIVER,
            "allocationMode": "ExactCount", "count": 4}]}},
    }
    allocator.allocate(claim, node_name=ELASTIC_NODE)
    client.create(RESOURCE_CLAIMS, claim, namespace="default")
    names = [r["device"] for r in
             claim["status"]["allocation"]["devices"]["results"]]
    reply, _ = kubelet_call(
        driver.config.transport, "/v1beta1.DRAPlugin/NodePrepareResources",
        drapb.NodePrepareResourcesRequest(claims=[drapb.Claim(
            namespace="default", uid="uid-gang", name=ELASTIC_CLAIM)]),
        drapb.NodePrepareResourcesResponse)
    got = reply.claims["uid-gang"]
    if got.error or sorted(d.device_name for d in got.devices) != \
            sorted(names):
        raise AssertionError(f"elastic: prepare of the gang: {got}")
    return names


def elastic_settle(driver, client, device: str, present: bool) -> None:
    """One health transition through the plugin: refresh, republish, and
    once the slice shows ``device`` as ``present``, a watch tick (its
    elastic re-solve reads the settled slice)."""
    from k8s_dra_driver_tpu_torch.kube import RESOURCE_SLICES

    driver.state.refresh_allocatable()
    driver.publish_resources()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        names = {d["name"] for sl in client.list(RESOURCE_SLICES)
                 for d in sl["spec"].get("devices") or []}
        if (device in names) == present:
            break
        time.sleep(0.02)
    else:
        raise AssertionError(f"elastic: {device} never "
                             f"{'returned to' if present else 'left'} the "
                             f"published slice")
    driver.tick_once()


def elastic_audit(driver) -> None:
    deadline = time.monotonic() + 30
    findings = driver.auditor.run_once()
    while findings and time.monotonic() < deadline:
        time.sleep(0.05)
        findings = driver.auditor.run_once()
    if findings:
        raise AssertionError(f"elastic: the auditor found {findings}")


def elastic_steps(torch, trainer, batches, read_counts, layers: int) -> tuple:
    """Steps ``trainer`` over ``batches``: (losses, host ms a step), each
    step's launches held to ``megatron_train_launches`` for the mesh it
    ran on."""
    losses, times = [], []
    for tokens in batches:
        mc = trainer.mesh_config
        want = megatron_train_launches(layers, mc.data * mc.fsdp, mc.tensor)
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.step(tokens))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        after = read_counts()
        got = {k: after[k] - before[k] for k in want}
        if got != want:
            raise AssertionError(f"elastic step {trainer.step_count} on "
                                 f"{mc}: launches {got}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"elastic: non-finite losses {losses}")
    return losses, times


def hold_elastic_event(event, **want) -> None:
    got = {k: getattr(event, k) for k in want}
    if got != want:
        raise AssertionError(f"elastic resize {event}: expected {want}")


def elastic_cold(torch, dev, cfg, members, read_counts) -> dict:
    """The cold path at phase 24's depth: ``cfg`` (8b-L8 cut to
    CKPT_LAYERS) on fsdp 4 over ``members``: ELASTIC_COLD_STEPS steps, a
    save, one step past it; then a resize onto two members, which no
    replica covers: the restore rewinds to the saved step, and the lost
    step's batch gives its loss again (ELASTIC_LOSS_REL)."""
    directory = ROOT / "build" / "elastic_ckpt"
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    trainer = elastic_trainer(cfg, dev, members, ELASTIC_COLD_MESH,
                              checkpoint_dir=str(directory))
    batches = elastic_tokens(torch, cfg, dev, ELASTIC_COLD_STEPS + 1)
    losses, _ = elastic_steps(torch, trainer, batches[:-1], read_counts,
                              cfg.n_layers)
    t0 = time.perf_counter()
    trainer.save()
    save_s = time.perf_counter() - t0
    (lost,), _ = elastic_steps(torch, trainer, batches[-1:], read_counts,
                               cfg.n_layers)
    event = trainer.resize(list(members[:2]), reason="two chips gone")
    hold_elastic_event(event, direction="shrink", path="cold", n_used=2,
                       n_idled=0, step=ELASTIC_COLD_STEPS,
                       old_mesh="fsdp=4", new_mesh="fsdp=2")
    if trainer.step_count != ELASTIC_COLD_STEPS or trainer.mesh.size != 2:
        raise AssertionError(f"elastic cold: step {trainer.step_count} on "
                             f"{trainer.mesh}")
    (again,), _ = elastic_steps(torch, trainer, batches[-1:], read_counts,
                                cfg.n_layers)
    rel_diff = abs(again - lost) / abs(lost)
    state_gb = train_state_gb(trainer.state)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(directory)
    out = dict(layers=cfg.n_layers, mesh_before="fsdp=4",
               mesh_after="fsdp=2", losses=losses, lost_step_loss=lost,
               replayed_loss=again, loss_rel_diff=rel_diff,
               save_s=save_s, state_gb=state_gb, event=event.to_dict())
    if not rel_diff <= ELASTIC_LOSS_REL:
        raise AssertionError(f"elastic cold: the replayed step's loss "
                             f"{again} against the lost one's {lost} "
                             f"(limit {ELASTIC_LOSS_REL})")
    return out


def elastic_run(torch, dev, cfg, ckpt_cfg, reference: dict,
                read_counts) -> dict:
    """Phase 39's counted run (module docstring): the gang on the fake
    node, the live shrink and grow of ``cfg`` on its members, then the
    cold path of ``ckpt_cfg``."""
    import random

    from k8s_dra_driver_tpu_torch.kube import EVENTS
    from k8s_dra_driver_tpu_torch.parallel import collectives
    from k8s_dra_driver_tpu_torch.utils import faults

    torch.cuda.reset_peak_memory_stats()
    driver, client, lib, allocator = elastic_node(
        ROOT / "build" / "dra" / "elastic")
    resizes = []
    driver.add_resize_listener(resizes.append)
    ledger = collectives.CollectiveLedger()
    try:
        names = elastic_gang(driver, client, allocator)
        trainer = elastic_trainer(cfg, dev, names, ELASTIC_MESH)
        init = [s for _, s in leaf_sums(torch, trainer.state)]
        if init != reference["init_bit_sums"]:
            raise AssertionError("elastic: the trainer's init differs from "
                                 "the uninterrupted run's")
        members = {m: str(d) for m, d in zip(trainer.members,
                                             trainer.devices)}
        batches = elastic_tokens(torch, cfg, dev, ELASTIC_STEPS)
        victim = names[random.Random(ELASTIC_CHAOS_SEED).randrange(
            len(names))]
        plan = faults.FaultPlan()
        plan.call("train.step",
                  lambda: lib.unplug_chip(int(victim.split("-")[1]),
                                          reason="chaos unplug"),
                  on_calls={ELASTIC_UNPLUG_AT})
        ledger.install()
        with faults.armed(plan):
            losses, before_ms = elastic_steps(
                torch, trainer, batches[:ELASTIC_UNPLUG_AT], read_counts,
                cfg.n_layers)
        elastic_settle(driver, client, victim, False)
        if len(resizes) != 1 or resizes[0].direction != "shrink" \
                or victim not in resizes[0].removed:
            raise AssertionError(f"elastic: resize messages {resizes}")
        msg = resizes[0]
        shrink = trainer.resize(list(msg.devices), reason=msg.reason)
        hold_elastic_event(shrink, direction="shrink", path="live",
                           n_used=2, n_idled=1, step=ELASTIC_UNPLUG_AT,
                           old_mesh="data=2xtensor=2", new_mesh="tensor=2")
        elastic_audit(driver)
        more, after_ms = elastic_steps(
            torch, trainer, batches[ELASTIC_UNPLUG_AT:], read_counts,
            cfg.n_layers)
        losses += more
        rel = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                   reference["losses"])]
        if not max(rel) <= ELASTIC_LOSS_REL:
            raise AssertionError(f"elastic: losses {losses} against the "
                                 f"uninterrupted {reference['losses']} "
                                 f"(limit {ELASTIC_LOSS_REL})")
        lib.restore_chip(int(victim.split("-")[1]))
        elastic_settle(driver, client, victim, True)
        if len(resizes) != 2 or resizes[1].direction != "grow" \
                or sorted(resizes[1].devices) != sorted(names):
            raise AssertionError(f"elastic: resize messages {resizes}")
        bits = leaf_sums(torch, trainer.state)
        grow = trainer.resize(list(resizes[1].devices),
                              reason=resizes[1].reason)
        hold_elastic_event(grow, direction="grow", path="live", n_used=4,
                           n_idled=0, step=ELASTIC_STEPS,
                           old_mesh="tensor=2", new_mesh="data=2xtensor=2")
        if leaf_sums(torch, trainer.state) != bits:
            raise AssertionError("elastic: a leaf moved or changed across "
                                 "the grow")
        elastic_audit(driver)
        grown, _ = elastic_steps(torch, trainer,
                                 batches[:ELASTIC_GROW_STEPS], read_counts,
                                 cfg.n_layers)
        ledger.uninstall()
        driver.events.flush()
        events = [e["reason"] for e in client.list(EVENTS)
                  if e["involvedObject"]["name"] == ELASTIC_CLAIM]
        counted = {d: driver._m_elastic_resizes.value(direction=d,
                                                      outcome="ok")
                   for d in ("shrink", "grow")}
        if "GangResized" not in events or counted != {"shrink": 1,
                                                      "grow": 1}:
            raise AssertionError(f"elastic: events {events}, resizes "
                                 f"{counted}")
        reshard = [r for r in ledger.snapshot()
                   if r["site"] == "train.reshard"]
        state_gb = train_state_gb(trainer.state)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        cold = elastic_cold(torch, dev, ckpt_cfg, names, read_counts)
    finally:
        ledger.uninstall()
        driver.shutdown()
    return dict(
        preset="8b-L8", batch=TRAIN_BATCH, seq=TRAIN_SEQ, members=members,
        victim=victim, messages=[m.to_dict() for m in resizes],
        losses=losses, uninterrupted_losses=reference["losses"],
        loss_rel_diff=rel, grow_losses=grown,
        shrink=shrink.to_dict(), grow=grow.to_dict(),
        live_shrink_s=shrink.duration_seconds,
        live_grow_s=grow.duration_seconds,
        cold_s=cold["event"]["duration_seconds"],
        step_ms_before=before_ms, step_ms_after=after_ms,
        step_ms_p50_before=statistics.median(before_ms[1:]),
        step_ms_p50_after=statistics.median(after_ms),
        uninterrupted_step_ms_p50=reference["step_ms_p50"],
        reshard_ledger=reshard, state_gb=state_gb,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        events=sorted(set(events)), resizes_ok=counted, cold=cold)


def elastic_bootstrap() -> dict:
    """``initialize_distributed()`` in this one process under a
    time-shared claim's envelope and no worker hostnames: the shim applies
    the envelope, no process group forms, and it returns False."""
    import torch.distributed as dist

    from k8s_dra_driver_tpu_torch.parallel import initialize_distributed
    from k8s_dra_driver_tpu_torch.parallel import shim

    keys = ("TPU_DRA_SHARING", "TPU_DRA_SHIM_APPLIED", "TPU_DRA_COORDINATOR",
            "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID")
    saved = {k: os.environ.pop(k) for k in keys if k in os.environ}
    active = shim._active
    os.environ["TPU_DRA_SHARING"] = "time-shared"
    try:
        formed = initialize_distributed()
        out = dict(returned=formed,
                   applied=os.environ.get("TPU_DRA_SHIM_APPLIED"),
                   mode=getattr(shim._active, "mode", None),
                   process_group=dist.is_available() and dist.is_initialized())
    finally:
        for k in keys:
            os.environ.pop(k, None)
        os.environ.update(saved)
        shim._active = active
    if out != dict(returned=False, applied="1", mode="time-shared",
                   process_group=False):
        raise AssertionError(f"elastic: initialize_distributed {out}")
    return out


# ---------------------------------------------------------------------------
# Phases 40-42: the expert axis beside tensor at full width (int8 Mixtral
# serving on expert 2 x tensor 2; 8x7b-L1 training on data 2 x expert 2 x
# tensor 2 and on expert 2 x sequence 2 x tensor 2 with ring attention),
# then the 8B in int8 through the pipeline on pipe 2 x tensor 2.
# ---------------------------------------------------------------------------

EPTP_SERVE_MESH = dict(expert=2, tensor=2)
EPTP_TRAIN_MESH = dict(data=2, expert=2, tensor=2)
EPSP_TRAIN_MESH = dict(expert=2, sequence=2, tensor=2)
EPSP_BATCH = 2
EPSP_SEQ = 4096
EPSP_LOSS_ABS = 5e-3        # the reference test's gate on the loss
EPSP_GRAD_REL = 5e-2
PIPE_INT8_MESH = dict(pipe=2, tensor=2)
PIPE_INT8_MICRO = 4
PIPE_INT8_BATCH = 8
PIPE_INT8_SEQ = 512


def check_int8_expert_blocks(torch, sharded, cfg, mesh) -> dict:
    """Phase 40: ``int8_matmul``'s prologue mode on the strided blocks that
    the einsum body hands it on ``mesh``: the last (expert shard, tensor
    shard) block of layer 0's placed stacks (``moe._expert_blocks``), each
    half of the gate/up block (its rows 2 M apart) and the down block (its
    experts M H apart), at the rows of the phase's prefill and of a decode
    step, against the plain version on contiguous copies at phase 16's
    limits. Timed beside the bound, the kernel on the contiguous copy, the
    plain version on the same inputs and a batched bf16 ``torch.matmul``
    on weights converted beforehand.
    Returns the kernels line's row: the prefill's three products summed,
    every call beside."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm
    from k8s_dra_driver_tpu_torch.ops._device import sm_count
    from k8s_dra_driver_tpu_torch.parallel.layout import Layout

    layer = {k: sharded["layers"][k][0] for k in ("w_gateup", "w_down")}
    gu, down = moe._expert_blocks(layer, cfg, Layout(mesh), 0)[-1][-1]
    dev = gu.q.device
    products = [(f"gate/up half {i}", gu.q[:, :, i], gu.scale[:, :, i])
                for i in (0, 1)] + [("down", down.q, down.scale)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 71)
    calls = {}
    for step, s in (("prefill", TP_LOGITS_PROMPT), ("decode", 1)):
        g = moe.effective_router_group(cfg, s)
        m = BATCH_SLOTS * (s // g) * moe._capacity(cfg, g)
        for what, q, scale in products:
            e, k, n = q.shape
            if q.is_contiguous():
                raise AssertionError(f"{what} block {tuple(q.stride())} is "
                                     f"contiguous; the mesh hands the "
                                     f"kernel a strided view")
            scale = scale.reshape(e, -1).contiguous()  # as _int8_experts
            qc = q.contiguous()
            x = torch.randn((e, m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            name = (f"{step} {what} [{e},{m},{k}] x [{e},{k},{n}] strides "
                    f"{tuple(q.stride())}")
            out = qm.int8_matmul(x, q, scale, True)
            ref = qm.int8_matmul_reference(x, qc, scale, True)
            torch.cuda.synchronize()
            err, r = rel(f"int8_matmul {name}", out, ref)
            del out, ref
            wb = (qc.float() * scale[:, None, :]).to(torch.bfloat16)
            calls[name] = dict(
                max_abs_err=err, rel_err=r,
                ms=time_ms(lambda: qm.int8_matmul(x, q, scale, True)),
                contiguous_ms=time_ms(
                    lambda: qm.int8_matmul(x, qc, scale, True)),
                plain_ms=time_ms(lambda: qm.int8_matmul_reference(
                    x, q, scale, True), warmup=1, iters=5),
                library_ms=time_ms(lambda: torch.matmul(x, wb)),
                plan=qm.plan(e, m, n, k, sm_count(dev))._asdict(),
                **bound_fields(f"int8_matmul {name}",
                               e * (k * n + 4 * n + 2 * m * k + 2 * m * n),
                               2 * e * m * k * n, BF16_FLOPS))
            del wb, qc
            torch.cuda.empty_cache()
    pre = [c for name, c in calls.items() if name.startswith("prefill")]
    row = dict(
        max_abs_err=max(c["max_abs_err"] for c in calls.values()),
        **{key: sum(c[key] for c in pre)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        bound_by="bytes" if all(c["bound_by"] == "bytes" for c in pre)
        else "operations",
        shape=(f"expert x tensor blocks of {mesh}: the prefill's gate and "
               f"up halves and down, strided views, prologue mode, summed "
               f"(max_abs_err over the decode step's too); library: "
               f"batched bf16 torch.matmul on weights converted "
               f"beforehand; launches: the int8_matmul_experts row's"),
        calls=calls)
    log("int8_matmul_experts_blocks:", json.dumps(row))
    return row


def ep_tp_serving(torch, dev, qcfg, drive, kept, phase15, phase35) -> dict:
    """Phase 40 (see the module docstring). Returns the phase's record."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.quant import quantize_specs

    t0 = time.perf_counter()
    qparams = int8_moe_params(torch, qcfg, dev)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    mesh = card_mesh(dev, **EPTP_SERVE_MESH)
    n_ep, tp = mesh.shape["expert"], mesh.shape["tensor"]
    sharded = shard_in_place(torch, qparams, mesh,
                             quantize_specs(moe.param_specs(qcfg)))
    log(f"phase 40: {mesh}, int8 weights {weights / 1e9:.2f} GB placed in "
        f"place ({time.perf_counter() - t0:.1f}s)")
    logits = {}
    for impl, replay in (("einsum", None),
                         ("dropless", functools.partial(EpRoutingReplay,
                                                        n_ep=n_ep))):
        logits[impl] = mesh_logits_rel(
            torch, qparams, sharded, dataclasses.replace(qcfg, moe_impl=impl),
            dev, mesh, True, replay)
    log(f"expert x tensor int8 moe: logits against the single device, "
        f"routing replayed {json.dumps(logits)}")
    served = drive("ep_tp_serving", serve, torch, sharded, qcfg, dev, True,
                   True, None, None, mesh)
    if served["moe_impl"] != {"decode_step": "einsum",
                              "prefill_chunk": "einsum"}:
        raise AssertionError(f"expert x tensor int8 MoE impl "
                             f"{served['moe_impl']}")
    streams = served.pop("_streams")
    for key in [k for k in served if k.startswith("_")]:
        del served[key]
    single = kept["moe_serving_int8"]["streams"]
    profile = profile_decode(torch, sharded, qcfg, dev, quantize_cache=True,
                             mesh=mesh, eager=False)
    # As in phase 35: no int8 weight is converted; the only int8 -> float
    # copies are the embedding's rows, one per tensor shard's vocabulary
    # block.
    copies = profile["int8_to_float_copies"]
    weight_copies = [c for c in copies if c > BATCH_SLOTS * qcfg.hidden]
    if weight_copies or len(copies) > tp:
        raise AssertionError(f"expert x tensor decode step int8 -> float "
                             f"copies {copies}; expected the embedding rows "
                             f"only")
    served.update(
        mesh=str(mesh), weights_gb=weights / 1e9, logits=logits,
        peak_above_weights_gb=served["peak_mem_gb"] - weights / 1e9,
        streams_equal_phase15=sum(a == b for a, b in zip(streams, single)),
        int8_to_float_copies=copies, decode_profile=profile,
        phase15={k: phase15[k] for k in ("decode_step_p50_ms",
                                         "ttft_p50_ms", "tokens_per_s",
                                         "peak_mem_gb")},
        phase15_captured_device_ms=phase15["decode_profile"][
            "captured_device_ms"],
        phase35={k: phase35[k] for k in ("decode_step_p50_ms",
                                         "ttft_p50_ms", "tokens_per_s",
                                         "peak_mem_gb")},
        phase35_captured_device_ms=phase35["decode_profile"][
            "captured_device_ms"])
    log(f"expert x tensor int8 moe: {mesh}; decode p50 "
        f"{served['decode_step_p50_ms']:.3f} ms (phase 15: "
        f"{phase15['decode_step_p50_ms']:.3f}, phase 35: "
        f"{phase35['decode_step_p50_ms']:.3f}), TTFT p50 "
        f"{served['ttft_p50_ms']:.2f} ms ({phase15['ttft_p50_ms']:.2f}, "
        f"{phase35['ttft_p50_ms']:.2f}), captured decode step "
        f"{profile['captured_device_ms']:.3f} device ms "
        f"({served['phase15_captured_device_ms']:.3f}, "
        f"{served['phase35_captured_device_ms']:.3f}), peak "
        f"{served['peak_mem_gb']:.2f} GB ({phase15['peak_mem_gb']:.2f}, "
        f"{phase35['peak_mem_gb']:.2f}); {served['streams_equal_phase15']} "
        f"of 8 streams equal phase 15's (reported: einsum drops past "
        f"capacity, dropless does not); {card_line()}")
    served["kernels"] = {"int8_matmul_experts_blocks":
                         check_int8_expert_blocks(torch, sharded, qcfg, mesh)}
    del sharded, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return served


def ep_tp_serving_launches(layers: int, n_ep: int, tp: int, decode: int,
                           prefill: int) -> dict:
    """Phase 40's engine launches (einsum on expert x tensor): K2 / K3 in
    int8 per tensor shard a layer (attention on expert shard 0's tensor
    shards); ``int8_matmul`` at the seams (wqkv and wo per tensor shard a
    layer, the LM head per tensor shard) and three expert products per
    (expert shard, tensor shard) a layer (the gate and up halves of the
    strided gate/up block, then down); K1 at both norms of a layer and the
    final norm; no fused dispatch, grouped product or ring hop."""
    forwards = decode + prefill
    return {"paged_decode_int8": tp * layers * decode,
            "paged_prefill_int8": tp * layers * prefill,
            "int8_matmul": (tp * (2 * layers + 1) + 3 * n_ep * tp * layers)
            * forwards,
            "rmsnorm": (2 * layers + 1) * forwards,
            "moe_gateup_int8": 0, "moe_down_combine_int8": 0,
            "grouped_matmul_int8": 0, "ring_permute": 0,
            "paged_decode": 0, "paged_prefill": 0}


def ep_tp_train_launches(layers: int, groups: int, n_ep: int,
                         tp: int) -> dict:
    """A train step's launches (remat "full") of dropless on data x
    expert x tensor: the trunk as ``megatron_train_launches``; the ring's
    n_ep K9 launches a layer and group forward, again in the recompute,
    and their inverses backward; every (group, hop, expert shard, tensor
    shard) runs its pairs through the grouped products -- the gate and up
    halves of its strided block and down, three K10a launches in the
    forward and three in the recompute, three K10a and three K10b in the
    backward -- and never K7/K8."""
    calls = layers * groups * n_ep * n_ep * tp
    return {**megatron_train_launches(layers, groups, tp),
            "ring_permute": 3 * n_ep * layers * groups,
            "grouped_matmul": 9 * calls, "grouped_weight_grad": 3 * calls,
            "moe_gateup": 0, "moe_down_combine": 0}


def ep_sp_train_launches(layers: int, n: int, tp: int) -> dict:
    """A loss and gradient's launches (remat "full") of einsum on expert x
    sequence ``n`` x tensor ``tp`` with ring attention: the attention as
    ``sequence_train_launches`` (one group); K1 at each token block's
    attention norm and at the group's MoE norm (the MoE block runs on the
    whole sequence), twice, and at each block's final norm once; its
    gradient once at each."""
    return {**sequence_train_launches(layers, n, 1, tp),
            "rmsnorm": 2 * (n + 1) * layers + n,
            "rmsnorm_backward": (n + 1) * layers + n,
            "grouped_matmul": 0, "moe_gateup": 0}


def ep_sp_compare(torch, cfg, dev, mesh, drive) -> dict:
    """Phase 41 (b): the reference test's composition at full width
    (``cfg`` einsum, EPSP_BATCH x EPSP_SEQ, remat "full") -- one
    ``loss_fn`` value and every gradient leaf with ring attention on
    expert x sequence x tensor (the counted run, ``drive``'s path
    "ep_sp_training") against the single device's on the same seeded
    weights and tokens, the mesh replaying the single run's expert choices
    (its flips held to near-ties): the loss within EPSP_LOSS_ABS (the
    reference test's gate), every leaf within EPSP_GRAD_REL."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.train import leaves

    params = moe.init_params(cfg, seed=SEED, device=dev)
    names, flat = param_names(params), leaves(params)
    for p in flat:
        p.requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (EPSP_BATCH, EPSP_SEQ + 1),
                           generator=gen, device=dev)

    def loss_grads(m):
        loss = moe.loss_fn(params, tokens, cfg, mesh=m,
                           use_ring=m is not None, remat=True)
        grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        out = (loss.item(), [g.cpu() for g in grads])
        del loss, grads
        torch.cuda.empty_cache()
        return out

    with RoutingReplay(moe) as replay:
        replay.mode = "record"
        l_single, g_single = loss_grads(None)
        replay.mode = "replay"
        l_mesh, g_mesh = drive("ep_sp_training", loss_grads, mesh)
    loss_rel, grad_rel_ = loss_grad_rel(names, (l_mesh, g_mesh),
                                        (l_single, g_single))
    result = dict(loss_single=l_single, loss_mesh=l_mesh,
                  loss_abs_diff=abs(l_mesh - l_single),
                  loss_rel_diff=loss_rel, grad_rel_diff=grad_rel_,
                  batch=EPSP_BATCH, seq=EPSP_SEQ, mesh=str(mesh),
                  **{k: v for k, v in replay.summary().items()
                     if k != "flip_margins"})
    log("expert x sequence x tensor loss/grad vs single device:",
        json.dumps(result))
    if not abs(l_mesh - l_single) < EPSP_LOSS_ABS:
        raise AssertionError(f"expert x sequence x tensor loss {l_mesh} "
                             f"against {l_single} (limit {EPSP_LOSS_ABS})")
    bad = {k: v for k, v in grad_rel_.items() if not v <= EPSP_GRAD_REL}
    if bad:
        raise AssertionError(f"expert x sequence x tensor gradients {bad} "
                             f"(limit {EPSP_GRAD_REL})")
    replay.check("expert x sequence x tensor loss/grad")
    del params, flat
    gc.collect()
    torch.cuda.empty_cache()
    return result


def pipe_int8_launches(layers: int, stages: int, micro: int,
                       tp: int) -> dict:
    """The int8 pipelined forward's launches (pipe x tensor, one group):
    each layer once per microbatch on its stage, K4 per tensor shard; K1
    at both norms of a layer per microbatch and the final norm once;
    ``int8_matmul`` at the five products of a layer (wqkv, wo, the gate
    and up halves, down) per (microbatch, tensor shard), and the LM head
    once, outside the pipeline; K9 once a hop, M + P - 2 hops."""
    return {"flash_fwd": layers * micro * tp,
            "rmsnorm": 2 * layers * micro + 1,
            "int8_matmul": 5 * layers * micro * tp + 1,
            "ring_permute": micro + stages - 2}


def pipe_int8_run(torch, dev, mesh) -> dict:
    """Phase 42, the counted run: the 8B preset in int8
    (``quantize_params``) through ``llama.forward_pipelined`` on ``mesh``
    at PIPE_INT8_BATCH x PIPE_INT8_SEQ in PIPE_INT8_MICRO microbatches.
    Returns what ``pipe_int8_check`` holds."""
    from k8s_dra_driver_tpu_torch.models import PRESETS, init_params, llama
    from k8s_dra_driver_tpu_torch.models.quant import quantize_params

    cfg = PRESETS["8b"]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    qparams = quantize_params(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    tokens = pipe_tokens(torch, cfg, dev, PIPE_INT8_BATCH,
                         PIPE_INT8_SEQ)[:, :-1]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = llama.forward_pipelined(qparams, tokens, cfg, mesh,
                                         PIPE_INT8_MICRO)
    torch.cuda.synchronize()
    return dict(cfg=cfg, qparams=qparams, tokens=tokens, logits=logits,
                built_s=built_s, forward_s=time.perf_counter() - t0,
                weights_gb=nbytes(qparams) / 1e9,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def pipe_int8_check(torch, run: dict, mesh) -> dict:
    """Phase 42's hold, outside the counted run: the pipelined int8 logits
    against the single device's unpipelined int8 forward on the same
    tokens, within PIPE_LOGITS_REL of its largest magnitude, finite, of
    the same shape."""
    from k8s_dra_driver_tpu_torch.models import llama

    logits = run["logits"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        single = llama.forward(run["qparams"], run["tokens"], run["cfg"])
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    if logits.shape != single.shape or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"pipelined int8 logits {tuple(logits.shape)} "
                             f"(want {tuple(single.shape)}), finite "
                             f"{bool(torch.isfinite(logits).all())}")
    rel_ = ((logits - single).abs().max() / single.abs().max()).item()
    out = dict(preset="8b", int8=True, batch=PIPE_INT8_BATCH,
               seq=PIPE_INT8_SEQ, microbatches=PIPE_INT8_MICRO,
               mesh=str(mesh), logits_rel=rel_,
               top1_agreement=float((logits.argmax(-1) == single.argmax(-1))
                                    .float().mean()),
               weights_gb=run["weights_gb"], built_s=run["built_s"],
               forward_s=run["forward_s"], single_forward_s=single_s,
               peak_mem_gb=run["peak_mem_gb"])
    log("pipeline int8:", json.dumps(out))
    if not rel_ <= PIPE_LOGITS_REL:
        raise AssertionError(f"pipelined int8 logits {rel_} of the largest "
                             f"(limit {PIPE_LOGITS_REL})")
    return out


def nbytes(tree) -> int:
    """Bytes of every tensor in a parameter dict (QuantTensors: q and
    scale)."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if hasattr(tree, "q"):
        return nbytes(tree.q) + nbytes(tree.scale)
    return tree.numel() * tree.element_size()


# Phase 43: where the driver lists the MIG access nodes' minors, the
# DeviceClasses of deployments/manifests/deviceclasses.yaml, and the
# constants of nvml.h the binding copies (C name -> the binding's value).
MIG_MINORS = Path("/proc/driver/nvidia-caps/mig-minors")
MIG_CLASSES = {
    name: [f"device.driver == '{DRA_DRIVER}' && "
           f"device.attributes['{DRA_DRIVER}'].type == '{kind}'"]
    for name, kind in ((DRA_DRIVER, "chip"),
                       (f"tensorcore.{DRA_DRIVER}", "tensorcore"))}


def nvml_constants() -> dict:
    from k8s_dra_driver_tpu_torch.tpulib import _nvml

    return {
        "nvmlGpuInstanceProfileInfo_v2": _nvml.GPU_INSTANCE_PROFILE_INFO_V2,
        "NVML_GPU_INSTANCE_PROFILE_1_SLICE":
            _nvml.GPU_INSTANCE_PROFILE_1_SLICE,
        "NVML_GPU_INSTANCE_PROFILE_2_SLICE":
            _nvml.GPU_INSTANCE_PROFILE_2_SLICE,
        "NVML_GPU_INSTANCE_PROFILE_3_SLICE":
            _nvml.GPU_INSTANCE_PROFILE_3_SLICE,
        "NVML_GPU_INSTANCE_PROFILE_4_SLICE":
            _nvml.GPU_INSTANCE_PROFILE_4_SLICE,
        "NVML_GPU_INSTANCE_PROFILE_7_SLICE":
            _nvml.GPU_INSTANCE_PROFILE_7_SLICE,
        "NVML_GPU_INSTANCE_PROFILE_1_SLICE_REV2":
            _nvml.GPU_INSTANCE_PROFILE_1_SLICE_REV2,
        "NVML_DEVICE_MIG_ENABLE": _nvml.MIG_ENABLED,
        "NVML_DEVICE_UUID_V2_BUFFER_SIZE": _nvml.UUID_BUFFER,
        "NVML_DEVICE_NAME_V2_BUFFER_SIZE": _nvml.NAME_BUFFER,
        "NVML_ERROR_NO_PERMISSION": 4,
        "NVML_ERROR_NOT_FOUND": 6,
    }


def nvml_layouts() -> dict:
    """The binding's structs and constants against the toolkit's
    ``nvml.h``: a C program compiled by ``nvcc`` into the build
    directory prints ``sizeof`` and each field's ``offsetof`` of every
    struct in ``_nvml.STRUCTS``, and each of ``nvml_constants``; every
    figure must equal the binding's."""
    import ctypes

    from k8s_dra_driver_tpu_torch.ops._build import nvcc_path
    from k8s_dra_driver_tpu_torch.tpulib import _nvml

    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    headers = [h for h in (home / "include" / "nvml.h",
                           home / "targets" / "x86_64-linux" / "include" /
                           "nvml.h", Path("/usr/include/nvml.h"))
               if h.exists()]
    if not headers:
        raise AssertionError(f"no nvml.h under {home} or /usr/include")
    want, lines = {}, ["#include <stddef.h>", "#include <stdio.h>",
                       "#include <nvml.h>", "int main(void) {"]
    for cname, struct in _nvml.STRUCTS.items():
        want[f"{cname} sizeof"] = ctypes.sizeof(struct)
        lines.append(f'  printf("{cname} sizeof %zu\\n", '
                     f'sizeof({cname}));')
        for field, _ in struct._fields_:
            want[f"{cname} {field}"] = getattr(struct, field).offset
            lines.append(f'  printf("{cname} {field} %zu\\n", '
                         f'offsetof({cname}, {field}));')
    for name, value in nvml_constants().items():
        want[name] = value
        lines.append(f'  printf("{name} %u\\n", (unsigned int)({name}));')
    lines += ["  return 0;", "}"]
    out = ROOT / "build" / "mig"
    out.mkdir(parents=True, exist_ok=True)
    (out / "nvml_layout.c").write_text("\n".join(lines) + "\n")
    proc = subprocess.run(
        [nvcc_path(), "-x", "c", f"-I{headers[0].parent}", "-o",
         str(out / "nvml_layout"), str(out / "nvml_layout.c")],
        capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise AssertionError(f"nvml_layout.c (nvcc rc {proc.returncode}):"
                             f"\n{proc.stdout}{proc.stderr}")
    printed = subprocess.run([str(out / "nvml_layout")], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    got = {line.rsplit(" ", 1)[0]: int(line.rsplit(" ", 1)[1])
           for line in printed.splitlines() if line.strip()}
    wrong = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
    if wrong:
        raise AssertionError(f"the NVML binding differs from {headers[0]} "
                             f"(binding, nvml.h): {wrong}")
    return dict(header=str(headers[0]), checked=len(want),
                sizes={k.split()[0]: v for k, v in got.items()
                       if k.endswith(" sizeof")})


def nvml_answer(fn, *args):
    """``fn(*args)``, or the name of the NVML error it raised."""
    from k8s_dra_driver_tpu_torch.tpulib import _nvml

    try:
        return fn(*args)
    except _nvml.NvmlError as e:
        return f"NVML_ERROR_{_nvml.RETURN_CODES.get(e.code, e.code)}"


def mig_driver(torch, enabled: bool, devices: dict) -> dict:
    """Phase 43's ``Driver`` on the card: publish, allocate a claim of the
    chip class (MIG disabled) or the tensorcore class (MIG enabled),
    prepare it through the transport, read its container's edits, run
    the MIG device's K1 worker where there is one, unprepare."""
    from k8s_dra_driver_tpu_torch.kube import FakeKubeClient
    from k8s_dra_driver_tpu_torch.kube.allocator import ReferenceAllocator
    from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb
    from k8s_dra_driver_tpu_torch.plugin.driver import Driver, DriverConfig
    from k8s_dra_driver_tpu_torch.tpulib import ChipLibConfig, RealChipLib

    root = ROOT / "build" / "dra" / "mig"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    node = os.uname().nodename
    client = FakeKubeClient()
    config = DriverConfig(
        node_name=node,
        chiplib=RealChipLib(ChipLibConfig(state_dir=str(root / "modes"))),
        kube_client=client, cdi_root=str(root / "cdi"),
        plugin_root=str(root / "plugin"),
        registrar_root=str(root / "registry"),
        state_root=str(root / "state"),
        device_classes=frozenset({"chip", "tensorcore"}),
        cleanup_interval_seconds=0, device_watch_interval_seconds=0,
        audit_interval_seconds=0)
    driver = Driver(config)
    worker = None
    uid = "dra-mig" if enabled else "dra-whole"
    claims = [drapb.Claim(namespace=DRA_NS, uid=uid, name=uid)]
    try:
        driver.start()
        deadline = time.monotonic() + 30
        while not client.list(driver.resource_api.slices) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        published = sorted(d["name"] for s in client.list(
            driver.resource_api.slices) for d in s["spec"]["devices"])
        if published != sorted(devices):
            raise AssertionError(f"the Driver published {published}, "
                                 f"RealChipLib {sorted(devices)}")
        alloc = ReferenceAllocator(client, device_classes=MIG_CLASSES)
        cls = f"tensorcore.{DRA_DRIVER}" if enabled else DRA_DRIVER
        claim = alloc.allocate({
            "apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
            "metadata": {"name": uid, "namespace": DRA_NS, "uid": uid},
            "spec": {"devices": {"requests": [
                {"name": "dev", "deviceClassName": cls}]}}},
            node_name=node)
        (result,) = claim["status"]["allocation"]["devices"]["results"]
        device = devices[result["device"]]
        client.create(driver.resource_api.claims, claim, namespace=DRA_NS)
        reply, prepare_ms = kubelet_call(
            driver.config.transport,
            "/v1beta1.DRAPlugin/NodePrepareResources",
            drapb.NodePrepareResourcesRequest(claims=claims),
            drapb.NodePrepareResourcesResponse)
        got = reply.claims[uid]
        if got.error or [d.device_name for d in got.devices] != \
                [result["device"]]:
            raise AssertionError(f"prepare of {uid}: {got}")
        ctr = cdi_container(config.cdi_root, got.devices)
        env = ctr["env"]
        impl = device.impl
        want_nodes = (impl.device_paths() if enabled
                      else impl.device_paths)
        if env.get("CUDA_VISIBLE_DEVICES") != impl.uuid or \
                any(k in env for k in ("TPU_VISIBLE_CORES",
                                       "TPU_PROCESS_BOUNDS", "TPU_MEGACORE",
                                       "TPU_VISIBLE_CHIPS")) or \
                not set(want_nodes) <= set(ctr["device_nodes"]):
            raise AssertionError(f"{uid}'s container: env {env}, nodes "
                                 f"{ctr['device_nodes']}, want "
                                 f"{impl.uuid} and {want_nodes}")
        out = dict(device=result["device"], uuid=impl.uuid,
                   device_nodes=ctr["device_nodes"], prepare_ms=prepare_ms)
        if enabled:
            worker = Worker("mig", {**os.environ, **env}, root / "mig.log")
            ran = worker.expect("rmsnorm")
            worker.finish()
            worker = None
            if (ran["count"], ran["launches"], ran["finite"]) != \
                    (1, 1, True) or ran["rel_err"] > 1e-2 or \
                    ran["total_memory"] > impl.parent.hbm_bytes:
                raise AssertionError(f"K1 on {impl.uuid}: {ran}")
            out["k1"] = ran
        reply, unprepare_ms = kubelet_call(
            driver.config.transport,
            "/v1beta1.DRAPlugin/NodeUnprepareResources",
            drapb.NodeUnprepareResourcesRequest(claims=claims),
            drapb.NodeUnprepareResourcesResponse)
        state = driver.state
        if reply.claims[uid].error or uid in state.cdi.list_claim_spec_uids() \
                or state.checkpoint.read():
            raise AssertionError(f"unprepare of {uid}: {reply}")
        out["unprepare_ms"] = unprepare_ms
        return out
    finally:
        if worker is not None:
            worker.stop()
        driver.shutdown()


def mig_phase(torch) -> dict:
    """Phase 43 (module docstring). Never sets the MIG mode."""
    from k8s_dra_driver_tpu_torch.tpulib import (
        ChipLibConfig,
        RealChipLib,
        _nvml,
        chiplib,
        deviceinfo,
    )

    t0 = time.perf_counter()
    out = dict(layouts=nvml_layouts())
    out["mig_minors"] = "absent"
    if MIG_MINORS.exists():
        minors = chiplib.parse_mig_minors(MIG_MINORS.read_text())
        if not any(k.endswith("/access") for k in minors):
            raise AssertionError(f"{MIG_MINORS} lists no access node: "
                                 f"{sorted(minors)[:8]}")
        out["mig_minors"] = dict(entries=len(minors),
                                 sample=sorted(minors.items())[:4])
    nv = _nvml.load()
    nv.init()
    try:
        handle = nv.handle_by_index(0)
        modes = nvml_answer(nv.mig_modes, handle)
        out["mig_mode"] = modes
        out["max_mig_devices"] = nvml_answer(nv.max_mig_device_count, handle)
        profiles = {}
        for p in deviceinfo.MIG_PROFILES["h100"]:
            info = nvml_answer(nv.gpu_instance_profile, handle,
                               p.nvml_profile)
            if isinstance(info, _nvml.GpuInstanceProfile):
                if (info.id, info.slice_count, info.name) != \
                        (p.profile_id, p.cores, f"MIG {p.name}"):
                    raise AssertionError(f"NVML's profile {p.nvml_profile}"
                                         f" is {info}, the table's {p}")
                info = dataclasses.asdict(info)
            profiles[p.name] = info
        out["profiles"] = profiles
    finally:
        nv.shutdown()
    enabled = isinstance(modes, tuple) and modes[0] == _nvml.MIG_ENABLED
    out["branch"] = "mig-enabled" if enabled else "mig-disabled"
    minors = out["mig_minors"]
    log(f"phase 43 branch: {out['branch']} (MIG mode current, pending: "
        f"{modes}; max MIG devices {out['max_mig_devices']}; mig-minors "
        f"{minors if isinstance(minors, str) else minors['entries']})")
    log("phase 43 profiles: " + json.dumps(profiles))
    if enabled and not all(isinstance(v, dict) for v in profiles.values()):
        raise AssertionError(f"MIG is enabled but NVML refused a profile "
                             f"query: {profiles}")
    lib = RealChipLib(ChipLibConfig(
        state_dir=str(ROOT / "build" / "dra" / "mig-modes")))
    lib.init()
    try:
        devices = lib.enumerate_all_possible_devices({"chip", "tensorcore"})
    finally:
        lib.shutdown()
    kinds = sorted({d.type() for d in devices.values()})
    if enabled:
        if "tensorcore" not in kinds or any(
                d.chip is not None and d.chip.index == 0
                for d in devices.values()):
            raise AssertionError(f"MIG enabled: published {sorted(devices)}")
    elif kinds != ["chip"] or len(devices) != torch.cuda.device_count():
        raise AssertionError(f"MIG disabled: published {sorted(devices)}")
    out["published"] = sorted(devices)
    out["driver"] = mig_driver(torch, enabled, devices)
    out["s"] = time.perf_counter() - t0
    return out


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
        from k8s_dra_driver_tpu_torch.parallel import ring
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2
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
        "rmsnorm_backward": norms.rmsnorm_backward,
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
        "ring_permute": ring.ring_permute_kernel,
        "grouped_matmul_int8": moe_dispatch.grouped_matmul_int8,
    }
    paths = {"serving": ("paged_decode", "paged_prefill", "rmsnorm"),
             "training": ("rmsnorm", "rmsnorm_backward", "flash_fwd",
                          "flash_bwd_dkdv", "flash_bwd_dq"),
             "moe_serving": ("moe_gateup", "moe_down_combine",
                             "paged_decode", "paged_prefill", "rmsnorm"),
             "moe_training": ("moe_gateup", "moe_down_combine",
                              "grouped_matmul", "grouped_weight_grad",
                              "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                              "rmsnorm", "rmsnorm_backward"),
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
             "remat_dense": ("rmsnorm", "rmsnorm_backward", "flash_fwd",
                             "flash_bwd_dkdv", "flash_bwd_dq"),
             "remat_moe": ("moe_gateup", "moe_down_combine",
                           "grouped_matmul", "grouped_weight_grad",
                           "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                           "rmsnorm", "rmsnorm_backward"),
             "checkpoint": ("rmsnorm", "rmsnorm_backward", "flash_fwd",
                            "flash_bwd_dkdv", "flash_bwd_dq"),
             "doctor": ("paged_decode", "paged_prefill", "rmsnorm"),
             "ep_serving": ("moe_gateup", "moe_down_combine",
                            "ring_permute", "paged_decode", "paged_prefill",
                            "rmsnorm"),
             "ep_training": ("ring_permute", "moe_gateup", "moe_down_combine",
                             "grouped_matmul", "grouped_weight_grad",
                             "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                             "rmsnorm", "rmsnorm_backward"),
             "megatron_serving": ("paged_decode", "paged_prefill",
                                  "rmsnorm"),
             "megatron_int8": ("grouped_matmul_int8", "int8_matmul",
                               "paged_decode_int8", "paged_prefill_int8",
                               "rmsnorm"),
             "megatron_training": ("rmsnorm", "rmsnorm_backward",
                                   "flash_fwd", "flash_bwd_dkdv",
                                   "flash_bwd_dq"),
             "sequence_training": ("rmsnorm", "rmsnorm_backward",
                                   "flash_fwd", "flash_bwd_dkdv",
                                   "flash_bwd_dq", "ring_permute"),
             "pipe_training": ("rmsnorm", "rmsnorm_backward", "flash_fwd",
                               "flash_bwd_dkdv", "flash_bwd_dq",
                               "ring_permute"),
             "pipe_moe": ("rmsnorm", "rmsnorm_backward", "flash_fwd",
                          "flash_bwd_dkdv", "flash_bwd_dq", "ring_permute"),
             "elastic_training": ("rmsnorm", "rmsnorm_backward",
                                  "flash_fwd", "flash_bwd_dkdv",
                                  "flash_bwd_dq"),
             "ep_tp_serving": ("int8_matmul", "paged_decode_int8",
                               "paged_prefill_int8", "rmsnorm"),
             "ep_tp_training": ("rmsnorm", "rmsnorm_backward", "flash_fwd",
                                "flash_bwd_dkdv", "flash_bwd_dq",
                                "grouped_matmul", "grouped_weight_grad",
                                "ring_permute"),
             "ep_sp_training": ("rmsnorm", "rmsnorm_backward", "flash_fwd",
                                "flash_bwd_dkdv", "flash_bwd_dq",
                                "ring_permute"),
             "pipe_int8": ("rmsnorm", "flash_fwd", "int8_matmul",
                           "ring_permute")}
    by_path = {}

    def reset_counts():
        write_launches([0] * len(LAUNCH_COUNTERS))

    def read_counts() -> dict:
        counts = {name: w.launches for name, w in wrappers.items()}
        counts["int8_matmul_wide"] = quant_matmul.int8_matmul.wide_launches
        counts["int8_matmul_wide_prologue"] = \
            quant_matmul.int8_matmul.wide_prologue_launches
        # A7b's launches by part, each counted where it launches: gate/up
        # or down, narrow (decode) or wide (prefill) rows.
        gmm8 = moe_dispatch.grouped_matmul_int8
        for tag, size in (("", "narrow"), ("_prefill", "wide")):
            for part in ("gateup", "down"):
                counts[f"grouped_matmul_int8{tag}_{part}"] = getattr(
                    gmm8, f"{size}_{part}_launches")
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

    def serve_twice(path, label, params, cfg, quantize_cache=False,
                    mesh=None, whole=None):
        """The engine's run (the main path, steps captured), then the same
        traffic through a ``capture=False`` engine, outside the counted
        run, held equal to it (``same_engines``; on a ``mesh`` the near-tie
        margins from ``whole``, the unplaced weights). Logs both engines'
        metrics on one line."""
        captured = drive(path, serve, torch, params, cfg, dev,
                         quantize_cache, True, None, None, mesh)
        gc.collect()                  # the captured engine's graphs
        torch.cuda.empty_cache()
        reset_counts()
        eager = serve(torch, params, cfg, dev, quantize_cache,
                      capture=False, mesh=mesh)
        flips = same_engines(torch, label, captured, eager, by_path[path],
                             read_counts(), params if whole is None
                             else whole, cfg, dev, quantize_cache)
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
    # twice per layer and step, K5 and K6 once; K1's gradient kernel at
    # each norm of a layer and the final norm.
    want = {"flash_fwd": 2 * layers * steps,
            "flash_bwd_dkdv": layers * steps, "flash_bwd_dq": layers * steps,
            "rmsnorm": (4 * layers + 1) * steps,
            "rmsnorm_backward": (2 * layers + 1) * steps}
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
            "rmsnorm": (4 * layers + 1) * steps,
            "rmsnorm_backward": (2 * layers + 1) * steps}
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
    # Phase 32: expert-parallel MoE serving on a mesh of EP_SHARDS shards of
    # the card, phase 8's model rebuilt from the seed.
    gc.collect()
    torch.cuda.empty_cache()
    ep = ep_phase(torch, mcfg, dev, moe_engine, kept["moe_serving"], drive,
                  read_counts)
    kernels.update(ep.pop("kernels"))
    served = ep["engine"]
    counts = by_path["ep_serving"]
    forwards = served["decode_steps"] + served["prefill_launches"]
    want = {"moe_gateup": EP_SHARDS ** 2 * MOE_LAYERS * forwards,
            "moe_down_combine": EP_SHARDS ** 2 * MOE_LAYERS * forwards,
            "ring_permute": EP_SHARDS * MOE_LAYERS * forwards,
            "paged_decode": MOE_LAYERS * served["decode_steps"],
            "paged_prefill": MOE_LAYERS * served["prefill_launches"]}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"EP serving launches {counts}, expected "
                             f"{want} ({forwards} forwards)")
    phase_done(f"phase 32: K9 bitwise equal to its plain version; the EP "
               f"ring and psum forwards match the single-device forward; "
               f"the EP engine served 8 requests on {EP_SHARDS} shards, "
               f"steps captured ({served['streams_equal_single']} of 8 "
               f"streams equal phase 9's; launches {counts})")
    # Phase 33: expert-parallel MoE training on the same mesh shape, phase
    # 12's model, batch and seed.
    gc.collect()
    torch.cuda.empty_cache()
    ep_grads = ep_compare_train(torch, tcfg, dev, read_counts)
    ep_trained = drive("ep_training", train, torch, dev, tcfg, "8x7b-L1",
                       MOE_TRAIN_BATCH, ep_mesh(dev))
    counts = by_path["ep_training"]
    layers = tcfg.n_layers
    want = {k: n * steps
            for k, n in ep_train_launches(EP_SHARDS, layers).items()}
    # The trunk as phase 12's: K4 twice a layer, K5 and K6 once; K1 at
    # each norm twice, its gradient once.
    want.update({"flash_fwd": 2 * layers * steps,
                 "flash_bwd_dkdv": layers * steps,
                 "flash_bwd_dq": layers * steps,
                 "rmsnorm": (4 * layers + 1) * steps,
                 "rmsnorm_backward": (2 * layers + 1) * steps})
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"EP training launches {counts}, expected "
                             f"{want}")
    if ep_trained["dispatch"] != "fused" \
            or set(ep_trained["moe_blocks"]) != blocks:
        raise AssertionError(f"EP training dispatch "
                             f"{ep_trained['dispatch']}, blocks "
                             f"{ep_trained['moe_blocks']}; want fused "
                             f"{blocks}")
    ep_trained["compare"] = ep_grads
    ep_trained["k9_launches_per_step"] = counts["ring_permute"] // steps
    ep_trained["phase12"] = {k: moe_trained[k] for k in (
        "step_ms_p50", "tokens_per_s", "peak_mem_gb", "losses")}
    log(f"EP train: step p50 {ep_trained['step_ms_p50']:.1f} ms (phase 12: "
        f"{moe_trained['step_ms_p50']:.1f}), {ep_trained['tokens_per_s']:.0f}"
        f" tokens/s ({moe_trained['tokens_per_s']:.0f}), peak memory "
        f"{ep_trained['peak_mem_gb']:.2f} GB "
        f"({moe_trained['peak_mem_gb']:.2f}), K9 "
        f"{ep_trained['k9_launches_per_step']} launches a step, K9 "
        f"{ep_trained['profile']['group_ms']['ring_permute']:.4f} device ms "
        f"a step; {card_line()}")
    phase_done(f"phase 33: 8x7b-L1 loss and gradients expert parallel on "
               f"{EP_SHARDS} shards match the single device with routing "
               f"replayed; trained for {steps} steps (launches {counts})")
    # Phase 34: Megatron serving of phase 4's 8B on data 2 x tensor 4.
    gc.collect()
    torch.cuda.empty_cache()
    megatron = megatron_serving(torch, dev, serve_twice, kept, engine)
    counts = by_path["megatron_serving"]
    groups = TP_SERVE_MESH["data"]
    shards = groups * TP_SERVE_MESH["tensor"]
    forwards = megatron["decode_steps"] + megatron["prefill_launches"]
    layers = PRESETS["8b"].n_layers
    # K2 / K3 once per (data, tensor) shard a layer; K1 at both norms of a
    # layer and the final norm once per data group.
    want = {"paged_decode": shards * layers * megatron["decode_steps"],
            "paged_prefill": shards * layers * megatron["prefill_launches"],
            "rmsnorm": groups * (2 * layers + 1) * forwards,
            "int8_matmul": 0, "moe_gateup": 0, "grouped_matmul_int8": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"Megatron serving launches {counts}, expected "
                             f"{want} ({forwards} forwards)")
    phase_done(f"phase 34: 8B served Megatron-style on data 2 x tensor 4, "
               f"steps captured and eagerly with equal results, "
               f"{megatron['streams_equal_phase4']} of 8 streams equal phase "
               f"4's, the rest near-ties (launches {counts})")
    # Phase 35: phase 15's int8 8x7b on tensor 4, A7b on every MoE layer.
    gc.collect()
    torch.cuda.empty_cache()
    int8_rows, megatron_int8 = megatron_int8_moe(
        torch, dev, qcfg, drive, kept, int8_engine)
    kernels.update(int8_rows)
    counts = by_path["megatron_int8"]
    tp = TP_MOE_MESH["tensor"]
    forwards = (megatron_int8["decode_steps"]
                + megatron_int8["prefill_launches"])
    layers = qcfg.n_layers
    # A7b: a gate/up and a down launch per tensor shard a layer, narrow
    # rows at decode, wide at prefill.
    want = {f"grouped_matmul_int8{tag}_{part}": tp * layers * megatron_int8[n]
            for tag, n in (("", "decode_steps"),
                           ("_prefill", "prefill_launches"))
            for part in ("gateup", "down")}
    want.update({"grouped_matmul_int8": 2 * tp * layers * forwards,
            "int8_matmul": tp * (2 * layers + 1) * forwards,
            "paged_decode_int8": tp * layers * megatron_int8["decode_steps"],
            "paged_prefill_int8":
                tp * layers * megatron_int8["prefill_launches"],
            "rmsnorm": (2 * layers + 1) * forwards,
            "moe_gateup_int8": 0, "moe_down_combine_int8": 0,
            "moe_gateup": 0, "grouped_matmul": 0, "paged_decode": 0})
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"Megatron int8 MoE launches {counts}, expected "
                             f"{want} ({forwards} forwards)")
    phase_done(f"phase 35: int8 8x7b served on tensor 4 through "
               f"grouped_matmul_int8, {megatron_int8['streams_equal_phase15']}"
               f" of 8 streams equal phase 15's, the rest near-ties (of "
               f"them {megatron_int8['routing_explained_flips']} routing "
               f"near-ties); no int8 weight converted (launches {counts})")
    # Phase 36: phase 6's 8b-L8 trained on data 2 x fsdp 2 x tensor 2.
    gc.collect()
    torch.cuda.empty_cache()
    tcfg8 = PRESETS["8b-L8"]
    tmesh = card_mesh(dev, **TP_TRAIN_MESH)
    tp_grads = megatron_compare_train(torch, tcfg8, dev, tmesh)
    tp_trained = drive("megatron_training", train, torch, dev, tcfg8,
                       "8b-L8", TRAIN_BATCH, tmesh, TP_TRAIN_STEPS, False)
    counts = by_path["megatron_training"]
    tsteps = 1 + TP_TRAIN_STEPS
    tgroups = TP_TRAIN_MESH["data"] * TP_TRAIN_MESH["fsdp"]
    want = {k: n * tsteps for k, n in megatron_train_launches(
        tcfg8.n_layers, tgroups, TP_TRAIN_MESH["tensor"]).items()}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"Megatron training launches {counts}, "
                             f"expected {want}")
    tp_trained["compare"] = tp_grads
    tp_trained["mesh"] = str(tmesh)
    tp_trained["phase6"] = {k: trained[k] for k in (
        "step_ms_p50", "tokens_per_s", "mfu", "peak_mem_gb")}
    log(f"megatron train: {tmesh}; step p50 "
        f"{tp_trained['step_ms_p50']:.1f} ms (phase 6: "
        f"{trained['step_ms_p50']:.1f}), {tp_trained['tokens_per_s']:.0f} "
        f"tokens/s ({trained['tokens_per_s']:.0f}), MFU "
        f"{tp_trained['mfu']:.3f} ({trained['mfu']:.3f}), peak memory "
        f"{tp_trained['peak_mem_gb']:.2f} GB "
        f"({trained['peak_mem_gb']:.2f}); loss rel "
        f"{tp_grads['loss_rel_diff']:.2e}, largest leaf rel "
        f"{max(tp_grads['grad_rel_diff'].values()):.2e}; {card_line()}")
    phase_done(f"phase 36: 8b-L8 loss and gradients on data 2 x fsdp 2 x "
               f"tensor 2 match the single device; trained for {tsteps} "
               f"steps (launches {counts})")
    # Phase 37: the sequence axis, 8b-L8 on sequence 4 x tensor 2 at 2 x
    # 8192 with ring attention; phase 36's state is freed.
    gc.collect()
    torch.cuda.empty_cache()
    smesh = card_mesh(dev, **SEQ_MESH)
    n_seq, seq_tp = SEQ_MESH["sequence"], SEQ_MESH["tensor"]
    kernels.update(check_flash_kernels(
        torch, tcfg8, dev, b=SEQ_BATCH, s=SEQ_LEN // n_seq,
        heads=(tcfg8.n_heads // seq_tp, tcfg8.n_kv_heads // seq_tp),
        causal=False, suffix="_hop"))
    hop = SEQ_LEN // n_seq
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 38)
    kv_shape = (SEQ_BATCH, tcfg8.n_kv_heads // seq_tp, hop, tcfg8.head_dim)
    kernels["ring_permute_ring_hop"] = time_hop(
        torch, "ring_permute_ring_hop", hop_rings(
            torch, gen, dev, [(kv_shape, torch.bfloat16)] * 2 * seq_tp
            + [(kv_shape, torch.float32)] * 2 * seq_tp, n_seq))
    seq_attn = check_sequence_attention(torch, tcfg8, dev, smesh)
    seq_grads = megatron_compare_train(torch, tcfg8, dev, smesh,
                                       batch=SEQ_BATCH, seq=SEQ_LEN,
                                       use_ring=True)
    seq_single = train(torch, dev, tcfg8, "8b-L8", SEQ_BATCH, None,
                       SEQ_STEPS, False, SEQ_LEN)
    seq_trained = drive("sequence_training", train, torch, dev, tcfg8,
                        "8b-L8", SEQ_BATCH, smesh, SEQ_STEPS, False, SEQ_LEN,
                        True)
    counts = by_path["sequence_training"]
    want = {k: n * (1 + SEQ_STEPS) for k, n in sequence_train_launches(
        tcfg8.n_layers, n_seq, 1, seq_tp).items()}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"sequence training launches {counts}, "
                             f"expected {want}")
    seq_trained.update(compare=seq_grads, attention=seq_attn,
                       mesh=str(smesh), single={k: seq_single[k] for k in (
                           "step_ms_p50", "tokens_per_s", "mfu",
                           "peak_mem_gb")},
                       launches_per_step={k: n // (1 + SEQ_STEPS)
                                          for k, n in want.items()})
    log(f"sequence train: {smesh}, {SEQ_BATCH} x {SEQ_LEN}, ring; step p50 "
        f"{seq_trained['step_ms_p50']:.1f} ms (one device: "
        f"{seq_single['step_ms_p50']:.1f}), "
        f"{seq_trained['tokens_per_s']:.0f} tokens/s "
        f"({seq_single['tokens_per_s']:.0f}), MFU {seq_trained['mfu']:.3f} "
        f"({seq_single['mfu']:.3f}), peak memory "
        f"{seq_trained['peak_mem_gb']:.2f} GB "
        f"({seq_single['peak_mem_gb']:.2f}); loss rel "
        f"{seq_grads['loss_rel_diff']:.2e}, largest leaf rel "
        f"{max(seq_grads['grad_rel_diff'].values()):.2e}; {card_line()}")
    phase_done(f"phase 37: K4-K6 not causal at the hop shape agree with "
               f"their plain versions; ring and Ulysses attention match one "
               f"device; 8b-L8 loss and gradients on sequence {n_seq} x "
               f"tensor {seq_tp} (ring) match the single device; trained for "
               f"{1 + SEQ_STEPS} steps (launches {counts})")
    # Phase 38: the pipe axis, 8b-L8 on pipe 2 x data 2 x tensor 2, then
    # 8x7b-L2 on data 2 x expert 2 x pipe 2.
    gc.collect()
    torch.cuda.empty_cache()
    pmesh = card_mesh(dev, **PIPE_MESH)
    stages, pgroups = PIPE_MESH["pipe"], PIPE_MESH["data"]
    act = (TRAIN_BATCH // (pgroups * PIPE_MICRO), TRAIN_SEQ, tcfg8.hidden)
    kernels["ring_permute_pipe_hop"] = time_hop(
        torch, "ring_permute_pipe_hop", hop_rings(
            torch, gen, dev, [(act, torch.bfloat16)] * pgroups, stages))
    pipe_grads = pipe_compare(torch, tcfg8, dev, pmesh)
    pipe_single = pipe_steps(torch, tcfg8, dev, None)
    piped = drive("pipe_training", pipe_steps, torch, tcfg8, dev, pmesh)
    counts = by_path["pipe_training"]
    want = {k: n * (1 + PIPE_STEPS) for k, n in pipe_train_launches(
        tcfg8.n_layers, stages, PIPE_MICRO, pgroups,
        PIPE_MESH["tensor"]).items()}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"pipelined training launches {counts}, "
                             f"expected {want}")
    bubble = (stages - 1) / (PIPE_MICRO + stages - 1)
    piped.update(compare=pipe_grads, mesh=str(pmesh), microbatches=PIPE_MICRO,
                 bubble_share=bubble, single=pipe_single,
                 launches_per_step={k: n // (1 + PIPE_STEPS)
                                    for k, n in want.items()})
    log(f"pipeline train: {pmesh}, {PIPE_MICRO} microbatches, bubble share "
        f"(P-1)/(M+P-1) = {bubble:.3f}; forward + backward step p50 "
        f"{piped['step_ms_p50']:.1f} ms (one device: "
        f"{pipe_single['step_ms_p50']:.1f}), {piped['tokens_per_s']:.0f} "
        f"tokens/s ({pipe_single['tokens_per_s']:.0f}), MFU "
        f"{piped['mfu']:.3f} ({pipe_single['mfu']:.3f}), peak memory "
        f"{piped['peak_mem_gb']:.2f} GB ({pipe_single['peak_mem_gb']:.2f}); "
        f"loss rel {pipe_grads['loss_rel_diff']:.2e}, largest leaf rel "
        f"{max(pipe_grads['grad_rel_diff'].values()):.2e}; {card_line()}")
    mmesh = card_mesh(dev, **PIPE_MOE_MESH)
    moe_run = drive("pipe_moe", pipe_moe_run, torch, dev, mmesh)
    counts = by_path["pipe_moe"]
    want = pipe_train_launches(PIPE_MOE_LAYERS, PIPE_MOE_MESH["pipe"],
                               PIPE_MOE_MICRO, PIPE_MOE_MESH["data"], 1,
                               remat=False)
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"pipelined MoE launches {counts}, expected "
                             f"{want}")
    piped["moe"] = pipe_moe_check(torch, moe_run, mmesh)
    piped["moe"]["launches"] = want
    del moe_run
    gc.collect()
    torch.cuda.empty_cache()
    phase_done(f"phase 38: pipelined 8b-L8 loss and gradients on pipe 2 x "
               f"data 2 x tensor 2 match the single device, "
               f"{1 + PIPE_STEPS} steps timed (bubble share {bubble:.3f}); "
               f"pipelined 8x7b-L{PIPE_MOE_LAYERS} on data 2 x expert 2 x "
               f"pipe 2 matches the single device's replayed forward and its "
               f"microbatches' aux (launches {counts})")
    # Phase 39: elastic training on members of the card; phase 38's state
    # is freed.
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_cfg = dataclasses.replace(tcfg8, n_layers=CKPT_LAYERS)
    elastic_ref = elastic_reference(torch, tcfg8, dev)
    elastic = drive("elastic_training", elastic_run, torch, dev, tcfg8,
                    ckpt_cfg, elastic_ref, read_counts)
    elastic["bootstrap"] = elastic_bootstrap()
    counts = by_path["elastic_training"]
    log(f"elastic: {elastic['members']} (victim {elastic['victim']}); live "
        f"shrink {elastic['live_shrink_s']:.4f} s, live grow "
        f"{elastic['live_grow_s']:.4f} s, cold "
        f"{elastic['cold_s']:.3f} s ({CKPT_LAYERS} layers, "
        f"{elastic['cold']['state_gb']:.2f} GB state); step p50 "
        f"{elastic['step_ms_p50_before']:.1f} ms on "
        f"{elastic['shrink']['old_mesh']}, "
        f"{elastic['step_ms_p50_after']:.1f} ms on "
        f"{elastic['shrink']['new_mesh']} (uninterrupted "
        f"{elastic['uninterrupted_step_ms_p50']:.1f}); largest loss rel "
        f"{max(elastic['loss_rel_diff']):.2e}; train.reshard "
        f"{elastic['reshard_ledger']}; peak memory "
        f"{elastic['peak_mem_gb']:.2f} GB; {card_line()}")
    phase_done(f"phase 39: 8b-L8 resized live data 2 x tensor 2 -> tensor 2 "
               f"-> data 2 x tensor 2 on the gang's members with the losses "
               f"of an uninterrupted run; the {CKPT_LAYERS}-layer cut "
               f"restored cold onto fsdp 2; the auditor clean "
               f"(launches {counts})")
    # Phase 40: phase 15's int8 8x7b served on expert 2 x tensor 2;
    # phase 39's state is freed.
    gc.collect()
    torch.cuda.empty_cache()
    ep_tp = ep_tp_serving(torch, dev, qcfg, drive, kept, int8_engine,
                          megatron_int8)
    kernels.update(ep_tp.pop("kernels"))
    counts = by_path["ep_tp_serving"]
    want = ep_tp_serving_launches(
        qcfg.n_layers, EPTP_SERVE_MESH["expert"], EPTP_SERVE_MESH["tensor"],
        ep_tp["decode_steps"], ep_tp["prefill_launches"])
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"expert x tensor int8 MoE launches {counts}, "
                             f"expected {want}")
    phase_done(f"phase 40: int8 8x7b served on expert 2 x tensor 2 "
               f"(einsum), its einsum and dropless forwards held to the "
               f"single device with routing replayed (launches {counts})")
    # Phase 41: 8x7b-L1 trained dropless on data 2 x expert 2 x tensor 2,
    # then the reference test's expert 2 x sequence 2 x tensor 2 einsum
    # composition with ring attention at 2 x 4096.
    gc.collect()
    torch.cuda.empty_cache()
    emesh = card_mesh(dev, **EPTP_TRAIN_MESH)
    egroups = EPTP_TRAIN_MESH["data"]
    per_step = ep_tp_train_launches(tcfg.n_layers, egroups,
                                    EPTP_TRAIN_MESH["expert"],
                                    EPTP_TRAIN_MESH["tensor"])
    ep_tp_grads = ep_compare_train(torch, tcfg, dev, read_counts, emesh,
                                   per_step)
    ep_tp_trained = drive("ep_tp_training", train, torch, dev, tcfg,
                          "8x7b-L1", MOE_TRAIN_BATCH, emesh)
    counts = by_path["ep_tp_training"]
    want = {k: n * steps for k, n in per_step.items()}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"data x expert x tensor training launches "
                             f"{counts}, expected {want}")
    ep_tp_trained.update(
        compare=ep_tp_grads, mesh=str(emesh), launches_per_step=per_step,
        phase12={k: moe_trained[k] for k in ("step_ms_p50", "tokens_per_s",
                                             "peak_mem_gb")},
        phase33={k: ep_trained[k] for k in ("step_ms_p50", "tokens_per_s",
                                            "peak_mem_gb")})
    log(f"data x expert x tensor train: {emesh}; step p50 "
        f"{ep_tp_trained['step_ms_p50']:.1f} ms (phase 12: "
        f"{moe_trained['step_ms_p50']:.1f}, phase 33: "
        f"{ep_trained['step_ms_p50']:.1f}), "
        f"{ep_tp_trained['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{ep_tp_trained['peak_mem_gb']:.2f} GB "
        f"({moe_trained['peak_mem_gb']:.2f}, "
        f"{ep_trained['peak_mem_gb']:.2f}); loss rel "
        f"{ep_tp_grads['loss_rel_diff']:.2e}, largest leaf rel "
        f"{max(ep_tp_grads['grad_rel_diff'].values()):.2e}; {card_line()}")
    gc.collect()
    torch.cuda.empty_cache()
    smesh = card_mesh(dev, **EPSP_TRAIN_MESH)
    ep_sp = ep_sp_compare(torch, dataclasses.replace(tcfg, moe_impl="einsum"),
                          dev, smesh, drive)
    counts = by_path["ep_sp_training"]
    want = ep_sp_train_launches(tcfg.n_layers, EPSP_TRAIN_MESH["sequence"],
                                EPSP_TRAIN_MESH["tensor"])
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"expert x sequence x tensor launches {counts}, "
                             f"expected {want}")
    ep_sp["launches"] = want
    ep_tp_trained["expert_sequence_tensor"] = ep_sp
    phase_done(f"phase 41: 8x7b-L1 loss and gradients on data 2 x expert 2 "
               f"x tensor 2 (dropless) and on expert 2 x sequence 2 x "
               f"tensor 2 (einsum, ring attention) match the single device; "
               f"trained for {steps} steps on the first (launches "
               f"{by_path['ep_tp_training']}, {counts})")
    # Phase 42: the 8B in int8 pipelined on pipe 2 x tensor 2.
    gc.collect()
    torch.cuda.empty_cache()
    qmesh = card_mesh(dev, **PIPE_INT8_MESH)
    qrun = drive("pipe_int8", pipe_int8_run, torch, dev, qmesh)
    counts = by_path["pipe_int8"]
    want = pipe_int8_launches(qrun["cfg"].n_layers, PIPE_INT8_MESH["pipe"],
                              PIPE_INT8_MICRO, PIPE_INT8_MESH["tensor"])
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"pipelined int8 launches {counts}, expected "
                             f"{want}")
    pipe_int8 = pipe_int8_check(torch, qrun, qmesh)
    pipe_int8["launches"] = want
    del qrun
    gc.collect()
    torch.cuda.empty_cache()
    phase_done(f"phase 42: 8B int8 pipelined on pipe 2 x tensor 2 in "
               f"{PIPE_INT8_MICRO} microbatches matches the unpipelined int8 "
               f"forward (launches {counts})")
    # Phase 43: MIG, read and driven as far as the card's mode allows.
    mig = mig_phase(torch)
    phase_done(f"phase 43: NVML's MIG structs match nvml.h "
               f"({mig['layouts']['checked']} figures); MIG mode "
               f"{mig['mig_mode']}, branch {mig['branch']}; the Driver "
               f"published {mig['published']} and prepared "
               f"{mig['driver']['device']} ({mig['driver']['uuid']})")
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
                                                  "remat_moe",
                                                  "ep_training"))
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
        "rmsnorm": ("cuda", "k8s_dra_driver_tpu_torch/csrc/rmsnorm.cu",
                    "k8s_dra_driver_tpu/ops/norms.py:26"),
        "rmsnorm_backward": ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                             "rmsnorm.cu",
                             "k8s_dra_driver_tpu/ops/norms.py:69 "
                             "(_rmsnorm_diff_bwd: jax.vjp of the reference, "
                             "XLA; no Pallas kernel)"),
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
    meta["ring_permute"] = ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                            "ring_permute.cu",
                            "k8s_dra_driver_tpu/parallel/ring.py:393")
    for name in ("grouped_matmul_int8_gateup", "grouped_matmul_int8_down",
                 "grouped_matmul_int8_prefill_gateup",
                 "grouped_matmul_int8_prefill_down"):
        meta[name] = ("cuda", "k8s_dra_driver_tpu_torch/csrc/"
                      "grouped_matmul_int8.cu",
                      "k8s_dra_driver_tpu/ops/moe_dispatch.py:389 "
                      "(lax.ragged_dot's int8 branch, XLA; no Pallas "
                      "kernel)")
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
    # K1 at the paths' other shapes, its gradient at the 8192-row shape,
    # the int8 seams at M 1, 5, 16 and 64, and the experts mode on phase
    # 40's strided blocks: the same kernels and launch counts as their
    # rows.
    for base, names in (("rmsnorm", [n for n, _, _ in RMSNORM_SHAPES[1:]]),
                        ("rmsnorm_backward", ["rmsnorm_backward_8k"]),
                        ("int8_matmul", [f"int8_matmul_m{m}"
                                         for m in INT8_SEAM_MS
                                         if m != BATCH_SLOTS]),
                        ("int8_matmul_experts",
                         ["int8_matmul_experts_blocks"])):
        for name in names:
            meta[name] = meta[base]
            launches[name] = launches[base]
            by_path = {p: {**c, name: c[base]} for p, c in by_path.items()}
    # K9 at the f32 carrier, at 256 MB a shard and as the hop's grouped
    # launch: the same kernel and launch count as its row at the bf16 hop
    # chunk.
    for name in ("ring_permute_carrier", "ring_permute_256mb",
                 "ring_permute_hop", "ring_permute_hop_decode",
                 "ring_permute_ring_hop", "ring_permute_pipe_hop"):
        meta[name] = meta["ring_permute"]
        launches[name] = launches["ring_permute"]
        by_path = {p: {**c, name: c["ring_permute"]}
                   for p, c in by_path.items()}
    # K4-K6 at phase 37's non-causal ring hop: the same kernels and launch
    # counts as their rows.
    for base in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        meta[base + "_hop"] = meta[base]
        launches[base + "_hop"] = launches[base]
        by_path = {p: {**c, base + "_hop": c[base]}
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
                    "plugin": plugin, "doctor": diag,
                    "expert_parallel": ep,
                    "expert_parallel_training": ep_trained,
                    "megatron_serving": megatron,
                    "megatron_int8_moe": megatron_int8,
                    "megatron_training": tp_trained,
                    "sequence_training": seq_trained,
                    "pipe_training": piped, "elastic_training": elastic,
                    "expert_tensor_serving": ep_tp,
                    "expert_tensor_training": ep_tp_trained,
                    "pipe_int8": pipe_int8, "mig": mig}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dra-worker"]:
        sys.exit(dra_worker(sys.argv[2]))
    sys.exit(main())
