#!/usr/bin/env python3
"""Prometheus text-exposition validator + debug-server smoke check on the
PyTorch port.

Twin of ``tools/verify_metrics.py`` (``make verify-metrics``) over
``k8s_dra_driver_tpu_torch``: the same options, checks, printed lines and
exit codes. It keeps its own copy of the exposition parser
(``validate_exposition``) and the cardinality bounds
(``check_cardinality``), and imports nothing of JAX. The self-test starts
the port's debug server (``utils/metrics.MetricsServer``) over a registry
exercising every renderer edge case (label escaping, +-Inf/NaN values,
histogram buckets, deprecated aliases) and every family the reference's
self-test registers, populated through the port's real code paths,
scrapes it over real HTTP, and fails on any malformed exposition line or
missing family. The self-test's ``tiny`` engine, its compute telemetry
and its reshard run on the CPU (the reference's run on its CPU backend):
they exist to populate the registry. With ``--url`` it validates a
running server instead (point it at a deployed plugin/controller
``/metrics``).

Run from the repo root: ``python tools/verify_metrics_torch.py [--url
URL]``.
"""

from __future__ import annotations

import argparse
import re
import sys

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL_NAME = r"[a-zA-Z_][a-zA-Z0-9_]*"
# A label value: any run of chars where backslash, quote, and newline
# appear only as \\ \" \n escapes.
_LABEL_VALUE = r'(?:[^"\\\n]|\\\\|\\"|\\n)*'
_LABELS = rf'\{{{_LABEL_NAME}="{_LABEL_VALUE}"(?:,{_LABEL_NAME}="{_LABEL_VALUE}")*\}}'
_VALUE = r"(?:[+-]?(?:\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)|\+Inf|-Inf|NaN)"
_SAMPLE_RE = re.compile(rf"({_NAME})(?:{_LABELS})?\s+{_VALUE}(?:\s+-?\d+)?\Z")
_HELP_RE = re.compile(rf"# HELP ({_NAME}) (.+)\Z")
_TYPE_RE = re.compile(rf"# TYPE ({_NAME}) (counter|gauge|histogram|summary|untyped)\Z")

_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


def _base_name(sample_name: str, types: dict[str, str]) -> str:
    """Map histogram series names back to the declared metric."""
    for suffix in _HISTOGRAM_SUFFIXES:
        base = sample_name[: -len(suffix)] if sample_name.endswith(suffix) else ""
        if base and types.get(base) == "histogram":
            return base
    return sample_name


def validate_exposition(text: str) -> list[str]:
    """All defects found in a /metrics payload; empty means clean."""
    errors: list[str] = []
    types: dict[str, str] = {}
    histogram_inf_seen: dict[str, bool] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line:
            continue
        if line.startswith("#"):
            if line.startswith("# HELP "):
                if not _HELP_RE.match(line):
                    errors.append(f"line {lineno}: malformed HELP: {line!r}")
            elif line.startswith("# TYPE "):
                m = _TYPE_RE.match(line)
                if not m:
                    errors.append(f"line {lineno}: malformed TYPE: {line!r}")
                    continue
                name, mtype = m.groups()
                if types.get(name, mtype) != mtype:
                    errors.append(
                        f"line {lineno}: conflicting TYPE for {name}"
                    )
                types[name] = mtype
                if mtype == "histogram":
                    histogram_inf_seen.setdefault(name, False)
            # other comments are legal and ignored
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            errors.append(f"line {lineno}: malformed sample: {line!r}")
            continue
        base = _base_name(m.group(1), types)
        if base not in types:
            errors.append(
                f"line {lineno}: sample {m.group(1)!r} has no TYPE declaration"
            )
        if (
            types.get(base) == "histogram"
            and m.group(1) == f"{base}_bucket"
            and 'le="+Inf"' in line
        ):
            histogram_inf_seen[base] = True
    for name, seen in sorted(histogram_inf_seen.items()):
        if not seen:
            errors.append(f"histogram {name} has no le=\"+Inf\" bucket")
    return errors


_PER_CHIP_LABELS = ("chip=", "uuid=", "device=")


def check_cardinality(
    text: str, max_series: int = 500, max_chip_series: int = 64
) -> list[str]:
    """Series-count bounds per metric family. Families carrying per-chip
    labels (chip/uuid/device — allowed only in accounting.py/audit.py,
    lint TPM04) get the tighter bound: a node has at most a handful of
    chips, so more series than that means a label is leaking identifiers
    (claim UIDs, timestamps) into what must stay a bounded dimension."""
    series: dict[str, int] = {}
    chip_labeled: set[str] = set()
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        series[name] = series.get(name, 0) + 1
        if "{" in line and any(
            f"{lbl}" in line.split("{", 1)[1] for lbl in _PER_CHIP_LABELS
        ):
            chip_labeled.add(name)
    errors = []
    for name, count in sorted(series.items()):
        if name in chip_labeled and count > max_chip_series:
            errors.append(
                f"family {name} renders {count} per-chip series "
                f"(bound {max_chip_series}): label cardinality leak"
            )
        elif count > max_series:
            errors.append(
                f"family {name} renders {count} series (bound {max_series})"
            )
    return errors


def _self_test_scrape() -> tuple[str, list[str]]:
    """Start a debug server over a worst-case registry; return the scraped
    body and any HTTP-surface errors."""
    import json
    import math
    import urllib.error
    import urllib.request

    from k8s_dra_driver_tpu_torch.utils.metrics import (
        Counter,
        Gauge,
        Histogram,
        MetricsServer,
        Registry,
    )
    from k8s_dra_driver_tpu_torch.utils.tracing import Tracer

    registry = Registry()
    c = Counter("tpu_dra_verify_requests_total", "Self-test counter", registry)
    c.inc(path='with"quote', node="back\\slash", detail="multi\nline")
    g = Gauge("tpu_dra_verify_temperature_celsius", "Self-test gauge", registry)
    g.set(math.inf, chip="hot")
    g.set(-math.inf, chip="cold")
    g.set(math.nan, chip="unknown")
    h = Histogram("tpu_dra_verify_latency_seconds", "Self-test histogram",
                  registry, buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(50.0)
    renamed = Counter("tpu_dra_verify_renamed_total", "Renamed", registry)
    renamed.inc()
    registry.alias("tpu_dra_verify_old_total", renamed)

    # The usage + audit families (this driver's utilization accounting
    # and state-drift auditing), populated through the REAL code paths so
    # the rendered exposition — per-chip labels included — is what a
    # production scrape sees.
    import tempfile

    from k8s_dra_driver_tpu_torch.cdi import CDIHandler
    from k8s_dra_driver_tpu_torch.plugin.accounting import UsageAccountant
    from k8s_dra_driver_tpu_torch.plugin.audit import StateAuditor
    from k8s_dra_driver_tpu_torch.plugin.checkpoint import CheckpointManager
    from k8s_dra_driver_tpu_torch.plugin.device_state import DeviceState
    from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib

    usage = UsageAccountant(
        registry,
        node_name="verify",
        inventory=lambda: {
            "capacity": {"chip": 2, "tensorcore": 4},
            "chips": {"TPU-verify": {
                "state": "healthy", "since": 0.0, "reason": "",
            }},
        },
    )
    with tempfile.TemporaryDirectory(prefix="verify-metrics-") as tmp:
        state = DeviceState(
            chiplib=FakeChipLib(generation="v5p", topology="2x1x1"),
            cdi=CDIHandler(f"{tmp}/cdi"),
            checkpoint=CheckpointManager(f"{tmp}/checkpoint.json"),
            driver_name="tpu.google.com",
            pool_name="verify",
            state_dir=f"{tmp}/state",
        )
        state.accountant = usage
        state.prepare({
            "metadata": {"name": "v", "namespace": "verify",
                         "uid": "uid-usage"},
            "status": {"allocation": {"devices": {"results": [{
                "request": "r", "driver": "tpu.google.com",
                "pool": "verify", "device": "tpu-0",
            }], "config": []}}},
        })
        auditor = StateAuditor(state=state, registry=registry)
        # One guaranteed drift sample, so the audit gauges render both
        # zero and non-zero series.
        state.cdi.create_claim_spec_file("uid-orphan", {}, {})
        auditor.run_once()
        snapshot = usage.snapshot()
    if not snapshot.get("holds"):
        return "", ["usage snapshot lost the prepared hold"]

    # The alloc explainability families (tpu_dra_alloc_*), populated
    # through REAL solve paths — one success and one forced unsat — so
    # the stage/reason label values the scrape renders are exactly what
    # the solver emits (and provably inside allocator.py's enums, the
    # TPM06 contract).
    from k8s_dra_driver_tpu_torch.kube import NODES, FakeKubeClient
    from k8s_dra_driver_tpu_torch.kube.allocator import (
        REASONS,
        STAGES,
        AllocationError,
        ReferenceAllocator,
    )
    from k8s_dra_driver_tpu_torch.kube.resourceslice import (
        DriverResources,
        Pool,
        ResourceSliceController,
    )
    from k8s_dra_driver_tpu_torch.tpulib.deviceinfo import counter_sets

    alloc_errors: list[str] = []
    client = FakeKubeClient()
    client.create(NODES, {"metadata": {"name": "verify", "uid": "u-v"}})
    lib = FakeChipLib(generation="v5p", topology="2x1x1")
    allocatable = lib.enumerate_all_possible_devices({"chip", "tensorcore"})
    ctrl = ResourceSliceController(
        client, "tpu.google.com", scope="verify",
        owner={"kind": "Node", "name": "verify", "uid": "u-v"},
    )
    ctrl.update(DriverResources(pools={"verify": Pool(
        devices=[d.get_device() for _, d in sorted(allocatable.items())],
        shared_counters=counter_sets(allocatable),
        node_name="verify",
    )}))
    ctrl.sync_once()
    allocator = ReferenceAllocator(client, registry=registry)

    def _verify_claim(uid, count):
        return {
            "metadata": {"name": f"wl-{uid}", "namespace": "verify",
                         "uid": uid},
            "spec": {"devices": {"requests": [{
                "name": "r0", "deviceClassName": "tpu.google.com",
                "count": count,
            }]}},
        }

    allocator.allocate(_verify_claim("uid-alloc-ok", 1))
    try:
        allocator.allocate(_verify_claim("uid-alloc-unsat", 99))
        alloc_errors.append("forced-unsat claim unexpectedly allocated")
    except AllocationError as e:
        if e.reason not in REASONS:
            alloc_errors.append(
                f"unsat reason {e.reason!r} outside the REASONS enum"
            )

    # The defrag families (tpu_dra_defrag_*), populated through a REAL
    # fragmented-gang unsat: a 4x1x1 slice with the middle chips held
    # leaves two free corners that form no contiguous pair, and the
    # attached planner must propose a migration plan for it.
    from k8s_dra_driver_tpu_torch.kube.allocator import Selector
    from k8s_dra_driver_tpu_torch.kube.defrag import OUTCOMES, DefragPlanner

    planner = DefragPlanner(allocator, registry=registry)
    client.create(NODES, {"metadata": {"name": "verify-frag",
                                       "uid": "u-vf"}})
    frag_lib = FakeChipLib(generation="v5p", topology="4x1x1",
                           slice_id="frag-slice")
    frag_devs = frag_lib.enumerate_all_possible_devices({"chip"})
    frag_ctrl = ResourceSliceController(
        client, "tpu.google.com", scope="verify-frag",
        owner={"kind": "Node", "name": "verify-frag", "uid": "u-vf"},
    )
    frag_ctrl.update(DriverResources(pools={"verify-frag": Pool(
        devices=[d.get_device() for _, d in sorted(frag_devs.items())],
        shared_counters=counter_sets(frag_devs),
        node_name="verify-frag",
    )}))
    frag_ctrl.sync_once()
    for i, coord in enumerate(("1,0,0", "2,0,0")):
        allocator.allocate(
            _verify_claim(f"uid-frag-hold-{i}", 1),
            selectors={"r0": [Selector("sliceId", "eq", "frag-slice"),
                              Selector("coord", "eq", coord)]},
        )
    try:
        allocator.allocate(
            _verify_claim("uid-frag-gang", 2),
            selectors={"r0": [Selector("sliceId", "eq", "frag-slice")]},
        )
        alloc_errors.append("fragmented gang unexpectedly allocated")
    except AllocationError as e:
        if e.reason != "gang":
            alloc_errors.append(
                f"fragmented gang failed with reason {e.reason!r}, "
                "want 'gang'"
            )
    frag_plans = planner.recent_plans()
    if not frag_plans:
        alloc_errors.append("defrag planner recorded no plan")
    else:
        newest_plan = frag_plans[-1]
        if newest_plan.get("outcome") not in OUTCOMES:
            alloc_errors.append(
                f"defrag outcome {newest_plan.get('outcome')!r} outside "
                "the OUTCOMES enum"
            )
        if newest_plan.get("outcome") != "planned" \
                or not newest_plan.get("migrations"):
            alloc_errors.append(
                "defrag plan for the fragmented gang is not 'planned' "
                f"with migrations: {newest_plan.get('outcome')!r}"
            )

    # The defrag EXECUTION families (tpu_dra_defrag_exec_*), populated
    # by EXECUTING the plan just computed: the mover re-places onto the
    # planned corner and the stuck gang admits, so the executions/steps
    # counters, latency histogram, and gauges render what a real
    # orchestrated migration produces — and /debug/defrag (checked
    # below) grows its `executions` view.
    from k8s_dra_driver_tpu_torch.kube.defrag_executor import DefragExecutor

    if frag_plans and frag_plans[-1].get("outcome") == "planned":
        with tempfile.TemporaryDirectory(prefix="verify-defrag-") as tmp:
            executor = DefragExecutor(
                planner, allocator,
                intent_path=f"{tmp}/defrag-intent.json",
                registry=registry,
            )
            try:
                exec_record = executor.execute(
                    frag_plans[-1],
                    claim=_verify_claim("uid-frag-gang", 2),
                    selectors={"r0": [Selector("sliceId", "eq",
                                               "frag-slice")]},
                )
            except Exception as e:
                alloc_errors.append(f"defrag execution failed: {e}")
            else:
                if exec_record.get("state") != "completed":
                    alloc_errors.append(
                        "defrag execution did not complete: "
                        f"{exec_record.get('state')!r}"
                    )
                if executor.orphaned_intent() is not None:
                    alloc_errors.append(
                        "defrag execution left an orphaned intent"
                    )

    # The SLO / dynamic-sharing families (tpu_dra_slo_*), populated
    # through a REAL rebalance: two ProcessShared co-tenants on one
    # chip, one bursting and one idle, so the rebalancer applies a
    # steal-idle move via the two-phase limits-resize protocol — the
    # decisions counter, granted/min gauges, and latency histogram all
    # render exactly what production would.
    from k8s_dra_driver_tpu_torch.plugin.rebalancer import (
        OUTCOMES as REB_OUTCOMES,
        Rebalancer,
    )

    def _shared_claim(uid, pct, hbm, slo):
        return {
            "metadata": {"name": f"t-{uid}", "namespace": "verify",
                         "uid": uid},
            "status": {"allocation": {"devices": {"results": [{
                "request": "r", "driver": "tpu.google.com",
                "pool": "verify", "device": "tpu-0",
            }], "config": [{
                "requests": [], "source": "FromClaim",
                "opaque": {"driver": "tpu.google.com", "parameters": {
                    "apiVersion": "tpu.google.com/v1alpha1",
                    "kind": "TpuChipConfig",
                    "sharing": {
                        "strategy": "ProcessShared",
                        "processSharedConfig": {
                            "maxProcesses": 2,
                            "defaultActiveCorePercentage": pct,
                            "defaultHbmLimit": hbm,
                            "slo": slo,
                        },
                    },
                }},
            }]}}},
        }

    slo_demand = {
        "uid-slo-infer": {"busy": 1.0},
        "uid-slo-batch": {"busy": 0.0},
    }
    with tempfile.TemporaryDirectory(prefix="verify-rebalance-") as tmp:
        slo_state = DeviceState(
            chiplib=FakeChipLib(generation="v5e", topology="2x1x1"),
            cdi=CDIHandler(f"{tmp}/cdi"),
            checkpoint=CheckpointManager(f"{tmp}/checkpoint.json"),
            driver_name="tpu.google.com",
            pool_name="verify",
            state_dir=f"{tmp}/state",
        )
        slo_state.prepare(_shared_claim("uid-slo-infer", 30, "4Gi", {
            "latencyClass": "realtime", "minTensorCorePercent": 30,
            "burstTensorCorePercent": 80, "priority": 10,
        }))
        slo_state.prepare(_shared_claim("uid-slo-batch", 70, "12Gi", {
            "latencyClass": "batch", "minTensorCorePercent": 20,
        }))
        rebalancer = Rebalancer(
            slo_state, registry, node_name="verify",
            demand_source=lambda v: slo_demand.get(v.claim_uid),
        )
        slo_records = rebalancer.run_once()
        if not slo_records or slo_records[-1]["outcome"] != "applied":
            alloc_errors.append(
                "rebalance sim produced no applied decision: "
                f"{slo_records}"
            )
        rebalance_snapshot = rebalancer.snapshot()

    # The fleet-gateway families (tpu_dra_gw_*), populated through a
    # REAL two-replica gateway sim driving all three observable paths:
    # shared-prefix traffic ROUTES with affinity, a batch request is
    # SHED at the watermark, and backlog pressure makes the autoscaler
    # SCALE up through a provisioner — so the policy/outcome/class
    # label values the scrape renders are exactly the production enums.
    from k8s_dra_driver_tpu_torch.serving_gateway import (
        Autoscaler,
        AutoscalerPolicy,
        AdmissionPolicy,
        OverloadedError,
        Replica,
        Router,
        ServingGateway,
        ServingTelemetry,
    )
    from k8s_dra_driver_tpu_torch.serving_gateway.autoscaler import (
        OUTCOMES as SCALE_OUTCOMES,
    )
    from k8s_dra_driver_tpu_torch.serving_gateway.reqtrace import (
        OUTCOMES as TRACE_OUTCOMES,
        TIMELINE_PHASES,
    )
    from k8s_dra_driver_tpu_torch.serving_gateway.sim import (
        ScriptedEngine,
        shared_prefix_prompts,
    )

    gw_errors: list[str] = []

    # Deterministic virtual clock shared by the gateway and every engine
    # (0.25 "seconds" per tick below): latencies, timelines, and the
    # forced SLO violation are then independent of wall-clock noise.
    gw_clock_box = [0.0]

    def gw_clock():
        return gw_clock_box[0]

    class _Provisioner:
        def __init__(self):
            self.ups = 0

        def scale_up(self):
            self.ups += 1
            return Replica(f"scaled-{self.ups}", ScriptedEngine(
                batch_slots=2, prefill_chunk=16, clock=gw_clock,
            ))

        def scale_down(self, replica):
            pass

    telemetry = ServingTelemetry(
        registry,
        # Deep enough that per-tick traces cannot evict the submit
        # traces the join assertion below looks up.
        tracer=Tracer(max_traces=4096),
        # Tight interactive budgets (in virtual seconds), so the slow
        # replica below forcibly populates the violation counters and
        # the exemplar ledger through the REAL observe path.
        slo={"interactive": {"ttftS": 0.5, "e2eS": 2.0}},
    )
    gateway = ServingGateway(
        registry,
        router=Router(policy="affinity", block_size=16,
                      affinity_blocks=2, seed=7),
        admission_policy=AdmissionPolicy(shed_watermark=16,
                                         hard_watermark=64),
        autoscaler=Autoscaler(
            AutoscalerPolicy(min_replicas=2, max_replicas=4,
                             queue_high_water=4.0, dwell_ticks=1,
                             cooldown_seconds=0.0),
            _Provisioner(),
        ),
        node_name="verify",
        clock=gw_clock,
        telemetry=telemetry,
    )
    # Replica 1 is a degraded chip (8 ticks per decoded token): requests
    # routed there miss the tight interactive SLO — the forced violation.
    gateway.add_replica(
        ScriptedEngine(batch_slots=2, prefill_chunk=16, clock=gw_clock),
        "verify-replica-0",
    )
    gateway.add_replica(
        ScriptedEngine(batch_slots=2, prefill_chunk=16,
                       decode_ticks_per_token=8, clock=gw_clock),
        "verify-replica-1",
    )
    gw_handles = []
    for prompt in shared_prefix_prompts(
        22, n_systems=4, system_len=32, tail_len=4, seed=11
    ):
        gw_handles.append(
            gateway.submit(prompt, 2, latency_class="interactive")
        )
    if any(not h.trace_id for h in gw_handles):
        gw_errors.append("gateway handle missing its trace id")
    try:
        gateway.submit([1] * 16, 2, latency_class="batch")
        gw_errors.append(
            "gateway accepted batch traffic past the shed watermark"
        )
    except OverloadedError as shed_err:
        if not getattr(shed_err, "trace_id", ""):
            gw_errors.append("shed OverloadedError missing its trace id")
    for _ in range(100000):
        if not gateway._live:
            break
        gw_clock_box[0] += 0.25
        gateway.tick()
    if gateway.counters["completed"] != 22:
        gw_errors.append(
            f"gateway sim completed {gateway.counters['completed']} "
            "of 22 requests"
        )
    gw_summary = gateway.fleet_slo_summary() or {}
    if not gw_summary.get("violations"):
        gw_errors.append(
            "slow replica forced no SLO violation in fleet_slo_summary"
        )
    if not telemetry.exemplars():
        gw_errors.append("no exemplar captured at violation onset")
    else:
        exemplar = telemetry.exemplars()[-1]
        if exemplar.get("dominantPhase") not in TIMELINE_PHASES:
            gw_errors.append(
                f"exemplar dominantPhase {exemplar.get('dominantPhase')!r} "
                "outside TIMELINE_PHASES"
            )
        # The trace-id join: the exemplar's gid resolves to the finished
        # gateway/submit span carrying the same trace id.
        ex_tl = exemplar.get("timeline") or {}
        joined = telemetry.tracer.find_trace_by_tag("gid", ex_tl.get("gid"))
        if not joined:
            gw_errors.append(
                "exemplar gid does not resolve to a gateway/submit trace"
            )
        elif joined.get("traceId") != exemplar.get("traceId"):
            gw_errors.append(
                "exemplar trace id does not match its submit span's"
            )
    if not any(
        r["kind"] == "scale" and r.get("outcome") == "applied"
        for r in gateway.snapshot()["events"]
    ):
        gw_errors.append("gateway sim produced no applied scale-up")
    gateway_snapshot = gateway.snapshot()
    alloc_errors.extend(gw_errors)

    # The KV-lifecycle families (tpu_dra_kv_*), populated through REAL
    # engine churn: a deliberately tight paged pool (12 blocks, 2 slots)
    # under shared-prefix traffic forces evictions, revivals, and COW
    # recomputes, and KVTelemetry mirrors the ledger onto this registry
    # so the rendered exposition carries lifecycle series a production
    # replica would emit. The engine's /debug/kv document backs the
    # endpoint check below; the gateway sim's ResidencyIndex (measured
    # ScriptedEngine digests joined against the affinity ledger) backs
    # /debug/residency.
    from k8s_dra_driver_tpu_torch.models.llama import PRESETS, init_params
    from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine, KVTelemetry

    kv_errors: list[str] = []
    kv_config = PRESETS["tiny"]
    kv_engine = DecodeEngine(
        init_params(kv_config, seed=0, device="cpu"), kv_config,
        batch_slots=2, num_blocks=12, block_size=8, max_seq_len=48,
        prefill_chunk=8, device="cpu",
    )
    KVTelemetry(registry).attach(kv_engine, replica="verify-kv")
    from k8s_dra_driver_tpu_torch.models.compute_telemetry import (
        ComputeTelemetry,
        device_peaks,
    )

    # The CPU's calibrated peak row: the engine runs on the CPU.
    compute_tel = ComputeTelemetry(registry, peaks=device_peaks("cpu"))
    compute_tel.attach(
        kv_engine, replica="verify-kv", claim_uid="uid-verify"
    )
    kv_base = list(range(1, 17))
    kv_prompts = [
        kv_base + [40 + t] * (5 + 3 * t) for t in range(4)
    ] * 2
    kv_reqs = [
        kv_engine.submit(p, max_new_tokens=12) for p in kv_prompts
    ]
    kv_engine.run()
    kv_engine.assert_no_leaks()
    if any(not r.tokens for r in kv_reqs):
        kv_errors.append("kv churn: a request retired with no tokens")
    kv_digest = kv_engine.kv_residency()
    if kv_digest["indexedBlocks"] != (
        kv_digest["insertedBlocks"] - kv_digest["evictedBlocks"]
    ):
        kv_errors.append(
            "kv churn: residency digest violates indexed == inserted - "
            "evicted"
        )
    if not kv_digest["evictedBlocks"]:
        kv_errors.append(
            "kv churn: the tight pool forced no evictions — the "
            "lifecycle families render unexercised"
        )
    alloc_errors.extend(kv_errors)

    # The compute-plane families (tpu_dra_compute_*), populated through
    # the SAME real engine: the churn above was the warmup (both
    # programs built under the compile ledger's wrappers), so marking
    # the warm horizon and replaying identically-shaped steady-state
    # traffic must record ZERO recompiles — the recompile-storm signal
    # verified quiet on a healthy engine. The collective families get a
    # real site too: an elastic reshard of a tiny TrainState.
    compute_errors: list[str] = []
    compute_tel.mark_warm()
    steady_reqs = [
        kv_engine.submit(kv_base + [90 + t] * 4, max_new_tokens=8)
        for t in range(2)
    ]
    kv_engine.run()
    kv_engine.assert_no_leaks()
    if any(not r.tokens for r in steady_reqs):
        compute_errors.append(
            "compute steady-state: a request retired with no tokens"
        )
    compute_snap = compute_tel.ledger.snapshot()
    for program in ("decode_step", "prefill_chunk"):
        if compute_snap["builds"].get(program) != (
            kv_engine.compile_counts.get(program)
        ):
            compute_errors.append(
                f"compile ledger counts {program} "
                f"{compute_snap['builds'].get(program)} time(s) but the "
                "engine's compile_counts says "
                f"{kv_engine.compile_counts.get(program)}"
            )
    if compute_snap["recompilesSinceWarm"]:
        compute_errors.append(
            "steady-state traffic recompiled after the warm horizon: "
            f"{compute_snap['recompilesSinceWarm']}"
        )
    import torch

    from k8s_dra_driver_tpu_torch.models.train import (
        init_train_state, make_optimizer, reshard_train_state,
    )
    from k8s_dra_driver_tpu_torch.parallel.mesh import build_mesh

    reshard_mesh = build_mesh(devices=[torch.device("cpu")])
    reshard_state = init_train_state(
        kv_config, make_optimizer(), seed=0, mesh=reshard_mesh
    )
    reshard_train_state(reshard_state, reshard_mesh)
    compute_coll = {
        row["site"]: row for row in compute_tel.collectives.snapshot()
    }
    reshard_row = compute_coll.get("train.reshard")
    if reshard_row is None or reshard_row["bytes"] <= 0:
        compute_errors.append(
            "elastic reshard emitted no train.reshard collective bytes"
        )
    alloc_errors.extend(compute_errors)

    # The fleet-soak families (tpu_dra_fleet_*), populated by a REAL
    # mini soak: the deterministic fleet simulator (fleetsim/) drives
    # the full driver+gateway stack through the compressed five-axis
    # scenario. Only the tpu_dra_fleet_* family lands on the scraped
    # registry — the soak's component families (gateway, allocator,
    # driver, ...) live on the FleetCluster's own registry, because this
    # process already populated those names with the sims above.
    from k8s_dra_driver_tpu_torch.fleetsim import FleetSim, mini_scenario

    fleet_errors: list[str] = []
    try:
        fleet_report = FleetSim(
            mini_scenario(), registry=registry
        ).run()
        if not fleet_report["pass"]:
            failed_gates = sorted(
                g for g, v in fleet_report["gates"].items()
                if not v["pass"]
            )
            fleet_errors.append(
                "fleet mini-soak violated gates: "
                + ", ".join(failed_gates)
            )
    except Exception as e:
        fleet_errors.append(f"fleet mini-soak crashed: {e!r}")
    alloc_errors.extend(fleet_errors)

    tracer = Tracer()
    with tracer.span("verify", claim_uid="uid-verify"):
        pass

    errors: list[str] = alloc_errors
    srv = MetricsServer(registry, host="127.0.0.1", port=0, tracer=tracer)
    srv.add_readiness_check("self-test", lambda: (True, "ok"))
    srv.set_usage_provider(lambda: snapshot)
    srv.set_allocations_provider(allocator.export_allocations_jsonl)
    srv.set_defrag_provider(planner.export_json)
    srv.set_rebalance_provider(lambda: rebalance_snapshot)
    srv.set_gateway_provider(lambda: gateway_snapshot)
    srv.set_requests_provider(telemetry.export_requests)
    srv.set_kv_provider(kv_engine.kv_debug)
    srv.set_residency_provider(gateway.residency.snapshot)
    srv.set_compute_provider(compute_tel.compute_debug)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(f"{base}/metrics").read().decode()
        for route in ("/healthz", "/readyz", "/debug/traces",
                      "/debug/usage"):
            resp = urllib.request.urlopen(base + route)
            if resp.status != 200:
                errors.append(f"{route}: HTTP {resp.status}")
        traces = urllib.request.urlopen(f"{base}/debug/traces").read().decode()
        for line in filter(None, traces.splitlines()):
            try:
                json.loads(line)
            except ValueError:
                errors.append(f"/debug/traces: undecodable line {line!r}")
        usage_body = urllib.request.urlopen(
            f"{base}/debug/usage"
        ).read().decode()
        try:
            decoded = json.loads(usage_body)
            if decoded.get("node") != "verify":
                errors.append("/debug/usage: wrong snapshot served")
        except ValueError:
            errors.append("/debug/usage: body is not JSON")
        # /debug/allocations: decodable JSONL, newest record is the
        # forced unsat with an enum-confined reason and a funnel.
        alloc_body = urllib.request.urlopen(
            f"{base}/debug/allocations"
        ).read().decode()
        records = []
        for line in filter(None, alloc_body.splitlines()):
            try:
                records.append(json.loads(line))
            except ValueError:
                errors.append(
                    f"/debug/allocations: undecodable line {line!r}"
                )
        if len(records) != 7:
            errors.append(
                f"/debug/allocations: {len(records)} records (want 7: "
                "three ok, the shortfall unsat, the gang unsat, then "
                "the executed defrag plan's mover re-place and gang "
                "admit)"
            )
        else:
            # Newest record: the defrag execution's admit of the
            # formerly-stuck gang.
            newest = records[-1]
            if newest.get("outcome") != "ok" or (
                newest.get("claim", {}).get("uid") != "uid-frag-gang"
            ):
                errors.append(
                    "/debug/allocations: newest record is not the "
                    "defrag-admitted fragmented gang"
                )
            unsats = [r for r in records if r.get("outcome") == "unsat"]
            if not unsats:
                errors.append("/debug/allocations: no unsat records")
                unsats = [{}]
            latest_unsat = unsats[-1]
            if latest_unsat.get("reason") not in REASONS:
                errors.append(
                    f"/debug/allocations: reason "
                    f"{latest_unsat.get('reason')!r} outside the "
                    "REASONS enum"
                )
            if not latest_unsat.get("funnels"):
                errors.append(
                    "/debug/allocations: unsat record carries no funnel"
                )
            for rec in records:
                for funnel in rec.get("funnels", []):
                    bad = set(funnel.get("rejected", {})) - set(STAGES)
                    if bad:
                        errors.append(
                            f"/debug/allocations: funnel stages {bad} "
                            "outside the STAGES enum"
                        )
        # /debug/defrag: decodable JSON whose newest plan is the
        # fragmented-gang proposal with enum-confined outcome.
        defrag_body = urllib.request.urlopen(
            f"{base}/debug/defrag"
        ).read().decode()
        try:
            defrag_doc = json.loads(defrag_body)
        except ValueError:
            errors.append("/debug/defrag: body is not JSON")
        else:
            served = defrag_doc.get("plans") or []
            if not served:
                errors.append("/debug/defrag: no plans served")
            else:
                if served[-1].get("claim", {}).get("uid") \
                        != "uid-frag-gang":
                    errors.append(
                        "/debug/defrag: newest plan is not the "
                        "fragmented gang's"
                    )
                for p in served:
                    if p.get("outcome") not in OUTCOMES:
                        errors.append(
                            f"/debug/defrag: outcome "
                            f"{p.get('outcome')!r} outside OUTCOMES"
                        )
            # The executions view: the executed fragmented-gang plan's
            # record rides the same document.
            executions = defrag_doc.get("executions") or []
            if not executions:
                errors.append("/debug/defrag: no executions served")
            elif executions[-1].get("state") != "completed":
                errors.append(
                    "/debug/defrag: newest execution is not "
                    f"'completed': {executions[-1].get('state')!r}"
                )
        # /debug/rebalance: decodable JSON whose newest decision is the
        # sim's applied steal, outcomes enum-confined, and both
        # co-tenant claims present with granted-vs-min shares.
        rebalance_body = urllib.request.urlopen(
            f"{base}/debug/rebalance"
        ).read().decode()
        try:
            rebalance_doc = json.loads(rebalance_body)
        except ValueError:
            errors.append("/debug/rebalance: body is not JSON")
        else:
            served_decisions = rebalance_doc.get("decisions") or []
            if not served_decisions:
                errors.append("/debug/rebalance: no decisions served")
            else:
                for dec in served_decisions:
                    if dec.get("outcome") not in REB_OUTCOMES:
                        errors.append(
                            f"/debug/rebalance: outcome "
                            f"{dec.get('outcome')!r} outside OUTCOMES"
                        )
                if served_decisions[-1].get("outcome") != "applied":
                    errors.append(
                        "/debug/rebalance: newest decision is not the "
                        "applied steal"
                    )
            served_claims = rebalance_doc.get("claims") or {}
            for uid in ("uid-slo-infer", "uid-slo-batch"):
                c = served_claims.get(uid)
                if not c or "granted" not in c or "min" not in c:
                    errors.append(
                        f"/debug/rebalance: claim {uid} missing its "
                        "granted-vs-min share view"
                    )
        # /debug/gateway: decodable JSON with both sim replicas, the
        # shed + applied-scale evidence, and enum-confined outcomes.
        gateway_body = urllib.request.urlopen(
            f"{base}/debug/gateway"
        ).read().decode()
        try:
            gateway_doc = json.loads(gateway_body)
        except ValueError:
            errors.append("/debug/gateway: body is not JSON")
        else:
            served_replicas = gateway_doc.get("replicas") or {}
            for rid in ("verify-replica-0", "verify-replica-1"):
                if rid not in served_replicas:
                    errors.append(
                        f"/debug/gateway: replica {rid} missing"
                    )
            gw_events = gateway_doc.get("events") or []
            if not any(e.get("kind") == "shed" for e in gw_events):
                errors.append("/debug/gateway: no shed event recorded")
            for e in gw_events:
                if e.get("kind") != "scale":
                    continue
                if e.get("outcome") not in SCALE_OUTCOMES:
                    errors.append(
                        f"/debug/gateway: scale outcome "
                        f"{e.get('outcome')!r} outside OUTCOMES"
                    )
            if not any(
                e.get("kind") == "scale"
                and e.get("outcome") == "applied"
                for e in gw_events
            ):
                errors.append(
                    "/debug/gateway: no applied scale decision served"
                )
        # /debug/requests: JSONL of every submitted request's sealed
        # timeline (22 finished + 1 shed), enum-confined outcomes,
        # trace ids present; plus the ticks/exemplars/slo views and
        # the 400 on an unknown view.
        requests_body = urllib.request.urlopen(
            f"{base}/debug/requests"
        ).read().decode()
        timeline_docs = []
        for line in filter(None, requests_body.splitlines()):
            try:
                timeline_docs.append(json.loads(line))
            except ValueError:
                errors.append(
                    f"/debug/requests: undecodable line {line!r}"
                )
        if len(timeline_docs) != 23:
            errors.append(
                f"/debug/requests: {len(timeline_docs)} timelines "
                "(want 23: 22 finished + 1 shed)"
            )
        for doc in timeline_docs:
            if doc.get("outcome") not in TRACE_OUTCOMES:
                errors.append(
                    f"/debug/requests: outcome {doc.get('outcome')!r} "
                    "outside OUTCOMES"
                )
            if not doc.get("traceId"):
                errors.append(
                    "/debug/requests: timeline missing its trace id"
                )
            if doc.get("dominantPhase") not in TIMELINE_PHASES:
                errors.append(
                    f"/debug/requests: dominantPhase "
                    f"{doc.get('dominantPhase')!r} outside TIMELINE_PHASES"
                )
        if not any(d.get("outcome") == "shed" for d in timeline_docs):
            errors.append("/debug/requests: shed timeline missing")
        ticks_body = urllib.request.urlopen(
            f"{base}/debug/requests?view=ticks"
        ).read().decode()
        tick_lines = [json.loads(ln)
                      for ln in filter(None, ticks_body.splitlines())]
        if not tick_lines or tick_lines[0].get("kind") != "summary":
            errors.append(
                "/debug/requests?view=ticks: first line is not the "
                "phase summary"
            )
        else:
            phase_keys = set(tick_lines[0].get("phaseSeconds") or {})
            for want in ("gateway/dispatch", "engine/decode"):
                if want not in phase_keys:
                    errors.append(
                        f"?view=ticks summary missing phase {want!r}"
                    )
        exemplars_body = urllib.request.urlopen(
            f"{base}/debug/requests?view=exemplars"
        ).read().decode()
        if not any(filter(None, exemplars_body.splitlines())):
            errors.append("/debug/requests?view=exemplars: empty")
        slo_body = urllib.request.urlopen(
            f"{base}/debug/requests?view=slo"
        ).read().decode()
        try:
            slo_doc = json.loads(slo_body)
        except ValueError:
            errors.append("/debug/requests?view=slo: body is not JSON")
        else:
            for key in ServingTelemetry.SLO_SUMMARY_KEYS:
                if key not in slo_doc:
                    errors.append(
                        f"/debug/requests?view=slo missing key {key!r}"
                    )
        try:
            urllib.request.urlopen(f"{base}/debug/requests?view=bogus")
            errors.append(
                "/debug/requests served an unknown view (want 400)"
            )
        except urllib.error.HTTPError as e:
            if e.code != 400:
                errors.append(
                    f"/debug/requests?view=bogus: HTTP {e.code} "
                    "(want 400)"
                )
        # /debug/kv: the churned engine's lifecycle ledger — decodable
        # JSON, occupancy states summing to the pool, and a residency
        # digest honoring its counter invariant.
        kv_body = urllib.request.urlopen(
            f"{base}/debug/kv"
        ).read().decode()
        try:
            kv_doc = json.loads(kv_body)
        except ValueError:
            errors.append("/debug/kv: body is not JSON")
        else:
            if kv_doc.get("schema") != "tpu-dra-kv-debug-v1":
                errors.append(
                    f"/debug/kv: schema {kv_doc.get('schema')!r} "
                    "(want tpu-dra-kv-debug-v1)"
                )
            kv_occ = kv_doc.get("occupancy") or {}
            if sum(kv_occ.values()) != kv_doc.get("blocksTotal"):
                errors.append(
                    "/debug/kv: occupancy states do not sum to the "
                    f"pool ({kv_occ} vs {kv_doc.get('blocksTotal')})"
                )
            kv_res = kv_doc.get("residency") or {}
            if kv_res.get("indexedBlocks") != (
                kv_res.get("insertedBlocks", 0)
                - kv_res.get("evictedBlocks", 0)
            ):
                errors.append(
                    "/debug/kv: served digest violates indexed == "
                    "inserted - evicted"
                )
        # /debug/residency: the gateway-global measured view — both sim
        # replicas' digests, the fleet rollup keys, and no counter
        # drift on healthy engines.
        res_body = urllib.request.urlopen(
            f"{base}/debug/residency"
        ).read().decode()
        try:
            res_doc = json.loads(res_body)
        except ValueError:
            errors.append("/debug/residency: body is not JSON")
        else:
            if res_doc.get("schema") != "tpu-dra-residency-v1":
                errors.append(
                    f"/debug/residency: schema {res_doc.get('schema')!r} "
                    "(want tpu-dra-residency-v1)"
                )
            res_replicas = res_doc.get("replicas") or {}
            for rid in ("verify-replica-0", "verify-replica-1"):
                if rid not in res_replicas:
                    errors.append(
                        f"/debug/residency: replica {rid} missing"
                    )
            drifted = sorted(
                rid for rid, doc in res_replicas.items()
                if doc.get("counterDrift")
            )
            if drifted:
                errors.append(
                    "/debug/residency: healthy sim replicas report "
                    f"counter drift: {drifted}"
                )
            res_fleet = res_doc.get("fleet") or {}
            for key in ("lookups", "hits", "hitTokens",
                        "measuredHitRate", "uniqueKeys", "keyInstances",
                        "duplicationRatio"):
                if key not in res_fleet:
                    errors.append(
                        f"/debug/residency: fleet view missing {key!r}"
                    )
            if not res_fleet.get("uniqueKeys"):
                errors.append(
                    "/debug/residency: no measured-resident keys — the "
                    "sim replicas published no blocks"
                )
        # /debug/compute: the compute telemetry's document — decodable
        # JSON, the churned engine's programs and exact HBM
        # decomposition, and the reshard's collective row.
        comp_body = urllib.request.urlopen(
            f"{base}/debug/compute"
        ).read().decode()
        try:
            comp_doc = json.loads(comp_body)
        except ValueError:
            errors.append("/debug/compute: body is not JSON")
        else:
            if comp_doc.get("schema") != "tpu-dra-compute-debug-v1":
                errors.append(
                    f"/debug/compute: schema {comp_doc.get('schema')!r} "
                    "(want tpu-dra-compute-debug-v1)"
                )
            if not comp_doc.get("warm"):
                errors.append(
                    "/debug/compute: warm horizon not marked"
                )
            comp_programs = comp_doc.get("programs") or {}
            for program in ("decode_step", "prefill_chunk"):
                if "verify-kv" not in (comp_programs.get(program) or {}):
                    errors.append(
                        f"/debug/compute: program {program} has no "
                        "verify-kv roofline"
                    )
            comp_hbm = (comp_doc.get("hbm") or {}).get("verify-kv") or {}
            if comp_hbm.get("totalBytes") != (
                comp_hbm.get("weightsBytes", 0)
                + comp_hbm.get("kvPoolBytes", 0)
            ):
                errors.append(
                    "/debug/compute: hbm decomposition does not sum "
                    f"({comp_hbm})"
                )
            comp_sites = {
                row.get("site")
                for row in comp_doc.get("collectives") or []
            }
            if "train.reshard" not in comp_sites:
                errors.append(
                    "/debug/compute: train.reshard collective row "
                    "missing"
                )
        # The scrape surface is GET-only by contract — /metrics and the
        # debug endpoints alike.
        for route in ("/metrics", "/debug/allocations", "/debug/defrag",
                      "/debug/rebalance", "/debug/gateway",
                      "/debug/requests", "/debug/kv",
                      "/debug/residency", "/debug/compute"):
            try:
                urllib.request.urlopen(base + route, data=b"x")
                errors.append(f"{route} accepted a POST (want 405)")
            except urllib.error.HTTPError as e:
                if e.code != 405:
                    errors.append(
                        f"{route} POST: HTTP {e.code} (want 405)"
                    )
    finally:
        srv.stop()
    for family in ("tpu_dra_usage_allocated_device_seconds_total",
                   "tpu_dra_usage_occupied_devices",
                   "tpu_dra_usage_claim_hold_seconds",
                   "tpu_dra_usage_chip_claims",
                   "tpu_dra_audit_findings",
                   "tpu_dra_audit_runs_total",
                   "tpu_dra_alloc_solve_seconds",
                   "tpu_dra_alloc_funnel_rejections_total",
                   "tpu_dra_alloc_unsat_total",
                   "tpu_dra_defrag_plans_total",
                   "tpu_dra_defrag_plan_seconds",
                   "tpu_dra_defrag_last_plan_migrations",
                   "tpu_dra_defrag_exec_executions_total",
                   "tpu_dra_defrag_exec_steps_total",
                   "tpu_dra_defrag_exec_seconds",
                   "tpu_dra_defrag_exec_last_execution_timestamp_seconds",
                   "tpu_dra_defrag_exec_in_flight",
                   "tpu_dra_slo_rebalance_decisions_total",
                   "tpu_dra_slo_granted_share",
                   "tpu_dra_slo_min_share",
                   "tpu_dra_slo_rebalance_seconds",
                   "tpu_dra_slo_violations_total",
                   "tpu_dra_gw_routed_total",
                   "tpu_dra_gw_affinity_lookups_total",
                   "tpu_dra_gw_affinity_hits_total",
                   "tpu_dra_gw_queue_depth",
                   "tpu_dra_gw_shed_total",
                   "tpu_dra_gw_replicas",
                   "tpu_dra_gw_scale_decisions_total",
                   "tpu_dra_gw_requests_total",
                   "tpu_dra_srv_ttft_seconds",
                   "tpu_dra_srv_e2e_seconds",
                   "tpu_dra_srv_token_interval_seconds",
                   "tpu_dra_srv_tick_phase_seconds",
                   "tpu_dra_srv_slo_violations_total",
                   "tpu_dra_srv_violation_seconds_total",
                   "tpu_dra_srv_timelines_total",
                   "tpu_dra_srv_exemplars_total",
                   "tpu_dra_kv_pool_blocks",
                   "tpu_dra_kv_indexed_blocks",
                   "tpu_dra_kv_prefix_runs",
                   "tpu_dra_kv_evicted_blocks_total",
                   "tpu_dra_kv_evicted_tokens_total",
                   "tpu_dra_kv_alloc_misses_total",
                   "tpu_dra_kv_revivals_total",
                   "tpu_dra_kv_cow_recomputes_total",
                   "tpu_dra_kv_eviction_lru_age_ops",
                   "tpu_dra_kv_request_footprint_blocks",
                   "tpu_dra_compute_compiles_total",
                   "tpu_dra_compute_recompiles_total",
                   "tpu_dra_compute_steps_total",
                   "tpu_dra_compute_compile_seconds",
                   "tpu_dra_compute_mfu_ratio",
                   "tpu_dra_compute_achieved_flops_per_s",
                   "tpu_dra_compute_achieved_bytes_per_s",
                   "tpu_dra_compute_hbm_bytes",
                   "tpu_dra_compute_hbm_watermark_bytes",
                   "tpu_dra_compute_collective_bytes_total",
                   "tpu_dra_compute_collective_invocations_total",
                   "tpu_dra_residency_fleet_hit_rate_ratio",
                   "tpu_dra_residency_duplication_ratio",
                   "tpu_dra_residency_unique_keys",
                   "tpu_dra_residency_stale_ledger_keys",
                   "tpu_dra_residency_replica_indexed_blocks",
                   "tpu_dra_gw_affinity_ledger_keys",
                   "tpu_dra_fleet_ticks_total",
                   "tpu_dra_fleet_requests_total",
                   "tpu_dra_fleet_slo_p99_seconds",
                   "tpu_dra_fleet_chip_seconds",
                   "tpu_dra_fleet_autoscaler_efficiency_ratio",
                   "tpu_dra_fleet_audit_findings_total",
                   "tpu_dra_fleet_gate_failures_total"):
        if f"\n{family}" not in body and not body.startswith(family):
            errors.append(f"expected family {family} missing from scrape")
    # The rendered stage/reason label values stay inside the enums the
    # lint (TPM06) pins at the call sites — the runtime half of the same
    # contract.
    enum_labels = {"stage": set(STAGES), "reason": set(REASONS)}
    for line in body.splitlines():
        if not line.startswith("tpu_dra_alloc") or "{" not in line:
            continue
        for pair in re.findall(rf'({_LABEL_NAME})="({_LABEL_VALUE})"',
                               line.split("{", 1)[1]):
            allowed = enum_labels.get(pair[0])
            if allowed is not None and pair[1] not in allowed:
                errors.append(
                    f"label {pair[0]}={pair[1]!r} on {line.split(' ')[0]} "
                    "outside the allocator's enum"
                )
    return body, errors


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--url", default="",
        help="scrape this /metrics URL instead of self-hosting a server",
    )
    parser.add_argument(
        "--max-series-per-family", type=int, default=500,
        help="series-count bound per metric family",
    )
    parser.add_argument(
        "--max-chip-series", type=int, default=64,
        help="tighter series bound for families carrying per-chip labels "
             "(chip/uuid/device)",
    )
    args = parser.parse_args(argv)
    if args.url:
        import urllib.request

        body = urllib.request.urlopen(args.url).read().decode()
        errors = []
    else:
        sys.path.insert(0, ".")
        body, errors = _self_test_scrape()
    errors += validate_exposition(body)
    errors += check_cardinality(
        body, args.max_series_per_family, args.max_chip_series
    )
    for err in errors:
        print(err, file=sys.stderr)
    n_samples = sum(
        1 for ln in body.splitlines() if ln and not ln.startswith("#")
    )
    print(
        f"verify-metrics: {n_samples} samples, {len(errors)} errors",
        file=sys.stderr,
    )
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
