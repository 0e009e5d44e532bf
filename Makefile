# Build/test entrypoints (reference: Makefile:58-102).
IMAGE ?= tpu-dra-driver
TAG ?= latest

.PHONY: all native test image lint verify verify-metrics chaos chaos-slow doctor decodebench moebench elastic allocbench allocbench-smoke gatewaybench tracesmoke kvsmoke computesmoke defragsmoke fleetsmoke clean e2e-kind

all: native

native:
	$(MAKE) -C k8s_dra_driver_tpu/native

test: native
	python -m pytest tests/ -q

# Deterministic chaos suite: seeded fault schedules (utils/faults.py)
# through the cluster sim, asserting the four robustness invariants
# (tests/test_chaos.py). The seed is FIXED so CI failures replay exactly;
# override with TPU_DRA_CHAOS_SEED=... to explore. Long randomized
# schedules are marked `slow` — run those with `make chaos-slow`.
TPU_DRA_CHAOS_SEED ?= 1234
chaos:
	TPU_DRA_CHAOS_SEED=$(TPU_DRA_CHAOS_SEED) \
		python -m pytest tests/test_chaos.py -q -m 'not slow'

chaos-slow:
	TPU_DRA_CHAOS_SEED=$(TPU_DRA_CHAOS_SEED) \
		python -m pytest tests/test_chaos.py -q

# Doctor gate: the support-bundle CLI against the cluster sim. A clean
# fleet must diagnose CLEAN (any drift finding fails the target),
# injected crash artifacts (orphan CDI spec + torn checkpoint) must be
# flagged by both the node auditor and the doctor, and an unallocatable
# claim must travel the explainability chain (typed AllocationError →
# /debug/allocations → the doctor's `explain` finding with its runbook
# hint).
doctor:
	python tools/run_doctor_sim.py

# Decode-engine smoke: fixed-seed traffic through the continuous-batching
# engine on CPU, asserting the compile-once invariant per serving variant
# (bf16/int8/kvq), deterministic token streams, and bounded repeat spread
# (tools/run_decode_smoke.py) — the fast gate for the BENCH_r05
# recompile-spread regression.
decodebench:
	python tools/run_decode_smoke.py

# MoE fast-path smoke: fixed-seed CPU gates for the sparse family
# (tools/run_moe_smoke.py) — compile-once per dispatch impl
# (MOE_TRACE_COUNTS oracle), einsum/binned/dropless equivalence at
# drop-free capacity, fused-kernel-vs-primitive parity
# (ops/moe_dispatch.py in interpret mode), the `auto` impl-selection
# policy against its recorded ranking, and a repeat-spread tripwire
# mirroring _decodebench.spread_flags for the mixtral metrics.
moebench:
	python tools/run_moe_smoke.py

# Elastic-training smoke: fixed-seed chip-unplug → gang shrink →
# live reshard → resume (then the symmetric grow) through the real
# Driver + allocator + ElasticTrainer on the CPU backend
# (tools/run_elastic_smoke.py). The StateAuditor is the no-drift
# oracle; loss continuity gates the resharding math. The long soak
# variant is the `slow`-marked test_chaos.py::TestElasticGangResize
# soak (run via `make chaos-slow`).
elastic:
	TPU_DRA_CHAOS_SEED=$(TPU_DRA_CHAOS_SEED) \
		python tools/run_elastic_smoke.py

# Allocator throughput + fragmentation bench (tools/run_alloc_bench.py):
# incremental-index solves/sec vs the from-scratch baseline (gated >=10x
# on the full profile), p50/p99 solve latency, and the scored-vs-first-fit
# large-gang admission comparison under seeded churn (gated: the scorer
# must not admit fewer). The full profile (10k devices / 1k claims)
# writes ALLOC_r01.json next to the BENCH files; `make verify` runs the
# small fixed-seed smoke profile.
ALLOC_BENCH_SEED ?= 1234
allocbench:
	ALLOC_BENCH_SEED=$(ALLOC_BENCH_SEED) \
		python tools/run_alloc_bench.py --profile full

allocbench-smoke:
	ALLOC_BENCH_SEED=$(ALLOC_BENCH_SEED) \
		python tools/run_alloc_bench.py --profile smoke

# Fleet-gateway smoke (tools/run_gateway_smoke.py): fixed-seed
# shared-prefix traffic through two real DecodeEngine replicas on CPU —
# prefix-affinity routing gated >= 1.3x round-robin fleet req/s
# (tick-normalized, deterministic) at equal-or-lower p99 token latency,
# compile-once per replica, plus a scripted-engine drain that must lose
# zero admitted requests.
gatewaybench:
	python tools/run_gateway_smoke.py

# Defrag-execution smoke (tools/run_defrag_smoke.py): a checkerboarded
# fleet leaves a 2-chip gang unsat; the DefragPlanner's plan is executed
# by the DefragExecutor through a seeded crash window at one of the
# defrag.* sites, then recovered by a "restarted" executor. PASS gates:
# the gang ends admitted on the freed box, allocator/node-state/checkpoint
# agree, the StateAuditor reports zero residual drift, no execution
# intent is orphaned, and every admitted serving request finishes.
defragsmoke:
	TPU_DRA_CHAOS_SEED=$(TPU_DRA_CHAOS_SEED) \
		python tools/run_defrag_smoke.py

# Fleet soak smoke (tools/run_fleet_smoke.py): the deterministic
# discrete-event fleet simulator (k8s_dra_driver_tpu/fleetsim/) drives
# the REAL gateway + plugin loop + allocator through a scripted day —
# diurnal load per tenant class, a shared-prefix flash crowd, chip
# unplug/flap chaos, an apiserver blackout, and a fragmentation-stranded
# gang un-stranded by defrag execution — then gates on zero admitted
# loss (typed), auditor silence, per-class p99 budgets, autoscaler
# efficiency vs the oracle schedule, and rebalancer min-share floors.
# Emits the byte-reproducible FLEET_r01.json artifact at the repo root.
fleetsmoke:
	TPU_DRA_CHAOS_SEED=$(TPU_DRA_CHAOS_SEED) \
		python tools/run_fleet_smoke.py

# Request-observability overhead smoke (tools/run_trace_smoke.py): the
# same fixed-seed serving profile with telemetry OFF vs ON — token
# streams, tick counts (the deterministic "within 3% req/s" enforcement)
# and compile-once must be identical, every submission must seal a
# timeline, and best-of-N wall clock must stay inside the
# TPU_DRA_TRACE_SMOKE_OVERHEAD tripwire (loose on CPU; 3% on TPU).
tracesmoke:
	python tools/run_trace_smoke.py

# KV-telemetry zero-cost smoke (tools/run_kv_smoke.py): the same
# fixed-seed churn profile per quantization variant (bf16/int8/kvq)
# with the KV lifecycle ledger unexported vs exported (KVTelemetry +
# registry scrapes mid-run) — token streams, tick counts, and
# compile-once must be bitwise identical, the residency digest must
# stay self-consistent under eviction churn, and best-of-N wall clock
# must stay inside the TPU_DRA_KV_SMOKE_OVERHEAD tripwire.
kvsmoke:
	python tools/run_kv_smoke.py

# Compute-telemetry zero-cost smoke (tools/run_compute_smoke.py): the
# same fixed-seed serving profile per quantization variant (bf16/int8/
# kvq) with the compute plane unobserved vs observed (ComputeTelemetry
# + registry scrapes mid-run) — token streams, tick counts, and
# compile-once must be bitwise identical, the CompileLedger must match
# the engine's compile_counts exactly with zero recompiles past the
# warm horizon, and best-of-N wall clock must stay inside the
# TPU_DRA_COMPUTE_SMOKE_OVERHEAD tripwire.
computesmoke:
	python tools/run_compute_smoke.py

# The full local gate: lint + unit/integration tests + chaos schedules +
# metrics exposition + the doctor/auditor drill + the decode-engine,
# MoE fast-path, elastic-training, allocator-bench, fleet-gateway,
# request-observability, KV-telemetry, compute-telemetry,
# defrag-execution, and fleet-soak smokes. What CI runs; what a PR must
# pass.
verify: lint test chaos verify-metrics doctor decodebench moebench elastic allocbench-smoke gatewaybench tracesmoke kvsmoke computesmoke defragsmoke fleetsmoke

# ruff when available (CI installs it; .golangci.yaml analog is
# [tool.ruff] in pyproject.toml), else the first-party AST lint floor.
lint:
	@if command -v ruff >/dev/null 2>&1; then \
		ruff check k8s_dra_driver_tpu tests tools bench.py __graft_entry__.py; \
	else \
		python tools/lint.py; \
	fi

# Scrape a started debug server (worst-case registry: escaping, ±Inf,
# aliases) and fail on malformed exposition lines. VERIFY_METRICS_URL=...
# points it at a live plugin/controller instead.
verify-metrics:
	@if [ -n "$(VERIFY_METRICS_URL)" ]; then \
		python tools/verify_metrics.py --url "$(VERIFY_METRICS_URL)"; \
	else \
		python tools/verify_metrics.py; \
	fi

image:
	docker build -t $(IMAGE):$(TAG) -f deployments/container/Dockerfile .

# The real-control-plane gate: kind + helm + the REAL scheduler
# allocating tpu-test1 end-to-end, cross-checked against the sim
# allocator. Needs docker/kind/kubectl/helm; exits 3 (skip) without
# them. Writes a transcript next to the script.
e2e-kind:
	demo/clusters/kind/e2e.sh

clean:
	$(MAKE) -C k8s_dra_driver_tpu/native clean

# The PyTorch port's gate (k8s_dra_driver_tpu_torch): the twins of the
# tools above, beside them with a _torch suffix, with the same gates,
# seeds and TPU_DRA_* variables. It needs neither JAX nor grpcio, so it
# runs on a GPU node. DEVICE is where the model tools run: cuda (the
# default; without a card they raise, never fall back) or cpu.
.PHONY: verify-torch lint-torch verify-metrics-torch doctor-torch decodebench-torch moebench-torch elastic-torch allocbench-smoke-torch gatewaybench-torch tracesmoke-torch kvsmoke-torch computesmoke-torch defragsmoke-torch fleetsmoke-torch demo-torch image-torch e2e-kind-torch
DEVICE ?= cuda

verify-torch: lint-torch verify-metrics-torch doctor-torch decodebench-torch moebench-torch elastic-torch allocbench-smoke-torch gatewaybench-torch tracesmoke-torch kvsmoke-torch computesmoke-torch defragsmoke-torch fleetsmoke-torch demo-torch

# tools/lint.py's checks, in the port's own copy, over the port's files
# (the package, chip_smoke.py, the *_torch.py twins); the metric rules
# read the port's kube/allocator.py enums.
lint-torch:
	python tools/lint_torch.py

verify-metrics-torch:
	@if [ -n "$(VERIFY_METRICS_URL)" ]; then \
		python tools/verify_metrics_torch.py --url "$(VERIFY_METRICS_URL)"; \
	else \
		python tools/verify_metrics_torch.py; \
	fi

doctor-torch:
	python tools/run_doctor_sim_torch.py

decodebench-torch:
	python tools/run_decode_smoke_torch.py --device $(DEVICE)

moebench-torch:
	python tools/run_moe_smoke_torch.py --device $(DEVICE)

elastic-torch:
	TPU_DRA_CHAOS_SEED=$(TPU_DRA_CHAOS_SEED) \
		python tools/run_elastic_smoke_torch.py --device $(DEVICE)

allocbench-smoke-torch:
	ALLOC_BENCH_SEED=$(ALLOC_BENCH_SEED) \
		python tools/run_alloc_bench_torch.py --profile smoke

# Two DecodeEngine replicas behind the port's gateway: affinity >= 1.3x
# round-robin (tick-normalized) at equal-or-lower p99, compile-once per
# replica, plus the scripted-engine drain.
gatewaybench-torch:
	python tools/run_gateway_smoke_torch.py --device $(DEVICE)

tracesmoke-torch:
	python tools/run_trace_smoke_torch.py --device $(DEVICE)

kvsmoke-torch:
	python tools/run_kv_smoke_torch.py --device $(DEVICE)

computesmoke-torch:
	python tools/run_compute_smoke_torch.py --device $(DEVICE)

defragsmoke-torch:
	TPU_DRA_CHAOS_SEED=$(TPU_DRA_CHAOS_SEED) \
		python tools/run_defrag_smoke_torch.py

# Prints the report's gates; writes the report only to an explicit
# --out (FLEET_r01.json is the reference's record).
fleetsmoke-torch:
	TPU_DRA_CHAOS_SEED=$(TPU_DRA_CHAOS_SEED) \
		python tools/run_fleet_smoke_torch.py

# The hermetic quickstart over the port's own gRPC sockets; its output
# equals the fenced block of docs/demo-transcript.md.
demo-torch:
	python demo/run_demo_sim_torch.py

# The port's driver image: the control plane without torch, grpcio or
# protobuf (deployments/container/Dockerfile.torch). Install it on H100
# nodes with the unchanged chart and values-h100.yaml.
image-torch:
	docker build -t $(IMAGE)-torch:$(TAG) -f deployments/container/Dockerfile.torch .

# The kind e2e gate on the port's image: fake H100 chips, the real
# scheduler allocating tpu-test1, cross-checked against the port's sim
# allocator. Exits 3 (skip) without docker/kind/kubectl/helm.
e2e-kind-torch:
	demo/clusters/kind/e2e-torch.sh
