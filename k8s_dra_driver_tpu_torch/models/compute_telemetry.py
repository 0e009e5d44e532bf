"""Compute-plane observability: compile ledger, roofline step telemetry,
HBM footprint, and collective accounting — the compute twin of the
serving path's request tracing (serving_gateway/reqtrace.py) and the KV
tier's lifecycle ledger (serving.KVTelemetry). Counterpart of
``k8s_dra_driver_tpu/models/compute_telemetry.py``, copied but for what
touches JAX.

Everything here is opt-in and zero-cost when off, pinned by
tests/test_torch_compute_telemetry.py: attaching
:class:`ComputeTelemetry` must leave token streams, tick counts, the
compile-once counters and the kernels' launch counters identical,
because the telemetry only *reads* seams the engine already maintains —

- **CompileLedger**: every program build, observed through the existing
  seams (``DecodeEngine.compile_counts``, ``decode.TRACE_OBSERVERS``,
  ``moe.TRACE_OBSERVERS``, ``train.TRACE_OBSERVERS``). On the card a
  build is a CUDA-graph capture; eagerly (the CPU, ``capture=False``) a
  shape's first use (``models/step_graph.py``). Engine programs
  additionally get a build wall time (the warm-up, the capture and the
  first replay, measured around the call that bumped the counter) and a
  deterministic FLOPs/bytes cost estimate, the port's only cost source:
  it has no lowered programs to ask. Builds recorded after
  :meth:`mark_warm` are first-class *recompile-storm* signals: they land
  in ``tpu_dra_compute_recompiles_total``.
- **Roofline step telemetry**: per-program scrape-window deltas of the
  engine's own step/token counters converted to achieved FLOPs/s,
  bytes/s, and MFU against :data:`PEAK_TABLE` (the CPU row is a
  calibrated fake so tests are deterministic), with compute-vs-memory-
  bound classification by arithmetic intensity vs the device ridge
  point.
- **HBM footprint ledger**: exact pool bytes from the live paged-KV
  pools (their scratch row included), exact weight bytes from the params
  dict, and a kv-used watermark — per replica, labeled with the claim
  UID so operators can join it against the ``tpu_dra_usage_*``
  accountant.
- **Collective accounting**: the ``parallel/collectives.py`` emission
  layer's per-site byte/invocation ledger, exported as
  ``tpu_dra_compute_collective_*``. Its sites are the expert-parallel MoE
  paths' (``moe.ep_ring.x``/``.y``/``.all_gather``/``.aux``,
  ``moe.ep_psum.combine``), so an engine on a mesh reads the ring's and
  the psum's traffic apart; a sharded engine's weight bytes count each
  shard once (``parallel.sharding.Sharded.nbytes``).

Scrape surface: the ``tpu_dra_compute_*`` families and the GET-only
``/debug/compute`` document (:meth:`ComputeTelemetry.compute_debug`),
wired via ``MetricsServer.set_compute_provider``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from collections import deque
from typing import Any, Callable, Optional

import torch

__all__ = [
    "PEAK_TABLE",
    "device_peaks",
    "roofline",
    "estimate_decode_step_cost",
    "estimate_prefill_chunk_cost",
    "tree_nbytes",
    "engine_hbm",
    "train_state_hbm",
    "CompileLedger",
    "ComputeTelemetry",
    "load_bench_trajectory",
    "bench_mfu_baseline",
]

# Per-device peak (FLOP/s, HBM bytes/s), keyed by substring of the
# lowercased device name (``torch.cuda.get_device_name()``). The H100 row
# is the SXM part's dense bf16 and HBM3 figures (NVIDIA H100 data sheet);
# its key matches only that part, so an H100 PCIe (756 TFLOP/s, 2.0 TB/s)
# does not take it. The "cpu" row is a CALIBRATED FAKE — a fixed,
# documented pair so CPU tests compute deterministic MFU/roofline numbers
# instead of guessing host hardware. The other rows are the reference's,
# kept so the two tables stay comparable.
PEAK_TABLE: dict[str, tuple[float, float]] = {
    "h100 80gb hbm3": (989e12, 3.35e12),
    "v5e": (197e12, 819e9),
    "v5p": (459e12, 2765e9),
    "v6e": (918e12, 1640e9),
    "v4": (275e12, 1228e9),
    "cpu": (1e11, 5e10),
}


def device_peaks(kind: Optional[str] = None) -> dict:
    """Resolve the peak row for ``kind`` (default: the name of the
    current CUDA device; with no card present and no ``kind`` it raises
    rather than take the cpu row). A named kind that matches no row takes
    the cpu fake so the math stays defined — the row records which kind
    actually matched."""
    if kind is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_peaks: no CUDA device; pass kind= (\"cpu\" for "
                "the calibrated fake) or explicit peaks")
        kind = torch.cuda.get_device_name()
    low = str(kind).lower()
    for key, (pf, pb) in PEAK_TABLE.items():
        if key in low:
            return {"kind": str(kind), "matched": key,
                    "peakFlopsPerS": pf, "peakBytesPerS": pb}
    pf, pb = PEAK_TABLE["cpu"]
    return {"kind": str(kind), "matched": "cpu",
            "peakFlopsPerS": pf, "peakBytesPerS": pb}


def roofline(flops: float, nbytes: float, seconds: float,
             peak_flops: float, peak_bytes: float) -> dict:
    """Pure roofline math (pinned by tests on a fake peak table):
    achieved rates, MFU, memory-bandwidth fraction, and the
    compute-vs-memory-bound classification by arithmetic intensity
    against the device ridge point (peak_flops / peak_bytes)."""
    if seconds <= 0.0 or (flops <= 0.0 and nbytes <= 0.0):
        return {
            "flopsPerS": 0.0, "bytesPerS": 0.0, "mfu": 0.0,
            "membwFraction": 0.0, "intensity": 0.0,
            "ridge": peak_flops / peak_bytes if peak_bytes else 0.0,
            "boundBy": "idle", "windowS": max(seconds, 0.0),
        }
    achieved_f = flops / seconds
    achieved_b = nbytes / seconds
    intensity = flops / nbytes if nbytes > 0 else float("inf")
    ridge = peak_flops / peak_bytes if peak_bytes else 0.0
    return {
        "flopsPerS": achieved_f,
        "bytesPerS": achieved_b,
        "mfu": achieved_f / peak_flops if peak_flops else 0.0,
        "membwFraction": achieved_b / peak_bytes if peak_bytes else 0.0,
        "intensity": intensity,
        "ridge": ridge,
        "boundBy": "memory" if intensity < ridge else "compute",
        "windowS": seconds,
    }


def tree_nbytes(tree: Any) -> int:
    """Exact bytes of every tensor in a params dict (dicts, lists, tuples
    and dataclasses such as the optimizer state walked; a QuantTensor
    counts its q + scale tensors, so quantized dicts are exact too)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return int(getattr(tree, "nbytes", 0))


def estimate_decode_step_cost(config, *, batch: int, context: float,
                              streamed_bytes: int,
                              kv_bytes_per_token: float) -> tuple:
    """Deterministic (FLOPs, HBM bytes) estimate for one decode step:
    ``batch`` tokens at mean ``context``, streaming every non-embedding
    weight byte once plus each sequence's filled cache."""
    flops = batch * config.flops_per_token(int(context))
    nbytes = streamed_bytes + batch * context * kv_bytes_per_token
    return float(flops), float(nbytes)


def estimate_prefill_chunk_cost(config, *, tokens: int,
                                context: float,
                                streamed_bytes: int) -> tuple:
    """Deterministic (FLOPs, HBM bytes) estimate for one packed prefill
    launch advancing ``tokens`` computed prompt tokens."""
    flops = tokens * config.flops_per_token(int(context))
    return float(flops), float(streamed_bytes)


def _row_bytes(engine) -> int:
    """Bytes of one pool row (one position of every layer and kv head,
    k and v, and their scales when quantized): the pools hold the
    allocator's ``num_blocks * block_size`` rows plus one scratch row."""
    rows = engine.allocator.num_blocks * engine.block_size + 1
    return sum(int(p.nbytes) for p in engine._pools) // rows


def engine_hbm(engine) -> dict:
    """Exact HBM decomposition of one DecodeEngine: weight bytes from
    the live params dict, pool bytes from the live paged-KV pools
    (bf16 or int8+scales — whatever was actually allocated, the scratch
    row included), and the in-use share from the allocator's occupancy
    states (the in-use blocks' rows)."""
    pool_bytes = sum(int(p.nbytes) for p in engine._pools)
    weights = tree_nbytes(engine.params)
    occ = engine.allocator.occupancy()
    total_blocks = engine.allocator.num_blocks
    used_blocks = total_blocks - occ["free"]
    kv_used = _row_bytes(engine) * engine.block_size * used_blocks
    return {
        "weightsBytes": weights,
        "kvPoolBytes": pool_bytes,
        "kvUsedBytes": kv_used,
        "kvUsedBlocks": used_blocks,
        "totalBytes": weights + pool_bytes,
    }


def train_state_hbm(state) -> dict:
    """Exact weight + optimizer bytes of a TrainState (the training-side
    HBM ledger entry; the optimizer's moments are dicts of tensors)."""
    params = tree_nbytes(state.params)
    opt = tree_nbytes(state.opt_state)
    return {
        "paramsBytes": params,
        "optimizerBytes": opt,
        "totalBytes": params + opt,
    }


class CompileLedger:
    """Every program build, as a bounded record ring plus per-program
    counters.

    The invariant pinned by tests/test_torch_compute_telemetry.py: for
    engine-level programs the ledger's build count equals the engine's
    own ``compile_counts`` exactly — the ledger observes the same seam,
    it never counts on its own. After :meth:`mark_warm`, further builds
    are *recompiles*: the recompile-storm signal (the counter), the only
    way to see per-shape recompilation."""

    def __init__(self, max_records: int = 256):
        self.records: deque = deque(maxlen=max_records)
        self.total_builds = 0
        self.builds: dict[str, int] = {}
        self.builds_by_variant: dict[tuple, int] = {}
        self.recompiles: dict[str, int] = {}
        self.warm = False

    def mark_warm(self) -> None:
        """Declare the warmup horizon passed: every program this process
        will run steady-state has been built. Builds after this point
        are recompiles."""
        self.warm = True

    def record_build(self, program: str, *, variant: str = "",
                     shapes: Any = None, compile_s: Optional[float] = None,
                     flops: Optional[float] = None,
                     nbytes: Optional[float] = None,
                     replica: str = "") -> dict:
        record = {
            "program": program,
            "variant": variant,
            "shapes": shapes,
            "compileS": compile_s,
            "flops": flops,
            "bytes": nbytes,
            "replica": replica,
            "afterWarm": self.warm,
        }
        self.records.append(record)
        self.total_builds += 1
        self.builds[program] = self.builds.get(program, 0) + 1
        vkey = (program, variant)
        self.builds_by_variant[vkey] = (
            self.builds_by_variant.get(vkey, 0) + 1
        )
        if self.warm:
            self.recompiles[program] = self.recompiles.get(program, 0) + 1
        return record

    def snapshot(self) -> dict:
        return {
            "warm": self.warm,
            "totalBuilds": self.total_builds,
            "builds": dict(self.builds),
            "recompilesSinceWarm": dict(self.recompiles),
            "records": [dict(r) for r in self.records],
        }


class ComputeTelemetry:
    """Pull-model exporter for the ``tpu_dra_compute_*`` catalog (minus
    the collective counters, declared with their vocabulary in
    parallel/collectives.py).

    Mirrors KVTelemetry's discipline: the hot paths keep plain ints
    (``compile_counts``, ``ServingStats``, the collective ledger); this
    class syncs deltas into the registry from a render hook, i.e. at
    scrape time only. Attaching to an engine wraps its two step objects
    (the ``StepGraph``s ``_decode`` and ``_prefill``) in a pass-through
    that times the calls which bumped the compile counter — a
    branch-free delegate on the steady-state path, restored exactly by
    :meth:`detach`. While attached, the engine's ``_decode`` and
    ``_prefill`` are those functions; the step objects are their
    ``__wrapped__``.

    ``peaks`` defaults to :func:`device_peaks` of the current card,
    which raises where there is none.

    Usage::

        telemetry = ComputeTelemetry(registry)
        telemetry.attach(engine, replica="r0", claim_uid="uid-1")
        ... warmup traffic ...
        telemetry.mark_warm()
        server.set_compute_provider(telemetry.compute_debug)
    """

    _WINDOW = 32  # scrape samples retained per replica

    def __init__(self, registry, *, peaks: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic):
        from ..parallel.collectives import (
            CollectiveLedger,
            CollectiveMetrics,
        )
        from ..utils.metrics import Counter, Gauge, Histogram

        # Peaks first: device_peaks raises where there is no card, and
        # then nothing may have been installed.
        self._peaks = peaks or device_peaks()
        self.ledger = CompileLedger()
        self.collectives = CollectiveLedger()
        self.collectives.install()
        self._clock = clock
        self._engines: dict[str, Any] = {}
        self._claims: dict[str, Optional[str]] = {}
        self._wrapped: dict[str, list] = {}
        self._windows: dict[str, deque] = {}
        self._published: dict[tuple, float] = {}
        self._program_stats: dict[tuple, dict] = {}
        self._hbm: dict[str, dict] = {}
        self._watermarks: dict[str, int] = {}
        self._external_steps: dict[tuple, dict] = {}
        self._trace_hooks: list = []

        self._c_compiles = Counter(
            "tpu_dra_compute_compiles_total",
            "Jitted-program builds recorded by the compile ledger, by "
            "program and serving variant.",
            registry,
        )
        self._c_recompiles = Counter(
            "tpu_dra_compute_recompiles_total",
            "Program builds observed AFTER the warmup horizon "
            "(mark_warm) — the recompile-storm signal the doctor "
            "raises a DRIFT finding on.",
            registry,
        )
        self._c_steps = Counter(
            "tpu_dra_compute_steps_total",
            "Executed steps per compiled program (decode steps, packed "
            "prefill launches, observed train steps).",
            registry,
        )
        self._h_compile = Histogram(
            "tpu_dra_compute_compile_seconds",
            "Build wall time per program: trace + XLA compile + the "
            "first dispatch, measured around the call that bumped the "
            "compile counter.",
            registry,
            buckets=(0.01, 0.05, 0.25, 1.0, 5.0, 25.0, 100.0, 500.0),
        )
        self._g_mfu = Gauge(
            "tpu_dra_compute_mfu_ratio",
            "Model FLOPs utilization per program over the last scrape "
            "window (achieved FLOPs/s over the device peak; the cpu "
            "row of the peak table is a calibrated fake).",
            registry,
        )
        self._g_flops = Gauge(
            "tpu_dra_compute_achieved_flops_per_s",
            "Achieved FLOPs/s per program over the last scrape window "
            "(deterministic cost estimator x the engine's own step/"
            "token counters).",
            registry,
        )
        self._g_bytes = Gauge(
            "tpu_dra_compute_achieved_bytes_per_s",
            "Achieved HBM bytes/s per program over the last scrape "
            "window (streamed weights + paged-KV reads).",
            registry,
        )
        self._g_hbm = Gauge(
            "tpu_dra_compute_hbm_bytes",
            "Exact HBM footprint decomposition per replica: weights "
            "(live params tree), kv_pool (allocated paged pools), "
            "kv_used (in-use share of the pool).",
            registry,
        )
        self._g_watermark = Gauge(
            "tpu_dra_compute_hbm_watermark_bytes",
            "High-watermark of the replica's in-use KV bytes since "
            "attach.",
            registry,
        )
        self._coll_metrics = CollectiveMetrics(registry)
        registry.add_render_hook(self._sync)
        self._install_trace_observers()

    # -- trace-seam observers ---------------------------------------------

    def _install_trace_observers(self) -> None:
        from . import decode, moe, train

        def observer(program: str, variant: str, meta: dict) -> None:
            self.ledger.record_build(
                program, variant=variant, shapes=meta,
            )

        for mod in (decode, moe, train):
            mod.TRACE_OBSERVERS.append(observer)
            self._trace_hooks.append((mod, observer))

    def close(self) -> None:
        """Detach every engine, remove the module trace observers, and
        uninstall the collective ledger. The registry keeps the metric
        families (monotone history)."""
        for replica in list(self._engines):
            self.detach(replica)
        for mod, observer in self._trace_hooks:
            if observer in mod.TRACE_OBSERVERS:
                mod.TRACE_OBSERVERS.remove(observer)
        self._trace_hooks.clear()
        self.collectives.uninstall()

    # -- engine attachment -------------------------------------------------

    def attach(self, engine, replica: str = "r0",
               claim_uid: Optional[str] = None) -> None:
        """Wrap ``engine``'s step objects for build timing, start the
        replica's roofline window, and materialize its series (the
        explicit-zeros convention)."""
        from .decode import QuantTensor

        quant_w = isinstance(
            engine.params["layers"]["wqkv"], QuantTensor
        )
        variant = "+".join(
            n for n, on in (
                ("int8", quant_w), ("kvq", engine.quantize_cache),
            ) if on
        ) or "bf16"
        self._engines[replica] = engine
        self._claims[replica] = claim_uid
        self._windows[replica] = deque(maxlen=self._WINDOW)
        self._wrapped[replica] = []
        for program, attr in (
            ("decode_step", "_decode"), ("prefill_chunk", "_prefill"),
        ):
            self._instrument(engine, replica, program, attr, variant)
        for program in ("decode_step", "prefill_chunk"):
            self._c_compiles.inc(0.0, program=program, variant=variant)
            self._c_recompiles.inc(0.0, program=program)
            self._c_steps.inc(0.0, program=program, replica=replica)
            self._h_compile.zero(program=program)
        for component in ("weights", "kv_pool", "kv_used"):
            self._g_hbm.set(0.0, replica=replica, component=component)
        self._g_watermark.set(0.0, replica=replica)
        self._sample(replica, engine)
        self._sync()

    def detach(self, replica: str) -> None:
        """Restore the engine's original step objects and drop the
        per-replica gauges; counter series keep their final values."""
        engine = self._engines.pop(replica, None)
        self._claims.pop(replica, None)
        self._windows.pop(replica, None)
        for attr, original in self._wrapped.pop(replica, []):
            setattr(engine, attr, original)
        for program in ("decode_step", "prefill_chunk"):
            for g in (self._g_mfu, self._g_flops, self._g_bytes):
                g.remove(program=program, replica=replica)
        for component in ("weights", "kv_pool", "kv_used"):
            self._g_hbm.remove(replica=replica, component=component)
        self._g_watermark.remove(replica=replica)
        self._hbm.pop(replica, None)
        self._watermarks.pop(replica, None)

    def _instrument(self, engine, replica: str, program: str, attr: str,
                    variant: str) -> None:
        inner = getattr(engine, attr)
        counts = engine.compile_counts
        ledger = self.ledger
        clock = self._clock

        def wrapped(*args, **kwargs):
            before = counts[program]
            t0 = clock()
            out = inner(*args, **kwargs)
            if counts[program] != before:
                flops, nbytes = self._engine_cost(engine, program)
                ledger.record_build(
                    program, variant=variant,
                    shapes=self._engine_shapes(engine, program),
                    compile_s=clock() - t0, flops=flops, nbytes=nbytes,
                    replica=replica,
                )
                self._h_compile.observe(
                    max(clock() - t0, 0.0), program=program
                )
            return out

        wrapped.__wrapped__ = inner
        setattr(engine, attr, wrapped)
        self._wrapped[replica].append((attr, inner))

    @staticmethod
    def _engine_shapes(engine, program: str) -> dict:
        if program == "decode_step":
            return {"batch": engine.batch_slots, "tokens": 1}
        return {
            "lanes": engine.prefill_batch,
            "chunk": engine.prefill_chunk,
        }

    # -- cost model --------------------------------------------------------

    def _engine_geometry(self, engine) -> dict:
        """Exact byte geometry from the live engine: streamed weight
        bytes (everything but the gathered embedding) and per-token KV
        bytes (one row of both pools + scales; the scratch row is not a
        token's)."""
        weights = tree_nbytes(engine.params)
        embed = tree_nbytes(engine.params["embed"])
        return {
            "streamed": weights - embed,
            "kv_per_token": float(_row_bytes(engine)),
        }

    def _engine_cost(self, engine, program: str) -> tuple:
        geo = self._engine_geometry(engine)
        ctx = self._mean_context(engine)
        if program == "decode_step":
            return estimate_decode_step_cost(
                engine.config, batch=engine.batch_slots, context=ctx,
                streamed_bytes=geo["streamed"],
                kv_bytes_per_token=geo["kv_per_token"],
            )
        return estimate_prefill_chunk_cost(
            engine.config,
            tokens=engine.prefill_batch * engine.prefill_chunk,
            context=ctx, streamed_bytes=geo["streamed"],
        )

    @staticmethod
    def _mean_context(engine) -> float:
        lengths = [int(n) for n in engine._lengths if int(n) > 0]
        if lengths:
            return sum(lengths) / len(lengths)
        return float(engine.prefill_chunk)

    # -- roofline windows --------------------------------------------------

    def _sample(self, replica: str, engine) -> None:
        s = engine.stats
        self._windows[replica].append({
            "t": self._clock(),
            "decode_steps": s.decode_steps,
            "prefill_chunks": s.prefill_chunks,
            "tokens": s.tokens_generated,
            "prefill_tokens": s.prefill_tokens,
            "ctx": self._mean_context(engine),
        })

    def _window_rooflines(self, replica: str, engine) -> dict:
        window = self._windows[replica]
        old, new = window[0], window[-1]
        dt = new["t"] - old["t"]
        geo = self._engine_geometry(engine)
        ctx = max(new["ctx"], 1.0)
        pf = self._peaks["peakFlopsPerS"]
        pb = self._peaks["peakBytesPerS"]
        out = {}
        steps = new["decode_steps"] - old["decode_steps"]
        tokens = new["tokens"] - old["tokens"]
        flops = tokens * engine.config.flops_per_token(int(ctx))
        nbytes = (steps * geo["streamed"]
                  + tokens * ctx * geo["kv_per_token"])
        out["decode_step"] = dict(
            roofline(flops, nbytes, dt, pf, pb), steps=steps,
        )
        chunks = new["prefill_chunks"] - old["prefill_chunks"]
        ptokens = new["prefill_tokens"] - old["prefill_tokens"]
        flops = ptokens * engine.config.flops_per_token(int(ctx))
        out["prefill_chunk"] = dict(
            roofline(flops, chunks * geo["streamed"], dt, pf, pb),
            steps=chunks,
        )
        return out

    def observe_step(self, program: str, seconds: float, *,
                     flops: float = 0.0, nbytes: float = 0.0,
                     steps: int = 1, replica: str = "host") -> None:
        """Explicit roofline sample for programs without an engine
        counter seam (train steps, bench loops): cumulative per
        (program, replica)."""
        cell = self._external_steps.setdefault(
            (program, replica),
            {"seconds": 0.0, "flops": 0.0, "nbytes": 0.0, "steps": 0},
        )
        cell["seconds"] += seconds
        cell["flops"] += flops
        cell["nbytes"] += nbytes
        cell["steps"] += steps

    def mark_warm(self) -> None:
        self.ledger.mark_warm()

    # -- scrape-time sync --------------------------------------------------

    def _bump(self, counter, key: tuple, current: float, **labels) -> None:
        delta = current - self._published.get(key, 0)
        if delta > 0:
            counter.inc(delta, **labels)
        self._published[key] = current

    def _sync(self) -> None:
        for (program, variant), count in (
            self.ledger.builds_by_variant.items()
        ):
            self._bump(
                self._c_compiles, ("compiles", program, variant),
                count, program=program, variant=variant or "-",
            )
        for program, n in self.ledger.recompiles.items():
            self._bump(
                self._c_recompiles, ("recompiles", program), n,
                program=program,
            )
        for replica, engine in self._engines.items():
            self._sample(replica, engine)
            stats = self._window_rooflines(replica, engine)
            s = engine.stats
            for program, cumulative in (
                ("decode_step", s.decode_steps),
                ("prefill_chunk", s.prefill_chunks),
            ):
                self._bump(
                    self._c_steps, ("steps", program, replica),
                    cumulative, program=program, replica=replica,
                )
            for program, r in stats.items():
                self._g_mfu.set(
                    r["mfu"], program=program, replica=replica
                )
                self._g_flops.set(
                    r["flopsPerS"], program=program, replica=replica
                )
                self._g_bytes.set(
                    r["bytesPerS"], program=program, replica=replica
                )
                self._program_stats[(replica, program)] = r
            hbm = engine_hbm(engine)
            self._hbm[replica] = hbm
            self._watermarks[replica] = max(
                self._watermarks.get(replica, 0), hbm["kvUsedBytes"]
            )
            self._g_hbm.set(hbm["weightsBytes"], replica=replica,
                            component="weights")
            self._g_hbm.set(hbm["kvPoolBytes"], replica=replica,
                            component="kv_pool")
            self._g_hbm.set(hbm["kvUsedBytes"], replica=replica,
                            component="kv_used")
            self._g_watermark.set(
                self._watermarks[replica], replica=replica
            )
        for (program, replica), cell in self._external_steps.items():
            self._bump(
                self._c_steps, ("steps", program, replica),
                cell["steps"], program=program, replica=replica,
            )
            pf = self._peaks["peakFlopsPerS"]
            pb = self._peaks["peakBytesPerS"]
            r = roofline(cell["flops"], cell["nbytes"],
                         cell["seconds"], pf, pb)
            r["steps"] = cell["steps"]
            self._g_mfu.set(r["mfu"], program=program, replica=replica)
            self._g_flops.set(r["flopsPerS"], program=program,
                              replica=replica)
            self._g_bytes.set(r["bytesPerS"], program=program,
                              replica=replica)
            self._program_stats[(replica, program)] = r
        self._coll_metrics.sync(self.collectives)

    # -- the /debug/compute document --------------------------------------

    def compute_debug(self) -> dict:
        """The GET-only ``/debug/compute`` document. Computed on demand
        (it runs one sync so the doc reflects live state even between
        scrapes); wire via ``MetricsServer.set_compute_provider``."""
        self._sync()
        programs = {}
        for (replica, program), r in sorted(self._program_stats.items()):
            programs.setdefault(program, {})[replica] = {
                "mfu": r["mfu"],
                "flopsPerS": r["flopsPerS"],
                "bytesPerS": r["bytesPerS"],
                "boundBy": r["boundBy"],
                "intensity": r["intensity"],
                "ridge": r["ridge"],
                "windowS": r["windowS"],
                "steps": r.get("steps", 0),
            }
        hbm = {}
        for replica, doc in sorted(self._hbm.items()):
            hbm[replica] = dict(
                doc,
                watermarkBytes=self._watermarks.get(replica, 0),
                claimUid=self._claims.get(replica),
            )
        return {
            "schema": "tpu-dra-compute-debug-v1",
            "device": dict(self._peaks),
            **self.ledger.snapshot(),
            "programs": programs,
            "hbm": hbm,
            "collectives": self.collectives.snapshot(),
        }


# -- BENCH artifact trajectory ---------------------------------------------


def load_bench_trajectory(bench_dir: str) -> list[dict]:
    """Tolerantly load the ``BENCH_r*.json`` rounds in ``bench_dir``.

    Older rounds predate fields the newer ones carry (r01 has no
    ``repeats``/``spread``/``mfu_all``) — every field is read with a
    default instead of KeyError-ing, and unreadable files are skipped.
    Returns one normalized row per parsed metric, sorted by round."""
    rows: list[dict] = []
    for path in sorted(glob.glob(os.path.join(bench_dir, "BENCH_r*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = doc.get("parsed")
        metrics = (
            parsed if isinstance(parsed, list)
            else [parsed] if isinstance(parsed, dict) else []
        )
        for m in metrics:
            if not isinstance(m, dict):
                continue
            rows.append({
                "round": doc.get("n"),
                "metric": m.get("metric", ""),
                "value": m.get("value"),
                "unit": m.get("unit", ""),
                "vs_baseline": m.get("vs_baseline"),
                "repeats": m.get("repeats", 1),
                "spread": m.get("spread", 0.0),
                "detail": m.get("detail") or {},
            })
    return rows


def bench_mfu_baseline(rows: list[dict]) -> Optional[float]:
    """Best MFU across the BENCH trajectory — the baseline the doctor's
    mfu-regression finding compares measured MFU against. On the port the
    directory holds rounds measured on the card; the TPU rounds committed
    at the repo's root are no baseline for it.
    None when no round recorded an MFU metric (the finding is skipped,
    never raised on a missing baseline)."""
    values = [
        float(r["value"]) for r in rows
        if r.get("unit") == "mfu_fraction"
        and isinstance(r.get("value"), (int, float))
    ]
    return max(values) if values else None
