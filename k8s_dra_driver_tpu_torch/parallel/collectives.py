"""Host-side collective accounting — the emission layer of the
compute-plane telemetry (models/compute_telemetry.py). Counterpart of
``k8s_dra_driver_tpu/parallel/collectives.py``, copied as it is.

Each collective site calls :func:`emit` with an *analytic* byte volume
derived from static shapes: the ring hops (``parallel/ring.py``) and
the expert-parallel combines of ``models/moe.py``. The call happens in
host Python — at capture for sites inside a captured CUDA graph (a
``StepGraph``'s warm-up runs record nothing), at call time for eager
and host-level sites — so the accounting never adds a launch to a step
and can never perturb tokens, tick counts, or the compile-once
counters. With no ledger installed, :func:`emit` is a single
list-truthiness check: the zero-cost contract
tests/test_torch_compute_telemetry.py pins.

Accounting convention (pinned by tests/test_torch_compute_telemetry.py): a
record's ``bytes`` is the total fabric traffic of one logical invocation
summed over every participating shard, under the standard ring
algorithms —

- permute (``ppermute``/ring hop): each of the ``n`` shards sends its
  whole local payload once → ``n * payload``.
- all_gather (tiled): ``n - 1`` ring steps, one chunk per shard per
  step → ``n * (n - 1) * local_chunk``.
- all_to_all: each shard keeps 1/n of its buffer and sends the rest →
  ``(n - 1) * local_buffer``.
- all_reduce (psum/pmean): reduce-scatter + all-gather →
  ``2 * (n - 1) * payload``.

Sites inside a captured step fire once per *capture* (per program
build), not per replay — the record is the per-invocation volume of the
captured program; multiply by the program's step counters for cumulative
traffic. Eager calls and host-level sites fire per call. A site inside
the layer loop fires once per layer: the record is what the program
moves. (The reference's layers run under ``lax.scan``, whose body traces
once, so its record is one layer's.)
"""

from __future__ import annotations

import math
import threading

MEDIUM_ICI = "ici"   # in-mesh collective fabric (NVLink between cards)
MEDIUM_DCN = "dcn"   # host-mediated transfers between hosts

# Installed CollectiveLedgers. Module-level on purpose: the collective
# sites must not need a handle threaded
# through every model call; attaching telemetry installs a ledger here.
_LEDGERS: list["CollectiveLedger"] = []
_LOCK = threading.Lock()


def payload_bytes(shape, dtype) -> int:
    """Bytes of one array payload from its static shape + dtype (only
    ``shape``/``dtype.itemsize`` are read; torch dtypes have both)."""
    return int(math.prod(shape)) * int(dtype.itemsize)


def permute_bytes(payload: int, n: int) -> int:
    """One ring hop: every shard ships its local payload. A ring of one
    is a self-permute — no fabric traffic."""
    return n * payload if n > 1 else 0


def all_gather_bytes(local_chunk: int, n: int) -> int:
    """Tiled all-gather via the ring algorithm."""
    return n * (n - 1) * local_chunk


def all_to_all_bytes(local_buffer: int, n: int) -> int:
    """Each shard sends (n-1)/n of its local buffer."""
    return (n - 1) * local_buffer


def all_reduce_bytes(payload: int, n: int) -> int:
    """psum/pmean as reduce-scatter + all-gather."""
    return 2 * (n - 1) * payload


def emit(site: str, medium: str, nbytes: int, invocations: int = 1) -> None:
    """Record ``nbytes`` of fabric traffic for ``site``. No-op (one
    truthiness check) unless a ledger is installed."""
    if not _LEDGERS:
        return
    from ..models.step_graph import phase

    if phase() == "warmup":
        return
    with _LOCK:
        for ledger in _LEDGERS:
            ledger.record(site, medium, nbytes, invocations)


class CollectiveLedger:
    """Plain-int per-(site, medium) byte/invocation counters.

    The hot-path half of the collective accounting: sites write here
    (host-side, via :func:`emit`), and the exporter half
    (:class:`CollectiveMetrics`, synced from ComputeTelemetry's render
    hook) publishes deltas at scrape time only."""

    def __init__(self):
        # (site, medium) -> [bytes, invocations]
        self.sites: dict[tuple[str, str], list[int]] = {}

    def record(self, site: str, medium: str, nbytes: int,
               invocations: int = 1) -> None:
        cell = self.sites.setdefault((site, medium), [0, 0])
        cell[0] += int(nbytes)
        cell[1] += int(invocations)

    def install(self) -> None:
        with _LOCK:
            if self not in _LEDGERS:
                _LEDGERS.append(self)

    def uninstall(self) -> None:
        with _LOCK:
            if self in _LEDGERS:
                _LEDGERS.remove(self)

    def snapshot(self) -> list[dict]:
        """JSON-clean rows, sorted for stable rendering."""
        return [
            {"site": site, "medium": medium,
             "bytes": cell[0], "invocations": cell[1]}
            for (site, medium), cell in sorted(self.sites.items())
        ]


class CollectiveMetrics:
    """The exported ``tpu_dra_compute_collective_*`` series.

    Declared here (not in compute_telemetry.py) so the family's two
    owners match its two halves: this module owns the collective
    vocabulary, compute_telemetry.py owns the rest of the
    ``tpu_dra_compute_*`` catalog."""

    def __init__(self, registry):
        from ..utils.metrics import Counter

        self._published: dict[tuple, int] = {}
        self._c_bytes = Counter(
            "tpu_dra_compute_collective_bytes_total",
            "Analytic fabric traffic per collective site (bytes summed "
            "over participating shards; jitted sites account once per "
            "program build — see parallel/collectives.py).",
            registry,
        )
        self._c_invocations = Counter(
            "tpu_dra_compute_collective_invocations_total",
            "Collective-site invocations (traces for jitted sites, "
            "calls for eager/host-level sites like train.reshard).",
            registry,
        )

    def sync(self, ledger: CollectiveLedger) -> None:
        for (site, medium), (nbytes, invocations) in ledger.sites.items():
            for counter, current in (
                (self._c_bytes, nbytes),
                (self._c_invocations, invocations),
            ):
                key = (counter.name, site, medium)
                delta = current - self._published.get(key, 0)
                if delta > 0:
                    counter.inc(delta, site=site, medium=medium)
                self._published[key] = current
