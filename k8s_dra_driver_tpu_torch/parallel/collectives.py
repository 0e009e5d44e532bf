"""Host-side collective accounting — the emission layer of the
compute-plane telemetry (models/compute_telemetry.py). Counterpart of
``k8s_dra_driver_tpu/parallel/collectives.py``, copied as it is, plus
the collectives of the single-controller mesh (:func:`psum`,
:func:`all_gather` and their per-group forms :func:`sum_parts`,
:func:`concat_parts`, and :func:`all_to_all`), which the reference
leaves to XLA: a psum is the sum of the shards' values in shard order, a
tiled all-gather their concatenation in shard order, a tiled all-to-all
the exchange of the shards' chunks. They record nothing here; a site that the
reference records calls :func:`emit` itself.

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

import torch

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


def sum_parts(parts, device=None) -> torch.Tensor:
    """The psum of one group: the shards' values summed in shard order on
    ``device`` (default the first value's)."""
    dev = parts[0].device if device is None else torch.device(device)
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def concat_parts(parts, dim: int, device=None) -> torch.Tensor:
    """The tiled all-gather of one group: the shards' values concatenated
    along ``dim`` in shard order on ``device`` (default the first's)."""
    dev = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def _over_groups(values, mesh, axes, fn) -> list:
    """``fn(parts, device)`` of each group of shards that share every
    coordinate but ``axes``, for each member on its device (computed once
    per group and device)."""
    if len(values) != mesh.size:
        raise ValueError(f"{len(values)} values for a mesh of {mesh.size} "
                         f"shards")
    out = [None] * mesh.size
    for group in mesh.groups(axes):
        parts = [values[j] for j in group]
        done = {}
        for i in group:
            dev = mesh.devices[i]
            if dev not in done:
                done[dev] = fn(parts, dev)
            out[i] = done[dev]
    return out


def psum(values, mesh, axes) -> list:
    """``lax.psum`` over ``axes`` (a name or a tuple of names): ``values``
    holds one tensor per shard of ``mesh``; each shard gets the sum over
    the shards that share its other coordinates."""
    return _over_groups(values, mesh, axes, sum_parts)


def all_gather(values, mesh, axes, dim: int) -> list:
    """The tiled ``lax.all_gather`` over ``axes``: each shard gets the
    values of the shards that share its other coordinates, concatenated
    along ``dim`` in shard order."""
    return _over_groups(values, mesh, axes,
                        lambda parts, dev: concat_parts(parts, dim, dev))


def all_to_all(values, mesh, axes, split_dim: int, concat_dim: int) -> list:
    """The tiled ``lax.all_to_all`` over ``axes``: in each group of ``n``
    shards that share the other coordinates, member ``i`` gets the ``i``-th
    of the ``n`` chunks of every member's value along ``split_dim``,
    concatenated along ``concat_dim`` in member order, on its own device.
    A shard whose value is None takes no part (its group must be all
    None) and gets None back."""
    if len(values) != mesh.size:
        raise ValueError(f"{len(values)} values for a mesh of {mesh.size} "
                         f"shards")
    out = [None] * mesh.size
    for group in mesh.groups(axes):
        parts = [values[j] for j in group]
        if all(p is None for p in parts):
            continue
        if any(p is None for p in parts):
            raise ValueError("all_to_all: a group with and without values")
        n = len(group)
        if parts[0].shape[split_dim] % n:
            raise ValueError(
                f"all_to_all: dimension {split_dim} of "
                f"{tuple(parts[0].shape)} does not split over {n} shards")
        chunks = [p.chunk(n, dim=split_dim) for p in parts]
        for i, idx in enumerate(group):
            dev = mesh.devices[idx]
            out[idx] = torch.cat([c[i].to(dev) for c in chunks],
                                 dim=concat_dim)
    return out


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
