"""Workload-side sharing shim: makes the driver's sharing env REAL.

The port's copy of the reference module. A claim on GPUs names its
runtime in the envelope (``TPU_DRA_RUNTIME=cuda``, ``cdi/runtime.py``):
the shim then partitions ``CUDA_VISIBLE_DEVICES`` per process slot and
derives the allocator fraction into ``TPU_DRA_TORCH_MEM_FRACTION``
(an operator may pin it there), which :func:`apply_memory_fraction`
hands to ``torch.cuda.set_per_process_memory_fraction`` -- PyTorch reads
no variable for it. Call that once after :func:`apply_sharing_env` and
again whenever :func:`poll_sharing_update` returns an update, at the
caller's step boundary. The cap covers PyTorch's caching allocator only:
not the CUDA context, not the kernels' code, not CUDA graphs' own
memory, not what a library allocates outside PyTorch. Without an
envelope naming a runtime the shim does exactly what the reference's
does. The reference's description follows.

The node plugin's sharing managers (plugin/sharing.py) inject a
claim-level envelope — ``TPU_DRA_SHARING``, ``TPU_DRA_MAX_PROCESSES``,
``TPU_DRA_HBM_LIMIT_BYTES``, ``TPU_DRA_TIMESHARE_QUANTUM``, a shared
coordination dir — the per-PROCESS consequences of which only the
workload process itself can apply (which slot am I, which chips do I
see, when may I touch the device). This module is that consumer,
invoked automatically by ``initialize_distributed`` or directly by an
entrypoint.

Reference behavior bar: GPU time-slicing / MPS actually change device
behavior (lengrongfu/k8s-dra-driver, cmd/nvidia-dra-plugin/
sharing.go:103-122 and :185-344). On TPU there is no on-device knob and
no control daemon; the real mechanisms are

- **process-shared**: libtpu/XLA env — a unique process slot (flock'd
  file in the shared dir, so two processes can never claim the same
  slot), a per-slot ``TPU_VISIBLE_CHIPS`` partition when the claim's
  chips divide across processes, and the HBM budget applied through
  ``XLA_PYTHON_CLIENT_MEM_FRACTION`` (the allocator fraction JAX
  honors) computed from the driver-injected limit and chip HBM size.
- **time-shared**: cooperative gating — ``timeshare_lease()`` holds an
  exclusive flock on the claim's shared lock file while the process
  runs device work; the quantum hint bounds the advisory lease length.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno
import fcntl
import json
import logging
import os
from typing import IO, Iterator, MutableMapping, Optional

from ..cdi import runtime as _runtime

logger = logging.getLogger(__name__)

# The generation-stamped limits document the node plugin renders into
# the claim's shared dir (plugin/sharing.py LIMITS_FILE) and the marker
# env var recording the last generation THIS process applied.
_LIMITS_FILE = "limits.json"
_GENERATION_MARKER = "TPU_DRA_SHIM_GENERATION"
# Set when the OPERATOR pre-set the runtime's fraction variable
# (XLA_PYTHON_CLIENT_MEM_FRACTION; TPU_DRA_TORCH_MEM_FRACTION on a GPU)
# in the pod spec: an explicit operator override outranks the driver's
# derived fraction, at startup and across every later rebalance
# generation.
_FRACTION_PINNED_MARKER = "TPU_DRA_MEM_FRACTION_PINNED"

# Quantum hint level (TPU_DRA_TIMESHARE_QUANTUM, api/v1alpha1/sharing.py
# INTERVALS) → advisory lease seconds.
_QUANTUM_SECONDS = {0: 1.0, 1: 0.1, 2: 1.0, 3: 10.0}


class SharingRuntimeError(RuntimeError):
    pass


# The process's applied decision (default-environ path). Holding it here
# keeps the slot flock alive for the process lifetime — a dropped
# SharingRuntime releases its slot.
_active: Optional["SharingRuntime"] = None

# Marker the shim leaves in the env so a second invocation (entrypoint
# calls apply_sharing_env, then initialize_distributed calls it again)
# can't burn a second slot or re-partition the already-halved chip list.
_APPLIED_MARKER = "TPU_DRA_SHIM_APPLIED"


@dataclasses.dataclass
class SharingRuntime:
    """What the shim decided for THIS process."""

    mode: str
    slot: int = -1
    max_processes: int = 1
    visible_chips: Optional[str] = None
    mem_fraction: Optional[float] = None
    quantum_seconds: Optional[float] = None
    # The slot lock must live as long as the process; dropping the
    # runtime object releases the slot.
    _slot_lock: Optional[IO[str]] = None

    def release(self) -> None:
        if self._slot_lock is not None:
            self._slot_lock.close()
            self._slot_lock = None


def _acquire_slot(shared_dir: str, max_processes: int) -> tuple[int, IO[str]]:
    """First free slot in [0, max_processes): an exclusive flock on
    slot-N.lock. The lock dies with the process, so a crashed worker's
    slot frees itself — no daemon, no leases to expire (the property MPS
    gets from its control daemon, sharing.go:185-344)."""
    os.makedirs(shared_dir, exist_ok=True)
    for i in range(max_processes):
        f = open(os.path.join(shared_dir, f"slot-{i}.lock"), "a+")
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return i, f
        except OSError as e:
            f.close()
            if e.errno not in (errno.EAGAIN, errno.EACCES):
                raise
    raise SharingRuntimeError(
        f"all {max_processes} process slots of shared claim are busy "
        f"(dir {shared_dir})"
    )


def _partition_visible_chips(
    visible: str, slot: int, max_processes: int
) -> Optional[str]:
    """Slot's share of the claim's chips, when they divide evenly; None
    leaves the claim-level visibility untouched (all processes share all
    chips and the HBM fraction is the budget)."""
    chips = [c.strip() for c in visible.split(",") if c.strip()]
    if not chips or len(chips) % max_processes != 0:
        return None
    per = len(chips) // max_processes
    return ",".join(chips[slot * per:(slot + 1) * per])


def apply_sharing_env(
    environ: Optional[MutableMapping[str, str]] = None,
) -> Optional[SharingRuntime]:
    """Apply the driver's sharing envelope to this process.

    Mutates ``environ`` (default ``os.environ``) BEFORE the TPU runtime
    initializes — call it ahead of the first jax import/device touch
    (``initialize_distributed`` does). Returns the decision record, or
    None when the claim is exclusive (no envelope present).
    """
    global _active
    env = environ if environ is not None else os.environ
    mode = env.get("TPU_DRA_SHARING", "")
    if not mode:
        return None
    if env.get(_APPLIED_MARKER):
        # Idempotent: the first application's decision stands.
        return _active if environ is None else None

    if mode == "process-shared":
        runtime = _runtime.runtime_of_env(env)
        max_p = max(int(env.get("TPU_DRA_MAX_PROCESSES", "1") or 1), 1)
        shared_dir = env.get("TPU_DRA_SHARED_DIR", "")
        slot, lock = (-1, None)
        if shared_dir:
            # Acquire even when maxProcesses == 1: that's the case where
            # a second process sneaking in MUST be refused.
            slot, lock = _acquire_slot(shared_dir, max_p)
        rt = SharingRuntime(
            mode=mode, slot=slot, max_processes=max_p, _slot_lock=lock
        )
        if slot >= 0:
            env.setdefault("TPU_DRA_PROCESS_SLOT", str(slot))
            part = _partition_visible_chips(
                env.get(runtime.visibility_env, ""), slot, max_p
            )
            if part is not None:
                env[runtime.visibility_env] = part
                rt.visible_chips = part
        limit = int(env.get("TPU_DRA_HBM_LIMIT_BYTES", "0") or 0)
        hbm = int(env.get("TPU_DRA_CHIP_HBM_BYTES", "0") or 0)
        derived = (f"{min(limit / hbm, 1.0):.4f}"
                   if limit > 0 and hbm > 0 else None)
        preset = env.get(runtime.mem_fraction_env)
        if preset is not None and preset != derived:
            # A fraction that does NOT match the value the driver would
            # derive from its own injected budget is an OPERATOR
            # override (the CDI claim spec injects the derived value
            # verbatim, so the driver's own injection compares equal):
            # pin it, so neither this setup nor any later rebalance
            # generation clobbers it.
            env[_FRACTION_PINNED_MARKER] = "1"
        if derived is not None:
            env.setdefault(runtime.mem_fraction_env, derived)
            rt.mem_fraction = float(env[runtime.mem_fraction_env])
        logger.info(
            "process-shared claim: slot %d/%d, visible=%s, mem_fraction=%s",
            slot, max_p, rt.visible_chips or "(claim-wide)",
            rt.mem_fraction,
        )
        env[_APPLIED_MARKER] = "1"
        # A rebalance may have moved the claim's limits since the claim
        # spec env above was rendered; the session's limits file is the
        # fresher truth, so a process starting mid-rebalance begins on
        # the current generation instead of the prepare-time one.
        update = poll_sharing_update(env)
        if update is not None and update.mem_fraction is not None:
            rt.mem_fraction = update.mem_fraction
        if environ is None:
            _active = rt
        return rt

    if mode == "time-shared":
        level = int(env.get("TPU_DRA_TIMESHARE_QUANTUM", "0") or 0)
        rt = SharingRuntime(
            mode=mode,
            quantum_seconds=_QUANTUM_SECONDS.get(level, 1.0),
        )
        logger.info(
            "time-shared claim: quantum level %d (%.1fs advisory lease); "
            "gate device work with timeshare_lease()",
            level, rt.quantum_seconds,
        )
        env[_APPLIED_MARKER] = "1"
        if environ is None:
            _active = rt
        return rt

    logger.warning("unknown TPU_DRA_SHARING mode %r ignored", mode)
    return None


@dataclasses.dataclass
class SharingUpdate:
    """A newly observed limits generation, already applied to the env."""

    generation: int
    tensorcore_percent: Optional[int] = None
    hbm_limit_bytes: Optional[int] = None
    mem_fraction: Optional[float] = None


def poll_sharing_update(
    environ: Optional[MutableMapping[str, str]] = None,
) -> Optional[SharingUpdate]:
    """Observe the claim's limits file and re-apply a newer generation.

    The node plugin's rebalancer resizes a process-shared claim's limits
    by re-rendering ``limits.json`` in the shared dir with a bumped
    ``generation`` (plugin/sharing.py ``ProcessShareSession.resize``).
    This is the workload half of that contract: call it at a SAFE STEP
    BOUNDARY (between training steps, between serving batches — anywhere
    the process can tolerate its allocator budget changing) and, when it
    returns an update, re-apply what the env now says (a changed
    ``XLA_PYTHON_CLIENT_MEM_FRACTION`` only binds a freshly initialized
    client; a running program keeps its allocation until the workload
    rebuilds it, which is exactly why the boundary is the caller's).

    Returns None when there is nothing new (no envelope, no file, or the
    generation was already applied) — so a loop can call it every step
    for free. Idempotent per generation via the ``TPU_DRA_SHIM_GENERATION``
    marker.
    """
    env = environ if environ is not None else os.environ
    if env.get("TPU_DRA_SHARING", "") != "process-shared":
        return None
    shared_dir = env.get("TPU_DRA_SHARED_DIR", "")
    if not shared_dir:
        return None
    try:
        with open(os.path.join(shared_dir, _LIMITS_FILE)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        # No file yet (pre-rebalancer plugin) or a torn read the atomic
        # writer makes impossible in practice: nothing to apply.
        return None
    try:
        generation = int(doc.get("generation", 0))
    except (TypeError, ValueError):
        return None
    applied = int(env.get(_GENERATION_MARKER, "0") or 0)
    if generation <= applied:
        return None
    from ..utils import faults

    faults.fire("rebalance.shim-apply")
    runtime = _runtime.runtime_of_env(env)
    update = SharingUpdate(generation=generation)
    pinned = env.get(_FRACTION_PINNED_MARKER) == "1"
    limit = doc.get("hbmLimitBytes")
    chip_hbm = doc.get("chipHbmBytes") or int(
        env.get("TPU_DRA_CHIP_HBM_BYTES", "0") or 0
    )
    if limit:
        update.hbm_limit_bytes = int(limit)
        env["TPU_DRA_HBM_LIMIT_BYTES"] = str(int(limit))
        if chip_hbm and not pinned:
            frac = min(int(limit) / int(chip_hbm), 1.0)
            env[runtime.mem_fraction_env] = f"{frac:.4f}"
            env["TPU_DRA_CHIP_HBM_BYTES"] = str(int(chip_hbm))
            update.mem_fraction = frac
    else:
        # A null limit is a CLEAR (e.g. a rollback restoring an
        # uncapped claim), not "nothing to say": leaving the aborted
        # cap in the env would enforce limits the checkpoint no longer
        # grants.
        env.pop("TPU_DRA_HBM_LIMIT_BYTES", None)
        if not pinned:
            env.pop(runtime.mem_fraction_env, None)
    pct = doc.get("tensorcorePercent")
    if pct is not None:
        update.tensorcore_percent = int(pct)
        env.update(_runtime.core_share_env(runtime, int(pct)))
    else:
        for name in runtime.core_share_env:
            env.pop(name, None)
    env[_GENERATION_MARKER] = str(generation)
    logger.info(
        "sharing limits generation %d applied: tensorcore=%s%%, "
        "mem_fraction=%s",
        generation, update.tensorcore_percent, update.mem_fraction,
    )
    return update


def apply_memory_fraction(
    device=None,
    environ: Optional[MutableMapping[str, str]] = None,
) -> float:
    """Cap PyTorch's caching allocator on ``device`` at the claim's
    fraction: ``torch.cuda.set_per_process_memory_fraction`` (PyTorch
    reads no environment variable for it; this is the port's stand-in for
    ``XLA_PYTHON_CLIENT_MEM_FRACTION``).

    The fraction is the runtime's fraction variable as
    :func:`apply_sharing_env` derived it (or an operator pinned it) and
    :func:`poll_sharing_update` last re-derived it; 1.0 where the env
    holds none (no cap, or a cap cleared). Call it after
    :func:`apply_sharing_env`, and again at the step boundary where
    :func:`poll_sharing_update` returned an update. ``device`` resolves
    as the port's entry points do (None is the card). Returns the
    fraction applied. Raises on a CPU device, which has no allocator to
    cap. An allocation that would take the allocator's reserved memory
    past ``fraction`` x the card's memory raises
    ``torch.OutOfMemoryError``; the CUDA context and memory allocated
    outside PyTorch are not counted.
    """
    import torch

    from .. import resolve_device

    env = environ if environ is not None else os.environ
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"a memory fraction caps a CUDA device's allocator; got {dev}"
        )
    raw = env.get(_runtime.runtime_of_env(env).mem_fraction_env)
    fraction = float(raw) if raw else 1.0
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    torch.cuda.set_per_process_memory_fraction(fraction, index)
    return fraction


def report_usage(
    busy_fraction: float,
    hbm_fraction: Optional[float] = None,
    environ: Optional[MutableMapping[str, str]] = None,
) -> bool:
    """Publish this process's recent device utilization into the shared
    dir — the demand signal the node-side rebalancer reads
    (plugin/rebalancer.py ``FileDemandSource``). ``busy_fraction`` is
    how much of the process's CURRENT grant it actually used over the
    last window (0..1): ~1.0 means pressure (wants more), ~0.0 means
    idle (can donate). Optional ``hbm_fraction`` is the analogous HBM
    signal. Free no-op off process-shared claims, so library code can
    call it unconditionally next to its step loop. Returns True when a
    sample was written."""
    env = environ if environ is not None else os.environ
    if env.get("TPU_DRA_SHARING", "") != "process-shared":
        return False
    shared_dir = env.get("TPU_DRA_SHARED_DIR", "")
    if not shared_dir:
        return False
    import time

    slot = env.get("TPU_DRA_PROCESS_SLOT", "0")
    doc: dict = {"ts": time.time(), "busy": float(busy_fraction)}
    if hbm_fraction is not None:
        doc["hbm"] = float(hbm_fraction)
    try:
        from ..utils.fs import atomic_write_json

        atomic_write_json(
            os.path.join(shared_dir, f"usage-slot-{slot}.json"), doc,
            indent=None,
        )
    except OSError as e:
        logger.warning("usage report failed: %s", e)
        return False
    return True


@contextlib.contextmanager
def timeshare_lease(
    environ: Optional[MutableMapping[str, str]] = None,
) -> Iterator[None]:
    """Exclusive device lease for a time-shared claim.

    Wrap each chunk of device work (a training step, an inference batch):
    the lease flocks ONE LOCK FILE PER CHIP (``TPU_DRA_CHIP_UUIDS``) in
    the node-global rendezvous dir, always in sorted order (no
    deadlocks). Per-chip locks mean claims with overlapping but unequal
    chip sets contend exactly on the chips they share — which IS the
    time-slicing. Holding a lease much longer than the operator-chosen
    quantum is logged, since co-tenants are starving meanwhile. On an
    exclusive claim (no envelope) this is a free no-op, so library code
    can use it unconditionally.
    """
    import time

    env = environ if environ is not None else os.environ
    if env.get("TPU_DRA_SHARING", "") != "time-shared":
        yield
        return
    shared_dir = env.get("TPU_DRA_SHARED_DIR", "")
    if not shared_dir:
        logger.warning(
            "time-shared claim without TPU_DRA_SHARED_DIR; lease is a no-op"
        )
        yield
        return
    os.makedirs(shared_dir, exist_ok=True)
    names = sorted(
        u.strip() for u in env.get("TPU_DRA_CHIP_UUIDS", "").split(",")
        if u.strip()
    ) or ["timeshare"]
    level = int(env.get("TPU_DRA_TIMESHARE_QUANTUM", "0") or 0)
    quantum = _QUANTUM_SECONDS.get(level, 1.0)
    files = []
    try:
        for name in names:
            f = open(os.path.join(shared_dir, f"{name}.lock"), "a+")
            files.append(f)
            fcntl.flock(f, fcntl.LOCK_EX)
        start = time.monotonic()
        yield
        held = time.monotonic() - start
        if held > 2 * quantum:
            logger.warning(
                "time-share lease held %.2fs, over the %.1fs quantum — "
                "co-tenant processes were starved; shorten device-work "
                "chunks or raise the claim's interval", held, quantum,
            )
    finally:
        for f in reversed(files):
            try:
                fcntl.flock(f, fcntl.LOCK_UN)
            finally:
                f.close()
