"""Sharing managers: TimeShare + ProcessShare (TS/MPS analogs).

The port's copy of the reference module. The variables a shared claim's
containers get follow the chips' runtime (``cdi/runtime.py``): on a GPU
the HBM budget stays in ``TPU_DRA_HBM_LIMIT_BYTES`` /
``TPU_DRA_CHIP_HBM_BYTES`` for the shim to hand PyTorch's allocator
(no ``XLA_*`` / ``TPU_PREMAPPED_*`` variable), the core share adds
``CUDA_MPS_ACTIVE_THREAD_PERCENTAGE``, and the envelope names the
runtime (``TPU_DRA_RUNTIME=cuda``). The reference's description follows.

Role of the reference's sharing.go (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/sharing.go:97-442). The GPU mechanisms do not map 1:1:

- GPU time-slicing is an nvidia-smi knob on the device
  (sharing.go:103-122); TPU has no on-device scheduler knob, so TimeShared
  is realised by (a) marking the chip's runtime mode, (b) mounting a
  shared rendezvous dir, and (c) injecting a quantum hint — the
  workload-side shim (parallel/shim.py ``timeshare_lease``) round-robins
  co-tenants through an exclusive flock in that dir.
- MPS is a per-claim control daemon Deployment + pipe/shm dirs
  (sharing.go:185-344); TPU process sharing needs no daemon — libtpu
  multi-process support is configured purely through env, so a
  ProcessShare "session" is a state-dir entry plus the env/mount edits
  for the claim's containers. The HBM budget maps onto
  ``XLA_PYTHON_CLIENT_MEM_FRACTION`` (the allocator cap JAX honors),
  and the shim (parallel/shim.py ``apply_sharing_env``) enforces
  maxProcesses via flock'd slot files and partitions
  ``TPU_VISIBLE_CHIPS`` per process slot.

What carries over unchanged: the full-device-only guard, per-claim session
identity (claimUID + digest of UUIDs, sharing.go:151-155), mode exclusivity
across claims, and cleanup on unprepare.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
from typing import Optional

from ..utils import faults
from ..utils.fs import atomic_write_json

from ..api.v1alpha1 import ProcessSharedConfig, TimeSharedConfig, parse_quantity
from ..cdi import runtime as _runtime
from ..cdi.spec import ContainerEdits
from ..tpulib.chiplib import (
    SHARING_EXCLUSIVE,
    SHARING_PROCESS_SHARED,
    SHARING_TIME_SHARED,
    ChipLib,
)
from ..tpulib.deviceinfo import AllocatableDevice

logger = logging.getLogger(__name__)


class SharingError(RuntimeError):
    pass


class ModeConflictError(SharingError):
    """A chip is already held in an incompatible sharing mode by another
    claim (role of compute-mode exclusivity, nvlib.go:541-558)."""


class CorruptShareStateError(SharingError):
    """A per-chip share-state file is unreadable. Raised loudly rather than
    treated as 'chip free', which would erase the mode-conflict guard."""


@dataclasses.dataclass
class _ChipShareState:
    """Per-chip record in the sharing state dir."""

    mode: str = SHARING_EXCLUSIVE
    claims: dict[str, dict] = dataclasses.field(default_factory=dict)


class SharingStateStore:
    """Durable per-chip sharing state under ``state_dir``.

    The reference keeps equivalent state on the device itself (compute mode,
    time-slice) and in MPS daemon Deployments; TPU chips hold no such state,
    so the plugin owns it. Survives restarts alongside the checkpoint.
    """

    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        os.makedirs(state_dir, exist_ok=True)

    def _path(self, uuid: str) -> str:
        return os.path.join(self.state_dir, f"{uuid}.share.json")

    def list_chips(self) -> list[str]:
        """Chip UUIDs with state files on disk (inspection seam: the
        file-name convention is this class's private detail)."""
        suffix = ".share.json"
        try:
            entries = os.listdir(self.state_dir)
        except FileNotFoundError:
            return []
        return sorted(
            e[: -len(suffix)] for e in entries if e.endswith(suffix)
        )

    def get(self, uuid: str) -> _ChipShareState:
        try:
            with open(self._path(uuid)) as f:
                d = json.load(f)
        except FileNotFoundError:
            return _ChipShareState()
        except (OSError, ValueError) as e:
            raise CorruptShareStateError(
                f"share state for chip {uuid} unreadable: {e}"
            ) from e
        try:
            return _ChipShareState(mode=d["mode"], claims=d.get("claims", {}))
        except (KeyError, TypeError) as e:
            raise CorruptShareStateError(
                f"share state for chip {uuid} malformed: {d!r}"
            ) from e

    def put(self, uuid: str, st: _ChipShareState) -> None:
        faults.fire("sharing.state-write")
        atomic_write_json(
            self._path(uuid), {"mode": st.mode, "claims": st.claims}, indent=None
        )

    def clear(self, uuid: str) -> None:
        faults.fire("sharing.state-write")
        try:
            os.unlink(self._path(uuid))
        except FileNotFoundError:
            pass

    def acquire(
        self, uuid: str, claim_uid: str, mode: str, meta: Optional[dict] = None
    ) -> None:
        st = self.get(uuid)
        others = set(st.claims) - {claim_uid}
        if others and st.mode != mode:
            raise ModeConflictError(
                f"chip {uuid} is {st.mode} (claims {sorted(others)}), "
                f"cannot also be {mode}"
            )
        # Exclusive means exclusive: even a same-mode second claim is a
        # double-allocation (scheduler bug or adminAccess misuse).
        if others and mode == SHARING_EXCLUSIVE:
            raise ModeConflictError(
                f"chip {uuid} is already exclusively held by "
                f"{sorted(others)}; cannot grant to {claim_uid}"
            )
        st.mode = mode
        st.claims[claim_uid] = meta or {}
        self.put(uuid, st)

    def release(self, uuid: str, claim_uid: str) -> bool:
        """Drop a claim; returns True if the chip is now free."""
        st = self.get(uuid)
        st.claims.pop(claim_uid, None)
        if not st.claims:
            self.clear(uuid)
            return True
        self.put(uuid, st)
        return False


def _require_full_chips(devices: list[AllocatableDevice], what: str) -> None:
    """Full-device-only guard (sharing.go:105-107 analog)."""
    for d in devices:
        if d.chip is None:
            raise SharingError(
                f"{what} is only supported on whole chips; "
                f"got {d.type()} device {d.canonical_name()}"
            )


class TimeShareManager:
    """TimeSlicingManager analog (sharing.go:97-122).

    The workload-side lease (parallel/shim.py timeshare_lease) needs a
    rendezvous point every co-tenant of a chip can flock. ONE node-global
    dir is mounted into every time-shared container, and the locks inside
    are PER CHIP (``<uuid>.lock``, advertised via TPU_DRA_CHIP_UUIDS), so
    claims with overlapping but unequal chip sets contend exactly on the
    chips they actually share.
    """

    def __init__(self, chiplib: ChipLib, state: SharingStateStore,
                 run_dir: str):
        self.chiplib = chiplib
        self.state = state
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)

    def set_time_share(
        self,
        claim_uid: str,
        devices: list[AllocatableDevice],
        config: TimeSharedConfig,
    ) -> ContainerEdits:
        _require_full_chips(devices, "TimeShared")
        uuids = [d.chip.uuid for d in devices]
        for u in uuids:
            self.state.acquire(
                u, claim_uid, SHARING_TIME_SHARED,
                {"interval": config.interval},
            )
        self.chiplib.set_sharing_mode(uuids, SHARING_TIME_SHARED)
        runtime = _runtime.runtime_of_chips(d.chip for d in devices)
        return ContainerEdits(
            env={
                "TPU_DRA_SHARING": "time-shared",
                "TPU_DRA_TIMESHARE_QUANTUM": str(config.quantum_level()),
                "TPU_DRA_SHARED_DIR": "/var/run/tpu-dra-shared",
                "TPU_DRA_CHIP_UUIDS": ",".join(sorted(uuids)),
                **dict(runtime.envelope),
            },
            mounts=[
                {
                    "hostPath": self.run_dir,
                    "containerPath": "/var/run/tpu-dra-shared",
                    "options": ["rw", "rbind"],
                }
            ],
        )

    def reset(self, claim_uid: str, uuids: list[str]) -> None:
        """Back to exclusive when the last claim leaves
        (role of default time-slice reset, device_state.go:358-362).

        Takes UUIDs rather than devices so Unprepare can run from checkpoint
        state alone after a plugin restart.
        """
        freed = [u for u in uuids if self.state.release(u, claim_uid)]
        if freed:
            self.chiplib.set_sharing_mode(freed, SHARING_EXCLUSIVE)
        for u in freed:
            # Last tenant of chip u gone: its lock file goes too.
            try:
                os.unlink(os.path.join(self.run_dir, f"{u}.lock"))
            except OSError:
                pass


def _session_id(claim_uid: str, uuids: list[str]) -> str:
    digest = hashlib.sha256("".join(sorted(uuids)).encode()).hexdigest()[:5]
    return f"{claim_uid}-{digest}"


# File the node plugin renders a session's CURRENT limits into, inside
# the session's shared dir (mounted at /var/run/tpu-dra-shared in every
# container of the claim). The workload shim (parallel/shim.py
# poll_sharing_update) watches its ``generation`` and re-applies the
# limits at a safe step boundary — the hitless half of a rebalance.
LIMITS_FILE = "limits.json"


class ProcessShareSession:
    """Per-claim process-share session (MpsControlDaemon analog,
    sharing.go:124-344, minus the daemon)."""

    def __init__(
        self,
        manager: "ProcessShareManager",
        claim_uid: str,
        devices: list[AllocatableDevice],
        config: ProcessSharedConfig,
    ):
        self.manager = manager
        self.claim_uid = claim_uid
        self.devices = devices
        self.config = config
        # Session id scheme mirrors sharing.go:151-155.
        self.id = _session_id(claim_uid, [d.chip.uuid for d in devices])
        self.shared_dir = os.path.join(manager.run_dir, self.id)

    def _resolved_limits(self) -> dict:
        """The session's effective per-process limits, resolved once and
        shared by container_edits, the limits file, and the store meta —
        three renderings of one truth that must not drift."""
        chips = [d.chip for d in self.devices]
        uuids = [c.uuid for c in chips]
        out: dict = {
            "maxProcesses": self.config.max_processes,
            "tensorcorePercent": self.config.default_active_core_percentage,
            "hbmLimit": self.config.default_hbm_limit,
            "hbmLimitBytes": None,
            "chipHbmBytes": None,
        }
        limits = {}
        if self.config.per_chip_hbm_limit is not None or self.config.default_hbm_limit:
            from ..api.v1alpha1 import PerChipHbmLimit

            limiter = self.config.per_chip_hbm_limit or PerChipHbmLimit()
            limits = limiter.normalize(uuids, self.config.default_hbm_limit)
        if limits:
            # Per-process HBM cap: lowest limit across the claim's chips
            # (one env var governs the process).
            out["hbmLimitBytes"] = min(
                parse_quantity(v) for v in limits.values()
            )
            chip_hbm = min(c.hbm_bytes for c in chips)
            if chip_hbm > 0:
                out["chipHbmBytes"] = chip_hbm
        return out

    def state_meta(self, generation: int) -> dict:
        """Per-chip store meta: the limits this claim holds, stamped with
        the session generation — what the state auditor's
        ``sharing-limits`` check compares against the checkpointed
        config."""
        res = self._resolved_limits()
        return {
            "maxProcesses": res["maxProcesses"],
            "tensorcorePercent": res["tensorcorePercent"],
            "hbmLimit": res["hbmLimit"],
            "generation": generation,
        }

    def current_generation(self) -> Optional[int]:
        """Generation of the limits file currently on disk (None when
        absent/unreadable) — the resize protocol reads it so a replayed
        apply never renders a generation a dead incarnation already
        used for DIFFERENT limits (workloads would ignore the render
        as stale)."""
        try:
            with open(os.path.join(self.shared_dir, LIMITS_FILE)) as f:
                return int(json.load(f).get("generation", 0))
        except (OSError, ValueError, TypeError):
            return None

    def write_limits_file(self, generation: int) -> None:
        """Render the generation-stamped limits document the workload
        shim polls. Atomic, so a reader never sees a torn rewrite."""
        res = self._resolved_limits()
        atomic_write_json(
            os.path.join(self.shared_dir, LIMITS_FILE),
            {
                "generation": generation,
                "mode": "process-shared",
                "maxProcesses": res["maxProcesses"],
                "tensorcorePercent": res["tensorcorePercent"],
                "hbmLimitBytes": res["hbmLimitBytes"],
                "chipHbmBytes": res["chipHbmBytes"],
            },
            indent=None,
        )

    def start(self, generation: int = 1) -> None:
        """Acquire chips + materialise the coordination dir
        (role of Start's mkdirs + daemon create, sharing.go:185-287;
        no readiness wait because there is no daemon to wait for)."""
        uuids = [d.chip.uuid for d in self.devices]
        meta = self.state_meta(generation)
        for u in uuids:
            self.manager.state.acquire(
                u, self.claim_uid, SHARING_PROCESS_SHARED, meta
            )
        self.manager.chiplib.set_sharing_mode(uuids, SHARING_PROCESS_SHARED)
        os.makedirs(self.shared_dir, exist_ok=True)
        self.write_limits_file(generation)

    def resize(self, generation: int) -> None:
        """Hitless limits re-render: update every chip's store meta
        (same-claim acquire is re-entrant) and bump the limits file to
        ``generation`` so running workloads re-apply at their next safe
        step boundary. Idempotent — the two-phase resize protocol
        (DeviceState.resize_claim_limits) may replay it after a crash.
        """
        faults.fire("rebalance.session-resize")
        uuids = [d.chip.uuid for d in self.devices]
        meta = self.state_meta(generation)
        for u in uuids:
            self.manager.state.acquire(
                u, self.claim_uid, SHARING_PROCESS_SHARED, meta
            )
        os.makedirs(self.shared_dir, exist_ok=True)
        self.write_limits_file(generation)

    def container_edits(self) -> ContainerEdits:
        """Env + mounts for the claim's containers
        (GetCDIContainerEdits analog, sharing.go:346-366)."""
        res = self._resolved_limits()
        runtime = _runtime.runtime_of_chips(d.chip for d in self.devices)
        hbm_env: dict[str, str] = {}
        floor = res["hbmLimitBytes"]
        if floor is not None:
            hbm_env.update(
                _runtime.hbm_cap_env(runtime, floor, res["chipHbmBytes"])
            )
        pct = res["tensorcorePercent"]
        if pct is not None:
            hbm_env.update(_runtime.core_share_env(runtime, pct))
        hbm_env.update(runtime.envelope)
        return ContainerEdits(
            env={
                "TPU_DRA_SHARING": "process-shared",
                "TPU_DRA_MAX_PROCESSES": str(self.config.max_processes),
                "TPU_DRA_SHARED_DIR": "/var/run/tpu-dra-shared",
                **hbm_env,
            },
            mounts=[
                {
                    "hostPath": self.shared_dir,
                    "containerPath": "/var/run/tpu-dra-shared",
                    "options": ["rw", "rbind"],
                }
            ],
        )

    def stop(self) -> None:
        """Release chips + remove the dir (Stop analog, sharing.go:368-403)."""
        self.manager.stop_session(
            self.claim_uid, [d.chip.uuid for d in self.devices]
        )


class ProcessShareManager:
    """MpsManager analog (sharing.go:124-183)."""

    def __init__(
        self,
        chiplib: ChipLib,
        state: SharingStateStore,
        run_dir: str,
    ):
        self.chiplib = chiplib
        self.state = state
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)

    def new_session(
        self,
        claim_uid: str,
        devices: list[AllocatableDevice],
        config: ProcessSharedConfig,
    ) -> ProcessShareSession:
        _require_full_chips(devices, "ProcessShared")
        return ProcessShareSession(self, claim_uid, devices, config)

    def stop_session(self, claim_uid: str, uuids: list[str]) -> None:
        """Tear a session down from UUIDs alone (checkpoint-driven
        unprepare after restart; Stop analog, sharing.go:368-403)."""
        freed = [u for u in uuids if self.state.release(u, claim_uid)]
        if freed:
            self.chiplib.set_sharing_mode(freed, SHARING_EXCLUSIVE)
        shutil.rmtree(
            os.path.join(self.run_dir, _session_id(claim_uid, uuids)),
            ignore_errors=True,
        )
