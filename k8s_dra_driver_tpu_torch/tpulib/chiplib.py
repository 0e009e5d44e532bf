"""Chip enumeration library: the hardware seam of the driver.

The port's copy of the reference module (``tpulib/chiplib.py``): the
interface, ``HealthStatus`` and ``FakeChipLib`` are copied (the fake also
builds a node of NVIDIA GPUs, ``generation="h100"``); ``RealChipLib`` is
rewritten over NVML (``_nvml.py``), the library the reference driver this
project was modelled on wraps through cgo (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/nvlib.go:40-46, :111-200), in place of the
reference's ``/dev/accel*`` + sysfs probing.

Unlike the reference — whose only backend is real hardware, making its test
story "run the demo on GPUs" (SURVEY.md §4) — the backend here is an abstract
interface with a first-class ``FakeChipLib``, so every layer above (device
state, CDI, gRPC plugin, controller) is testable hermetically.
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
import logging
import os
import threading
import time
from typing import Optional

from .deviceinfo import (
    AllocatableDevice,
    AllocatableDevices,
    ChipInfo,
    IciChannelInfo,
    TensorCoreInfo,
)
from .topology import GENERATIONS, Coord, MeshShape

logger = logging.getLogger(__name__)


def _hostpath(root: str, rel: str) -> str:
    """Join a host-root prefix with a relative path; root='/' must yield
    absolute paths, not cwd-relative ones."""
    return os.path.join(root.rstrip("/") or "/", rel)


# Mirror of the reference's IMEX channel capacity constants
# (cmd/nvidia-dra-plugin/nvlib.go:441-444): how many interconnect channels a
# single driver instance will advertise.
ICI_CHANNEL_COUNT = 2048

# Chip health states. The reference has no health model at all — an NVML
# device that wedges after startup stays advertised forever; here health is
# a first-class output of the chip library, consumed by DeviceState.
HEALTH_HEALTHY = "healthy"
HEALTH_DEGRADED = "degraded"   # present but erroring; drain, don't allocate
HEALTH_GONE = "gone"           # device node vanished (unplug, vfio rebind)

# Xids that a workload causes (a kernel's illegal address, a page fault, a
# stopped context, ...), not the card: NVIDIA's k8s-device-plugin leaves
# exactly this set out of its health check. Recording them would let one
# pod's faulting kernel refuse the next claim on a sound card.
APPLICATION_XIDS = frozenset({13, 31, 43, 45, 68, 109})


@dataclasses.dataclass(frozen=True)
class HealthStatus:
    """Point-in-time health of one chip.

    ``since`` is the epoch timestamp of the OBSERVATION (the poll that
    produced this status), not of the underlying hardware event — the
    library has no better clock for that.
    """

    state: str = HEALTH_HEALTHY
    reason: str = ""
    since: float = 0.0

    def is_healthy(self) -> bool:
        return self.state == HEALTH_HEALTHY

    def is_gone(self) -> bool:
        return self.state == HEALTH_GONE

# Sharing modes for a chip runtime (role of NVML compute modes,
# nvlib.go:541-558).
SHARING_EXCLUSIVE = "exclusive"
SHARING_TIME_SHARED = "time-shared"
SHARING_PROCESS_SHARED = "process-shared"


def derive_host_block(
    topology: MeshShape, n_per_host: int
) -> Optional[MeshShape]:
    """Most compact (bx,by,bz) with bx*by*bz == n_per_host tiling the
    topology: minimal z extent first (real multi-host blocks are flat:
    v4/v5p hosts own 2x2x1), then most square in x/y. Shared by the real
    and fake backends so both speak the same coordinate contract."""
    best = None
    for bx in range(1, topology.x + 1):
        if topology.x % bx or n_per_host % bx:
            continue
        for by in range(1, topology.y + 1):
            if topology.y % by or (n_per_host // bx) % by:
                continue
            bz = n_per_host // (bx * by)
            if bz > topology.z or topology.z % bz:
                continue
            key = (bz, abs(bx - by), bx + by + bz)
            if best is None or key < best[0]:
                best = (key, MeshShape(bx, by, bz))
    return best[1] if best else None


@dataclasses.dataclass
class ChipLibConfig:
    """Host-side knobs (role of driver-root flags, main.go:73-123)."""

    dev_root: str = "/"
    sysfs_root: str = "/sys"
    # Metadata overrides; on real hosts these come from the TPU runtime env
    # (GKE sets TPU_* env on node pools) or the C++ shim's sysfs probe.
    generation: Optional[str] = None
    slice_id: Optional[str] = None
    slice_topology: Optional[str] = None
    host_id: int = 0
    hosts_per_slice: int = 1
    # Coordinate-grid metadata (TPU_CHIPS_PER_HOST_BOUNDS /
    # TPU_HOST_BOUNDS mirrors), e.g. "2,2,1". See enumerate_chips for the
    # mapping contract.
    chips_per_host_bounds: Optional[str] = None
    host_bounds: Optional[str] = None
    # Where set_sharing_mode records each chip's mode; None means
    # <dev_root>/var/run/tpu-dra, the reference's place.
    state_dir: Optional[str] = None


class ChipLib(abc.ABC):
    """Interface mirrored from deviceLib (nvlib.go:40-46)."""

    @abc.abstractmethod
    def init(self) -> None: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...

    @abc.abstractmethod
    def enumerate_chips(self) -> list[ChipInfo]: ...

    def enumerate_all_possible_devices(
        self, device_classes: set[str],
        chips: Optional[list[ChipInfo]] = None,
    ) -> AllocatableDevices:
        """Enumerate chips + core partitions + ICI channels
        (enumerateAllPossibleDevices, nvlib.go:111-136). Pass ``chips``
        (e.g. from :meth:`snapshot`) to build from an existing probe
        instead of re-walking the hardware."""
        devices: AllocatableDevices = {}
        if chips is None:
            chips = self.enumerate_chips()
        if "chip" in device_classes or "tensorcore" in device_classes:
            for chip in chips:
                if "chip" in device_classes:
                    d = AllocatableDevice(chip=chip)
                    devices[d.canonical_name()] = d
                if "tensorcore" in device_classes:
                    for tc in self.enumerate_core_partitions(chip):
                        d = AllocatableDevice(tensorcore=tc)
                        devices[d.canonical_name()] = d
        if "ici" in device_classes:
            slice_id = chips[0].slice_id if chips else ""
            for ch in self.enumerate_ici_channels(slice_id):
                d = AllocatableDevice(ici_channel=ch)
                devices[d.canonical_name()] = d
        return devices

    def enumerate_core_partitions(self, chip: ChipInfo) -> list[TensorCoreInfo]:
        """Sub-chip partitions for a chip: every placement of every
        profile the generation supports (role of MIG profile/placement
        enumeration, nvlib.go:244-295). Counter consumption keeps
        overlapping placements and whole-chip claims mutually exclusive.
        """
        from .deviceinfo import partition_profiles

        if chip.cores < 2:
            return []
        return [
            TensorCoreInfo(parent=chip, core_index=start, profile=prof)
            for prof in partition_profiles(chip.generation)
            for start in prof.placements(chip.cores)
        ]

    def enumerate_ici_channels(
        self, slice_id: str = ""
    ) -> list[IciChannelInfo]:
        """All possible interconnect channels (enumerateImexChannels,
        nvlib.go:182-200; count hardcoded like nvlib.go:441-444)."""
        return [
            IciChannelInfo(channel=i, slice_id=slice_id)
            for i in range(ICI_CHANNEL_COUNT)
        ]

    def worker_hostnames(self) -> list[str]:
        """Hostnames of all workers in this host's slice, worker-id order.

        Ground truth for the cross-host launch env an ICI-channel prepare
        injects (cdi.spec.ici_channel_launch_env): worker 0 hosts the
        jax.distributed coordinator. Empty when the platform metadata does
        not carry hostnames (single-host, or bare-metal without the GKE
        TPU env) — preparation then omits the coordinator env and the
        workload falls back to its own bootstrap.
        """
        return []

    def wait_device_event(self, timeout_s: float) -> bool:
        """Block until the device inventory MAY have changed (chip
        hot-plug, vfio rebind), or the timeout lapses; returns True when an
        event woke the wait. The driver's republish loop sleeps here; a
        False return still triggers a periodic re-enumeration, so backends
        without an event source (this default) just pace the resync.
        """
        time.sleep(timeout_s)
        return False

    def chip_health(
        self, chips: Optional[list[ChipInfo]] = None
    ) -> dict[str, HealthStatus]:
        """uuid → HealthStatus for every chip this backend knows about.

        ``chips`` lets the caller supply an enumeration it already has
        (hardware probes are not free; see :meth:`snapshot`). MAY include
        chips ``enumerate_chips`` no longer returns (reported ``gone``
        with a reason) when the backend remembers them; callers
        additionally diff against their own previous view, so a backend
        without memory (this default: everything visible is healthy) still
        yields correct gone-detection one layer up (DeviceState).
        """
        now = time.time()
        if chips is None:
            chips = self.enumerate_chips()
        return {
            c.uuid: HealthStatus(HEALTH_HEALTHY, since=now) for c in chips
        }

    def snapshot(self) -> tuple[list[ChipInfo], dict[str, HealthStatus]]:
        """ONE probe yielding (chips, health) observed at the same
        instant — the device-watch loop's per-tick read. The default
        enumerates once and derives health from that enumeration, so a
        refresh never walks the hardware twice (the probe runs under the
        DeviceState lock that Prepare RPCs also take)."""
        chips = self.enumerate_chips()
        return chips, self.chip_health(chips)

    # --- side-effecting operations used at Prepare time -------------------

    @abc.abstractmethod
    def set_sharing_mode(self, chip_uuids: list[str], mode: str) -> None:
        """Set the chip runtime sharing mode (role of setComputeMode /
        setTimeSlice exec'ing nvidia-smi, nvlib.go:521-558)."""

    @abc.abstractmethod
    def create_ici_channel_device(self, channel: int) -> str:
        """Materialise the per-channel device node (role of
        createImexChannelDevice's mknod, nvlib.go:490-519). Returns path."""


# ---------------------------------------------------------------------------
# Fake backend (the testing seam the reference lacked — SURVEY.md §4)
# ---------------------------------------------------------------------------


class FakeChipLib(ChipLib):
    """In-memory chip backend with a configurable slice topology.

    Fully scriptable fault controls (the hermetic half of the health
    subsystem): ``wedge_chip`` marks a chip degraded in place,
    ``unplug_chip`` removes its device node from enumeration and reports
    it gone, ``restore_chip`` undoes either, and ``set_flap`` flips a chip
    between present and gone on a deterministic schedule driven by the
    health-poll count (never wall time, so chaos tests replay exactly).
    """

    def __init__(
        self,
        generation: str = "v5p",
        topology: str = "2x2x1",
        host_id: int = 0,
        hosts_per_slice: int = 1,
        slice_id: str = "",
        chips_per_host: Optional[int] = None,
        hostnames: Optional[list[str]] = None,
    ):
        self.generation = generation
        self.topology = MeshShape.parse(topology)
        self.host_id = host_id
        self.hosts_per_slice = hosts_per_slice
        self.hostnames = list(hostnames) if hostnames else []
        self.slice_id = slice_id or f"{generation}-{self.topology}-fake"
        self.chips_per_host = (
            chips_per_host
            if chips_per_host is not None
            else self.topology.num_chips // hosts_per_slice
        )
        self.initialized = False
        # Side-effect journals for test assertions.
        self.sharing_modes: dict[str, str] = {}
        self.created_channels: list[int] = []
        # Tests set() this to wake a driver watch loop immediately (the
        # fake's stand-in for an inotify device event).
        self.device_event = threading.Event()
        # Fault state, keyed by host-local chip index.
        self._wedged: dict[int, str] = {}      # index -> reason
        self._unplugged: dict[int, str] = {}   # index -> reason
        self._flaps: dict[int, int] = {}       # index -> period (in polls)
        self.health_polls = 0                  # deterministic flap clock

    # -- fault controls ----------------------------------------------------

    def wedge_chip(self, index: int, reason: str = "wedged") -> None:
        """Chip stays enumerated but reports degraded (hung runtime)."""
        self._wedged[index] = reason
        self.device_event.set()

    def unplug_chip(self, index: int, reason: str = "unplugged") -> None:
        """Chip's device node disappears: gone from enumeration + health."""
        self._unplugged[index] = reason
        self.device_event.set()

    def restore_chip(self, index: int) -> None:
        """Undo wedge/unplug/flap for one chip."""
        self._wedged.pop(index, None)
        self._unplugged.pop(index, None)
        self._flaps.pop(index, None)
        self.device_event.set()

    def set_flap(self, index: int, period: int = 2) -> None:
        """Flap a chip on a schedule: present for ``period`` health polls,
        gone for the next ``period``, repeating. Deterministic — driven by
        the poll count, not time."""
        if period < 1:
            raise ValueError(f"flap period must be >= 1, got {period}")
        self._flaps[index] = period
        self.device_event.set()

    def _flapped_out(self, index: int) -> bool:
        period = self._flaps.get(index)
        if period is None:
            return False
        return (self.health_polls // period) % 2 == 1

    def init(self) -> None:
        self.initialized = True

    def shutdown(self) -> None:
        self.initialized = False

    def _host_coords(self) -> list[Coord]:
        """This host's chip coordinates under the same block contract the
        real backend derives from grid metadata (RealChipLib.
        enumerate_chips): host_id indexes a host grid of compact per-host
        blocks. Falls back to host-major linear slicing when the chip
        count doesn't tile the topology (deliberately odd test setups)."""
        block = derive_host_block(self.topology, self.chips_per_host)
        if block is not None:
            host_grid = MeshShape(
                self.topology.x // block.x,
                self.topology.y // block.y,
                self.topology.z // block.z,
            )
            if self.host_id < host_grid.num_chips:
                hc = host_grid.coord_at(self.host_id)
                return [
                    Coord(
                        hc.x * block.x + block.coord_at(i).x,
                        hc.y * block.y + block.coord_at(i).y,
                        hc.z * block.z + block.coord_at(i).z,
                    )
                    for i in range(self.chips_per_host)
                ]
        all_coords = list(self.topology.coords())
        lo = self.host_id * self.chips_per_host
        return all_coords[lo:lo + self.chips_per_host]

    def _all_chips(self) -> list[ChipInfo]:
        """Every chip of this host's block, ignoring fault state (the
        ground truth unplug/flap subtract from). A ``cuda`` generation's
        chips carry what NVML would report for a node of GPUs: ``GPU-``
        uuids, ``/dev/nvidia<i>`` nodes, NVML's bus id form, and no
        trusted coordinate."""
        spec = GENERATIONS[self.generation]
        gpu = spec.runtime == "cuda"
        chips = []
        for local_idx, coord in enumerate(self._host_coords()):
            digest = hashlib.sha256(
                f"{self.slice_id}/{coord}".encode()
            ).hexdigest()
            if gpu:
                uuid = (f"GPU-{digest[:8]}-{digest[8:12]}-{digest[12:16]}-"
                        f"{digest[16:20]}-{digest[20:32]}")
                node = f"/dev/nvidia{local_idx}"
                pci = f"00000000:{local_idx:02X}:00.0"
            else:
                uuid = f"TPU-{digest[:12]}"
                node = f"/dev/accel{local_idx}"
                pci = f"0000:{local_idx:02x}:00.0"
            chips.append(
                ChipInfo(
                    index=local_idx,
                    uuid=uuid,
                    generation=self.generation,
                    device_paths=[node],
                    hbm_bytes=spec.hbm_bytes,
                    cores=spec.cores_per_chip,
                    coord=coord,
                    slice_id=self.slice_id,
                    slice_topology=self.topology,
                    host_id=self.host_id,
                    hosts_per_slice=self.hosts_per_slice,
                    pci_address=pci,
                    numa_node=local_idx % 2,
                    driver_version="1.0.0",
                    firmware_version="1.0.0",
                    coords_reliable=spec.ici_dims > 0,
                )
            )
        return chips

    def enumerate_chips(self) -> list[ChipInfo]:
        from ..utils import faults

        faults.fire("chiplib.enumerate")
        return [
            c for c in self._all_chips()
            if c.index not in self._unplugged
            and not self._flapped_out(c.index)
        ]

    def chip_health(
        self, chips: Optional[list[ChipInfo]] = None
    ) -> dict[str, HealthStatus]:
        """Scripted health: unplugged/flapped-out chips report gone (with
        the injected reason), wedged ones degraded, the rest healthy. Each
        call advances the deterministic flap clock by one poll. ``chips``
        is ignored — the fake's ground truth is its own fault state, and
        health must cover unplugged chips a caller's enumeration lacks."""
        self.health_polls += 1
        now = time.time()
        out: dict[str, HealthStatus] = {}
        for c in self._all_chips():
            if c.index in self._unplugged:
                out[c.uuid] = HealthStatus(
                    HEALTH_GONE, self._unplugged[c.index], now
                )
            elif self._flapped_out(c.index):
                out[c.uuid] = HealthStatus(
                    HEALTH_GONE,
                    f"flapping (period {self._flaps[c.index]} polls)", now,
                )
            elif c.index in self._wedged:
                out[c.uuid] = HealthStatus(
                    HEALTH_DEGRADED, self._wedged[c.index], now
                )
            else:
                out[c.uuid] = HealthStatus(HEALTH_HEALTHY, since=now)
        return out

    def snapshot(self) -> tuple[list[ChipInfo], dict[str, HealthStatus]]:
        """Health FIRST (advancing the flap clock), then enumeration, so
        both halves observe the same deterministic tick — the base
        default would enumerate at the pre-advance tick."""
        health = self.chip_health()
        return self.enumerate_chips(), health

    def set_sharing_mode(self, chip_uuids: list[str], mode: str) -> None:
        for u in chip_uuids:
            self.sharing_modes[u] = mode

    def create_ici_channel_device(self, channel: int) -> str:
        from ..utils import faults

        faults.fire("chiplib.create-channel")
        self.created_channels.append(channel)
        return f"/dev/tpu-ici-channels/channel{channel}"

    def worker_hostnames(self) -> list[str]:
        return list(self.hostnames)

    def wait_device_event(self, timeout_s: float) -> bool:
        if self.device_event.wait(timeout_s):
            self.device_event.clear()
            return True
        return False


# ---------------------------------------------------------------------------
# Real backend: NVIDIA GPUs through NVML
# ---------------------------------------------------------------------------


class MigEnabledError(RuntimeError):
    """A GPU is in MIG mode. Its partitions are not modelled, and
    publishing the whole GPU would misstate what CUDA can see on it."""


class UnsupportedGpuError(RuntimeError):
    """NVML names a GPU no generation row describes."""


class RealChipLib(ChipLib):
    """Discovers the host's NVIDIA GPUs through NVML.

    One ``ChipInfo`` per NVML device: its NVML index, uuid, generation
    (from the name), ``/dev/nvidia<minor>`` node, memory total, PCI bus
    id, NUMA node, driver and VBIOS versions; ``coords_reliable`` is
    False (NVLink is no mesh). There is no sysfs fallback: without NVML
    there is no GPU to publish. ``nvml`` is an object with the methods of
    ``_nvml.Nvml`` (tests pass a fake); None loads the host's library at
    :meth:`init`.

    Health reads three signals: the device handle (gone when NVML no
    longer finds the uuid) and the device node (gone when it vanished),
    the uncorrected volatile ECC count (degraded when it advanced since
    the last poll) and Xid critical-error events (degraded at the poll
    after one arrived). A signal the driver or the GPU lacks reads as
    none, never as "healthy by measurement".
    """

    # Substring of NVML's device name -> generation.
    GPU_GENERATIONS = (("H100", "h100"),)
    # The longest single NVML event wait. A caller stopping the device
    # watch wakes it through ``device_event`` and joins the waiting thread
    # for a second (``Driver.shutdown``); NVML's own wait cannot be woken,
    # and ``nvmlShutdown`` blocks until it returns.
    EVENT_WAIT_SLICE_S = 0.25

    def __init__(self, config: Optional[ChipLibConfig] = None, nvml=None):
        self.config = config or ChipLibConfig()
        self.initialized = False
        self._nvml = nvml
        # Health-probe memory: chips seen by the last enumeration (so a
        # vanished GPU is reported gone, not just absent), the last ECC
        # sample per chip, and the Xid events not yet reported.
        self._known_chips: dict[str, ChipInfo] = {}
        self._last_errors: dict[str, int] = {}
        self._events = None                  # NVML event set, or None
        self._event_uuids: dict[int, str] = {}   # device handle -> uuid
        self._xids: dict[str, int] = {}
        self._xid_lock = threading.Lock()
        # Set to end a wait_device_event early (FakeChipLib's seam).
        self.device_event = threading.Event()

    def init(self) -> None:
        from . import _nvml

        if self._nvml is None:
            self._nvml = _nvml.load()
        self._nvml.init()
        self._open_events()
        self.initialized = True

    def shutdown(self) -> None:
        if self._events is not None:
            self._nvml.event_set_free(self._events)
            self._events = None
        self._nvml.shutdown()
        self.initialized = False

    def _signal(self, fn, *args):
        """``fn(*args)``, or None where the driver or the GPU has no such
        signal (an unsupported query, a symbol an older driver lacks)."""
        from ._nvml import NO_SIGNAL_ERRORS

        try:
            return fn(*args)
        except NO_SIGNAL_ERRORS:
            return None

    def _open_events(self) -> None:
        """An event set with every GPU's Xid critical errors registered;
        None where the driver or no GPU supports events."""
        from ._nvml import ERRORS, EVENT_XID_CRITICAL_ERROR, NO_SIGNAL_ERRORS

        # A container may be refused the events (no permission): no
        # signal either.
        refused = NO_SIGNAL_ERRORS + (ERRORS[4],)
        nv = self._nvml
        try:
            events = nv.event_set_create()
        except refused:
            return
        for index in range(nv.device_count()):
            handle = nv.handle_by_index(index)
            try:
                nv.register_events(handle, EVENT_XID_CRITICAL_ERROR, events)
            except refused:
                continue
            self._event_uuids[handle] = nv.uuid(handle)
        if not self._event_uuids:
            nv.event_set_free(events)
            return
        self._events = events

    def _generation(self, name: str) -> str:
        if self.config.generation:
            return self.config.generation
        for key, generation in self.GPU_GENERATIONS:
            if key in name:
                return generation
        raise UnsupportedGpuError(
            f"no generation row describes the GPU {name!r}"
        )

    def enumerate_chips(self) -> list[ChipInfo]:
        from ..utils import faults
        from ._nvml import MIG_ENABLED

        faults.fire("chiplib.enumerate")
        nv = self._nvml
        count = nv.device_count()
        driver = self._signal(nv.driver_version) or "0.0.0"
        topology = MeshShape(max(count, 1), 1, 1)
        chips = []
        for index in range(count):
            handle = nv.handle_by_index(index)
            name = nv.name(handle)
            uuid = nv.uuid(handle)
            if self._signal(nv.mig_mode, handle) == MIG_ENABLED:
                raise MigEnabledError(
                    f"GPU {index} ({uuid}, {name}) is in MIG mode; MIG "
                    "partitions are not supported yet"
                )
            generation = self._generation(name)
            spec = GENERATIONS[generation]
            numa = self._signal(nv.numa_node, handle)
            pci = self._signal(nv.pci_info, handle)
            slice_id = self.config.slice_id or (
                f"{generation}-{topology}-{os.uname().nodename}"
            )
            chips.append(
                ChipInfo(
                    index=index,
                    uuid=uuid,
                    generation=generation,
                    device_paths=[_hostpath(
                        self.config.dev_root,
                        f"dev/nvidia{nv.minor_number(handle)}",
                    )],
                    hbm_bytes=nv.memory_total(handle),
                    cores=spec.cores_per_chip,
                    coord=Coord(index, 0, 0),
                    slice_id=slice_id,
                    slice_topology=topology,
                    host_id=self.config.host_id,
                    hosts_per_slice=self.config.hosts_per_slice,
                    pci_address="" if pci is None else pci.bus_id,
                    numa_node=-1 if numa is None else numa,
                    driver_version=driver,
                    firmware_version=(
                        self._signal(nv.vbios_version, handle) or "0.0.0"
                    ),
                    coords_reliable=False,
                )
            )
        return chips

    # -- side effects ------------------------------------------------------

    def set_sharing_mode(self, chip_uuids: list[str], mode: str) -> None:
        """Record the requested per-chip sharing mode in the state dir.

        A GPU's own compute mode (``nvidia-smi -c``) needs root and is
        left alone: sharing is realised through the claim's env and the
        workload shim (plugin/sharing.py, parallel/shim.py), as on the
        reference's TPUs. The record lets concurrent claims on one chip
        be validated against it (role of nvidia-smi -c, nvlib.go:541-558).
        """
        state_dir = self.config.state_dir or _hostpath(
            self.config.dev_root, "var/run/tpu-dra"
        )
        os.makedirs(state_dir, exist_ok=True)
        for u in chip_uuids:
            with open(os.path.join(state_dir, f"{u}.mode"), "w") as f:
                f.write(mode)

    def create_ici_channel_device(self, channel: int) -> str:
        raise NotImplementedError(
            "interconnect channels (IMEX over NVLink) need several GPUs; "
            "they are still to port (ROADMAP A12)"
        )

    # -- events and health -------------------------------------------------

    def _drain_events(self, timeout_ms: int) -> bool:
        """Wait up to ``timeout_ms`` for an event, then take every event
        already queued; remember each Xid against its GPU, except those in
        ``APPLICATION_XIDS``. True when an event came."""
        from ._nvml import EVENT_XID_CRITICAL_ERROR, NvmlTimeout

        if self._events is None:
            return False
        got = False
        while True:
            try:
                event = self._nvml.event_set_wait(self._events, timeout_ms)
            except NvmlTimeout:
                return got
            got = True
            timeout_ms = 0
            uuid = self._event_uuids.get(event.handle)
            if (uuid is not None
                    and event.event_type & EVENT_XID_CRITICAL_ERROR
                    and event.data not in APPLICATION_XIDS):
                with self._xid_lock:
                    self._xids[uuid] = event.data

    def wait_device_event(self, timeout_s: float) -> bool:
        """Block on the Xid event set (only pace where the driver offers
        no events), in NVML waits of at most ``EVENT_WAIT_SLICE_S``; True
        when an event came or ``device_event`` was set."""
        deadline = time.monotonic() + timeout_s
        while True:
            if self.device_event.is_set():
                self.device_event.clear()
                return True
            now = time.monotonic()
            if now >= deadline:
                return False
            step_end = min(deadline, now + self.EVENT_WAIT_SLICE_S)
            if self._events is not None and self._drain_events(
                    int((step_end - now) * 1000)):
                return True
            self.device_event.wait(max(0.0, step_end - time.monotonic()))

    def chip_health(
        self, chips: Optional[list[ChipInfo]] = None
    ) -> dict[str, HealthStatus]:
        """Poll health for every GPU this host has ever enumerated (the
        reference's contract, ``chiplib.py:961-1013``): ``gone`` when the
        GPU no longer enumerates, NVML no longer finds its uuid, or its
        device node vanished; ``degraded`` when its uncorrected ECC count
        advanced since the last poll or an Xid critical error arrived
        since the last poll; else ``healthy``."""
        from ._nvml import GONE_ERRORS

        now = time.time()
        if chips is None:
            chips = self.enumerate_chips()
        current = {c.uuid: c for c in chips}
        self._known_chips.update(current)
        self._drain_events(0)
        nv = self._nvml
        out: dict[str, HealthStatus] = {}
        for uuid, chip in self._known_chips.items():
            if uuid not in current:
                out[uuid] = HealthStatus(
                    HEALTH_GONE, "chip no longer enumerable", now
                )
                continue
            try:
                handle = nv.handle_by_uuid(uuid)
            except GONE_ERRORS as e:
                out[uuid] = HealthStatus(
                    HEALTH_GONE, f"NVML lost the GPU: {e}", now
                )
                continue
            missing = [
                p for p in chip.device_paths if not os.path.exists(p)
            ]
            if missing:
                out[uuid] = HealthStatus(
                    HEALTH_GONE, f"device node missing: {missing[0]}", now
                )
                continue
            reasons = []
            with self._xid_lock:
                xid = self._xids.pop(uuid, None)
            if xid is not None:
                reasons.append(f"Xid {xid} critical error")
            errs = self._signal(nv.ecc_uncorrected, handle)
            if errs is not None:
                last = self._last_errors.get(uuid)
                self._last_errors[uuid] = errs
                if last is not None and errs > last:
                    reasons.append(
                        f"uncorrected ECC errors advanced {last} -> {errs}"
                    )
            out[uuid] = (
                HealthStatus(HEALTH_DEGRADED, "; ".join(reasons), now)
                if reasons else HealthStatus(HEALTH_HEALTHY, since=now)
            )
        return out
