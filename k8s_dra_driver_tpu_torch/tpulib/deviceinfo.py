"""Allocatable-device model and ResourceSlice attribute rendering.

The port's copy of the reference module. A GPU renders as a ``ChipInfo``
too (``generation`` "h100", ``uuid`` NVML's ``GPU-...``); it has no
partition profile and, NVLink being no mesh, ``coords_reliable`` False,
so no ``submesh*Id`` tile attributes. Its NVML version strings publish in
semver form (``_version_attr``).

TPU-native analog of the reference's deviceinfo.go + allocatable.go
(lengrongfu/k8s-dra-driver, cmd/nvidia-dra-plugin/deviceinfo.go:30-217,
allocatable.go:25-108): three device kinds form a tagged union —

- ``ChipInfo``        — a whole TPU chip            (reference: GpuInfo)
- ``TensorCoreInfo``  — a sub-chip core partition   (reference: MigDeviceInfo)
- ``IciChannelInfo``  — an interconnect channel     (reference: ImexChannelInfo)

Each renders itself to a ``resource.k8s.io`` Device (plain dict in k8s wire
shape) with topology-first attributes so the stock scheduler's CEL /
matchAttribute machinery can express things the reference could not, e.g.
"4 chips forming a contiguous 2x2 sub-mesh on one host".
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from .topology import GENERATIONS, Coord, MeshShape

# Device type tags (reference: cmd/nvidia-dra-plugin/types.go:19-24).
ChipDeviceType = "chip"
TensorCoreDeviceType = "tensorcore"
IciChannelDeviceType = "ici"
UnknownDeviceType = "unknown"

ATTR_PREFIX = "tpu.google.com"


def _attr(value: Any) -> dict[str, Any]:
    """Wrap a value in the DRA DeviceAttribute union shape."""
    if isinstance(value, bool):
        return {"bool": value}
    if isinstance(value, int):
        return {"int": value}
    if isinstance(value, str):
        # Version-ish strings go in the version slot, everything else string.
        return {"string": value}
    raise TypeError(f"unsupported attribute type: {type(value)!r}")


# semver.org 2.0.0, as the API server parses a version attribute.
_SEMVER = re.compile(
    r"^(0|[1-9][0-9]*)(\.(0|[1-9][0-9]*)){2}"
    r"(-[0-9A-Za-z.-]+)?(\+[0-9A-Za-z.-]+)?$"
)
# NVML's VBIOS version: five hex bytes, "96.00.DA.00.0C".
_VBIOS = re.compile(r"^[0-9A-Fa-f]{2}(\.[0-9A-Fa-f]{2}){4}$")


def _version_attr(value: str) -> dict[str, Any]:
    """A version attribute, which the API server takes as semver only.
    A semver value publishes as it is. A VBIOS version reads its first
    three bytes as the core and keeps the whole string as build metadata
    ("96.00.DA.00.0C" -> "150.0.218+96.00.DA.00.0C"). Any other value
    takes its leading decimal fields as the core, leading zeros dropped
    and missing fields 0, and the rest as build metadata, characters
    semver does not allow there made "-": NVML's driver "570.124.06" ->
    "570.124.6", "535.98" -> "535.98.0", "N/A" -> "0.0.0+N-A"."""
    if _SEMVER.match(value):
        return {"version": value}
    parts = value.split(".")
    if _VBIOS.match(value):
        core, build = [int(p, 16) for p in parts[:3]], parts
    else:
        n = 0
        while n < min(3, len(parts)) and parts[n].isdigit() \
                and parts[n].isascii():
            n += 1
        core = [int(p) for p in parts[:n]] + [0] * (3 - n)
        build = parts[n:]
    build = [re.sub(r"[^0-9A-Za-z-]", "-", p) for p in build if p]
    return {"version": ".".join(map(str, core))
            + ("+" + ".".join(build) if build else "")}


@dataclasses.dataclass
class ChipInfo:
    """A whole TPU chip (reference GpuInfo, deviceinfo.go:30-43)."""

    index: int                      # host-local chip index (device ordinal)
    uuid: str                       # stable id, e.g. "TPU-<serial>"
    generation: str                 # "v4" | "v5e" | "v5p" | "v6e" | ...
    device_paths: list[str]         # e.g. ["/dev/accel0"] or vfio group nodes
    hbm_bytes: int
    cores: int                      # TensorCores on this chip
    coord: Coord                    # ICI coordinates within the slice
    slice_id: str                   # pod-slice identity, e.g. "v5p-16-abcd"
    slice_topology: MeshShape       # physical shape of the owning slice
    host_id: int                    # worker index within the slice
    hosts_per_slice: int
    pci_address: str = ""
    numa_node: int = -1
    driver_version: str = "0.0.0"   # libtpu version
    firmware_version: str = "0.0.0"
    # False when the chip library could not ground the coordinate in
    # runtime metadata (chiplib.RealChipLib.enumerate_chips contract) —
    # the contiguity tile attributes are then withheld so a scheduler
    # never gang-allocates on made-up adjacency.
    coords_reliable: bool = True
    # Health flags stamped by DeviceState from the chip library's health
    # poll (chiplib.HealthStatus). Published as the tpu.google.com/healthy
    # attribute so CEL selectors can require healthy chips; ``gone`` chips
    # never render at all (DeviceState drops them from allocatable).
    healthy: bool = True
    health_reason: str = ""

    def canonical_name(self) -> str:
        return f"tpu-{self.index}"

    def canonical_index(self) -> str:
        return str(self.index)

    def uuids(self) -> list[str]:
        return [self.uuid]

    def submesh_tile_id(self, tx: int, ty: int, tz: int = 1) -> str:
        """Identity of the axis-aligned (tx, ty, tz) tile this chip's
        coordinate falls in, scoped to the slice.

        Published as an attribute so a stock scheduler can enforce ICI
        contiguity with nothing but ``matchAttribute``: every chip with the
        same tile id is, by construction, part of one contiguous sub-mesh
        (the TPU analog of MIG placement constraints,
        demo/specs/quickstart/gpu-test4.yaml:42-44). Aligned tiles partition
        the slice, so tile-equality claims can never straddle a gap.
        """
        c = self.coord
        return (
            f"{self.slice_id}:{tx}x{ty}x{tz}:"
            f"{c.x // tx}-{c.y // ty}-{c.z // tz}"
        )

    def get_device(self) -> dict[str, Any]:
        """Render as a resource.k8s.io Device (deviceinfo.go:98-140 analog)."""
        spec = GENERATIONS.get(self.generation)
        peak_flops = int(spec.peak_bf16_flops) if spec else 0
        dev = {
            "name": self.canonical_name(),
            "basic": {
                "attributes": {
                    "type": _attr(ChipDeviceType),
                    "uuid": _attr(self.uuid),
                    "index": _attr(self.index),
                    "generation": _attr(self.generation),
                    "cores": _attr(self.cores),
                    "iciX": _attr(self.coord.x),
                    "iciY": _attr(self.coord.y),
                    "iciZ": _attr(self.coord.z),
                    "coord": _attr(str(self.coord)),
                    "sliceId": _attr(self.slice_id),
                    "sliceTopology": _attr(str(self.slice_topology)),
                    "hostId": _attr(self.host_id),
                    "hostsPerSlice": _attr(self.hosts_per_slice),
                    "pcieAddress": _attr(self.pci_address),
                    "numaNode": _attr(self.numa_node),
                    "healthy": _attr(self.healthy),
                    "driverVersion": _version_attr(self.driver_version),
                    "firmwareVersion": _version_attr(self.firmware_version),
                },
                "capacity": {
                    "hbm": {"value": str(self.hbm_bytes)},
                    "tensorcores": {"value": str(self.cores)},
                    "peakBf16Flops": {"value": str(peak_flops)},
                },
            },
        }
        if self.coords_reliable:
            attrs = dev["basic"]["attributes"]
            attrs["submesh2x2Id"] = _attr(self.submesh_tile_id(2, 2, 1))
            attrs["submesh4x4Id"] = _attr(self.submesh_tile_id(4, 4, 1))
        if self.cores >= 2:
            # A whole-chip claim drains the chip's counter set, so the
            # scheduler cannot also hand out this chip's TensorCore
            # partitions (and vice versa). The reference encodes the same
            # exclusivity via MIG memory-slice capacities
            # (deviceinfo.go:184-198).
            dev["basic"]["consumesCounters"] = [
                {
                    "counterSet": f"chip-{self.index}-counters",
                    "counters": {
                        "cores": {"value": str(self.cores)},
                        "hbm": {"value": str(self.hbm_bytes)},
                    },
                }
            ]
        return dev


@dataclasses.dataclass(frozen=True)
class PartitionProfile:
    """A sub-chip partition SHAPE (role of the reference's MIG profile
    records, nvlib.go:244-295): how many cores one instance consumes,
    what fraction of the chip's HBM it takes, and which placement start
    positions it may occupy. The placement/counter machinery is profile-
    generic even though current TPU generations ship only the single
    whole-core profile — a future asymmetric profile (e.g. one core with
    half the chip's HBM) is a table entry, not a code change.
    """

    name: str                       # e.g. "1c"; "1c.halfhbm"; "2c"
    cores: int = 1                  # cores consumed per instance
    # HBM consumed as a fraction (num, den) of the parent chip's HBM;
    # None = proportional to cores/total_cores.
    hbm_fraction: Optional[tuple[int, int]] = None

    def placements(self, total_cores: int) -> list[int]:
        """Valid start cores for this profile on a chip with
        ``total_cores`` (aligned, non-overlapping — MIG placement sets)."""
        if self.cores > total_cores:
            return []
        return list(range(0, total_cores - self.cores + 1, self.cores))

    def hbm_share(self, parent_hbm: int, total_cores: int) -> int:
        if self.hbm_fraction is not None:
            num, den = self.hbm_fraction
            return parent_hbm * num // den
        return parent_hbm * self.cores // max(total_cores, 1)


# The single-core profile every multi-core generation supports (v4/v5p
# chips run two independent TensorCore programs when not fused in
# megacore mode).
ONE_CORE_PROFILE = PartitionProfile(name="1c", cores=1)


def partition_profiles(generation: str) -> list[PartitionProfile]:
    """Profiles a generation supports (reference: the per-arch MIG
    profile enumeration, nvlib.go:244-295). One table entry today;
    the seam future profiles plug into."""
    spec = GENERATIONS.get(generation)
    if spec is None or not spec.partitionable:
        return []
    return [ONE_CORE_PROFILE]


@dataclasses.dataclass
class TensorCoreInfo:
    """A sub-chip TensorCore partition (reference MigDeviceInfo,
    deviceinfo.go:45-56).

    Where MIG slices a GPU into profiles with memory slices, TPU sub-chip
    partitioning hands out placements of a ``PartitionProfile`` on a
    multi-core chip. Each partition is advertised as a first-class device
    that consumes its profile's share of the parent chip's counters, so
    the scheduler can never double-book a chip as both whole and
    partitioned, nor overlap two placements.
    """

    parent: ChipInfo
    core_index: int                 # placement start core within the chip
    profile: PartitionProfile = ONE_CORE_PROFILE

    @property
    def uuid(self) -> str:
        # Profile-qualified so placements of different profiles at the
        # same start core never collide; "1c" keeps the historical form.
        # Parse these back with ``chip_uuid_of_device_uuid`` — never with
        # ad-hoc string splitting.
        if self.profile.name == "1c":
            return f"{self.parent.uuid}-core-{self.core_index}"
        return (
            f"{self.parent.uuid}-{self.profile.name}-{self.core_index}"
        )

    def spanned_cores(self) -> list[int]:
        """The physical core indices this placement occupies."""
        return list(
            range(self.core_index, self.core_index + self.profile.cores)
        )

    def canonical_name(self) -> str:
        # reference: fmt "gpu-%d-mig-%d-%d-%d" deviceinfo.go:80-88. The
        # 1c profile keeps the historical "tpu-N-core-M" names; other
        # profiles carry their profile name MIG-style.
        if self.profile.name == "1c":
            return f"tpu-{self.parent.index}-core-{self.core_index}"
        return (
            f"tpu-{self.parent.index}-{self.profile.name}-{self.core_index}"
        )

    def canonical_index(self) -> str:
        return f"{self.parent.index}:{self.core_index}"

    def uuids(self) -> list[str]:
        return [self.uuid]

    def get_device(self) -> dict[str, Any]:
        total = max(self.parent.cores, 1)
        hbm_share = self.profile.hbm_share(self.parent.hbm_bytes, total)
        spec = GENERATIONS.get(self.parent.generation)
        flops_share = (
            int(spec.peak_bf16_flops) * self.profile.cores // total
            if spec else 0
        )
        dev = {
            "name": self.canonical_name(),
            "basic": {
                "attributes": {
                    "type": _attr(TensorCoreDeviceType),
                    "uuid": _attr(self.uuid),
                    "parentUuid": _attr(self.parent.uuid),
                    "parentIndex": _attr(self.parent.index),
                    "index": _attr(self.core_index),
                    "profile": _attr(self.profile.name),
                    "profileCores": _attr(self.profile.cores),
                    "generation": _attr(self.parent.generation),
                    "coord": _attr(str(self.parent.coord)),
                    "sliceId": _attr(self.parent.slice_id),
                    "hostId": _attr(self.parent.host_id),
                    # A partition is only as healthy as its parent chip.
                    "healthy": _attr(self.parent.healthy),
                    "driverVersion": _version_attr(self.parent.driver_version),
                },
                "capacity": {
                    "hbm": {"value": str(hbm_share)},
                    "tensorcores": {"value": str(self.profile.cores)},
                    "peakBf16Flops": {"value": str(flops_share)},
                },
            },
        }
        # consumesCounters ties every partition of one chip together so
        # the scheduler cannot double-book a chip as both whole and
        # partitioned, nor overlap placements (role of MIG memory-slice
        # capacities, deviceinfo.go:184-198).
        dev["basic"]["consumesCounters"] = [
            {
                "counterSet": f"chip-{self.parent.index}-counters",
                "counters": {
                    "cores": {"value": str(self.profile.cores)},
                    "hbm": {"value": str(hbm_share)},
                },
            }
        ]
        return dev


@dataclasses.dataclass
class IciChannelInfo:
    """A cross-host interconnect channel (reference ImexChannelInfo,
    deviceinfo.go:58-61).

    IMEX channels gate NVLink cross-node memory export; the TPU analog is a
    claimable channel on a slice's ICI/DCN domain.  Workloads that want
    cross-host collectives claim one channel per pod from the slice's domain
    pool; preparation materialises the common launch environment (coordinator
    address, megascale ids) that makes jax.distributed over ICI/DCN work.
    """

    channel: int
    slice_id: str = ""

    def canonical_name(self) -> str:
        return f"ici-channel-{self.channel}"

    NAME_PREFIX = "ici-channel-"

    def uuids(self) -> list[str]:
        return [f"ici-channel-{self.channel}"]

    def get_device(self) -> dict[str, Any]:
        return {
            "name": self.canonical_name(),
            "basic": {
                "attributes": {
                    "type": _attr(IciChannelDeviceType),
                    "channel": _attr(self.channel),
                    "sliceId": _attr(self.slice_id),
                },
            },
        }


@dataclasses.dataclass
class AllocatableDevice:
    """Tagged union over the three device kinds (allocatable.go:27-31)."""

    chip: Optional[ChipInfo] = None
    tensorcore: Optional[TensorCoreInfo] = None
    ici_channel: Optional[IciChannelInfo] = None

    def type(self) -> str:
        if self.chip is not None:
            return ChipDeviceType
        if self.tensorcore is not None:
            return TensorCoreDeviceType
        if self.ici_channel is not None:
            return IciChannelDeviceType
        return UnknownDeviceType

    @property
    def impl(self):
        return self.chip or self.tensorcore or self.ici_channel

    def canonical_name(self) -> str:
        return self.impl.canonical_name()

    def get_device(self) -> dict[str, Any]:
        return self.impl.get_device()


# name -> AllocatableDevice (reference: AllocatableDevices map, allocatable.go:25)
AllocatableDevices = dict[str, AllocatableDevice]


def is_ici_channel_device_name(name: str) -> bool:
    """Whether a device (or allocation-result) name is an ICI channel —
    IciChannelInfo.canonical_name's form. The one classifier; callers
    must not match the prefix themselves, and must never classify by
    POOL name: node pools are named after operator-controlled node
    names, which may themselves start with "ici-"."""
    return name.startswith(IciChannelInfo.NAME_PREFIX)


def chip_uuid_of_device_uuid(device_uuid: str) -> str:
    """The chip uuid any device uuid belongs to. Chip uuids are
    ``TPU-<serial>`` with a hyphen-free serial; partition uuids append
    ``-core-<i>`` (1c profile) or ``-<profile>-<i>`` (TensorCoreInfo.uuid
    above) — so the chip is always the first two hyphen tokens. The one
    parser for that format; callers must not re-implement the split.
    A GPU's uuid (NVML's ``GPU-<8-4-4-4-12 hex>``) is whole: GPUs have no
    partition devices here."""
    if device_uuid.startswith("GPU-"):
        return device_uuid
    return "-".join(device_uuid.split("-")[:2])


def chip_uuids(devices: AllocatableDevices) -> list[str]:
    return sorted(
        d.chip.uuid for d in devices.values() if d.chip is not None
    )


def counter_sets(devices: AllocatableDevices) -> list[dict[str, Any]]:
    """SharedCounter sets for partitionable chips (one per multi-core chip)."""
    out = []
    for d in devices.values():
        if d.chip is None or d.chip.cores < 2:
            continue
        out.append(
            {
                "name": f"chip-{d.chip.index}-counters",
                "counters": {
                    "cores": {"value": str(d.chip.cores)},
                    "hbm": {"value": str(d.chip.hbm_bytes)},
                },
            }
        )
    return out
