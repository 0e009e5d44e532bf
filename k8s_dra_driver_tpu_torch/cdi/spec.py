"""CDI (Container Device Interface) spec generation for TPU and GPU
devices.

The port's copy of the reference module. What a claim tells the chip's
software stack (device nodes beyond the chips', driver libraries,
visibility env) is chosen by the chips' runtime from ``runtime.py``: for
a "libtpu" generation every spec is exactly the reference's, for "cuda"
(the H100) it is NVIDIA's device nodes, driver libraries and
``CUDA_VISIBLE_DEVICES``.

Role of the reference's CDI handler (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/cdi.go:50-298), which delegates to the vendored nvcdi
library to emit GPU device nodes, driver-library mounts and hooks. TPUs need
none of that machinery — a TPU container needs exactly:

1. the chip device nodes (``/dev/accel*`` or ``/dev/vfio/*``),
2. environment telling libtpu which chips to bind and how they're laid out
   (``TPU_VISIBLE_CHIPS``, topology/worker env), and
3. for shared claims, the process-bounds / HBM-limit env the sharing manager
   computed.

So we generate CDI 0.7 specs directly: a **base spec** advertising every
allocatable device (CreateStandardDeviceSpecFile analog, cdi.go:158-227) and
**transient per-claim specs** carrying claim-specific env (CreateClaimSpecFile
analog, cdi.go:229-279). Files are written atomically (tempfile + rename) the
way the CDI cache writer does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Optional

from ..tpulib.deviceinfo import AllocatableDevices, ChipInfo, TensorCoreInfo
from ..utils.fs import atomic_write_json as _atomic_write_json
from ..utils.tracing import child_span
from . import runtime as _runtime

logger = logging.getLogger(__name__)

CDI_VERSION = "0.7.0"

# Qualified-name components (cdi.go:36-48 analog):
#   vendor "k8s.tpu.google.com", class "chip" → kind "k8s.tpu.google.com/chip"
DEFAULT_DRIVER_NAME = "tpu.google.com"


@dataclasses.dataclass
class ContainerEdits:
    """A subset of CDI containerEdits we emit."""

    env: dict[str, str] = dataclasses.field(default_factory=dict)
    device_nodes: list[str] = dataclasses.field(default_factory=list)
    mounts: list[dict[str, Any]] = dataclasses.field(default_factory=list)

    def merge(self, other: "ContainerEdits") -> "ContainerEdits":
        env = dict(self.env)
        env.update(other.env)
        return ContainerEdits(
            env=env,
            device_nodes=list(dict.fromkeys(self.device_nodes + other.device_nodes)),
            mounts=self.mounts + other.mounts,
        )

    def to_cdi(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.env:
            out["env"] = [f"{k}={v}" for k, v in sorted(self.env.items())]
        if self.device_nodes:
            out["deviceNodes"] = [
                {"path": p, "type": "c", "permissions": "rw"}
                for p in self.device_nodes
            ]
        if self.mounts:
            out["mounts"] = self.mounts
        return out


class CDIHandler:
    """Writes/deletes CDI spec files under ``cdi_root``
    (NewCDIHandler analog, cdi.go:68-141)."""

    def __init__(
        self,
        cdi_root: str,
        driver_name: str = DEFAULT_DRIVER_NAME,
        dev_root: str = "/",
        driver_root: str = "/",
        driver_root_ctr_path: Optional[str] = None,
    ):
        self.cdi_root = cdi_root
        self.driver_name = driver_name
        self.vendor = f"k8s.{driver_name}"
        self.device_class = "chip"
        self.claim_class = "claim"
        self.dev_root = dev_root
        # driver_root is the HOST path of the driver installation (what CDI
        # hostPath fields must name); driver_root_ctr_path is where that
        # directory is mounted inside THIS container, i.e. where the search
        # actually runs. They coincide when running on the host.
        self.driver_root = driver_root
        self.driver_root_ctr_path = (
            driver_root_ctr_path if driver_root_ctr_path is not None
            else driver_root
        )
        os.makedirs(cdi_root, exist_ok=True)
        # The node's chip runtime (runtime.py), taken from the chips of
        # the last base spec written: every claim spec follows the base
        # spec, which DeviceState writes first.
        self.runtime = _runtime.RUNTIMES[_runtime.LIBTPU]

    def _driver_library_edits(self) -> ContainerEdits:
        """Driver-library injection (nvcdi driver-mount analog): when the
        configured driver root holds the runtime's driver libraries, mount
        them read-only into workload containers (libtpu: libtpu.so, with
        TPU_LIBRARY_PATH pointing at it; cuda: libcuda.so.1 and
        libnvidia-ml.so.1 where the loader looks). No-op when absent —
        containers then use their image's own.

        Probed at every spec WRITE (not cached at startup): claim specs are
        written at prepare time, so a driver installed after plugin startup
        (the usual driver-installer DaemonSet race) is picked up by the
        next claim without a plugin restart."""
        from ..tpulib.driverroot import DriverRoot

        droot = DriverRoot(
            root=self.driver_root_ctr_path, host_root=self.driver_root
        )
        env, mounts = _runtime.driver_library_edits(self.runtime, droot)
        return ContainerEdits(env=env, mounts=mounts)

    # -- qualified names (cdi.go:286-298 analog) ---------------------------

    def get_standard_device(self, device_name: str) -> str:
        return f"{self.vendor}/{self.device_class}={device_name}"

    def get_claim_device(self, claim_uid: str, device_name: str) -> str:
        return f"{self.vendor}/{self.claim_class}={claim_uid}-{device_name}"

    def _base_spec_path(self) -> str:
        return os.path.join(self.cdi_root, f"{self.vendor}-base.json")

    def _claim_spec_path(self, claim_uid: str) -> str:
        return os.path.join(self.cdi_root, f"{self.vendor}-claim_{claim_uid}.json")

    # -- device edits ------------------------------------------------------

    def _chip_edits(self, chip: ChipInfo) -> ContainerEdits:
        return ContainerEdits(device_nodes=list(chip.device_paths))

    def device_edits(self, device) -> ContainerEdits:
        """Per-device containerEdits for the base spec."""
        if device.chip is not None:
            return self._chip_edits(device.chip)
        if device.tensorcore is not None:
            # A core partition still needs its parent chip's device node;
            # core selection happens via env in the claim spec. A MIG
            # device adds its GPU and compute instances' access nodes.
            return ContainerEdits(
                device_nodes=device.tensorcore.device_paths())
        if device.ici_channel is not None:
            return ContainerEdits(
                device_nodes=[
                    f"/dev/tpu-ici-channels/channel{device.ici_channel.channel}"
                ]
            )
        return ContainerEdits()

    # -- spec files --------------------------------------------------------

    def create_standard_device_spec_file(self, allocatable: AllocatableDevices) -> str:
        """Base spec with one CDI device per allocatable device
        (cdi.go:158-227 analog).

        The commonEdits guard plays the role of NVIDIA_VISIBLE_DEVICES=void
        (cdi.go:175-180): mark the container as DRA-managed so host tooling
        (and the TPU device-plugin, if both run) knows not to double-inject.
        """
        from ..utils import faults

        faults.fire("cdi.base-write")
        chips = [d.chip for d in allocatable.values() if d.chip is not None]
        if chips:
            self.runtime = _runtime.runtime_of_chips(chips)
        devices = []
        for name, dev in sorted(allocatable.items()):
            edits = self.device_edits(dev)
            devices.append({"name": name, "containerEdits": edits.to_cdi()})
        spec = {
            "cdiVersion": CDI_VERSION,
            "kind": f"{self.vendor}/{self.device_class}",
            "devices": devices,
            "containerEdits": ContainerEdits(
                env={"TPU_DRA_MANAGED": "1"},
                device_nodes=_runtime.control_nodes(
                    self.runtime, self.dev_root),
            ).merge(self._driver_library_edits()).to_cdi(),
        }
        path = self._base_spec_path()
        _atomic_write_json(path, spec)
        return path

    def create_claim_spec_file(
        self,
        claim_uid: str,
        device_edits: dict[str, ContainerEdits],
        common_env: Optional[dict[str, str]] = None,
    ) -> str:
        """Transient per-claim spec (cdi.go:229-279 analog).

        ``device_edits`` maps device name → claim-specific edits (the env the
        sharing manager / device state computed). ``common_env`` applies to
        every container using any device of the claim (topology env), and is
        merged with the driver-library injection (claims are prepared after
        startup, so this is the injection point that survives the
        driver-installed-late race).
        """
        from ..utils import faults

        faults.fire("cdi.claim-write")
        with child_span("cdi-render", claim_uid=claim_uid) as sp:
            devices = []
            for name, edits in sorted(device_edits.items()):
                devices.append(
                    {
                        "name": f"{claim_uid}-{name}",
                        "containerEdits": edits.to_cdi(),
                    }
                )
            spec = {
                "cdiVersion": CDI_VERSION,
                "kind": f"{self.vendor}/{self.claim_class}",
                "devices": devices,
            }
            common = ContainerEdits(env=dict(common_env or {})).merge(
                self._driver_library_edits()
            ).to_cdi()
            if common:
                spec["containerEdits"] = common
            path = self._claim_spec_path(claim_uid)
            sp.set_tag("path", path).set_tag("devices", len(devices))
            _atomic_write_json(path, spec)
        return path

    def delete_claim_spec_file(self, claim_uid: str) -> None:
        """cdi.go:281-284 analog; missing file is not an error."""
        try:
            os.unlink(self._claim_spec_path(claim_uid))
        except FileNotFoundError:
            pass

    def base_spec_exists(self) -> bool:
        """Whether the standard device spec is on disk (inspection seam:
        the file name is this class's private convention)."""
        return os.path.exists(self._base_spec_path())

    def list_claim_spec_uids(self) -> list[str]:
        """UIDs with transient specs on disk — the orphan-cleanup seam the
        reference left as a TODO (driver.go:154-166)."""
        prefix = f"{self.vendor}-claim_"
        out = []
        for fn in os.listdir(self.cdi_root):
            if fn.startswith(prefix) and fn.endswith(".json"):
                out.append(fn[len(prefix):-len(".json")])
        return sorted(out)


# ---------------------------------------------------------------------------
# TPU workload environment
# ---------------------------------------------------------------------------


def chip_visibility_env(chips: list[ChipInfo]) -> dict[str, str]:
    """Env restricting the runtime to the allocated chips.

    TPU_VISIBLE_CHIPS is the TPU analog of NVIDIA_VISIBLE_DEVICES; the
    topology bounds tell the runtime the shape of the allocated sub-mesh so
    XLA's mesh builder sees the real ICI layout. GPUs get
    ``CUDA_VISIBLE_DEVICES`` over their uuids and nothing else
    (runtime.py).
    """
    if not chips:
        return {}
    if _runtime.runtime_of_chips(chips).name == _runtime.CUDA:
        return _runtime.cuda_visibility_env(chips)
    indices = ",".join(str(c.index) for c in sorted(chips, key=lambda c: c.index))
    xs = [c.coord.x for c in chips]
    ys = [c.coord.y for c in chips]
    zs = [c.coord.z for c in chips]
    bounds = (
        f"{max(xs) - min(xs) + 1},{max(ys) - min(ys) + 1},{max(zs) - min(zs) + 1}"
    )
    first = chips[0]
    # Accelerator-type strings count TensorCores, not chips: 4 chips of v5p
    # is "v5p-8" (cores_per_chip=2), while lite generations (v5e/v6e,
    # cores_per_chip=1) count chips. libtpu derives topology from this.
    from ..tpulib.topology import GENERATIONS

    spec = GENERATIONS.get(first.generation)
    n_cores = len(chips) * (spec.cores_per_chip if spec else 1)
    env = {
        "TPU_VISIBLE_CHIPS": indices,
        "TPU_CHIPS_PER_HOST_BOUNDS": bounds,
        "TPU_ACCELERATOR_TYPE": f"{first.generation}-{n_cores}",
        "TPU_SLICE_ID": first.slice_id,
        "TPU_TOPOLOGY": str(first.slice_topology),
        "TPU_WORKER_ID": str(first.host_id),
        "TPU_RUNTIME_METRICS_PORTS": "",
        # Containers must not fall back to GCE metadata probing on bare hosts.
        "TPU_SKIP_MDS_QUERY": "true",
    }
    return env


def claim_visibility_env(
    chips: list[ChipInfo], cores: list[TensorCoreInfo]
) -> dict[str, str]:
    """Visibility env over ALL devices of one claim.

    Computed once per claim (not per config group) so a claim whose
    allocation spans several config groups still presents the full chip set
    to libtpu. Core partitions contribute their parent chips to the chip
    set plus a TPU_VISIBLE_CORES selection. On a GPU the partitions are
    MIG devices, named by their uuids in ``CUDA_VISIBLE_DEVICES``
    (runtime.py) and carved by no core variable.
    """
    by_uuid = {c.uuid: c for c in chips}
    for core in cores:
        by_uuid.setdefault(core.parent.uuid, core.parent)
    if cores and _runtime.runtime_of_chips(
            by_uuid.values()).name == _runtime.CUDA:
        return _runtime.cuda_visibility_env(chips, cores)
    env = chip_visibility_env(list(by_uuid.values()))
    if cores:
        # A multi-core partition profile exposes EVERY core it spans.
        pairs = sorted(
            (c.parent.index, core)
            for c in cores
            for core in c.spanned_cores()
        )
        env["TPU_VISIBLE_CORES"] = ",".join(f"{i}:{j}" for i, j in pairs)
        env["TPU_PROCESS_BOUNDS"] = f"1,1,{len(pairs)}"
        env["TPU_MEGACORE"] = "0"  # cores addressed independently, not fused
    return env


def tensorcore_visibility_env(cores: list[TensorCoreInfo]) -> dict[str, str]:
    """Env for sub-chip core-partition claims.

    Core partitions run one process per TensorCore: TPU_PROCESS_BOUNDS
    carves the chip, TPU_VISIBLE_CHIPS binds the parent chip, and the core
    index selects the process slot (the role MIG UUIDs play in the
    reference's claim specs).
    """
    if not cores:
        return {}
    return claim_visibility_env([], cores)


# Default base for per-channel coordinator ports. jax.distributed's
# conventional port is 8476; offsetting by the channel number gives every
# claimed channel on a slice a disjoint rendezvous, the way IMEX channel
# ids partition the cross-node memory domain (imex.go:43-45).
COORDINATOR_BASE_PORT = 8476


def ici_channel_launch_env(
    hostnames: list[str], channel: int, host_id: Optional[int] = None
) -> dict[str, str]:
    """Cross-host launch env for an ICI-channel claim.

    The IciChannelInfo contract (tpulib/deviceinfo.py): preparing a channel
    materialises the common launch environment that makes jax.distributed
    over ICI/DCN work — the consumer is parallel.distributed.
    initialize_distributed, which reads exactly these variables. Worker 0
    hosts the coordinator; the port is derived from the claimed channel so
    concurrent jobs on one slice rendezvous on disjoint ports.

    Empty when the chip library has no hostname ground truth — preparation
    must not invent addresses.
    """
    if not hostnames:
        return {}
    raw = os.environ.get("TPU_DRA_COORDINATOR_BASE_PORT",
                         str(COORDINATOR_BASE_PORT))
    try:
        base = int(raw)
    except ValueError:
        raise ValueError(
            f"invalid TPU_DRA_COORDINATOR_BASE_PORT {raw!r}: must be an "
            f"integer port number"
        ) from None
    port = base + channel
    if not 1 <= port <= 65535:
        raise ValueError(
            f"coordinator port {port} (base {base} + channel {channel}) "
            f"outside 1-65535"
        )
    env = {
        "TPU_WORKER_HOSTNAMES": ",".join(hostnames),
        "TPU_DRA_COORDINATOR": f"{hostnames[0]}:{port}",
    }
    # Channel-only claims carry no chips, so chip_visibility_env never runs
    # for them; the process id still has to reach initialize_distributed or
    # every gang member would boot as process 0.
    if host_id is not None:
        env["TPU_WORKER_ID"] = str(host_id)
    return env
