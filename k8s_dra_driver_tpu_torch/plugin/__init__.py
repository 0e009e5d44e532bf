"""Node plugin: the Prepare/Unprepare engine, its checkpoint, the sharing
managers, and the kubelet-facing Driver (``driver.py``) with its
accounting, audit, cleanup and rebalancer loops, the CLI (``main.py``)
and ``inspect.py`` -- the port's twin of ``k8s_dra_driver_tpu.plugin``.
The DRA services answer on the kubelet's two unix sockets, as gRPC over
HTTP/2 written by hand (``grpc_uds.py``, ``hpack.py``), or in process
(``kubeletplugin.LocalTransport``)."""

from .checkpoint import CheckpointManager, CorruptCheckpointError
from .device_state import DeviceState, PrepareError
from .prepared import (
    KubeletDevice,
    PreparedClaim,
    PreparedDevice,
    PreparedDeviceGroup,
)
from .sharing import (
    ModeConflictError,
    ProcessShareManager,
    SharingError,
    SharingStateStore,
    TimeShareManager,
)

__all__ = [
    "CheckpointManager",
    "CorruptCheckpointError",
    "DeviceState",
    "PrepareError",
    "KubeletDevice",
    "PreparedClaim",
    "PreparedDevice",
    "PreparedDeviceGroup",
    "TimeShareManager",
    "ProcessShareManager",
    "SharingStateStore",
    "SharingError",
    "ModeConflictError",
]
