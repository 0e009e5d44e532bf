"""Node plugin's device layer: the Prepare/Unprepare engine, its
checkpoint and the sharing managers (the port's twin of
``k8s_dra_driver_tpu.plugin`` without the kubelet-facing gRPC server,
which is still to port)."""

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
