"""tpulib: chip discovery and device modeling (role of the reference's
nvlib.go + deviceinfo.go + allocatable.go, see SURVEY.md §2). The port's
twin of ``k8s_dra_driver_tpu.tpulib``: the same exports, discovering
NVIDIA GPUs through NVML."""

from .chiplib import (  # noqa: F401
    HEALTH_DEGRADED,
    HEALTH_GONE,
    HEALTH_HEALTHY,
    ICI_CHANNEL_COUNT,
    ChipLib,
    ChipLibConfig,
    FakeChipLib,
    HealthStatus,
    RealChipLib,
    SHARING_EXCLUSIVE,
    SHARING_PROCESS_SHARED,
    SHARING_TIME_SHARED,
)
from .deviceinfo import (  # noqa: F401
    AllocatableDevice,
    AllocatableDevices,
    ChipDeviceType,
    ChipInfo,
    IciChannelDeviceType,
    IciChannelInfo,
    MigDeviceInfo,
    TensorCoreDeviceType,
    TensorCoreInfo,
    counter_sets,
)
from .topology import (  # noqa: F401
    GENERATIONS,
    Coord,
    MeshShape,
    enumerate_submeshes,
    is_contiguous_submesh,
)
