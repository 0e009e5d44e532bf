"""tpu.google.com/v1alpha1 opaque device-config API (the port's copy of
the reference package: the same exports)."""

from .configs import (
    API_VERSION,
    GROUP,
    ICI_CHANNEL_CONFIG_KIND,
    TENSORCORE_CONFIG_KIND,
    TPU_CHIP_CONFIG_KIND,
    VERSION,
    ConfigError,
    IciChannelConfig,
    TensorCoreConfig,
    TpuChipConfig,
    decode_config,
)
from .quantity import InvalidQuantityError, parse_quantity, to_mebibytes_string
from .slo import (
    BATCH_CLASS,
    DEFAULT_LATENCY_CLASS,
    INTERACTIVE_CLASS,
    LATENCY_CLASSES,
    REALTIME_CLASS,
    SloConfig,
)
from .sharing import (
    DEFAULT_INTERVAL,
    EXCLUSIVE,
    INTERVALS,
    LONG_INTERVAL,
    MEDIUM_INTERVAL,
    PROCESS_SHARED,
    SHORT_INTERVAL,
    STRATEGIES,
    TIME_SHARED,
    ErrInvalidDeviceSelector,
    ErrInvalidLimit,
    PerChipHbmLimit,
    ProcessSharedConfig,
    TimeSharedConfig,
    TpuSharing,
)

__all__ = [
    "API_VERSION", "GROUP", "VERSION",
    "TPU_CHIP_CONFIG_KIND", "TENSORCORE_CONFIG_KIND", "ICI_CHANNEL_CONFIG_KIND",
    "ConfigError", "TpuChipConfig", "TensorCoreConfig", "IciChannelConfig",
    "decode_config",
    "InvalidQuantityError", "parse_quantity", "to_mebibytes_string",
    "EXCLUSIVE", "TIME_SHARED", "PROCESS_SHARED", "STRATEGIES",
    "DEFAULT_INTERVAL", "SHORT_INTERVAL", "MEDIUM_INTERVAL", "LONG_INTERVAL",
    "INTERVALS", "TpuSharing", "TimeSharedConfig", "ProcessSharedConfig",
    "PerChipHbmLimit", "ErrInvalidDeviceSelector", "ErrInvalidLimit",
    "SloConfig", "LATENCY_CLASSES", "DEFAULT_LATENCY_CLASS",
    "REALTIME_CLASS", "INTERACTIVE_CLASS", "BATCH_CLASS",
]
