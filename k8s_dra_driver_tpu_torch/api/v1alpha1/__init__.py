"""tpu.google.com/v1alpha1 API: the serving SLO classes."""

from .slo import (
    BATCH_CLASS,
    DEFAULT_LATENCY_CLASS,
    INTERACTIVE_CLASS,
    LATENCY_CLASSES,
    REALTIME_CLASS,
    SloConfig,
)

__all__ = [
    "SloConfig", "LATENCY_CLASSES", "DEFAULT_LATENCY_CLASS",
    "REALTIME_CLASS", "INTERACTIVE_CLASS", "BATCH_CLASS",
]
