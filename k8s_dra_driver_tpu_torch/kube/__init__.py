"""Minimal Kubernetes client layer (fake + real) and the scheduler side of
the control plane: ResourceSlice publishing, the CEL subset, the reference
allocator and the defragmenter."""

from .client import (
    DEVICE_CLASSES,
    EVENTS,
    GVR,
    NODES,
    PODS,
    RESOURCE_CLAIMS,
    RESOURCE_SLICES,
    ExecAuthConfig,
    FakeKubeClient,
    KubeClient,
    RealKubeClient,
    RestConfig,
    Watch,
    WatchEvent,
    matches_labels,
    parse_label_selector,
)
from .errors import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    InvalidError,
    NotFoundError,
    is_conflict,
    is_not_found,
)
from .events import EventRecorder, ObjectRef
from .resourceapi import ResourceApi

__all__ = [
    "GVR",
    "ResourceApi",
    "RESOURCE_SLICES",
    "RESOURCE_CLAIMS",
    "DEVICE_CLASSES",
    "NODES",
    "PODS",
    "EVENTS",
    "KubeClient",
    "FakeKubeClient",
    "RealKubeClient",
    "RestConfig",
    "ExecAuthConfig",
    "Watch",
    "WatchEvent",
    "EventRecorder",
    "ObjectRef",
    "matches_labels",
    "parse_label_selector",
    "ApiError",
    "NotFoundError",
    "AlreadyExistsError",
    "ConflictError",
    "InvalidError",
    "is_not_found",
    "is_conflict",
]
