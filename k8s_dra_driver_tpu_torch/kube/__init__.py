"""Minimal Kubernetes client layer: the client interface, its in-memory
fake, and the Event recorder the serving gateway narrates through."""

from .client import (
    DEVICE_CLASSES,
    EVENTS,
    GVR,
    NODES,
    PODS,
    RESOURCE_CLAIMS,
    RESOURCE_SLICES,
    FakeKubeClient,
    KubeClient,
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

__all__ = [
    "GVR",
    "RESOURCE_SLICES",
    "RESOURCE_CLAIMS",
    "DEVICE_CLASSES",
    "NODES",
    "PODS",
    "EVENTS",
    "KubeClient",
    "FakeKubeClient",
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
