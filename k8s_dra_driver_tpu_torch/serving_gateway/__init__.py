"""Fleet serving gateway: prefix-affinity routing, SLO-aware admission,
and replica autoscaling over DecodeEngine replicas. See gateway.py for
the architecture overview and docs/serving.md for operator guidance."""

from .admission import (
    AdmissionController,
    AdmissionPolicy,
    OverloadedError,
)
from .autoscaler import (
    Autoscaler,
    AutoscalerPolicy,
    ReplicaProvisioner,
    ScaleError,
)
from .gateway import (
    GatewayRequest,
    ReplicaLostError,
    ServingGateway,
)
from .reqtrace import (
    RequestTimeline,
    ServingTelemetry,
    TickProfiler,
)
from .router import (
    NoReplicaAvailableError,
    Replica,
    RouteDecision,
    Router,
    prefix_affinity_key,
)

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "Autoscaler",
    "AutoscalerPolicy",
    "GatewayRequest",
    "NoReplicaAvailableError",
    "OverloadedError",
    "Replica",
    "ReplicaLostError",
    "ReplicaProvisioner",
    "RequestTimeline",
    "RouteDecision",
    "Router",
    "ScaleError",
    "ServingGateway",
    "ServingTelemetry",
    "TickProfiler",
    "prefix_affinity_key",
]
