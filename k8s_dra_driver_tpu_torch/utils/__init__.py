"""Shared utilities the serving gateway needs: metrics, fault injection,
tracing."""

from .metrics import Counter, Gauge, Histogram, MetricsServer, Registry

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsServer",
    "Registry",
]
