"""Shared utilities: atomic fs writes, logging, metrics."""

from .fs import atomic_write_json
from .logging import setup_logging
from .metrics import Counter, Gauge, Histogram, MetricsServer, Registry

__all__ = [
    "atomic_write_json",
    "setup_logging",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsServer",
    "Registry",
]
