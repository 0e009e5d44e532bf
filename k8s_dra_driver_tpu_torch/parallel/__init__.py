"""Parallelism. So far the host-side collective accounting
(:mod:`.collectives`), which the compute telemetry installs, and the
workload's sharing shim (:mod:`.shim`); the device mesh, ring attention
and expert parallelism are still to port."""

from . import collectives

__all__ = ["collectives"]
