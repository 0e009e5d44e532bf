"""Parallelism. So far only the host-side collective accounting
(:mod:`.collectives`), which the compute telemetry installs; the device
mesh, ring attention and expert parallelism are still to port."""

from . import collectives

__all__ = ["collectives"]
