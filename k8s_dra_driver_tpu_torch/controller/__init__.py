"""Cluster controller: ICI slice-domain manager (IMEX analog)."""

from .slice_manager import (
    CHANNELS_PER_DRIVER,
    CHANNELS_PER_POOL,
    CLIQUE_LABEL,
    SLICE_LABEL,
    DomainKey,
    IciSliceManager,
    OffsetAllocator,
)

__all__ = [
    "IciSliceManager",
    "DomainKey",
    "OffsetAllocator",
    "SLICE_LABEL",
    "CLIQUE_LABEL",
    "CHANNELS_PER_DRIVER",
    "CHANNELS_PER_POOL",
]
