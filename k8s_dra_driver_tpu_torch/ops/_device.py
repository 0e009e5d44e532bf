"""Properties of the CUDA device that the kernels' host plans read."""

from __future__ import annotations

import torch

_SM_COUNT: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The device's SM count, read once per device."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]
