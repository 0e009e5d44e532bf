"""PyTorch + CUDA port of the workload layer's serving path.

The package mirrors the layout of the JAX package ``k8s_dra_driver_tpu``
(``ops/``, ``models/``) so each module's counterpart sits at the same
relative path, but it imports nothing from it: whatever it needs from the
JAX package is kept here as its own copy. The JAX package stays the
reference the port is tested against.

Entry points (``init_params``, ``DecodeEngine``, ``generate``) run on the
CUDA device unless the caller passes ``device="cpu"`` explicitly; with
``device=None`` and no CUDA device they raise instead of falling back.

Importing the package loads no ``torch`` (nor ``numpy``): the control
plane (``plugin``, ``controller``, ``kube``, ``serving_gateway``,
``fleetsim``, ``doctor``) runs in a driver image that carries neither.
``resolve_device`` imports ``torch`` when it is called.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when ``device`` is
    None. Raises when a CUDA device is asked for (explicitly or by
    default) and none is present -- the port never drops to the CPU on
    its own."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


__all__ = ["resolve_device"]
