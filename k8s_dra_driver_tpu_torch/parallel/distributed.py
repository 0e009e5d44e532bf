"""Multi-host initialization from DRA-injected environment. Counterpart of
``k8s_dra_driver_tpu/parallel/distributed.py``.

The consumer side of the driver's ICI-channel prepare: the cluster
controller publishes per-slice channel pools (controller/slice_manager.py),
the node plugin injects slice/worker env (cdi/spec.py), and a pod entrypoint
calls ``initialize_distributed()`` before building a mesh. The reference
maps it onto ``jax.distributed.initialize``, a coordinator bootstrap; the
port's twin is ``torch.distributed.init_process_group`` over the same
coordinator address (``tcp://<coordinator>``), which gives the gang's
processes their rendezvous and a process group. The port's mesh stays one
process's (the single-controller mesh, ``parallel/mesh.py``): the group
does not stretch it across processes.

The backend is chosen up front from what the process sees: ``nccl`` where
a CUDA device is visible, ``gloo`` where none is. A failed ``nccl``
initialization raises; it is never retried on ``gloo``, which would hide
the card.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def coordinator_from_env() -> Optional[str]:
    """Coordinator address for the process group.

    Priority: explicit TPU_DRA_COORDINATOR (set by the channel prepare),
    then the GKE-style TPU_WORKER_HOSTNAMES list (worker 0 coordinates).
    """
    addr = os.environ.get("TPU_DRA_COORDINATOR", "")
    if addr:
        return addr
    hostnames = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if hostnames:
        first = hostnames.split(",")[0].strip()
        port = os.environ.get("TPU_DRA_COORDINATOR_PORT", "8476")
        return f"{first}:{port}"
    return None


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize ``torch.distributed`` from env; no-op for single-host
    jobs.

    Returns True if a process group was initialized.
    """
    # Sharing first: the shim must adjust CUDA_VISIBLE_DEVICES and the
    # allocator fraction before the process touches a device.
    from .shim import apply_sharing_env

    apply_sharing_env()

    coordinator = coordinator or coordinator_from_env()
    if num_processes is None:
        hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
        num_processes = len(hosts.split(",")) if hosts else 1
    if process_id is None:
        process_id = int(os.environ.get("TPU_WORKER_ID", "0") or 0)
    if coordinator is None or num_processes <= 1:
        logger.info("single-host job; skipping torch.distributed")
        return False
    import torch
    import torch.distributed as dist

    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )
    logger.info(
        "torch.distributed up (%s): %d processes, this is %d, "
        "coordinator %s", backend, num_processes, process_id, coordinator,
    )
    return True
