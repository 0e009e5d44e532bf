"""The runtime mapping: what a claim tells the software stack on its chips.

A chip generation names its ``runtime`` (``tpulib/topology.py``): the
TPU rows "libtpu", the H100 "cuda". Every runtime-facing edit of a claim
is chosen here from that name, never from the shape of a device name or
path. For "libtpu" the edits are exactly the reference's
(``k8s_dra_driver_tpu/cdi/spec.py``, ``plugin/sharing.py``); for "cuda":

=================================================  ==============================================
reference, libtpu                                  port, cuda
=================================================  ==============================================
``/dev/accel<i>`` a chip                           ``/dev/nvidia<minor>`` a GPU; ``/dev/nvidiactl``,
                                                   ``/dev/nvidia-uvm``, ``/dev/nvidia-uvm-tools`` in
                                                   the base spec, each where the host has it
``TPU_LIBRARY_PATH`` + a libtpu mount              read-only mounts of ``libcuda.so.1`` and
                                                   ``libnvidia-ml.so.1`` where the driver root has
                                                   them; else no edit
``TPU_VISIBLE_CHIPS=<indices>``                    ``CUDA_VISIBLE_DEVICES=<uuids in index order>``
``TPU_CHIPS_PER_HOST_BOUNDS``, ``TPU_TOPOLOGY`` .. none (no CUDA reader)
``XLA_PYTHON_CLIENT_MEM_FRACTION``,                none: the shim turns ``TPU_DRA_HBM_LIMIT_BYTES``
``TPU_PREMAPPED_BUFFER_SIZE``                      / ``TPU_DRA_CHIP_HBM_BYTES`` into PyTorch's
                                                   allocator fraction (``TPU_DRA_TORCH_MEM_FRACTION``,
                                                   which an operator may pin)
``TPU_DRA_ACTIVE_CORE_PERCENTAGE``                 kept, plus ``CUDA_MPS_ACTIVE_THREAD_PERCENTAGE``
                                                   (read only by an MPS server's clients)
``TPU_VISIBLE_CORES`` .. ``TPU_MEGACORE``          none: a GPU's partition is a MIG device, named by
                                                   its ``MIG-`` uuid in ``CUDA_VISIBLE_DEVICES``; its
                                                   container gets the GPU's node and the GPU and
                                                   compute instances' ``/dev/nvidia-caps`` nodes
=================================================  ==============================================

A shared claim's envelope also names a "cuda" runtime to the workload
shim (``TPU_DRA_RUNTIME=cuda``), which reads it to pick the visibility
and fraction variables below; a "libtpu" envelope carries no such name,
as the reference's does not.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

LIBTPU = "libtpu"
CUDA = "cuda"

# The envelope variable naming a non-libtpu runtime to the workload shim.
RUNTIME_ENV = "TPU_DRA_RUNTIME"

# Where libtpu's claim edits mount the runtime library (JAX loads libtpu
# from TPU_LIBRARY_PATH when set).
CONTAINER_LIBTPU = "/usr/lib/tpu/libtpu.so"

MOUNT_OPTIONS_RO = ["ro", "nosuid", "nodev", "bind"]


@dataclasses.dataclass(frozen=True)
class Runtime:
    name: str
    # The claim's chip set: the shim partitions it per process slot.
    visibility_env: str
    # The allocator fraction the shim derives from the HBM budget (or an
    # operator pins).
    mem_fraction_env: str
    # Where the claim edits also cap a runtime buffer at the budget.
    premapped_env: Optional[str]
    # The core share's variables.
    core_share_env: tuple[str, ...]
    # Device nodes every container of the runtime needs beside its chips'
    # (relative to the dev root; each rendered only where it exists).
    control_nodes: tuple[str, ...]
    # What the shim's envelope adds for this runtime.
    envelope: tuple[tuple[str, str], ...]


RUNTIMES = {
    LIBTPU: Runtime(
        name=LIBTPU,
        visibility_env="TPU_VISIBLE_CHIPS",
        mem_fraction_env="XLA_PYTHON_CLIENT_MEM_FRACTION",
        premapped_env="TPU_PREMAPPED_BUFFER_SIZE",
        core_share_env=("TPU_DRA_ACTIVE_CORE_PERCENTAGE",),
        control_nodes=(),
        envelope=(),
    ),
    CUDA: Runtime(
        name=CUDA,
        visibility_env="CUDA_VISIBLE_DEVICES",
        mem_fraction_env="TPU_DRA_TORCH_MEM_FRACTION",
        premapped_env=None,
        core_share_env=("TPU_DRA_ACTIVE_CORE_PERCENTAGE",
                        "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE"),
        control_nodes=("dev/nvidiactl", "dev/nvidia-uvm",
                       "dev/nvidia-uvm-tools"),
        envelope=((RUNTIME_ENV, CUDA),),
    ),
}


def runtime_of_chips(chips: Iterable) -> Runtime:
    """The one runtime of ``chips`` (ChipInfo), from their generation;
    libtpu where there is none (a claim of channels only). A node holds
    one generation, so two runtimes in one set is a fault."""
    from ..tpulib.topology import runtime_of

    names = {runtime_of(c.generation) for c in chips}
    if len(names) > 1:
        raise ValueError(f"one claim spans runtimes {sorted(names)}")
    return RUNTIMES[names.pop() if names else LIBTPU]


def runtime_of_env(env) -> Runtime:
    """The runtime a shared claim's envelope names (libtpu when none)."""
    return RUNTIMES.get(env.get(RUNTIME_ENV, LIBTPU), RUNTIMES[LIBTPU])


def control_nodes(runtime: Runtime, dev_root: str) -> list[str]:
    """The runtime's control nodes the host has, as paths under
    ``dev_root``."""
    root = dev_root.rstrip("/") or "/"
    paths = [os.path.join(root, rel) for rel in runtime.control_nodes]
    return [p for p in paths if os.path.exists(p)]


def driver_library_edits(runtime: Runtime, droot) -> tuple[dict, list]:
    """(env, mounts) injecting the runtime's driver libraries that the
    ``DriverRoot`` holds; both empty where it holds none."""
    if runtime.name == LIBTPU:
        lib = droot.libtpu_or_none()
        if lib is None:
            return {}, []
        return ({"TPU_LIBRARY_PATH": CONTAINER_LIBTPU},
                [{"hostPath": droot.to_host_path(lib),
                  "containerPath": CONTAINER_LIBTPU,
                  "options": list(MOUNT_OPTIONS_RO)}])
    mounts = []
    for name, path in sorted(droot.driver_libraries().items()):
        # The library goes where the loader looks for it: the directory
        # it was found in, under its soname.
        in_root = "/" + os.path.relpath(os.path.dirname(path), droot.root)
        mounts.append({
            "hostPath": droot.to_host_path(path),
            "containerPath": os.path.normpath(os.path.join(in_root, name)),
            "options": list(MOUNT_OPTIONS_RO),
        })
    return {}, mounts


def cuda_visibility_env(chips: list, mig_devices=()) -> dict[str, str]:
    """``CUDA_VISIBLE_DEVICES`` over the chips' uuids in index order,
    then the MIG devices' (``MIG-...``) in GPU and placement order: a
    uuid names its device whatever renumbering the container's device
    set causes. CUDA enumerates one MIG device a process (the first
    listed): a claim of two MIG devices lists both, and a process meant
    for the second narrows the variable to that uuid."""
    uuids = [c.uuid for c in sorted(chips, key=lambda c: c.index)]
    uuids += [m.uuid for m in sorted(
        mig_devices, key=lambda m: (m.parent.index, m.core_index,
                                    m.ci_id))]
    if not uuids:
        return {}
    return {"CUDA_VISIBLE_DEVICES": ",".join(uuids)}


def hbm_cap_env(runtime: Runtime, floor: int,
                chip_hbm: Optional[int]) -> dict[str, str]:
    """The per-process HBM cap's variables (plugin/sharing.py)."""
    env = {"TPU_DRA_HBM_LIMIT_BYTES": str(floor)}
    if runtime.premapped_env:
        # Also cap XLA's premapped buffer so runtimes without the shim
        # still respect the budget.
        env[runtime.premapped_env] = str(floor)
    if chip_hbm:
        env["TPU_DRA_CHIP_HBM_BYTES"] = str(chip_hbm)
        if runtime.name == LIBTPU:
            # The knob JAX honors; the shim recomputes per-process values,
            # setting it here means even shim-less workloads are capped.
            env[runtime.mem_fraction_env] = f"{min(floor / chip_hbm, 1.0):.4f}"
    return env


def core_share_env(runtime: Runtime, pct: int) -> dict[str, str]:
    return {name: str(pct) for name in runtime.core_share_env}
