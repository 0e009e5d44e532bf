"""Parallelism: the single-controller device mesh (:mod:`.mesh`), sharded
values and their specs (:mod:`.sharding`), ring hops with K9's twin
(:mod:`.ring`), the host-side collective accounting (:mod:`.collectives`)
that the compute telemetry installs, and the workload's sharing shim
(:mod:`.shim`). Only the expert axis of a mesh may be larger than 1; the
other compositions, the pipeline and ``elastic`` are still to port."""

from . import collectives
from .mesh import (
    AXES,
    Mesh,
    MeshConfig,
    auto_mesh_config,
    build_mesh,
    host_mesh_shape,
    mesh_from_env,
)
from .ring import (
    ring_attention,
    ring_permute,
    ring_permute_reference,
    ulysses_attention,
)
from .sharding import (
    DEFAULT_RULES,
    P,
    Sharded,
    batch_sharding,
    named_sharding,
    shard_pytree,
    spec_for,
)

__all__ = [
    "collectives",
    "AXES",
    "Mesh",
    "MeshConfig",
    "auto_mesh_config",
    "build_mesh",
    "mesh_from_env",
    "host_mesh_shape",
    "ring_attention",
    "ring_permute",
    "ring_permute_reference",
    "ulysses_attention",
    "DEFAULT_RULES",
    "P",
    "Sharded",
    "spec_for",
    "named_sharding",
    "shard_pytree",
    "batch_sharding",
]
