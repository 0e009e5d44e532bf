"""Parallelism: the single-controller device mesh (:mod:`.mesh`), sharded
values and their specs (:mod:`.sharding`), the explicit placement of a
forward over the data, fsdp, sequence, tensor and expert axes
(:mod:`.layout`), ring hops with K9's twin and sequence parallelism --
ring attention over K4-K6 per hop and Ulysses -- (:mod:`.ring`), the
GPipe pipeline over the pipe axis (:mod:`.pipeline`), the collectives and
their host-side accounting (:mod:`.collectives`) that the compute
telemetry installs, elastic training over a gang's members
(:mod:`.elastic`), and the bootstrap from the driver's env: the workload's
sharing shim (:mod:`.shim`) and the process group (:mod:`.distributed`)."""

from . import collectives
from .distributed import coordinator_from_env, initialize_distributed
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
    ring_attention_shards,
    ring_permute,
    ring_permute_reference,
    ulysses_attention,
)
from .layout import Layout
from .shim import SharingRuntime, apply_sharing_env, timeshare_lease
from .sharding import (
    DEFAULT_RULES,
    NamedSharding,
    P,
    Sharded,
    batch_sharding,
    named_sharding,
    shard_pytree,
    spec_for,
)

__all__ = [
    "collectives",
    "coordinator_from_env",
    "initialize_distributed",
    "SharingRuntime",
    "apply_sharing_env",
    "timeshare_lease",
    "AXES",
    "Mesh",
    "MeshConfig",
    "auto_mesh_config",
    "build_mesh",
    "mesh_from_env",
    "host_mesh_shape",
    "ring_attention",
    "ring_attention_shards",
    "ring_permute",
    "ring_permute_reference",
    "ulysses_attention",
    "DEFAULT_RULES",
    "Layout",
    "NamedSharding",
    "P",
    "Sharded",
    "spec_for",
    "named_sharding",
    "shard_pytree",
    "batch_sharding",
]
