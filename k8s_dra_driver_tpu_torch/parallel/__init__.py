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

import importlib

from .distributed import coordinator_from_env, initialize_distributed
from .shim import SharingRuntime, apply_sharing_env, timeshare_lease

# The mesh, ring, layout and sharding surface needs torch: it is loaded on
# first use (PEP 562), so that the bootstrap and the shim import without
# torch or numpy, as the driver's control plane does.
_LAZY = {
    "collectives": None,
    **dict.fromkeys(("AXES", "Mesh", "MeshConfig", "auto_mesh_config",
                     "build_mesh", "host_mesh_shape", "mesh_from_env"),
                    "mesh"),
    **dict.fromkeys(("ring_attention", "ring_attention_shards",
                     "ring_permute", "ring_permute_reference",
                     "ulysses_attention"), "ring"),
    "Layout": "layout",
    **dict.fromkeys(("DEFAULT_RULES", "NamedSharding", "P", "Sharded",
                     "batch_sharding", "named_sharding", "shard_pytree",
                     "spec_for"), "sharding"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f".{_LAZY[name] or name}", __name__)
    return module if _LAZY[name] is None else getattr(module, name)


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
