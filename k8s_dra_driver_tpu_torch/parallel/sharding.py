"""Sharding rules and sharded values on a single-controller mesh.
Counterpart of ``k8s_dra_driver_tpu/parallel/sharding.py``.

The reference annotates arrays with logical axes, maps them to mesh axes
in one table (:data:`DEFAULT_RULES`, :func:`spec_for`) and lets XLA place
them (``shard_pytree`` is a ``device_put`` per leaf). The port keeps the
table and the specs (:class:`P`, a tuple like ``PartitionSpec``) and
places a leaf itself:

- a leaf whose spec names a mesh axis larger than 1 becomes a
  :class:`Sharded`, one contiguous slice of that dimension per shard, in
  shard order. A slice is a view of the leaf where its shard's device is
  the leaf's, and a copy onto the shard's device only where it differs;
  on one card the sharded weights therefore take no more memory than the
  whole ones;
- a replicated leaf (``P()``, or axes of size 1) stays one tensor on the
  mesh's first device, the controller: the port runs the replicated work
  (the dense trunk, routing) once there, and a body that needs it on
  another shard's device moves it there.

Only the ``expert`` axis may be larger than 1 (``mesh.require_expert_only``).
:func:`named_sharding` and :func:`batch_sharding` have no counterpart yet
(A12 in ROADMAP.md) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .mesh import Mesh, require_expert_only

# Logical axis -> mesh axis (None = replicated), the reference's table.
DEFAULT_RULES: dict[str, Optional[str | tuple[str, ...]]] = {
    "batch": ("data", "fsdp"),
    "seq": "sequence",
    "embed": None,
    "vocab": "tensor",
    "embed_fsdp": "fsdp",
    "heads": "tensor",
    "kv_heads": "tensor",
    "mlp": "tensor",
    "head_dim": None,
    "layers": None,
}


class P(tuple):
    """A partition spec: per leading dimension a mesh axis name, a tuple
    of names, or None (replicated); trailing dimensions are replicated.
    Compares equal to the tuple of its entries, as the reference's
    ``PartitionSpec`` unpacks to."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


def spec_for(*logical_axes: Optional[str], rules=None) -> P:
    """The spec of an array whose dims carry these logical names."""
    rules = rules or DEFAULT_RULES
    parts = [None if name is None else rules.get(name)
             for name in logical_axes]
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _axis_size(mesh: Mesh, entry) -> int:
    names = entry if isinstance(entry, tuple) else (entry,)
    size = 1
    for name in names:
        if name is not None:
            size *= mesh.shape[name]
    return size


class Sharded:
    """A value cut along dimension ``dim`` into one tensor per shard of
    ``mesh`` (``shards[i]`` on ``mesh.devices[i]``), by ``spec``. Indexing
    a leading replicated dimension (``w[i]``, ``w.unbind(0)``) indexes
    every shard, so the layer loops slice sharded and whole stacks alike;
    ``shape`` is the whole value's."""

    __slots__ = ("shards", "spec", "mesh", "dim")

    def __init__(self, shards, spec: P, mesh: Mesh, dim: int):
        self.shards = tuple(shards)
        self.spec = spec
        self.mesh = mesh
        self.dim = dim

    @property
    def shape(self) -> torch.Size:
        shape = list(self.shards[0].shape)
        shape[self.dim] *= len(self.shards)
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.shards)

    def __getitem__(self, i: int) -> "Sharded":
        if self.dim == 0:
            raise IndexError("cannot index the sharded dimension of a "
                             "Sharded value")
        return Sharded(tuple(s[i] for s in self.shards), P(*self.spec[1:]),
                       self.mesh, self.dim - 1)

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a Sharded value unbinds only its leading axis")
        return [self[i] for i in range(self.shape[0])]

    def gather(self, device=None) -> torch.Tensor:
        """The whole value on ``device`` (default the first shard's)."""
        device = self.device if device is None else torch.device(device)
        return torch.cat([s.to(device) for s in self.shards], dim=self.dim)

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"{len(self.shards)} shards)")


def _shard_leaf(x: torch.Tensor, mesh: Mesh, spec: P):
    if not isinstance(x, torch.Tensor):
        raise TypeError(
            f"spec {spec} for a {type(x).__name__} leaf: the spec tree must "
            f"match the parameter tree (quant.quantize_specs for int8 "
            f"weights)"
        )
    split = [(d, _axis_size(mesh, entry)) for d, entry in enumerate(spec)
             if _axis_size(mesh, entry) > 1]
    if not split:
        return x.to(mesh.devices[0])
    (dim, n), = split       # expert-only meshes split one dimension
    if x.shape[dim] % n:
        raise ValueError(
            f"dimension {dim} of a {tuple(x.shape)} leaf does not divide "
            f"over {n} shards (spec {spec})"
        )
    step = x.shape[dim] // n
    return Sharded(
        tuple(x.narrow(dim, i * step, step).to(dev)
              for i, dev in enumerate(mesh.devices)),
        spec, mesh, dim,
    )


def _shard(tree: Any, mesh: Mesh, spec: Any) -> Any:
    if isinstance(spec, P):
        return _shard_leaf(tree, mesh, spec)
    if isinstance(spec, dict):
        return {k: _shard(tree[k], mesh, spec[k]) for k in spec}
    if dataclasses.is_dataclass(spec):
        return dataclasses.replace(tree, **{
            f.name: _shard(getattr(tree, f.name), mesh, getattr(spec, f.name))
            for f in dataclasses.fields(spec)})
    raise TypeError(f"no spec for a {type(tree).__name__} leaf: {spec!r}")


def shard_pytree(tree: Any, mesh: Mesh, spec_tree: Any) -> Any:
    """Place a parameter dict by per-leaf specs (the spec tree's shape:
    nested dicts, and dataclasses such as ``QuantTensor`` whose fields
    carry their own specs, as ``quant.quantize_specs`` builds them)."""
    require_expert_only(mesh, "shard_pytree")
    return _shard(tree, mesh, spec_tree)


def named_sharding(mesh: Mesh, *logical_axes, rules=None):
    raise NotImplementedError(
        "named_sharding: GSPMD placements are not ported (A12 in "
        "ROADMAP.md); use shard_pytree"
    )


def batch_sharding(mesh: Mesh):
    raise NotImplementedError(
        "batch_sharding: a batch split over data/fsdp is not ported (A12 in "
        "ROADMAP.md)"
    )
