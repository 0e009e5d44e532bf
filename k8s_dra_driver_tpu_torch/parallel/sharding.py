"""Sharding rules and sharded values on a single-controller mesh.
Counterpart of ``k8s_dra_driver_tpu/parallel/sharding.py``.

The reference annotates arrays with logical axes, maps them to mesh axes
in one table (:data:`DEFAULT_RULES`, :func:`spec_for`) and lets XLA place
them (``shard_pytree`` is a ``device_put`` per leaf). The port keeps the
table and the specs (:class:`P`, a tuple like ``PartitionSpec``, and
:class:`NamedSharding`, a mesh with a spec) and places a leaf itself:

- a leaf whose spec names a mesh axis larger than 1 becomes a
  :class:`Sharded`: one block per shard of the mesh, in shard order, cut
  along every dimension whose spec entry names such an axis (a tuple
  entry such as ``("data", "fsdp")`` cuts one dimension over the product
  of its axes, the first name major) and the same block on the shards
  that differ only in the axes the spec does not name. A block is a view
  of the leaf where its shard's device is the leaf's, and a copy onto
  the shard's device only where it differs; on one card the sharded
  weights therefore take no more memory than the whole ones;
- a replicated leaf (``P()``, or axes of size 1) stays one tensor on the
  mesh's first device, the controller: the port runs replicated work once
  per group of shards that shares it, and a body that needs it on
  another shard's device moves it there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .mesh import Mesh

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


def _names(entry) -> tuple:
    """The mesh axes a spec entry names (None names none)."""
    names = entry if isinstance(entry, tuple) else (entry,)
    return tuple(n for n in names if n is not None)


def _axis_size(mesh: Mesh, entry) -> int:
    size = 1
    for name in _names(entry):
        size *= mesh.shape[name]
    return size


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The port's twin of ``jax.sharding.NamedSharding``: where a value is
    placed, a mesh and a spec. :func:`shard_pytree` places by it."""

    mesh: Mesh
    spec: P


class Sharded:
    """A value cut into one block per shard of ``mesh`` by ``spec``
    (``shards[i]`` on ``mesh.devices[i]``): along every dimension whose
    spec entry names axes larger than 1 (:attr:`splits`), the same block
    on shards that differ only in other axes. Indexing a leading
    unsplit dimension (``w[i]``, ``w.unbind(0)``) indexes every shard, so
    the layer loops slice sharded and whole stacks alike; ``shape`` is the
    whole value's."""

    __slots__ = ("shards", "spec", "mesh")

    def __init__(self, shards, spec: P, mesh: Mesh):
        self.shards = tuple(shards)
        self.spec = spec
        self.mesh = mesh

    @property
    def splits(self) -> list:
        """``(dim, axes, n)`` of every cut dimension: the axes larger
        than 1 its entry names, and the blocks it is cut into."""
        out = []
        for dim, entry in enumerate(self.spec):
            axes = tuple(a for a in _names(entry) if self.mesh.shape[a] > 1)
            if axes:
                out.append((dim, axes, _axis_size(self.mesh, axes)))
        return out

    def block(self, i: int) -> tuple:
        """Shard ``i``'s block index along each cut dimension."""
        c = self.mesh.coords(i)
        out = []
        for _, axes, _ in self.splits:
            b = 0
            for a in axes:
                b = b * self.mesh.shape[a] + c[a]
            out.append(b)
        return tuple(out)

    @property
    def shape(self) -> torch.Size:
        shape = list(self.shards[0].shape)
        for dim, _, n in self.splits:
            shape[dim] *= n
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        """Bytes of every block once (replicas on one device are one)."""
        seen = {}
        for s in self.shards:
            seen[(s.data_ptr(), str(s.device), tuple(s.shape))] = (
                s.numel() * s.element_size())
        return sum(seen.values())

    def __getitem__(self, i: int) -> "Sharded":
        if self.spec and _axis_size(self.mesh, self.spec[0]) > 1:
            raise IndexError("cannot index the sharded dimension of a "
                             "Sharded value")
        return Sharded(tuple(s[i] for s in self.shards), P(*self.spec[1:]),
                       self.mesh)

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a Sharded value unbinds only its leading axis")
        return [self[i] for i in range(self.shape[0])]

    def gathered(self, i: int, axis: str) -> torch.Tensor:
        """Shard ``i``'s block with ``axis`` gathered: the tiled
        all-gather, the blocks of the shards that differ from ``i`` only
        in ``axis`` concatenated in shard order along the dimension whose
        entry names it, on shard ``i``'s device (shard ``i``'s block
        itself where the spec does not cut along ``axis``)."""
        for dim, axes, _ in self.splits:
            if axis in axes:
                if axes != (axis,):
                    raise NotImplementedError(
                        f"gathering {axis!r} out of the entry {axes} of "
                        f"{self.spec}")
                c = self.mesh.coords(i)
                dev = self.mesh.devices[i]
                parts = [self.shards[self.mesh.index(**{**c, axis: j})]
                         for j in range(self.mesh.shape[axis])]
                return torch.cat([p.to(dev) for p in parts], dim=dim)
        return self.shards[i]

    def gather(self, device=None) -> torch.Tensor:
        """The whole value on ``device`` (default the first shard's)."""
        device = self.device if device is None else torch.device(device)
        splits = self.splits
        whole = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for i, s in enumerate(self.shards):
            b = self.block(i)
            if b in done:
                continue
            done.add(b)
            view = whole
            for (dim, _, _), j in zip(splits, b):
                step = s.shape[dim]
                view = view.narrow(dim, j * step, step)
            view.copy_(s)
        return whole

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"{len(self.shards)} shards)")


def shard_of(x, mesh: Mesh, i: int):
    """Shard ``i``'s block of ``x``: its shard of a :class:`Sharded`
    value, or the whole (replicated) tensor moved to the shard's device.
    A ``QuantTensor``-like dataclass takes each field's."""
    if isinstance(x, Sharded):
        return x.shards[i]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: shard_of(getattr(x, f.name), mesh, i)
            for f in dataclasses.fields(x)})
    return x.to(mesh.devices[i])


def gathered_of(x, mesh: Mesh, i: int, axis: str):
    """:meth:`Sharded.gathered` of ``x`` at shard ``i`` over ``axis``, for
    whole tensors (moved to the shard's device) and ``QuantTensor``-like
    dataclasses (each field) too."""
    if isinstance(x, Sharded):
        return x.gathered(i, axis)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: gathered_of(getattr(x, f.name), mesh, i, axis)
            for f in dataclasses.fields(x)})
    return x.to(mesh.devices[i])


def _shard_leaf(x: torch.Tensor, mesh: Mesh, spec: P):
    if not isinstance(x, torch.Tensor):
        raise TypeError(
            f"spec {spec} for a {type(x).__name__} leaf: the spec tree must "
            f"match the parameter tree (quant.quantize_specs for int8 "
            f"weights)"
        )
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{tuple(x.shape)} leaf has dimensions")
    probe = Sharded((), spec, mesh)
    splits = probe.splits
    if not splits:
        return x.to(mesh.devices[0])
    for dim, _, n in splits:
        if x.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of a {tuple(x.shape)} leaf does not divide "
                f"over {n} shards (spec {spec})"
            )
    blocks = {}
    shards = []
    for i, dev in enumerate(mesh.devices):
        b = probe.block(i)
        key = (b, str(dev))
        if key not in blocks:
            view = x
            for (dim, _, n), j in zip(splits, b):
                step = x.shape[dim] // n
                view = view.narrow(dim, j * step, step)
            blocks[key] = view.to(dev)
        shards.append(blocks[key])
    return Sharded(shards, spec, mesh)


def _shard(tree: Any, mesh: Mesh, spec: Any) -> Any:
    if isinstance(tree, Sharded):
        return tree
    if isinstance(spec, NamedSharding):
        return _shard_leaf(tree, spec.mesh, spec.spec)
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
    """Place a parameter dict (or one tensor) by per-leaf specs or
    :class:`NamedSharding` leaves (the spec tree's shape: nested dicts,
    and dataclasses such as ``QuantTensor`` whose fields carry their own
    specs, as ``quant.quantize_specs`` builds them). Sharded leaves made
    from tensors that require grad are views under autograd: a loss over
    them reaches the whole leaves."""
    return _shard(tree, mesh, spec_tree)


def named_sharding(mesh: Mesh, *logical_axes, rules=None) -> NamedSharding:
    return NamedSharding(mesh, spec_for(*logical_axes, rules=rules))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Input batch: split over (data, fsdp) -- every shard group sees
    distinct rows."""
    return named_sharding(mesh, "batch", "seq")
