"""The device mesh of a single-controller program. Counterpart of
``k8s_dra_driver_tpu/parallel/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` and runs one program over all
of its shards (``shard_map``). The port keeps that single-controller
shape: a :class:`Mesh` is a grid of ``torch.device`` entries with the
reference's named axes, and the expert-parallel bodies
(``models/moe.py``) loop over its shards in one process, each shard's
work on that shard's device. ``torch.distributed`` ranks are not used:
NCCL takes one rank per card, and a mesh of several shards on one card
(what the tests and the card's smoke run build) is then still one
program, as the reference's virtual-device meshes are.

Axis convention (outer -> inner), the reference's:
``("data", "fsdp", "pipe", "expert", "sequence", "tensor")``.

Every axis may be larger than 1. A shard is named by its coordinates
(:meth:`Mesh.coords`, :meth:`Mesh.index`), :meth:`Mesh.groups` lists
the shards that share every coordinate but some axes: the shards a
collective over those axes joins (``parallel/collectives.py``), and
:meth:`Mesh.sub` is the mesh of the shards at one coordinate of an axis
(a pipeline stage's shards, ``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Optional, Sequence

import torch

AXES = ("data", "fsdp", "pipe", "expert", "sequence", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical parallelism degrees. Product must equal the device count."""

    data: int = 1
    fsdp: int = 1
    pipe: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1

    @property
    def shape(self) -> tuple[int, int, int, int, int, int]:
        return (self.data, self.fsdp, self.pipe, self.expert,
                self.sequence, self.tensor)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    def __str__(self) -> str:
        return "x".join(
            f"{a}={d}" for a, d in zip(AXES, self.shape) if d > 1
        ) or "single"

    @property
    def model_degrees(self) -> int:
        """Product of the degrees fixed by the model, not the fleet
        (tensor/sequence/expert/pipe); only data x fsdp can absorb a
        change of the device count."""
        return self.pipe * self.expert * self.sequence * self.tensor

    def resize(self, n_devices: int) -> "MeshConfig":
        """This config refactored for ``n_devices``: the model degrees
        carry over, data x fsdp collapses to one degree (fsdp where the
        source shards parameters, else data). Raises ``ValueError`` when
        ``n_devices`` cannot hold the model degrees."""
        fixed = self.model_degrees
        if n_devices <= 0:
            raise ValueError(f"cannot resize mesh to {n_devices} devices")
        if n_devices % fixed:
            raise ValueError(
                f"{n_devices} devices cannot hold the preserved degrees "
                f"of {self} (pipe*expert*sequence*tensor={fixed}); "
                f"use a multiple of {fixed}"
            )
        rest = n_devices // fixed
        if self.fsdp > 1:
            return dataclasses.replace(self, data=1, fsdp=rest)
        return dataclasses.replace(self, data=rest, fsdp=1)


def auto_mesh_config(
    n_devices: int,
    *,
    model_needs_tensor: int = 1,
    long_context: bool = False,
) -> MeshConfig:
    """Default factorization for ``n_devices``: the model's tensor degree,
    then sequence if long-context, the rest on fsdp."""
    if n_devices < 1:
        raise ValueError(f"need at least one device, got {n_devices}")
    if model_needs_tensor < 1:
        raise ValueError(
            f"tensor degree must be >= 1, got {model_needs_tensor}"
        )
    if model_needs_tensor > n_devices:
        raise ValueError(
            f"model needs tensor={model_needs_tensor} but only "
            f"{n_devices} device(s) are available; allocate at least "
            f"{model_needs_tensor} devices or lower the tensor degree"
        )
    if n_devices % model_needs_tensor:
        raise ValueError(
            f"{n_devices} devices not divisible by tensor={model_needs_tensor}"
        )
    rest = n_devices // model_needs_tensor
    sequence = 1
    if long_context and rest % 2 == 0:
        sequence = min(rest, 4)
        while rest % sequence:
            sequence //= 2
        rest //= sequence
    return MeshConfig(
        data=1, fsdp=rest, sequence=sequence, tensor=model_needs_tensor
    )


def _device(d) -> torch.device:
    """``d`` as a device with its index: a bare ``cuda`` is the current
    card, so that shards compare equal by device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Named axes over a grid of ``torch.device`` entries, one per shard,
    in row-major order of ``AXES``. ``shape`` maps each axis to its size
    (the reference's ``mesh.shape.get("expert", 1)`` idiom). Several
    shards may name one device."""

    def __init__(self, devices: Sequence[torch.device], config: MeshConfig):
        if len(devices) != config.num_devices:
            raise ValueError(
                f"mesh {config} needs {config.num_devices} devices, "
                f"have {len(devices)}"
            )
        self.devices = tuple(_device(d) for d in devices)
        self.config = config
        self.shape = dict(zip(AXES, config.shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, i: int) -> dict:
        """Shard ``i``'s coordinate on every axis."""
        out = {}
        for axis in reversed(AXES):
            i, out[axis] = divmod(i, self.shape[axis])
        return {a: out[a] for a in AXES}

    def index(self, **coords) -> int:
        """The shard at ``coords`` (axes left out are 0)."""
        i = 0
        for axis in AXES:
            c = coords.get(axis, 0)
            if not 0 <= c < self.shape[axis]:
                raise IndexError(f"{axis}={c} on a mesh of {self.config}")
            i = i * self.shape[axis] + c
        return i

    def groups(self, axes) -> list:
        """The shards that share every coordinate but ``axes`` (a name or
        a tuple of names), one list per group in shard order, each listed
        in row-major order of ``axes``: the members of one collective over
        ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        rest = [a for a in AXES if a not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            base = dict(zip(rest, fixed))
            out.append([self.index(**base, **dict(zip(axes, c)))
                        for c in itertools.product(
                            *(range(self.shape[a]) for a in axes))])
        return out

    def sub(self, axis: str, index: int) -> "Mesh":
        """The mesh of the shards whose ``axis`` coordinate is ``index``,
        that axis of size 1 in it, the others as they are."""
        if not 0 <= index < self.shape[axis]:
            raise IndexError(f"{axis}={index} on a mesh of {self.config}")
        config = dataclasses.replace(self.config, **{axis: 1})
        return Mesh([d for i, d in enumerate(self.devices)
                     if self.coords(i)[axis] == index], config)

    def __repr__(self) -> str:
        return f"Mesh({self.config}, devices={list(map(str, self.devices))})"


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def build_mesh(
    config: Optional[MeshConfig] = None,
    devices: Optional[list] = None,
) -> Mesh:
    """A :class:`Mesh` over ``devices``, default the visible CUDA devices,
    one shard each. A config larger than the visible cards raises: several
    shards on one device are built only from an explicit list (``[cuda:0]
    * 4`` on one card, ``[cpu] * 4`` in the tests), never silently."""
    explicit = devices is not None
    devices = list(devices) if explicit else _visible_devices()
    if config is None:
        config = auto_mesh_config(len(devices))
    if config.num_devices != len(devices):
        hint = "" if explicit else (
            "; pass devices= explicitly to place several shards on one "
            "device"
        )
        raise ValueError(
            f"mesh {config} needs {config.num_devices} devices, "
            f"have {len(devices)}{hint}"
        )
    return Mesh(devices, config)


def mesh_from_env(config: Optional[MeshConfig] = None) -> Mesh:
    """The mesh inside a DRA-prepared container: over the CUDA devices the
    driver's injected ``CUDA_VISIBLE_DEVICES`` leaves visible, one shard
    each (:func:`build_mesh`)."""
    return build_mesh(config)


def host_mesh_shape() -> tuple[int, ...]:
    """Physical bounds of this host's chips from the driver-injected
    ``TPU_CHIPS_PER_HOST_BOUNDS`` (``"2,2,1"``); without it, the count of
    visible CUDA devices."""
    bounds = os.environ.get("TPU_CHIPS_PER_HOST_BOUNDS", "")
    if not bounds:
        return (len(_visible_devices()),)
    return tuple(int(x) for x in bounds.split(","))
