"""The explicit placement of a forward on a single-controller mesh: which
shard runs which rows with which block of each weight. The reference gets
these placements from GSPMD; the port computes them here.

- **Batch groups.** The batch rows split over ``("data", "fsdp")``
  (``sharding.DEFAULT_RULES["batch"]``): group ``g`` of ``data * fsdp``
  holds rows ``[g * B / dp, (g + 1) * B / dp)``, on the shards whose data
  and fsdp coordinates are ``divmod(g, fsdp)``. A group's replicated work
  (norms, residual adds, routing) runs once, on its first tensor shard's
  device (:meth:`Layout.home`).
- **Tensor shards.** Within a group, tensor shard ``t`` computes with the
  ``t``-th block of every tensor-cut weight (Megatron: column-parallel
  products then row-parallel ones, their partial sums added by a psum).
- **fsdp.** A weight cut over ``fsdp`` is gathered before use, per layer
  and shard (:meth:`Layout.weight`): the blocks of the shards that differ
  only in their fsdp coordinate, concatenated in shard order.
- **Experts.** On a mesh with an ``expert`` axis each group runs the
  expert-parallel bodies of ``models/moe.py`` over its expert shards
  (:meth:`Layout.expert_shards`).
- **Sequence shards.** On a ``sequence`` axis of ``n`` a group's rows cut
  into ``n`` token blocks: block ``(g, j)`` holds positions ``[j S / n,
  (j + 1) S / n)`` of the group's rows (:meth:`Layout.blocks`), and its
  replicated work runs on its first tensor shard's device
  (:meth:`Layout.home` with ``j``). Attention joins a group's blocks
  (ring attention, ``parallel/ring.py``, or a gather over ``sequence``);
  the rest of a layer runs block by block.
- **Pipe.** A forward that is not pipelined runs on the shards at pipe
  coordinate 0 (the replicas along ``pipe`` would compute the same
  thing); ``parallel/pipeline.py`` gives each stage a Layout of its own
  sub-mesh (``Mesh.sub``).

An ``expert`` axis beside ``tensor`` or ``fsdp`` raises (A12c's
remainder in ROADMAP.md).
"""

from __future__ import annotations

import torch

from .mesh import Mesh
from .sharding import gathered_of, shard_of


class Layout:
    """The batch groups, sequence shards, tensor shards and expert shards
    of ``mesh``."""

    def __init__(self, mesh: Mesh, what: str = "a mesh forward"):
        s = mesh.shape
        if s["expert"] > 1 and (s["tensor"] > 1 or s["fsdp"] > 1):
            raise NotImplementedError(
                f"{what}: an expert axis beside tensor or fsdp "
                f"({mesh.config}) is not ported (A12c in ROADMAP.md); the "
                f"expert axis composes with data")
        self.mesh = mesh
        self.fsdp = s["fsdp"]
        self.dp = s["data"] * s["fsdp"]
        self.tp = s["tensor"]
        self.ep = s["expert"]
        self.sp = s["sequence"]
        self._index = {
            (g, t, e, j): mesh.index(data=g // self.fsdp, fsdp=g % self.fsdp,
                                     expert=e, sequence=j, tensor=t)
            for g in range(self.dp) for t in range(self.tp)
            for e in range(self.ep) for j in range(self.sp)}

    def shard(self, g: int, t: int = 0, e: int = 0, j: int = 0) -> int:
        """The mesh index of group ``g``'s tensor shard ``t`` (expert
        shard ``e``, sequence shard ``j``)."""
        return self._index[g, t, e, j]

    def device(self, g: int, t: int = 0, e: int = 0,
               j: int = 0) -> torch.device:
        return self.mesh.devices[self.shard(g, t, e, j)]

    def home(self, g: int, j: int = 0) -> torch.device:
        """Where token block ``(g, j)``'s replicated work runs."""
        return self.device(g, j=j)

    def expert_shards(self, g: int) -> list:
        """Group ``g``'s expert shards, their mesh indices in ring order."""
        return [self.shard(g, e=e) for e in range(self.ep)]

    def weight(self, w, g: int, t: int = 0, j: int = 0):
        """The block of ``w`` that group ``g``'s tensor shard ``t`` (of
        sequence shard ``j``) computes with: its shard, gathered over fsdp
        where ``w`` is cut there; a replicated tensor moved to the shard's
        device."""
        i = self.shard(g, t, j=j)
        if self.fsdp > 1:
            return gathered_of(w, self.mesh, i, "fsdp")
        return shard_of(w, self.mesh, i)

    def rows(self, b: int) -> int:
        """Rows a group holds of a batch of ``b``."""
        if b % self.dp:
            raise ValueError(
                f"a batch of {b} rows does not split over data x fsdp = "
                f"{self.dp} groups ({self.mesh.config})")
        return b // self.dp

    def blocks(self, x: torch.Tensor) -> list:
        """``x`` [B, S, ...] cut into token blocks: per group the list of
        its ``sp`` sequence blocks, each on its home device."""
        n = self.rows(x.shape[0])
        if x.shape[1] % self.sp:
            raise ValueError(
                f"a sequence of {x.shape[1]} positions does not split over "
                f"sequence = {self.sp} shards ({self.mesh.config})")
        m = x.shape[1] // self.sp
        return [[x[g * n:(g + 1) * n, j * m:(j + 1) * m].to(self.home(g, j))
                 for j in range(self.sp)] for g in range(self.dp)]


def check_heads(config, mesh: Mesh) -> None:
    """The fused ``wqkv`` cuts its kv-head axis over ``tensor``: the
    tensor degree must divide ``n_kv_heads`` (the reference's message)."""
    tensor = mesh.shape.get("tensor", 1)
    if tensor > 1 and config.n_kv_heads % tensor != 0:
        raise ValueError(
            f"tensor parallel degree {tensor} must divide n_kv_heads "
            f"({config.n_kv_heads}); use tensor <= n_kv_heads"
        )
