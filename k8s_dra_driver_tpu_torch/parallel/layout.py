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
  (:meth:`Layout.expert_shards`). Beside ``tensor`` each expert shard's
  experts run per tensor shard on their M block (:meth:`Layout.experts`,
  gathered over fsdp where the stack is cut there), the partial outputs
  summed on the expert shard's first tensor shard; attention and the
  other replicated work run on expert shard 0's tensor shards (their
  weights are replicated over ``expert``).
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
"""

from __future__ import annotations

import torch

from .mesh import Mesh
from .sharding import Sharded, gathered_of, shard_of


class Layout:
    """The batch groups, sequence shards, tensor shards and expert shards
    of ``mesh``."""

    def __init__(self, mesh: Mesh, what: str = "a mesh forward"):
        s = mesh.shape
        self.what = what
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

    def expert_shards(self, g: int, t: int = 0, j: int = 0) -> list:
        """Group ``g``'s expert shards at tensor shard ``t`` (sequence
        shard ``j``), their mesh indices in ring order."""
        return [self.shard(g, t, e, j) for e in range(self.ep)]

    def experts(self, w, g: int, e: int, t: int = 0):
        """Expert shard ``e``'s block of one layer's expert stack ``w``
        [E, ...] for group ``g``'s tensor shard ``t``: its shard of a
        :class:`Sharded` stack (a ``QuantTensor``'s fields alike),
        gathered over fsdp where the stack is cut there, on the shard's
        device. The stack must be placed on this mesh (``shard_pytree`` by
        ``moe.param_specs``; the model forwards place whole leaves)."""
        s = getattr(w, "q", w)
        if not isinstance(s, Sharded) or s.mesh is not self.mesh \
                or not s.splits or s.splits[0][:2] != (0, ("expert",)):
            raise ValueError(f"{self.what}: expert stack {s!r:.80} is not "
                             f"cut by this mesh's expert axis")
        return self.weight(w, g, t, e=e)

    def weight(self, w, g: int, t: int = 0, j: int = 0, e: int = 0):
        """The block of ``w`` that group ``g``'s tensor shard ``t`` (of
        sequence shard ``j``, expert shard ``e``) computes with: its
        shard, gathered over fsdp where ``w`` is cut there; a replicated
        tensor moved to the shard's device."""
        i = self.shard(g, t, e, j)
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
