"""Elastic resize coordinator: reshape the mesh, reshard the live state.
Counterpart of ``k8s_dra_driver_tpu/parallel/elastic.py``.

The workload half of the gang-resize story (the plugin half is
``plugin/driver.py``'s elastic coordinator). When chip health shrinks a
gang claim -- or a restored spare grows it back -- the driver emits a
typed ``GangResize`` message; this module consumes the surviving gang and
keeps training alive:

1. pick the **largest valid sub-mesh** of the survivors (the model's
   tensor/sequence/expert/pipe degrees are preserved --
   ``MeshConfig.resize`` -- and the global batch must still divide the
   data axes; the remainder is idled, not used);
2. **reshard the live TrainState** onto the new mesh
   (``train.reshard_train_state``: no checkpoint round trip on the hot
   path). The cold fallback -- ``models/checkpoint.restore_template`` +
   restore -- runs ONLY when the survivors cannot cover the state (some
   block of a leaf lived on lost members alone);
3. rebuild the train step for the new mesh and resume -- the step
   counter and optimizer state carry over, so the loss trajectory
   continues where it left off.

**Members, not devices.** The reference tells a gang's devices apart by
identity (distinct jax devices). On the port's single-controller mesh
several shards may share a ``torch.device`` (every shard of a one-card
mesh is ``cuda:0``, of a CPU test mesh ``cpu``), so a device cannot say
which member survived. The gang is keyed by **members**: hashable
handles, in practice the claim's device names (``tpu-<i>``, as
``GangResize.devices`` gives them), each mapped to its ``torch.device``
(:func:`default_device`: ``cuda:<i>``; a mapping may be passed instead,
so that several members share one card). The mesh is
built over the used members' devices, shard ``i`` being member ``i``.

Fault sites: ``train.step`` fires at the top of every train step and
``train.reshard`` at the top of every resize, so the chaos harness can
land a chip-unplug (or a crash) exactly mid-step / mid-reshard the same
way it does for ``kube.*``/``chiplib.*`` sites.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import time
from typing import Any, Mapping, Optional, Sequence

import torch

from ..utils import faults
from ..utils.metrics import Counter, Gauge, Histogram, Registry
from .sharding import Sharded

logger = logging.getLogger(__name__)

RESHARD_LIVE = "live"
RESHARD_COLD = "cold"

class ElasticResizeError(RuntimeError):
    """A resize that cannot proceed: no valid sub-mesh exists for the
    surviving devices, or the cold fallback has no checkpoint to restore
    from. Training state is left untouched — the caller may retry with a
    different device set (or after saving a checkpoint)."""


def largest_usable_count(
    n_available: int, config, global_batch: Optional[int] = None
) -> int:
    """Largest device count ``<= n_available`` that yields a valid mesh.

    Valid means: the preserved model degrees (``config.model_degrees``)
    divide it, and — when ``global_batch`` is given — the resulting
    data x fsdp product still divides the batch (the train step shards
    batches over ``("data", "fsdp")``; a dp degree that does not divide
    the batch cannot run). Returns 0 when no count works.
    """
    fixed = config.model_degrees
    n = (n_available // fixed) * fixed
    while n >= fixed:
        dp = n // fixed
        if global_batch is None or global_batch % dp == 0:
            return n
        n -= fixed
    return 0


_MEMBER_INDEX = re.compile(r"\d+")


def default_device(member) -> torch.device:
    """The card of a gang member: ``cuda:<i>`` for member ``i`` or the
    claim device name ``tpu-<i>`` (the first number in the name:
    ``tpu-3`` -> ``cuda:3``)."""
    if isinstance(member, int):
        return torch.device("cuda", member)
    match = _MEMBER_INDEX.search(str(member))
    if match is None:
        raise ValueError(f"no device index in gang member {member!r}; "
                         f"pass device_of= to map members to devices")
    return torch.device("cuda", int(match.group(0)))


def state_covered(state: Any, available, members: Optional[Sequence] = None
                  ) -> bool:
    """Can the ``available`` members reconstruct every block of
    ``state`` (a ``TrainState`` placed on a mesh)?

    ``members[i]`` is the member of the mesh's shard ``i`` (default: the
    mesh's devices themselves, the reference's identities). For each
    leaf's ``NamedSharding``, the shards are grouped by the block of the
    leaf they hold: every block must have a shard on an available member.
    Data-parallel replication makes shrink coverable (the surviving
    replica holds a full copy); a pure-fsdp layout is NOT covered when
    any of its members is lost — that is exactly the cold-restore case.

    The port's train state physically stays whole on the mesh's first
    device, so the state is also uncovered where no available member's
    device holds its tensors -- which only happens when the members lie
    on several cards.
    """
    from ..models.train import leaves, state_shardings

    if not state.shardings:
        raise ValueError("state_covered: the state has no placement on a "
                         "mesh (init_train_state(..., mesh=))")
    mesh = leaves(state.shardings)[0].mesh
    # Every leaf's placement: the params' specs, the rest replicated.
    placed = state_shardings(state, mesh)
    shardings = (leaves(placed.params) + leaves(placed.opt_state.mu)
                 + leaves(placed.opt_state.nu)
                 + [placed.opt_state.count, placed.step])
    members = list(mesh.devices if members is None else members)
    if len(members) != mesh.size:
        raise ValueError(f"{len(members)} members for the {mesh.size} "
                         f"shards of {mesh}")
    avail = set(available)
    alive = {i for i, m in enumerate(members) if m in avail}
    for sharding in shardings:
        probe = Sharded((), sharding.spec, mesh)
        blocks: dict[tuple, bool] = {}
        for i in range(mesh.size):
            key = probe.block(i)
            blocks[key] = blocks.get(key, False) or i in alive
        if not all(blocks.values()):
            return False
    holders = {mesh.devices[i] for i in alive}
    tensors = (leaves(state.params) + leaves(state.opt_state.mu)
               + leaves(state.opt_state.nu))
    return all(t.device in holders for t in tensors)


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """Workload-side record of one completed resize (the resize trace)."""

    direction: str                 # "shrink" | "grow" | "reshape"
    path: str                      # "live" | "cold"
    reason: str
    step: int                      # TrainState.step AFTER the resize
    old_mesh: str                  # str(MeshConfig) before
    new_mesh: str                  # str(MeshConfig) after
    n_old: int
    n_used: int
    n_idled: int
    duration_seconds: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ElasticTrainer:
    """Owns the mesh, the TrainState, and the train step — and survives
    the gang changing underneath them.

    ``members`` is the gang's initial member list (the claim's device
    names, or any hashable handles), ``device_of`` maps every member the
    gang may hold to its device (default :func:`default_device`);
    ``resize()`` takes the post-resize member
    list (survivors, or survivors + spares) in allocation order.
    ``global_batch`` pins the batch geometry so a resize never lands on a
    mesh the batch cannot shard over.
    """

    def __init__(
        self,
        config,
        optimizer,
        members: Sequence,
        *,
        mesh_config=None,
        global_batch: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        use_ring: bool = False,
        remat: bool = True,
        seed: int = 0,
        registry: Optional[Registry] = None,
        device_of: Optional[Mapping] = None,
    ):
        from ..models.train import init_train_state, make_train_step
        from .mesh import auto_mesh_config, build_mesh

        self.config = config
        self.optimizer = optimizer
        self.use_ring = use_ring
        self.remat = remat
        self.global_batch = global_batch
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.device_of = dict(device_of) if device_of is not None else None
        self.members = list(members)
        self.idled: list = []
        self.mesh_config = mesh_config or auto_mesh_config(len(self.members))
        if self.mesh_config.num_devices != len(self.members):
            raise ValueError(
                f"mesh {self.mesh_config} needs "
                f"{self.mesh_config.num_devices} devices, got "
                f"{len(self.members)}"
            )
        self.mesh = build_mesh(self.mesh_config,
                               [self._device(m) for m in self.members])
        self.state = init_train_state(
            config, optimizer, seed=seed, mesh=self.mesh
        )
        self._step_fn = make_train_step(
            config, optimizer, mesh=self.mesh, use_ring=use_ring,
            remat=remat
        )
        self.resize_trace: list[ResizeEvent] = []

        reg = registry if registry is not None else Registry()
        self._m_reshards = Counter(
            "tpu_dra_elastic_reshards_total",
            "Live-state reshards by direction, path (live/cold) and "
            "outcome",
            reg,
        )
        self._m_reshard_seconds = Histogram(
            "tpu_dra_elastic_reshard_seconds",
            "End-to-end resize latency: sub-mesh choice, state reshard, "
            "and train-step rebuild",
            reg,
        )
        self._m_devices = Gauge(
            "tpu_dra_elastic_devices",
            "Devices in the current elastic gang by role (used/idled)",
            reg,
        )
        self._set_device_gauges()

    def _device(self, member) -> torch.device:
        if self.device_of is None:
            return default_device(member)
        return torch.device(self.device_of[member])

    @property
    def devices(self) -> list:
        """The used members' devices in shard order (several may be
        one), as the mesh holds them (``cuda`` as ``cuda:<current>``)."""
        return list(self.mesh.devices)

    def _set_device_gauges(self) -> None:
        self._m_devices.set(len(self.members), role="used")
        self._m_devices.set(len(self.idled), role="idled")

    # -- training ----------------------------------------------------------

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    def step(self, tokens) -> float:
        """One train step; returns the loss. Instrumented as the
        ``train.step`` fault site so chaos schedules can unplug a chip
        (or crash) exactly mid-training."""
        faults.fire("train.step")
        self.state, loss = self._step_fn(self.state, tokens)
        if (
            self.checkpoint_every
            and self.checkpoint_dir
            and self.step_count % self.checkpoint_every == 0
        ):
            self.save()
        return float(loss)

    def save(self) -> None:
        if not self.checkpoint_dir:
            raise ElasticResizeError(
                "no checkpoint_dir configured; cannot save"
            )
        from ..models.checkpoint import save_checkpoint

        save_checkpoint(self.checkpoint_dir, self.state,
                        step=self.step_count)

    # -- resize ------------------------------------------------------------

    def relocate(self, members: Sequence, *, reason: str = ""
                 ) -> ResizeEvent:
        """Defrag-migration resize: move the gang onto ``members``
        WITHOUT shrinking the mesh. A relocation trades placement for
        placement — the defrag executor promises loss continuity, so a
        destination that would silently idle part of the mesh (or force
        a smaller sub-mesh) is refused up front with
        :class:`ElasticResizeError` instead of degrading training.
        Otherwise delegates to :meth:`resize` with the old members
        marked still-alive — a migration is a planned move, not a
        failure, so the live state reshards onto the destination (never
        a checkpoint restore) and the step/loss continuity guarantees
        apply unchanged."""
        usable = largest_usable_count(
            len(members), self.mesh_config, self.global_batch
        )
        if usable < len(self.members):
            raise ElasticResizeError(
                f"relocation target of {len(members)} device(s) cannot "
                f"host the current {len(self.members)}-device mesh "
                f"(largest valid sub-mesh: {usable}) — a defrag move "
                "must not shrink the gang"
            )
        return self.resize(members, reason=reason or "defrag relocation",
                           sources_alive=True)

    def resize(self, members: Sequence, *, reason: str = "",
               sources_alive: bool = False) -> ResizeEvent:
        """Reshape the mesh onto ``members`` and reshard the live state.

        ``members`` is the post-resize gang (survivors first is not
        required — members already in the old mesh are preferred for the
        sub-mesh so transfers stay local). Members beyond the largest
        valid sub-mesh are idled, not dropped: they remain in the gang
        and re-enter the mesh on the next grow.

        ``sources_alive`` (the :meth:`relocate` path) declares that
        members LEAVING the gang still hold readable memory — a planned
        migration, not a chip loss — so the live state reshards from
        them instead of falling back to a checkpoint restore.
        """
        t0 = time.monotonic()
        faults.fire("train.reshard")
        from ..models.train import make_train_step, reshard_train_state
        from .mesh import build_mesh

        members = list(members)
        old_members = list(self.members)
        old_config = self.mesh_config
        n_old = len(old_members)
        usable = largest_usable_count(
            len(members), old_config, self.global_batch
        )
        if usable == 0:
            self._m_reshards.inc(
                direction="unknown", path="none", outcome="no-valid-mesh"
            )
            raise ElasticResizeError(
                f"no valid sub-mesh for {len(members)} device(s): the "
                f"preserved degrees of {old_config} need multiples of "
                f"{old_config.model_degrees}"
                + (
                    f" that divide global batch {self.global_batch}"
                    if self.global_batch else ""
                )
            )
        # Prefer members the old mesh already used (their shards are in
        # place), then spares — stable within each class so the driver's
        # allocation order is respected.
        old_set = set(old_members)
        ordered = (
            [m for m in members if m in old_set]
            + [m for m in members if m not in old_set]
        )
        used, idled = ordered[:usable], ordered[usable:]
        new_config = old_config.resize(usable)
        new_mesh = build_mesh(new_config, [self._device(m) for m in used])
        direction = (
            "grow" if len(members) > n_old
            else "shrink" if len(members) < n_old
            else "reshape"
        )

        # Sources readable for a live reshard: old-mesh members that are
        # still part of the gang. A member absent from ``members``
        # vanished with its memory — its blocks only survive as replicas
        # — UNLESS the caller vouches the sources are alive (a planned
        # relocation reads every old block).
        available = old_set if sources_alive else old_set & set(members)
        path = RESHARD_LIVE
        new_state = None
        if state_covered(self.state, available, old_members):
            try:
                new_state = reshard_train_state(self.state, new_mesh)
            except Exception:
                logger.exception(
                    "live reshard failed; falling back to checkpoint "
                    "restore"
                )
                path = RESHARD_COLD
        else:
            logger.warning(
                "surviving members cannot cover the live state "
                "(unreplicated blocks on lost members); cold-restoring "
                "from checkpoint"
            )
            path = RESHARD_COLD
        if new_state is None:
            try:
                new_state = self._cold_restore(new_mesh)
            except Exception:
                # ANY restore failure counts (MeshShapeMismatchError,
                # I/O errors, ...) — dashboards alerting on error
                # outcomes must see exactly these.
                self._m_reshards.inc(
                    direction=direction, path=RESHARD_COLD,
                    outcome="error",
                )
                raise
        self._step_fn = make_train_step(
            self.config, self.optimizer, mesh=new_mesh,
            use_ring=self.use_ring, remat=self.remat,
        )
        self.state = new_state
        self.mesh = new_mesh
        self.mesh_config = new_config
        self.members = used
        self.idled = idled
        self._set_device_gauges()

        event = ResizeEvent(
            direction=direction,
            path=path,
            reason=reason,
            step=self.step_count,
            old_mesh=str(old_config),
            new_mesh=str(new_config),
            n_old=n_old,
            n_used=len(used),
            n_idled=len(idled),
            duration_seconds=time.monotonic() - t0,
        )
        self.resize_trace.append(event)
        self._m_reshards.inc(
            direction=direction, path=path, outcome="ok"
        )
        self._m_reshard_seconds.observe(event.duration_seconds)
        logger.info(
            "elastic resize (%s, %s): %s -> %s on %d device(s) "
            "(%d idled) at step %d in %.3fs — %s",
            direction, path, event.old_mesh, event.new_mesh,
            event.n_used, event.n_idled, event.step,
            event.duration_seconds, reason or "no reason given",
        )
        return event

    def _cold_restore(self, new_mesh):
        """The fallback when live blocks are unrecoverable: restore the
        latest checkpoint onto the new mesh. Loses the steps since the
        last save — which is why it is never taken while a live reshard
        can work."""
        if not self.checkpoint_dir:
            raise ElasticResizeError(
                "surviving devices cannot cover the live state and no "
                "checkpoint_dir is configured — training state is lost"
            )
        from ..models.checkpoint import (
            latest_step,
            restore_checkpoint,
            restore_template,
        )

        if latest_step(self.checkpoint_dir) is None:
            raise ElasticResizeError(
                "surviving devices cannot cover the live state and no "
                f"checkpoint exists under {self.checkpoint_dir}"
            )
        template = restore_template(self.state, new_mesh)
        return restore_checkpoint(self.checkpoint_dir, template)
