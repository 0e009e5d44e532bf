"""Training: the optimizer, the train state and the train step. Counterpart
of ``k8s_dra_driver_tpu/models/train.py`` on one device or on a
single-controller mesh.

The reference jits one program per (batch, seq) with the state donated;
here the step runs eagerly and updates the state IN PLACE -- parameters
and optimizer moments are overwritten, and the step returns the same
``TrainState`` object -- which is what donation buys the reference:
memory for one copy of the state, not two.

:func:`make_optimizer` computes what the reference's optax chain computes
(``clip_by_global_norm`` then ``adamw`` under a warmup-cosine schedule):
the learning rate is read at the update count before it is incremented
(so the first update has lr 0 when the warmup starts at 0), eps sits
outside the square root, weight decay reaches every leaf, and both
moments keep the parameters' dtype. The clip divides by the plain global
norm (no epsilon added, unlike ``torch.nn.utils.clip_grad_norm_``).

Both model families train: :func:`_model_fns` picks ``moe``'s parameters
and loss for an ``MoeConfig`` (whose router stays f32, and so do its
moments), ``llama``'s otherwise. On a ``mesh`` (``parallel/mesh.py``:
data, fsdp, tensor, sequence and, for an MoE model, expert) the state's
leaves stay whole on the mesh's first device, and its placement is a
tree of ``NamedSharding`` twins (``TrainState.shardings``, by the model's
``param_specs``; the optimizer's moments replicated, as the reference's
jitted optax init leaves them). The loss cuts each shard's blocks as
views of the whole leaves (``llama.place``), so the gradients reach the
leaves that the update writes in place: the data and fsdp groups'
gradients add up in them, the reduce-scatter of a sharded step. On a
``sequence`` axis the step takes ``use_ring`` (ring attention over the
sequence shards, the reference's ``make_train_step(use_ring=True)``).
:func:`reshard_train_state` re-anchors a state to another mesh, its
``train.reshard`` ledger record the reference's.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math

import torch

from .. import resolve_device
from ..parallel import collectives
from ..parallel.layout import Layout, check_heads
from ..parallel.sharding import NamedSharding, P
from .llama import LlamaConfig

__all__ = [
    "AdamW",
    "AdamWState",
    "TrainState",
    "TRACE_COUNTS",
    "TRACE_OBSERVERS",
    "make_optimizer",
    "make_train_step",
    "make_eval_step",
    "init_train_state",
    "state_shardings",
    "reshard_train_state",
    "train_state_from_params",
    "leaves",
]

#: First use of each (batch, seq) train-step shape, keyed like the
#: reference's trace counter (``train_step:b<B>:s<S>``). PyTorch builds no
#: program per shape, so a key is counted once, the first time that shape
#: runs.
TRACE_COUNTS: "collections.Counter[str]" = collections.Counter()

#: Observers called with ("train_step", "", {"batch": B, "seq": S}) where
#: ``TRACE_COUNTS`` first counts a key. Empty by default.
TRACE_OBSERVERS: list = []

#: optax's adam epsilon, added outside the square root.
ADAM_EPS = 1e-8

#: Elements per f32 slice of the optimizer update: bounds its temporaries
#: (a few of 256 MB) whatever the size of a leaf.
_UPDATE_SLICE = 1 << 26


def _model(config: LlamaConfig):
    """The config's model module -- MoeConfig subclasses LlamaConfig, so
    the sparse check comes first."""
    from . import llama, moe

    return moe if isinstance(config, moe.MoeConfig) else llama


def _model_fns(config: LlamaConfig):
    """(init_params, loss_fn) for the config's model family."""
    mod = _model(config)
    return mod.init_params, mod.loss_fn


def leaves(tree: dict) -> list[torch.Tensor]:
    """The tensors of a parameter (or moment) dict, depth first in
    insertion order -- the same order for every dict of one structure."""
    out = []
    for value in tree.values():
        out.extend(leaves(value) if isinstance(value, dict) else [value])
    return out


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@dataclasses.dataclass
class AdamWState:
    """optax's adam state: the update count and both moments."""
    count: int
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Global-norm clipping then AdamW under a warmup-cosine schedule."""
    lr: float
    weight_decay: float
    b1: float
    b2: float
    grad_clip: float
    warmup_steps: int
    total_steps: int

    def schedule(self, count: int) -> float:
        """optax ``warmup_cosine_decay_schedule(0, lr, warmup, total,
        end_value=lr / 10)`` at update ``count``."""
        if count < self.warmup_steps:
            return self.lr * count / self.warmup_steps
        decay = self.total_steps - self.warmup_steps
        t = min(count - self.warmup_steps, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        alpha = 0.1
        return self.lr * ((1.0 - alpha) * cosine + alpha)

    def init(self, params: dict) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)
        return AdamWState(count=0, mu=_map(zeros, params),
                          nu=_map(zeros, params))

    @torch.no_grad()
    def update_(self, params: list, grads: list,
                state: AdamWState) -> None:
        """One update of ``params`` (in place) from ``grads``; moments and
        count advance in ``state``. The clip factor stays on the device,
        so the update needs no host sync."""
        sq = [g.float().pow(2).sum() for g in grads]
        norm = torch.stack(sq).sum().sqrt()
        clip = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                           self.grad_clip / norm)
        lr = self.schedule(state.count)
        n = state.count + 1
        bc1 = 1.0 - self.b1 ** n
        bc2 = 1.0 - self.b2 ** n
        for p, g, m, v in zip(params, grads, leaves(state.mu),
                              leaves(state.nu)):
            pf, gf, mf, vf = (x.view(-1) for x in (p, g, m, v))
            for a in range(0, pf.numel(), _UPDATE_SLICE):
                sl = slice(a, a + _UPDATE_SLICE)
                g32 = gf[sl].float() * clip
                m32 = mf[sl].float().mul_(self.b1).add_(g32,
                                                        alpha=1 - self.b1)
                v32 = vf[sl].float().mul_(self.b2).addcmul_(
                    g32, g32, value=1 - self.b2)
                mf[sl].copy_(m32)
                vf[sl].copy_(v32)
                p32 = pf[sl].float()
                step = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(ADAM_EPS))
                step.add_(p32, alpha=self.weight_decay)
                pf[sl].copy_(p32.sub_(step, alpha=lr))
        state.count = n


def make_optimizer(
    lr: float = 3e-4,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
    warmup_steps: int = 100,
    total_steps: int = 10000,
) -> AdamW:
    if total_steps <= warmup_steps:
        raise ValueError(
            f"total_steps ({total_steps}) must exceed warmup_steps "
            f"({warmup_steps}): the cosine decay needs positive steps"
        )
    return AdamW(lr=lr, weight_decay=weight_decay, b1=b1, b2=b2,
                 grad_clip=grad_clip, warmup_steps=warmup_steps,
                 total_steps=total_steps)


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: AdamWState
    step: int
    #: The params' placement on a mesh (a tree of ``NamedSharding`` like
    #: ``params``), or None on one device. Not saved in a checkpoint: a
    #: restore keeps its template's.
    shardings: dict | None = dataclasses.field(
        default=None, metadata={"checkpoint": False})


def _check_mesh(config: LlamaConfig, mesh, what: str) -> None:
    Layout(mesh, what)
    check_heads(config, mesh)


def train_state_from_params(params: dict, optimizer: AdamW,
                            mesh=None) -> TrainState:
    """A fresh train state over existing parameters, which it marks
    trainable -- e.g. ones converted from the reference with
    ``params_from_numpy`` (the optimizer state is not converted: both
    packages start it fresh from the same parameters). With ``mesh`` the
    state is placed there by the model's ``param_specs``; the parameters
    of a dense model (a dict without a router) take ``llama``'s."""
    for p in leaves(params):
        p.requires_grad_(True)
    shardings = None
    if mesh is not None:
        from . import llama, moe

        specs = (moe if "wr" in params["layers"] else llama).param_specs
        shardings = _named(specs(None), mesh)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0, shardings=shardings)


def _named(specs: dict, mesh) -> dict:
    return {k: _named(v, mesh) if isinstance(v, dict)
            else NamedSharding(mesh, v) for k, v in specs.items()}


def init_train_state(config: LlamaConfig, optimizer: AdamW, seed: int = 0,
                     device=None, mesh=None) -> TrainState:
    """Random parameters from ``seed`` on ``device`` (default CUDA; the
    mesh's first device with ``mesh``) and a fresh optimizer state, the
    state placed on ``mesh`` by the model's ``param_specs`` (the tensor
    degree must divide ``n_kv_heads``)."""
    if mesh is not None:
        _check_mesh(config, mesh, "init_train_state")
        if device is None:
            device = mesh.devices[0]
    params = _model_fns(config)[0](config, seed=seed, device=device)
    state = train_state_from_params(params, optimizer)
    if mesh is not None:
        state.shardings = _named(_model(config).param_specs(config), mesh)
    return state


def state_shardings(state: TrainState, mesh) -> TrainState:
    """Per-leaf target ``NamedSharding`` twins for ``state`` on ``mesh``,
    shaped like the state: each leaf keeps its spec (``state.shardings``)
    re-anchored to ``mesh``; everything else -- the optimizer's moments,
    its update count, the step -- replicated, as the reference's live
    arrays are."""
    rep = NamedSharding(mesh, P())

    def anchor(tree, placed):
        return {k: anchor(v, placed.get(k) if placed else None)
                if isinstance(v, dict)
                else NamedSharding(mesh, placed[k].spec if placed else P())
                for k, v in tree.items()}

    return TrainState(
        params=anchor(state.params, state.shardings),
        opt_state=AdamWState(count=rep,
                             mu=anchor(state.opt_state.mu, None),
                             nu=anchor(state.opt_state.nu, None)),
        step=rep)


#: Bytes of the reference's train state beyond its params and moments:
#: adam's update count, the schedule's and the step, int32 scalars.
_SCALAR_STATE_BYTES = 3 * 4


def reshard_train_state(state: TrainState, mesh) -> TrainState:
    """The live reshard of ``state`` onto ``mesh``: the leaves move to
    the new mesh's first device (the same tensors where it is the old
    one's: values bit for bit, no checkpoint round trip, no optimizer
    re-initialization) and the placement re-anchors to ``mesh``
    (:func:`state_shardings`). With a collective ledger installed it
    records ``train.reshard`` (DCN) with the reference's worst-case
    volume: every leaf moves in full."""
    if collectives._LEDGERS:
        nbytes = sum(int(x.nbytes) for x in (
            leaves(state.params) + leaves(state.opt_state.mu)
            + leaves(state.opt_state.nu)))
        collectives.emit("train.reshard", collectives.MEDIUM_DCN,
                         nbytes + _SCALAR_STATE_BYTES)
    dev = mesh.devices[0]
    target = state_shardings(state, mesh)

    def move(tree):
        return {k: move(v) if isinstance(v, dict)
                else v.detach().to(dev).requires_grad_(v.requires_grad)
                if v.device != dev else v for k, v in tree.items()}

    return TrainState(
        params=move(state.params),
        opt_state=AdamWState(count=state.opt_state.count,
                             mu=move(state.opt_state.mu),
                             nu=move(state.opt_state.nu)),
        step=state.step, shardings=target.params)


def _note_first_use(b: int, s: int) -> None:
    key = f"train_step:b{b}:s{s}"
    if key in TRACE_COUNTS:
        return
    TRACE_COUNTS[key] += 1
    for observer in TRACE_OBSERVERS:
        observer("train_step", "", {"batch": b, "seq": s})


def _check_device(params: dict, dev: torch.device) -> None:
    have = params["embed"].device
    if have.type != dev.type:
        raise ValueError(f"params live on {have}, not on {dev}")


def make_train_step(config: LlamaConfig, optimizer: AdamW,
                    remat: bool = True, device=None, mesh=None,
                    use_ring: bool = False):
    """The train step ``(state, tokens [B, S+1]) -> (state, loss)`` on
    ``device`` (default CUDA; the mesh's first device with ``mesh``). It
    updates ``state`` in place and returns it, with the loss as a 0-dim
    f32 tensor. With ``mesh`` the loss runs on the mesh (batch rows over
    data x fsdp, token blocks over sequence, Megatron tensor parallelism,
    expert parallel MoE blocks on an expert axis; ``use_ring`` for ring
    attention over sequence) on views of the whole leaves."""
    if device is None and mesh is not None:
        device = mesh.devices[0]
    dev = resolve_device(device)
    loss_fn = _model_fns(config)[1]
    if mesh is not None:
        _check_mesh(config, mesh, "make_train_step")
        loss_fn = functools.partial(loss_fn, mesh=mesh, use_ring=use_ring)

    def step(state: TrainState, tokens: torch.Tensor):
        _check_device(state.params, dev)
        tokens = torch.as_tensor(tokens, device=state.params["embed"].device)
        b, s = tokens.shape
        _note_first_use(b, s)
        params = leaves(state.params)
        loss = loss_fn(state.params, tokens, config, remat=remat)
        grads = torch.autograd.grad(loss, params)
        optimizer.update_(params, grads, state.opt_state)
        state.step += 1
        return state, loss.detach()

    return step


def make_eval_step(config: LlamaConfig, device=None, mesh=None,
                   use_ring: bool = False):
    """``(params, tokens [B, S+1]) -> loss`` without gradients or remat
    (on ``mesh`` as :func:`make_train_step`)."""
    if device is None and mesh is not None:
        device = mesh.devices[0]
    dev = resolve_device(device)
    loss_fn = _model_fns(config)[1]
    if mesh is not None:
        _check_mesh(config, mesh, "make_eval_step")
        loss_fn = functools.partial(loss_fn, mesh=mesh, use_ring=use_ring)

    @torch.no_grad()
    def step(params: dict, tokens: torch.Tensor):
        _check_device(params, dev)
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return loss_fn(params, tokens, config, remat=False)

    return step
