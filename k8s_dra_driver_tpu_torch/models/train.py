"""Training: the optimizer, the train state and the train step. Counterpart
of ``k8s_dra_driver_tpu/models/train.py`` on one device, or for an MoE
model on an expert-only single-controller mesh.

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
moments), ``llama``'s otherwise. On a ``mesh`` (an ``MoeConfig`` only,
the ``expert`` axis only) the step is expert parallel: the state stays
whole, and the MoE blocks take each shard's experts as a view of the
whole stack (``moe._local_experts``), so the gradients reach the whole
leaves that the update writes in place.
Not ported yet: the other mesh axes, ``state_shardings`` and
``reshard_train_state`` (A12c in ROADMAP.md) and ring attention
(``use_ring``, A12d).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math

import torch

from .. import resolve_device
from ..parallel.mesh import require_expert_only
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


def _model_fns(config: LlamaConfig):
    """(init_params, loss_fn) for the config's model family -- MoeConfig
    subclasses LlamaConfig, so the sparse check comes first."""
    from . import llama, moe

    mod = moe if isinstance(config, moe.MoeConfig) else llama
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


def train_state_from_params(params: dict, optimizer: AdamW) -> TrainState:
    """A fresh train state over existing parameters, which it marks
    trainable -- e.g. ones converted from the reference with
    ``params_from_numpy`` (the optimizer state is not converted: both
    packages start it fresh from the same parameters)."""
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)


def init_train_state(config: LlamaConfig, optimizer: AdamW, seed: int = 0,
                     device=None) -> TrainState:
    """Random parameters from ``seed`` on ``device`` (default CUDA) and a
    fresh optimizer state."""
    params = _model_fns(config)[0](config, seed=seed, device=device)
    return train_state_from_params(params, optimizer)


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
                    remat: bool = True, device=None, mesh=None):
    """The train step ``(state, tokens [B, S+1]) -> (state, loss)`` on
    ``device`` (default CUDA). It updates ``state`` in place and returns
    it, with the loss as a 0-dim f32 tensor. With ``mesh`` (an expert-only
    mesh, an ``MoeConfig``) the MoE blocks run expert parallel."""
    dev = resolve_device(device)
    if mesh is None:
        loss_fn = _model_fns(config)[1]
    else:
        from . import moe

        if not isinstance(config, moe.MoeConfig):
            raise NotImplementedError(
                "make_train_step(mesh=...) for a dense model: its tensor "
                "and fsdp placements are not ported (A12c in ROADMAP.md)")
        require_expert_only(mesh, "make_train_step")
        loss_fn = functools.partial(moe.loss_fn, mesh=mesh)

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


def make_eval_step(config: LlamaConfig, device=None):
    """``(params, tokens [B, S+1]) -> loss`` without gradients or remat."""
    dev = resolve_device(device)
    loss_fn = _model_fns(config)[1]

    @torch.no_grad()
    def step(params: dict, tokens: torch.Tensor):
        _check_device(params, dev)
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        return loss_fn(params, tokens, config, remat=False)

    return step
