"""Named residuals for the remat policies: the port's counterpart of
``jax.ad_checkpoint.checkpoint_name`` and
``jax.checkpoint_policies.save_only_these_names``.

A named policy (``llama.REMAT_POLICIES``) wraps each layer in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` with
selective activation checkpointing: :func:`save_only_these_names` gives
the ``context_fn`` whose policy keeps the outputs of the ops that carry
the policy's names (``MUST_SAVE``) and recomputes every other op
(``PREFER_RECOMPUTE``). A policy sees only ops that go through the
dispatcher, so each named site is one ``torch.library`` op with a
registered backward (:data:`SITES`): in the recompute a saved site hands
back its outputs and runs nothing, neither its products nor a kernel
launch (so no launch is counted). A ``ctypes`` launch inside an
``autograd.Function`` would be invisible to the policy, and caching the
``torch.empty`` it writes into would let the recompute's launch
overwrite the saved tensor: the flash kernels therefore sit behind the
``flash_out`` op (``ops/attention.py``), the dispatch plan behind the
``moe_routing`` op (``ops/moe_dispatch.py``).

Each site runs its plain PyTorch body on CPU and CUDA tensors alike (no
other device): these are the products and elementwise ops the reference
leaves to XLA; the flash site launches its kernels on CUDA tensors.

What the recompute still runs. Eager PyTorch has no dead-code
elimination: a saved tensor does not stop the ops upstream of it from
running again, unless the site op spans them, and the recompute replays
the block's forward up to the last tensor the backward needs
(``torch.utils.checkpoint``'s early stop ends it there, so the block's
last product is not replayed). Per name:

- ``flash_out`` (:func:`~..ops.attention.flash_site`): out and lse. K4
  runs once per layer and step. Without ``flash_qkv`` the recompute still
  runs the attention RMSNorm, the QKV product and rope (the backward
  needs q, k, v), as XLA does.
- ``flash_qkv`` (:func:`qkv_site`): q, k, v as the flash kernels read
  them (contiguous, after rope). The site spans the QKV product and rope,
  so neither is recomputed; the attention RMSNorm still is (the site's
  backward needs its output), as under XLA.
- ``attn_o`` (:func:`attn_proj_site`): the output projection's result.
  The recompute skips the ``wo`` product and still adds the residual.
- ``mlp_prod`` (:func:`swiglu_site`): ``silu(gate) * up`` in the model
  dtype. The recompute still runs the MLP RMSNorm and the gate/up product
  (the SwiGLU backward needs it), as XLA does; it skips the elementwise
  SwiGLU only.
- ``moe_routing`` (``ops.moe_dispatch.plan_site`` and
  :func:`slots_site`): the dispatch plan's index tensors, binned's
  ``slot_pair``. The recompute still runs the router (its product,
  softmax and top-k), as XLA does, and skips the sort and the scatters.
  The port's primitive dropless path reads the same plan, so this name
  also covers the reference's ``order`` / ``inv``.
- ``moe_gu`` (:func:`expert_gateup_site`): the einsum and binned bodies'
  gate/up product ``[E, rows, 2, M]``, which then runs once.
- ``moe_act``: the fused pipeline's activations, saved inside
  ``FusedMoeMlpFunction`` (an ``autograd.Function`` the policy does not
  see). No policy names it, as in the reference: K7 and K8 run again in
  the recompute.

Under ``"full"`` (plain checkpointing, no policy) every op, K4 and K7/K8
included, runs twice per layer and step.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    create_selective_checkpoint_contexts,
)

from ..ops.rotary import apply_rope

#: The ops (``torch.library`` names) that carry each residual name. A
#: policy that saves a name keeps these ops' outputs.
SITES: dict[str, tuple[str, ...]] = {
    "flash_out": ("tpu_dra::flash_attention",),
    "flash_qkv": ("tpu_dra::project_qkv",),
    "attn_o": ("tpu_dra::attn_proj",),
    "mlp_prod": ("tpu_dra::swiglu",),
    "moe_routing": ("tpu_dra::moe_plan", "tpu_dra::binned_slots"),
    "moe_gu": ("tpu_dra::expert_gateup",),
    "moe_act": (),
}

_DEVICES = ("cpu", "cuda")


def save_only_these_names(*names: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` that saves the
    outputs of the sites carrying ``names`` and recomputes everything
    else."""
    unknown = [n for n in names if n not in SITES]
    if unknown:
        raise ValueError(f"unknown residual names {unknown}; valid: "
                         f"{sorted(SITES)}")
    saved = frozenset(op for n in names for op in SITES[n])

    def policy(ctx, op, *args, **kwargs):
        if op.name() in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


# ---------------------------------------------------------------------------
# flash_qkv: the QKV product and rope.
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpu_dra::project_qkv", mutates_args=(),
                         device_types=_DEVICES)
def qkv_site(xn: torch.Tensor, wqkv: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``llama.project_qkv`` for float weights at positions 0..T-1: xn [B,
    T, H] against wqkv [H, KV, G+2, D], then rope. Returns contiguous q
    [B, KV*G, T, D], k and v [B, KV, T, D], as the flash kernels read
    them."""
    b, t, h = xn.shape
    _, kv, g2, d = wqkv.shape
    g = g2 - 2
    qkv = (xn @ wqkv.reshape(h, -1)).reshape(b, t, kv, g2, d)
    q = qkv[..., :g, :].reshape(b, t, kv * g, d)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(qkv[..., g, :].transpose(1, 2), cos, sin)
    v = qkv[..., g + 1, :].transpose(1, 2)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _qkv_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _qkv_backward(ctx, dq, dk, dv):
    xn, wqkv, cos, sin = ctx.saved_tensors
    b, t, h = xn.shape
    _, kv, g2, d = wqkv.shape
    # Rope is a rotation: its transpose is the rotation by -angle.
    dq = apply_rope(dq, cos, -sin).transpose(1, 2)
    dk = apply_rope(dk, cos, -sin).transpose(1, 2)
    dqkv = torch.cat([dq.reshape(b, t, kv, g2 - 2, d), dk[:, :, :, None],
                      dv.transpose(1, 2)[:, :, :, None]], dim=3)
    dqkv = dqkv.reshape(b * t, -1)
    w2 = wqkv.reshape(h, -1)
    dxn = (dqkv @ w2.T).reshape(b, t, h)
    dw = (xn.reshape(b * t, h).T @ dqkv).reshape(wqkv.shape)
    return dxn, dw, None, None


qkv_site.register_autograd(_qkv_backward, setup_context=_qkv_setup)


# ---------------------------------------------------------------------------
# attn_o: the output projection.
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpu_dra::attn_proj", mutates_args=(),
                         device_types=_DEVICES)
def attn_proj_site(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The attention output o [B, Hq, T, D] against wo [Hq*D, H]: [B, T,
    H], before the residual."""
    b, _, t, _ = o.shape
    return o.transpose(1, 2).reshape(b, t, -1) @ wo


def _proj_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _proj_backward(ctx, dy):
    o, wo = ctx.saved_tensors
    b, hq, t, d = o.shape
    dy2 = dy.reshape(b * t, -1)
    do = (dy2 @ wo.T).reshape(b, t, hq, d).transpose(1, 2)
    dwo = o.transpose(1, 2).reshape(b * t, -1).T @ dy2
    return do, dwo


attn_proj_site.register_autograd(_proj_backward, setup_context=_proj_setup)


# ---------------------------------------------------------------------------
# mlp_prod: the dense MLP's SwiGLU.
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpu_dra::swiglu", mutates_args=(),
                         device_types=_DEVICES)
def swiglu_site(gu: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` of gu [..., 2, M] (index 0 gate) in f32,
    rounded to gu's dtype (the model dtype)."""
    gate = F.silu(gu[..., 0, :].float())
    return (gate * gu[..., 1, :].float()).to(gu.dtype)


def _swiglu_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _swiglu_backward(ctx, dprod):
    # autograd's arithmetic on the plain expression, bit for bit, in
    # fewer passes: f32 gradients written into gu's halves in its dtype.
    (gu,) = ctx.saved_tensors
    gate = gu[..., 0, :].float()
    d = dprod.float()
    dgu = torch.empty_like(gu)
    dgu[..., 0, :] = torch.ops.aten.silu_backward(d * gu[..., 1, :], gate)
    dgu[..., 1, :] = d * F.silu(gate)
    return dgu


swiglu_site.register_autograd(_swiglu_backward, setup_context=_swiglu_setup)


# ---------------------------------------------------------------------------
# moe_gu: the einsum and binned bodies' gate/up product.
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpu_dra::expert_gateup", mutates_args=(),
                         device_types=_DEVICES)
def expert_gateup_site(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each expert's rows against its gate/up weights: xe [E, R, H], w
    [E, H, 2, M] -> [E, R, 2, M] (one batched product)."""
    e, r, h = xe.shape
    return torch.bmm(xe, w.reshape(e, h, -1)).reshape(e, r, *w.shape[2:])


def _gateup_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _gateup_backward(ctx, dgu):
    xe, w = ctx.saved_tensors
    e, r, h = xe.shape
    w2 = w.reshape(e, h, -1)
    dgu = dgu.reshape(e, r, -1)
    dxe = torch.bmm(dgu, w2.transpose(1, 2))
    dw = torch.bmm(xe.transpose(1, 2), dgu).reshape(w.shape)
    return dxe, dw


expert_gateup_site.register_autograd(_gateup_backward,
                                     setup_context=_gateup_setup)


# ---------------------------------------------------------------------------
# moe_routing (binned): the slot -> pair map.
# ---------------------------------------------------------------------------


@torch.library.custom_op("tpu_dra::binned_slots", mutates_args=(),
                         device_types=_DEVICES)
def slots_site(pair_slot: torch.Tensor, nslots: int) -> torch.Tensor:
    """binned's ``slot_pair`` [nslots] int32: the pair each capacity slot
    holds, from each pair's slot ``pair_slot`` [P] (``nslots`` = dropped).
    Slots no pair holds read P. One int scatter, as the reference's
    ``.at[...].set(mode="drop")``: the dropped pairs land in an extra row
    that is cut off."""
    n_pairs = pair_slot.shape[0]
    dev = pair_slot.device
    out = torch.full((nslots + 1,), n_pairs, dtype=torch.long, device=dev)
    out[pair_slot.long()] = torch.arange(n_pairs, device=dev)
    return out[:nslots].to(torch.int32)
