"""Mixtral-style sparse Mixture-of-Experts on the Llama trunk: serving and
training. Counterpart of ``k8s_dra_driver_tpu/models/moe.py``.

An MoE model differs from the dense trunk only in its MLP block: a router
(``wr``, kept in f32) picks ``top_k`` of ``n_experts`` per token, and the
chosen experts' SwiGLU MLPs are summed with the renormalised router gates.
The reference's three formulations are ported, sharing one router
(:func:`_topk_masks`):

- **dropless** -- token-sort into the dispatch plan, then the fused
  dispatch kernels (``ops/moe_dispatch.py``: K7 gathers the rows inside
  the gate/up product, K8 scatters the gate-weighted down product to each
  pair's slot; their backward runs the grouped kernels K10), or, on the
  primitive path, gathers around grouped matmuls (K10 both ways). No
  capacity, nothing drops.
- **einsum** -- GShard capacity routing with one-hot dispatch/combine
  einsums (plain PyTorch, as the reference leaves them to XLA).
- **binned** -- the einsum path's routing and drops, addressed by the
  capacity cumsum: one int scatter builds the slot -> pair map, row
  gathers (:class:`_GatherRows`, whose backward is gathers too) move the
  tokens into ``[E, rows, H]`` and back, and the experts run as batched
  products.

``auto`` resolves per call by the reference's table
(:func:`resolve_moe_impl`; it never picks binned). :func:`forward` and
:func:`loss_fn` (next-token cross-entropy plus ``aux_coef`` times the
Switch load-balancing loss) are differentiable, with the dense trunk's
remat policies. Under a named policy the MoE block's sites are the
dispatch plan and binned's slot map (``moe_routing``) and the einsum and
binned gate/up product (``moe_gu``); the recompute still runs the
router, and in the fused dropless pipeline K7 and K8 (``moe_act`` is in
no policy), as the reference's does.

**On a mesh** (``forward(..., mesh=...)``, a mesh of ``parallel/mesh.py``,
weights whole or placed by ``shard_pytree(params, mesh,
param_specs(cfg))``) the layers run per batch group and tensor shard
(``llama.mesh_trunk``, ``parallel/layout.py``), each shard's work on its
shard's device, and each group's MoE block is :func:`moe_group`:

- on an **expert axis**, the expert-parallel bodies over the group's
  expert shards (the data axis composes with it: each data group runs
  its own):

  - dropless **ring** (:func:`_ep_ring_out`): tokens chunk over the
    expert ring; at each hop every shard routes its resident chunk and
    runs its local experts on it (``_pairs_mlp`` with its expert window,
    K7 and K8 on the card), and ``parallel/ring.py::ring_permute`` (K9's
    twin) rotates the chunks and the f32 carriers that collect each
    chunk's output. After ``n_ep`` carrier hops chunk i's output is home
    on shard i; concatenating in shard order is the all-gather.
    ``n_ep**2`` K7/K8 pairs and ``n_ep`` K9 launches a layer (each hop's
    chunk rides with its carrier: ``ring_permute_many``);
  - dropless **psum** (:func:`_ep_psum_out`): every shard runs its local
    pairs of the whole batch, and their sum is the psum. The fallback
    where the token count does not divide the ring (``ep_overlap=
    "auto"``), and the parity oracle;
  - **einsum**: each shard runs its experts' rows of the dispatched
    ``[E, ...]`` tensor with its weights; the results concatenate along
    E. binned refuses, as in the reference;
  - beside **tensor** (and fsdp) each expert shard's work runs per tensor
    shard on its M block of the shard's experts (gathered over fsdp where
    cut there), the partial outputs summed in f32 on the expert shard's
    first tensor shard (:func:`_expert_pairs`; einsum's ``_experts`` per
    block). The routing runs once per expert shard (on the ring: once
    per group, hop and expert shard), shared by its tensor shards, so the
    ring stays one ring of expert shards, ``n_ep`` K9 launches a layer.
    Dropless takes the primitive path there (K10a/b, A7b for int8
    stacks), as the reference does under GSPMD;

- **without one** (the reference's GSPMD case, ``moe.py:943-951``
  there), dropless takes the primitive path per tensor shard
  (:func:`_dropless_tp_out`: the routing once, then each shard's grouped
  products on its M block of every expert -- K10a for bf16 experts, A7b
  ``grouped_matmul_int8`` for int8 ones, the gate/up block a strided
  view -- and a psum over ``tensor``); einsum and binned run per tensor
  shard on its M block. The Switch aux combines the groups' statistics.

:func:`loss_fn` takes the mesh too, and its gradient runs back through
the same bodies (for EP: the grouped inverse rotation (K9) and each
shard's ``FusedMoeMlpFunction`` backward (K10a, K10b)). Each body
records the reference's collective sites and byte counts.

On a **sequence** axis (``use_ring`` for ring attention) each group's MoE
block runs on its whole sequence, gathered from the group's token blocks
and cut back after: the capacity groups and the aux's means are the
reference's global ones. :func:`forward_pipelined` runs the layers as a
GPipe pipeline over ``pipe`` (``parallel/pipeline.py``), the aux riding
as a per-row channel.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops import moe_dispatch
from ..ops.norms import rmsnorm, rmsnorm_reference
from ..ops.quant_matmul import int8_matmul, int8_matmul_reference
from ..ops.rotary import rope_frequencies
from ..parallel import collectives
from ..parallel.collectives import concat_parts, sum_parts
from ..parallel.layout import Layout
from ..parallel.mesh import Mesh
from ..parallel.ring import ring_permute, ring_permute_many
from ..parallel.sharding import P, Sharded
from .llama import (
    LlamaConfig,
    _attention_block,
    _remat_transform,
    chunked_cross_entropy,
    check_heads,
    mesh_attention,
    mesh_cross_entropy,
    mesh_gather,
    mesh_heads,
    mesh_logits,
    mesh_trunk,
    pipeline_stages,
)
from .quant import QuantTensor, q_lookup, q_matmul
from .remat import expert_gateup_site, slots_site


@dataclasses.dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    n_experts: int = 8
    top_k: int = 2
    # Per-expert token slots = capacity_factor * (top_k * S / E), the
    # GShard convention (einsum only); overflowing tokens drop that
    # expert.
    capacity_factor: float = 1.25
    # Tokens per routing group of the einsum path (0 = whole sequence).
    router_group: int = 128
    # "auto" | "einsum" | "binned" | "dropless".
    moe_impl: str = "auto"
    # Weight of the Switch load-balancing loss in ``loss_fn``.
    aux_coef: float = 0.01
    # Expert-parallel dropless dispatch on a mesh's "expert" axis:
    # "ring" (chunks rotate over the ring while each shard runs its local
    # experts; needs the token count to divide the axis), "psum" (every
    # shard runs its local pairs of the whole batch, one sum combines),
    # "auto" (ring where the token count divides the axis, else psum).
    ep_overlap: str = "auto"

    def num_params(self) -> int:
        h, m, v, l = self.hidden, self.mlp_hidden, self.vocab_size, self.n_layers
        kv = self.n_kv_heads * self.head_dim
        e = self.n_experts
        per_layer = (
            h * h + 2 * h * kv + h * h          # attention
            + h * e                              # router
            + e * 3 * h * m                      # experts (gate, up, down)
            + 2 * h
        )
        return v * h + l * per_layer + h + h * v

    def flops_per_token(self, seq: int | None = None) -> float:
        """Active-parameter FLOPs (top_k experts of E), fwd+bwd."""
        h, m, v, l = self.hidden, self.mlp_hidden, self.vocab_size, self.n_layers
        kv = self.n_kv_heads * self.head_dim
        active_per_layer = (
            h * h + 2 * h * kv + h * h
            + h * self.n_experts
            + self.top_k * 3 * h * m
            + 2 * h
        )
        n_active = v * h + l * active_per_layer + h + h * v
        attn = 12 * l * h * (seq or self.max_seq_len)
        return 6 * n_active + attn


MOE_PRESETS: dict[str, MoeConfig] = {
    # Hermetic-test size.
    "tiny-moe": MoeConfig(
        vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_hidden=128, max_seq_len=128, dtype=torch.float32,
        n_experts=4, top_k=2,
    ),
    "8x160m": MoeConfig(
        vocab_size=32000, hidden=768, n_layers=12, n_heads=12, n_kv_heads=12,
        mlp_hidden=2048, max_seq_len=2048, n_experts=8, top_k=2,
    ),
    # Mixtral-8x7B geometry.
    "8x7b": MoeConfig(
        vocab_size=32000, hidden=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        mlp_hidden=14336, max_seq_len=8192, rope_theta=1e6,
        n_experts=8, top_k=2,
    ),
    # Mixtral-8x7B per-layer shapes at one layer.
    "8x7b-L1": MoeConfig(
        vocab_size=32000, hidden=4096, n_layers=1, n_heads=32, n_kv_heads=8,
        mlp_hidden=14336, max_seq_len=8192, rope_theta=1e6,
        n_experts=8, top_k=2,
    ),
}


#: First use of each (impl, dispatch, token-count) key, keyed like the
#: reference's trace counter. PyTorch traces nothing, so a key is counted
#: once, the first time that shape runs (as ``decode.TRACE_COUNTS``).
MOE_TRACE_COUNTS: "collections.Counter[str]" = collections.Counter()

#: Observers called with ("moe_block", "<impl>:<dispatch>", shape dict)
#: where ``MOE_TRACE_COUNTS`` first counts a key. Empty by default.
TRACE_OBSERVERS: list = []

# `auto` selection thresholds, the reference's (measured there on a TPU
# v5e). They are kept as they are because einsum drops tokens that
# dropless keeps: parity with the reference needs the same policy.
_AUTO_DECODE_TOKENS = 512
_AUTO_SMALL_EXPERT_CELLS = 16 << 20


def resolve_moe_impl(
    config: MoeConfig,
    n_tokens: int,
    *,
    expert_mesh: bool = False,
    in_pipeline: bool = False,
) -> str:
    """The concrete MLP impl ``moe_impl="auto"`` runs for this call
    (explicit impls pass through): einsum in a pipeline or on an
    expert-sharded mesh, dropless for <= 512 routed tokens or small
    experts (h * m <= 16M cells), einsum for large experts."""
    c = config
    if c.moe_impl != "auto":
        return c.moe_impl
    if in_pipeline or expert_mesh:
        return "einsum"
    if n_tokens <= _AUTO_DECODE_TOKENS:
        return "dropless"
    if c.mlp_hidden * c.hidden <= _AUTO_SMALL_EXPERT_CELLS:
        return "dropless"
    return "einsum"


def init_params(config: MoeConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default CUDA): the dense trunk's layout with the MLP replaced by the
    router ``wr`` [L, H, E] (f32: top-k on bf16 logits is noisy) and the
    expert stacks ``w_gateup`` [L, E, H, 2, M] and ``w_down`` [L, E, M,
    H]. Stacked weights are drawn one (layer, expert) slice at a time, so
    the f32 draw never holds more than one slice."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, m, v, l, e = c.hidden, c.mlp_hidden, c.vocab_size, c.n_layers, c.n_experts
    hq = c.n_heads * c.head_dim
    g = c.n_heads // c.n_kv_heads

    def normal(*shape, fan_in, dtype=c.dtype, split=0):
        out = torch.empty(shape, dtype=dtype, device=dev)
        parts = [out]
        for _ in range(split):
            parts = [q for p in parts for q in p]
        for part in parts:
            part.copy_(
                torch.randn(part.shape, generator=gen, device=dev)
                / math.sqrt(fan_in)
            )
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=c.dtype, device=dev)

    return {
        "embed": normal(v, h, fan_in=h),
        "layers": {
            "wqkv": normal(l, h, c.n_kv_heads, g + 2, c.head_dim, fan_in=h,
                           split=1),
            "wo": normal(l, hq, h, fan_in=hq, split=1),
            "wr": normal(l, h, e, fan_in=h, dtype=torch.float32, split=1),
            "w_gateup": normal(l, e, h, 2, m, fan_in=h, split=2),
            "w_down": normal(l, e, m, h, fan_in=m, split=2),
            "ln_attn": ones(l, h),
            "ln_mlp": ones(l, h),
        },
        "final_norm": ones(h),
        "lm_head": normal(h, v, fan_in=h),
    }


def param_specs(config: MoeConfig) -> dict:
    """Partition specs: the dense trunk's tensor/fsdp axes plus the expert
    axis on every per-expert weight (the leading None is the layer axis),
    the reference's tree."""
    return {
        "embed": P("tensor", "fsdp"),
        "layers": {
            "wqkv": P(None, "fsdp", "tensor", None, None),
            "wo": P(None, "tensor", "fsdp"),
            "wr": P(None, None, None),
            "w_gateup": P(None, "expert", "fsdp", None, "tensor"),
            "w_down": P(None, "expert", "tensor", "fsdp"),
            "ln_attn": P(None, None),
            "ln_mlp": P(None, None),
        },
        "final_norm": P(None),
        "lm_head": P("fsdp", "tensor"),
    }


def effective_router_group(config: MoeConfig, seq: int) -> int:
    """The routing-group size used at ``seq``: the configured group,
    snapped down to the largest divisor of the sequence length; 0 or a
    group >= seq means the whole sequence."""
    g = config.router_group
    if g <= 0 or g >= seq:
        return seq
    if seq % g:
        g = next(c for c in range(g, 0, -1) if seq % c == 0)
    return g


def _capacity(config: MoeConfig, seq: int) -> int:
    c = config
    return max(1, int(c.capacity_factor * c.top_k * seq / c.n_experts))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: out-of-range indices give an all-zero row."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).to(dtype)


def _topk_masks(probs: torch.Tensor, config: MoeConfig):
    """Iterative-argmax top-k: per-choice one-hots + gates + Switch aux.
    Shared by every impl, so expert choice and tie-breaking (the first
    maximal index, as in JAX) are identical across them."""
    c = config
    e = c.n_experts
    masks, gates = [], []
    remaining = probs
    for _ in range(c.top_k):
        idx = torch.argmax(remaining, dim=-1)
        m = _one_hot(idx, e, probs.dtype)
        gates.append(torch.sum(remaining * m, dim=-1))
        masks.append(m)
        remaining = remaining * (1.0 - m)
    # Load-balancing aux (Switch eq. 4).
    token_axes = tuple(range(probs.dim() - 1))
    frac = masks[0].mean(dim=token_axes)
    mean_prob = probs.mean(dim=token_axes)
    aux = e * torch.sum(frac * mean_prob)
    return masks, gates, aux


def _route(probs: torch.Tensor, config: MoeConfig, cap: int):
    """Static-shape top-k routing with per-expert capacity. probs [B, S,
    E]; returns (dispatch [B,S,E,C] 0/1, combine [B,S,E,C] gate-weighted,
    aux). Choice k queues behind choices < k; tokens past capacity drop
    that expert only."""
    c = config
    e = c.n_experts
    masks, gates, aux = _topk_masks(probs, c)
    denom = sum(gates) + 1e-9
    dispatch = torch.zeros(probs.shape + (cap,), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    count = torch.zeros(probs.shape[:1] + (1, e), dtype=probs.dtype,
                        device=probs.device)
    for m, gate in zip(masks, gates):
        pos = torch.cumsum(m, dim=1) - m + count
        count = count + m.sum(dim=1, keepdim=True)
        keep = m * (pos < cap)
        poh = _one_hot(pos, cap, probs.dtype) * keep[..., None]
        dispatch = dispatch + poh
        combine = combine + poh * (gate / denom)[..., None, None]
    return dispatch, combine, aux


def _route_topk(xf: torch.Tensor, wr: torch.Tensor, config: MoeConfig):
    """Router + top-k for the sorted paths: (gates [T, k] f32
    renormalised, experts [T, k] int32, probs [T, E] f32, aux)."""
    logits = torch.einsum("th,he->te", xf.float(), wr.float())
    probs = torch.softmax(logits, dim=-1)
    masks, gate_l, aux = _topk_masks(probs, config)
    denom = sum(gate_l) + 1e-9
    gates = torch.stack(gate_l, dim=1) / denom[:, None]
    experts = torch.stack([torch.argmax(mk, dim=-1) for mk in masks],
                          dim=1).to(torch.int32)
    return gates, experts, probs, aux


def _pairs_mlp(
    xf: torch.Tensor,            # [T, H] tokens (unsorted)
    gates: torch.Tensor,         # [T, k] f32
    experts: torch.Tensor,       # [T, k] int32
    w_gu,                        # [E_loc, H, 2, M] tensor or QuantTensor
    w_down,                      # [E_loc, M, H] tensor or QuantTensor
    config: MoeConfig,
    *,
    lo: int = 0,
    e_loc: int | None = None,
    use_kernels: bool = True,
    under_mesh: bool = False,
) -> torch.Tensor:
    """Expert MLP over the (token, choice) pairs whose expert lies in
    [lo, lo + e_loc): per-token contributions [T, H] f32 (pairs outside
    the range contribute exact zeros).

    Two implementations over one dispatch plan: **fused** (K7 and K8, K10
    in their backward) and **primitive** (gathers around grouped matmuls,
    K10 both ways); ``use_kernels=False`` runs the plain versions on CUDA
    tensors. int8 ``QuantTensor`` stacks run forward only, through the
    kernels' int8 branches (fused) or the int8 grouped product
    (primitive). ``under_mesh`` (dropless on a mesh without an expert
    axis, or beside tensor or fsdp) takes the primitive path, as the
    reference does under GSPMD."""
    c = config
    t, k = gates.shape
    h = xf.shape[1]
    e_loc = c.n_experts if e_loc is None else e_loc
    m = w_down.shape[1]
    r = t * k

    flat_e = experts.reshape(r).long()
    local_pair = (flat_e >= lo) & (flat_e < lo + e_loc)
    # Local experts renumber to 0..e_loc-1; foreign pairs get the
    # sentinel e_loc, which the plan gives no slot.
    key = torch.where(local_pair, flat_e - lo,
                      torch.full_like(flat_e, e_loc))
    gates_flat = gates.reshape(r)
    plan = moe_dispatch.build_plan(key.to(torch.int32), t, e_loc, k)
    if moe_dispatch.use_fused(h=h, m=m, device=xf.device,
                              under_mesh=under_mesh):
        y_pairs = moe_dispatch.fused_moe_mlp(
            xf, w_gu, w_down, gates_flat, plan, use_kernels=use_kernels,
        )
    else:
        _, y_pairs = moe_dispatch._reference_parts(
            xf, w_gu, w_down, gates_flat, plan, use_kernels)
    return y_pairs.reshape(t, k, h).sum(dim=1)


def _norm(use_kernels: bool):
    return rmsnorm if use_kernels else rmsnorm_reference


def _dropless_out(x, layer, config: MoeConfig, use_kernels: bool = True):
    """Dropless sparse MLP on one device: top-k route, then the shared
    pair pipeline over all experts. Returns (out [B, S, H] f32, aux,
    probs)."""
    c = config
    b, s, h = x.shape
    xn = _norm(use_kernels)(x, layer["ln_mlp"], c.norm_eps)
    xf = xn.reshape(b * s, h)
    gates, experts, probs, aux = _route_topk(xf, layer["wr"], c)
    out = _pairs_mlp(
        xf, gates, experts, layer["w_gateup"], layer["w_down"], c,
        use_kernels=use_kernels,
    )
    return out.reshape(b, s, h), aux, probs


def _moe_block_dropless(x, layer, config: MoeConfig,
                        use_kernels: bool = True):
    """Dropless sparse MLP (:func:`_dropless_out`). Returns (x + out,
    aux)."""
    out, aux, _ = _dropless_out(x, layer, config, use_kernels)
    return x + out.to(x.dtype), aux


def _stats(probs: torch.Tensor, e: int) -> tuple:
    """The Switch aux's per-token statistics of one group's routing: the
    fraction of tokens whose first choice is each expert, and the mean
    router probability (``_topk_masks``'s ``frac`` and ``mean_prob``)."""
    p = probs.reshape(-1, e)
    return _one_hot(p.argmax(dim=-1), e, p.dtype).mean(0), p.mean(0)


def _aux_of(stats: list, e: int, device) -> torch.Tensor:
    """The Switch aux of the whole batch from its equal-sized groups'
    statistics: the groups' means averaged, then combined."""
    frac = torch.stack([f.to(device) for f, _ in stats]).mean(0)
    mean_prob = torch.stack([p.to(device) for _, p in stats]).mean(0)
    return e * torch.sum(frac * mean_prob)


def _expert_blocks(layer, config: MoeConfig, lay: Layout, g: int) -> list:
    """Group ``g``'s expert weights per expert shard ``e`` and tensor shard
    ``t``: ``blocks[e][t]`` = (gate/up [E_loc, H, 2, M / tensor], a strided
    view; down [E_loc, M / tensor, H]), gathered over fsdp where the stacks
    are cut there (:meth:`Layout.experts`; int8 stacks as ``QuantTensor``
    blocks). Without an expert axis, each tensor shard's M block of every
    expert (:meth:`Layout.weight`)."""
    if lay.ep > 1:
        _ep_geometry(config, lay)
        return [[tuple(lay.experts(layer[k], g, e, t)
                       for k in ("w_gateup", "w_down"))
                 for t in range(lay.tp)] for e in range(lay.ep)]
    return [[tuple(lay.weight(layer[k], g, t) for k in ("w_gateup", "w_down"))
             for t in range(lay.tp)]]


def _expert_pairs(xf, gates, experts, blocks: list, config: MoeConfig,
                  lay: Layout, g: int, e: int, use_kernels: bool = True):
    """Expert shard ``e``'s pairs of the routed tokens ``xf`` [T, H]
    (``gates`` and ``experts`` beside them): each tensor shard's
    ``_pairs_mlp`` on its block of the shard's experts (``blocks[t]``),
    and the partial outputs summed in f32 on ``xf``'s device -- the psum
    over ``tensor``, exact up to the f32 order since SwiGLU is elementwise
    over M. The fused pipeline runs only where expert (and data) are the
    mesh's only axes; beside tensor or fsdp, and on a mesh without an
    expert axis, the primitive path (the grouped products per shard), as
    in the reference. Returns [T, H] f32."""
    c = config
    e_loc = c.n_experts // lay.ep
    fused_ok = lay.ep > 1 and lay.tp == 1 and lay.fsdp == 1
    parts = []
    for t, (w_gu, w_down) in enumerate(blocks):
        dev = lay.device(g, t, e)
        parts.append(_pairs_mlp(
            xf.to(dev), gates.to(dev), experts.to(dev), w_gu, w_down, c,
            lo=e * e_loc, e_loc=e_loc, use_kernels=use_kernels,
            under_mesh=not fused_ok))
    return sum_parts(parts, xf.device)


def _dropless_tp_out(x, layer, config: MoeConfig, lay: Layout, g: int,
                     use_kernels: bool = True):
    """Dropless on a mesh without an expert axis (group ``g``): the norm
    and the routing once, then each tensor shard's primitive pipeline on
    its M block of every expert (``w_gateup`` [E, H, 2, M / tensor] a
    strided view, ``w_down`` [E, M / tensor, H]; int8 stacks through
    ``grouped_matmul_int8``), and the psum over ``tensor`` (f32). Returns
    (out [B, S, H] f32, aux, probs)."""
    c = config
    b, s, h = x.shape
    xn = _norm(use_kernels)(x, layer["ln_mlp"].to(x.device), c.norm_eps)
    xf = xn.reshape(b * s, h)
    gates, experts, probs, aux = _route_topk(xf, layer["wr"].to(x.device), c)
    blocks = _expert_blocks(layer, c, lay, g)
    out = _expert_pairs(xf, gates, experts, blocks[0], c, lay, g, 0,
                        use_kernels)
    return out.reshape(b, s, h), aux, probs


def _ep_geometry(config: MoeConfig, lay: Layout) -> tuple:
    """(n_ep, e_loc): the expert axis's size and the experts per shard."""
    n_ep = lay.ep
    e = config.n_experts
    if e % n_ep:
        raise ValueError(
            f"n_experts={e} does not divide over expert axis size {n_ep}"
        )
    return n_ep, e // n_ep


def _ep_dropless_out(x, layer, config: MoeConfig, lay: Layout, g: int,
                     use_kernels: bool = True):
    """Expert-parallel dropless MLP over group ``g``'s expert shards: the
    ring where the geometry allows, the psum formulation as fallback and
    parity oracle (``config.ep_overlap``)."""
    c = config
    n_ep, _ = _ep_geometry(c, lay)
    t = x.shape[0] * x.shape[1]
    ring_ok = n_ep > 1 and t % n_ep == 0
    if c.ep_overlap == "ring" and not ring_ok:
        raise ValueError(
            f"ep_overlap='ring' needs the token count ({t}) to divide "
            f"the expert axis ({n_ep}); use 'auto' or 'psum'"
        )
    if c.ep_overlap not in ("auto", "ring", "psum"):
        raise ValueError(
            f"unknown ep_overlap {c.ep_overlap!r}; valid: auto, ring, "
            "psum"
        )
    if c.ep_overlap != "psum" and ring_ok:
        return _ep_ring_out(x, layer, c, lay, g, use_kernels)
    return _ep_psum_out(x, layer, c, lay, g, use_kernels)


def _ep_psum_out(x, layer, config: MoeConfig, lay: Layout, g: int,
                 use_kernels: bool = True):
    """Replicate-and-reduce expert parallelism: the routing of the
    group's batch is computed once (the reference computes the same,
    replicated, on every shard), each expert shard runs the pairs routed
    to its local experts over the whole batch, and the sum of the shards'
    contributions is the psum. Each (token, expert) pair runs on exactly
    one shard, so the sum equals the single-device dropless result up to
    the order of the sum. Returns (out [B, S, H] f32, aux, probs)."""
    c = config
    n_ep, _ = _ep_geometry(c, lay)
    b, s, h = x.shape
    t = b * s
    xn = _norm(use_kernels)(x, layer["ln_mlp"].to(x.device),
                            c.norm_eps).reshape(t, h)
    gates, experts, probs, aux = _route_topk(xn, layer["wr"].to(x.device), c)
    blocks = _expert_blocks(layer, c, lay, g)
    out = None
    for e in range(n_ep):
        contrib = _expert_pairs(
            xn.to(lay.device(g, e=e)), gates, experts, blocks[e], c, lay, g,
            e, use_kernels).to(x.device)
        out = contrib if out is None else out + contrib
    # The full [T, H] reduction: this path's traffic against the ring's.
    collectives.emit(
        "moe.ep_psum.combine", collectives.MEDIUM_ICI,
        collectives.all_reduce_bytes(
            collectives.payload_bytes(contrib.shape, contrib.dtype), n_ep,
        ),
    )
    return out.reshape(b, s, h), aux, probs


def _ep_ring_out(x, layer, config: MoeConfig, lay: Layout, g: int,
                 use_kernels: bool = True):
    """Ring expert parallelism over group ``g``'s expert shards: the
    all-to-all in n_ep hops. Chunk i of the tokens starts on expert shard
    i; at each hop every shard routes the chunk it holds (chunk (i - hop)
    mod n_ep), runs its local experts on it and adds the result to a
    carrier that rotates with the chunk, so after n_ep carrier hops chunk
    i's output is back on shard i, and the concatenation in shard order
    restores the token order.

    The reference issues the next chunk's hop before the hop's expert
    work, so the transfer overlaps it. Here a rotation's streams wait on
    each other (``ring_permute_group``), so that early hop could overlap
    nothing; the chunk travels with the carrier instead: hop h < n_ep - 1
    ends with one K9 launch rotating both (``ring_permute_many``), the
    last hop rotates the carrier alone -- n_ep launches a layer, not
    2 n_ep - 1. The expert work never writes ``x_cur``, so the values are
    the reference's; the ledger records ``moe.ep_ring.x`` then
    ``moe.ep_ring.y`` a hop, as there.

    The row buffers are [T k / n_ep, H] per shard and hop, against the
    psum path's [T k, H]. The Switch aux statistics come from hop 0 (each
    shard's own chunk) and are averaged over the shards: equal to the
    whole batch's up to the f32 order of the means. Beside tensor each
    hop's chunk is routed once on its expert shard and run per tensor
    shard (:func:`_expert_pairs`): the tensor axis adds no hop. Returns
    (out [B, S, H] f32, aux, (frac, mean_prob))."""
    c = config
    n_ep, _ = _ep_geometry(c, lay)
    b, s, h = x.shape
    e = c.n_experts
    t = b * s
    t_loc = t // n_ep
    devs = [lay.mesh.devices[i] for i in lay.expert_shards(g)]
    xn = _norm(use_kernels)(x, layer["ln_mlp"].to(x.device),
                            c.norm_eps).reshape(t, h)
    wr = [layer["wr"].to(d) for d in devs]
    blocks = _expert_blocks(layer, c, lay, g)
    x_cur = [xn[i * t_loc:(i + 1) * t_loc].to(d) for i, d in enumerate(devs)]
    y = [torch.zeros(t_loc, h, dtype=torch.float32, device=d) for d in devs]
    frac, meanprob = [None] * n_ep, [None] * n_ep
    for hop in range(n_ep):
        for i in range(n_ep):
            gates, experts, probs, _aux = _route_topk(x_cur[i], wr[i], c)
            if hop == 0:
                frac[i] = _one_hot(experts[:, 0], e, probs.dtype).mean(0)
                meanprob[i] = probs.mean(0)
            y[i] = y[i] + _expert_pairs(x_cur[i], gates, experts,
                                        blocks[i], c, lay, g, i, use_kernels)
        if hop < n_ep - 1:
            x_cur, y = ring_permute_many(
                [x_cur, y], "expert", n_ep,
                sites=("moe.ep_ring.x", "moe.ep_ring.y"))
        else:
            y = ring_permute(y, "expert", n_ep, site="moe.ep_ring.y")
    out = torch.cat([yi.to(x.device) for yi in y], dim=0)
    collectives.emit(
        "moe.ep_ring.all_gather", collectives.MEDIUM_ICI,
        collectives.all_gather_bytes(
            collectives.payload_bytes(y[0].shape, y[0].dtype), n_ep),
    )
    frac = torch.stack([f.to(x.device) for f in frac]).mean(0)
    meanprob = torch.stack([p.to(x.device) for p in meanprob]).mean(0)
    collectives.emit(
        "moe.ep_ring.aux", collectives.MEDIUM_ICI,
        2 * collectives.all_reduce_bytes(
            collectives.payload_bytes(frac.shape, frac.dtype), n_ep),
        invocations=2,
    )
    aux = e * torch.sum(frac * meanprob)
    return out.reshape(b, s, h), aux, (frac, meanprob)


def _note_first_use(impl: str, dispatch: str, tokens: int) -> None:
    key = f"{impl}:{dispatch}:t{tokens}"
    if key in MOE_TRACE_COUNTS:
        return
    MOE_TRACE_COUNTS[key] += 1
    for observer in TRACE_OBSERVERS:
        observer("moe_block", f"{impl}:{dispatch}", {"tokens": tokens})


def _einsum_out(x, layer, config: MoeConfig, use_kernels: bool = True,
                ep: tuple | None = None):
    """The GShard capacity formulation: route within groups of
    ``router_group`` tokens, dispatch into [E, ..., C, H] by one-hot
    einsums, the experts' MLPs, combine. ``ep`` = (layout, group) runs
    the experts on the layout's mesh (:func:`_expert_blocks`): expert
    shard i's experts [i e_loc, (i + 1) e_loc) of the expert-major
    dispatched tensor run per tensor shard on their M block, the tensor
    shards' outputs summed in f32 on the expert shard's first tensor
    shard, and the expert shards' results concatenate along E (without
    an expert axis, one shard of every expert). The norm and the routing
    run once. Returns (out [B, S, H] f32, aux, probs)."""
    c = config
    b, s, h = x.shape
    xn = _norm(use_kernels)(x, layer["ln_mlp"].to(x.device), c.norm_eps)
    g = effective_router_group(c, s)
    cap = _capacity(c, g)
    if g != s:
        # Route within groups of g tokens: fold the group count into the
        # batch dim -- _route treats each batch row as a group.
        xn = xn.reshape(b * (s // g), g, h)
    logits = torch.einsum("bsh,he->bse", xn.float(),
                          layer["wr"].to(x.device).float())
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _route(probs, c, cap)
    xe = torch.einsum("bsec,bsh->ebch", dispatch.to(xn.dtype), xn)
    if ep is not None:
        lay, grp = ep
        e_loc = c.n_experts // lay.ep
        blocks = _expert_blocks(layer, c, lay, grp)
        ye = []
        for i in range(lay.ep):
            xi = xe[i * e_loc:(i + 1) * e_loc]
            parts = [_experts(xi.to(lay.device(grp, t, i)), w_gu, w_down,
                              x.dtype, use_kernels).float()
                     for t, (w_gu, w_down) in enumerate(blocks[i])]
            ye.append(sum_parts(parts, lay.device(grp, e=i)).to(x.device))
        ye = torch.cat(ye, dim=0)
    else:
        ye = _experts(xe, layer["w_gateup"], layer["w_down"], x.dtype,
                      use_kernels)
    out = torch.einsum("bsec,ebch->bsh", combine.float(), ye.float())
    return out.reshape(b, s, h), aux, probs


def moe_group(x, layer, config: MoeConfig, lay: Layout, g: int,
              use_kernels: bool = True, in_pipeline: bool = False):
    """Batch group ``g``'s sparse MLP on a mesh (``parallel/layout.py``),
    ``moe_impl`` resolved at the whole batch's token count as the
    reference resolves it (a microbatch's inside a pipeline, where
    ``auto`` is einsum and dropless on an expert axis is refused, as the
    reference refuses it). On an expert axis: dropless expert parallel
    over the group's expert shards (ring or psum), einsum with the
    experts split over them, binned refused; beside tensor (and fsdp)
    each expert shard's experts run per tensor shard on their M block and
    the shards' outputs add up in f32 (:func:`_expert_pairs`). Without
    one (the reference's GSPMD case): dropless on the primitive path
    (:func:`_dropless_tp_out`) and einsum route once and run each tensor
    shard's M block of every expert; binned runs whole per tensor shard;
    the psum over ``tensor`` adds the shards' outputs (SwiGLU is
    elementwise over M). Returns (x + out, aux, the aux statistics of
    :func:`_stats`)."""
    c = config
    tokens = x.shape[0] * x.shape[1] * (1 if in_pipeline else lay.dp)
    expert_mesh = lay.ep > 1
    impl = resolve_moe_impl(c, tokens, expert_mesh=expert_mesh,
                            in_pipeline=in_pipeline)
    _note_first_use(
        impl,
        moe_dispatch.dispatch_impl_label(c.hidden, c.mlp_hidden,
                                         device=x.device),
        tokens,
    )
    if impl in ("binned", "grouped") and expert_mesh:
        # binned carries no expert placement; its routing and drops are
        # the einsum path's, which does.
        raise ValueError(
            f"moe_impl={c.moe_impl!r} does not support an expert-sharded "
            "mesh; use 'einsum'/'auto' (same drop semantics) or "
            "'dropless' for expert-parallel runs"
        )
    if impl not in ("binned", "grouped", "dropless", "einsum"):
        raise ValueError(
            f"unknown moe_impl {c.moe_impl!r}; valid: "
            "auto, binned, dropless, einsum"
        )
    if expert_mesh and impl == "dropless" and in_pipeline:
        raise ValueError(
            "moe_impl='dropless' is not supported inside the pipelined "
            "forward; use 'einsum' for pipe meshes")
    if impl == "dropless":
        body = _ep_dropless_out if expert_mesh else _dropless_tp_out
        out, aux, st = body(x, layer, c, lay, g, use_kernels)
    elif impl == "einsum":
        out, aux, st = _einsum_out(x, layer, c, use_kernels, ep=(lay, g))
    else:
        outs = []
        for t in range(lay.tp):
            local = {k: lay.weight(layer[k], g, t)
                     for k in ("ln_mlp", "wr", "w_gateup", "w_down")}
            o, aux, st = _binned_out(x.to(lay.device(g, t)), local, c,
                                     use_kernels)
            outs.append(o)
        out = sum_parts(outs, x.device)
    if not isinstance(st, tuple):
        st = _stats(st, c.n_experts)
    return x + out.to(x.dtype), aux, st


def _moe_block(x, layer, config: MoeConfig, use_kernels: bool = True):
    """Sparse MLP on one device: route -> dispatch -> experts -> combine ->
    residual. Returns (x, aux). ``config.moe_impl`` picks the formulation
    ("auto" resolved by :func:`resolve_moe_impl`). ``use_kernels=False``
    runs the plain versions of RMSNorm, K7 and K8 (and of ``int8_matmul``
    for int8 experts) even on CUDA tensors. On a mesh the layers call
    :func:`moe_group` per batch group instead."""
    c = config
    tokens = x.shape[0] * x.shape[1]
    if isinstance(getattr(layer["w_gateup"], "q", layer["w_gateup"]),
                  Sharded):
        raise ValueError("sharded expert stacks need the mesh they were "
                         "sharded on (mesh=...)")
    impl = resolve_moe_impl(c, tokens)
    _note_first_use(
        impl,
        moe_dispatch.dispatch_impl_label(c.hidden, c.mlp_hidden,
                                         device=x.device),
        tokens,
    )
    if impl in ("binned", "grouped"):   # "grouped": the megablocks term
        return _moe_block_binned(x, layer, c, use_kernels=use_kernels)
    if impl == "dropless":
        return _moe_block_dropless(x, layer, c, use_kernels=use_kernels)
    if impl != "einsum":
        raise ValueError(
            f"unknown moe_impl {c.moe_impl!r}; valid: "
            "auto, binned, dropless, einsum"
        )
    out, aux, _ = _einsum_out(x, layer, c, use_kernels)
    return x + out.to(x.dtype), aux


def _experts(xe: torch.Tensor, w_gu, w_down, dtype: torch.dtype,
             use_kernels: bool) -> torch.Tensor:
    """The einsum and binned bodies' expert MLPs: xe [E, ..., H] -> ye
    [E, ..., H] in ``dtype``, each expert's SwiGLU MLP on its rows. Float
    stacks run as batched products, the gate/up one the ``moe_gu`` site.
    An int8 stack (models/quant.py) goes through ``int8_matmul``'s
    prologue mode, all experts in one launch per product: the reference's
    ``bf16(q * scale)`` rounding made tile by tile, never a dequantized
    copy of the stack (its plain version, with ``use_kernels=False`` or on
    the CPU, makes that copy)."""
    e, h = xe.shape[0], xe.shape[-1]
    rows = xe.reshape(e, -1, h)
    if isinstance(w_gu, QuantTensor):
        gu = _int8_experts(rows, w_gu, use_kernels)
    else:
        gu = expert_gateup_site(rows, w_gu)                # [E, R, 2, M]
    gate = F.silu(gu[..., 0, :].float())
    act = (gate * gu[..., 1, :].float()).to(dtype)
    if isinstance(w_down, QuantTensor):
        ye = _int8_experts(act, w_down, use_kernels)
    else:
        ye = torch.bmm(act, w_down)
    return ye.reshape(xe.shape)


def _int8_experts(rows: torch.Tensor, w: QuantTensor,
                  use_kernels: bool) -> torch.Tensor:
    """rows [E, R, K] against the int8 stack w [E, K, ...] -> [E, R, ...]
    in rows' dtype, through ``int8_matmul``'s prologue mode. A tensor
    shard's gate/up block [E, K, 2, M / tensor] (a strided view) runs a
    launch per half, each half a strided view too: no copy of the
    weights."""
    q = w.q
    if q.dim() == 4 and q.stride(2) != q.shape[3] * q.stride(3):
        return torch.stack([_int8_experts(rows, QuantTensor(
            q=q[:, :, i], scale=w.scale[:, :, i].contiguous()), use_kernels)
            for i in (0, 1)], dim=2)
    e, r, k = rows.shape
    fn = int8_matmul if use_kernels else int8_matmul_reference
    y = fn(rows.contiguous(), w.q.reshape(e, k, -1), w.scale.reshape(e, -1),
           prologue=True)
    return y.reshape(e, r, *w.q.shape[2:])


class _GatherRows(torch.autograd.Function):
    """Row gather ``y[i] = x[idx[i]]`` (out-of-range ids give zero rows)
    whose backward is gathers too, through the inverse map ``bwd_idx``
    [J, len(x)]: ``dx = sum_j dy[bwd_idx[j]]`` (out of range -> 0). The
    reference's ``_gather_rows``: in binned's dispatch and combine every
    inverse map is known (a token fills at most top_k slots, a slot holds
    at most one pair), so neither direction needs a scatter-add."""

    @staticmethod
    def forward(ctx, x, idx, bwd_idx):
        ctx.save_for_backward(bwd_idx)
        return moe_dispatch._take_rows(x, idx)

    @staticmethod
    def backward(ctx, dy):
        (bwd_idx,) = ctx.saved_tensors
        dx = sum(moe_dispatch._take_rows(dy, bwd_idx[j])
                 for j in range(bwd_idx.shape[0]))
        return dx, None, None


def _moe_block_binned(x, layer, config: MoeConfig,
                      use_kernels: bool = True):
    """:func:`_binned_out` plus the residual. Returns (x + out, aux)."""
    out, aux, _ = _binned_out(x, layer, config, use_kernels)
    return x + out.to(x.dtype), aux


def _binned_out(x, layer, config: MoeConfig, use_kernels: bool = True):
    """Sorted capacity-binned sparse MLP (the reference's
    ``_moe_block_binned``): the einsum path's routing, drops, gates and
    tie-breaking, without its [.., E, C] one-hot products. The capacity
    cumsum gives each kept pair its (expert, group, position) slot; one
    int scatter (the ``moe_routing`` site) inverts it; a row gather fills
    the expert-major bins [E, Bg * C, H]; the experts run as batched
    products (the gate/up one the ``moe_gu`` site); a second gather,
    weighted by the gates, combines. Returns (out [B, S, H] f32, aux,
    probs)."""
    c = config
    b, s, h = x.shape
    e, k = c.n_experts, c.top_k
    xn = _norm(use_kernels)(x, layer["ln_mlp"].to(x.device), c.norm_eps)
    g = effective_router_group(c, s)
    cap = _capacity(c, g)
    bg = b * (s // g)
    xn = xn.reshape(bg, g, h)
    logits = torch.einsum("bsh,he->bse", xn.float(),
                          layer["wr"].to(x.device).float())
    probs = torch.softmax(logits, dim=-1)
    masks, gates, aux = _topk_masks(probs, c)               # [Bg, G, E]
    denom = sum(gates) + 1e-9

    # Slot addressing: choice k queues behind choices < k (the _route
    # priority), its position from the same cumsum.
    count = torch.zeros((bg, 1, e), dtype=probs.dtype, device=x.device)
    e_l, pos_l, gatew_l = [], [], []
    for mk, gk in zip(masks, gates):
        pos = torch.cumsum(mk, dim=1) - mk + count
        count = count + mk.sum(dim=1, keepdim=True)
        pos_l.append((pos * mk).sum(dim=-1).long())         # [Bg, G]
        e_l.append(torch.argmax(mk, dim=-1))
        gatew_l.append(gk / denom)
    e_tok, pos_tok = torch.stack(e_l), torch.stack(pos_l)   # [k, Bg, G]
    gates_w = torch.stack(gatew_l)

    # Expert-major slots; dropped pairs get the sentinel nslots.
    t = bg * g
    nslots = e * bg * cap
    group_ids = torch.arange(bg, device=x.device)[None, :, None]
    slot_global = (e_tok * bg + group_ids) * cap + pos_tok
    pair_slot = torch.where(pos_tok < cap, slot_global,
                            torch.full_like(slot_global, nslots))
    pair_slot = pair_slot.reshape(k, t)
    scatter_to = pair_slot.reshape(k * t)
    slot_pair = slots_site(scatter_to, nslots)
    slot_token = torch.where(slot_pair < k * t, slot_pair % t,
                             torch.full_like(slot_pair, t))
    xe = _GatherRows.apply(xn.reshape(t, h), slot_token, pair_slot)
    ye = _experts(xe.reshape(e, bg * cap, h), layer["w_gateup"],
                  layer["w_down"], x.dtype, use_kernels)
    y_pair = _GatherRows.apply(ye.reshape(nslots, h), scatter_to,
                               slot_pair[None])
    y_pair = y_pair.float() * gates_w.reshape(k * t)[:, None]
    out = y_pair.reshape(k, t, h).sum(dim=0)
    return out.reshape(b, s, h), aux, probs


def _block(x, layer, config: MoeConfig, cos, sin, use_kernels: bool):
    """One layer: attention, then the sparse MLP. Returns (x, aux)."""
    x = _attention_block(x, layer, config, cos, sin, use_kernels)
    return _moe_block(x, layer, config, use_kernels=use_kernels)


def _mesh_block(xs, layer, config: MoeConfig, cos, sin, use_kernels: bool,
                lay: Layout, g: int, use_ring: bool = False,
                in_pipeline: bool = False):
    """One layer of batch group ``g`` on a mesh over its token blocks
    ``xs``: the Megatron attention block, then :func:`moe_group` on the
    group's whole sequence -- on a sequence axis the blocks are gathered
    for it and cut back after, so the capacity groups (``router_group``
    0: a row's whole sequence) and the aux's means are the reference's
    global ones. Returns (blocks, (aux, statistics))."""
    xs = mesh_attention(xs, layer, config, cos, sin, use_kernels, lay, g,
                        use_ring)
    x = xs[0] if len(xs) == 1 else concat_parts(xs, 1, lay.home(g))
    x, aux, st = moe_group(x, layer, config, lay, g, use_kernels,
                           in_pipeline)
    if len(xs) == 1:
        return [x], (aux, st)
    span = xs[0].shape[1]
    # Each block contiguous, as the kernels downstream take it (a cut of
    # the sequence axis of [B, S, H] with B > 1 is strided).
    return [x[:, j * span:(j + 1) * span].to(lay.home(g, j)).contiguous()
            for j in range(len(xs))], (aux, st)


def _mesh_forward(params, tokens, config: MoeConfig, mesh: Mesh,
                  remat: bool, remat_policy: str, use_kernels: bool,
                  use_ring: bool = False):
    """(layout, placed params, per-group token blocks' hidden states, aux
    averaged over layers) of the mesh forward."""
    c = config
    lay, placed, xs, extras = mesh_trunk(
        params, tokens, c, mesh, param_specs(c), _mesh_block, remat,
        remat_policy, use_kernels, use_ring)
    home = lay.home(0)
    aux = torch.zeros((), dtype=torch.float32, device=home)
    for per_group in extras:
        if lay.dp == 1:
            aux = aux + per_group[0][0].to(home)
        else:
            aux = aux + _aux_of([st for _, st in per_group], c.n_experts,
                                home)
    return lay, placed, xs, aux / c.n_layers


def forward(
    params: dict,
    tokens: torch.Tensor,               # [B, S] int
    config: MoeConfig,
    remat: bool = False,
    return_hidden: bool = False,
    remat_policy: str = "full",
    use_kernels: bool = True,
    mesh: Mesh | None = None,
    use_ring: bool = False,
):
    """Causal LM forward. Returns (logits [B, S, V] f32, or the final
    hidden states with ``return_hidden``, and the aux loss averaged over
    layers). Differentiable; ``remat`` takes the dense trunk's policies.
    Weights are unbound per layer once, as ``llama.forward`` does. On a
    ``mesh`` the layers run per batch group and tensor shard
    (``llama.mesh_trunk``) with the MoE blocks of :func:`moe_group`; the
    result is gathered on the mesh's first device, and the aux combines
    the groups' statistics (the whole batch's, up to the f32 order of
    the means). ``use_ring`` runs ring attention over the mesh's
    sequence axis."""
    c = config
    if mesh is not None:
        lay, placed, xs, aux = _mesh_forward(
            params, tokens, c, mesh, remat, remat_policy, use_kernels,
            use_ring)
        if not return_hidden:
            xs = [[mesh_logits(x, mesh_heads(placed["lm_head"], lay, g, j),
                               use_kernels) for j, x in enumerate(blocks)]
                  for g, blocks in enumerate(xs)]
        return mesh_gather(lay, xs), aux
    s = tokens.shape[1]
    x = q_lookup(params["embed"], tokens, c.dtype)
    cos, sin = rope_frequencies(c.head_dim, s, c.rope_theta,
                                device=tokens.device)
    block = _remat_transform(remat, remat_policy)(_block)
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(c.n_layers):
        layer = {name: ws[i] for name, ws in layers.items()}
        x, aux_l = block(x, layer, c, cos, sin, use_kernels)
        aux = aux + aux_l
    aux = aux / c.n_layers
    x = _norm(use_kernels)(x, params["final_norm"], c.norm_eps)
    if return_hidden:
        return x, aux
    return q_matmul(x, params["lm_head"], use_kernels).float(), aux


def forward_pipelined(
    params: dict,
    tokens: torch.Tensor,               # [B, S] int
    config: MoeConfig,
    mesh: Mesh,
    n_microbatches: int = 2,
    return_hidden: bool = False,
    remat: bool = False,
):
    """Causal MoE LM forward as a GPipe pipeline over the mesh's ``pipe``
    axis (``parallel/pipeline.py``), composed with the other axes: each
    stage runs its layers through the mesh block on its sub-mesh, the MoE
    block resolved as inside a pipeline (``auto`` is einsum; dropless on
    an expert axis raises, as in the reference). The Switch aux rides the
    pipeline as a per-row channel: each stage adds its layers' aux of the
    microbatch, spread over its rows; the total is divided by ``n_layers
    * n_microbatches * (data * fsdp)``, the reference's mean of per
    (batch group, microbatch) statistics. Returns (logits f32, or the
    final hidden states with ``return_hidden``, aux)."""
    from ..parallel.pipeline import pipeline, stage_params

    c = config
    n_stages = mesh.shape["pipe"]
    if c.n_layers % n_stages:
        raise ValueError(
            f"{c.n_layers} layers do not split over {n_stages} stages"
        )
    check_heads(c, mesh)
    home = mesh.devices[0]
    s = tokens.shape[1]
    x = q_lookup(params["embed"], tokens.to(home), c.dtype)
    cos, sin = rope_frequencies(c.head_dim, s, c.rope_theta, device=home)
    staged = stage_params(params["layers"], n_stages)
    block = functools.partial(_mesh_block, in_pipeline=True)
    stage_fn, lays = pipeline_stages(c, mesh, block,
                                     param_specs(c)["layers"], remat, cos,
                                     sin)

    def stage(stage_layers, act, p, g):
        h, extras = stage_fn(stage_layers, act["x"], p, g)
        aux = sum(a.to(h.device) for a, _ in extras)
        return {"x": h, "aux": act["aux"] + aux / act["aux"].shape[0]}

    out = pipeline(
        stage, staged,
        {"x": x, "aux": torch.zeros((tokens.shape[0],), dtype=torch.float32,
                                    device=home)},
        mesh=mesh, n_microbatches=n_microbatches, manual_only=False,
        with_coords=True)
    aux = out["aux"].sum() / (c.n_layers * n_microbatches * lays[0].dp)
    h = rmsnorm(out["x"], params["final_norm"].to(home), c.norm_eps)
    if return_hidden:
        return h, aux
    return q_matmul(h, params["lm_head"].to(home)).float(), aux


def loss_fn(
    params: dict,
    tokens: torch.Tensor,               # [B, S+1]: inputs + shifted targets
    config: MoeConfig,
    mesh: Mesh | None = None,
    use_ring: bool = False,
    remat: bool = True,
    remat_policy: str = "full",
    use_kernels: bool = True,
) -> torch.Tensor:
    """Next-token cross-entropy (mean over tokens) plus ``aux_coef`` times
    the load-balancing aux loss. On a ``mesh`` (:func:`forward`)
    ``params`` may hold whole or placed leaves; the gradient reaches the
    leaves either way. ``use_ring`` runs ring attention over the mesh's
    sequence axis."""
    if mesh is not None:
        lay, placed, xs, aux = _mesh_forward(
            params, tokens[:, :-1], config, mesh, remat, remat_policy,
            use_kernels, use_ring)
        ce = mesh_cross_entropy(lay, placed, xs, tokens[:, 1:])
        return ce + config.aux_coef * aux
    hidden, aux = forward(params, tokens[:, :-1], config, remat=remat,
                          return_hidden=True, remat_policy=remat_policy,
                          use_kernels=use_kernels)
    ce = chunked_cross_entropy(hidden, params["lm_head"], tokens[:, 1:])
    return ce + config.aux_coef * aux
