"""Llama-3 family causal LM: configuration, parameters, the dense layers
the serving path runs, and the training forward and loss. Counterpart of
``k8s_dra_driver_tpu/models/llama.py``.

The training forward (:func:`forward`, :func:`loss_fn`) maps the
reference's ``lax.scan`` over layers to a loop over the layers' views,
and its remat policies to ``torch.utils.checkpoint`` around each layer:
``"full"`` recomputes the whole layer (the flash kernel then runs twice
per layer and step, as under the reference's full remat); a named policy
(:data:`REMAT_POLICIES`) saves the named residuals through selective
activation checkpointing (``models/remat.py``). Each named residual is
the output of one op (the QKV product with rope, the flash kernels, the
output projection, the SwiGLU product), so a saved one is not recomputed.

Where eager PyTorch recomputes what XLA's dead-code elimination skips:
eager PyTorch replays the layer's forward up to the last tensor the
backward reads (``torch.utils.checkpoint``'s early stop ends the replay
there, so the down projection and the last residual add do not run
again, as XLA drops them), and a saved residual skips only the ops
inside its site op: anything upstream of it outside the op runs again.
The sites are drawn around the work for that reason (``flash_qkv`` spans
the QKV product and rope). Per policy, what the recompute of one layer
still runs (counted in ``tests/test_torch_train.py``), K1 at both norms
in each:

- ``flash``: the QKV product and rope (the flash backward needs q, k, v),
  the MLP's gate/up product and SwiGLU. Not K4, not the ``wo`` product.
- ``flash_qkv``: the MLP's gate/up product and SwiGLU. Not K4, not the
  QKV product and rope, not the ``wo`` product.
- ``flash_mlp``: the QKV product and rope, the MLP's gate/up product.
- ``flash_min`` and ``flash_moe`` (the latter's MoE names do not occur in
  the dense trunk): the QKV product and rope, the ``wo`` product, the
  MLP's gate/up product and SwiGLU.

On a ``mesh`` (:func:`mesh_trunk`, ``parallel/layout.py``) the batch rows
split over data x fsdp groups; in each group the tensor shards run the
Megatron split explicitly (the reference leaves it to GSPMD):
``wqkv`` column-parallel over whole kv-head groups (each shard slices its
q/k/v, attention on its heads), ``wo`` row-parallel, then a psum over
``tensor``; gate/up column-parallel over M (two products on the strided
halves of the shard's [H, 2, M / T] block), ``w_down`` row-parallel,
then a psum; the embedding a vocab-cut lookup plus a psum, the LM head
vocab-cut columns with the logits gathered. A weight cut over fsdp is
gathered per layer and shard before use. Whole leaves are cut into views
inside the loss (:func:`place`), so the gradients reach them.

XLA recomputes the same products under each policy but one: the port's
``attn_o`` is the output projection's result, where the reference's
names the attention output (which ``flash_out`` already keeps), so
"flash", "flash_qkv" and "flash_mlp" also skip the ``wo`` product that
XLA recomputes to rebuild the residual. The MoE block's recompute is in
``models/moe.py``.

On a ``sequence`` axis each batch group's rows cut into token blocks
(``Layout.blocks``): the embedding, rope (at the block's positions), the
norms, the MLP and the CE run block by block; attention joins a group's
blocks -- with ``use_ring`` through ring attention
(``parallel/ring.py::ring_attention_shards``, every tensor shard's ring in
one K9 launch a hop), else by gathering each tensor shard's q/k/v over
``sequence`` for one whole-sequence ``flash_attention`` (the reference's
GSPMD result). The ring tags no remat name: under any policy the
recompute reruns the ring's forward, as the reference's does.
:func:`forward_pipelined` runs the layers as a GPipe pipeline over
``pipe`` (``parallel/pipeline.py``), each stage's layers through the
mesh block on its own sub-mesh.

Parameters are a plain dict with the reference's structure and layouts,
layers stacked on axis 0:

- ``wqkv`` ``[L, H, n_kv_heads, group + 2, head_dim]``: per kv head its
  ``group`` query heads, then its k head, then its v head ("grouped by kv
  head"). Query head ``h`` reads kv head ``h // group``; the paged kernels
  rely on that order.
- ``w_gateup`` ``[L, H, 2, M]`` (index 0 gate, 1 up), ``w_down``
  ``[L, M, H]``, ``wo`` ``[L, Hq, H]``, norms ``[L, H]``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

import torch.nn.functional as F

from .. import resolve_device
from ..ops.attention import _repeat_kv, attention_reference, flash_attention
from ..ops.norms import rmsnorm, rmsnorm_reference
from ..ops.rotary import apply_rope, rope_frequencies
from ..parallel.collectives import concat_parts, sum_parts
from ..parallel.layout import Layout, check_heads
from ..parallel.ring import _emit_ring_attention_kv, ring_attention_shards
from ..parallel.sharding import P, shard_pytree
from .quant import QuantTensor, q_einsum, q_lookup, q_matmul, quantize_specs
from .remat import (
    attn_proj_site,
    qkv_site,
    save_only_these_names,
    swiglu_site,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_hidden: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    def flops_per_token(self, seq: int | None = None) -> float:
        """Dense fwd+bwd FLOPs/token ~ 6N + the attention term (at ``seq``,
        default max_seq_len)."""
        attn = 12 * self.n_layers * self.hidden * (seq or self.max_seq_len)
        return 6 * self.num_params() + attn

    def num_params(self) -> int:
        h, m, v, l = self.hidden, self.mlp_hidden, self.vocab_size, self.n_layers
        kv = self.n_kv_heads * self.head_dim
        per_layer = h * h + 2 * h * kv + h * h + 3 * h * m + 2 * h
        return v * h + l * per_layer + h + h * v


PRESETS: dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(
        vocab_size=256, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_hidden=128, max_seq_len=128, dtype=torch.float32,
    ),
    "160m": LlamaConfig(
        vocab_size=32000, hidden=768, n_layers=12, n_heads=12, n_kv_heads=12,
        mlp_hidden=2048, max_seq_len=2048,
    ),
    "160m-gqa": LlamaConfig(
        vocab_size=32000, hidden=768, n_layers=12, n_heads=12, n_kv_heads=4,
        mlp_hidden=2048, max_seq_len=2048,
    ),
    "1b": LlamaConfig(
        vocab_size=128256, hidden=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        mlp_hidden=8192, max_seq_len=8192,
    ),
    "3b": LlamaConfig(
        vocab_size=128256, hidden=3072, n_layers=28, n_heads=24, n_kv_heads=8,
        mlp_hidden=8192, max_seq_len=8192,
    ),
    "8b": LlamaConfig(),  # Llama-3-8B
    "8b-L8": LlamaConfig(vocab_size=32000, n_layers=8, max_seq_len=8192),
    "70b": LlamaConfig(
        vocab_size=128256, hidden=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        mlp_hidden=28672, max_seq_len=8192,
    ),
}


def init_params(config: LlamaConfig, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default CUDA), each weight ``normal / sqrt(fan_in)`` like the
    reference. Stacked weights are drawn one layer at a time so the f32
    draw never holds more than one layer's slice."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, m, v, l = c.hidden, c.mlp_hidden, c.vocab_size, c.n_layers
    hq = c.n_heads * c.head_dim
    g = c.n_heads // c.n_kv_heads

    def normal(*shape, fan_in, stacked=False):
        out = torch.empty(shape, dtype=c.dtype, device=dev)
        for part in out if stacked else [out]:
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
                           stacked=True),
            "wo": normal(l, hq, h, fan_in=hq, stacked=True),
            "w_gateup": normal(l, h, 2, m, fan_in=h, stacked=True),
            "w_down": normal(l, m, h, fan_in=m, stacked=True),
            "ln_attn": ones(l, h),
            "ln_mlp": ones(l, h),
        },
        "final_norm": ones(h),
        "lm_head": normal(h, v, fan_in=h),
    }


def param_specs(config: LlamaConfig) -> dict:
    """Partition specs per parameter, the reference's: Megatron tensor
    parallelism (column-parallel ``wqkv`` over whole kv-head groups and
    gate/up over M, row-parallel ``wo`` and ``w_down``, the embedding and
    the LM head cut over the vocabulary) and fsdp on the other dimension.
    The leading None of a stack is the layer axis."""
    return {
        "embed": P("tensor", "fsdp"),
        "layers": {
            "wqkv": P(None, "fsdp", "tensor", None, None),
            "wo": P(None, "tensor", "fsdp"),
            "w_gateup": P(None, "fsdp", None, "tensor"),
            "w_down": P(None, "tensor", "fsdp"),
            "ln_attn": P(None, None),
            "ln_mlp": P(None, None),
        },
        "final_norm": P(None),
        "lm_head": P("fsdp", "tensor"),
    }


def place(params: dict, mesh, specs: dict) -> dict:
    """``params`` placed on ``mesh`` by ``specs`` (``quantize_specs`` of
    them for int8 weights): leaves already :class:`Sharded` stay, whole
    ones are cut into views (``shard_pytree``), so a loss over the result
    reaches the whole leaves -- the shard_map of an unsharded input."""
    if isinstance(params["layers"]["wqkv"], QuantTensor):
        specs = quantize_specs(specs)
    return shard_pytree(params, mesh, specs)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights as views into the stacked tensors."""
    return {name: w[i] for name, w in params["layers"].items()}


def project_qkv(
    xn: torch.Tensor,             # [B, T, H] (normed input)
    layer: dict,
    config: LlamaConfig,
    cos, sin,
    positions=None,
    use_kernels: bool = True,
):
    """QKV projection + head split + rope. Returns q [B,Hq,T,D],
    k,v [B,Hkv,T,D]. ``use_kernels=False`` runs an int8 weight's plain
    product (models/quant.py)."""
    b, t, _ = xn.shape
    # The heads from the weight: a tensor shard's block holds whole kv
    # groups (KV / tensor of them).
    _, kv, g2, d = layer["wqkv"].shape
    g = g2 - 2
    # [B, T, H] @ [H, KV, G+2, D]: one matmul; q_einsum is the int8 seam
    # (models/quant.py), the same product for float weights.
    qkv = q_einsum("bth,hkgd->btkgd", xn, layer["wqkv"], use_kernels)
    q = qkv[..., :g, :].reshape(b, t, kv * g, d)
    k = qkv[..., g, :]                                  # [B, T, KV, D]
    v = qkv[..., g + 1, :]
    q = apply_rope(q.transpose(1, 2), cos, sin, positions=positions)
    k = apply_rope(k.transpose(1, 2), cos, sin, positions=positions)
    return q, k, v.transpose(1, 2)


def attn_out(x: torch.Tensor, o: torch.Tensor, layer: dict,
             use_kernels: bool = True) -> torch.Tensor:
    """Output projection + residual. o: [B, H, T, D] attention result."""
    b, _, t, _ = o.shape
    flat = o.transpose(1, 2).reshape(b, t, -1)
    return x + q_matmul(flat.to(x.dtype), layer["wo"],
                        use_kernels).to(x.dtype)


def _mlp_block(x, layer, config: LlamaConfig, use_kernels: bool = True):
    """SwiGLU MLP + residual. ``use_kernels=False`` runs the plain RMSNorm
    even on CUDA tensors (the kernel-versus-plain comparison)."""
    norm = rmsnorm if use_kernels else rmsnorm_reference
    xn = norm(x, layer["ln_mlp"], config.norm_eps)
    gu = q_einsum("bth,hcm->btcm", xn, layer["w_gateup"],   # [B, T, 2, M]
                  use_kernels)
    prod = swiglu_site(gu)          # the mlp_prod site, in x's dtype
    return x + q_matmul(prod, layer["w_down"], use_kernels).to(x.dtype)


def _attention_block(x, layer, config: LlamaConfig, cos, sin,
                     use_kernels: bool = True):
    """Norm, QKV + rope, causal attention, output projection + residual.
    Float weights go through the remat sites (the ``flash_qkv``,
    ``flash_out`` and ``attn_o`` ops); int8 weights (``quantize_params``)
    through the int8 seams. ``use_kernels=False`` runs the plain RMSNorm
    and attention even on CUDA tensors (the kernel-versus-plain
    comparison)."""
    norm = rmsnorm if use_kernels else rmsnorm_reference
    xn = norm(x, layer["ln_attn"], config.norm_eps)
    int8 = isinstance(layer["wqkv"], QuantTensor)
    if int8:
        q, k, v = project_qkv(xn, layer, config, cos, sin,
                              use_kernels=use_kernels)
    else:
        q, k, v = qkv_site(xn, layer["wqkv"], cos, sin)
    if use_kernels:
        o = flash_attention(q, k, v, causal=True)
    else:
        g = config.n_heads // config.n_kv_heads
        o = attention_reference(q, _repeat_kv(k, g), _repeat_kv(v, g),
                                causal=True)
    if int8:
        return attn_out(x, o, layer, use_kernels)
    return x + attn_proj_site(o.to(x.dtype), layer["wo"]).to(x.dtype)


def _block(x, layer, config: LlamaConfig, cos, sin, use_kernels: bool):
    x = _attention_block(x, layer, config, cos, sin, use_kernels)
    return _mlp_block(x, layer, config, use_kernels=use_kernels)


# Remat policies of the reference, by name. "full" recomputes each layer
# in the backward; the others save the named residuals (flash out + lse,
# q/k/v, the attention output projection, the MLP product, MoE routing
# and the MoE gate/up product) and recompute the rest (models/remat.py).
REMAT_POLICIES = {
    "full": None,
    "flash": ("flash_out", "attn_o", "moe_routing"),
    "flash_qkv": ("flash_out", "flash_qkv", "attn_o", "moe_routing"),
    "flash_mlp": ("flash_out", "attn_o", "mlp_prod", "moe_routing"),
    "flash_min": ("flash_out", "moe_routing"),
    "flash_moe": ("flash_out", "moe_routing", "moe_gu"),
}


def _remat_transform(remat: bool, remat_policy: str):
    if not remat or remat_policy == "none":
        return lambda f: f
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {remat_policy!r}; valid: "
            f"{['none', *REMAT_POLICIES]}"
        )
    names = REMAT_POLICIES[remat_policy]
    if names is None:
        return lambda f: functools.partial(checkpoint, f,
                                           use_reentrant=False)
    return lambda f: functools.partial(
        checkpoint, f, use_reentrant=False,
        context_fn=save_only_these_names(*names))


# ---------------------------------------------------------------------------
# The trunk on a mesh (parallel/layout.py): batch groups over data x fsdp,
# Megatron tensor parallelism inside a group, fsdp-cut weights gathered
# per layer and shard.
# ---------------------------------------------------------------------------


def mesh_embed(embed, tokens: torch.Tensor, lay: Layout, g: int,
               dtype: torch.dtype, j: int = 0) -> torch.Tensor:
    """Token block ``(g, j)``'s embedding rows: each tensor shard looks up
    the tokens in its vocabulary block (zero rows elsewhere), and the psum
    over ``tensor`` adds the blocks' rows -- exact, one shard holds each
    token."""
    home = lay.home(g, j)
    parts = []
    for t in range(lay.tp):
        emb = lay.weight(embed, g, t, j)
        if lay.tp == 1:
            return q_lookup(emb, tokens.to(home), dtype)
        v_loc = emb.shape[0]
        tok = tokens.to(emb.device).long() - t * v_loc
        ok = (tok >= 0) & (tok < v_loc)
        rows = q_lookup(emb, tok.clamp(0, v_loc - 1), dtype)
        parts.append(torch.where(ok[..., None], rows, torch.zeros_like(rows)))
    return sum_parts(parts, home)


def mesh_heads(lm_head, lay: Layout, g: int, j: int = 0) -> list:
    """Token block ``(g, j)``'s LM head blocks, one per tensor shard
    (vocab-cut columns)."""
    return [lay.weight(lm_head, g, t, j) for t in range(lay.tp)]


def mesh_logits(x: torch.Tensor, heads: list,
                use_kernels: bool = True) -> torch.Tensor:
    """f32 logits of ``x`` against the vocab-cut head blocks, gathered
    over ``tensor`` (concatenated in shard order) on ``x``'s device."""
    return concat_parts(
        [q_matmul(x.to(h.device), h, use_kernels).float() for h in heads],
        -1, x.device)


def _half(w, i: int):
    """The gate (0) or up (1) half of a [H, 2, M] block, a strided view
    (no copy); an int8 block halves q and its scale alike."""
    if isinstance(w, QuantTensor):
        return QuantTensor(q=w.q[:, i, :], scale=w.scale[:, i, :])
    return w[:, i, :]


def _mesh_attend(q, k, v, use_kernels: bool, lay: Layout, g: int,
                 use_ring: bool) -> list:
    """Causal attention of group ``g``'s q/k/v (per tensor shard the list
    of its sequence blocks): with ``use_ring`` every tensor shard's ring
    through ``ring_attention_shards`` (one K9 launch a hop for all of
    them); else each tensor shard's blocks gathered over ``sequence`` on
    its first block's device, attention on the whole sequence, and the
    output cut back into blocks."""
    n = len(q[0])
    if use_ring and use_kernels:
        if g == 0:
            b, h, s, d = k[0][0].shape
            shape = (b * lay.dp, h * lay.tp, s * n, d)
            _emit_ring_attention_kv(shape, shape, k[0][0].dtype, n)
        return ring_attention_shards(q, k, v, causal=True)
    outs = []
    for qt, kt, vt in zip(q, k, v):
        devs = [x.device for x in qt]
        qw, kw, vw = (concat_parts(x, 2) for x in (qt, kt, vt))
        if use_kernels:
            o = flash_attention(qw, kw, vw, causal=True)
        else:
            rep = qw.shape[1] // kw.shape[1]
            o = attention_reference(qw, _repeat_kv(kw, rep),
                                    _repeat_kv(vw, rep), causal=True)
        outs.append([c.to(dev) for c, dev in zip(o.chunk(n, dim=2), devs)])
    return outs


def mesh_attention(xs, layer, config: LlamaConfig, cos, sin,
                   use_kernels: bool, lay: Layout, g: int,
                   use_ring: bool = False) -> list:
    """Group ``g``'s attention block over its token blocks ``xs`` (block
    j on its home device, positions ``[j S / n, (j + 1) S / n)``): the norm
    per block, then each tensor shard's QKV product on its kv-head groups
    with rope at the block's positions, causal attention on its heads over
    the group's whole sequence (:func:`_mesh_attend`), and its row block of
    ``wo``; the psum over ``tensor`` (f32) adds the partial projections
    before each block's residual."""
    norm = rmsnorm if use_kernels else rmsnorm_reference
    span = xs[0].shape[1]
    xns = [norm(x, layer["ln_attn"].to(x.device), config.norm_eps)
           for x in xs]
    q, k, v = ([[None] * len(xs) for _ in range(lay.tp)] for _ in range(3))
    for t in range(lay.tp):
        for j, xn in enumerate(xns):
            dev = lay.device(g, t, j=j)
            xt = xn.to(dev)
            c_ = cos[j * span:(j + 1) * span].to(dev)
            s_ = sin[j * span:(j + 1) * span].to(dev)
            wqkv = lay.weight(layer["wqkv"], g, t, j)
            int8 = isinstance(wqkv, QuantTensor)
            if int8:
                q[t][j], k[t][j], v[t][j] = project_qkv(
                    xt, {"wqkv": wqkv}, config, c_, s_,
                    use_kernels=use_kernels)
            else:
                q[t][j], k[t][j], v[t][j] = qkv_site(xt, wqkv, c_, s_)
    o = _mesh_attend(q, k, v, use_kernels, lay, g, use_ring)
    out = []
    for j, x in enumerate(xs):
        parts = []
        for t in range(lay.tp):
            wo = lay.weight(layer["wo"], g, t, j)
            if int8:
                b, _, s, _ = o[t][j].shape
                flat = o[t][j].transpose(1, 2).reshape(b, s, -1).to(x.dtype)
                parts.append(q_matmul(flat, wo, use_kernels).float())
            else:
                parts.append(attn_proj_site(o[t][j].to(x.dtype), wo).float())
        out.append(x + sum_parts(parts, x.device).to(x.dtype))
    return out


def mesh_mlp(x, layer, config: LlamaConfig, use_kernels: bool,
             lay: Layout, g: int, j: int = 0):
    """Token block ``(g, j)``'s SwiGLU MLP: each tensor shard's gate and up
    columns (two products on the strided halves of its [H, 2, M / tensor]
    block, no weight copy), SwiGLU, and its row block of ``w_down``; the
    psum over ``tensor`` (f32) before the residual."""
    norm = rmsnorm if use_kernels else rmsnorm_reference
    xn = norm(x, layer["ln_mlp"].to(x.device), config.norm_eps)
    parts = []
    for t in range(lay.tp):
        xt = xn.to(lay.device(g, t, j=j))
        w_gu = lay.weight(layer["w_gateup"], g, t, j)
        gate = q_matmul(xt, _half(w_gu, 0), use_kernels)
        up = q_matmul(xt, _half(w_gu, 1), use_kernels)
        prod = (F.silu(gate.float()) * up.float()).to(x.dtype)
        parts.append(q_matmul(prod, lay.weight(layer["w_down"], g, t, j),
                              use_kernels).float())
    return x + sum_parts(parts, x.device).to(x.dtype)


def _mesh_block(xs, layer, config: LlamaConfig, cos, sin, use_kernels: bool,
                lay: Layout, g: int, use_ring: bool = False):
    """One layer of group ``g`` over its token blocks ``xs``."""
    xs = mesh_attention(xs, layer, config, cos, sin, use_kernels, lay, g,
                        use_ring)
    return [mesh_mlp(x, layer, config, use_kernels, lay, g, j)
            for j, x in enumerate(xs)], None


def mesh_trunk(params: dict, tokens: torch.Tensor, config: LlamaConfig,
               mesh, specs: dict, block, remat: bool, remat_policy: str,
               use_kernels: bool, use_ring: bool = False):
    """The layers on ``mesh``: ``(layout, placed params, per group the
    normed final hidden states of its token blocks, per-layer lists of the
    groups' second outputs)``. ``block(xs, layer, config, cos, sin,
    use_kernels, layout, g, use_ring=)`` runs one layer of group ``g``
    over the list of its token blocks and returns ``(blocks, extra)``;
    remat wraps each (layer, group)."""
    c = config
    check_heads(c, mesh)
    lay = Layout(mesh)
    params = place(params, mesh, specs)
    toks = lay.blocks(tokens)
    s = tokens.shape[1]
    cos, sin = rope_frequencies(c.head_dim, s, c.rope_theta,
                                device=lay.home(0))
    block = _remat_transform(remat, remat_policy)(
        functools.partial(block, use_ring=use_ring))
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    xs = [[mesh_embed(params["embed"], tok, lay, g, c.dtype, j)
           for j, tok in enumerate(toks[g])] for g in range(lay.dp)]
    extras = []
    for i in range(c.n_layers):
        layer = {name: ws[i] for name, ws in layers.items()}
        out = [block(xs[g], layer, c, cos, sin, use_kernels, lay, g)
               for g in range(lay.dp)]
        xs = [o[0] for o in out]
        extras.append([o[1] for o in out])
    norm = rmsnorm if use_kernels else rmsnorm_reference
    xs = [[norm(x, params["final_norm"].to(x.device), c.norm_eps)
           for x in blocks] for blocks in xs]
    return lay, params, xs, extras


def mesh_gather(lay: Layout, xs: list) -> torch.Tensor:
    """Every group's token blocks as one ``[B, S, ...]`` tensor on the
    mesh's first device: blocks along the sequence, groups along the
    rows."""
    return concat_parts([concat_parts(blocks, 1, lay.home(g))
                         for g, blocks in enumerate(xs)], 0, lay.home(0))


def forward(
    params: dict,
    tokens: torch.Tensor,               # [B, S] int
    config: LlamaConfig,
    remat: bool = False,
    return_hidden: bool = False,
    remat_policy: str = "full",
    use_kernels: bool = True,
    mesh=None,
    use_ring: bool = False,
) -> torch.Tensor:
    """Causal LM forward -> logits [B, S, V] (f32), or the final hidden
    states [B, S, H] when ``return_hidden`` (the loss projects to vocab
    chunkwise instead). ``use_ring`` runs ring attention over the mesh's
    sequence axis (without a mesh it changes nothing, as in the
    reference).

    Each stacked weight is unbound once into per-layer views, so its
    gradient is stacked once in the backward instead of being scattered
    into a zero tensor of the whole stack per layer. On a ``mesh`` the
    layers run per batch group and tensor shard (:func:`mesh_trunk`) with
    ``params`` whole or placed by :func:`param_specs`; the result is
    gathered on the mesh's first device."""
    c = config
    if mesh is not None:
        lay, placed, xs, _ = mesh_trunk(
            params, tokens, c, mesh, param_specs(c), _mesh_block, remat,
            remat_policy, use_kernels, use_ring)
        if not return_hidden:
            xs = [[mesh_logits(x, mesh_heads(placed["lm_head"], lay, g, j),
                               use_kernels) for j, x in enumerate(blocks)]
                  for g, blocks in enumerate(xs)]
        return mesh_gather(lay, xs)
    s = tokens.shape[1]
    x = q_lookup(params["embed"], tokens, c.dtype)      # [B, S, H]
    cos, sin = rope_frequencies(c.head_dim, s, c.rope_theta,
                                device=tokens.device)
    block = _remat_transform(remat, remat_policy)(_block)
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(c.n_layers):
        layer = {name: ws[i] for name, ws in layers.items()}
        x = block(x, layer, c, cos, sin, use_kernels)
    norm = rmsnorm if use_kernels else rmsnorm_reference
    x = norm(x, params["final_norm"], c.norm_eps)
    if return_hidden:
        return x
    return q_matmul(x, params["lm_head"], use_kernels).float()


def _ce_chunk(x, lm_head, t):
    if isinstance(lm_head, (list, tuple)):
        logits = mesh_logits(x, lm_head)            # [B, chunk, V] f32
    else:
        logits = (x @ lm_head).float()              # [B, chunk, V]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    return (logz - gold).sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,               # [B, S, H]
    lm_head,                            # [H, V], or its vocab blocks
    targets: torch.Tensor,              # [B, S]
    chunk: int | None = None,
) -> torch.Tensor:
    """Next-token CE (mean over tokens) without a [B, S, V] logits slab:
    each sequence chunk's projection is checkpointed, so one
    [B, chunk, V] slab lives in the forward and in the backward
    (recomputed). Default chunk: ``max(128, 8192 // B)`` on the card, 256
    on the CPU; it shrinks to the largest divisor of S not above it.
    ``lm_head`` may be a list of vocab-cut blocks (a tensor-parallel
    head): each chunk's logits are their products gathered."""
    b, s, _ = hidden.shape
    if chunk is None:
        chunk = max(128, 8192 // max(b, 1)) if hidden.is_cuda else 256
    if s % chunk:
        chunk = next(c for c in range(min(chunk, s), 0, -1) if s % c == 0)
    targets = targets.long()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for x, t in zip(hidden.split(chunk, dim=1), targets.split(chunk, dim=1)):
        total = total + checkpoint(_ce_chunk, x, lm_head, t,
                                   use_reentrant=False)
    return total / (b * s)


def mesh_cross_entropy(lay: Layout, placed: dict, xs: list,
                       targets: torch.Tensor) -> torch.Tensor:
    """The mean next-token CE over every token block: each block's
    chunked CE against its head blocks, weighted by its share of the
    tokens (``1 / (dp * sequence)``), summed on the mesh's first
    device."""
    tg = lay.blocks(targets)
    home = lay.home(0)
    total = None
    for g, blocks in enumerate(xs):
        for j, x in enumerate(blocks):
            ce = chunked_cross_entropy(
                x, mesh_heads(placed["lm_head"], lay, g, j),
                tg[g][j]).to(home) / (lay.dp * lay.sp)
            total = ce if total is None else total + ce
    return total


def loss_fn(
    params: dict,
    tokens: torch.Tensor,               # [B, S+1]: inputs + shifted targets
    config: LlamaConfig,
    remat: bool = True,
    remat_policy: str = "full",
    use_kernels: bool = True,
    mesh=None,
    use_ring: bool = False,
) -> torch.Tensor:
    """Next-token cross-entropy (mean over tokens). On a ``mesh``
    (:func:`forward`, ``use_ring`` too) the gradient reaches the leaves of
    ``params`` whether they are whole or placed."""
    if mesh is not None:
        lay, placed, xs, _ = mesh_trunk(
            params, tokens[:, :-1], config, mesh, param_specs(config),
            _mesh_block, remat, remat_policy, use_kernels, use_ring)
        return mesh_cross_entropy(lay, placed, xs, tokens[:, 1:])
    hidden = forward(params, tokens[:, :-1], config, remat=remat,
                     return_hidden=True, remat_policy=remat_policy,
                     use_kernels=use_kernels)
    return chunked_cross_entropy(hidden, params["lm_head"], tokens[:, 1:])


# ---------------------------------------------------------------------------
# The pipelined forward (parallel/pipeline.py): the layers split into
# contiguous stages over the mesh's pipe axis, each stage's layers run
# through the mesh block on its own sub-mesh.
# ---------------------------------------------------------------------------


def stage_mesh(mesh, p: int):
    """Stage ``p``'s shards: the sub-mesh at pipe ``p`` (and sequence 0:
    a stage runs its microbatch whole, the sequence replicas computing the
    same thing, as the reference's pipeline shard_map leaves them)."""
    sub = mesh.sub("pipe", p)
    return sub.sub("sequence", 0) if sub.shape["sequence"] > 1 else sub


def pipeline_stages(config: LlamaConfig, mesh, block, layer_specs: dict,
                    remat: bool, cos, sin):
    """``(stage_fn, layouts)`` for ``parallel.pipeline.pipeline(...,
    with_coords=True)``: ``stage_fn(stage_layers, x_mb, p, g)`` places
    stage p's layer stack views on its sub-mesh (``shard_pytree``, views
    on one card: the gradients reach the whole stack) and runs them
    through ``block`` for batch group g, each layer under remat "full"
    with ``remat``. ``block(xs, layer, config, cos, sin, use_kernels,
    layout, g)`` returns ``(blocks, extra)``; the stage function returns
    ``(x, extras)``."""
    subs = [stage_mesh(mesh, p) for p in range(mesh.shape["pipe"])]
    lays = [Layout(sub, "a pipeline stage") for sub in subs]
    block = _remat_transform(remat, "full")(block)
    int8_specs = quantize_specs(
        {"embed": P(), "lm_head": P(), "layers": layer_specs})["layers"]

    def stage_fn(stage_layers, x_mb, p, g):
        int8 = isinstance(stage_layers["wqkv"], QuantTensor)
        placed = shard_pytree(stage_layers, subs[p],
                              int8_specs if int8 else layer_specs)
        per = {name: w.unbind(0) for name, w in placed.items()}
        c_, s_ = cos.to(x_mb.device), sin.to(x_mb.device)
        xs, extras = [x_mb], []
        for i in range(len(per["wqkv"])):
            layer = {name: ws[i] for name, ws in per.items()}
            xs, extra = block(xs, layer, config, c_, s_, True, lays[p], g)
            extras.append(extra)
        return xs[0], extras

    return stage_fn, lays


def forward_pipelined(
    params: dict,
    tokens: torch.Tensor,               # [B, S] int
    config: LlamaConfig,
    mesh,
    n_microbatches: int,
    return_hidden: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """Causal LM forward with the layers run as a GPipe pipeline over the
    mesh's ``pipe`` axis (``parallel/pipeline.py``): contiguous stages of
    L / P layers, microbatches handed stage to stage by K9. The embedding
    and the LM head stay outside the pipeline, on the mesh's first
    device; inside, each stage runs its layers through the mesh block on
    its sub-mesh, so data, fsdp and tensor compose with pipe. ``remat``
    (not in the reference) recomputes each layer of a stage ("full").
    Returns logits [B, S, V] f32, or the final hidden states with
    ``return_hidden``."""
    from ..parallel.pipeline import pipeline, stage_params

    c = config
    check_heads(c, mesh)
    home = mesh.devices[0]
    s = tokens.shape[1]
    x = q_lookup(params["embed"], tokens.to(home), c.dtype)
    cos, sin = rope_frequencies(c.head_dim, s, c.rope_theta, device=home)
    staged = stage_params(params["layers"], mesh.shape["pipe"])
    stage_fn, _ = pipeline_stages(c, mesh, _mesh_block,
                                  param_specs(c)["layers"], remat, cos, sin)
    x = pipeline(lambda *a: stage_fn(*a)[0], staged, x, mesh=mesh,
                 n_microbatches=n_microbatches, with_coords=True)
    x = rmsnorm(x, params["final_norm"].to(home), c.norm_eps)
    if return_hidden:
        return x
    return q_matmul(x, params["lm_head"].to(home)).float()
