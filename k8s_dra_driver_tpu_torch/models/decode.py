"""Inference over the paged KV cache: prefill and autoregressive decode.
Counterpart of ``k8s_dra_driver_tpu/models/decode.py``.

Every shape in a decode step is independent of sequence length: growing
sequences advance block-table entries and per-sequence lengths. The
reference's ``lax.scan`` over stacked pools becomes a layer loop over
per-layer views of the pools, which the forward pass updates in place.
Attention reads the pool through the block tables: the single-token
decode step goes to ``paged_decode_attention`` and multi-token windows to
``paged_prefill_attention``, each a CUDA kernel on the card and its plain
version on the CPU. The per-layer FFN follows the config's family
(:func:`_mlp_or_moe`): the dense SwiGLU MLP for a ``LlamaConfig``, the
sparse MoE block (``models/moe.py``, the fused dispatch kernels K7 and K8
on the card) for a ``MoeConfig``. Every entry point takes a ``mesh``
(``parallel/mesh.py``): the stack then runs per batch group and tensor
shard (``parallel/layout.py``, :func:`_mesh_forward_with_cache`), the
pools cut on kv heads by ``paged.cache_specs`` (each tensor shard reads
and writes its head range ``pool[l, h0:h1]`` of the whole pool in
place), block tables and lengths replicated, the MoE blocks through
``moe.moe_group`` (expert parallel on an expert axis).

The int8 variants follow the reference's (``variant_label``): int8
weights from ``quant.quantize_params`` run through the seams of
``models/quant.py`` and the int8 branches of K7 and K8, and the int8 KV
cache (``quantize_cache=True``, :class:`PagedQuantKVCache`) stores each
new k and v row as int8 with an f32 scale per position and head
(:func:`_quantize_kv`) and is read by the int8 branches of the paged
kernels.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops.attention import (
    paged_attention_reference,
    paged_decode_attention,
    paged_prefill_attention,
)
from ..ops.norms import rmsnorm, rmsnorm_reference
from ..ops.rotary import rope_frequencies
from ..parallel.collectives import concat_parts, sum_parts
from ..parallel.layout import Layout, check_heads
from ..parallel.sharding import shard_of
from . import llama, moe, step_graph
from .llama import (
    LlamaConfig,
    _mlp_block,
    attn_out,
    layer_params,
    mesh_embed,
    mesh_heads,
    mesh_logits,
    mesh_mlp,
    place,
    project_qkv,
)
from .moe import MoeConfig, _moe_block, moe_group
from .paged import (
    BlockAllocator,
    OutOfBlocksError,
    PagedKVCache,
    PagedQuantKVCache,
    PrefixCache,
    flat_write_positions,
    place_cache,
)
from .quant import QuantTensor, q_lookup, q_matmul, quantize_tensor

__all__ = [
    "PagedKVCache",
    "PagedQuantKVCache",
    "BlockAllocator",
    "OutOfBlocksError",
    "PrefixCache",
    "prefill",
    "prefill_cached",
    "decode_step",
    "generate",
    "TRACE_COUNTS",
    "TRACE_OBSERVERS",
]

#: The forward's programs per variant, keyed like the reference's trace
#: counter (``forward:<variant>:t<T>``). Under the engine on the card a
#: count is a capture (``models/step_graph.py``): each capture of a step
#: counts 1, as each trace does in the reference, and its warm-up runs
#: count nothing. An eager forward builds no program per shape, so it
#: counts a key once, the first time that shape runs; the set of keys
#: shows which shapes ran.
TRACE_COUNTS: "collections.Counter[str]" = collections.Counter()

#: Observers called with (program, variant, shape dict) wherever
#: ``TRACE_COUNTS`` counts. Empty by default.
TRACE_OBSERVERS: list = []

_ROPE_TABLES: dict = {}


def _require_supported(config) -> None:
    if not isinstance(config, LlamaConfig):
        raise NotImplementedError(
            f"{type(config).__name__}: only Llama configs (dense, or MoE "
            f"through MoeConfig) are ported"
        )


def variant_label(params: dict, cache) -> str:
    """``"bf16"`` | ``"int8"`` | ``"kvq"`` | ``"int8+kvq"``: the bench
    variant names (int8 weights, the int8 KV cache)."""
    wq = isinstance(params["layers"]["wqkv"], QuantTensor)
    cq = isinstance(cache, PagedQuantKVCache)
    return "+".join(n for n, on in (("int8", wq), ("kvq", cq)) if on) \
        or "bf16"


def _rope_tables(config: LlamaConfig, span: int, device):
    """cos/sin for ``span`` positions, built once per (span, device)."""
    key = (config.head_dim, span, config.rope_theta, str(device))
    tables = _ROPE_TABLES.get(key)
    if tables is None:
        tables = rope_frequencies(
            config.head_dim, span, config.rope_theta, device=device
        )
        _ROPE_TABLES[key] = tables
    return tables


def _mlp_or_moe(x, layer, config, use_kernels: bool = True):
    """The per-layer FFN for the config's family on one device: sparse MoE
    routing for a ``MoeConfig`` (aux loss dropped -- inference), dense
    otherwise. The MoE impl follows ``resolve_moe_impl``: decode steps and
    prefill chunks of up to 512 tokens run dropless, which on the card is
    the fused dispatch pipeline (K7 then K8, once each per layer). On a
    mesh :func:`_mesh_forward_with_cache` runs ``moe.moe_group``."""
    if isinstance(config, MoeConfig):
        x, _aux = _moe_block(x, layer, config, use_kernels=use_kernels)
        return x
    return _mlp_block(x, layer, config, use_kernels=use_kernels)


def _quantize_kv(x: torch.Tensor):
    """[B, H, T, D] -> (int8 values, f32 scales [B, H, T]): symmetric
    per-vector quantization over D, the recipe of ``quantize_tensor``."""
    qt = quantize_tensor(x, axis=-1)
    return qt.q, qt.scale.squeeze(-1)


def _note_first_use(variant: str, b: int, t: int) -> None:
    key = f"forward:{variant}:t{t}"
    stage = step_graph.phase()
    if stage == "warmup" or (stage is None and key in TRACE_COUNTS):
        return
    TRACE_COUNTS[key] += 1
    for observer in TRACE_OBSERVERS:
        observer("forward", variant, {"batch": b, "tokens": t})


@torch.no_grad()
def _forward_with_cache(
    params: dict,
    tokens: torch.Tensor,          # [B, T] new tokens
    cache: "PagedKVCache | PagedQuantKVCache",
    config: LlamaConfig,
    positions: torch.Tensor,       # [T] shared or [B, T] per-sequence
    n_valid: torch.Tensor | None = None,   # [] or [B] real tokens per row
    active: torch.Tensor | None = None,    # [B] bool: rows allowed to write
    use_kernels: bool = True,
    mesh=None,
) -> "tuple[torch.Tensor, PagedKVCache | PagedQuantKVCache]":
    """Run the stack over new tokens, reading and writing the paged cache
    (its pools in place; an int8 cache gets int8 rows and their scales).
    Returns (logits [B, T, V] f32, cache with new lengths).

    ``n_valid`` marks the first n columns of a right-padded chunk as real;
    padded columns and rows not ``active`` write only to the scratch row
    and do not advance lengths. ``use_kernels=False`` calls the plain
    versions of the ops even on CUDA tensors -- the comparison the card
    smoke test makes; on CPU tensors both settings run the plain ops."""
    c = config
    _require_supported(c)
    b, t = tokens.shape
    bs = cache.block_size
    scale = c.head_dim ** -0.5
    quantized = isinstance(cache, PagedQuantKVCache)
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, t)
    positions = positions.long()
    _note_first_use(variant_label(params, cache), b, t)
    # Padded columns may sit past the table; their writes go to the
    # scratch row and their outputs are discarded, but the gather must
    # stay in range.
    rope_pos = positions.clamp(0, cache.max_len - 1)
    valid = None
    if n_valid is not None:
        valid = (
            torch.arange(t, device=tokens.device)[None, :]
            < n_valid.reshape(-1, 1)
        ).expand(b, t)
    if active is not None:
        valid = active[:, None] if valid is None else valid & active[:, None]
    flat = flat_write_positions(
        cache.block_tables, positions, bs, cache.scratch_row, valid=valid
    )                                                   # [B, T]
    # At query position p the row written this step is p itself, so the
    # decode kernel's visible prefix is p + 1.
    vlen = (rope_pos[:, -1] + 1).to(torch.int32)
    norm = rmsnorm if use_kernels else rmsnorm_reference

    if mesh is not None:
        logits, cache = _mesh_forward_with_cache(
            params, tokens, cache, c, rope_pos, flat, vlen, use_kernels,
            mesh)
    else:
        x = q_lookup(params["embed"], tokens, c.dtype)
        cos, sin = _rope_tables(c, cache.max_len, tokens.device)
        flat = flat.reshape(-1)                         # [B*T]
        for i in range(c.n_layers):
            layer = layer_params(params, i)
            xn = norm(x, layer["ln_attn"], c.norm_eps)
            q, k, v = project_qkv(xn, layer, c, cos, sin, positions=rope_pos,
                                  use_kernels=use_kernels)
            scales = (dict(k_scale=cache.k_scale[i], v_scale=cache.v_scale[i])
                      if quantized else {})
            o = _attend(q, k, v, cache.k[i], cache.v[i], scales,
                        cache.block_tables, rope_pos, vlen, flat, bs, scale,
                        use_kernels)
            x = attn_out(x, o, layer, use_kernels)
            x = _mlp_or_moe(x, layer, c, use_kernels=use_kernels)
        x = norm(x, params["final_norm"], c.norm_eps)
        logits = q_matmul(x, params["lm_head"], use_kernels).float()

    # Committed length: last real position + 1, frozen for padded columns
    # and inactive rows.
    if n_valid is not None:
        new_len = positions[:, 0] + n_valid.long()
    else:
        new_len = positions[:, -1] + 1
    new_len = new_len.clamp(0, cache.max_len).to(torch.int32)
    if active is not None:
        new_len = torch.where(active, new_len, cache.lengths)
    return logits, dataclasses.replace(cache, lengths=new_len)


def _attend(q, k, v, k_pool, v_pool, scales, tables, rope_pos, vlen, flat,
            bs: int, scale: float, use_kernels: bool):
    """Write this step's k and v rows into the pools (an int8 cache:
    their int8 rows and scales) and attend over them: K2 for one token,
    K3 for a window, the plain version with ``use_kernels=False``."""
    b, hkv, t, d = k.shape
    if scales:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales["k_scale"].index_copy_(
            1, flat, ks.transpose(0, 1).reshape(hkv, b * t))
        scales["v_scale"].index_copy_(
            1, flat, vs.transpose(0, 1).reshape(hkv, b * t))
    k_pool.index_copy_(
        1, flat, k.transpose(0, 1).reshape(hkv, b * t, d).to(k_pool.dtype))
    v_pool.index_copy_(
        1, flat, v.transpose(0, 1).reshape(hkv, b * t, d).to(v_pool.dtype))
    if not use_kernels:
        return paged_attention_reference(q, k_pool, v_pool, tables, rope_pos,
                                         bs, scale, **scales)
    if t == 1:
        return paged_decode_attention(q[:, :, 0, :], k_pool, v_pool, tables,
                                      vlen, bs, scale, **scales)[:, :, None, :]
    return paged_prefill_attention(q, k_pool, v_pool, tables, rope_pos, bs,
                                   scale, **scales)


def _mesh_forward_with_cache(params, tokens, cache, config, rope_pos, flat,
                             vlen, use_kernels: bool, mesh):
    """:func:`_forward_with_cache`'s layers on a mesh, from its write plan
    (``flat`` [B, T] pool rows, ``vlen``, ``rope_pos``): ``(logits, the
    cache placed on the mesh)``. The batch rows split into
    the data x fsdp groups; in each layer every group's tensor shard
    projects q/k/v for its kv-head groups, writes and reads its head
    range of the pools (K2 / K3, or their int8 forms, on the contiguous
    view ``pool[l, h0:h1]``) with the group's rows of the replicated
    block tables, and projects through its row block of ``wo``; the psum
    over ``tensor`` adds the partial projections. The FFN is
    ``llama.mesh_mlp`` or ``moe.moe_group``; the logits are each group's
    vocab blocks gathered, the groups concatenated on the mesh's first
    device."""
    c = config
    b, t = tokens.shape
    bs = cache.block_size
    scale = c.head_dim ** -0.5
    quantized = isinstance(cache, PagedQuantKVCache)
    check_heads(c, mesh)
    lay = Layout(mesh, "the cached forward")
    n = lay.rows(b)
    specs = (moe.param_specs if isinstance(c, MoeConfig)
             else llama.param_specs)(c)
    params = place(params, mesh, specs)
    cache = place_cache(cache, mesh)
    home = tokens.device
    cos, sin = _rope_tables(c, cache.max_len, home)
    norm = rmsnorm if use_kernels else rmsnorm_reference
    rows = [slice(g * n, (g + 1) * n) for g in range(lay.dp)]
    # Per (group, tensor shard): its device's copy of the group's row
    # bookkeeping (views where the device is the controller's).
    book = {}
    for g, r in enumerate(rows):
        for s in range(lay.tp):
            dev = lay.device(g, s)
            book[g, s] = (cos.to(dev), sin.to(dev), rope_pos[r].to(dev),
                          cache.block_tables[r].to(dev), vlen[r].to(dev),
                          flat[r].reshape(-1).to(dev))
    xs = [mesh_embed(params["embed"], tokens[r], lay, g, c.dtype)
          for g, r in enumerate(rows)]
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(c.n_layers):
        layer = {name: ws[i] for name, ws in layers.items()}
        for g in range(lay.dp):
            x = xs[g]
            xn = norm(x, layer["ln_attn"].to(x.device), c.norm_eps)
            parts = []
            for s in range(lay.tp):
                j = lay.shard(g, s)
                cs, sn, pos, tables, vl, fl = book[g, s]
                q, k, v = project_qkv(
                    xn.to(cs.device),
                    {"wqkv": lay.weight(layer["wqkv"], g, s)}, c, cs, sn,
                    positions=pos, use_kernels=use_kernels)
                scales = {}
                if quantized:
                    scales = dict(k_scale=shard_of(cache.k_scale, mesh, j)[i],
                                  v_scale=shard_of(cache.v_scale, mesh, j)[i])
                o = _attend(q, k, v, shard_of(cache.k, mesh, j)[i],
                            shard_of(cache.v, mesh, j)[i], scales, tables,
                            pos, vl, fl, bs, scale, use_kernels)
                flat_o = o.transpose(1, 2).reshape(n, t, -1).to(x.dtype)
                parts.append(q_matmul(flat_o, lay.weight(layer["wo"], g, s),
                                      use_kernels).float())
            x = x + sum_parts(parts, x.device).to(x.dtype)
            if isinstance(c, MoeConfig):
                x = moe_group(x, layer, c, lay, g, use_kernels)[0]
            else:
                x = mesh_mlp(x, layer, c, use_kernels, lay, g)
            xs[g] = x
    logits = [mesh_logits(norm(x, params["final_norm"].to(x.device),
                               c.norm_eps),
                          mesh_heads(params["lm_head"], lay, g), use_kernels)
              for g, x in enumerate(xs)]
    return concat_parts(logits, 0, home), cache


def _as_tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(tokens, np.int32), device=device)


def _param_device(params: dict) -> torch.device:
    return params["embed"].device


def prefill(
    params: dict,
    tokens: torch.Tensor,          # [B, S] prompt
    config: LlamaConfig,
    max_len: int,
    quantize_cache: bool = False,
    block_size: int | None = None,
    mesh=None,
) -> "tuple[torch.Tensor, PagedKVCache | PagedQuantKVCache]":
    """Process the prompt into a fixed-reservation paged cache (int8 with
    per-position scales when ``quantize_cache``); returns (last-position
    logits [B, V], cache)."""
    dev = _param_device(params)
    tokens = _as_tokens(tokens, dev)
    b, s = tokens.shape
    cache_cls = PagedQuantKVCache if quantize_cache else PagedKVCache
    cache = cache_cls.init(config, b, max_len, block_size=block_size,
                           device=dev)
    if mesh is not None:
        cache = place_cache(cache, mesh)
    positions = torch.arange(s, device=dev)
    logits, cache = _forward_with_cache(params, tokens, cache, config,
                                        positions, mesh=mesh)
    return logits[:, -1], cache


def prefill_cached(
    params: dict,
    prompt,                        # sequence of int token ids (one request)
    config: LlamaConfig,
    max_len: int,
    pools: tuple,                  # shared (k, v) or (k, v, k_scale,
                                   # v_scale) pools (paged._init_pools)
    allocator: BlockAllocator,
    block_size: int,
    prefix_cache: "PrefixCache | None" = None,
    quantize_cache: bool = False,
    mesh=None,
):
    """Single-sequence prefill over a caller-owned shared pool, reusing
    the prefix cache; a fully cached prompt drops its trailing matched
    block and recomputes it (copy-on-write by recompute). Returns
    ``(last_logits [1, V], cache, blocks, hit_tokens)``; release with
    ``allocator.free(blocks)``."""
    prompt = [int(t) for t in prompt]
    s = len(prompt)
    if not 0 < s < max_len:
        raise ValueError(
            f"prompt of {s} tokens needs 0 < len < max_len={max_len}"
        )
    bs = block_size
    nbps = -(-max_len // bs)
    hit: list[int] = []
    if prefix_cache is not None:
        hit = prefix_cache.lookup(prompt)[:nbps]
        if hit and len(hit) * bs >= s:
            hit = hit[:-1]
    hit_tokens = len(hit) * bs
    allocator.share(hit)
    try:
        fresh = allocator.alloc(nbps - len(hit))
    except OutOfBlocksError:
        allocator.free(hit)
        raise
    blocks = list(hit) + fresh
    dev = pools[0].device
    tables = torch.tensor([blocks], dtype=torch.int32, device=dev)
    lengths = torch.tensor([hit_tokens], dtype=torch.int32, device=dev)
    if quantize_cache:
        k, v, ks, vs = pools
        cache = PagedQuantKVCache(k=k, k_scale=ks, v=v, v_scale=vs,
                                  block_tables=tables, lengths=lengths,
                                  block_size=bs)
    else:
        k, v = pools
        cache = PagedKVCache(k=k, v=v, block_tables=tables, lengths=lengths,
                             block_size=bs)
    tail = torch.tensor([prompt[hit_tokens:]], dtype=torch.int32, device=dev)
    positions = hit_tokens + torch.arange(s - hit_tokens, device=dev)
    logits, cache = _forward_with_cache(params, tail, cache, config,
                                        positions, mesh=mesh)
    return logits[:, -1], cache, blocks, hit_tokens


def decode_step(
    params: dict,
    token: torch.Tensor,          # [B] latest token
    cache: "PagedKVCache | PagedQuantKVCache",
    config: LlamaConfig,
    mesh=None,
) -> "tuple[torch.Tensor, PagedKVCache | PagedQuantKVCache]":
    """One autoregressive step; returns (next-token logits [B, V], cache)."""
    positions = cache.lengths[:, None]
    logits, cache = _forward_with_cache(params, token[:, None], cache,
                                        config, positions, mesh=mesh)
    return logits[:, 0], cache


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy argmax at temperature 0, else a draw from softmax(logits/T)
    with ``generator`` (its stream differs from JAX's by design).

    The draw is ``torch.multinomial``'s own for one sample, the argmax of
    probs over exponential noise (the same numbers from the same
    generator), written out because ``multinomial`` first checks its
    input on the host, which a captured step cannot do."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / noise).argmax(dim=-1).to(torch.int32)


def generate(
    params: dict,
    prompt,                        # [B, S] int tokens
    config: LlamaConfig,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    quantize_cache: bool = False,
    device=None,
    mesh=None,
) -> torch.Tensor:
    """Greedy (or sampled) generation; returns [B, S + N] int32 tokens on
    ``device`` (default CUDA), where ``params`` must already live."""
    dev = resolve_device(device)
    if _param_device(params).type != dev.type:
        raise ValueError(
            f"params live on {_param_device(params)}, not on {dev}"
        )
    prompt = _as_tokens(prompt, _param_device(params))
    b, s = prompt.shape
    logits, cache = prefill(params, prompt, config, s + max_new_tokens,
                            quantize_cache=quantize_cache, mesh=mesh)
    out = []
    for i in range(max_new_tokens):
        tok = sample(logits, temperature, generator)
        out.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, tok, cache, config,
                                        mesh=mesh)
    if not out:
        return prompt
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
