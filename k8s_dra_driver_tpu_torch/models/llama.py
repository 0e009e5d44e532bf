"""Llama-3 family causal LM: configuration, parameters and the dense layer
pieces the serving path runs. Counterpart of
``k8s_dra_driver_tpu/models/llama.py`` (training -- ``forward``,
``loss_fn``, remat -- is not ported yet).

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
import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.norms import rmsnorm, rmsnorm_reference
from ..ops.rotary import apply_rope


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


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s weights as views into the stacked tensors."""
    return {name: w[i] for name, w in params["layers"].items()}


def project_qkv(
    xn: torch.Tensor,             # [B, T, H] (normed input)
    layer: dict,
    config: LlamaConfig,
    cos, sin,
    positions=None,
):
    """QKV projection + head split + rope. Returns q [B,Hq,T,D],
    k,v [B,Hkv,T,D]."""
    c = config
    b, t, h = xn.shape
    g = c.n_heads // c.n_kv_heads
    w = layer["wqkv"]                                   # [H, KV, G+2, D]
    qkv = (xn @ w.reshape(h, -1)).reshape(b, t, *w.shape[1:])
    q = qkv[..., :g, :].reshape(b, t, c.n_heads, c.head_dim)
    k = qkv[..., g, :]                                  # [B, T, KV, D]
    v = qkv[..., g + 1, :]
    q = apply_rope(q.transpose(1, 2), cos, sin, positions=positions)
    k = apply_rope(k.transpose(1, 2), cos, sin, positions=positions)
    return q, k, v.transpose(1, 2)


def attn_out(x: torch.Tensor, o: torch.Tensor, layer: dict) -> torch.Tensor:
    """Output projection + residual. o: [B, H, T, D] attention result."""
    b, _, t, _ = o.shape
    flat = o.transpose(1, 2).reshape(b, t, -1)
    return x + (flat.to(x.dtype) @ layer["wo"]).to(x.dtype)


def _mlp_block(x, layer, config: LlamaConfig, use_kernels: bool = True):
    """SwiGLU MLP + residual. ``use_kernels=False`` runs the plain RMSNorm
    even on CUDA tensors (the kernel-versus-plain comparison)."""
    norm = rmsnorm if use_kernels else rmsnorm_reference
    xn = norm(x, layer["ln_mlp"], config.norm_eps)
    w = layer["w_gateup"]                               # [H, 2, M]
    gu = (xn @ w.reshape(w.shape[0], -1)).reshape(*xn.shape[:-1], 2, -1)
    gate = F.silu(gu[..., 0, :].float())
    up = gu[..., 1, :].float()
    prod = (gate * up).to(x.dtype)
    return x + (prod @ layer["w_down"]).to(x.dtype)
