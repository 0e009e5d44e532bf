"""Rotary position embeddings (RoPE), the counterpart of
``k8s_dra_driver_tpu/ops/rotary.py``.

Plain PyTorch: RoPE is a cheap elementwise op between the QKV projection
and attention. Same split-half layout and f32 math as the reference.
"""

from __future__ import annotations

import torch

from .. import resolve_device


def rope_frequencies(
    head_dim: int,
    max_seq_len: int,
    theta: float = 500000.0,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [S, D/2]. theta=5e5 is the Llama-3 base."""
    dev = resolve_device(device)
    inv_freq = 1.0 / (
        theta ** (
            torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev)
            / head_dim
        )
    )
    t = torch.arange(max_seq_len, dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(
    x: torch.Tensor,           # [B, H, S, D]
    cos: torch.Tensor,         # [S, D/2] (or the whole table + positions)
    sin: torch.Tensor,
    positions: torch.Tensor | None = None,   # [S] shared or [B, S]
) -> torch.Tensor:
    if positions is not None and positions.dim() == 2:
        # Per-sequence positions: gather [B, S, D/2], broadcast over heads.
        cos = cos[positions.long()][:, None]
        sin = sin[positions.long()][:, None]
    else:
        if positions is not None:
            cos = cos[positions.long()]
            sin = sin[positions.long()]
        cos = cos[None, None]
        sin = sin[None, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
