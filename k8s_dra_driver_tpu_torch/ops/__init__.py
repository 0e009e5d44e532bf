"""Ops of the serving path: paged attention and RMSNorm (hand-written
Hopper kernels with their plain PyTorch versions) and rotary embeddings."""

from .attention import (
    paged_attention_reference,
    paged_decode_attention,
    paged_prefill_attention,
)
from .norms import rmsnorm, rmsnorm_reference
from .rotary import apply_rope, rope_frequencies

__all__ = [
    "paged_attention_reference",
    "paged_decode_attention",
    "paged_prefill_attention",
    "rmsnorm",
    "rmsnorm_reference",
    "apply_rope",
    "rope_frequencies",
]
