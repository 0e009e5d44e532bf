"""Llama-3 serving on the paged KV cache: configuration and parameters,
the cached forward, and the continuous-batching engine."""

from .convert import params_from_numpy
from .decode import decode_step, generate, prefill, prefill_cached
from .llama import PRESETS, LlamaConfig, init_params
from .paged import BlockAllocator, OutOfBlocksError, PagedKVCache, PrefixCache
from .serving import (
    AdmissionClosedError,
    DecodeEngine,
    Request,
    ServingStats,
)

__all__ = [
    "LlamaConfig",
    "PRESETS",
    "init_params",
    "params_from_numpy",
    "PagedKVCache",
    "BlockAllocator",
    "OutOfBlocksError",
    "PrefixCache",
    "prefill",
    "prefill_cached",
    "decode_step",
    "generate",
    "AdmissionClosedError",
    "DecodeEngine",
    "Request",
    "ServingStats",
]
