"""Llama-3 on the card: configuration and parameters, serving on the paged
KV cache (the cached forward, greedy speculative decoding and the
continuous-batching engine, for dense and Mixtral-style MoE configs, with
int8 weights and an int8 KV cache as options, and MoE expert parallel on a
mesh), and training of both
(forward, loss, optimizer and train step, the named remat policies) with
train-state checkpoints. ``compute_telemetry`` observes the engine's
builds, roofline and HBM footprint."""

from . import moe
from .checkpoint import (
    MeshShapeMismatchError,
    latest_step,
    restore_checkpoint,
    restore_template,
    save_checkpoint,
)
from .convert import params_from_numpy
from .decode import decode_step, generate, prefill, prefill_cached
from .llama import (
    PRESETS,
    REMAT_POLICIES,
    LlamaConfig,
    chunked_cross_entropy,
    forward,
    init_params,
    loss_fn,
)
from .moe import MOE_PRESETS, MoeConfig
from .paged import (
    BlockAllocator,
    OutOfBlocksError,
    PagedKVCache,
    PagedQuantKVCache,
    PrefixCache,
)
from .quant import QuantTensor, quantize_params, quantize_specs
from .speculative import speculative_generate
from .serving import (
    AdmissionClosedError,
    DecodeEngine,
    Request,
    ServingStats,
)
from .train import (
    AdamW,
    TrainState,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    train_state_from_params,
)

__all__ = [
    "LlamaConfig",
    "PRESETS",
    "init_params",
    "params_from_numpy",
    "moe",
    "MoeConfig",
    "MOE_PRESETS",
    "PagedKVCache",
    "PagedQuantKVCache",
    "QuantTensor",
    "quantize_params",
    "quantize_specs",
    "BlockAllocator",
    "OutOfBlocksError",
    "PrefixCache",
    "prefill",
    "prefill_cached",
    "decode_step",
    "generate",
    "speculative_generate",
    "AdmissionClosedError",
    "DecodeEngine",
    "Request",
    "ServingStats",
    "REMAT_POLICIES",
    "forward",
    "chunked_cross_entropy",
    "loss_fn",
    "AdamW",
    "TrainState",
    "make_optimizer",
    "init_train_state",
    "train_state_from_params",
    "make_train_step",
    "make_eval_step",
    "save_checkpoint",
    "restore_checkpoint",
    "restore_template",
    "latest_step",
    "MeshShapeMismatchError",
]
