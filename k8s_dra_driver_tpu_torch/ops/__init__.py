"""Ops of the serving and training paths: paged and flash attention, the
fused MoE dispatch pipeline and its grouped matmuls, the int8-weight
matmul, and RMSNorm (hand-written Hopper kernels with their plain PyTorch
versions) and rotary embeddings. ``LAUNCH_COUNTERS`` also lists K9's
twin, the ring hop of ``parallel/ring.py``."""

from .attention import (
    flash_site,
    attention_impl_label,
    attention_reference,
    flash_attention,
    flash_attention_backward,
    flash_attention_forward,
    flash_bwd_dkdv,
    flash_bwd_dq,
    flash_fwd,
    paged_attention_reference,
    paged_decode_attention,
    paged_decode_int8,
    paged_prefill_attention,
    paged_prefill_impl_label,
    paged_prefill_int8,
    set_attention_impl,
)
from . import moe_dispatch
from .moe_dispatch import (
    DispatchPlan,
    FusedMoeMlpFunction,
    GroupedMatmulFunction,
    build_plan,
    fused_moe_mlp,
    grouped_matmul,
    grouped_matmul_label,
    grouped_matmul_reference,
    grouped_weight_grad,
    grouped_weight_grad_reference,
    moe_down_combine,
    moe_down_combine_int8,
    moe_down_combine_reference,
    moe_gateup,
    moe_gateup_int8,
    moe_gateup_reference,
    reference_moe_mlp,
)
from .norms import (
    RMSNormFunction,
    rmsnorm,
    rmsnorm_backward,
    rmsnorm_backward_reference,
    rmsnorm_reference,
)
from .quant_matmul import int8_matmul, int8_matmul_reference
from .rotary import apply_rope, rope_frequencies
from ..parallel.ring import ring_permute_kernel

#: Every launch counter of the kernels' wrappers, as (wrapper, attribute).
#: A wrapper adds to its counter in Python where it launches, so under a
#: CUDA graph it counts the capture only; ``models/step_graph.py`` reads
#: these to add a captured step's launches on each replay.
LAUNCH_COUNTERS = (
    (paged_decode_attention, "launches"),
    (paged_decode_int8, "launches"),
    (paged_prefill_attention, "launches"),
    (paged_prefill_int8, "launches"),
    (flash_fwd, "launches"),
    (flash_bwd_dkdv, "launches"),
    (flash_bwd_dq, "launches"),
    (moe_gateup, "launches"),
    (moe_gateup_int8, "launches"),
    (moe_down_combine, "launches"),
    (moe_down_combine_int8, "launches"),
    (grouped_matmul, "launches"),
    (grouped_weight_grad, "launches"),
    (rmsnorm, "launches"),
    (rmsnorm_backward, "launches"),
    (ring_permute_kernel, "launches"),
    (int8_matmul, "launches"),
    (int8_matmul, "wide_launches"),
    (int8_matmul, "wide_prologue_launches"),
)

__all__ = [
    "LAUNCH_COUNTERS",
    "paged_attention_reference",
    "paged_decode_attention",
    "paged_prefill_attention",
    "paged_decode_int8",
    "paged_prefill_int8",
    "set_attention_impl",
    "attention_impl_label",
    "paged_prefill_impl_label",
    "attention_reference",
    "flash_attention",
    "flash_attention_forward",
    "flash_attention_backward",
    "flash_fwd",
    "flash_bwd_dkdv",
    "flash_bwd_dq",
    "flash_site",
    "moe_dispatch",
    "DispatchPlan",
    "build_plan",
    "fused_moe_mlp",
    "FusedMoeMlpFunction",
    "grouped_matmul",
    "grouped_matmul_label",
    "grouped_matmul_reference",
    "grouped_weight_grad",
    "grouped_weight_grad_reference",
    "GroupedMatmulFunction",
    "reference_moe_mlp",
    "moe_gateup",
    "moe_gateup_reference",
    "moe_down_combine",
    "moe_down_combine_int8",
    "moe_gateup_int8",
    "moe_down_combine_reference",
    "int8_matmul",
    "int8_matmul_reference",
    "rmsnorm",
    "rmsnorm_reference",
    "rmsnorm_backward",
    "rmsnorm_backward_reference",
    "RMSNormFunction",
    "apply_rope",
    "rope_frequencies",
    "ring_permute_kernel",
]
