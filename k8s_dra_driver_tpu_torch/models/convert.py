"""Parameters of the JAX package, converted for the port.

:func:`params_from_numpy` takes the JAX package's Llama parameter tree
after ``jax.tree.map(np.asarray, params)`` -- nested dicts of numpy arrays
with the same keys and layouts the port uses -- and returns the port's
parameter dict on ``device``. Both packages then compute the same
function. No JAX is imported here: the caller does the ``np.asarray``
step. Dense and MoE layer layouts both convert; the MoE router ``wr``
stays f32 whatever ``config.dtype`` is, as in the reference (rounding it
to bf16 would change expert choices). The reference's int8 tree (from its
``quantize_params``) converts too: a leaf with ``.q`` and ``.scale``
becomes the port's ``QuantTensor`` with int8 ``q`` and f32 ``scale``,
never cast to ``config.dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .llama import LlamaConfig
from .quant import QuantTensor

_LAYER_KEYS = ("wqkv", "wo", "w_gateup", "w_down", "ln_attn", "ln_mlp")
# MoE: the router, and w_gateup [L, E, H, 2, M] / w_down [L, E, M, H].
_MOE_LAYER_KEYS = ("wqkv", "wo", "wr", "w_gateup", "w_down", "ln_attn",
                   "ln_mlp")
_F32_KEYS = ("wr",)


def _tensor(a, dtype: torch.dtype, device: torch.device):
    if hasattr(a, "q") and hasattr(a, "scale"):
        # The reference's QuantTensor, duck typed (the port imports
        # nothing of the JAX package).
        return QuantTensor(q=_tensor(a.q, torch.int8, device),
                           scale=_tensor(a.scale, torch.float32, device))
    if not isinstance(a, np.ndarray):
        raise NotImplementedError(
            f"{type(a).__name__} leaf: only numpy arrays and int8 "
            f"QuantTensor leaves convert"
        )
    a = np.array(a)                     # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload.
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(params_np: dict, config: LlamaConfig,
                      device=None) -> dict:
    """The port's parameter dict from the reference's numpy tree, cast to
    ``config.dtype`` on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    layers = params_np["layers"]
    if set(layers) not in (set(_LAYER_KEYS), set(_MOE_LAYER_KEYS)):
        raise NotImplementedError(
            f"layer keys {sorted(layers)}: only the dense Llama layout "
            f"{list(_LAYER_KEYS)} and the MoE layout "
            f"{list(_MOE_LAYER_KEYS)} convert"
        )
    keys = _MOE_LAYER_KEYS if "wr" in layers else _LAYER_KEYS
    return {
        "embed": _tensor(params_np["embed"], config.dtype, dev),
        "layers": {
            k: _tensor(layers[k],
                       torch.float32 if k in _F32_KEYS else config.dtype, dev)
            for k in keys
        },
        "final_norm": _tensor(params_np["final_norm"], config.dtype, dev),
        "lm_head": _tensor(params_np["lm_head"], config.dtype, dev),
    }
