"""Weight-only int8 for serving. Counterpart of
``k8s_dra_driver_tpu/models/quant.py``.

- **Per-output-channel symmetric int8**: ``scale = amax / 127`` over the
  contraction axis, kept with ``keepdims`` so a per-layer slice of a
  stacked leaf slices ``q`` and ``scale`` together. :func:`quantize_tensor`
  gives the reference's int8 values and scales bit for bit (f32 amax,
  the same clamp and divide, round half to even).
- **The dense seams** (:func:`q_einsum`, :func:`q_matmul`): the weight
  stays int8 all the way into the product, as the reference's
  ``_mixed_dot`` keeps it: ``ops.int8_matmul`` (``csrc/quant_matmul.cu``)
  streams q as int8, sums in f32, multiplies the f32 sum by the
  per-column scale (constant over the contraction) and casts once. No
  bf16 copy of a weight is made. The kernel runs on CUDA tensors; its
  plain version (``(x.float() @ q.float()) * scale``) on the CPU or with
  ``use_kernels=False`` (the kernel-versus-plain comparison). An einsum
  pattern that is not "x's last axis against w's first" keeps a plain f32
  einsum, as the reference's ``preferred_element_type=f32`` does; no model
  pattern reaches it.
- **The einsum MoE body** (``models/moe.py``) runs its expert products
  through the same kernel's prologue mode (bf16(q * scale) staged tile by
  tile, the reference's :func:`q_dequant` rounding); :func:`q_dequant`
  stays as the reference's materialized form. The fused dispatch kernels
  read the expert stacks as int8 themselves (``ops/moe_dispatch.py``).
- :class:`QuantTensor` is a plain dataclass. It slices by its leading
  axis (``w[i]``, ``w.unbind(0)``), so the layer loops index quantized
  and float stacks alike.

:func:`quantize_specs` maps a float spec tree (``moe.param_specs``)
onto the quantized tree for ``parallel.sharding.shard_pytree``.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from ..ops.quant_matmul import int8_matmul, int8_matmul_reference
from ..parallel.sharding import P


@dataclasses.dataclass
class QuantTensor:
    """int8 weights + per-output-channel scales (same rank, keepdims)."""

    q: torch.Tensor       # int8, the weight's shape
    scale: torch.Tensor   # f32, the contraction axis collapsed to 1

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    def __getitem__(self, i) -> "QuantTensor":
        """The slice ``i`` of the leading (stacking) axis."""
        return QuantTensor(q=self.q[i], scale=self.scale[i])

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a QuantTensor unbinds only its leading axis")
        return [self[i] for i in range(self.q.shape[0])]

    def to(self, device) -> "QuantTensor":
        """Both fields moved to ``device``."""
        return QuantTensor(q=self.q.to(device), scale=self.scale.to(device))


def quantize_tensor(w: torch.Tensor, axis: int) -> QuantTensor:
    """Symmetric per-channel int8 over the contraction ``axis``."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QuantTensor(q=q, scale=scale)


def _quantize_sliced(w: torch.Tensor, axis: int) -> QuantTensor:
    """:func:`quantize_tensor` of a stacked leaf (rank 3 and up) one slice
    of the axes before ``axis`` at a time, into preallocated int8 and f32
    tensors: the same bits, with the f32 transient of one (layer, expert)
    slice instead of the whole stack. The embedding and the LM head
    (rank 2) quantize whole."""
    axis = axis % w.dim()
    if axis == 0 or w.dim() < 3:
        return quantize_tensor(w, axis)
    lead = w.shape[:axis]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(lead + (1,) + w.shape[axis + 1:],
                        dtype=torch.float32, device=w.device)
    for idx in itertools.product(*(range(n) for n in lead)):
        part = quantize_tensor(w[idx], 0)
        q[idx] = part.q
        scale[idx] = part.scale
    return QuantTensor(q=q, scale=scale)


# Contraction axes of the stacked weights (leading L is the layer axis,
# the reduction input follows). The MoE expert stacks carry an expert axis
# before the contraction; the router stays float.
_DENSE_AXES = {"wqkv": 1, "wo": 1, "w_gateup": 1, "w_down": 1}
_MOE_AXES = {"wqkv": 1, "wo": 1, "w_gateup": 2, "w_down": 2}


def _map_quant_tree(tree: dict, leaf_fn) -> dict:
    """Apply ``leaf_fn(value, contraction_axis)`` to every weight the int8
    path covers; norm gains and the MoE router stay untouched."""
    layers = tree["layers"]
    axes = _MOE_AXES if "wr" in layers else _DENSE_AXES
    qlayers = dict(layers)
    for name, axis in axes.items():
        qlayers[name] = leaf_fn(layers[name], axis)
    out = dict(tree)
    out["layers"] = qlayers
    out["embed"] = leaf_fn(tree["embed"], 1)     # per row
    out["lm_head"] = leaf_fn(tree["lm_head"], 0)
    return out


def quantize_params(params: dict) -> dict:
    """Quantize every large matmul weight of a Llama or MoE param dict."""
    return _map_quant_tree(params, _quantize_sliced)


def quantize_specs(specs: dict) -> dict:
    """A float spec tree mapped onto :func:`quantize_params`' tree: each
    quantized weight becomes a QuantTensor of specs, q keeping the
    weight's spec and the scale dropping the contraction axis's placement
    (a length-1 axis cannot be split). The same traversal as
    :func:`quantize_params`, so the two trees match."""

    def one(spec, axis):
        scale_spec = P(*[None if i == axis else s
                         for i, s in enumerate(spec)])
        return QuantTensor(q=spec, scale=scale_spec)

    return _map_quant_tree(specs, one)


# ---------------------------------------------------------------------------
# Compute seams: the float path unchanged, the int8 path scaled in f32.
# ---------------------------------------------------------------------------


def _contract(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x's last axis against w's first: [*x_batch, *w_out]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def _contract_int8(x: torch.Tensor, w: QuantTensor,
                   use_kernels: bool) -> torch.Tensor:
    """x's last axis against the int8 weight's first, the f32 sum scaled
    per output column and cast to x's dtype once: ``int8_matmul``, or its
    plain version with ``use_kernels=False``."""
    fn = int8_matmul if use_kernels else int8_matmul_reference
    k = w.q.shape[0]
    y = fn(x.reshape(-1, k).contiguous(), w.q.reshape(k, -1),
           w.scale.reshape(-1))
    return y.reshape(*x.shape[:-1], *w.q.shape[1:])


def q_einsum(pattern: str, x: torch.Tensor, w,
             use_kernels: bool = True) -> torch.Tensor:
    """``einsum(pattern, x, w)`` where w may be a QuantTensor. Every
    pattern the model uses contracts x's last axis with w's first; that
    runs as one matrix product (an int8 weight through ``int8_matmul``),
    anything else as ``torch.einsum`` (f32 for an int8 weight). The scale,
    constant over the contraction, multiplies the f32 product."""
    ins, out = pattern.split("->")
    xs, ws = ins.split(",")
    simple = xs[-1] == ws[0] and out == xs[:-1] + ws[1:]
    if not isinstance(w, QuantTensor):
        return _contract(x, w) if simple else torch.einsum(pattern, x, w)
    if simple:
        return _contract_int8(x, w, use_kernels)
    y = torch.einsum(pattern, x.float(), w.q.float())
    return (y * w.scale.squeeze(0)).to(x.dtype)


def q_matmul(x: torch.Tensor, w, use_kernels: bool = True) -> torch.Tensor:
    """``x @ w`` where w may be a QuantTensor ([K, N], scale [1, N])."""
    if isinstance(w, QuantTensor):
        return _contract_int8(x, w, use_kernels)
    return x @ w


def q_dequant(w, dtype: torch.dtype):
    """Materialized dequant, ``bf16(q * scale)`` for a bf16 ``dtype``: the
    reference's form for products outside the factored seams. The einsum
    MoE body computes the same rounding tile by tile instead
    (``int8_matmul(..., prologue=True)``)."""
    if isinstance(w, QuantTensor):
        return (w.q.float() * w.scale).to(dtype)
    return w


def q_lookup(emb, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding gather where the table may be row-quantized ([V, H] with
    per-row scale [V, 1]); ``dtype`` is the model compute dtype."""
    tokens = tokens.long()
    if isinstance(emb, QuantTensor):
        return emb.q[tokens].to(dtype) * emb.scale[tokens].to(dtype)
    return emb[tokens]
