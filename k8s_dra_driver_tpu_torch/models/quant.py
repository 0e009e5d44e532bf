"""Weight-only int8 for serving. Counterpart of
``k8s_dra_driver_tpu/models/quant.py``.

- **Per-output-channel symmetric int8**: ``scale = amax / 127`` over the
  contraction axis, kept with ``keepdims`` so a per-layer slice of a
  stacked leaf slices ``q`` and ``scale`` together. :func:`quantize_tensor`
  gives the reference's int8 values and scales bit for bit (f32 amax,
  the same clamp and divide, round half to even).
- **The dense seams** (:func:`q_einsum`, :func:`q_matmul`): the product
  runs on ``q`` converted to the activation dtype (int8 to bf16 is
  exact), so the weight stays stored as int8; the per-channel scale,
  constant over the contraction, multiplies the product in f32 before the
  cast. On bf16 activations ``torch.matmul`` rounds the product to bf16
  once before the scale, where the reference's mixed-dtype dot keeps it
  f32: one more rounding of at most 2^-9 relative, accepted (the card's
  forward is held to 5e-2 relative logits). These are plain matrix
  products outside any kernel. The MoE expert stacks do not come here:
  the fused dispatch kernels read them as int8 (``ops/moe_dispatch.py``).
- :class:`QuantTensor` is a plain dataclass. It slices by its leading
  axis (``w[i]``, ``w.unbind(0)``), so the layer loops index quantized
  and float stacks alike.

``quantize_specs`` (sharding) is not ported: the port has no mesh yet.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch


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


# ---------------------------------------------------------------------------
# Compute seams: the float path unchanged, the int8 path scaled in f32.
# ---------------------------------------------------------------------------


def _contract(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x's last axis against w's first: [*x_batch, *w_out]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def q_einsum(pattern: str, x: torch.Tensor, w) -> torch.Tensor:
    """``einsum(pattern, x, w)`` where w may be a QuantTensor. Every
    pattern the model uses contracts x's last axis with w's first; that
    runs as one matrix product, anything else as ``torch.einsum``. The
    scale, constant over the contraction, multiplies the product."""
    ins, out = pattern.split("->")
    xs, ws = ins.split(",")
    simple = xs[-1] == ws[0] and out == xs[:-1] + ws[1:]
    if not isinstance(w, QuantTensor):
        return _contract(x, w) if simple else torch.einsum(pattern, x, w)
    wq = w.q.to(x.dtype)
    y = _contract(x, wq) if simple else torch.einsum(pattern, x, wq)
    return (y.float() * w.scale.squeeze(0)).to(x.dtype)


def q_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where w may be a QuantTensor ([K, N], scale [1, N])."""
    if isinstance(w, QuantTensor):
        y = x @ w.q.to(x.dtype)
        return (y.float() * w.scale[0]).to(x.dtype)
    return x @ w


def q_dequant(w, dtype: torch.dtype):
    """Materialized dequant for the einsum MoE body (its expert axis leads
    the output, outside the factored seams)."""
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
