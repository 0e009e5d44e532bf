"""RMSNorm: a Triton kernel for Hopper plus its plain PyTorch version.

Replaces ``k8s_dra_driver_tpu/ops/norms.py::_rmsnorm_kernel`` (the Pallas
kernel launched by ``_rmsnorm_pallas``).

What bounds it on the H100: bytes. Each row is read once and written
once (2 * rows * D * itemsize bytes, plus the weight) and the arithmetic
is a few operations per element, far below the ~295 bf16 operations per
byte where the tensor cores would become the limit. The design follows:
one program per row with the whole row in registers (``BLOCK =
next_pow2(D)``, 4096 at Llama-3-8B), the mean square, rsqrt and weight
scale done in f32 in that one pass, and the result cast back to the
input dtype. Rows are independent, so the grid is simply ``rows``.

On the CPU the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. ``triton`` is imported only when the
kernel is first launched: hosts without it can still import the module.

Gradients: on the card the kernel runs inside :class:`RMSNormFunction`,
whose backward recomputes through :func:`rmsnorm_reference` (the
reference's ``_rmsnorm_diff_bwd``); there is no backward kernel, as the
JAX package has none.
"""

from __future__ import annotations

import torch

#: Bound at the first launch (``_triton_kernel``): the kernel body below
#: is compiled by Triton, which resolves ``tl`` from this module's globals.
tl = None
_KERNEL = None


def rmsnorm_reference(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """The plain version: f32 mean square, rsqrt, weight scale, cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _rmsnorm_row(x_ptr, w_ptr, o_ptr, n_cols, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(x_ptr + row * n_cols + cols, mask=mask, other=0.0)
    x = x.to(tl.float32)
    var = tl.sum(x * x, axis=0) / n_cols
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * (1.0 / tl.sqrt(var + eps)) * w
    tl.store(o_ptr + row * n_cols + cols, y.to(o_ptr.dtype.element_ty),
             mask=mask)


def _triton_kernel():
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl

        _KERNEL = triton.jit(_rmsnorm_row)
    return _KERNEL


_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _rmsnorm_forward(x: torch.Tensor, weight: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The forward without autograd: the plain version on CPU tensors, the
    Triton kernel (counted in ``rmsnorm.launches``) on CUDA tensors, or
    raise."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    if not (x.is_cuda and weight.is_cuda and x.device == weight.device):
        raise ValueError(
            f"rmsnorm: x on {x.device} and weight on {weight.device}; "
            f"both must sit on one CUDA device (or both on the CPU)"
        )
    d = x.shape[-1]
    if x.dtype not in _DTYPES or weight.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: unsupported dtypes {x.dtype}, {weight.dtype}")
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} != ({d},)")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm: x and weight must be contiguous")
    block = 1 << max(d - 1, 0).bit_length()
    if block > 65536:
        raise ValueError(f"rmsnorm: row width {d} exceeds one program")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        kernel = _triton_kernel()
        with torch.cuda.device(x.device):
            kernel[(rows,)](
                x, weight, out, d, float(eps), BLOCK=block,
                num_warps=8 if block >= 2048 else 4,
            )
        rmsnorm.launches += 1
    return out


class RMSNormFunction(torch.autograd.Function):
    """The kernel's forward with the reference's gradient: the backward
    recomputes :func:`rmsnorm_reference` under autograd and takes its
    vector-Jacobian product."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rmsnorm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_()
            w_ = weight.detach().requires_grad_()
            y = rmsnorm_reference(x_, w_, ctx.eps)
            dx, dw = torch.autograd.grad(y, (x_, w_), g)
        return dx, dw, None


def rmsnorm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """RMSNorm over the last dim. x: [..., D], weight: [D].

    CPU tensors take :func:`rmsnorm_reference` under plain autograd; CUDA
    tensors launch the Triton kernel (counted in ``rmsnorm.launches``)
    through :class:`RMSNormFunction`, or raise."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    return RMSNormFunction.apply(x, weight, eps)


rmsnorm.launches = 0
