"""RMSNorm: the wrapper over ``csrc/rmsnorm.cu`` (the forward and its
gradient) and their plain PyTorch versions.

Replaces ``k8s_dra_driver_tpu/ops/norms.py::_rmsnorm_kernel`` (the Pallas
kernel launched by ``_rmsnorm_pallas``) and, for the gradient,
``_rmsnorm_diff_bwd`` (``jax.vjp`` of the reference, which XLA compiles
into fused loops).

What bounds it on the H100: bytes (a few f32 operations per element read
or written). :func:`plan` sizes the forward from host integers (the
row's width): one CTA a row up to width 8192, a thread-block cluster of
CTAs a row above, whose CTAs exchange their partial sums of squares
through distributed shared memory; one 16-byte slot a thread. :func:`backward_plan` sizes the
gradient kernel: a CTA owns a row at a time, the weight and its
gradient's partial sums in registers, the partial sums of the CTAs summed
in a fixed order by a second pass (no atomics: two calls give the same
bits). ``csrc/rmsnorm.cu`` describes both and what was measured.

On the CPU the wrappers run the plain versions; on CUDA tensors they
launch the kernels (counted in ``rmsnorm.launches`` and
``rmsnorm_backward.launches``) or raise. Gradients on the card run
through :class:`RMSNormFunction`, whose backward is the gradient kernel;
on CPU tensors its backward is :func:`rmsnorm_backward_reference`, the
closed form of the reference's ``jax.vjp``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._device import sm_count

_SOURCE = "rmsnorm"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LIB = None

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
#: The source's dtype codes.
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

#: Columns of a slot: one 16-byte word of bf16 / f16 (two of f32).
SLOT = 8
#: The forward, one slot a thread: threads a CTA at most (one CTA a row up
#: to width 8192), and CTAs a row at most past it (the portable cluster
#: size).
MAX_THREADS = 1024
MAX_CLUSTER = 8
#: The gradient kernel: threads a CTA at most, the slots a thread it is
#: built for, and CTAs an SM (its grid, and so its scratch rows).
BWD_THREADS = 256
BWD_SLOTS = (1, 2, 4)
BWD_CTAS_PER_SM = 2


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        lib.rmsnorm_forward.argtypes = (
            [_PTR] * 3 + [_INT] * 4 + [ctypes.c_float] + [_INT] * 3 + [_PTR])
        lib.rmsnorm_forward.restype = _INT
        lib.rmsnorm_backward.argtypes = (
            [_PTR] * 6 + [_INT] * 4 + [ctypes.c_float] + [_INT] * 4 + [_PTR])
        lib.rmsnorm_backward.restype = _INT
        _LIB = lib
    return _LIB


def rmsnorm_reference(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """The plain version: f32 mean square, rsqrt, weight scale, cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rmsnorm_backward_reference(x: torch.Tensor, weight: torch.Tensor,
                               g: torch.Tensor, eps: float = 1e-6):
    """The gradient's plain version, the closed form of the reference's
    ``jax.vjp`` of :func:`rmsnorm_reference`: per row, in f32, ``r =
    rsqrt(mean(x^2) + eps)``, ``xn = x r``, ``dx = r (g w - xn mean(g w
    xn))`` cast to x's dtype; ``dw`` the sum over rows of ``g xn`` cast to
    the weight's dtype. Returns (dx, dw)."""
    xf, wf, gf = x.float(), weight.float(), g.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xn = xf * r
    gw = gf * wf
    dx = r * (gw - xn * (gw * xn).mean(dim=-1, keepdim=True))
    dw = (gf * xn).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


class Plan(NamedTuple):
    """One launch: ``cluster`` CTAs a row (1: one CTA a row, a plain
    launch) of ``threads`` each, ``slots`` 8-column slots a thread (1 in
    the forward), over ``grid`` CTAs."""
    cluster: int
    threads: int
    slots: int
    grid: int


def plan(rows: int, d: int) -> Plan:
    """The forward's launch for ``rows`` rows of width ``d``, from host
    integers only: one 8-column slot a thread, in whole warps; one CTA a
    row while ``MAX_THREADS`` threads cover it (width 8192), else a
    cluster of the fewest CTAs (2, 4 or 8) that cover it."""
    slots = -(-d // SLOT)
    cluster = next(c for c in (1, 2, 4, MAX_CLUSTER)
                   if -(-slots // c) <= MAX_THREADS or c == MAX_CLUSTER)
    per_cta = -(-slots // cluster)
    return Plan(cluster, -(-per_cta // 32) * 32, 1, rows * cluster)


def backward_plan(rows: int, d: int, sms: int) -> Plan:
    """The gradient kernel's launch, from host integers only: as many
    threads as the row has slots (whole warps, at most ``BWD_THREADS``),
    the slots a thread the fewest of ``BWD_SLOTS`` that cover the row,
    and ``BWD_CTAS_PER_SM`` CTAs an SM (at most one a row). Raises for a
    width no plan covers."""
    slots = -(-d // SLOT)
    threads = min(BWD_THREADS, -(-slots // 32) * 32)
    fit = next((s for s in BWD_SLOTS if s * threads >= slots), None)
    if fit is None:
        raise ValueError(f"rmsnorm_backward: row width {d} exceeds "
                         f"{BWD_SLOTS[-1] * BWD_THREADS * SLOT}")
    return Plan(1, threads, fit, min(rows, BWD_CTAS_PER_SM * sms))


def _check(name: str, tensors: dict) -> torch.device:
    """The one CUDA device every tensor sits on, or raise; each must be
    contiguous and of a dtype the kernel takes."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or not next(iter(devices)).type == "cuda":
        where = ", ".join(f"{k} on {t.device}" for k, t in tensors.items())
        raise ValueError(f"{name}: {where}; all must sit on one CUDA "
                         f"device (or all on the CPU)")
    for k, t in tensors.items():
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: {k} is {t.dtype}; the kernel takes "
                            f"{_DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return next(iter(devices))


def _vec(d: int, *tensors) -> int:
    """1 where the kernel may move whole 16-byte words: every row starts
    16-byte aligned (d a multiple of 8) and so does every pointer."""
    return int(d % SLOT == 0 and all(t.data_ptr() % 16 == 0
                                     for t in tensors))


def _rmsnorm_forward(x: torch.Tensor, weight: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """The forward without autograd: the plain version on CPU tensors, the
    kernel (counted in ``rmsnorm.launches``) on CUDA tensors, or raise."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    dev = _check("rmsnorm", {"x": x, "weight": weight})
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} != ({d},)")
    if d > MAX_CLUSTER * MAX_THREADS * SLOT:
        raise ValueError(f"rmsnorm: row width {d} exceeds one cluster")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows:
        p = plan(rows, d)
        with torch.cuda.device(dev):
            rc = _library().rmsnorm_forward(
                x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype], float(eps),
                p.cluster, p.threads, _vec(d, x, weight, out),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(rc, "rmsnorm")
        rmsnorm.launches += 1
    return out


def rmsnorm_backward(x: torch.Tensor, weight: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6):
    """(dx, dw) of :func:`rmsnorm` at x, weight for the output's gradient
    g: :func:`rmsnorm_backward_reference` on CPU tensors, the gradient
    kernel (counted in ``rmsnorm_backward.launches``) on CUDA tensors, or
    raise."""
    if all(t.device.type == "cpu" for t in (x, weight, g)):
        return rmsnorm_backward_reference(x, weight, g, eps)
    g = g.to(x.dtype).contiguous()
    dev = _check("rmsnorm_backward", {"x": x, "weight": weight, "g": g})
    d = x.shape[-1]
    if weight.shape != (d,) or g.shape != x.shape:
        raise ValueError(f"rmsnorm_backward: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, g {tuple(g.shape)}")
    rows = x.numel() // d if d else 0
    dx = torch.empty_like(x)
    if not rows:
        return dx, torch.zeros_like(weight)
    p = backward_plan(rows, d, sm_count(dev))
    dw = torch.empty_like(weight)
    part = torch.empty((p.grid, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _library().rmsnorm_backward(
            x.data_ptr(), g.data_ptr(), weight.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), part.data_ptr(), rows, d, _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[weight.dtype], float(eps), p.threads, p.slots,
            p.grid, _vec(d, x, g, weight, dx, part),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "rmsnorm_backward")
    rmsnorm_backward.launches += 1
    return dx, dw


class RMSNormFunction(torch.autograd.Function):
    """The forward kernel with the gradient kernel as its backward (on CPU
    tensors: the plain forward and :func:`rmsnorm_backward_reference`)."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rmsnorm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, weight, g, ctx.eps)
        return dx, dw, None


def rmsnorm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """RMSNorm over the last dim. x: [..., D], weight: [D].

    CPU tensors take :func:`rmsnorm_reference` under plain autograd; CUDA
    tensors launch the kernel (counted in ``rmsnorm.launches``) through
    :class:`RMSNormFunction`, or raise."""
    if x.device.type == "cpu" and weight.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    return RMSNormFunction.apply(x, weight, eps)


rmsnorm.launches = 0
rmsnorm_backward.launches = 0
