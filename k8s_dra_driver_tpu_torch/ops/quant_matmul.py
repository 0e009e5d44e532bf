"""int8-weight matrix product: the wrapper over ``csrc/quant_matmul.cu``
and its plain PyTorch version.

``y = cast((x . q) * scale)`` with x bf16 ``[M, K]`` (or ``[E, M, K]``),
q int8 ``[K, N]`` (or ``[E, K, N]``) and a per-column f32 scale, in one of
two modes:

- ``prologue=False`` (the dense seams, ``models/quant.py``): the f32 sum
  of x against q as stored, times the scale, one cast -- the reference's
  ``_mixed_dot`` followed by ``* scale``;
- ``prologue=True`` (the einsum MoE body, ``models/moe.py``): x against
  ``bf16(q * scale)`` with an f32 sum -- the reference's ``q_dequant``
  followed by a bf16 dot, with the dequantized weight made tile by tile
  in shared memory only.

:func:`int8_matmul` takes its plain version,
:func:`int8_matmul_reference`, for CPU tensors; for CUDA tensors it
launches the kernel (counted in ``int8_matmul.launches``; the launches of
the wgmma body, M > 64, also in ``int8_matmul.wide_launches``, and those
of them in the prologue mode in ``int8_matmul.wide_prologue_launches``)
or raises: bf16 x, int8 q, f32 scales, K a multiple of 64 and N of 16,
16-byte aligned operands on one device, x and the scale contiguous, q
contiguous or a view whose rows (and entries) lie a multiple of 16 bytes
apart -- a column block of a wider weight, such as a tensor shard's
``wqkv``, ``lm_head`` or gate/up half, read where it lies
(``int8_matmul_strided`` in the source). :func:`plan` picks the
body and a K split from the shape and the card's SM count alone (host
integers, no sync): at M <= 64 the swapped form (the weight's columns as
wgmma's M, x's rows as its N), 128 columns a block, K split up to 8 ways
until the blocks cover the SMs; above, the wgmma body, K split two or
four ways where its tiles alone would leave SMs idle. A split's f32
partial sums go to a scratch buffer the wrapper allocates, summed in a
fixed order by the source's second pass.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._device import sm_count

_SOURCE = "quant_matmul"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = [_PTR] * 5 + [_INT] * 6 + [_PTR]
_STRIDED_ARGTYPES = [_PTR] * 5 + [_INT] * 6 + [ctypes.c_longlong] * 2 + [_PTR]
_LIB = None

#: The M <= 64 body's (the swapped form's) weight columns a block, and both
#: bodies' K step (``csrc/quant_matmul.cu``).
SWAP_COLS = 128
KERNEL_K_STEP = 64
#: The K splits the swapped form takes (the wgmma body: 1, 2, 4).
SWAP_SPLITS = (1, 2, 4, 8)
#: The wgmma body (M > 64): its output tile.
WIDE_MIN_M = 65
WIDE_ROWS = 128
WIDE_COLS = 256
#: The CUDA grid's limit on entries times splits (along y in both bodies);
#: the source refuses a grid past it.
GRID_Y_MAX = 65535


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        lib.int8_matmul.argtypes = _ARGTYPES
        lib.int8_matmul.restype = _INT
        lib.int8_matmul_strided.argtypes = _STRIDED_ARGTYPES
        lib.int8_matmul_strided.restype = _INT
        _LIB = lib
    return _LIB


def _batched(x, q, scale):
    """(x [E, M, K], q [E, K, N], scale [E, N], batched?) from either the
    2-D or the 3-D form; the scale may carry the collapsed contraction
    axis (``[1, N]``, ``[E, 1, N]``)."""
    if x.dim() != q.dim() or x.dim() not in (2, 3):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} and q "
                         f"{tuple(q.shape)}; expected [M, K] and [K, N], or "
                         f"[E, M, K] and [E, K, N]")
    batched = x.dim() == 3
    if not batched:
        x, q = x[None], q[None]
    e, _, k = x.shape
    if q.shape[0] != e or q.shape[1] != k:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} does not match q "
                         f"{tuple(q.shape)}")
    n = q.shape[2]
    if scale.numel() != e * n:
        raise ValueError(f"int8_matmul: scale {tuple(scale.shape)} for "
                         f"{e} x {n} columns")
    return x, q, scale.reshape(e, n), batched


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor,
                          prologue: bool = False) -> torch.Tensor:
    """The plain version: ``(x.float() @ q.float()) * scale`` cast to x's
    dtype, or with ``prologue`` ``x @ (q.float() * scale).to(x.dtype)``."""
    xb, qb, sb, batched = _batched(x, q, scale)
    sb = sb[:, None, :].float()
    if prologue:
        y = torch.matmul(xb, (qb.float() * sb).to(x.dtype))
    else:
        y = (torch.matmul(xb.float(), qb.float()) * sb).to(x.dtype)
    return y if batched else y[0]


def split_k(e: int, n: int, k: int, sms: int) -> int:
    """How many ways the M <= 64 body splits K: the fewest of 1, 2, 4, 8
    whose blocks (128 weight columns of an entry, per split) cover the
    card's SMs, among those that cut K into whole 64-deep steps and keep
    entries times splits within the grid; 8 where none covers them."""
    blocks = e * -(-n // SWAP_COLS)
    steps = k // KERNEL_K_STEP
    split = 1
    for s in SWAP_SPLITS:
        if steps % s or e * s > GRID_Y_MAX:
            break
        split = s
        if blocks * s >= sms:
            break
    return split


class Plan(NamedTuple):
    """One launch: the body (``wide``: the wgmma body, M > 64) and the K
    split."""
    wide: bool
    split: int


def plan(e: int, m: int, n: int, k: int, sms: int) -> Plan:
    """The launch for x [e, m, k] times q [e, k, n] on a card of ``sms``
    SMs, from host integers only. M <= 64 takes the swapped form and
    :func:`split_k`. Above, the wgmma body splits K (2 or 4 ways, where K
    divides) only where that cuts the waves of 128 x 256 blocks a unit of
    work takes by a quarter or more: a wave that a split would not fill is
    no gain, and the split's partial sums cost a second pass."""
    if m < WIDE_MIN_M:
        return Plan(False, split_k(e, n, k, sms))
    tiles = e * -(-m // WIDE_ROWS) * -(-n // WIDE_COLS)
    split = 1
    for s in (2, 4):
        if (k // KERNEL_K_STEP) % s or e * s > GRID_Y_MAX:
            break
        # Waves per unit of work: ceil(tiles s / sms) / s.
        if 4 * -(-tiles * s // sms) * split > 3 * s * -(-tiles * split // sms):
            break
        split = s
    return Plan(True, split)


def _check_args(x, q, scale) -> None:
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"int8_matmul: {name} on {t.device}; every input "
                             f"must sit on one CUDA device (or all on the "
                             f"CPU)")
        if name != "q" and not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"int8_matmul: {name} is not 16-byte aligned")
    for name, t, dtype in (("x", x, torch.bfloat16), ("q", q, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"int8_matmul: {name} is {t.dtype}; the kernel "
                            f"takes {dtype}")


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                prologue: bool = False) -> torch.Tensor:
    """``cast((x . q) * scale)`` through the int8-weight kernel; see the
    module docstring for the two modes and what the kernel takes."""
    if not (x.is_cuda or q.is_cuda or scale.is_cuda):
        return int8_matmul_reference(x, q, scale, prologue)
    _check_args(x, q, scale)
    xb, qb, sb, batched = _batched(x, q, scale)
    e, m, k = xb.shape
    n = qb.shape[2]
    if m == 0 or k % KERNEL_K_STEP or n % 16:
        raise ValueError(f"int8_matmul: M {m}, K {k}, N {n}; the kernel "
                         f"takes M > 0, K a multiple of {KERNEL_K_STEP} and "
                         f"N a multiple of 16")
    ldq = qb.stride(1)
    sq = qb.stride(0) if e > 1 else k * ldq
    if qb.stride(2) != 1 or ldq < n or ldq % 16 or sq % 16 \
            or (e > 1 and sq < k * ldq):
        raise ValueError(
            f"int8_matmul: q strides {tuple(q.stride())}; the kernel takes "
            f"rows with a contiguous last axis, 16-byte multiples apart")
    p = plan(e, m, n, k, sm_count(x.device))
    y = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    part = (torch.empty((p.split, e, m, n), dtype=torch.float32,
                        device=x.device) if p.split > 1 else None)
    with torch.cuda.device(x.device):
        rc = _library().int8_matmul_strided(
            xb.data_ptr(), qb.data_ptr(), sb.data_ptr(), y.data_ptr(),
            part.data_ptr() if part is not None else None, e, m, n, k,
            p.split, int(prologue), ldq, sq,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(rc, "int8_matmul")
    int8_matmul.launches += 1
    int8_matmul.wide_launches += p.wide
    int8_matmul.wide_prologue_launches += p.wide and prologue
    return y if batched else y[0]


int8_matmul.launches = 0
int8_matmul.wide_launches = 0
int8_matmul.wide_prologue_launches = 0
