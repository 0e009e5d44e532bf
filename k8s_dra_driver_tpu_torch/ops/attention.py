"""Paged attention over one paged KV pool: the plain PyTorch version and
the wrappers over the two CUDA kernels of ``csrc/paged_attention.cu``.

Counterpart of the paged half of ``k8s_dra_driver_tpu/ops/attention.py``:

- :func:`paged_attention_reference` is the plain version (any T, any
  ``positions`` layout): gather each sequence's window through its block
  table, then grouped-GQA masked attention.
- :func:`paged_decode_attention` wraps ``paged_decode``, which replaces
  ``_paged_decode_kernel``.
- :func:`paged_prefill_attention` wraps ``paged_prefill``, which replaces
  ``_paged_prefill_kernel``.

The public layouts are the JAX package's: q ``[B, Hq, D]`` or
``[B, Hq, T, D]``, pools ``[H_kv, P, D]``, tables ``[B, NBPS]`` int32.
The CUDA source's header says what bounds each kernel on the H100 and
how the design answers it.

A wrapper takes the plain version only for CPU tensors. For CUDA tensors
it launches its kernel (counted in ``<wrapper>.launches``) or raises: on
bf16 inputs only, no int8 pools, head_dim 64 or 128.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

_SOURCE = "paged_attention"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DECODE_ARGTYPES = [_PTR] * 6 + [_INT] * 7 + [ctypes.c_float, _PTR]
_PREFILL_ARGTYPES = [_PTR] * 6 + [_INT] * 8 + [ctypes.c_float, _PTR]
_MAX_G = {"paged_decode": 8, "paged_prefill": 64}


def gather_indices(block_tables: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flat pool rows [B, span] covering each sequence's whole addressable
    window in position order."""
    b, nbps = block_tables.shape
    idx = (
        block_tables[:, :, None].long() * block_size
        + torch.arange(block_size, device=block_tables.device)[None, None, :]
    )
    return idx.reshape(b, nbps * block_size)


def paged_attention_reference(
    q: torch.Tensor,             # [B, Hq, T, D]
    k_pool: torch.Tensor,        # [H_kv, P, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, NBPS] int
    positions: torch.Tensor,     # [B, T] absolute query positions
    block_size: int,
    scale: float | None = None,
) -> torch.Tensor:
    """The plain version: kv row s is visible to query t when
    ``s <= positions[b, t]``."""
    b, hq, t, d = q.shape
    hkv = k_pool.shape[0]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    idx = gather_indices(block_tables, block_size)
    span = idx.shape[1]
    k = k_pool[:, idx, :].transpose(0, 1)          # [B, H_kv, S, D]
    v = v_pool[:, idx, :].transpose(0, 1)
    qg = q.reshape(b, hkv, g, t, d)
    s = torch.einsum(
        "bhgtd,bhsd->bhgts", qg.float(), k.to(q.dtype).float()
    ) * scale
    kpos = torch.arange(span, device=q.device)
    mask = kpos[None, None, :] <= positions.long()[:, :, None]   # [B, T, S]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", p.to(q.dtype), v.to(q.dtype))
    return out.reshape(b, hq, t, d)


_LIB = None


def _library():
    """The built kernel library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        lib.paged_decode.argtypes = _DECODE_ARGTYPES
        lib.paged_decode.restype = _INT
        lib.paged_prefill.argtypes = _PREFILL_ARGTYPES
        lib.paged_prefill.restype = _INT
        _LIB = lib
    return _LIB


def _is_cpu(*tensors) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def _check_cuda_args(kernel, q, k_pool, v_pool, block_tables, lengths):
    dev = q.device
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if x.device != dev or not x.is_cuda:
            raise ValueError(
                f"{kernel}: {name} on {x.device}; every input must sit on "
                f"one CUDA device (or all on the CPU)"
            )
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if x.dtype != torch.bfloat16:
            raise TypeError(
                f"{kernel}: {name} is {x.dtype}; the kernel takes bf16 "
                f"(int8 pools are not ported yet)"
            )
    for name, x in (("block_tables", block_tables), ("lengths", lengths)):
        if x.dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} must be int32, got {x.dtype}")
    if k_pool.dim() != 3 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"{kernel}: pools must both be [H_kv, P, D], got "
            f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}"
        )
    hq, d = q.shape[1], q.shape[-1]
    hkv = k_pool.shape[0]
    if k_pool.shape[2] != d or d not in (64, 128):
        raise ValueError(f"{kernel}: head_dim {d} (pool {k_pool.shape[2]}); "
                         f"the kernel takes 64 or 128")
    if hq % hkv or hq // hkv > _MAX_G[kernel]:
        raise ValueError(f"{kernel}: {hq} query heads on {hkv} kv heads")
    b = q.shape[0]
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"{kernel}: block_tables {tuple(block_tables.shape)}"
                         f" for batch {b}")
    if lengths.shape != (b,):
        raise ValueError(f"{kernel}: lengths {tuple(lengths.shape)} != ({b},)")


def paged_decode_attention(
    q: torch.Tensor,              # [B, Hq, D], one query token per sequence
    k_pool: torch.Tensor,         # [H_kv, P, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,   # [B, NBPS] int32
    valid_len: torch.Tensor,      # [B] int32, kv entries visible
    block_size: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Single-token paged attention, masked at ``valid_len`` per sequence."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if _is_cpu(q, k_pool, v_pool, block_tables, valid_len):
        out = paged_attention_reference(
            q[:, :, None, :], k_pool, v_pool, block_tables,
            (valid_len.long() - 1)[:, None], block_size, scale,
        )
        return out[:, :, 0, :]
    if q.dim() != 3:
        raise ValueError(f"paged_decode: q must be [B, Hq, D], got {q.shape}")
    _check_cuda_args("paged_decode", q, k_pool, v_pool, block_tables,
                     valid_len)
    b, hq, _ = q.shape
    out = torch.empty_like(q)
    if b:
        with torch.cuda.device(q.device):
            rc = _library().paged_decode(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
                b, hq, k_pool.shape[0], d, k_pool.shape[1],
                block_tables.shape[1], block_size, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(rc, "paged_decode")
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_prefill_attention(
    q: torch.Tensor,              # [B, Hq, T, D], T-token query windows
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,      # [B, T] absolute query positions
    block_size: int,
    scale: float | None = None,
) -> torch.Tensor:
    """Multi-token paged attention over contiguous windows.

    The kernel reads only ``positions[:, 0]``: each row of ``positions``
    must be the window ``start + arange(T)``, as every T>1 caller's is
    (chunked prefill, the copy-on-write recompute). Right-padded query
    rows get finite values that the caller discards."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if _is_cpu(q, k_pool, v_pool, block_tables, positions):
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, positions, block_size, scale,
        )
    if q.dim() != 4 or positions.shape != q.shape[:1] + q.shape[2:3]:
        raise ValueError(
            f"paged_prefill: q {tuple(q.shape)} / positions "
            f"{tuple(positions.shape)}; expected [B, Hq, T, D] and [B, T]"
        )
    start = positions[:, 0].to(torch.int32).contiguous()
    _check_cuda_args("paged_prefill", q, k_pool, v_pool, block_tables, start)
    b, hq, t, _ = q.shape
    out = torch.empty_like(q)
    if b:
        with torch.cuda.device(q.device):
            rc = _library().paged_prefill(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), start.data_ptr(), out.data_ptr(),
                b, hq, k_pool.shape[0], t, d, k_pool.shape[1],
                block_tables.shape[1], block_size, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(rc, "paged_prefill")
        paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
