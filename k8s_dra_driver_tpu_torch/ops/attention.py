"""Attention: the paged half (serving) and the flash half (training), each
a plain PyTorch version beside wrappers over hand-written CUDA kernels.

Counterpart of ``k8s_dra_driver_tpu/ops/attention.py``. The paged half,
over ``csrc/paged_attention.cu``:

- :func:`paged_attention_reference` is the plain version (any T, any
  ``positions`` layout): gather each sequence's window through its block
  table, then grouped-GQA masked attention.
- :func:`paged_decode_attention` wraps ``paged_decode``, which replaces
  ``_paged_decode_kernel``. It splits the kv axis: :func:`decode_splits`
  picks the split count S on the host from host-known integers only, and
  :func:`paged_decode_split_reference` is the plain version of the
  split-and-merge (:func:`paged_decode_partials`, then
  :func:`merge_partials` in the kernel's order).
- :func:`paged_prefill_attention` wraps ``paged_prefill``, which replaces
  ``_paged_prefill_kernel``.
- int8 pools (the ``quantized`` branch of both TPU kernels) come with f32
  per-position scales ``k_scale``/``v_scale`` ``[H_kv, P]``: k's scale
  multiplies the scores, v's the probabilities, which stay f32 into the
  PV product. Both wrappers hand them to :func:`paged_decode_int8` and
  :func:`paged_prefill_int8`, the wrappers of the kernels' int8 branches
  (``paged_decode_int8``/``paged_prefill_int8`` of the same source),
  counted apart from the bf16 launches.

The flash half, over ``csrc/flash_attention.cu``:

- :func:`attention_reference` is plain attention (causal offset
  ``skv - sq``), the numerics oracle.
- :func:`flash_fwd` (out and natural-log lse), :func:`flash_bwd_dkdv` and
  :func:`flash_bwd_dq` wrap the kernels that replace ``_flash_kernel``,
  ``_flash_bwd_dkdv_kernel`` and ``_flash_bwd_dq_kernel``; each has its
  plain version (``*_reference``).
- :func:`flash_attention_forward` and :func:`flash_attention_backward`
  mirror ``_flash_attention_pallas`` (``return_lse``) and
  ``_flash_attention_bwd_pallas``: the per-hop calls ring attention needs.
- :func:`flash_site` takes the place of ``_flash_diff``: one
  ``torch.library`` op with a registered backward, the ``flash_out``
  site of the named remat policies. :func:`flash_attention` is what the
  model calls.

The public layouts are the JAX package's: q ``[B, Hq, D]`` or
``[B, Hq, T, D]``, pools ``[H_kv, P, D]``, tables ``[B, NBPS]`` int32;
flash q ``[B, Hq, S, D]``, k/v ``[B, H_kv, S, D]``, lse ``[B, Hq, S]``.
The CUDA sources' headers say what bounds each kernel on the H100 and
how the design answers it.

A wrapper takes the plain version only for CPU tensors. For CUDA tensors
it launches its kernel (counted in ``<wrapper>.launches``) or raises: bf16
queries, bf16 pools or int8 pools with their scales, head_dim 64 or 128.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._device import sm_count

NEG_INF = -1e30

_SOURCE = "paged_attention"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# Decode takes the split partials' scratch after out, and the split count
# after block_size.
_DECODE_ARGTYPES = [_PTR] * 8 + [_INT] * 8 + [ctypes.c_float, _PTR]
_PREFILL_ARGTYPES = [_PTR] * 6 + [_INT] * 8 + [ctypes.c_float, _PTR]
# The int8 entry points take k_scale and v_scale after the pools.
_DECODE_INT8_ARGTYPES = [_PTR] * 10 + [_INT] * 8 + [ctypes.c_float, _PTR]
_PREFILL_INT8_ARGTYPES = [_PTR] * 8 + [_INT] * 8 + [ctypes.c_float, _PTR]
_MAX_G = {"paged_decode": 8, "paged_prefill": 64, "paged_decode_int8": 8,
          "paged_prefill_int8": 64}
LOG2E = 1.4426950408889634

# The decode split plan (``csrc/paged_attention.cu``'s K2). A split covers
# at least DECODE_SPLIT_MIN positions of the addressable span (one kv tile);
# the host aims at DECODE_BLOCKS_PER_SM blocks an SM. On the device each
# split of sequence b covers ceil(valid_len[b] / S) positions rounded up to
# DECODE_SPLIT_ALIGN (the kernel's kSplitAlign); at most DECODE_MAX_SPLITS
# (kMaxSplits) splits, the merge kernel's shared arrays.
DECODE_SPLIT_MIN = 64
DECODE_BLOCKS_PER_SM = 2
DECODE_SPLIT_ALIGN = 32
DECODE_MAX_SPLITS = 512


def decode_splits(b: int, hkv: int, nbps: int, block_size: int,
                  sm_count: int) -> int:
    """The number of kv splits S of one decode launch: enough (sequence,
    kv head, split) blocks for DECODE_BLOCKS_PER_SM on each SM, no more
    splits than the span holds DECODE_SPLIT_MIN positions. Host integers
    only -- never ``valid_len``, which lives on the device: a plan read from
    it would wait for the device on every decode step."""
    most = max(1, min(DECODE_MAX_SPLITS,
                      -(-nbps * block_size // DECODE_SPLIT_MIN)))
    want = -(-DECODE_BLOCKS_PER_SM * sm_count // max(1, b * hkv))
    return max(1, min(want, most))


def decode_split_len(valid_len: torch.Tensor, splits: int) -> torch.Tensor:
    """Positions each split of each sequence covers (the kernel's formula):
    ceil(valid_len / S) rounded up to DECODE_SPLIT_ALIGN."""
    per = -(-valid_len.long().clamp(min=0) // splits)
    return -(-per // DECODE_SPLIT_ALIGN) * DECODE_SPLIT_ALIGN


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
    k_scale: torch.Tensor | None = None,   # [H_kv, P] f32 (int8 pools)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The plain version: kv row s is visible to query t when
    ``s <= positions[b, t]``. With int8 pools, k's per-position scale
    multiplies the scores and v's the probabilities, which stay f32 into
    the PV product (the bf16 branch rounds them to the pool dtype)."""
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
    if k_scale is not None:
        s = s * k_scale[:, idx].transpose(0, 1)[:, :, None, None, :]
    kpos = torch.arange(span, device=q.device)
    mask = kpos[None, None, :] <= positions.long()[:, :, None]   # [B, T, S]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, idx].transpose(0, 1)[:, :, None, None, :]
        out = torch.einsum("bhgts,bhsd->bhgtd", p, v.float()).to(q.dtype)
    else:
        out = torch.einsum("bhgts,bhsd->bhgtd", p.to(q.dtype),
                           v.to(q.dtype))
    return out.reshape(b, hq, t, d)


def paged_decode_partials(
    q: torch.Tensor,             # [B, Hq, D]
    k_pool: torch.Tensor,        # [H_kv, P, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, NBPS] int
    valid_len: torch.Tensor,     # [B] int
    block_size: int,
    splits: int,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,   # [H_kv, P] f32 (int8 pools)
    v_scale: torch.Tensor | None = None,
):
    """The kernel's split partials, f32: for each (sequence, query head,
    split) the largest score m (base 2, ``-inf`` for an empty split), the
    sum l of ``2^(s - m)`` and ``acc = sum 2^(s - m) v`` (times v's scale
    with int8 pools), over the positions of the split that lie below
    ``valid_len``. Shapes [B, Hq, S], [B, Hq, S], [B, Hq, S, D]."""
    b, hq, d = q.shape
    hkv = k_pool.shape[0]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    idx = gather_indices(block_tables, block_size)
    span = idx.shape[1]
    k = k_pool[:, idx, :].transpose(0, 1).float()    # [B, H_kv, S, D]
    v = v_pool[:, idx, :].transpose(0, 1).float()
    s = torch.einsum("bhgd,bhsd->bhgs", q.reshape(b, hkv, g, d).float(),
                     k) * (scale * LOG2E)
    if k_scale is not None:
        s = s * k_scale[:, idx].transpose(0, 1)[:, :, None, :]
    vl = valid_len.long().clamp(0, span)
    length = decode_split_len(vl, splits).clamp(min=1)
    kpos = torch.arange(span, device=q.device)
    split_of = kpos[None, :] // length[:, None]                  # [B, span]
    visible = kpos[None, :] < vl[:, None]
    vs = (v_scale[:, idx].transpose(0, 1)[:, :, None, :]
          if v_scale is not None else None)
    ms, ls, accs = [], [], []
    for i in range(splits):
        mask = (visible & (split_of == i))[:, None, None, :]     # [B,1,1,span]
        si = torch.where(mask, s, torch.full_like(s, -torch.inf))
        m = si.amax(dim=-1)                                     # [B,H_kv,G]
        p = torch.where(mask, torch.exp2(si - m.clamp(min=NEG_INF)[..., None]),
                        torch.zeros_like(s))
        ls.append(p.sum(dim=-1))
        if vs is not None:
            p = p * vs
        accs.append(torch.einsum("bhgs,bhsd->bhgd", p, v))
        ms.append(m)
    return (torch.stack(ms, -1).reshape(b, hq, splits),
            torch.stack(ls, -1).reshape(b, hq, splits),
            torch.stack(accs, -2).reshape(b, hq, splits, d))


def merge_partials(m: torch.Tensor, l: torch.Tensor,
                   acc: torch.Tensor) -> torch.Tensor:
    """The merge kernel's arithmetic: ``sum_i acc_i 2^(m_i - M) / sum_i l_i
    2^(m_i - M)``, M the largest m, summed in split order; 0 where every
    split is empty. [B, Hq, S] x2, [B, Hq, S, D] -> [B, Hq, D] f32."""
    top = m.amax(dim=-1, keepdim=True)
    weight = torch.where(top > -torch.inf, torch.exp2(m - top.clamp(
        min=NEG_INF)), torch.zeros_like(m))
    lsum = torch.zeros_like(m[..., 0])
    asum = torch.zeros_like(acc[..., 0, :])
    for i in range(m.shape[-1]):
        lsum = lsum + l[..., i] * weight[..., i]
        asum = asum + acc[..., i, :] * weight[..., i, None]
    return torch.where(lsum[..., None] > 0,
                       asum / lsum.clamp(min=1e-30)[..., None],
                       torch.zeros_like(asum))


def paged_decode_split_reference(q, k_pool, v_pool, block_tables, valid_len,
                                 block_size: int, splits: int,
                                 scale: float | None = None, k_scale=None,
                                 v_scale=None) -> torch.Tensor:
    """The plain version of the split decode kernel and its merge: the
    partials of every split merged in split order, in q's dtype
    [B, Hq, D]."""
    m, l, acc = paged_decode_partials(q, k_pool, v_pool, block_tables,
                                      valid_len, block_size, splits, scale,
                                      k_scale, v_scale)
    return merge_partials(m, l, acc).to(q.dtype)


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
        lib.paged_decode_int8.argtypes = _DECODE_INT8_ARGTYPES
        lib.paged_decode_int8.restype = _INT
        lib.paged_prefill_int8.argtypes = _PREFILL_INT8_ARGTYPES
        lib.paged_prefill_int8.restype = _INT
        _LIB = lib
    return _LIB


def _is_cpu(*tensors) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def set_attention_impl(impl: str) -> None:
    """The reference's backend override. The port has one rule instead --
    the kernels for CUDA tensors, the plain versions for CPU tensors --
    so only ``"auto"`` is taken: an override that sent a CUDA tensor to
    the plain version would be a fallback, and the plain versions already
    run wherever the tensors lie on the CPU."""
    if impl != "auto":
        raise ValueError(
            f"attention impl {impl!r}: the port runs the kernels for CUDA "
            f"tensors and the plain versions for CPU tensors; only 'auto' "
            f"is taken"
        )


def _impl_label(device=None) -> str:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def attention_impl_label(device=None) -> str:
    """What ``flash_attention`` runs for tensors on ``device`` (default:
    the CUDA device where there is one, else the CPU): ``"cuda"`` (the
    kernels of ``csrc/flash_attention.cu``) or ``"plain"``."""
    return _impl_label(device)


def paged_prefill_impl_label(device=None) -> str:
    """What ``paged_prefill_attention`` runs for tensors on ``device``
    (default as :func:`attention_impl_label`): ``"cuda"`` (K3 of
    ``csrc/paged_attention.cu``) or ``"plain"``
    (:func:`paged_attention_reference`)."""
    return _impl_label(device)


def _check_cuda_args(kernel, q, k_pool, v_pool, block_tables, lengths,
                     k_scale=None, v_scale=None):
    dev = q.device
    scales = () if k_scale is None else (("k_scale", k_scale),
                                         ("v_scale", v_scale))
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths),
                    *scales):
        if x.device != dev or not x.is_cuda:
            raise ValueError(
                f"{kernel}: {name} on {x.device}; every input must sit on "
                f"one CUDA device (or all on the CPU)"
            )
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
    pool_dtype = torch.int8 if scales else torch.bfloat16
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        want = torch.bfloat16 if name == "q" else pool_dtype
        if x.dtype != want:
            raise TypeError(
                f"{kernel}: {name} is {x.dtype}; the kernel takes bf16 "
                f"queries and bf16 pools, or int8 pools with k_scale and "
                f"v_scale"
            )
    for name, x in scales:
        if x.dtype != torch.float32 or x.shape != k_pool.shape[:2]:
            raise TypeError(
                f"{kernel}: {name} {tuple(x.shape)} {x.dtype}; expected "
                f"float32 {tuple(k_pool.shape[:2])}"
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


def _launch(kernel, q, k_pool, v_pool, k_scale, v_scale, block_tables,
            lengths, block_size, scale) -> tuple[torch.Tensor, bool]:
    """Check the arguments and run one paged kernel of
    ``csrc/paged_attention.cu`` (``lengths``: valid_len for decode, the
    window starts for prefill). Returns (out, launched)."""
    _check_cuda_args(kernel, q, k_pool, v_pool, block_tables, lengths,
                     k_scale, v_scale)
    b, hq = q.shape[:2]
    hkv, d = k_pool.shape[0], q.shape[-1]
    nbps = block_tables.shape[1]
    pools = (k_pool, v_pool) + (() if k_scale is None else (k_scale, v_scale))
    out = torch.empty_like(q)
    if not b:
        return out, False
    if kernel.startswith("paged_decode"):
        # Split partials, f32 scratch written and merged by the kernels:
        # acc [B, Hq, S, D], then (m, l) [B, Hq, S, 2], in one allocation.
        splits = decode_splits(b, hkv, nbps, block_size, sm_count(q.device))
        extra = (None, None)
        if splits > 1:
            scratch = torch.empty(b * hq * splits * (d + 2),
                                  dtype=torch.float32, device=q.device)
            extra = (scratch.data_ptr(),
                     scratch.data_ptr() + b * hq * splits * d * 4)
        t, tail = (), (splits,)
    else:
        extra, t, tail = (), (q.shape[2],), ()
    with torch.cuda.device(q.device):
        rc = getattr(_library(), kernel)(
            q.data_ptr(), *(x.data_ptr() for x in pools),
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            *extra, b, hq, hkv, *t, d, k_pool.shape[1], nbps, block_size,
            *tail, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(rc, kernel)
    return out, True


def paged_decode_attention(
    q: torch.Tensor,              # [B, Hq, D], one query token per sequence
    k_pool: torch.Tensor,         # [H_kv, P, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,   # [B, NBPS] int32
    valid_len: torch.Tensor,      # [B] int32, kv entries visible
    block_size: int,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,   # [H_kv, P] f32 (int8 pools)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Single-token paged attention, masked at ``valid_len`` per sequence.
    int8 pools with their scales go to :func:`paged_decode_int8`."""
    if k_scale is not None or v_scale is not None:
        return paged_decode_int8(q, k_pool, v_pool, k_scale, v_scale,
                                 block_tables, valid_len, block_size, scale)
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
    out, launched = _launch("paged_decode", q, k_pool, v_pool, None, None,
                            block_tables, valid_len, block_size, scale)
    paged_decode_attention.launches += launched
    return out


paged_decode_attention.launches = 0


def paged_decode_int8(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                      valid_len, block_size: int,
                      scale: float | None = None) -> torch.Tensor:
    """The int8 branch of the decode kernel: pools int8 ``[H_kv, P, D]``,
    ``k_scale``/``v_scale`` f32 ``[H_kv, P]``; otherwise
    :func:`paged_decode_attention`."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if _is_cpu(q, k_pool, v_pool, block_tables, valid_len):
        out = paged_attention_reference(
            q[:, :, None, :], k_pool, v_pool, block_tables,
            (valid_len.long() - 1)[:, None], block_size, scale,
            k_scale=k_scale, v_scale=v_scale,
        )
        return out[:, :, 0, :]
    if q.dim() != 3 or k_scale is None or v_scale is None:
        raise ValueError(f"paged_decode_int8: q must be [B, Hq, D] (got "
                         f"{tuple(q.shape)}) and both scales given")
    out, launched = _launch("paged_decode_int8", q, k_pool, v_pool, k_scale,
                            v_scale, block_tables, valid_len, block_size,
                            scale)
    paged_decode_int8.launches += launched
    return out


paged_decode_int8.launches = 0


def _window_starts(kernel, q, positions) -> torch.Tensor:
    if q.dim() != 4 or positions.shape != q.shape[:1] + q.shape[2:3]:
        raise ValueError(
            f"{kernel}: q {tuple(q.shape)} / positions "
            f"{tuple(positions.shape)}; expected [B, Hq, T, D] and [B, T]"
        )
    return positions[:, 0].to(torch.int32).contiguous()


def paged_prefill_attention(
    q: torch.Tensor,              # [B, Hq, T, D], T-token query windows
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    positions: torch.Tensor,      # [B, T] absolute query positions
    block_size: int,
    scale: float | None = None,
    k_scale: torch.Tensor | None = None,   # [H_kv, P] f32 (int8 pools)
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Multi-token paged attention over contiguous windows.

    The kernel reads only ``positions[:, 0]``: each row of ``positions``
    must be the window ``start + arange(T)``, as every T>1 caller's is
    (chunked prefill, the copy-on-write recompute). Right-padded query
    rows get finite values that the caller discards. int8 pools with their
    scales go to :func:`paged_prefill_int8`."""
    if k_scale is not None or v_scale is not None:
        return paged_prefill_int8(q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, positions, block_size, scale)
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if _is_cpu(q, k_pool, v_pool, block_tables, positions):
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, positions, block_size, scale,
        )
    start = _window_starts("paged_prefill", q, positions)
    out, launched = _launch("paged_prefill", q, k_pool, v_pool, None, None,
                            block_tables, start, block_size, scale)
    paged_prefill_attention.launches += launched
    return out


paged_prefill_attention.launches = 0


def paged_prefill_int8(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                       positions, block_size: int,
                       scale: float | None = None) -> torch.Tensor:
    """The int8 branch of the prefill kernel: pools int8, scales f32
    ``[H_kv, P]``; otherwise :func:`paged_prefill_attention`."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if _is_cpu(q, k_pool, v_pool, block_tables, positions):
        return paged_attention_reference(
            q, k_pool, v_pool, block_tables, positions, block_size, scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    if k_scale is None or v_scale is None:
        raise ValueError("paged_prefill_int8: both scales must be given")
    start = _window_starts("paged_prefill_int8", q, positions)
    out, launched = _launch("paged_prefill_int8", q, k_pool, v_pool, k_scale,
                            v_scale, block_tables, start, block_size, scale)
    paged_prefill_int8.launches += launched
    return out


paged_prefill_int8.launches = 0


# ---------------------------------------------------------------------------
# Flash attention (the dense training path)
# ---------------------------------------------------------------------------

_FLASH_SOURCE = "flash_attention"
_FLASH_FWD_ARGTYPES = [_PTR] * 5 + [_INT] * 6 + [ctypes.c_float, _PTR]
_FLASH_DKDV_ARGTYPES = [_PTR] * 8 + [_INT] * 6 + [ctypes.c_float, _PTR]
_FLASH_DQ_ARGTYPES = [_PTR] * 7 + [_INT] * 6 + [ctypes.c_float, _PTR]
_FLASH_LIB = None


def _flash_library():
    global _FLASH_LIB
    if _FLASH_LIB is None:
        lib = _build.load(_FLASH_SOURCE)
        for name, argtypes in (("flash_fwd", _FLASH_FWD_ARGTYPES),
                               ("flash_bwd_dkdv", _FLASH_DKDV_ARGTYPES),
                               ("flash_bwd_dq", _FLASH_DQ_ARGTYPES)):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _INT
        _FLASH_LIB = lib
    return _FLASH_LIB


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """kv heads repeated so query head h reads kv head h // group."""
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    return torch.arange(skv, device=device)[None, :] <= qpos


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention. q, k, v: [B, H, S, D] with as many kv heads as q
    heads (GQA repeats outside); query i of sq sees kv position j when
    ``j <= i + skv - sq``. Returns [B, H, S, D] in q's dtype."""
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_causal_mask(sq, skv, q.device), s,
                        torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).to(q.dtype)


def _scores(q, k, causal, scale):
    """Scaled f32 scores [B, Hq, S, S] with masked entries at NEG_INF."""
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     _repeat_kv(k, g).float()) * scale
    if causal:
        s = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), s,
                        torch.full_like(s, NEG_INF))
    return s


def flash_fwd_reference(q, k, v, causal: bool, scale: float):
    """The plain version of ``flash_fwd``: (out in q's dtype, natural-log
    lse [B, Hq, S] f32). out is :func:`attention_reference`'s, bit for
    bit."""
    s = _scores(q, k, causal, scale)
    g = q.shape[1] // k.shape[1]
    out = torch.einsum("bhqk,bhkd->bhqd",
                       torch.softmax(s, dim=-1).to(v.dtype),
                       _repeat_kv(v, g))
    return out.to(q.dtype), torch.logsumexp(s, dim=-1)


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    """p rebuilt from lse (masked entries exactly 0) and dS = p * (dO V^T
    - delta), both f32 [B, Hq, S, S]."""
    g = q.shape[1] // k.shape[1]
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None].float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      _repeat_kv(v, g).float())
    return p, p * (dp - delta[..., None].float())


def _sum_group(x: torch.Tensor, hkv: int) -> torch.Tensor:
    b, hq, s, d = x.shape
    return x.reshape(b, hkv, hq // hkv, s, d).sum(dim=2)


def flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal: bool,
                             scale: float):
    """The plain version of ``flash_bwd_dkdv``: (dk, dv) at kv-head count,
    summed over each kv head's query group. p and dS are rounded to the
    input dtype before their products, as the kernels do."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
                      q.float()) * scale
    hkv = k.shape[1]
    return (_sum_group(dk, hkv).to(k.dtype),
            _sum_group(dv, hkv).to(v.dtype))


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool,
                           scale: float):
    """The plain version of ``flash_bwd_dq``."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    g = q.shape[1] // k.shape[1]
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(),
                      _repeat_kv(k, g).float()) * scale
    return dq.to(q.dtype)


def _check_flash_args(kernel, q, k, v, bf16: dict, f32: dict) -> None:
    """What the flash kernels take: one CUDA device, contiguous 16-byte
    aligned tensors, bf16 activations and f32 row statistics,
    q [B, Hq, S, D] with k, v [B, H_kv, S, D], D 64 or 128."""
    for name, x in {**bf16, **f32}.items():
        if x.device != q.device or not x.is_cuda:
            raise ValueError(
                f"{kernel}: {name} on {x.device}; every input must sit on "
                f"one CUDA device (or all on the CPU)"
            )
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} is not 16-byte aligned")
    for name, x in bf16.items():
        if x.dtype != torch.bfloat16:
            raise TypeError(
                f"{kernel}: {name} is {x.dtype}; the kernel takes bf16")
    for name, x in f32.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32, got {x.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{kernel}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; expected [B, H, S, D]")
    b, hq, s, d = q.shape
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d:
        raise ValueError(f"{kernel}: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (same B, S and D)")
    if d not in (64, 128):
        raise ValueError(f"{kernel}: head_dim {d}; the kernel takes 64 or "
                         f"128")
    if hq % k.shape[1]:
        raise ValueError(f"{kernel}: {hq} query heads on {k.shape[1]} kv "
                         f"heads")
    for name, x in f32.items():
        if x.shape != (b, hq, s):
            raise ValueError(f"{kernel}: {name} {tuple(x.shape)} != "
                             f"{(b, hq, s)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q, k, v, causal: bool = True, scale: float | None = None):
    """Flash attention forward: (out [B, Hq, S, D], lse [B, Hq, S] f32,
    natural log). Replaces ``_flash_kernel``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _is_cpu(q, k, v):
        return flash_fwd_reference(q, k, v, causal, scale)
    _check_flash_args("flash_fwd", q, k, v, dict(q=q, k=k, v=v), {})
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _flash_library().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, hq, k.shape[1], s, d, int(causal),
            float(scale), _stream(q),
        )
    _build.check(rc, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = True,
                   scale: float | None = None):
    """dK and dV at kv-head count from (q, k, v, dO, lse, delta).
    Replaces ``_flash_bwd_dkdv_kernel``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _is_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkdv_reference(q, k, v, do, lse, delta, causal,
                                        scale)
    _check_flash_args("flash_bwd_dkdv", q, k, v,
                      dict(q=q, k=k, v=v, do=do),
                      dict(lse=lse, delta=delta))
    if do.shape != q.shape:
        raise ValueError(f"flash_bwd_dkdv: do {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    b, hq, s, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _flash_library().flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, hq, k.shape[1], s, d, int(causal), float(scale), _stream(q),
        )
    _build.check(rc, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return dk, dv


flash_bwd_dkdv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 scale: float | None = None):
    """dQ per query head from (q, k, v, dO, lse, delta). Replaces
    ``_flash_bwd_dq_kernel``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _is_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    _check_flash_args("flash_bwd_dq", q, k, v, dict(q=q, k=k, v=v, do=do),
                      dict(lse=lse, delta=delta))
    if do.shape != q.shape:
        raise ValueError(f"flash_bwd_dq: do {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    b, hq, s, d = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _flash_library().flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, hq,
            k.shape[1], s, d, int(causal), float(scale), _stream(q),
        )
    _build.check(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_attention_forward(q, k, v, causal: bool = True,
                            scale: float | None = None,
                            return_lse: bool = False):
    """Counterpart of ``_flash_attention_pallas``: out, or (out, lse) with
    ``return_lse`` -- what each ring-attention hop needs."""
    out, lse = flash_fwd(q, k, v, causal, scale)
    return (out, lse) if return_lse else out


def flash_attention_backward(q, k, v, out, lse, do, causal: bool = True,
                             scale: float | None = None):
    """Counterpart of ``_flash_attention_bwd_pallas``: (dq, dk, dv).
    ``delta = rowsum(dO * O)`` is plain f32 PyTorch, outside the kernels,
    as the reference leaves it to XLA."""
    delta = (do.float() * out.float()).sum(dim=-1)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal, scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


@torch.library.custom_op("tpu_dra::flash_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def flash_site(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, scale: float) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Autograd through the flash kernels (the place of ``_flash_diff``),
    as one op the dispatcher sees: (out, lse) from :func:`flash_fwd`. Its
    registered backward rebuilds the score tiles from lse (K5, K6), so
    neither direction holds an [S, S] tensor. lse is a residual: it
    carries no gradient.

    Being one op, it is the ``flash_out`` site of the named remat
    policies (``models/remat.py``): a policy that saves it keeps out and
    lse, and the recompute of the block skips K4. Its inputs are q, k, v
    as the kernel reads them (contiguous). On CPU tensors it runs the
    plain versions: ``flash_fwd_reference`` forward, and autograd through
    :func:`attention_reference` backward (the model's plain path, which
    the plain versions of K5 and K6 match to rounding)."""
    return flash_fwd(q, k, v, causal, scale)


def _flash_site_setup(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.scale = causal, scale


def _flash_site_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if _is_cpu(q, k, v):
        # The plain path: autograd through plain attention, recomputed
        # from q, k, v (the scores, as K5 and K6 rebuild them).
        g = q.shape[1] // k.shape[1]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            ref = attention_reference(leaves[0], _repeat_kv(leaves[1], g),
                                      _repeat_kv(leaves[2], g), ctx.causal,
                                      ctx.scale)
        return (*torch.autograd.grad(ref, leaves, do), None, None)
    dq, dk, dv = flash_attention_backward(
        q, k, v, out, lse, do.contiguous(), ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


flash_site.register_autograd(_flash_site_backward,
                             setup_context=_flash_site_setup)


def flash_attention(q, k, v, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Multi-head attention with GQA, q [B, Hq, S, D], k/v [B, H_kv, S, D],
    through :func:`flash_site`: on CUDA tensors the kernels forward and
    backward, query head h reading kv head h // G in place (or a raise);
    on CPU tensors their plain versions."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out, _ = flash_site(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal, scale)
    return out
