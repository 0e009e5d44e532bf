"""Fused ragged MoE dispatch: the dispatch plan, the hand-written Hopper
kernels of the route -> dispatch -> expert -> combine pipeline and of its
backward, and their plain PyTorch versions. Counterpart of
``k8s_dra_driver_tpu/ops/moe_dispatch.py``.

- :func:`build_plan` lays every (token, expert) pair into an
  expert-major buffer of ``r_pad`` rows whose per-expert regions start at
  tile boundaries, so each row tile belongs to exactly one expert. It is
  integer PyTorch and gives the reference's plan bit for bit; its index
  tensors come from one op (:func:`plan_site`), the ``moe_routing`` site
  of the named remat policies.
- :func:`moe_gateup` wraps ``moe_gateup`` of ``csrc/moe_dispatch.cu``,
  which replaces ``_gateup_kernel`` (with ``_gather_rows_dma``): it
  gathers each tile's token rows itself, computes both halves of the
  gate/up projection against the tile's expert in f32 and writes
  ``silu(g) * u`` in the input dtype. Sentinel rows come out exactly 0.
- :func:`moe_down_combine` wraps ``moe_down_combine``, which replaces
  ``_down_combine_kernel`` (with ``_scatter_rows_dma``): the
  down-projection in f32, times each row's router gate, written straight
  to the row's token-major pair slot. Slots of no live pair stay 0.
- :func:`dispatch_plan` picks the launch of both from host integers
  alone (the row tile, ``r_pad``, the widths, int8 or not, the card's SM
  count; never the routing, never a device sync): each kernel's form of
  the one wgmma body (the swapped form for int8 experts at decode), its
  column block, and the int8 K8's split of its contracted axis.
- :func:`grouped_matmul` and :func:`grouped_weight_grad` wrap ``gmm`` and
  ``tgmm`` of ``csrc/grouped_matmul.cu``, which replace megablox ``gmm``
  and ``tgmm``: ``lax.ragged_dot`` over any group sizes, and the per-group
  weight gradient ``lhs_e^T . rhs_e``. :class:`GroupedMatmulFunction` gives
  ``grouped_matmul`` megablox's VJP (one more ``gmm`` and one ``tgmm``).
- :class:`FusedMoeMlpFunction` is the fused pipeline with the reference's
  custom VJP: K7 then K8 forward, and a backward of three grouped products
  and two grouped weight gradients (:func:`fused_moe_mlp`).
- :func:`reference_moe_mlp` is the reference's oracle: gathers plus
  grouped products over the same layout, all plain versions
  (:func:`_reference_parts`, which the primitive path runs with kernels).
- int8 experts (``models/quant.py`` ``QuantTensor`` stacks, matched by
  duck typing: ops import nothing of models) run forward only. The fused
  pipeline hands them to :func:`moe_gateup_int8` and
  :func:`moe_down_combine_int8`, the wrappers of the kernels' int8
  branches (int8 weights into the products, per-column scales in the
  epilogues), counted apart from the bf16 launches. ``grouped_matmul``
  with an int8 rhs (the primitive path's, the reference's ``ragged_dot``
  int8 branch) runs :func:`grouped_matmul_int8`, the wrapper of
  ``csrc/grouped_matmul_int8.cu``: the int8 weight read as it is stored,
  f32 sums, each column's scale in the epilogue; :func:`int8_gmm_plan`
  picks its body (the swapped form at decode, the int8-image wgmma body
  at prefill) from host integers.
- A tensor shard's gate/up block is the strided view ``[E, H, 2, M / T]``
  of the whole ``[E, H, 2, M]`` stack (``models/moe.py``). The primitive
  path takes it through its strides (:func:`gateup_product`): the int8
  kernel in one launch over both halves, K10a in one launch per half
  (its expert maps take a row and an expert stride). No weight copy.

Each kernel has its plain version beside it (``*_reference``). A kernel
wrapper takes it only for CPU tensors, or where the caller passes
``use_kernels=False`` (the kernel-versus-plain comparison). For CUDA
tensors it launches its kernel (counted in ``<wrapper>.launches``) or
raises: bf16 inputs, bf16 weights or int8 weights with f32 scales, row
tiles that are multiples of 8 up to 128, and the widths
:func:`fused_geometry_ok` names. The reference's
``TPU_DRA_MOE_*`` environment knobs are module constants here
(:data:`TILE_ROWS`, :data:`TILE_COLS`) and :func:`set_dispatch_impl`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import torch

from . import _build
from ._device import sm_count

#: Largest row tile of the default plan (the reference's
#: ``TPU_DRA_MOE_TILE_ROWS`` default).
TILE_ROWS = 128
#: Column tile of the reference's kernels (``TPU_DRA_MOE_TILE_COLS``);
#: kept for :func:`_fit_cols`. The CUDA kernels fix their own widths.
TILE_COLS = 512
#: The CUDA kernels take H and M in whole blocks of 64 (output columns in
#: blocks of 64, 128 or 256, the contracted axis in 64-deep stages; see
#: ``csrc/moe_dispatch.cu``).
KERNEL_COLS = 64
K_STEP = 64
#: int8 experts take the swapped form at row tiles up to this size.
SWAP_MAX_TILE = 16
#: The int8 K8's largest split of its contracted axis.
MAX_SPLIT = 4

_DISPATCH_IMPL = "auto"

_SOURCE = "moe_dispatch"
_GROUPED_SOURCE = "grouped_matmul"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
# Shapes, then the plan: (n, widths, r_pad, tile, n_experts, body, cols).
_GATEUP_ARGTYPES = [_PTR] * 5 + [_INT] * 8 + [_PTR]
_DOWN_ARGTYPES = [_PTR] * 6 + [_INT] * 8 + [_PTR]
# The int8 entry points take the weights' scale after the weights, and
# the int8 K8 its split scratch after the output and its split last.
_GATEUP_INT8_ARGTYPES = [_PTR] * 6 + [_INT] * 8 + [_PTR]
_DOWN_INT8_ARGTYPES = [_PTR] * 8 + [_INT] * 9 + [_PTR]
_GMM_ARGTYPES = [_PTR] * 4 + [_INT] * 5 + [ctypes.c_longlong] * 2 + [_PTR]
_TGMM_ARGTYPES = [_PTR] * 4 + [_INT] * 4 + [_PTR]
_LIB = None
_GROUPED_LIB = None
_INT8_GROUPED_SOURCE = "grouped_matmul_int8"
# Shapes and strides, then the plan: (body, rows a pass, columns a block,
# the grid's x and y).
_INT8_GMM_ARGTYPES = ([_PTR] * 5 + [_INT] * 5 + [ctypes.c_longlong] * 5
                      + [_INT] * 3 + [ctypes.c_longlong] * 2 + [_PTR])
_INT8_GROUPED_LIB = None
#: The grouped kernels' width steps: gmm takes K in steps of 32 and N of
#: 64, tgmm K and N in steps of 64 (``csrc/grouped_matmul.cu``).
GMM_K_STEP = 32
GROUPED_COLS = 64


def set_dispatch_impl(impl: str) -> None:
    """Select the MoE dispatch backend: "auto" (the kernels for CUDA
    tensors, the gather + grouped-matmul path on the CPU), "fused" (the
    kernel pipeline everywhere; on the CPU its plain versions) or
    "primitive" (the gather + grouped-matmul path everywhere)."""
    global _DISPATCH_IMPL
    if impl not in ("auto", "fused", "primitive"):
        raise ValueError(f"unknown dispatch impl {impl!r}")
    _DISPATCH_IMPL = impl


def dispatch_impl_label(h: int | None = None, m: int | None = None,
                        device=None) -> str:
    """What the dropless MLP runs for tensors on ``device`` (default: the
    CUDA device where there is one, else the CPU), outside any mesh.
    Pass ``h``/``m`` to fold in the kernels' shape limits: the label
    never says "fused" for a CUDA run those limits send down the
    primitive path."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if _DISPATCH_IMPL == "primitive":
        return "primitive"
    if _DISPATCH_IMPL != "fused" and dev.type != "cuda":
        return "primitive"
    if (dev.type == "cuda" and h is not None and m is not None
            and not fused_geometry_ok(h, m)):
        return "primitive"
    return "fused"


def fused_geometry_ok(h: int, m: int) -> bool:
    """Whether the CUDA kernels take a [.., H] x [E, H, 2, M] problem:
    H and M each in whole blocks of 64 (both are an output width of one
    kernel and the contracted axis of the other). The plain versions take
    any shape."""
    return h % KERNEL_COLS == 0 and m % KERNEL_COLS == 0


def use_fused(h: int | None = None, m: int | None = None,
              device=None, under_mesh: bool = False) -> bool:
    """Whether the fused pipeline is selected for tensors on ``device``.
    ``under_mesh`` (dropless on a mesh without an expert axis, or on an
    expert axis beside tensor or fsdp: the reference's GSPMD cases)
    selects the primitive path, as there."""
    if under_mesh:
        return False
    return dispatch_impl_label(h, m, device) == "fused"


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _fit_cols(n: int, want: int) -> int:
    """A column tile <= want dividing n (gcd, as the reference picks)."""
    return math.gcd(n, want)


def default_tile_rows(n_pairs: int, n_experts: int) -> int:
    """Row-tile heuristic: big tiles amortize the per-tile row gather,
    but ``r_pad`` grows by E * tile of padding, so at decode shapes the
    tile clamps toward the per-expert row count."""
    per_expert = max(1, n_pairs // max(n_experts, 1))
    return max(8, min(TILE_ROWS, _round_up(per_expert, 8)))


# ---------------------------------------------------------------------------
# Dispatch plan.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DispatchPlan:
    """Index maps for one routed MoE layer invocation (int32 tensors).

    Slots live in an expert-major buffer of ``r_pad`` rows; expert e's
    rows occupy [aligned_start_e, aligned_start_e + count_e) with every
    aligned start a multiple of ``tile_rows``. Sentinels: ``row_ids`` =
    n_tokens (gathered as a zero row), ``pair_ids`` = n_pairs (never
    written), ``slot_of_pair`` = r_pad (a foreign pair's expert lies
    outside this plan's range).
    """

    row_ids: torch.Tensor        # [r_pad] source token row per slot
    pair_ids: torch.Tensor       # [r_pad] token-major pair id per slot
    slot_of_pair: torch.Tensor   # [n_pairs] slot per pair (inverse map)
    tile_expert: torch.Tensor    # [r_pad // tile_rows] expert per tile
    sizes_aligned: torch.Tensor  # [n_experts] tile-aligned group sizes
    tile_rows: int
    n_tokens: int
    n_pairs: int
    n_experts: int
    top_k: int

    @property
    def r_pad(self) -> int:
        return self.row_ids.shape[0]


def build_plan(
    experts_flat: torch.Tensor,   # [n_pairs] int; >= n_experts = foreign
    n_tokens: int,
    n_experts: int,
    top_k: int,
    tile_rows: int | None = None,
) -> DispatchPlan:
    """The dispatch layout from per-pair expert assignments: one stable
    argsort and a few scatters (:func:`plan_site`), every shape fixed by
    (n_pairs, n_experts, tile). Foreign pairs (expert id >= ``n_experts``)
    get no slot."""
    r = experts_flat.shape[0]
    tile = tile_rows or default_tile_rows(r, n_experts)
    return DispatchPlan(*plan_site(experts_flat, n_tokens, n_experts, top_k,
                                   tile),
                        tile_rows=tile, n_tokens=n_tokens, n_pairs=r,
                        n_experts=n_experts, top_k=top_k)


@torch.library.custom_op("tpu_dra::moe_plan", mutates_args=(),
                         device_types=("cpu", "cuda"))
def plan_site(experts_flat: torch.Tensor, n_tokens: int, n_experts: int,
              top_k: int, tile: int) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The plan's index tensors (row_ids, pair_ids, slot_of_pair,
    tile_expert, sizes_aligned; int32) as one op the dispatcher sees: the
    ``moe_routing`` site of the named remat policies
    (``models/remat.py``), whose recompute then skips the sort and the
    scatters."""
    dev = experts_flat.device
    r = experts_flat.shape[0]
    e = n_experts
    r_pad = _round_up(r, tile) + e * tile

    key = torch.where(experts_flat < e, experts_flat,
                      torch.full_like(experts_flat, e)).long()
    # Stable: pair order within an expert is token order.
    order = torch.argsort(key, stable=True)
    # A scatter-add, not bincount: bincount on a CUDA tensor sizes its
    # output from the data and so waits for the device.
    counts = torch.zeros(e + 1, dtype=torch.long, device=dev).scatter_add_(
        0, key, torch.ones_like(key))[:e]
    aligned = (counts + tile - 1) // tile * tile
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    starts = torch.cat([zero, torch.cumsum(counts, 0)])[:-1]
    starts_aligned = torch.cat([zero, torch.cumsum(aligned, 0)])[:-1]

    g = key[order]                                      # sorted experts
    total = counts.sum().reshape(1)
    rank = torch.arange(r, device=dev) - torch.cat([starts, total])[g]
    dest = torch.where(
        g < e,
        torch.cat([starts_aligned,
                   torch.full((1,), r_pad, dtype=torch.long, device=dev)])[g]
        + rank,
        torch.full_like(g, r_pad),
    )
    # The reference's ``.at[dest].set(..., mode="drop")``: sentinel
    # destinations land in one extra row that is cut off.
    row_ids = torch.full((r_pad + 1,), n_tokens, dtype=torch.long,
                         device=dev)
    row_ids[dest] = order // top_k
    pair_ids = torch.full((r_pad + 1,), r, dtype=torch.long, device=dev)
    pair_ids[dest] = order
    slot_of_pair = torch.full((r,), r_pad, dtype=torch.long, device=dev)
    slot_of_pair[order] = dest
    # Groups are tile-aligned, so a tile's expert is the region its first
    # row falls in; tiles past the last region clip to E-1 (all their
    # rows are sentinels).
    n_tiles = r_pad // tile
    tile_expert = (
        torch.searchsorted(starts_aligned,
                           torch.arange(n_tiles, device=dev) * tile,
                           right=True) - 1
    ).clamp(0, e - 1)
    i32 = torch.int32
    return (row_ids[:r_pad].to(i32), pair_ids[:r_pad].to(i32),
            slot_of_pair.to(i32), tile_expert.to(i32), aligned.to(i32))


# ---------------------------------------------------------------------------
# int8 weights.
# ---------------------------------------------------------------------------


def _quant_parts(w):
    """(q, scale) of an int8 ``QuantTensor`` (duck typed), else (w,
    None)."""
    if hasattr(w, "q") and hasattr(w, "scale"):
        return w.q, w.scale
    return w, None


def _row_scale(scale: torch.Tensor, group_sizes: torch.Tensor,
               rows: int) -> torch.Tensor:
    """Per-row dequant scale [rows, N] of a grouped product: each row takes
    the scale of the group its position falls in; rows past the last
    group take the last group's (their products are zero)."""
    e = group_sizes.shape[0]
    bounds = torch.cumsum(group_sizes.long(), 0)
    row_group = torch.searchsorted(
        bounds, torch.arange(rows, device=group_sizes.device), right=True,
    ).clamp(0, e - 1)
    return scale.reshape(e, -1)[row_group]


# ---------------------------------------------------------------------------
# K10: grouped matmul (megablox gmm) and grouped weight gradient (tgmm).
# ---------------------------------------------------------------------------


def grouped_matmul_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                             group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain version of ``gmm`` (``lax.ragged_dot``): rows [start_g,
    start_g + size_g) times ``rhs[g]`` as f32 products, rounded to
    ``lhs``'s dtype; rows past the last group are 0."""
    rows = lhs.shape[0]
    out = torch.zeros(rows, rhs.shape[2], dtype=lhs.dtype,
                      device=lhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(size, 0), rows)
        if end > start:
            out[start:end] = (lhs[start:end].float()
                              @ rhs[g].float()).to(lhs.dtype)
        start += max(size, 0)
    return out


def _row_groups(group_sizes: torch.Tensor, rows: int) -> torch.Tensor:
    """The group of each of ``rows`` rows under cumulative sizes; -1 past
    the last group."""
    bounds = torch.cumsum(group_sizes.clamp(min=0).long(), 0)
    groups = torch.searchsorted(
        bounds, torch.arange(rows, device=group_sizes.device), right=True)
    return torch.where(groups < group_sizes.numel(), groups,
                       torch.full_like(groups, -1))


def grouped_weight_grad_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                                  row_group: torch.Tensor,
                                  n_groups: int) -> torch.Tensor:
    """The plain version of ``tgmm`` (the reference's fallback): dW[g] =
    the f32 product of ``lhs``'s and ``rhs``'s rows of group g ([E, K, N]
    f32); rows of no group (``row_group`` -1, or any group for rows whose
    lhs is zero) add nothing."""
    lhs32, rhs32 = lhs.float(), rhs.float()
    out = torch.zeros(n_groups, lhs.shape[1], rhs.shape[1],
                      dtype=torch.float32, device=lhs.device)
    for g in range(n_groups):
        rows = torch.nonzero(row_group == g).flatten()
        if rows.numel():
            out[g] = lhs32[rows].T @ rhs32[rows]
    return out


def _grouped_library():
    global _GROUPED_LIB
    if _GROUPED_LIB is None:
        lib = _build.load(_GROUPED_SOURCE)
        lib.grouped_matmul.argtypes = _GMM_ARGTYPES
        lib.grouped_matmul.restype = _INT
        lib.grouped_weight_grad.argtypes = _TGMM_ARGTYPES
        lib.grouped_weight_grad.restype = _INT
        _GROUPED_LIB = lib
    return _GROUPED_LIB


def _int8_grouped_library():
    global _INT8_GROUPED_LIB
    if _INT8_GROUPED_LIB is None:
        lib = _build.load(_INT8_GROUPED_SOURCE)
        lib.grouped_matmul_int8.argtypes = _INT8_GMM_ARGTYPES
        lib.grouped_matmul_int8.restype = _INT
        _INT8_GROUPED_LIB = lib
    return _INT8_GROUPED_LIB


def _check_grouped(kernel: str, group_sizes: torch.Tensor,
                   **operands) -> None:
    """What the grouped kernels take: one CUDA device, bf16 operands,
    int32 group sizes, 16-byte aligned."""
    dev = next(iter(operands.values())).device
    for name, x in {**operands, "group_sizes": group_sizes}.items():
        if x.device != dev or not x.is_cuda:
            raise ValueError(
                f"{kernel}: {name} on {x.device}; every input must sit on "
                f"one CUDA device (or all on the CPU)"
            )
        if x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
    for name, x in operands.items():
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{kernel}: {name} is {x.dtype}; the kernel "
                            f"takes bf16")
    if group_sizes.dtype != torch.int32 or not group_sizes.is_contiguous():
        raise TypeError(f"{kernel}: group_sizes must be contiguous int32, "
                        f"got {group_sizes.dtype}")


def _check_gmm_widths(k: int, n: int) -> None:
    if k % GMM_K_STEP or n % GROUPED_COLS:
        raise ValueError(
            f"grouped_matmul: K {k}, N {n}; the kernel takes K in multiples "
            f"of {GMM_K_STEP} and N in multiples of {GROUPED_COLS}")


def grouped_matmul_label(m: int, kk: int, nn: int, device=None) -> str:
    """Which body ``grouped_matmul`` runs for a bf16 [m, kk] x [E, kk, nn]
    problem on ``device`` (default: the CUDA device where there is one,
    else the CPU): ``"cuda"`` (K10a, ``csrc/grouped_matmul.cu``) or
    ``"plain"`` (:func:`grouped_matmul_reference`). Widths the kernel does
    not take raise here as they do in the wrapper: there is no fallback."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type != "cuda":
        return "plain"
    _check_gmm_widths(kk, nn)
    return "cuda"


def _gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor,
         use_kernels: bool = True) -> torch.Tensor:
    """K10a without autograd: the ``gmm`` kernel for CUDA tensors, its
    plain version for CPU tensors or with ``use_kernels=False``."""
    if not use_kernels or _is_cpu(lhs, rhs, group_sizes):
        return grouped_matmul_reference(lhs, rhs, group_sizes)
    _check_grouped("grouped_matmul", group_sizes, lhs=lhs, rhs=rhs)
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[1] != lhs.shape[1] \
            or group_sizes.shape != (rhs.shape[0],):
        raise ValueError(
            f"grouped_matmul: lhs {tuple(lhs.shape)}, rhs "
            f"{tuple(rhs.shape)}, group_sizes {tuple(group_sizes.shape)}; "
            f"expected [rows, K], [E, K, N] and [E]")
    rows, k = lhs.shape
    e, _, n = rhs.shape
    if not lhs.is_contiguous():
        raise ValueError("grouped_matmul: lhs must be contiguous")
    # rhs as stored [E, K, N], or the transposed view of a stored [E, N, K]
    # (megablox's transpose_rhs), each possibly a strided view whose rows
    # lie further apart (a tensor shard's half of a gate/up stack): the
    # kernel reads either through its row and expert strides, no copy.
    se, sk, sn = rhs.stride()
    if sn == 1 and sk >= n:
        transposed, ld = 0, sk
    elif sk == 1 and sn >= k:
        transposed, ld = 1, sn
    else:
        raise ValueError(
            "grouped_matmul: rhs must be a row-major [E, K, N] or the "
            "transposed view of a row-major [E, N, K] (rows may be strided)")
    if (ld * 2) % 16 or (se * 2) % 16 or se < (k * ld if not transposed
                                               else n * ld):
        raise ValueError(
            f"grouped_matmul: rhs strides {rhs.stride()}; the kernel takes "
            f"16-byte multiples with experts apart")
    _check_gmm_widths(k, n)
    out = torch.empty(rows, n, dtype=lhs.dtype, device=lhs.device)
    with torch.cuda.device(lhs.device):
        rc = _grouped_library().grouped_matmul(
            lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), rows, k, n, e, transposed, ld, se,
            torch.cuda.current_stream(lhs.device).cuda_stream,
        )
    _build.check(rc, "grouped_matmul")
    grouped_matmul.launches += 1
    return out


def grouped_weight_grad(
    lhs: torch.Tensor,               # [rows, K] forward operand
    rhs: torch.Tensor,               # [rows, N] cotangent
    group_sizes: torch.Tensor,       # [E] int32, cumulative layout
    row_group: torch.Tensor | None,  # [rows] group per row (plain version)
    n_groups: int,
    *,
    use_kernels: bool = True,
) -> torch.Tensor:
    """K10b, megablox ``tgmm``: dW[e] = lhs_e^T . rhs_e over group e's
    rows, [E, K, N] f32. CUDA tensors launch the ``tgmm`` kernel, which
    reads the groups from ``group_sizes``; the plain version (CPU tensors,
    or ``use_kernels=False``) masks by ``row_group`` as the reference's
    fallback does (derived from ``group_sizes`` when None), so rows past
    the groups must carry zero lhs there."""
    if not use_kernels or _is_cpu(lhs, rhs, group_sizes):
        if row_group is None:
            row_group = _row_groups(group_sizes, lhs.shape[0])
        return grouped_weight_grad_reference(lhs, rhs, row_group, n_groups)
    _check_grouped("grouped_weight_grad", group_sizes, lhs=lhs, rhs=rhs)
    rows, k = lhs.shape
    n = rhs.shape[1]
    if rhs.dim() != 2 or rhs.shape[0] != rows \
            or group_sizes.shape != (n_groups,):
        raise ValueError(
            f"grouped_weight_grad: lhs {tuple(lhs.shape)}, rhs "
            f"{tuple(rhs.shape)}, group_sizes {tuple(group_sizes.shape)}; "
            f"expected [rows, K], [rows, N] and [{n_groups}]")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("grouped_weight_grad: lhs and rhs must be "
                         "contiguous")
    if k % GROUPED_COLS or n % GROUPED_COLS:
        raise ValueError(
            f"grouped_weight_grad: K {k}, N {n}; the kernel takes multiples "
            f"of {GROUPED_COLS}")
    out = torch.empty(n_groups, k, n, dtype=torch.float32,
                      device=lhs.device)
    with torch.cuda.device(lhs.device):
        rc = _grouped_library().grouped_weight_grad(
            lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), rows, k, n, n_groups,
            torch.cuda.current_stream(lhs.device).cuda_stream,
        )
    _build.check(rc, "grouped_weight_grad")
    grouped_weight_grad.launches += 1
    return out


grouped_weight_grad.launches = 0


class GroupedMatmulFunction(torch.autograd.Function):
    """Autograd through ``gmm`` with megablox's VJP: dlhs = gmm(dout,
    rhs^T) (a transposed view, no copy) and drhs = tgmm(lhs, dout) in
    rhs's dtype. Runs for CPU tensors too, with the plain versions."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, use_kernels: bool):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.use_kernels = use_kernels
        return _gmm(lhs, rhs, group_sizes, use_kernels)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.to(lhs.dtype).contiguous()
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = _gmm(dout, rhs.transpose(1, 2), group_sizes,
                        ctx.use_kernels)
        if ctx.needs_input_grad[1]:
            drhs = grouped_weight_grad(
                lhs, dout, group_sizes, None, rhs.shape[0],
                use_kernels=ctx.use_kernels,
            ).to(rhs.dtype)
        return dlhs, drhs, None, None


def grouped_matmul(
    lhs: torch.Tensor,           # [rows, K]
    rhs,                         # [E, K, N] (or a transposed [E, N, K]),
                                 # or an int8 QuantTensor
    group_sizes: torch.Tensor,   # [E] int32, cumulative layout
    *,
    use_kernels: bool = True,
) -> torch.Tensor:
    """K10a, megablox ``gmm`` (``lax.ragged_dot``): rows [start_g, start_g
    + size_g) times ``rhs[g]``, summed in f32 and rounded to ``lhs``'s
    dtype; rows past the last group 0. Any group sizes, aligned or not.
    Differentiable (:class:`GroupedMatmulFunction`).

    An int8 ``QuantTensor`` rhs (scale [E, 1, N]; or a gate/up stack [E,
    K, 2, M] with scale [E, 1, 2, M], whose halves give the output's
    [:M] and [M:] columns) takes the reference's ``ragged_dot`` int8
    branch: the f32 product with ``q``, times each row's group scale,
    rounded to ``lhs``'s dtype; forward only, through
    :func:`grouped_matmul_int8` (its plain version for CPU tensors or
    with ``use_kernels=False``)."""
    q, scale = _quant_parts(rhs)
    if scale is None:
        return GroupedMatmulFunction.apply(lhs, rhs, group_sizes,
                                           use_kernels)
    if not use_kernels or _is_cpu(lhs, q, group_sizes):
        return grouped_matmul_int8_reference(lhs, q, scale, group_sizes)
    return grouped_matmul_int8(lhs, q, scale, group_sizes)


grouped_matmul.launches = 0


def _int8_flat(q: torch.Tensor, scale: torch.Tensor):
    """(q [E, K, N], scale [E, 1, N]) of a 3-D stack or of a gate/up stack
    [E, K, 2, M] (the plain version's copy; the kernel reads the halves
    through their strides)."""
    if q.dim() == 4:
        e, k, _, m = q.shape
        return q.reshape(e, k, 2 * m), scale.reshape(e, 1, 2 * m)
    return q, scale


def grouped_matmul_int8_reference(lhs: torch.Tensor, q: torch.Tensor,
                                  scale: torch.Tensor,
                                  group_sizes: torch.Tensor) -> torch.Tensor:
    """The plain version of ``grouped_matmul_int8``: the reference's
    ``ragged_dot`` int8 branch, ``bf16((lhs . q_g) * scale_g)`` per row of
    group g with f32 sums; rows past the last group 0."""
    q, scale = _int8_flat(q, scale)
    y = grouped_matmul_reference(lhs.float(), q.float(), group_sizes)
    return (y * _row_scale(scale, group_sizes, lhs.shape[0])).to(lhs.dtype)


#: ``csrc/grouped_matmul_int8.cu``'s widths: K and N (M for a gate/up
#: stack) in steps of 16 (TMA's zero fill covers the rest of a 64-deep
#: stage and of a column block); the narrow body while the rows fit this
#: many an expert.
INT8_GMM_K_STEP = 16
INT8_GMM_COLS = 16
INT8_GMM_ROWS = 64
#: The two bodies by the C entry point's ``body`` argument.
INT8_GMM_BODIES = {"narrow": 0, "wide": 1}


class Int8GmmPlan(NamedTuple):
    """One launch of ``grouped_matmul_int8``."""
    body: str     # a key of INT8_GMM_BODIES
    rows: int     # narrow: wgmma's N, a group's rows a pass; wide: 128
    cols: int     # output columns of a block, within one half
    grid: tuple   # (x, y) blocks


def int8_gmm_plan(rows: int, n_groups: int, k: int, half_n: int,
                  halves: int = 1) -> Int8GmmPlan:
    """The launch of ``grouped_matmul_int8`` for ``rows`` lhs rows over
    ``n_groups`` groups, contracted depth ``k`` and ``halves`` (1, or 2
    for a gate/up stack) of ``half_n`` columns, from host integers alone:
    never the group sizes, never a sync, so the launch is captured in
    CUDA graphs.

    Rows up to :data:`INT8_GMM_ROWS` an expert (a decode step's few
    tokens) take the narrow body: the swapped form, 128 columns a block,
    a block a (column block, group) plus a row of blocks for the rows past
    the last group, the group's rows in passes of N = 16, 32 or 64 (the
    least that holds ``rows / n_groups``: a larger group takes more
    passes). More rows (a prefill chunk's) take the wide body: a block a
    (row tile of 128, group) intersection and 256 columns, at most
    ``ceil(rows / 128) + n_groups`` items (K10a's walk). No choice reads
    the SM count: the narrow body's four blocks an SM fit Mixtral's
    decode in one wave, and 256 columns were faster than 128 at every
    8x7b and 8x160m shape on the H100 (PERF.md)."""
    if not all(type(v) is int for v in (rows, n_groups, k, half_n, halves)):
        raise TypeError("int8_gmm_plan takes host integers, not tensors")
    if rows < 0 or n_groups <= 0 or halves not in (1, 2) \
            or k <= 0 or k % INT8_GMM_K_STEP \
            or half_n <= 0 or half_n % INT8_GMM_COLS:
        raise ValueError(
            f"int8_gmm_plan: rows {rows}, groups {n_groups}, K {k}, N "
            f"{half_n}, halves {halves}; the kernel takes K in multiples of "
            f"{INT8_GMM_K_STEP} and N in multiples of {INT8_GMM_COLS}")
    if rows <= n_groups * INT8_GMM_ROWS:
        per_group = -(-rows // n_groups)
        nr = next(v for v in (16, 32, 64) if v >= per_group)
        return Int8GmmPlan("narrow", nr, 128,
                           (halves * -(-half_n // 128), n_groups + 1))
    return Int8GmmPlan("wide", 128, 256,
                       ((-(-rows // 128) + n_groups) * halves
                        * -(-half_n // 256), 1))


class Int8GmmLaunch(NamedTuple):
    """The C entry point's shape, stride and plan arguments of one
    ``grouped_matmul_int8`` call."""
    rows: int
    k: int
    n: int
    n_groups: int
    half_n: int
    strides: tuple  # q's (expert, row, half) in bytes, scale's (expert,
                    # half) in elements
    plan: Int8GmmPlan


def int8_gmm_launch(lhs: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor,
                    group_sizes: torch.Tensor) -> Int8GmmLaunch:
    """What ``grouped_matmul_int8`` hands the kernel, from the operands'
    dtypes, shapes, strides and alignment (on any device; no data is
    read), or its refusal: lhs bf16 [rows, K] contiguous, q int8 [E, K,
    N] or a gate/up stack [E, K, 2, M] with a contiguous last axis and
    16-byte multiples for its other strides, scale f32 [E, 1, N] or [E, 1,
    2, M] with a contiguous last axis, group sizes int32 [E]; K and N (M)
    multiples of :data:`INT8_GMM_K_STEP` / :data:`INT8_GMM_COLS`."""
    if lhs.dtype != torch.bfloat16 or q.dtype != torch.int8 \
            or scale.dtype != torch.float32 \
            or group_sizes.dtype != torch.int32:
        raise TypeError(
            f"grouped_matmul_int8: lhs {lhs.dtype}, q {q.dtype}, scale "
            f"{scale.dtype}, group_sizes {group_sizes.dtype}; the kernel "
            f"takes bf16, int8, float32 and int32")
    if lhs.dim() != 2 or not lhs.is_contiguous() or lhs.data_ptr() % 16:
        raise ValueError("grouped_matmul_int8: lhs must be a contiguous, "
                         "16-byte aligned [rows, K]")
    rows, k = lhs.shape
    halves = q.dim() == 4
    if q.dim() not in (3, 4) or q.shape[1] != k \
            or (halves and q.shape[2] != 2) \
            or group_sizes.shape != (q.shape[0],) \
            or not group_sizes.is_contiguous():
        raise ValueError(
            f"grouped_matmul_int8: lhs {tuple(lhs.shape)}, q "
            f"{tuple(q.shape)}, group_sizes {tuple(group_sizes.shape)}; "
            f"expected [rows, K], [E, K, N] or [E, K, 2, M], and [E]")
    e = q.shape[0]
    half_n = q.shape[-1]
    want_scale = (e, 1, 2, half_n) if halves else (e, 1, half_n)
    if tuple(scale.shape) != want_scale:
        raise ValueError(f"grouped_matmul_int8: scale {tuple(scale.shape)}, "
                         f"expected {want_scale}")
    q_se, q_sk = q.stride(0), q.stride(1)
    q_sh = q.stride(2) if halves else 0
    if q.stride(-1) != 1 or scale.stride(-1) != 1 \
            or any(v % 16 for v in (q_se, q_sk, q_sh)) \
            or q.data_ptr() % 16:
        raise ValueError(
            f"grouped_matmul_int8: q strides {q.stride()}, scale strides "
            f"{scale.stride()}; the kernel takes a contiguous last axis, "
            f"16-byte aligned rows")
    if k % INT8_GMM_K_STEP or half_n % INT8_GMM_COLS:
        raise ValueError(
            f"grouped_matmul_int8: K {k}, N {half_n}; the kernel takes K in "
            f"multiples of {INT8_GMM_K_STEP} and N in multiples of "
            f"{INT8_GMM_COLS}")
    return Int8GmmLaunch(
        rows, k, 2 * half_n if halves else half_n, e, half_n,
        (q_se, q_sk, q_sh, scale.stride(0), scale.stride(2) if halves else 0),
        int8_gmm_plan(rows, e, k, half_n, 2 if halves else 1))


def grouped_matmul_int8(lhs: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """A7b: the int8 grouped product on the card, ``csrc/
    grouped_matmul_int8.cu``. ``y[r] = bf16((sum_k lhs[r, k] q[g(r), k,
    n]) * scale[g(r), n])``, f32 sums, rows at or past ``sum(group_sizes)``
    0. The operands as :func:`int8_gmm_launch` takes them (a tensor
    shard's strided block of the whole stack read as it lies, no copy; a
    gate/up stack's output columns [:M] the gate half), the launch from
    :func:`int8_gmm_plan`. Counted in ``.launches``, and by part in
    ``.<narrow|wide>_<gateup|down>_launches``: gate/up for a stack of two
    halves, down otherwise; narrow where the rows fit
    :data:`INT8_GMM_ROWS` an expert (a decode step's few tokens), wide
    past that (a prefill chunk's). Raises on anything else (no
    fallback)."""
    if not (lhs.is_cuda and q.is_cuda and scale.is_cuda
            and group_sizes.is_cuda):
        raise ValueError("grouped_matmul_int8: every input must sit on one "
                         "CUDA device")
    dev = lhs.device
    for name, x in (("q", q), ("scale", scale), ("group_sizes", group_sizes)):
        if x.device != dev:
            raise ValueError(f"grouped_matmul_int8: {name} on {x.device}, "
                             f"lhs on {dev}")
    a = int8_gmm_launch(lhs, q, scale, group_sizes)
    out = torch.empty(a.rows, a.n, dtype=torch.bfloat16, device=dev)
    if a.rows == 0:
        return out
    p = a.plan
    with torch.cuda.device(dev):
        rc = _int8_grouped_library().grouped_matmul_int8(
            lhs.data_ptr(), q.data_ptr(), scale.data_ptr(),
            group_sizes.data_ptr(), out.data_ptr(), a.rows, a.k, a.n,
            a.n_groups, a.half_n, *a.strides, INT8_GMM_BODIES[p.body],
            p.rows, p.cols, *p.grid,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "grouped_matmul_int8")
    grouped_matmul_int8.launches += 1
    part = f"{p.body}_{'gateup' if a.n != a.half_n else 'down'}_launches"
    setattr(grouped_matmul_int8, part,
            getattr(grouped_matmul_int8, part) + 1)
    return out


#: The launch counters of ``grouped_matmul_int8`` by part (see its
#: docstring); their sum is ``.launches``.
INT8_GMM_PARTS = tuple(f"{w}_{p}_launches" for w in ("narrow", "wide")
                       for p in ("gateup", "down"))
grouped_matmul_int8.launches = 0
for _part in INT8_GMM_PARTS:
    setattr(grouped_matmul_int8, _part, 0)


def gateup_product(xs: torch.Tensor, w_gu, group_sizes: torch.Tensor,
                   use_kernels: bool = True) -> torch.Tensor:
    """The primitive path's gate/up product, [rows, 2M] with the gate half
    first, of a stack [E, H, 2, M]: as one [E, H, 2M] product where the
    stack reshapes without a copy; a strided block (a tensor shard's)
    through its strides -- one ``grouped_matmul_int8`` launch for int8
    weights, one K10a launch per half for bf16."""
    q, scale = _quant_parts(w_gu)
    if scale is not None:
        return grouped_matmul(xs, w_gu, group_sizes, use_kernels=use_kernels)
    e, h, _, m = w_gu.shape
    try:
        flat = w_gu.view(e, h, 2 * m)
    except RuntimeError:
        return torch.cat([
            grouped_matmul(xs, w_gu[:, :, i, :], group_sizes,
                           use_kernels=use_kernels) for i in (0, 1)], dim=1)
    return grouped_matmul(xs, flat, group_sizes, use_kernels=use_kernels)


def _gu_2d(w_gu):
    """[E, H, 2, M] -> [E, H, 2M]: [:, :, :M] is the gate half. An int8
    QuantTensor reshapes both leaves (scale to [E, 1, 2M])."""
    e, h, _, m = w_gu.shape
    q, scale = _quant_parts(w_gu)
    if scale is None:
        return w_gu.reshape(e, h, 2 * m)
    return dataclasses.replace(w_gu, q=q.reshape(e, h, 2 * m),
                               scale=scale.reshape(e, 1, 2 * m))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0 with out-of-range ids as zero rows (the
    reference's ``jnp.take(..., mode="fill", fill_value=0)``)."""
    n = x.shape[0]
    valid = (idx >= 0) & (idx < n)
    rows = x[torch.where(valid, idx, torch.zeros_like(idx)).long()]
    mask = valid.reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(mask, rows, torch.zeros_like(rows))


def _reference_parts(xf, w_gu, w_down, gates, plan: DispatchPlan,
                     use_kernels: bool):
    """(sorted activations [r_pad, M], token-major pair outputs [n_pairs,
    H] f32) by gathers and grouped products over the plan's layout:
    ``gmm`` on the card with ``use_kernels``, the plain versions without.
    Differentiable (the gathers by autograd, the products by
    :class:`GroupedMatmulFunction`). Equal to the fused pipeline up to
    rounding: its gate/up product is rounded to the input dtype before
    SwiGLU."""
    m = w_down.shape[1]
    xs = _take_rows(xf, plan.row_ids)
    gu = gateup_product(xs, w_gu, plan.sizes_aligned, use_kernels)
    gate = torch.nn.functional.silu(gu[:, :m].float())
    up = gu[:, m:].float()
    act = (gate * up).to(xf.dtype)
    ys = grouped_matmul(act, w_down, plan.sizes_aligned,
                        use_kernels=use_kernels)
    gates_pad = _take_rows(gates, plan.pair_ids)
    yw = ys.float() * gates_pad[:, None]
    return act, _take_rows(yw, plan.slot_of_pair)


def reference_moe_mlp(xf, w_gu, w_down, gates, plan: DispatchPlan):
    """The oracle: :func:`_reference_parts` with every product a plain
    version (the reference passes ``use_pallas=False``); returns
    token-major pair contributions [n_pairs, H] f32."""
    return _reference_parts(xf, w_gu, w_down, gates, plan,
                            use_kernels=False)[1]


# ---------------------------------------------------------------------------
# K7 and K8: plain versions and kernel wrappers.
# ---------------------------------------------------------------------------


def _row_expert(plan: DispatchPlan) -> torch.Tensor:
    return plan.tile_expert.long().repeat_interleave(plan.tile_rows)


def moe_gateup_reference(xf: torch.Tensor, w_gu: torch.Tensor,
                         plan: DispatchPlan,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of ``moe_gateup``: act [r_pad, M] in xf's dtype,
    ``silu(g) * u`` with g and u the f32 products of each live row with
    its tile's expert, sentinel rows exactly 0. With int8 ``w_gu``,
    ``scale`` [E, 1, 2, M] multiplies g and u before SwiGLU."""
    _, h, _, m = w_gu.shape
    act = torch.zeros(plan.r_pad, m, dtype=xf.dtype, device=xf.device)
    live = plan.row_ids < plan.n_tokens
    row_expert = _row_expert(plan)
    for ex in range(w_gu.shape[0]):
        rows = torch.nonzero(live & (row_expert == ex)).flatten()
        if rows.numel() == 0:
            continue
        x = xf[plan.row_ids[rows].long()].float()
        gu = x @ w_gu[ex].reshape(h, 2 * m).float()
        if scale is not None:
            gu = gu * scale[ex].reshape(2 * m)
        g, u = gu[:, :m], gu[:, m:]
        act[rows] = (g * torch.sigmoid(g) * u).to(xf.dtype)
    return act


def moe_down_combine_reference(act: torch.Tensor, w_down: torch.Tensor,
                               gates_pad: torch.Tensor, plan: DispatchPlan,
                               scale: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The plain version of ``moe_down_combine``: y_pairs [n_pairs, H]
    f32, each live row's f32 down product times its gate in its pair's
    slot, every other slot exactly 0. With int8 ``w_down``, ``scale`` [E,
    1, H] multiplies the product before the gate."""
    h = w_down.shape[2]
    out = torch.zeros(plan.n_pairs, h, dtype=torch.float32,
                      device=act.device)
    live = plan.pair_ids < plan.n_pairs
    row_expert = _row_expert(plan)
    gates_pad = gates_pad.reshape(-1)
    for ex in range(w_down.shape[0]):
        rows = torch.nonzero(live & (row_expert == ex)).flatten()
        if rows.numel() == 0:
            continue
        y = act[rows].float() @ w_down[ex].float()
        if scale is not None:
            y = y * scale[ex].reshape(h)
        out[plan.pair_ids[rows].long()] = y * gates_pad[rows, None].float()
    return out


#: The forms of the kernels' body (``csrc/moe_dispatch.cu``) by the C
#: entry points' ``body`` argument.
BODIES = {"wgmma": 0, "swapped": 1}


class MoePlan(NamedTuple):
    """One launch of K7 and K8 over a dispatch plan."""
    gateup_body: str  # K7's form, a key of BODIES
    gateup_cols: int  # K7's output (act) columns a block
    down_body: str    # K8's form
    down_cols: int    # K8's output columns a block
    split: int        # the int8 K8's split of its contracted axis M
    chunk: int        # M // split: the contracted rows of one split


def dispatch_plan(tile: int, r_pad: int, h: int, m: int, int8: bool,
                  sms: int) -> MoePlan:
    """The launch of K7 and K8 for a dispatch plan of row tile ``tile``
    and ``r_pad`` rows at widths H ``h`` and M ``m``, on a card of ``sms``
    SMs, from host integers alone: never the routing, never a sync.

    K7 stages 128 gate and 128 up columns a block (64 + 64 where M is not
    a multiple of 128), K8 the widest of 256, 128 or 64 columns that
    divides H. int8 experts at a tile of at most :data:`SWAP_MAX_TILE`
    rows (decode) take the swapped form where the block stages 256 columns
    and the contracted axis (of a split) is an even number of stages.
    The int8 K8 splits M 2 or 4 ways while its blocks (every tile's, live
    or not: the host cannot see the routing), so split, still fit one wave
    (the body runs one block an SM), keeping whole stages a split. bf16 K8
    never splits: on the H100 no split of it was faster (PERF.md)."""
    if not all(type(v) is int for v in (tile, r_pad, h, m, sms)):
        raise TypeError("dispatch_plan takes host integers, not tensors")
    if h % KERNEL_COLS or m % KERNEL_COLS or tile <= 0 or r_pad % tile:
        raise ValueError(f"dispatch_plan: tile {tile}, r_pad {r_pad}, H {h}, "
                         f"M {m}; widths must be multiples of {KERNEL_COLS}")
    gateup_cols = 128 if m % 128 == 0 else 64
    down_cols = next(c for c in (256, 128, 64) if h % c == 0)
    swap = int8 and tile <= SWAP_MAX_TILE
    blocks = (r_pad // tile) * (h // down_cols)
    split = 1
    while (int8 and split < MAX_SPLIT and 2 * split * blocks <= sms
           and (m // K_STEP) % (2 * split) == 0):
        split *= 2
    chunk = m // split
    return MoePlan(
        "swapped" if swap and gateup_cols == 128 and h % (2 * K_STEP) == 0
        else "wgmma", gateup_cols,
        "swapped" if swap and down_cols == 256 and chunk % (2 * K_STEP) == 0
        else "wgmma", down_cols, split, chunk)


def _library():
    """The built kernel library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        lib.moe_gateup.argtypes = _GATEUP_ARGTYPES
        lib.moe_gateup.restype = _INT
        lib.moe_down_combine.argtypes = _DOWN_ARGTYPES
        lib.moe_down_combine.restype = _INT
        lib.moe_gateup_int8.argtypes = _GATEUP_INT8_ARGTYPES
        lib.moe_gateup_int8.restype = _INT
        lib.moe_down_combine_int8.argtypes = _DOWN_INT8_ARGTYPES
        lib.moe_down_combine_int8.restype = _INT
        _LIB = lib
    return _LIB


def _is_cpu(*tensors) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def _check_cuda(kernel: str, plan: DispatchPlan, **tensors) -> None:
    dev = next(iter(tensors.values())).device
    ints = {"row_ids": plan.row_ids, "pair_ids": plan.pair_ids,
            "tile_expert": plan.tile_expert}
    for name, x in {**tensors, **ints}.items():
        if x.device != dev or not x.is_cuda:
            raise ValueError(
                f"{kernel}: {name} on {x.device}; every input must sit on "
                f"one CUDA device (or all on the CPU)"
            )
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
    for name, x in ints.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} must be int32, got {x.dtype}")
    tile = plan.tile_rows
    if tile % 8 or not 0 < tile <= TILE_ROWS or plan.r_pad % tile:
        raise ValueError(
            f"{kernel}: row tile {tile} (r_pad {plan.r_pad}); the kernel "
            f"takes multiples of 8 up to {TILE_ROWS} that divide r_pad"
        )
    if plan.tile_expert.shape != (plan.r_pad // tile,):
        raise ValueError(f"{kernel}: tile_expert "
                         f"{tuple(plan.tile_expert.shape)} for "
                         f"{plan.r_pad // tile} tiles")


def _check_weights(kernel: str, w: torch.Tensor, h: int, m: int,
                   scale: torch.Tensor | None = None,
                   scale_shape: tuple | None = None) -> None:
    """bf16 weights, or (``scale`` given) int8 weights with an f32 scale of
    ``scale_shape``; widths that :func:`fused_geometry_ok` takes."""
    want = torch.bfloat16 if scale is None else torch.int8
    if w.dtype != want:
        raise TypeError(f"{kernel}: weights are {w.dtype}; the kernel takes "
                        f"bf16, or int8 with an f32 scale")
    if scale is not None and (scale.dtype != torch.float32
                              or tuple(scale.shape) != scale_shape):
        raise TypeError(f"{kernel}: scale {tuple(scale.shape)} "
                        f"{scale.dtype}; expected float32 {scale_shape}")
    if not fused_geometry_ok(h, m):
        raise ValueError(
            f"{kernel}: hidden {h}, expert width {m}; the kernel takes "
            f"multiples of {KERNEL_COLS} (fused_geometry_ok)"
        )


def moe_gateup(xf: torch.Tensor, w_gu: torch.Tensor, plan: DispatchPlan,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """K7: fused row gather + gate/up projection + SwiGLU. xf [T, H];
    w_gu [E, H, 2, M]. Returns the sorted activations [r_pad, M] in xf's
    dtype (sentinel rows exactly 0). int8 ``w_gu`` with its ``scale`` [E,
    1, 2, M] goes to :func:`moe_gateup_int8`."""
    if scale is not None:
        return moe_gateup_int8(xf, w_gu, scale, plan)
    if _is_cpu(xf, w_gu, plan.row_ids, plan.tile_expert):
        return moe_gateup_reference(xf, w_gu, plan)
    act = _gateup_launch("moe_gateup", xf, w_gu, None, plan)
    moe_gateup.launches += 1
    return act


moe_gateup.launches = 0


def moe_gateup_int8(xf: torch.Tensor, w_gu: torch.Tensor,
                    scale: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """The int8 branch of K7: w_gu int8 [E, H, 2, M], scale f32 [E, 1, 2,
    M] on g and u before SwiGLU; otherwise :func:`moe_gateup`."""
    if _is_cpu(xf, w_gu, scale, plan.row_ids, plan.tile_expert):
        return moe_gateup_reference(xf, w_gu, plan, scale)
    act = _gateup_launch("moe_gateup_int8", xf, w_gu, scale, plan)
    moe_gateup_int8.launches += 1
    return act


moe_gateup_int8.launches = 0


def _gateup_launch(kernel, xf, w_gu, scale, plan,
                   launch: MoePlan | None = None) -> torch.Tensor:
    """Checks and launches K7 (``kernel``: either branch's C entry) with
    the launch ``dispatch_plan`` picks, or ``launch``."""
    e, h, two, m = w_gu.shape
    extra = {} if scale is None else {"scale": scale}
    _check_cuda(kernel, plan, xf=xf, w_gu=w_gu, **extra)
    _check_weights(kernel, w_gu, h, m, scale, (e, 1, 2, m))
    if xf.dtype != torch.bfloat16 or xf.dim() != 2 or xf.shape[1] != h \
            or two != 2 or xf.shape[0] != plan.n_tokens:
        raise ValueError(
            f"{kernel}: xf {tuple(xf.shape)} {xf.dtype}, w_gu "
            f"{tuple(w_gu.shape)}; expected bf16 [{plan.n_tokens}, H] and "
            f"[E, H, 2, M]"
        )
    if launch is None:
        launch = dispatch_plan(plan.tile_rows, plan.r_pad, h, m,
                               scale is not None, sm_count(xf.device))
    act = torch.empty(plan.r_pad, m, dtype=xf.dtype, device=xf.device)
    weights = (w_gu,) if scale is None else (w_gu, scale)
    with torch.cuda.device(xf.device):
        rc = getattr(_library(), kernel)(
            xf.data_ptr(), *(x.data_ptr() for x in weights),
            plan.row_ids.data_ptr(), plan.tile_expert.data_ptr(),
            act.data_ptr(), plan.n_tokens, h, m, plan.r_pad, plan.tile_rows,
            e, BODIES[launch.gateup_body], launch.gateup_cols,
            torch.cuda.current_stream(xf.device).cuda_stream,
        )
    _build.check(rc, kernel)
    return act


def moe_down_combine(act: torch.Tensor, w_down: torch.Tensor,
                     gates_pad: torch.Tensor, plan: DispatchPlan,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """K8: fused down-projection + gate weighting + combine scatter.
    act [r_pad, M]; w_down [E, M, H]; gates_pad [r_pad] or [r_pad, 1]
    f32. Returns token-major pair contributions [n_pairs, H] f32, zero
    where no live pair writes. int8 ``w_down`` with its ``scale`` [E, 1,
    H] goes to :func:`moe_down_combine_int8`."""
    if scale is not None:
        return moe_down_combine_int8(act, w_down, scale, gates_pad, plan)
    if _is_cpu(act, w_down, gates_pad, plan.pair_ids, plan.tile_expert):
        return moe_down_combine_reference(act, w_down, gates_pad, plan)
    out = _down_launch("moe_down_combine", act, w_down, None, gates_pad,
                       plan)
    moe_down_combine.launches += 1
    return out


moe_down_combine.launches = 0


def moe_down_combine_int8(act: torch.Tensor, w_down: torch.Tensor,
                          scale: torch.Tensor, gates_pad: torch.Tensor,
                          plan: DispatchPlan) -> torch.Tensor:
    """The int8 branch of K8: w_down int8 [E, M, H], scale f32 [E, 1, H]
    on the product before the gate; otherwise :func:`moe_down_combine`."""
    if _is_cpu(act, w_down, scale, gates_pad, plan.pair_ids,
               plan.tile_expert):
        return moe_down_combine_reference(act, w_down, gates_pad, plan,
                                          scale)
    out = _down_launch("moe_down_combine_int8", act, w_down, scale,
                       gates_pad, plan)
    moe_down_combine_int8.launches += 1
    return out


moe_down_combine_int8.launches = 0


def _down_launch(kernel, act, w_down, scale, gates_pad, plan,
                 launch: MoePlan | None = None) -> torch.Tensor:
    """Checks and launches K8 (``kernel``: either branch's C entry) with
    the launch ``dispatch_plan`` picks, or ``launch``. A split launch (int8
    only) writes gated partial sums to a zero-filled f32 scratch [split,
    n_pairs, H] that the source's second pass sums, in order, into the
    output."""
    e, m, h = w_down.shape
    extra = {} if scale is None else {"scale": scale}
    _check_cuda(kernel, plan, act=act, w_down=w_down, gates_pad=gates_pad,
                **extra)
    _check_weights(kernel, w_down, h, m, scale, (e, 1, h))
    if act.dtype != torch.bfloat16 or act.shape != (plan.r_pad, m):
        raise ValueError(f"{kernel}: act {tuple(act.shape)} {act.dtype}; "
                         f"expected bf16 [{plan.r_pad}, {m}]")
    if gates_pad.dtype != torch.float32 or gates_pad.numel() != plan.r_pad:
        raise TypeError(f"{kernel}: gates_pad {tuple(gates_pad.shape)} "
                        f"{gates_pad.dtype}; expected float32 [{plan.r_pad}]")
    if launch is None:
        launch = dispatch_plan(plan.tile_rows, plan.r_pad, h, m,
                               scale is not None, sm_count(act.device))
    if scale is None and launch.split != 1:
        raise ValueError(f"{kernel}: split {launch.split}; bf16 K8 is never "
                         f"split")
    out = torch.zeros(plan.n_pairs, h, dtype=torch.float32,
                      device=act.device)
    part = (torch.zeros(launch.split, plan.n_pairs, h, dtype=torch.float32,
                        device=act.device) if launch.split > 1 else None)
    if scale is None:  # the bf16 entry takes no scale, scratch or split
        weights, scratch, split = (w_down,), (), ()
    else:
        weights, split = (w_down, scale), (launch.split,)
        scratch = (None if part is None else part.data_ptr(),)
    with torch.cuda.device(act.device):
        rc = getattr(_library(), kernel)(
            act.data_ptr(), *(x.data_ptr() for x in weights),
            gates_pad.data_ptr(), plan.pair_ids.data_ptr(),
            plan.tile_expert.data_ptr(), out.data_ptr(), *scratch,
            plan.n_pairs, m, h, plan.r_pad, plan.tile_rows, e,
            BODIES[launch.down_body], launch.down_cols, *split,
            torch.cuda.current_stream(act.device).cuda_stream,
        )
    _build.check(rc, kernel)
    return out


def swiglu_backward(gu: torch.Tensor, dact: torch.Tensor) -> torch.Tensor:
    """d(silu(g) * u) / d[g | u] times ``dact``: gu [rows, 2M] f32 (gate
    half first), dact [rows, M] f32 -> [rows, 2M] f32."""
    m = dact.shape[1]
    g_lin, u = gu[:, :m], gu[:, m:]
    sg = torch.sigmoid(g_lin)
    return torch.cat([dact * u * (sg * (1.0 + g_lin * (1.0 - sg))),
                      dact * (g_lin * sg)], dim=1)


_PLAN_TENSORS = ("row_ids", "pair_ids", "slot_of_pair", "tile_expert",
                 "sizes_aligned")


class FusedMoeMlpFunction(torch.autograd.Function):
    """The fused dispatch pipeline with the reference's custom VJP
    (``_fused_mlp``). Forward: K7 then K8; it saves the sorted
    activations (the reference's ``moe_act`` residual) and the plan's
    index tensors, so under ``torch.utils.checkpoint`` the backward reads
    the recomputed ones. Backward, line for line ``_fused_mlp_bwd``: three
    grouped products and two grouped weight gradients, every index motion
    a gather through the plan's maps (no scatter-add: deterministic). The
    ``valid`` masks stay, as the reference computes them, though the
    port's kernels zero-fill. ``use_kernels=False`` runs the plain
    versions in both directions."""

    @staticmethod
    def forward(ctx, xf, w_gu, w_down, gates, plan: DispatchPlan,
                use_kernels: bool):
        gates_pad = _take_rows(gates, plan.pair_ids).contiguous()
        if use_kernels:
            act = moe_gateup(xf, w_gu, plan)
            y_pairs = moe_down_combine(act, w_down, gates_pad, plan)
        else:
            act = moe_gateup_reference(xf, w_gu, plan)
            y_pairs = moe_down_combine_reference(act, w_down, gates_pad,
                                                 plan)
        ctx.save_for_backward(xf, w_gu, w_down, gates, act,
                              *(getattr(plan, f) for f in _PLAN_TENSORS))
        ctx.statics = (plan.tile_rows, plan.n_tokens, plan.n_pairs,
                       plan.n_experts, plan.top_k)
        ctx.use_kernels = use_kernels
        return y_pairs

    @staticmethod
    def backward(ctx, dy):
        xf, w_gu, w_down, gates, act, *index = ctx.saved_tensors
        tile_rows, t, n_pairs, e, k = ctx.statics
        plan = DispatchPlan(*index, tile_rows=tile_rows, n_tokens=t,
                            n_pairs=n_pairs, n_experts=e, top_k=k)
        uk = ctx.use_kernels
        sizes = plan.sizes_aligned

        dyw = _take_rows(dy.float(), plan.pair_ids)          # [r_pad, H]
        gates_pad = _take_rows(gates, plan.pair_ids)
        # One grouped product serves the gate and the activation grads:
        # q = dyw . W_down^T; dgate = act . q; dact = gate * q.
        q = _gmm(dyw.to(xf.dtype), w_down.transpose(1, 2), sizes,
                 uk).float()                                 # [r_pad, M]
        valid = (plan.pair_ids < plan.n_pairs)[:, None]
        q = torch.where(valid, q, 0.0)
        dgates_pad = (act.float() * q).sum(-1)
        dgates = _take_rows(dgates_pad, plan.slot_of_pair)
        dact = q * gates_pad[:, None]
        del q, dgates_pad

        # SwiGLU jacobian from a recompute of the gate/up product. The
        # kernels take bf16 operands: dgu is rounded to the weights' dtype
        # here, for tgmm as for gmm (the reference keeps tgmm's f32).
        xs = _take_rows(xf, plan.row_ids)
        w2 = _gu_2d(w_gu)
        gu = torch.where(valid, _gmm(xs, w2, sizes, uk).float(), 0.0)
        dgu = swiglu_backward(gu, dact).to(w_gu.dtype)       # [r_pad, 2M]
        del gu, dact

        dxs = _gmm(dgu, w2.transpose(1, 2), sizes, uk).float()
        dxs = torch.where(valid, dxs, 0.0)
        slots = plan.slot_of_pair.reshape(t, k)
        dxf = sum(_take_rows(dxs, slots[:, j]) for j in range(k)).to(
            xf.dtype)
        del dxs

        row_group = plan.tile_expert.long().repeat_interleave(tile_rows)
        dw_gu = grouped_weight_grad(
            xs, dgu, sizes, row_group, e, use_kernels=uk,
        ).reshape(w_gu.shape).to(w_gu.dtype)
        del xs, dgu
        dys = (dyw * gates_pad[:, None]).to(w_down.dtype)
        dw_down = grouped_weight_grad(
            act, dys, sizes, row_group, e, use_kernels=uk,
        ).to(w_down.dtype)
        return dxf, dw_gu, dw_down, dgates, None, None


def fused_moe_mlp(
    xf: torch.Tensor,            # [T, H] tokens (unsorted)
    w_gu: torch.Tensor,          # [E, H, 2, M]
    w_down: torch.Tensor,        # [E, M, H]
    gates: torch.Tensor,         # [T*k] f32, token-major pair order
    plan: DispatchPlan,
    *,
    use_kernels: bool = True,
) -> torch.Tensor:
    """The fused dispatch pipeline, K7 then K8: returns token-major pair
    contributions [T*k, H] f32 (the caller sums the k slots per token and
    adds the residual). The caller picks this path (:func:`use_fused`);
    on CPU tensors, or with ``use_kernels=False`` (the kernel-versus-plain
    comparison), the plain versions run. Differentiable in xf, both
    weights and the gates (:class:`FusedMoeMlpFunction`).

    int8 ``QuantTensor`` weights run the forward-only serving path: the
    int8 branches of K7 and K8, scales in their epilogues."""
    q_gu, s_gu = _quant_parts(w_gu)
    q_dn, s_dn = _quant_parts(w_down)
    if s_gu is None and s_dn is None:
        return FusedMoeMlpFunction.apply(xf, w_gu, w_down, gates.float(),
                                         plan, use_kernels)
    gates_pad = _take_rows(gates.float(), plan.pair_ids).contiguous()
    if use_kernels:
        act = moe_gateup(xf, q_gu, plan, s_gu)
        return moe_down_combine(act, q_dn, gates_pad, plan, s_dn)
    act = moe_gateup_reference(xf, q_gu, plan, s_gu)
    return moe_down_combine_reference(act, q_dn, gates_pad, plan, s_dn)
