"""Fused ragged MoE dispatch: the dispatch plan, the two hand-written
Hopper kernels of the route -> dispatch -> expert -> combine pipeline,
and their plain PyTorch versions. Counterpart of
``k8s_dra_driver_tpu/ops/moe_dispatch.py``.

- :func:`build_plan` lays every (token, expert) pair into an
  expert-major buffer of ``r_pad`` rows whose per-expert regions start at
  tile boundaries, so each row tile belongs to exactly one expert. It is
  integer PyTorch and gives the reference's plan bit for bit.
- :func:`moe_gateup` wraps ``moe_gateup`` of ``csrc/moe_dispatch.cu``,
  which replaces ``_gateup_kernel`` (with ``_gather_rows_dma``): it
  gathers each tile's token rows itself, computes both halves of the
  gate/up projection against the tile's expert in f32 and writes
  ``silu(g) * u`` in the input dtype. Sentinel rows come out exactly 0.
- :func:`moe_down_combine` wraps ``moe_down_combine``, which replaces
  ``_down_combine_kernel`` (with ``_scatter_rows_dma``): the
  down-projection in f32, times each row's router gate, written straight
  to the row's token-major pair slot. Slots of no live pair stay 0.
- :func:`moe_gateup_reference` and :func:`moe_down_combine_reference`
  are their plain versions (the same arithmetic, per expert);
  :func:`fused_moe_mlp` chains the pair (forward only: the custom VJP and
  its grouped matmuls come with MoE training).
- :func:`reference_moe_mlp` is the reference's oracle: gathers plus
  :func:`grouped_matmul` over the same layout. ``grouped_matmul`` exists
  here only as its plain version (a loop over groups equal to
  ``lax.ragged_dot``); its kernel, megablox ``gmm``, is ported with MoE
  training, and until then a CUDA tensor makes it raise.

A kernel wrapper takes its plain version only for CPU tensors. For CUDA
tensors it launches its kernel (counted in ``<wrapper>.launches``) or
raises: bf16 inputs, row tiles that are multiples of 8 up to 128, and the
widths :func:`fused_geometry_ok` names. The reference's
``TPU_DRA_MOE_*`` environment knobs are module constants here
(:data:`TILE_ROWS`, :data:`TILE_COLS`) and :func:`set_dispatch_impl`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import _build

#: Largest row tile of the default plan (the reference's
#: ``TPU_DRA_MOE_TILE_ROWS`` default).
TILE_ROWS = 128
#: Column tile of the reference's kernels (``TPU_DRA_MOE_TILE_COLS``);
#: kept for :func:`_fit_cols`. The CUDA kernels fix their own widths.
TILE_COLS = 512
#: The CUDA kernels take H and M in whole blocks of 64 (output columns
#: in blocks of 64, the contracted axis in steps of 32; see
#: ``csrc/moe_dispatch.cu``).
KERNEL_COLS = 64

_DISPATCH_IMPL = "auto"

_SOURCE = "moe_dispatch"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_GATEUP_ARGTYPES = [_PTR] * 5 + [_INT] * 5 + [_PTR]
_DOWN_ARGTYPES = [_PTR] * 6 + [_INT] * 5 + [_PTR]
_LIB = None


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
              device=None) -> bool:
    """Whether the fused pipeline is selected for tensors on ``device``
    (the port has no device mesh, so the reference's ``under_mesh`` case
    does not arise)."""
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
    argsort and a few scatters, every shape fixed by (n_pairs, n_experts,
    tile). Foreign pairs (expert id >= ``n_experts``) get no slot."""
    dev = experts_flat.device
    r = experts_flat.shape[0]
    e = n_experts
    tile = tile_rows or default_tile_rows(r, e)
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
    return DispatchPlan(
        row_ids=row_ids[:r_pad].to(i32), pair_ids=pair_ids[:r_pad].to(i32),
        slot_of_pair=slot_of_pair.to(i32), tile_expert=tile_expert.to(i32),
        sizes_aligned=aligned.to(i32), tile_rows=tile, n_tokens=n_tokens,
        n_pairs=r, n_experts=e, top_k=top_k,
    )


# ---------------------------------------------------------------------------
# Grouped matmul (plain version only until MoE training ports K10).
# ---------------------------------------------------------------------------


def grouped_matmul(
    lhs: torch.Tensor,           # [rows, K]
    rhs: torch.Tensor,           # [E, K, N]
    group_sizes: torch.Tensor,   # [E] int, cumulative layout
) -> torch.Tensor:
    """``lax.ragged_dot``: rows [start_g, start_g + size_g) times
    ``rhs[g]``, rows past the last group zero, in ``lhs``'s dtype.

    On the card this is megablox ``gmm`` (K10), ported with MoE training;
    until then a CUDA tensor raises rather than run a stand-in."""
    if lhs.is_cuda or rhs.is_cuda:
        raise NotImplementedError(
            "grouped_matmul: K10 (megablox gmm) is not ported yet -- it "
            "comes with the MoE training slice; the fused dispatch "
            "kernels (moe_gateup, moe_down_combine) serve on the card"
        )
    out = torch.zeros(lhs.shape[0], rhs.shape[2], dtype=lhs.dtype)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        if size:
            out[start:start + size] = lhs[start:start + size] @ rhs[g]
        start += size
    return out


def _gu_2d(w_gu: torch.Tensor) -> torch.Tensor:
    """[E, H, 2, M] -> [E, H, 2M]: [:, :, :M] is the gate half."""
    e, h, _, m = w_gu.shape
    return w_gu.reshape(e, h, 2 * m)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0 with out-of-range ids as zero rows (the
    reference's ``jnp.take(..., mode="fill", fill_value=0)``)."""
    n = x.shape[0]
    valid = (idx >= 0) & (idx < n)
    rows = x[torch.where(valid, idx, torch.zeros_like(idx)).long()]
    mask = valid.reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(mask, rows, torch.zeros_like(rows))


def reference_moe_mlp(xf, w_gu, w_down, gates, plan: DispatchPlan):
    """The oracle: gathers and grouped products over the plan's layout;
    returns token-major pair contributions [n_pairs, H] f32. Equal to the
    fused pipeline up to rounding (its gate/up product is rounded to the
    input dtype before SwiGLU). The reference's ``_reference_parts`` also
    returns the sorted activations, for its backward; that comes with MoE
    training."""
    m = w_down.shape[1]
    xs = _take_rows(xf, plan.row_ids)
    gu = grouped_matmul(xs, _gu_2d(w_gu), plan.sizes_aligned)
    gate = torch.nn.functional.silu(gu[:, :m].float())
    up = gu[:, m:].float()
    act = (gate * up).to(xf.dtype)
    ys = grouped_matmul(act, w_down, plan.sizes_aligned)
    gates_pad = _take_rows(gates, plan.pair_ids)
    yw = ys.float() * gates_pad[:, None]
    return _take_rows(yw, plan.slot_of_pair)


# ---------------------------------------------------------------------------
# K7 and K8: plain versions and kernel wrappers.
# ---------------------------------------------------------------------------


def _row_expert(plan: DispatchPlan) -> torch.Tensor:
    return plan.tile_expert.long().repeat_interleave(plan.tile_rows)


def moe_gateup_reference(xf: torch.Tensor, w_gu: torch.Tensor,
                         plan: DispatchPlan) -> torch.Tensor:
    """The plain version of ``moe_gateup``: act [r_pad, M] in xf's dtype,
    ``silu(g) * u`` with g and u the f32 products of each live row with
    its tile's expert, sentinel rows exactly 0."""
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
        g, u = gu[:, :m], gu[:, m:]
        act[rows] = (g * torch.sigmoid(g) * u).to(xf.dtype)
    return act


def moe_down_combine_reference(act: torch.Tensor, w_down: torch.Tensor,
                               gates_pad: torch.Tensor,
                               plan: DispatchPlan) -> torch.Tensor:
    """The plain version of ``moe_down_combine``: y_pairs [n_pairs, H]
    f32, each live row's f32 down product times its gate in its pair's
    slot, every other slot exactly 0."""
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
        out[plan.pair_ids[rows].long()] = y * gates_pad[rows, None].float()
    return out


def _library():
    """The built kernel library with its C signatures declared."""
    global _LIB
    if _LIB is None:
        lib = _build.load(_SOURCE)
        lib.moe_gateup.argtypes = _GATEUP_ARGTYPES
        lib.moe_gateup.restype = _INT
        lib.moe_down_combine.argtypes = _DOWN_ARGTYPES
        lib.moe_down_combine.restype = _INT
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


def _check_weights(kernel: str, w: torch.Tensor, h: int, m: int) -> None:
    if w.dtype != torch.bfloat16:
        raise TypeError(f"{kernel}: weights are {w.dtype}; the kernel takes "
                        f"bf16 (int8 experts are not ported yet)")
    if not fused_geometry_ok(h, m):
        raise ValueError(
            f"{kernel}: hidden {h}, expert width {m}; the kernel takes "
            f"multiples of {KERNEL_COLS} (fused_geometry_ok)"
        )


def moe_gateup(xf: torch.Tensor, w_gu: torch.Tensor,
               plan: DispatchPlan) -> torch.Tensor:
    """K7: fused row gather + gate/up projection + SwiGLU. xf [T, H];
    w_gu [E, H, 2, M]. Returns the sorted activations [r_pad, M] in xf's
    dtype (sentinel rows exactly 0)."""
    if _is_cpu(xf, w_gu, plan.row_ids, plan.tile_expert):
        return moe_gateup_reference(xf, w_gu, plan)
    e, h, two, m = w_gu.shape
    _check_cuda("moe_gateup", plan, xf=xf, w_gu=w_gu)
    _check_weights("moe_gateup", w_gu, h, m)
    if xf.dtype != torch.bfloat16 or xf.dim() != 2 or xf.shape[1] != h \
            or two != 2 or xf.shape[0] != plan.n_tokens:
        raise ValueError(
            f"moe_gateup: xf {tuple(xf.shape)} {xf.dtype}, w_gu "
            f"{tuple(w_gu.shape)}; expected bf16 [{plan.n_tokens}, H] and "
            f"[E, H, 2, M]"
        )
    act = torch.empty(plan.r_pad, m, dtype=xf.dtype, device=xf.device)
    with torch.cuda.device(xf.device):
        rc = _library().moe_gateup(
            xf.data_ptr(), w_gu.data_ptr(), plan.row_ids.data_ptr(),
            plan.tile_expert.data_ptr(), act.data_ptr(),
            plan.n_tokens, h, m, plan.r_pad, plan.tile_rows,
            torch.cuda.current_stream(xf.device).cuda_stream,
        )
    _build.check(rc, "moe_gateup")
    moe_gateup.launches += 1
    return act


moe_gateup.launches = 0


def moe_down_combine(act: torch.Tensor, w_down: torch.Tensor,
                     gates_pad: torch.Tensor,
                     plan: DispatchPlan) -> torch.Tensor:
    """K8: fused down-projection + gate weighting + combine scatter.
    act [r_pad, M]; w_down [E, M, H]; gates_pad [r_pad] or [r_pad, 1]
    f32. Returns token-major pair contributions [n_pairs, H] f32, zero
    where no live pair writes."""
    if _is_cpu(act, w_down, gates_pad, plan.pair_ids, plan.tile_expert):
        return moe_down_combine_reference(act, w_down, gates_pad, plan)
    e, m, h = w_down.shape
    _check_cuda("moe_down_combine", plan, act=act, w_down=w_down,
                gates_pad=gates_pad)
    _check_weights("moe_down_combine", w_down, h, m)
    if act.dtype != torch.bfloat16 or act.shape != (plan.r_pad, m):
        raise ValueError(f"moe_down_combine: act {tuple(act.shape)} "
                         f"{act.dtype}; expected bf16 [{plan.r_pad}, {m}]")
    if gates_pad.dtype != torch.float32 or gates_pad.numel() != plan.r_pad:
        raise TypeError(f"moe_down_combine: gates_pad "
                        f"{tuple(gates_pad.shape)} {gates_pad.dtype}; "
                        f"expected float32 [{plan.r_pad}]")
    out = torch.zeros(plan.n_pairs, h, dtype=torch.float32,
                      device=act.device)
    with torch.cuda.device(act.device):
        rc = _library().moe_down_combine(
            act.data_ptr(), w_down.data_ptr(), gates_pad.data_ptr(),
            plan.pair_ids.data_ptr(), plan.tile_expert.data_ptr(),
            out.data_ptr(), plan.n_pairs, m, h, plan.r_pad, plan.tile_rows,
            torch.cuda.current_stream(act.device).cuda_stream,
        )
    _build.check(rc, "moe_down_combine")
    moe_down_combine.launches += 1
    return out


moe_down_combine.launches = 0


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
    comparison), K7's and K8's plain versions run.

    Forward only: the reference's custom VJP needs the grouped matmuls of
    MoE training, so inputs that require grad raise."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xf, w_gu, w_down, gates)):
        raise NotImplementedError(
            "fused_moe_mlp is forward-only in the port; its backward (the "
            "reference's custom VJP over K10) comes with MoE training"
        )
    gates_pad = _take_rows(gates.float(), plan.pair_ids).contiguous()
    if use_kernels:
        act = moe_gateup(xf, w_gu, plan)
        return moe_down_combine(act, w_down, gates_pad, plan)
    act = moe_gateup_reference(xf, w_gu, plan)
    return moe_down_combine_reference(act, w_down, gates_pad, plan)
