"""Ring hops between the shards of a single-controller mesh. Counterpart
of ``k8s_dra_driver_tpu/parallel/ring.py``.

:func:`ring_permute` moves shard i's buffer to shard (i + shift) mod n
along a mesh axis: the building block of the ring-overlapped expert
all-to-all (``models/moe.py::_moe_block_dropless_ep_ring``). The
reference calls it per shard inside a ``shard_map``; the port calls it
once with the list of every shard's buffer, in shard order, and gets the
rotated list back, each output on its destination shard's device.
:func:`ring_permute_many` rotates several rings of one axis together (a
hop's f32 carrier and its next bf16 chunk), each ring its own shape and
dtype.

On CUDA tensors every ``impl`` ("auto", "pallas", "xla") launches K9's
twin, ``csrc/ring_permute.cu`` (:func:`ring_permute_group`): one launch
per source card copies every pair of every ring of the group whose source
lives there into its destination, through peer pointers where the
destination is another card. There is no fallback: a build or launch
error raises. On the CPU it runs the plain version ring by ring,
:func:`ring_permute_reference`. The gradient of a rotation is the inverse
rotation of the group through the same kernel, one launch
(:class:`RingPermuteFunction`, the reference's custom VJP).

Each call records ``permute_bytes(payload, n)`` per ring at the ring's
site in the collective ledger (``parallel/collectives.py``), as the
reference's calls do.

Sequence parallelism over the ``sequence`` axis:

- :func:`ring_attention` (the reference's two forms). The flash form
  (``impl`` "auto" or "flash", :class:`RingFlashFunction`) runs the flash
  kernels per ring hop: K4 (``flash_fwd``) causal on the diagonal hop,
  non-causal on every hop that holds earlier keys and values, and no
  launch on a hop that holds later ones; the hops' normalized partials
  merge by their lse. k and v rotate at their native GQA head count, one
  K9 launch a hop for every ring of the call. Its backward rides the ring
  again with the **global** out and lse on every hop (K5, K6): dq
  accumulates at home, dk and dv in f32 carriers that rotate with their
  kv shard and arrive home after n hops. The plain form (``impl`` "xla")
  is the einsum m/l merge per shard, its gradient autograd's. On CPU
  tensors the hops run the kernels' plain versions.
  :func:`ring_attention_shards` is the per-shard core the model path
  calls on the shard tensors it holds; :func:`ring_attention` takes and
  returns whole ``[B, H, S, D]`` tensors, cut over the batch groups, the
  tensor shards (heads) and the sequence shards of a mesh.
- :func:`ulysses_attention`: four all-to-alls
  (``collectives.all_to_all``) turn sequence shards into head shards
  around one whole-sequence ``flash_attention`` per shard.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import collectives

MAX_SHARDS = 8          # shards a ring
MAX_PAIRS = 32          # the kernel's (source, destination) pairs a launch
_BLOCKS_PER_SM = 8      # 256-thread blocks an SM holds: one wave

_LIB = None
_PEERS: set = set()


def _library():
    global _LIB
    if _LIB is None:
        from ..ops import _build

        lib = _build.load("ring_permute")
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.ring_permute_group.argtypes = [
            ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.ring_permute_group.restype = ctypes.c_int
        lib.ring_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ring_enable_peer.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(xs, what: str) -> None:
    if not 1 <= len(xs) <= MAX_SHARDS:
        raise ValueError(f"{what}: {len(xs)} shards; the ring takes 1 to "
                         f"{MAX_SHARDS}")
    shape, dtype = xs[0].shape, xs[0].dtype
    for i, x in enumerate(xs):
        if x.shape != shape or x.dtype != dtype:
            raise ValueError(
                f"{what}: shard {i} is {tuple(x.shape)} {x.dtype}, shard 0 "
                f"{tuple(shape)} {dtype}; every shard's buffer must match"
            )


def _check_group(rings, what: str) -> int:
    """Checks each ring; returns their common shard count."""
    if not rings:
        raise ValueError(f"{what}: no ring")
    for ring in rings:
        _check(ring, what)
    n = len(rings[0])
    if any(len(ring) != n for ring in rings):
        raise ValueError(f"{what}: rings of {[len(r) for r in rings]} "
                         f"shards; a group's rings share one axis")
    return n


def ring_permute_reference(xs, shift: int = 1) -> list:
    """The plain version: ``out[(i + shift) mod n] = xs[i]``, each a copy
    on its destination shard's device (the device of ``xs`` at that
    index)."""
    n = len(xs)
    return [xs[(j - shift) % n].to(xs[j].device, copy=True)
            for j in range(n)]


def ring_permute_many_reference(rings, shift: int = 1) -> list:
    """The plain version of a group: :func:`ring_permute_reference` ring
    by ring."""
    return [ring_permute_reference(ring, shift) for ring in rings]


def _enable_peer(src: torch.device, dst: torch.device) -> None:
    key = (src.index, dst.index)
    if key in _PEERS:
        return
    rc = _library().ring_enable_peer(src.index, dst.index)
    if rc == -2:
        raise RuntimeError(f"ring_permute: {src} cannot write into {dst} "
                           f"(cudaDeviceCanAccessPeer says no)")
    if rc != 0:
        raise RuntimeError(f"ring_permute: enabling peer access {src} -> "
                           f"{dst} returned CUDA error {rc}")
    _PEERS.add(key)


def ring_permute_group(rings, shift: int = 1) -> list:
    """K9's twin on CUDA tensors (``csrc/ring_permute.cu``) for a group of
    rings of one axis: per ring the rotated list, ``out[r][(i + shift) mod
    n] = rings[r][i]`` byte for byte, each output allocated on its
    destination shard's device. One launch per source card for every
    pair of every ring (empty pairs move nothing; a group with no byte
    launches nothing), counted in ``ring_permute_kernel.launches``; a
    destination on another card waits on an event recorded after the
    launch. CPU tensors go to :func:`ring_permute_many_reference`."""
    rings = [list(ring) for ring in rings]
    n = _check_group(rings, "ring_permute")
    flat = [x for ring in rings for x in ring]
    if all(x.device.type == "cpu" for x in flat):
        return ring_permute_many_reference(rings, shift)
    for r, ring in enumerate(rings):
        for i, x in enumerate(ring):
            if not x.is_cuda:
                raise ValueError(f"ring_permute: ring {r} shard {i} on "
                                 f"{x.device}; every shard must be on a "
                                 f"CUDA device (or all on the CPU)")
            if not x.is_contiguous():
                raise ValueError(f"ring_permute: ring {r} shard {i} must be "
                                 f"contiguous")
    outs = [[torch.empty(ring[j].shape, dtype=ring[j].dtype,
                         device=ring[j].device) for j in range(n)]
            for ring in rings]
    pairs: dict = {}
    for ring, out in zip(rings, outs):
        for i, x in enumerate(ring):
            pairs.setdefault(x.device, []).append((x, out[(i + shift) % n]))
    from ..ops._build import check
    from ..ops._device import sm_count

    lib = _library()
    for src_dev, group in pairs.items():
        sizes = [s.numel() * s.element_size() for s, _ in group]
        if not any(sizes):
            continue
        if len(group) > MAX_PAIRS:
            raise ValueError(f"ring_permute: {len(group)} pairs from "
                             f"{src_dev}; a launch takes {MAX_PAIRS}")
        stream = torch.cuda.current_stream(src_dev)
        remote = sorted({d.device for _, d in group if d.device != src_dev},
                        key=str)
        for dst_dev in remote:
            _enable_peer(src_dev, dst_dev)
            # The destination's buffers were allocated on its own stream.
            stream.wait_stream(torch.cuda.current_stream(dst_dev))
        count = len(group)
        srcs = (ctypes.c_void_p * count)(*(s.data_ptr() for s, _ in group))
        dsts = (ctypes.c_void_p * count)(*(d.data_ptr() for _, d in group))
        nbytes = (ctypes.c_longlong * count)(*sizes)
        with torch.cuda.device(src_dev):
            rc = lib.ring_permute_group(srcs, dsts, nbytes, count,
                                        _BLOCKS_PER_SM * sm_count(src_dev),
                                        stream.cuda_stream)
        check(rc, "ring_permute")
        ring_permute_kernel.launches += 1
        if remote:
            done = torch.cuda.Event()
            done.record(stream)
            for dst_dev in remote:
                torch.cuda.current_stream(dst_dev).wait_event(done)
    return outs


def ring_permute_kernel(xs, shift: int = 1) -> list:
    """:func:`ring_permute_group` on one ring: the rotated list.
    ``ring_permute_kernel.launches`` counts K9's launches from either
    entry."""
    return ring_permute_group([xs], shift)[0]


ring_permute_kernel.launches = 0


class RingPermuteFunction(torch.autograd.Function):
    """A group's rotation whose gradient is the group's inverse rotation,
    one launch each way through :func:`ring_permute_group` (the
    reference's ``_ring_permute_pallas`` custom VJP, per ring). ``apply(
    shift, n, *buffers)``: the rings' buffers one ring after another,
    ``n`` a ring; returns the rotated buffers in the same order."""

    @staticmethod
    def forward(ctx, shift: int, n: int, *xs):
        ctx.shift, ctx.n = shift, n
        rings = [list(xs[r:r + n]) for r in range(0, len(xs), n)]
        return tuple(x for out in ring_permute_group(rings, shift)
                     for x in out)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        rings = [[g.contiguous() for g in gs[r:r + n]]
                 for r in range(0, len(gs), n)]
        grads = [g for out in ring_permute_group(rings, -ctx.shift)
                 for g in out]
        return (None, None, *grads)


def _rotate(rings, shift: int = 1) -> list:
    """A group's rotation (:func:`ring_permute_group`), differentiable
    through :class:`RingPermuteFunction` where a buffer requires grad; no
    ledger record."""
    rings = [list(ring) for ring in rings]
    n = len(rings[0])
    flat = [x for ring in rings for x in ring]
    if torch.is_grad_enabled() and any(x.requires_grad for x in flat):
        out = RingPermuteFunction.apply(shift % n, n, *flat)
        return [list(out[r:r + n]) for r in range(0, len(out), n)]
    return ring_permute_group(rings, shift % n)


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown ring_permute impl {impl!r}; valid: auto, "
                         f"pallas, xla")


def ring_permute_many(
    rings,
    axis_name: str,
    n: int,
    *,
    shift: int = 1,
    impl: str = "auto",
    sites,
) -> list:
    """Rotate every ring of ``rings`` (each the list of its ``n`` shards'
    buffers along ``axis_name``, one shape and dtype a ring) by ``shift``
    in one launch per source device; returns the rotated rings. Each
    ring's hop is recorded at its own site of ``sites``, in ring order, as
    that many :func:`ring_permute` calls would record them.
    Differentiable: the gradient is one inverse launch for the group."""
    _check_impl(impl)
    rings = [list(ring) for ring in rings]
    if len(sites) != len(rings):
        raise ValueError(f"ring_permute_many: {len(sites)} sites for "
                         f"{len(rings)} rings")
    for ring in rings:
        if len(ring) != n:
            raise ValueError(f"ring_permute over {axis_name!r}: {len(ring)} "
                             f"buffers for a ring of {n}")
    _check_group(rings, "ring_permute")
    for ring, site in zip(rings, sites):
        collectives.emit(
            site, collectives.MEDIUM_ICI,
            collectives.permute_bytes(
                collectives.payload_bytes(ring[0].shape, ring[0].dtype), n),
        )
    return _rotate(rings, shift)


def ring_permute(
    xs,
    axis_name: str,
    n: int,
    *,
    shift: int = 1,
    impl: str = "auto",
    site: str = "ring.permute",
) -> list:
    """Move shard i's buffer ``xs[i]`` to shard (i + shift) mod n along
    ``axis_name``; returns the list of received buffers in shard order.
    ``xs`` holds every shard's buffer of the ring (``n`` of them, one
    shape and dtype). ``impl`` keeps the reference's names; every one runs
    K9's twin on CUDA tensors and the plain version on the CPU.
    Differentiable; ``site`` labels the hop in the collective ledger."""
    return ring_permute_many([xs], axis_name, n, shift=shift, impl=impl,
                             sites=(site,))[0]


# ---------------------------------------------------------------------------
# Ring attention: sequence parallelism over the "sequence" axis.
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _hop_class(kv_idx: int, idx: int, causal: bool) -> int:
    """0 = diagonal (causal kernel), 1 = fully visible, 2 = skip: the
    reference's ``_hop_class``, decided on the host."""
    if not causal:
        return 1
    return 0 if kv_idx == idx else (1 if kv_idx < idx else 2)


def _split(xs, n: int, parts: int) -> list:
    """``xs`` (``parts`` groups of rings of ``n``, one after another) as
    ``parts`` lists of rings."""
    rings = [list(xs[i:i + n]) for i in range(0, len(xs), n)]
    r = len(rings) // parts
    return [rings[p * r:(p + 1) * r] for p in range(parts)]


def _flat(rings) -> list:
    return [x for ring in rings for x in ring]


def _ring_flash_forward(qs, ks, vs, causal: bool, scale: float) -> tuple:
    """The ring's forward over every ring of ``qs``/``ks``/``vs`` (lists
    of rings, a ring the list of its ``n`` shard tensors): per hop, K4 on
    each shard's visible (q, kv) pair, its lse-weighted merge, and one
    grouped K9 launch that moves every ring's k and v one shard on (none
    after the last hop). Returns (outs in q's dtype, lses f32) as rings."""
    from ..ops.attention import flash_fwd

    r_count, n = len(qs), len(qs[0])
    outs = [[None] * n for _ in range(r_count)]
    lses = [[None] * n for _ in range(r_count)]
    k_cur, v_cur = ks, vs
    for t in range(n):
        for r in range(r_count):
            for i in range(n):
                hop = _hop_class((i - t) % n, i, causal)
                if hop == 2:
                    continue
                o, lse = flash_fwd(qs[r][i], k_cur[r][i], v_cur[r][i],
                                   hop == 0, scale)
                if outs[r][i] is None:      # hop 0: the diagonal
                    outs[r][i], lses[r][i] = o.float(), lse
                    continue
                new = torch.logaddexp(lses[r][i], lse)
                outs[r][i] = (
                    outs[r][i] * torch.exp(lses[r][i] - new)[..., None]
                    + o.float() * torch.exp(lse - new)[..., None])
                lses[r][i] = new
        if t < n - 1:
            moved = ring_permute_group(k_cur + v_cur)
            k_cur, v_cur = moved[:r_count], moved[r_count:]
    outs = [[o.to(q.dtype) for o, q in zip(ro, rq)]
            for ro, rq in zip(outs, qs)]
    return outs, lses


def _ring_flash_backward(qs, ks, vs, outs, lses, dos, causal: bool,
                         scale: float) -> tuple:
    """The ring's backward: per hop, K5 and K6 with the global out and
    lse on each visible pair; dq accumulates at home (f32), dk and dv in
    f32 carriers that rotate with their kv shard -- one grouped K9 launch
    a hop for k, v and both carriers, and after the last hop one for the
    carriers alone, which then sit at their kv shard's home."""
    from ..ops.attention import flash_bwd_dkdv, flash_bwd_dq

    r_count, n = len(qs), len(qs[0])
    deltas = [[(do.float() * o.float()).sum(dim=-1)
               for do, o in zip(rd, ro)] for rd, ro in zip(dos, outs)]
    dqs = [[None] * n for _ in range(r_count)]
    dks = [[torch.zeros(k.shape, dtype=torch.float32, device=k.device)
            for k in ring] for ring in ks]
    dvs = [[torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for v in ring] for ring in vs]
    k_cur, v_cur = ks, vs
    for t in range(n):
        for r in range(r_count):
            for i in range(n):
                hop = _hop_class((i - t) % n, i, causal)
                if hop == 2:
                    continue
                args = (qs[r][i], k_cur[r][i], v_cur[r][i], dos[r][i],
                        lses[r][i], deltas[r][i], hop == 0, scale)
                dk, dv = flash_bwd_dkdv(*args)
                dq = flash_bwd_dq(*args).float()
                dqs[r][i] = dq if dqs[r][i] is None else dqs[r][i] + dq
                dks[r][i] += dk.float()
                dvs[r][i] += dv.float()
        if t < n - 1:
            moved = ring_permute_group(k_cur + v_cur + dks + dvs)
            k_cur, v_cur = moved[:r_count], moved[r_count:2 * r_count]
            dks, dvs = moved[2 * r_count:3 * r_count], moved[3 * r_count:]
        else:
            moved = ring_permute_group(dks + dvs)
            dks, dvs = moved[:r_count], moved[r_count:]
    cast = lambda grads, like: [  # noqa: E731
        [g.to(x.dtype) for g, x in zip(rg, rx)] for rg, rx in zip(grads, like)]
    return cast(dqs, qs), cast(dks, ks), cast(dvs, vs)


class RingFlashFunction(torch.autograd.Function):
    """The flash form of ring attention over a group of rings, with the
    whole ring's backward (the reference's ``_ring_flash`` custom VJP).
    ``apply(n, causal, scale, *tensors)``: the rings' q shards one ring
    after another, then their k shards, then their v shards (``n`` a
    ring); returns the rings' outputs in q's order."""

    @staticmethod
    def forward(ctx, n: int, causal: bool, scale: float, *xs):
        qs, ks, vs = _split(xs, n, 3)
        outs, lses = _ring_flash_forward(qs, ks, vs, causal, scale)
        ctx.n, ctx.causal, ctx.scale = n, causal, scale
        ctx.save_for_backward(*xs, *_flat(outs), *_flat(lses))
        return tuple(_flat(outs))

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        count = len(gs)
        qs, ks, vs = _split(saved[:3 * count], n, 3)
        outs = _split(saved[3 * count:4 * count], n, 1)[0]
        lses = _split(saved[4 * count:], n, 1)[0]
        dos = _split([g.contiguous() for g in gs], n, 1)[0]
        dq, dk, dv = _ring_flash_backward(qs, ks, vs, outs, lses, dos,
                                          ctx.causal, ctx.scale)
        return (None, None, None, *_flat(dq), *_flat(dk), *_flat(dv))


def _block_attend(q, k, v, scale: float, q_offset: int, kv_offset: int,
                  causal: bool) -> tuple:
    """One blockwise attention step in f32 (the reference's): (row max m,
    denominator l, unnormalized out) for the online-softmax merge. m
    carries no gradient anywhere, where the reference stops it only in
    the exponent: o / l is invariant to the shift, and the half-stopped
    shift's gradient is not zero."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[-2], device=q.device)[:, None]
        kpos = kv_offset + torch.arange(k.shape[-2], device=q.device)[None]
        mask = kpos <= qpos
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    # The shift m is a constant to autograd: o / l does not depend on it.
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
        m = torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF), m)
    l = p.sum(dim=-1, keepdim=True)
    return m, l, torch.einsum("bhqk,bhkd->bhqd", p, v)


def _ring_xla(qs, ks, vs, causal: bool, scale: float) -> list:
    """The plain form (the reference's ``_ring_attention_local``) over a
    group of rings at full head count: the einsum m/l merge per shard,
    k and v rotated by one grouped K9 launch a hop; autograd's gradient."""
    r_count, n = len(qs), len(qs[0])
    s_local = qs[0][0].shape[-2]
    acc = [[None] * n for _ in range(r_count)]
    k_cur, v_cur = ks, vs
    for t in range(n):
        for r in range(r_count):
            for i in range(n):
                part = _block_attend(
                    qs[r][i].float(), k_cur[r][i].float(),
                    v_cur[r][i].float(), scale, i * s_local,
                    ((i - t) % n) * s_local, causal)
                if acc[r][i] is None:
                    acc[r][i] = part
                    continue
                m1, l1, o1 = acc[r][i]
                m2, l2, o2 = part
                m = torch.maximum(m1, m2)
                a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
                acc[r][i] = (m, l1 * a1 + l2 * a2, o1 * a1 + o2 * a2)
        if t < n - 1:
            moved = _rotate(k_cur + v_cur)
            k_cur, v_cur = moved[:r_count], moved[r_count:]
    return [[(o / l.clamp_min(1e-30)).to(q.dtype)
             for (_, l, o), q in zip(ra, rq)] for ra, rq in zip(acc, qs)]


def ring_attention_shards(qs, ks, vs, *, causal: bool = True,
                          scale: float | None = None,
                          impl: str = "flash") -> list:
    """Ring attention on shard tensors: ``qs``, ``ks``, ``vs`` are lists
    of rings, a ring the list of its ``n`` sequence shards' tensors in
    shard order (q ``[B, Hq, S/n, D]``, k/v ``[B, H_kv, S/n, D]``, each
    ring's shards of one shape, shard i on its own device). Every ring
    hops together: one K9 launch a hop and source device for all of them.
    ``impl`` "flash" (:class:`RingFlashFunction`: K4-K6 per hop on CUDA
    tensors, their plain versions on the CPU) or "xla" (the einsum form,
    k/v repeated to the query heads here). Returns the rings' outputs,
    each on its shard's device. Records nothing in the ledger (the
    caller records ``ring_attention.kv``)."""
    if impl not in ("flash", "xla"):
        raise ValueError(f"unknown ring attention impl {impl!r}; valid: "
                         f"flash, xla")
    qs, ks, vs = ([list(r) for r in x] for x in (qs, ks, vs))
    n = len(qs[0])
    if not 1 <= n <= MAX_SHARDS or any(
            len(r) != n for r in (*qs, *ks, *vs)) or not (
            len(qs) == len(ks) == len(vs)):
        raise ValueError(f"ring attention: rings of {[len(r) for r in qs]} "
                         f"q shards; each ring takes 1 to {MAX_SHARDS}")
    scale = scale if scale is not None else qs[0][0].shape[-1] ** -0.5
    if impl == "xla":
        from ..ops.attention import _repeat_kv

        g = qs[0][0].shape[1] // ks[0][0].shape[1]
        ks = [[_repeat_kv(k, g) for k in ring] for ring in ks]
        vs = [[_repeat_kv(v, g) for v in ring] for ring in vs]
        return _ring_xla(qs, ks, vs, causal, scale)
    flat = [x.contiguous() for x in _flat(qs) + _flat(ks) + _flat(vs)]
    out = RingFlashFunction.apply(n, causal, scale, *flat)
    return [list(out[i:i + n]) for i in range(0, len(out), n)]


def _emit_ring_attention_kv(k_shape, v_shape, dtype, n_seq: int) -> None:
    """Forward-ring accounting, the reference's: the global k/v at the
    head counts that rotate, every shard's chunk on each of the n hops --
    global k + v bytes per hop, ``n_seq`` hops (whatever number of K9
    launches moves them)."""
    if n_seq <= 1:
        return
    collectives.emit(
        "ring_attention.kv", collectives.MEDIUM_ICI,
        n_seq * (collectives.payload_bytes(k_shape, dtype)
                 + collectives.payload_bytes(v_shape, dtype)),
    )


def _group_coords(mesh, axes, g: int) -> dict:
    """Group ``g`` of the batch ``axes`` (the first name major) as their
    coordinates."""
    out = {}
    for axis in reversed(axes):
        g, out[axis] = divmod(g, mesh.shape[axis])
    return out


def _cut(x: torch.Tensor, count: int, dim: int, what: str) -> int:
    if x.shape[dim] % count:
        raise ValueError(f"{what}: dimension {dim} of {tuple(x.shape)} does "
                         f"not split over {count} shards")
    return x.shape[dim] // count


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "sequence",
    causal: bool = True,
    scale: float | None = None,
    batch_axes: tuple = ("data", "fsdp"),
    head_axis: str | None = "tensor",
    impl: str = "auto",
) -> torch.Tensor:
    """Sequence-parallel attention on whole tensors (q ``[B, Hq, S, D]``,
    k/v ``[B, H_kv, S, D]``), the reference's API: B cut over the batch
    axes, H over ``head_axis``, S over ``axis_name``, each (batch group,
    head shard) a ring over its sequence shards' devices, all rings in
    one :func:`ring_attention_shards` call; the output is gathered on q's
    device. ``impl``: "auto" and "flash" the flash form (k/v at native
    GQA count, repeated by the smallest group divisor that splits over
    ``head_axis`` where the native count does not), "xla" the plain form
    (k/v repeated to the query heads). A ring of one is one hop."""
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown ring attention impl {impl!r}; valid: "
                         f"auto, flash, xla")
    from ..ops.attention import _repeat_kv

    form = "xla" if impl == "xla" else "flash"
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    n = mesh.shape[axis_name]
    batch_axes = tuple(batch_axes or ())
    dp = math.prod(mesh.shape[a] for a in batch_axes)
    tp = mesh.shape[head_axis] if head_axis else 1
    h, hkv = q.shape[1], k.shape[1]
    if form == "xla":
        r = h // hkv
    elif hkv % tp:
        group = h // hkv
        r = next((r for r in range(2, group + 1)
                  if group % r == 0 and (hkv * r) % tp == 0), group)
    else:
        r = 1
    if r > 1:
        k, v = _repeat_kv(k, r), _repeat_kv(v, r)
    _emit_ring_attention_kv(k.shape, v.shape, k.dtype, n)
    rows = _cut(q, dp, 0, "ring_attention")
    hq_loc = _cut(q, tp, 1, "ring_attention")
    hkv_loc = _cut(k, tp, 1, "ring_attention")
    s_loc = _cut(q, n, 2, "ring_attention")
    rings = ([], [], [])
    for g in range(dp):
        base = _group_coords(mesh, batch_axes, g)
        for t in range(tp):
            coords = {**base, **({head_axis: t} if head_axis else {})}
            devs = [mesh.devices[mesh.index(**coords, **{axis_name: j})]
                    for j in range(n)]
            for ring, x, heads in zip(rings, (q, k, v),
                                      (hq_loc, hkv_loc, hkv_loc)):
                ring.append([
                    x[g * rows:(g + 1) * rows, t * heads:(t + 1) * heads,
                      j * s_loc:(j + 1) * s_loc].to(dev)
                    for j, dev in enumerate(devs)])
    outs = ring_attention_shards(*rings, causal=causal, scale=scale,
                                 impl=form)
    per_group = [
        torch.cat([torch.cat([o.to(q.device) for o in outs[g * tp + t]],
                             dim=2) for t in range(tp)], dim=1)
        for g in range(dp)]
    return torch.cat(per_group, dim=0)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    axis_name: str = "sequence",
    causal: bool = True,
    scale: float | None = None,
    batch_axes: tuple = ("data", "fsdp"),
    attn_fn=None,
) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses), the
    reference's: kv repeated to the query heads, then on each (batch
    group, sequence shard) ``[B, H, S/n, D] -> [B, H/n, S, D]`` by
    ``collectives.all_to_all`` for q, k and v, whole-sequence
    ``flash_attention`` (K4-K6) on its H/n heads, and the output back.
    Whole tensors in and out (gathered on q's device); H must divide by
    n."""
    from ..ops.attention import _repeat_kv, flash_attention

    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if k.shape[1] != q.shape[1]:
        reps = q.shape[1] // k.shape[1]
        k, v = _repeat_kv(k, reps), _repeat_kv(v, reps)
    attn = attn_fn or (
        lambda q_, k_, v_: flash_attention(q_, k_, v_, causal, scale))
    n = mesh.shape[axis_name]
    if n > 1:
        # Four a2as: q, k, v in; the output (q-shaped) back out.
        collectives.emit(
            "ulysses.all_to_all", collectives.MEDIUM_ICI,
            sum(collectives.all_to_all_bytes(
                collectives.payload_bytes(t.shape, t.dtype) // n, n)
                for t in (q, k, v, q)),
            invocations=4,
        )
    _cut(q, n, 1, "ulysses_attention")
    batch_axes = tuple(batch_axes or ())
    dp = math.prod(mesh.shape[a] for a in batch_axes)
    rows = _cut(q, dp, 0, "ulysses_attention")
    s_loc = _cut(q, n, 2, "ulysses_attention")
    # One value per (batch group, sequence shard) at coordinate 0 of every
    # other axis; the replicas along those axes take no part.
    where = {}
    for g in range(dp):
        base = _group_coords(mesh, batch_axes, g)
        for j in range(n):
            where[mesh.index(**base, **{axis_name: j})] = (g, j)

    def cut(x):
        return [None if i not in where else
                x[where[i][0] * rows:(where[i][0] + 1) * rows, :,
                  where[i][1] * s_loc:(where[i][1] + 1) * s_loc].to(dev)
                for i, dev in enumerate(mesh.devices)]

    qh, kh, vh = (collectives.all_to_all(cut(x), mesh, axis_name, 1, 2)
                  for x in (q, k, v))
    oh = [None if x is None else attn(x, y, z) for x, y, z in zip(qh, kh, vh)]
    o = collectives.all_to_all(oh, mesh, axis_name, 2, 1)
    blocks = {where[i]: x for i, x in enumerate(o) if x is not None}
    return torch.cat([torch.cat([blocks[g, j].to(q.device)
                                 for j in range(n)], dim=2)
                      for g in range(dp)], dim=0)
