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

``ring_attention`` and ``ulysses_attention`` (sequence parallelism over
K4-K6 per hop) are still to port (A12d in ROADMAP.md) and raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import collectives

MAX_SHARDS = 8          # shards a ring
MAX_PAIRS = 16          # the kernel's (source, destination) pairs a launch
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
    shift %= n
    flat = [x for ring in rings for x in ring]
    if torch.is_grad_enabled() and any(x.requires_grad for x in flat):
        out = RingPermuteFunction.apply(shift, n, *flat)
        return [list(out[r:r + n]) for r in range(0, len(out), n)]
    return ring_permute_group(rings, shift)


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


def ring_attention(*args, **kwargs):
    raise NotImplementedError(
        "ring_attention: sequence parallelism over K4-K6 per hop is not "
        "ported (A12d in ROADMAP.md)"
    )


def ulysses_attention(*args, **kwargs):
    raise NotImplementedError(
        "ulysses_attention: all-to-all sequence parallelism is not ported "
        "(A12d in ROADMAP.md)"
    )
