"""Ring hops between the shards of a single-controller mesh. Counterpart
of ``k8s_dra_driver_tpu/parallel/ring.py``.

:func:`ring_permute` moves shard i's buffer to shard (i + shift) mod n
along a mesh axis: the building block of the ring-overlapped expert
all-to-all (``models/moe.py::_moe_block_dropless_ep_ring``). The
reference calls it per shard inside a ``shard_map``; the port calls it
once with the list of every shard's buffer, in shard order, and gets the
rotated list back, each output on its destination shard's device.

On CUDA tensors every ``impl`` ("auto", "pallas", "xla") launches K9's
twin, ``csrc/ring_permute.cu`` (:func:`ring_permute_kernel`): one launch
per source card copies every shard that lives there into its
destination, through peer pointers where the destination is another
card. There is no fallback: a build or launch error raises. On the CPU it
runs the plain version, :func:`ring_permute_reference`. The gradient of a
rotation is the inverse rotation through the same kernel
(:class:`RingPermuteFunction`, the reference's custom VJP).

Each call records ``permute_bytes(payload, n)`` at its ``site`` in the
collective ledger (``parallel/collectives.py``), as the reference's does.

``ring_attention`` and ``ulysses_attention`` (sequence parallelism over
K4-K6 per hop) are still to port (A12 in ROADMAP.md) and raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import collectives

MAX_SHARDS = 8          # the kernel's pointer pairs per launch
_THREADS = 256
_WORD = 16
_BLOCKS_PER_SM = 8

_LIB = None
_PEERS: set = set()


def _library():
    global _LIB
    if _LIB is None:
        from ..ops import _build

        lib = _build.load("ring_permute")
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        lib.ring_permute.argtypes = [ptrs, ptrs, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.ring_permute.restype = ctypes.c_int
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


def ring_permute_reference(xs, shift: int = 1) -> list:
    """The plain version: ``out[(i + shift) mod n] = xs[i]``, each a copy
    on its destination shard's device (the device of ``xs`` at that
    index)."""
    n = len(xs)
    return [xs[(j - shift) % n].to(xs[j].device, copy=True)
            for j in range(n)]


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


def ring_permute_kernel(xs, shift: int = 1) -> list:
    """K9's twin on CUDA tensors (``csrc/ring_permute.cu``): the rotated
    list, ``out[(i + shift) mod n] = xs[i]`` byte for byte, each output
    allocated on its destination shard's device. One launch per source
    card, counted in ``ring_permute_kernel.launches``; a destination on
    another card waits on an event recorded after the launch. CPU tensors
    go to :func:`ring_permute_reference`."""
    _check(xs, "ring_permute")
    n = len(xs)
    if all(x.device.type == "cpu" for x in xs):
        return ring_permute_reference(xs, shift)
    for i, x in enumerate(xs):
        if not x.is_cuda:
            raise ValueError(f"ring_permute: shard {i} on {x.device}; every "
                             f"shard must be on a CUDA device (or all on "
                             f"the CPU)")
        if not x.is_contiguous():
            raise ValueError(f"ring_permute: shard {i} must be contiguous")
    outs = [torch.empty(xs[j].shape, dtype=xs[j].dtype, device=xs[j].device)
            for j in range(n)]
    nbytes = xs[0].numel() * xs[0].element_size()
    if nbytes == 0:
        return outs
    pairs: dict = {}
    for i, x in enumerate(xs):
        pairs.setdefault(x.device, []).append((x, outs[(i + shift) % n]))
    from ..ops._build import check
    from ..ops._device import sm_count

    lib = _library()
    for src_dev, group in pairs.items():
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
        blocks = max(1, min(-(-nbytes // (_THREADS * _WORD)),
                            _BLOCKS_PER_SM * sm_count(src_dev) // count))
        with torch.cuda.device(src_dev):
            rc = lib.ring_permute(srcs, dsts, count, nbytes, blocks,
                                  stream.cuda_stream)
        check(rc, "ring_permute")
        ring_permute_kernel.launches += 1
        if remote:
            done = torch.cuda.Event()
            done.record(stream)
            for dst_dev in remote:
                torch.cuda.current_stream(dst_dev).wait_event(done)
    return outs


ring_permute_kernel.launches = 0


class RingPermuteFunction(torch.autograd.Function):
    """A rotation whose gradient is the inverse rotation, both through
    :func:`ring_permute_kernel` (the reference's ``_ring_permute_pallas``
    custom VJP)."""

    @staticmethod
    def forward(ctx, shift: int, *xs):
        ctx.shift = shift
        return tuple(ring_permute_kernel(list(xs), shift))

    @staticmethod
    def backward(ctx, *gs):
        grads = ring_permute_kernel([g.contiguous() for g in gs], -ctx.shift)
        return (None, *grads)


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
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown ring_permute impl {impl!r}; valid: auto, "
                         f"pallas, xla")
    xs = list(xs)
    if len(xs) != n:
        raise ValueError(f"ring_permute over {axis_name!r}: {len(xs)} "
                         f"buffers for a ring of {n}")
    _check(xs, "ring_permute")
    collectives.emit(
        site, collectives.MEDIUM_ICI,
        collectives.permute_bytes(
            collectives.payload_bytes(xs[0].shape, xs[0].dtype), n),
    )
    shift %= n
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(RingPermuteFunction.apply(shift, *xs))
    return ring_permute_kernel(xs, shift)


def ring_attention(*args, **kwargs):
    raise NotImplementedError(
        "ring_attention: sequence parallelism over K4-K6 per hop is not "
        "ported (A12 in ROADMAP.md)"
    )


def ulysses_attention(*args, **kwargs):
    raise NotImplementedError(
        "ulysses_attention: all-to-all sequence parallelism is not ported "
        "(A12 in ROADMAP.md)"
    )
