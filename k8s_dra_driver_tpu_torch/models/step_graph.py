"""A step function captured once per static input shape as a CUDA graph and
replayed every call: the port's twin of ``jax.jit`` for the serving
engine's decode step and packed prefill step (the reference's
``jax.jit(_decode_fn)`` and ``jax.jit(_prefill_fn)``).

A :class:`StepGraph` wraps ``fn(*ints, *tensors)``. ``ints`` are host
int arrays (numpy; bool arrays arrive as int32 0/1); ``tensors`` are
device tensors, such as the previous step's on-device tokens. Per call the
host arrays are packed into one pinned staging buffer (two of them, used
in turn, so the host may mutate its arrays as soon as the call returns)
and sent to the device in one copy; ``fn`` sees int32 views of that
device buffer.

For each new static shape (the arrays' shapes and dtypes and the
tensors'), on a CUDA device:

1. **warm-up**: ``fn`` runs eagerly twice on a side stream, on zeroed
   inputs, so that every lazy thing is filled before the capture: the
   ``nvcc`` build and ``ctypes`` load of the kernels, the cuBLAS handle
   and its workspace for that stream, the SM count, the rope tables. Zeroed inputs are a neutral step for the
   engine: every row is inactive, so the pools see writes only in their
   scratch row;
2. **capture**: ``fn`` runs once more under ``torch.cuda.graph`` into a
   memory pool of its own (graphs of one process never share a pool, so
   one graph's replay cannot overwrite another's output);
3. **replay**: each call stages the host arrays, copies the tensors into
   the graph's static inputs on the stream, and replays. The returned
   tensor is the graph's static output: the next replay of that shape
   overwrites it, so a caller that keeps it copies it, or enqueues its
   copy, first.

Nothing falls back: a capture that fails (a host sync, a launch that
cannot be captured) or a replay that fails raises.

The kernels' wrappers count their launches in Python
(``ops.LAUNCH_COUNTERS``), which under a graph runs at capture only. So
a :class:`StepGraph` records each counter's change during the capture,
takes the warm-up's and the capture's counts back out, and adds the
recorded change on every replay: the counters read as if every replayed
step had launched eagerly.

A new shape counts 1 in ``counts[name]`` (the engine's
``compile_counts``): a capture on the card, the first use of that shape in
eager mode. Inside ``fn``, :func:`phase` reads ``"warmup"`` or
``"capture"`` (``models/decode.py`` counts a capture in
``TRACE_COUNTS`` and a warm-up not at all), else None.

``capture=False``, and any CPU device, runs ``fn`` eagerly on every call,
through the same staging: the twin of ``jax.disable_jit``.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import gc
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import LAUNCH_COUNTERS

__all__ = [
    "StepGraph",
    "phase",
    "read_launches",
    "write_launches",
    "launch_delta",
    "add_launches",
]

WARMUP_CALLS = 2

_PHASE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "step_graph_phase", default=None)


def phase() -> Optional[str]:
    """``"warmup"`` or ``"capture"`` while a :class:`StepGraph` runs its
    function for that purpose, else None."""
    return _PHASE.get()


@contextlib.contextmanager
def _in_phase(name: str):
    token = _PHASE.set(name)
    try:
        yield
    finally:
        _PHASE.reset(token)


def read_launches(counters=LAUNCH_COUNTERS) -> tuple:
    """Every counter's value, in ``counters``' order."""
    return tuple(getattr(fn, attr) for fn, attr in counters)


def write_launches(values: Sequence[int], counters=LAUNCH_COUNTERS) -> None:
    for (fn, attr), value in zip(counters, values, strict=True):
        setattr(fn, attr, value)


def launch_delta(before: Sequence[int], after: Sequence[int]) -> tuple:
    """What each counter gained from ``before`` to ``after``."""
    return tuple(a - b for a, b in zip(after, before, strict=True))


def add_launches(values: Sequence[int], delta: Sequence[int]) -> tuple:
    """``values`` with one replay's ``delta`` added."""
    return tuple(v + d for v, d in zip(values, delta, strict=True))


class _Staging:
    """Host int arrays packed into one int32 device buffer. On a CUDA
    device the host side is two pinned buffers used in turn, each reused
    only once the copy that last read it has finished (an event), so the
    host may mutate its arrays right after a call."""

    def __init__(self, arrays: Sequence[np.ndarray], device: torch.device):
        sizes = [a.size for a in arrays]
        self.device_buf = torch.zeros(sum(sizes), dtype=torch.int32,
                                      device=device)
        self.views = []
        start = 0
        for a, n in zip(arrays, sizes):
            self.views.append(
                self.device_buf[start:start + n].view(a.shape))
            start += n
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._host = [torch.zeros(sum(sizes), dtype=torch.int32,
                                      pin_memory=True) for _ in range(2)]
            self._copied: list = [None, None]
            self._turn = 0

    def stage(self, arrays: Sequence[np.ndarray]) -> None:
        if not self.views:
            return
        if not self._cuda:
            _pack(arrays, self.device_buf.numpy())
            return
        i, self._turn = self._turn, self._turn ^ 1
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        _pack(arrays, self._host[i].numpy())
        self.device_buf.copy_(self._host[i], non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._copied[i] = done


def _pack(arrays: Sequence[np.ndarray], out: np.ndarray) -> None:
    np.concatenate([np.asarray(a).reshape(-1) for a in arrays], out=out,
                   casting="unsafe")


@dataclasses.dataclass
class _Step:
    """One static shape: its staging, and on the card its graph, the
    graph's static tensor inputs and output, and the launches one replay
    makes."""

    staging: _Staging
    graph: "Optional[torch.cuda.CUDAGraph]" = None
    inputs: tuple = ()
    out: Optional[torch.Tensor] = None
    launches: tuple = ()


def _key(arrays, tensors) -> tuple:
    return (tuple((a.shape, a.dtype.str) for a in arrays),
            tuple((tuple(t.shape), t.dtype, t.device) for t in tensors))


class StepGraph:
    """``fn`` captured per static shape and replayed (see the module
    docstring). ``counts[name]`` counts the shapes captured (or, eager,
    first used); ``generator``, when given, is registered with every
    graph so that each replay draws new numbers from it. ``build_s``
    sums the host seconds spent setting shapes up (warm-ups and
    captures)."""

    def __init__(self, fn, device, *, counts: dict, name: str,
                 capture: bool = True,
                 generator: Optional[torch.Generator] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self.counts = counts
        self.name = name
        self.generator = generator
        self.build_s = 0.0
        self._steps: dict = {}

    @property
    def graphs(self) -> int:
        """The CUDA graphs this instance holds."""
        return sum(s.graph is not None for s in self._steps.values())

    def __call__(self, arrays: Sequence[np.ndarray],
                 *tensors: torch.Tensor) -> torch.Tensor:
        key = _key(arrays, tensors)
        step = self._steps.get(key)
        if step is None:
            t0 = time.perf_counter()
            step = self._build(arrays, tensors)
            self.build_s += time.perf_counter() - t0
            self._steps[key] = step
            self.counts[self.name] += 1
        step.staging.stage(arrays)
        if step.graph is None:
            return self.fn(*step.staging.views, *tensors)
        for dst, src in zip(step.inputs, tensors):
            dst.copy_(src, non_blocking=True)
        step.graph.replay()
        write_launches(add_launches(read_launches(), step.launches))
        return step.out

    def _build(self, arrays, tensors) -> _Step:
        staging = _Staging(arrays, self.device)
        if not self.capture:
            return _Step(staging)
        inputs = tuple(torch.zeros_like(t) for t in tensors)
        args = (*staging.views, *inputs)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        before = read_launches()
        try:
            side.wait_stream(stream)
            with torch.cuda.stream(side), _in_phase("warmup"):
                for _ in range(WARMUP_CALLS):
                    self.fn(*args)
            stream.wait_stream(side)
            start = read_launches()
            with _no_collection(), torch.cuda.graph(graph, stream=side), \
                    _in_phase("capture"):
                out = self.fn(*args)
            launches = launch_delta(start, read_launches())
        finally:
            write_launches(before)
        return _Step(staging, graph, inputs, out, launches)


@contextlib.contextmanager
def _no_collection():
    """The cyclic garbage collector off: a dead reference cycle that holds
    a graph (an engine no longer used), collected mid-capture, would
    destroy that graph there, a CUDA call a capture forbids, and the
    capture would fail. The cycle is collected after the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()
