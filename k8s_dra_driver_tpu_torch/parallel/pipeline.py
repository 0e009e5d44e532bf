"""Pipeline parallelism: the GPipe microbatch schedule over the ``pipe``
axis of a single-controller mesh. Counterpart of
``k8s_dra_driver_tpu/parallel/pipeline.py``.

Stages are the shards along ``pipe``; stage weights are the layer stack
viewed as ``[n_stages, L / n_stages, ...]`` (:func:`stage_params`), and
activations move stage to stage through K9's twin
(``parallel/ring.py::ring_permute_group``), one grouped launch a step for
every batch group's ring and every leaf of the activation pytree. The
schedule is plain GPipe: microbatch j enters stage p at step p + j, so M
microbatches over P stages take M + P - 1 steps with a bubble share of
(P - 1) / (M + P - 1).

The reference runs the schedule as a ``fori_loop`` inside a
``shard_map``, each stage computing (and discarding) its bubble slots;
here it is a host loop that skips them (a difference by design: the
result is the same), and sends no hop after the last step that carries
an activation: M + P - 2 hops. Autograd runs back through the loop and
the hops (each hop's gradient is the inverse rotation, one launch); there
is no custom backward, as the reference has none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from .ring import _rotate


def _tree_map(fn, tree):
    """``fn`` on every tensor of ``tree``: dicts, lists and tuples, and
    dataclass leaves such as ``QuantTensor`` field by field (the
    reference's ``jax.tree_util`` descends into its registered pytrees)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def stage_params(layer_stack: Any, n_stages: int) -> Any:
    """A layer-stacked pytree ``[L, ...]`` viewed as ``[n_stages, L /
    n_stages, ...]`` (views: the gradient reaches the stack)."""
    def split(a):
        l = a.shape[0]
        assert l % n_stages == 0, (
            f"{l} layers do not split over {n_stages} pipeline stages"
        )
        return a.reshape(n_stages, l // n_stages, *a.shape[1:])
    return _tree_map(split, layer_stack)


def pipeline(
    stage_fn: Callable[..., Any],
    staged: Any,                      # [n_stages, L/P, ...] pytree
    x: Any,                           # [B, ...] tensor or pytree of them
    *,
    mesh,
    n_microbatches: int,
    axis_name: str = "pipe",
    batch_axes: Optional[tuple] = ("data", "fsdp"),
    manual_only: bool = True,
    with_coords: bool = False,
) -> Any:
    """Run ``stage_fn`` (a same-structure transform of a microbatch, e.g.
    this stage's layers) as a P-stage GPipe pipeline over ``axis_name``.
    The rows of ``x`` split over the batch axes' groups (the first name
    major), each group's rows into ``n_microbatches`` microbatches; stage
    p of group g runs on the shard at (g, pipe p) and coordinate 0 of every
    other axis. ``x`` may be a pytree (dict, list or tuple) of tensors with
    one leading batch size; every leaf rides the same schedule and hops.
    Returns the transformed batch, its pytree, on ``x``'s device.

    ``stage_fn(staged_p, x_mb)`` gets stage p's slice of ``staged`` (on
    the stage's device) and a microbatch; with ``with_coords`` it is called
    ``stage_fn(staged_p, x_mb, p, g)``, for a stage that places its own
    work on its sub-mesh (``Mesh.sub(axis_name, p)``), as the models'
    pipelined forwards do. ``manual_only`` is the reference's switch
    between a shard_map manual over every axis and one manual over pipe
    and batch only; on the single-controller mesh the stage function
    places its work itself either way, so it changes nothing."""
    del manual_only
    leaves = _leaves(x)
    b = leaves[0].shape[0]
    m = n_microbatches
    assert b % m == 0, f"batch {b} not divisible into {m} microbatches"
    batch_axes = tuple(batch_axes or ())
    dp = math.prod(mesh.shape[a] for a in batch_axes)
    if b % (dp * m):
        raise ValueError(f"batch {b} does not split into {dp} batch groups "
                         f"of {m} microbatches")
    n_stages = mesh.shape[axis_name]
    rows = b // (dp * m)
    home = leaves[0].device

    def device(g: int, p: int) -> torch.device:
        coords, rest = {}, g
        for axis in reversed(batch_axes):
            rest, coords[axis] = divmod(rest, mesh.shape[axis])
        return mesh.devices[mesh.index(**coords, **{axis_name: p})]

    devs = [[device(g, p) for p in range(n_stages)] for g in range(dp)]

    def stage(p: int, g: int):
        return _tree_map(lambda a: a[p].to(devs[g][p]), staged)

    def microbatch(g: int, j: int) -> list:
        start = (g * m + j) * rows
        return [a[start:start + rows].to(devs[g][0]) for a in leaves]

    outs = [[None] * m for _ in range(dp)]
    inbox = [[None] * n_stages for _ in range(dp)]   # what stage p reads
    for t in range(m + n_stages - 1):
        sent = [[None] * n_stages for _ in range(dp)]
        for g in range(dp):
            for p in range(n_stages):
                j = t - p
                if not 0 <= j < m:
                    continue            # a bubble slot: nothing to compute
                inp = microbatch(g, j) if p == 0 else inbox[g][p]
                args = (stage(p, g), _unflatten(x, inp))
                if with_coords:
                    args += (p, g)
                y = _leaves(stage_fn(*args))
                if p == n_stages - 1:
                    outs[g][j] = y
                else:
                    sent[g][p] = y
        if n_stages == 1 or t == m + n_stages - 2:
            continue                    # no stage waits for a hop
        # One grouped launch moves every group's leaves a stage on; a slot
        # that sends nothing rides as zeros (the wrap-around to stage 0
        # is never read).
        like = next(y for row in sent for y in row if y is not None)
        rings = []
        for g in range(dp):
            for i, ref in enumerate(like):
                rings.append([
                    sent[g][p][i].contiguous() if sent[g][p] is not None
                    else torch.zeros(ref.shape, dtype=ref.dtype,
                                     device=devs[g][p])
                    for p in range(n_stages)])
        moved = _rotate(rings)
        count = len(like)
        for g in range(dp):
            for p in range(n_stages):
                inbox[g][p] = [moved[g * count + i][p] for i in range(count)]
    gathered = [
        torch.cat([outs[g][j][i].to(home) for g in range(dp)
                   for j in range(m)], dim=0)
        for i in range(len(leaves))]
    return _unflatten(x, gathered)
