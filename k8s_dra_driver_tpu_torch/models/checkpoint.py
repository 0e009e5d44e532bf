"""Model and train-state checkpoints. Counterpart of
``k8s_dra_driver_tpu/models/checkpoint.py``.

A DRA-scheduled training pod that is preempted or rescheduled resumes
from the latest step. The reference writes with orbax; the port has no
orbax (and no JAX), so it writes with ``torch.save`` and reads with
``torch.load(weights_only=True)``: an orbax checkpoint of the reference
is not readable here, nor the other way round.

Layout: ``<directory>/<step>/state.pt``, one file a step holding a flat
dict from key paths (``"params/layers/wqkv"``, ``"opt_state/count"``,
``"step"``) to tensors and Python scalars. A step is written under a
temporary name that begins with a dot and then renamed
(``os.replace``), so a step directory is complete or absent, and
:func:`latest_step` ignores what an interrupted save left behind. The
newest ``max_to_keep`` steps are kept.

A state is any nesting of dicts and dataclasses over tensors and Python
scalars: a params dict, or ``TrainState`` with its ``AdamWState``.
``weights_only`` loads no dataclass, so :func:`restore_checkpoint`
rebuilds the template's structure around the loaded leaves.

A template for a mesh (:func:`restore_template` with ``mesh``, the
elastic resume onto another allocation's layout) places every leaf as
the port's train state on a mesh is placed: whole on the mesh's first
device, with a ``NamedSharding`` twin per leaf -- the params' specs
(``TrainState.shardings``) re-anchored to the mesh, everything else
replicated. :func:`restore_checkpoint` refuses such a template, before it
reads the file, where a spec cannot tile its leaf on that mesh.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Optional

import torch

from ..parallel.sharding import NamedSharding, P, Sharded

STATE_FILE = "state.pt"
_SCALARS = (bool, int, float, str, type(None))


class MeshShapeMismatchError(ValueError):
    """The restore template's mesh cannot hold the saved state: some
    leaf's dimension is cut more ways than it divides into. Raised
    before the restore reads the file, naming the leaf, its shape, the
    mesh's shape and the spec."""


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A template leaf without storage (the reference's
    ``jax.ShapeDtypeStruct``): where the restored tensor goes, its shape
    and dtype, whether it is trainable, and on a mesh its placement (a
    ``NamedSharding``)."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device
    requires_grad: bool = False
    sharding: Optional[NamedSharding] = None


def _children(node: Any):
    """(key, child) pairs of a dict or a dataclass instance; None for a
    leaf (a tensor, a :class:`TensorSpec` or a Python scalar)."""
    if isinstance(node, dict):
        return list(node.items())
    if dataclasses.is_dataclass(node) and not isinstance(node, type) \
            and not isinstance(node, TensorSpec):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)
                if f.metadata.get("checkpoint", True)]
    if isinstance(node, (torch.Tensor, TensorSpec, *_SCALARS)):
        return None
    raise TypeError(f"checkpoint: a {type(node).__name__} in the state; a "
                    f"state nests dicts and dataclasses over tensors and "
                    f"Python scalars")


def _path(prefix: str, key) -> str:
    if not isinstance(key, str) or "/" in key:
        raise TypeError(f"checkpoint: key {key!r} under "
                        f"{prefix or 'the root'} is not a string free of "
                        f"'/'")
    return f"{prefix}/{key}" if prefix else key


def _flatten(node: Any, prefix: str = "") -> dict:
    """{key path: leaf} of a nesting of dicts and dataclasses."""
    children = _children(node)
    if children is None:
        return {prefix: node}
    out = {}
    for key, child in children:
        out.update(_flatten(child, _path(prefix, key)))
    return out


def _rebuild(node: Any, fn, prefix: str = "") -> Any:
    """``node``'s structure with each leaf replaced by ``fn(leaf,
    path)``."""
    children = _children(node)
    if children is None:
        return fn(node, prefix)
    new = {key: _rebuild(child, fn, _path(prefix, key))
           for key, child in children}
    return new if isinstance(node, dict) else dataclasses.replace(node, **new)


def _steps(directory: str) -> list[int]:
    """The complete steps under ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit()
        and os.path.isfile(os.path.join(directory, name, STATE_FILE))
    )


def save_checkpoint(
    directory: str,
    state: Any,
    step: int,
    max_to_keep: int = 3,
    wait: bool = True,
) -> None:
    """Save ``state`` at ``step`` and keep the newest ``max_to_keep``
    steps. The write is synchronous (``wait`` is the reference's
    signature: orbax can return before its write ends)."""
    directory = os.path.abspath(directory)
    final = os.path.join(directory, str(int(step)))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint step {step} exists under "
                              f"{directory}")
    flat = {path: x.detach() if isinstance(x, torch.Tensor) else x
            for path, x in _flatten(state).items()}
    if any(isinstance(x, TensorSpec) for x in flat.values()):
        raise TypeError("checkpoint: save a state, not a restore template")
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".{int(step)}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(flat, os.path.join(tmp, STATE_FILE))
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under ``directory``, or None (also for a
    missing directory)."""
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


def _specs_by_path(skeleton: Any) -> dict:
    """{key path: spec} of the params a state's ``shardings`` places (a
    ``TrainState`` on a mesh); empty for any other skeleton."""
    def walk(node, prefix):
        if isinstance(node, NamedSharding):
            return {prefix: node.spec}
        out = {}
        for key, child in (node.items() if isinstance(node, dict) else ()):
            out.update(walk(child, _path(prefix, key)))
        return out

    return walk(getattr(skeleton, "shardings", None), "params")


def _reanchor(node: Any, mesh: Any) -> Any:
    """``node`` with every ``NamedSharding`` in it re-anchored to
    ``mesh``, through dicts and every field of a dataclass (also those
    a checkpoint does not save, as ``TrainState.shardings``)."""
    if isinstance(node, NamedSharding):
        return NamedSharding(mesh, node.spec)
    if isinstance(node, dict):
        return {k: _reanchor(v, mesh) for k, v in node.items()}
    if dataclasses.is_dataclass(node) and not isinstance(node, type) \
            and not isinstance(node, TensorSpec):
        return dataclasses.replace(node, **{
            f.name: _reanchor(getattr(node, f.name), mesh)
            for f in dataclasses.fields(node)})
    return node


def restore_template(skeleton: Any, mesh: Any) -> Any:
    """The restore template of a state skeleton (a fresh state, or the old
    state itself): every tensor becomes a :class:`TensorSpec`, scalars
    stay as they are. Without a mesh each spec stays on the skeleton
    tensor's device. With ``mesh`` every spec goes to ``mesh.devices[0]``
    with its placement on ``mesh``: a param keeps its spec from the
    skeleton's ``shardings``, re-anchored to ``mesh`` (a skeleton from a
    dead allocation must not pin the restore to its devices), every other
    leaf -- the optimizer's moments -- is replicated; the skeleton's own
    ``shardings`` re-anchor to ``mesh`` as well. The template is built
    even where ``mesh`` cannot lay a leaf out: :func:`restore_checkpoint`
    refuses it."""
    specs = _specs_by_path(skeleton) if mesh is not None else {}

    def spec(x, path):
        if not isinstance(x, torch.Tensor):
            return x
        if mesh is None:
            return TensorSpec(tuple(x.shape), x.dtype, x.device,
                              x.requires_grad)
        return TensorSpec(tuple(x.shape), x.dtype, mesh.devices[0],
                          x.requires_grad,
                          NamedSharding(mesh, specs.get(path, P())))

    template = _rebuild(skeleton, spec)
    return template if mesh is None else _reanchor(template, mesh)


def _validate_template_meshable(template: Any) -> None:
    """Raise :class:`MeshShapeMismatchError` for the first template leaf
    whose spec cannot tile it on its mesh: an entry naming mesh axes
    whose product does not divide the dimension, or more entries than
    the leaf has dimensions."""
    for path, leaf in _flatten(template).items():
        if not isinstance(leaf, TensorSpec) or leaf.sharding is None:
            continue
        mesh, spec = leaf.sharding.mesh, leaf.sharding.spec
        why = None
        if len(spec) > len(leaf.shape):
            why = (f"the spec has {len(spec)} entries for "
                   f"{len(leaf.shape)} dimensions")
        else:
            for dim, _, ways in Sharded((), spec, mesh).splits:
                if leaf.shape[dim] % ways:
                    why = (f"dimension {dim} of size {leaf.shape[dim]} "
                           f"does not divide over {ways} shards")
                    break
        if why is not None:
            raise MeshShapeMismatchError(
                f"saved state {path} of shape {tuple(leaf.shape)} cannot "
                f"be restored onto mesh {dict(mesh.shape)} with spec "
                f"{spec} ({why}); lower the offending mesh axis degree or "
                f"restore onto a mesh whose preserved degrees divide the "
                f"saved shapes")


def restore_checkpoint(
    directory: str,
    template: Any,
    step: Optional[int] = None,
) -> Any:
    """The state saved at ``step`` (default: the latest) in the structure
    of ``template`` (a state, or :func:`restore_template`'s specs), each
    tensor on its template leaf's device and trainable where the template
    leaf is. Raises ``FileNotFoundError`` before touching disk when
    nothing was saved there, :class:`MeshShapeMismatchError` before
    reading the file when a mesh template's spec cannot tile its leaf,
    and ``ValueError`` naming the leaf whose shape, dtype or kind
    differs."""
    directory = os.path.abspath(directory)
    steps = _steps(directory)
    if not steps:
        asked = "" if step is None else f" (asked for step {step})"
        raise FileNotFoundError(
            f"no checkpoint found under {directory}{asked}")
    step = steps[-1] if step is None else int(step)
    if step not in steps:
        raise FileNotFoundError(f"no checkpoint for step {step} under "
                                f"{directory} (steps {steps})")
    _validate_template_meshable(template)
    leaves = _flatten(template)
    devices = [x.device for x in leaves.values()
               if isinstance(x, (torch.Tensor, TensorSpec))]
    saved = torch.load(os.path.join(directory, str(step), STATE_FILE),
                       map_location=devices[0] if devices else "cpu",
                       weights_only=True)
    missing = sorted(set(leaves) - set(saved))
    extra = sorted(set(saved) - set(leaves))
    if missing or extra:
        raise ValueError(f"checkpoint step {step}: the template's leaves "
                         f"{missing} are not saved, the saved {extra} not "
                         f"in the template")
    for path, want in leaves.items():
        got = saved[path]
        if isinstance(want, (torch.Tensor, TensorSpec)):
            if not isinstance(got, torch.Tensor) \
                    or tuple(got.shape) != tuple(want.shape) \
                    or got.dtype != want.dtype:
                what = (f"{got.dtype} {tuple(got.shape)}"
                        if isinstance(got, torch.Tensor) else repr(got))
                raise ValueError(
                    f"checkpoint step {step}: {path} is saved as {what}; "
                    f"the template wants {want.dtype} {tuple(want.shape)}")
            saved[path] = got.to(want.device).requires_grad_(
                want.requires_grad)
        elif isinstance(got, torch.Tensor):
            raise ValueError(f"checkpoint step {step}: {path} is saved as a "
                             f"tensor; the template holds {want!r}")
    return _rebuild(template, lambda _leaf, path: saved[path])
