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
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"
_SCALARS = (bool, int, float, str, type(None))


class MeshShapeMismatchError(ValueError):
    """The restore template's mesh cannot hold the saved state (the
    reference's error, raised there before a restore touches disk). The
    port builds no mesh template yet: :func:`restore_template` refuses a
    mesh (ROADMAP A12)."""


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A template leaf without storage (the reference's
    ``jax.ShapeDtypeStruct``): where the restored tensor goes, its shape
    and dtype, and whether it is trainable."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device
    requires_grad: bool = False


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


def restore_template(skeleton: Any, mesh: Any) -> Any:
    """The restore template of a state skeleton (a fresh state, or the old
    state itself): every tensor becomes a :class:`TensorSpec` on the
    skeleton's device, scalars stay as they are. A mesh (the reference's
    elastic resume onto another allocation's layout) is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "restore_template: a mesh needs the multi-GPU slice (ROADMAP "
            "A12); pass mesh=None to restore onto the skeleton's devices")

    def spec(x, _path):
        if isinstance(x, torch.Tensor):
            return TensorSpec(tuple(x.shape), x.dtype, x.device,
                              x.requires_grad)
        return x

    return _rebuild(skeleton, spec)


def restore_checkpoint(
    directory: str,
    template: Any,
    step: Optional[int] = None,
) -> Any:
    """The state saved at ``step`` (default: the latest) in the structure
    of ``template`` (a state, or :func:`restore_template`'s specs), each
    tensor on its template leaf's device and trainable where the template
    leaf is. Raises ``FileNotFoundError`` before touching disk when
    nothing was saved there, and ``ValueError`` naming the leaf whose
    shape, dtype or kind differs."""
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
