"""The port's train-state checkpoints (``models/checkpoint.py``) against
the JAX package's (orbax), on the CPU at the ``tiny`` preset.

The reference's round trip and no-mkdir tests run on both packages; the
port's own behaviour (retention, the step a restore reads, the template's
checks, a bitwise resume) runs on the port. Nothing here is approximate:
a restore gives the saved bits back, and a resumed run is bitwise equal
to one that was never interrupted.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import checkpoint as jckpt
from k8s_dra_driver_tpu.models import llama as jllama
from k8s_dra_driver_tpu_torch.models import checkpoint as tckpt
from k8s_dra_driver_tpu_torch.models import llama as tllama
from k8s_dra_driver_tpu_torch.models import train as ttrain

TINY = tllama.PRESETS["tiny"]


def _jax_params():
    params = jllama.init_params(jllama.PRESETS["tiny"], jax.random.PRNGKey(0))
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding),
        params)
    return params, template, lambda tree: np.asarray(tree["embed"])


def _port_params():
    params = tllama.init_params(TINY, seed=0, device="cpu")
    return (params, tckpt.restore_template(params, None),
            lambda tree: tree["embed"].numpy())


PACKAGES = {"jax": (jckpt, _jax_params), "port": (tckpt, _port_params)}


@pytest.mark.parametrize("package", list(PACKAGES))
def test_save_restore_roundtrip(tmp_path, package):
    mod, make = PACKAGES[package]
    params, template, embed = make()
    mod.save_checkpoint(str(tmp_path / "ckpt"), params, step=7)
    assert mod.latest_step(str(tmp_path / "ckpt")) == 7
    restored = mod.restore_checkpoint(str(tmp_path / "ckpt"), template)
    np.testing.assert_array_equal(embed(restored), embed(params))


@pytest.mark.parametrize("package", list(PACKAGES))
def test_typod_path_fails_without_mkdir_side_effect(tmp_path, package):
    """A restore from a nonexistent directory fails loudly and leaves no
    directory behind, with and without an explicit step."""
    mod, _ = PACKAGES[package]
    typo = str(tmp_path / "no-such-ckpt")
    for step in (None, 7):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            mod.restore_checkpoint(typo, template={}, step=step)
        assert not os.path.exists(typo), f"step={step} made the directory"
    assert mod.latest_step(typo) is None


def test_keeps_the_newest_steps_and_ignores_unfinished_ones(tmp_path):
    params = {"w": torch.arange(4.0)}
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(d, {"w": params["w"] + step}, step,
                              max_to_keep=3)
    assert sorted(os.listdir(d)) == ["3", "4", "5"]
    # What an interrupted save leaves (a temporary directory, or a step
    # directory without its file) is not a step.
    os.makedirs(os.path.join(d, ".9.123.tmp"))
    os.makedirs(os.path.join(d, "8"))
    assert tckpt.latest_step(d) == 5
    template = {"w": tckpt.TensorSpec((4,), torch.float32,
                                      torch.device("cpu"))}
    assert torch.equal(tckpt.restore_checkpoint(d, template)["w"],
                       params["w"] + 5)
    assert torch.equal(tckpt.restore_checkpoint(d, template, step=3)["w"],
                       params["w"] + 3)
    with pytest.raises(FileNotFoundError, match="step 1"):
        tckpt.restore_checkpoint(d, template, step=1)
    with pytest.raises(FileExistsError):
        tckpt.save_checkpoint(d, params, 5)


def test_train_state_round_trips_bitwise_in_bf16(tmp_path):
    """A ``TrainState`` (dataclasses, an int count and step, bf16 params
    and moments) comes back with the same bits, structure, dtypes and
    ``requires_grad``."""
    cfg = dataclasses.replace(TINY, dtype=torch.bfloat16)
    opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
    state = ttrain.init_train_state(cfg, opt, seed=3, device="cpu")
    state.opt_state.count, state.step = 4, 5
    for m in ttrain.leaves(state.opt_state.mu):
        m.normal_()
    tckpt.save_checkpoint(str(tmp_path), state, 5)
    fresh = ttrain.init_train_state(cfg, opt, seed=9, device="cpu")
    back = tckpt.restore_checkpoint(str(tmp_path),
                                    tckpt.restore_template(fresh, None))
    assert isinstance(back, ttrain.TrainState)
    assert isinstance(back.opt_state, ttrain.AdamWState)
    assert (back.step, back.opt_state.count) == (5, 4)
    for tree in ("params", "mu", "nu"):
        want = (state.params if tree == "params"
                else getattr(state.opt_state, tree))
        got = (back.params if tree == "params"
               else getattr(back.opt_state, tree))
        for a, b in zip(ttrain.leaves(want), ttrain.leaves(got)):
            assert b.dtype == a.dtype and b.requires_grad == a.requires_grad
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_resume_after_save_and_restore_is_bitwise(tmp_path):
    """Two AdamW steps, a save, two more steps; then a restore into a
    fresh state's template and the same two steps: the losses, parameters
    and both moments are bitwise equal."""
    opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
    step = ttrain.make_train_step(TINY, opt, device="cpu")
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(0, TINY.vocab_size,
                                            size=(2, 17)).astype(np.int32))
               for _ in range(4)]
    state = ttrain.init_train_state(TINY, opt, seed=0, device="cpu")
    for toks in batches[:2]:
        state, _ = step(state, toks)
    tckpt.save_checkpoint(str(tmp_path), state, state.step)
    straight = [step(state, toks)[1] for toks in batches[2:]]

    template = tckpt.restore_template(
        ttrain.init_train_state(TINY, opt, seed=1, device="cpu"), None)
    resumed = tckpt.restore_checkpoint(str(tmp_path), template)
    assert resumed.step == 2 and resumed.opt_state.count == 2
    again = [step(resumed, toks)[1] for toks in batches[2:]]
    assert [x.item() for x in again] == [x.item() for x in straight]
    for a, b in zip(ttrain.leaves(state.params),
                    ttrain.leaves(resumed.params)):
        assert torch.equal(a, b)
    for which in ("mu", "nu"):
        for a, b in zip(ttrain.leaves(getattr(state.opt_state, which)),
                        ttrain.leaves(getattr(resumed.opt_state, which))):
            assert torch.equal(a, b)
    assert resumed.step == state.step == 4


def test_a_leaf_that_does_not_fit_the_template_raises_naming_it(tmp_path):
    params = tllama.init_params(TINY, seed=0, device="cpu")
    tckpt.save_checkpoint(str(tmp_path), params, 1)
    template = tckpt.restore_template(params, None)
    wrong = dict(template, layers=dict(
        template["layers"],
        wo=dataclasses.replace(template["layers"]["wo"], shape=(2, 8, 8))))
    with pytest.raises(ValueError, match="layers/wo"):
        tckpt.restore_checkpoint(str(tmp_path), wrong)
    bf16 = dict(template, final_norm=dataclasses.replace(
        template["final_norm"], dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="final_norm"):
        tckpt.restore_checkpoint(str(tmp_path), bf16)
    with pytest.raises(ValueError, match="extra"):
        tckpt.restore_checkpoint(str(tmp_path), dict(template, extra=0))


def test_restore_template_with_a_mesh_raises(tmp_path):
    """A mesh template places each tensor on the mesh's first device with
    a ``NamedSharding`` (replicated where the skeleton names no spec), and
    builds even for a mesh that cannot lay a leaf out; the restore then
    raises ``MeshShapeMismatchError`` naming the leaf, its shape, the
    mesh's shape and the spec, before it reads the file."""
    from k8s_dra_driver_tpu_torch.parallel import MeshConfig, build_mesh
    from k8s_dra_driver_tpu_torch.parallel.sharding import NamedSharding, P

    params = {"w": torch.zeros(2)}
    spec = tckpt.restore_template(params, None)["w"]
    assert spec == tckpt.TensorSpec((2,), torch.float32, torch.device("cpu"),
                                    False)
    assert issubclass(tckpt.MeshShapeMismatchError, ValueError)
    mesh = build_mesh(MeshConfig(tensor=4), devices=["cpu"] * 4)
    opt = ttrain.make_optimizer(warmup_steps=1, total_steps=10)
    state = ttrain.init_train_state(
        TINY, opt, mesh=build_mesh(MeshConfig(tensor=2),
                                   devices=["cpu"] * 2))
    tckpt.save_checkpoint(str(tmp_path), state, 0)
    template = tckpt.restore_template(state, mesh)
    wqkv = template.params["layers"]["wqkv"]
    assert wqkv.device == mesh.devices[0] and wqkv.requires_grad
    assert wqkv.sharding == NamedSharding(
        mesh, state.shardings["layers"]["wqkv"].spec)
    assert template.opt_state.mu["embed"].sharding == NamedSharding(mesh, P())
    assert template.shardings["embed"].mesh is mesh
    # tensor=4 cannot cut the tiny config's 2 kv heads.
    with pytest.raises(tckpt.MeshShapeMismatchError) as exc:
        tckpt.restore_checkpoint(str(tmp_path), template)
    msg = str(exc.value)
    for part in ("params/layers/wqkv", "shape (2, 64, 2, 4, 16)",
                 "cannot be restored onto mesh", "'tensor': 4", "P("):
        assert part in msg, (part, msg)
