"""The port's elastic training (``parallel/elastic.py``) and mesh restore
templates (``models/checkpoint.py``) against the JAX package's: the twins
of ``tests/test_elastic_resume.py`` and of
``tests/test_faults.py::TestInjectionSites::test_train_step_site_reaches_trainer``,
on the ``tiny`` preset.

The reference's trainer runs on conftest's 8 virtual devices; the port's
on a gang of members ``tpu-0`` .. ``tpu-7``, all on the CPU. Each resize
scenario runs once per package (the reference's trainers are built once
per module): the port's trainer starts from the reference's initial
parameters (``params_from_numpy``), steps the same tokens and resizes onto
the same member indices. Every ``ResizeEvent`` field but
``duration_seconds`` is equal, the ``tpu_dra_elastic_*`` families render
alike, ``state_covered`` answers alike for every loss mask of the gang
before each resize, and the losses agree within the reference's own
tolerance across meshes (rtol 2e-4, atol 2e-4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import train as jtrain
from k8s_dra_driver_tpu.models.llama import PRESETS as JPRESETS
from k8s_dra_driver_tpu.parallel import MeshConfig as JMeshConfig
from k8s_dra_driver_tpu.parallel import elastic as jelastic
from k8s_dra_driver_tpu.utils.metrics import Registry as JRegistry
from k8s_dra_driver_tpu_torch.models import checkpoint as tckpt
from k8s_dra_driver_tpu_torch.models import train as ttrain
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.models.llama import PRESETS, param_specs
from k8s_dra_driver_tpu_torch.parallel import MeshConfig, build_mesh
from k8s_dra_driver_tpu_torch.parallel import elastic
from k8s_dra_driver_tpu_torch.parallel.sharding import NamedSharding, P
from k8s_dra_driver_tpu_torch.utils import faults
from k8s_dra_driver_tpu_torch.utils.metrics import Registry
from test_torch_kube import exposition

CPU = torch.device("cpu")
JTINY, TINY = JPRESETS["tiny"], PRESETS["tiny"]
MEMBERS = [f"tpu-{i}" for i in range(8)]
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
EVENT_KEYS = ("direction", "path", "reason", "step", "old_mesh", "new_mesh",
              "n_old", "n_used", "n_idled")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny trainer's ops are too small to share among threads: one
    intra-op thread keeps them quick where the suite's workers share the
    cores (many threads each made them 5x slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(n, batch=8):  # divisible by both meshes' (data x fsdp)
    return [np.asarray(jax.random.randint(
        jax.random.PRNGKey(100 + i), (batch, 65), 0, TINY.vocab_size))
        for i in range(n)]


def cpu_mesh(**axes):
    mc = MeshConfig(**axes)
    return build_mesh(mc, devices=[CPU] * mc.num_devices)


def opt_for(train_mod):
    return train_mod.make_optimizer(warmup_steps=1, total_steps=10)


# -- the resize scenarios, once per package -----------------------------------


class RefSide:
    """The reference's trainer over conftest's virtual devices."""

    def __init__(self):
        self.devices = jax.devices()
        assert len(self.devices) >= 8

    registry = JRegistry

    def trainer(self, n, axes, registry, _init, **kw):
        return jelastic.ElasticTrainer(
            JTINY, opt_for(jtrain), self.devices[:n],
            mesh_config=JMeshConfig(**axes), global_batch=8,
            registry=registry, **kw)

    def gang(self, idx):
        return [self.devices[i] for i in idx]

    def step(self, trainer, toks):
        return trainer.step(jnp.asarray(toks))

    def covered(self, trainer, idx):
        return jelastic.state_covered(trainer.state, self.gang(idx))

    error = jelastic.ElasticResizeError


class PortSide:
    """The port's trainer over members all on the CPU, started from the
    reference's initial parameters."""

    registry = Registry

    def trainer(self, n, axes, registry, init, **kw):
        trainer = elastic.ElasticTrainer(
            TINY, opt_for(ttrain), MEMBERS[:n],
            mesh_config=MeshConfig(**axes), global_batch=8,
            registry=registry, device_of=dict.fromkeys(MEMBERS, CPU),
            **kw)
        trainer.state = ttrain.train_state_from_params(
            params_from_numpy(init, TINY, device="cpu"),
            trainer.optimizer, mesh=trainer.mesh)
        return trainer

    def gang(self, idx):
        return [MEMBERS[i] for i in idx]

    def step(self, trainer, toks):
        return trainer.step(torch.tensor(toks))

    def covered(self, trainer, idx):
        return elastic.state_covered(trainer.state, self.gang(idx),
                                     trainer.members)

    error = elastic.ElasticResizeError


def masks(n):
    """Every subset of the gang's first ``n`` members, as index tuples."""
    return [tuple(i for i in range(n) if bit >> i & 1)
            for bit in range(1 << n)]


def event(ev):
    return {k: getattr(ev, k) for k in EVENT_KEYS}


def scenario_grow(side, trainer, toks, _tmp):
    losses = [side.step(trainer, t) for t in toks[:2]]
    covered = [side.covered(trainer, m) for m in masks(2)]
    ev = trainer.resize(side.gang(range(4)), reason="spares restored")
    losses += [side.step(trainer, t) for t in toks[2:]]
    return dict(events=[event(ev)], losses=losses, covered=covered,
                idled=len(trainer.idled))


def scenario_shrink(side, trainer, toks, _tmp):
    losses = [side.step(trainer, t) for t in toks[:2]]
    covered = [side.covered(trainer, m) for m in masks(8)]
    ev = trainer.resize(side.gang(range(7)), reason="chip 7 gone")
    losses += [side.step(trainer, t) for t in toks[2:]]
    return dict(events=[event(ev)], losses=losses, covered=covered,
                idled=len(trainer.idled))


def scenario_cold(side, trainer, toks, tmp):
    """The reference's no-checkpoint case (no directory configured, then
    an empty one) on the fsdp gang after one step, then its cold case:
    a save after two steps, a step past it, the cold resize."""
    losses = [side.step(trainer, toks[0])]
    errors = []
    state_before = trainer.state
    for directory in (None, trainer.checkpoint_dir):
        trainer.checkpoint_dir = directory
        with pytest.raises(side.error, match="no checkpoint") as exc:
            trainer.resize(side.gang(range(2)), reason="chips 2+3 gone")
        errors.append(str(exc.value).replace(str(tmp), "<dir>"))
        assert trainer.state is state_before
        assert trainer.mesh_config.num_devices == 4
    losses.append(side.step(trainer, toks[1]))
    trainer.save()
    losses.append(side.step(trainer, toks[2]))
    assert trainer.step_count == 3
    covered = [side.covered(trainer, m) for m in masks(4)]
    ev = trainer.resize(side.gang(range(2)), reason="chips 2+3 gone")
    assert trainer.step_count == 2
    assert trainer.mesh_config.num_devices == 2
    losses.append(side.step(trainer, toks[2]))
    assert trainer.step_count == 3
    return dict(events=[event(ev)], losses=losses, covered=covered,
                errors=errors)


def scenario_no_mesh(side, trainer, _toks, _tmp):
    with pytest.raises(side.error, match="no valid sub-mesh") as exc:
        trainer.resize(side.gang([0]), reason="only one survivor")
    return dict(events=[], losses=[], errors=[str(exc.value)])


SCENARIOS = {
    "grow": (scenario_grow, 2, dict(tensor=2), {}),
    "non_pow2_shrink": (scenario_shrink, 8, dict(data=4, tensor=2), {}),
    "cold": (scenario_cold, 4, dict(fsdp=4), {"checkpoint_dir": True}),
    "no_valid_submesh": (scenario_no_mesh, 4, dict(data=2, tensor=2), {}),
}


def run(side, name, tmp, init=None):
    fn, n, axes, kw = SCENARIOS[name]
    if kw.get("checkpoint_dir"):
        kw = dict(kw, checkpoint_dir=str(tmp / "ckpt"))
    registry = side.registry()
    trainer = side.trainer(n, axes, registry, init, **kw)
    params = (jax.tree.map(np.asarray, trainer.state.params)
              if init is None else None)
    out = fn(side, trainer, batches(4), tmp)
    out.update(metrics=exposition(registry, "tpu_dra_elastic_"),
               mesh=str(trainer.mesh_config),
               trace=[event(e) for e in trainer.resize_trace])
    return out, params


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's scenarios, each run once for the module; a
    scenario's entry is (observations, initial parameters as numpy)."""
    side, cache = RefSide(), {}

    def get(name):
        if name not in cache:
            cache[name] = run(side, name, tmp_path_factory.mktemp(name))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_resize_decisions_and_losses_match_the_reference(
        name, reference_runs, tmp_path):
    want, init = reference_runs(name)
    got, _ = run(PortSide(), name, tmp_path, init=init)
    np.testing.assert_allclose(got.pop("losses"), want["losses"], **LOSS_TOL)
    want = {k: v for k, v in want.items() if k != "losses"}
    assert got == want


@pytest.mark.parametrize("axes", [
    dict(), dict(tensor=2), dict(data=2, tensor=2), dict(fsdp=4),
    dict(data=4, tensor=2), dict(sequence=2, tensor=2), dict(pipe=2),
    dict(data=2, expert=2), dict(fsdp=2, tensor=3),
], ids=str)
def test_largest_usable_count_matches_the_reference(axes):
    got = [[elastic.largest_usable_count(n, MeshConfig(**axes), batch)
            for n in range(10)] for batch in (8, None)]
    want = [[jelastic.largest_usable_count(n, JMeshConfig(**axes), batch)
             for n in range(10)] for batch in (8, None)]
    assert got == want


# -- test_elastic_resume.py ---------------------------------------------------


def run_steps(state, step_fn, toks):
    losses = []
    for t in toks:
        state, loss = step_fn(state, torch.tensor(t))
        losses.append(float(loss))
    return state, losses


def test_resume_on_a_different_mesh_matches_uninterrupted(tmp_path):
    """Preempted after 3 steps on data 2 x tensor 2, restored onto data 4
    x fsdp 2 through a fresh skeleton's template: the restored state is
    placed on the new mesh, and its 2 steps land where the uninterrupted
    run lands."""
    opt = opt_for(ttrain)
    toks = batches(5)
    mesh_a = cpu_mesh(data=2, tensor=2)
    step_a = ttrain.make_train_step(TINY, opt, mesh=mesh_a)
    ref_state = ttrain.init_train_state(TINY, opt, mesh=mesh_a)
    ref_state, ref_losses = run_steps(ref_state, step_a, toks)

    state = ttrain.init_train_state(TINY, opt, mesh=mesh_a)
    state, pre = run_steps(state, step_a, toks[:3])
    np.testing.assert_allclose(pre, ref_losses[:3], rtol=1e-6)
    tckpt.save_checkpoint(str(tmp_path / "ckpt"), state, step=state.step)
    assert tckpt.latest_step(str(tmp_path / "ckpt")) == 3

    mesh_b = cpu_mesh(data=4, fsdp=2)
    skeleton = ttrain.init_train_state(TINY, opt, seed=123, mesh=mesh_b)
    template = tckpt.restore_template(skeleton, mesh_b)
    restored = tckpt.restore_checkpoint(str(tmp_path / "ckpt"), template)
    assert isinstance(restored, ttrain.TrainState)
    assert restored.step == 3 and restored.opt_state.count == 3
    # Every leaf landed with mesh B's placement, not mesh A's.
    placed = ttrain.state_shardings(restored, mesh_b)
    for got, want in zip(ttrain.leaves(restored.shardings),
                         ttrain.leaves(placed.params)):
        assert got == want and got.mesh is mesh_b
    step_b = ttrain.make_train_step(TINY, opt, mesh=mesh_b)
    _, post = run_steps(restored, step_b, toks[3:])
    np.testing.assert_allclose(post, ref_losses[3:], **LOSS_TOL)


def test_old_state_works_as_template_skeleton(tmp_path):
    """The preempted state itself as the skeleton: its specs transfer,
    every leaf (and the state's own placement) re-anchors to the new
    mesh, the moments replicated."""
    opt = opt_for(ttrain)
    mesh_a = cpu_mesh(data=2)
    state = ttrain.init_train_state(TINY, opt, mesh=mesh_a)
    tckpt.save_checkpoint(str(tmp_path / "ckpt"), state, step=0)

    mesh_b = cpu_mesh(data=2, fsdp=2)
    template = tckpt.restore_template(state, mesh_b)
    restored = tckpt.restore_checkpoint(str(tmp_path / "ckpt"), template)
    specs = ttrain.leaves(ttrain._named(param_specs(TINY), mesh_b))
    for sh, want in zip(ttrain.leaves(template.params), specs):
        assert sh.sharding == want and sh.device == mesh_b.devices[0]
    for tree in (template.opt_state.mu, template.opt_state.nu):
        for sh in ttrain.leaves(tree):
            assert sh.sharding == NamedSharding(mesh_b, P())
    for tree in (template.shardings, restored.shardings):
        assert all(sh.mesh is mesh_b for sh in ttrain.leaves(tree))
    assert state.shardings["embed"].mesh is mesh_a   # the skeleton intact
    for a, b in zip(ttrain.leaves(state.params),
                    ttrain.leaves(restored.params)):
        assert torch.equal(a, b) and b.requires_grad


def test_restore_rejects_missing_checkpoint(tmp_path):
    assert tckpt.latest_step(str(tmp_path / "nope")) is None
    params = ttrain.init_train_state(TINY, opt_for(ttrain),
                                     device="cpu").params
    missing = tmp_path / "nope2"
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(missing), params)
    # The failed restore must not mkdir the typo'd path.
    assert not os.path.exists(missing)


def test_restore_onto_incompatible_mesh_raises_typed_error(
        tmp_path, monkeypatch):
    """A mesh whose preserved degrees cannot hold the saved state fails
    with the typed error naming both shapes, before the file is read;
    building its template does not raise."""
    opt = opt_for(ttrain)
    mesh_a = cpu_mesh(data=2, tensor=2)
    state = ttrain.init_train_state(TINY, opt, mesh=mesh_a)
    tckpt.save_checkpoint(str(tmp_path / "ckpt"), state, step=0)

    # tensor=8 cannot shard the tiny config's 2 kv heads (nor the other
    # tensor-sharded axes): the template is un-meshable.
    bad_mesh = cpu_mesh(tensor=8)
    template = tckpt.restore_template(state, bad_mesh)

    def no_read(*a, **k):
        raise AssertionError("the restore read the file")

    monkeypatch.setattr(tckpt.torch, "load", no_read)
    with pytest.raises(tckpt.MeshShapeMismatchError) as exc_info:
        tckpt.restore_checkpoint(str(tmp_path / "ckpt"), template)
    msg = str(exc_info.value)
    assert "cannot be restored onto mesh" in msg
    assert "'tensor': 8" in msg  # the mesh shape is named
    assert "shape (" in msg      # ...and the array shape
    assert "params/" in msg and "P(" in msg   # the leaf and its spec


def test_train_step_site_reaches_trainer():
    """The elastic trainer's step is injectable end to end: a schedule
    failing train.step surfaces from ElasticTrainer.step."""
    trainer = elastic.ElasticTrainer(
        TINY, opt_for(ttrain), ["tpu-0"], mesh_config=MeshConfig(),
        global_batch=8, device_of={"tpu-0": "cpu"})
    toks = torch.tensor(batches(1)[0])
    plan = faults.FaultPlan().fail(
        "train.step", faults.FaultError("chaos"), on_calls={2})
    with faults.armed(plan):
        trainer.step(toks)
        with pytest.raises(faults.FaultError):
            trainer.step(toks)
        trainer.step(toks)  # rule exhausted; training continues
    assert trainer.step_count == 2


def test_members_map_to_devices():
    """Claim device names map to their cards by default; members sharing
    one device keep their own identities in the coverage decision."""
    assert elastic.default_device("tpu-3") == torch.device("cuda", 3)
    assert elastic.default_device(2) == torch.device("cuda", 2)
    with pytest.raises(ValueError, match="device_of"):
        elastic.default_device("spare")
    trainer = elastic.ElasticTrainer(
        TINY, opt_for(ttrain), MEMBERS[:4],
        mesh_config=MeshConfig(data=2, tensor=2), global_batch=8,
        device_of=dict.fromkeys(MEMBERS[:4], "cpu"))
    assert trainer.devices == [CPU] * 4
    # tensor shard 1 lives on members 1 and 3: losing both loses it.
    for lost, want in (((3,), True), ((1, 3), False), ((0, 3), True)):
        alive = [m for i, m in enumerate(MEMBERS[:4]) if i not in lost]
        assert elastic.state_covered(trainer.state, alive,
                                     trainer.members) is want
    with pytest.raises(ValueError, match="members"):
        elastic.state_covered(trainer.state, MEMBERS[:2], MEMBERS[:2])
