"""Training on the data, fsdp and tensor axes of the port's single-controller
mesh against the JAX package's: the twins of
``tests/test_models.py::TestShardedTraining`` and of the reference's
``state_shardings`` / ``reshard_train_state``.

The reference jits its step over conftest's 8 virtual CPU devices; the
port runs ``make_train_step(..., mesh=)`` on 8 CPU shards from the same
parameters and tokens. Pins, the expert-parallel train test's
(``tests/test_torch_moe_ep.py``): losses 1e-5, the first moments
(averages of the gradients) atol 1e-4 / rtol 1e-3, the parameters 5e-4
(Adam moves an element by about lr whatever its gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_dra_driver_tpu.models import llama as jllama
from k8s_dra_driver_tpu.models import train as jtrain
from k8s_dra_driver_tpu.parallel import MeshConfig as JMeshConfig
from k8s_dra_driver_tpu.parallel import build_mesh as jbuild_mesh
from k8s_dra_driver_tpu.parallel import collectives as jcollectives
from k8s_dra_driver_tpu_torch.models import llama
from k8s_dra_driver_tpu_torch.models import train as ttrain
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.parallel import (
    MeshConfig,
    NamedSharding,
    Sharded,
    build_mesh,
    collectives,
    shard_pytree,
)

CPU = torch.device("cpu")
JTINY, TINY = jllama.PRESETS["tiny"], llama.PRESETS["tiny"]
AXES = dict(data=2, fsdp=2, tensor=2)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _cpu_mesh(**axes):
    mc = MeshConfig(**axes)
    return build_mesh(mc, devices=[CPU] * mc.num_devices)


def _jmesh(**axes):
    mc = JMeshConfig(**axes)
    return jbuild_mesh(mc, devices=jax.devices()[:mc.num_devices])


def _tokens(b=4, s=33, seed=0) -> np.ndarray:
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0,
                                         TINY.vocab_size))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _specs(tree):
    return {k: _specs(v) if isinstance(v, dict) else tuple(v.spec)
            for k, v in tree.items()}


@pytest.mark.parametrize("case", ["decreases_loss", "params_cut",
                                  "eval_step"])
def test_sharded_training(case):
    """The twins of ``TestShardedTraining``: the step decreases the loss
    and counts steps, the state is placed by ``param_specs`` (the fused
    wqkv's kv-head axis cut over tensor), the eval step runs."""
    mesh = _cpu_mesh(**AXES)
    if case == "decreases_loss":
        opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
        state = ttrain.init_train_state(TINY, opt, device="cpu", mesh=mesh)
        step = ttrain.make_train_step(TINY, opt, device="cpu", mesh=mesh)
        batch = torch.tensor(_tokens())
        losses = []
        for _ in range(5):
            state, loss = step(state, batch)
            losses.append(loss.item())
        assert losses[-1] < losses[0], losses
        assert state.step == 5
    elif case == "params_cut":
        state = ttrain.init_train_state(TINY, ttrain.make_optimizer(),
                                        device="cpu", mesh=mesh)
        placement = ttrain.state_shardings(state, mesh)
        wqkv_sh = placement.params["layers"]["wqkv"]
        assert isinstance(wqkv_sh, NamedSharding) and wqkv_sh.mesh is mesh
        assert _specs(placement.params) == {
            k: tuple(v) if not isinstance(v, dict)
            else {kk: tuple(vv) for kk, vv in v.items()}
            for k, v in llama.param_specs(TINY).items()}
        placed = shard_pytree(state.params, mesh, placement.params)
        wqkv = placed["layers"]["wqkv"]
        assert isinstance(wqkv, Sharded) and len(wqkv.shards) == 8
        assert wqkv.shards[0].shape[2] == wqkv.shape[2] // 2
    else:
        state = ttrain.init_train_state(TINY, ttrain.make_optimizer(),
                                        device="cpu", mesh=mesh)
        ev = ttrain.make_eval_step(TINY, device="cpu", mesh=mesh)
        loss = ev(state.params, torch.tensor(_tokens()))
        assert torch.isfinite(loss)
        np.testing.assert_allclose(
            loss.item(), ttrain.make_eval_step(TINY, device="cpu")(
                state.params, torch.tensor(_tokens())).item(),
            rtol=1e-5)


def test_train_steps_match_the_reference_on_its_mesh():
    """Three AdamW steps of the port's ``make_train_step(mesh=)`` on 8 CPU
    shards (data 2, fsdp 2, tensor 2) against three of the reference's
    jitted step on its 8-device mesh and three of the port's single-device
    step, from the same parameters and tokens; the state updates in
    place."""
    jmesh = _jmesh(**AXES)
    mesh = _cpu_mesh(**AXES)
    toks = _tokens(seed=2)
    jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
    jstate = jtrain.init_train_state(JTINY, jmesh, jopt, seed=0)
    np_params = jax.tree.map(np.asarray, jstate.params)
    jstep = jtrain.make_train_step(JTINY, jmesh, jopt)
    jlosses = []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(toks))
        jlosses.append(float(loss))
    ref = dict(
        losses=jlosses,
        mu=_leaves(jax.tree.map(
            np.asarray, optax.tree_utils.tree_get(jstate.opt_state, "mu"))),
        params=_leaves(jax.tree.map(np.asarray, jstate.params)))
    runs = []
    for m in (mesh, None):
        opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
        state = ttrain.train_state_from_params(
            params_from_numpy(np_params, TINY, device="cpu"), opt, mesh=m)
        step = ttrain.make_train_step(TINY, opt, device="cpu", mesh=m)
        losses = []
        for _ in range(3):
            out, loss = step(state, torch.tensor(toks))
            assert out is state
            losses.append(loss.item())
        runs.append(dict(
            losses=losses,
            mu=_leaves(jax.tree.map(lambda t: t.detach().numpy(),
                                    state.opt_state.mu)),
            params=_leaves(jax.tree.map(lambda t: t.detach().numpy(),
                                        state.params))))
    meshed, single = runs
    assert meshed["losses"][2] < meshed["losses"][1]
    for want in (ref, single):
        np.testing.assert_allclose(meshed["losses"], want["losses"],
                                   atol=1e-5, rtol=1e-5)
        for key, tol in (("mu", GRAD_TOL),
                         ("params", dict(atol=5e-4, rtol=1e-4))):
            assert sorted(meshed[key]) == sorted(want[key])
            for name, got in meshed[key].items():
                np.testing.assert_allclose(got, want[key][name], **tol,
                                           err_msg=f"{key} {name}")


def test_loss_and_grads_match_the_reference_on_its_mesh():
    """``llama.loss_fn(..., mesh=)`` and every gradient leaf against one
    jitted reference gradient on its (data 2, fsdp 2, tensor 2) mesh: the
    gradients of the views reach the whole leaves."""
    jmesh = _jmesh(**AXES)
    mesh = _cpu_mesh(**AXES)
    jp = jllama.init_params(JTINY, jax.random.PRNGKey(4))
    toks = _tokens(seed=5)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jnp.asarray(toks), JTINY, mesh=jmesh)
    ))(jp)
    jgrads = _leaves(jax.tree.map(np.asarray, jgrads))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), TINY, device="cpu")
    flat = _leaves(tp)
    for p in flat.values():
        p.requires_grad_(True)
    loss = llama.loss_fn(tp, torch.tensor(toks), TINY, mesh=mesh)
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert abs(loss.item() - float(jloss)) < 1e-5
    assert sorted(flat) == sorted(jgrads)
    for name, g in zip(flat, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name], **GRAD_TOL,
                                   err_msg=name)


def test_reshard_train_state_matches_the_reference():
    """``state_shardings`` / ``reshard_train_state`` from (data 2, fsdp 2,
    tensor 2) to (fsdp 4, tensor 2): values bit for bit, each leaf's
    placement the reference's (params by ``param_specs``, the moments and
    counts replicated), and the ``train.reshard`` ledger record equal to
    the reference's."""
    src, dst = dict(AXES), dict(fsdp=4, tensor=2)
    jopt = jtrain.make_optimizer()
    jstate = jtrain.init_train_state(JTINY, _jmesh(**src), jopt, seed=0)
    jled = jcollectives.CollectiveLedger()
    jled.install()
    try:
        jnew = jtrain.reshard_train_state(jstate, _jmesh(**dst))
    finally:
        jled.uninstall()
    jtarget = jtrain.state_shardings(jstate, _jmesh(**dst))

    opt = ttrain.make_optimizer()
    state = ttrain.train_state_from_params(
        params_from_numpy(jax.tree.map(np.asarray, jstate.params), TINY,
                          device="cpu"), opt, mesh=_cpu_mesh(**src))
    before = {k: v.detach().clone() for k, v in _leaves(state.params).items()}
    led = collectives.CollectiveLedger()
    led.install()
    try:
        new_mesh = _cpu_mesh(**dst)
        new = ttrain.reshard_train_state(state, new_mesh)
    finally:
        led.uninstall()
    assert led.snapshot() == jled.snapshot()
    for name, v in _leaves(new.params).items():
        assert torch.equal(v, before[name])
        np.testing.assert_array_equal(
            v.detach().numpy(), np.asarray(_leaves(jnew.params)[name]))
    target = ttrain.state_shardings(new, new_mesh)
    assert _specs(target.params) == jax.tree.map(
        lambda s: tuple(s.spec), jtarget.params)
    jmu = optax.tree_utils.tree_get(jtarget.opt_state, "mu")
    assert _specs(target.opt_state.mu) == jax.tree.map(
        lambda s: tuple(s.spec), jmu)
    assert tuple(target.step.spec) == tuple(jtarget.step.spec)
    placed = shard_pytree(new.params, new_mesh, target.params)
    assert placed["layers"]["wo"].shards[0].shape == (
        TINY.n_layers, TINY.n_heads * TINY.head_dim // 2, TINY.hidden // 4)


@pytest.mark.parametrize("impl", ["dropless", "einsum"])
def test_moe_loss_and_grads_on_a_tensor_mesh(impl):
    """``tiny-moe``'s loss and every gradient leaf on (data 2, tensor 2)
    against one jitted reference gradient on its (data 2, tensor 2) mesh
    (dropless: the primitive path per tensor shard, its grouped products'
    gradients through K10's autograd twin; einsum per tensor shard), and
    against the port's single device, at the expert-parallel train pins."""
    import dataclasses

    from k8s_dra_driver_tpu.models import moe as jmoe
    from k8s_dra_driver_tpu.parallel.sharding import shard_pytree as jshard
    from k8s_dra_driver_tpu_torch.models import moe

    kw = dict(moe_impl=impl, capacity_factor=8.0)
    jcfg = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"], **kw)
    cfg = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"], **kw)
    jmesh, mesh = _jmesh(data=2, tensor=2), _cpu_mesh(data=2, tensor=2)
    toks = _tokens(s=17, seed=7)
    jp = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmoe.loss_fn(p, jnp.asarray(toks), jcfg, mesh=jmesh)
    ))(jshard(jp, jmesh, jmoe.param_specs(jcfg)))
    ref = (float(jloss), _leaves(jax.tree.map(np.asarray, jgrads)))
    runs = []
    for m in (mesh, None):
        params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
        flat = _leaves(params)
        for p in flat.values():
            p.requires_grad_(True)
        loss = moe.loss_fn(params, torch.tensor(toks), cfg, mesh=m)
        runs.append((loss.item(), {k: g.numpy() for k, g in zip(
            flat, torch.autograd.grad(loss, list(flat.values())))}))
    (meshed, mgrads), single = runs
    for want_loss, want in (ref, single):
        assert abs(meshed - want_loss) < 1e-5
        assert sorted(mgrads) == sorted(want)
        for name, g in mgrads.items():
            np.testing.assert_allclose(g, want[name], **GRAD_TOL,
                                       err_msg=name)


def _moe_mesh_grads(jcfg, cfg, axes, toks, **kw):
    """The reference's jitted ``value_and_grad`` of ``moe.loss_fn`` on its
    mesh of ``axes`` (its weights placed by ``param_specs``) and the
    port's loss and gradient leaves on CPU shards of the same shape, from
    the same ``PRNGKey(0)`` weights."""
    from k8s_dra_driver_tpu.models import moe as jmoe
    from k8s_dra_driver_tpu.parallel.sharding import shard_pytree as jshard
    from k8s_dra_driver_tpu_torch.models import moe

    jmesh = _jmesh(**axes)
    jp = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmoe.loss_fn(p, jnp.asarray(toks), jcfg, mesh=jmesh, **kw)
    ))(jshard(jp, jmesh, jmoe.param_specs(jcfg)))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    flat = _leaves(params)
    for p in flat.values():
        p.requires_grad_(True)
    loss = moe.loss_fn(params, torch.tensor(toks), cfg, mesh=_cpu_mesh(**axes),
                       **kw)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    return (float(jloss), _leaves(jax.tree.map(np.asarray, jgrads)),
            loss.item(), grads, jp)


@pytest.mark.parametrize("impl", ["auto", "dropless"])
def test_moe_grad_step_on_data_expert_tensor(impl):
    """The twin of ``tests/test_moe.py::test_sharded_grad_step`` (data 2 x
    expert 2 x tensor 2, ``tiny-moe``, 2 x 65 tokens): the loss and every
    gradient leaf against the reference's on its mesh (it checks only
    finiteness), with ``auto`` (einsum on an expert mesh) and dropless
    (the EP ring, each expert shard's grouped products per tensor
    shard)."""
    import dataclasses

    from k8s_dra_driver_tpu.models import moe as jmoe
    from k8s_dra_driver_tpu_torch.models import moe

    jcfg = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"], moe_impl=impl)
    cfg = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"], moe_impl=impl)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 65), 0,
                                         cfg.vocab_size))
    jloss, jgrads, loss, grads, _ = _moe_mesh_grads(
        jcfg, cfg, dict(data=2, expert=2, tensor=2), toks)
    assert abs(loss - jloss) < 1e-5
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        assert g.shape == jgrads[name].shape
        np.testing.assert_allclose(g.numpy(), jgrads[name], **GRAD_TOL,
                                   err_msg=name)


def test_moe_combined_expert_sequence_tensor_mesh(monkeypatch):
    """The twin of ``test_combined_expert_sequence_tensor_mesh``: expert 2
    x sequence 2 x tensor 2 in one mesh, einsum, ring attention, remat:
    the loss within 5e-3 of the single device (the reference's gate) and
    within 1e-5 of the reference's on its mesh, and every gradient leaf
    against the reference's (it checks only finiteness). The reference's
    ring runs its flash form (its einsum form's dq and dk on the CPU are
    not plain attention's, ``tests/test_torch_ring_attention.py``)."""
    import dataclasses
    import functools

    from k8s_dra_driver_tpu.models import moe as jmoe
    from k8s_dra_driver_tpu.parallel import ring as jring
    from k8s_dra_driver_tpu_torch.models import moe

    monkeypatch.setattr(jllama, "ring_attention", functools.partial(
        jring.ring_attention, impl="flash"))
    jcfg = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    cfg = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"], moe_impl="einsum")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 65), 0,
                                         cfg.vocab_size))
    jloss, jgrads, loss, grads, jp = _moe_mesh_grads(
        jcfg, cfg, dict(expert=2, sequence=2, tensor=2), toks,
        use_ring=True, remat=True)
    single = float(jmoe.loss_fn(jp, jnp.asarray(toks), jcfg))
    assert abs(loss - single) < 5e-3
    assert abs(loss - jloss) < 1e-5
    assert sorted(grads) == sorted(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], **GRAD_TOL,
                                   err_msg=name)


def test_moe_train_steps_on_data_expert_tensor():
    """Three AdamW steps of ``make_train_step(mesh=)`` for ``tiny-moe``
    (dropless) on data 2 x expert 2 x tensor 2 against three of the
    single-device step from the same parameters: the losses, the first
    moments and the parameters at this file's pins; the state's placement
    is ``moe.param_specs`` on the mesh."""
    import dataclasses

    from k8s_dra_driver_tpu_torch.models import moe

    mesh = _cpu_mesh(data=2, expert=2, tensor=2)
    cfg = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"],
                              moe_impl="dropless")
    init = moe.init_params(cfg, seed=0, device="cpu")
    toks = torch.tensor(np.asarray(jax.random.randint(
        jax.random.PRNGKey(2), (4, 33), 0, cfg.vocab_size)))
    runs = []
    for m in (mesh, None):
        opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
        state = ttrain.train_state_from_params(
            jax.tree.map(lambda t: t.detach().clone(), init), opt, mesh=m)
        step = ttrain.make_train_step(cfg, opt, device="cpu", mesh=m)
        losses = [step(state, toks)[1].item() for _ in range(3)]
        runs.append((losses, _leaves(state.opt_state.mu),
                     _leaves(state.params), state.shardings))
    (losses, mu, params, shardings), (s_losses, s_mu, s_params, _) = runs
    assert losses[2] < losses[0]
    np.testing.assert_allclose(losses, s_losses, atol=1e-5, rtol=1e-5)
    for name in params:
        np.testing.assert_allclose(mu[name].numpy(), s_mu[name].numpy(),
                                   **GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(params[name].detach().numpy(),
                                   s_params[name].detach().numpy(),
                                   atol=5e-4, rtol=1e-4, err_msg=name)
    assert _specs(shardings) == {
        k: tuple(v) if not isinstance(v, dict)
        else {kk: tuple(vv) for kk, vv in v.items()}
        for k, v in moe.param_specs(cfg).items()}
    assert all(s.mesh is mesh for s in _leaves(shardings).values())
