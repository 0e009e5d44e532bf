"""Expert-parallel MoE serving on a single-controller mesh against the JAX
package's: the twin of ``tests/test_moe.py::TestRingOverlapEP``, and of
``TestDroplessExpertParallel``'s data x expert composition.

The reference shards ``tiny-moe`` (f32) over a 4-shard ``expert`` mesh of
conftest's virtual CPU devices and runs its ``shard_map`` bodies; the port
shards the same weights (converted by ``params_from_numpy``) over a mesh
of 4 CPU shards (``build_mesh(..., devices=[cpu] * 4)``) and runs its
bodies over all shards at once. Tolerances, the reference's own: the ring
and psum forwards within atol/rtol 3e-5 of the reference's EP forward and
of single-device dropless (f32 sums in another order, the psum's and the
aux means' included), aux within 1e-5; the int8 stacks within 1e-4 (the
reference's int8 EP pin). The EP engine's greedy streams must equal the
reference's EP engine's (``DecodeEngine(mesh=...)``, which runs on the
CPU there) token for token.

Training (the twin of ``TestRingOverlapEP::test_loss_and_grads_match_psum``,
``slow`` there): the port's ``moe.loss_fn(..., mesh=)`` loss and every
gradient leaf, ring and psum, against one jitted reference gradient of
the ring, at the reference's pins (loss 1e-5, gradients atol 1e-4 / rtol
1e-3); three steps of ``make_train_step(mesh=)`` against the reference's
``make_train_step`` on its expert mesh and against the port's
single-device step (losses 1e-5, the first moments -- averages of the
gradients -- at the gradient pins, the parameters at
``test_torch_moe_train.py``'s 5e-4, since Adam moves an element by about
lr whatever its gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_dra_driver_tpu.models import llama as jllama
from k8s_dra_driver_tpu.models import moe as jmoe
from k8s_dra_driver_tpu.models import quant as jquant
from k8s_dra_driver_tpu.models import train as jtrain
from k8s_dra_driver_tpu.models.serving import DecodeEngine as JEngine
from k8s_dra_driver_tpu.parallel import MeshConfig as JMeshConfig
from k8s_dra_driver_tpu.parallel import build_mesh as jbuild_mesh
from k8s_dra_driver_tpu.parallel.sharding import shard_pytree as jshard
from k8s_dra_driver_tpu_torch.models import llama, moe, quant
from k8s_dra_driver_tpu_torch.models import train as ttrain
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine
from k8s_dra_driver_tpu_torch.parallel import (
    MeshConfig,
    Sharded,
    build_mesh,
    collectives,
    ring,
    shard_pytree,
)

JCFG = jmoe.MOE_PRESETS["tiny-moe"]
CFG = moe.MOE_PRESETS["tiny-moe"]
N_EP = 4
TOL = dict(atol=3e-5, rtol=3e-5)
CPU = torch.device("cpu")

MODES = ["ring", "psum", "auto_13_tokens", "int8_ring", "int8_psum",
         "einsum_on_mesh", "specs", "experts_do_not_divide", "data_axis",
         "binned_refused", "sharded_without_mesh", "engine"]


@pytest.fixture(scope="module")
def setup():
    jp = jmoe.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    jmesh = jbuild_mesh(JMeshConfig(expert=N_EP), devices=jax.devices()[:4])
    mesh = build_mesh(MeshConfig(expert=N_EP), devices=[CPU] * N_EP)
    return jp, tp, jmesh, mesh


def _tokens(b=2, s=64, seed=1) -> np.ndarray:
    return np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed), (b, s), 0, CFG.vocab_size))


def _cfgs(**kw):
    return (dataclasses.replace(JCFG, **kw), dataclasses.replace(CFG, **kw))


def _jforward(p, tokens, cfg, mesh=None):
    if mesh is None:
        out, aux = jmoe.forward(p, jnp.asarray(tokens), cfg)
    else:
        out, aux = jax.jit(
            lambda p_, t_: jmoe.forward(p_, t_, cfg, mesh=mesh)
        )(p, jnp.asarray(tokens))
    return np.asarray(out), float(aux)


def _tforward(p, tokens, cfg, mesh=None):
    out, aux = moe.forward(p, torch.tensor(tokens), cfg, mesh=mesh)
    return out.numpy(), float(aux)


def _ep_forward(setup, mode: str, tokens, quantized=False):
    """The port's EP forward against the reference's EP forward and the
    single-device dropless forward of both packages."""
    jp, tp, jmesh, mesh = setup
    jcfg, tcfg = _cfgs(moe_impl="dropless", ep_overlap=mode)
    jspecs, tspecs = jmoe.param_specs(jcfg), moe.param_specs(tcfg)
    if quantized:
        jp = jquant.quantize_params(jp)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                               device="cpu")
        jspecs, tspecs = jquant.quantize_specs(jspecs), \
            quant.quantize_specs(tspecs)
    sharded = shard_pytree(tp, mesh, tspecs)
    w = sharded["layers"]["w_gateup"]
    if quantized:
        assert isinstance(w, quant.QuantTensor)
        w = w.q
    assert isinstance(w, Sharded) and len(w.shards) == N_EP
    jref, jref_aux = _jforward(jshard(jp, jmesh, jspecs), tokens, jcfg,
                               jmesh)
    out, aux = _tforward(sharded, tokens, tcfg, mesh)
    single, single_aux = _tforward(
        tp, tokens, dataclasses.replace(tcfg, ep_overlap="auto"))
    tol = dict(atol=1e-4, rtol=1e-4) if quantized else TOL
    if not quantized:
        # Whole stacks on a mesh are cut per call, as a shard_map cuts an
        # unsharded input: the same numbers.
        np.testing.assert_array_equal(_tforward(tp, tokens, tcfg, mesh)[0],
                                      out)
    np.testing.assert_allclose(out, jref, **tol)
    np.testing.assert_allclose(out, single, **tol)
    assert abs(aux - jref_aux) < 1e-5 and abs(aux - single_aux) < 1e-5
    return out


def _engine_streams(eng) -> list:
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, CFG.vocab_size, size=n).tolist()
               for n in (5, 9, 13)]
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run()
    eng.assert_no_leaks()
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("mode", MODES)
def test_expert_parallel(setup, mode):
    jp, tp, jmesh, mesh = setup
    if mode in ("ring", "psum"):
        _ep_forward(setup, mode, _tokens())
    elif mode == "auto_13_tokens":
        # 13 tokens do not chunk over 4 shards: "auto" takes psum, "ring"
        # refuses.
        t = _tokens(b=1, s=13)
        _ep_forward(setup, "auto", t)
        _, tcfg = _cfgs(moe_impl="dropless", ep_overlap="ring")
        with pytest.raises(ValueError, match="ep_overlap='ring'"):
            moe.forward(tp, torch.tensor(t), tcfg, mesh=mesh)
    elif mode in ("int8_ring", "int8_psum"):
        _ep_forward(setup, mode.split("_")[1], _tokens(), quantized=True)
    elif mode == "einsum_on_mesh":
        # "auto" resolves to einsum on an expert mesh; each shard runs its
        # experts' rows of the dispatched tensor.
        jcfg, tcfg = _cfgs(capacity_factor=1.0)
        assert moe.resolve_moe_impl(tcfg, 128, expert_mesh=True) == "einsum"
        t = _tokens()
        sharded = shard_pytree(tp, mesh, moe.param_specs(tcfg))
        jref, jaux = _jforward(jshard(jp, jmesh, jmoe.param_specs(jcfg)), t,
                               jcfg, jmesh)
        out, aux = _tforward(sharded, t, tcfg, mesh)
        single, _ = _tforward(tp, t, dataclasses.replace(
            tcfg, moe_impl="einsum"))
        np.testing.assert_allclose(out, jref, **TOL)
        np.testing.assert_allclose(out, single, **TOL)
        assert abs(aux - jaux) < 1e-5
    elif mode == "specs":
        tspecs, jspecs = moe.param_specs(CFG), jmoe.param_specs(JCFG)
        for got, want in ((tspecs, jspecs),
                          (quant.quantize_specs(tspecs),
                           jquant.quantize_specs(jspecs))):
            flat_j = jax.tree_util.tree_leaves_with_path(
                want, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))
            flat_t = {jax.tree_util.keystr(path): tuple(spec) for path, spec
                      in _flatten(got)}
            assert len(flat_t) == len(flat_j) >= 10
            assert flat_t == {jax.tree_util.keystr(path): tuple(spec)
                              for path, spec in flat_j}
        # The spec tree must match the parameter tree: int8 weights take
        # quantize_specs.
        with pytest.raises(TypeError, match="quantize_specs"):
            shard_pytree(quant.quantize_params(tp), mesh, tspecs)
    elif mode == "experts_do_not_divide":
        mesh3 = build_mesh(MeshConfig(expert=3), devices=[CPU] * 3)
        _, tcfg = _cfgs(moe_impl="dropless")
        with pytest.raises(ValueError, match="does not divide"):
            moe.forward(tp, torch.tensor(_tokens()), tcfg, mesh=mesh3)
    elif mode == "data_axis":
        # data composed with expert: each data group runs its own EP body
        # (the ring, 64 tokens a group), against the reference's forward
        # on its data 2 x expert 2 mesh and the single device.
        mesh_dp = build_mesh(MeshConfig(data=2, expert=2), devices=[CPU] * 4)
        jmesh_dp = jbuild_mesh(JMeshConfig(data=2, expert=2),
                               devices=jax.devices()[:4])
        jcfg, tcfg = _cfgs(moe_impl="dropless")
        t = _tokens()
        sharded = shard_pytree(tp, mesh_dp, moe.param_specs(tcfg))
        assert len(sharded["layers"]["w_gateup"].shards) == 4
        jref, jaux = _jforward(jshard(jp, jmesh_dp, jmoe.param_specs(jcfg)),
                               t, jcfg, jmesh_dp)
        out, aux = _tforward(sharded, t, tcfg, mesh_dp)
        single, single_aux = _tforward(tp, t, tcfg)
        np.testing.assert_allclose(out, jref, **TOL)
        np.testing.assert_allclose(out, single, **TOL)
        assert abs(aux - jaux) < 1e-5 and abs(aux - single_aux) < 1e-5
        eng = DecodeEngine(sharded, tcfg, mesh=mesh_dp, device="cpu",
                           batch_slots=4, num_blocks=16, block_size=8,
                           max_seq_len=32, prefill_chunk=8)
        assert _engine_streams(eng) == _engine_streams(DecodeEngine(
            tp, tcfg, device="cpu", batch_slots=4, num_blocks=16,
            block_size=8, max_seq_len=32, prefill_chunk=8))
    elif mode == "binned_refused":
        _, tcfg = _cfgs(moe_impl="binned")
        with pytest.raises(ValueError, match="expert-sharded"):
            moe.forward(tp, torch.tensor(_tokens()), tcfg, mesh=mesh)
    elif mode == "sharded_without_mesh":
        sharded = shard_pytree(tp, mesh, moe.param_specs(CFG))
        # Views of the whole stack on one device: no copy, no new memory.
        w = tp["layers"]["w_gateup"]
        shards = sharded["layers"]["w_gateup"].shards
        assert all(s.untyped_storage().data_ptr()
                   == w.untyped_storage().data_ptr() for s in shards)
        assert sharded["layers"]["wqkv"] is tp["layers"]["wqkv"]
        assert torch.equal(sharded["layers"]["w_gateup"].gather(), w)
        with pytest.raises(ValueError, match="mesh"):
            moe.forward(sharded, torch.tensor(_tokens()), CFG)
    else:
        # The EP engine: 4 slots decode 4 tokens a step (ring), 4 lanes of
        # 8-token chunks prefill 32 (ring), against the reference's EP
        # engine on its virtual mesh.
        jcfg, tcfg = _cfgs(capacity_factor=8.0, moe_impl="dropless")
        kw = dict(batch_slots=4, num_blocks=16, block_size=8,
                  max_seq_len=32, prefill_chunk=8)
        ref = _engine_streams(JEngine(
            jshard(jp, jmesh, jmoe.param_specs(jcfg)), jcfg, mesh=jmesh,
            **kw))
        eng = DecodeEngine(shard_pytree(tp, mesh, moe.param_specs(tcfg)),
                           tcfg, mesh=mesh, device="cpu", **kw)
        assert eng.device == CPU and eng.mesh is mesh
        assert eng.moe_impl == {"decode_step": "dropless",
                                "prefill_chunk": "dropless"}
        assert _engine_streams(eng) == ref
        assert eng.compile_counts == {"decode_step": 1, "prefill_chunk": 1}


def _flatten(tree, path=()):
    """(key path, spec) pairs of the port's spec tree, keyed as jax's
    ``keystr`` renders the reference's."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (jax.tree_util.DictKey(k),))
    elif isinstance(tree, quant.QuantTensor):
        for name in ("q", "scale"):
            yield from _flatten(getattr(tree, name),
                                path + (jax.tree_util.GetAttrKey(name),))
    else:
        yield path, tree


GRAD_TOL = dict(atol=1e-4, rtol=1e-3)


def _leaves(tree, prefix=""):
    """{"layers/wqkv": tensor, ...}: a parameter dict's leaves by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def ring_grads(setup):
    """One jitted reference loss and gradient: dropless on the ring, its
    expert stacks sharded over the 4 virtual devices, the reference
    test's tokens."""
    jp, _, jmesh, _ = setup
    jcfg, _ = _cfgs(moe_impl="dropless", ep_overlap="ring")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (2, 65), 0,
                                         CFG.vocab_size))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmoe.loss_fn(p, jnp.asarray(toks), jcfg, mesh=jmesh)
    ))(jshard(jp, jmesh, jmoe.param_specs(jcfg)))
    return toks, float(loss), _leaves(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("mode", ["ring", "psum"])
def test_loss_and_grads_match_the_reference_ring(setup, ring_grads, mode):
    """The port's EP loss and every gradient leaf (autograd through the
    grouped K9 rotation and its inverse, and each shard's expert MLP on
    its expert window) against the reference's EP ring."""
    jp, _, _, mesh = setup
    toks, jloss, jgrads = ring_grads
    _, tcfg = _cfgs(moe_impl="dropless", ep_overlap=mode)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    flat = _leaves(tp)
    for p in flat.values():
        p.requires_grad_(True)
    # The shards are views made under autograd: the gradients reach the
    # whole stacks.
    loss = moe.loss_fn(shard_pytree(tp, mesh, moe.param_specs(tcfg)),
                       torch.from_numpy(toks), tcfg, mesh=mesh)
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert abs(loss.item() - jloss) < 1e-5
    assert sorted(flat) == sorted(jgrads)
    for name, g in zip(flat, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name], **GRAD_TOL,
                                   err_msg=name)


def test_ring_rotates_chunk_and_carrier_together_on_one_device(setup,
                                                               monkeypatch):
    """Each hop but the last rotates the carrier and the next chunk in one
    group, the last hop the carrier alone: n_ep groups a layer, not the
    reference's 2 n_ep - 1 rotations. The ledger keeps the reference's
    records, x then y a hop."""
    _, tp, _, mesh = setup
    _, tcfg = _cfgs(moe_impl="dropless", ep_overlap="ring")
    calls, sites = [], []
    group, emit = ring.ring_permute_group, collectives.emit
    monkeypatch.setattr(ring, "ring_permute_group",
                        lambda rings, shift=1: calls.append(len(rings))
                        or group(rings, shift))
    monkeypatch.setattr(collectives, "emit",
                        lambda site, *a, **kw: sites.append(site)
                        or emit(site, *a, **kw))
    with torch.no_grad():
        moe.forward(shard_pytree(tp, mesh, moe.param_specs(tcfg)),
                    torch.tensor(_tokens()), tcfg, mesh=mesh)
    layers = CFG.n_layers
    assert calls == ([2] * (N_EP - 1) + [1]) * layers
    hops = [s for s in sites if s in ("moe.ep_ring.x", "moe.ep_ring.y")]
    assert hops == (["moe.ep_ring.x", "moe.ep_ring.y"] * (N_EP - 1)
                    + ["moe.ep_ring.y"]) * layers


def _steps_against_reference(jcfg, tcfg, jmesh, mesh, toks, steps=3):
    """``steps`` AdamW steps of the port's ``make_train_step(mesh=)``
    against as many of the reference's ``make_train_step`` on its mesh and
    of the port's single-device step, all from the same parameters and
    tokens: losses, first moments and parameters at the train pins; the
    state updates in place. Returns the meshed run's losses."""
    jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
    jstate = jtrain.init_train_state(jcfg, jmesh, jopt, seed=0)
    np_params = jax.tree.map(np.asarray, jstate.params)
    jstep = jtrain.make_train_step(jcfg, jmesh, jopt)
    jlosses = []
    for _ in range(steps):
        jstate, loss = jstep(jstate, jnp.asarray(toks))
        jlosses.append(float(loss))
    assert int(jstate.step) == steps
    ref = dict(
        losses=jlosses,
        mu=_leaves(jax.tree.map(
            np.asarray, optax.tree_utils.tree_get(jstate.opt_state, "mu"))),
        params=_leaves(jax.tree.map(np.asarray, jstate.params)))
    runs = []
    for m in (mesh, None):
        opt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
        state = ttrain.train_state_from_params(
            params_from_numpy(np_params, tcfg, device="cpu"), opt, mesh=m)
        step = ttrain.make_train_step(tcfg, opt, device="cpu", mesh=m)
        losses = []
        for _ in range(steps):
            out, loss = step(state, torch.tensor(toks))
            assert out is state
            losses.append(loss.item())
        assert state.step == steps
        runs.append(dict(
            losses=losses,
            mu=_leaves(jax.tree.map(lambda t: t.detach().numpy(),
                                    state.opt_state.mu)),
            params=_leaves(jax.tree.map(lambda t: t.detach().numpy(),
                                        state.params))))
    meshed, single = runs
    for want in (ref, single):
        np.testing.assert_allclose(meshed["losses"], want["losses"],
                                   atol=1e-5, rtol=1e-5)
        for key, tol in (("mu", GRAD_TOL),
                         ("params", dict(atol=5e-4, rtol=1e-4))):
            assert sorted(meshed[key]) == sorted(want[key])
            for name, got in meshed[key].items():
                np.testing.assert_allclose(got, want[key][name], **tol,
                                           err_msg=f"{key} {name}")
    return meshed["losses"]


def test_make_train_step_on_a_mesh_matches_the_single_device_step(setup):
    """Three AdamW steps of ``make_train_step(mesh=)`` (4 CPU shards, the
    ring) against three of the reference's ``make_train_step`` on its
    4-device expert mesh, and against three of the port's single-device
    step, all from the same parameters and tokens."""
    _, _, jmesh, mesh = setup
    jcfg, tcfg = _cfgs(moe_impl="dropless", ep_overlap="ring")
    losses = _steps_against_reference(jcfg, tcfg, jmesh, mesh,
                                      _tokens(b=4, s=33, seed=2))
    assert losses[2] < losses[1]


@pytest.mark.parametrize("bad", ["use_ring", "data_axis_loss",
                                 "data_axis_step", "dense_step"])
def test_ep_training_refuses(setup, bad):
    """The cases ported since hold parity instead of raising: the EP
    loss with ``use_ring=True`` on the expert mesh (a ring of one hop)
    against the reference's on its mesh; the EP loss on data 2 x expert 2 against the
    reference's on its mesh and the single device's; three train steps
    there, and three of a dense model on an expert mesh (the axis shards
    nothing of it), against the reference's ``make_train_step`` on its
    mesh and the port's single-device step."""
    jp, tp, jmesh, mesh = setup
    jcfg, tcfg = _cfgs(moe_impl="dropless")
    toks = torch.tensor(_tokens(b=2, s=9))
    mesh_dp = build_mesh(MeshConfig(data=2, expert=2), devices=[CPU] * 4)
    jmesh_dp = jbuild_mesh(JMeshConfig(data=2, expert=2),
                           devices=jax.devices()[:4])
    if bad == "use_ring":
        jloss = float(jax.jit(lambda p, t: jmoe.loss_fn(
            p, t, jcfg, mesh=jmesh, use_ring=True))(
                jshard(jp, jmesh, jmoe.param_specs(jcfg)),
                jnp.asarray(toks.numpy())))
        loss = moe.loss_fn(tp, toks, tcfg, mesh=mesh, use_ring=True).item()
        assert abs(loss - jloss) < 1e-5
        assert abs(loss - moe.loss_fn(tp, toks, tcfg, mesh=mesh).item()) \
            < 1e-5
    elif bad == "data_axis_loss":
        jloss = float(jax.jit(lambda p, t: jmoe.loss_fn(
            p, t, jcfg, mesh=jmesh_dp))(
                jshard(jp, jmesh_dp, jmoe.param_specs(jcfg)),
                jnp.asarray(toks.numpy())))
        loss = moe.loss_fn(tp, toks, tcfg, mesh=mesh_dp).item()
        assert abs(loss - jloss) < 1e-5
        assert abs(loss - moe.loss_fn(tp, toks, tcfg).item()) < 1e-5
    elif bad == "data_axis_step":
        _steps_against_reference(jcfg, tcfg, jmesh_dp, mesh_dp, toks.numpy())
    else:
        _steps_against_reference(jllama.PRESETS["tiny"],
                                 llama.PRESETS["tiny"], jmesh, mesh,
                                 toks.numpy())
