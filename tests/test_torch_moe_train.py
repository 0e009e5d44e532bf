"""The port's MoE training path (``models/moe.py`` ``forward``/``loss_fn``,
``models/train.py`` on an ``MoeConfig``) against the JAX package's, on the
CPU at the ``tiny-moe`` preset (f32) with ``capacity_factor=8.0`` and
``router_group=0``, as the reference's own gradient tests run it (nothing
overflows, so einsum and dropless compute the same function).

Parameters are the JAX package's, converted by ``params_from_numpy``;
tokens come from numpy seeds. Each implementation runs on both sides: the
einsum block, dropless through the fused pipeline (JAX: its Pallas kernels
in interpret mode and its custom VJP; the port: ``FusedMoeMlpFunction``
over the plain versions) and dropless through the primitive path (JAX:
``lax.ragged_dot``; the port: ``GroupedMatmulFunction`` over the plain
versions) and the binned block. Each implementation runs under every remat
policy on both sides, the reference under the same policy.

Tolerances, f32: the loss rtol 1e-5 and every gradient leaf atol 1e-5 /
rtol 1e-4 (the reference's own policy tolerance, one decade looser for
two packages); the train step's losses atol/rtol 1e-5 and its
parameters after three AdamW steps atol 5e-4 / rtol 1e-4 (as
``test_torch_train.py``: Adam scales an element's update to about lr
whatever the size of its gradient).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from k8s_dra_driver_tpu.models import moe as jmoe
from k8s_dra_driver_tpu.models import train as jtrain
from k8s_dra_driver_tpu.ops import moe_dispatch as jmd
from k8s_dra_driver_tpu.parallel import MeshConfig, build_mesh
from k8s_dra_driver_tpu_torch.models import moe
from k8s_dra_driver_tpu_torch.models import train as ttrain
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.models.llama import REMAT_POLICIES
from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md

JCFG = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"], capacity_factor=8.0,
                           router_group=0)
CFG = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"], capacity_factor=8.0,
                          router_group=0)
TOL = dict(atol=1e-5, rtol=1e-4)
IMPLS = {                         # name -> (moe_impl, dispatch impl)
    "einsum": ("einsum", "auto"),
    "binned": ("binned", "auto"),
    "dropless-fused": ("dropless", "fused"),
    "dropless-primitive": ("dropless", "primitive"),
}


def _tokens(b, s, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, CFG.vocab_size, size=(b, s)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "/"))
        else:
            out[name] = v
    return out


@pytest.fixture(scope="module")
def params():
    jp = jmoe.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _port(np_params):
    tp = params_from_numpy(np_params, CFG, device="cpu")
    for p in ttrain.leaves(tp):
        p.requires_grad_(True)
    return tp


class _Dispatch:
    """Both packages' dispatch impl for the block; "auto" again after."""

    def __init__(self, impl):
        self.impl = impl

    def __enter__(self):
        jmd.set_dispatch_impl(self.impl)
        md.set_dispatch_impl(self.impl)

    def __exit__(self, *exc):
        jmd.set_dispatch_impl("auto")
        md.set_dispatch_impl("auto")


POLICIES = ["none", "full", "flash", "flash_qkv", "flash_mlp", "flash_min",
            "flash_moe"]


def _jax_loss_and_grads(params, name, toks, remat):
    """The reference's loss and gradients under the same policy."""
    impl, dispatch = IMPLS[name]
    jp, _ = params
    cfg = dataclasses.replace(JCFG, moe_impl=impl)
    with _Dispatch(dispatch):
        loss, grads = jax.value_and_grad(
            lambda p: jmoe.loss_fn(p, jnp.asarray(toks), cfg,
                                   remat=remat != "none",
                                   remat_policy=remat))(jp)
    return float(loss), _flat(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("name", list(IMPLS))
def test_loss_and_every_grad_leaf_match_jax(params, name, remat):
    toks = _tokens(2, 33, seed=11)
    jloss, jgrads = _jax_loss_and_grads(params, name, toks, remat)
    impl, dispatch = IMPLS[name]
    cfg = dataclasses.replace(CFG, moe_impl=impl)
    tp = _port(params[1])
    flat = _flat(tp)
    with _Dispatch(dispatch):
        assert md.dispatch_impl_label(device="cpu") == (
            "fused" if dispatch == "fused" else "primitive")
        loss = moe.loss_fn(tp, torch.from_numpy(toks), cfg,
                           remat=remat != "none", remat_policy=remat)
        grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert sorted(jgrads) == sorted(flat)
    for leaf, g in zip(flat, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[leaf], **TOL,
                                   err_msg=leaf)
    # The router learns: through the gates and the aux loss.
    assert grads[list(flat).index("layers/wr")].abs().sum() > 0


def test_forward_returns_hidden_and_aux(params):
    """``return_hidden`` gives the final-normed hidden states; the logits
    are their projection; aux is the reference's layer mean."""
    jp, np_params = params
    toks = _tokens(1, 16, seed=12)
    tp = params_from_numpy(np_params, CFG, device="cpu")
    hidden, aux = moe.forward(tp, torch.from_numpy(toks), CFG,
                              return_hidden=True)
    jhidden, jaux = jmoe.forward(jp, jnp.asarray(toks), JCFG,
                                 return_hidden=True)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-5)
    logits, _ = moe.forward(tp, torch.from_numpy(toks), CFG)
    torch.testing.assert_close(logits, hidden @ tp["lm_head"])


def test_remat_full_runs_the_fused_forward_twice(params, monkeypatch):
    """Under remat "full" the fused pipeline's forward runs again in the
    backward (the checkpoint's recompute), once per layer, and the
    backward reads the recomputed activations: gradients equal remat
    "none". So does it under "flash_moe": ``moe_act`` is in no policy, so
    K7 and K8 run again, as the reference's recompute runs them."""
    calls = []
    real = md.moe_gateup
    monkeypatch.setattr(md, "moe_gateup",
                        lambda *a: calls.append(1) or real(*a))
    toks = torch.from_numpy(_tokens(1, 9, seed=13))
    cfg = dataclasses.replace(CFG, moe_impl="dropless")
    tp = _port(params[1])
    grads = {}
    with _Dispatch("fused"):
        for remat in ("none", "full", "flash_moe"):
            calls.clear()
            loss = moe.loss_fn(tp, toks, cfg, remat=remat != "none",
                               remat_policy=remat)
            assert len(calls) == CFG.n_layers
            grads[remat] = torch.autograd.grad(loss, ttrain.leaves(tp))
            assert len(calls) == CFG.n_layers * (1 if remat == "none" else 2)
    for remat in ("full", "flash_moe"):
        for a, b in zip(grads["none"], grads[remat]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


class SiteCounts(TorchDispatchMode):
    """How many times each op ran, the backward's recompute included: a
    site a policy saves is handed back from the cache in the recompute,
    without reaching this mode."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.name()] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["full", "flash", "flash_min",
                                   "flash_moe"])
@pytest.mark.parametrize("name", list(IMPLS))
def test_backward_recomputes_only_the_unsaved_sites(params, name, remat):
    """Per layer and step: the dispatch plan (dropless) or binned's slot
    scatter once under ``moe_routing``, the einsum and binned gate/up
    product once under ``moe_gu``, the attention core once under
    ``flash_out``; twice each under "full"."""
    impl, dispatch = IMPLS[name]
    cfg = dataclasses.replace(CFG, moe_impl=impl)
    tp = _port(params[1])
    toks = torch.from_numpy(_tokens(2, 17, seed=14))
    with _Dispatch(dispatch), SiteCounts() as mode:
        loss = moe.loss_fn(tp, toks, cfg, remat=True, remat_policy=remat)
        torch.autograd.grad(loss, ttrain.leaves(tp))
    saved = REMAT_POLICIES[remat] or ()
    layers = CFG.n_layers

    def want(site, runs):
        return layers * (1 if site in saved else 2) if runs else 0

    dropless, sorted_ = impl == "dropless", impl == "binned"
    counts = mode.counts
    assert counts["tpu_dra::moe_plan"] == want("moe_routing", dropless)
    assert counts["tpu_dra::binned_slots"] == want("moe_routing", sorted_)
    assert counts["tpu_dra::expert_gateup"] == want("moe_gu", not dropless)
    assert counts["tpu_dra::flash_attention"] == want("flash_out", True)


def test_three_train_steps_match_jax_make_train_step():
    mesh = build_mesh(MeshConfig(data=1, fsdp=1, sequence=1, tensor=1),
                      devices=jax.devices()[:1])
    jcfg = dataclasses.replace(JCFG, moe_impl="dropless")
    cfg = dataclasses.replace(CFG, moe_impl="dropless")
    jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
    jstate = jtrain.init_train_state(jcfg, mesh, jopt, seed=0)
    np_params = jax.tree.map(np.asarray, jstate.params)
    jstep = jtrain.make_train_step(jcfg, mesh, jopt)

    topt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1, total_steps=100)
    tstate = ttrain.train_state_from_params(
        params_from_numpy(np_params, cfg, device="cpu"), topt)
    tstep = ttrain.make_train_step(cfg, topt, device="cpu")

    toks = _tokens(4, 33, seed=2)
    jl, tl = [], []
    for _ in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(toks))
        jl.append(float(loss))
        out, loss = tstep(tstate, torch.from_numpy(toks))
        assert out is tstate
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    assert tl[0] == tl[1] and tl[2] < tl[1]
    assert tstate.step == 3 and int(jstate.step) == 3
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    got = _flat(tstate.params)
    assert sorted(want) == sorted(got)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   atol=5e-4, rtol=1e-4, err_msg=name)
    # The router and its moments stay f32 through AdamW.
    assert tstate.params["layers"]["wr"].dtype == torch.float32
    assert tstate.opt_state.mu["layers"]["wr"].dtype == torch.float32


def test_model_fns_pick_the_family_and_eval_step():
    from k8s_dra_driver_tpu_torch.models import llama

    assert ttrain._model_fns(CFG) == (moe.init_params, moe.loss_fn)
    assert ttrain._model_fns(llama.PRESETS["tiny"]) == (
        llama.init_params, llama.loss_fn)
    bf16 = dataclasses.replace(CFG, dtype=torch.bfloat16)
    opt = ttrain.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
    state = ttrain.init_train_state(bf16, opt, seed=0, device="cpu")
    assert state.params["layers"]["w_down"].dtype == torch.bfloat16
    assert state.opt_state.nu["layers"]["wr"].dtype == torch.float32
    toks = torch.from_numpy(_tokens(2, 17, seed=4))
    loss = ttrain.make_eval_step(CFG, device="cpu")(
        _port(jax.tree.map(np.asarray, jmoe.init_params(
            JCFG, jax.random.PRNGKey(1)))), toks)
    assert not loss.requires_grad and np.isfinite(loss.item())
