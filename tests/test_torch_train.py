"""The port's training path against the JAX package's, on the CPU at the
``tiny`` preset (f32).

The JAX parameters are converted with ``params_from_numpy``, tokens are
made with numpy from a seed, and both packages run the same function: the
forward with remat off and full, the chunked cross-entropy, ``loss_fn``
with every gradient leaf, and three optimizer steps of ``make_train_step``
(the reference on a one-device mesh).

Tolerances, f32: forward atol 1e-5 (two layers, another summation
order); loss and gradients atol 1e-5 / rtol 1e-4; the train step's losses
atol 1e-5, and its parameters after three AdamW steps at lr 1e-2 atol
5e-4: Adam scales every element's update to about lr whatever the size of
its gradient, so an element whose gradient is near zero carries the f32
rounding of that gradient (a relative error far above 1e-4) into an
update of size lr.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from k8s_dra_driver_tpu.models import llama as jllama
from k8s_dra_driver_tpu.models import train as jtrain
from k8s_dra_driver_tpu.parallel import MeshConfig, build_mesh
from k8s_dra_driver_tpu_torch.models import llama as tllama
from k8s_dra_driver_tpu_torch.models import train as ttrain
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.ops import attention as tatt

JTINY, TINY = jllama.PRESETS["tiny"], tllama.PRESETS["tiny"]
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _tokens(b, s, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, TINY.vocab_size, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JTINY, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _port(params_np):
    return params_from_numpy(params_np, TINY, device="cpu")


def _flat(tree, prefix=""):
    """{"layers/wqkv": leaf, ...} of a parameter tree (either package)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "/"))
        else:
            out[name] = v
    return out


class TestForward:
    @pytest.mark.parametrize("remat", [False, True])
    def test_logits_and_hidden_match_jax(self, params, remat):
        jp, np_params = params
        toks = _tokens(2, 24)
        tp = _port(np_params)
        for hidden in (False, True):
            want = jllama.forward(jp, jnp.asarray(toks), JTINY, remat=remat,
                                  return_hidden=hidden)
            got = tllama.forward(tp, torch.from_numpy(toks), TINY,
                                 remat=remat, return_hidden=hidden)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), **FWD_TOL)

    def test_unknown_remat_policy_raises_and_none_is_plain(self, params):
        _, np_params = params
        tp = _port(np_params)
        toks = torch.from_numpy(_tokens(1, 8))
        with pytest.raises(ValueError, match="unknown remat_policy"):
            tllama.forward(tp, toks, TINY, remat=True, remat_policy="bogus")
        # "none" and remat=False both run the plain layer loop.
        a = tllama.forward(tp, toks, TINY, remat=True, remat_policy="none")
        b = tllama.forward(tp, toks, TINY, remat=False)
        assert torch.equal(a, b)

    def test_flops_per_token_matches_jax(self):
        for name in ("tiny", "8b-L8", "8b"):
            j, t = jllama.PRESETS[name], tllama.PRESETS[name]
            assert t.flops_per_token(2048) == j.flops_per_token(2048)
            assert t.flops_per_token() == j.flops_per_token()


POLICIES = ["none", *tllama.REMAT_POLICIES]


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


class TestRematPolicies:
    """Every remat policy against the reference's under the same policy
    (loss rtol 1e-5, leaves atol 1e-5 / rtol 1e-4), and what the backward
    recomputes per layer and step."""

    @pytest.mark.parametrize("policy", POLICIES)
    def test_loss_and_every_grad_leaf_match_jax(self, params, policy):
        jp, np_params = params
        toks = _tokens(2, 33, seed=1)
        jloss, jgrads = jax.value_and_grad(
            lambda p: jllama.loss_fn(p, jnp.asarray(toks), JTINY,
                                     remat=True, remat_policy=policy))(jp)
        tp = _port(np_params)
        for p in ttrain.leaves(tp):
            p.requires_grad_(True)
        flat = _flat(tp)
        loss = tllama.loss_fn(tp, torch.from_numpy(toks), TINY, remat=True,
                              remat_policy=policy)
        grads = torch.autograd.grad(loss, list(flat.values()))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        jflat = _flat(jax.tree.map(np.asarray, jgrads))
        assert sorted(jflat) == sorted(flat)
        for name, g in zip(flat, grads):
            np.testing.assert_allclose(g.numpy(), jflat[name], **GRAD_TOL,
                                       err_msg=f"{policy}: {name}")

    @pytest.mark.parametrize("policy", POLICIES)
    def test_backward_recomputes_only_the_unsaved_sites(self, params,
                                                        policy, monkeypatch):
        """Per layer and step: the attention core (the plain path's
        ``flash_fwd_reference``, K4 on the card) once under every policy
        that saves ``flash_out``, twice under "full"; the QKV product with
        rope once under ``flash_qkv``; the output projection once under
        ``attn_o``; the SwiGLU product once under ``mlp_prod``. The
        gradients equal remat "none"'s bit for bit."""
        _, np_params = params
        tp = _port(np_params)
        for p in ttrain.leaves(tp):
            p.requires_grad_(True)
        toks = torch.from_numpy(_tokens(2, 17, seed=4))
        core = []
        real = tatt.flash_fwd_reference
        monkeypatch.setattr(tatt, "flash_fwd_reference",
                            lambda *a: core.append(1) or real(*a))
        runs = {}
        for name in ("none", policy):
            core.clear()
            with SiteCounts() as mode:
                loss = tllama.loss_fn(tp, toks, TINY, remat=True,
                                      remat_policy=name)
                grads = torch.autograd.grad(loss, ttrain.leaves(tp))
            runs[name] = (len(core), mode.counts, grads)
        n, counts, grads = runs[policy]
        saved = {"none": None, "full": ()}.get(
            policy, tllama.REMAT_POLICIES.get(policy))
        layers = TINY.n_layers

        def want(site):
            return layers * (1 if saved is None or site in saved else 2)

        assert n == want("flash_out")
        assert counts["tpu_dra::flash_attention"] == want("flash_out")
        for site, op in (("flash_qkv", "project_qkv"), ("attn_o", "attn_proj"),
                         ("mlp_prod", "swiglu")):
            assert counts[f"tpu_dra::{op}"] == want(site), (site, counts)
        for a, b in zip(grads, runs["none"][2]):
            assert torch.equal(a, b)


class TestChunkedCrossEntropy:
    def test_value_and_lm_head_grad_match_jax_and_unchunked(self):
        rng = np.random.RandomState(3)
        b, s, h, v = 2, 24, 16, 40
        hidden = rng.randn(b, s, h).astype(np.float32)
        head = (rng.randn(h, v) / 4).astype(np.float32)
        targets = rng.randint(0, v, size=(b, s)).astype(np.int32)

        jval, jgrad = jax.value_and_grad(
            lambda w: jllama.chunked_cross_entropy(
                jnp.asarray(hidden), w, jnp.asarray(targets), chunk=8)
        )(jnp.asarray(head))

        def port(chunk):
            w = torch.from_numpy(head).requires_grad_()
            val = tllama.chunked_cross_entropy(
                torch.from_numpy(hidden), w, torch.from_numpy(targets),
                chunk=chunk)
            (grad,) = torch.autograd.grad(val, w)
            return val.item(), grad.numpy()

        val8, grad8 = port(8)
        np.testing.assert_allclose(val8, float(jval), **GRAD_TOL)
        np.testing.assert_allclose(grad8, np.asarray(jgrad), **GRAD_TOL)
        # 7 does not divide 24: the chunk shrinks to 6. One chunk of 24 is
        # the unchunked loss.
        for chunk in (7, 24):
            val, grad = port(chunk)
            np.testing.assert_allclose(val, val8, **GRAD_TOL)
            np.testing.assert_allclose(grad, grad8, **GRAD_TOL)
        logits = torch.from_numpy(hidden) @ torch.from_numpy(head)
        plain = torch.nn.functional.cross_entropy(
            logits.reshape(-1, v), torch.from_numpy(targets).long().reshape(-1))
        np.testing.assert_allclose(val8, plain.item(), **GRAD_TOL)


class TestLossFn:
    def test_value_and_every_grad_leaf_match_jax(self, params):
        jp, np_params = params
        toks = _tokens(2, 33, seed=1)
        jloss, jgrads = jax.value_and_grad(
            lambda p: jllama.loss_fn(p, jnp.asarray(toks), JTINY,
                                     remat=True))(jp)
        tp = _port(np_params)
        for p in ttrain.leaves(tp):
            p.requires_grad_(True)
        loss = tllama.loss_fn(tp, torch.from_numpy(toks), TINY, remat=True)
        flat = _flat(tp)
        grads = torch.autograd.grad(loss, list(flat.values()))
        np.testing.assert_allclose(loss.item(), float(jloss), **GRAD_TOL)
        want = _flat(jax.tree.map(np.asarray, jgrads))
        assert sorted(want) == sorted(flat)
        for name, g in zip(flat, grads):
            np.testing.assert_allclose(g.numpy(), want[name], **GRAD_TOL,
                                       err_msg=name)
        # The norms' gradients are live (not the zero a detached norm
        # output would leave).
        for name in ("layers/ln_attn", "layers/ln_mlp", "final_norm"):
            assert np.abs(want[name]).max() > 1e-4, name


class TestTrainStep:
    def test_three_steps_match_jax_make_train_step(self):
        mesh = build_mesh(MeshConfig(data=1, fsdp=1, sequence=1, tensor=1),
                          devices=jax.devices()[:1])
        jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=1,
                                     total_steps=100)
        jstate = jtrain.init_train_state(JTINY, mesh, jopt, seed=0)
        np_params = jax.tree.map(np.asarray, jstate.params)
        jstep = jtrain.make_train_step(JTINY, mesh, jopt)

        topt = ttrain.make_optimizer(lr=1e-2, warmup_steps=1,
                                     total_steps=100)
        tstate = ttrain.train_state_from_params(
            params_from_numpy(np_params, TINY, device="cpu"), topt)
        tstep = ttrain.make_train_step(TINY, topt, device="cpu")

        toks = _tokens(4, 33, seed=2)
        jl, tl = [], []
        for _ in range(3):
            jstate, loss = jstep(jstate, jnp.asarray(toks))
            jl.append(float(loss))
            out, loss = tstep(tstate, torch.from_numpy(toks))
            assert out is tstate                 # updated in place
            tl.append(loss.item())
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
        # warmup_steps=1: the first update runs at lr 0, so the first two
        # losses are equal; the third has moved.
        assert tl[0] == tl[1] and tl[2] < tl[1]
        assert tstate.step == 3 and int(jstate.step) == 3
        assert tstate.opt_state.count == 3
        want = _flat(jax.tree.map(np.asarray, jstate.params))
        got = _flat(tstate.params)
        assert sorted(want) == sorted(got)
        for name, p in got.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       atol=5e-4, rtol=1e-4, err_msg=name)

    def test_schedule_matches_optax(self):
        import optax

        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=3e-4, warmup_steps=10,
            decay_steps=100, end_value=3e-5)
        opt = ttrain.make_optimizer(lr=3e-4, warmup_steps=10,
                                    total_steps=100)
        for count in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            np.testing.assert_allclose(opt.schedule(count),
                                       float(sched(count)), rtol=1e-6)
        with pytest.raises(ValueError, match="warmup"):
            ttrain.make_optimizer(warmup_steps=10, total_steps=10)

    def test_trace_counts_one_key_per_shape_and_eval_step(self, params):
        _, np_params = params
        opt = ttrain.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=10)
        state = ttrain.train_state_from_params(_port(np_params), opt)
        step = ttrain.make_train_step(TINY, opt, device="cpu")
        seen = []
        ttrain.TRACE_COUNTS.clear()
        ttrain.TRACE_OBSERVERS.append(lambda *a: seen.append(a))
        try:
            for shape in ((2, 9), (2, 9), (1, 17), (2, 9)):
                step(state, torch.from_numpy(_tokens(*shape)))
        finally:
            ttrain.TRACE_OBSERVERS.clear()
        assert dict(ttrain.TRACE_COUNTS) == {"train_step:b2:s9": 1,
                                             "train_step:b1:s17": 1}
        assert seen == [("train_step", "", {"batch": 2, "seq": 9}),
                        ("train_step", "", {"batch": 1, "seq": 17})]
        assert state.step == 4
        toks = _tokens(2, 17, seed=4)
        loss = ttrain.make_eval_step(TINY, device="cpu")(
            state.params, torch.from_numpy(toks))
        assert not loss.requires_grad
        want = tllama.loss_fn(state.params, torch.from_numpy(toks), TINY,
                              remat=False)
        assert loss.item() == pytest.approx(want.item(), rel=1e-6)
