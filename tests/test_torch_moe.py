"""The port's MoE model (``models/moe.py``) and its serving path against
the JAX package's, on the CPU at the ``tiny-moe`` preset (f32) with
``capacity_factor=8.0`` as the reference's tests use (nothing overflows,
so cached decode equals the full forward).

Parameters are the JAX package's, converted by ``params_from_numpy``.
Routing is compared exactly (expert ids) on inputs whose top-2 margins
all exceed 1e-4, so an f32 rounding difference cannot flip a near-tie;
outputs to atol/rtol 1e-4 (2e-4 for incremental decode); greedy token
streams of the two engines must be EQUAL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from k8s_dra_driver_tpu.models import moe as jmoe
from k8s_dra_driver_tpu.models import quant as jquant
from k8s_dra_driver_tpu.models.serving import DecodeEngine as JEngine
from k8s_dra_driver_tpu.ops import moe_dispatch as jmd
from k8s_dra_driver_tpu_torch.models import moe
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.models.decode import (
    _forward_with_cache,
    decode_step,
    generate,
    prefill,
)
from k8s_dra_driver_tpu_torch.models.paged import PagedKVCache
from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine
from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md

JCFG = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"], capacity_factor=8.0)
CFG = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"], capacity_factor=8.0)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jmoe.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                 device="cpu")


def _layer(params, i=0):
    jp, tp = params
    return (jax.tree.map(lambda a: a[i], jp["layers"]),
            {k: w[i] for k, w in tp["layers"].items()})


def _top2_margin(probs: np.ndarray) -> float:
    """Smallest gap, over tokens, between the 1st and 2nd and between the
    2nd and 3rd router probabilities."""
    p = -np.sort(-probs, axis=-1)
    return float(min((p[..., 0] - p[..., 1]).min(),
                     (p[..., 1] - p[..., 2]).min()))


def test_presets_and_counts_match():
    assert set(moe.MOE_PRESETS) == set(jmoe.MOE_PRESETS)
    for name, c in moe.MOE_PRESETS.items():
        j = jmoe.MOE_PRESETS[name]
        for f in ("vocab_size", "hidden", "n_layers", "n_heads",
                  "n_kv_heads", "mlp_hidden", "max_seq_len", "rope_theta",
                  "norm_eps", "n_experts", "top_k", "capacity_factor",
                  "router_group", "moe_impl", "aux_coef"):
            assert getattr(c, f) == getattr(j, f), (name, f)
        assert c.num_params() == j.num_params()
        assert c.flops_per_token(2048) == j.flops_per_token(2048)
    assert isinstance(CFG, moe.MoeConfig)


def test_resolve_moe_impl_table_equal():
    for impl in ("auto", "einsum", "binned", "dropless"):
        for h, m in ((64, 128), (768, 2048), (4096, 14336), (4096, 4096)):
            c = dataclasses.replace(CFG, moe_impl=impl, hidden=h,
                                    mlp_hidden=m)
            j = dataclasses.replace(JCFG, moe_impl=impl, hidden=h,
                                    mlp_hidden=m)
            for tokens in (1, 8, 128, 512, 513, 4096):
                for mesh in (False, True):
                    for pipe in (False, True):
                        assert moe.resolve_moe_impl(
                            c, tokens, expert_mesh=mesh, in_pipeline=pipe,
                        ) == jmoe.resolve_moe_impl(
                            j, tokens, expert_mesh=mesh, in_pipeline=pipe,
                        ), (impl, h, m, tokens, mesh, pipe)
    assert moe.resolve_moe_impl(moe.MOE_PRESETS["8x7b"], 8) == "dropless"
    assert moe.resolve_moe_impl(moe.MOE_PRESETS["8x7b"], 513) == "einsum"


def test_route_topk_and_route_equal(params):
    """Seed 5 gives top-2 margins above 1e-4 for every token (asserted),
    so expert ids must match exactly."""
    rng = np.random.RandomState(5)
    xf = rng.randn(16, CFG.hidden).astype(np.float32)
    wr = (rng.randn(CFG.hidden, CFG.n_experts) * 0.5).astype(np.float32)
    jg, je, jprobs, jaux = jmoe._route_topk(jnp.asarray(xf),
                                            jnp.asarray(wr), JCFG)
    assert _top2_margin(np.asarray(jprobs)) > 1e-4
    tg, te, tprobs, taux = moe._route_topk(torch.from_numpy(xf),
                                           torch.from_numpy(wr), CFG)
    assert te.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    # Capacity routing over [B=2, S=8] with a tight capacity (drops).
    probs = np.array(jprobs).reshape(2, 8, CFG.n_experts)
    jd, jc, _ = jmoe._route(jnp.asarray(probs), JCFG, 3)
    td, tc, _ = moe._route(torch.from_numpy(probs), CFG, 3)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    assert 0 < td.sum() < 2 * 8 * CFG.top_k       # some pairs dropped
    for seq in (7, 12, 128, 256):
        assert moe.effective_router_group(CFG, seq) == \
            jmoe.effective_router_group(JCFG, seq)
        assert moe._capacity(CFG, seq) == jmoe._capacity(JCFG, seq)


@pytest.mark.parametrize("impl,dispatch", [
    ("dropless", "primitive"),
    ("dropless", "fused"),       # JAX: Pallas interpret; port: K7/K8 plain
    ("einsum", "auto"),
    ("binned", "auto"),
])
def test_moe_block_matches_jax(params, impl, dispatch):
    jl, tl = _layer(params)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, CFG.hidden).astype(np.float32)
    c = dataclasses.replace(CFG, moe_impl=impl)
    j = dataclasses.replace(JCFG, moe_impl=impl)
    try:
        jmd.set_dispatch_impl(dispatch)
        md.set_dispatch_impl(dispatch)
        jy, jaux = jmoe._moe_block(jnp.asarray(x), jl, j, None)
        ty, taux = moe._moe_block(torch.from_numpy(x), tl, c)
    finally:
        jmd.set_dispatch_impl("auto")
        md.set_dispatch_impl("auto")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


def test_forward_matches_jax(params):
    jp, tp = params
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)
    jl, jaux = jmoe.forward(jp, jnp.asarray(tokens), JCFG)
    tl, taux = moe.forward(tp, torch.from_numpy(tokens), CFG)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


class TestMoeDecode:
    """The reference's TestMoeDecode, with the port's cached path held
    against the JAX package's full MoE forward."""

    def _prompt(self):
        rng = np.random.RandomState(1)
        return rng.randint(0, CFG.vocab_size, size=(2, 12)).astype(np.int32)

    def test_prefill_matches_forward(self, params):
        jp, tp = params
        prompt = self._prompt()
        full, _ = jmoe.forward(jp, jnp.asarray(prompt), JCFG)
        last, _ = prefill(tp, prompt, CFG, max_len=32)
        np.testing.assert_allclose(last.numpy(), np.asarray(full)[:, -1],
                                   **TOL)

    def test_decode_matches_forward_incrementally(self, params):
        jp, tp = params
        seq = self._prompt()
        last, cache = prefill(tp, seq, CFG, max_len=32)
        for _ in range(3):
            tok = last.argmax(-1).to(torch.int32)
            seq = np.concatenate([seq, tok.numpy()[:, None]], axis=1)
            full, _ = jmoe.forward(jp, jnp.asarray(seq), JCFG)
            last, cache = decode_step(tp, tok, cache, CFG)
            np.testing.assert_allclose(last.numpy(), np.asarray(full)[:, -1],
                                       atol=2e-4, rtol=2e-4)

    def test_use_kernels_false_is_the_same_function_on_cpu(self, params):
        _, tp = params
        out = {}
        for flag in (True, False):
            cache = PagedKVCache.init(CFG, 2, 24, block_size=8, device="cpu")
            tokens = torch.arange(12, dtype=torch.int32).reshape(2, 6)
            out[flag], _ = _forward_with_cache(tp, tokens, cache, CFG,
                                               torch.arange(6),
                                               use_kernels=flag)
        torch.testing.assert_close(out[True], out[False], atol=0, rtol=0)


def test_engine_streams_equal_the_jax_engine(params):
    """The reference's TestMoeServing: a sparse target under continuous
    batching, token-exact against the JAX engine and solo generate."""
    jp, tp = params
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, CFG.vocab_size, size=n).tolist()
               for n in (5, 9, 13)]
    kw = dict(batch_slots=2, num_blocks=16, block_size=8, max_seq_len=32,
              prefill_chunk=8)
    streams = []
    for eng in (JEngine(jp, JCFG, **kw), DecodeEngine(tp, CFG, device="cpu",
                                                      **kw)):
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        assert eng.compile_counts == {"decode_step": 1, "prefill_chunk": 1}
        assert eng.moe_impl == {"decode_step": "dropless",
                                "prefill_chunk": "dropless"}
        streams.append([r.tokens for r in reqs])
    assert streams[1] == streams[0]
    for toks, p in zip(streams[1], prompts):
        assert toks == generate(tp, [p], CFG, 4, device="cpu")[0].tolist()


def test_engine_pins_prefill_impl_per_lane(params):
    """With 8x7b-sized experts, 8 lanes of 128 tokens (1024 packed) stay
    dropless: the prefill program resolves at the per-lane chunk, as the
    reference's does. Only the constructor runs (no step)."""
    _, tp = params
    big = dataclasses.replace(CFG, hidden=4096, mlp_hidden=14336)
    for chunk, want in ((128, "dropless"), (1024, "einsum")):
        eng = DecodeEngine(tp, big, batch_slots=8, num_blocks=4,
                           block_size=8, prefill_chunk=chunk,
                           prefill_batch=8, device="cpu")
        assert eng.moe_impl == {"decode_step": "dropless",
                                "prefill_chunk": want}
        assert eng._prefill_config.moe_impl == want
        assert eng.config.moe_impl == "auto"


def test_params_keep_the_router_f32(params):
    jp, _ = params
    bf16 = dataclasses.replace(CFG, dtype=torch.bfloat16)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), bf16, device="cpu")
    assert tp["layers"]["wr"].dtype == torch.float32
    assert tp["layers"]["w_gateup"].dtype == torch.bfloat16
    assert tp["layers"]["w_gateup"].shape == (2, 4, 64, 2, 128)
    np.testing.assert_array_equal(tp["layers"]["wr"].numpy(),
                                  np.asarray(jp["layers"]["wr"]))
    own = moe.init_params(bf16, seed=0, device="cpu")
    assert own["layers"]["wr"].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in own["layers"].items()} == {
        k: tuple(v.shape) for k, v in jp["layers"].items()}


def test_first_use_counter_and_unported_paths(params):
    _, tp = params
    _, tl = _layer(params)
    seen = []
    moe.TRACE_OBSERVERS.append(lambda *a: seen.append(a))
    try:
        x = torch.zeros(1, 5, CFG.hidden)
        for _ in range(2):
            moe._moe_block(x, tl, CFG)
    finally:
        moe.TRACE_OBSERVERS.pop()
    assert moe.MOE_TRACE_COUNTS["dropless:primitive:t5"] == 1
    assert seen in ([], [("moe_block", "dropless:primitive",
                          {"tokens": 5})])
    moe._moe_block(x, tl, dataclasses.replace(CFG, moe_impl="binned"))
    assert moe.MOE_TRACE_COUNTS["binned:primitive:t5"] == 1
    # MoE training is ported: the loss is finite (parity in
    # tests/test_torch_moe_train.py).
    loss = moe.loss_fn(tp, torch.zeros(1, 4, dtype=torch.int32), CFG)
    assert loss.dim() == 0 and torch.isfinite(loss)
    # param_specs is ported (expert parallelism, tests/test_torch_moe_ep.py)
    # and so is the pipelined forward (parity in
    # tests/test_torch_pipeline.py): on pipe 2 it runs, einsum inside.
    assert moe.param_specs(CFG)["layers"]["w_down"] == (
        None, "expert", "tensor", "fsdp")
    from k8s_dra_driver_tpu_torch.parallel import MeshConfig, build_mesh

    pipe = build_mesh(MeshConfig(pipe=2), devices=[torch.device("cpu")] * 2)
    toks = torch.randint(0, CFG.vocab_size, (2, 4))
    logits, aux = moe.forward_pipelined(tp, toks, CFG, pipe,
                                        n_microbatches=2)
    assert logits.shape == (2, 4, CFG.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


class TestBinned:
    """``moe_impl="binned"``: the reference's ``_moe_block_binned`` when
    tokens drop (forward and gradients), the reference's own binned ==
    einsum checks on the port, and int8 experts through ``int8_matmul``."""

    TIGHT = dict(capacity_factor=0.25)

    @pytest.mark.parametrize("group", [0, 16])
    def test_block_and_grads_match_reference_binned_with_drops(self, params,
                                                               group):
        jl, tl = _layer(params)
        c = dataclasses.replace(CFG, moe_impl="binned", router_group=group,
                                **self.TIGHT)
        j = dataclasses.replace(JCFG, moe_impl="binned", router_group=group,
                                **self.TIGHT)
        rng = np.random.RandomState(9)
        x = rng.randn(2, 32, CFG.hidden).astype(np.float32)
        dy = rng.randn(*x.shape).astype(np.float32)
        names = ("ln_mlp", "wr", "w_gateup", "w_down")

        def jblock(x_, *ws):
            return jmoe._moe_block_binned(x_, {**jl, **dict(zip(names, ws))},
                                          j)

        (jy, jaux), vjp = jax.vjp(jblock, jnp.asarray(x),
                                  *[jl[n] for n in names])
        jgrads = vjp((jnp.asarray(dy), jnp.zeros(())))
        leaves = [torch.from_numpy(x).requires_grad_()] + [
            tl[n].clone().requires_grad_() for n in names]
        ty, taux = moe._moe_block_binned(
            leaves[0], {**tl, **dict(zip(names, leaves[1:]))}, c)
        grads = torch.autograd.grad(ty, leaves, torch.from_numpy(dy))
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
        for name, a, b_ in zip(("x",) + names, grads, jgrads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-5,
                                       rtol=1e-4, err_msg=name)
        # The capacity is tight enough that pairs drop.
        g = moe.effective_router_group(c, 32)
        xn = moe.rmsnorm(torch.from_numpy(x), tl["ln_mlp"], c.norm_eps)
        probs = torch.softmax(xn.reshape(-1, g, CFG.hidden) @ tl["wr"], -1)
        dispatch, _, _ = moe._route(probs, c, moe._capacity(c, g))
        assert dispatch.sum() < 2 * 32 * c.top_k

    @pytest.mark.parametrize("group", [0, 16])
    def test_matches_einsum_exactly_with_drops(self, params, group):
        """The reference's ``test_binned_matches_einsum_exactly_with_drops``
        on the port: the same routing, drops and gates."""
        _, tp = params
        einsum = dataclasses.replace(CFG, moe_impl="einsum",
                                     router_group=group, **self.TIGHT)
        binned = dataclasses.replace(einsum, moe_impl="binned")
        toks = torch.from_numpy(np.random.RandomState(10).randint(
            0, CFG.vocab_size, size=(2, 32)).astype(np.int32))
        o1, aux1 = moe.forward(tp, toks, einsum)
        o2, aux2 = moe.forward(tp, toks, binned)
        np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=3e-5,
                                   rtol=3e-5)
        assert aux1.item() == aux2.item()

    @pytest.mark.parametrize("impl", ["binned", "dropless"])
    def test_grads_match_einsum_when_nothing_drops(self, params, impl):
        """The reference's check of the sorted paths' gradients (custom
        gathers, the inverse maps) against autograd of einsum at ample
        capacity."""
        _, tp = params
        einsum = dataclasses.replace(CFG, moe_impl="einsum",
                                     capacity_factor=8.0, router_group=0)
        other = dataclasses.replace(einsum, moe_impl=impl)
        toks = torch.from_numpy(np.random.RandomState(11).randint(
            0, CFG.vocab_size, size=(2, 17)).astype(np.int32))
        grads = []
        for c in (einsum, other):
            leaves = {k: w.clone().requires_grad_()
                      for k, w in tp["layers"].items()}
            loss = moe.loss_fn({**tp, "layers": leaves}, toks, c,
                               remat=False)
            grads.append(torch.autograd.grad(loss, list(leaves.values())))
        for name, a, b_ in zip(tp["layers"], *grads):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=3e-5,
                                       rtol=3e-4, err_msg=name)

    def test_int8_experts_run_int8_matmul_and_make_no_float_copy(
            self, monkeypatch):
        """int8 expert stacks (``quantize_params``) go through
        ``int8_matmul``'s prologue mode, one call per product, and
        nothing outside it converts an int8 tensor to a float one; the
        block matches the reference's binned on the same int8 weights
        (its ``q_dequant`` form)."""
        jcfg = dataclasses.replace(JCFG, moe_impl="binned", **self.TIGHT)
        tcfg = dataclasses.replace(CFG, moe_impl="binned", **self.TIGHT)
        jq = jquant.quantize_params(jmoe.init_params(jcfg,
                                                     jax.random.PRNGKey(1)))
        tq = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg,
                               device="cpu")
        jlayer = jax.tree.map(lambda a: a[0], jq["layers"])
        tlayer = {k: w[0] for k, w in tq["layers"].items()}
        x = np.random.RandomState(12).randn(2, 16, CFG.hidden).astype(
            np.float32)
        calls, inside = [], []
        real = moe.int8_matmul

        def counted(*args, prologue=False):
            calls.append(prologue)
            inside.append(1)
            try:
                return real(*args, prologue=prologue)
            finally:
                inside.pop()

        class Casts(TorchDispatchMode):
            found = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if (not inside and isinstance(out, torch.Tensor)
                        and out.is_floating_point() and args
                        and isinstance(args[0], torch.Tensor)
                        and args[0].dtype == torch.int8):
                    self.found.append(func.name())
                return out

        monkeypatch.setattr(moe, "int8_matmul", counted)
        with Casts():
            ty, _ = moe._moe_block(torch.from_numpy(x), tlayer, tcfg)
        assert calls == [True, True]
        assert Casts.found == []
        jy, _ = jmoe._moe_block(jnp.asarray(x), jlayer, jcfg, None)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
