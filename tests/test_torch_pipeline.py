"""The port's GPipe pipeline against the JAX package's, on the CPU: the
twins of ``tests/test_pipeline.py`` (staging, the affine schedule, a
single stage, the pipelined Llama forward at pipe 2 x data 2 x tensor 2
and its gradients) and of ``tests/test_moe.py``'s ``TestPipelinedMoe`` and
``test_refuses_pipeline_composition``, plus the hop count the card's K9
formula rests on.

The reference runs ``shard_map`` on conftest's 8 virtual CPU devices; the
port a host loop over meshes of CPU shards, each stage's hop through
K9's plain version. Tolerances, the reference tests' own: the forward at
2e-5, gradients at 5e-4, the MoE logits at 3e-4 and its aux within 20%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import llama as jllama
from k8s_dra_driver_tpu.models import moe as jmoe
from k8s_dra_driver_tpu.parallel import MeshConfig as JMeshConfig
from k8s_dra_driver_tpu.parallel import build_mesh as jbuild_mesh
from k8s_dra_driver_tpu.parallel.pipeline import pipeline as jpipeline
from k8s_dra_driver_tpu.parallel.pipeline import stage_params as jstage
from k8s_dra_driver_tpu.parallel.sharding import shard_pytree as jshard
from k8s_dra_driver_tpu_torch.models import llama, moe
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.models.train import leaves
from k8s_dra_driver_tpu_torch.parallel import MeshConfig, build_mesh
import k8s_dra_driver_tpu_torch.parallel.pipeline as pipeline_mod
from k8s_dra_driver_tpu_torch.parallel.pipeline import pipeline, stage_params

CPU = torch.device("cpu")
JTINY, TINY = jllama.PRESETS["tiny"], llama.PRESETS["tiny"]


def _cpu_mesh(**axes):
    mc = MeshConfig(**axes)
    return build_mesh(mc, devices=[CPU] * mc.num_devices)


def _jmesh(**axes):
    mc = JMeshConfig(**axes)
    return jbuild_mesh(mc, devices=jax.devices()[:mc.num_devices])


def _skip_if_partial_manual_unsupported(exc: Exception):
    """The reference test's own skip: old jaxlib CPU backends cannot lower
    collectives under a partial-manual shard_map."""
    if "PartitionId" in str(exc):
        pytest.skip("partial-manual shard_map unsupported on this jaxlib")
    raise exc


# ---------------------------------------------------------------------------
# TestSchedule
# ---------------------------------------------------------------------------


def test_stage_params_split():
    stack = {"w": torch.arange(24.0).reshape(6, 4)}
    staged = stage_params(stack, 3)
    assert staged["w"].shape == (3, 2, 4)
    assert torch.equal(staged["w"][1], stack["w"][2:4])
    want = jstage({"w": jnp.arange(24.0).reshape(6, 4)}, 3)
    np.testing.assert_array_equal(staged["w"].numpy(), np.asarray(want["w"]))
    with pytest.raises(AssertionError, match="do not split"):
        stage_params(stack, 4)


@pytest.mark.parametrize("with_aux", [False, True])
def test_affine_stages_compose_in_order(with_aux):
    # Stage p computes x * w[p] + 1: composition order must be stage
    # 0 -> 1 -> 2 -> 3 for every microbatch, as the reference's.
    w = np.array([2.0, 3.0, 5.0, 7.0], np.float32).reshape(4, 1)
    x = np.arange(8.0, dtype=np.float32).reshape(8, 1)
    want = np.asarray(jpipeline(
        lambda wp, xm: xm * wp[0] + 1.0, jnp.asarray(w)[:, None],
        jnp.asarray(x), mesh=_jmesh(pipe=4, data=2), n_microbatches=4))
    mesh = _cpu_mesh(pipe=4, data=2)
    tw = torch.tensor(w)[:, None]
    if with_aux:
        # A pytree rides the same schedule: a per-row channel beside x.
        out = pipeline(
            lambda wp, a: {"x": a["x"] * wp[0] + 1.0, "n": a["n"] + 1},
            tw, {"x": torch.tensor(x), "n": torch.zeros(8)}, mesh=mesh,
            n_microbatches=4)
        assert torch.equal(out["n"], torch.full((8,), 4.0))
        out = out["x"]
    else:
        out = pipeline(lambda wp, xm: xm * wp[0] + 1.0, tw, torch.tensor(x),
                       mesh=mesh, n_microbatches=4)
    expect = (((x * 2 + 1) * 3 + 1) * 5 + 1) * 7 + 1
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6)


def test_single_stage_is_identity_schedule():
    w = torch.tensor([[3.0]])
    x = torch.arange(8.0).reshape(8, 1)
    out = pipeline(lambda wp, xm: xm * wp[0], w[:, None], x,
                   mesh=_cpu_mesh(pipe=1, data=2), n_microbatches=2)
    np.testing.assert_allclose(out.numpy(), (x * 3).numpy(), rtol=1e-6)


@pytest.mark.parametrize("stages,micro", [(2, 2), (2, 4), (4, 4), (1, 3)])
def test_hops_per_forward_and_backward(monkeypatch, stages, micro):
    """M + P - 2 grouped hops a forward (none after the last step that
    carries an activation, none on one stage), each carrying every batch
    group's ring, and one inverse hop each in the backward."""
    calls = []
    real = pipeline_mod._rotate

    def counted(rings, shift=1):
        calls.append(len(rings))
        return real(rings, shift)
    monkeypatch.setattr(pipeline_mod, "_rotate", counted)
    from k8s_dra_driver_tpu_torch.parallel import ring

    inverse = []
    real_group = ring.ring_permute_group
    monkeypatch.setattr(ring, "ring_permute_group", lambda rings, shift=1: (
        inverse.append(shift), real_group(rings, shift))[1])
    w = torch.arange(1.0, stages + 1).reshape(stages, 1, 1)
    w.requires_grad_(True)
    x = torch.randn(2 * micro * 2, 3)
    out = pipeline(lambda wp, xm: xm * wp[0], w, x,
                   mesh=_cpu_mesh(pipe=stages, data=2), n_microbatches=micro)
    hops = micro + stages - 2 if stages > 1 else 0
    assert calls == [2] * hops       # two batch groups' rings a hop
    (g,) = torch.autograd.grad(out.sum(), w)
    assert inverse == [1] * hops + [-1] * hops
    np.testing.assert_allclose(
        g.flatten().numpy(),
        [(x.sum() * torch.prod(w.detach()) / w[p, 0, 0].detach()).item()
         for p in range(stages)], rtol=1e-5)


# ---------------------------------------------------------------------------
# TestPipelinedLlama
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jp = jllama.init_params(JTINY, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), TINY,
                                 device="cpu")


def test_pipelined_llama_matches_plain_forward(tiny):
    """pipe 2 x data 2 x tensor 2: each stage's layers through the mesh
    block on its sub-mesh (tensor composes with pipe), against the
    reference's pipelined forward and its plain forward."""
    jp, tp = tiny
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0,
                                           JTINY.vocab_size))
    ref = np.asarray(jllama.forward(jp, jnp.asarray(tokens), JTINY))
    jout = np.asarray(jllama.forward_pipelined(
        jp, jnp.asarray(tokens), JTINY, _jmesh(pipe=2, data=2, tensor=2),
        n_microbatches=2))
    out = llama.forward_pipelined(tp, torch.tensor(tokens), TINY,
                                  _cpu_mesh(pipe=2, data=2, tensor=2),
                                  n_microbatches=2)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), jout, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_llama_grads_match_plain(tiny, remat):
    """The twin of ``test_grads_match_plain`` (pipe 2, batch 4 x 33, two
    microbatches): the pipelined loss and every gradient leaf against the
    reference's plain loss, and at pipe 2 x data 2 x tensor 2 too; under
    remat each stage's layers recompute (not a reference option)."""
    jp, tp = tiny
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 33), 0,
                                           JTINY.vocab_size))

    def plain_loss(p):
        hidden = jllama.forward(p, jnp.asarray(tokens[:, :-1]), JTINY,
                                return_hidden=True)
        return jllama.chunked_cross_entropy(hidden, p["lm_head"],
                                            jnp.asarray(tokens[:, 1:]))

    lr, gr = jax.value_and_grad(plain_loss)(jp)
    want = [np.asarray(gr["embed"])] + [
        np.asarray(gr["layers"][k]) for k in tp["layers"]] + [
        np.asarray(gr["final_norm"]), np.asarray(gr["lm_head"])]
    for axes in (dict(pipe=2), dict(pipe=2, data=2, tensor=2)):
        params = {k: ({kk: vv.clone().requires_grad_(True)
                       for kk, vv in v.items()} if isinstance(v, dict)
                      else v.clone().requires_grad_(True))
                  for k, v in tp.items()}
        hidden = llama.forward_pipelined(
            params, torch.tensor(tokens[:, :-1]), TINY, _cpu_mesh(**axes),
            n_microbatches=2, return_hidden=True, remat=remat)
        loss = llama.chunked_cross_entropy(hidden, params["lm_head"],
                                           torch.tensor(tokens[:, 1:]))
        assert abs(loss.item() - float(lr)) < 1e-5
        grads = torch.autograd.grad(loss, leaves(params))
        for a, b in zip(grads, want):
            np.testing.assert_allclose(a.numpy(), b, atol=5e-4, rtol=5e-4)


# ---------------------------------------------------------------------------
# TestPipelinedMoe and the dropless refusal.
# ---------------------------------------------------------------------------


def test_pipelined_moe_composes_with_expert_and_data():
    """The twin of ``test_pp_composes_with_ep_tp_dp_in_one_step`` on data
    2 x expert 2 x pipe 2 (einsum): logits against the reference's
    unpipelined forward (3e-4) and, where this jaxlib runs it, its
    pipelined forward; aux within 20% of the unpipelined aux; one
    backward with every gradient finite and w_gateup's nonzero."""
    jcfg = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    tcfg = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    jp = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    t = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (4, 65), 0,
                                      jcfg.vocab_size))
    ref_logits, ref_aux = jmoe.forward(jp, jnp.asarray(t[:, :-1]), jcfg)
    axes = dict(data=2, expert=2, pipe=2)
    mesh = _cpu_mesh(**axes)
    params = {k: ({kk: vv.clone().requires_grad_(True)
                   for kk, vv in v.items()} if isinstance(v, dict)
                  else v.clone().requires_grad_(True))
              for k, v in tp.items()}
    logits, aux = moe.forward_pipelined(params, torch.tensor(t[:, :-1]),
                                        tcfg, mesh, n_microbatches=2)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), atol=3e-4, rtol=3e-4)
    assert abs(float(ref_aux) - aux.item()) < 0.2 * float(ref_aux)
    jmesh = _jmesh(**axes)
    try:
        jl, ja = jax.jit(lambda p: jmoe.forward_pipelined(
            p, jnp.asarray(t[:, :-1]), jcfg, jmesh, n_microbatches=2))(
                jshard(jp, jmesh, jmoe.param_specs(jcfg)))
    except Exception as e:  # jaxlib without partial-manual support
        _skip_if_partial_manual_unsupported(e)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl),
                               atol=3e-4, rtol=3e-4)
    assert abs(aux.item() - float(ja)) < 1e-5
    hidden, aux = moe.forward_pipelined(
        params, torch.tensor(t[:, :-1]), tcfg, mesh, n_microbatches=2,
        return_hidden=True)
    loss = (llama.chunked_cross_entropy(hidden, params["lm_head"],
                                        torch.tensor(t[:, 1:]))
            + tcfg.aux_coef * aux)
    assert torch.isfinite(loss)
    flat = leaves(params)
    grads = dict(zip([id(p) for p in flat],
                     torch.autograd.grad(loss, flat)))
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert grads[id(params["layers"]["w_gateup"])].abs().sum() > 0


def test_refuses_pipeline_composition():
    """Dropless on an expert axis inside the pipeline raises, as the
    reference's does; ``auto`` resolves to einsum there."""
    cfg = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"],
                              moe_impl="dropless")
    params = moe.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 64))
    mesh = _cpu_mesh(data=2, expert=2, pipe=2)
    with pytest.raises(ValueError, match="pipelined"):
        moe.forward_pipelined(params, toks, cfg, mesh, n_microbatches=2)
    assert moe.resolve_moe_impl(moe.MOE_PRESETS["tiny-moe"], 64,
                                in_pipeline=True) == "einsum"


# ---------------------------------------------------------------------------
# int8 weights through the pipeline: the stages view each QuantTensor's
# q and scale as [P, L / P, ...] alike.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", [dict(pipe=2), dict(pipe=2, tensor=2)])
def test_int8_pipelined_llama_matches_the_reference(tiny, axes):
    """``quantize_params`` of ``tiny`` through ``forward_pipelined`` (two
    microbatches) against the reference's pipelined forward of the same
    int8 tree on its mesh, logits [4, 16, 256] at the int8 pin (1e-4)."""
    from k8s_dra_driver_tpu.models import quant as jquant
    from k8s_dra_driver_tpu_torch.models import quant

    jp = jquant.quantize_params(tiny[0])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), TINY, device="cpu")
    assert isinstance(tp["layers"]["wqkv"], quant.QuantTensor)
    staged = stage_params(tp["layers"], 2)["wqkv"]
    assert staged.q.shape[:2] == staged.scale.shape[:2] == (2, 1)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                           JTINY.vocab_size))
    want = np.asarray(jllama.forward_pipelined(
        jp, jnp.asarray(tokens), JTINY, _jmesh(**axes), n_microbatches=2))
    got = llama.forward_pipelined(tp, torch.tensor(tokens), TINY,
                                  _cpu_mesh(**axes), n_microbatches=2)
    assert got.shape == want.shape == (4, 16, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_int8_pipelined_moe_matches_the_reference():
    """``moe.forward_pipelined`` on int8 ``tiny-moe`` (einsum) over pipe 2
    x expert 2 x tensor 2 against the reference's jitted pipelined forward
    of its int8 tree placed by ``quantize_specs`` on its mesh (its eager
    call refuses in ``shard_map``, its jitted one runs): logits at the
    int8 pin (1e-4) and the aux within 1e-5."""
    from k8s_dra_driver_tpu.models import quant as jquant
    from k8s_dra_driver_tpu_torch.models import quant

    jcfg = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    tcfg = dataclasses.replace(moe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    jp = jquant.quantize_params(jmoe.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    t = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                      jcfg.vocab_size))
    axes = dict(pipe=2, expert=2, tensor=2)
    jmesh = _jmesh(**axes)
    jl, ja = jax.jit(lambda p: jmoe.forward_pipelined(
        p, jnp.asarray(t), jcfg, jmesh, n_microbatches=2))(
            jshard(jp, jmesh, jquant.quantize_specs(jmoe.param_specs(jcfg))))
    logits, aux = moe.forward_pipelined(tp, torch.tensor(t), tcfg,
                                        _cpu_mesh(**axes), n_microbatches=2)
    assert isinstance(tp["lm_head"], quant.QuantTensor)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    assert abs(aux.item() - float(ja)) < 1e-5
