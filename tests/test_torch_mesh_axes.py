"""The data, fsdp and tensor axes of the port's single-controller mesh
against the JAX package's GSPMD placements, on the CPU.

The reference places ``tiny`` / ``tiny-moe`` (f32) on meshes of conftest's
8 virtual CPU devices and lets XLA insert the collectives; the port places
the same weights (``params_from_numpy``) on meshes of CPU shards
(``build_mesh(..., devices=[cpu] * n)``) and runs its explicit Megatron
split (``parallel/layout.py``). Tolerances, the reference's own: the
sharded decode pins of ``tests/test_decode_sharded.py`` (2e-4, f32), the
expert-parallel pins of ``tests/test_moe.py`` (3e-5; 1e-4 for int8
experts, aux 1e-5). The mesh's own pieces (shards, specs, collectives,
``mesh_from_env``, the refusals) are held to the reference's values where
it has them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from k8s_dra_driver_tpu.models import decode as jdecode
from k8s_dra_driver_tpu.models import llama as jllama
from k8s_dra_driver_tpu.models import moe as jmoe
from k8s_dra_driver_tpu.models import quant as jquant
from k8s_dra_driver_tpu.ops import moe_dispatch as jmd
from k8s_dra_driver_tpu.parallel import MeshConfig as JMeshConfig
from k8s_dra_driver_tpu.parallel import build_mesh as jbuild_mesh
from k8s_dra_driver_tpu.parallel import mesh as jmesh_mod
from k8s_dra_driver_tpu.parallel import sharding as jsharding
from k8s_dra_driver_tpu_torch.models import decode, llama, moe, quant
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.models.paged import cache_specs
from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine
from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md
from k8s_dra_driver_tpu_torch.parallel import (
    MeshConfig,
    NamedSharding,
    P,
    Sharded,
    batch_sharding,
    build_mesh,
    collectives,
    host_mesh_shape,
    mesh_from_env,
    named_sharding,
    shard_pytree,
)

CPU = torch.device("cpu")
JTINY, TINY = jllama.PRESETS["tiny"], llama.PRESETS["tiny"]
JMOE, TMOE = jmoe.MOE_PRESETS["tiny-moe"], moe.MOE_PRESETS["tiny-moe"]
BATCH, PROMPT, MAX_LEN = 4, 8, 16
TOL = dict(atol=3e-5, rtol=3e-5)


def _cpu_mesh(**axes):
    mc = MeshConfig(**axes)
    return build_mesh(mc, devices=[CPU] * mc.num_devices)


def _jmesh(**axes):
    mc = JMeshConfig(**axes)
    return jbuild_mesh(mc, devices=jax.devices()[:mc.num_devices])


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# The mesh, its specs and its collectives.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    "grid", "tuple_entry", "replicated", "gather", "named", "collectives",
    "coords", "env", "refusals", "kv_heads"])
def test_mesh_pieces(case, monkeypatch):
    mesh = _cpu_mesh(data=2, fsdp=2, tensor=2)
    if case == "grid":
        # wqkv's spec cuts the contraction axis over fsdp and the kv-head
        # axis over tensor: a 2 x 2 grid of views, replicated over data.
        w = torch.arange(2 * 8 * 4 * 3 * 2, dtype=torch.float32).reshape(
            2, 8, 4, 3, 2)
        s = shard_pytree(w, mesh, P(None, "fsdp", "tensor", None, None))
        assert isinstance(s, Sharded) and len(s.shards) == 8
        assert s.shape == w.shape
        for i, block in enumerate(s.shards):
            c = mesh.coords(i)
            assert block.untyped_storage().data_ptr() == \
                w.untyped_storage().data_ptr()
            assert torch.equal(block, w[:, 4 * c["fsdp"]:4 * c["fsdp"] + 4,
                                        2 * c["tensor"]:2 * c["tensor"] + 2])
        assert torch.equal(s.gather(), w)
        assert s.nbytes == w.numel() * 4
        assert torch.equal(s[1].gather(), w[1])
    elif case == "tuple_entry":
        x = torch.arange(8 * 3).reshape(8, 3)
        s = shard_pytree(x, mesh, batch_sharding(mesh))
        assert batch_sharding(mesh).spec == P(("data", "fsdp"), "sequence")
        for i, block in enumerate(s.shards):
            c = mesh.coords(i)
            g = 2 * c["data"] + c["fsdp"]
            assert torch.equal(block, x[2 * g:2 * g + 2])
        assert torch.equal(s.gather(), x)
    elif case == "replicated":
        x = torch.ones(4, 4)
        assert shard_pytree(x, mesh, P(None, None)) is x
        with pytest.raises(ValueError, match="does not divide"):
            shard_pytree(torch.ones(3, 4), mesh, P("tensor"))
        with pytest.raises(IndexError, match="sharded dimension"):
            shard_pytree(torch.ones(4, 4), mesh, P("tensor"))[0]
    elif case == "gather":
        w = torch.randn(8, 6)
        s = shard_pytree(w, mesh, P("fsdp", "tensor"))
        for i in range(8):
            t = mesh.coords(i)["tensor"]
            assert torch.equal(s.gathered(i, "fsdp"), w[:, 3 * t:3 * t + 3])
    elif case == "named":
        # The port's NamedSharding twin carries the reference's spec.
        jm = _jmesh(data=2, fsdp=2, tensor=2)
        for axes in (("batch", "seq"), ("embed_fsdp", "mlp"),
                     ("vocab", None, "embed_fsdp")):
            got = named_sharding(mesh, *axes)
            assert isinstance(got, NamedSharding) and got.mesh is mesh
            assert tuple(got.spec) == tuple(
                jsharding.named_sharding(jm, *axes).spec)
        assert tuple(batch_sharding(mesh).spec) == tuple(
            jsharding.batch_sharding(jm).spec)
    elif case == "collectives":
        vals = [torch.full((2,), float(i)) for i in range(8)]
        summed = collectives.psum(vals, mesh, "tensor")
        gathered = collectives.all_gather(vals, mesh, ("data", "fsdp"), 0)
        for i in range(8):
            c = mesh.coords(i)
            base = i - c["tensor"]
            assert torch.equal(summed[i], vals[base] + vals[base + 1])
            same = [j for j in range(8)
                    if mesh.coords(j)["tensor"] == c["tensor"]]
            assert torch.equal(gathered[i], torch.cat([vals[j]
                                                      for j in same]))
    elif case == "coords":
        for i in range(8):
            assert mesh.index(**mesh.coords(i)) == i
        assert mesh.groups("tensor") == [[0, 1], [2, 3], [4, 5], [6, 7]]
        assert mesh.groups(("data", "fsdp")) == [[0, 2, 4, 6],
                                                  [1, 3, 5, 7]]
    elif case == "env":
        monkeypatch.setenv("TPU_CHIPS_PER_HOST_BOUNDS", "2,2,1")
        assert host_mesh_shape() == jmesh_mod.host_mesh_shape() == (2, 2, 1)
        monkeypatch.delenv("TPU_CHIPS_PER_HOST_BOUNDS")
        # No CUDA device here: no visible shards.
        assert host_mesh_shape() == (0,)
        with pytest.raises(ValueError, match="needs 8 devices"):
            mesh_from_env(MeshConfig(tensor=8))
    elif case == "refusals":
        # The pipe and sequence axes run (they refused before): weights
        # placed on them, the forward and, on a mesh without a sequence
        # axis, use_ring (a ring of one hop) equal the reference's.
        jp = jllama.init_params(JTINY, jax.random.PRNGKey(0))
        p = params_from_numpy(_numpy(jp), TINY, device="cpu")
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 9),
                                             0, TINY.vocab_size))
        for axes in (dict(pipe=2), dict(sequence=2)):
            bad, jbad = _cpu_mesh(**axes), _jmesh(**axes)
            placed = shard_pytree(p, bad, llama.param_specs(TINY))
            assert placed["layers"]["wqkv"] is p["layers"]["wqkv"]
            want = jllama.forward(
                jsharding.shard_pytree(jp, jbad, jllama.param_specs(JTINY)),
                jnp.asarray(toks[:, :-1]), JTINY, jbad)
            got = llama.forward(p, torch.tensor(toks[:, :-1]), TINY,
                                mesh=bad)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-5, atol=2e-5)
        jm = _jmesh(data=2, fsdp=2, tensor=2)
        want = jllama.loss_fn(
            jsharding.shard_pytree(jp, jm, jllama.param_specs(JTINY)),
            jnp.asarray(toks), JTINY, jm, use_ring=True)
        got = llama.loss_fn(p, torch.tensor(toks), TINY, mesh=mesh,
                            use_ring=True)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        # The expert axis beside tensor (it refused before): the MoE
        # forward on expert 2 x tensor 2 equals the reference's there.
        jmp = jmoe.init_params(JMOE, jax.random.PRNGKey(0))
        jem = _jmesh(expert=2, tensor=2)
        want, want_aux = jax.jit(lambda q: jmoe.forward(
            q, jnp.asarray(toks), JMOE, mesh=jem))(
                jsharding.shard_pytree(jmp, jem, jmoe.param_specs(JMOE)))
        got, aux = moe.forward(params_from_numpy(_numpy(jmp), TMOE,
                                                 device="cpu"),
                               torch.tensor(toks), TMOE,
                               mesh=_cpu_mesh(expert=2, tensor=2))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert abs(float(aux) - float(want_aux)) < 1e-5
        with pytest.raises(ValueError, match="does not split"):
            llama.forward(p, torch.zeros((3, 4), dtype=torch.long), TINY,
                          mesh=mesh)
    else:
        # The reference's refusal: tensor must divide n_kv_heads (2).
        from k8s_dra_driver_tpu.models import train as jtrain
        from k8s_dra_driver_tpu_torch.models import train as ttrain

        with pytest.raises(ValueError, match="must divide n_kv_heads") as je:
            jtrain.init_train_state(JTINY, _jmesh(tensor=4),
                                    jtrain.make_optimizer())
        with pytest.raises(ValueError, match="must divide n_kv_heads") as te:
            ttrain.init_train_state(TINY, ttrain.make_optimizer(),
                                    device="cpu", mesh=_cpu_mesh(tensor=4))
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# Sharded decode: the twins of tests/test_decode_sharded.py.
# ---------------------------------------------------------------------------


def _jcache_specs():
    kv = JP(None, "tensor", None, None)
    return jdecode.PagedKVCache(k=kv, v=kv, block_tables=JP(), lengths=JP(),
                                block_size=8)


def _jshard(mesh, specs, values):
    shardings = jax.tree.map(lambda s: JNamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, JP))
    return jax.device_put(values, shardings)


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_sharded_decode_matches_unsharded(weights):
    """The reference's sharded decode on (data 2, fsdp 2, tensor 2) and
    the port's on the same mesh shape, both against the reference's
    unsharded forward at 2e-4; the port's pools cut by ``cache_specs``
    (kv heads over tensor, views of the whole pools)."""
    jm = JMesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
               ("data", "fsdp", "tensor"))
    mesh = _cpu_mesh(data=2, fsdp=2, tensor=2)
    jp = jllama.init_params(JTINY, jax.random.PRNGKey(0))
    jspecs, tspecs = jllama.param_specs(JTINY), llama.param_specs(TINY)
    if weights == "int8":
        jp = jquant.quantize_params(jp)
        jspecs, tspecs = jquant.quantize_specs(jspecs), \
            quant.quantize_specs(tspecs)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                         (BATCH, PROMPT), 0,
                                         JTINY.vocab_size))
    ref = np.asarray(jllama.forward(jp, jnp.asarray(toks), JTINY))
    sh = _jshard(jm, jspecs, jp)
    jtoks = jax.device_put(jnp.asarray(toks),
                           JNamedSharding(jm, JP(("data", "fsdp"), None)))
    logits_sh = JNamedSharding(jm, JP(("data", "fsdp"), None))
    cache_sh = jax.tree.map(lambda s: JNamedSharding(jm, s), _jcache_specs(),
                            is_leaf=lambda x: isinstance(x, JP))
    jpre = jax.jit(lambda p, t: jdecode.prefill(p, t, JTINY, MAX_LEN,
                                                block_size=8),
                   out_shardings=(logits_sh, cache_sh))
    jstep = jax.jit(lambda p, t, c: jdecode.decode_step(p, t, c, JTINY),
                    out_shardings=(logits_sh, cache_sh))
    tp = params_from_numpy(_numpy(jp), TINY, device="cpu")
    placed = shard_pytree(tp, mesh, tspecs)
    if weights == "int8":
        assert placed["layers"]["wqkv"].q.spec == tspecs["layers"]["wqkv"].q
    jl, jc = jpre(sh, jtoks[:, :PROMPT - 2])
    tl, tc = decode.prefill(placed, torch.tensor(toks[:, :PROMPT - 2]),
                            TINY, MAX_LEN, block_size=8, mesh=mesh)
    steps = [(np.asarray(jl), tl, PROMPT - 3)]
    for i in range(PROMPT - 2, PROMPT):
        jl, jc = jstep(sh, jtoks[:, i], jc)
        tl, tc = decode.decode_step(placed, torch.tensor(toks[:, i]), tc,
                                    TINY, mesh=mesh)
        steps.append((np.asarray(jl), tl, i))
    for jlog, tlog, pos in steps:
        np.testing.assert_allclose(tlog.numpy(), ref[:, pos], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(tlog.numpy(), jlog, rtol=2e-4, atol=2e-4)
    assert jc.k.sharding.spec == _jcache_specs().k
    assert isinstance(tc.k, Sharded) and tc.k.spec == cache_specs().k
    assert tuple(tc.k.spec) == tuple(_jcache_specs().k)
    for i, block in enumerate(tc.k.shards):
        t = mesh.coords(i)["tensor"]
        assert block.shape[1] == TINY.n_kv_heads // 2
        assert block.data_ptr() == tc.k.shards[0].data_ptr() + t * (
            tc.k.shards[0][0, 0].numel() * 4)
    assert isinstance(tc.block_tables, torch.Tensor)


def test_sharded_engine_streams_equal_the_unsharded_engine():
    """``DecodeEngine(mesh=)`` on (data 2, tensor 2): greedy streams token
    for token those of the unsharded engine and of the reference's
    engine, the pools cut by ``cache_specs``, each step built once."""
    from k8s_dra_driver_tpu.models.serving import DecodeEngine as JEngine

    mesh = _cpu_mesh(data=2, tensor=2)
    jp = jllama.init_params(JTINY, jax.random.PRNGKey(0))
    tp = params_from_numpy(_numpy(jp), TINY, device="cpu")
    kw = dict(batch_slots=4, num_blocks=16, block_size=8, max_seq_len=32,
              prefill_chunk=8)

    def streams(eng):
        rng = np.random.RandomState(8)
        prompts = [rng.randint(0, TINY.vocab_size, size=n).tolist()
                   for n in (5, 9, 13, 7)]
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        return [r.tokens for r in reqs]

    ref = streams(JEngine(jp, JTINY, **kw))
    eng = DecodeEngine(shard_pytree(tp, mesh, llama.param_specs(TINY)),
                       TINY, mesh=mesh, device="cpu", **kw)
    assert isinstance(eng._pools[0], Sharded)
    assert streams(eng) == ref
    assert streams(DecodeEngine(tp, TINY, device="cpu", **kw)) == ref
    assert eng.compile_counts == {"decode_step": 1, "prefill_chunk": 1}
    with pytest.raises(ValueError, match="does not split"):
        DecodeEngine(tp, TINY, mesh=mesh, device="cpu", batch_slots=3)


def test_engine_serves_on_pipe_and_sequence_meshes():
    """``DecodeEngine(mesh=)`` on pipe 2 x sequence 2 x tensor 2 serves on
    the shards at pipe 0 and sequence 0 (the replicas along both axes
    would compute the same step): greedy streams token for token those
    of the reference's engine on its mesh of the same shape."""
    from k8s_dra_driver_tpu.models.serving import DecodeEngine as JEngine

    axes = dict(pipe=2, sequence=2, tensor=2)
    mesh, jmesh = _cpu_mesh(**axes), _jmesh(**axes)
    jp = jllama.init_params(JTINY, jax.random.PRNGKey(0))
    tp = params_from_numpy(_numpy(jp), TINY, device="cpu")
    kw = dict(batch_slots=4, num_blocks=16, block_size=8, max_seq_len=32,
              prefill_chunk=8)

    def streams(eng):
        rng = np.random.RandomState(8)
        prompts = [rng.randint(0, TINY.vocab_size, size=n).tolist()
                   for n in (5, 9, 13, 7)]
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        return [r.tokens for r in reqs]

    ref = streams(JEngine(
        jsharding.shard_pytree(jp, jmesh, jllama.param_specs(JTINY)), JTINY,
        mesh=jmesh, **kw))
    eng = DecodeEngine(shard_pytree(tp, mesh, llama.param_specs(TINY)),
                       TINY, mesh=mesh, device="cpu", **kw)
    assert streams(eng) == ref
    assert eng.compile_counts == {"decode_step": 1, "prefill_chunk": 1}


def test_int8_moe_engine_on_expert_and_tensor():
    """``DecodeEngine(mesh=)`` on expert 2 x tensor 2 with int8 weights
    and the int8 KV cache (the card's int8 Mixtral serving composition):
    ``auto`` resolves to einsum there, each expert shard's experts run per
    tensor shard; greedy streams token for token the reference engine's
    on its mesh, each step built once."""
    from k8s_dra_driver_tpu.models.serving import DecodeEngine as JEngine

    axes = dict(expert=2, tensor=2)
    mesh, jmesh = _cpu_mesh(**axes), _jmesh(**axes)
    jcfg = dataclasses.replace(JMOE, capacity_factor=8.0)
    tcfg = dataclasses.replace(TMOE, capacity_factor=8.0)
    jp = jquant.quantize_params(jmoe.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(_numpy(jp), tcfg, device="cpu")
    kw = dict(batch_slots=4, num_blocks=16, block_size=8, max_seq_len=32,
              prefill_chunk=8, quantize_cache=True)

    def streams(eng):
        rng = np.random.RandomState(8)
        prompts = [rng.randint(0, TMOE.vocab_size, size=n).tolist()
                   for n in (5, 9, 13)]
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        eng.assert_no_leaks()
        return [r.tokens for r in reqs]

    ref = streams(JEngine(
        jsharding.shard_pytree(jp, jmesh, jquant.quantize_specs(
            jmoe.param_specs(jcfg))), jcfg, mesh=jmesh, **kw))
    eng = DecodeEngine(shard_pytree(tp, mesh, quant.quantize_specs(
        moe.param_specs(tcfg))), tcfg, mesh=mesh, device="cpu", **kw)
    assert eng.moe_impl == {"decode_step": "einsum",
                            "prefill_chunk": "einsum"}
    assert streams(eng) == ref
    assert eng.compile_counts == {"decode_step": 1, "prefill_chunk": 1}


# ---------------------------------------------------------------------------
# MoE on expertless meshes and data composed with expert.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_params():
    jp = jmoe.init_params(JMOE, jax.random.PRNGKey(0))
    return jp, params_from_numpy(_numpy(jp), TMOE, device="cpu")


MOE_MESHES = {"tensor2": dict(tensor=2), "data2_expert4": dict(data=2,
                                                                expert=4),
              "data2_fsdp2_tensor2": dict(data=2, fsdp=2, tensor=2),
              "expert2_tensor2": dict(expert=2, tensor=2),
              "expert2_fsdp2": dict(expert=2, fsdp=2),
              "data2_expert2_tensor2": dict(data=2, expert=2, tensor=2)}


@pytest.mark.parametrize("case", [
    "tensor2_dropless", "tensor2_dropless_int8", "tensor2_einsum",
    "tensor2_binned", "data2_expert4_dropless", "data2_expert4_int8",
    "data2_fsdp2_tensor2_dropless", "expert2_tensor2_dropless_ring",
    "expert2_tensor2_dropless_psum", "expert2_tensor2_einsum",
    "expert2_tensor2_int8", "expert2_fsdp2_dropless",
    "data2_expert2_tensor2_dropless"])
def test_moe_on_mesh_axes(moe_params, case):
    """``tiny-moe`` on the reference's mesh and the port's: dropless on an
    expertless mesh takes the primitive path per tensor shard (the
    reference's GSPMD case), einsum and binned run there too, and each
    data group runs its own expert-parallel body on data x expert. Beside
    tensor (and fsdp) each expert shard's experts run per tensor shard on
    their M block, gathered over fsdp: the EP ring and psum, einsum, and
    int8 stacks (the ring, the int8 grouped product per shard)."""
    jp, tp = moe_params
    mesh_name = max((k for k in MOE_MESHES if case.startswith(k + "_")),
                    key=len)
    axes = MOE_MESHES[mesh_name]
    impl = "einsum" if "einsum" in case else (
        "binned" if "binned" in case else "dropless")
    overlap = case.rsplit("_", 1)[1] if case.endswith(("_ring", "_psum")) \
        else "auto"
    kw = dict(moe_impl=impl, capacity_factor=8.0, ep_overlap=overlap)
    jcfg = dataclasses.replace(JMOE, **kw)
    tcfg = dataclasses.replace(TMOE, **kw)
    jspecs, tspecs = jmoe.param_specs(jcfg), moe.param_specs(tcfg)
    if case.endswith("int8"):
        jp = jquant.quantize_params(jp)
        tp = params_from_numpy(_numpy(jp), TMOE, device="cpu")
        jspecs, tspecs = jquant.quantize_specs(jspecs), \
            quant.quantize_specs(tspecs)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                         JMOE.vocab_size))
    jm = _jmesh(**axes)
    jout, jaux = jax.jit(lambda p, t: jmoe.forward(p, t, jcfg, mesh=jm))(
        _jshard(jm, jspecs, jp), jnp.asarray(toks))
    mesh = _cpu_mesh(**axes)
    out, aux = moe.forward(shard_pytree(tp, mesh, tspecs),
                           torch.tensor(toks), tcfg, mesh=mesh)
    single, single_aux = moe.forward(tp, torch.tensor(toks), tcfg)
    tol = dict(atol=1e-4, rtol=1e-4) if case.endswith("int8") else TOL
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(out.numpy(), single.numpy(), **tol)
    assert abs(float(aux) - float(jaux)) < 1e-5
    assert abs(float(aux) - float(single_aux)) < 1e-5


def test_dropless_on_a_tensor_mesh_is_the_primitive_path(moe_params,
                                                          monkeypatch):
    """Each tensor shard's pairs go through ``grouped_matmul`` on its M
    block, the gate/up block a strided view of the whole stack (no copy);
    the fused pipeline never runs there."""
    _, tp = moe_params
    mesh = _cpu_mesh(tensor=2)
    cfg = dataclasses.replace(TMOE, moe_impl="dropless")
    seen = []
    gm = md.grouped_matmul

    def spy(lhs, rhs, sizes, **kw):
        seen.append(rhs)
        return gm(lhs, rhs, sizes, **kw)

    monkeypatch.setattr(md, "grouped_matmul", spy)
    monkeypatch.setattr(md, "fused_moe_mlp", lambda *a, **k: 1 / 0)
    with torch.no_grad():
        moe.forward(tp, torch.zeros((2, 8), dtype=torch.long), cfg,
                    mesh=mesh)
    whole = tp["layers"]["w_gateup"]
    m_loc = TMOE.mlp_hidden // 2
    halves = [w for w in seen if w.untyped_storage().data_ptr()
              == whole.untyped_storage().data_ptr()]
    # Two layers, two shards, a gate and an up half each (float weights),
    # each a strided view [E, H, M / 2] of the whole stack.
    assert len(halves) == 2 * 2 * 2 and len(seen) == 2 * 2 * 3
    assert all(w.shape == (TMOE.n_experts, TMOE.hidden, m_loc)
               and not w.is_contiguous() for w in halves)


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_dropless_beside_tensor_runs_grouped_products_per_shard(
        moe_params, weights, monkeypatch):
    """Dropless on expert 2 x tensor 2 (the ring): every (hop, expert
    shard) runs its pairs per tensor shard through the grouped products
    on that shard's M block of its local experts (K10a, or the int8
    grouped product: one gate/up launch for both halves), never the
    fused pipeline (K7/K8), and the ring keeps n_ep K9 launches a layer:
    the tensor axis adds no hop."""
    from k8s_dra_driver_tpu_torch.parallel import ring

    _, tp = moe_params
    mesh = _cpu_mesh(expert=2, tensor=2)
    cfg = dataclasses.replace(TMOE, moe_impl="dropless", ep_overlap="ring")
    specs = moe.param_specs(cfg)
    if weights == "int8":
        tp, specs = quant.quantize_params(tp), quant.quantize_specs(specs)
    seen, hops = [], []
    gm, group = md.grouped_matmul, ring.ring_permute_group

    def spy(lhs, rhs, sizes, **kw):
        seen.append(tuple(rhs.shape))
        return gm(lhs, rhs, sizes, **kw)

    def counted(rings, shift=1):
        if any(x.numel() for r in rings for x in r):
            hops.append(len(rings))
        return group(rings, shift)

    monkeypatch.setattr(md, "grouped_matmul", spy)
    monkeypatch.setattr(ring, "ring_permute_group", counted)
    monkeypatch.setattr(md, "fused_moe_mlp", lambda *a, **k: 1 / 0)
    with torch.no_grad():
        moe.forward(shard_pytree(tp, mesh, specs),
                    torch.zeros((2, 8), dtype=torch.long), cfg, mesh=mesh)
    layers, n_ep, t = TMOE.n_layers, 2, 2
    e_loc, h, m_loc = TMOE.n_experts // n_ep, TMOE.hidden, \
        TMOE.mlp_hidden // t
    shard_calls = layers * n_ep * n_ep * t
    if weights == "int8":
        want = [(e_loc, h, 2, m_loc), (e_loc, m_loc, h)] * shard_calls
    else:
        want = [(e_loc, h, m_loc)] * 2 + [(e_loc, m_loc, h)]
        want = want * shard_calls
    assert seen == want
    # Each hop but the last rotates chunk and carrier together.
    assert hops == [2, 1] * layers


def test_layout_places_expert_shards_beside_tensor():
    """``Layout.expert_shards(g, t, j)`` is the mesh index of each expert
    shard at (group, tensor shard, sequence shard); ``Layout.experts``
    gives an expert shard's block for a tensor shard, gathered over
    fsdp, its int8 fields alike, and refuses a stack not cut by the
    mesh's expert axis (whole, cut otherwise, or on another mesh)."""
    from k8s_dra_driver_tpu_torch.parallel.layout import Layout

    mesh = _cpu_mesh(data=2, fsdp=2, expert=2, sequence=2, tensor=2)
    lay = Layout(mesh)
    for g in range(4):
        for t in range(2):
            for j in range(2):
                assert lay.expert_shards(g, t, j) == [
                    mesh.index(data=g // 2, fsdp=g % 2, expert=e,
                               sequence=j, tensor=t) for e in range(2)]
    assert lay.expert_shards(1) == lay.expert_shards(1, 0, 0)
    w = torch.randn(4, 8, 2, 6)
    q = quant.quantize_tensor(w, axis=1)
    spec = P("expert", "fsdp", None, "tensor")
    placed = shard_pytree(w, mesh, spec)
    qplaced = shard_pytree(q, mesh, quant.QuantTensor(
        q=spec, scale=P("expert", None, None, "tensor")))
    for e in range(2):
        for t in range(2):
            block = lay.experts(placed, 3, e, t)
            assert torch.equal(block, w[2 * e:2 * e + 2, :, :,
                                        3 * t:3 * t + 3])
            qb = lay.experts(qplaced, 3, e, t)
            assert torch.equal(qb.q, q.q[2 * e:2 * e + 2, :, :,
                                         3 * t:3 * t + 3])
            assert torch.equal(qb.scale, q.scale[2 * e:2 * e + 2, :, :,
                                                 3 * t:3 * t + 3])
    for bad in (w, shard_pytree(w, mesh, P(None, "fsdp")),
                shard_pytree(w, _cpu_mesh(expert=2), P("expert"))):
        with pytest.raises(ValueError, match="not cut by this mesh's "
                           "expert axis"):
            lay.experts(bad, 0, 0)


# ---------------------------------------------------------------------------
# The int8 grouped product's plain version against the reference's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ragged", "empty_and_tail", "gateup",
                                  "bf16"])
def test_int8_grouped_product_matches_the_reference(case):
    """``grouped_matmul`` with an int8 rhs (its plain version, what a CPU
    tensor takes) against the reference's int8 ``grouped_matmul``
    (``lax.ragged_dot`` with the scale in the epilogue) on the same
    inputs: ragged groups, an empty group and rows past the last group,
    and a gate/up stack [E, K, 2, M] against the reference's [E, K, 2M]."""
    rng = np.random.RandomState(3)
    e, k, n = 4, 64, 48
    sizes = {"ragged": [5, 17, 1, 9], "empty_and_tail": [0, 7, 0, 12],
             "gateup": [3, 0, 8, 6], "bf16": [6, 2, 9, 4]}[case]
    rows = sum(sizes) + (5 if case == "empty_and_tail" else 0)
    lhs = rng.randn(rows, k).astype(np.float32)
    shape = (e, k, 2, n // 2) if case == "gateup" else (e, k, n)
    w = rng.randn(*shape).astype(np.float32)
    jw = jquant.quantize_tensor(jnp.asarray(w), axis=1)
    tw = quant.QuantTensor(q=torch.tensor(np.asarray(jw.q)),
                           scale=torch.tensor(np.asarray(jw.scale)))
    if case == "gateup":
        jw = jquant.QuantTensor(q=jw.q.reshape(e, k, n),
                                scale=jw.scale.reshape(e, 1, n))
    dtype = (jnp.bfloat16, torch.bfloat16) if case == "bf16" else (
        jnp.float32, torch.float32)
    gs = np.asarray(sizes, np.int32)
    want = np.asarray(jmd.grouped_matmul(
        jnp.asarray(lhs).astype(dtype[0]), jw, jnp.asarray(gs),
        use_pallas=False).astype(jnp.float32))
    tl = torch.tensor(lhs).to(dtype[1])
    got = md.grouped_matmul(tl, tw, torch.tensor(gs)).float().numpy()
    plain = md.grouped_matmul_int8_reference(
        tl, tw.q, tw.scale, torch.tensor(gs)).float().numpy()
    np.testing.assert_array_equal(got, plain)
    if case == "bf16":
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[sum(sizes):].any()
