"""The port's int8 serving path against the JAX package's, on the CPU at the
``tiny`` and ``tiny-moe`` presets (f32).

- ``quantize_tensor`` and ``quantize_params`` give the reference's int8
  values and scales bit for bit, and ``params_from_numpy`` of the
  reference's quantized tree equals the port's ``quantize_params`` of the
  converted float tree bit for bit.
- The seams (``q_einsum``, ``q_matmul``, ``q_lookup``, ``q_dequant``)
  match to 1e-6 (f32; another summation order). With bf16 activations
  ``q_einsum``/``q_matmul`` and both modes of ``int8_matmul``'s plain
  version match the reference's ``_mixed_dot`` and ``q_dequant`` forms
  within 1 bf16 ulp, bitwise but for at most 1% of the elements (ties of
  the f32 summation order); every model pattern is the simple
  contraction; ``tiny-moe`` with ``moe_impl="einsum"`` on int8 weights
  matches the reference's forward to 1e-4.
- ``forward`` and ``_forward_with_cache`` in each of ``int8``, ``kvq`` and
  ``int8+kvq``: logits within 1e-4 relative to the largest logit; the
  int8 pools equal but for at most a few values one step apart (a k or v
  element at a rounding boundary of its scale, where the two packages'
  f32 projections differ in the last bit); scales within 1e-6 relative.
- ``DecodeEngine`` int8+kvq: greedy streams, counters, allocator and
  prefix-cache state EQUAL to the reference engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.models import decode as jdecode
from k8s_dra_driver_tpu.models import llama as jllama
from k8s_dra_driver_tpu.models import moe as jmoe
from k8s_dra_driver_tpu.models import paged as jpaged
from k8s_dra_driver_tpu.models import quant as jquant
from k8s_dra_driver_tpu.models.serving import DecodeEngine as JEngine
from k8s_dra_driver_tpu_torch import ops as tops
from k8s_dra_driver_tpu_torch.models import decode as tdecode
from k8s_dra_driver_tpu_torch.models import llama as tllama
from k8s_dra_driver_tpu_torch.models import moe as tmoe
from k8s_dra_driver_tpu_torch.models import paged as tpaged
from k8s_dra_driver_tpu_torch.models import quant as tquant
from k8s_dra_driver_tpu_torch.models.convert import params_from_numpy
from k8s_dra_driver_tpu_torch.models.serving import DecodeEngine

PRESETS = {
    "tiny": (jllama.PRESETS["tiny"], tllama.PRESETS["tiny"],
             jllama.init_params, jllama.forward, tllama.forward),
    "tiny-moe": (
        dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"], capacity_factor=8.0),
        dataclasses.replace(tmoe.MOE_PRESETS["tiny-moe"], capacity_factor=8.0),
        jmoe.init_params, jmoe.forward, tmoe.forward),
}
SEAM_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module", params=list(PRESETS))
def model(request):
    """(name, jax config, port config, jax float params, jax int8 params,
    port int8 params converted from the jax int8 tree)."""
    jcfg, tcfg, init, _, _ = PRESETS[request.param]
    jp = init(jcfg, jax.random.PRNGKey(0))
    jq = jquant.quantize_params(jp)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    return request.param, jcfg, tcfg, jp, jq, tq


def _leaves(p):
    out = {"embed": p["embed"], "lm_head": p["lm_head"]}
    out.update({f"layers/{k}": v for k, v in p["layers"].items()})
    return out


def _rel_close(ours, ref, tol=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert np.isfinite(ours).all()
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_quantize_tensor_bitwise(dtype, axis):
    rng = np.random.RandomState(axis)
    w = (rng.randn(5, 6, 7) * np.exp(rng.randn(5, 6, 7))).astype(np.float32)
    w[1] = 0.0                      # an all-zero slice: amax clamps to 1e-8
    jw = jnp.asarray(w, dtype=getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    ref = jquant.quantize_tensor(jw, axis)
    ours = tquant.quantize_tensor(tw, axis)
    assert ours.q.dtype == torch.int8 and ours.scale.dtype == torch.float32
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))


def test_quantize_params_bitwise(model):
    """The reference's quantized tree, converted, equals the port's
    ``quantize_params`` of the converted float tree, and both equal the
    reference's leaves; the router and the norms stay float."""
    name, jcfg, tcfg, jp, jq, tq = model
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ours = tquant.quantize_params(tp)
    ref = _leaves(jq)
    for key, a in _leaves(ours).items():
        b = _leaves(tq)[key]
        if isinstance(a, tquant.QuantTensor):
            assert isinstance(b, tquant.QuantTensor)
            assert a.q.dtype == b.q.dtype == torch.int8
            assert a.scale.dtype == b.scale.dtype == torch.float32
            for x, y in ((a.q, b.q), (a.scale, b.scale)):
                assert torch.equal(x, y), key
            np.testing.assert_array_equal(a.q.numpy(), np.asarray(ref[key].q))
            np.testing.assert_array_equal(a.scale.numpy(),
                                          np.asarray(ref[key].scale))
        else:
            assert torch.equal(a, b), key
    if name == "tiny-moe":
        assert tq["layers"]["wr"].dtype == torch.float32
        assert not isinstance(tq["layers"]["wr"], tquant.QuantTensor)


@pytest.mark.parametrize("seam", ["einsum_qkv", "einsum_generic", "matmul",
                                  "lookup", "dequant"])
def test_seams_match(seam):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 16).astype(np.float32)
    if seam == "einsum_qkv":
        w, axis, args = rng.randn(16, 2, 4, 8), 0, ("bth,hkgd->btkgd",)
    elif seam == "einsum_generic":     # x's batch axes reordered
        w, axis, args = rng.randn(16, 5), 0, ("bth,hm->tbm",)
    elif seam in ("matmul", "lookup"):
        w, axis, args = rng.randn(16, 24), 0 if seam == "matmul" else 1, ()
    else:
        w, axis, args = rng.randn(3, 16, 2, 8), 1, ()
    w = w.astype(np.float32)
    jw = jquant.quantize_tensor(jnp.asarray(w), axis)
    tw = tquant.quantize_tensor(torch.from_numpy(w), axis)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if seam.startswith("einsum"):
        ours, ref = tquant.q_einsum(*args, tx, tw), \
            jquant.q_einsum(*args, jx, jw)
        float_ours = tquant.q_einsum(*args, tx, torch.from_numpy(w))
        np.testing.assert_allclose(
            float_ours.numpy(), np.asarray(jnp.einsum(*args, jx, w)),
            **SEAM_TOL)
    elif seam == "matmul":
        ours, ref = tquant.q_matmul(tx, tw), jquant.q_matmul(jx, jw)
    elif seam == "lookup":
        tokens = np.array([[0, 5, 15], [3, 3, 9]], np.int32)
        ours = tquant.q_lookup(tw, torch.from_numpy(tokens), torch.float32)
        ref = jquant.q_lookup(jw, jnp.asarray(tokens), jnp.float32)
    else:
        ours = tquant.q_dequant(tw, torch.float32)
        ref = jquant.q_dequant(jw, jnp.float32)
        assert tquant.q_dequant(tx, torch.float32) is tx
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **SEAM_TOL)


def _bf16_order(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of their values, so that the
    difference of two is their distance in bf16 ulps."""
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _ulps(ours: torch.Tensor, ref) -> torch.Tensor:
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).bfloat16()
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
    return (_bf16_order(ours) - _bf16_order(ref)).abs()


@pytest.mark.parametrize("seam", ["einsum_qkv", "einsum_mlp", "matmul"])
def test_bf16_seams_keep_the_product_f32(seam):
    """bf16 activations, as the card serves: the seams against the
    reference's ``_mixed_dot`` path (f32 sum of x and int8 q, f32 scale,
    one cast) within 1 bf16 ulp everywhere and bitwise equal but for
    summation-order ties. A seam that rounds the product to bf16 before
    the scale differs by an ulp in a large share of the elements."""
    rng = np.random.RandomState(11)
    x = rng.randn(3, 5, 128).astype(np.float32)
    if seam == "einsum_qkv":
        w, args = rng.randn(128, 2, 4, 16), ("bth,hkgd->btkgd",)
    elif seam == "einsum_mlp":
        w, args = rng.randn(128, 2, 96), ("bth,hcm->btcm",)
    else:
        w, args = rng.randn(128, 160), ()
    w = (w * np.exp(rng.randn(*w.shape))).astype(np.float32)
    jw = jquant.quantize_tensor(jnp.asarray(w), 0)
    tw = tquant.quantize_tensor(torch.from_numpy(w), 0)
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    if seam == "matmul":
        jx, tx = jx.reshape(15, 128), tx.reshape(15, 128)
        ours, ref = tquant.q_matmul(tx, tw), jquant.q_matmul(jx, jw)
    else:
        ours = tquant.q_einsum(*args, tx, tw)
        ref = jquant.q_einsum(*args, jx, jw)
    ulps = _ulps(ours, ref)
    assert ulps.max().item() <= 1, ulps.max().item()
    assert (ulps > 0).float().mean().item() <= 0.01


@pytest.mark.parametrize("prologue", [False, True])
def test_int8_matmul_reference_matches_the_reference_forms(prologue):
    """The kernel's plain version in both modes against the reference's
    own forms: ``_mixed_dot(x, q) * scale`` (epilogue) and
    ``einsum(x, q_dequant(w, bf16))`` (prologue), bf16 activations,
    batched over an expert axis as the MoE body calls it."""
    rng = np.random.RandomState(12 + prologue)
    x = rng.randn(4, 24, 128).astype(np.float32)
    w = (rng.randn(4, 128, 80) * np.exp(rng.randn(4, 128, 80))).astype(
        np.float32)
    jw = jquant.quantize_tensor(jnp.asarray(w), 1)        # scale [E, 1, N]
    tw = tquant.quantize_tensor(torch.from_numpy(w), 1)
    jx = jnp.asarray(x, dtype=jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    ours = tops.int8_matmul_reference(tx, tw.q, tw.scale, prologue=prologue)
    if prologue:
        ref = jnp.einsum("emk,ekn->emn", jx, jquant.q_dequant(jw,
                                                            jnp.bfloat16))
    else:
        ref = jnp.stack([
            (jquant._mixed_dot(jx[i], jw.q[i]) * jw.scale[i]).astype(
                jnp.bfloat16) for i in range(4)])
    ulps = _ulps(ours, ref)
    assert ulps.max().item() <= 1, ulps.max().item()
    assert (ulps > 0).float().mean().item() <= 0.01
    # The 2-D form is the batched form's slice.
    assert torch.equal(
        tops.int8_matmul_reference(tx[1], tw.q[1], tw.scale[1],
                                   prologue=prologue), ours[1])
    # On CPU tensors the wrapper is its plain version, counted nowhere.
    before = tops.int8_matmul.launches
    assert torch.equal(tops.int8_matmul(tx, tw.q, tw.scale, prologue), ours)
    assert tops.int8_matmul.launches == before


def test_model_einsum_patterns_are_the_simple_contraction(model,
                                                          monkeypatch):
    """Every ``q_einsum`` pattern the models use (forward and the cached
    forward, dense and MoE) contracts x's last axis with w's first: the
    int8 kernel's form. The generic f32 einsum is reached by none."""
    name, _, tcfg, _, _, tq = model
    _, _, _, _, tfwd = PRESETS[name]
    seen = []
    real = tquant.q_einsum

    def record(pattern, x, w, use_kernels=True):
        seen.append((pattern, isinstance(w, tquant.QuantTensor)))
        return real(pattern, x, w, use_kernels)

    monkeypatch.setattr(tllama, "q_einsum", record)
    tokens = torch.from_numpy(np.random.RandomState(5).randint(
        0, tcfg.vocab_size, size=(2, 8)).astype(np.int32))
    tfwd(tq, tokens, tcfg)
    cache = tpaged.PagedKVCache.init(tcfg, 2, 16, block_size=8,
                                     device="cpu")
    tdecode._forward_with_cache(tq, tokens, cache, tcfg, torch.arange(8))
    assert seen and all(quant for _, quant in seen)
    for pattern, _ in seen:
        ins, out = pattern.split("->")
        xs, ws = ins.split(",")
        assert xs[-1] == ws[0] and out == xs[:-1] + ws[1:], pattern


def test_int8_einsum_moe_matches_jax():
    """``tiny-moe`` with ``moe_impl="einsum"`` on int8 weights: the
    expert products run ``int8_matmul``'s prologue mode (its plain
    version on the CPU) and match the reference's ``q_dequant`` einsums;
    no dequantized copy of a stack is made on the card."""
    jcfg = dataclasses.replace(jmoe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    tcfg = dataclasses.replace(tmoe.MOE_PRESETS["tiny-moe"],
                               moe_impl="einsum")
    jq = jquant.quantize_params(jmoe.init_params(jcfg, jax.random.PRNGKey(1)))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    tokens = np.random.RandomState(6).randint(0, tcfg.vocab_size,
                                              size=(2, 16)).astype(np.int32)
    assert tmoe.resolve_moe_impl(tcfg, tokens.size) == "einsum"
    ref, ref_aux = jmoe.forward(jq, jnp.asarray(tokens), jcfg)
    ours, aux = tmoe.forward(tq, torch.from_numpy(tokens), tcfg)
    _rel_close(ours.numpy(), ref)
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=1e-5)
    plain, _ = tmoe.forward(tq, torch.from_numpy(tokens), tcfg,
                            use_kernels=False)
    assert torch.equal(plain, ours)


def test_forward_matches_jax(model):
    name, jcfg, tcfg, _, jq, tq = model
    _, _, _, jfwd, tfwd = PRESETS[name]
    tokens = np.random.RandomState(4).randint(0, tcfg.vocab_size,
                                              size=(2, 12)).astype(np.int32)
    ref = jfwd(jq, jnp.asarray(tokens), jcfg)
    ours = tfwd(tq, torch.from_numpy(tokens), tcfg)
    if name == "tiny-moe":
        ref, ours = ref[0], ours[0]
    _rel_close(ours.numpy(), ref)


def _quant_caches(jcfg, tcfg, quantize_cache, b, nbps, bs, nb, seed):
    """The same scrambled block tables on both sides, each package's own
    cache class (int8 + scales when ``quantize_cache``)."""
    rng = np.random.RandomState(seed)
    tables = rng.permutation(nb)[: b * nbps].reshape(b, nbps).astype(
        np.int32)
    jlen = jnp.zeros((b,), jnp.int32)
    tlen = torch.zeros((b,), dtype=torch.int32)
    if not quantize_cache:
        jk, jv = jpaged._init_pools(jcfg, nb, bs)
        tk, tv = tpaged._init_pools(tcfg, nb, bs, device="cpu")
        return (jpaged.PagedKVCache(k=jk, v=jv, block_tables=jnp.asarray(
                    tables), lengths=jlen, block_size=bs),
                tpaged.PagedKVCache(k=tk, v=tv, block_tables=torch.from_numpy(
                    tables), lengths=tlen, block_size=bs))
    jk, jv, jks, jvs = jpaged._init_pools(jcfg, nb, bs, quantized=True)
    tk, tv, tks, tvs = tpaged._init_pools(tcfg, nb, bs, quantized=True,
                                          device="cpu")
    return (jpaged.PagedQuantKVCache(k=jk, k_scale=jks, v=jv, v_scale=jvs,
                                     block_tables=jnp.asarray(tables),
                                     lengths=jlen, block_size=bs),
            tpaged.PagedQuantKVCache(k=tk, k_scale=tks, v=tv, v_scale=tvs,
                                     block_tables=torch.from_numpy(tables),
                                     lengths=tlen, block_size=bs))


def _pools_match(jc, tc):
    p = jc.k.shape[2]
    if not isinstance(tc, tpaged.PagedQuantKVCache):
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(tc, name)[:, :, :p].numpy(),
                                       np.asarray(getattr(jc, name)),
                                       atol=1e-4, rtol=1e-4)
        return
    for name in ("k", "v"):
        ours = getattr(tc, name)[:, :, :p].numpy().astype(np.int32)
        ref = np.asarray(getattr(jc, name)).astype(np.int32)
        diff = np.abs(ours - ref)
        assert diff.max() <= 1 and (diff > 0).sum() <= 4, diff.sum()
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tc, name)[:, :, :p].numpy(),
                                   np.asarray(getattr(jc, name)), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("variant", ["int8", "kvq", "int8+kvq"])
def test_forward_with_cache_variants_match_jax(model, variant):
    """A packed chunk (ragged n_valid, an idle lane), then two decode steps
    with an inactive lane, in the variant's weights and cache."""
    name, jcfg, tcfg, jp, jq, tq = model
    int8, kvq = "int8" in variant, "kvq" in variant
    if int8:
        jparams, tparams = jq, tq
    else:
        jparams = jp
        tparams = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    b, t, bs, nb, nbps = 3, 8, 8, 12, 4
    jc, tc = _quant_caches(jcfg, tcfg, kvq, b, nbps, bs, nb, seed=1)
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, tcfg.vocab_size, size=(b, t)).astype(np.int32)
    starts = np.array([0, 5, 0], np.int32)
    n_valid = np.array([8, 3, 0], np.int32)
    active = np.array([True, True, False])
    positions = starts[:, None] + np.arange(t, dtype=np.int32)
    jl, jc = jdecode._forward_with_cache(
        jparams, jnp.asarray(tokens), jc, jcfg, jnp.asarray(positions),
        n_valid=jnp.asarray(n_valid), active=jnp.asarray(active))
    tl, tc = tdecode._forward_with_cache(
        tparams, torch.from_numpy(tokens), tc, tcfg,
        torch.from_numpy(positions), n_valid=torch.from_numpy(n_valid),
        active=torch.from_numpy(active))
    for lane in range(2):
        _rel_close(tl[lane, : n_valid[lane]].numpy(),
                   np.asarray(jl)[lane, : n_valid[lane]])
    _pools_match(jc, tc)
    assert f"forward:{variant}:t{t}" in tdecode.TRACE_COUNTS
    assert tdecode.variant_label(tparams, tc) == \
        jdecode.variant_label(jparams, jc) == variant
    dact = np.array([True, False, True])
    for tok in (np.array([7, 9, 11], np.int32), np.array([1, 2, 3], np.int32)):
        pos = np.array(jc.lengths)[:, None]
        jl, jc = jdecode._forward_with_cache(
            jparams, jnp.asarray(tok)[:, None], jc, jcfg, jnp.asarray(pos),
            active=jnp.asarray(dact))
        tl, tc = tdecode._forward_with_cache(
            tparams, torch.from_numpy(tok)[:, None], tc, tcfg,
            torch.from_numpy(pos), active=torch.from_numpy(dact))
        _rel_close(tl[dact].numpy(), np.asarray(jl)[dact])
        _pools_match(jc, tc)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
    assert f"forward:{variant}:t1" in tdecode.TRACE_COUNTS


def test_generate_and_prefill_cached_quantized(model):
    """Solo generation int8+kvq equals the reference's stream; a fully
    cached prompt through ``prefill_cached`` on int8 pools (the COW
    recompute) gives the cold prefill's logits."""
    name, jcfg, tcfg, _, jq, tq = model
    prompt = np.random.RandomState(5).randint(
        0, tcfg.vocab_size, size=(1, 9)).astype(np.int32)
    ref = jdecode.generate(jq, jnp.asarray(prompt), jcfg, 5,
                           quantize_cache=True)
    ours = tdecode.generate(tq, prompt, tcfg, 5, quantize_cache=True,
                            device="cpu")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))

    bs, nb = 8, 8
    pools = tpaged._init_pools(tcfg, nb, bs, quantized=True, device="cpu")
    alloc = tpaged.BlockAllocator(nb)
    pc = tpaged.PrefixCache(alloc, bs)
    toks = list(range(3, 3 + 2 * bs))
    cold, _, blocks, hit = tdecode.prefill_cached(
        tq, toks, tcfg, 32, pools, alloc, bs, pc, quantize_cache=True)
    assert hit == 0
    pc.insert(toks, blocks)
    hot, _, blocks2, hit2 = tdecode.prefill_cached(
        tq, toks, tcfg, 32, pools, alloc, bs, pc, quantize_cache=True)
    assert hit2 == bs
    torch.testing.assert_close(hot, cold, atol=1e-4, rtol=1e-4)
    alloc.free(blocks)
    alloc.free(blocks2)


def test_engine_int8_kvq_matches_jax_engine(model):
    """The reference's int8 serving variant under continuous batching: a
    shared prefix (hits and one copy-on-write recompute), packed prefill
    and the overlapped tick; streams, counters, allocator and prefix-cache
    state equal the reference engine's, with no leaks."""
    name, jcfg, tcfg, _, jq, tq = model
    from k8s_dra_driver_tpu_torch.models.serving import RUNNING

    rng = np.random.RandomState(42)
    system = list(rng.randint(0, tcfg.vocab_size, size=16))
    first = [system + list(rng.randint(0, tcfg.vocab_size, size=5)),
             list(rng.randint(0, tcfg.vocab_size, size=11))]
    later = [system + list(rng.randint(0, tcfg.vocab_size, size=3)),
             list(system)]
    kw = dict(batch_slots=2, num_blocks=24, block_size=8, max_seq_len=64,
              prefill_chunk=8, prefill_batch=2, quantize_cache=True)
    tdecode.TRACE_COUNTS.clear()
    runs = []
    for eng in (JEngine(jq, jcfg, **kw),
                DecodeEngine(tq, tcfg, device="cpu", **kw)):
        reqs = [eng.submit(p, max_new_tokens=5) for p in first]
        while reqs[0].state != RUNNING and not reqs[0].done:
            eng.tick()
        reqs += [eng.submit(p, max_new_tokens=5) for p in later]
        eng.run()
        eng.assert_no_leaks()
        assert eng.compile_counts == {"decode_step": 1, "prefill_chunk": 1}
        runs.append((eng, [r.tokens for r in reqs]))
    (je, jt), (te, tt) = runs
    assert tt == jt
    timing = {"ttftP50Ms", "ttftP99Ms", "tokenIntervalP50Ms",
              "tokenIntervalP99Ms"}
    js, ts = je.stats.snapshot(), te.stats.snapshot()
    assert {k: v for k, v in ts.items() if k not in timing} == {
        k: v for k, v in js.items() if k not in timing}
    assert te.allocator.occupancy() == je.allocator.occupancy()
    assert te.kv_residency() == je.kv_residency()
    assert te.stats.prefix_hits >= 2 and te.stats.cow_recomputes == 1
    assert isinstance(te._cache(None, None), tpaged.PagedQuantKVCache)
    assert set(tdecode.TRACE_COUNTS) == {"forward:int8+kvq:t1",
                                         "forward:int8+kvq:t8"}
    if name == "tiny-moe":
        assert te.moe_impl == je.moe_impl == {"decode_step": "dropless",
                                              "prefill_chunk": "dropless"}
