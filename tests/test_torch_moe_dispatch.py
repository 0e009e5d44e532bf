"""The port's fused MoE dispatch (``ops/moe_dispatch.py``) against the JAX
package's, on the CPU, from the same seeded numpy inputs.

JAX's kernels run as its own tests run them (``force_pallas=True,
interpret=True``); the port's wrappers take their plain versions on CPU
tensors. Plans must be bitwise equal; f32 outputs agree to atol/rtol
1e-5 (the same products summed in another order); slots of foreign pairs
are exactly 0 on both sides. Gradients of the fused pipeline agree with
JAX's custom VJP to atol 2e-5 / rtol 2e-4 (the reference's own limit
against autodiff of its oracle: the backward sums in another order than
the forward), those of the grouped matmul with ``jax.grad`` of
``lax.ragged_dot`` to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.ops import moe_dispatch as jmd
from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md

TOL = dict(atol=1e-5, rtol=1e-5)
PLAN_FIELDS = ("row_ids", "pair_ids", "slot_of_pair", "tile_expert",
               "sizes_aligned")


def _problem(seed=0, t=24, h=32, e=4, k=2, m=16, case="random"):
    rng = np.random.RandomState(seed)
    xf = rng.randn(t, h).astype(np.float32)
    w_gu = (rng.randn(e, h, 2, m) * 0.1).astype(np.float32)
    w_down = (rng.randn(e, m, h) * 0.1).astype(np.float32)
    experts = rng.randint(0, e, size=(t * k,)).astype(np.int32)
    if case == "skew":
        experts[:] = 0                            # everything on expert 0
    elif case == "foreign":
        mask = rng.rand(t * k) < 0.5
        experts = np.where(mask, e + 7, experts).astype(np.int32)
    gates = rng.rand(t * k).astype(np.float32)
    return xf, w_gu, w_down, experts, gates, (t, h, e, k, m)


def _plans(experts, t, e, k, tile):
    jp = jmd.build_plan(jnp.asarray(experts), t, e, k, tile_rows=tile)
    tp = md.build_plan(torch.from_numpy(experts), t, e, k, tile_rows=tile)
    return jp, tp


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case,t,e,tile", [
    ("random", 24, 4, 8),
    ("skew", 24, 4, 8),          # one expert holds every pair
    ("foreign", 24, 4, 8),       # half the pairs on foreign experts
    ("random", 8, 8, None),      # a decode step: T=8, k=2, default tile 8
    ("random", 24, 4, None),     # the default tile at 12 pairs per expert
])
def test_build_plan_bitwise_equal(case, t, e, tile):
    *_, experts, _, _ = _problem(seed=1, t=t, e=e, case=case)
    jp, tp = _plans(experts, t, e, 2, tile)
    assert tp.tile_rows == jp.tile_rows and tp.r_pad == jp.r_pad
    assert (tp.n_tokens, tp.n_pairs, tp.n_experts, tp.top_k) == (
        jp.n_tokens, jp.n_pairs, jp.n_experts, jp.top_k)
    for name in PLAN_FIELDS:
        ours, ref = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert ours.dtype == ref.dtype == np.int32, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def test_default_tile_rows_equal():
    for n_pairs in (1, 2, 16, 100, 1024, 4096, 10 ** 5):
        for n_experts in (1, 4, 8, 64):
            assert md.default_tile_rows(n_pairs, n_experts) == \
                jmd.default_tile_rows(n_pairs, n_experts)
    assert md._round_up(13, 8) == jmd._round_up(13, 8) == 16
    assert md._fit_cols(14336, 512) == jmd._fit_cols(14336, 512)


@pytest.mark.parametrize("case", ["random", "skew", "foreign"])
def test_fused_and_reference_match_jax(case):
    """The port's fused pipeline against JAX's fused kernels in
    interpret mode, and the two oracles against each other."""
    xf, w_gu, w_down, experts, gates, (t, h, e, k, m) = _problem(
        seed=4, case=case)
    jp, tp = _plans(experts, t, e, k, 8)
    jargs = [jnp.asarray(a) for a in (xf, w_gu, w_down, gates)]
    targs = _t(xf, w_gu, w_down, gates)
    jfused = np.asarray(jmd.fused_moe_mlp(*jargs, jp, force_pallas=True,
                                          interpret=True))
    jref = np.asarray(jmd.reference_moe_mlp(*jargs, jp))
    tfused = md.fused_moe_mlp(*targs, tp).numpy()
    tref = md.reference_moe_mlp(*targs, tp).numpy()
    np.testing.assert_allclose(tfused, jfused, **TOL)
    np.testing.assert_allclose(tref, jref, **TOL)
    foreign = experts >= e
    assert foreign.any() == (case == "foreign")
    assert (tfused[foreign] == 0).all() and (jfused[foreign] == 0).all()


def test_each_kernel_matches_its_pallas_kernel():
    """K7 and K8 one at a time: the port's wrappers (plain versions on
    the CPU) against ``_gateup_pallas`` and ``_down_combine_pallas`` in
    interpret mode, sentinel rows and foreign slots exactly 0."""
    xf, w_gu, w_down, experts, gates, (t, h, e, k, m) = _problem(
        seed=7, case="foreign")
    jp, tp = _plans(experts, t, e, k, 8)
    jact = jmd._gateup_pallas(jnp.asarray(xf), jnp.asarray(w_gu), None, jp,
                              True)
    x, wg, wd, gt = _t(xf, w_gu, w_down, gates)
    act = md.moe_gateup(x, wg, tp)
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), **TOL)
    assert (act[tp.row_ids >= t] == 0).all()
    jgates_pad = jnp.take(jnp.asarray(gates), jp.pair_ids, mode="fill",
                          fill_value=0.0)[:, None]
    jy = jmd._down_combine_pallas(jact, jnp.asarray(w_down), None,
                                  jgates_pad, jp, True)
    gates_pad = md._take_rows(gt, tp.pair_ids)
    np.testing.assert_allclose(gates_pad.numpy(),
                               np.asarray(jgates_pad)[:, 0])
    y = md.moe_down_combine(act, wd, gates_pad, tp)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert (y[torch.from_numpy(experts >= e)] == 0).all()


def test_grouped_matmul_matches_ragged_dot():
    rng = np.random.RandomState(13)
    lhs = rng.randn(24, 16).astype(np.float32)
    rhs = rng.randn(3, 16, 8).astype(np.float32)
    sizes = np.array([10, 0, 9], np.int32)       # an empty group, 5 rows past
    ref = np.asarray(jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs),
                                        jnp.asarray(sizes)))
    out = md.grouped_matmul(*_t(lhs, rhs, sizes))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert (out[19:] == 0).all()


def test_dispatch_labels_follow_the_reference_off_tpu():
    """On the CPU both packages run the primitive path unless "fused" is
    forced; the port runs the kernels for CUDA tensors (the reference for
    a TPU)."""
    try:
        for impl in ("auto", "fused", "primitive"):
            jmd.set_dispatch_impl(impl)
            md.set_dispatch_impl(impl)
            assert md.dispatch_impl_label(device="cpu") == \
                jmd.dispatch_impl_label(), impl
            assert md.use_fused(device="cpu", h=64, m=128) == \
                jmd.use_fused(h=64, m=128), impl
        md.set_dispatch_impl("auto")
        assert md.dispatch_impl_label(device="cuda") == "fused"
        assert md.dispatch_impl_label(4096, 14336, device="cuda") == "fused"
        assert md.dispatch_impl_label(48, 128, device="cuda") == "primitive"
        with pytest.raises(ValueError):
            md.set_dispatch_impl("megablox")
    finally:
        jmd.set_dispatch_impl("auto")
        md.set_dispatch_impl("auto")
    assert md.fused_geometry_ok(4096, 14336) and md.fused_geometry_ok(64, 128)
    assert not md.fused_geometry_ok(32, 16)
    assert not md.fused_geometry_ok(4096, 14336 + 32)


def test_fused_moe_mlp_is_forward_only():
    """Once forward-only, the fused pipeline now has the reference's
    backward: without grad it runs the forward alone, and an all-foreign
    plan (a shard that owns no pair) gives exactly 0 out and exactly 0
    gradients, not NaN (mirrors the reference's
    ``test_grads_finite_for_all_foreign``)."""
    xf, w_gu, w_down, experts, gates, (t, h, e, k, m) = _problem(seed=3)
    tp = md.build_plan(torch.from_numpy(experts), t, e, k)
    x, wg, wd, gt = _t(xf, w_gu, w_down, gates)
    with torch.no_grad():
        out = md.fused_moe_mlp(x, wg, wd, gt, tp)
    assert out.shape == (t * k, h) and torch.isfinite(out).all()
    assert not out.requires_grad
    foreign = md.build_plan(torch.full((t * k,), e + 1, dtype=torch.int32),
                            t, e, k, tile_rows=8)
    leaves = [a.clone().requires_grad_() for a in (x, wg, wd, gt)]
    out = md.fused_moe_mlp(*leaves, foreign)
    grads = torch.autograd.grad(out.sum(), leaves)
    assert out.sum().item() == 0.0
    for g in grads:
        assert (g == 0).all()


@pytest.mark.parametrize("case", ["random", "foreign"])
def test_fused_moe_mlp_grads_match_jax_custom_vjp(case):
    """The port's ``FusedMoeMlpFunction`` backward (plain versions on the
    CPU) against JAX's custom VJP with its kernels in interpret mode, for
    every differentiable input; half the pairs foreign in one case."""
    xf, w_gu, w_down, experts, gates, (t, h, e, k, m) = _problem(
        seed=8, case=case)
    jp, tp = _plans(experts, t, e, k, 8)
    cot = np.random.RandomState(9).randn(t * k, h).astype(np.float32)
    jgrads = jax.grad(
        lambda *a: jnp.sum(jmd.fused_moe_mlp(
            *a, jp, force_pallas=True, interpret=True) * cot),
        argnums=(0, 1, 2, 3),
    )(*[jnp.asarray(a) for a in (xf, w_gu, w_down, gates)])
    leaves = [a.requires_grad_() for a in _t(xf, w_gu, w_down, gates)]
    out = md.fused_moe_mlp(*leaves, tp)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for name, a, b in zip(("dxf", "dw_gu", "dw_down", "dgates"), grads,
                          jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=2e-4, err_msg=name)
    # The port's oracle gives the same gradients by autograd.
    leaves = [a.detach().clone().requires_grad_() for a in leaves]
    ref = torch.autograd.grad(md.reference_moe_mlp(*leaves, tp), leaves,
                              torch.from_numpy(cot))
    for name, a, b in zip(("dxf", "dw_gu", "dw_down", "dgates"), grads,
                          ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=2e-4, err_msg=name)


# The card tests' cases where groups meet the kernels' 64-deep stages and
# TMA's boxes (``tests/test_torch_kernels.py``): rows, K, N, group sizes.
GROUPED_EDGE_CASES = {
    "boundary_in_stage": (256, 128, 128, [37, 91, 0, 64]),
    "one_row_odd_start": (100, 64, 64, [1, 50, 30]),
    "n192_k192": (200, 192, 192, [7, 120, 50]),
}
GMM_K_TAIL_CASES = {
    "k32": (64, 32, 64, [20, 0, 30]),
    "k96": (150, 96, 128, [75, 1, 60]),
}


def _ragged_problem(case, seed=13):
    """(lhs [rows, K], rhs [E, K, N] as the port takes it, the same rhs
    as JAX takes it, group sizes): [24, 16] x [3, 16, 8] for the named
    small cases, the card's shapes for the edge cases."""
    rng = np.random.RandomState(seed)
    edge = {**GROUPED_EDGE_CASES, **GMM_K_TAIL_CASES}.get(case)
    if edge is not None:
        rows, k, n, sizes = edge
        lhs = rng.randn(rows, k).astype(np.float32)
        rhs = rng.randn(len(sizes), k, n).astype(np.float32)
        return lhs, rhs, torch.from_numpy(rhs), np.array(sizes, np.int32)
    lhs = rng.randn(24, 16).astype(np.float32)
    rhs = rng.randn(3, 16, 8).astype(np.float32)
    sizes = {"ragged": [10, 0, 9],          # an empty group, 5 rows past
             "aligned": [8, 8, 8],
             "tail": [6, 7, 3]}[case if case != "transposed" else "ragged"]
    port_rhs = torch.from_numpy(rhs)
    if case == "transposed":
        # The transposed view of a stored [E, N, K] (no copy).
        port_rhs = torch.from_numpy(
            np.ascontiguousarray(rhs.transpose(0, 2, 1))).transpose(1, 2)
        assert not port_rhs.is_contiguous()
    return lhs, rhs, port_rhs, np.array(sizes, np.int32)


@pytest.mark.parametrize("case", ["ragged", "transposed", "aligned", "tail",
                                  *GROUPED_EDGE_CASES, *GMM_K_TAIL_CASES])
def test_grouped_matmul_cases_match_ragged_dot(case):
    lhs, rhs, port_rhs, sizes = _ragged_problem(case)
    ref = np.asarray(jax.lax.ragged_dot(jnp.asarray(lhs), jnp.asarray(rhs),
                                        jnp.asarray(sizes)))
    out = md.grouped_matmul(torch.from_numpy(lhs), port_rhs,
                            torch.from_numpy(sizes))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert (out[int(sizes.sum()):] == 0).all()


@pytest.mark.parametrize("case", ["ragged", "transposed"])
def test_grouped_matmul_grads_match_ragged_dot(case):
    """``GroupedMatmulFunction``'s VJP (dlhs = gmm(dout, rhs^T), drhs =
    tgmm(lhs, dout)) against ``jax.grad`` of ``lax.ragged_dot``."""
    lhs, rhs, port_rhs, sizes = _ragged_problem(case, seed=14)
    cot = np.random.RandomState(15).randn(24, 8).astype(np.float32)
    jl, jr = jax.grad(
        lambda a, b: jnp.sum(jax.lax.ragged_dot(a, b, jnp.asarray(sizes))
                             * cot), argnums=(0, 1),
    )(jnp.asarray(lhs), jnp.asarray(rhs))
    tl = torch.from_numpy(lhs).requires_grad_()
    tr = port_rhs.requires_grad_()
    out = md.grouped_matmul(tl, tr, torch.from_numpy(sizes))
    dl, dr = torch.autograd.grad(out, (tl, tr), torch.from_numpy(cot))
    np.testing.assert_allclose(dl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(dr.numpy(), np.asarray(jr), **TOL)
    assert (dl[int(sizes.sum()):] == 0).all()
    assert (dr[1] == 0).all()                       # the empty group


def test_grouped_weight_grad_matches_jax_fallback():
    """Mirrors the reference's ``test_weight_grad_reference``, against its
    fallback, with row groups given and derived from the sizes."""
    rng = np.random.RandomState(15)
    rows, kk, nn, e = 24, 8, 6, 3
    lhs = rng.randn(rows, kk).astype(np.float32)
    rhs = rng.randn(rows, nn).astype(np.float32)
    sizes = np.array([8, 8, 8], np.int32)
    row_group = np.repeat(np.arange(e), 8).astype(np.int32)
    ref = np.asarray(jmd.grouped_weight_grad(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(sizes),
        jnp.asarray(row_group), e, use_pallas=False))
    tl, tr, ts = _t(lhs, rhs, sizes)
    for rg in (torch.from_numpy(row_group), None):
        out = md.grouped_weight_grad(tl, tr, ts, rg, e)
        assert out.dtype == torch.float32 and out.shape == (e, kk, nn)
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
    for g in range(e):
        sl = slice(8 * g, 8 * (g + 1))
        np.testing.assert_allclose(ref[g], lhs[sl].T @ rhs[sl], **TOL)
    # Ragged sizes with an empty group and rows past the end: those rows
    # add nothing, the empty group is 0.
    ragged = torch.tensor([10, 0, 9], dtype=torch.int32)
    out = md.grouped_weight_grad(tl, tr, ragged, None, e)
    np.testing.assert_allclose(out[0].numpy(), lhs[:10].T @ rhs[:10], **TOL)
    assert (out[1] == 0).all()
    np.testing.assert_allclose(out[2].numpy(), lhs[10:19].T @ rhs[10:19],
                               **TOL)


@pytest.mark.parametrize("case", list(GROUPED_EDGE_CASES))
def test_grouped_weight_grad_edge_cases_match_jax_fallback(case):
    """The card's tgmm edge cases against the reference's fallback: rows
    past the last group (row group -1 there) add nothing, an empty group
    is 0."""
    rows, kk, nn, sizes = GROUPED_EDGE_CASES[case]
    rng = np.random.RandomState(16)
    lhs = rng.randn(rows, kk).astype(np.float32)
    rhs = rng.randn(rows, nn).astype(np.float32)
    sizes = np.array(sizes, np.int32)
    bounds = np.cumsum(sizes)
    row_group = np.searchsorted(bounds, np.arange(rows), side="right")
    row_group = np.where(row_group < len(sizes), row_group, -1)
    ref = np.asarray(jmd.grouped_weight_grad(
        jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(sizes),
        jnp.asarray(row_group.astype(np.int32)), len(sizes),
        use_pallas=False))
    tl, tr, ts = _t(lhs, rhs, sizes)
    out = md.grouped_weight_grad(tl, tr, ts, None, len(sizes))
    assert out.dtype == torch.float32 and out.shape == (len(sizes), kk, nn)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    for g, size in enumerate(sizes):
        assert bool((out[g] == 0).all()) == (size == 0), g


def _quantized(w_gu, w_down):
    """The reference's int8 expert stacks of ``_problem``'s weights
    (contraction axes H and M) as numpy (q, scale) pairs."""
    from k8s_dra_driver_tpu.models.quant import quantize_tensor

    return [tuple(np.array(a) for a in (qt.q, qt.scale))
            for qt in (quantize_tensor(jnp.asarray(w_gu), 1),
                       quantize_tensor(jnp.asarray(w_down), 1))]


@pytest.mark.parametrize("case", ["random", "skew", "foreign"])
def test_each_int8_kernel_matches_its_pallas_kernel(case):
    """The int8 branches of K7 and K8: the port's wrappers (plain versions
    on the CPU) against ``_gateup_pallas``/``_down_combine_pallas`` with
    int8 weights and their scales, in interpret mode, on the same plan;
    sentinel rows and foreign slots exactly 0."""
    xf, w_gu, w_down, experts, gates, (t, h, e, k, m) = _problem(
        seed=11, case=case)
    (q_gu, s_gu), (q_dn, s_dn) = _quantized(w_gu, w_down)
    assert s_gu.shape == (e, 1, 2, m) and s_dn.shape == (e, 1, h)
    jp, tp = _plans(experts, t, e, k, 8)
    jact = jmd._gateup_pallas(jnp.asarray(xf), jnp.asarray(q_gu),
                              jnp.asarray(s_gu), jp, True)
    x, qg, sg, qd, sd, gt = _t(xf, q_gu, s_gu, q_dn, s_dn, gates)
    before = (md.moe_gateup.launches, md.moe_gateup_int8.launches)
    act = md.moe_gateup(x, qg, tp, sg)
    assert (md.moe_gateup.launches, md.moe_gateup_int8.launches) == before
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), **TOL)
    assert (act[tp.row_ids >= t] == 0).all()
    jgates_pad = jnp.take(jnp.asarray(gates), jp.pair_ids, mode="fill",
                          fill_value=0.0)[:, None]
    jy = jmd._down_combine_pallas(jact, jnp.asarray(q_dn), jnp.asarray(s_dn),
                                  jgates_pad, jp, True)
    gates_pad = md._take_rows(gt, tp.pair_ids)
    y = md.moe_down_combine(act, qd, gates_pad, tp, sd)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert (y[torch.from_numpy(experts >= e)] == 0).all()
    np.testing.assert_array_equal(
        md.moe_down_combine_int8(act, qd, sd, gates_pad, tp).numpy(),
        y.numpy())


@pytest.mark.parametrize("case", ["random", "foreign"])
def test_quantized_fused_moe_mlp_matches_jax(case):
    """``fused_moe_mlp`` on int8 ``QuantTensor`` experts (forward only)
    against the reference's quantized ``fused_moe_mlp`` (kernels in
    interpret mode) and its quantized oracle; the port's oracle (the
    primitive path's int8 grouped product) against the reference's."""
    from k8s_dra_driver_tpu.models.quant import QuantTensor as JQuant
    from k8s_dra_driver_tpu_torch.models.quant import QuantTensor

    xf, w_gu, w_down, experts, gates, (t, h, e, k, m) = _problem(
        seed=12, case=case)
    (q_gu, s_gu), (q_dn, s_dn) = _quantized(w_gu, w_down)
    jp, tp = _plans(experts, t, e, k, 8)
    jw = [JQuant(q=jnp.asarray(q), scale=jnp.asarray(s))
          for q, s in ((q_gu, s_gu), (q_dn, s_dn))]
    tw = [QuantTensor(*_t(q, s)) for q, s in ((q_gu, s_gu), (q_dn, s_dn))]
    jx, jg = jnp.asarray(xf), jnp.asarray(gates)
    x, gt = _t(xf, gates)
    jfused = np.asarray(jmd.fused_moe_mlp(jx, *jw, jg, jp, force_pallas=True,
                                          interpret=True))
    jref = np.asarray(jmd.reference_moe_mlp(jx, *jw, jg, jp))
    tfused = md.fused_moe_mlp(x, *tw, gt, tp)
    assert not tfused.requires_grad
    tref = md.reference_moe_mlp(x, *tw, gt, tp).numpy()
    np.testing.assert_allclose(tfused.numpy(), jfused, **TOL)
    np.testing.assert_allclose(tref, jref, **TOL)
    np.testing.assert_allclose(
        md.fused_moe_mlp(x, *tw, gt, tp, use_kernels=False).numpy(), jfused,
        **TOL)
    foreign = experts >= e
    assert (tfused.numpy()[foreign] == 0).all()


def test_grouped_matmul_int8_matches_ragged_dot_int8():
    """An int8 ``QuantTensor`` rhs: the reference's ``ragged_dot`` int8
    branch (f32 product, per-row group scale), rows past the groups 0."""
    from k8s_dra_driver_tpu.models.quant import quantize_tensor as jquant
    from k8s_dra_driver_tpu_torch.models.quant import quantize_tensor

    rng = np.random.RandomState(14)
    lhs = rng.randn(24, 16).astype(np.float32)
    rhs = rng.randn(3, 16, 8).astype(np.float32)
    sizes = np.array([10, 0, 9], np.int32)
    ref = np.asarray(jmd.grouped_matmul(jnp.asarray(lhs),
                                        jquant(jnp.asarray(rhs), 1),
                                        jnp.asarray(sizes)))
    lhs_t, rhs_t, sizes_t = _t(lhs, rhs, sizes)
    out = md.grouped_matmul(lhs_t, quantize_tensor(rhs_t, 1), sizes_t)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert (out[19:] == 0).all()
