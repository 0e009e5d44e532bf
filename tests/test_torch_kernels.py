"""The port's hand-written kernels against their plain PyTorch versions,
on the card. Imports no JAX, so it runs on the machine with the GPU:

    python -m pytest tests/test_torch_kernels.py -q

Without a CUDA device every test here skips (the kernels have no CPU
mode; the plain versions are held against the JAX package by
``tests/test_torch_ops.py``). Tolerances, bf16: paged attention max abs
error 2e-2 and mean 2e-3 (bf16 output rounding and another summation
order), RMSNorm 1e-2 relative to the largest output; flash outputs and
gradients, and K7's output, within 2% of the plain version's largest
value and 1% of its mean magnitude (bf16 rounding of p, dS and the
outputs; f32 sums in another order), K8's f32 output within 1e-3 and
1e-4 of them (only the f32 summation order differs), lse within 1e-3;
the MoE kernels' sentinel rows and slots of no live pair exactly 0. The
grouped matmul ``gmm`` (bf16 out) is held to the bf16 2% / 1%, ``tgmm``
(f32 out, f32 sums) to K8's 1e-3 / 1e-4; rows past the groups exactly 0.
Gradients through ``GroupedMatmulFunction`` and ``FusedMoeMlpFunction``
(bf16 outputs of bf16 products) are held to 2% / 1%. The int8 branches
(K2/K3 on int8 pools with per-position scales, K7/K8 on int8 experts with
per-column scales) are held to their bf16 branches' limits: the kernel and
its plain version read the same int8 data. ``int8_matmul`` (bf16 out, f32
sums in another order, split K summed in another order again) is held to
the bf16 2% / 1%. The split decode kernel and its merge are also held to
the plain split-and-merge (``paged_decode_split_reference``) at the
wrapper's own split count; poisoned pool rows past the window (and, with
int8, their scales) must leave every paged kernel's output bitwise
unchanged, two calls on the same inputs must agree bitwise, and no
wrapper may synchronise with the host.
"""

import pytest
import torch

from k8s_dra_driver_tpu_torch.ops import attention as att
from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md
from k8s_dra_driver_tpu_torch.ops import norms
from k8s_dra_driver_tpu_torch.ops._device import sm_count


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _paged(dev, b_starts, t, hq, hkv, d, bs, nbps, seed=0):
    """Random pools (one scratch row past the blocks), scrambled tables,
    contiguous windows at the given starts."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b = len(b_starts)
    nb = b * nbps + 3
    q = torch.randn(b, hq, t, d, generator=g, device=dev).bfloat16()
    k = torch.randn(hkv, nb * bs + 1, d, generator=g, device=dev).bfloat16()
    v = torch.randn(hkv, nb * bs + 1, d, generator=g, device=dev).bfloat16()
    tables = torch.randperm(nb, generator=g, device=dev)[: b * nbps]
    tables = tables.reshape(b, nbps).to(torch.int32).contiguous()
    pos = (torch.tensor(b_starts, device=dev)[:, None]
           + torch.arange(t, device=dev)[None, :])
    return q, k, v, tables, pos


def _close(out, ref):
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= 2e-2, err.max().item()
    assert err.mean().item() <= 2e-3, err.mean().item()


# The decode cases below: G 1, 2, 4, 8; head_dim 64 and 128; block_size 8,
# 16 and 64; lengths 1, on 32-position split-alignment and 64-position
# edges and one past them; one sequence at 8B's longest window (8191: 33
# splits on 132 SMs) and one a position past a split edge (257, 5 splits).
_DECODE_CASES = [
    (32, 8, 128, 16, (0, 31, 32, 700)),   # Llama-3-8B heads, tile edges
    (8, 1, 128, 8, (5, 64)),              # G=8 (the decode kernel's most)
    (4, 4, 64, 64, (0, 200)),             # MHA, head_dim 64, block 64
    (32, 8, 128, 16, (8190,)),            # one long sequence: the split path
    (32, 8, 128, 16, (256,)),             # valid_len 257: past a split edge
    (16, 2, 128, 16, (0,)),               # valid_len 1 alone, G=8
    (16, 8, 64, 8, (63, 64, 127, 31)),    # G=2, head_dim 64, edges
    (12, 4, 128, 64, (95, 96, 4000)),     # G=3, block 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,d,bs,starts", _DECODE_CASES)
def test_decode_matches_plain(dev, hq, hkv, d, bs, starts):
    nbps = -(-(max(starts) + 1) // bs)
    q, k, v, tables, pos = _paged(dev, starts, 1, hq, hkv, d, bs, nbps)
    vlen = (pos[:, 0] + 1).to(torch.int32)
    before = att.paged_decode_attention.launches
    out = att.paged_decode_attention(q[:, :, 0], k, v, tables, vlen, bs)
    ref = att.paged_attention_reference(q, k, v, tables, pos, bs)[:, :, 0]
    splits = att.decode_splits(len(starts), hkv, nbps, bs, sm_count(dev))
    split_ref = att.paged_decode_split_reference(q[:, :, 0], k, v, tables,
                                                 vlen, bs, splits)
    torch.cuda.synchronize()
    _close(out, ref)
    _close(out, split_ref)
    assert att.paged_decode_attention.launches == before + 1


# The prefill cases below: G 1, 2, 3, 4, 8; head_dim 64 and 128; block_size
# 4, 5, 8, 12, 16 and 64 (TMA boxes of 4, 1, 8, 4, 16 and 64 rows); T from 1;
# windows from 0, on and past 128-position tile edges, and one ending at
# position 8190 (8B's longest).
_PREFILL_CASES = [
    (128, 32, 8, 128, 16, (0, 256, 384, 572)),  # the engine's packed chunk
    (40, 8, 2, 128, 16, (0, 9, 70)),            # a partial last q tile
    (1, 32, 8, 128, 16, (0, 33)),               # T=1 through prefill
    (33, 4, 4, 64, 8, (3, 17)),                 # MHA, head_dim 64, bs 8
    (128, 32, 8, 128, 16, (8063,)),             # a window ending at 8190
    (100, 8, 1, 128, 64, (0, 127, 128)),        # G=8, block 64, tile edges
    (70, 8, 4, 64, 16, (1, 200)),               # G=2, head_dim 64
    (40, 6, 2, 64, 4, (3, 50)),                 # G=3, block 4
    (17, 4, 1, 128, 5, (0, 11)),                # G=4, block 5: 1-row boxes
    (64, 8, 2, 128, 12, (5, 130)),              # block 12: 4-row boxes
    (5, 32, 8, 128, 16, (515,)),                # a verify window (k 4), B 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("t,hq,hkv,d,bs,starts", _PREFILL_CASES)
def test_prefill_matches_plain(dev, t, hq, hkv, d, bs, starts):
    nbps = -(-(max(starts) + t) // bs)
    q, k, v, tables, pos = _paged(dev, starts, t, hq, hkv, d, bs, nbps)
    out = att.paged_prefill_attention(q, k, v, tables, pos, bs)
    ref = att.paged_attention_reference(q, k, v, tables, pos, bs)
    torch.cuda.synchronize()
    _close(out, ref)


@pytest.mark.cuda
def test_prefill_never_reads_past_the_window(dev):
    """Poisoning every pool row after each window's last position leaves
    the output bitwise unchanged."""
    starts, t, bs = (5, 21), 12, 16
    q, k, v, tables, pos = _paged(dev, starts, t, 8, 2, 128, bs, 4)
    out = att.paged_prefill_attention(q, k, v, tables, pos, bs)
    k2, v2 = k.clone(), v.clone()
    for i, s0 in enumerate(starts):
        for j in range(tables.shape[1]):
            for r in range(bs):
                if j * bs + r > s0 + t - 1:
                    row = int(tables[i, j]) * bs + r
                    k2[:, row] = 1e4
                    v2[:, row] = -1e4
    out2 = att.paged_prefill_attention(q, k2, v2, tables, pos, bs)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v, tables, pos = _paged(dev, (0, 3), 4, 8, 2, 128, 16, 2)
    with pytest.raises(TypeError, match="bf16"):
        att.paged_prefill_attention(q, k.to(torch.int8), v, tables, pos, 16)
    with pytest.raises(TypeError, match="int32"):
        att.paged_prefill_attention(q, k, v, tables.long(), pos, 16)
    with pytest.raises(ValueError, match="contiguous"):
        att.paged_prefill_attention(q.transpose(2, 3).contiguous()
                                    .transpose(2, 3), k, v, tables, pos, 16)
    with pytest.raises(ValueError, match="CUDA"):
        att.paged_prefill_attention(q, k.cpu(), v, tables, pos, 16)
    with pytest.raises(ValueError, match="head_dim"):
        att.paged_decode_attention(q[:, :, 0, :32].contiguous(), k, v,
                                   tables, (pos[:, 0] + 1).int(), 16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,dtype", [
    (512, 4096, torch.bfloat16),    # the 8B prefill chunk
    (8, 4096, torch.bfloat16),      # the 8B decode step
    (5, 1000, torch.float32),       # a width that is not a power of two
    (1, 2048, torch.bfloat16),      # the 1b draft's step
    (5, 4096, torch.bfloat16),      # the 8B verify window
    (8192, 4096, torch.bfloat16),
    (16384, 4096, torch.bfloat16),  # the 8b-L8 train step
    (8, 64, torch.float32),         # the tiny preset
    (512, 64, torch.float32),
    (8, 768, torch.float16),        # the 160m preset
    (512, 768, torch.float16),
    (700, 1000, torch.float32),     # a ragged last warp
    (300, 4100, torch.bfloat16),    # 4 slots a thread, a tail
    (3, 77, torch.bfloat16),        # no whole 16-byte word a row
    (3, 10000, torch.bfloat16),     # wider than a CTA: a cluster of 2
    (2, 16384, torch.float32),
    (4, 8200, torch.float16),       # a cluster of 2, a tail
    (3, 20000, torch.bfloat16),     # a cluster of 4
    (2, 65536, torch.bfloat16),     # a cluster of 8, the widest row
])
def test_rmsnorm_matches_plain(dev, rows, width, dtype):
    """Each launch ``norms.plan`` picks (one CTA a row up to width 8192, a
    cluster of 2, 4 or 8 CTAs a row past it) against the plain version,
    1e-2 of the largest output, and the same bits on a second call."""
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    x = torch.randn(rows, width, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(width, generator=g, device=dev)).to(dtype)
    before = norms.rmsnorm.launches
    out = norms.rmsnorm(x, w, 1e-5)
    again = norms.rmsnorm(x, w, 1e-5)
    ref = norms.rmsnorm_reference(x, w, 1e-5).float()
    torch.cuda.synchronize()
    assert norms.rmsnorm.launches == before + 2
    assert out.dtype == dtype and torch.equal(out, again)
    out = out.float()
    assert torch.isfinite(out).all()
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.float16, torch.bfloat16)])
@pytest.mark.parametrize("rows", [8, 512])
def test_rmsnorm_takes_a_weight_of_another_dtype(dev, rows, xdt, wdt):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = torch.randn(rows, 4096, generator=g, device=dev).to(xdt)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(wdt)
    out = norms.rmsnorm(x, w, 1e-6).float()
    ref = norms.rmsnorm_reference(x, w, 1e-6).float()
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-2


@pytest.mark.cuda
def test_rmsnorm_is_captured_in_a_graph(dev):
    """Both launches (a CTA and a cluster a row) under a CUDA graph: no
    host sync, the replay equal to an eager call."""
    for rows, d in ((8, 4096), (512, 4096), (8, 16384)):
        x = torch.randn(rows, d, device=dev).bfloat16()
        w = torch.randn(d, device=dev).bfloat16()
        eager = norms.rmsnorm(x, w)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = norms.rmsnorm(x, w)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), (rows, d)


def _flash_inputs(dev, b, hq, hkv, s, d, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    return (rand(b, hq, s, d), rand(b, hkv, s, d), rand(b, hkv, s, d),
            rand(b, hq, s, d))


def _rel_close(name, out, ref, rel_max=2e-2, rel_mean=1e-2):
    """bf16 outputs against the plain version: the largest error within 2%
    of the largest value, the mean error within 1% of the mean value."""
    assert torch.isfinite(out.float()).all(), name
    err = (out.float() - ref.float()).abs()
    top, avg = ref.float().abs().max(), ref.float().abs().mean()
    assert err.max() <= rel_max * top, (name, err.max().item(), top.item())
    assert err.mean() <= rel_mean * avg, (name, err.mean().item(), avg.item())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
# 40: shorter than one tile; 130, 200, 1000: a ragged last tile.
@pytest.mark.parametrize("s", [40, 128, 130, 200, 512, 1000])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])   # G = 1 and 4
@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernels_match_plain(dev, d, hq, hkv, s, causal):
    q, k, v, do = _flash_inputs(dev, 2, hq, hkv, s, d)
    scale = d ** -0.5
    launches = (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
                att.flash_bwd_dq.launches)
    out, lse = att.flash_fwd(q, k, v, causal, scale)
    ref_out, ref_lse = att.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * ref_out.float()).sum(-1)
    dk, dv = att.flash_bwd_dkdv(q, k, v, do, ref_lse, delta, causal, scale)
    dq = att.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale)
    ref_dk, ref_dv = att.flash_bwd_dkdv_reference(q, k, v, do, ref_lse,
                                                  delta, causal, scale)
    ref_dq = att.flash_bwd_dq_reference(q, k, v, do, ref_lse, delta, causal,
                                        scale)
    torch.cuda.synchronize()
    assert (att.flash_fwd.launches, att.flash_bwd_dkdv.launches,
            att.flash_bwd_dq.launches) == tuple(n + 1 for n in launches)
    assert out.dtype == dk.dtype == dq.dtype == torch.bfloat16
    assert lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    for name, a, b_ in (("out", out, ref_out), ("dk", dk, ref_dk),
                        ("dv", dv, ref_dv), ("dq", dq, ref_dq)):
        _rel_close(name, a, b_)


@pytest.mark.cuda
def test_flash_attention_autograd_matches_plain(dev):
    """Gradients through the autograd.Function (kernels both ways) equal
    autograd through the plain attention with repeated kv heads."""
    q, k, v, do = _flash_inputs(dev, 2, 8, 2, 256, 128, seed=3)
    grads = []
    for use_kernels in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        if use_kernels:
            out = att.flash_attention(*leaves, causal=True)
        else:
            out = att.attention_reference(
                leaves[0], att._repeat_kv(leaves[1], 4),
                att._repeat_kv(leaves[2], 4), causal=True)
        grads.append(torch.autograd.grad(out, leaves, do))
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), *grads):
        _rel_close(name, a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_dq_matches_plain_at_the_training_length(dev, causal):
    """K6 alone at S 2048, G 4 (the 8b-L8 step's sequence and grouping)
    against ``flash_bwd_dq_reference``."""
    q, k, v, do = _flash_inputs(dev, 1, 8, 2, 2048, 128, seed=5)
    scale = 128 ** -0.5
    out, lse = att.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1)
    before = att.flash_bwd_dq.launches
    dq = att.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    ref = att.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert att.flash_bwd_dq.launches == before + 1
    _rel_close("dq", dq, ref)


@pytest.mark.cuda
def test_flash_bwd_dq_repeats_bitwise(dev):
    """Two K6 calls on the same inputs give the same bits (dQ is summed in
    registers, no atomics), at a ragged S with G 4."""
    q, k, v, do = _flash_inputs(dev, 2, 8, 2, 1000, 128, seed=6)
    out, lse = att.flash_fwd_reference(q, k, v, True, 128 ** -0.5)
    delta = (do.float() * out.float()).sum(-1)
    first = att.flash_bwd_dq(q, k, v, do, lse, delta, True)
    second = att.flash_bwd_dq(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_rmsnorm_grads_match_plain(dev):
    """The kernel's output carries autograd history on the card: x and
    weight gradients (the gradient kernel) equal those through the plain
    version."""
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    x = torch.randn(4, 128, 4096, generator=g, device=dev).bfloat16()
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).bfloat16()
    dy = torch.randn(4, 128, 4096, generator=g, device=dev).bfloat16()
    grads = []
    before = norms.rmsnorm_backward.launches
    for fn in (norms.rmsnorm, norms.rmsnorm_reference):
        xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xt, wt, 1e-5)
        assert y.requires_grad
        grads.append(torch.autograd.grad(y, (xt, wt), dy))
    torch.cuda.synchronize()
    assert norms.rmsnorm_backward.launches == before + 1
    for name, a, b_ in zip(("dx", "dw"), *grads):
        assert a.abs().max() > 0, name
        _rel_close(name, a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width,xdt,wdt", [
    (8192, 4096, torch.bfloat16, torch.bfloat16),
    (16384, 4096, torch.bfloat16, torch.bfloat16),   # the 8b-L8 step
    (512, 4096, torch.bfloat16, torch.bfloat16),
    (5, 1000, torch.float32, torch.float32),
    (1, 4096, torch.bfloat16, torch.bfloat16),
    (700, 768, torch.float16, torch.float16),
    (64, 64, torch.float32, torch.float32),
    (300, 8192, torch.bfloat16, torch.float32),      # 4 slots a thread
    (9, 77, torch.bfloat16, torch.bfloat16),         # no whole word a row
])
def test_rmsnorm_backward_matches_plain(dev, rows, width, xdt, wdt):
    """The gradient kernel against ``rmsnorm_backward_reference`` by the
    bf16 2% / 1% rule, and the same bits on a second call (dw's partial
    sums are summed in a fixed order, no atomics)."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    x = torch.randn(rows, width, generator=g, device=dev).to(xdt)
    w = (1 + 0.1 * torch.randn(width, generator=g, device=dev)).to(wdt)
    dy = torch.randn(rows, width, generator=g, device=dev).to(xdt)
    before = norms.rmsnorm_backward.launches
    dx, dw = norms.rmsnorm_backward(x, w, dy, 1e-5)
    dx2, dw2 = norms.rmsnorm_backward(x, w, dy, 1e-5)
    ref_dx, ref_dw = norms.rmsnorm_backward_reference(x, w, dy, 1e-5)
    torch.cuda.synchronize()
    assert norms.rmsnorm_backward.launches == before + 2
    assert dx.dtype == xdt and dw.dtype == wdt
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    _rel_close("dx", dx, ref_dx)
    _rel_close("dw", dw, ref_dw)


@pytest.mark.cuda
def test_flash_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v, do = _flash_inputs(dev, 1, 4, 2, 64, 64)
    lse = torch.zeros(1, 4, 64, device=dev)
    with pytest.raises(TypeError, match="bf16"):
        att.flash_fwd(q.float(), k, v)
    with pytest.raises(TypeError, match="float32"):
        att.flash_bwd_dq(q, k, v, do, lse.bfloat16(), lse)
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="CUDA"):
        att.flash_bwd_dkdv(q, k, v, do, lse.cpu(), lse)
    with pytest.raises(ValueError, match="contiguous"):
        att.flash_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        att.flash_bwd_dkdv(q, k, v, do.transpose(1, 2), lse, lse)
    with pytest.raises(ValueError, match="head_dim"):
        att.flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                      v[..., :32].contiguous())
    with pytest.raises(ValueError, match="query heads"):
        att.flash_fwd(q[:, :3].contiguous(), k, v)


def _moe_problem(dev, t, h, m, e=8, k=2, tile=8, case="random", seed=0):
    """Tokens, expert weights (normal / sqrt(fan_in), bf16), gates and the
    plan of one routed MoE layer: "random" experts, "skew" (one expert
    holds every pair, the others are empty) or "foreign" (half the pairs
    routed to experts outside the plan)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    xf = torch.randn(t, h, generator=g, device=dev).bfloat16()
    w_gu = (torch.randn(e, h, 2, m, generator=g, device=dev)
            / h ** 0.5).bfloat16()
    w_down = (torch.randn(e, m, h, generator=g, device=dev)
              / m ** 0.5).bfloat16()
    experts = torch.randint(0, e, (t * k,), generator=g, device=dev)
    if case == "skew":
        experts = torch.full_like(experts, e - 1)
    elif case == "foreign":
        foreign = torch.rand(t * k, generator=g, device=dev) < 0.5
        experts = torch.where(foreign, torch.full_like(experts, e + 7),
                              experts)
    gates = torch.rand(t * k, generator=g, device=dev)
    plan = md.build_plan(experts.int(), t, e, k, tile_rows=tile)
    return xf, w_gu, w_down, gates, plan


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "skew", "foreign"])
@pytest.mark.parametrize("t,h,m,tile", [
    (24, 64, 128, 8),          # tiny widths, the decode tile
    (40, 64, 128, 128),        # tiny widths, the prefill tile
    (8, 4096, 14336, 8),       # Mixtral-8x7B decode step
    (512, 4096, 14336, 128),   # Mixtral-8x7B packed prefill chunk
])
def test_moe_kernels_match_plain(dev, t, h, m, tile, case):
    xf, w_gu, w_down, gates, plan = _moe_problem(dev, t, h, m, tile=tile,
                                                 case=case)
    before = (md.moe_gateup.launches, md.moe_down_combine.launches)
    act = md.moe_gateup(xf, w_gu, plan)
    ref_act = md.moe_gateup_reference(xf, w_gu, plan)
    gates_pad = md._take_rows(gates, plan.pair_ids).contiguous()
    y = md.moe_down_combine(ref_act, w_down, gates_pad, plan)
    ref_y = md.moe_down_combine_reference(ref_act, w_down, gates_pad, plan)
    torch.cuda.synchronize()
    assert (md.moe_gateup.launches, md.moe_down_combine.launches) == (
        before[0] + 1, before[1] + 1)
    assert act.dtype == torch.bfloat16 and y.dtype == torch.float32
    _rel_close("act", act, ref_act)
    # K8's output is f32, summed in f32: only the summation order differs,
    # so a bf16 accumulator or bf16 output (~2-4e-3) fails these limits.
    _rel_close("y_pairs", y, ref_y, rel_max=1e-3, rel_mean=1e-4)
    # Sentinel rows of act and slots of no live pair are exactly 0.
    sentinel = plan.row_ids >= plan.n_tokens
    assert sentinel.any()
    assert (act[sentinel] == 0).all()
    dead = plan.slot_of_pair >= plan.r_pad
    if case == "foreign":
        assert dead.any()
    assert (y[dead] == 0).all()
    assert (y[~dead].abs().sum(-1) > 0).all()


@pytest.mark.cuda
def test_moe_kernels_all_sentinel_plan(dev):
    """A plan whose every pair is foreign: every tile is all sentinels,
    so K7 writes zeros without reading weights and K8 writes nothing."""
    xf, w_gu, w_down, gates, _ = _moe_problem(dev, 16, 64, 128)
    plan = md.build_plan(torch.full((32,), 9, dtype=torch.int32,
                                    device=dev), 16, 8, 2, tile_rows=8)
    act = md.moe_gateup(xf, w_gu, plan)
    gates_pad = md._take_rows(gates, plan.pair_ids).contiguous()
    y = md.moe_down_combine(act, w_down, gates_pad, plan)
    torch.cuda.synchronize()
    assert (act == 0).all() and (y == 0).all()


@pytest.mark.cuda
def test_fused_moe_mlp_runs_the_kernels(dev):
    xf, w_gu, w_down, gates, plan = _moe_problem(dev, 24, 64, 128, tile=8)
    before = md.moe_gateup.launches
    out = md.fused_moe_mlp(xf, w_gu, w_down, gates, plan)
    plain = md.fused_moe_mlp(xf, w_gu, w_down, gates, plan,
                             use_kernels=False)
    torch.cuda.synchronize()
    assert md.moe_gateup.launches == before + 1
    assert md.dispatch_impl_label(64, 128, device=dev) == "fused"
    _rel_close("fused", out, plain)


@pytest.mark.cuda
def test_moe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    xf, w_gu, w_down, gates, plan = _moe_problem(dev, 24, 64, 128, tile=8)
    gates_pad = md._take_rows(gates, plan.pair_ids).contiguous()
    with pytest.raises(TypeError, match="bf16"):
        md.moe_gateup(xf, w_gu.float(), plan)
    with pytest.raises(ValueError, match="CUDA"):
        md.moe_gateup(xf, w_gu.cpu(), plan)
    with pytest.raises(ValueError, match="multiples of 64"):
        md.moe_gateup(xf[:, :48].contiguous(),
                      w_gu[:, :48].contiguous(), plan)
    with pytest.raises(TypeError, match="float32"):
        md.moe_down_combine(md.moe_gateup(xf, w_gu, plan), w_down,
                            gates_pad.bfloat16(), plan)
    big = md.build_plan(torch.zeros(48, dtype=torch.int32, device=dev), 24,
                        8, 2, tile_rows=256)
    with pytest.raises(ValueError, match="row tile"):
        md.moe_gateup(xf, w_gu, big)
    # MoE training is ported: the grouped matmul and the fused pipeline's
    # backward run on the card (their refusals: below).
    out = md.grouped_matmul(xf, w_down[:, :64].contiguous(),
                            plan.sizes_aligned)
    assert out.shape == (xf.shape[0], 64)
    leaf = xf.clone().requires_grad_()
    (dx,) = torch.autograd.grad(
        md.fused_moe_mlp(leaf, w_gu, w_down, gates, plan).sum(), leaf)
    torch.cuda.synchronize()
    assert dx.shape == xf.shape and torch.isfinite(dx.float()).all()


def _grouped_problem(dev, rows, k, n, sizes, e=None, seed=0):
    """bf16 lhs [rows, K], rhs [E, K, N] (normal / sqrt(K)) and int32
    group sizes on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e = len(sizes) if e is None else e
    lhs = torch.randn(rows, k, generator=g, device=dev).bfloat16()
    rhs = (torch.randn(e, k, n, generator=g, device=dev)
           / k ** 0.5).bfloat16()
    return lhs, rhs, torch.tensor(sizes, dtype=torch.int32, device=dev)


GROUPED_CASES = [
    # rows, K, N, group sizes
    (24, 64, 64, [10, 0, 9]),                      # ragged, empty, 5 past
    (300, 64, 128, [100, 28, 0, 150]),             # straddles, 22 past
    (1024, 128, 256, [128, 256, 0, 384, 256]),     # tile-aligned, none past
    (1100, 4096, 14336, [200, 0, 311, 150, 139, 0, 100, 50]),  # Mixtral
]

# Where groups meet the kernels' 64-deep stages (tgmm contracts over rows
# in stages of 64 from each group's first row) and TMA's boxes.
GROUPED_EDGE_CASES = [
    (256, 128, 128, [37, 91, 0, 64]),   # a boundary inside one stage
    (100, 64, 64, [1, 50, 30]),         # one-row group, odd start, 19 past
                                        # the last group in its last stage
    (200, 192, 192, [7, 120, 50]),      # N 192 (64-wide tiles); K 192
                                        # (tgmm's last K tile half past K)
]
# gmm takes K in steps of 32: a stage half filled by TMA's zero fill.
GMM_K_TAIL_CASES = [
    (64, 32, 64, [20, 0, 30]),          # K 32
    (150, 96, 128, [75, 1, 60]),        # K 96
]


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize(
    "rows,k,n,sizes", GROUPED_CASES + GROUPED_EDGE_CASES + GMM_K_TAIL_CASES)
def test_grouped_matmul_matches_plain(dev, rows, k, n, sizes, transposed):
    lhs, rhs, gs = _grouped_problem(dev, rows, k, n, sizes)
    if transposed:
        # The transposed view of a stored [E, N, K], as the backward
        # passes W^T: the kernel reads it in place.
        rhs = rhs.transpose(1, 2).contiguous().transpose(1, 2)
        assert not rhs.is_contiguous()
    before = md.grouped_matmul.launches
    out = md.grouped_matmul(lhs, rhs, gs)
    ref = md.grouped_matmul_reference(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert md.grouped_matmul.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (rows, n)
    _rel_close("gmm", out, ref)
    total = sum(sizes)
    assert (out[total:] == 0).all()
    assert (out[:total].float().abs().sum(-1) > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n,sizes", GROUPED_CASES + [
    (2200, 14336, 4096, [1100, 0, 1000]),           # dW_down's widths
] + GROUPED_EDGE_CASES)
def test_grouped_weight_grad_matches_plain(dev, rows, k, n, sizes):
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    lhs = torch.randn(rows, k, generator=g, device=dev).bfloat16()
    rhs = torch.randn(rows, n, generator=g, device=dev).bfloat16()
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    before = md.grouped_weight_grad.launches
    out = md.grouped_weight_grad(lhs, rhs, gs, None, len(sizes))
    ref = md.grouped_weight_grad_reference(
        lhs, rhs, md._row_groups(gs, rows), len(sizes))
    torch.cuda.synchronize()
    assert md.grouped_weight_grad.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (len(sizes), k, n)
    _rel_close("tgmm", out, ref, rel_max=1e-3, rel_mean=1e-4)
    for i, size in enumerate(sizes):
        assert (out[i] == 0).all() == (size == 0), i


@pytest.mark.cuda
def test_grouped_matmul_function_grads_match_plain(dev):
    """megablox's VJP on the card (gmm on a transposed view, tgmm) against
    the same Function over the plain versions."""
    lhs, rhs, gs = _grouped_problem(dev, 700, 256, 512,
                                    [300, 0, 250, 100], seed=2)
    cot = torch.randn(700, 512, device=dev).bfloat16()
    grads = []
    for use_kernels in (True, False):
        leaves = [x.clone().requires_grad_() for x in (lhs, rhs)]
        out = md.GroupedMatmulFunction.apply(*leaves, gs, use_kernels)
        grads.append(torch.autograd.grad(out, leaves, cot))
    torch.cuda.synchronize()
    for name, a, b in zip(("dlhs", "drhs"), *grads):
        assert a.dtype == torch.bfloat16, name
        _rel_close(name, a, b)
    assert (grads[0][0][650:] == 0).all() and (grads[0][1][1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "foreign"])
@pytest.mark.parametrize("t,h,m", [(40, 64, 128), (1024, 4096, 14336)])
def test_fused_moe_mlp_grads_match_plain(dev, t, h, m, case):
    """``FusedMoeMlpFunction``'s backward through gmm/tgmm against the
    same backward over the plain versions, on the same inputs and
    cotangent; the launch counters show 3 gmm and 2 tgmm."""
    xf, w_gu, w_down, gates, plan = _moe_problem(dev, t, h, m, tile=128,
                                                 case=case)
    cot = torch.randn(t * 2, h, device=dev)
    grads = []
    for use_kernels in (True, False):
        leaves = [x.clone().requires_grad_() for x in (xf, w_gu, w_down,
                                                       gates)]
        before = (md.grouped_matmul.launches,
                  md.grouped_weight_grad.launches)
        out = md.fused_moe_mlp(*leaves, plan, use_kernels=use_kernels)
        grads.append(torch.autograd.grad(out, leaves, cot))
        ran = (md.grouped_matmul.launches - before[0],
               md.grouped_weight_grad.launches - before[1])
        assert ran == ((3, 2) if use_kernels else (0, 0))
    torch.cuda.synchronize()
    for name, a, b in zip(("dxf", "dw_gu", "dw_down", "dgates"), *grads):
        assert a.abs().max() > 0, name
        _rel_close(name, a, b)


@pytest.mark.cuda
def test_grouped_wrappers_refuse_what_the_kernels_do_not_take(dev):
    lhs, rhs, gs = _grouped_problem(dev, 64, 64, 128, [32, 32])
    with pytest.raises(TypeError, match="bf16"):
        md.grouped_matmul(lhs.float(), rhs, gs)
    with pytest.raises(TypeError, match="int32"):
        md.grouped_matmul(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="CUDA"):
        md.grouped_matmul(lhs, rhs.cpu(), gs)
    with pytest.raises(ValueError, match="multiples"):
        md.grouped_matmul(lhs[:, :48].contiguous(),
                          rhs[:, :48].contiguous(), gs)
    with pytest.raises(ValueError, match="multiples"):
        md.grouped_matmul(lhs, rhs[..., :96].contiguous(), gs)
    with pytest.raises(ValueError, match="transposed view"):
        md.grouped_matmul(lhs, rhs[:, :, ::2], gs)
    with pytest.raises(TypeError, match="bf16"):
        md.grouped_weight_grad(lhs, lhs.float(), gs, None, 2)
    with pytest.raises(ValueError, match="multiples of 64"):
        md.grouped_weight_grad(lhs[:, :32].contiguous(), lhs, gs, None, 2)
    with pytest.raises(ValueError, match="CUDA"):
        md.grouped_weight_grad(lhs, lhs, gs.cpu(), None, 2)


# ---------------------------------------------------------------------------
# The int8 branches: K2/K3 over int8 pools, K7/K8 over int8 experts.
# ---------------------------------------------------------------------------


def _int8_paged(dev, starts, t, hq, hkv, d, bs, nbps, sentinel, seed=0):
    """``_paged``'s inputs with the pools quantized per position (the
    cache's own recipe) and, with ``sentinel``, every table entry past a
    window's last block set to 0."""
    from k8s_dra_driver_tpu_torch.models.decode import _quantize_kv

    q, k, v, tables, pos = _paged(dev, starts, t, hq, hkv, d, bs, nbps, seed)
    (k8, ks), (v8, vs) = _quantize_kv(k[None]), _quantize_kv(v[None])
    if sentinel:
        for i, s0 in enumerate(starts):
            tables[i, -(-(s0 + t) // bs):] = 0
    return q, k8[0], v8[0], ks[0], vs[0], tables, pos


@pytest.mark.cuda
@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("hq,hkv,d,bs,starts", _DECODE_CASES)
def test_int8_decode_matches_plain(dev, hq, hkv, d, bs, starts, sentinel):
    nbps = -(-(max(starts) + 1) // bs) + 1
    q, k, v, ks, vs, tables, pos = _int8_paged(dev, starts, 1, hq, hkv, d,
                                               bs, nbps, sentinel)
    vlen = (pos[:, 0] + 1).to(torch.int32)
    before = (att.paged_decode_attention.launches,
              att.paged_decode_int8.launches)
    out = att.paged_decode_attention(q[:, :, 0], k, v, tables, vlen, bs,
                                     k_scale=ks, v_scale=vs)
    ref = att.paged_attention_reference(q, k, v, tables, pos, bs,
                                        k_scale=ks, v_scale=vs)[:, :, 0]
    splits = att.decode_splits(len(starts), hkv, nbps, bs, sm_count(dev))
    split_ref = att.paged_decode_split_reference(
        q[:, :, 0], k, v, tables, vlen, bs, splits, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    _close(out, ref)
    _close(out, split_ref)
    assert (att.paged_decode_attention.launches,
            att.paged_decode_int8.launches) == (before[0], before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("t,hq,hkv,d,bs,starts", _PREFILL_CASES)
def test_int8_prefill_matches_plain(dev, t, hq, hkv, d, bs, starts,
                                    sentinel):
    nbps = -(-(max(starts) + t) // bs) + 1
    q, k, v, ks, vs, tables, pos = _int8_paged(dev, starts, t, hq, hkv, d,
                                               bs, nbps, sentinel)
    before = (att.paged_prefill_attention.launches,
              att.paged_prefill_int8.launches)
    out = att.paged_prefill_attention(q, k, v, tables, pos, bs, k_scale=ks,
                                      v_scale=vs)
    ref = att.paged_attention_reference(q, k, v, tables, pos, bs,
                                        k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    _close(out, ref)
    assert (att.paged_prefill_attention.launches,
            att.paged_prefill_int8.launches) == (before[0], before[1] + 1)


@pytest.mark.cuda
def test_int8_paged_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v, ks, vs, tables, pos = _int8_paged(dev, (0, 3), 4, 8, 2, 128,
                                               16, 2, False)
    with pytest.raises(TypeError, match="bf16"):        # int8, no scales
        att.paged_prefill_attention(q, k, v, tables, pos, 16)
    with pytest.raises(TypeError, match="float32"):
        att.paged_prefill_attention(q, k, v, tables, pos, 16,
                                    k_scale=ks.half(), v_scale=vs)
    with pytest.raises(TypeError, match="float32"):
        att.paged_prefill_attention(q, k, v, tables, pos, 16,
                                    k_scale=ks[:, :-1].contiguous(),
                                    v_scale=vs)
    with pytest.raises(TypeError, match="int8"):        # bf16 pools, scales
        att.paged_prefill_attention(q, k.bfloat16(), v.bfloat16(), tables,
                                    pos, 16, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="CUDA"):
        att.paged_prefill_attention(q, k, v, tables, pos, 16,
                                    k_scale=ks.cpu(), v_scale=vs)


def _run_paged(kernel, q, k, v, tables, pos, bs, scales):
    """One wrapper call: ``kernel`` "decode" or "prefill", ``scales`` the
    int8 pools' (k_scale, v_scale) or None."""
    sc = {} if scales is None else dict(k_scale=scales[0], v_scale=scales[1])
    if kernel == "decode":
        vlen = (pos[:, 0] + 1).to(torch.int32)
        return att.paged_decode_attention(q[:, :, 0].contiguous(), k, v,
                                          tables, vlen, bs, **sc)
    return att.paged_prefill_attention(q, k, v, tables, pos, bs, **sc)


def _paged_problem(dev, kernel, quantized, starts, t, hq=8, hkv=2, d=128,
                   bs=16, spare_sentinel=False):
    """Inputs of one decode (T = 1) or prefill call, bf16 or int8 pools.
    With ``spare_sentinel`` every table entry past a window's last block
    names a block no window reads (the pool has 3 spare blocks)."""
    t = 1 if kernel == "decode" else t
    nbps = -(-(max(starts) + t) // bs) + 1
    q, k, v, tables, pos = _paged(dev, starts, t, hq, hkv, d, bs, nbps)
    if spare_sentinel:
        spare = sorted(set(range(tables.numel() + 3))
                       - set(tables.flatten().tolist()))[0]
        for i, s0 in enumerate(starts):
            tables[i, -(-(s0 + t) // bs):] = spare
    if not quantized:
        return q, k, v, tables, pos, None
    from k8s_dra_driver_tpu_torch.models.decode import _quantize_kv

    (k8, ks), (v8, vs) = _quantize_kv(k[None]), _quantize_kv(v[None])
    return q, k8[0], v8[0], tables, pos, (ks[0], vs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [1e4, float("nan")])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_paged_kernels_never_read_past_the_window(dev, kernel, quantized,
                                                  poison):
    """Poisoning every pool row after each window's last position (values
    and, with int8 pools, scales; NaN or +-1e4), the sentinel entries' block
    included, leaves the output bitwise unchanged: masked columns weigh exactly
    0 and no row past the window enters P V."""
    starts, t, bs = (5, 21, 300), 12, 16
    q, k, v, tables, pos, scales = _paged_problem(dev, kernel, quantized,
                                                  starts, t, bs=bs,
                                                  spare_sentinel=True)
    t = q.shape[2]
    out = _run_paged(kernel, q, k, v, tables, pos, bs, scales)
    k2, v2 = k.clone(), v.clone()
    sc2 = None if scales is None else (scales[0].clone(), scales[1].clone())
    big = 127 if quantized else poison
    for i, s0 in enumerate(starts):
        for j in range(tables.shape[1]):
            for r in range(bs):
                if j * bs + r > s0 + t - 1:
                    row = int(tables[i, j]) * bs + r
                    k2[:, row] = big
                    v2[:, row] = -big
                    if sc2 is not None:
                        sc2[0][:, row] = poison
                        sc2[1][:, row] = poison
    out2 = _run_paged(kernel, q, k2, v2, tables, pos, bs, sc2)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_paged_kernels_are_deterministic(dev, kernel, quantized):
    """Two calls on the same inputs agree bitwise: the decode splits merge
    in a fixed order, with no float atomics (one long sequence and three
    short ones, so both the 33-split and the 5-split plans run)."""
    for starts in ((8190,), (0, 400, 1000)):
        q, k, v, tables, pos, scales = _paged_problem(
            dev, kernel, quantized, starts, 64, hq=32, hkv=8)
        first = _run_paged(kernel, q, k, v, tables, pos, 16, scales)
        second = _run_paged(kernel, q, k, v, tables, pos, 16, scales)
        torch.cuda.synchronize()
        assert torch.equal(first, second), starts


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("kernel", ["decode", "prefill"])
def test_paged_wrappers_never_sync(dev, kernel, quantized):
    """Under ``set_sync_debug_mode("error")`` any PyTorch operation that
    waits for the device raises: the split plan and the scratch it
    allocates come from host integers only."""
    q, k, v, tables, pos, scales = _paged_problem(dev, kernel, quantized,
                                                  (0, 700, 3000), 40,
                                                  hq=32, hkv=8)
    _run_paged(kernel, q, k, v, tables, pos, 16, scales)  # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _run_paged(kernel, q, k, v, tables, pos, 16, scales)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()


def _int8_moe_problem(dev, t, h, m, tile=8, case="random"):
    """``_moe_problem`` with the experts quantized per output column (the
    port's ``quantize_tensor``, contraction axes H and M)."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_tensor

    xf, w_gu, w_down, gates, plan = _moe_problem(dev, t, h, m, tile=tile,
                                                 case=case)
    return xf, quantize_tensor(w_gu, 1), quantize_tensor(w_down, 1), gates, \
        plan


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "skew", "foreign"])
@pytest.mark.parametrize("t,h,m,tile", [
    (24, 64, 128, 8),          # tiny widths, the decode tile
    (40, 64, 128, 128),        # tiny widths, the prefill tile
    (8, 4096, 14336, 8),       # Mixtral-8x7B decode step
    (512, 4096, 14336, 128),   # Mixtral-8x7B packed prefill chunk
])
def test_int8_moe_kernels_match_plain(dev, t, h, m, tile, case):
    xf, w_gu, w_down, gates, plan = _int8_moe_problem(dev, t, h, m, tile,
                                                      case)
    counters = (md.moe_gateup, md.moe_down_combine, md.moe_gateup_int8,
                md.moe_down_combine_int8)
    before = [c.launches for c in counters]
    act = md.moe_gateup(xf, w_gu.q, plan, w_gu.scale)
    ref_act = md.moe_gateup_reference(xf, w_gu.q, plan, w_gu.scale)
    gates_pad = md._take_rows(gates, plan.pair_ids).contiguous()
    y = md.moe_down_combine(ref_act, w_down.q, gates_pad, plan, w_down.scale)
    ref_y = md.moe_down_combine_reference(ref_act, w_down.q, gates_pad, plan,
                                          w_down.scale)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, 1, 1]
    assert act.dtype == torch.bfloat16 and y.dtype == torch.float32
    _rel_close("act", act, ref_act)
    _rel_close("y_pairs", y, ref_y, rel_max=1e-3, rel_mean=1e-4)
    sentinel = plan.row_ids >= plan.n_tokens
    assert sentinel.any() and (act[sentinel] == 0).all()
    dead = plan.slot_of_pair >= plan.r_pad
    if case == "foreign":
        assert dead.any()
    assert (y[dead] == 0).all()
    assert (y[~dead].abs().sum(-1) > 0).all()


@pytest.mark.cuda
def test_int8_moe_kernels_all_sentinel_plan(dev):
    xf, w_gu, w_down, gates, _ = _int8_moe_problem(dev, 16, 64, 128)
    plan = md.build_plan(torch.full((32,), 9, dtype=torch.int32,
                                    device=dev), 16, 8, 2, tile_rows=8)
    act = md.moe_gateup_int8(xf, w_gu.q, w_gu.scale, plan)
    gates_pad = md._take_rows(gates, plan.pair_ids).contiguous()
    y = md.moe_down_combine_int8(act, w_down.q, w_down.scale, gates_pad,
                                 plan)
    torch.cuda.synchronize()
    assert (act == 0).all() and (y == 0).all()


@pytest.mark.cuda
def test_quantized_fused_moe_mlp_runs_the_int8_kernels(dev):
    xf, w_gu, w_down, gates, plan = _int8_moe_problem(dev, 24, 64, 128)
    before = (md.moe_gateup.launches, md.moe_gateup_int8.launches)
    out = md.fused_moe_mlp(xf, w_gu, w_down, gates, plan)
    plain = md.fused_moe_mlp(xf, w_gu, w_down, gates, plan,
                             use_kernels=False)
    torch.cuda.synchronize()
    assert (md.moe_gateup.launches, md.moe_gateup_int8.launches) == (
        before[0], before[1] + 1)
    _rel_close("fused int8", out, plain)


@pytest.mark.cuda
def test_int8_moe_wrappers_refuse_what_the_kernels_do_not_take(dev):
    xf, w_gu, w_down, gates, plan = _int8_moe_problem(dev, 24, 64, 128)
    with pytest.raises(TypeError, match="bf16"):        # int8, no scale
        md.moe_gateup(xf, w_gu.q, plan)
    with pytest.raises(TypeError, match="float32"):
        md.moe_gateup(xf, w_gu.q, plan, w_gu.scale.half())
    with pytest.raises(TypeError, match="float32"):
        md.moe_gateup(xf, w_gu.q, plan, w_gu.scale[:, :, :1].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        md.moe_down_combine(md.moe_gateup(xf, w_gu.q, plan, w_gu.scale),
                            w_down.q, md._take_rows(gates, plan.pair_ids),
                            plan, w_down.scale.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,m,tp", [(8, 128, 1), (8, 256, 2),
                                         (128, 256, 4), (500, 512, 2)])
def test_grouped_matmul_int8_against_plain(dev, tokens, m, tp):
    """A7b (``csrc/grouped_matmul_int8.cu``) against its plain version on
    the primitive path's operands: a tensor shard's gate/up block (the
    strided view [E, H, 2, M / tp], both halves in one launch) and its
    down block, ragged and empty groups, rows past the last group exactly
    0; two calls bitwise equal; ``grouped_matmul`` on an int8 rhs
    launches it once a call."""
    from k8s_dra_driver_tpu_torch.models.quant import QuantTensor

    xf, w_gu, w_down, gates, plan = _int8_moe_problem(dev, tokens, 128, m)
    m_loc = m // tp
    gu_q, gu_s = w_gu.q[..., :m_loc], w_gu.scale[..., :m_loc]
    if tp > 1:
        assert not gu_q.is_contiguous()
    xs = md._take_rows(xf, plan.row_ids)
    sizes = plan.sizes_aligned
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    act = torch.randn((plan.r_pad, m_loc), generator=g, device=dev).to(
        torch.bfloat16)
    counters = ("launches",) + md.INT8_GMM_PARTS
    before = [getattr(md.grouped_matmul_int8, c) for c in counters]
    for lhs, q, scale in ((xs, gu_q, gu_s),
                          (act, w_down.q[:, :m_loc], w_down.scale)):
        out = md.grouped_matmul(lhs, QuantTensor(q=q, scale=scale), sizes)
        again = md.grouped_matmul_int8(lhs, q, scale, sizes)
        ref = md.grouped_matmul_int8_reference(lhs, q, scale, sizes)
        torch.cuda.synchronize()
        _rel_close("grouped_matmul_int8", out, ref)
        assert torch.equal(out, again)
        assert not out[int(sizes.sum()):].any()
    # Each launch counted once in all and once by its part (gate/up or
    # down; narrow or wide by its rows).
    size = "wide" if plan.r_pad > w_gu.q.shape[0] * md.INT8_GMM_ROWS \
        else "narrow"
    want = {"launches": 4, f"{size}_gateup_launches": 2,
            f"{size}_down_launches": 2}
    assert {c: getattr(md.grouped_matmul_int8, c) - b
            for c, b in zip(counters, before)} == {
                c: want.get(c, 0) for c in counters}
    ragged = torch.tensor([3, 0, 9, 1], dtype=torch.int32, device=dev)
    lhs = xs[:20].contiguous()
    q4, s4 = gu_q[:4], gu_s[:4]
    out = md.grouped_matmul_int8(lhs, q4, s4, ragged)
    torch.cuda.synchronize()
    _rel_close("grouped_matmul_int8 ragged", out,
               md.grouped_matmul_int8_reference(lhs, q4, s4, ragged))
    assert not out[13:].any()
    with pytest.raises(ValueError, match="multiples"):
        md.grouped_matmul_int8(lhs[:, :100].contiguous(), q4[:, :100],
                               s4, ragged)
    with pytest.raises(TypeError, match="int8"):
        md.grouped_matmul_int8(lhs, q4.float(), s4, ragged)


# A7b's cases: (rows, group sizes, K, whole M, tensor shards, the body the
# plan picks). Gate/up on the strided block [E, K, 2, M / tp] of a whole
# stack, down on [E, M / tp, K]... of the same sizes; rows past the last
# group in every case but "full".
_GMM8_CASES = {
    "decode_1_row_groups": (11, [1] * 8, 512, 512, 4, "narrow"),
    "decode_16_row_groups": (80, [16, 0, 16, 16, 0, 16, 8, 0], 4096, 14336,
                             4, "narrow"),
    "decode_17_to_64_rows": (300, [17, 33, 64, 40, 0, 25, 18, 63], 256,
                             1024, 2, "narrow"),
    "decode_one_group_every_row": (80, [0, 0, 80, 0, 0, 0, 0, 0], 4096,
                                   14336, 4, "narrow"),
    "decode_full": (64, [8] * 8, 1024, 2048, 1, "narrow"),
    "decode_k_48_n_144": (40, [5, 0, 12, 9], 48, 288, 2, "narrow"),
    "prefill_tp1": (1100, [130, 0, 7, 257, 1, 200, 50, 400], 512, 512, 1,
                    "wide"),
    "prefill_tp2": (700, [130, 0, 7, 257, 1, 200, 50, 0], 512, 512, 2,
                    "wide"),
    "prefill_tp4": (700, [128, 128, 0, 256, 128, 0, 0, 0], 512, 512, 4,
                    "wide"),
    "prefill_wide_256": (2048, [256] * 7 + [200], 256, 3072, 2, "wide"),
    "prefill_k_80_n_208": (600, [300, 0, 77, 150], 80, 416, 2, "wide"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_GMM8_CASES))
def test_grouped_matmul_int8_bodies(dev, case):
    """A7b's two bodies (``int8_gmm_plan``) against the plain version:
    decode groups of 1, 16 and 17-64 rows, one group holding every row
    (the narrow body's passes), empty groups, rows past the last group
    exactly 0, the strided gate/up halves at tensor 1, 2 and 4 and a down
    block, K and N off the 64-deep stage and the column block; two calls
    bitwise equal, and a CUDA-graph replay equal to the eager call."""
    rows, sizes, k, m, tp, body = _GMM8_CASES[case]
    e = len(sizes)
    g = torch.Generator(device=dev)
    g.manual_seed(sum(sizes) + k)
    m_loc = m // tp
    lhs_gu = torch.randn(rows, k, generator=g, device=dev).bfloat16()
    lhs_dn = torch.randn(rows, m_loc, generator=g, device=dev).bfloat16()
    gu_q = torch.randint(-127, 128, (e, k, 2, m), generator=g, device=dev,
                         dtype=torch.int8)[..., :m_loc]
    gu_s = torch.rand(e, 1, 2, m, generator=g, device=dev)[..., :m_loc] / 64
    dn_q = torch.randint(-127, 128, (e, m, k), generator=g, device=dev,
                         dtype=torch.int8)[:, :m_loc]
    dn_s = torch.rand(e, 1, k, generator=g, device=dev) / 64
    group_sizes = torch.tensor(sizes, dtype=torch.int32, device=dev)
    total = min(sum(sizes), rows)
    for part, lhs, q, scale in (("gateup", lhs_gu, gu_q, gu_s),
                                ("down", lhs_dn, dn_q, dn_s)):
        assert (tp > 1) == (not q.is_contiguous())
        plan = md.int8_gmm_launch(lhs, q, scale, group_sizes).plan
        assert plan.body == body, plan
        counter = f"{body}_{part}_launches"
        before = getattr(md.grouped_matmul_int8, counter)
        out = md.grouped_matmul_int8(lhs, q, scale, group_sizes)
        again = md.grouped_matmul_int8(lhs, q, scale, group_sizes)
        ref = md.grouped_matmul_int8_reference(lhs, q, scale, group_sizes)
        torch.cuda.synchronize()
        assert getattr(md.grouped_matmul_int8, counter) == before + 2
        _rel_close(f"{case} {part}", out, ref)
        assert torch.equal(out, again), (case, part)
        assert not out[total:].any(), (case, part)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            md.grouped_matmul_int8(lhs, q, scale, group_sizes)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = md.grouped_matmul_int8(lhs, q, scale, group_sizes)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, out), (case, part)


def _int8_weight(dev, e, k, n, seed):
    """Per-column int8 weights (``quantize_tensor`` over K) of a random
    float weight, [K, N] or [E, K, N], with their f32 scales."""
    from k8s_dra_driver_tpu_torch.models.quant import quantize_tensor

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = (k, n) if e is None else (e, k, n)
    w = torch.randn(*shape, generator=g, device=dev) / k ** 0.5
    return quantize_tensor(w, -2)


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("e", [None, 3, 8])     # 3, 8: the MoE body's batch
@pytest.mark.parametrize("k,n", [(256, 192), (512, 208), (512, 112),
                                 (1024, 4096), (14336, 4096 + 16)])
@pytest.mark.parametrize("m", [1, 5, 8, 13, 16, 33, 64, 65, 128, 129, 320,
                               512, 1000])
def test_int8_matmul_matches_plain(dev, m, k, n, e, prologue):
    """Both modes against the plain version. M <= 64 runs the swapped form
    (x's rows as wgmma's N: 8 at M 1, 5 and 8, 16 at 13 and 16, 64 at 33
    and 64; 128 columns a block; K split 8, 4, 2 and 1 ways, one 64-deep
    step a split at K 256 and 512, so a padding stage past K), M > 64 the
    wgmma body (column tiles of 256; K split where the tiles leave SMs
    idle); M 65, 129 and 1000
    leave a ragged row tile, 320 one of 64 rows (the upper m64 half
    idle); N 112, 192, 208 and 4112 a ragged last column tile (at 112 and
    4112 the second consumer has no columns); K 14336 is the expert
    down-projection's depth."""
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

    w = _int8_weight(dev, e, k, n, seed=m + k)
    g = torch.Generator(device=dev)
    g.manual_seed(m)
    x = torch.randn(*((m, k) if e is None else (e, m, k)), generator=g,
                    device=dev).bfloat16()
    counts = ("launches", "wide_launches", "wide_prologue_launches")
    before = [getattr(qm.int8_matmul, c) for c in counts]
    out = qm.int8_matmul(x, w.q, w.scale, prologue)
    ref = qm.int8_matmul_reference(x, w.q, w.scale, prologue)
    torch.cuda.synchronize()
    assert [getattr(qm.int8_matmul, c) - b for c, b in zip(counts, before)
            ] == [1, m > 64, m > 64 and prologue]
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    _rel_close(f"int8_matmul {qm.plan(e or 1, m, n, k, sm_count(dev))}",
               out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", [False, True])
def test_int8_matmul_repeats_bitwise(dev, prologue):
    """Two calls on the same inputs give the same bits (no atomics; split
    K summed in a fixed order): the expert shape at capacity 320, a seam
    at M 512 whose plan splits K, and the swapped form at the decode
    seams (wo split 8 ways, the LM head unsplit) and at E 8."""
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

    for e, m, k, n in ((8, 320, 1024, 4096), (None, 512, 4096, 4096),
                       (None, 8, 4096, 4096), (None, 1, 4096, 32000),
                       (8, 5, 1024, 4096), (None, 64, 4096, 6144)):
        w = _int8_weight(dev, e, k, n, seed=7)
        x = torch.randn(*((m, k) if e is None else (e, m, k)),
                        device=dev).bfloat16()
        first = qm.int8_matmul(x, w.q, w.scale, prologue)
        second = qm.int8_matmul(x, w.q, w.scale, prologue)
        torch.cuda.synchronize()
        assert torch.equal(first, second), (e, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 128])
def test_int8_matmul_takes_a_column_block(dev, m):
    """A tensor shard's column block of an int8 weight (``q[:, c0:c1]``, its
    rows 2N apart) goes into the kernel where it lies, both bodies, equal
    to the plain version on a contiguous copy."""
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

    w = _int8_weight(dev, None, 512, 2 * 192, seed=3)
    x = torch.randn(m, 512, device=dev).bfloat16()
    for c in (0, 1):
        q = w.q[:, 192 * c:192 * (c + 1)]
        scale = w.scale[:, 192 * c:192 * (c + 1)]
        assert not q.is_contiguous()
        out = qm.int8_matmul(x, q, scale)
        ref = qm.int8_matmul_reference(x, q.contiguous(), scale)
        torch.cuda.synchronize()
        _rel_close("int8_matmul column block", out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 128])
def test_int8_matmul_experts_take_a_block(dev, m):
    """An (expert shard, tensor shard) block of int8 expert stacks, as an
    expert x tensor mesh hands it to the einsum body: each half of the
    gate/up block [E_loc, K, 2, N] (its rows 4N apart) and the down block
    [E_loc, N, K] (its experts 2NK apart) go into the prologue mode where
    they lie, one launch each, equal to the plain version on contiguous
    copies."""
    from k8s_dra_driver_tpu_torch.models import moe
    from k8s_dra_driver_tpu_torch.models.quant import QuantTensor
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

    e, k, n = 4, 512, 192
    gu = _int8_weight(dev, e, k, 2 * 2 * n, seed=4)
    gu = QuantTensor(q=gu.q.reshape(e, k, 2, 2 * n),
                     scale=gu.scale.reshape(e, 1, 2, 2 * n))
    down = _int8_weight(dev, e, 2 * n, k, seed=5)
    gu_b = QuantTensor(q=gu.q[2:, :, :, n:], scale=gu.scale[2:, :, :, n:])
    down_b = QuantTensor(q=down.q[2:, n:], scale=down.scale[2:])
    x = torch.randn(2, m, k, device=dev).bfloat16()
    act = torch.randn(2, m, n, device=dev).bfloat16()
    for i in (0, 1):
        q, scale = gu_b.q[:, :, i], gu_b.scale[:, :, i].contiguous()
        assert not q.is_contiguous()
        _rel_close(f"gate/up half {i}", qm.int8_matmul(x, q, scale, True),
                   qm.int8_matmul_reference(x, q.contiguous(), scale, True))
    assert not down_b.q.is_contiguous()
    _rel_close("down block", qm.int8_matmul(act, down_b.q, down_b.scale,
                                            True),
               qm.int8_matmul_reference(act, down_b.q.contiguous(),
                                        down_b.scale, True))
    before = qm.int8_matmul.launches
    y = moe._int8_experts(x, gu_b, True)
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches == before + 2
    contiguous = QuantTensor(q=gu_b.q.contiguous(),
                             scale=gu_b.scale.contiguous())
    _rel_close("_int8_experts gate/up block", y,
               moe._int8_experts(x, contiguous, False))


@pytest.mark.cuda
def test_int8_seams_run_the_kernel(dev):
    """On CUDA tensors the seams launch ``int8_matmul`` once each and
    agree with their plain versions (``use_kernels=False``)."""
    from k8s_dra_driver_tpu_torch.models import quant
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

    wqkv = _int8_weight(dev, None, 256, 2 * 6 * 64, seed=1)
    wqkv = quant.QuantTensor(q=wqkv.q.reshape(256, 2, 6, 64),
                             scale=wqkv.scale.reshape(1, 2, 6, 64))
    wo = _int8_weight(dev, None, 256, 128, seed=2)
    x = torch.randn(2, 3, 256, device=dev).bfloat16()
    before = qm.int8_matmul.launches
    a = quant.q_einsum("bth,hkgd->btkgd", x, wqkv)
    b = quant.q_matmul(x, wo)
    torch.cuda.synchronize()
    assert qm.int8_matmul.launches == before + 2
    _rel_close("q_einsum", a, quant.q_einsum("bth,hkgd->btkgd", x, wqkv,
                                             use_kernels=False))
    _rel_close("q_matmul", b, quant.q_matmul(x, wo, use_kernels=False))
    assert qm.int8_matmul.launches == before + 2


@pytest.mark.cuda
def test_int8_matmul_refuses_what_the_kernel_does_not_take(dev):
    from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

    w = _int8_weight(dev, None, 256, 192, seed=3)
    x = torch.randn(8, 256, device=dev).bfloat16()
    with pytest.raises(TypeError, match="bf16|bfloat16"):
        qm.int8_matmul(x.float(), w.q, w.scale)
    with pytest.raises(TypeError, match="int8"):
        qm.int8_matmul(x, w.q.float(), w.scale)
    with pytest.raises(TypeError, match="float32"):
        qm.int8_matmul(x, w.q, w.scale.bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        qm.int8_matmul(x, w.q, w.scale.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        qm.int8_matmul(x.t().contiguous().t(), w.q, w.scale)
    with pytest.raises(ValueError, match="multiple of 64"):
        qm.int8_matmul(x[:, :96].contiguous(), w.q[:96].contiguous(),
                       w.scale)
    with pytest.raises(ValueError, match="multiple of 16"):
        qm.int8_matmul(x, w.q[:, :40].contiguous(),
                       w.scale[:, :40].contiguous())
    with pytest.raises(ValueError, match="does not match"):
        qm.int8_matmul(x[:, :128].contiguous(), w.q, w.scale)


# K7/K8's launches (``md.dispatch_plan``): the wgmma body at every row
# tile, its swapped form for int8 experts at tiles of at most 16 rows, and
# the int8 K8's split of its contracted axis where its blocks leave SMs
# idle; both branches of each.


def _moe_branch(dev, t, h, m, tile, case, quantized):
    """(xf, (w_gu, its scale), (w_down, its scale), gates, plan); the
    scales are None for bf16 experts."""
    if quantized:
        xf, w_gu, w_down, gates, plan = _int8_moe_problem(dev, t, h, m, tile,
                                                          case)
        return (xf, (w_gu.q, w_gu.scale), (w_down.q, w_down.scale), gates,
                plan)
    xf, w_gu, w_down, gates, plan = _moe_problem(dev, t, h, m, tile=tile,
                                                 case=case)
    return xf, (w_gu, None), (w_down, None), gates, plan


def _moe_launch(xf, gu, dn, gates_pad, plan, act_in, launch=None):
    """K7 on xf and K8 on ``act_in`` through the wrappers, or with the
    given launch (``md.MoePlan``) through their launch helpers."""
    (wg, sg), (wd, sd) = gu, dn
    if launch is None:
        return (md.moe_gateup(xf, wg, plan, sg),
                md.moe_down_combine(act_in, wd, gates_pad, plan, sd))
    q = "" if sg is None else "_int8"
    return (md._gateup_launch("moe_gateup" + q, xf, wg, sg, plan, launch),
            md._down_launch("moe_down_combine" + q, act_in, wd, sd,
                            gates_pad, plan, launch))


def _moe_check(xf, gu, dn, gates, plan, launch=None):
    """K7 and K8 against their plain versions (K7 2% / 1%, K8 1e-3 /
    1e-4), sentinel rows and slots of no live pair exactly 0, and both
    bitwise equal on a second call."""
    (wg, sg), (wd, sd) = gu, dn
    gates_pad = md._take_rows(gates, plan.pair_ids).contiguous()
    ref_act = md.moe_gateup_reference(xf, wg, plan, sg)
    act, y = _moe_launch(xf, gu, dn, gates_pad, plan, ref_act, launch)
    act2, y2 = _moe_launch(xf, gu, dn, gates_pad, plan, ref_act, launch)
    ref_y = md.moe_down_combine_reference(ref_act, wd, gates_pad, plan, sd)
    torch.cuda.synchronize()
    assert act.dtype == torch.bfloat16 and y.dtype == torch.float32
    _rel_close("act", act, ref_act)
    _rel_close("y_pairs", y, ref_y, rel_max=1e-3, rel_mean=1e-4)
    assert torch.equal(act, act2) and torch.equal(y, y2)
    sentinel = plan.row_ids >= plan.n_tokens
    assert (act[sentinel] == 0).all()
    dead = plan.slot_of_pair >= plan.r_pad
    assert (y[dead] == 0).all()
    assert (y[~dead].abs().sum(-1) > 0).all()
    return dead


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("case", ["random", "skew", "foreign"])
@pytest.mark.parametrize("t,h,m,tile", [
    (8192, 4096, 14336, 128),  # Mixtral-8x7B training (8x7b-L1, 4 x 2048)
    (200, 512, 512, 24),       # K7 128 + 128 columns, K8 256
    (200, 384, 384, 40),       # K7 128 + 128, K8 128
    (200, 320, 320, 72),       # K7 64 + 64, K8 64
    (300, 512, 320, 120),      # K7 64 + 64, K8 256
])
def test_moe_kernels_match_plain_at_every_column_block(dev, t, h, m, tile, case, quantized):
    """The wgmma body at row tiles under 128 (the box reads the next tile's
    rows, never stored), every column block K7 and K8 take (the narrow
    widths' few blocks split the int8 K8), skewed and half-foreign
    routing, at the training shape too."""
    xf, gu, dn, gates, plan = _moe_branch(dev, t, h, m, tile, case,
                                          quantized)
    launch = md.dispatch_plan(tile, plan.r_pad, h, m, quantized,
                              sm_count(dev))
    assert launch.gateup_body == launch.down_body == "wgmma"
    assert launch.split * launch.chunk == m
    counters = (md.moe_gateup_int8, md.moe_down_combine_int8) if quantized \
        else (md.moe_gateup, md.moe_down_combine)
    before = [c.launches for c in counters]
    dead = _moe_check(xf, gu, dn, gates, plan)
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2]
    assert case != "foreign" or dead.any()


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tile", [8, 128])
def test_moe_kernels_all_sentinel_plan_at_both_tiles(dev, tile, quantized):
    """Every pair foreign: K7 writes zeros, K8 nothing, at a tile of 8
    and one of 128."""
    xf, gu, dn, gates, _ = _moe_branch(dev, 40, 128, 128, 8, "random",
                                       quantized)
    plan = md.build_plan(torch.full((80,), 9, dtype=torch.int32,
                                    device=dev), 40, 8, 2, tile_rows=tile)
    gates_pad = md._take_rows(gates, plan.pair_ids).contiguous()
    act, y = _moe_launch(xf, gu, dn, gates_pad, plan,
                         torch.ones(plan.r_pad, 128, dtype=torch.bfloat16,
                                    device=dev))
    torch.cuda.synchronize()
    assert (act == 0).all() and (y == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,split", [(False, 1), (True, 1),
                                             (True, 2), (True, 4)])
@pytest.mark.parametrize("case", ["random", "foreign"])
def test_moe_decode_step_forms_and_splits_match_plain(dev, case, split,
                                                      quantized):
    """The Mixtral-8x7B decode step (T 8, tile 8: 64-row boxes) in the
    wgmma body and, on int8 experts, its swapped form (the plan's choice
    there), the int8 K8's contracted axis whole and split 2 and 4 ways,
    partials summed in order (bitwise on repeat)."""
    xf, gu, dn, gates, plan = _moe_branch(dev, 8, 4096, 14336, 8, case,
                                          quantized)
    forms = ("wgmma", "swapped") if quantized else ("wgmma",)
    assert md.dispatch_plan(8, plan.r_pad, 4096, 14336, quantized,
                            sm_count(dev)).down_body == forms[-1]
    for form in forms:
        _moe_check(xf, gu, dn, gates, plan,
                   md.MoePlan(form, 128, form, 256, split, 14336 // split))


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,split", [(True, 1), (True, 2),
                                             (True, 4), (False, 1)])
@pytest.mark.parametrize("t,tile", [(8, 8), (512, 128)])
def test_moe_kernels_match_plain_at_8x160m_widths(dev, t, tile, split,
                                                  quantized):
    """8x160m's widths (H 768, M 2048), where the plan splits the int8
    K8 (4 ways at the decode step, 2 at the prefill chunk), in the plan's
    form with K8 whole and split 2 and 4 ways; bf16 unsplit."""
    xf, gu, dn, gates, plan = _moe_branch(dev, t, 768, 2048, tile, "random",
                                          quantized)
    chosen = md.dispatch_plan(tile, plan.r_pad, 768, 2048, quantized,
                              sm_count(dev))
    assert chosen.split == ((4 if tile == 8 else 2) if quantized else 1)
    _moe_check(xf, gu, dn, gates, plan,
               chosen._replace(split=split, chunk=2048 // split))


@pytest.mark.cuda
def test_moe_wrappers_refuse_a_bad_launch(dev):
    """The C entry points refuse a launch outside their plan's grammar, and
    the wrapper a split of bf16 K8, whose entry point takes none."""
    xf, gu, dn, gates, plan = _moe_branch(dev, 24, 64, 128, 8, "random",
                                          False)
    gates_pad = md._take_rows(gates, plan.pair_ids).contiguous()
    act = md.moe_gateup(xf, gu[0], plan)
    for bad in (md.MoePlan("wgmma", 128, "wgmma", 128, 1, 128),  # H 64
                md.MoePlan("wgmma", 128, "swapped", 64, 1, 128)):  # bf16
        with pytest.raises(RuntimeError, match="error -1"):
            md._down_launch("moe_down_combine", act, dn[0], None, gates_pad,
                            plan, bad)
    with pytest.raises(ValueError, match="never split"):
        md._down_launch("moe_down_combine", act, dn[0], None, gates_pad,
                        plan, md.MoePlan("wgmma", 128, "wgmma", 64, 2, 64))
    xq, guq, dnq, gates_q, plan_q = _moe_branch(dev, 24, 64, 128, 8,
                                                "random", True)
    act_q = md.moe_gateup(xq, guq[0], plan_q, guq[1])
    for bad in (md.MoePlan("wgmma", 128, "wgmma", 64, 4, 32),  # 4 x 64 > M
                md.MoePlan("wgmma", 128, "wgmma", 64, 3, 42)):  # split 3
        with pytest.raises(RuntimeError, match="error -1"):
            md._down_launch("moe_down_combine_int8", act_q, dnq[0], dnq[1],
                            md._take_rows(gates_q, plan_q.pair_ids)
                            .contiguous(), plan_q, bad)
    with pytest.raises(RuntimeError, match="error -1"):  # 256 columns
        md._gateup_launch("moe_gateup", xf, gu[0], None, plan,
                          md.MoePlan("wgmma", 256, "wgmma", 64, 1, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("n,shift", [(2, 1), (4, 1), (4, -1), (4, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
def test_ring_permute_matches_its_plain_version(dev, n, shift, dtype):
    """K9's twin (``csrc/ring_permute.cu``) against its plain version, bit
    for bit: four shards of one card, a size of no whole 16-byte word (100
    x 37 elements) and views at a nonzero storage offset (rows of one
    buffer, which start 2- or 4-byte aligned for the narrow types); the
    gradient is the inverse rotation; one launch a call; no host sync."""
    from k8s_dra_driver_tpu_torch.parallel import ring

    g = torch.Generator(device=dev)
    g.manual_seed(n * 10 + shift)
    whole = torch.randn(n * 100 * 37 + 1, generator=g, device=dev)
    if dtype == torch.int8:
        whole = (whole * 40).to(torch.int8)
    else:
        whole = whole.to(dtype)
    xs = [whole[1 + i * 3700:1 + (i + 1) * 3700].view(100, 37)
          for i in range(n)]
    assert all(x.storage_offset() > 0 for x in xs)
    before = ring.ring_permute_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ring.ring_permute(xs, "expert", n, shift=shift)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert ring.ring_permute_kernel.launches == before + 1
    ref = ring.ring_permute_reference(xs, shift)
    for o, r in zip(out, ref):
        assert o.device == r.device and torch.equal(o, r)
    if dtype == torch.float32:
        leaves = [x.clone().requires_grad_() for x in xs]
        w = [torch.randn(100, 37, generator=g, device=dev) for _ in xs]
        sum((o * wi).sum() for o, wi in zip(
            ring.ring_permute(leaves, "expert", n, shift=shift), w)
            ).backward()
        for got, want in zip([x.grad for x in leaves],
                             ring.ring_permute_reference(w, -shift)):
            assert torch.equal(got, want)


def _same_bytes(out, ref) -> bool:
    return all(o.dtype == r.dtype and o.device == r.device and torch.equal(
        o.reshape(-1).view(torch.uint8), r.reshape(-1).view(torch.uint8))
        for o, r in zip(out, ref))


def _ring_views(dev, g, n, shape, dtype, offset):
    """``n`` shard buffers of ``shape``, views into one buffer from
    ``offset`` elements on: a storage offset of ``offset`` x the dtype's
    size in bytes."""
    numel = 1
    for d in shape:
        numel *= d
    whole = torch.randn(offset + n * numel, generator=g, device=dev)
    whole = (whole * 40).to(torch.int8) if dtype == torch.int8 \
        else whole.to(dtype)
    return [whole[offset + i * numel:offset + (i + 1) * numel].view(shape)
            for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,shift", [(2, 1), (4, 1), (4, -1), (4, 3)])
def test_ring_permute_group_matches_its_plain_version(dev, n, shift):
    """K9's grouped launch (``ring.ring_permute_group``) against the plain
    version ring by ring, bit for bit: rings of mixed dtypes in one launch
    -- int8, bf16 and f32 views at storage offsets of 1, 2 and 4 bytes
    (narrow words and a ragged unit), a ring of empty pairs, and the EP
    hop's aligned bf16 chunk beside its f32 carrier; one launch a group
    call and none for a group of no byte; no host sync; a CUDA graph's
    replay (its launch after a memset) equal to the eager call; the
    gradient of a group the group's inverse rotation, one launch each
    way."""
    from k8s_dra_driver_tpu_torch.parallel import ring

    g = torch.Generator(device=dev)
    g.manual_seed(200 + n * 10 + shift)
    groups = [
        [_ring_views(dev, g, n, (100, 37), torch.int8, 1),
         _ring_views(dev, g, n, (100, 37), torch.bfloat16, 1),
         _ring_views(dev, g, n, (100, 37), torch.float32, 1),
         _ring_views(dev, g, n, (0, 37), torch.float32, 0)],
        [_ring_views(dev, g, n, (128, 512), torch.bfloat16, 0),
         _ring_views(dev, g, n, (128, 512), torch.float32, 0),
         _ring_views(dev, g, n, (3, 5), torch.float32, 0)],
    ]
    assert [r[0].storage_offset() * r[0].element_size()
            for r in groups[0][:3]] == [1, 2, 4]
    scratch = torch.empty(1 << 20, device=dev)
    for rings in groups:
        want = ring.ring_permute_many_reference(rings, shift)
        before = ring.ring_permute_kernel.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = ring.ring_permute_group(rings, shift % n)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert ring.ring_permute_kernel.launches == before + 1
        for out, ref in zip(got, want):
            assert _same_bytes(out, ref)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ring.ring_permute_group(rings, shift % n)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ring.ring_permute_kernel.launches
        with torch.cuda.graph(graph):
            scratch.zero_()
            captured = ring.ring_permute_group(rings, shift % n)
        assert ring.ring_permute_kernel.launches == before + 1
        for out in captured:
            for o in out:
                o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for out, ref in zip(captured, got):
            assert _same_bytes(out, ref)
    empty = [_ring_views(dev, g, n, (0, 8), torch.bfloat16, 0)]
    before = ring.ring_permute_kernel.launches
    out = ring.ring_permute_group(empty, shift % n)
    assert ring.ring_permute_kernel.launches == before
    assert [o.shape for o in out[0]] == [torch.Size([0, 8])] * n
    leaves = [[x.clone().requires_grad_() for x in ring_]
              for ring_ in groups[1][:2]]
    w = [[torch.randn(x.shape, generator=g, device=dev).to(x.dtype)
          for x in ring_] for ring_ in leaves]
    before = ring.ring_permute_kernel.launches
    rotated = ring.ring_permute_many(leaves, "expert", n, shift=shift,
                                     sites=("x", "y"))
    sum((o.float() * wi.float()).sum() for out, ws in zip(rotated, w)
        for o, wi in zip(out, ws)).backward()
    torch.cuda.synchronize()
    assert ring.ring_permute_kernel.launches == before + 2
    for ring_, ws in zip(leaves, w):
        assert _same_bytes([x.grad for x in ring_],
                           ring.ring_permute_reference(ws, -shift))
