"""The fused MoE dispatch kernels' launch plan
(``ops/moe_dispatch.py::dispatch_plan``) on the CPU, no card: which form
of the body K7 and K8 run, their column blocks and the int8 K8's split of
its contracted axis, from host integers alone, for every row tile the
kernels take and the widths of ``tiny-moe``, ``8x160m`` and
Mixtral-8x7B."""

import inspect

import pytest
import torch

from k8s_dra_driver_tpu_torch.models.moe import MOE_PRESETS
from k8s_dra_driver_tpu_torch.ops import moe_dispatch as md

SMS = 132  # the H100's SMs
TILES = list(range(8, md.TILE_ROWS + 1, 8))
WIDTHS = sorted({(MOE_PRESETS[name].hidden, MOE_PRESETS[name].mlp_hidden)
                 for name in ("tiny-moe", "8x160m", "8x7b")})


def _r_pad(n_pairs: int, n_experts: int, tile: int) -> int:
    """``build_plan``'s row count."""
    return -(-n_pairs // tile) * tile + n_experts * tile


def _plans(h, m, int8, sms=SMS, tiles=TILES):
    """The plan of each tile at a decode step (16 pairs), a packed prefill
    chunk (1024) and a training batch (16384), 8 experts."""
    for tile in tiles:
        for pairs in (16, 1024, 16384):
            r_pad = _r_pad(pairs, 8, tile)
            yield tile, r_pad, md.dispatch_plan(tile, r_pad, h, m, int8, sms)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h,m", WIDTHS)
def test_every_tile_gets_a_launch_the_kernels_take(h, m, int8, tile):
    """The column blocks divide the output widths; the swapped form runs
    exactly where the source takes it: int8, tiles of at most 16 rows, a
    block of 256 staged columns, an even number of 64-deep stages."""
    for tile, _, p in _plans(h, m, int8, tiles=[tile]):
        assert p.gateup_cols in (64, 128) and m % p.gateup_cols == 0, p
        assert p.down_cols in (64, 128, 256) and h % p.down_cols == 0, p
        assert set(md.BODIES) >= {p.gateup_body, p.down_body}, p
        small = int8 and tile <= md.SWAP_MAX_TILE
        assert (p.gateup_body == "swapped") == (
            small and p.gateup_cols == 128 and h % 128 == 0), (tile, p)
        assert (p.down_body == "swapped") == (
            small and p.down_cols == 256 and p.chunk % 128 == 0), (tile, p)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h,m", WIDTHS)
def test_split_times_chunk_covers_the_contracted_axis(h, m, int8, tile):
    """K8's split takes M whole, in chunks of whole 64-deep stages; bf16
    K8 is never split."""
    for tile, _, p in _plans(h, m, int8, tiles=[tile]):
        assert p.split in ((1, 2, 4) if int8 else (1,)), (tile, p)
        assert p.split * p.chunk == m, (tile, p)
        assert p.chunk % md.K_STEP == 0, (tile, p)


@pytest.mark.parametrize("h,m", WIDTHS)
def test_the_widest_column_block_that_divides(h, m):
    p = md.dispatch_plan(128, _r_pad(1024, 8, 128), h, m, False, SMS)
    assert p.down_cols == max(c for c in (64, 128, 256) if h % c == 0)
    assert p.gateup_cols == (128 if m % 128 == 0 else 64)


@pytest.mark.parametrize("h,m,down", [(320, 320, 64), (384, 384, 128),
                                      (512, 512, 256), (512, 320, 256)])
def test_the_card_tests_widths_take_each_column_block(h, m, down):
    p = md.dispatch_plan(24, _r_pad(400, 8, 24), h, m, True, SMS)
    assert p.down_cols == down and p.gateup_cols == (128 if m % 128 == 0
                                                     else 64)
    assert p.gateup_body == p.down_body == "wgmma"


@pytest.mark.parametrize("sms", [16, 66, 132, 264])
@pytest.mark.parametrize("int8", [False, True])
def test_k8_splits_only_below_one_wave(sms, int8):
    """The int8 K8 splits while its blocks (every tile's), so split, still
    fit one wave of the SMs, and stops at four, or where M would not
    divide into whole stages; bf16 K8 never splits."""
    for h, m in WIDTHS:
        for tile, r_pad, p in _plans(h, m, int8, sms):
            blocks = (r_pad // tile) * (h // p.down_cols)
            if not int8:
                assert p.split == 1, (tile, r_pad, p)
                continue
            assert blocks * p.split <= sms or p.split == 1, (tile, r_pad, p)
            if p.split < 4 and (m // md.K_STEP) % (2 * p.split) == 0:
                assert blocks * 2 * p.split > sms, (tile, r_pad, p)


def test_the_plan_at_the_paths_shapes():
    """Mixtral-8x7B on the H100: the decode step (8 tokens, tile 8, r_pad
    80: 160 blocks of K8, over the 132 SMs) splits nothing and takes the
    swapped form on int8 experts, the wgmma body on bf16 ones; the prefill
    chunk and the training batch (tile 128) take the wgmma body, 128 + 128
    columns for K7, 256 for K8."""
    assert md.dispatch_plan(8, 80, 4096, 14336, True, SMS) == md.MoePlan(
        "swapped", 128, "swapped", 256, 1, 14336)
    assert md.dispatch_plan(8, 80, 4096, 14336, False, SMS) == md.MoePlan(
        "wgmma", 128, "wgmma", 256, 1, 14336)
    for int8 in (False, True):
        for r_pad in (2048, 17408):
            assert md.dispatch_plan(128, r_pad, 4096, 14336, int8,
                                    SMS) == md.MoePlan(
                "wgmma", 128, "wgmma", 256, 1, 14336)


def test_tiny_moe_splits_k8_and_keeps_the_wgmma_body():
    """``tiny-moe`` (H 64, M 128) at decode: 5 blocks of the int8 K8 split
    M into two whole stages, bf16 K8's do not; a contracted axis of one
    stage (K7's H) or a 64-column block cannot take the swapped form."""
    assert md.dispatch_plan(8, 40, 64, 128, True, SMS) == md.MoePlan(
        "wgmma", 128, "wgmma", 64, 2, 64)
    assert md.dispatch_plan(8, 40, 64, 128, False, SMS) == md.MoePlan(
        "wgmma", 128, "wgmma", 64, 1, 128)


@pytest.mark.parametrize("int8", [False, True])
def test_the_plan_at_8x160m(int8):
    """8x160m (H 768, M 2048) on the H100, where the int8 K8's split was
    timed fastest: the decode step's 30 blocks split 4 ways, the prefill
    chunk's 48 blocks 2 ways, the training batch's 408 none; bf16 K8
    splits nowhere."""
    want = (4, 2, 1) if int8 else (1, 1, 1)
    for (tile, r_pad), split in zip(((8, 80), (128, 2048), (128, 17408)),
                                    want):
        p = md.dispatch_plan(tile, r_pad, 768, 2048, int8, SMS)
        assert (p.down_cols, p.split, p.chunk) == (256, split,
                                                   2048 // split), p
        assert p.down_body == ("swapped" if int8 and tile == 8
                               else "wgmma"), p


def test_the_plan_reads_no_tensor():
    """Host integers in, host integers and names out: a tensor in place of
    an integer is refused before any device work (no routing is read,
    nothing syncs)."""
    params = inspect.signature(md.dispatch_plan).parameters
    assert list(params) == ["tile", "r_pad", "h", "m", "int8", "sms"]
    p = md.dispatch_plan(8, 80, 4096, 14336, False, SMS)
    assert all(type(v) in (str, int) for v in p)
    for i in range(5):
        args = [8, 80, 4096, 14336, SMS]
        args[i] = torch.tensor(args[i])
        with pytest.raises(TypeError, match="host integers"):
            md.dispatch_plan(*args[:4], False, args[4])


def test_widths_the_kernels_refuse_raise():
    with pytest.raises(ValueError, match="multiples of 64"):
        md.dispatch_plan(8, 80, 4096 + 32, 14336, False, SMS)
    with pytest.raises(ValueError, match="multiples of 64"):
        md.dispatch_plan(8, 80, 4096, 100, False, SMS)


# ---------------------------------------------------------------------------
# A7b, the int8 grouped product's launch (``int8_gmm_plan``).
# ---------------------------------------------------------------------------

# Phase 35's four shapes of one tensor shard of the int8 Mixtral-8x7B (8
# experts: the decode step's 16 pairs in r_pad 80 rows, a 512-token prefill
# chunk's 1024 pairs in 2048), at tensor 1, 2 and 4: (tensor, shape) ->
# (rows, K, N a half, halves) and the launch.
_8X7B = {
    (tp, shape): launch
    for tp, m in ((1, 14336), (2, 7168), (4, 3584))
    for shape, launch in (
        ("decode_gateup", ((80, 4096, m, 2),
                           ("narrow", 16, 128, (2 * m // 128, 9)))),
        ("decode_down", ((80, m, 4096, 1), ("narrow", 16, 128, (32, 9)))),
        ("prefill_gateup", ((2048, 4096, m, 2),
                            ("wide", 128, 256, (24 * 2 * m // 256, 1)))),
        ("prefill_down", ((2048, m, 4096, 1),
                          ("wide", 128, 256, (24 * 16, 1)))))
}


@pytest.mark.parametrize("tp,shape", sorted(_8X7B))
def test_int8_gmm_plan_at_8x7b(tp, shape):
    """Decode rows (80 over 8 experts) take the narrow body, 16 rows a
    pass, 128 columns a block, a row of blocks per expert and one for the
    rows past the last group; prefill rows the wide body, 256 columns a
    block, (16 row tiles + 8) items per column block. At tensor 4 the
    gate/up decode grid is 56 x 9 (448 live blocks at most: one wave of 4
    blocks an SM)."""
    (rows, k, half_n, halves), launch = _8X7B[tp, shape]
    assert md.int8_gmm_plan(rows, 8, k, half_n, halves) == \
        md.Int8GmmPlan(*launch)


# The test presets at tensor 1, 2 and 4: (preset, tensor) -> the plans of
# the decode step's gate/up and down, then the prefill chunk's.
_PRESET_PLANS = {
    ("tiny-moe", 1): [("narrow", 16, 128, (2, 5)), ("narrow", 16, 128, (1, 5)),
                      ("wide", 128, 256, (32, 1)),
                      ("wide", 128, 256, (16, 1))],
    ("tiny-moe", 2): [("narrow", 16, 128, (2, 5)), ("narrow", 16, 128, (1, 5)),
                      ("wide", 128, 256, (32, 1)),
                      ("wide", 128, 256, (16, 1))],
    ("tiny-moe", 4): [("narrow", 16, 128, (2, 5)), ("narrow", 16, 128, (1, 5)),
                      ("wide", 128, 256, (32, 1)),
                      ("wide", 128, 256, (16, 1))],
    ("8x160m", 1): [("narrow", 16, 128, (32, 9)), ("narrow", 16, 128, (6, 9)),
                    ("wide", 128, 256, (384, 1)),
                    ("wide", 128, 256, (72, 1))],
    ("8x160m", 2): [("narrow", 16, 128, (16, 9)), ("narrow", 16, 128, (6, 9)),
                    ("wide", 128, 256, (192, 1)),
                    ("wide", 128, 256, (72, 1))],
    ("8x160m", 4): [("narrow", 16, 128, (8, 9)), ("narrow", 16, 128, (6, 9)),
                    ("wide", 128, 256, (96, 1)),
                    ("wide", 128, 256, (72, 1))],
}


def _pairs_rows(pairs: int, e: int) -> int:
    return _r_pad(pairs, e, md.default_tile_rows(pairs, e))


@pytest.mark.parametrize("name,tp", sorted(_PRESET_PLANS))
def test_int8_gmm_plan_at_the_test_presets(name, tp):
    """The test presets at a decode step (8 tokens: tiny-moe's 48 rows
    over 4 experts, 8x160m's 80 over 8) and a prefill chunk (512 tokens:
    1536 and 2048 rows): the narrow body while the rows fit 64 an expert,
    every column of both halves in a block, K and N (32 at tiny-moe's
    tensor 4) off the 64-deep stage and the column block taken whole."""
    cfg = MOE_PRESETS[name]
    e, h, m = cfg.n_experts, cfg.hidden, cfg.mlp_hidden // tp
    got = [md.int8_gmm_plan(_pairs_rows(tokens * cfg.top_k, e), e, k,
                            half_n, halves)
           for tokens in (8, 512)
           for k, half_n, halves in ((h, m, 2), (m, h, 1))]
    assert got == [md.Int8GmmPlan(*p) for p in _PRESET_PLANS[name, tp]]


@pytest.mark.parametrize("rows,want", [(0, 16), (8, 16), (128, 16),
                                       (129, 32), (256, 32), (257, 64),
                                       (512, 64), (513, None)])
def test_int8_gmm_plan_rows_a_pass(rows, want):
    """N (the narrow body's rows a pass) is the least of 16, 32 and 64
    that holds the rows an expert (8 experts); past 64 an expert the wide
    body runs (the narrow launch counters count exactly these)."""
    p = md.int8_gmm_plan(rows, 8, 4096, 3584, 2)
    assert (p.rows if p.body == "narrow" else None) == want, p
    assert (p.body == "narrow") == (rows <= 8 * md.INT8_GMM_ROWS)


def test_int8_gmm_plan_reads_no_tensor():
    """Host integers in, host integers and names out; a tensor in place
    of an integer is refused (the group sizes are never read, so the
    launch is captured in CUDA graphs)."""
    params = inspect.signature(md.int8_gmm_plan).parameters
    assert list(params) == ["rows", "n_groups", "k", "half_n", "halves"]
    for body_rows in (80, 2048):
        p = md.int8_gmm_plan(body_rows, 8, 4096, 3584, 2)
        assert type(p.body) is str and type(p.rows) is int
        assert type(p.cols) is int and all(type(v) is int for v in p.grid)
    for i in range(5):
        args = [80, 8, 4096, 3584, 2]
        args[i] = torch.tensor(args[i])
        with pytest.raises(TypeError, match="host integers"):
            md.int8_gmm_plan(*args)


def _int8_gmm_operands(rows=80, e=8, k=256, m=512, tp=4):
    """CPU operands of one tensor shard's gate/up product: lhs [rows, K],
    the strided block [E, K, 2, M / tp] of a whole stack and its scale."""
    lhs = torch.zeros(rows, k, dtype=torch.bfloat16)
    q = torch.zeros(e, k, 2, m, dtype=torch.int8)[..., :m // tp]
    scale = torch.zeros(e, 1, 2, m)[..., :m // tp]
    return lhs, q, scale, torch.zeros(e, dtype=torch.int32)


def test_int8_gmm_launch_reads_a_strided_block():
    """The wrapper's arguments for a tensor shard's gate/up block, on CPU
    tensors: both halves of the view as it lies (its expert, row and half
    strides in bytes, the scale's in elements), 2 x M / tp output
    columns, the plan of its host integers."""
    lhs, q, scale, sizes = _int8_gmm_operands()
    a = md.int8_gmm_launch(lhs, q, scale, sizes)
    assert (a.rows, a.k, a.n, a.n_groups, a.half_n) == (80, 256, 256, 8, 128)
    assert a.strides == (256 * 2 * 512, 2 * 512, 512, 2 * 512, 512)
    assert a.plan == md.int8_gmm_plan(80, 8, 256, 128, 2)
    down = torch.zeros(8, 512, 4096, dtype=torch.int8)[:, :128]
    a = md.int8_gmm_launch(torch.zeros(80, 128, dtype=torch.bfloat16), down,
                           torch.zeros(8, 1, 4096), sizes)
    assert (a.k, a.n, a.half_n, a.strides) == (
        128, 4096, 4096, (512 * 4096, 4096, 0, 4096, 0))


@pytest.mark.parametrize("case,error,match", [
    ("k_off_16", ValueError, "multiples"),
    ("n_off_16", ValueError, "multiples"),
    ("row_stride_off_16", ValueError, "strides"),
    ("expert_stride_off_16", ValueError, "strides"),
    ("scale_last_axis_strided", ValueError, "strides"),
    ("f32_weights", TypeError, "int8"),
    ("scale_shape", ValueError, "scale"),
    ("cpu_tensors", ValueError, "CUDA"),
])
def test_int8_gmm_refusals_on_the_cpu(case, error, match):
    """What the kernel does not take raises before any launch, on CPU
    tensors too: K or N off the multiples of 16, a weight stride off 16
    bytes, a strided last axis, float weights, a wrong scale shape; and
    the wrapper refuses CPU tensors (their plain version runs through
    ``grouped_matmul``)."""
    lhs, q, scale, sizes = _int8_gmm_operands()
    if case == "k_off_16":
        lhs, q = lhs[:, :200].contiguous(), q[:, :200]
    elif case == "n_off_16":
        q, scale = q[..., :120], scale[..., :120]
    elif case == "row_stride_off_16":
        q = torch.zeros(8, 256, 40, dtype=torch.int8)[..., :32]
        scale = torch.zeros(8, 1, 32)
    elif case == "expert_stride_off_16":
        q = torch.zeros(8 * 8200, dtype=torch.int8).as_strided(
            (8, 256, 32), (8200, 32, 1))
        scale = torch.zeros(8, 1, 32)
    elif case == "scale_last_axis_strided":
        scale = torch.zeros(8, 1, 2, 256)[..., ::2]
    elif case == "f32_weights":
        q = q.float()
    elif case == "scale_shape":
        scale = scale[:4]
    if case == "cpu_tensors":
        with pytest.raises(error, match=match):
            md.grouped_matmul_int8(lhs, q, scale, sizes)
        return
    with pytest.raises(error, match=match):
        md.int8_gmm_launch(lhs, q, scale, sizes)
