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
