"""The int8 matmul's launch plan (``ops/quant_matmul.py::plan``) on the
CPU, no card: which body runs, how the output is tiled and K split, from
host integers alone, at the shapes of the int8 serving path (the seams of
Mixtral-8x7B at decode, at a packed prefill and at a 1024-token prompt,
and the einsum MoE body's expert products). At M <= 64 the swapped form
runs: 128 weight columns a block, K split 1, 2, 4 or 8 ways, the fewest
whose blocks cover the SMs."""

import inspect

import pytest

from k8s_dra_driver_tpu_torch.ops import quant_matmul as qm

SMS = 132  # the H100's SMs
# (E, M, K, N): the seams (wqkv, wo, LM head) at decode M 8, at the packed
# prefill's M 512 and at a 1024-token prompt; the expert products at
# capacity 512 and 320 (gate/up 4096 -> 28672, down 14336 -> 4096).
SEAMS = [(1, m, 4096, n) for m in (8, 512, 1024)
         for n in (6144, 4096, 32000)]
EXPERTS = [(8, 512, 4096, 28672), (8, 320, 4096, 28672),
           (8, 320, 14336, 4096)]
SHAPES = SEAMS + EXPERTS


@pytest.mark.parametrize("e,k,n", [(1, 4096, 4096), (8, 4096, 28672),
                                   (3, 256, 208)])
def test_the_wgmma_body_runs_exactly_above_m_64(e, k, n):
    for m in list(range(1, 140)) + [320, 512, 1000, 1024, 8192]:
        p = qm.plan(e, m, n, k, SMS)
        assert p.wide == (m > 64), (m, p)
        if not p.wide:
            assert p.split == qm.split_k(e, n, k, SMS), (m, p)


def _tiles(e, m, n):
    """The wgmma body's output tiles: 128 x 256 blocks per split."""
    return e * -(-m // 128) * -(-n // 256)


def _waves(tiles, split, sms):
    """Waves of blocks a unit of work takes: ceil(tiles split / sms) /
    split."""
    return -(-tiles * split // sms) / split


@pytest.mark.parametrize("e,m,k,n", SHAPES)
def test_a_split_cuts_the_waves_by_a_quarter_or_is_not_taken(e, m, k, n):
    """Above M 64: K split only where the split cuts the waves of 128 x
    256 blocks a unit of work takes by a quarter or more (the next
    doubling would not)."""
    p = qm.plan(e, m, n, k, SMS)
    if m <= 64:
        assert p.split == qm.split_k(e, n, k, SMS)
        return
    tiles = _tiles(e, m, n)
    if p.split > 1:
        assert (_waves(tiles, p.split, SMS)
                <= 0.75 * _waves(tiles, p.split // 2, SMS))
    if p.split < 4 and (k // 64) % (2 * p.split) == 0:
        assert (_waves(tiles, 2 * p.split, SMS)
                > 0.75 * _waves(tiles, p.split, SMS))


@pytest.mark.parametrize("e,m,k,n,split", [
    (1, 512, 4096, 4096, 2),     # wo: 64 tiles, half the SMs idle
    (1, 512, 4096, 6144, 1),     # wqkv: 96 tiles; 192 would take 2 waves
    (1, 512, 4096, 32000, 1),
    (8, 512, 4096, 28672, 1),
    (1, 1024, 4096, 6144, 2),    # 192 tiles: 2 waves, split 3 of 384
    (8, 320, 4096, 28672, 1),
    (8, 320, 14336, 4096, 1),
])
def test_the_plan_at_the_int8_paths_shapes(e, m, k, n, split):
    assert qm.plan(e, m, n, k, SMS) == qm.Plan(True, split)


@pytest.mark.parametrize("sms", [16, 66, 132, 264])
def test_tiles_that_leave_half_the_sms_idle_split_k(sms):
    """Where the wgmma body's tiles would leave more than half of the SMs
    idle and K divides, K is split."""
    for e, m, k, n in SHAPES + [(1, 65, 256, 208), (3, 129, 512, 192)]:
        p = qm.plan(e, m, n, k, sms)
        if p.wide and 2 * _tiles(e, m, n) <= sms and k % 128 == 0:
            assert p.split >= 2, (sms, e, m, k, n, p)


@pytest.mark.parametrize("n", [16, 112, 128, 144, 256])
def test_narrow_outputs_split_k_four_ways(n):
    """An output no wider than one 256-column tile makes 4 blocks at M
    512: the plan splits K four ways (16 blocks, still one wave)."""
    assert qm.plan(1, 512, n, 4096, SMS) == qm.Plan(True, 4)


@pytest.mark.parametrize("e,m,k,n", SHAPES + [(1, 65, 256, 208),
                                               (4000, 100, 4096, 16),
                                               (65535, 100, 256, 16),
                                               (1, 2 ** 20, 64, 2 ** 16),
                                               (10000, 8, 4096, 16),
                                               (65535, 1, 512, 16),
                                               (1, 64, 192, 16)])
def test_the_plan_keeps_the_grid_limits(e, m, k, n):
    """The kernel's grid: blocks per (entry, split) along x at most
    2^31 - 1, entries times splits along y (z for M <= 64) at most 65535;
    a split divides K into whole 64-deep steps."""
    p = qm.plan(e, m, n, k, SMS)
    assert p.split in ((1, 2, 4) if p.wide else qm.SWAP_SPLITS)
    assert (k // qm.KERNEL_K_STEP) % p.split == 0
    assert e * p.split <= qm.GRID_Y_MAX
    if p.wide:
        assert _tiles(e, m, n) // e <= 2 ** 31 - 1
    else:
        assert -(-n // qm.SWAP_COLS) <= 2 ** 31 - 1


def test_the_plan_reads_host_integers_only():
    """``plan`` takes the shape and the SM count as Python integers and
    returns integers: nothing in it can read a device tensor or sync."""
    params = inspect.signature(qm.plan).parameters
    assert list(params) == ["e", "m", "n", "k", "sms"]
    p = qm.plan(8, 320, 4096, 14336, SMS)
    assert all(type(v) in (int, bool) for v in p), p
    source = inspect.getsource(qm.plan)
    assert "torch" not in source and ".item(" not in source


# The swapped form's splits at the int8 paths' M <= 64 shapes: the seams
# at decode M 8, a B 1 draft's M 1, a verify window's M 5, M 16 and 64 (a
# packed prefill of 64 tokens), and the expert products at a small
# capacity.
@pytest.mark.parametrize("m", [1, 5, 8, 16, 64])
@pytest.mark.parametrize("e,k,n,split", [
    (1, 4096, 6144, 4),     # wqkv: 48 blocks; 4 ways cover the 132 SMs
    (1, 4096, 4096, 8),     # wo: 32 blocks; 4 ways leave 4 SMs idle
    (1, 4096, 32000, 1),    # the LM head: 250 blocks
    (8, 4096, 28672, 1),    # the expert gate/up: 1792 blocks
    (8, 14336, 4096, 1),    # the expert down: 256 blocks
])
def test_the_swapped_form_at_the_int8_paths_shapes(m, e, k, n, split):
    assert qm.plan(e, m, n, k, SMS) == qm.Plan(False, split)


@pytest.mark.parametrize("sms", [16, 66, 132, 264])
@pytest.mark.parametrize("e,k,n", [(1, 4096, 6144), (1, 4096, 4096),
                                   (1, 4096, 32000), (3, 512, 208),
                                   (1, 256, 192), (1, 192, 16)])
def test_the_swapped_form_splits_k_the_fewest_ways_that_cover_the_sms(
        sms, e, k, n):
    """At M <= 64: a split only where the unsplit blocks leave SMs idle,
    and never one more than needed to cover them; K cut into whole
    64-deep steps (at K 192, three steps: no split divides them)."""
    blocks = e * -(-n // qm.SWAP_COLS)
    p = qm.plan(e, 8, n, k, sms)
    assert (k // qm.KERNEL_K_STEP) % p.split == 0
    if p.split > 1:
        assert blocks * (p.split // 2) < sms
    nxt = 2 * p.split
    if blocks * p.split < sms and nxt in qm.SWAP_SPLITS:
        assert (k // qm.KERNEL_K_STEP) % nxt, (sms, p)
