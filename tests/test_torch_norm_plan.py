"""K1's launch plans (``ops/norms.py::plan`` and ``backward_plan``) on the
CPU, no card: how the forward and the gradient kernel are sized, from host
integers alone, at the shapes the paths launch (a B 1 draft [1, 2048], a
verify window [5, 4096], decode [8, 4096], a packed prefill [512, 4096],
training [8192 and 16384, 4096]), at the presets' and the tests' widths
(64, 768, 1000, 2048, 4096) and past one CTA's reach (a cluster a row)."""

import inspect

import pytest

from k8s_dra_driver_tpu_torch.ops import norms

SMS = 132  # the H100's SMs
WIDTHS = [64, 768, 1000, 2048, 4096]
ROWS = [1, 5, 8, 512, 8192, 16384]


@pytest.mark.parametrize("d,threads", [
    (64, 32),       # the tiny preset: 8 slots, one warp
    (768, 96),      # the 160m preset
    (1000, 128),    # 125 slots: a ragged last warp
    (2048, 256),    # the 1b draft
    (4096, 512),    # Llama-3-8B and Mixtral-8x7B
    (8192, 1024),   # the widest row one CTA takes
    (77, 32),       # no whole 16-byte word
])
@pytest.mark.parametrize("rows", ROWS)
def test_one_cta_a_row_up_to_width_8192(rows, d, threads):
    """As many threads as the row has 8-column slots, in whole warps, one
    slot each; one CTA a row at every row count, a plain launch."""
    p = norms.plan(rows, d)
    assert p == norms.Plan(1, threads, 1, rows)
    assert p.threads * norms.SLOT >= d


@pytest.mark.parametrize("d,cluster,threads", [
    (8200, 2, 544),     # 1025 slots: 513 a CTA, in 17 warps
    (10000, 2, 640),
    (16384, 2, 1024),
    (16392, 4, 544),
    (65536, 8, 1024),   # the widest row a cluster takes
])
@pytest.mark.parametrize("rows", [1, 8, 512])
def test_a_wider_row_takes_a_cluster(rows, d, cluster, threads):
    """Past one CTA's 1024 slots: a cluster of the fewest CTAs (up to 8,
    the portable size) that cover the row, one slot a thread, whole
    warps."""
    p = norms.plan(rows, d)
    assert p == norms.Plan(cluster, threads, 1, rows * cluster)
    assert p.cluster * p.threads * norms.SLOT >= d
    assert p.threads <= norms.MAX_THREADS and p.threads % 32 == 0


@pytest.mark.parametrize("d", WIDTHS)
def test_the_forward_never_leaves_a_slot_uncovered(d):
    for rows in ROWS:
        p = norms.plan(rows, d)
        assert p.cluster * p.threads * norms.SLOT >= d
        assert p.slots == 1 and p.threads <= norms.MAX_THREADS


@pytest.mark.parametrize("d,threads,slots", [(64, 32, 1), (768, 96, 1),
                                             (1000, 128, 1), (2048, 256, 1),
                                             (4096, 256, 2), (8192, 256, 4)])
@pytest.mark.parametrize("rows,grid", [(1, 1), (20, 20), (8192, 264),
                                       (16384, 264)])
def test_the_gradient_plan(d, threads, slots, rows, grid):
    """The gradient kernel: whole warps up to 256 threads a CTA, the slots
    a thread that cover the row, 2 CTAs an SM and at most one a row (the
    grid is also the scratch's row count)."""
    p = norms.backward_plan(rows, d, SMS)
    assert p == norms.Plan(1, threads, slots, grid)
    assert p.threads * p.slots * norms.SLOT >= d


def test_the_gradient_plan_refuses_what_no_slot_count_covers():
    with pytest.raises(ValueError, match="exceeds"):
        norms.backward_plan(8, 8200, SMS)


@pytest.mark.parametrize("fn,params", [
    (norms.plan, ["rows", "d"]),
    (norms.backward_plan, ["rows", "d", "sms"]),
])
def test_the_plans_read_host_integers_only(fn, params):
    """Both plans take Python integers and return integers: nothing in
    them can read a device tensor or sync."""
    assert list(inspect.signature(fn).parameters) == params
    for rows in (1, 8, 16384):
        p = fn(*(rows, 4096, SMS)[:len(params)])
        assert all(type(v) is int for v in p), p
    source = inspect.getsource(fn)
    assert "torch" not in source and ".item(" not in source
