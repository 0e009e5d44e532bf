"""``tools/run_kv_smoke_torch.py`` against ``tools/run_kv_smoke.py`` on one
seed, on the CPU at ``tiny`` with the reference's parameters.

Decisions only: the token streams of every drive (per variant: OFF, then
ON, warm run and each repeat), every engine's ``compile_counts`` and
ticks, and each telemetry-ON engine's residency digest (inserted,
evicted and indexed blocks) and pool occupancy by state. The overhead
tripwire reads the wall clock and is not held here.
"""

import contextlib
import io

import pytest

from test_torch_gate_common import (
    Recorder,
    engine_facts,
    load_tool,
    one_torch_thread,
    tiny_params,
)

DIGEST_KEYS = ("insertedBlocks", "evictedBlocks", "indexedBlocks")


def ledger(engine) -> tuple:
    digest = engine.kv_residency()
    return ({k: digest[k] for k in DIGEST_KEYS},
            engine.kv_debug()["occupancy"])


@pytest.fixture(scope="module")
def runs():
    with one_torch_thread():
        mp = pytest.MonkeyPatch()
        try:
            ref, twin = load_tool("run_kv_smoke"), load_tool("run_kv_smoke_torch")
            want = Recorder(ref, mp, "build_engine", "drive")
            with contextlib.redirect_stdout(io.StringIO()):
                ref.main()
            got = Recorder(twin, mp, "build_engine", "drive")
            from k8s_dra_driver_tpu_torch.models.llama import PRESETS

            out = twin.run(tiny_params(), PRESETS["tiny"], "cpu",
                           emit=lambda line: None)
        finally:
            mp.undo()
        return want.calls, got.calls, out


def test_token_streams_equal_the_reference(runs):
    want, got, _ = runs
    assert len(got["drive"]) == len(want["drive"]) == 3 * 2 * 6
    assert got["drive"] == want["drive"]


def test_compile_counts_and_ticks_equal_the_reference(runs):
    want, got, _ = runs
    assert [engine_facts(e) for e in got["build_engine"]] == \
        [engine_facts(e) for e in want["build_engine"]]


def test_digest_and_occupancy_equal_the_reference(runs):
    want, got, _ = runs
    # Engines alternate OFF, ON per variant: the ON ones carry the ledger.
    ours = [ledger(e) for e in got["build_engine"][1::2]]
    assert ours == [ledger(e) for e in want["build_engine"][1::2]]
    assert all(d["evictedBlocks"] > 0 for d, _ in ours)


def test_deterministic_gates_pass(runs):
    _, _, out = runs
    assert out["gates"].failures(kinds=("gate",)) == []
    assert [w for ok, w, k in out["gates"].results if k == "wall"]
