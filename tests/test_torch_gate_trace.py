"""``tools/run_trace_smoke_torch.py`` against ``tools/run_trace_smoke.py``
on one seed, on the CPU at ``tiny`` with the reference's parameters.

Decisions only: each drive's token streams, ticks and submissions (OFF,
then ON, warm run and each repeat), both engines' ``compile_counts`` and
ticks, and the sealed timelines of the ON run. The overhead tripwire
reads the wall clock and is not held here.
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


def sealed(telemetry) -> tuple:
    docs = telemetry.timelines()
    return len(docs), sorted(d["outcome"] for d in docs)


@pytest.fixture(scope="module")
def runs():
    with one_torch_thread():
        mp = pytest.MonkeyPatch()
        try:
            ref = load_tool("run_trace_smoke")
            twin = load_tool("run_trace_smoke_torch")
            want = Recorder(ref, mp, "build", "drive")
            with contextlib.redirect_stdout(io.StringIO()):
                ref.main()
            got = Recorder(twin, mp, "build", "drive")
            from k8s_dra_driver_tpu_torch.models.llama import PRESETS

            out = twin.run(tiny_params(), PRESETS["tiny"], "cpu",
                           emit=lambda line: None)
        finally:
            mp.undo()
        return want.calls, got.calls, out


def test_streams_ticks_and_submissions_equal_the_reference(runs):
    want, got, _ = runs
    assert len(got["drive"]) == len(want["drive"]) == 2 * 6
    assert got["drive"] == want["drive"]


def test_compile_counts_and_ticks_equal_the_reference(runs):
    want, got, _ = runs
    # build() returns (gateway, engine, telemetry, clock box).
    assert [engine_facts(b[1]) for b in got["build"]] == \
        [engine_facts(b[1]) for b in want["build"]]


def test_every_timeline_sealed_as_the_reference(runs):
    want, got, out = runs
    assert sealed(got["build"][1][2]) == sealed(want["build"][1][2])
    assert out["sealed"] == out["submitted"] == out["timelines"]
    assert out["gates"].failures(kinds=("gate",)) == []
