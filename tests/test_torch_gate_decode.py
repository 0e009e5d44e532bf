"""``tools/run_decode_smoke_torch.py`` against ``tools/run_decode_smoke.py``
on one seed, on the CPU at ``tiny`` with the reference's parameters.

Decisions only: every engine's token streams (each ``drive`` in order:
bf16, int8, kvq; determinism, cache cold/hot, batched vs serial prefill,
the spread repeats), every engine's ``compile_counts`` and ticks, and the
tick-normalized TTFT line. The spread tripwire reads the wall clock and
is not held here.
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


@pytest.fixture(scope="module")
def runs():
    with one_torch_thread():
        mp = pytest.MonkeyPatch()
        try:
            ref, twin = load_tool("run_decode_smoke"), load_tool(
                "run_decode_smoke_torch")
            want = Recorder(ref, mp, "build_engine", "drive")
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                ref.main()
            got = Recorder(twin, mp, "build_engine", "drive")
            lines = []
            from k8s_dra_driver_tpu_torch.models.llama import PRESETS

            out = twin.run(tiny_params(), PRESETS["tiny"], "cpu",
                           emit=lines.append)
        finally:
            mp.undo()
        return want.calls, got.calls, out, lines, printed.getvalue()


def test_token_streams_equal_the_reference(runs):
    want, got, _, _, _ = runs
    assert len(got["drive"]) == len(want["drive"]) > 0
    assert got["drive"] == want["drive"]


def test_compile_counts_and_ticks_equal_the_reference(runs):
    want, got, _, _, _ = runs
    assert [engine_facts(e) for e in got["build_engine"]] == \
        [engine_facts(e) for e in want["build_engine"]]
    assert all(engine_facts(e)[0] == {"decode_step": 1, "prefill_chunk": 1}
               for e in got["build_engine"])


def test_deterministic_gates_pass_and_ttft_line_equal(runs):
    _, _, out, lines, printed = runs
    assert out["gates"].failures(kinds=("gate",)) == []
    ttft = [ln for ln in lines if ln.startswith("decodebench ttft:")]
    assert len(ttft) == 1 and ttft[0] in printed.splitlines()
