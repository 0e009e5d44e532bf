"""``tools/run_compute_smoke_torch.py`` against
``tools/run_compute_smoke.py`` on one seed, on the CPU at ``tiny`` with
the reference's parameters.

Decisions only: the token streams of every drive, every engine's
``compile_counts`` and ticks, and the compute ledger's build counts of
the engine's two programs and its recompiles past the warm horizon per
variant. The ledger's ``forward`` key is not compared: the reference
traces the forward once per jitted program of every engine, the port
reports a forward shape's first use once per process
(``decode.TRACE_COUNTS``), so its count depends on what ran before in
the process. The overhead tripwire reads the wall clock and is not held
here.
"""

PROGRAMS = ("decode_step", "prefill_chunk")

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
            ref = load_tool("run_compute_smoke")
            twin = load_tool("run_compute_smoke_torch")
            want = Recorder(ref, mp, "build_engine", "drive")
            ledgers = []
            real_check = ref.check_ledger

            def check_ledger(label, telemetry, eng):
                snap = telemetry.ledger.snapshot()
                ledgers.append(dict(
                    builds={p: snap["builds"].get(p) for p in PROGRAMS},
                    recompiles=snap["recompilesSinceWarm"]))
                return real_check(label, telemetry, eng)

            mp.setattr(ref, "check_ledger", check_ledger)
            with contextlib.redirect_stdout(io.StringIO()):
                ref.main()
            got = Recorder(twin, mp, "build_engine", "drive")
            from k8s_dra_driver_tpu_torch.models.llama import PRESETS

            out = twin.run(tiny_params(), PRESETS["tiny"], "cpu",
                           emit=lambda line: None)
        finally:
            mp.undo()
        return want.calls, got.calls, out, ledgers


def test_token_streams_equal_the_reference(runs):
    want, got, _, _ = runs
    assert len(got["drive"]) == len(want["drive"]) == 3 * 2 * 6
    assert got["drive"] == want["drive"]


def test_compile_counts_and_ticks_equal_the_reference(runs):
    want, got, _, _ = runs
    assert [engine_facts(e) for e in got["build_engine"]] == \
        [engine_facts(e) for e in want["build_engine"]]


def test_ledger_builds_equal_the_reference(runs):
    _, _, out, ledgers = runs
    ours = [dict(builds={p: v["ledger"]["builds"].get(p) for p in PROGRAMS},
                 recompiles=v["ledger"]["recompiles"])
            for v in out["variants"].values()]
    assert ours == ledgers
    assert all(v["builds"] == {"decode_step": 1, "prefill_chunk": 1}
               for v in ours)


def test_deterministic_gates_pass(runs):
    _, _, out, _ = runs
    assert out["gates"].failures(kinds=("gate",)) == []
