"""``tools/run_gateway_smoke_torch.py`` against ``tools/run_gateway_smoke.py``
on one seed, on the CPU at ``tiny`` with the reference's parameters.

Decisions only: the reference tool runs in process (its
``_decodebench.run_gateway_bench`` recorded), the twin runs on the
reference's ``init_params(PRESETS["tiny"], PRNGKey(0))`` converted by
``params_from_numpy``, and every routing decision of the bench must be
equal: tick counts, p99 token ticks, hit rates, evictions, sheds,
``compile_counts`` and the tick-normalized speedup. The wall-clock req/s
and the milliseconds derived from them are not held here.
"""

import contextlib
import io

import pytest

import _decodebench
import _decodebench_torch
from test_torch_gate_common import load_tool, one_torch_thread, tiny_params

DECISIONS = ("ticks", "ticks_all", "ticks_round_robin", "p99_token_ticks",
             "p99_token_ticks_round_robin", "prefix_hit_rate",
             "prefix_hit_rate_round_robin", "affinity_hit_rate", "evictions",
             "evictions_round_robin", "shed_rate", "compile_counts",
             "speedup_rps_ticks", "n_replicas", "n_requests", "n_systems",
             "num_blocks_per_replica")


@pytest.fixture(scope="module")
def runs():
    with one_torch_thread():
        mp = pytest.MonkeyPatch()
        try:
            ref, twin = load_tool("run_gateway_smoke"), load_tool(
                "run_gateway_smoke_torch")
            want = []
            real = _decodebench.run_gateway_bench

            def recorded(*args, **kwargs):
                want.append(real(*args, **kwargs))
                return want[-1]

            mp.setattr(_decodebench, "run_gateway_bench", recorded)
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                ref.failures.clear()
                rc = ref.main()
            lines = []
            from k8s_dra_driver_tpu_torch.models.llama import PRESETS

            out = twin.run(tiny_params(), PRESETS["tiny"], "cpu",
                           emit=lines.append)
        finally:
            mp.undo()
        return rc, want, printed.getvalue(), out, lines


def test_routing_decisions_equal_the_reference(runs):
    rc, want, _, out, _ = runs
    assert rc == 0 and len(want) == 1
    ref, got = want[0]["detail"], out["bench"]["detail"]
    assert {k: got[k] for k in DECISIONS} == {k: ref[k] for k in DECISIONS}
    # The smoke's traffic, as the reference prints it.
    assert (got["ticks"], got["ticks_round_robin"]) == (131, 199)
    assert got["speedup_rps_ticks"] == 1.519


def test_metric_name_and_keys_equal_the_reference(runs):
    _, want, _, out, _ = runs
    ref, got = want[0], out["bench"]
    assert got["metric"] == ref["metric"] == "llama3_tiny_gateway_rps_r2_b4"
    # spread_flags marks a wall-clock spread past 2% (``spread_flag``),
    # which either run may or may not show.
    assert got.keys() - {"spread_flag"} == ref.keys() - {"spread_flag"}
    assert got["detail"].keys() == ref["detail"].keys()
    assert (got["unit"], got["repeats"]) == (ref["unit"], ref["repeats"])


def test_gate_lines_equal_the_reference(runs):
    """Every gate line (the drain's too) reads as the reference's: the
    gates' texts carry only decisions."""
    _, _, printed, out, lines = runs
    gates = [ln for ln in lines if ln.startswith("[")]
    assert gates == [ln for ln in printed.splitlines()
                     if ln.startswith("[")]
    assert len(gates) == 8 and all(ln.startswith("[ok ]") for ln in gates)
    assert out["gates"].failures() == []
    assert out["drain"]["lost"] == 0 and out["drain"]["rerouted"] > 0


def test_main_passes_on_the_cpu(capsys):
    """``make gatewaybench-torch DEVICE=cpu``: the twin's own parameters
    (``init_params(seed=0)``), every gate held, exit 0."""
    with one_torch_thread():
        rc = load_tool("run_gateway_smoke_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert text.rstrip().endswith("gateway smoke: all gates passed")
    assert "131 vs 199 ticks" in text


@pytest.mark.parametrize("metrics", [
    [{"metric": "llama3_tiny_gateway_rps_r2_b4", "value": 100.0,
      "spread": 2.5}],
    [{"metric": "llama3_tiny_gateway_rps_r2_b4", "value": 100.0,
      "spread": 2.0}],
    [{"metric": "x_decode_toks_b8", "value": 10.0, "spread": 0.3},
     {"metric": "x_prefill_toks_b8", "value": 10.0, "spread": None},
     {"metric": "x_other", "value": 1.0, "spread": 5.0},
     {"metric": "x_gateway_rps_r2", "value": 0, "spread": 1.0}],
], ids=["over", "at-limit", "mixed"])
def test_spread_flags_equal_the_reference(metrics):
    import copy

    ref, got = copy.deepcopy(metrics), copy.deepcopy(metrics)
    assert _decodebench_torch.spread_flags(got) == \
        _decodebench.spread_flags(ref)
    assert got == ref


def test_the_traffic_vocabulary_must_fit_the_model():
    from k8s_dra_driver_tpu_torch.models.llama import PRESETS

    with pytest.raises(ValueError, match="exceeds"):
        _decodebench_torch.run_gateway_bench(
            preset="tiny", device="cpu", vocab_size=PRESETS["tiny"].vocab_size
            + 1, params={}, repeats=1)
