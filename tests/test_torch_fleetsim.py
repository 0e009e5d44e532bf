"""The port's fleet soak simulator against the reference's.

Twins of ``test_fleetsim.py``: the mini soak runs once per package
(module-scoped fixtures) and every test makes the reference test's
assertions on both reports and requires the part of the report it reads
to be equal. The port's mini artifact must be the reference's byte for
byte and hash to ``MINI_SHA256`` (``chip_smoke.py`` phase 31 replays it on
the card's host and holds it to the same digest). The full smoke profile
stays under the ``slow`` marker, as in the reference.
"""

from __future__ import annotations

import hashlib
import json
import random

import pytest

from test_torch_kube import PORT, REF, SIDES

MINI_SHA256 = "273e0fdc2686467f8e67e87bd232302c3353c7beff431d1e8febd18314cbc505"


def fleetsim(side):
    return side("fleetsim")


@pytest.fixture(scope="module")
def reports():
    """One mini soak per package (the tests below only read them)."""
    return {side: fleetsim(side).FleetSim(fleetsim(side).mini_scenario()).run()
            for side in SIDES}


@pytest.fixture(scope="module")
def metered():
    """One mini soak per package on a registry of its own: the report
    and the registry's exposition."""
    out = {}
    for side in SIDES:
        registry = side("utils.metrics").Registry()
        report = fleetsim(side).FleetSim(fleetsim(side).mini_scenario(),
                                         registry=registry).run()
        out[side] = (report, registry.render())
    return out


def each(reports, read):
    """``read(side, report)`` on both packages; their values must be
    equal. Returns the port's."""
    ref, port = (read(side, reports[side]) for side in (REF, PORT))
    assert port == ref
    return port


def on_both(read):
    ref, port = (read(side) for side in (REF, PORT))
    assert port == ref
    return port


# -- scenario math ---------------------------------------------------------


def test_diurnal_rate_trough_and_peak():
    def read(side):
        spec = fleetsim(side).mini_scenario()
        cls = spec.classes[0]
        rates = [spec.rate(cls, t) for t in (0.0, spec.duration_s / 2,
                                             spec.duration_s)]
        assert rates[0] == pytest.approx(cls.base_rps)
        assert rates[1] == pytest.approx(cls.peak_rps)
        assert rates[2] == pytest.approx(cls.base_rps)
        return rates

    on_both(read)


def test_flash_rate_confined_to_window():
    def read(side):
        spec = fleetsim(side).mini_scenario()
        lo = spec.flash.start_frac * spec.duration_s
        hi = spec.flash.end_frac * spec.duration_s
        rates = [spec.flash_rate(t) for t in (lo, hi - 1e-9, lo - 1e-9, hi)]
        assert rates == [spec.flash.rps, spec.flash.rps, 0.0, 0.0]
        return rates

    on_both(read)


def test_oracle_replicas_clamped():
    def read(side):
        spec = fleetsim(side).mini_scenario()
        n = [spec.oracle_replicas(f * spec.duration_s)
             for f in (0.0, 0.25, 0.5, 0.75, 1.0)]
        assert all(spec.min_replicas <= k <= spec.max_replicas for k in n)
        return n

    on_both(read)


def test_events_abs_sorted():
    def read(side):
        spec = fleetsim(side).mini_scenario()
        events = [(t, e.kind) for t, e in spec.events_abs()]
        times = [t for t, _ in events]
        assert times == sorted(times) and len(times) == len(spec.chaos)
        return events

    on_both(read)


def test_poisson_draw_deterministic():
    def read(side):
        draw = fleetsim(side).poisson_draw
        a = [draw(random.Random(5), 0.8) for _ in range(20)]
        b = [draw(random.Random(5), 0.8) for _ in range(20)]
        assert a == b
        assert draw(random.Random(5), 0.0) == 0
        return a

    on_both(read)


def test_class_prompts_seeded_and_shaped():
    def read(side):
        fs = fleetsim(side)
        spec = fs.mini_scenario()
        prompts = fs.build_class_prompts(spec)
        assert prompts == fs.build_class_prompts(spec)
        for cls in spec.classes:
            assert len(prompts[cls.name]) == cls.n_systems
            assert all(len(p) == cls.system_len for p in prompts[cls.name])
        return prompts

    on_both(read)


# -- determinism -----------------------------------------------------------


def test_mini_artifact_equals_the_reference_byte_for_byte(tmp_path, reports):
    blobs = {}
    for side in SIDES:
        path = tmp_path / f"{side}.json"
        fleetsim(side).write_artifact(reports[side], str(path))
        blobs[side] = path.read_bytes()
    assert blobs[PORT] == blobs[REF]
    assert hashlib.sha256(blobs[PORT]).hexdigest() == MINI_SHA256


def test_same_seed_byte_identical_artifact(tmp_path, reports):
    def read(side, report):
        fs = fleetsim(side)
        again = fs.FleetSim(fs.mini_scenario()).run()
        a, b = tmp_path / f"{side}-a.json", tmp_path / f"{side}-b.json"
        fs.write_artifact(report, str(a))
        fs.write_artifact(again, str(b))
        assert a.read_bytes() == b.read_bytes()
        return hashlib.sha256(b.read_bytes()).hexdigest()

    assert each(reports, read) == MINI_SHA256


def test_wall_clock_is_the_only_nondeterministic_section(tmp_path, reports):
    def read(side, report):
        path = tmp_path / f"{side}.json"
        fleetsim(side).write_artifact(
            report, str(path),
            wall_clock={"generatedAt": 1e9, "runSeconds": 1.0})
        doc = json.loads(path.read_text())
        assert doc.pop("wallClock") == {"generatedAt": 1e9,
                                        "runSeconds": 1.0}
        assert doc == json.loads(json.dumps(report))
        return doc

    each(reports, read)


def test_perturbed_seed_diverges(reports):
    def read(side, report):
        fs = fleetsim(side)
        other = fs.FleetSim(fs.mini_scenario(seed=4321)).run()
        assert json.dumps(other, sort_keys=True) != json.dumps(
            report, sort_keys=True)
        assert other["pass"], {
            g: v for g, v in other["gates"].items() if not v["pass"]}
        return other

    each(reports, read)


def test_elastic_section_carries_no_wall_time(reports):
    def read(side, report):
        assert report["elastic"], "no elastic resizes recorded"
        for entry in report["elastic"]:
            assert "at" not in entry
        directions = [e["direction"] for e in report["elastic"]]
        assert "shrink" in directions and "grow" in directions
        return report["elastic"]

    each(reports, read)


# -- the gates -------------------------------------------------------------


def test_all_gates_pass(reports):
    def read(side, report):
        assert set(report["gates"]) == set(fleetsim(side).GATES)
        failed = {g: v for g, v in report["gates"].items() if not v["pass"]}
        assert not failed, failed
        assert report["pass"]
        return report["gates"]

    each(reports, read)


def test_zero_admitted_loss_is_typed(reports):
    def read(side, report):
        loss = report["loss"]
        assert loss["lost"] == 0
        assert loss["unclassified"] == 0
        assert loss["expired-deadline"] == 0
        assert loss["served"] > 0
        assert loss["submitted"] == (
            loss["served"] + loss["shed-watermark"]
            + loss["expired-deadline"] + loss["lost"]
            + loss["unclassified"])
        assert report["chaos"]["failovers"] >= 1
        assert loss["retried"] >= 1
        for cls_losses in report["lossByClass"].values():
            assert set(cls_losses) == set(fleetsim(side).REQUEST_OUTCOMES)
        return loss, report["lossByClass"]

    each(reports, read)


def test_gang_strands_then_admits_via_executed_plan(reports):
    def read(side, report):
        defrag = report["defrag"]
        assert defrag["unsatReason"] == "gang"
        assert defrag["gangDevices"] == ["tpu-6", "tpu-7"]
        assert any(e["state"] == "completed" for e in defrag["executions"])
        assert defrag["plan"]["outcome"] == "planned"
        assert defrag["plan"]["migrations"], "executed plan lists none"
        return defrag

    each(reports, read)


def test_auditor_silent_every_tick(reports):
    def read(side, report):
        assert report["audit"]["passes"] > 0
        assert report["audit"]["findings"] == 0
        return report["audit"]

    each(reports, read)


def test_slo_summary_within_budgets(reports):
    def read(side, report):
        spec = fleetsim(side).mini_scenario()
        classes = report["slo"]["classes"]
        for name, ttft_budget, e2e_budget in spec.p99_budgets:
            assert classes[name]["ttftP99S"] <= ttft_budget
            assert classes[name]["e2eP99S"] <= e2e_budget
            assert classes[name]["requests"] > 0
        return report["slo"]

    each(reports, read)


def test_prefix_cache_exercised_by_flash_crowd(reports):
    def read(side, report):
        cache = report["prefixCache"]
        assert cache["lookups"] > 0 and cache["hits"] > 0
        assert cache["hitRate"] > 0.5
        return cache

    each(reports, read)


def test_chaos_timeline_complete(reports):
    def read(side, report):
        spec = fleetsim(side).mini_scenario()
        kinds = [e["kind"] for e in report["chaos"]["timeline"]]
        assert kinds == [e.kind for _, e in spec.events_abs()]
        return report["chaos"]

    each(reports, read)


def test_kv_hit_rate_gate_measures_and_agrees(reports):
    def read(side, report):
        gate = report["gates"]["kv-hit-rate"]
        assert gate["pass"]
        assert gate["value"]["measuredHits"] == gate["value"]["engineHits"]
        assert gate["value"]["measuredHitRate"] >= (
            gate["budget"]["measuredHitRate"])
        res = report["kvResidency"]
        assert res["fleet"]["hits"] == gate["value"]["measuredHits"]
        for rid, rep in res["replicas"].items():
            assert not rep["counterDrift"], rid
            assert rep["ledger"]["staleKeys"] <= rep["ledger"]["predictedKeys"]
        return gate, res

    each(reports, read)


# -- metrics ---------------------------------------------------------------


def test_fleet_metric_family_rendered_with_explicit_zeros(metered):
    def read(side, run):
        report, text = run
        for family in (
            "tpu_dra_fleet_ticks_total",
            "tpu_dra_fleet_requests_total",
            "tpu_dra_fleet_slo_p99_seconds",
            "tpu_dra_fleet_chip_seconds",
            "tpu_dra_fleet_autoscaler_efficiency_ratio",
            "tpu_dra_fleet_audit_findings_total",
            "tpu_dra_fleet_gate_failures_total",
        ):
            assert family in text, f"{family} missing from exposition"
        assert report["pass"]
        for gate in fleetsim(side).GATES:
            assert f'tpu_dra_fleet_gate_failures_total{{gate="{gate}"}} 0' \
                in text
        for cls in fleetsim(side).mini_scenario().classes:
            for outcome in fleetsim(side).REQUEST_OUTCOMES:
                assert (f'latency_class="{cls.name}",outcome="{outcome}"'
                        in text)
        return text

    each(metered, read)


def test_component_metrics_stay_off_the_fleet_registry(metered):
    def read(side, run):
        _, text = run
        assert "tpu_dra_gw_" not in text
        assert "tpu_dra_alloc_" not in text
        return sorted({ln.split("{")[0].split(" ")[0]
                       for ln in text.splitlines() if not ln.startswith("#")})

    each(metered, read)


# -- the full smoke profile ------------------------------------------------


@pytest.mark.slow
def test_smoke_profile_passes_all_gates(tmp_path):
    blobs = []
    for side in SIDES:
        fs = fleetsim(side)
        report = fs.FleetSim(fs.smoke_scenario()).run()
        failed = {g: v for g, v in report["gates"].items() if not v["pass"]}
        assert not failed, failed
        assert report["pass"]
        assert report["defrag"]["gangDevices"] == ["tpu-6", "tpu-7"]
        assert report["chaos"]["failovers"] >= 1
        assert report["elastic"]
        assert report["audit"]["passes"] > 0
        path = tmp_path / f"{side}-FLEET_r01.json"
        fs.write_artifact(report, str(path))
        blobs.append(path.read_bytes())
    assert blobs[1] == blobs[0]


@pytest.mark.slow
def test_smoke_profile_reproducible():
    def read(side):
        fs = fleetsim(side)
        a = fs.FleetSim(fs.smoke_scenario()).run()
        b = fs.FleetSim(fs.smoke_scenario()).run()
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
        return a

    on_both(read)
