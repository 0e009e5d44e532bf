"""The port's fleet doctor against the reference's, over the cluster sim.

Twins of ``test_doctor.py`` and of the doctor cases of
``test_gateway.py``, ``test_request_trace.py``, ``test_defrag.py`` and
``test_defrag_executor.py``. The doctor-ready fleet (two node plugins
with real debug HTTP servers, the ICI slice controller, one FakeKubeClient)
is built by each package's own gate: ``tools/run_doctor_sim.py`` for the
reference, ``tools/run_doctor_sim_torch.py`` for the port, whose Drivers
answer through ``kubeletplugin.LocalTransport`` (a fleet in one
process). Each scenario runs once per package, makes the reference
test's assertions, and returns what it observed: statuses, findings,
rendered reports, scraped holds and bundle members. The two must be
equal once the report's clock, hold ages,
ports and directories are masked. One difference is by design: the
port's ``recompile-storm`` finding says a recompile re-pays a CUDA-graph
capture, where the reference's says trace and XLA time
(``RECOMPILE_TEXT``).

The reference's Drivers serve gRPC on unix sockets under the fleet's
directory; it is made with ``tempfile.mkdtemp`` (a short path), since a
socket path of 106 bytes or more fails to bind.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import sys
import tarfile
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from test_torch_allocator import chip_claim
from test_torch_defrag import executor, fragmented_4x1, stuck_gang, unsat
from test_torch_kube import PORT, REF, SIDES, both
from test_torch_plugin_driver import first_difference

DRIVER = "tpu.google.com"
TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "tools")
# (the reference's words, the port's) in the recompile-storm finding.
RECOMPILE_TEXT = ("re-pays trace+XLA time on the serving path",
                  "re-pays a CUDA-graph capture on the serving path")


def _load_sims():
    sys.path.insert(0, TOOLS)
    try:
        import run_doctor_sim
        import run_doctor_sim_torch
    finally:
        sys.path.pop(0)
    return {REF: run_doctor_sim, PORT: run_doctor_sim_torch}


SIMS = _load_sims()


def doctor(side):
    return side("doctor")


def wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def findings(found):
    """(severity, check, subject, detail) of each finding."""
    return [(f.severity, f.check, f.subject, f.detail) for f in found]


def masked(obj, root=""):
    """``obj`` with the doctor's clock, hold ages, local ports and the
    fleet's directory masked, and the port's recompile text written as
    the reference's."""
    if isinstance(obj, dict):
        return {k: masked(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [masked(v, root) for v in obj]
    if isinstance(obj, str):
        if root:
            obj = obj.replace(root, "<dir>")
        obj = re.sub(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\dZ", "<t>", obj)
        obj = re.sub(r"held \d+s", "held <n>s", obj)
        obj = re.sub(r"127\.0\.0\.1:\d+", "127.0.0.1:<port>", obj)
        return obj.replace(RECOMPILE_TEXT[1], RECOMPILE_TEXT[0])
    return obj


@contextlib.contextmanager
def fleet(side):
    """Two node plugins with real debug HTTP servers + the controller,
    against one FakeKubeClient, built by the side's doctor gate. Yields
    (client, drivers, urls, root)."""
    sim = SIMS[side]
    root = tempfile.mkdtemp(prefix="dr-")
    client = side("kube").FakeKubeClient()
    drivers, servers = {}, {}
    mgr = None
    try:
        for h, name in enumerate(["node-a", "node-b"]):
            drivers[name], servers[name] = sim.start_node(client, root,
                                                          name, h)
        mgr = side("controller.slice_manager").IciSliceManager(client)
        mgr.start()
        assert wait_for(lambda: len(client.list(
            side("kube").RESOURCE_SLICES)) >= 3)
        urls = {n: f"http://127.0.0.1:{s.port}" for n, s in servers.items()}
        yield client, drivers, urls, root
    finally:
        if mgr is not None:
            mgr.stop(cleanup=False)
        for name in drivers:
            servers[name].stop()
            drivers[name].shutdown()
        shutil.rmtree(root, ignore_errors=True)


def twin(scenario):
    """``scenario(side, client, drivers, urls)`` on each package's fleet;
    the observations, masked, must be equal. Returns the port's."""
    seen = []
    for side in SIDES:
        with fleet(side) as (client, drivers, urls, root):
            seen.append(json.loads(json.dumps(
                masked(scenario(side, client, drivers, urls), root))))
    assert seen[1] == seen[0], first_difference(seen[0], seen[1])
    return seen[1]


# -- TestDoctorCleanFleet ------------------------------------------------------


def test_occupancy_matches_prepared_claims_exactly():
    def scenario(side, client, drivers, urls):
        expected = SIMS[side].seed_claims(client, drivers)
        dr = doctor(side)
        report, found, status = dr.run(urls, kube_client=client)
        assert status == 0
        assert not [f for f in found if f.severity == dr.SEVERITY_DRIFT]
        assert "diagnosis: CLEAN" in report
        holds = {}
        for node, want in expected.items():
            scrape = dr.collect_node(node, urls[node])
            held = {d["name"] for h in scrape.holds
                    for d in h.get("devices", [])}
            assert held == want
            assert sum(scrape.usage["occupied"]["chip"].values()) == len(want)
            holds[node] = sorted(held)
        return dict(report=report, findings=findings(found), holds=holds)

    twin(scenario)


def test_bundle_tar_contains_raw_documents():
    def scenario(side, client, drivers, urls):
        SIMS[side].seed_claims(client, drivers)
        root = os.path.dirname(drivers["node-a"].config.state_root)
        bundle = os.path.join(root, "bundle.tar")
        report, _, status = doctor(side).run(urls, kube_client=client,
                                             bundle=bundle)
        assert status == 0
        with tarfile.open(bundle) as tar:
            names = sorted(tar.getnames())
            assert {"report.txt", "findings.json",
                    "cluster/resourceslices.json",
                    "cluster/resourceclaims.json"} <= set(names)
            for node in urls:
                for doc in ("metrics.txt", "usage.json", "traces.jsonl",
                            "readyz.txt"):
                    assert f"nodes/{node}/{doc}" in names
            usage = json.load(tar.extractfile("nodes/node-a/usage.json"))
            assert usage["node"] == "node-a" and len(usage["holds"]) == 1
            assert tar.extractfile("report.txt").read().decode() == report
            claims = json.load(
                tar.extractfile("cluster/resourceclaims.json"))
        return dict(members=names, claims=claims,
                    holds=[(h["claimUid"], h["devices"])
                           for h in usage["holds"]])

    twin(scenario)


# -- TestDoctorDrift -------------------------------------------------------------


def test_corrupted_checkpoint_and_cdi_flagged():
    def scenario(side, client, drivers, urls):
        SIMS[side].seed_claims(client, drivers)
        victim = drivers["node-a"]
        victim.state.cdi.create_claim_spec_file("uid-orphan", {}, {})
        path = victim.state.checkpoint.path
        with open(path) as f:
            content = f.read()
        with open(path, "w") as f:
            f.write(content[: len(content) // 2])
        node_findings = victim.auditor.run_once()
        assert {f.check for f in node_findings} >= {"checkpoint", "cdi"}
        report, found, status = doctor(side).run(urls, kube_client=client)
        assert status == 1
        subjects = {f.subject for f in found if f.check == "node-audit"}
        assert {"node-a/checkpoint", "node-a/cdi"} <= subjects
        assert "node-b" not in str(subjects)
        assert "drift" in report
        return dict(report=report, findings=findings(found),
                    auditor=sorted((f.check, f.subject)
                                   for f in node_findings))

    twin(scenario)


def test_claim_gone_from_apiserver_is_drift():
    def scenario(side, client, drivers, urls):
        SIMS[side].seed_claims(client, drivers)
        client.delete(side("kube").RESOURCE_CLAIMS, "wl-0", namespace="sim")
        report, found, status = doctor(side).run(urls, kube_client=client)
        assert status == 1
        assert any(f.check == "claim-gone" and f.subject == "node-a/sim-uid-0"
                   for f in found)
        return dict(report=report, findings=findings(found))

    twin(scenario)


def test_claim_prepared_on_wrong_node_is_drift():
    def scenario(side, client, drivers, urls):
        sim = SIMS[side]
        alloc = side("kube.allocator").ReferenceAllocator(client)
        claim = sim.claim_obj("uid-wrong", "misplaced")
        alloc.allocate(claim, node_name="node-a")
        client.create(side("kube").RESOURCE_CLAIMS, claim, namespace="sim")
        sim.prepare(drivers["node-b"], claim)
        for d in drivers.values():
            d.auditor.run_once()
        report, found, status = doctor(side).run(urls, kube_client=client)
        assert status == 1
        assert any(f.check == "wrong-node" and f.subject == "node-b/uid-wrong"
                   for f in found)
        assert any(f.check == "not-prepared"
                   and f.subject == "node-a/uid-wrong" for f in found)
        return dict(report=report, findings=findings(found))

    twin(scenario)


class ErrorPage(BaseHTTPRequestHandler):
    def do_GET(self):
        body = b"<html>upstream connect error</html>"
        self.send_response(503)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_metrics_error_body_is_collection_error():
    srv = HTTPServer(("127.0.0.1", 0), ErrorPage)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        def scenario(side, client, drivers, urls):
            dr = doctor(side)
            urls = dict(urls, **{
                "node-proxy": f"http://127.0.0.1:{srv.server_port}"})
            report, found, status = dr.run(urls, kube_client=client,
                                           timeout=2.0)
            assert status == 2
            errs = [f for f in found if f.severity == dr.SEVERITY_ERROR
                    and f.subject == "node-proxy"]
            assert any("/metrics" in f.detail for f in errs)
            return dict(report=report, findings=findings(found))

        twin(scenario)
    finally:
        srv.shutdown()
        srv.server_close()


def test_unreachable_node_is_collection_error():
    def scenario(side, client, drivers, urls):
        dr = doctor(side)
        urls = dict(urls, **{"node-gone": "http://127.0.0.1:1"})
        report, found, status = dr.run(urls, kube_client=client,
                                       timeout=0.5)
        assert status == 2
        assert any(f.severity == dr.SEVERITY_ERROR
                   and f.subject == "node-gone" for f in found)
        return dict(report=report, findings=findings(found))

    twin(scenario)


# -- TestNodeNameMismatch --------------------------------------------------------


def test_nickname_is_collection_error_not_false_drift():
    def scenario(side, client, drivers, urls):
        SIMS[side].seed_claims(client, drivers)
        dr = doctor(side)
        nicknamed = {"a-nickname": urls["node-a"], "node-b": urls["node-b"]}
        report, found, status = dr.run(nicknamed, kube_client=client)
        assert not any(f.check in ("wrong-node", "not-prepared")
                       for f in found)
        errs = [f for f in found if f.severity == dr.SEVERITY_ERROR
                and f.subject == "a-nickname"]
        assert any("--node mapping" in f.detail for f in errs)
        assert status == 2
        return dict(report=report, findings=findings(found))

    twin(scenario)


# -- the gate and the CLI --------------------------------------------------------


def test_doctor_gate_passes_on_both_packages(capsys):
    """``make doctor``'s three phases (clean, drift, explain) exit 0 on
    each package's gate."""
    assert SIMS[REF].main() == 0
    assert SIMS[PORT].main() == 0
    err = capsys.readouterr().err.splitlines()
    gate = [ln for ln in err if ln.startswith("doctor sim gate:")]
    assert len(gate) == 2 and gate[0] == gate[1]


def test_cli_json_against_a_live_fleet(capsys):
    def scenario(side, client, drivers, urls):
        SIMS[side].seed_claims(client, drivers)
        dr = doctor(side)
        bad = dr.main(["--node", "node-a"])
        assert bad == 2
        argv = [a for n, u in sorted(urls.items())
                for a in ("--node", f"{n}={u}")]
        capsys.readouterr()
        status = dr.main(argv + ["--no-kube", "--json"])
        out = capsys.readouterr().out
        assert status == 0
        return dict(status=status, listed=json.loads(out))

    twin(scenario)


# -- the scrape-free checks (TestIciClassification, TestUsageScrapeFailure,
# TestExplainCheck, TestRenderDefensive, TestMetricsParser, TestSloCheck,
# TestKvResidencyCheck) -----------------------------------------------------


def node_pool_named_ici_is_not_a_channel(side):
    cluster = {
        "resourceSlices": [],
        "resourceClaims": [{
            "metadata": {"uid": "u1", "namespace": "ns", "name": "w"},
            "status": {"allocation": {"devices": {"results": [
                {"driver": DRIVER, "pool": "ici-rack1-host0",
                 "device": "tpu-0"},
                {"driver": DRIVER, "pool": "ici-slice0-abc123",
                 "device": "ici-channel-5"},
            ]}}},
        }],
    }
    published, allocated = doctor(side).ici_occupancy(cluster, DRIVER)
    assert allocated == 1
    return published, allocated


def failed_usage_scrape_is_not_read_as_no_holds(side):
    dr = doctor(side)
    scrape = dr.NodeScrape(name="node-a", url="http://x")
    scrape.errors.append("/debug/usage: boom")
    cluster = {"resourceSlices": [], "resourceClaims": [{
        "metadata": {"uid": "uid-1", "namespace": "ns", "name": "wl"},
        "status": {"allocation": {"devices": {"results": [{
            "driver": DRIVER, "pool": "node-a", "device": "tpu-0"}]}}},
    }]}
    found = dr.fleet_findings([scrape], cluster, DRIVER)
    assert not any(f.check == "not-prepared" for f in found)
    assert any(f.check == "collect" and f.subject == "node-a" for f in found)
    return findings(found)


def unsat_scrape(side, name="node-a", uid="uid-stuck", outcome="unsat",
                 reason="gang"):
    scrape = doctor(side).NodeScrape(name=name, url="http://x")
    scrape.allocations_text = json.dumps({
        "outcome": outcome, "reason": reason,
        "detail": "request 'r0': 1 candidate(s) rejected at stage 'gang'",
        "claim": {"uid": uid, "namespace": "ns", "name": "wl-stuck"},
    }) + "\n"
    return scrape


EMPTY = {"resourceSlices": [], "resourceClaims": []}


def unsat_record_is_flagged_with_runbook_hint(side):
    dr = doctor(side)
    found = dr.fleet_findings([unsat_scrape(side)], EMPTY, DRIVER)
    explain = [f for f in found if f.check == "explain"]
    assert len(explain) == 1
    f = explain[0]
    assert f.severity == dr.SEVERITY_DRIFT and f.subject == "ns/wl-stuck"
    assert "'gang'" in f.detail
    assert side("kube.allocator").RUNBOOK_HINTS["gang"] in f.detail
    return findings(found)


def since_allocated_claim_is_stale_history(side):
    cluster = {"resourceSlices": [], "resourceClaims": [{
        "metadata": {"uid": "uid-stuck", "namespace": "ns",
                     "name": "wl-stuck"},
        "status": {"allocation": {"devices": {"results": []}}},
    }]}
    found = doctor(side).fleet_findings([unsat_scrape(side)], cluster,
                                        DRIVER)
    assert not any(f.check == "explain" for f in found)
    return findings(found)


def same_decision_on_two_nodes_reported_once(side):
    found = doctor(side).fleet_findings(
        [unsat_scrape(side, "node-a"), unsat_scrape(side, "node-b")],
        EMPTY, DRIVER)
    assert sum(f.check == "explain" for f in found) == 1
    return findings(found)


def successful_solves_are_not_findings(side):
    found = doctor(side).fleet_findings(
        [unsat_scrape(side, outcome="ok", reason="")], EMPTY, DRIVER)
    assert not any(f.check == "explain" for f in found)
    return findings(found)


def without_kube_every_unsat_surfaces(side):
    found = doctor(side).fleet_findings([unsat_scrape(side)], None, DRIVER)
    assert any(f.check == "explain" for f in found)
    return findings(found)


def undecodable_lines_degrade_not_abort(side):
    dr = doctor(side)
    scrape = dr.NodeScrape(name="node-a", url="http://x")
    scrape.allocations_text = "not json\n" + json.dumps({
        "outcome": "unsat", "reason": "reserved", "detail": "held",
        "claim": {"uid": "u", "namespace": "ns", "name": "wl"},
    }) + "\n"
    found = dr.fleet_findings([scrape], EMPTY, DRIVER)
    assert sum(f.check == "explain" for f in found) == 1
    return findings(found)


def malformed_hold_degrades_report_not_run(side):
    dr = doctor(side)
    scrape = dr.NodeScrape(name="n1", url="http://x")
    scrape.usage = {
        "node": "n1", "capacity": {"chip": 4}, "occupied": {},
        "holds": [{"claimUid": "uid-1", "devices": [{"type": "chip"}],
                   "heldSeconds": "not-a-number"}],
    }
    report = dr.render_report([scrape], None, [], DRIVER)
    assert "? [?]" in report and "held ?s" in report
    return masked(report)


def parse_and_lookup(side):
    dr = doctor(side)
    text = (
        '# HELP x y\n# TYPE tpu_dra_audit_findings gauge\n'
        'tpu_dra_audit_findings{check="cdi"} 2\n'
        'tpu_dra_audit_findings{check="slices"} 0\n'
        'tpu_dra_up 1\n'
        'escaped{label="a\\"b"} 3\n'
    )
    parsed = dr.parse_metrics(text)
    seen = [dr.metric_value(parsed, "tpu_dra_audit_findings", check="cdi"),
            dr.metric_value(parsed, "tpu_dra_audit_findings",
                            check="slices"),
            dr.metric_value(parsed, "tpu_dra_up"),
            dr.metric_value(parsed, "escaped", label='a"b'),
            dr.metric_value(parsed, "missing")]
    assert seen == [2, 0, 1, 3, None]
    return parsed


def label_unescape_is_single_pass(side):
    dr = doctor(side)
    parsed = dr.parse_metrics('m{path="C:\\\\new",msg="a\\nb"} 1\n')
    assert dr.metric_value(parsed, "m", path="C:\\new", msg="a\nb") == 1
    return parsed


def slo_scrape(side, below=30.0, grace=5.0, with_rebalance=True):
    scrape = doctor(side).NodeScrape(name="node-a", url="http://x")
    if with_rebalance:
        scrape.rebalance = {"decisions": [], "claims": {"uid-starved": {
            "namespace": "tenants", "name": "infer",
            "latencyClass": "realtime", "belowMinSeconds": below,
            "graceSeconds": grace}}}
    return scrape


def starved_claim_is_drift(side):
    dr = doctor(side)
    found = dr.fleet_findings([slo_scrape(side)], None, DRIVER)
    slo = [f for f in found if f.check == "slo"]
    assert len(slo) == 1 and slo[0].severity == dr.SEVERITY_DRIFT
    assert slo[0].subject == "node-a/tenants/infer"
    assert "realtime" in slo[0].detail
    return findings(found)


def within_grace_is_silent(side):
    found = doctor(side).fleet_findings(
        [slo_scrape(side, below=3.0, grace=5.0)], None, DRIVER)
    assert [f for f in found if f.check == "slo"] == []
    return findings(found)


def rebalancerless_node_is_silent(side):
    found = doctor(side).fleet_findings(
        [slo_scrape(side, with_rebalance=False)], None, DRIVER)
    assert [f for f in found if f.check == "slo"] == []
    return findings(found)


def residency_scrape(side, replicas):
    scrape = doctor(side).NodeScrape(name="node-a", url="http://x")
    scrape.residency = {
        "schema": "tpu-dra-residency-v1", "replicas": replicas,
        "fleet": {"lookups": 0, "hits": 0, "measuredHitRate": 0.0},
    }
    return scrape


def counter_drift_is_drift(side):
    dr = doctor(side)
    scrape = residency_scrape(side, {
        "r-bad": {"counterDrift": True, "indexedBlocks": 5,
                  "insertedBlocks": 9, "evictedBlocks": 5,
                  "ledger": {"staleKeys": 0, "divergence": 0.0}},
        "r-ok": {"counterDrift": False, "indexedBlocks": 4,
                 "insertedBlocks": 9, "evictedBlocks": 5,
                 "ledger": {"staleKeys": 0, "divergence": 0.0}},
    })
    found = dr.fleet_findings([scrape], None, DRIVER)
    kv = [f for f in found if f.check == "kv-residency"]
    assert len(kv) == 1 and kv[0].severity == dr.SEVERITY_DRIFT
    assert kv[0].subject == "node-a/r-bad" and "/debug/kv" in kv[0].detail
    return findings(found)


def stale_ledger_keys_are_info_with_playbook(side):
    dr = doctor(side)
    scrape = residency_scrape(side, {"r0": {
        "counterDrift": False, "indexedBlocks": 2, "insertedBlocks": 6,
        "evictedBlocks": 4, "ledger": {"staleKeys": 3, "divergence": 0.75}}})
    found = dr.fleet_findings([scrape], None, DRIVER)
    kv = [f for f in found if f.check == "kv-residency"]
    assert len(kv) == 1 and kv[0].severity == dr.SEVERITY_INFO
    assert "actually warm" in kv[0].detail
    assert "docs/operations.md" in kv[0].detail
    return findings(found)


def missing_residency_document_is_benign(side):
    dr = doctor(side)
    scrape = dr.NodeScrape(name="node-a", url="http://x")
    assert scrape.residency is None
    found = dr.fleet_findings([scrape], None, DRIVER)
    assert not [f for f in found if f.check in ("kv-residency", "collect")]
    return findings(found)


# (test_gateway.py's, test_request_trace.py's, test_defrag.py's and
# test_defrag_executor.py's doctor cases.)


def gateway_doc_findings(side):
    dr = doctor(side)
    node = dr.NodeScrape(name="n1", url="http://x")
    node.gateway = {"overloaded": True, "fleetQueueDepth": 999, "events": [
        {"kind": "scale", "direction": "up", "outcome": "failed",
         "reason": "queue high", "detail": "ScaleError: allocator unsat"}]}
    found = [f for f in dr.fleet_findings([node], None, DRIVER)
             if f.check == "gateway"]
    assert {f.severity for f in found} == {"drift", "info"}
    assert any("allocator unsat" in f.detail for f in found)
    return findings(found)


def recovered_scale_failure_is_ignored(side):
    dr = doctor(side)

    def scrape(events):
        n = dr.NodeScrape(name="n1", url="http://x")
        n.gateway = {"overloaded": False, "events": events}
        return n

    failed = {"kind": "scale", "direction": "up", "outcome": "failed",
              "detail": "transient unsat"}
    applied = {"kind": "scale", "direction": "up", "outcome": "applied"}
    dwell = {"kind": "scale", "direction": "up", "outcome": "dwell"}
    recovered = dr.fleet_findings([scrape([failed, applied])], None, "d")
    assert [f for f in recovered if f.check == "gateway"] == []
    standing = [f for f in dr.fleet_findings(
        [scrape([applied, failed, dwell])], None, "d")
        if f.check == "gateway"]
    assert len(standing) == 1 and standing[0].severity == "drift"
    return findings(standing)


def slo_node(side, violations, exemplars):
    node = doctor(side).NodeScrape(name="n1", url="http://x")
    node.slo_summary = {"classes": {"interactive": {
        "violations": violations, "e2eP99S": 3.0, "ttftP99S": 2.0}}}
    node.exemplars = exemplars
    return node


def sustained_violations_point_at_slowest_exemplar(side):
    node = slo_node(side, 5, [
        {"latencyClass": "interactive", "signal": "e2e", "observedS": 2.0,
         "thresholdS": 1.0, "dominantPhase": "queueWait", "traceId": "aaa"},
        {"latencyClass": "interactive", "signal": "e2e", "observedS": 4.0,
         "thresholdS": 1.0, "dominantPhase": "decode", "traceId": "bbb"},
        {"latencyClass": "batch", "signal": "e2e", "observedS": 9.0,
         "thresholdS": 1.0, "dominantPhase": "prefill", "traceId": "ccc"},
    ])
    found = [f for f in doctor(side).fleet_findings([node], None, "tpu")
             if f.check == "slo-exemplar"]
    assert len(found) == 1 and found[0].severity == "drift"
    assert found[0].subject == "n1/interactive"
    assert "decode" in found[0].detail and "bbb" in found[0].detail
    return findings(found)


def slo_below_threshold_is_quiet(side):
    dr = doctor(side)
    node = slo_node(side, dr.SLO_SUSTAINED_VIOLATIONS - 1, [])
    found = dr.fleet_findings([node], None, "tpu")
    assert not [f for f in found if f.check == "slo-exemplar"]
    return findings(found)


def sustained_without_exemplar_still_flags(side):
    (f,) = [f for f in doctor(side).fleet_findings(
        [slo_node(side, 4, [])], None, "tpu") if f.check == "slo-exemplar"]
    assert "no exemplar captured" in f.detail
    return findings([f])


def defrag_scrape(side, alloc, planner):
    return doctor(side).NodeScrape(
        name="node-0", url="http://test", readyz_text="ready\n",
        allocations_text=alloc.export_allocations_jsonl(),
        defrag=planner.export_json())


def defrag_finding_rides_next_to_explain(side):
    _, alloc, planner, _ = fragmented_4x1(side)
    assert unsat(side, alloc, chip_claim("uid-gang", count=2)) == "gang"
    found = doctor(side).fleet_findings(
        [defrag_scrape(side, alloc, planner)], None, DRIVER)
    assert any("gang" in f.detail for f in found if f.check == "explain")
    defrag = [f for f in found if f.check == "defrag"]
    assert len(defrag) == 1 and defrag[0].severity == "info"
    assert "defrag plan available" in defrag[0].detail
    return findings(found)


def no_defrag_finding_without_a_planned_plan(side):
    _, alloc, planner, _ = fragmented_4x1(side)
    unsat(side, alloc, chip_claim("uid-big", count=9))
    found = doctor(side).fleet_findings(
        [defrag_scrape(side, alloc, planner)], None, DRIVER)
    assert not [f for f in found if f.check == "defrag"]
    return findings(found)


def completed_execution_renders_as_info_trail(side):
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    root = tempfile.mkdtemp(prefix="dx-")
    try:
        executor(side, root, alloc, planner, reg).execute(plan, claim=claim)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    found = doctor(side).fleet_findings(
        [defrag_scrape(side, alloc, planner)], None, DRIVER)
    trail = [f for f in found if f.check == "defrag-exec"]
    assert len(trail) == 1 and trail[0].severity == "info"
    assert plan["planId"] in trail[0].detail
    assert "admit[uid-gang]=ok" in trail[0].detail
    return [(f.severity, f.check, f.subject) for f in found]


def failed_execution_is_drift_in_flight_is_info(side):
    doc = {"plans": [], "executions": [
        {"planId": "plan-7", "state": "failed",
         "claim": {"uid": "u1", "name": "gang", "namespace": "ml"},
         "detail": "rollback failed for mover(s) u2",
         "steps": [{"kind": "replace", "claimUid": "u2",
                    "outcome": "failed", "detail": "boom"}],
         "rollbacks": [{"claimUid": "u2", "outcome": "failed",
                        "detail": "boom"}]},
        {"planId": "plan-8", "state": "in-flight",
         "claim": {"uid": "u1", "name": "gang", "namespace": "ml"},
         "detail": "", "steps": [], "rollbacks": []},
    ]}
    dr = doctor(side)
    scrape = dr.NodeScrape(name="node-0", url="http://test",
                           readyz_text="ready\n", defrag=doc)
    trail = [f for f in dr.fleet_findings([scrape], None, DRIVER)
             if f.check == "defrag-exec"]
    by_plan = {("plan-7" in f.detail): f for f in trail}
    assert len(trail) == 2
    assert by_plan[True].severity == "drift"
    assert "intent is still on disk" in by_plan[True].detail
    assert by_plan[False].severity == "info"
    assert "in progress" in by_plan[False].detail
    return findings(trail)


@pytest.mark.parametrize("scenario", [
    gateway_doc_findings, recovered_scale_failure_is_ignored,
    sustained_violations_point_at_slowest_exemplar,
    slo_below_threshold_is_quiet, sustained_without_exemplar_still_flags,
    defrag_finding_rides_next_to_explain,
    no_defrag_finding_without_a_planned_plan,
    completed_execution_renders_as_info_trail,
    failed_execution_is_drift_in_flight_is_info,
    node_pool_named_ici_is_not_a_channel,
    failed_usage_scrape_is_not_read_as_no_holds,
    unsat_record_is_flagged_with_runbook_hint,
    since_allocated_claim_is_stale_history,
    same_decision_on_two_nodes_reported_once,
    successful_solves_are_not_findings,
    without_kube_every_unsat_surfaces,
    undecodable_lines_degrade_not_abort,
    malformed_hold_degrades_report_not_run,
    parse_and_lookup, label_unescape_is_single_pass,
    starved_claim_is_drift, within_grace_is_silent,
    rebalancerless_node_is_silent, counter_drift_is_drift,
    stale_ledger_keys_are_info_with_playbook,
    missing_residency_document_is_benign,
], ids=lambda f: f.__name__)
def test_checks(scenario):
    both(scenario)


# -- TestSloCheck against a real MetricsServer -----------------------------------


def live_server(side, rebalance=None):
    metrics = side("utils.metrics")
    srv = metrics.MetricsServer(metrics.Registry(), host="127.0.0.1",
                                port=0, tracer=side("utils.tracing").Tracer())
    srv.set_usage_provider(lambda: {"node": "node-a", "holds": []})
    if rebalance is not None:
        srv.set_rebalance_provider(rebalance)
    srv.start()
    return srv


def test_slo_live_scrape_and_bundle(tmp_path):
    snapshot = {
        "node": "node-a",
        "decisions": [{"outcome": "applied", "action": "steal-idle"}],
        "claims": {"uid-s": {
            "namespace": "t", "name": "w", "latencyClass": "realtime",
            "belowMinSeconds": 99.0, "graceSeconds": 5.0}},
    }

    def scenario(side):
        srv = live_server(side, lambda: snapshot)
        bundle = tmp_path / f"{side}.tar"
        try:
            report, found, status = doctor(side).run(
                {"node-a": f"http://127.0.0.1:{srv.port}"},
                bundle=str(bundle))
        finally:
            srv.stop()
        assert status == 1 and any(f.check == "slo" for f in found)
        with tarfile.open(bundle) as tar:
            doc = json.load(tar.extractfile("nodes/node-a/rebalance.json"))
            members = sorted(tar.getnames())
        assert doc["claims"]["uid-s"]["belowMinSeconds"] == 99.0
        return masked(dict(report=report, findings=findings(found),
                           members=members, doc=doc))

    both(scenario)


def test_rebalance_scrape_failure_is_loud():
    def boom():
        raise RuntimeError("provider exploded")

    def scenario(side):
        srv = live_server(side, boom)
        try:
            scrape = doctor(side).collect_node(
                "node-a", f"http://127.0.0.1:{srv.port}")
        finally:
            srv.stop()
        assert scrape.rebalance is None
        assert any("/debug/rebalance" in e for e in scrape.errors)
        return masked(scrape.errors)

    both(scenario)


def test_rebalance_404_is_benign():
    def scenario(side):
        srv = live_server(side)
        try:
            scrape = doctor(side).collect_node(
                "node-a", f"http://127.0.0.1:{srv.port}")
        finally:
            srv.stop()
        assert scrape.rebalance is None
        assert not any("/debug/rebalance" in e for e in scrape.errors)
        return masked(scrape.errors)

    both(scenario)
