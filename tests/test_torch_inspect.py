"""The port's node-state inspector against the reference's.

Twins of ``test_inspect.py``: each scenario builds the same node state
(or serves the same debug endpoints) for each package, and both
packages' ``collect`` documents and ``render`` texts must be equal, wall
clock values masked and each side's directory written as ``<dir>``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from test_torch_plugin_driver import both
from test_torch_plugin_loops import make_state

DRIVER = "tpu.google.com"


def claim(uid, device, strategy=None):
    cfgs = []
    if strategy:
        cfgs = [{"source": "FromClaim", "requests": [],
                 "opaque": {"driver": DRIVER, "parameters": {
                     "apiVersion": "tpu.google.com/v1alpha1",
                     "kind": "TpuChipConfig",
                     "sharing": {"strategy": strategy}}}}]
    return {
        "metadata": {"name": f"c-{uid}", "namespace": "ns", "uid": uid},
        "status": {"allocation": {"devices": {"results": [{
            "request": "r", "driver": DRIVER, "pool": "node-a",
            "device": device}], "config": cfgs}}},
    }


def view(side, root, **kwargs):
    """``collect`` and ``render`` of the package, epoch times and ages in
    the text masked."""
    insp = side("plugin.inspect")
    out = insp.collect(str(root), str(root / "cdi"), **kwargs)
    text = re.sub(r"\d{9,}(\.\d+)?", "<t>", insp.render(out))
    text = re.sub(r"\d+(\.\d+)?s ago", "<age>", text)
    return json.loads(re.sub(r"\d{9,}\.\d+", "0", json.dumps(out))), text


def prepared_and_shared(side, root):
    state, _ = make_state(side, root)
    state.prepare(claim("uid-a", "tpu-0", strategy="TimeShared"))
    state.prepare(claim("uid-b", "tpu-1"))
    out, text = view(side, root)
    assert {c["uid"] for c in out["preparedClaims"]} == {"uid-a", "uid-b"}
    assert "ns/c-uid-a (uid-a): tpu-0 [TimeShared]" in text
    assert out["cdi"]["orphanedClaimSpecs"] == []
    state.checkpoint.write({})                  # a crash artifact
    orphaned = view(side, root)
    assert orphaned[0]["cdi"]["orphanedClaimSpecs"] == ["uid-a", "uid-b"]
    (root / "checkpoint.json").write_text('{"truncated')
    corrupt = view(side, root)
    assert "CHECKPOINT CORRUPT" in corrupt[1]
    return (out, text), orphaned, corrupt


def empty_node(side, root):
    out, text = view(side, root)
    assert "prepared claims: 0" in text
    return out, text


def health_fields(side, root):
    lib = side("tpulib").FakeChipLib(generation="v5p", topology="2x2x1")
    lib.wedge_chip(0, reason="hbm uncorrectable errors")
    lib.unplug_chip(1, reason="pcie link down")
    out, text = view(side, root, chiplib=lib)
    assert "unhealthy chips: 2" in text and "[DEGRADED since" in text
    return out, text


def cli_json(side, root):
    state, _ = make_state(side, root)
    state.prepare(claim("uid-a", "tpu-0"))
    proc = subprocess.run(
        [sys.executable, "-m", f"{side.root}.plugin.inspect",
         "--state-root", str(root), "--cdi-root", str(root / "cdi"),
         "--fake-topology", "2x2x1", "--json"],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(re.sub(r"\d{9,}\.\d+", "0", proc.stdout))
    assert out["preparedClaims"][0]["uid"] == "uid-a"
    assert len(out["inventory"]) == 4
    return out


@pytest.mark.parametrize("scenario", [
    prepared_and_shared, empty_node, health_fields, cli_json,
], ids=lambda f: f.__name__)
def test_offline(tmp_path, scenario):
    both(scenario, tmp_path)


REBALANCE = {
    "decisions": [{
        "outcome": "applied", "action": "steal-idle",
        "resource": "tensorcore",
        "gainer": {"claim": "uid-i", "from": 30, "to": 40},
        "donor": {"claim": "uid-b", "from": 70, "to": 60}}],
    "claims": {
        "uid-i": {"namespace": "t", "name": "infer",
                  "latencyClass": "realtime", "generation": 2,
                  "granted": {"tensorcore": 40, "hbm": 25},
                  "min": {"tensorcore": 30, "hbm": 25},
                  "burst": {"tensorcore": 80, "hbm": 75},
                  "belowMinSeconds": 0.0, "graceSeconds": 5.0},
        "uid-s": {"namespace": "t", "name": "w",
                  "latencyClass": "realtime", "generation": 4,
                  "granted": {"tensorcore": 10, "hbm": None},
                  "min": {"tensorcore": 30, "hbm": None},
                  "burst": {"tensorcore": 80, "hbm": None},
                  "belowMinSeconds": 44.0, "graceSeconds": 5.0}},
}
ALLOCATIONS = [
    {"outcome": "ok", "reason": "", "claim":
        {"uid": "u-ok", "namespace": "ns", "name": "wl-ok"}},
    {"outcome": "unsat", "reason": "gang", "detail": "non-contiguous coords",
     "claim": {"uid": "u-frag", "namespace": "ns", "name": "wl-frag"}},
]


def boom():
    raise RuntimeError("provider exploded")


LIVE = {
    "ready": {},
    "degraded": {"degraded": True},
    "allocations": {"allocations": lambda: "".join(
        json.dumps(r) + "\n" for r in ALLOCATIONS)},
    "allocations-failing": {"allocations": boom},
    "rebalance": {"rebalance": lambda: REBALANCE},
    "rebalance-failing": {"rebalance": boom},
    "unreachable": None,
}


def live(side, root, name):
    metrics = side("utils.metrics")
    wiring = LIVE[name]
    if wiring is None:
        out, text = view(side, root, http_url="http://127.0.0.1:1")
        assert "UNREACHABLE" in text
        return out, text
    srv = metrics.MetricsServer(metrics.Registry(), host="127.0.0.1", port=0)
    srv.add_readiness_check("grpc-serving", lambda: (True, "ok"))
    if wiring.get("degraded"):
        srv.add_readiness_check(
            "apiserver-reachable",
            lambda: (False, "slice republish failing: 503 blackout"),
            critical=False)
    if "allocations" in wiring:
        srv.set_allocations_provider(wiring["allocations"])
    if "rebalance" in wiring:
        srv.set_rebalance_provider(wiring["rebalance"])
    srv.start()
    try:
        out, text = view(side, root, http_url=f"http://127.0.0.1:{srv.port}")
    finally:
        srv.stop()
    # Each side served on a port of its own.
    out["live"].pop("url", None)
    text = re.sub(r"127\.0\.0\.1:\d+", "<url>", text)
    return out, text


@pytest.mark.parametrize("name", sorted(LIVE))
def test_live(tmp_path, name):
    out, text = both(live, tmp_path, name)
    want = {"degraded": "DEGRADED MODE", "allocations":
            "recent unallocatable claims: 1",
            "allocations-failing": "/debug/allocations scrape FAILED",
            "rebalance": "SLO-STARVED",
            "rebalance-failing": "/debug/rebalance scrape FAILED",
            "ready": "live plugin: ready"}.get(name)
    assert want is None or want in text
