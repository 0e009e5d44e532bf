"""The port's allocator bench against the reference's, on one seed.

``tools/run_alloc_bench_torch.py`` is the twin of
``tools/run_alloc_bench.py``. Both run their smoke profile in process
with seed 1234; every allocator either tool builds records each claim's
outcome (the granted devices, or the refusal's reason), and each
package's ``largest_free_submesh`` records what it returns. The two
tools' decisions must be equal: the placements of the throughput and
fragmentation phases, the large-gang probes first-fit and the scorer
admit, and the fragmentation series. Both tools' gates must pass. Solve
rates are not compared. The port's extra H100 section runs on its own
allocator and is held only to having solved its claims; the reference's
``ALLOC_r01.json`` stays byte for byte as it was.
"""

import hashlib
import json
import os
import sys

import pytest

from k8s_dra_driver_tpu.tpulib import topology as ref_topology
from k8s_dra_driver_tpu_torch.tpulib import topology as port_topology

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 1234
# Outcome fields that follow from the decisions alone.
DECIDED = ("devices", "claims", "unsat", "from_scratch_sample",
           "index_rebuilds", "index_generation")


def load_tools():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import run_alloc_bench
        import run_alloc_bench_torch
    finally:
        sys.path.pop(0)
    return run_alloc_bench, run_alloc_bench_torch


def outcome(claim_or_error) -> list:
    if isinstance(claim_or_error, Exception):
        return ["unsat", getattr(claim_or_error, "reason", "")]
    results = claim_or_error["status"]["allocation"]["devices"]["results"]
    return sorted([r["pool"], r["device"]] for r in results)


def run(tool, topology, monkeypatch, capsys) -> tuple:
    """(exit code, document, [per allocator: [(uid, outcome)]], the
    largest_free_submesh series)."""
    allocators, series = [], []
    real_make = tool.make_allocator
    real_lfs = topology.largest_free_submesh

    def make_allocator(client, registry=None, **kw):
        alloc = real_make(client, registry, **kw)
        log = []
        allocators.append(log)
        allocate = alloc.allocate

        def recorded(claim, *args, **kwargs):
            uid = claim["metadata"]["uid"]
            try:
                out = allocate(claim, *args, **kwargs)
            except Exception as e:
                log.append((uid, outcome(e)))
                raise
            log.append((uid, outcome(out)))
            return out

        alloc.allocate = recorded
        return alloc

    def largest_free_submesh(shape, free):
        value = real_lfs(shape, free)
        series.append(value)
        return value

    monkeypatch.setattr(tool, "make_allocator", make_allocator)
    monkeypatch.setattr(topology, "largest_free_submesh",
                        largest_free_submesh)
    capsys.readouterr()
    rc = tool.main(["--profile", "smoke", "--seed", str(SEED)])
    doc = json.loads(capsys.readouterr().out)
    monkeypatch.undo()
    return rc, doc, allocators, series


def test_smoke_profiles_decide_alike(monkeypatch, capsys):
    ref_tool, port_tool = load_tools()
    assert port_tool.PROFILES == {
        name: dict(p, h100_nodes=port_tool.PROFILES[name]["h100_nodes"])
        for name, p in ref_tool.PROFILES.items()}
    record = os.path.join(ROOT, "ALLOC_r01.json")
    with open(record, "rb") as f:
        before = hashlib.sha256(f.read()).hexdigest()

    ref_rc, ref_doc, ref_allocs, ref_series = run(
        ref_tool, ref_topology, monkeypatch, capsys)
    port_rc, port_doc, port_allocs, port_series = run(
        port_tool, port_topology, monkeypatch, capsys)

    assert (ref_rc, port_rc) == (0, 0)
    assert ref_doc["gates"] == port_doc["gates"]
    assert port_doc["gates"]["failures"] == []
    # Throughput (incremental, from scratch), then fragmentation
    # (first-fit, scored); the port adds its H100 allocator last.
    assert len(ref_allocs) == 4 and len(port_allocs) == 5
    for i, (ref_log, port_log) in enumerate(zip(ref_allocs, port_allocs)):
        assert len(port_log) == len(ref_log), i
        for ref_step, port_step in zip(ref_log, port_log):
            assert port_step == ref_step, (i, ref_step, port_step)
    assert port_series == ref_series and len(ref_series) == 2 * 120

    for key in DECIDED:
        assert port_doc["throughput"][key] == ref_doc["throughput"][key], key
    assert port_doc["fragmentation"] == ref_doc["fragmentation"]
    frag = port_doc["fragmentation"]
    assert frag["scored"]["admitted"] >= frag["first_fit"]["admitted"]
    # The TPU sections keep the reference's keys.
    assert set(ref_doc) <= set(port_doc)
    assert set(port_doc["throughput"]) == set(ref_doc["throughput"])

    h100 = port_doc["h100"]
    mixed = [step for _, step in port_allocs[4]]
    gpu_pools = {pool for step in mixed if step[0] != "unsat"
                 for pool, _ in step if pool.startswith("gpu-node-")}
    assert gpu_pools and h100["gpus"] == 16 * 8
    assert sum(c["claims"] for c in h100["claims"].values()) == \
        len(mixed) == port_tool.PROFILES["smoke"]["claims"]

    with open(record, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == before


def test_the_twin_writes_only_an_explicit_out(tmp_path, monkeypatch,
                                              capsys):
    """No ``--out``: the document is printed and nothing is written, on
    either profile's default; with ``--out`` it goes there."""
    _, port_tool = load_tools()
    monkeypatch.chdir(tmp_path)
    small = dict(port_tool.PROFILES["smoke"], slices=2, claims=20,
                 scratch_sample=2, delta_every=5, min_speedup=0.0,
                 frag_steps=16, h100_nodes=2)
    monkeypatch.setitem(port_tool.PROFILES, "full", small)
    assert port_tool.main(["--profile", "full"]) == 0
    assert os.listdir(tmp_path) == []
    printed = json.loads(capsys.readouterr().out)
    out = tmp_path / "alloc.json"
    assert port_tool.main(["--profile", "full", "--out", str(out)]) == 0
    assert os.listdir(tmp_path) == ["alloc.json"]
    written = json.loads(out.read_text())
    assert written["package"] == printed["package"] == \
        "k8s_dra_driver_tpu_torch"


@pytest.mark.parametrize("section", ["throughput", "fragmentation"])
def test_a_failed_gate_exits_1(section, monkeypatch, capsys):
    _, port_tool = load_tools()
    small = dict(port_tool.PROFILES["smoke"], slices=2, claims=20,
                 scratch_sample=2, delta_every=5, frag_steps=16,
                 h100_nodes=2, min_speedup=0.0, min_extra_probes=0)
    if section == "throughput":
        small["min_speedup"] = 1e9
    else:
        small["min_extra_probes"] = 1000
    monkeypatch.setitem(port_tool.PROFILES, "smoke", small)
    assert port_tool.main(["--profile", "smoke"]) == 1
    (failure,) = json.loads(capsys.readouterr().out)["gates"]["failures"]
    assert ("speedup" if section == "throughput" else "probe") in failure
