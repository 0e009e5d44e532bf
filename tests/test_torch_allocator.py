"""The port's reference allocator against the reference's: every funnel
stage's terminal reason, the decision records, the placement scorer, the
``tpu_dra_alloc_*`` metric families, the UnsatisfiableClaim Event, and
the demo specs' CEL selectors solved through the allocator, on TPU fakes
published through each package's own ResourceSlice controller.

Each scenario runs once per package and its observations must be equal:
``AllocationError.reason`` and ``Explanation.to_dict()``, the newest
``/debug/allocations`` record served over HTTP, every
``status.allocation``, the decision records with their timestamps masked,
and the metric exposition. On a fake node of 8 H100s (no interconnect
mesh) the port's gangs need no contiguous coordinates.
"""

from __future__ import annotations

import json
import urllib.request

import pytest

from test_cel import load_device_classes, spec_requests
from test_torch_kube import PORT, both, exposition, masked

DRIVER = "tpu.google.com"


def publish_host(side, client, node, *, generation="v5p", topology="2x1x1",
                 host_id=0, hosts_per_slice=1, slice_id="s1", mutate=None,
                 kinds=("chip", "tensorcore")):
    """One node pool published through the package's controller.
    ``mutate(devices, counters)`` corrupts the slice before publication."""
    rs = side("kube.resourceslice")
    client.create(side("kube").NODES,
                  {"metadata": {"name": node, "uid": f"u-{node}"}})
    lib = side("tpulib").FakeChipLib(
        generation=generation, topology=topology, host_id=host_id,
        hosts_per_slice=hosts_per_slice, slice_id=slice_id)
    allocatable = lib.enumerate_all_possible_devices(set(kinds))
    devices = [d.get_device() for _, d in sorted(allocatable.items())]
    counters = side("tpulib.deviceinfo").counter_sets(allocatable)
    if mutate is not None:
        devices, counters = mutate(devices, counters)
    ctrl = rs.ResourceSliceController(
        client, DRIVER, scope=node,
        owner={"kind": "Node", "name": node, "uid": f"u-{node}"})
    ctrl.update(rs.DriverResources(pools={node: rs.Pool(
        devices=devices, shared_counters=counters, node_name=node)}))
    ctrl.sync_once()


def chip_claim(uid, count=1, name=None, selectors=None, mode=None,
               constraints=None, device_class=DRIVER):
    req = {"name": "r0", "deviceClassName": device_class}
    if mode is not None:
        req["allocationMode"] = mode
    else:
        req["count"] = count
    if selectors is not None:
        req["selectors"] = selectors
    return {
        "metadata": {"name": name or f"claim-{uid}", "namespace": "explain",
                     "uid": uid},
        "spec": {"devices": {"requests": [req],
                             "constraints": constraints or []}},
    }


def cel(expr):
    return [{"cel": {"expression": expr}}]


def coord_pin(side, coord, *more):
    return {"r0": [*more, side("kube.allocator").Selector(
        "coord", "eq", coord)]}


def node(side, **kwargs):
    """A fake client with one published host, an allocator on it and its
    registry."""
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0", **kwargs)
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(client, registry=reg)
    return client, alloc, reg


def observed(alloc, reg, *claims):
    """What both packages must agree on after a scenario: the decision
    records as ``/debug/allocations`` serves them, the metrics and the
    claims' statuses."""
    return (
        masked([json.loads(ln) for ln in
                alloc.export_allocations_jsonl().splitlines() if ln]),
        exposition(reg, "tpu_dra_alloc_"),
        [c.get("status") for c in claims],
    )


def unsat_triple(side, alloc, registry, claim, want, selectors=None):
    """The same terminal reason in the exception and its explanation, the
    unsat metric and the newest /debug/allocations record over HTTP."""
    al = side("kube.allocator")
    before = alloc._m_unsat.value(reason=want)
    with pytest.raises(al.AllocationError) as ei:
        alloc.allocate(claim, selectors=selectors)
    e = ei.value
    assert e.reason == want and want in al.REASONS
    assert e.explanation.outcome == "unsat"
    assert e.explanation.reason == want
    assert alloc._m_unsat.value(reason=want) == before + 1
    assert f'tpu_dra_alloc_unsat_total{{reason="{want}"}}' in \
        registry.render()
    srv = side("utils.metrics").MetricsServer(registry, host="127.0.0.1",
                                              port=0)
    srv.set_allocations_provider(alloc.export_allocations_jsonl)
    srv.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/debug/allocations").read().decode()
    finally:
        srv.stop()
    newest = json.loads([ln for ln in body.splitlines() if ln][-1])
    assert newest["outcome"] == "unsat" and newest["reason"] == want
    assert newest["claim"]["uid"] == claim["metadata"]["uid"]
    return str(e), masked(e.explanation.to_dict()), masked(newest)


# -- the funnel stages (tests/test_allocator_explain.py) ---------------------


def reserved_device(side):
    _, alloc, reg = node(side)
    held = chip_claim("uid-holder", count=2)
    alloc.allocate(held)
    triple = unsat_triple(side, alloc, reg, chip_claim("uid-blocked"),
                          "reserved")
    funnel = triple[2]["funnels"][0]
    assert funnel["rejected"]["reserved"] == 2
    assert any("held by claim uid-holder" in s
               for s in funnel["reasons"]["reserved"])
    return triple, observed(alloc, reg, held)


def failing_deviceclass_cel(side):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0")
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(
        client, registry=reg, device_classes={DRIVER: [
            "device.attributes['tpu.google.com'].type == 'gpu'"]})
    triple = unsat_triple(side, alloc, reg, chip_claim("uid-class"),
                          "class-cel")
    assert any("cel:mismatch expr=" in s and "'gpu'" in s
               for s in triple[2]["funnels"][0]["reasons"]["class-cel"])
    return triple, observed(alloc, reg)


def failing_request_selector(side):
    _, alloc, reg = node(side)
    claim = chip_claim("uid-sel", selectors=cel(
        "device.attributes['tpu.google.com'].type == 'optical'"))
    triple = unsat_triple(side, alloc, reg, claim, "request-cel")
    assert any("'optical'" in s for s in
               triple[2]["funnels"][0]["reasons"]["request-cel"])
    return triple, observed(alloc, reg)


def absent_attribute_named(side):
    _, alloc, reg = node(side)
    claim = chip_claim("uid-typo", selectors=cel(
        "device.attributes['tpu.google.com'].iciQ == 0"))
    triple = unsat_triple(side, alloc, reg, claim, "request-cel")
    assert any("attribute 'iciQ' absent" in s for s in
               triple[2]["funnels"][0]["reasons"]["request-cel"])
    return triple, observed(alloc, reg)


def exhausted_counter_set(side):
    _, alloc, reg = node(side)
    whole = chip_claim("uid-whole", count=2)
    alloc.allocate(whole)
    core = chip_claim("uid-core", device_class="tensorcore.tpu.google.com")
    triple = unsat_triple(side, alloc, reg, core, "counters")
    assert any(s.startswith("counters:") and "used" in s
               for s in triple[2]["funnels"][0]["reasons"]["counters"])
    return triple, observed(alloc, reg, whole)


def match_attribute_conflict(side):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-a", topology="1x1x1", slice_id="s-a")
    publish_host(side, client, "node-b", topology="1x1x1", slice_id="s-b")
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(client, registry=reg)
    claim = chip_claim("uid-gang", count=2, constraints=[{
        "requests": ["r0"], "matchAttribute": "tpu.google.com/sliceId"}])
    triple = unsat_triple(side, alloc, reg, claim, "constraint")
    assert any("constraint:" in s for s in
               triple[2]["funnels"][0]["reasons"]["constraint"])
    return triple, observed(alloc, reg)


def fragmented_gang(side):
    _, alloc, reg = node(side, topology="4x1x1")
    for i, coord in enumerate(("1,0,0", "2,0,0")):
        alloc.allocate(chip_claim(f"uid-mid-{i}"),
                       selectors=coord_pin(side, coord))
    triple = unsat_triple(side, alloc, reg, chip_claim("uid-frag", count=2),
                          "gang")
    assert any("non-contiguous" in s
               for s in triple[2]["funnels"][0]["reasons"]["gang"])
    return triple, observed(alloc, reg)


def intra_claim_contention(side):
    _, alloc, reg = node(side, topology="2x2x1")
    claim = chip_claim("uid-contend", count=2)
    claim["spec"]["devices"]["requests"].append(
        {"name": "r1", "deviceClassName": DRIVER, "count": 3})
    triple = unsat_triple(side, alloc, reg, claim, "reserved")
    funnel = next(f for f in triple[2]["funnels"] if f["request"] == "r1")
    assert any("of this claim" in s for s in funnel["reasons"]["reserved"])
    return triple, observed(alloc, reg)


def checkerboard(side, alloc):
    held = 0
    for x in range(4):
        for y in range(4):
            if (x + y) % 2 == 0:
                continue
            alloc.allocate(chip_claim(f"uid-cb-{x}{y}"),
                           selectors=coord_pin(side, f"{x},{y},0"))
            held += 1
    assert held == 8


def gang_rejections_bounded(side):
    _, alloc, reg = node(side, topology="4x4x1")
    checkerboard(side, alloc)
    triple = unsat_triple(side, alloc, reg, chip_claim("uid-pair", count=2),
                          "gang")
    funnel = next(f for f in triple[2]["funnels"] if f["request"] == "r0")
    assert funnel["rejected"]["gang"] <= funnel["survivors"] == 8
    return triple, observed(alloc, reg)


def invalid_slice(side):
    def corrupt(devices, counters):
        bad = {"name": "ghost-chip", "basic": {
            "attributes": {"type": {"string": "chip"}},
            "consumesCounters": [{"counterSet": "cs", "counters": {
                "ghostCores": {"value": "1"}}}]}}
        return [bad], [{"name": "cs", "counters": {"cores": {"value": "4"}}}]

    _, alloc, reg = node(side, mutate=corrupt)
    triple = unsat_triple(side, alloc, reg, chip_claim("uid-bad"),
                          "invalid-slice")
    assert triple[2]["funnels"][0]["rejected"]["invalid-slice"] == 1
    return triple, observed(alloc, reg)


def unknown_allocation_mode(side):
    _, alloc, reg = node(side)
    return unsat_triple(side, alloc, reg,
                        chip_claim("uid-mode", mode="BestEffort"),
                        "unknown-mode"), observed(alloc, reg)


def unknown_device_class(side):
    _, alloc, reg = node(side)
    return unsat_triple(
        side, alloc, reg,
        chip_claim("uid-cls", device_class="gpu.example.com"),
        "unknown-class"), observed(alloc, reg)


def malformed_cel(side):
    _, alloc, reg = node(side)
    claim = chip_claim("uid-syntax", selectors=cel("device.attributes["))
    with pytest.raises(side("kube.allocator").AllocationError) as ei:
        alloc.allocate(claim)
    assert ei.value.reason == "cel-error"
    assert "device.attributes[" in str(ei.value)
    assert alloc.recent_decisions()[-1]["reason"] == "cel-error"
    assert reg.render().count(
        'tpu_dra_alloc_unsat_total{reason="cel-error"} 1') == 1
    return str(ei.value), observed(alloc, reg)


def shortfall(side):
    _, alloc, reg = node(side)
    triple = unsat_triple(side, alloc, reg, chip_claim("uid-many", count=5),
                          "shortfall")
    assert "only 2 of 5" in triple[2]["detail"]
    return triple, observed(alloc, reg)


def backtrack_budget(side):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0", topology="4x1x1")
    reg = side("utils.metrics").Registry()
    al = side("kube.allocator")
    alloc = al.ReferenceAllocator(client, registry=reg,
                                  max_backtrack_steps=1)
    corners = al.Selector("coord", "in", ["0,0,0", "3,0,0"])
    triple = unsat_triple(side, alloc, reg, chip_claim("uid-budget", count=2),
                          "backtrack-budget", selectors={"r0": [corners]})
    assert triple[2]["backtracks"] >= 1
    return triple, observed(alloc, reg)


def all_mode_with_reserved(side):
    _, alloc, reg = node(side)
    one = chip_claim("uid-one", selectors=cel(
        "device.attributes['tpu.google.com'].iciX == 0"))
    alloc.allocate(one)
    return unsat_triple(side, alloc, reg, chip_claim("uid-all", mode="All"),
                        "reserved"), observed(alloc, reg, one)


FUNNEL_SCENARIOS = [
    reserved_device, failing_deviceclass_cel, failing_request_selector,
    absent_attribute_named, exhausted_counter_set, match_attribute_conflict,
    fragmented_gang, intra_claim_contention, gang_rejections_bounded,
    invalid_slice, unknown_allocation_mode, unknown_device_class,
    malformed_cel, shortfall, backtrack_budget, all_mode_with_reserved,
]


@pytest.mark.parametrize("scenario", FUNNEL_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_funnel_stage(scenario):
    both(scenario)


def test_backtrack_budget_env_override(monkeypatch):
    monkeypatch.setenv("TPU_DRA_MAX_BACKTRACK_STEPS", "7")
    got = both(lambda side: side("kube.allocator").ReferenceAllocator(
        side("kube").FakeKubeClient()).max_backtrack_steps)
    assert got == 7


# -- the decision records and the scorer -------------------------------------


def success_compact_funnel(side):
    _, alloc, reg = node(side)
    claim = chip_claim("uid-ok", count=2)
    alloc.allocate(claim)
    rec = alloc.recent_decisions()[-1]
    assert rec["outcome"] == "ok" and rec["reason"] == ""
    funnel = rec["funnels"][0]
    assert funnel["entering"] > 0 and funnel["survivors"] == 2
    assert funnel["rejected"].get("class-cel", 0) > 0
    assert funnel["reasons"] == {}
    assert rec["durationSeconds"] >= 0 and "class-cel" in rec["stageSeconds"]
    assert alloc._m_solve_seconds.summary()[0] == 1
    assert alloc._m_funnel_rejections.value(stage="class-cel") >= 4
    return observed(alloc, reg, claim)


def gang_placement_score(side):
    _, alloc, reg = node(side, topology="4x1x1")
    claim = chip_claim("uid-pair", count=2)
    alloc.allocate(claim)
    placement = alloc.recent_decisions()[-1]["placements"]["r0"]
    assert placement["strategy"] == "best-fit"
    assert placement["box"] == "2x1x1" and placement["origin"] == "0,0,0"
    assert placement["applied"] is True
    assert placement["score"] == {**placement["score"],
                                  "cornerDistance": 0, "freeComponent": 4}
    assert set(placement["devices"]) == {"tpu-0", "tpu-1"}
    return observed(alloc, reg, claim)


def first_fit_no_placement(side):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0", topology="4x1x1")
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(
        client, registry=reg, placement_scoring=False)
    claim = chip_claim("uid-pair", count=2)
    alloc.allocate(claim)
    assert alloc.recent_decisions()[-1]["placements"] == {}
    return observed(alloc, reg, claim)


def scorer_best_fit(side):
    _, alloc, reg = node(side, topology="4x1x1")
    mid = chip_claim("uid-mid")
    alloc.allocate(mid, selectors=coord_pin(side, "1,0,0"))
    single = chip_claim("uid-one")
    alloc.allocate(single)
    results = single["status"]["allocation"]["devices"]["results"]
    assert results[0]["device"] == "tpu-0"
    placement = alloc.recent_decisions()[-1]["placements"]["r0"]
    assert placement["score"]["freeComponent"] == 1
    return observed(alloc, reg, mid, single)


def scorer_proves_unsat(side):
    _, alloc, reg = node(side, topology="4x4x1")
    checkerboard(side, alloc)
    with pytest.raises(side("kube.allocator").AllocationError) as ei:
        alloc.allocate(chip_claim("uid-pair", count=2))
    assert ei.value.reason == "gang"
    rec = alloc.recent_decisions()[-1]
    assert rec["backtracks"] == 0
    assert any("scored placement exhausted" in s
               for s in rec["funnels"][0]["reasons"]["gang"])
    return observed(alloc, reg)


def enums_confine_values(side):
    al = side("kube.allocator")
    _, alloc, reg = node(side)
    alloc.allocate(chip_claim("uid-ok"))
    with pytest.raises(al.AllocationError):
        alloc.allocate(chip_claim("uid-no", count=99))
    for rec in alloc.recent_decisions():
        assert not rec["reason"] or rec["reason"] in al.REASONS
        for funnel in rec["funnels"]:
            assert set(funnel["rejected"]) <= set(al.STAGES)
    assert set(al.RUNBOOK_HINTS) == set(al.REASONS)
    return (al.REASONS, al.STAGES, al.RUNBOOK_HINTS, al.DEVICE_CLASS_TYPES,
            observed(alloc, reg))


def batch_most_constrained_first(side):
    _, alloc, reg = node(side, topology="2x2x1")
    claims = [chip_claim("uid-single"), chip_claim("uid-gang", count=2),
              chip_claim("uid-big", count=9)]
    results = alloc.allocate_batch(claims)
    errors = [None if e is None else e.reason for _, e in results]
    assert errors.count("shortfall") == 1
    return errors, observed(alloc, reg, *claims)


@pytest.mark.parametrize("scenario", [
    success_compact_funnel, gang_placement_score, first_fit_no_placement,
    scorer_best_fit, scorer_proves_unsat, enums_confine_values,
    batch_most_constrained_first,
], ids=lambda f: f.__name__)
def test_decision_record(scenario):
    both(scenario)


def test_ring_buffer_is_bounded(monkeypatch):
    monkeypatch.setenv("TPU_DRA_ALLOC_DECISION_BUFFER", "3")

    def scenario(side):
        _, alloc, reg = node(side)
        for i in range(5):
            with pytest.raises(side("kube.allocator").AllocationError):
                alloc.allocate(chip_claim(f"uid-{i}", count=99))
        recs = alloc.recent_decisions()
        assert len(recs) == 3 and recs[-1]["claim"]["uid"] == "uid-4"
        return observed(alloc, reg)

    both(scenario)


def test_deallocate_frees_and_reallocates():
    def scenario(side):
        _, alloc, reg = node(side)
        first = chip_claim("uid-a", count=2)
        alloc.allocate(first)
        alloc.deallocate("uid-a")
        again = chip_claim("uid-b", count=2)
        alloc.allocate(again)
        assert first["status"] == again["status"]
        return observed(alloc, reg, first, again)

    both(scenario)


# -- the UnsatisfiableClaim Event --------------------------------------------

EVENT_TIMES = ("firstTimestamp", "lastTimestamp")


def events_after(side, count, tries):
    """The Events left by ``tries`` solves of one claim for ``count``
    chips on a 2-chip node, their timestamps dropped."""
    kube = side("kube")
    client, _, _ = node(side)
    recorder = side("kube.events").EventRecorder(
        client, component="scheduler-sim",
        registry=side("utils.metrics").Registry())
    alloc = side("kube.allocator").ReferenceAllocator(
        client, registry=side("utils.metrics").Registry(),
        recorder=recorder)
    claim = chip_claim("uid-ev", count=count, name="wl-stuck")
    for _ in range(tries):
        try:
            alloc.allocate(claim)
        except side("kube.allocator").AllocationError:
            pass
    assert recorder.flush()
    events = client.list(kube.EVENTS, namespace="explain")
    return [{k: v for k, v in e.items() if k not in EVENT_TIMES}
            for e in events]


def test_unsatisfiable_claim_event_deduped():
    events = both(events_after, 99, 2)
    unsat = [e for e in events if e["reason"] == "UnsatisfiableClaim"]
    assert len(unsat) == 1
    ev = unsat[0]
    assert ev["type"] == "Warning" and ev["count"] == 2
    assert ev["involvedObject"]["name"] == "wl-stuck"
    assert "only 2 of 99" in ev["message"]
    assert PORT("kube.allocator").RUNBOOK_HINTS["shortfall"] in ev["message"]


def test_success_emits_no_event():
    assert both(events_after, 1, 1) == []


# -- the demo specs' CEL through the allocator (tests/test_cel.py) -----------


def published_4x4(side):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-a", topology="4x4x1", slice_id="s1")
    return client, side("kube.allocator").ReferenceAllocator(
        client, device_classes=load_device_classes())


def spec_claim(name, devices):
    return {"metadata": {"name": name, "namespace": "d", "uid": name},
            "spec": {"devices": devices}}


def tpu_test6_origin_pin(side):
    _, alloc = published_4x4(side)
    origin = spec_requests("demo/specs/quickstart/tpu-test6.yaml")[0]
    claim = spec_claim("t6-0", origin)
    alloc.allocate(claim)
    assert len(claim["status"]["allocation"]["devices"]["results"]) == 1
    with pytest.raises(side("kube.allocator").AllocationError) as ei:
        alloc.allocate(spec_claim("again", origin))
    return claim["status"], ei.value.reason, masked(alloc.recent_decisions())


def tpu_test6_quadrant(side):
    client, alloc = published_4x4(side)
    quadrant = spec_requests("demo/specs/quickstart/tpu-test6.yaml")[1]
    claim = spec_claim("q-0", quadrant)
    alloc.allocate(claim)
    results = claim["status"]["allocation"]["devices"]["results"]
    assert len(results) == 4
    picked = {r["device"] for r in results}
    for s in client.list(side("kube").RESOURCE_SLICES):
        for d in s["spec"].get("devices", []):
            if d["name"] in picked:
                attrs = d["basic"]["attributes"]
                assert attrs["iciX"]["int"] < 2 and attrs["iciY"]["int"] < 2
    with pytest.raises(side("kube.allocator").AllocationError) as ei:
        alloc.allocate(spec_claim("q-1", quadrant))
    return claim["status"], ei.value.reason, masked(alloc.recent_decisions())


def tpu_test7_gang(side):
    _, alloc = published_4x4(side)
    claim = spec_claim(
        "t7", spec_requests("demo/specs/quickstart/tpu-test7.yaml")[0])
    alloc.allocate(claim)
    assert len(claim["status"]["allocation"]["devices"]["results"]) == 4
    return claim["status"], masked(alloc.recent_decisions())


def deviceclass_types(side):
    _, alloc = published_4x4(side)
    claim = spec_claim("c", {"requests": [
        {"name": "r", "deviceClassName": "tensorcore.tpu.google.com"}]})
    alloc.allocate(claim)
    dev = claim["status"]["allocation"]["devices"]["results"][0]["device"]
    assert "-core-" in dev
    return claim["status"], masked(alloc.recent_decisions())


@pytest.mark.parametrize("scenario", [
    tpu_test6_origin_pin, tpu_test6_quadrant, tpu_test7_gang,
    deviceclass_types,
], ids=lambda f: f.__name__)
def test_demo_spec_through_allocator(scenario):
    both(scenario)


# -- a node of H100s: no interconnect mesh, no contiguity --------------------


def gpu_node(side, generation, topology):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0", generation=generation,
                 topology=topology, kinds=("chip",))
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(
        client, registry=reg, device_classes=load_device_classes())
    return client, alloc, reg


def hold_even(side, alloc):
    for i in (0, 2, 4, 6):
        alloc.allocate(chip_claim(f"uid-hold-{i}"),
                       selectors=coord_pin(side, f"{i},0,0"))


def test_tpu_gang_on_a_line_still_needs_contiguity():
    def scenario(side):
        _, alloc, reg = gpu_node(side, "v5e", "8x1x1")
        hold_even(side, alloc)
        with pytest.raises(side("kube.allocator").AllocationError) as ei:
            alloc.allocate(chip_claim("uid-gang", count=4))
        assert ei.value.reason == "gang"
        return ei.value.reason, observed(alloc, reg)

    both(scenario)


def test_gpu_gang_needs_no_contiguous_coordinates():
    _, alloc, reg = gpu_node(PORT, "h100", "8x1x1")
    hold_even(PORT, alloc)
    claim = chip_claim("uid-gang", count=4)
    alloc.allocate(claim)
    results = claim["status"]["allocation"]["devices"]["results"]
    assert {r["device"] for r in results} == {"tpu-1", "tpu-3", "tpu-5",
                                              "tpu-7"}
    rec = alloc.recent_decisions()[-1]
    assert rec["outcome"] == "ok" and rec["placements"] == {}
    assert "gang" not in rec["funnels"][0]["rejected"]


def test_gpu_cel_selector_on_generation_and_hbm():
    _, alloc, reg = gpu_node(PORT, "h100", "8x1x1")
    hbm = PORT("tpulib.topology").GENERATIONS["h100"].hbm_bytes
    a = "device.attributes['tpu.google.com']"
    fits = chip_claim("uid-fits", count=8, selectors=cel(
        f"{a}.generation == 'h100' && "
        f"device.capacity['tpu.google.com'].hbm >= {hbm}"))
    alloc.allocate(fits)
    assert len(fits["status"]["allocation"]["devices"]["results"]) == 8
    alloc.deallocate("uid-fits")
    for expr, reason in [
        (f"{a}.generation == 'v5p'", "request-cel"),
        (f"device.capacity['tpu.google.com'].hbm >= {hbm + 1}",
         "request-cel"),
    ]:
        with pytest.raises(PORT("kube.allocator").AllocationError) as ei:
            alloc.allocate(chip_claim("uid-no", selectors=cel(expr)))
        assert ei.value.reason == reason
        rec = alloc.recent_decisions()[-1]
        assert rec["reason"] == reason
        assert rec["funnels"][0]["rejected"]["request-cel"] == 8
