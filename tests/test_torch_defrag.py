"""The port's defrag planner and executor against the reference's.

On a fragmented TPU fake both packages plan the same migrations, serve
the same ``/debug/defrag`` document, execute the same steps (gateway
drain, re-placement, admission), refuse stale plans, roll back, and
recover from a crash at every ``defrag.*`` fault site to the same fleet;
the plans, the executor's journal (its on-disk intent included) and the
``tpu_dra_defrag_*`` exposition must be equal, wall-clock values masked.
On a fake node of 8 H100s the planner proposes no move: the GPUs form no
mesh, so there is no box to free.
"""

from __future__ import annotations

import json
import os
import types
import urllib.error
import urllib.request

import pytest

from test_torch_allocator import chip_claim, coord_pin, gpu_node, publish_host
from test_torch_kube import PORT, REF, both, exposition, masked


def fragmented_4x1(side):
    """4x1x1 slice with the two middle chips held: the two free corners
    cannot form a contiguous pair."""
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0", topology="4x1x1")
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(client, registry=reg)
    planner = side("kube.defrag").DefragPlanner(alloc, registry=reg)
    for i, coord in enumerate(("1,0,0", "2,0,0")):
        alloc.allocate(chip_claim(f"uid-mid-{i}"),
                       selectors=coord_pin(side, coord))
    return client, alloc, planner, reg


def unsat(side, alloc, claim, **kwargs):
    with pytest.raises(side("kube.allocator").AllocationError) as ei:
        alloc.allocate(claim, **kwargs)
    return ei.value.reason


def plans(planner, reg):
    return masked(planner.recent_plans()), exposition(reg, "tpu_dra_defrag_")


# -- the planner (tests/test_defrag.py) --------------------------------------


def fragmented_gang_gets_a_plan(side):
    _, alloc, planner, reg = fragmented_4x1(side)
    assert unsat(side, alloc, chip_claim("uid-gang", count=2)) == "gang"
    plan = planner.recent_plans()[-1]
    assert plan["outcome"] == "planned" and plan["wanted"] == 2
    assert plan["claim"]["uid"] == "uid-gang" and plan["reason"] == "gang"
    (mig,) = plan["migrations"]
    assert mig["claimUid"] in ("uid-mid-0", "uid-mid-1")
    assert mig["devices"] in (["tpu-1"], ["tpu-2"])
    assert mig["to"][0] in ("tpu-0", "tpu-3")
    assert plan["box"] == "2x1x1"
    text = reg.render()
    assert 'tpu_dra_defrag_plans_total{outcome="planned"} 1' in text
    assert "tpu_dra_defrag_last_plan_migrations 1" in text
    assert "tpu_dra_defrag_last_plan_freed_devices 2" in text
    return plans(planner, reg)


def capacity_shortfall(side):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0", topology="4x1x1")
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(client, registry=reg)
    planner = side("kube.defrag").DefragPlanner(alloc, registry=reg)
    assert unsat(side, alloc, chip_claim("uid-big", count=5)) == "shortfall"
    plan = planner.recent_plans()[-1]
    assert plan["outcome"] == "insufficient-capacity"
    assert plan["migrations"] == [] and "capacity problem" in plan["detail"]
    core = chip_claim("uid-cores", count=9,
                      device_class="tensorcore.tpu.google.com")
    assert unsat(side, alloc, core) == "shortfall"
    assert planner.recent_plans()[-1]["outcome"] == "no-topology"
    return plans(planner, reg)


def two_slices(side):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-a", topology="4x1x1", slice_id="s-a")
    return client


def immovable_blockers(side):
    al = side("kube.allocator")
    client = two_slices(side)
    publish_host(side, client, "node-b", topology="2x1x1", slice_id="s-b")
    reg = side("utils.metrics").Registry()
    alloc = al.ReferenceAllocator(client, registry=reg)
    planner = side("kube.defrag").DefragPlanner(alloc, registry=reg)
    for i, coord in enumerate(("1,0,0", "2,0,0")):
        claim = chip_claim(f"uid-mixed-{i}")
        claim["spec"]["devices"]["requests"].append(
            {"name": "r1", "deviceClassName": "tpu.google.com"})
        alloc.allocate(claim, selectors={
            "r0": [al.Selector("sliceId", "eq", "s-a"),
                   al.Selector("coord", "eq", coord)],
            "r1": [al.Selector("sliceId", "eq", "s-b")]})
    reason = unsat(side, alloc, chip_claim("uid-gang", count=2), selectors={
        "r0": [al.Selector("sliceId", "eq", "s-a")]})
    assert reason == "gang"
    plan = planner.recent_plans()[-1]
    assert plan["outcome"] == "unplannable" and plan["migrations"] == []
    return plans(planner, reg)


def plan_respects_selectors(side):
    al = side("kube.allocator")
    client = two_slices(side)
    publish_host(side, client, "node-b", topology="4x1x1", slice_id="s-b")
    reg = side("utils.metrics").Registry()
    alloc = al.ReferenceAllocator(client, registry=reg)
    planner = side("kube.defrag").DefragPlanner(alloc, registry=reg)
    pin = al.Selector("sliceId", "eq", "s-a")
    for i, coord in enumerate(("1,0,0", "2,0,0")):
        alloc.allocate(chip_claim(f"uid-mid-{i}"),
                       selectors=coord_pin(side, coord, pin))
    reason = unsat(side, alloc, chip_claim("uid-gang", count=2),
                   selectors={"r0": [pin]})
    assert reason == "gang"
    plan = planner.recent_plans()[-1]
    assert plan["outcome"] == "planned" and plan["sliceId"] == "s-a"
    assert plan["migrations"]
    return plans(planner, reg)


def healthy_only_unsat(side):
    def sicken(devices, counters):
        for d in devices:
            attrs = d.get("basic", {}).get("attributes", {})
            if attrs.get("coord", {}).get("string") == "0,0,0" \
                    and attrs.get("type", {}).get("string") == "chip":
                attrs["healthy"] = {"bool": False}
        return devices, counters

    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0", topology="4x1x1", mutate=sicken)
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(client, registry=reg)
    planner = side("kube.defrag").DefragPlanner(alloc, registry=reg)
    alloc.allocate(chip_claim("uid-mid"), selectors=coord_pin(side, "2,0,0"))
    reason = unsat(side, alloc, chip_claim("uid-gang", count=2),
                   require_healthy=True)
    assert reason == "gang"
    plan = planner.recent_plans()[-1]
    assert plan["outcome"] == "planned"
    assert plan["origin"] in ("1,0,0", "2,0,0")
    return plans(planner, reg)


def retry_dedup(side):
    _, alloc, planner, reg = fragmented_4x1(side)
    for _ in range(3):
        unsat(side, alloc, chip_claim("uid-gang", count=2))
    assert len(planner.recent_plans()) == 1
    alloc.deallocate("uid-mid-0")
    alloc.allocate(chip_claim("uid-mid-0b"),
                   selectors=coord_pin(side, "1,0,0"))
    unsat(side, alloc, chip_claim("uid-gang", count=2))
    assert len(planner.recent_plans()) == 2
    assert all(p["outcome"] in side("kube.defrag").OUTCOMES
               for p in planner.recent_plans())
    return plans(planner, reg)


@pytest.mark.parametrize("scenario", [
    fragmented_gang_gets_a_plan, capacity_shortfall, immovable_blockers,
    plan_respects_selectors, healthy_only_unsat, retry_dedup,
], ids=lambda f: f.__name__)
def test_planner(scenario):
    both(scenario)


def http_defrag(side, reg, planner):
    """GET /debug/defrag, then the 405 a POST must get."""
    srv = side("utils.metrics").MetricsServer(reg, host="127.0.0.1", port=0)
    srv.set_defrag_provider(planner.export_json)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        doc = json.loads(urllib.request.urlopen(
            f"{base}/debug/defrag").read().decode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/debug/defrag", data=b"x")
        assert ei.value.code == 405
        assert "GET" in ei.value.headers.get("Allow", "")
    finally:
        srv.stop()
    return doc


def test_debug_defrag_json_and_405():
    def scenario(side):
        _, alloc, planner, reg = fragmented_4x1(side)
        unsat(side, alloc, chip_claim("uid-gang", count=2))
        doc = http_defrag(side, reg, planner)
        assert doc["plans"][-1]["claim"]["uid"] == "uid-gang"
        assert doc["plans"][-1]["outcome"] == "planned" and "note" in doc
        srv = side("utils.metrics").MetricsServer(
            side("utils.metrics").Registry(), host="127.0.0.1", port=0)
        srv.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/debug/defrag")
        finally:
            srv.stop()
        assert ei.value.code == 404
        return masked(doc)

    both(scenario)


def test_gpu_node_gets_no_move():
    """The even GPUs held and a gang asking for the odd ones: on a line of
    TPUs the planner would move claims to free a box; on H100s the gang
    fits as it is, and a gang beyond the free GPUs gets no move either,
    since the GPUs publish no mesh to defragment."""
    def plan_after_holds(generation, count):
        _, alloc, reg = gpu_node(PORT, generation, "8x1x1")
        planner = PORT("kube.defrag").DefragPlanner(alloc, registry=reg)
        for i in (0, 2, 4, 6):
            alloc.allocate(chip_claim(f"uid-hold-{i}"),
                           selectors=coord_pin(PORT, f"{i},0,0"))
        try:
            alloc.allocate(chip_claim("uid-gang", count=count))
        except PORT("kube.allocator").AllocationError as e:
            return e.reason, planner.recent_plans()
        return "ok", planner.recent_plans()

    reason, tpu_plans = plan_after_holds("v5e", 4)
    assert reason == "gang"
    assert tpu_plans[-1]["outcome"] == "planned"
    assert tpu_plans[-1]["migrations"]
    assert plan_after_holds("h100", 4) == ("ok", [])
    assert plan_after_holds("h100", 5) == ("reserved", [])
    # Asked directly, as for a stuck gang, the planner finds no mesh.
    _, alloc, reg = gpu_node(PORT, "h100", "8x1x1")
    planner = PORT("kube.defrag").DefragPlanner(alloc, registry=reg)
    plan = planner.note_unsat(chip_claim("uid-gang", count=4),
                              types.SimpleNamespace(reason="gang"))
    assert plan["outcome"] == "no-topology" and plan["migrations"] == []
    assert "no slice publishes grounded chip coordinates" in plan["detail"]


# -- the executor (tests/test_defrag_executor.py) ----------------------------


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for side in (REF, PORT):
        side("utils.faults").disarm()


def stuck_gang(side, alloc, planner, uid="uid-gang", count=2):
    assert unsat(side, alloc, chip_claim(uid, count=count)) == "gang"
    plan = planner.recent_plans()[-1]
    assert plan["outcome"] == "planned"
    return plan, chip_claim(uid, count=count)


def executor(side, root, alloc, planner, reg=None, **kwargs):
    os.makedirs(root, exist_ok=True)
    return side("kube.defrag_executor").DefragExecutor(
        planner, alloc, intent_path=os.path.join(root, "defrag-intent.json"),
        registry=reg if reg is not None else side("utils.metrics").Registry(),
        **kwargs)


def held_by(alloc, uid):
    return {n for (_, n), h in alloc._reservations.items() if h == uid}


def normalized(obj, root):
    """``obj`` masked, the side's own directory written as <dir>."""
    return json.loads(json.dumps(masked(obj)).replace(root, "<dir>"))


def journal(execu, reg, root):
    """The executor's records and metrics."""
    return (normalized(execu.export_executions(), root),
            exposition(reg, "tpu_dra_defrag_exec_"))


def end_to_end(side, root):
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    mig = plan["migrations"][0]
    execu = executor(side, root, alloc, planner, reg)
    moves = []
    execu.add_migration_listener(
        lambda uid, devs: moves.append((uid, sorted(devs))))
    record = execu.execute(plan, claim=claim)
    assert record["state"] == "completed"
    results = claim["status"]["allocation"]["devices"]["results"]
    assert len(results) == 2
    assert held_by(alloc, "uid-gang") == {r["device"] for r in results}
    assert held_by(alloc, mig["claimUid"]) == set(mig["to"])
    assert len(alloc._reservations) == 4
    assert [(s["kind"], s["outcome"]) for s in record["steps"]] == [
        ("intent-write", "ok"), ("drain", "ok"), ("replace", "ok"),
        ("admit", "ok")]
    assert execu.orphaned_intent() is None
    assert not os.path.exists(execu.intent_path)
    assert moves == [(mig["claimUid"], sorted(mig["to"]))]
    text = reg.render()
    assert ('tpu_dra_defrag_exec_executions_total'
            '{outcome="completed"} 1') in text
    assert ('tpu_dra_defrag_exec_steps_total'
            '{kind="admit",outcome="ok"} 1') in text
    assert "tpu_dra_defrag_exec_in_flight 0" in text
    doc = http_defrag(side, reg, planner)
    assert doc["executions"][-1]["planId"] == plan["planId"]
    return (claim["status"], moves, normalized(doc, root),
            journal(execu, reg, root))


def gateway_drain(side, root):
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    mover = plan["migrations"][0]["claimUid"]
    gateway = side("serving_gateway")
    gw = gateway.ServingGateway(side("utils.metrics").Registry(),
                                node_name="test")
    engine = side("serving_gateway.sim").ScriptedEngine()
    gw.add_replica(engine, "r-mover", claim_uid=mover)
    execu = executor(side, root, alloc, planner, reg, gateway=gw)
    reqs = [gw.submit([i] * 8, 3) for i in range(6)]
    gw.tick()
    record = execu.execute(plan, claim=claim)
    assert record["state"] == "completed"
    drain = [s for s in record["steps"] if s["kind"] == "drain"][0]
    assert "1 serving replica" in drain["detail"]
    (replica,) = gw.replicas()
    assert replica.state == "healthy"
    gw.run()
    assert all(r.state == "finished" for r in reqs)
    assert gw.counters["failed"] == 0
    engine.assert_no_leaks()
    return [r.state for r in reqs], journal(execu, reg, root)


def stale_plan_refused(side, root):
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    alloc.allocate(chip_claim("uid-late"))
    before = dict(alloc._reservations)
    execu = executor(side, root, alloc, planner, reg)
    with pytest.raises(side("kube.defrag_executor").StalePlanError):
        execu.execute(plan, claim=claim)
    assert alloc._reservations == before
    assert not os.path.exists(execu.intent_path)
    rec = execu.export_executions()[-1]
    assert rec["state"] == "refused" and "re-plan" in rec["detail"]
    assert ('tpu_dra_defrag_exec_executions_total'
            '{outcome="stale-plan"} 1') in reg.render()
    return journal(execu, reg, root)


def only_planned_execute(side, root):
    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-0", topology="4x1x1")
    reg = side("utils.metrics").Registry()
    alloc = side("kube.allocator").ReferenceAllocator(client, registry=reg)
    planner = side("kube.defrag").DefragPlanner(alloc, registry=reg)
    unsat(side, alloc, chip_claim("uid-big", count=5))
    plan = planner.recent_plans()[-1]
    assert plan["outcome"] == "insufficient-capacity"
    execu = executor(side, root, alloc, planner, reg)
    with pytest.raises(side("kube.defrag_executor").DefragExecutionError,
                       match="not executable"):
        execu.execute(plan)
    assert ('tpu_dra_defrag_exec_executions_total'
            '{outcome="refused"} 1') in reg.render()
    return journal(execu, reg, root)


def admit_failure_rolls_back(side, root):
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    mover = plan["migrations"][0]["claimUid"]
    gw = side("serving_gateway").ServingGateway(
        side("utils.metrics").Registry(), node_name="test")
    gw.add_replica(side("serving_gateway.sim").ScriptedEngine(), "r-mover",
                   claim_uid=mover)
    before = dict(alloc._reservations)
    execu = executor(side, root, alloc, planner, reg, gateway=gw)
    al = side("kube.allocator")
    with pytest.raises(side("kube.defrag_executor").DefragExecutionError,
                       match="rolled back"):
        execu.execute(plan, claim=claim, selectors={
            "r0": [al.Selector("sliceId", "eq", "no-such")]})
    assert alloc._reservations == before
    assert held_by(alloc, "uid-gang") == set()
    assert not os.path.exists(execu.intent_path)
    rec = execu.export_executions()[-1]
    assert rec["state"] == "rolled-back"
    assert [r["outcome"] for r in rec["rollbacks"]] == ["ok"]
    (replica,) = gw.replicas()
    assert replica.state == "healthy"
    text = reg.render()
    assert ('tpu_dra_defrag_exec_steps_total'
            '{kind="admit",outcome="failed"} 1') in text
    return journal(execu, reg, root)


def drain_fault_rolls_back(side, root):
    faults = side("utils.faults")
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    before = dict(alloc._reservations)
    execu = executor(side, root, alloc, planner, reg)
    fault = faults.FaultPlan().fail(
        "defrag.drain", faults.FaultError("chaos"), times=1)
    with faults.armed(fault):
        with pytest.raises(side("kube.defrag_executor").DefragExecutionError,
                           match="rolled back"):
            execu.execute(plan, claim=claim)
    assert alloc._reservations == before
    assert not os.path.exists(execu.intent_path)
    assert execu.export_executions()[-1]["state"] == "rolled-back"
    return journal(execu, reg, root)


@pytest.mark.parametrize("scenario", [
    end_to_end, gateway_drain, stale_plan_refused, only_planned_execute,
    admit_failure_rolls_back, drain_fault_rolls_back,
], ids=lambda f: f.__name__)
def test_executor(scenario, tmp_path):
    both(lambda side: scenario(side, str(tmp_path / str(side))))


def crash_then_restart(side, root, site):
    faults = side("utils.faults")
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    mig = plan["migrations"][0]
    execu = executor(side, root, alloc, planner, reg)
    before = dict(alloc._reservations)
    with faults.armed(faults.FaultPlan().crash(site)):
        with pytest.raises(faults.CrashPoint):
            execu.execute(plan, claim=claim)
    on_disk = execu.orphaned_intent()
    reg2 = side("utils.metrics").Registry()
    execu2 = executor(side, root, alloc, planner, reg2)
    rec = execu2.recover()
    if site == "defrag.intent-write":
        assert rec is None and alloc._reservations == before
        rec = execu2.execute(plan, claim=chip_claim("uid-gang", count=2))
        assert rec["state"] == "completed"
    else:
        assert rec["state"] == "completed" and rec["recovered"] is True
        assert "crash recovery" in rec["detail"]
    assert len(held_by(alloc, "uid-gang")) == 2
    assert held_by(alloc, mig["claimUid"]) == set(mig["to"])
    assert execu2.orphaned_intent() is None
    assert not os.path.exists(execu2.intent_path)
    return normalized(on_disk, root), journal(execu2, reg2, root)


def test_crash_sites_match():
    sites = both(lambda side: side("utils.faults").sites_in("defrag."))
    assert sites


@pytest.mark.parametrize(
    "site", PORT("utils.faults").sites_in("defrag."))
def test_crash_then_restart_converges(tmp_path, site):
    both(lambda side: crash_then_restart(side, str(tmp_path / str(side)),
                                         site))


def recovery_reentrant(side, root):
    faults = side("utils.faults")
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    execu = executor(side, root, alloc, planner, reg)
    with faults.armed(faults.FaultPlan().crash("defrag.replace")):
        with pytest.raises(faults.CrashPoint):
            execu.execute(plan, claim=claim)
    execu2 = executor(side, root, alloc, planner)
    orphan = execu2.orphaned_intent()
    assert orphan["planId"] == plan["planId"]
    assert orphan["path"] == execu2.intent_path
    with faults.armed(faults.FaultPlan().crash("defrag.admit")):
        with pytest.raises(faults.CrashPoint):
            execu2.recover()
    reg3 = side("utils.metrics").Registry()
    execu3 = executor(side, root, alloc, planner, reg3)
    rec = execu3.recover()
    assert rec["state"] == "completed"
    assert len(held_by(alloc, "uid-gang")) == 2
    assert execu3.orphaned_intent() is None
    return journal(execu3, reg3, root)


def abort_rolls_back(side, root):
    faults = side("utils.faults")
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, claim = stuck_gang(side, alloc, planner)
    before = dict(alloc._reservations)
    execu = executor(side, root, alloc, planner, reg)
    with faults.armed(faults.FaultPlan().crash("defrag.admit")):
        with pytest.raises(faults.CrashPoint):
            execu.execute(plan, claim=claim)
    reg2 = side("utils.metrics").Registry()
    execu2 = executor(side, root, alloc, planner, reg2)
    rec = execu2.abort()
    assert rec["state"] == "rolled-back"
    assert alloc._reservations == before
    assert held_by(alloc, "uid-gang") == set()
    assert execu2.orphaned_intent() is None
    assert not os.path.exists(execu2.intent_path)
    assert execu2.abort() is None
    return journal(execu2, reg2, root)


@pytest.mark.parametrize("scenario", [recovery_reentrant, abort_rolls_back],
                         ids=lambda f: f.__name__)
def test_recovery(scenario, tmp_path):
    both(lambda side: scenario(side, str(tmp_path / str(side))))
