"""The port's node-plugin loops against the reference's: usage accounting,
the state-drift auditor, the orphan cleaner and the SLO-aware rebalancer.

Twins of ``test_accounting.py``, ``test_audit.py``, ``test_cleanup.py``
and ``test_rebalancer.py``: each scenario runs once per package on TPU
fakes, in a directory of its own, makes the reference test's assertions
and returns what it observed (snapshots, findings, decision records,
checkpoints, rendered metric lines); the two packages' observations must
be equal, wall-clock values masked (``test_torch_plugin_driver.both``).
"""

from __future__ import annotations

import json
import os
import re
import time

import pytest

from test_device_state import make_claim as ds_claim
from test_device_state import opaque
from test_rebalancer import BATCH_SLO, INFER_SLO, shared_claim
from test_torch_kube import PORT, SIDES, exposition
from test_torch_plugin_driver import both, make_driver, masked

DRIVER = "tpu.google.com"
GIB = 1 << 30
SEED = int(os.environ.get("TPU_DRA_CHAOS_SEED", "1234"))


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for side in SIDES:
        side("utils.faults").disarm()


def make_state(side, root, lib=None, generation="v5p", topology="2x2x1"):
    lib = lib or side("tpulib").FakeChipLib(generation=generation,
                                            topology=topology)
    (root / "driver").mkdir(parents=True, exist_ok=True)
    return side("plugin.device_state").DeviceState(
        chiplib=lib,
        cdi=side("cdi").CDIHandler(
            str(root / "cdi"), driver_root=str(root / "driver"),
            driver_root_ctr_path=str(root / "driver")),
        checkpoint=side("plugin.checkpoint").CheckpointManager(
            str(root / "checkpoint.json")),
        driver_name=DRIVER, pool_name="node-a",
        state_dir=str(root / "state"),
    ), lib


def claim(uid, devices, strategy=None, name="c"):
    """test_accounting.make_claim / test_audit.make_claim."""
    cfgs = []
    if strategy:
        cfgs = [opaque({"apiVersion": "tpu.google.com/v1alpha1",
                        "kind": "TpuChipConfig",
                        "sharing": {"strategy": strategy}})]
    return {
        "metadata": {"name": name, "namespace": "ns", "uid": uid},
        "status": {"allocation": {"devices": {"results": [
            {"request": f"r{i}", "driver": DRIVER, "pool": "node-a",
             "device": d} for i, d in enumerate(devices)],
            "config": cfgs}}},
    }


def findings(found):
    """(check, subject, detail) of each finding, epoch times in the
    detail masked."""
    return [(f.check, f.subject, re.sub(r"\d{9,}\.\d+", "<t>", f.detail))
            for f in found]


# -- test_accounting.py -------------------------------------------------------


class FakeClock:
    """Starts at the wall clock (``prepared_at`` is stamped with
    ``time.time()``) and advances only when told."""

    def __init__(self):
        self.t = time.time()

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def attach(side, state, clock):
    registry = side("utils.metrics").Registry()
    acct = side("plugin.accounting").UsageAccountant(
        registry, node_name="node-a", inventory=state.usage_inventory,
        clock=clock)
    state.accountant = acct
    return acct, registry


def usage(acct):
    """The snapshot with the hold clocks rounded to the second (the
    accountant reads a clock that started at the wall clock)."""
    snap = masked(acct.snapshot())
    for h in snap["holds"]:
        h["heldSeconds"] = round(h["heldSeconds"])
    return snap


def occupancy(side, root):
    state, _ = make_state(side, root)
    acct, registry = attach(side, state, FakeClock())
    state.prepare(claim("uid-1", ["tpu-0"]))
    seen = [usage(acct)]
    assert seen[0]["occupied"] == {"chip": {"exclusive": 1}}
    assert acct._m_capacity.value(type="chip") == 4
    state.unprepare("uid-1")
    seen.append(usage(acct))
    state.prepare(claim("uid-ts", ["tpu-0"], strategy="TimeShared"))
    c2 = claim("uid-ex", ["tpu-1"], name="c2")
    state.prepare(c2)
    state.prepare(c2)               # a kubelet retry books once
    state.prepare(claim("uid-core", ["tpu-2-core-0"], name="c3"))
    state.prepare(claim("uid-ps", ["tpu-3"], strategy="ProcessShared",
                        name="c4"))
    seen.append(usage(acct))
    assert seen[-1]["occupied"]["chip"] == {
        "time-shared": 1, "exclusive": 1, "process-shared": 1}
    json.dumps(acct.snapshot())
    seen.append(acct._m_chip_claims.value(
        chip=state.allocatable["tpu-2"].chip.uuid))
    return seen, exposition(registry, "tpu_dra_usage_")


def allocated_seconds(side, root):
    state, _ = make_state(side, root)
    clock = FakeClock()
    acct, registry = attach(side, state, clock)
    state.prepare(claim("uid-1", ["tpu-0", "tpu-1"]))
    clock.advance(10.0)
    registry.render()
    mid = acct._m_alloc_seconds.value(type="chip")
    assert mid == pytest.approx(20.0)
    clock.advance(5.0)
    state.unprepare("uid-1")
    assert acct._m_alloc_seconds.value(type="chip") == pytest.approx(30.0)
    state.prepare(claim("uid-2", ["tpu-0"]))
    clock.advance(120.0)
    state.unprepare("uid-2")
    # Hold durations run from the wall-clock prepared_at to the fake
    # clock: 15 s, then 135 s.
    n, total = acct._m_hold_seconds.summary()
    assert n == 2 and total == pytest.approx(150.0, abs=2.0)
    return round(mid, 6), n


def rebuild(side, root):
    state, _ = make_state(side, root)
    clock = FakeClock()
    acct, _ = attach(side, state, clock)
    state.prepare(claim("uid-1", ["tpu-0"]))
    clock.advance(60.0)
    restarted, _ = make_state(side, root)
    acct2, _ = attach(side, restarted, clock)
    acct2.rebuild(restarted.checkpoint.read())
    snap = usage(acct2)
    assert [h["claimUid"] for h in snap["holds"]] == ["uid-1"]
    assert snap["holds"][0]["heldSeconds"] == 60
    assert acct2._m_alloc_seconds.value(type="chip") == 0
    restarted.unprepare("uid-1")
    assert acct2.snapshot()["holds"] == []
    return snap


def group_modes(side, root):
    group_mode = side("plugin.accounting").group_mode
    modes = [group_mode(c) for c in (
        {"adminAccess": True}, {"kind": "IciChannelConfig"},
        {"sharing": {"strategy": "TimeShared"}},
        {"sharing": {"strategy": "ProcessShared"}}, {})]
    assert modes == ["admin", "channel", "time-shared", "process-shared",
                     "exclusive"]
    state, lib = make_state(side, root)
    acct, _ = attach(side, state, FakeClock())
    lib.wedge_chip(0, reason="hbm errors")
    state.refresh_allocatable()
    uuid0 = state.allocatable["tpu-0"].chip.uuid
    snap = usage(acct)
    assert snap["chips"][uuid0]["state"] == "degraded"
    return modes, snap


@pytest.mark.parametrize("scenario", [
    occupancy, allocated_seconds, rebuild, group_modes,
], ids=lambda f: f.__name__)
def test_accounting(tmp_path, scenario):
    both(scenario, tmp_path)


# -- test_audit.py ------------------------------------------------------------


def auditor_for(side, state, **kw):
    registry = side("utils.metrics").Registry()
    return side("plugin.audit").StateAuditor(
        state=state, registry=registry, node_name="node-a", node_uid="nu-1",
        **kw), registry


def audit_checks(side, root):
    """Clean state, an orphan CDI spec, a torn checkpoint, a missing CDI
    spec, a phantom hold, a health-ordering violation, adminAccess on a
    sick chip, a duplicate channel: each pass's findings and metrics."""
    seen = []
    state, lib = make_state(side, root)
    state.prepare(claim("uid-1", ["tpu-0"]))
    auditor, registry = auditor_for(side, state)
    assert auditor.run_once() == []
    seen.append(auditor.readiness_check())
    state.cdi.create_claim_spec_file("uid-orphan", {}, {})
    seen.append(findings(auditor.run_once()))
    seen.append(auditor.readiness_check())
    auditor.run_once()
    assert auditor._m_drift_total.value(check="cdi") == 1
    state.cdi.delete_claim_spec_file("uid-orphan")
    state.cdi.delete_claim_spec_file("uid-1")
    seen.append(findings(auditor.run_once()))
    uuid1 = state.allocatable["tpu-1"].chip.uuid
    state.share_state.acquire(uuid1, "uid-ghost", "exclusive")
    seen.append(findings(auditor.run_once()))
    state.share_state.release(uuid1, "uid-ghost")
    seen.append(exposition(registry, "tpu_dra_audit_"))
    path = root / "checkpoint.json"
    text = path.read_text()
    path.write_text(text[:40])
    seen.append(sorted({f.check for f in auditor.run_once()}))
    path.write_text(text)
    return seen


def audit_health_and_channels(side, root):
    state, lib = make_state(side, root)
    state.prepare(claim("uid-1", ["tpu-0"]))
    lib.wedge_chip(0, reason="ecc")
    state.refresh_allocatable()
    records = state.checkpoint.read()
    records["uid-1"]["preparedAt"] = time.time() + 3600
    state.checkpoint.write(records)
    auditor, _ = auditor_for(side, state)
    health = findings(auditor.run_once())
    assert any(c == "health" and s == "uid-1" for c, s, _ in health)
    state.prepare({
        "metadata": {"name": "mon", "namespace": "ns", "uid": "uid-admin"},
        "spec": {"devices": {"requests": [
            {"name": "r0", "deviceClassName": DRIVER, "adminAccess": True}]}},
        "status": {"allocation": {"devices": {"results": [
            {"request": "r0", "driver": DRIVER, "pool": "node-a",
             "device": "tpu-0"}], "config": []}}},
    })
    records = state.checkpoint.read()
    records["uid-1"]["preparedAt"] = 0.0
    state.checkpoint.write(records)
    admin = findings(auditor.run_once())
    assert admin == []
    state.unprepare("uid-admin")
    records = state.checkpoint.read()
    for uid in ("uid-1", "uid-2"):
        rec = json.loads(json.dumps(records["uid-1"]))
        rec["claimUID"] = uid
        rec["groups"][0]["devices"][0]["channel"] = 7
        records[uid] = rec
    state.checkpoint.write(records)
    channels = findings(auditor.run_once())
    assert any(c == "channels" for c, _, _ in channels)
    return health, channels


def audit_slices_and_events(side, root):
    kube = side("kube")
    driver, client, lib = make_driver(
        side, root, cleanup_interval_seconds=0,
        device_watch_interval_seconds=0, audit_interval_seconds=0)
    driver.start()
    try:
        ok = driver.degraded_checks()["state-consistent"]()
        assert driver.auditor.run_once() == []
        lib.unplug_chip(1)
        driver.state.refresh_allocatable()
        stale = findings(driver.auditor.run_once())
        assert any(c == "slices" and s == "tpu-1" for c, s, _ in stale)
        client.fault_injector = lambda verb, gvr, name: kube.ApiError(
            "blackout", code=503)
        dark = findings(driver.auditor.run_once())
        assert not any(c == "slices" for c, _, _ in dark)
    finally:
        client.fault_injector = None
        driver.shutdown()
    state, _ = make_state(side, root / "events")
    state.cdi.create_claim_spec_file("uid-orphan", {}, {})
    ev_client = kube.FakeKubeClient()
    recorder = side("kube.events").EventRecorder(ev_client, component="test")
    auditor, _ = auditor_for(side, state, events=recorder)
    auditor.run_once()
    auditor.run_once()
    recorder.flush()
    events = [(e["reason"], e["involvedObject"]["name"], e["count"],
               e["message"]) for e in ev_client.list(kube.EVENTS)]
    assert [e[:3] for e in events] == [("StateDrift", "node-a", 2)]
    return ok, stale, dark, events


@pytest.mark.parametrize("scenario", [
    audit_checks, audit_health_and_channels, audit_slices_and_events,
], ids=lambda f: f.__name__)
def test_audit(tmp_path, scenario):
    both(scenario, tmp_path)


# -- test_cleanup.py ----------------------------------------------------------


PS = {"apiVersion": "tpu.google.com/v1alpha1", "kind": "TpuChipConfig",
      "sharing": {"strategy": "ProcessShared"}}
TS = {"apiVersion": "tpu.google.com/v1alpha1", "kind": "TpuChipConfig",
      "sharing": {"strategy": "TimeShared"}}


def cleaner_for(side, state, **kw):
    return side("plugin.cleanup").OrphanCleaner(state, **kw)


def cleanup_local(side, root):
    chiplib = side("tpulib.chiplib")
    sharing = side("plugin.sharing")
    state, lib = make_state(side, root)
    state.prepare(ds_claim("uid-live", ["tpu-0"], configs=[opaque(PS)]))
    state.cdi.create_claim_spec_file("uid-ghost", {}, {})
    ghost = os.path.join(state.ps_manager.run_dir, "uid-ghost-abcde")
    os.makedirs(ghost)
    cleaner = cleaner_for(side, state)
    cleaner.clean_once()
    assert state.cdi.list_claim_spec_uids() == ["uid-live"]
    assert not os.path.exists(ghost)
    assert any(d.startswith("uid-live")
               for d in os.listdir(state.ps_manager.run_dir))
    uuid = lib.enumerate_chips()[1].uuid
    state.share_state.acquire(uuid, "uid-ghost", chiplib.SHARING_TIME_SHARED)
    lib.set_sharing_mode([uuid], chiplib.SHARING_TIME_SHARED)
    with pytest.raises(sharing.ModeConflictError):
        state.share_state.acquire(uuid, "uid-new",
                                  chiplib.SHARING_PROCESS_SHARED)
    cleaner.clean_once()
    assert lib.sharing_modes[uuid] == chiplib.SHARING_EXCLUSIVE
    state.prepare(ds_claim("uid-ts", ["tpu-2"], configs=[opaque(TS)],
                           name="c-ts"))
    uuid2 = lib.enumerate_chips()[2].uuid
    state.share_state.acquire(uuid2, "uid-ghost2",
                              chiplib.SHARING_TIME_SHARED)
    cleaner.clean_once()
    st = state.share_state.get(uuid2)
    assert set(st.claims) == {"uid-ts"}
    return (cleaner.removed_cdi, cleaner.removed_share_claims,
            cleaner.passes, st.mode, lib.sharing_modes[uuid2])


def cleanup_deleted_claims(side, root):
    kube = side("kube")
    state, _ = make_state(side, root)
    client = kube.FakeKubeClient()
    c1 = ds_claim("uid-1", ["tpu-0"], name="c1", namespace="ns")
    client.create(kube.RESOURCE_CLAIMS, c1, namespace="ns")
    state.prepare(c1)
    old = ds_claim("uid-old", ["tpu-1"], name="c2", namespace="ns")
    client.create(kube.RESOURCE_CLAIMS, old, namespace="ns")
    state.prepare(old)
    cleaner = cleaner_for(side, state, kube_client=client)
    cleaner.clean_once()
    kept = sorted(state.checkpoint.read())
    client.delete(kube.RESOURCE_CLAIMS, "c1", namespace="ns")
    client.delete(kube.RESOURCE_CLAIMS, "c2", namespace="ns")
    client.create(kube.RESOURCE_CLAIMS,
                  ds_claim("uid-new", ["tpu-2"], name="c2", namespace="ns"),
                  namespace="ns")
    cleaner.clean_once()
    assert state.checkpoint.read() == {}
    return kept, cleaner.unprepared_deleted


def cleanup_dialects(side, root):
    kube = side("kube")
    state, _ = make_state(side, root)
    client = kube.FakeKubeClient()
    client.served_api_versions["resource.k8s.io"] = ["v1beta1"]
    beta = kube.ResourceApi("v1beta1")
    live = ds_claim("uid-live", ["tpu-0"], name="c-live", namespace="ns")
    dead = ds_claim("uid-dead", ["tpu-1"], name="c-dead", namespace="ns")
    client.create(beta.claims, live, namespace="ns")
    state.prepare(live)
    state.prepare(dead)
    observed = []
    stale = cleaner_for(side, state, kube_client=client,
                        resource_api=kube.ResourceApi("v1alpha3"),
                        on_dialect_change=observed.append)
    stale.clean_once()
    assert set(state.checkpoint.read()) == {"uid-live", "uid-dead"}
    holder = {"api": kube.ResourceApi("v1alpha3")}
    cleaner = cleaner_for(side, state, kube_client=client,
                          resource_api=lambda: holder["api"],
                          on_dialect_change=lambda a: holder.update(api=a))
    cleaner.clean_once()
    assert set(state.checkpoint.read()) == {"uid-live", "uid-dead"}
    cleaner.clean_once()
    assert set(state.checkpoint.read()) == {"uid-live"}
    return [a.version for a in observed], cleaner.unprepared_deleted


def cleanup_thread(side, root):
    state, _ = make_state(side, root)
    cleaner = cleaner_for(side, state, interval_seconds=0.05)
    cleaner.start()
    time.sleep(0.2)
    cleaner.stop()
    assert cleaner.passes >= 1
    return True


@pytest.mark.parametrize("scenario", [
    cleanup_local, cleanup_deleted_claims, cleanup_dialects, cleanup_thread,
], ids=lambda f: f.__name__)
def test_cleanup(tmp_path, scenario):
    both(scenario, tmp_path)


# -- test_rebalancer.py -------------------------------------------------------


def v5e_state(side, root):
    return make_state(side, root, generation="v5e", topology="2x1x1")[0]


def granted(state, uid):
    psc = state.checkpoint.read()[uid]["groups"][0]["config"]["sharing"][
        "processSharedConfig"]
    return (psc.get("defaultActiveCorePercentage"),
            psc.get("defaultHbmLimit"))


def audit(side, state):
    return findings(side("plugin.audit").StateAuditor(
        state=state, registry=side("utils.metrics").Registry(),
        node_name="node-a").run_once())


def session_dir(state, uid):
    run_dir = state.ps_manager.run_dir
    (d,) = [d for d in os.listdir(run_dir) if d.startswith(uid)]
    return os.path.join(run_dir, d)


def rebalancer(side, state, demand, clock, **kw):
    registry = side("utils.metrics").Registry()
    return side("plugin.rebalancer").Rebalancer(
        state, registry, node_name="node-a",
        demand_source=kw.pop("demand_source",
                             lambda v: demand.get(v.claim_uid)),
        clock=lambda: clock[0], **kw), registry


def trail(reb, registry):
    return (masked(reb.snapshot()),
            exposition(registry, "tpu_dra_slo_"))


def burst_steal_and_return(side, root):
    shim = side("parallel.shim")
    state = v5e_state(side, root)
    state.prepare(shared_claim("uid-infer", 30, "4Gi", INFER_SLO,
                               name="infer"))
    state.prepare(shared_claim("uid-batch", 70, "12Gi", BATCH_SLO,
                               name="batch"))
    demand, clock = {}, [10_000.0]
    reb, registry = rebalancer(side, state, demand, clock)

    def workload(uid):
        env = {"TPU_DRA_SHARING": "process-shared",
               "TPU_DRA_MAX_PROCESSES": "2",
               "TPU_DRA_SHARED_DIR": session_dir(state, uid),
               "TPU_DRA_CHIP_HBM_BYTES": str(16 * GIB)}
        rt = shim.apply_sharing_env(env)
        assert rt is not None and rt.slot == 0
        return env, rt

    env_i, rt_i = workload("uid-infer")
    env_b, rt_b = workload("uid-batch")

    def ticks(n, stop):
        out = []
        for _ in range(n):
            out += reb.run_once()
            clock[0] += 120.0
            assert audit(side, state) == []
            if stop():
                break
        return out

    demand.update({"uid-infer": {"busy": 1.0, "hbm": 1.0},
                   "uid-batch": {"busy": 0.05, "hbm": 0.05}})
    phase1 = ticks(8, lambda: granted(state, "uid-infer")[0] == 80)
    assert granted(state, "uid-infer") == (80, "12288Mi")
    assert granted(state, "uid-batch") == (20, "4096Mi")
    updates = [shim.poll_sharing_update(env_i), shim.poll_sharing_update(env_i),
               shim.poll_sharing_update(env_b)]
    assert updates[1] is None
    demand.update({"uid-infer": {"busy": 0.02, "hbm": 0.02},
                   "uid-batch": {"busy": 1.0, "hbm": 1.0}})
    phase2 = ticks(10, lambda: granted(state, "uid-batch")[0] == 70)
    assert granted(state, "uid-batch") == (70, "12288Mi")
    rt_i.release()
    rt_b.release()
    return (masked(phase1), masked(phase2),
            [None if u is None else vars(u) for u in updates],
            sorted(env_i.items()), trail(reb, registry))


def file_demand_source(side, root):
    shim = side("parallel.shim")
    rb = side("plugin.rebalancer")
    state = v5e_state(side, root)
    state.prepare(shared_claim("uid-infer", 30, "4Gi", INFER_SLO,
                               name="infer"))
    state.prepare(shared_claim("uid-batch", 70, "12Gi", BATCH_SLO,
                               name="batch"))
    clock = [10_000.0]
    reb, registry = rebalancer(
        side, state, {}, clock,
        demand_source=rb.FileDemandSource(state.ps_manager.run_dir,
                                          clock=lambda: clock[0]))
    envs = {}
    for uid in ("uid-infer", "uid-batch"):
        envs[uid] = {"TPU_DRA_SHARING": "process-shared",
                     "TPU_DRA_MAX_PROCESSES": "2",
                     "TPU_DRA_SHARED_DIR": session_dir(state, uid),
                     "TPU_DRA_CHIP_HBM_BYTES": str(16 * GIB)}
        rt = shim.apply_sharing_env(envs[uid])
        rt.release()
    assert reb.run_once() == []
    clock[0] += 120.0
    offset = clock[0] - time.time()
    assert shim.report_usage(1.0, environ=envs["uid-infer"])
    assert shim.report_usage(0.0, environ=envs["uid-batch"])
    for uid in envs:
        p = os.path.join(session_dir(state, uid), "usage-slot-0.json")
        with open(p) as f:
            doc = json.load(f)
        doc["ts"] += offset
        with open(p, "w") as f:
            json.dump(doc, f)
    records = reb.run_once()
    assert [r["outcome"] for r in records] == ["applied"]
    assert granted(state, "uid-infer")[0] == 40
    return masked(records), trail(reb, registry)


def policy(side, root, shares, demand, policy_kw, ticks, step):
    """Two co-tenants under the policy: the records of each tick."""
    rb = side("plugin.rebalancer")
    state = v5e_state(side, root)
    (a, a_pct, a_slo), (b, b_pct, b_slo) = shares
    state.prepare(shared_claim(a, a_pct, "8Gi", a_slo))
    state.prepare(shared_claim(b, b_pct, "8Gi", b_slo))
    clock = [50_000.0]
    demands = {} if callable(demand) else dict(demand)
    reb, registry = rebalancer(
        side, state, demands, clock,
        policy=rb.MisoPolicy(**policy_kw) if policy_kw else None)
    out = []
    for i in range(ticks):
        if callable(demand):
            demands.clear()
            demands.update(demand(i))
        out.append([(r["outcome"], r["action"], r["resource"])
                    for r in reb.run_once()])
        clock[0] += step
    assert audit(side, state) == []
    return out, granted(state, a), granted(state, b), trail(reb, registry)


def flap(i):
    hot, cold = ("uid-a", "uid-b") if i % 2 == 0 else ("uid-b", "uid-a")
    return {hot: {"busy": 1.0}, cold: {"busy": 0.0}}


POLICIES = {
    "hysteresis-band": ((("uid-a", 50, INFER_SLO), ("uid-b", 50, BATCH_SLO)),
                        {"uid-a": {"busy": 0.7}, "uid-b": {"busy": 0.5}},
                        None, 5, 1.0),
    "flap-storm": ((("uid-a", 50, INFER_SLO), ("uid-b", 50, BATCH_SLO)),
                   flap, {"cooldown_seconds": 60.0}, 120, 1.0),
    "small-leftover": ((("uid-a", 60, INFER_SLO), ("uid-b", 23, BATCH_SLO)),
                       {"uid-a": {"busy": 1.0}, "uid-b": {"busy": 0.0}},
                       {"hysteresis_percent": 5}, 1, 1.0),
    "restore-min": ((("uid-a", 10, INFER_SLO), ("uid-b", 90, BATCH_SLO)),
                    {}, None, 1, 1.0),
    "violation": ((("uid-a", 10, INFER_SLO), ("uid-b", 20, BATCH_SLO)),
                  {}, None, 3, 30.0),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_rebalancer_policy(tmp_path, name):
    out, a, b, _ = both(policy, tmp_path, *POLICIES[name])
    if name == "flap-storm":
        applied = sum(o == "applied" for tick in out for o, _, _ in tick)
        assert applied <= 120 / 60.0 + 1
    if name == "restore-min":
        assert a[0] == 30 and b[0] == 70


def hitless_resize(side, root):
    ds = side("plugin.device_state")
    faults = side("utils.faults")
    state = v5e_state(side, root)
    state.prepare(shared_claim("uid-x", 30, "4Gi", INFER_SLO))
    out = state.resize_claim_limits("uid-x", tensorcore_percent=55,
                                    hbm_limit="8Gi")
    assert out["generation"] == 2
    with open(os.path.join(session_dir(state, "uid-x"), "limits.json")) as f:
        limits = masked(json.load(f))
    state.prepare({
        "metadata": {"name": "ex", "namespace": "d", "uid": "uid-ex"},
        "status": {"allocation": {"devices": {"results": [{
            "request": "r0", "driver": DRIVER, "pool": "node-a",
            "device": "tpu-1"}], "config": []}}}})
    errors = []
    for uid in ("uid-ex", "uid-nope"):
        with pytest.raises(ds.LimitResizeError) as ei:
            state.resize_claim_limits(uid, tensorcore_percent=50)
        errors.append(str(ei.value))
    with faults.armed(faults.FaultPlan().fail(
            "rebalance.session-resize", OSError("disk full"), times=1)):
        with pytest.raises(OSError, match="disk full"):
            state.resize_claim_limits("uid-x", tensorcore_percent=70)
    with pytest.raises(ValueError):
        state.resize_claim_limits("uid-x", tensorcore_percent=200)
    assert granted(state, "uid-x") == (55, "8Gi")
    assert audit(side, state) == []
    return masked(out), limits, errors, masked(state.checkpoint.read())


def limits_drift(side, root):
    state = v5e_state(side, root)
    state.prepare(shared_claim("uid-h", 30, "4Gi", INFER_SLO))
    chip = state.allocatable["tpu-0"].chip.uuid
    meta = dict(state.share_state.get(chip).claims["uid-h"])
    seen = [audit(side, state)]
    state.share_state.acquire(chip, "uid-h", "process-shared",
                              dict(meta, tensorcorePercent=99))
    seen.append(audit(side, state))
    state.share_state.acquire(chip, "uid-h", "process-shared",
                              {"maxProcesses": 2})       # legacy meta
    seen.append(audit(side, state))
    state.share_state.acquire(chip, "uid-h", "process-shared",
                              {"maxProcesses": 5})
    seen.append(audit(side, state))
    state.share_state.release(chip, "uid-h")
    seen.append(audit(side, state))
    assert [c for c, _, _ in seen[1]] == ["sharing-limits"] and not seen[2]
    return seen


def seeded_schedule(side, root):
    faults = side("utils.faults")
    state = v5e_state(side, root)
    state.prepare(shared_claim("uid-infer", 30, "4Gi", INFER_SLO))
    state.prepare(shared_claim("uid-batch", 70, "12Gi", BATCH_SLO))
    demand, clock = {}, [99_000.0]
    reb, registry = rebalancer(side, state, demand, clock)
    sites = faults.sites_in("sharing.", "rebalance.")
    plan = faults.FaultPlan.seeded(SEED, sites, rounds=12, fail_rate=0.6,
                                   max_call=4)
    outcomes = []
    with faults.armed(plan):
        for i in range(10):
            hot, cold = (("uid-infer", "uid-batch") if i % 2 == 0
                         else ("uid-batch", "uid-infer"))
            demand[hot] = {"busy": 1.0}
            demand[cold] = {"busy": 0.0}
            outcomes += [r["outcome"] for r in reb.run_once()]
            clock[0] += 120.0
    assert outcomes
    restarted = v5e_state(side, root)
    assert audit(side, restarted) == []
    return sorted(sites), outcomes


def review_regressions(side, root):
    """A damped donor does not shadow a viable one; a failing gainer
    gives the donor's share back (the exact original quantity) and cools
    down; a transiently absent device keeps its HBM view; a departed
    claim's gauge series are dropped."""
    state = v5e_state(side, root)
    state.prepare(shared_claim("uid-needy", 30, "4Gi", INFER_SLO))
    state.prepare(shared_claim("uid-donor-a", 23, "4Gi", {
        "latencyClass": "batch", "minTensorCorePercent": 20}))
    state.prepare(shared_claim("uid-donor-b", 47, "8Gi", {
        "latencyClass": "batch", "minTensorCorePercent": 20}))
    demand = {"uid-needy": {"busy": 1.0}, "uid-donor-a": {"busy": 0.0},
              "uid-donor-b": {"busy": 0.1}}
    clock = [200_000.0]
    reb, registry = rebalancer(side, state, demand, clock)
    first = masked(reb.run_once())
    assert granted(state, "uid-donor-b")[0] == 37
    orig = state.resize_claim_limits

    def flaky(uid, **kw):
        if uid == "uid-needy":
            raise OSError("gainer session broken")
        return orig(uid, **kw)

    state.resize_claim_limits = flaky
    clock[0] += 120.0
    failed = masked(reb.run_once())
    clock[0] += 1.0
    cooling = masked(reb.run_once())
    state.resize_claim_limits = orig
    views = [(v.claim_uid, v.chip_hbm_bytes, v.granted)
             for v in reb._claim_views()]
    state.allocatable = {k: v for k, v in state.allocatable.items()
                         if k != "tpu-0"}
    absent = [(v.claim_uid, v.chip_hbm_bytes, v.granted)
              for v in reb._claim_views()]
    assert absent == views
    state.refresh_allocatable()
    state.unprepare("uid-donor-a")
    clock[0] += 120.0
    reb.run_once()
    assert 'claim="uid-donor-a"' not in "\n".join(reb._m_granted.render())
    assert audit(side, state) == []
    return first, failed, cooling, views, trail(reb, registry)


def hbm_restore_exact(side, root):
    state = v5e_state(side, root)
    state.prepare(shared_claim("uid-infer", None, "4Gi", {
        "latencyClass": "realtime", "minHbmPercent": 25,
        "burstHbmPercent": 75, "priority": 10}))
    state.prepare(shared_claim("uid-batch", None, "5Gi", {
        "latencyClass": "batch", "minHbmPercent": 25}))
    orig = state.resize_claim_limits

    def flaky(uid, **kw):
        if uid == "uid-infer":
            raise OSError("gainer session broken")
        return orig(uid, **kw)

    state.resize_claim_limits = flaky
    demand = {"uid-infer": {"busy": 0.5, "hbm": 1.0},
              "uid-batch": {"busy": 0.5, "hbm": 0.0}}
    reb, _ = rebalancer(side, state, demand, [1000.0])
    records = masked(reb.run_once())
    assert [r["outcome"] for r in records] == ["failed"]
    assert granted(state, "uid-batch")[1] == "5Gi"
    assert audit(side, state) == []
    return records


@pytest.mark.parametrize("scenario", [
    burst_steal_and_return, file_demand_source, hitless_resize,
    limits_drift, seeded_schedule, review_regressions, hbm_restore_exact,
], ids=lambda f: f.__name__)
def test_rebalancer(tmp_path, scenario):
    both(scenario, tmp_path)


def test_rebalancer_reads_the_port_shims_usage_files(tmp_path):
    """On a GPU claim's envelope (``TPU_DRA_RUNTIME=cuda``) the port's
    ``report_usage`` writes the same sample file ``FileDemandSource``
    reads."""
    shim = PORT("parallel.shim")
    rb = PORT("plugin.rebalancer")
    run_dir = tmp_path / "run"
    sess = run_dir / "uid-g-abcde"
    sess.mkdir(parents=True)
    env = {"TPU_DRA_SHARING": "process-shared", "TPU_DRA_RUNTIME": "cuda",
           "TPU_DRA_SHARED_DIR": str(sess), "TPU_DRA_PROCESS_SLOT": "1"}
    assert shim.report_usage(0.9, 0.2, environ=env)
    view = rb.ClaimShareView(
        claim_uid="uid-g", namespace="ns", name="g", chips=("GPU-x",),
        chip_hbm_bytes=80 * GIB,
        slo=PORT("api.v1alpha1").SloConfig.from_dict(INFER_SLO),
        granted={"tensorcore": 50, "hbm": 45})
    assert rb.FileDemandSource(str(run_dir))(view) == {"busy": 0.9,
                                                       "hbm": 0.2}
