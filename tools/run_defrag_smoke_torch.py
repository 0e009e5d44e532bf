#!/usr/bin/env python3
"""Defrag-execution smoke on the PyTorch port: checkerboarded fleet ->
unsat gang -> one executed (and crash-recovered) plan -> gang admitted.

Twin of ``tools/run_defrag_smoke.py`` (``make defragsmoke``) over
``k8s_dra_driver_tpu_torch``, with the same steps, seed, gates, printed
lines and exit codes. It imports nothing of JAX.

1. a 4x1x1 FakeChipLib slice publishes through ResourceSliceController;
   the two MIDDLE chips are allocated to movable single-chip claims and
   prepared on a real DeviceState (holds + CDI + checkpoint), so the
   free corners form no contiguous pair;
2. both movers serve live traffic through a ServingGateway replica;
3. a 2-chip gang claim goes unsat on fragmentation and the attached
   DefragPlanner computes a ``planned`` migration plan;
4. a seeded crash (``faults.CrashPoint``) lands at one of the
   ``defrag.*`` execution sites; the "restarted plugin" (fresh
   DeviceState re-read from disk, fresh DefragExecutor over the same
   intent path) recovers the plan;
5. PASS requires: the gang ends ADMITTED on the freed box, the mover's
   allocator holdings / node state / checkpoint all agree, the
   StateAuditor (executor attached) reports zero drift, no execution
   intent is orphaned, and the gateway finishes EVERY admitted request
   -- zero admitted loss across the migration.

``run(seed)`` returns the decisions (the plan, the moved claim, the
crash site, the gang's devices, the executed steps) and the first failed
gate, if any; ``main()`` prints as the reference does.

Exit 0 on PASS, 1 on any violated gate. TPU_DRA_CHAOS_SEED overrides
the seed (default 1234) -- the same seed replays the same crash window.
Run from the repo root: ``python tools/run_defrag_smoke_torch.py``.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = int(os.environ.get("TPU_DRA_CHAOS_SEED", "1234"))


class GateFailed(Exception):
    """A violated gate; its message is the reference's FAIL line."""


def run(seed: int = SEED, emit=print) -> dict:
    """The smoke's decisions, with ``failure`` the first violated gate's
    message (None on PASS). ``emit`` takes the progress lines."""
    out = {"seed": seed, "failure": None}
    try:
        _run(seed, emit, out)
    except GateFailed as e:
        out["failure"] = str(e)
    return out


def _run(seed, emit, out):
    import random

    from k8s_dra_driver_tpu_torch.cdi import CDIHandler
    from k8s_dra_driver_tpu_torch.kube import NODES, FakeKubeClient
    from k8s_dra_driver_tpu_torch.kube.allocator import (
        AllocationError,
        ReferenceAllocator,
        Selector,
    )
    from k8s_dra_driver_tpu_torch.kube.defrag import DefragPlanner
    from k8s_dra_driver_tpu_torch.kube.defrag_executor import DefragExecutor
    from k8s_dra_driver_tpu_torch.kube.resourceslice import (
        DriverResources,
        Pool,
        ResourceSliceController,
    )
    from k8s_dra_driver_tpu_torch.plugin.audit import StateAuditor
    from k8s_dra_driver_tpu_torch.plugin.checkpoint import CheckpointManager
    from k8s_dra_driver_tpu_torch.plugin.device_state import DeviceState
    from k8s_dra_driver_tpu_torch.serving_gateway import ServingGateway
    from k8s_dra_driver_tpu_torch.serving_gateway.sim import ScriptedEngine
    from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib
    from k8s_dra_driver_tpu_torch.tpulib.deviceinfo import counter_sets
    from k8s_dra_driver_tpu_torch.utils import faults
    from k8s_dra_driver_tpu_torch.utils.metrics import Registry

    tmp = tempfile.mkdtemp(prefix="defrag-smoke-")
    client = FakeKubeClient()
    client.create(NODES, {"metadata": {"name": "node-a", "uid": "nu-1"}})
    lib = FakeChipLib(generation="v5p", topology="4x1x1")
    devs = lib.enumerate_all_possible_devices({"chip"})
    ctrl = ResourceSliceController(
        client, "tpu.google.com", scope="node-a",
        owner={"kind": "Node", "name": "node-a", "uid": "nu-1"},
    )
    ctrl.update(DriverResources(pools={"node-a": Pool(
        devices=[d.get_device() for _, d in sorted(devs.items())],
        shared_counters=counter_sets(devs),
        node_name="node-a",
    )}))
    ctrl.sync_once()

    reg = Registry()
    allocator = ReferenceAllocator(client, registry=reg)
    planner = DefragPlanner(allocator, registry=reg)

    def make_state():
        return DeviceState(
            chiplib=lib,
            cdi=CDIHandler(f"{tmp}/cdi"),
            checkpoint=CheckpointManager(f"{tmp}/checkpoint.json"),
            driver_name="tpu.google.com",
            pool_name="node-a",
            state_dir=f"{tmp}/state",
        )

    def gang_claim(uid, count):
        return {
            "metadata": {"name": f"wl-{uid}", "namespace": "smoke",
                         "uid": uid},
            "spec": {"devices": {"requests": [{
                "name": "r0", "deviceClassName": "tpu.google.com",
                "allocationMode": "ExactCount", "count": count,
            }]}},
        }

    state = make_state()
    gw = ServingGateway(Registry(), node_name="node-a")
    engines = []
    # Checkerboard: the middle chips are held AND prepared AND serving.
    for i, coord in enumerate(("1,0,0", "2,0,0")):
        uid = f"uid-mid-{i}"
        allocator.allocate(
            gang_claim(uid, 1),
            selectors={"r0": [Selector("coord", "eq", coord)]},
        )
        state.prepare({
            "metadata": {"name": f"mid-{i}", "namespace": "smoke",
                         "uid": uid},
            "status": {"allocation": {"devices": {"results": [{
                "request": "r0", "driver": "tpu.google.com",
                "pool": "node-a", "device": f"tpu-{i + 1}",
            }], "config": []}}},
        })
        engine = ScriptedEngine()
        engines.append(engine)
        gw.add_replica(engine, f"r-mid-{i}", claim_uid=uid)

    reqs = [gw.submit([i] * 8, 2) for i in range(8)]
    gw.tick()  # some requests are admitted before the migration

    try:
        allocator.allocate(gang_claim("uid-gang", 2))
        raise GateFailed("fragmented gang unexpectedly allocated")
    except AllocationError as e:
        out["unsat_reason"] = e.reason
        if e.reason != "gang":
            raise GateFailed(f"gang unsat reason {e.reason!r}, want 'gang'")
    plan = planner.recent_plans()[-1]
    out["plan"] = {k: plan.get(k) for k in ("planId", "outcome", "box",
                                            "migrations")}
    if plan["outcome"] != "planned" or not plan["migrations"]:
        raise GateFailed(f"no executable plan: {plan['outcome']!r} "
                         f"({plan['detail']})")
    mover = plan["migrations"][0]
    out["moved"] = mover["claimUid"]
    emit(f"plan {plan['planId']}: move {mover['claimUid']} "
         f"{mover['devices']} -> {mover['to']} to free box {plan['box']}")

    intent_path = f"{tmp}/defrag-intent.json"
    executor = DefragExecutor(
        planner, allocator, intent_path=intent_path,
        state=state, gateway=gw, registry=Registry(),
    )

    # Seeded crash window: SIGKILL at one defrag.* orchestration site.
    site = random.Random(seed).choice(faults.sites_in("defrag."))
    out["site"] = site
    emit(f"seed={seed}: crashing at {site}")
    crashed = False
    try:
        with faults.armed(faults.FaultPlan().crash(site)):
            executor.execute(plan)
    except faults.CrashPoint:
        crashed = True
    except Exception as e:
        raise GateFailed(f"execution failed instead of crashing: {e}")
    if not crashed:
        raise GateFailed(f"the {site} crash never fired")

    # "Restart": node state re-reads disk; a fresh executor recovers.
    state2 = make_state()
    executor2 = DefragExecutor(
        planner, allocator, intent_path=intent_path,
        state=state2, gateway=gw, registry=Registry(),
    )
    record = executor2.recover()
    if record is None:
        # The crash preceded the intent write: nothing moved, the plan
        # is still fresh -- execute it on the recovered incarnation.
        record = executor2.execute(plan)
    out["steps"] = [(s["kind"], s["outcome"]) for s in record["steps"]]
    if record["state"] != "completed":
        raise GateFailed(f"execution did not converge: {record['state']} "
                         f"({record['detail']})")

    # Gate 1: the gang is SAT on the freed contiguous box.
    gang_holds = sorted(
        n for (_, n), h in allocator._reservations.items()
        if h == "uid-gang"
    )
    out["gang"] = gang_holds
    if len(gang_holds) != 2:
        raise GateFailed(f"gang holds {gang_holds}, want 2 devices")
    # Gate 2: allocator and node state agree on every mover.
    for i in range(2):
        uid = f"uid-mid-{i}"
        held = {n for (_, n), h in allocator._reservations.items()
                if h == uid}
        view = state2.gang_view(uid)
        if view is None:
            raise GateFailed(f"{uid} lost its prepared state")
        staged = {n for n, _ in view["devices"]}
        if held != staged:
            raise GateFailed(f"{uid}: allocator holds {sorted(held)} but "
                             f"node state shows {sorted(staged)}")
    # Gate 3: no residual drift -- auditor silent, no orphaned intent.
    if executor2.orphaned_intent() is not None:
        raise GateFailed(f"orphaned execution intent at {intent_path}")
    auditor = StateAuditor(
        state=state2, registry=Registry(), node_name="node-a"
    )
    auditor.defrag_executor = executor2
    findings = auditor.run_once()
    out["findings"] = [f"[{f.check}] {f.subject}: {f.detail}"
                       for f in findings]
    if findings:
        raise GateFailed("auditor drift after execution: "
                         + "; ".join(out["findings"]))
    # Gate 4: zero admitted loss across the migration.
    gw.run()
    lost = [r for r in reqs if r.state != "finished"]
    out["requests"] = len(reqs)
    out["lost"] = len(lost)
    out["failed"] = gw.counters["failed"]
    if lost or gw.counters["failed"]:
        raise GateFailed(f"admitted-request loss: {len(lost)} unfinished, "
                         f"{gw.counters['failed']} failed")
    for engine in engines:
        engine.assert_no_leaks()


def main() -> int:
    out = run(SEED)
    if out["failure"] is not None:
        print(f"FAIL: {out['failure']}")
        return 1
    steps = ", ".join(f"{kind}={outcome}" for kind, outcome in out["steps"])
    print(f"PASS: seed={out['seed']} site={out['site']} gang on "
          f"{out['gang']}; steps: {steps}; {out['requests']} requests "
          f"finished, 0 lost")
    return 0


if __name__ == "__main__":
    sys.exit(main())
