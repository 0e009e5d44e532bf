"""The port's serving gateway (``k8s_dra_driver_tpu_torch.serving_gateway``)
against the JAX package's, on the CPU.

Part one, scripted engines: every scenario of the reference's
tests/test_gateway.py that drives the gateway over ``ScriptedEngine``s
(routing, admission, drain and failover, chaos, the autoscaler,
residency) runs twice -- the reference gateway over the reference sim,
the port's gateway over the port's sim -- on the same traffic and the
same injected clock. Each request's replica, state and error, the
gateway's counters, ``snapshot()`` (its event ring included),
``residency.snapshot()`` and the registry's rendered text must be EQUAL.

Part two, real engines: two port ``DecodeEngine(tiny)`` replicas built
from the reference's parameters (``params_from_numpy``) and two
reference replicas from the same parameters serve the same shared-prefix
traffic behind each side's gateway, with a drain, then a
``fail_replica`` and ``resubmit``. The greedy streams, the routing, each
engine's ``snapshot()`` and ``kv_residency()`` must be EQUAL, and the
streams equal the reference ``generate``.

The only values read from the wall clock rather than the injected one
are the tick profiler's phase seconds (``TickProfiler`` times phases
with ``time.perf_counter``) and the Events' ``firstTimestamp`` and
``lastTimestamp`` (``EventRecorder`` stamps them with ``time.gmtime``):
the ``tpu_dra_srv_tick_phase_seconds`` series, the ``?view=ticks``
export and those two Event fields are compared by their keys only
(``WALL_CLOCK_FAMILIES``, ``WALL_CLOCK_EVENT_FIELDS``).
"""

import json
import os
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import k8s_dra_driver_tpu.kube as ref_kube
import k8s_dra_driver_tpu.serving_gateway as ref_sg
import k8s_dra_driver_tpu.serving_gateway.sim as ref_sim
import k8s_dra_driver_tpu.utils.faults as ref_faults
import k8s_dra_driver_tpu.utils.metrics as ref_metrics
import k8s_dra_driver_tpu_torch.kube as port_kube
import k8s_dra_driver_tpu_torch.serving_gateway as port_sg
import k8s_dra_driver_tpu_torch.serving_gateway.sim as port_sim
import k8s_dra_driver_tpu_torch.utils.faults as port_faults
import k8s_dra_driver_tpu_torch.utils.metrics as port_metrics
from k8s_dra_driver_tpu.models.decode import generate as ref_generate
from k8s_dra_driver_tpu.models.llama import PRESETS as REF_PRESETS
from k8s_dra_driver_tpu.models.llama import init_params as ref_init
from k8s_dra_driver_tpu.models.serving import DecodeEngine as RefEngine
from k8s_dra_driver_tpu_torch.models import DecodeEngine, params_from_numpy
from k8s_dra_driver_tpu_torch.models.llama import PRESETS
from k8s_dra_driver_tpu_torch.models.paged import prefix_run_key

CHAOS_SEED = int(os.environ.get("TPU_DRA_CHAOS_SEED", "1234"))
N_NEW = 6
# Families whose values come from the wall clock: compared by series key.
WALL_CLOCK_FAMILIES = ("tpu_dra_srv_tick_phase_seconds",)
WALL_CLOCK_EVENT_FIELDS = ("firstTimestamp", "lastTimestamp")


def _side(sg, sim, faults, metrics, kube):
    ns = types.SimpleNamespace(**{n: getattr(sg, n) for n in sg.__all__})
    ns.ScriptedEngine = sim.ScriptedEngine
    ns.shared_prefix_prompts = sim.shared_prefix_prompts
    ns.faults = faults
    ns.Registry = metrics.Registry
    ns.MetricsServer = metrics.MetricsServer
    ns.kube = kube
    return ns


REF = _side(ref_sg, ref_sim, ref_faults, ref_metrics, ref_kube)
PORT = _side(port_sg, port_sim, port_faults, port_metrics, port_kube)


class FakeClock:
    """Advances by ``step`` on every read, so two runs that read the
    clock in the same order see the same times."""

    def __init__(self, step: float = 0.001):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


def _gateway(ns, clock, n_replicas=3, *, policy="affinity", block_size=16,
             affinity_blocks=2, saturation_depth=None, admission=None,
             autoscaler=None, seed=0, engine_kwargs=None, telemetry=None,
             registry=None):
    reg = registry or ns.Registry()
    gw = ns.ServingGateway(
        reg,
        router=ns.Router(policy=policy, block_size=block_size,
                         affinity_blocks=affinity_blocks,
                         saturation_depth=saturation_depth, seed=seed),
        admission_policy=admission, autoscaler=autoscaler,
        node_name="test", clock=clock, telemetry=telemetry,
    )
    engines = [ns.ScriptedEngine(clock=clock, **(engine_kwargs or {}))
               for _ in range(n_replicas)]
    for i, e in enumerate(engines):
        gw.add_replica(e, f"r{i}")
    return gw, reg, engines


def _error_doc(err):
    if err is None:
        return None
    return (type(err).__name__, str(err), getattr(err, "reason", None),
            getattr(err, "retryable", None))


def _request_doc(r):
    return dict(gid=r.gid, replica=r.replica_id, state=r.state,
                error=_error_doc(r.error), dispatches=r.dispatches,
                tokens=r.tokens, submitted=r.submitted_at,
                finished=r.finished_at, latency_class=r.latency_class,
                engine_rid=getattr(r.engine_req, "rid", None))


def _split_wall_clock(text):
    """The rendered text without the wall-clock families' values: their
    lines reduced to the series key."""
    out = []
    for line in text.splitlines():
        if line.startswith(WALL_CLOCK_FAMILIES):
            line = line.rsplit(" ", 1)[0]
        out.append(line)
    return out


def _record(gw, reg, reqs, extra=None):
    return {
        "requests": [_request_doc(r) for r in reqs],
        "counters": dict(gw.counters),
        "snapshot": gw.snapshot(),
        "residency": gw.residency.snapshot(),
        "metrics": _split_wall_clock(reg.render()),
        "extra": extra,
    }


# -- routing invariants -----------------------------------------------------


def _routing_affinity_pins(ns, clock):
    gw, reg, _ = _gateway(ns, clock, 4, saturation_depth=10 ** 6)
    prompts = ns.shared_prefix_prompts(64, n_systems=8, system_len=32,
                                       tail_len=4, seed=2)
    reqs = [gw.submit(p, 2, latency_class="interactive") for p in prompts]
    gw.tick()
    by_system = {}
    for p, r in zip(prompts, reqs):
        by_system.setdefault(tuple(p[:32]), set()).add(r.replica_id)
    assert all(len(v) == 1 for v in by_system.values()), by_system
    gw.run()
    assert gw.counters["affinity_lookups"] == 64
    assert gw.counters["affinity_hits"] == 64 - 8
    return _record(gw, reg, reqs, gw.affinity_hit_rate())


def _routing_round_robin(ns, clock):
    gw, reg, _ = _gateway(ns, clock, 4, policy="round-robin")
    prompts = ns.shared_prefix_prompts(64, n_systems=8, system_len=32,
                                       tail_len=4, seed=2)
    reqs = [gw.submit(p, 2, latency_class="interactive") for p in prompts]
    gw.tick()
    by_system = {}
    for p, r in zip(prompts, reqs):
        by_system.setdefault(tuple(p[:32]), set()).add(r.replica_id)
    assert all(len(v) > 1 for v in by_system.values())
    gw.run()
    return _record(gw, reg, reqs)


def _routing_p2c_skew(ns, clock):
    gw, reg, engines = _gateway(ns, clock, 4, saturation_depth=10 ** 6,
                                engine_kwargs=dict(stall=True))
    reqs = [gw.submit([1, 2, 3], 1, latency_class="interactive")
            for _ in range(200)]
    gw.tick()
    depths = [len(e.waiting) for e in engines]
    assert sum(depths) == 200 and max(depths) - min(depths) <= 10, depths
    return _record(gw, reg, reqs, depths)


def _routing_affinity_spill(ns, clock):
    gw, reg, engines = _gateway(ns, clock, 2, saturation_depth=3,
                                engine_kwargs=dict(stall=True))
    prompts = ns.shared_prefix_prompts(12, n_systems=1, system_len=32,
                                       tail_len=4, seed=4)
    reqs = [gw.submit(p, 1, latency_class="interactive") for p in prompts]
    for _ in range(8):
        gw.tick()
    depths = sorted(len(e.waiting) + e.num_active for e in engines)
    assert depths[0] > 0, depths
    return _record(gw, reg, reqs, depths)


def _routing_no_replicas(ns, clock):
    reg = ns.Registry()
    gw = ns.ServingGateway(reg, router=ns.Router(), clock=clock)
    with pytest.raises(ns.NoReplicaAvailableError) as ei:
        gw.router.route([1] * 16)
    req = gw.submit([1] * 16, 2, latency_class="interactive")
    gw.tick()
    assert req.state == "queued" and gw.admission.depth() == 1
    return _record(gw, reg, [req], _error_doc(ei.value))


# -- admission --------------------------------------------------------------


def _admission_batch_shed_first(ns, clock):
    gw, reg, _ = _gateway(
        ns, clock, 1, admission=ns.AdmissionPolicy(
            shed_watermark=4, hard_watermark=10, retry_after_s=2.5),
        engine_kwargs=dict(stall=True))
    reqs = [gw.submit([1, 2], 1, latency_class="interactive")
            for _ in range(4)]
    with pytest.raises(ns.OverloadedError) as ei:
        gw.submit([1, 2], 1, latency_class="batch")
    assert ei.value.reason == "watermark" and ei.value.retryable
    reqs += [gw.submit([1, 2], 1, latency_class="interactive"),
             gw.submit([1, 2], 1, latency_class="realtime")]
    return _record(gw, reg, reqs, (_error_doc(ei.value),
                                   ei.value.retry_after_s,
                                   ei.value.queue_depth))


def _admission_hard_watermark(ns, clock):
    gw, reg, _ = _gateway(
        ns, clock, 1, admission=ns.AdmissionPolicy(shed_watermark=2,
                                                   hard_watermark=4),
        engine_kwargs=dict(stall=True))
    reqs = [gw.submit([1, 2], 1, latency_class="realtime")
            for _ in range(4)]
    sheds = []
    for lc in ("realtime", "interactive", "batch"):
        with pytest.raises(ns.OverloadedError) as ei:
            gw.submit([1, 2], 1, latency_class=lc)
        sheds.append(_error_doc(ei.value))
    return _record(gw, reg, reqs, sheds)


def _admission_priority_order(ns, clock):
    gw, reg, _ = _gateway(ns, clock, 1, saturation_depth=1,
                          engine_kwargs=dict(batch_slots=1,
                                             prefill_chunk=16))
    b = gw.submit([1] * 16, 1, latency_class="batch")
    i = gw.submit([2] * 16, 1, latency_class="interactive")
    r = gw.submit([3] * 16, 1, latency_class="realtime")
    gw.run()
    assert r.engine_req.rid < i.engine_req.rid < b.engine_req.rid
    return _record(gw, reg, [b, i, r])


def _admission_deadline_expiry(ns, clock):
    gw, reg, _ = _gateway(
        ns, clock, 1,
        admission=ns.AdmissionPolicy(max_queue_delay_s={"batch": 10.0}),
        engine_kwargs=dict(stall=True))
    gw.router.saturation_depth = 0
    req = gw.submit([1, 2], 1, latency_class="batch")
    clock.advance(11.0)
    gw.tick()
    assert req.state == "failed" and req.error.reason == "deadline"
    return _record(gw, reg, [req])


# -- drain and failover -----------------------------------------------------


def _drain_zero_loss(ns, clock):
    gw, reg, engines = _gateway(ns, clock, 3, saturation_depth=10 ** 6)
    prompts = ns.shared_prefix_prompts(30, n_systems=6, system_len=32,
                                       tail_len=4, seed=5)
    reqs = [gw.submit(p, 3, latency_class="interactive") for p in prompts]
    for _ in range(2):
        gw.tick()
    rerouted = gw.drain_replica("r1", remove=True, reason="test")
    gw.run()
    assert all(r.state == "finished" for r in reqs)
    assert gw.counters["failed"] == 0
    for e in engines:
        e.assert_no_leaks()
    return _record(gw, reg, reqs, rerouted)


def _drain_fail_replica_resubmit(ns, clock):
    gw, reg, _ = _gateway(ns, clock, 2, saturation_depth=10 ** 6,
                          engine_kwargs=dict(batch_slots=2))
    reqs = [gw.submit([i] * 16, 4, latency_class="interactive")
            for i in range(8)]
    gw.tick()
    lost = gw.fail_replica("r0", reason="chip unplugged")
    failed = [r for r in reqs if r.state == "failed"]
    assert lost > 0 and len(failed) == lost
    retries = [gw.resubmit(r) for r in failed]
    gw.run()
    assert all(r.state == "finished" for r in retries)
    return _record(gw, reg, reqs + retries, lost)


def _drain_faultable(ns, clock):
    gw, reg, _ = _gateway(ns, clock, 2)
    plan = ns.faults.FaultPlan()
    plan.fail("gateway.drain", ns.faults.FaultError("chaos"), times=1)
    with ns.faults.armed(plan):
        with pytest.raises(ns.faults.FaultError) as ei:
            gw.drain_replica("r0")
    return _record(gw, reg, [], _error_doc(ei.value))


def _drain_requeue_order(ns, clock):
    gw, reg, _ = _gateway(ns, clock, 2, saturation_depth=10 ** 6,
                          engine_kwargs=dict(batch_slots=1,
                                             prefill_chunk=16, stall=True))
    prompts = ns.shared_prefix_prompts(3, n_systems=1, system_len=32,
                                       tail_len=4, seed=9)
    reqs = [gw.submit(p, 1, latency_class="interactive") for p in prompts]
    gw.tick()
    target = reqs[0].replica_id
    gw.drain_replica(target, remove=True)
    requeued = [r for r in reqs if r.state == "queued"]
    assert len(requeued) >= 2
    popped = [gw.admission.pop() for _ in requeued]
    assert [r.gid for r in popped] == sorted(r.gid for r in requeued)
    return _record(gw, reg, reqs, [r.gid for r in popped])


def _drain_claim_and_resume(ns, clock):
    reg = ns.Registry()
    gw = ns.ServingGateway(reg, router=ns.Router(block_size=16),
                           node_name="test", clock=clock)
    for i, claim in enumerate(("uid-a", "uid-a", "uid-b")):
        gw.add_replica(ns.ScriptedEngine(clock=clock), f"r{i}",
                       claim_uid=claim)
    reqs = [gw.submit([i % 5] * 20, 2, latency_class="interactive")
            for i in range(9)]
    gw.tick()
    drained = gw.drain_claim("uid-a", reason="defrag")
    reqs += [gw.submit([7] * 20, 2, latency_class="batch")]
    gw.run()
    resumed = gw.resume_claim("uid-a")
    reqs += [gw.submit([i] * 17, 1, latency_class="realtime")
             for i in range(4)]
    gw.run()
    return _record(gw, reg, reqs, (drained, resumed,
                                   gw.resume_claim("uid-a")))


def _drain_remove_pops_tables(ns, clock):
    gw, reg, _ = _gateway(ns, clock, 2)
    gw.drain_replica("r1", remove=True)
    assert "r1" not in gw._dispatched
    gw.fail_replica("r0")
    assert gw._dispatched == {}
    return _record(gw, reg, [])


def _drain_gauge_registered_states(ns, clock):
    reg = ns.Registry()
    gw = ns.ServingGateway(reg, node_name="test", clock=clock)
    for i in range(2):
        gw.add_replica(ns.ScriptedEngine(clock=clock), f"r{i}")
    gw.drain_replica("r0")
    gw.fail_replica("r1")
    body = reg.render()
    assert 'tpu_dra_gw_replicas{state="draining"} 1' in body
    assert 'state="gone"' not in body
    return _record(gw, reg, [])


# -- chaos ------------------------------------------------------------------


def _chaos_route_fault_retries(ns, clock):
    gw, reg, _ = _gateway(ns, clock, 2)
    req = gw.submit([1] * 16, 2, latency_class="interactive")
    plan = ns.faults.FaultPlan()
    plan.fail("gateway.route", ns.faults.FaultError("chaos@route"),
              times=1)
    with ns.faults.armed(plan):
        gw.tick()
        assert req.state == "queued"
        gw.run()
    assert req.state == "finished"
    return _record(gw, reg, [req])


def _chaos_crash_at_route(ns, clock):
    gw, reg, engines = _gateway(ns, clock, 2)
    req = gw.submit([1] * 16, 2, latency_class="interactive")
    plan = ns.faults.FaultPlan()
    plan.crash("gateway.route", on_call=1)
    with ns.faults.armed(plan):
        with pytest.raises(ns.faults.CrashPoint):
            gw.tick()
    assert req.state == "queued"
    reg2 = ns.Registry()
    gw2 = ns.ServingGateway(reg2, router=ns.Router(
        policy="affinity", block_size=16, affinity_blocks=2), clock=clock)
    for i, e in enumerate(engines):
        gw2.add_replica(e, f"r{i}")
    retry = gw2.submit(req.prompt, req.max_new_tokens,
                       latency_class=req.latency_class)
    gw2.run()
    for e in engines:
        e.assert_no_leaks()
    return {"first": _record(gw, reg, [req]),
            "restarted": _record(gw2, reg2, [retry])}


def _chaos_seeded_soak(ns, clock):
    sites = ns.faults.sites_in("gateway.")
    assert sites == ["gateway.route", "gateway.drain", "gateway.scale"]
    plan = ns.faults.FaultPlan.seeded(CHAOS_SEED, sites, rounds=6,
                                      fail_rate=0.5, max_call=4)

    class Prov:
        def scale_down(self, replica):
            pass

        def scale_up(self):
            raise ns.ScaleError("no capacity in the chaos fleet")

    engines = [ns.ScriptedEngine(batch_slots=2, clock=clock)
               for _ in range(3)]
    prompts = ns.shared_prefix_prompts(24, n_systems=4, system_len=32,
                                       tail_len=4, seed=CHAOS_SEED)
    built = []

    def build():
        reg = ns.Registry()
        gw = ns.ServingGateway(
            reg,
            router=ns.Router(policy="affinity", block_size=16,
                             affinity_blocks=2, saturation_depth=10 ** 6),
            autoscaler=ns.Autoscaler(
                ns.AutoscalerPolicy(min_replicas=1, max_replicas=3,
                                    queue_low_water=0.1, dwell_ticks=1,
                                    cooldown_seconds=0.0),
                Prov()),
            node_name="chaos", clock=clock,
        )
        for i, e in enumerate(engines):
            e.resume_admission()
            gw.add_replica(e, f"r{i}")
        built.append((gw, reg))
        return gw

    gw = build()
    handles = [gw.submit(p, 2, latency_class="interactive")
               for p in prompts]
    outstanding = {id(r): r for r in handles}
    with ns.faults.armed(plan):
        for _ in range(200):
            if not outstanding:
                break
            try:
                gw.tick()
                if gw.ticks == 3 and len(gw.replicas()) > 1:
                    gw.drain_replica(gw.replicas()[-1].replica_id,
                                     remove=True, reason="chaos drain")
            except ns.faults.CrashPoint:
                gw = build()
                for r in list(outstanding.values()):
                    if r.state in ("queued", "dispatched"):
                        outstanding.pop(id(r))
                        retry = gw.submit(r.prompt, r.max_new_tokens,
                                          latency_class="interactive")
                        outstanding[id(retry)] = retry
                        handles.append(retry)
            except ns.faults.FaultError:
                pass
            for k, r in list(outstanding.items()):
                if r.state == "finished":
                    outstanding.pop(k)
                elif r.state == "failed":
                    outstanding.pop(k)
                    retry = gw.resubmit(r)
                    outstanding[id(retry)] = retry
                    handles.append(retry)
    assert not outstanding, f"{len(outstanding)} requests stranded"
    for e in engines:
        if not e.idle:
            e.drain()
        e.assert_no_leaks()
    return [_record(g, r, handles if g is gw else []) for g, r in built]


# -- the autoscaler ---------------------------------------------------------


class _Prov:
    def __init__(self, ns, clock):
        self.ns, self.clock = ns, clock
        self.ups = 0
        self.downs = []

    def scale_up(self):
        self.ups += 1
        return self.ns.Replica(f"scaled-{self.ups}",
                               self.ns.ScriptedEngine(clock=self.clock))

    def scale_down(self, replica):
        self.downs.append(replica.replica_id)


def _stalled(ns, clock, policy, prov):
    return _gateway(ns, clock, 1, saturation_depth=10 ** 6,
                    autoscaler=ns.Autoscaler(policy, prov),
                    engine_kwargs=dict(stall=True))


def _autoscale_dwell_then_up(ns, clock):
    prov = _Prov(ns, clock)
    gw, reg, _ = _stalled(ns, clock, ns.AutoscalerPolicy(
        min_replicas=1, max_replicas=4, queue_high_water=2.0,
        dwell_ticks=3, cooldown_seconds=0.0), prov)
    reqs = [gw.submit([1, 2], 1, latency_class="interactive")
            for _ in range(8)]
    for _ in range(2):
        gw.tick()
        clock.advance(1)
    assert prov.ups == 0
    gw.tick()
    assert prov.ups == 1 and len(gw.replicas()) == 2
    return _record(gw, reg, reqs, prov.ups)


def _autoscale_cooldown(ns, clock):
    prov = _Prov(ns, clock)
    gw, reg, _ = _stalled(ns, clock, ns.AutoscalerPolicy(
        min_replicas=1, max_replicas=4, queue_high_water=2.0,
        dwell_ticks=1, cooldown_seconds=60.0), prov)
    reqs = [gw.submit([1, 2], 1, latency_class="interactive")
            for _ in range(30)]
    gw.tick()
    for _ in range(3):
        clock.advance(1)
        gw.tick()
    assert prov.ups == 1
    clock.advance(120)
    gw.tick()
    gw.tick()
    assert prov.ups == 2
    return _record(gw, reg, reqs, prov.ups)


def _autoscale_down_drains(ns, clock):
    prov = _Prov(ns, clock)
    gw, reg, _ = _gateway(ns, clock, 3, autoscaler=ns.Autoscaler(
        ns.AutoscalerPolicy(min_replicas=1, max_replicas=4,
                            queue_low_water=0.5, dwell_ticks=1,
                            cooldown_seconds=0.0), prov))
    gw.tick()
    assert prov.downs and len(gw.replicas()) == 2
    return _record(gw, reg, [], prov.downs)


def _autoscale_up_failure_typed(ns, clock):
    class FailingProv:
        def scale_up(self):
            raise ns.ScaleError("allocator unsat: no chips")

        def scale_down(self, replica):
            pass

    gw, reg, _ = _stalled(ns, clock, ns.AutoscalerPolicy(
        min_replicas=1, max_replicas=4, queue_high_water=1.0,
        dwell_ticks=1, cooldown_seconds=30.0), FailingProv())
    reqs = [gw.submit([1, 2], 1, latency_class="interactive")
            for _ in range(10)]
    gw.tick()
    clock.advance(1)
    gw.tick()
    scales = [e for e in gw.snapshot()["events"] if e["kind"] == "scale"]
    assert len([s for s in scales if s["outcome"] == "failed"]) == 1
    return _record(gw, reg, reqs)


def _autoscale_clamped_at_max(ns, clock):
    prov = _Prov(ns, clock)
    gw, reg, _ = _stalled(ns, clock, ns.AutoscalerPolicy(
        min_replicas=1, max_replicas=1, queue_high_water=1.0,
        dwell_ticks=1, cooldown_seconds=0.0), prov)
    reqs = [gw.submit([1, 2], 1, latency_class="interactive")
            for _ in range(10)]
    gw.tick()
    assert prov.ups == 0
    return _record(gw, reg, reqs)


def _autoscale_never_last_healthy(ns, clock):
    prov = _Prov(ns, clock)
    gw, reg, _ = _gateway(ns, clock, 2, autoscaler=ns.Autoscaler(
        ns.AutoscalerPolicy(min_replicas=1, max_replicas=4,
                            queue_low_water=0.5, dwell_ticks=1,
                            cooldown_seconds=0.0), prov))
    gw.router.get("r1").state = "draining"
    gw.tick()
    assert prov.downs == [] and gw.router.get("r0").state == "healthy"
    return _record(gw, reg, [])


# -- residency --------------------------------------------------------------


def _affinity_gateway(ns, clock, *engines):
    reg = ns.Registry()
    gw = ns.ServingGateway(
        reg, router=ns.Router(policy="affinity", block_size=16,
                              affinity_blocks=2, seed=3), clock=clock)
    for i, eng in enumerate(engines):
        gw.add_replica(eng, f"r{i}")
    return gw, reg


def _residency_fleet_hits(ns, clock):
    gw, reg = _affinity_gateway(ns, clock, ns.ScriptedEngine(clock=clock),
                                ns.ScriptedEngine(clock=clock))
    prompts = ns.shared_prefix_prompts(8, n_systems=2, system_len=32,
                                       tail_len=4, seed=5)
    reqs = [gw.submit(p, 2, latency_class="interactive")
            for p in prompts[:4]]
    gw.run()
    reqs += [gw.submit(p, 2, latency_class="interactive")
             for p in prompts[4:]]
    gw.run()
    doc = gw.residency.snapshot()
    hits = sum(r.engine.snapshot()["prefixHits"]
               for r in gw.router.replicas())
    assert hits > 0 and doc["fleet"]["hits"] == hits
    assert not any(r["counterDrift"] for r in doc["replicas"].values())
    return _record(gw, reg, reqs)


def _residency_stale_ledger(ns, clock):
    gw, reg = _affinity_gateway(
        ns, clock, ns.ScriptedEngine(max_cached_blocks=2, clock=clock))
    reqs = []
    for p in ns.shared_prefix_prompts(6, n_systems=6, system_len=32,
                                      tail_len=2, seed=7):
        reqs.append(gw.submit(p, 1, latency_class="interactive"))
        gw.run()
    ledger = gw.residency.snapshot()["replicas"]["r0"]["ledger"]
    assert ledger["staleKeys"] > 0 and ledger["divergence"] > 0
    return _record(gw, reg, reqs)


def _residency_departed_series(ns, clock):
    gw, reg = _affinity_gateway(ns, clock, ns.ScriptedEngine(clock=clock),
                                ns.ScriptedEngine(clock=clock))
    reqs = [gw.submit(p, 1, latency_class="interactive")
            for p in ns.shared_prefix_prompts(6, n_systems=2,
                                              system_len=32, tail_len=4,
                                              seed=13)]
    gw.run()
    before = _split_wall_clock(reg.render())
    gw.drain_replica("r1", remove=True)
    assert "r1" not in gw.residency.snapshot()["replicas"]
    return {"before": before, "after": _record(gw, reg, reqs)}


def _residency_failed_series(ns, clock):
    gw, reg = _affinity_gateway(ns, clock, ns.ScriptedEngine(clock=clock),
                                ns.ScriptedEngine(clock=clock))
    reqs = [gw.submit(p, 1, latency_class="interactive")
            for p in ns.shared_prefix_prompts(4, n_systems=2,
                                              system_len=32, tail_len=4,
                                              seed=17)]
    gw.run()
    gw.fail_replica("r0", "chip unplugged")
    gw.run()
    return _record(gw, reg, reqs)


def _residency_scripted_digest(ns, clock):
    eng = ns.ScriptedEngine(max_cached_blocks=3, clock=clock)
    for p in ns.shared_prefix_prompts(5, n_systems=5, system_len=32,
                                      tail_len=2, seed=23):
        eng.submit(p, 1)
    while eng.waiting or eng.running:
        eng.tick()
    digest = eng.kv_residency()
    assert digest["evictedBlocks"] > 0
    return {"digest": digest, "snapshot": eng.snapshot()}


def _residency_replica_snapshot(ns, clock):
    gw, reg = _affinity_gateway(ns, clock, ns.ScriptedEngine(clock=clock))
    req = gw.submit([1] * 32, 1, latency_class="interactive")
    gw.run()
    rep = gw.snapshot()["replicas"]["r0"]
    assert rep["kvResidency"]["schema"] == "tpu-dra-kv-residency-v1"
    return _record(gw, reg, [req])


# -- request telemetry ------------------------------------------------------


def _wall_clock_keys(doc: dict) -> dict:
    """A ``?view=ticks`` line with its seconds reduced to phase names."""
    return {k: sorted(v) if isinstance(v, dict) else
            (None if k == "totalS" else v) for k, v in doc.items()}


def _telemetry_timelines(ns, clock):
    reg = ns.Registry()
    tel = ns.ServingTelemetry(reg, slo={"interactive": {"ttftS": 0.02}})
    gw, _, engines = _gateway(
        ns, clock, 2, saturation_depth=10 ** 6, telemetry=tel, registry=reg,
        admission=ns.AdmissionPolicy(shed_watermark=20, hard_watermark=40,
                                     max_queue_delay_s={"batch": 0.5}),
        engine_kwargs=dict(batch_slots=2, decode_ticks_per_token=2))
    prompts = ns.shared_prefix_prompts(30, n_systems=3, system_len=32,
                                       tail_len=4, seed=31)
    reqs, shed = [], []
    for i, p in enumerate(prompts):
        lc = ("realtime", "interactive", "batch")[i % 3]
        try:
            reqs.append(gw.submit(p, 3, latency_class=lc))
        except ns.OverloadedError as e:
            shed.append((_error_doc(e), e.trace_id))
    for _ in range(3):
        gw.tick()
    gw.drain_replica("r1", reason="telemetry")
    gw.resume_replica("r1")
    gw.run()
    return {
        "gateway": _record(gw, reg, reqs),
        "shed": shed,
        "trace_ids": [r.trace_id for r in reqs],
        "timelines": tel.export_requests(""),
        "exemplars": tel.export_requests("exemplars"),
        "slo": tel.fleet_slo_summary(),
        "ticks": [_wall_clock_keys(json.loads(line)) for line in
                  tel.export_requests("ticks").splitlines()],
        "engine_ticks": [e.ticks for e in engines],
    }


def _events_narrated(ns, clock):
    """Shed, drain, failover and both scale directions, narrated as
    deduplicated ``Gateway*`` Events through an ``EventRecorder`` over
    the in-memory ``FakeKubeClient``."""
    reg = ns.Registry()
    client = ns.kube.FakeKubeClient()
    rec = ns.kube.EventRecorder(client, "serving-gateway", registry=reg)
    prov = _Prov(ns, clock)
    gw = ns.ServingGateway(
        reg, router=ns.Router(block_size=16, saturation_depth=10 ** 6),
        admission_policy=ns.AdmissionPolicy(shed_watermark=6,
                                            hard_watermark=9),
        autoscaler=ns.Autoscaler(ns.AutoscalerPolicy(
            min_replicas=1, max_replicas=3, queue_high_water=2.0,
            queue_low_water=0.5, dwell_ticks=1, cooldown_seconds=0.0),
            prov),
        events=rec, node_name="gw-node", node_uid="u-gw", clock=clock)
    for i in range(2):
        gw.add_replica(ns.ScriptedEngine(clock=clock), f"r{i}")
    reqs, sheds = [], []
    for i in range(12):
        try:
            reqs.append(gw.submit([i % 3] * 20, 2,
                                  latency_class=("batch", "interactive")[
                                      i % 2]))
        except ns.OverloadedError as e:
            sheds.append(_error_doc(e))
    gw.tick()
    gw.drain_replica("r0", reason="maintenance")
    gw.fail_replica("r1", reason="chip unplugged")
    reqs += [gw.resubmit(r) for r in list(reqs) if r.state == "failed"]
    gw.run()
    for _ in range(3):
        gw.tick()
    assert rec.flush(timeout=10.0)
    events = sorted(client.list(ns.kube.EVENTS),
                    key=lambda e: e["metadata"]["name"])
    for ev in events:
        for field in WALL_CLOCK_EVENT_FIELDS:
            assert ev.pop(field)
    reasons = {e["reason"] for e in events}
    assert {"GatewayOverloaded", "GatewayReplicaDrained",
            "GatewayReplicaLost"} <= reasons, reasons
    return {"gateway": _record(gw, reg, reqs), "sheds": sheds,
            "events": events, "ups": prov.ups, "downs": prov.downs}


SCRIPTED = {
    "routing-affinity-pins": _routing_affinity_pins,
    "routing-round-robin": _routing_round_robin,
    "routing-p2c-skew": _routing_p2c_skew,
    "routing-affinity-spill": _routing_affinity_spill,
    "routing-no-replicas": _routing_no_replicas,
    "admission-batch-shed-first": _admission_batch_shed_first,
    "admission-hard-watermark": _admission_hard_watermark,
    "admission-priority-order": _admission_priority_order,
    "admission-deadline-expiry": _admission_deadline_expiry,
    "drain-zero-loss": _drain_zero_loss,
    "drain-fail-replica-resubmit": _drain_fail_replica_resubmit,
    "drain-faultable": _drain_faultable,
    "drain-requeue-order": _drain_requeue_order,
    "drain-claim-and-resume": _drain_claim_and_resume,
    "drain-remove-pops-tables": _drain_remove_pops_tables,
    "drain-gauge-registered-states": _drain_gauge_registered_states,
    "chaos-route-fault-retries": _chaos_route_fault_retries,
    "chaos-crash-at-route": _chaos_crash_at_route,
    "chaos-seeded-soak": _chaos_seeded_soak,
    "autoscale-dwell-then-up": _autoscale_dwell_then_up,
    "autoscale-cooldown": _autoscale_cooldown,
    "autoscale-down-drains": _autoscale_down_drains,
    "autoscale-up-failure-typed": _autoscale_up_failure_typed,
    "autoscale-clamped-at-max": _autoscale_clamped_at_max,
    "autoscale-never-last-healthy": _autoscale_never_last_healthy,
    "residency-fleet-hits": _residency_fleet_hits,
    "residency-stale-ledger": _residency_stale_ledger,
    "residency-departed-series": _residency_departed_series,
    "residency-failed-series": _residency_failed_series,
    "residency-scripted-digest": _residency_scripted_digest,
    "residency-replica-snapshot": _residency_replica_snapshot,
    "telemetry-timelines": _telemetry_timelines,
    "events-narrated": _events_narrated,
}


@pytest.mark.parametrize("scenario", list(SCRIPTED))
def test_scripted_fleet_matches_reference(scenario):
    ref = SCRIPTED[scenario](REF, FakeClock())
    port = SCRIPTED[scenario](PORT, FakeClock())
    assert port == ref


def _served(ns, build):
    """GET the gateway's three debug documents from ``ns``'s
    MetricsServer, and the status and Allow header of a POST."""
    reg, gw, tel = build(ns)
    srv = ns.MetricsServer(reg, host="127.0.0.1", port=0)
    srv.set_gateway_provider(gw.snapshot)
    srv.set_residency_provider(gw.residency.snapshot)
    srv.set_requests_provider(tel.export_requests)
    srv.start()
    out = {}
    try:
        base = f"http://127.0.0.1:{srv.port}"
        for path in ("/debug/gateway", "/debug/residency",
                     "/debug/requests", "/debug/requests?view=slo",
                     "/metrics"):
            body = urllib.request.urlopen(f"{base}{path}").read().decode()
            out[path] = (_split_wall_clock(body) if path == "/metrics"
                         else body)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/debug/requests?view=nope")
        out["bad-view"] = ei.value.code
        for path in ("/debug/gateway", "/debug/residency"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}{path}", data=b"x")
            out[f"POST {path}"] = (ei.value.code,
                                   ei.value.headers.get("Allow"))
    finally:
        srv.stop()
    return out


def test_debug_endpoints_serve_the_reference_documents():
    def build(ns):
        clock = FakeClock()
        reg = ns.Registry()
        tel = ns.ServingTelemetry(reg)
        gw = ns.ServingGateway(reg, router=ns.Router(block_size=16),
                               node_name="obs", clock=clock, telemetry=tel)
        gw.add_replica(ns.ScriptedEngine(clock=clock), "r0")
        for i in range(3):
            gw.submit([1] * 32 + [i], 2, latency_class="interactive")
        gw.run()
        return reg, gw, tel

    ref, port = _served(REF, build), _served(PORT, build)
    assert port == ref
    assert port["POST /debug/gateway"] == (405, "GET, HEAD")
    assert json.loads(port["/debug/gateway"])["node"] == "obs"


# -- part two: real engines -------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jp = ref_init(REF_PRESETS["tiny"], jax.random.PRNGKey(0))
    cfg = PRESETS["tiny"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jp, tp, cfg


_SOLO = {}


def _solo(jp, prompt):
    """The reference ``generate`` of one prompt (memoised: each prompt
    length is one JAX compile)."""
    key = tuple(prompt)
    if key not in _SOLO:
        _SOLO[key] = np.asarray(ref_generate(
            jp, jnp.asarray([prompt], jnp.int32), REF_PRESETS["tiny"],
            N_NEW))[0].tolist()
    return _SOLO[key]


ENGINE_KW = dict(batch_slots=2, num_blocks=24, block_size=8, max_seq_len=40,
                 prefill_chunk=8)


def _shared_prompts():
    rng = np.random.RandomState(90)
    systems = [list(rng.randint(0, 256, size=16)) for _ in range(2)]
    tails = [list(rng.randint(0, 256, size=n))
             for n in (3, 9, 5, 11, 7, 4, 10, 6)]
    return [[int(t) for t in systems[i % 2] + tail]
            for i, tail in enumerate(tails)]


def _real_fleet(ns, make_engine, prompts, fail=False):
    clock = FakeClock()
    reg = ns.Registry()
    gw = ns.ServingGateway(
        reg, router=ns.Router(policy="affinity", block_size=8,
                              affinity_blocks=2, saturation_depth=10 ** 6),
        node_name="fleet", clock=clock)
    engines = [make_engine(clock) for _ in range(2)]
    for i, e in enumerate(engines):
        gw.add_replica(e, f"r{i}")
    reqs = [gw.submit(p, N_NEW, latency_class="interactive")
            for p in prompts]
    gw.tick()
    placed = [r.replica_id for r in reqs]
    gw.tick()
    if fail:
        lost = gw.fail_replica("r1", reason="chip unplugged")
        failed = [r for r in reqs if r.state == "failed"]
        assert lost > 0 and len(failed) == lost
        reqs += [gw.resubmit(r) for r in failed]
    else:
        gw.drain_replica("r1", reason="drain test")
    gw.run()
    for e in engines:
        if e.idle:
            e.assert_no_leaks()
    return {
        "record": _record(gw, reg, reqs),
        "engines": [(e.snapshot(), e.kv_residency(), e.kv_debug())
                    for e in engines],
        "streams": [r.tokens for r in reqs],
        "placed": placed,
    }


@pytest.mark.parametrize("event", ["drain", "fail-and-resubmit"])
def test_real_engines_behind_gateway_match_reference(tiny, event):
    jp, tp, cfg = tiny
    prompts = _shared_prompts()
    fail = event != "drain"
    ref = _real_fleet(REF, lambda c: RefEngine(
        jp, REF_PRESETS["tiny"], clock=c, **ENGINE_KW), prompts, fail)
    port = _real_fleet(PORT, lambda c: DecodeEngine(
        tp, cfg, device="cpu", clock=c, **ENGINE_KW), prompts, fail)
    assert port["streams"] == ref["streams"]
    assert port["record"] == ref["record"]
    assert port["engines"] == ref["engines"]
    assert port["placed"] == ref["placed"]
    rec = port["record"]
    assert all(r["state"] in ("finished", "failed")
               for r in rec["requests"])
    done = [r for r in rec["requests"] if r["state"] == "finished"]
    assert len(done) == len(prompts)
    # Before the drain or failure, all requests of one system on one
    # replica.
    for sys_i in range(2):
        assert len(set(port["placed"][sys_i::2])) == 1, port["placed"]
    for r in done:
        assert r["tokens"] == _solo(jp, r["tokens"][:-N_NEW]), r["gid"]
    if not fail:
        assert rec["counters"].get("failed", 0) == 0


def test_affinity_key_equals_prefix_run_key():
    rng = np.random.RandomState(9)
    prompt = [int(t) for t in rng.randint(0, 997, size=41)]
    for block_size, max_blocks in ((8, 1), (8, 2), (8, 5), (16, 2)):
        n = min(len(prompt) // block_size, max_blocks)
        key = port_sg.prefix_affinity_key(prompt, block_size, max_blocks)
        assert key == prefix_run_key(prompt[: n * block_size])
        assert key == ref_sg.prefix_affinity_key(prompt, block_size,
                                                 max_blocks)
    assert port_sg.prefix_affinity_key([1, 2], 16, 2) is None
