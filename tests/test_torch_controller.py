"""The port's ICI slice controller against the reference's.

Twins of ``test_controller.py`` and of the controller cases of
``test_events.py`` (a failed reconcile as a Node event),
``test_schema.py`` (the published channel pools validate),
``test_tracing.py`` (the controller's debug server answers its four
routes) and ``test_chaos.py`` (the node watch re-established after a
stream death), plus ``controller/main.py``'s flags. Each scenario runs
once per package (``test_torch_kube.both``), makes the reference test's
assertions on that package and returns what it observed: domains, the
published pools' specs, offsets, outcomes. The two packages'
observations must be equal; counts that depend on thread timing are
observed as the reference test bounds them.
"""

from __future__ import annotations

import time
import urllib.request

import pytest

from test_torch_kube import both, outcome


def wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def node(side, name, slice_id=None, clique=None):
    sm = side("controller.slice_manager")
    labels = {}
    if slice_id:
        labels[sm.SLICE_LABEL] = slice_id
    if clique:
        labels[sm.CLIQUE_LABEL] = clique
    return {"metadata": {"name": name, "labels": labels}}


def manager(side, client=None, **kwargs):
    kube = side("kube")
    client = client or kube.FakeKubeClient()
    return side("controller.slice_manager").IciSliceManager(
        client, **kwargs), client


def domains(mgr):
    """The manager's domains as sorted [slice, clique, [nodes]]."""
    return sorted([k.slice_id, k.clique_id, sorted(v)]
                  for k, v in mgr.domains().items())


def specs(side, client):
    """The published ResourceSlices' specs, in pool-name order."""
    kube = side("kube")
    return sorted((s["spec"] for s in client.list(kube.RESOURCE_SLICES)),
                  key=lambda s: s["pool"]["name"])


# -- test_controller.py::TestOffsetAllocator -----------------------------------


def offsets_slots_and_reuse(side):
    sm = side("controller.slice_manager")
    a = sm.OffsetAllocator()
    k1, k2 = sm.DomainKey("s1"), sm.DomainKey("s2")
    seen = [a.add(k1), a.add(k2), a.add(k1)]
    a.remove(k1)
    seen.append(a.add(sm.DomainKey("s3")))
    assert seen == [0, 128, 0, 0]
    return seen


def offsets_capacity_exhaustion(side):
    sm = side("controller.slice_manager")
    a = sm.OffsetAllocator()
    seen = [a.add(sm.DomainKey(f"s{i}")) for i in range(2048 // 128)]
    over = outcome(a.add, sm.DomainKey("overflow"))
    assert over[0] == "RuntimeError" and "capacity" in over[1]
    return seen, over


def exhaustion_does_not_wedge_publishing(side):
    sm = side("controller.slice_manager")
    kube = side("kube")
    mgr, client = manager(side)
    for i in range(16):
        client.create(kube.NODES, node(side, f"n{i}", f"slice-{i:02d}"))
    mgr.start()
    try:
        assert wait_for(lambda: len(mgr.domains()) == 16)
        client.create(kube.NODES, node(side, "n-over", "slice-overflow"))
        client.create(kube.NODES, node(side, "n17", "slice-00"))
        assert wait_for(lambda: "n17" in mgr.domains().get(
            sm.DomainKey("slice-00"), set()))
        mgr.slice_controller.sync_once()
        assert len(client.list(kube.RESOURCE_SLICES)) == 16
        assert sm.DomainKey("slice-overflow") not in mgr.domains()
        return domains(mgr), specs(side, client)
    finally:
        mgr.stop(cleanup=False)


# -- test_controller.py::TestDomainLifecycle -----------------------------------


def domain_appears_and_publishes(side):
    sm = side("controller.slice_manager")
    kube = side("kube")
    mgr, client = manager(side)
    mgr.start()
    client.create(kube.NODES, node(side, "n1", "slice-a"))
    client.create(kube.NODES, node(side, "n2", "slice-a"))
    assert wait_for(lambda: any(s["spec"].get("nodeSelector")
                                for s in client.list(kube.RESOURCE_SLICES)))
    mgr.slice_controller.sync_once()
    published = specs(side, client)
    assert len(published) == 1
    assert len(published[0]["devices"]) == sm.CHANNELS_PER_POOL
    sel = published[0]["nodeSelector"]["nodeSelectorTerms"][0][
        "matchExpressions"]
    assert sel[0] == {"key": sm.SLICE_LABEL, "operator": "In",
                      "values": ["slice-a"]}
    seen = domains(mgr)
    assert seen == [["slice-a", "", ["n1", "n2"]]]
    mgr.stop()
    assert client.list(kube.RESOURCE_SLICES) == []
    return seen, published


def domain_vanishes_when_last_node_leaves(side):
    kube = side("kube")
    mgr, client = manager(side)
    mgr.start()
    client.create(kube.NODES, node(side, "n1", "slice-a"))
    assert wait_for(lambda: mgr.domains())
    seen = domains(mgr)
    client.delete(kube.NODES, "n1")
    assert wait_for(lambda: not mgr.domains())
    mgr.slice_controller.sync_once()
    assert client.list(kube.RESOURCE_SLICES) == []
    mgr.stop(cleanup=False)
    return seen


def relabel_moves_node_between_domains(side):
    sm = side("controller.slice_manager")
    kube = side("kube")
    mgr, client = manager(side)
    mgr.start()
    try:
        obj = client.create(kube.NODES, node(side, "n1", "slice-a"))
        assert wait_for(lambda: sm.DomainKey("slice-a") in mgr.domains())
        obj["metadata"]["labels"][sm.SLICE_LABEL] = "slice-b"
        client.update(kube.NODES, obj)
        assert wait_for(lambda: mgr.domains().keys()
                        == {sm.DomainKey("slice-b")})
        mgr.slice_controller.sync_once()
        return domains(mgr), specs(side, client)
    finally:
        mgr.stop(cleanup=False)


def cliques_form_separate_pools(side):
    kube = side("kube")
    mgr, client = manager(side)
    mgr.start()
    try:
        client.create(kube.NODES, node(side, "n1", "slice-a", clique="c0"))
        client.create(kube.NODES, node(side, "n2", "slice-a", clique="c1"))
        assert wait_for(lambda: len(mgr.domains()) == 2)
        mgr.slice_controller.sync_once()
        published = specs(side, client)
        assert len(published) == 2
        firsts = sorted(s["devices"][0]["basic"]["attributes"]["channel"]
                        ["int"] for s in published)
        assert firsts == [0, 128]
        return domains(mgr), published
    finally:
        mgr.stop(cleanup=False)


def pre_existing_nodes_seed_domains(side):
    kube = side("kube")
    client = kube.FakeKubeClient()
    client.create(kube.NODES, node(side, "n1", "slice-a"))
    mgr, _ = manager(side, client)
    mgr.start()
    try:
        assert wait_for(lambda: mgr.domains())
        return domains(mgr)
    finally:
        mgr.stop(cleanup=False)


def pool_names_unambiguous(side):
    sm = side("controller.slice_manager")
    names = [sm.DomainKey("a-b").pool_name, sm.DomainKey("a", "b").pool_name]
    assert names[0] != names[1]
    return names


# -- test_controller.py::TestOutageRecovery ------------------------------------


def publish_retries_through_api_outage(side):
    kube = side("kube")
    errors = side("kube.errors")
    client = kube.FakeKubeClient()
    outage = {"remaining": 6, "seen": 0}

    def inject(verb, gvr, name):
        if gvr.resource == kube.RESOURCE_SLICES.resource:
            outage["seen"] += 1
            if outage["remaining"] > 0:
                outage["remaining"] -= 1
                return errors.ApiError("api server down", code=500)
        return None

    client.fault_injector = inject
    client.create(kube.NODES, node(side, "n1", "slice-a"))
    mgr, _ = manager(side, client)
    mgr.slice_controller.resync_seconds = 0.05
    mgr.start()
    try:
        assert wait_for(lambda: outage["remaining"] == 0
                        and client.list(kube.RESOURCE_SLICES)), outage
        assert mgr.slice_controller.sync_errors >= 1
        published = specs(side, client)
        assert len(published[0]["devices"]) == 128
        return published
    finally:
        client.fault_injector = None
        mgr.stop()


def node_events_resume_after_outage(side):
    kube = side("kube")
    errors = side("kube.errors")
    client = kube.FakeKubeClient()
    down = {"on": True}

    def inject(verb, gvr, name):
        if down["on"] and gvr.resource == kube.RESOURCE_SLICES.resource \
                and verb in ("create", "update", "delete", "list"):
            return errors.ApiError("api server down", code=500)
        return None

    mgr, _ = manager(side, client)
    mgr.slice_controller.resync_seconds = 0.05
    mgr.start()
    client.fault_injector = inject
    try:
        client.create(kube.NODES, node(side, "n1", "slice-a"))
        client.create(kube.NODES, node(side, "n2", "slice-b"))
        time.sleep(0.2)     # publishes failing throughout
        down["on"] = False  # heal
        assert wait_for(lambda: len({
            s["spec"]["pool"]["name"]
            for s in client.list(kube.RESOURCE_SLICES)}) == 2)
        return specs(side, client)
    finally:
        client.fault_injector = None
        mgr.stop()


# -- test_controller.py::TestWatchStreamRecovery -------------------------------


def watch_death_reestablishes_with_fresh_seed(side):
    kube = side("kube")
    client = kube.FakeKubeClient()
    client.create(kube.NODES, node(side, "n1", "slice-a"))
    mgr, _ = manager(side, client)
    mgr.start()
    try:
        assert wait_for(lambda: mgr.domains())
        dead = mgr._watch
        dead.stop()
        client.delete(kube.NODES, "n1")
        client.create(kube.NODES, node(side, "n2", "slice-b"))
        assert wait_for(lambda: {k.slice_id for k in mgr.domains()}
                        == {"slice-b"})
        assert mgr.healthy()[0]
        assert mgr._watch is not dead and not mgr._watch.stopped
        return domains(mgr), mgr.healthy()
    finally:
        mgr.stop()


def reestablish_retries_through_relist_faults(side):
    kube = side("kube")
    errors = side("kube.errors")
    client = kube.FakeKubeClient()
    client.create(kube.NODES, node(side, "n1", "slice-a"))
    mgr, _ = manager(side, client)
    mgr.start()
    try:
        assert wait_for(lambda: mgr.domains())
        faults = {"remaining": 3, "seen": 0}

        def inject(verb, gvr, name):
            if verb in ("list", "watch") and gvr.resource == "nodes":
                faults["seen"] += 1
                if faults["remaining"] > 0:
                    faults["remaining"] -= 1
                    return errors.ApiError("history compacted", code=410)
            return None

        client.fault_injector = inject
        mgr._watch.stop()
        client.create(kube.NODES, node(side, "n2", "slice-b"))
        assert wait_for(lambda: {k.slice_id for k in mgr.domains()}
                        == {"slice-a", "slice-b"}, timeout=15), faults
        assert faults["seen"] >= 3
        assert mgr.healthy()[0]
        return domains(mgr), faults["remaining"]
    finally:
        client.fault_injector = None
        mgr.stop()


def healthy_reports_not_ready_during_dark_window(side):
    kube = side("kube")
    errors = side("kube.errors")
    client = kube.FakeKubeClient()
    client.create(kube.NODES, node(side, "n1", "slice-a"))
    mgr, _ = manager(side, client)
    mgr.start()
    try:
        assert wait_for(lambda: mgr.healthy()[0])
        seen = [mgr.healthy()]
        client.fault_injector = lambda verb, gvr, name: (
            errors.ApiError("down", code=503)
            if verb in ("list", "watch") and gvr.resource == "nodes"
            else None)
        mgr._watch.stop()
        assert wait_for(lambda: not mgr.healthy()[0])
        seen.append(mgr.healthy())
        client.fault_injector = None
        assert wait_for(lambda: mgr.healthy()[0], timeout=15)
        seen.append(mgr.healthy())
        return seen
    finally:
        client.fault_injector = None
        mgr.stop()


# -- test_controller.py::TestOffsetRecovery ------------------------------------


def restart_preserves_channel_numbering(side):
    sm = side("controller.slice_manager")
    kube = side("kube")
    mgr, client = manager(side)
    mgr.start()
    client.create(kube.NODES, node(side, "n1", "slice-a"))
    client.create(kube.NODES, node(side, "n2", "slice-b"))
    assert wait_for(lambda: len(mgr.domains()) == 2)
    mgr.slice_controller.sync_once()
    assert mgr.offsets.get(sm.DomainKey("slice-b")) == 128
    mgr.stop(cleanup=False)  # crash: slices stay in the API server

    client.delete(kube.NODES, "n1")
    mgr2, _ = manager(side, client)
    mgr2.start()
    try:
        assert wait_for(lambda: mgr2.domains())
        assert mgr2.offsets.get(sm.DomainKey("slice-b")) == 128
        mgr2.slice_controller.sync_once()
        published = specs(side, client)
        assert len(published) == 1
        first = published[0]["devices"][0]["basic"]["attributes"]
        assert first["channel"]["int"] == 128
        return domains(mgr2), published
    finally:
        mgr2.stop(cleanup=False)


@pytest.mark.parametrize("scenario", [
    offsets_slots_and_reuse, offsets_capacity_exhaustion,
    exhaustion_does_not_wedge_publishing, domain_appears_and_publishes,
    domain_vanishes_when_last_node_leaves,
    relabel_moves_node_between_domains, cliques_form_separate_pools,
    pre_existing_nodes_seed_domains, pool_names_unambiguous,
    publish_retries_through_api_outage, node_events_resume_after_outage,
    watch_death_reestablishes_with_fresh_seed,
    reestablish_retries_through_relist_faults,
    healthy_reports_not_ready_during_dark_window,
    restart_preserves_channel_numbering,
], ids=lambda f: f.__name__)
def test_controller(scenario):
    both(scenario)


# -- test_events.py::TestControllerReconcileEvents -----------------------------


def _raise(*a, **k):
    raise RuntimeError("publish exploded")


def test_reconcile_error_emits_node_event():
    def scenario(side):
        kube = side("kube")
        sm = side("controller.slice_manager")
        client = kube.FakeKubeClient()
        reg = side("utils.metrics").Registry()
        rec = side("kube.events").EventRecorder(
            client, component="tpu-dra-controller", namespace="default",
            registry=reg)
        mgr = sm.IciSliceManager(client, registry=reg, events=rec)
        mgr.start()
        mgr.slice_controller.update = _raise
        try:
            client.create(kube.NODES, {"metadata": {
                "name": "node-x", "labels": {sm.SLICE_LABEL: "slice-1"}}})
            events = []
            assert wait_for(lambda: events.extend(
                e for e in client.list(kube.EVENTS, namespace="default")
                if e["reason"] == "ReconcileFailed") or events)
        finally:
            mgr.stop(cleanup=False)
        assert len(events) == 1
        assert events[0]["involvedObject"]["name"] == "node-x"
        assert events[0]["type"] == "Warning"
        assert 'tpu_dra_reconciles_total{outcome="error"}' in reg.render()
        return [(e["type"], e["reason"], e["message"],
                 e["involvedObject"]["kind"], e["involvedObject"]["name"])
                for e in events]

    both(scenario)


# -- test_schema.py::TestPublishedObjectsConform -------------------------------


@pytest.mark.parametrize("version", ["v1alpha3", "v1beta1", "v1beta2", "v1"])
def test_ici_controller_slices_validate(version):
    def scenario(side):
        kube = side("kube")
        client = kube.FakeKubeClient()
        client.served_api_versions["resource.k8s.io"] = [version]
        for i in range(2):
            client.create(kube.NODES, {"metadata": {
                "name": f"host-{i}",
                "labels": {"tpu.google.com/slice-id": "slice-a"}}})
        mgr = side("controller.slice_manager").IciSliceManager(
            client, "tpu.google.com")
        mgr.start()
        try:
            gvr = kube.ResourceApi(version).slices
            assert wait_for(lambda: client.list(gvr)), \
                "controller published nothing"
            slices = client.list(gvr)
            for s in slices:
                side("kube.schema").validate_resource_slice(s)
            return [s["spec"] for s in slices]
        finally:
            mgr.stop()

    both(scenario)


# -- test_tracing.py::TestDebugServers (the controller's server) ---------------


def test_controller_debug_server_routes():
    def scenario(side):
        metrics = side("utils.metrics")
        registry = metrics.Registry()
        tracer = side("utils.tracing").Tracer()
        mgr = side("controller.slice_manager").IciSliceManager(
            side("kube").FakeKubeClient(), "tpu.google.com",
            registry=registry, tracer=tracer)
        mgr.start()
        srv = metrics.MetricsServer(registry, host="127.0.0.1", port=0,
                                    tracer=tracer)
        srv.add_readiness_check("slice-manager", mgr.healthy)
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            seen = {}
            for route in ("/metrics", "/healthz", "/readyz",
                          "/debug/traces"):
                resp = urllib.request.urlopen(base + route)
                assert resp.status == 200, route
                seen[route] = resp.status
            seen["ready"] = urllib.request.urlopen(
                base + "/readyz").read().decode().strip().splitlines()
            return seen
        finally:
            srv.stop()
            mgr.stop()

    both(scenario)


# -- test_chaos.py::TestWatchStreamDeath ---------------------------------------


def test_controller_reestablishes_node_watch():
    def scenario(side):
        kube = side("kube")
        sm = side("controller.slice_manager")
        client = kube.FakeKubeClient()
        client.create(kube.NODES, {"metadata": {
            "name": "n1", "labels": {sm.SLICE_LABEL: "s1"}}})
        mgr = sm.IciSliceManager(client)
        mgr.start()
        try:
            assert wait_for(
                lambda: len(client.list(kube.RESOURCE_SLICES)) == 1)
            dead = mgr._watch
            dead.stop()
            client.delete(kube.NODES, "n1")
            client.create(kube.NODES, {"metadata": {
                "name": "n2", "labels": {sm.SLICE_LABEL: "s2"}}})
            assert wait_for(lambda: mgr.healthy()[0]
                            and mgr._watch is not dead)
            assert wait_for(lambda: [k.slice_id for k in mgr.domains()]
                            == ["s2"])
            client.create(kube.NODES, {"metadata": {
                "name": "n3", "labels": {sm.SLICE_LABEL: "s3"}}})
            assert wait_for(lambda: {k.slice_id for k in mgr.domains()}
                            == {"s2", "s3"})
            return domains(mgr)
        finally:
            mgr.stop(cleanup=False)

    both(scenario)


# -- controller/main.py ---------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [],
    ["--device-classes", "chip", "--http-port", "0", "--cleanup-on-exit",
     "--log-json", "--kube-api-qps", "7", "--pod-name", "p",
     "--pod-uid", "u"],
], ids=["defaults", "flags"])
def test_main_flags(argv, monkeypatch):
    for var in ("DRIVER_NAME", "POD_NAME", "POD_UID", "NAMESPACE",
                "DEVICE_CLASSES", "HTTP_PORT", "KUBECONFIG", "LOG_LEVEL"):
        monkeypatch.delenv(var, raising=False)

    def scenario(side):
        return vars(side("controller.main").build_parser().parse_args(argv))

    both(scenario)
