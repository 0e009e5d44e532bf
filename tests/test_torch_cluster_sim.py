"""The whole control plane against one fake API server, on both packages.

Twins of ``test_cluster_sim.py``: two "nodes" of a 2-host v5p slice run
full ``Driver`` instances, the ICI slice controller publishes the slice's
channel pool, and the reference allocator plays the scheduler. Each
scenario runs once per package on its own cluster, makes the reference
test's assertions, and returns what it observed (published specs,
allocation results, prepare results, CDI edits, refusals); the two must
be equal once the cluster's directory is masked.

A kubelet reaches the reference's Drivers through its ``NodeStub`` over
their gRPC unix sockets, and the port's through
``kubeletplugin.LocalTransport`` in the port's wire codec (a fleet of
Drivers in one process; the port's sockets have their own tests in
``test_torch_plugin_driver.py`` and ``test_torch_kubelet_socket.py``).
The reference's sockets live under a directory made with
``tempfile.mkdtemp`` (a short path): a socket path of 106 bytes or more
fails to bind.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time

import grpc
import pytest

from k8s_dra_driver_tpu.kube.protos import dra_v1alpha4_pb2 as ref_drapb
from k8s_dra_driver_tpu.plugin.grpc_services import NodeStub
from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as port_drapb
from test_torch_kube import REF, SIDES, both, outcome
from test_torch_plugin_driver import first_difference

DRIVER = "tpu.google.com"


def wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def masked(obj, root):
    return json.loads(json.dumps(obj, default=str).replace(root, "<dir>"))


def empty_root(root):
    """An empty driver root: the reference would also find a libtpu wheel
    in this host's Python environment, the port does not look there."""
    path = os.path.join(root, "driver")
    os.makedirs(path, exist_ok=True)
    return path


def in_process(side) -> dict:
    """The port's Drivers answer through ``LocalTransport``."""
    if side is REF:
        return {}
    return {"transport": side("plugin.kubeletplugin").LocalTransport()}


@contextlib.contextmanager
def cluster(side):
    """API server + controller + two node plugins on one v5p 4x2 slice.
    Yields (client, drivers, root)."""
    kube = side("kube")
    sm = side("controller.slice_manager")
    root = tempfile.mkdtemp(prefix="cs-")
    client = kube.FakeKubeClient()
    drivers, mgr = {}, None
    try:
        for h, name in enumerate(["node-a", "node-b"]):
            client.create(kube.NODES, {"metadata": {
                "name": name, "uid": f"uid-{name}",
                "labels": {sm.SLICE_LABEL: "slice-1"}}})
            d = side("plugin.driver").Driver(side("plugin.driver").DriverConfig(
                node_name=name,
                chiplib=side("tpulib").FakeChipLib(
                    generation="v5p", topology="4x2x1", host_id=h,
                    hosts_per_slice=2, slice_id="slice-1"),
                kube_client=client,
                cdi_root=f"{root}/{name}/cdi",
                plugin_root=f"{root}/{name}/plugin",
                registrar_root=f"{root}/{name}/reg",
                state_root=f"{root}/{name}/state",
                node_uid=f"uid-{name}",
                cleanup_interval_seconds=0,
                driver_root=empty_root(root),
                driver_root_ctr_path=empty_root(root),
                **in_process(side),
            ))
            d.start()
            drivers[name] = d
        mgr = sm.IciSliceManager(client)
        mgr.start()
        assert wait_for(lambda: len(client.list(kube.RESOURCE_SLICES)) >= 3), \
            "expected 2 node pools + 1 ici pool"
        yield client, drivers, root
    finally:
        if mgr is not None:
            mgr.stop(cleanup=False)
        for d in drivers.values():
            d.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def twin(scenario):
    """``scenario(side, client, drivers)`` on each package's cluster; the
    observations, the directory masked, must be equal."""
    seen = []
    for side in SIDES:
        with cluster(side) as (client, drivers, root):
            seen.append(masked(scenario(side, client, drivers), root))
    assert seen[1] == seen[0], first_difference(seen[0], seen[1])
    return seen[1]


def kubelet(side, driver, method, claim):
    """``method`` for ``claim`` as a kubelet sends it: the reference's
    NodeStub over the plugin socket, or the port's codec through its
    transport. Returns the claim's result as a dict."""
    md = claim["metadata"]
    if side is REF:
        req_cls = getattr(ref_drapb, f"{method}Request")
        with grpc.insecure_channel(
                f"unix://{driver.config.plugin_socket}") as ch:
            resp = getattr(NodeStub(ch), method)(req_cls(claims=[
                ref_drapb.Claim(uid=md["uid"], name=md["name"],
                                namespace=md["namespace"])]))
        result = resp.claims[md["uid"]]
        return {"error": result.error,
                "devices": [[d.request_names[:], d.pool_name, d.device_name,
                             d.cdi_device_ids[:]]
                            for d in getattr(result, "devices", [])]}
    req_cls = getattr(port_drapb, f"{method}Request")
    resp_cls = getattr(port_drapb, f"{method}Response")
    req = req_cls(claims=[port_drapb.Claim(
        uid=md["uid"], name=md["name"], namespace=md["namespace"])])
    resp = resp_cls.FromString(driver.config.transport.call(
        f"/v1beta1.DRAPlugin/{method}", req.SerializeToString()))
    result = resp.claims[md["uid"]]
    return {"error": result.error,
            "devices": [[list(d.request_names), d.pool_name, d.device_name,
                         list(d.cdi_device_ids)]
                        for d in getattr(result, "devices", [])]}


def make_claim_obj(uid, name, requests, constraints=None, config=None):
    return {
        "apiVersion": "resource.k8s.io/v1beta1",
        "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": "sim", "uid": uid},
        "spec": {"devices": {
            "requests": requests,
            **({"constraints": constraints} if constraints else {}),
            **({"config": config} if config else {}),
        }},
    }


def results(claim):
    return claim["status"]["allocation"]["devices"]["results"]


def cdi_env(driver, uid):
    path = os.path.join(driver.config.cdi_root,
                        f"k8s.tpu.google.com-claim_{uid}.json")
    with open(path) as f:
        return json.load(f)["containerEdits"]["env"]


def selector(side, *args):
    return side("kube.allocator").Selector(*args)


def test_slice_inventory():
    def scenario(side, client, drivers):
        slices = client.list(side("kube").RESOURCE_SLICES)
        by_node = {s["spec"].get("nodeName"): s for s in slices
                   if "nodeName" in s["spec"]}
        assert set(by_node) == {"node-a", "node-b"}
        assert len(by_node["node-a"]["spec"]["devices"]) == 12
        ici = [s for s in slices if "nodeSelector" in s["spec"]]
        assert len(ici) == 1 and len(ici[0]["spec"]["devices"]) == 128
        return sorted((s["spec"] for s in slices),
                      key=lambda s: s["pool"]["name"])

    twin(scenario)


def test_full_pod_lifecycle_single_chip():
    def scenario(side, client, drivers):
        alloc = side("kube.allocator").ReferenceAllocator(client)
        claim = make_claim_obj("sim-uid-1", "one-chip", [
            {"name": "chip", "deviceClassName": "tpu.google.com"}])
        alloc.allocate(claim, node_name="node-a")
        client.create(side("kube").RESOURCE_CLAIMS, claim, namespace="sim")
        prepared = kubelet(side, drivers["node-a"], "NodePrepareResources",
                           claim)
        assert prepared["error"] == "" and len(prepared["devices"]) == 1
        env = cdi_env(drivers["node-a"], "sim-uid-1")
        assert any(e.startswith("TPU_VISIBLE_CHIPS=") for e in env)
        assert "TPU_SLICE_ID=slice-1" in env
        unprepared = kubelet(side, drivers["node-a"],
                             "NodeUnprepareResources", claim)
        assert unprepared["error"] == ""
        alloc.deallocate("sim-uid-1")
        return dict(results=results(claim), prepared=prepared, env=env,
                    unprepared=unprepared)

    twin(scenario)


def test_gang_submesh_with_ici_channel():
    def scenario(side, client, drivers):
        alloc = side("kube.allocator").ReferenceAllocator(client)
        claim = make_claim_obj(
            "sim-uid-2", "gang",
            [{"name": "mesh", "deviceClassName": "tpu.google.com",
              "count": 4},
             {"name": "chan", "deviceClassName": "ici.tpu.google.com"}],
            constraints=[{"requests": ["mesh"],
                          "matchAttribute": "tpu.google.com/hostId"}])
        alloc.allocate(claim)
        got = results(claim)
        mesh = [r for r in got if r["request"] == "mesh"]
        chan = [r for r in got if r["request"] == "chan"]
        assert len(mesh) == 4 and len(chan) == 1
        pools = {r["pool"] for r in mesh}
        assert len(pools) == 1
        node = pools.pop()
        client.create(side("kube").RESOURCE_CLAIMS, claim, namespace="sim")
        prepared = kubelet(side, drivers[node], "NodePrepareResources", claim)
        assert prepared["error"] == "" and len(prepared["devices"]) == 5
        created = drivers[node].state.chiplib.created_channels
        assert created
        return dict(results=got, prepared=prepared,
                    channels=sorted(map(str, created)))

    twin(scenario)


def test_selector_picks_generation_and_coord():
    def scenario(side, client, drivers):
        alloc = side("kube.allocator").ReferenceAllocator(client)
        claim = make_claim_obj("sim-uid-3", "origin-chip", [
            {"name": "chip", "deviceClassName": "tpu.google.com"}])
        alloc.allocate(claim, selectors={"chip": [
            selector(side, "generation", "eq", "v5p"),
            selector(side, "coord", "eq", "0,1,0")]})
        assert results(claim)[0]["pool"] == "node-a"
        return results(claim)

    twin(scenario)


def test_double_booking_prevented():
    def scenario(side, client, drivers):
        alloc = side("kube.allocator").ReferenceAllocator(client)
        sel = {"chip": [selector(side, "coord", "eq", "0,0,0")]}
        c1 = make_claim_obj("sim-uid-4", "c1", [
            {"name": "chip", "deviceClassName": "tpu.google.com"}])
        alloc.allocate(c1, selectors=sel)
        c2 = make_claim_obj("sim-uid-5", "c2", [
            {"name": "chip", "deviceClassName": "tpu.google.com"}])
        refused = outcome(alloc.allocate, c2, selectors=sel)
        assert refused[0] == "AllocationError"
        return results(c1), refused

    twin(scenario)


def test_counter_sets_block_chip_core_double_booking():
    def scenario(side, client, drivers):
        alloc = side("kube.allocator").ReferenceAllocator(client)
        whole = make_claim_obj("cnt-uid-1", "whole", [
            {"name": "chip", "deviceClassName": "tpu.google.com"}])
        alloc.allocate(whole, selectors={"chip": [
            selector(side, "coord", "eq", "0,0,0")]})
        idx = None
        for s in client.list(side("kube").RESOURCE_SLICES):
            for d in s["spec"].get("devices", []):
                if d["name"] == results(whole)[0]["device"]:
                    idx = d["basic"]["attributes"]["index"]["int"]
        assert idx is not None
        core = make_claim_obj("cnt-uid-2", "core", [
            {"name": "core", "deviceClassName": "tensorcore.tpu.google.com"}])
        pin = {"core": [selector(side, "parentIndex", "eq", idx)]}
        seen = [outcome(alloc.allocate, core, selectors=pin,
                        node_name="node-a")]
        assert seen[0][0] == "AllocationError"
        alloc.deallocate("cnt-uid-1")
        alloc.allocate(core, selectors=pin, node_name="node-a")
        whole2 = make_claim_obj("cnt-uid-3", "whole2", [
            {"name": "chip", "deviceClassName": "tpu.google.com"}])
        seen.append(outcome(alloc.allocate, whole2, selectors={"chip": [
            selector(side, "index", "eq", idx)]}, node_name="node-a"))
        assert seen[1][0] == "AllocationError"
        return seen, results(core)

    twin(scenario)


def test_undeclared_consumed_counter_disqualifies_device():
    def chip(name, idx, consumes):
        return {"name": name, "basic": {
            "attributes": {"type": {"string": "chip"}, "index": {"int": idx}},
            "capacity": {}, "consumesCounters": consumes}}

    def scenario(side):
        kube = side("kube")
        client = kube.FakeKubeClient()
        client.validate_schemas = False
        client.create(kube.RESOURCE_SLICES, {
            "apiVersion": "resource.k8s.io/v1beta1",
            "kind": "ResourceSlice",
            "metadata": {"name": "mixed-slice"},
            "spec": {
                "driver": "tpu.google.com", "nodeName": "node-x",
                "pool": {"name": "node-x", "generation": 1,
                         "resourceSliceCount": 1},
                "sharedCounters": [{"name": "chip-1-counters",
                                    "counters": {"cores": {"value": "2"}}}],
                "devices": [
                    chip("chip-0", 0, [{"counterSet": "phantom-counters",
                                        "counters": {"cores":
                                                     {"value": "2"}}}]),
                    chip("chip-1", 1, [{"counterSet": "chip-1-counters",
                                        "counters": {"cores":
                                                     {"value": "2"}}}]),
                ],
            },
        })
        alloc = side("kube.allocator").ReferenceAllocator(client)
        claim = make_claim_obj("bad-uid-1", "c", [
            {"name": "chip", "deviceClassName": "tpu.google.com"}])
        alloc.allocate(claim)
        assert [r["device"] for r in results(claim)] == ["chip-1"]
        claim2 = make_claim_obj("bad-uid-2", "c2", [
            {"name": "chip", "deviceClassName": "tpu.google.com"}])
        refused = outcome(alloc.allocate, claim2)
        assert refused[0] == "AllocationError"
        return results(claim), refused

    both(scenario)


def test_gang_must_be_contiguous_submesh():
    def scenario(side, client, drivers):
        alloc = side("kube.allocator").ReferenceAllocator(client)
        frag = make_claim_obj("gang-uid-1", "fragmented", [
            {"name": "gang", "deviceClassName": "tpu.google.com",
             "count": 2}])
        refused = outcome(alloc.allocate, frag, selectors={"gang": [
            selector(side, "coord", "in", ["0,0,0", "2,0,0"])]})
        assert refused[0] == "AllocationError"
        ok = make_claim_obj("gang-uid-2", "adjacent", [
            {"name": "gang", "deviceClassName": "tpu.google.com",
             "count": 2}])
        alloc.allocate(ok, selectors={"gang": [
            selector(side, "coord", "in", ["0,0,0", "1,0,0"])]})
        assert len(results(ok)) == 2
        return refused, results(ok)

    twin(scenario)


def test_submesh_tile_attribute_gangs_2x2():
    def scenario(side, client, drivers):
        alloc = side("kube.allocator").ReferenceAllocator(client)
        claim = make_claim_obj(
            "gang-uid-3", "tile",
            [{"name": "gang", "deviceClassName": "tpu.google.com",
              "count": 4}],
            constraints=[{"requests": ["gang"], "matchAttribute":
                          "tpu.google.com/submesh2x2Id"}])
        alloc.allocate(claim)
        got = results(claim)
        assert len(got) == 4
        devs = [d for s in client.list(side("kube").RESOURCE_SLICES)
                for d in s["spec"].get("devices", []) for r in got
                if d["name"] == r["device"]
                and s["spec"].get("pool", {}).get("name") == r["pool"]]
        tiles = {d["basic"]["attributes"]["submesh2x2Id"]["string"]
                 for d in devs}
        assert len(tiles) == 1, tiles
        return got, sorted(tiles)

    twin(scenario)


def test_tensorcore_same_parent_constraint():
    def scenario(side, client, drivers):
        alloc = side("kube.allocator").ReferenceAllocator(client)
        claim = make_claim_obj(
            "sim-uid-6", "cores",
            [{"name": "core-0",
              "deviceClassName": "tensorcore.tpu.google.com"},
             {"name": "core-1",
              "deviceClassName": "tensorcore.tpu.google.com"}],
            constraints=[{"requests": ["core-0", "core-1"],
                          "matchAttribute": "tpu.google.com/parentUuid"}])
        alloc.allocate(claim, node_name="node-b")
        names = sorted(r["device"] for r in results(claim))
        assert len({n.split("-core-")[0] for n in names}) == 1
        client.create(side("kube").RESOURCE_CLAIMS, claim, namespace="sim")
        prepared = kubelet(side, drivers["node-b"], "NodePrepareResources",
                           claim)
        assert prepared["error"] == ""
        env = cdi_env(drivers["node-b"], "sim-uid-6")
        assert any(e.startswith("TPU_VISIBLE_CORES=") for e in env)
        return dict(results=results(claim), prepared=prepared, env=env)

    twin(scenario)


def test_synthetic_profile_allocates_with_counter_exclusivity(monkeypatch):
    """test_cluster_sim.py::TestPartitionProfiles: a synthetic two-core
    profile enumerates its placement, allocates, and its counters exclude
    the whole chip and the 1c placements of the same chip."""
    def scenario(side):
        di = side("tpulib.deviceinfo")
        kube = side("kube")
        sm = side("controller.slice_manager")
        synthetic = di.PartitionProfile(name="2c", cores=2,
                                        hbm_fraction=(1, 2))
        monkeypatch.setattr(di, "partition_profiles",
                            lambda gen: [di.ONE_CORE_PROFILE, synthetic])
        root = tempfile.mkdtemp(prefix="pp-")
        client = kube.FakeKubeClient()
        client.create(kube.NODES, {"metadata": {
            "name": "node-a", "uid": "u-a", "labels": {sm.SLICE_LABEL: "s"}}})
        d = side("plugin.driver").Driver(side("plugin.driver").DriverConfig(
            node_name="node-a",
            chiplib=side("tpulib").FakeChipLib(
                generation="v5p", topology="2x1x1", slice_id="s"),
            kube_client=client, cdi_root=f"{root}/cdi",
            plugin_root=f"{root}/plugin", registrar_root=f"{root}/reg",
            state_root=f"{root}/state", node_uid="u-a",
            cleanup_interval_seconds=0, driver_root=empty_root(root),
            driver_root_ctr_path=empty_root(root), **in_process(side)))
        d.start()
        try:
            def devices():
                return [dev for s in client.list(kube.RESOURCE_SLICES)
                        for dev in s["spec"].get("devices", [])]

            assert wait_for(lambda: any(dev["name"] == "tpu-0-2c-0"
                                        for dev in devices()))
            dev2c = next(dev for dev in devices()
                         if dev["name"] == "tpu-0-2c-0")
            assert dev2c["basic"]["capacity"]["tensorcores"]["value"] == "2"
            assert dev2c["basic"]["consumesCounters"][0]["counters"][
                "cores"]["value"] == "2"
            alloc = side("kube.allocator").ReferenceAllocator(client)

            def claim(uid, name, klass):
                return make_claim_obj(uid, name, [
                    {"name": "p", "deviceClassName": klass}])

            core = "tensorcore.tpu.google.com"
            seen = []
            alloc.allocate(claim("pp-1", "two-core", core), selectors={"p": [
                selector(side, "profile", "eq", "2c"),
                selector(side, "parentIndex", "eq", 0)]})
            seen.append(outcome(alloc.allocate, claim(
                "pp-2", "whole", "tpu.google.com"), selectors={"p": [
                    selector(side, "index", "eq", 0)]}))
            seen.append(outcome(alloc.allocate, claim(
                "pp-3", "one-core", core), selectors={"p": [
                    selector(side, "profile", "eq", "1c"),
                    selector(side, "parentIndex", "eq", 0)]}))
            assert [s[0] for s in seen] == ["AllocationError"] * 2
            four = claim("pp-4", "two-core-b", core)
            alloc.allocate(four, selectors={"p": [
                selector(side, "profile", "eq", "2c"),
                selector(side, "parentIndex", "eq", 1)]})
            alloc.deallocate("pp-1")
            five = claim("pp-5", "whole-after", "tpu.google.com")
            alloc.allocate(five, selectors={"p": [
                selector(side, "index", "eq", 0)]})
            return dict(device=dev2c, refused=seen, four=results(four),
                        five=results(five))
        finally:
            d.shutdown()
            shutil.rmtree(root, ignore_errors=True)

    both(scenario)


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for side in SIDES:
        side("utils.faults").disarm()
