"""The port's kubelet-facing Driver against the reference's.

Twins of ``test_plugin_grpc.py``, ``test_device_watch.py``, the Driver
cases of ``test_tracing.py``, the Driver opt-in cases of
``test_defrag_executor.py``, and the cases of ``test_chaos.py`` that need
no JAX (unplug mid-prepare, apiserver blackout, crash/restart, health end
to end, the auditor oracle, elastic gang resize and its crash windows,
the rebalance limits' crash windows, defrag execution on the node).

Each scenario runs once per package (``both``), each in a directory of
its own, makes the reference test's assertions, and returns what it
observed; the two packages' observations must be equal, with timestamps
and durations masked and the directory written as ``<dir>``.

Each package serves its kubelet sockets its own way: the reference on
two ``grpc.server``s, the port on its hand-written gRPC over HTTP/2
(``plugin/grpc_uds.py``, the Driver's default transport). The
reference's ``NodeStub`` and ``RegistrationStub`` on real ``grpcio``
channels drive both packages byte for byte, as a kubelet would.

The elastic trainer's cases (the resize-resume-grow of
``TestElasticGangResize::test_chip_unplug_mid_step_resize_resume_and_grow``,
the shrink/grow soak and the defrag training gang) run on the port alone
with the reference tests' assertions: the port's ``ElasticTrainer`` rides
the port's Driver, and its decisions are held against the reference's in
``test_torch_elastic.py``.

Not twinned: the snapshot-descent case fails on the reference itself
(ROADMAP C); the seeded acceptance schedule and the node-watch controller
are not the Driver's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import time
import urllib.error
import urllib.request

import grpc
import pytest
from google.protobuf import json_format

from k8s_dra_driver_tpu.kube.protos import dra_v1alpha4_pb2 as drapb
from k8s_dra_driver_tpu.kube.protos import pluginregistration_v1_pb2 as regpb
from k8s_dra_driver_tpu.plugin.grpc_services import (
    DRA_SERVICE_NAME,
    DRA_SERVICE_NAME_V1BETA1,
    NodeStub,
    RegistrationStub,
)
from test_torch_allocator import chip_claim
from test_torch_defrag import (
    executor,
    fragmented_4x1,
    held_by,
    journal,
    stuck_gang,
)
from test_torch_kube import PORT, REF, SIDES, TIMING_KEYS, exposition

DRIVER = "tpu.google.com"
# Wall-clock fields of checkpoints, resize messages, intents, health and
# snapshots, beside the decision records' (test_torch_kube.TIMING_KEYS).
TIMES = TIMING_KEYS | {"preparedAt", "at", "startedAt", "since",
                      "generatedAt", "firstTimestamp", "lastTimestamp",
                      "updatedAt", "resizedAt", "lastResizeAt"}


def masked(obj):
    """``obj`` with every wall-clock value replaced by "<t>"."""
    if isinstance(obj, dict):
        return {k: "<t>" if k in TIMES else masked(v)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [masked(v) for v in obj]
    return obj


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    for side in SIDES:
        side("utils.faults").disarm()


def both(scenario, tmp_path, *args, **kwargs):
    """Run ``scenario(side, root, ...)`` on each package in a directory
    of its own; the observations, masked and with the directory written
    as <dir>, must be equal. Returns the port's."""
    seen = []
    for side in SIDES:
        root = tmp_path / ("r" if side is REF else "p")
        root.mkdir()
        got = scenario(side, root, *args, **kwargs)
        seen.append(json.loads(
            json.dumps(masked(got), default=str).replace(str(root), "<dir>")))
    assert seen[1] == seen[0], first_difference(seen[0], seen[1])
    return seen[1]


def first_difference(ref, port, path="$"):
    """Where two observations first differ, for the failure message."""
    if type(ref) is not type(port):
        return f"{path}: {ref!r} != {port!r}"
    if isinstance(ref, dict):
        for k in sorted(set(ref) | set(port), key=str):
            if ref.get(k) != port.get(k):
                return first_difference(ref.get(k), port.get(k),
                                        f"{path}.{k}")
    if isinstance(ref, list) and len(ref) == len(port):
        for i, (a, b) in enumerate(zip(ref, port)):
            if a != b:
                return first_difference(a, b, f"{path}[{i}]")
    if isinstance(ref, str) and isinstance(port, str):
        i = next((i for i, (a, b) in enumerate(zip(ref, port)) if a != b),
                 min(len(ref), len(port)))
        return f"{path}@{i}: {ref[i - 80:i + 120]!r} != {port[i - 80:i + 120]!r}"
    return f"{path}: {ref!r} != {port!r}"


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def make_driver(side, root, lib=None, client=None, node_uid="nu-1",
                **overrides):
    kube = side("kube")
    client = client or kube.FakeKubeClient()
    try:
        client.get(kube.NODES, "node-a")
    except Exception:
        client.create(kube.NODES, {"metadata": {"name": "node-a",
                                                "uid": node_uid}})
    lib = lib or side("tpulib").FakeChipLib(generation="v5p",
                                            topology="2x2x1")
    # An empty driver root: the reference would also find a libtpu
    # wheel in this host's Python environment, the port does not look.
    (root / "driver").mkdir(exist_ok=True)
    kwargs = dict(
        node_name="node-a", chiplib=lib, kube_client=client,
        cdi_root=str(root / "cdi"), plugin_root=str(root / "s"),
        registrar_root=str(root / "g"),
        state_root=str(root / "state"), node_uid=node_uid,
        driver_root=str(root / "driver"),
        driver_root_ctr_path=str(root / "driver"))
    kwargs.update(overrides)
    d = side("plugin.driver")
    return d.Driver(d.DriverConfig(**kwargs)), client, lib


def make_state(side, root, lib=None):
    lib = lib or side("tpulib").FakeChipLib(generation="v5p",
                                            topology="2x2x1")
    (root / "driver").mkdir(exist_ok=True)
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


def add_claim(side, client, uid, devices, name="claim-1",
              namespace="default", request_per_device=False, config=()):
    results = [
        {"request": f"req-{i}" if request_per_device else "req-0",
         "driver": DRIVER, "pool": "node-a", "device": d}
        for i, d in enumerate(devices)]
    claim = {
        "apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": namespace, "uid": uid},
        "spec": {"devices": {"requests": [
            {"name": r, "deviceClassName": DRIVER}
            for r in sorted({r["request"] for r in results})]}},
        "status": {"allocation": {"devices": {
            "results": results, "config": list(config)}}},
    }
    if client is not None:
        client.create(side("kube").RESOURCE_CLAIMS, claim,
                      namespace=namespace)
    return claim


def make_claim(uid, devices, name="c", namespace="default"):
    """test_chaos.make_claim: one request per device."""
    return add_claim(None, None, uid, devices, name=name,
                     namespace=namespace, request_per_device=True)


def as_dict(msg):
    return json_format.MessageToDict(msg, preserving_proto_field_name=True)


def proto_claims(*triples):
    return [drapb.Claim(uid=u, name=n, namespace=ns) for u, n, ns in triples]


def kubelet_prepare(config, claims, service=DRA_SERVICE_NAME):
    with grpc.insecure_channel(f"unix://{config.plugin_socket}") as ch:
        return NodeStub(ch, service_name=service).NodePrepareResources(
            drapb.NodePrepareResourcesRequest(claims=claims))


def kubelet_unprepare(config, claims, service=DRA_SERVICE_NAME):
    with grpc.insecure_channel(f"unix://{config.plugin_socket}") as ch:
        return NodeStub(ch, service_name=service).NodeUnprepareResources(
            drapb.NodeUnprepareResourcesRequest(claims=claims))


def prepare_via_rpc(side, driver, claim):
    """test_chaos.prepare_via_rpc: the servicer called in process, with
    the package's own messages."""
    pb = side("kube.protos.dra_v1alpha4" if side is PORT
              else "kube.protos.dra_v1alpha4_pb2")
    md = claim["metadata"]
    resp = driver.NodePrepareResources(pb.NodePrepareResourcesRequest(
        claims=[pb.Claim(uid=md["uid"], name=md["name"],
                         namespace=md["namespace"])]), None)
    result = resp.claims[md["uid"]]
    return dict(error=result.error,
                devices=[d.device_name for d in result.devices])


def event_list(side, client):
    return sorted(
        (e["type"], e["reason"], e["involvedObject"]["name"],
         e["involvedObject"]["uid"], e["message"], e["count"])
        for e in client.list(side("kube").EVENTS))


def slice_names(side, client):
    return sorted(d["name"] for s in client.list(side("kube").RESOURCE_SLICES)
                  for d in s["spec"].get("devices") or [])


def files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            if p.endswith(".sock") or not os.path.isfile(p):
                continue
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read().decode(
                    "utf-8", "replace")
    return dict(sorted(out.items()))


def checkpoint_doc(state):
    return masked(json.loads(json.dumps(state.checkpoint.read())))


def run_audit(side, state):
    return [(f.check, f.subject) for f in
            side("plugin.audit").StateAuditor(
                state=state, registry=side("utils.metrics").Registry(),
                node_name="node-a").run_once()]


def clean(side, state):
    side("plugin.cleanup").OrphanCleaner(
        state, kube_client=None, interval_seconds=0).clean_once()


def chip_uuid_of(state, device_name):
    dev = state.allocatable[device_name]
    return (dev.chip or dev.tensorcore.parent).uuid


def assert_invariants(state):
    """test_chaos.assert_invariants: I1-I4."""
    ckpt = state.checkpoint.read()
    orphans = set(state.cdi.list_claim_spec_uids()) - set(ckpt)
    assert not orphans, f"orphaned CDI specs: {orphans}"
    seen_channels: dict = {}
    for uid, rec in ckpt.items():
        for group in rec.get("groups", []):
            for dev in group.get("devices", []):
                ch = dev.get("channel")
                if ch is not None:
                    assert seen_channels.setdefault(ch, uid) == uid
    for uid, rec in ckpt.items():
        prepared_at = rec.get("preparedAt", 0.0)
        for group in rec.get("groups", []):
            for dev in group.get("devices", []):
                for u in dev.get("uuids", []):
                    st = state.chip_health.get(u.split("-core-")[0])
                    if st is not None and not st.is_healthy():
                        assert st.since >= prepared_at


# -- test_plugin_grpc.py ------------------------------------------------------


def registration(side, root, versions):
    extra = {} if versions is None else {"registration_versions": versions}
    driver, _, _ = make_driver(side, root, node_uid="node-uid-1", **extra)
    driver.start()
    config = driver.config
    try:
        with grpc.insecure_channel(f"unix://{config.registrar_socket}") as ch:
            stub = RegistrationStub(ch)
            info = stub.GetInfo(regpb.InfoRequest())
            assert info.type == "DRAPlugin" and info.name == DRIVER
            assert info.endpoint == config.plugin_socket
            stub.NotifyRegistrationStatus(
                regpb.RegistrationStatus(plugin_registered=True))
        assert driver.plugin.registration_status() == {
            "pluginRegistered": True, "error": ""}
        return as_dict(info), driver.plugin.registration_status()
    finally:
        driver.shutdown()


@pytest.mark.parametrize("versions", [None, ("v1beta1.DRAPlugin",)],
                         ids=["1.0.0", "v1beta1"])
def test_get_info_and_notify(tmp_path, versions):
    info, _ = both(registration, tmp_path, versions)
    assert info["supported_versions"] == list(versions or ["1.0.0"])


def prepare_roundtrip(side, root, service):
    driver, client, _ = make_driver(side, root)
    driver.start()
    config = driver.config
    try:
        add_claim(side, client, "uid-1", ["tpu-0", "tpu-1"])
        claims = proto_claims(("uid-1", "claim-1", "default"))
        resp = kubelet_prepare(config, claims, service)
        result = resp.claims["uid-1"]
        assert result.error == "" and len(result.devices) == 2
        assert result.devices[0].cdi_device_ids[0].startswith(
            "k8s.tpu.google.com/chip=")
        on_disk = files(root / "cdi")
        ckpt = checkpoint_doc(driver.state)
        uresp = kubelet_unprepare(config, claims, service)
        assert uresp.claims["uid-1"].error == ""
        assert driver.state.checkpoint.read() == {}
        return as_dict(resp), as_dict(uresp), on_disk, ckpt
    finally:
        driver.shutdown()


@pytest.mark.parametrize("service", [DRA_SERVICE_NAME,
                                     DRA_SERVICE_NAME_V1BETA1])
def test_prepare_unprepare_roundtrip(tmp_path, service):
    both(prepare_roundtrip, tmp_path, service)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(re.sub(r"[\d.]+ms", "<ms>", record.getMessage()))


def rpc_call_logging(side, root):
    driver, client, _ = make_driver(side, root)
    driver.start()
    logger = logging.getLogger(f"{side.root}.plugin.grpc_services")
    cap, old = _Lines(), logger.level
    logger.addHandler(cap)
    logger.setLevel(logging.DEBUG)
    try:
        add_claim(side, client, "uid-log", ["tpu-0"], name="logged")
        claims = proto_claims(("uid-log", "logged", "default"))
        kubelet_prepare(driver.config, claims)
        kubelet_unprepare(driver.config, claims)
    finally:
        logger.removeHandler(cap)
        logger.setLevel(old)
        driver.shutdown()
    assert any("NodePrepareResources called: claims=uid-log" in m
               for m in cap.lines)
    assert any("NodeUnprepareResources succeeded in" in m for m in cap.lines)
    return cap.lines


def error_isolation(side, root):
    driver, client, _ = make_driver(side, root)
    driver.start()
    try:
        add_claim(side, client, "uid-good", ["tpu-0"], name="good")
        add_claim(side, client, "uid-bad", ["tpu-404"], name="bad")
        add_claim(side, client, "uid-new", ["tpu-1"], name="claim-x")
        resp = kubelet_prepare(driver.config, proto_claims(
            ("uid-good", "good", "default"), ("uid-bad", "bad", "default"),
            ("uid-missing", "ghost", "default"),
            ("uid-old", "claim-x", "default")))
    finally:
        driver.shutdown()
    assert resp.claims["uid-good"].error == ""
    assert "not allocatable" in resp.claims["uid-bad"].error
    assert "uid-missing" in resp.claims["uid-missing"].error
    assert "UID mismatch" in resp.claims["uid-old"].error
    return as_dict(resp), event_list(side, client)


def channel_launch_env(side, root):
    lib = side("tpulib").FakeChipLib(
        generation="v5p", topology="2x2x1", hosts_per_slice=2,
        chips_per_host=2, hostnames=["w0.internal", "w1.internal"])
    driver, client, _ = make_driver(side, root, lib=lib)
    driver.start()
    try:
        claim = add_claim(side, None, "uid-ch", ["tpu-0", "ici-channel-5"],
                          name="gang", config=[{
                              "source": "FromClaim", "requests": ["req-0"],
                              "opaque": {"driver": DRIVER, "parameters": {
                                  "apiVersion": "tpu.google.com/v1alpha1",
                                  "kind": "IciChannelConfig"}}}])
        claim["spec"]["devices"]["requests"][0]["deviceClassName"] = \
            "ici.tpu.google.com"
        client.create(side("kube").RESOURCE_CLAIMS, claim,
                      namespace="default")
        resp = kubelet_prepare(driver.config,
                               proto_claims(("uid-ch", "gang", "default")))
        assert resp.claims["uid-ch"].error == ""
        spec = json.loads(
            (root / "cdi" / "k8s.tpu.google.com-claim_uid-ch.json")
            .read_text())
        env = dict(kv.partition("=")[::2]
                   for kv in spec["containerEdits"]["env"])
        assert env["TPU_DRA_COORDINATOR"] == "w0.internal:9105"
        return as_dict(resp), spec
    finally:
        driver.shutdown()


def slices_on_start(side, root):
    driver, client, _ = make_driver(side, root, node_uid="node-uid-1")
    driver.start()
    try:
        kube = side("kube")
        assert wait_for(lambda: client.list(kube.RESOURCE_SLICES), 5)
        slices = client.list(kube.RESOURCE_SLICES)
        assert len(slices) == 1
        spec = slices[0]["spec"]
        assert spec["nodeName"] == "node-a" and len(spec["devices"]) == 12
        assert slices[0]["metadata"]["ownerReferences"][0]["uid"] == \
            "node-uid-1"
        return spec, slices[0]["metadata"]["ownerReferences"]
    finally:
        driver.shutdown()


@pytest.mark.parametrize("scenario", [
    rpc_call_logging, error_isolation, channel_launch_env, slices_on_start,
], ids=lambda f: f.__name__)
def test_grpc_scenarios(tmp_path, monkeypatch, scenario):
    monkeypatch.setenv("TPU_DRA_COORDINATOR_BASE_PORT", "9100")
    both(scenario, tmp_path)


# -- test_device_watch.py -----------------------------------------------------


def refresh_allocatable(side, root):
    lib = side("tpulib").FakeChipLib(generation="v5e", topology="2x2x1")
    driver, _, _ = make_driver(side, root, lib=lib,
                               device_watch_interval_seconds=0)
    state = driver.state
    assert state.refresh_allocatable() is False
    state.prepare(make_claim("uid-k", ["tpu-3"]))
    lib.chips_per_host = 2          # tpu-2/tpu-3 vanish mid-rebind
    assert state.refresh_allocatable() is True

    def base_names():
        base = json.loads(
            (root / "cdi" / "k8s.tpu.google.com-base.json").read_text())
        return sorted(d["name"] for d in base["devices"])

    seen = [base_names(), sorted(state.allocatable),
            sorted(d["name"] for d in state.published_resources()["devices"])]
    assert "tpu-3" in seen[0] and "tpu-2" not in seen[0]
    lib.chips_per_host = 1
    assert state.refresh_allocatable() is True
    seen.append(base_names())
    state.unprepare("uid-k")
    lib.chips_per_host = 2
    assert state.refresh_allocatable() is True
    assert "tpu-3" not in base_names()
    return seen + [base_names()]


def fake_host_ids(side, root):
    main = side("plugin.main")
    kube = side("kube")
    client = kube.FakeKubeClient()
    for i, name in enumerate(["worker-0", "worker-1"]):
        client.create(kube.NODES, {"metadata": {
            "name": name, "uid": f"u-{i}",
            "labels": {main.FAKE_HOST_ID_LABEL: str(i)}}})
    client.create(kube.NODES, {"metadata": {"name": "plain", "uid": "u-p"}})
    ids = [main.lookup_fake_host_id(main.fetch_node(client, n), n)
           for n in ("worker-0", "worker-1", "plain", "ghost")]
    assert ids == [0, 1, 0, 0]
    args = argparse.Namespace(fake_topology="2x2x1", fake_generation="v5e",
                              fake_hosts=2, sysfs_root="/sys")
    coords = {}
    for host in (0, 1):
        lib = main.make_chiplib(args, "/", fake_host_id=host)
        coords[host] = sorted(str(c.coord) for c in lib.enumerate_chips())
    assert not set(coords[0]) & set(coords[1])
    return ids, coords


def no_kube_multi_host(side, root):
    main = side("plugin.main")
    logger = logging.getLogger(main.__name__)
    cap = _Lines()
    logger.addHandler(cap)
    try:
        assert main.lookup_fake_host_id(None, "w-1", fake_hosts=2) == 0
        loud = list(cap.lines)
        cap.lines.clear()
        assert main.lookup_fake_host_id(None, "w-1", fake_hosts=1) == 0
    finally:
        logger.removeHandler(cap)
    assert any("fake-hosts" in m for m in loud) and not cap.lines
    rc = main.main(["--node-name", "n", "--no-kube",
                    "--fake-topology", "2x2x1", "--fake-hosts", "3"])
    assert rc == 2
    return loud, rc


def hotplug_republishes(side, root):
    lib = side("tpulib").FakeChipLib(generation="v5e", topology="2x2x1")
    driver, client, _ = make_driver(side, root, lib=lib,
                                    device_watch_interval_seconds=0.1)
    driver.start()
    try:
        assert wait_for(lambda: len(slice_names(side, client)) == 4)
        first = slice_names(side, client)
        lib.chips_per_host = 2
        lib.device_event.set()
        assert wait_for(lambda: len(slice_names(side, client)) == 2)
        refreshes = driver._m_inventory_refreshes.value()
    finally:
        t0 = time.monotonic()
        driver.shutdown()
        assert time.monotonic() - t0 < 2, "watch thread stalled shutdown"
    return first, slice_names(side, client), refreshes


@pytest.mark.parametrize("scenario", [
    refresh_allocatable, fake_host_ids, no_kube_multi_host,
    hotplug_republishes,
], ids=lambda f: f.__name__)
def test_device_watch(tmp_path, scenario):
    both(scenario, tmp_path)


# -- test_tracing.py (the Driver's cases) -------------------------------------


def trace_shape(trace):
    """A trace's spans as (name, parent's name, tags, status)."""
    names = {s["spanId"]: s["name"] for s in trace["spans"]}
    return sorted((s["name"], names.get(s["parentId"]), s["tags"],
                   s["status"]) for s in trace["spans"])


def nested_trace(side, root):
    client = side("kube").FakeKubeClient()
    driver, client, _ = make_driver(side, root, client=client,
                                    node_uid="node-uid-1")
    driver.start()
    records = []
    fmt = side("utils.logging").JsonFormatter()

    class Capture(logging.Handler):
        def emit(self, record):
            records.append(json.loads(fmt.format(record)))

    cap = Capture(level=logging.DEBUG)
    logger = logging.getLogger(f"{side.root}.plugin.driver")
    old = logger.level
    logger.addHandler(cap)
    logger.setLevel(logging.DEBUG)
    try:
        add_claim(side, client, "uid-trace", ["tpu-0", "tpu-1"])
        claims = proto_claims(("uid-trace", "claim-1", "default"))
        for _ in range(2):          # the second is idempotent
            assert kubelet_prepare(driver.config, claims).claims[
                "uid-trace"].error == ""
    finally:
        logger.removeHandler(cap)
        logger.setLevel(old)
        driver.shutdown()
    full = [tr for tr in driver.tracer.traces()
            if tr["claimUid"] == "uid-trace"
            and any(s["name"] == "cdi-render" for s in tr["spans"])]
    assert len(full) == 1
    by_name = {s["name"]: s for s in full[0]["spans"]}
    assert by_name["prepare"]["parentId"] == \
        by_name["rpc/NodePrepareResources"]["spanId"]
    assert by_name["rpc/NodePrepareResources"]["tags"]["service"] == \
        "v1alpha3.Node"
    text = driver.registry.render()
    assert 'tpu_dra_claim_prepare_attempts_total{result="ok"} 2' in text
    assert driver.events.flush()
    tagged = [r["claimUid"] for r in records if "claimUid" in r]
    assert "uid-trace" in tagged
    return ([trace_shape(t) for t in driver.tracer.traces()],
            exposition(driver.registry, "tpu_dra_claim_"),
            event_list(side, client), sorted(set(tagged)))


def failure_warning_event(side, root):
    driver, client, _ = make_driver(side, root)
    driver.start()
    try:
        add_claim(side, client, "uid-bad", ["tpu-404"], name="bad")
        for _ in range(3):          # kubelet retry storm
            resp = kubelet_prepare(driver.config,
                                   proto_claims(("uid-bad", "bad", "default")))
            assert "not allocatable" in resp.claims["uid-bad"].error
        assert driver.events.flush()
    finally:
        driver.shutdown()
    warnings = [e for e in event_list(side, client) if e[1] == "PrepareFailed"]
    assert len(warnings) == 1 and warnings[0][5] == 3
    trace = driver.tracer.find_trace("uid-bad")
    assert trace["status"] == "error"
    return warnings, trace_shape(trace), as_dict(resp)


def debug_routes(side, root):
    metrics = side("utils.metrics")
    driver, _, _ = make_driver(side, root, node_uid="node-uid-1")
    driver.start()
    srv = metrics.MetricsServer(driver.registry, host="127.0.0.1", port=0,
                                tracer=driver.tracer)
    for name, check in driver.readiness_checks().items():
        srv.add_readiness_check(name, check)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        codes = [urllib.request.urlopen(base + r).status for r in
                 ("/metrics", "/healthz", "/readyz", "/debug/traces")]
        ready = urllib.request.urlopen(base + "/readyz").read().decode()
        assert "[+] grpc-serving" in ready and ready.strip().endswith("ready")
        driver.shutdown()           # the services down: readiness flips
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/readyz")
        assert ei.value.code == 503
        after = ei.value.read().decode()
        assert "[-] grpc-serving" in after
    finally:
        srv.stop()
    # The grpc-serving check's detail names the transport: the lines
    # other than that detail must be the reference's.
    return codes, [ln.split(":")[0] for ln in ready.splitlines()], \
        [ln.split(":")[0] for ln in after.splitlines()]


@pytest.mark.parametrize("scenario", [
    nested_trace, failure_warning_event, debug_routes,
], ids=lambda f: f.__name__)
def test_tracing(tmp_path, scenario):
    both(scenario, tmp_path)


# -- test_chaos.py: unplug, blackout, crash/restart, health, the oracle ------


def unplug_mid_prepare(side, root):
    faults = side("utils.faults")
    ds = side("plugin.device_state")
    state, lib = make_state(side, root)
    uuid1 = chip_uuid_of(state, "tpu-1")
    plan = faults.FaultPlan()
    plan.call("checkpoint.write", lambda: lib.unplug_chip(1))
    with faults.armed(plan):
        devices = state.prepare(make_claim("uid-mid", ["tpu-1"]))
    assert state.refresh_allocatable() is True
    transitions = state.drain_health_transitions()
    assert any(u == uuid1 and s.is_gone() for u, _, s in transitions)
    with pytest.raises(ds.PrepareError):
        state.prepare(make_claim("uid-new", ["tpu-1"], name="c2"))
    assert_invariants(state)
    audit = run_audit(side, state)
    state.unprepare("uid-mid")
    assert state.checkpoint.read() == {}
    return [d.device_name for d in devices], audit


def wedged_chip_refused(side, root):
    ds = side("plugin.device_state")
    state, lib = make_state(side, root)
    lib.wedge_chip(0, reason="hbm uncorrectable errors")
    assert state.refresh_allocatable() is True
    dev = next(d for d in state.published_resources()["devices"]
               if d["name"] == "tpu-0")
    assert dev["basic"]["attributes"]["healthy"]["bool"] is False
    errors = []
    for uid, names in (("uid-w", ["tpu-0"]), ("uid-w2", ["tpu-0-core-0"])):
        with pytest.raises(ds.UnhealthyDeviceError) as ei:
            state.prepare(make_claim(uid, names, name=uid))
        errors.append(str(ei.value))
    state.prepare(make_claim("uid-ok", ["tpu-1"], name="c4"))
    assert_invariants(state)
    return errors, checkpoint_doc(state)


def blackout(side, root):
    kube = side("kube")
    driver, client, lib = make_driver(side, root, cleanup_interval_seconds=0,
                                      device_watch_interval_seconds=0.05)
    driver.start()
    seen = []
    try:
        claim = make_claim("uid-bo", ["tpu-0"])
        client.create(kube.RESOURCE_CLAIMS, claim, namespace="default")
        seen.append(prepare_via_rpc(side, driver, claim))
        client.fault_injector = lambda verb, gvr, name: kube.ApiError(
            "apiserver blackout", code=503)
        seen.append(prepare_via_rpc(side, driver, claim))
        assert seen[-1]["error"] == ""
        assert driver._m_degraded_prepares.value() == 1
        ok, detail = driver._check_apiserver()
        assert not ok and "blackout" in detail
        assert all(c()[0] for c in driver.readiness_checks().values())
        seen.append(prepare_via_rpc(side, driver,
                                    make_claim("uid-bo2", ["tpu-1"], "c2")))
        assert seen[-1]["error"] != ""
        lib.unplug_chip(1)
        assert wait_for(lambda: "tpu-1" not in driver.state.allocatable)
        client.fault_injector = None
        assert wait_for(lambda: "tpu-1" not in slice_names(side, client))
        seen.append(prepare_via_rpc(side, driver, claim))
        assert wait_for(lambda: driver._check_apiserver()[0])
        assert_invariants(driver.state)
    finally:
        client.fault_injector = None
        driver.shutdown()
    return seen, slice_names(side, client)


def crash_before_checkpoint(side, root):
    faults = side("utils.faults")
    state, lib = make_state(side, root)
    with faults.armed(faults.FaultPlan().crash("checkpoint.write")):
        with pytest.raises(faults.CrashPoint):
            state.prepare(make_claim("uid-crash", ["tpu-0"]))
    restarted, _ = make_state(side, root)
    assert restarted.checkpoint.read() == {}
    assert restarted.cdi.list_claim_spec_uids() == ["uid-crash"]
    findings = run_audit(side, restarted)
    assert sorted(findings) == sorted([
        ("cdi", "uid-crash"), ("sharing", chip_uuid_of(restarted, "tpu-0"))])
    clean(side, restarted)
    assert_invariants(restarted)
    assert run_audit(side, restarted) == []
    devices = restarted.prepare(make_claim("uid-after", ["tpu-0"]))
    return findings, [d.device_name for d in devices]


def corrupt_checkpoint(side, root):
    state, _ = make_state(side, root)
    state.prepare(make_claim("uid-c", ["tpu-0"]))
    path = root / "checkpoint.json"
    path.write_text(path.read_text()[: len(path.read_text()) // 2])
    restarted, _ = make_state(side, root)
    assert restarted.checkpoint.read() == {}
    assert (root / "checkpoint.json.corrupt").exists()
    found = run_audit(side, restarted)
    assert ("cdi", "uid-c") in found
    clean(side, restarted)
    assert_invariants(restarted)
    assert run_audit(side, restarted) == []
    return sorted(found)


def health_end_to_end(side, root):
    kube = side("kube")
    driver, client, lib = make_driver(side, root, cleanup_interval_seconds=0,
                                      device_watch_interval_seconds=0.05)
    driver.start()
    try:
        assert wait_for(lambda: "tpu-0" in slice_names(side, client))
        claim = make_claim("uid-e2e", ["tpu-0"], name="workload")
        client.create(kube.RESOURCE_CLAIMS, claim, namespace="default")
        assert prepare_via_rpc(side, driver, claim)["error"] == ""
        lib.unplug_chip(0, reason="pcie link down")
        assert wait_for(lambda: "tpu-0-core-0" not in slice_names(side,
                                                                  client))
        gone = slice_names(side, client)
        driver.events.flush()
        assert wait_for(lambda: any(e[1] == "ChipUnhealthy"
                                    for e in event_list(side, client)))
        lib.restore_chip(0)
        assert wait_for(lambda: "tpu-0" in slice_names(side, client))
        driver.events.flush()
        assert wait_for(lambda: any(e[1] == "ChipRecovered"
                                    for e in event_list(side, client)))
        assert_invariants(driver.state)
        return (gone, event_list(side, client),
                driver._m_health_transitions.value(from_state="healthy",
                                                   to="gone"),
                driver._m_health_transitions.value(from_state="gone",
                                                   to="healthy"))
    finally:
        driver.shutdown()


def flap_schedule(side, root):
    state, lib = make_state(side, root)
    lib.set_flap(1, period=2)
    present = []
    for _ in range(8):
        state.refresh_allocatable()
        present.append("tpu-1" in state.allocatable)
    assert present == [False, False, True, True, False, False, True, True]
    return present, [(old, s.state) for _, old, s
                     in state.drain_health_transitions()]


@pytest.mark.parametrize("scenario", [
    unplug_mid_prepare, wedged_chip_refused, blackout,
    crash_before_checkpoint, corrupt_checkpoint, health_end_to_end,
    flap_schedule,
], ids=lambda f: f.__name__)
def test_chaos(tmp_path, scenario):
    both(scenario, tmp_path)


# -- test_chaos.py: elastic gang resize --------------------------------------


def elastic_driver(side, root):
    lib = side("tpulib").FakeChipLib(generation="v5p", topology="4x1x1")
    driver, client, lib = make_driver(side, root, lib=lib,
                                      cleanup_interval_seconds=0,
                                      device_watch_interval_seconds=0.05)
    allocator = side("kube.allocator").ReferenceAllocator(
        client, registry=side("utils.metrics").Registry())
    driver.enable_elastic(allocator)
    driver.publish_resources()
    assert wait_for(lambda: client.list(side("kube").RESOURCE_SLICES))
    return driver, client, lib, allocator


def gang_claim(side, client, allocator, uid, name, count):
    claim = {
        "apiVersion": "resource.k8s.io/v1beta1", "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": "default", "uid": uid},
        "spec": {"devices": {"requests": [{
            "name": "workers", "deviceClassName": DRIVER,
            "allocationMode": "ExactCount", "count": count}]}},
    }
    allocator.allocate(claim, node_name="node-a")
    client.create(side("kube").RESOURCE_CLAIMS, claim, namespace="default")
    return claim, [r["device"] for r in
                   claim["status"]["allocation"]["devices"]["results"]]


def no_survivors(side, root):
    driver, client, lib, allocator = elastic_driver(side, root)
    try:
        claim, names = gang_claim(side, client, allocator, "uid-all",
                                  "doomed", 2)
        assert prepare_via_rpc(side, driver, claim)["error"] == ""
        for n in names:
            lib.unplug_chip(int(n.split("-")[1]), reason="rack power")
        driver.state.refresh_allocatable()
        driver._maybe_elastic_resize(driver.state.drain_health_transitions())
        driver.events.flush()
        view = driver.state.gang_view("uid-all")
        assert [n for n, _ in view["devices"]] == names
        return (names, exposition(driver.registry, "tpu_dra_elastic_"),
                [e for e in event_list(side, client)
                 if e[1] == "GangResizeFailed"])
    finally:
        driver.shutdown()


def failed_resize_restores(side, root):
    driver, client, lib, allocator = elastic_driver(side, root)
    al = side("kube.allocator")
    try:
        claim, names = gang_claim(side, client, allocator, "uid-res", "res", 2)
        assert prepare_via_rpc(side, driver, claim)["error"] == ""
        keys = {("node-a", n) for n in names}

        def unsat(*a, **k):
            raise al.AllocationError("forced unsat", reason="shortfall")

        allocator.allocate = unsat
        lib.unplug_chip(int(names[1].split("-")[1]), reason="dead")
        driver.state.refresh_allocatable()
        driver._maybe_elastic_resize(driver.state.drain_health_transitions())
        assert all(allocator._reservations.get(k) == "uid-res" for k in keys)
        view = driver.state.gang_view("uid-res")
        assert [n for n, _ in view["devices"]] == names
        return names, exposition(driver.registry, "tpu_dra_elastic_")
    finally:
        driver.shutdown()


def shrink_and_grow(side, root):
    """The elastic coordinator's shrink and grow, each re-solved once the
    republished slice shows the transition, with the resize trace and
    its listener; then a quiet ``tick_once`` (the fleet soak's drive)."""
    driver, client, lib, allocator = elastic_driver(side, root)
    messages = []
    driver.add_resize_listener(lambda m: messages.append(m.to_dict()))

    def transition(change, want):
        change()
        driver.state.refresh_allocatable()
        driver.publish_resources()
        assert wait_for(lambda: ("tpu-3" in slice_names(side, client))
                        == want)
        driver._maybe_elastic_resize(driver.state.drain_health_transitions())

    try:
        claim, names = gang_claim(side, client, allocator, "uid-g", "train", 4)
        assert prepare_via_rpc(side, driver, claim)["error"] == ""
        transition(lambda: lib.unplug_chip(3, reason="chaos"), False)
        transition(lambda: lib.restore_chip(3), True)
        quiet = driver.tick_once(now=1000.0)
        driver.events.flush()
        assert [m["direction"] for m in messages] == ["shrink", "grow"]
        return (quiet, masked(driver.resize_trace()),
                exposition(driver.registry, "tpu_dra_elastic_"),
                event_list(side, client), run_audit(side, driver.state))
    finally:
        driver.shutdown()


def device_class_from_types(side, root):
    driver, client, lib, allocator = elastic_driver(side, root)
    try:
        driver.state.prepare(make_claim("uid-tc",
                                        ["tpu-0-core-0", "tpu-1-core-0"]))
        view = driver.state.gang_view("uid-tc")
        driver.state.prepare(make_claim("uid-mix", ["tpu-2", "tpu-3-core-0"],
                                        name="mix"))
        mixed = driver.state.gang_view("uid-mix")
        classes = [driver._elastic_device_class(view),
                   driver._elastic_device_class(mixed)]
        assert classes == ["tensorcore.tpu.google.com", None]
        return view["device_types"], sorted(mixed["device_types"]), classes
    finally:
        driver.shutdown()


@pytest.mark.parametrize("scenario", [
    no_survivors, failed_resize_restores, shrink_and_grow,
    device_class_from_types,
], ids=lambda f: f.__name__)
def test_elastic(tmp_path, scenario):
    both(scenario, tmp_path)


@pytest.mark.parametrize("victim", [0, 3])
def test_watch_tick_resolves_against_the_republished_slice(tmp_path,
                                                           monkeypatch,
                                                           victim):
    """The port's watch tick lands its republish before the elastic
    re-solve reads the slice. The slice controller's thread never runs
    here, as on a host where it has not been scheduled yet: the unplug
    still shrinks the gang to the three live chips, and the restore grows
    it back to four (re-solving against the slice as it was, the grow
    found "only 3 of 4")."""
    monkeypatch.setattr(PORT("kube.resourceslice").ResourceSliceController,
                        "start", lambda self: None)
    lib = PORT("tpulib").FakeChipLib(generation="v5p", topology="4x1x1")
    driver, client, lib = make_driver(PORT, tmp_path, lib=lib,
                                      cleanup_interval_seconds=0,
                                      device_watch_interval_seconds=0)
    allocator = PORT("kube.allocator").ReferenceAllocator(
        client, registry=PORT("utils.metrics").Registry())
    driver.enable_elastic(allocator)
    driver.publish_resources()
    driver.plugin.sync_slices()
    resizes = []
    driver.add_resize_listener(resizes.append)
    try:
        claim, names = gang_claim(PORT, client, allocator, "uid-gang",
                                  "train", 4)
        assert prepare_via_rpc(PORT, driver, claim)["error"] == ""
        lib.unplug_chip(victim, reason="unplug")
        driver.tick_once()
        assert f"tpu-{victim}" not in slice_names(PORT, client)
        assert [m.direction for m in resizes] == ["shrink"]
        assert resizes[0].removed == (f"tpu-{victim}",)
        assert len(resizes[0].devices) == 3
        lib.restore_chip(victim)
        driver.tick_once()
        assert f"tpu-{victim}" in slice_names(PORT, client)
        assert [m.direction for m in resizes] == ["shrink", "grow"]
        assert sorted(resizes[1].devices) == sorted(names)
        assert driver._m_elastic_resizes.value(direction="grow",
                                               outcome="ok") == 1
    finally:
        driver.shutdown()


# -- test_chaos.py: the elastic trainer riding the gang resizes ---------------
#
# The workload half on the port alone: the reference's trainer compiles a
# program per mesh (it marks two of these slow), its resize decisions are
# held against the port's in test_torch_elastic.py, and the plugin half's
# messages against the reference's in shrink_and_grow above. Each health
# transition is driven as shrink_and_grow drives it: republished, and
# re-solved once the slice shows it. The reference's two slow cases leave
# that to the watch thread, whose grow re-solve reads the slice before the
# republish lands, and fail on the reference itself (ROADMAP C).

CHAOS_SEED = int(os.environ.get("TPU_DRA_CHAOS_SEED", "1234"))
GANG = ["tpu-0", "tpu-1", "tpu-2", "tpu-3"]


@pytest.fixture
def one_torch_thread():
    """The tiny trainer's ops are too small to share among threads: one
    intra-op thread keeps them quick where the suite's workers share the
    cores (test_torch_elastic.one_torch_thread)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_trainer(members, axes, total_steps=10):
    """The port's ElasticTrainer on the tiny preset over CPU members."""
    el = PORT("parallel.elastic")
    return el.ElasticTrainer(
        PORT("models.llama").PRESETS["tiny"],
        PORT("models.train").make_optimizer(warmup_steps=1,
                                            total_steps=total_steps),
        members, mesh_config=PORT("parallel.mesh").MeshConfig(**axes),
        global_batch=8, device_of=dict.fromkeys(GANG, "cpu"))


def share_init(trainer, reference):
    """``reference`` restarted from a copy of ``trainer``'s parameters (the
    port's step updates its state in place, so the runs share nothing)."""
    tr = PORT("models.train")
    params = {k: {kk: vv.detach().clone() for kk, vv in v.items()}
              if isinstance(v, dict) else v.detach().clone()
              for k, v in trainer.state.params.items()}
    reference.state = tr.train_state_from_params(params, reference.optimizer,
                                                 mesh=reference.mesh)


def settle(driver, client, device, present):
    """One health transition through the plugin: refresh, republish, and
    once the slice shows ``device`` as ``present``, the elastic re-solve
    (its messages reach the resize listeners)."""
    driver.state.refresh_allocatable()
    driver.publish_resources()
    assert wait_for(lambda: (device in slice_names(PORT, client))
                    == present)
    driver._maybe_elastic_resize(driver.state.drain_health_transitions())


def tiny_tokens(seed, n):
    import torch

    vocab = PORT("models.llama").PRESETS["tiny"].vocab_size
    return [torch.randint(0, vocab, (8, 65),
                          generator=torch.Generator().manual_seed(seed + i))
            for i in range(n)]


def test_chip_unplug_mid_step_resize_resume_and_grow(tmp_path, one_torch_thread):
    """``TestElasticGangResize::test_chip_unplug_mid_step_resize_resume_and_grow``:
    a seeded unplug at the top of train step 4 shrinks the gang claim,
    the trainer reshards live onto the message's members (2 used, 1
    idled) and its losses follow an uninterrupted run on the surviving
    topology from the same init; then the symmetric grow."""
    import random

    import numpy as np

    faults = PORT("utils.faults")
    driver, client, lib, allocator = elastic_driver(PORT, tmp_path)
    resizes = []
    driver.add_resize_listener(resizes.append)
    try:
        claim, names = gang_claim(PORT, client, allocator, "uid-gang",
                                  "train", 4)
        assert prepare_via_rpc(PORT, driver, claim)["error"] == ""
        trainer = tiny_trainer(GANG, dict(data=2, tensor=2))
        reference = tiny_trainer(GANG[:2], dict(tensor=2))
        share_init(trainer, reference)
        toks = tiny_tokens(100, 7)
        ref_losses = [reference.step(t) for t in toks]

        victim = random.Random(CHAOS_SEED).randrange(4)
        plan = faults.FaultPlan()
        plan.call("train.step",
                  lambda: lib.unplug_chip(victim, reason="chaos unplug"),
                  on_calls={4})
        with faults.armed(plan):
            losses = [trainer.step(t) for t in toks[:4]]
        settle(driver, client, f"tpu-{victim}", False)
        assert len(resizes) == 1
        msg = resizes[0]
        assert msg.direction == "shrink" and msg.claim_uid == "uid-gang"
        assert f"tpu-{victim}" in msg.removed
        assert f"tpu-{victim}" not in msg.devices
        assert msg.desired == 4 and msg.generation == 1
        view = driver.state.gang_view("uid-gang")
        assert tuple(n for n, _ in view["devices"]) == msg.devices
        for d in driver.state.cached_devices("uid-gang"):
            assert d.request_names == ["workers"]

        event = trainer.resize(list(msg.devices), reason=msg.reason)
        assert event.path == "live", "the hot path must not touch the " \
            "checkpoint"
        assert event.n_used == 2
        assert event.n_used + event.n_idled == len(msg.devices)
        losses += [trainer.step(t) for t in toks[4:]]
        np.testing.assert_allclose(losses, ref_losses, rtol=2e-4, atol=2e-4)
        assert wait_for(lambda: driver.auditor.run_once() == [])
        assert driver._m_elastic_resizes.value(direction="shrink",
                                               outcome="ok") == 1

        lib.restore_chip(victim)
        settle(driver, client, f"tpu-{victim}", True)
        assert len(resizes) == 2
        grow = resizes[1]
        assert grow.direction == "grow" and grow.generation == 2
        assert set(grow.devices) == set(GANG)
        event = trainer.resize(list(grow.devices), reason=grow.reason)
        assert event.path == "live" and event.n_used == 4
        assert all(np.isfinite(trainer.step(t)) for t in toks)
        assert wait_for(lambda: driver.auditor.run_once() == [])
        assert driver._m_elastic_resizes.value(direction="grow",
                                               outcome="ok") == 1
        driver.events.flush()
        assert any(ev["reason"] == "GangResized"
                   and ev["involvedObject"]["name"] == "train"
                   for ev in client.list(PORT("kube").EVENTS))
        assert [r["direction"] for r in driver.resize_trace()] == [
            "shrink", "grow"]
        assert_invariants(driver.state)
    finally:
        driver.shutdown()


def test_shrink_grow_soak(tmp_path, one_torch_thread):
    """``TestElasticGangResize::test_shrink_grow_soak``: 4 seeded
    unplug/restore rounds with the trainer riding every resize; the
    auditor reads clean and the loss stays finite after each round."""
    import random

    import numpy as np

    rng = random.Random(CHAOS_SEED)
    driver, client, lib, allocator = elastic_driver(PORT, tmp_path)
    resizes = []
    driver.add_resize_listener(resizes.append)
    try:
        claim, _ = gang_claim(PORT, client, allocator, "uid-soak", "soak", 4)
        assert prepare_via_rpc(PORT, driver, claim)["error"] == ""
        trainer = tiny_trainer(GANG, dict(data=2, tensor=2), total_steps=100)
        toks = iter(tiny_tokens(0, 8))
        paths = []
        for round_no in range(4):
            victim = rng.randrange(4)
            seen = len(resizes)
            lib.unplug_chip(victim, reason=f"soak round {round_no}")
            settle(driver, client, f"tpu-{victim}", False)
            assert len(resizes) == seen + 1
            paths.append(trainer.resize(list(resizes[-1].devices),
                                        reason=resizes[-1].reason).path)
            for _ in range(2):
                loss = trainer.step(next(toks))
            assert np.isfinite(loss)
            seen = len(resizes)
            lib.restore_chip(victim)
            settle(driver, client, f"tpu-{victim}", True)
            assert len(resizes) == seen + 1
            event = trainer.resize(list(resizes[-1].devices),
                                   reason=resizes[-1].reason)
            paths.append(event.path)
            assert event.n_used == 4 and trainer.step_count == 2 * (
                round_no + 1)
            assert wait_for(lambda: driver.auditor.run_once() == [],
                            timeout=15)
        assert paths == ["live"] * 8
        assert_invariants(driver.state)
    finally:
        driver.shutdown()


def resize_results(names):
    return [{"request": "gang", "driver": DRIVER, "pool": "node-a",
             "device": n} for n in names]


def state_4x1(side, root):
    return make_state(side, root, side("tpulib").FakeChipLib(
        generation="v5p", topology="4x1x1"))


def elastic_crash_before_intent(side, root):
    faults = side("utils.faults")
    state, lib = state_4x1(side, root)
    state.prepare(make_claim("uid-r", ["tpu-0", "tpu-1", "tpu-2"]))
    with faults.armed(faults.FaultPlan().crash("checkpoint.write")):
        with pytest.raises(faults.CrashPoint):
            state.resize_claim("uid-r", resize_results(["tpu-0", "tpu-1"]))
    restarted, _ = make_state(side, root, lib)
    assert run_audit(side, restarted) == []
    assert_invariants(restarted)
    return [n for n, _ in restarted.gang_view("uid-r")["devices"]]


def elastic_rolls_forward(side, root):
    faults = side("utils.faults")
    state, lib = state_4x1(side, root)
    state.prepare(make_claim("uid-r2", ["tpu-0", "tpu-1", "tpu-2"]))
    with faults.armed(faults.FaultPlan().crash("checkpoint.write",
                                               on_call=2)):
        with pytest.raises(faults.CrashPoint):
            state.resize_claim("uid-r2", resize_results(["tpu-0", "tpu-1"]),
                               desired=3)
    raw = checkpoint_doc(state)
    assert "resize" in raw["uid-r2"]
    restarted, _ = make_state(side, root, lib)
    view = restarted.gang_view("uid-r2")
    assert [n for n, _ in view["devices"]] == ["tpu-0", "tpu-1"]
    assert run_audit(side, restarted) == []
    restarted.prepare(make_claim("uid-n", ["tpu-2"], name="n"))
    assert_invariants(restarted)
    return raw, checkpoint_doc(restarted)


def elastic_failed_live_resize(side, root):
    ds = side("plugin.device_state")
    state, _ = state_4x1(side, root)
    state.prepare(make_claim("uid-rb", ["tpu-0", "tpu-1"]))
    held = {u: state.share_state.get(u).claims
            for u in state.share_state.list_chips()}
    with pytest.raises(ds.GangResizeError, match="tpu-9") as ei:
        state.resize_claim("uid-rb",
                           resize_results(["tpu-0", "tpu-1", "tpu-9"]))
    rec = state.checkpoint.read()["uid-rb"]
    assert "resize" not in rec and "elastic" not in rec
    assert run_audit(side, state) == []
    assert {u: state.share_state.get(u).claims
            for u in state.share_state.list_chips()} == held
    state.unprepare("uid-rb")
    assert run_audit(side, state) == []
    return str(ei.value)


def elastic_partial_apply_rollback(side, root):
    faults = side("utils.faults")
    state, _ = state_4x1(side, root)
    state.prepare(make_claim("uid-ph", ["tpu-0", "tpu-1", "tpu-2"]))
    with faults.armed(faults.FaultPlan().fail(
            "cdi.claim-write", OSError("disk full"), times=1)):
        with pytest.raises(OSError, match="disk full"):
            state.resize_claim("uid-ph",
                               resize_results(["tpu-0", "tpu-1", "tpu-3"]))
    assert [n for n, _ in state.gang_view("uid-ph")["devices"]] == \
        ["tpu-0", "tpu-1", "tpu-2"]
    assert run_audit(side, state) == []
    assert "uid-ph" in state.share_state.get(
        chip_uuid_of(state, "tpu-2")).claims
    assert "uid-ph" not in state.share_state.get(
        chip_uuid_of(state, "tpu-3")).claims
    state.prepare(make_claim("uid-sp", ["tpu-3"], name="sp"))
    assert_invariants(state)
    return checkpoint_doc(state), files(root / "cdi")


def elastic_kept_request_names(side, root):
    state, _ = state_4x1(side, root)
    state.prepare(make_claim("uid-rq", ["tpu-0", "tpu-1", "tpu-2"]))
    state.resize_claim("uid-rq", resize_results(["tpu-0", "tpu-1"]))
    names = [d.request_names for d in state.cached_devices("uid-rq")]
    assert names == [["req-0"], ["req-1"]]
    return names


def elastic_unrecoverable_intent(side, root):
    state, lib = state_4x1(side, root)
    state.prepare(make_claim("uid-r3", ["tpu-0", "tpu-1"]))
    mgr = side("plugin.checkpoint").CheckpointManager(
        str(root / "checkpoint.json"))
    recs = mgr.read()
    recs["uid-r3"]["resize"] = {"to": ["tpu-0", "tpu-1", "tpu-9"],
                                "requests": {}, "startedAt": time.time()}
    mgr.write(recs)
    restarted, _ = make_state(side, root, lib)
    found = run_audit(side, restarted)
    assert ("resize", "uid-r3") in found
    restarted.unprepare("uid-r3")
    assert run_audit(side, restarted) == []
    return found


@pytest.mark.parametrize("scenario", [
    elastic_crash_before_intent, elastic_rolls_forward,
    elastic_failed_live_resize, elastic_partial_apply_rollback,
    elastic_kept_request_names, elastic_unrecoverable_intent,
], ids=lambda f: f.__name__)
def test_elastic_crash_consistency(tmp_path, scenario):
    both(scenario, tmp_path)


# -- test_chaos.py: the rebalance limits' crash windows ----------------------


def process_shared_claim(uid, device="tpu-0", pct=30, hbm="4Gi"):
    return {
        "metadata": {"name": f"ps-{uid}", "namespace": "default", "uid": uid},
        "status": {"allocation": {"devices": {"results": [{
            "request": "r0", "driver": DRIVER, "pool": "node-a",
            "device": device,
        }], "config": [{
            "requests": [], "source": "FromClaim",
            "opaque": {"driver": DRIVER, "parameters": {
                "apiVersion": "tpu.google.com/v1alpha1",
                "kind": "TpuChipConfig",
                "sharing": {"strategy": "ProcessShared",
                            "processSharedConfig": {
                                "maxProcesses": 2,
                                "defaultActiveCorePercentage": pct,
                                "defaultHbmLimit": hbm,
                                "slo": {"latencyClass": "interactive",
                                        "minTensorCorePercent": 20}}},
            }},
        }]}}},
    }


def limits_crash_before_intent(side, root):
    faults = side("utils.faults")
    state, lib = make_state(side, root)
    state.prepare(process_shared_claim("uid-l0"))
    with faults.armed(faults.FaultPlan().crash("checkpoint.write")):
        with pytest.raises(faults.CrashPoint):
            state.resize_claim_limits("uid-l0", tensorcore_percent=60)
    restarted, _ = make_state(side, root, lib)
    assert run_audit(side, restarted) == []
    assert_invariants(restarted)
    return checkpoint_doc(restarted)


def limits_rolls_forward(side, root):
    faults = side("utils.faults")
    state, lib = make_state(side, root)
    state.prepare(process_shared_claim("uid-l1"))
    chip = chip_uuid_of(state, "tpu-0")
    with faults.armed(faults.FaultPlan().crash("checkpoint.write",
                                               on_call=2)):
        with pytest.raises(faults.CrashPoint):
            state.resize_claim_limits("uid-l1", tensorcore_percent=60,
                                      hbm_limit="8Gi")
    raw = checkpoint_doc(state)
    assert raw["uid-l1"]["resize"]["limits"] == {
        "tensorcorePercent": 60, "hbmLimit": "8Gi"}
    restarted, _ = make_state(side, root, lib)
    rec = restarted.checkpoint.read()["uid-l1"]
    gen = rec["sharing"]["generation"]
    assert gen >= 2
    assert restarted.share_state.get(chip).claims["uid-l1"]["generation"] \
        == gen
    assert run_audit(side, restarted) == []
    ckpt = checkpoint_doc(restarted)
    shared = files(root / "state")
    restarted.unprepare("uid-l1")
    assert run_audit(side, restarted) == []
    return raw, ckpt, masked(shared)


def limits_unfinished_intent(side, root):
    faults = side("utils.faults")
    state, lib = make_state(side, root)
    state.prepare(process_shared_claim("uid-l2"))
    with faults.armed(faults.FaultPlan().crash("checkpoint.write",
                                               on_call=2)):
        with pytest.raises(faults.CrashPoint):
            state.resize_claim_limits("uid-l2", tensorcore_percent=55)
    with faults.armed(faults.FaultPlan().fail(
            "rebalance.session-resize", OSError("still broken"), times=10)):
        restarted, _ = make_state(side, root, lib)
        findings = run_audit(side, restarted)
    assert ("resize", "uid-l2") in findings
    healed, _ = make_state(side, root, lib)
    assert run_audit(side, healed) == []
    return findings


@pytest.mark.parametrize("scenario", [
    limits_crash_before_intent, limits_rolls_forward,
    limits_unfinished_intent,
], ids=lambda f: f.__name__)
def test_rebalance_crash_consistency(tmp_path, scenario):
    both(scenario, tmp_path)


# -- defrag execution: test_defrag_executor.TestDriverOptIn and the node
# state of test_chaos.TestDefragCrashConsistency -----------------------------


def opt_in_driver(side, root, execute):
    client = side("kube").FakeKubeClient()
    client.create(side("kube").NODES, {"metadata": {"name": "node-d",
                                                    "uid": "nu"}})
    d = side("plugin.driver")
    kwargs = dict(
        node_name="node-d",
        chiplib=side("tpulib").FakeChipLib(generation="v5e",
                                           topology="2x2x1"),
        kube_client=client, cdi_root=str(root / "cdi"),
        plugin_root=str(root / "s"),
        registrar_root=str(root / "g"),
        state_root=str(root / "state"), node_uid="nu",
        device_watch_interval_seconds=0, defrag_execute=execute)
    return d.Driver(d.DriverConfig(**kwargs))


def driver_opt_in(side, root, execute):
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, _ = stuck_gang(side, alloc, planner)
    execu = executor(side, str(root / "x"), alloc, planner, reg)
    driver = opt_in_driver(side, root, execute)
    driver.enable_defrag_execution(execu)
    assert driver.auditor.defrag_executor is execu
    driver._maybe_execute_defrag()
    driver._maybe_execute_defrag()      # a plan executes once at most
    records = execu.export_executions()
    assert [r["state"] for r in records] == (["completed"] if execute
                                             else [])
    return journal(execu, reg, str(root)), sorted(held_by(alloc, "uid-gang"))


def arming_recovers(side, root):
    faults = side("utils.faults")
    _, alloc, planner, reg = fragmented_4x1(side)
    plan, _ = stuck_gang(side, alloc, planner)
    execu = executor(side, str(root / "x"), alloc, planner, reg)
    with faults.armed(faults.FaultPlan().crash("defrag.replace")):
        with pytest.raises(faults.CrashPoint):
            execu.execute(plan)
    reg2 = side("utils.metrics").Registry()
    execu2 = executor(side, str(root / "x"), alloc, planner, reg2)
    opt_in_driver(side, root, True).enable_defrag_execution(execu2)
    assert execu2.orphaned_intent() is None
    records = execu2.export_executions()
    assert records[-1]["state"] == "completed" and records[-1]["recovered"]
    assert len(held_by(alloc, "uid-gang")) == 2
    flag = [side("plugin.main").build_parser().parse_args(
        ["--node-name", "n", "--no-kube", *extra]).defrag_execute
        for extra in ([], ["--defrag-execute"])]
    assert flag == [False, True]
    return journal(execu2, reg2, str(root)), flag


@pytest.mark.parametrize("execute", [False, True], ids=["advisory", "armed"])
def test_driver_defrag_opt_in(tmp_path, execute):
    both(driver_opt_in, tmp_path, execute)


def test_driver_defrag_arming_recovers(tmp_path):
    both(arming_recovers, tmp_path)


def frag_node(side, root):
    """test_chaos.TestDefragCrashConsistency._frag_node: both middle
    chips of a 4x1x1 node held by single-chip claims that are also
    prepared on the node."""
    from test_torch_allocator import publish_host

    client = side("kube").FakeKubeClient()
    publish_host(side, client, "node-a", topology="4x1x1")
    reg = side("utils.metrics").Registry()
    al = side("kube.allocator")
    alloc = al.ReferenceAllocator(client, registry=reg)
    planner = side("kube.defrag").DefragPlanner(alloc, registry=reg)
    state, lib = state_4x1(side, root)
    for i, coord in enumerate(("1,0,0", "2,0,0")):
        alloc.allocate(chip_claim(f"uid-mid-{i}"),
                       selectors={"r0": [al.Selector("coord", "eq", coord)]})
        state.prepare(make_claim(f"uid-mid-{i}", [f"tpu-{i + 1}"],
                                 name=f"mid-{i}"))
    return alloc, planner, state, lib


def node_executor(side, root, alloc, planner, state):
    return side("kube.defrag_executor").DefragExecutor(
        planner, alloc, intent_path=str(root / "defrag-intent.json"),
        state=state, registry=side("utils.metrics").Registry())


def assert_converged(side, alloc, state, execu):
    assert len(held_by(alloc, "uid-gang")) == 2
    for uid in ("uid-mid-0", "uid-mid-1"):
        assert {n for n, _ in state.gang_view(uid)["devices"]} == \
            held_by(alloc, uid)
    assert execu.orphaned_intent() is None
    auditor = side("plugin.audit").StateAuditor(
        state=state, registry=side("utils.metrics").Registry(),
        node_name="node-a")
    auditor.defrag_executor = execu
    assert auditor.run_once() == []
    assert_invariants(state)


def defrag_on_node(side, root, crash):
    """No crash: one executed plan rewrites the mover's node state; a
    crash at a ``defrag.*`` site, or inside the mover's node resize
    (``checkpoint.write`` hit 1 or 2), then a restart, converges."""
    faults = side("utils.faults")
    alloc, planner, state, lib = frag_node(side, root)
    plan, _ = stuck_gang(side, alloc, planner)
    mig = plan["migrations"][0]
    execu = node_executor(side, root, alloc, planner, state)
    if crash is None:
        assert execu.execute(plan)["state"] == "completed"
        assert_converged(side, alloc, state, execu)
        return checkpoint_doc(state), plan["migrations"]
    site, on_call = crash
    with faults.armed(faults.FaultPlan().crash(site, on_call=on_call)):
        with pytest.raises(faults.CrashPoint):
            execu.execute(plan)
    restarted, _ = make_state(side, root, lib)
    execu2 = node_executor(side, root, alloc, planner, restarted)
    rec = execu2.recover()
    if site == "defrag.intent-write":
        assert rec is None
        rec = execu2.execute(plan)
    assert rec["state"] == "completed"
    assert held_by(alloc, mig["claimUid"]) == set(mig["to"])
    assert_converged(side, alloc, restarted, execu2)
    return checkpoint_doc(restarted), masked(rec)


def test_training_gang_keeps_loss_continuity(tmp_path, one_torch_thread):
    """``TestDefragCrashConsistency::test_training_gang_keeps_loss_continuity``
    on the port: the mover is a live training gang, the executor's
    migration listener relocates it through ``ElasticTrainer.relocate``
    onto the planned members, and its losses follow an uninterrupted
    run's -- no checkpoint restore, no lost step."""
    import numpy as np

    alloc, planner, state, lib = frag_node(PORT, tmp_path)
    plan, _ = stuck_gang(PORT, alloc, planner)
    mig = plan["migrations"][0]
    mover_uid = mig["claimUid"]
    trainer = tiny_trainer(list(mig["devices"]), {})
    reference = tiny_trainer(list(mig["devices"]), {})
    share_init(trainer, reference)
    toks = tiny_tokens(200, 4)
    ref_losses = [reference.step(t) for t in toks]

    relocations = []
    execu = node_executor(PORT, tmp_path, alloc, planner, state)

    def on_migrate(uid, devices):
        if uid == mover_uid:
            relocations.append(trainer.relocate(
                list(devices), reason="defrag migration"))

    execu.add_migration_listener(on_migrate)
    losses = [trainer.step(t) for t in toks[:2]]
    record = execu.execute(plan)
    losses += [trainer.step(t) for t in toks[2:]]

    assert record["state"] == "completed"
    assert len(relocations) == 1
    assert relocations[0].path == "live", (
        "a defrag relocation must not touch the checkpoint")
    assert trainer.members == list(mig["to"]) != list(mig["devices"])
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4, atol=2e-4)
    assert_converged(PORT, alloc, state, execu)


@pytest.mark.parametrize("crash", [None] + [
    (site, 1) for site in REF("utils.faults").sites_in("defrag.")
] + [("checkpoint.write", 1), ("checkpoint.write", 2)],
    ids=lambda c: "none" if c is None else f"{c[0]}@{c[1]}")
def test_defrag_on_the_node(tmp_path, crash):
    both(defrag_on_node, tmp_path, crash)
