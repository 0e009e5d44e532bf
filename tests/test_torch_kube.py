"""The port's Kubernetes client layer against the reference's: the fake's
CRUD, watch and validation, the apiserver schema, the CEL subset, the
backoff helpers, the JSON log format, the ResourceSlice controller, and
the REST client against the same stdlib HTTP servers (plain, and TLS with
client certificates and exec credential plugins).

Each scenario runs once per package (``both``): it makes the reference
test's assertions on that package, returns what it observed, and the two
packages' observations must be equal. Timing-only scenarios (the token
bucket, the throttle) make the reference's assertions on each package.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import random
import stat
import threading
import time

import pytest
import yaml

from test_kubeconfig_auth import (
    PLUGIN_COUNTING,
    TlsEchoServer,
    _make_cert,
    _pem,
    kind_style_kubeconfig,
    write_exec_plugin,
)
from test_real_client import StubApiServer, collect_events, mkslice, wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = "tpu.google.com"
VERSIONS = ["v1alpha3", "v1beta1", "v1beta2", "v1"]


class Side:
    """One package's modules, addressed below its root:
    ``side("kube.allocator")``."""

    def __init__(self, root: str):
        self.root = root

    def __call__(self, path: str):
        return importlib.import_module(f"{self.root}.{path}")

    def __repr__(self):
        return self.root


REF = Side("k8s_dra_driver_tpu")
PORT = Side("k8s_dra_driver_tpu_torch")
SIDES = [REF, PORT]


def both(scenario, *args, **kwargs):
    """Run ``scenario(side, ...)`` on the reference, then on the port;
    their observations must be equal. Returns the port's."""
    ref = scenario(REF, *args, **kwargs)
    port = scenario(PORT, *args, **kwargs)
    assert port == ref
    return port


def outcome(fn, *args, **kwargs):
    """("ok", value) or (exception class name, message): an error is an
    observation like a value."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the error is the observable
        return (type(e).__name__, str(e))


# Wall-clock fields of decision records, plans and journals.
TIMING_KEYS = frozenset({"ts", "durationSeconds", "stageSeconds"})


def masked(obj):
    """``obj`` with every wall-clock value replaced by "<t>"."""
    if isinstance(obj, dict):
        return {k: "<t>" if k in TIMING_KEYS else masked(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [masked(v) for v in obj]
    return obj


def exposition(registry, prefix: str) -> list[str]:
    """The lines of the families under ``prefix``; the values of time
    histograms' buckets and sums, and of timestamp gauges, masked."""
    out = []
    for line in registry.render().splitlines():
        name = line.split()[2] if line.startswith("#") else line
        if not name.startswith(prefix):
            continue
        metric = line.split("{")[0].split(" ")[0]
        if not line.startswith("#") and (
            metric.endswith(("_seconds_bucket", "_seconds_sum"))
            or metric.endswith("_timestamp_seconds")
        ):
            line = line.rsplit(" ", 1)[0] + " <t>"
        out.append(line)
    return out


# -- the fake client (tests/test_kube.py) ------------------------------------


def fake(side, validate=False):
    c = side("kube").FakeKubeClient()
    c.validate_schemas = validate
    return c


def mk(name, labels=None, namespace=None, **extra):
    md = {"name": name}
    if labels:
        md["labels"] = labels
    if namespace:
        md["namespace"] = namespace
    return {"metadata": md, **extra}


def test_label_selectors():
    def scenario(side):
        kube = side("kube")
        obj = mk("x", labels={"a": "b", "z": "1"})
        parsed = [kube.parse_label_selector(s)
                  for s in ("a=b, c=d", "", "exists")]
        assert parsed == [{"a": "b", "c": "d"}, {}, {"exists": None}]
        matched = [kube.matches_labels(obj, s) for s in
                   ("a=b", "a=b,z=1", "a=c", "missing=1", "z", None)]
        assert matched == [True, True, False, False, True, True]
        return parsed, matched

    both(scenario)


def crud_roundtrip(side):
    kube = side("kube")
    c = fake(side)
    created = c.create(kube.RESOURCE_SLICES, mk("s1", spec={"driver": "tpu"}))
    assert created["metadata"]["resourceVersion"] == "1"
    got = c.get(kube.RESOURCE_SLICES, "s1")
    assert got["spec"] == {"driver": "tpu"}
    return created, got, outcome(c.get, kube.RESOURCE_SLICES, "nope")


def crud_conflicts(side):
    kube = side("kube")
    c = fake(side)
    obj = c.create(kube.RESOURCE_SLICES, mk("s1"))
    dup = outcome(c.create, kube.RESOURCE_SLICES, mk("s1"))
    assert dup[0] == "AlreadyExistsError"
    obj["spec"] = {"x": 1}
    updated = c.update(kube.RESOURCE_SLICES, obj)
    assert updated["metadata"]["resourceVersion"] != "1"
    obj["metadata"]["resourceVersion"] = "1"
    stale = outcome(c.update, kube.RESOURCE_SLICES, obj)
    assert stale[0] == "ConflictError"
    return dup, updated, stale


def crud_namespacing(side):
    kube = side("kube")
    c = fake(side)
    c.create(kube.RESOURCE_CLAIMS, mk("claim", namespace="a"), namespace="a")
    c.create(kube.RESOURCE_CLAIMS, mk("claim", namespace="b"), namespace="b")
    counts = [len(c.list(kube.RESOURCE_CLAIMS)),
              len(c.list(kube.RESOURCE_CLAIMS, namespace="a"))]
    c.delete(kube.RESOURCE_CLAIMS, "claim", namespace="a")
    counts.append(len(c.list(kube.RESOURCE_CLAIMS)))
    assert counts == [2, 1, 1]
    return c.list(kube.RESOURCE_CLAIMS)


def crud_label_filtering(side):
    kube = side("kube")
    c = fake(side)
    c.create(kube.NODES, mk("n1", labels={"tpu.google.com/slice-id": "s1"}))
    c.create(kube.NODES, mk("n2", labels={"tpu.google.com/slice-id": "s2"}))
    c.create(kube.NODES, mk("n3"))
    some = c.list(kube.NODES, label_selector="tpu.google.com/slice-id")
    one = c.list(kube.NODES, label_selector="tpu.google.com/slice-id=s2")
    assert len(some) == 2
    assert [n["metadata"]["name"] for n in one] == ["n2"]
    return some, one


def crud_apply(side):
    kube = side("kube")
    c = fake(side)
    c.apply(kube.RESOURCE_SLICES, mk("s1", spec={"v": 1}))
    out = c.apply(kube.RESOURCE_SLICES, mk("s1", spec={"v": 2}))
    assert out["spec"] == {"v": 2}
    assert len(c.list(kube.RESOURCE_SLICES)) == 1
    return out


def crud_fault_injection(side):
    kube = side("kube")
    c = fake(side)
    c.fault_injector = lambda verb, gvr, name: (
        kube.ConflictError("boom") if verb == "create" else None
    )
    got = outcome(c.create, kube.RESOURCE_SLICES, mk("s1"))
    assert got == ("ConflictError", "boom")
    return got


def watch_fault_then_clear(side):
    kube = side("kube")
    c = fake(side)
    c.create(kube.NODES, mk("n1"))
    calls = {"n": 0}

    def injector(verb, gvr, name):
        if verb == "watch":
            calls["n"] += 1
            if calls["n"] == 1:
                return kube.ApiError("watch refused", code=500)
        return None

    c.fault_injector = injector
    refused = outcome(c.watch, kube.NODES)
    assert refused[0] == "ApiError"
    w = c.watch(kube.NODES)
    c.create(kube.NODES, mk("n2"))
    got = [(ev.type, ev.object["metadata"]["name"])
           for _, ev in zip(range(2), w.events(timeout=1.0))]
    w.stop()
    assert got == [("ADDED", "n1"), ("ADDED", "n2")]
    return refused, got


def watch_seed_list_fault(side):
    kube = side("kube")
    c = fake(side)
    c.create(kube.NODES, mk("n1"))
    c.fault_injector = lambda verb, gvr, name: (
        kube.ApiError("relist shed", code=503) if verb == "list" else None
    )
    refused = outcome(c.watch, kube.NODES)
    assert refused[0] == "ApiError"
    c.fault_injector = None
    w = c.watch(kube.NODES)
    first = next(iter(w.events(timeout=1.0))).object["metadata"]["name"]
    w.stop()
    assert first == "n1"
    return refused, first


def watch_global_fault_registry(side):
    kube, faults = side("kube"), side("utils.faults")
    c = fake(side)
    plan = faults.FaultPlan().fail(
        "kube.watch", faults.FaultError("chaos"), times=1)
    with faults.armed(plan):
        refused = outcome(c.watch, kube.NODES)
        hits = faults.REGISTRY.hits("kube.watch")
        c.watch(kube.NODES).stop()
    assert refused[0] == "FaultError" and hits == 1
    return refused, hits


def watch_seed_and_stream(side):
    kube = side("kube")
    c = fake(side)
    c.create(kube.NODES, mk("n1", labels={"x": "1"}))
    w = c.watch(kube.NODES, label_selector="x=1")
    c.create(kube.NODES, mk("n2", labels={"x": "1"}))
    c.create(kube.NODES, mk("n3"))
    c.delete(kube.NODES, "n1")
    got = []
    for ev in w.events(timeout=0.2):
        got.append((ev.type, ev.object["metadata"]["name"]))
        if len(got) == 3:
            break
    w.stop()
    assert got == [("ADDED", "n1"), ("ADDED", "n2"), ("DELETED", "n1")]
    return got


def watch_stop_unblocks(side):
    c = fake(side)
    w = c.watch(side("kube").NODES)
    t = threading.Thread(target=lambda: list(w.events()))
    t.start()
    w.stop()
    t.join(timeout=2)
    assert not t.is_alive()
    return w.stopped


@pytest.mark.parametrize("scenario", [
    crud_roundtrip, crud_conflicts, crud_namespacing, crud_label_filtering,
    crud_apply, crud_fault_injection, watch_fault_then_clear,
    watch_seed_list_fault, watch_global_fault_registry,
    watch_seed_and_stream, watch_stop_unblocks,
], ids=lambda f: f.__name__)
def test_fake_client(scenario):
    both(scenario)


# -- the apiserver schema (tests/test_schema.py) -----------------------------


def published_slices(side, version, topology="2x2x1", generation="v5p"):
    """Slices as the node plugin publishes them: the package's
    FakeChipLib devices through its controller, read back in wire form."""
    kube, rs = side("kube"), side("kube.resourceslice")
    client = kube.FakeKubeClient()
    client.served_api_versions["resource.k8s.io"] = [version]
    api = kube.ResourceApi.discover(client)
    lib = side("tpulib").FakeChipLib(generation=generation, topology=topology)
    allocatable = lib.enumerate_all_possible_devices({"chip", "tensorcore"})
    devices = [d.get_device() for d in allocatable.values()]
    counter_sets = sorted({
        cc["counterSet"] for d in devices
        for cc in d.get("basic", {}).get("consumesCounters", [])
    })
    shared = [{"name": cs, "counters": {
        "cores": {"value": "2"}, "hbm": {"value": "103079215104"}}}
        for cs in counter_sets]
    ctrl = rs.ResourceSliceController(client, DRIVER, scope="n0", api=api)
    ctrl.update(rs.DriverResources(pools={
        "n0": rs.Pool(devices=devices, shared_counters=shared,
                      node_name="n0"),
    }))
    ctrl.sync_once()
    return client.list(api.slices)


@pytest.mark.parametrize("version", VERSIONS)
def test_published_slices_validate(version):
    def scenario(side):
        slices = published_slices(side, version)
        assert slices
        for s in slices:
            side("kube.schema").validate_resource_slice(s)
        return slices

    both(scenario)


@pytest.mark.parametrize("version", VERSIONS)
def test_allocated_claim_validates(version):
    def scenario(side):
        kube, rs = side("kube"), side("kube.resourceslice")
        client = kube.FakeKubeClient()
        client.served_api_versions["resource.k8s.io"] = [version]
        api = kube.ResourceApi.discover(client)
        lib = side("tpulib").FakeChipLib(generation="v5e", topology="2x2x1")
        devices = [d.get_device() for d in
                   lib.enumerate_all_possible_devices({"chip"}).values()]
        ctrl = rs.ResourceSliceController(client, DRIVER, scope="n0",
                                          api=api)
        ctrl.update(rs.DriverResources(pools={
            "n0": rs.Pool(devices=devices, node_name="n0")}))
        ctrl.sync_once()
        claim = {
            "apiVersion": "resource.k8s.io/v1beta1",
            "kind": "ResourceClaim",
            "metadata": {"name": "c0", "namespace": "d", "uid": "u0"},
            "spec": {"devices": {"requests": [{
                "name": "r0", "deviceClassName": DRIVER, "count": 2}]}},
        }
        out = side("kube.allocator").ReferenceAllocator(client).allocate(
            claim, node_name="n0")
        wire = api.claim_to_wire(out)
        side("kube.schema").validate_resource_claim(wire)
        return wire, client.create(api.claims, wire, namespace="d")

    both(scenario)


def test_shipped_specs_validate():
    import glob

    paths = sorted(
        glob.glob(os.path.join(REPO, "demo/specs/**/*.yaml"), recursive=True)
        + glob.glob(os.path.join(REPO, "deployments/manifests/*.yaml")))
    docs = []
    for path in paths:
        with open(path) as f:
            docs += [d for d in yaml.safe_load_all(f) if d and d.get("kind")
                     in ("ResourceClaim", "ResourceClaimTemplate",
                         "DeviceClass")]
    assert len(docs) >= 10

    def scenario(side):
        verdicts = [outcome(side("kube.schema").validate, d) for d in docs]
        assert {v[0] for v in verdicts} == {"ok"}
        return verdicts

    both(scenario)


def valid_slice(side, version="v1beta1"):
    (s,) = published_slices(side, version, topology="1x1x1",
                            generation="v5e")
    return s


def _attrs(s):
    return s["spec"]["devices"][0]["basic"]["attributes"]


def _caps(s):
    return s["spec"]["devices"][0]["basic"]["capacity"]


def _wrap_bare_cap(s):
    caps = _caps(s)
    caps[next(iter(caps))] = {"value": "95"}


def _bare_cap(s):
    caps = _caps(s)
    caps[next(iter(caps))] = "95"


def _both_node_fields(s):
    s["spec"]["nodeSelector"] = {"nodeSelectorTerms": [{}]}


def _no_node_field(s):
    del s["spec"]["nodeName"]


def _too_many(s):
    dev = s["spec"]["devices"][0]
    s["spec"]["devices"] = [dict(dev, name=f"tpu-{i}") for i in range(129)]


# (name, version of the valid slice, mutation, the reference's match)
SLICE_DEFECTS = [
    ("domain-over-63", "v1beta1", lambda s: _attrs(s).update(
        {("x" * 64) + ".example.com/attr": {"string": "v"}}), "exceeds 63"),
    ("bad-domain", "v1beta1", lambda s: _attrs(s).update(
        {"Not_A_Domain!/attr": {"string": "v"}}), "invalid DNS-1123"),
    ("identifier-over-32", "v1beta1", lambda s: _attrs(s).update(
        {"a" * 33: {"string": "v"}}), "exceeds 32"),
    ("two-union-fields", "v1beta1", lambda s: _attrs(s).update(
        {"broken": {"string": "v", "int": 1}}), "exactly one"),
    ("string-over-64", "v1beta1", lambda s: _attrs(s).update(
        {"long": {"string": "v" * 65}}), "exceeds 64"),
    ("bare-capacity-in-beta", "v1beta1", _bare_cap, "value.*quantity|must be"),
    ("wrapped-capacity-in-alpha", "v1alpha3", _wrap_bare_cap,
     "bare quantity"),
    ("bad-quantity", "v1beta1", lambda s: _caps(s).update(
        {"hbm": {"value": "ninety-five"}}), "invalid quantity"),
    ("both-node-fields", "v1beta1", _both_node_fields, "exactly one of"),
    ("no-node-field", "v1beta1", _no_node_field, "exactly one of"),
    ("too-many-devices", "v1beta1", _too_many, "exceeds 128"),
    ("duplicate-names", "v1beta1", lambda s: s["spec"].update(
        devices=s["spec"]["devices"] * 2), "duplicate"),
    ("undeclared-counter-set", "v1beta1",
     lambda s: s["spec"]["devices"][0]["basic"].update(consumesCounters=[{
         "counterSet": "ghost", "counters": {"x": {"value": "1"}}}]),
     "not declared"),
    ("unsupported-version", "v1beta1",
     lambda s: s.update(apiVersion="resource.k8s.io/v1beta3"),
     "not a supported"),
    ("basic-wrapper-in-v1beta2", "v1beta1",
     lambda s: s.update(apiVersion="resource.k8s.io/v1beta2"),
     "not a v1beta2 field"),
]


@pytest.mark.parametrize("version,mutate,match",
                         [d[1:] for d in SLICE_DEFECTS],
                         ids=[d[0] for d in SLICE_DEFECTS])
def test_slice_defect_rejected(version, mutate, match):
    def scenario(side):
        s = valid_slice(side, version)
        mutate(s)
        schema = side("kube.schema")
        with pytest.raises(schema.SchemaError, match=match) as ei:
            schema.validate_resource_slice(s)
        return str(ei.value)

    both(scenario)


def _claim(api_version, requests, constraints=None, status=None):
    doc = {"apiVersion": api_version, "kind": "ResourceClaim",
           "metadata": {"name": "c"},
           "spec": {"devices": {"requests": requests}}}
    if constraints is not None:
        doc["spec"]["devices"]["constraints"] = constraints
    if status is not None:
        doc["status"] = status
    return doc


FIRST_AVAILABLE = [{"name": "r0", "firstAvailable": [
    {"name": "big", "deviceClassName": DRIVER, "count": 2},
    {"name": "small", "deviceClassName": DRIVER}]}]


def _first_available(sub):
    return _claim("resource.k8s.io/v1beta2", FIRST_AVAILABLE, status={
        "allocation": {"devices": {"results": [{
            "request": f"r0/{sub}", "driver": DRIVER, "pool": "n0",
            "device": "tpu-0"}]}}})


CLAIM_CASES = [
    ("count-with-mode-all", _claim("resource.k8s.io/v1beta1", [{
        "name": "r0", "deviceClassName": DRIVER, "allocationMode": "All",
        "count": 3}]), "must be unset"),
    ("constraint-not-qualified", _claim(
        "resource.k8s.io/v1beta1",
        [{"name": "r0", "deviceClassName": DRIVER}],
        constraints=[{"requests": ["r0"], "matchAttribute": "sliceId"}]),
     "fully qualified"),
    ("flat-request-in-v1beta2", _claim(
        "resource.k8s.io/v1beta2",
        [{"name": "r0", "deviceClassName": DRIVER}]),
     "nest under 'exactly'"),
    ("first-available-result", _first_available("big"), None),
    ("first-available-unknown", _first_available("huge"),
     "names no spec request"),
]


@pytest.mark.parametrize("claim,match", [c[1:] for c in CLAIM_CASES],
                         ids=[c[0] for c in CLAIM_CASES])
def test_claim_validation(claim, match):
    def scenario(side):
        schema = side("kube.schema")
        if match is None:
            return schema.validate_resource_claim(claim)
        with pytest.raises(schema.SchemaError, match=match) as ei:
            schema.validate_resource_claim(claim)
        return str(ei.value)

    both(scenario)


def test_v1beta2_conversion_validates():
    def scenario(side):
        api = side("kube").ResourceApi("v1beta2")
        schema = side("kube.schema")
        claim = _claim("resource.k8s.io/v1beta2",
                       [{"name": "r0", "deviceClassName": DRIVER}])
        wire_claim = api.claim_to_wire(claim)
        wire_slice = api.slice_to_wire(valid_slice(side, "v1beta1"))
        schema.validate_resource_claim(wire_claim)
        schema.validate_resource_slice(wire_slice)
        return wire_claim, wire_slice

    both(scenario)


def test_fake_client_rejects_as_apiserver_would():
    def scenario(side):
        kube = side("kube")
        client = kube.FakeKubeClient()
        s = valid_slice(side)
        _attrs(s)[("y" * 70) + ".example.com/attr"] = {"string": "v"}
        with pytest.raises(kube.InvalidError, match="exceeds 63") as ei:
            client.create(kube.ResourceApi("v1beta1").slices, s)
        return str(ei.value), client.list(kube.ResourceApi("v1beta1").slices)

    both(scenario)


# -- the CEL subset (tests/test_cel.py) --------------------------------------

ATTRS = {
    "type": {"string": "chip"},
    "generation": {"string": "v5p"},
    "coord": {"string": "0,1,0"},
    "iciX": {"int": 0},
    "iciY": {"int": 1},
    "iciZ": {"int": 0},
    "cores": {"int": 2},
}
CAP = {"hbm": {"value": "16Gi"}, "tensorcores": {"value": "2"}}
A = "device.attributes['tpu.google.com']"

# (expression, attributes, capacity, the reference's verdict: True, False
# or "error" for CelError)
CEL_CASES = [
    (f"{A}.generation == 'v5p'", None, None, True),
    (f"{A}.generation == 'v4'", None, None, False),
    ("device.driver == 'tpu.google.com'", None, None, True),
    ("device.driver == 'gpu.nvidia.com'", None, None, False),
    (f"{A}.iciX < 2", None, None, True),
    (f"{A}.iciY <= 1", None, None, True),
    (f"{A}.cores >= 2", None, None, True),
    (f"{A}.iciY > 1", None, None, False),
    (f"{A}.iciZ != 1", None, None, True),
    (f"{A}.generation == 'v5p' && {A}.coord == '0,1,0'", None, None, True),
    (f"{A}.generation == 'v4' || {A}.iciX == 0", None, None, True),
    (f"!({A}.iciX == 3)", None, None, True),
    (f"{A}.generation in ['v4', 'v5p']", None, None, True),
    (f"{A}.generation in ['v4', 'v5e']", None, None, False),
    (f"{A}.iciX == 1 && {A}.iciY == 9 || {A}.iciZ == 0", None, None, True),
    (f"{A}.iciX == 1 && ({A}.iciY == 9 || {A}.iciZ == 0)", None, None,
     False),
    (f"{A}.nosuch == 1", None, None, False),
    (f"{A}.nosuch == 1 || {A}.iciX == 0", None, None, True),
    (f"{A}.nosuch == 1 && {A}.iciX == 3", None, None, False),
    ("device.attributes['gpu.nvidia.com'].type == 'chip'", None, None,
     False),
    ("device.capacity['tpu.google.com'].hbm >= 17179869184", None, CAP,
     True),
    ("device.capacity['tpu.google.com'].tensorcores == 2", None, CAP, True),
    ("device.capacity['tpu.google.com'].hbm < 1024", None, CAP, False),
    (f"{A}.generation >= 16", None, None, False),
    (f"{A}.generation >= 16 || {A}.iciX == 0", None, None, True),
    (f"{A}.generation >= 16 && {A}.iciY > 1", None, None, False),
    (f"{A}.iciX in {A}.cores", None, None, False),
    (f"{A}.cores == '2'", None, None, False),
    (f"{A}.cores != '2'", None, None, True),
    (f"{A}.hollow == 1", dict(ATTRS, hollow={}), None, False),
    ("device.capacity['tpu.google.com'].hbm >= 1", None, {"hbm": {}},
     False),
    (f"{A}.type == 'chip'", None, None, True),
    (f"{A}.type == 'tensorcore'", None, None, False),
    (f"{A}.iciQ == 0", None, None, False),
    ("device.attributes[", None, None, "error"),
    ("frobnicate == 1", None, None, "error"),
]


@pytest.mark.parametrize("expr,attrs,capacity,want", CEL_CASES,
                         ids=[f"cel{i}" for i in range(len(CEL_CASES))])
def test_cel_verdicts(expr, attrs, capacity, want):
    def scenario(side):
        cel = side("kube.cel")
        try:
            verdict = cel.evaluate(expr, DRIVER, attrs or ATTRS, capacity)
            detailed = cel.evaluate_detailed(expr, DRIVER, attrs or ATTRS,
                                             capacity)
        except cel.CelError as e:
            assert want == "error"
            assert e.expression == expr and expr in str(e)
            return "error", str(e), e.expression
        assert verdict is want and detailed[0] is want
        return verdict, detailed

    out = both(scenario)
    if "iciQ" in expr:
        assert "attribute 'iciQ' absent" in out[1][1]
    if expr == f"{A}.generation >= 16":
        assert "no matching overload" in out[1][1]


# -- backoff and the token bucket (tests/test_backoff.py) --------------------


@pytest.mark.parametrize("side", SIDES, ids=str)
def test_token_bucket_timing(side):
    tb = side("utils.backoff").TokenBucket(qps=100, burst=5)
    t0 = time.monotonic()
    for _ in range(5):
        tb.acquire()
    assert time.monotonic() - t0 < 0.04
    t0 = time.monotonic()
    for _ in range(5):
        tb.acquire()
    assert time.monotonic() - t0 >= 0.04
    tb = side("utils.backoff").TokenBucket(qps=1000, burst=3)
    for _ in range(3):
        assert tb.try_acquire()
    time.sleep(0.05)
    assert sum(tb.try_acquire() for _ in range(10)) == 3
    tb = side("utils.backoff").TokenBucket(qps=0, burst=1)
    t0 = time.monotonic()
    for _ in range(1000):
        tb.acquire()
    assert time.monotonic() - t0 < 0.5


def test_token_bucket_and_backoff_sequences():
    def scenario(side):
        bo = side("utils.backoff")
        tb = bo.TokenBucket(qps=1, burst=2)
        grabs = [tb.try_acquire() for _ in range(3)]
        assert grabs == [True, True, False]
        refused = outcome(bo.TokenBucket, qps=5, burst=0)
        assert refused[0] == "ValueError"
        b = bo.Backoff(initial=1.0, cap=5.0, factor=2.0)
        capped = [b.next_delay() for _ in range(5)]
        assert capped == [1.0, 2.0, 4.0, 5.0, 5.0]
        b = bo.Backoff(initial=0.5, cap=10.0)
        b.next_delay()
        b.next_delay()
        b.reset()
        assert b.current == 0.0
        reset = b.next_delay()
        assert reset == 0.5
        rng = random.Random(7)
        jitter = [bo.full_jitter(4.0, rng) for _ in range(200)]
        assert all(0.0 <= d <= 4.0 for d in jitter)
        assert bo.full_jitter(0.0, rng) == 0.0
        b = bo.Backoff(initial=1.0, cap=8.0, factor=2.0, jitter=True,
                       rng=random.Random(42))
        based = []
        for base in [1.0, 2.0, 4.0, 8.0, 8.0]:
            d = b.next_delay()
            assert 0.0 <= d <= base and b.current == base
            based.append(d)
        seqs = [[x.next_delay() for _ in range(6)] for x in (
            bo.Backoff(initial=1.0, cap=60.0, jitter=True,
                       rng=random.Random(seed)) for seed in (1, 2, 9, 9))]
        assert seqs[0] != seqs[1] and seqs[2] == seqs[3]
        return grabs, refused, capped, reset, jitter, based, seqs

    both(scenario)


# -- the JSON log format (tests/test_logging.py) -----------------------------


@pytest.fixture
def _restore_root_logger():
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


def _record(msg="hello", **extra):
    record = logging.LogRecord(
        "test.logger", logging.INFO, __file__, 1, msg, (), None)
    for k, v in extra.items():
        setattr(record, k, v)
    return record


def test_json_formatter():
    def scenario(side):
        fmt = side("utils.logging").JsonFormatter()
        lines = [json.loads(fmt.format(_record())),
                 json.loads(fmt.format(_record(claim="default/c1",
                                               devices=3)))]
        spoofed = _record()
        spoofed.__dict__["ts"] = "spoofed"
        lines.append(json.loads(fmt.format(spoofed)))
        assert lines[-1]["ts"] != "spoofed"
        odd = json.loads(fmt.format(_record(obj=object())))
        assert "object object" in odd["obj"]
        t = side("utils.tracing").Tracer()
        with t.span("op", claim_uid="uid-log") as sp:
            inside = json.loads(fmt.format(_record()))
        assert inside["traceId"] == sp.trace_id
        assert inside["spanId"] == sp.span_id
        assert inside["claimUid"] == "uid-log"
        lines.append(json.loads(fmt.format(_record())))
        assert "traceId" not in lines[-1]
        assert lines[0]["msg"] == "hello" and lines[0]["level"] == "info"
        assert lines[1]["claim"] == "default/c1" and lines[1]["devices"] == 3
        return masked(lines), sorted(inside)

    both(scenario)


@pytest.mark.parametrize("env,args,want", [
    ({"TPU_DRA_LOG_LEVEL": "DEBUG", "TPU_DRA_LOG_FORMAT": "json"}, {},
     (logging.DEBUG, True)),
    ({"TPU_DRA_LOG_LEVEL": "DEBUG", "TPU_DRA_LOG_FORMAT": "json"},
     {"level": "WARNING", "json_format": False}, (logging.WARNING, False)),
    ({}, {}, (logging.INFO, False)),
], ids=["env", "cli-beats-env", "defaults"])
def test_setup_logging(monkeypatch, _restore_root_logger, env, args, want):
    for k in ("TPU_DRA_LOG_LEVEL", "TPU_DRA_LOG_FORMAT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def scenario(side):
        lg = side("utils.logging")
        lg.setup_logging(**args)
        root = logging.getLogger()
        got = (root.level,
               isinstance(root.handlers[0].formatter, lg.JsonFormatter))
        assert got == want
        return got

    both(scenario)


# -- the ResourceSlice controller (tests/test_resourceslice.py) --------------


def dev(name):
    return {"name": name, "basic": {"attributes": {}}}


def controller(side, client=None, scope="node-a", owner=None):
    client = client or fake(side, validate=True)
    return side("kube.resourceslice").ResourceSliceController(
        client, DRIVER, scope=scope, owner=owner), client


def pools(side, **by_pool):
    rs = side("kube.resourceslice")
    return rs.DriverResources(pools={
        name: rs.Pool(devices=devs, node_name=node)
        for name, (devs, node) in by_pool.items()})


def slices_create_update_delete(side):
    ctl, client = controller(side)
    slices = side("kube").RESOURCE_SLICES
    seen = []
    for devs in ([dev("tpu-0"), dev("tpu-1")], [dev("tpu-0")]):
        ctl.update(pools(side, **{"node-a": (devs, "node-a")}))
        ctl.sync_once()
        seen.append(client.list(slices))
        assert seen[-1][0]["spec"]["devices"] == devs
    ctl.update(side("kube.resourceslice").DriverResources())
    ctl.sync_once()
    assert client.list(slices) == []
    return seen


def slices_idempotent(side):
    ctl, client = controller(side)
    ctl.update(pools(side, p=([dev("tpu-0")], "n")))
    ctl.sync_once()
    first = client.list(side("kube").RESOURCE_SLICES)
    ctl.sync_once()
    assert client.list(side("kube").RESOURCE_SLICES) == first
    return first


def slices_chunked(side):
    rs = side("kube.resourceslice")
    ctl, client = controller(side)
    n = rs.MAX_DEVICES_PER_SLICE + 5
    ctl.update(pools(side, big=([dev(f"d-{i}") for i in range(n)], "n")))
    ctl.sync_once()
    out = client.list(side("kube").RESOURCE_SLICES)
    assert sorted(len(s["spec"]["devices"]) for s in out) == \
        [5, rs.MAX_DEVICES_PER_SLICE]
    assert all(s["spec"]["pool"]["resourceSliceCount"] == 2 for s in out)
    return out


def slices_network_pool(side):
    rs = side("kube.resourceslice")
    ctl, client = controller(side)
    selector = {"nodeSelectorTerms": [{"matchExpressions": [{
        "key": "tpu.google.com/slice-id", "operator": "In",
        "values": ["slice-1"]}]}]}
    ctl.update(rs.DriverResources(pools={"slice-1-ici": rs.Pool(
        devices=[dev("ici-channel-0")], node_selector=selector)}))
    ctl.sync_once()
    spec = client.list(side("kube").RESOURCE_SLICES)[0]["spec"]
    assert spec["nodeSelector"] == selector and "nodeName" not in spec
    return spec


def slices_foreign_untouched(side):
    kube = side("kube")
    client = fake(side, validate=True)
    client.create(kube.RESOURCE_SLICES, {
        "apiVersion": "resource.k8s.io/v1alpha3",
        "kind": "ResourceSlice",
        "metadata": {"name": "other"},
        "spec": {"driver": "gpu.nvidia.com", "nodeName": "n",
                 "pool": {"name": "p", "generation": 1,
                          "resourceSliceCount": 1},
                 "devices": []},
    })
    ctl, _ = controller(side, client)
    ctl.update(side("kube.resourceslice").DriverResources())
    ctl.sync_once()
    names = [s["metadata"]["name"] for s in client.list(kube.RESOURCE_SLICES)]
    assert names == ["other"]
    return names


def slices_generation_bumps(side):
    rs = side("kube.resourceslice")
    ctl, client = controller(side)
    slices = side("kube").RESOURCE_SLICES
    ctl.update(pools(side, p=([dev("tpu-0")], "n")))
    ctl.sync_once()
    gen1 = client.list(slices)[0]["spec"]["pool"]["generation"]
    ctl.sync_once()
    assert client.list(slices)[0]["spec"]["pool"]["generation"] == gen1
    ctl.update(pools(side, p=([dev("tpu-0"), dev("tpu-1")], "n")))
    ctl.sync_once()
    gen2 = client.list(slices)[0]["spec"]["pool"]["generation"]
    assert gen2 == gen1 + 1
    n = rs.MAX_DEVICES_PER_SLICE + 2
    ctl.update(pools(side, p=([dev(f"d{i}") for i in range(n)], "n")))
    ctl.sync_once()
    assert len(client.list(slices)) == 2
    ctl.update(pools(side, p=([dev(f"d{i}") for i in range(3)], "n")))
    ctl.sync_once()
    (last,) = client.list(slices)
    assert last["spec"]["pool"]["resourceSliceCount"] == 1
    return gen1, gen2, last


def slices_publishers_coexist(side):
    client = fake(side, validate=True)
    slices = side("kube").RESOURCE_SLICES
    ctl_a, _ = controller(side, client, scope="node-a")
    ctl_b, _ = controller(side, client, scope="node-b")
    ctl_a.update(pools(side, **{"node-a": ([dev("tpu-0")], "node-a")}))
    ctl_b.update(pools(side, **{"node-b": ([dev("tpu-0")], "node-b")}))
    for _ in range(2):
        ctl_a.sync_once()
        ctl_b.sync_once()
        assert len(client.list(slices)) == 2
    ctl_a.stop(delete_slices=True)
    remaining = client.list(slices)
    assert [s["spec"]["nodeName"] for s in remaining] == ["node-b"]
    return remaining


def slices_stop_with_cleanup(side):
    ctl, client = controller(side)
    ctl.update(pools(side, p=([dev("tpu-0")], "n")))
    ctl.start()
    ctl.sync_once()
    published = client.list(side("kube").RESOURCE_SLICES)
    ctl.stop(delete_slices=True)
    assert published and client.list(side("kube").RESOURCE_SLICES) == []
    return published


@pytest.mark.parametrize("scenario", [
    slices_create_update_delete, slices_idempotent, slices_chunked,
    slices_network_pool, slices_foreign_untouched, slices_generation_bumps,
    slices_publishers_coexist, slices_stop_with_cleanup,
], ids=lambda f: f.__name__)
def test_resourceslice_controller(scenario):
    both(scenario)


# -- the REST client (tests/test_real_client.py) -----------------------------


def rest(side, stub, **kwargs):
    kube = side("kube.client")
    kwargs.setdefault("qps", 0)
    return kube.RealKubeClient(kube.RestConfig(
        host=f"http://127.0.0.1:{stub.port}",
        token=kwargs.pop("token", "")), **kwargs)


def on_stub(scenario, served=("v1alpha3",)):
    """``scenario(side, stub)`` on a fresh stub API server per package;
    the stub's request log joins the observation."""
    def run(side):
        stub = StubApiServer(served_versions=served)
        stub.start()
        try:
            return scenario(side, stub), stub.requests, stub.auth_headers
        finally:
            stub.stop()
    return run


def rest_crud(side, stub):
    kube = side("kube.client")
    client = rest(side, stub, token="tok-123", poll_interval=0.05)
    try:
        created = client.create(kube.RESOURCE_SLICES, mkslice("s1"))
        assert created["metadata"]["resourceVersion"] == "1"
        got = client.get(kube.RESOURCE_SLICES, "s1")
        names = [o["metadata"]["name"]
                 for o in client.list(kube.RESOURCE_SLICES)]
        assert names == ["s1"]
        client.delete(kube.RESOURCE_SLICES, "s1")
        gone = outcome(client.get, kube.RESOURCE_SLICES, "s1")
        assert gone[0] == "NotFoundError"
        assert stub.auth_headers[-1] == "Bearer tok-123"
        client.create(kube.RESOURCE_SLICES, mkslice("s2"))
        client.create(kube.RESOURCE_SLICES, mkslice("s3"))
        meta = client.list_meta(kube.RESOURCE_SLICES)
        assert meta == [("s2", "2"), ("s3", "3")]
        return created, got, gone, meta
    finally:
        client.close()


def rest_errors(side, stub):
    kube = side("kube.client")
    client = rest(side, stub)
    try:
        client.create(kube.RESOURCE_SLICES, mkslice("a", {"scope": "x"}))
        client.create(kube.RESOURCE_SLICES, mkslice("b", {"scope": "y"}))
        picked = [o["metadata"]["name"] for o in client.list(
            kube.RESOURCE_SLICES, label_selector="scope=x")]
        assert picked == ["a"]
        dup = outcome(client.create, kube.RESOURCE_SLICES, mkslice("a"))
        assert dup[0] == "AlreadyExistsError"
        obj = client.get(kube.RESOURCE_SLICES, "a")
        out = client.update(kube.RESOURCE_SLICES, obj)
        assert int(out["metadata"]["resourceVersion"]) > 1
        obj["metadata"]["resourceVersion"] = "999"
        stale = outcome(client.update, kube.RESOURCE_SLICES, obj)
        assert stale[0] == "ConflictError"
        ghost = outcome(client.update, kube.RESOURCE_SLICES, mkslice("g"))
        assert ghost[0] == "NotFoundError"
        return picked, dup, out, stale, ghost
    finally:
        client.close()


def rest_poll_watch(side, stub):
    kube = side("kube.client")
    client = rest(side, stub, poll_interval=0.05, watch_mode="poll")
    client.create(kube.RESOURCE_SLICES, mkslice("s1"))
    w = client.watch(kube.RESOURCE_SLICES)
    events, t = collect_events(w)
    try:
        wait_for(events, ("ADDED", "s1"))
        obj = client.get(kube.RESOURCE_SLICES, "s1")
        obj["spec"]["pool"]["generation"] = 2
        client.update(kube.RESOURCE_SLICES, obj)
        wait_for(events, ("MODIFIED", "s1"))
        client.delete(kube.RESOURCE_SLICES, "s1")
        wait_for(events, ("DELETED", "s1"))
    finally:
        w.stop()
        client.close()
    t.join(timeout=5)
    assert not t.is_alive()
    return list(events)


def rest_stream_watch(side, stub):
    kube = side("kube.client")
    client = rest(side, stub, poll_interval=0.05)
    client.create(kube.RESOURCE_SLICES, mkslice("seed"))
    w = client.watch(kube.RESOURCE_SLICES, label_selector="")
    events, t = collect_events(w)
    try:
        wait_for(events, ("ADDED", "seed"))
        stub.wait_watch_connections(1)
        client.create(kube.RESOURCE_SLICES, mkslice("live"))
        wait_for(events, ("ADDED", "live"))
        obj = client.get(kube.RESOURCE_SLICES, "live")
        obj["spec"]["pool"]["generation"] = 2
        client.update(kube.RESOURCE_SLICES, obj)
        wait_for(events, ("MODIFIED", "live"))
        client.delete(kube.RESOURCE_SLICES, "live")
        wait_for(events, ("DELETED", "live"))
        lists = [p for m, p in stub.requests
                 if m == "GET" and "watch=true" not in p
                 and p.split("?")[0].rstrip("/").endswith("resourceslices")]
        assert len(lists) == 1, stub.requests
        # A bookmark moves the resume point and never surfaces.
        stub.broadcast({"type": "BOOKMARK",
                        "object": {"metadata": {"resourceVersion": "42"}}})
        time.sleep(0.1)
        stub.end_watch_streams()
        stub.wait_watch_connections(2)
        assert stub.watch_rvs[1] == "42"
    finally:
        w.stop()
        client.close()
    t.join(timeout=5)
    return list(events), stub.watch_rvs[:2]


def rest_relist_on_410(side, stub):
    kube = side("kube.client")
    client = rest(side, stub, poll_interval=0.05)
    client.create(kube.RESOURCE_SLICES, mkslice("a"))
    w = client.watch(kube.RESOURCE_SLICES, label_selector="scope=x")
    events, t = collect_events(w)
    try:
        stub.wait_watch_connections(1)
        watch_reqs = [p for m, p in stub.requests if "watch=true" in p]
        assert any("labelSelector=scope%3Dx" in p for p in watch_reqs)
        w.stop()
        t.join(timeout=5)
        w = client.watch(kube.RESOURCE_SLICES)
        events, t = collect_events(w)
        wait_for(events, ("ADDED", "a"))
        stub.wait_watch_connections(2)
        stub.mute = True
        client.create(kube.RESOURCE_SLICES, mkslice("b"))
        client.delete(kube.RESOURCE_SLICES, "a")
        stub.watch_410_once = True
        stub.end_watch_streams()
        wait_for(events, ("ADDED", "b"))
        wait_for(events, ("DELETED", "a"))
    finally:
        w.stop()
        client.close()
    t.join(timeout=5)
    return list(events)


def rest_chunked_list(side, stub):
    kube = side("kube.client")
    for i in range(5):
        stub.rv += 1
        stub.objects[f"s{i}"] = mkslice(f"s{i}")
    seen = []
    for page_size, expire in ((2, False), (2, True), (0, False)):
        client = rest(side, stub, list_page_size=page_size)
        stub.expire_continue = expire
        before = len(stub.requests)
        names = [o["metadata"]["name"]
                 for o in client.list(kube.RESOURCE_SLICES)]
        client.close()
        assert names == [f"s{i}" for i in range(5)]
        seen.append((names, stub.requests[before:]))
    assert len(seen[0][1]) == 3
    assert any("continue=2" in p for _, p in seen[0][1])
    last = seen[1][1][-1][1]
    assert "limit=" not in last and "continue=" not in last
    assert all("limit=" not in p for _, p in seen[2][1])
    return seen


def rest_overload(side, stub):
    kube, errors = side("kube.client"), side("kube.errors")
    client = rest(side, stub)
    try:
        stub.objects["s0"] = mkslice("s0")
        stub.rv += 1
        stub.inject_429 = 1
        t0 = time.monotonic()
        names = [o["metadata"]["name"]
                 for o in client.list(kube.RESOURCE_SLICES)]
        assert names == ["s0"] and time.monotonic() - t0 >= 0.04
        client.overload_retries = 2
        stub.inject_429 = 99
        with pytest.raises(errors.ApiError) as exc:
            client.list(kube.RESOURCE_SLICES)
        assert exc.value.code == 429 and exc.value.retry_after == 0.05
        stub.inject_429 = 1
        created = client.create(kube.RESOURCE_SLICES, mkslice("w1"))
        assert "w1" in stub.objects
        return names, (exc.value.code, exc.value.retry_after), created
    finally:
        stub.inject_429 = 0
        client.close()


def rest_dialect(side, stub):
    """Discovery picks the one served version, and the controller's
    slices land in its dialect, without churn on a resync."""
    kube, rs = side("kube.client"), side("kube.resourceslice")
    client = rest(side, stub, poll_interval=0.05)
    try:
        api = side("kube").ResourceApi.discover(client)
        assert api.version == stub.served_versions[0]
        pinned = outcome(client.create, kube.RESOURCE_SLICES,
                         mkslice("pinned"))
        ctrl = rs.ResourceSliceController(client, DRIVER, scope="n0",
                                          api=api)
        ctrl.update(rs.DriverResources(pools={"n0": rs.Pool(devices=[{
            "name": "tpu0", "basic": {
                "attributes": {"type": {"string": "chip"}},
                "capacity": {"hbm": {"value": "95"}}}}], node_name="n0")}))
        ctrl.sync_once()
        wire = [o for n, o in stub.objects.items() if n != "pinned"]
        ctrl.sync_once()
        again = [o for n, o in stub.objects.items() if n != "pinned"]
        assert again == wire and len(wire) == 1
        assert wire[0]["apiVersion"] == f"resource.k8s.io/{api.version}"
        return (client.api_group_versions("resource.k8s.io"), pinned, wire)
    finally:
        client.close()


@pytest.mark.parametrize("scenario,served", [
    (rest_crud, ("v1alpha3",)),
    (rest_errors, ("v1alpha3",)),
    (rest_chunked_list, ("v1alpha3",)),
    (rest_overload, ("v1alpha3",)),
    (rest_dialect, ("v1alpha3",)),
    (rest_dialect, ("v1beta1",)),
    (rest_dialect, ("v1beta2",)),
], ids=["crud", "errors", "chunked-list", "overload", "dialect-v1alpha3",
        "dialect-v1beta1", "dialect-v1beta2"])
def test_rest_client(scenario, served):
    both(on_stub(scenario, served))


@pytest.mark.parametrize("scenario", [
    rest_poll_watch, rest_stream_watch, rest_relist_on_410,
], ids=lambda f: f.__name__)
def test_rest_client_watch(scenario):
    """The events each package's watch delivered are equal; the request
    logs are not compared (a watch thread's reconnects are timed)."""
    def events(side):
        return on_stub(scenario)(side)[0]

    both(events)


@pytest.mark.parametrize("side", SIDES, ids=str)
def test_rest_client_survives_server_errors_and_throttles(side):
    stub = StubApiServer()
    stub.start()
    kube = side("kube.client")
    client = rest(side, stub, qps=50, burst=5)
    t0 = time.monotonic()
    for _ in range(11):
        client.list(kube.RESOURCE_SLICES)
    assert time.monotonic() - t0 >= 0.1
    client.close()
    client = rest(side, stub, poll_interval=0.05)
    t0 = time.monotonic()
    for _ in range(20):
        client.list(kube.RESOURCE_SLICES)
    assert time.monotonic() - t0 < 2.0
    w = client.watch(kube.RESOURCE_SLICES)
    time.sleep(0.1)
    stub.stop()
    time.sleep(0.15)
    assert not w.stopped
    w.stop()
    client.close()


# -- kubeconfig auth (tests/test_kubeconfig_auth.py) -------------------------


@pytest.fixture(scope="module")
def pki():
    ca_cert, ca_key = _make_cert("tpu-test-ca", is_ca=True)
    server_cert, server_key = _make_cert(
        "kube-apiserver", issuer_key=ca_key, issuer_cert=ca_cert,
        san_ip="127.0.0.1")
    client_cert, client_key = _make_cert(
        "kubernetes-admin", issuer_key=ca_key, issuer_cert=ca_cert)
    return {"ca": _pem(ca_cert),
            "server": (_pem(server_cert), _pem(server_key)),
            "client": (_pem(client_cert), _pem(client_key))}


def _config_fields(cfg):
    return {k: v for k, v in vars(cfg).items() if k != "exec_auth"}, (
        None if cfg.exec_auth is None else vars(cfg.exec_auth))


def test_kubeconfigs_parse(tmp_path, pki):
    kind = kind_style_kubeconfig(tmp_path, pki, 6443)
    gke = tmp_path / "gke-kubeconfig"
    gke.write_text(yaml.safe_dump({
        "current-context": "gke",
        "clusters": [{"name": "gke", "cluster": {
            "server": "https://1.2.3.4"}}],
        "contexts": [{"name": "gke", "context": {
            "cluster": "gke", "user": "gke"}}],
        "users": [{"name": "gke", "user": {"exec": {
            "apiVersion": "client.authentication.k8s.io/v1beta1",
            "command": "gke-gcloud-auth-plugin",
            "args": ["--use_application_default_credentials"],
            "env": [{"name": "FOO", "value": "bar"}]}}}],
    }))

    def scenario(side):
        rc = side("kube.client").RestConfig
        a, b = rc.from_kubeconfig(kind), rc.from_kubeconfig(str(gke))
        assert a.host == "https://127.0.0.1:6443"
        assert "BEGIN CERTIFICATE" in a.ca_data
        assert "BEGIN RSA PRIVATE KEY" in a.client_key_data
        assert not a.insecure and not a.token
        assert b.exec_auth.command == "gke-gcloud-auth-plugin"
        assert b.exec_auth.env == {"FOO": "bar"}
        return _config_fields(a), _config_fields(b)

    both(scenario)


def tls_list(side, server, cfg_fields):
    kube = side("kube.client")
    client = kube.RealKubeClient(kube.RestConfig(**cfg_fields), qps=0)
    try:
        got = outcome(client.list, kube.RESOURCE_SLICES)
        files = list(client._cred_files)
        modes = [stat.S_IMODE(os.stat(f).st_mode) for f in files]
    finally:
        client.close()
    assert not any(os.path.exists(f) for f in files)
    return got, modes, server.peer_subjects[-1:], server.auth_headers[-1:]


def test_mtls(tmp_path, pki):
    cert_path, key_path = tmp_path / "admin.crt", tmp_path / "admin.key"
    cert_path.write_text(pki["client"][0])
    key_path.write_text(pki["client"][1])

    def scenario(side):
        server = TlsEchoServer(pki, tmp_path)
        server.start()
        try:
            host = f"https://127.0.0.1:{server.port}"
            kind = side("kube.client").RestConfig.from_kubeconfig(
                kind_style_kubeconfig(tmp_path, pki, server.port))
            inline = tls_list(side, server, _config_fields(kind)[0])
            assert inline[0] == ("ok", []) and inline[1]
            assert set(inline[1]) == {0o600}
            assert inline[2] == ["kubernetes-admin"]
            files = tls_list(side, server, {
                "host": host, "ca_data": pki["ca"],
                "client_cert_file": str(cert_path),
                "client_key_file": str(key_path)})
            assert files[0] == ("ok", [])
            assert files[2] == ["kubernetes-admin"]
            kube = side("kube.client")
            bare = kube.RealKubeClient(
                kube.RestConfig(host=host, ca_data=pki["ca"]), qps=0)
            with pytest.raises(Exception):
                bare.list(kube.RESOURCE_SLICES)
            bare.close()
            return inline, files
        finally:
            server.stop()

    both(scenario)


def test_rotated_cert_files_do_not_accumulate(pki):
    def scenario(side):
        kube = side("kube.client")
        client = kube.RealKubeClient(kube.RestConfig(
            host="https://127.0.0.1:1", ca_data=pki["ca"],
            client_cert_data=pki["client"][0],
            client_key_data=pki["client"][1]), qps=0)
        first = list(client._cred_files)
        client._ssl_ctx = client._make_ssl_ctx()
        second = list(client._cred_files)
        gone = [os.path.exists(f) for f in first]
        kept = [os.path.exists(f) for f in second]
        client.close()
        assert gone == [False, False] and kept == [True, True]
        assert not any(os.path.exists(f) for f in second)
        return gone, kept

    both(scenario)


@pytest.mark.parametrize("expiry,require,extra", [
    ("", "", ""),
    ("2020-01-01T00:00:00Z", "", ""),
    ("", "exec-token-2", ""),
    ("2020-01-01T00:00:00Z", "", "\nif n > 1:\n    sys.exit(1)\n"),
], ids=["token", "expired-refreshes", "401-reexecs", "refresh-failure"])
def test_exec_credentials(tmp_path, monkeypatch, expiry, require, extra):
    monkeypatch.setenv("PLUGIN_EXPIRY", expiry)

    def scenario(side):
        count = tmp_path / f"count-{side}"
        monkeypatch.setenv("PLUGIN_COUNT_FILE", str(count))
        plugin = write_exec_plugin(tmp_path, PLUGIN_COUNTING + extra)
        stub = StubApiServer()
        stub.require_token = require
        stub.start()
        kube = side("kube.client")
        try:
            client = kube.RealKubeClient(kube.RestConfig(
                host=f"http://127.0.0.1:{stub.port}",
                exec_auth=kube.ExecAuthConfig(command=plugin)), qps=0)
            got = [client.list(kube.RESOURCE_SLICES)]
            runs = [int(count.read_text())]
            if expiry:
                got.append(client.list(kube.RESOURCE_SLICES))
                runs.append(int(count.read_text()))
            client.close()
        finally:
            stub.stop()
        return got, runs, stub.auth_headers

    got, runs, headers = both(scenario)
    want = {"": "Bearer exec-token-1", "exec-token-2": "Bearer exec-token-2"}
    if extra:
        assert headers[-1] == "Bearer exec-token-1" and runs[0] == runs[1]
    elif expiry:
        assert headers[-1] == "Bearer exec-token-3"
    else:
        assert headers[-1] == want[require]


def test_exec_plugin_minting_client_certs(tmp_path, pki):
    cert_file, key_file = tmp_path / "minted.crt", tmp_path / "minted.key"
    cert_file.write_text(pki["client"][0])
    key_file.write_text(pki["client"][1])
    plugin = write_exec_plugin(tmp_path, f"""
import json
print(json.dumps({{
    "kind": "ExecCredential",
    "apiVersion": "client.authentication.k8s.io/v1",
    "status": {{
        "clientCertificateData": open({str(cert_file)!r}).read(),
        "clientKeyData": open({str(key_file)!r}).read(),
    }},
}}))
""")

    def scenario(side):
        server = TlsEchoServer(pki, tmp_path)
        server.start()
        try:
            kube = side("kube.client")
            client = kube.RealKubeClient(kube.RestConfig(
                host=f"https://127.0.0.1:{server.port}", ca_data=pki["ca"],
                exec_auth=kube.ExecAuthConfig(command=plugin)), qps=0)
            got = client.list(kube.RESOURCE_SLICES)
            client.close()
        finally:
            server.stop()
        assert got == [] and server.peer_subjects == ["kubernetes-admin"]
        assert server.auth_headers == [""]
        return got, server.peer_subjects, server.auth_headers

    both(scenario)


@pytest.mark.parametrize("body,match", [
    ("import sys; sys.stderr.write('no creds'); sys.exit(3)", "rc=3"),
    ("print('not json')", "non-JSON"),
], ids=["failure", "bad-output"])
def test_exec_plugin_errors_are_loud(tmp_path, body, match):
    plugin = write_exec_plugin(tmp_path, body)

    def scenario(side):
        with pytest.raises(RuntimeError, match=match) as ei:
            side("kube.client").ExecAuthConfig(command=plugin).run()
        return str(ei.value)

    both(scenario)
