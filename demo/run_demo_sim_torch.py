#!/usr/bin/env python3
"""Hermetic end-to-end demo on the PyTorch port: every quickstart spec
through the port's full stack.

Twin of ``demo/run_demo_sim.py`` (the README's quickstart) over
``k8s_dra_driver_tpu_torch``. The same flow: ``FakeChipLib`` topology ->
ResourceSlice publication through the controller -> DeviceClass CEL +
allocation through the scheduler-sim -> NodePrepareResources over a
gRPC unix-socket channel against the Driver -> the CDI env the pod would
see -> unprepare. The Driver serves its sockets through
``plugin/grpc_uds.py`` and the kubelet's side is ``grpc_uds.Channel``
with ``grpc_services.NodeStub``: neither ``grpcio`` nor ``protobuf`` nor
JAX is needed, so the demo runs on a GPU node as it does anywhere.

Run: python demo/run_demo_sim_torch.py      (transcript to stdout)
The output equals the fenced block of docs/demo-transcript.md, the
reference's recording; tests/test_torch_gate_demo.py holds it there.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys
import tempfile

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from k8s_dra_driver_tpu_torch.controller.slice_manager import (  # noqa: E402
    SLICE_LABEL,
    IciSliceManager,
)
from k8s_dra_driver_tpu_torch.kube import (  # noqa: E402
    NODES,
    RESOURCE_CLAIMS,
    FakeKubeClient,
)
from k8s_dra_driver_tpu_torch.kube.allocator import (  # noqa: E402
    AllocationError,
    ReferenceAllocator,
)
from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb  # noqa: E402
from k8s_dra_driver_tpu_torch.plugin import grpc_uds  # noqa: E402
from k8s_dra_driver_tpu_torch.plugin.driver import Driver, DriverConfig  # noqa: E402
from k8s_dra_driver_tpu_torch.plugin.grpc_services import NodeStub  # noqa: E402
from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib  # noqa: E402

NODE = "demo-node"


def load_device_classes() -> dict[str, list[str]]:
    out = {}
    path = os.path.join(REPO, "deployments/manifests/deviceclasses.yaml")
    with open(path) as f:
        for doc in yaml.safe_load_all(f):
            if doc and doc.get("kind") == "DeviceClass":
                out[doc["metadata"]["name"]] = [
                    s["cel"]["expression"]
                    for s in doc["spec"].get("selectors", [])
                ]
    return out


def spec_claims(path: str):
    """(name, namespace, devices-spec) for each claim/template in a demo
    YAML."""
    with open(path) as f:
        for doc in yaml.safe_load_all(f):
            if not doc:
                continue
            kind = doc.get("kind")
            meta = doc.get("metadata", {})
            if kind == "ResourceClaimTemplate":
                yield meta["name"], meta.get("namespace", "default"), \
                    doc["spec"]["spec"]["devices"]
            elif kind == "ResourceClaim":
                yield meta["name"], meta.get("namespace", "default"), \
                    doc["spec"]["devices"]


def main() -> int:
    print("# TPU DRA driver — hermetic demo transcript")
    print("#")
    print("# Full driver stack, no cluster required: fake 4x4x1 v5p node,")
    print("# real ResourceSlice controller, real DeviceClass CEL, real")
    print("# allocator, real gRPC NodePrepareResources, real CDI specs.")
    client = FakeKubeClient()
    client.create(NODES, {"metadata": {
        "name": NODE, "uid": "demo-node-uid",
        "labels": {SLICE_LABEL: "demo-slice"},
    }})
    # A short root: the sockets stay under AF_UNIX's 107-byte limit.
    tmp = tempfile.mkdtemp(prefix="tpu-dra-demo-")
    config = DriverConfig(
        node_name=NODE,
        chiplib=FakeChipLib(generation="v5p", topology="4x4x1",
                            slice_id="demo-slice"),
        kube_client=client,
        cdi_root=os.path.join(tmp, "cdi"),
        plugin_root=os.path.join(tmp, "plugin"),
        registrar_root=os.path.join(tmp, "registry"),
        state_root=os.path.join(tmp, "state"),
        # Hermetic: point driver discovery into the sandbox so the sim's
        # output never depends on whether THIS machine has a runtime
        # installed under the default driver root.
        driver_root=os.path.join(tmp, "driver-root"),
        driver_root_ctr_path=os.path.join(tmp, "driver-root"),
        node_uid="demo-node-uid",
    )
    driver = Driver(config)
    driver.start()
    # The cluster controller publishes the slice's ICI channel pool
    # (tpu-test-ici claims one channel per worker).
    mgr = IciSliceManager(client)
    mgr.start()
    alloc = ReferenceAllocator(client, device_classes=load_device_classes())
    failures = 0
    try:
        with grpc_uds.Channel(config.plugin_socket) as ch:
            stub = NodeStub(ch)
            for path in sorted(glob.glob(
                    os.path.join(REPO, "demo/specs/quickstart/*.yaml"))):
                failures += run_spec(
                    path, client, alloc, stub, config.cdi_root
                )
    finally:
        mgr.stop(cleanup=False)
        driver.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"\n== demo {'FAILED' if failures else 'OK'}: "
          f"{failures} failing spec claim(s) ==")
    return 1 if failures else 0


def run_spec(path, client, alloc, stub, cdi_root) -> int:
    rel = os.path.relpath(path, REPO)
    print(f"\n== {rel} ==")
    failures = 0
    for name, ns, devices in spec_claims(path):
        uid = f"uid-{ns}-{name}"
        claim = {
            "apiVersion": "resource.k8s.io/v1beta1",
            "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": ns, "uid": uid},
            "spec": {"devices": devices},
        }
        try:
            alloc.allocate(claim, node_name=NODE)
        except AllocationError as e:
            print(f"  {name}: UNALLOCATABLE ({e})")
            failures += 1
            continue
        results = claim["status"]["allocation"]["devices"]["results"]
        devs = [r["device"] for r in results]
        print(f"  {name}: allocated {devs}")
        client.create(RESOURCE_CLAIMS, claim, namespace=ns)
        resp = stub.NodePrepareResources(
            drapb.NodePrepareResourcesRequest(
                claims=[drapb.Claim(uid=uid, name=name, namespace=ns)]
            )
        )
        res = resp.claims[uid]
        if res.error:
            print(f"  {name}: PREPARE FAILED: {res.error}")
            failures += 1
        else:
            cdi_ids = [i for d in res.devices for i in d.cdi_device_ids]
            print(f"  {name}: prepared, CDI {cdi_ids}")
            for key, value in sorted(claim_env(cdi_root, uid).items()):
                print(f"      {key}={value}")
        uresp = stub.NodeUnprepareResources(
            drapb.NodeUnprepareResourcesRequest(
                claims=[drapb.Claim(uid=uid, name=name, namespace=ns)]
            )
        )
        if uresp.claims[uid].error:
            print(f"  {name}: UNPREPARE FAILED: {uresp.claims[uid].error}")
            failures += 1
        alloc.deallocate(uid)
        client.delete(RESOURCE_CLAIMS, name, namespace=ns)
    return failures


def claim_env(cdi_root, uid) -> dict[str, str]:
    """Env the claim's CDI spec would inject into the pod."""
    env: dict[str, str] = {}
    for spec_path in glob.glob(os.path.join(cdi_root, "*.json")):
        if uid not in os.path.basename(spec_path):
            continue
        with open(spec_path) as f:
            spec = json.load(f)
        for dev in spec.get("devices", []):
            for kv in dev.get("containerEdits", {}).get("env", []) or []:
                k, _, v = kv.partition("=")
                env[k] = v
        for kv in spec.get("containerEdits", {}).get("env", []) or []:
            k, _, v = kv.partition("=")
            env[k] = v
    return env


if __name__ == "__main__":
    raise SystemExit(main())
