#!/usr/bin/env python3
"""The doctor gate on the PyTorch port: the doctor against the cluster sim.

Twin of ``tools/run_doctor_sim.py`` (the ``make doctor`` gate) on
``k8s_dra_driver_tpu_torch``. It builds the same hermetic cluster --
FakeKubeClient, two node plugins with real debug HTTP servers, the ICI
slice controller -- prepares claims through the plugin's transport
(``kubeletplugin.LocalTransport``: the port serves no kubelet socket), then
drives ``k8s_dra_driver_tpu_torch.doctor`` three times:

1. **clean phase**: the fleet is consistent; the doctor must report zero
   drift (exit 0) and its per-node occupancy must match the sim's
   prepared claims exactly;
2. **drift phase**: an orphaned CDI claim spec and a corrupted
   checkpoint are injected; the node auditors and the doctor must BOTH
   flag them (doctor exit 1);
3. **explain phase**: an unallocatable claim (a selector matching
   nothing) must travel the whole explainability chain -- typed
   ``AllocationError`` reason -> ``/debug/allocations`` record -> the
   doctor's ``explain`` finding carrying the runbook hint (exit non-zero).

Run from the repo root: ``python tools/run_doctor_sim_torch.py``. It needs
no card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import tempfile

sys.path.insert(0, ".")

from k8s_dra_driver_tpu_torch import doctor  # noqa: E402
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
    RUNBOOK_HINTS,
    AllocationError,
    ReferenceAllocator,
)
from k8s_dra_driver_tpu_torch.kube.protos import dra_v1alpha4 as drapb  # noqa: E402
from k8s_dra_driver_tpu_torch.plugin.driver import Driver, DriverConfig  # noqa: E402
from k8s_dra_driver_tpu_torch.tpulib import FakeChipLib  # noqa: E402
from k8s_dra_driver_tpu_torch.utils.metrics import MetricsServer  # noqa: E402

DRIVER = "tpu.google.com"
PREPARE = "/v1beta1.DRAPlugin/NodePrepareResources"


# The fleet-construction helpers below (start_node / prepare / claim_obj
# / seed_claims) are the single source of truth for "a doctor-ready sim
# fleet" on the port: tests/test_torch_doctor.py imports them, so the
# pytest suite and this gate build the same fleet.


def start_node(client, tmp, name, host_id):
    client.create(NODES, {"metadata": {
        "name": name, "uid": f"uid-{name}",
        "labels": {SLICE_LABEL: "slice-1"},
    }})
    cfg = DriverConfig(
        node_name=name,
        chiplib=FakeChipLib(
            generation="v5p", topology="4x2x1", host_id=host_id,
            hosts_per_slice=2, slice_id="slice-1",
        ),
        kube_client=client,
        cdi_root=f"{tmp}/{name}/cdi",
        plugin_root=f"{tmp}/{name}/plugin",
        registrar_root=f"{tmp}/{name}/reg",
        state_root=f"{tmp}/{name}/state",
        node_uid=f"uid-{name}",
        cleanup_interval_seconds=0,
        device_watch_interval_seconds=0,
        audit_interval_seconds=0,  # passes are driven explicitly below
    )
    d = Driver(cfg)
    d.start()
    srv = MetricsServer(d.registry, host="127.0.0.1", port=0,
                        tracer=d.tracer)
    for check_name, check in d.readiness_checks().items():
        srv.add_readiness_check(check_name, check)
    for check_name, check in d.degraded_checks().items():
        srv.add_readiness_check(check_name, check, critical=False)
    srv.set_usage_provider(d.usage.snapshot)
    srv.start()
    return d, srv


def prepare(driver, claim):
    """NodePrepareResources for ``claim`` as a kubelet sends it: encoded by
    the port's codec and answered through the plugin's transport."""
    req = drapb.NodePrepareResourcesRequest(claims=[drapb.Claim(
        uid=claim["metadata"]["uid"],
        name=claim["metadata"]["name"],
        namespace=claim["metadata"]["namespace"],
    )])
    resp = drapb.NodePrepareResourcesResponse.FromString(
        driver.config.transport.call(PREPARE, req.SerializeToString()))
    result = resp.claims[claim["metadata"]["uid"]]
    if result.error:
        raise SystemExit(f"sim prepare failed: {result.error}")


def claim_obj(uid, name):
    return {
        "apiVersion": "resource.k8s.io/v1beta1",
        "kind": "ResourceClaim",
        "metadata": {"name": name, "namespace": "sim", "uid": uid},
        "spec": {"devices": {"requests": [
            {"name": "chip", "deviceClassName": "tpu.google.com"},
        ]}},
    }


def seed_claims(client, drivers, alloc=None):
    """One allocated + prepared single-chip claim per node, auditors
    brought current; returns {node: expected held device names}.
    ``alloc`` lets the caller share the scheduler-sim allocator whose
    decision buffer the debug servers publish."""
    if alloc is None:
        alloc = ReferenceAllocator(client)
    expected = {}
    for i, node in enumerate(sorted(drivers)):
        claim = claim_obj(f"sim-uid-{i}", f"wl-{i}")
        alloc.allocate(claim, node_name=node)
        client.create(RESOURCE_CLAIMS, claim, namespace="sim")
        prepare(drivers[node], claim)
        expected[node] = {
            r["device"]
            for r in claim["status"]["allocation"]["devices"]["results"]
        }
    for d in drivers.values():
        d.auditor.run_once()
    return expected


def main() -> int:
    failures: list[str] = []
    with tempfile.TemporaryDirectory(prefix="tpu-dra-doctor-sim-") as tmp:
        client = FakeKubeClient()
        drivers, servers = {}, {}
        for i, name in enumerate(["node-a", "node-b"]):
            drivers[name], servers[name] = start_node(client, tmp, name, i)
        mgr = IciSliceManager(client)
        mgr.start()
        # The scheduler-sim allocator; its solve-decision buffer is
        # published at every node's /debug/allocations so the doctor's
        # `explain` cross-check sees it.
        alloc = ReferenceAllocator(client)
        for srv in servers.values():
            srv.set_allocations_provider(alloc.export_allocations_jsonl)
        try:
            expected_holds = seed_claims(client, drivers, alloc)

            urls = {
                name: f"http://127.0.0.1:{srv.port}"
                for name, srv in servers.items()
            }

            # Phase 1: a consistent fleet must diagnose CLEAN, with
            # occupancy matching the prepared claims exactly.
            bundle = f"{tmp}/bundle.tar"
            report, findings, status = doctor.run(
                urls, kube_client=client, bundle=bundle,
            )
            print(report)
            drift = [f for f in findings
                     if f.severity == doctor.SEVERITY_DRIFT]
            if status != 0 or drift:
                failures.append(
                    f"clean phase: expected no drift, got status={status} "
                    f"findings={[str(f) for f in findings]}"
                )
            for name, want in expected_holds.items():
                scrape = doctor.collect_node(name, urls[name])
                got = {
                    d["name"] for h in scrape.holds
                    for d in h.get("devices", [])
                }
                if got != want:
                    failures.append(
                        f"{name}: /debug/usage holds {sorted(got)} != "
                        f"prepared {sorted(want)}"
                    )

            # Phase 2: inject the crash artifacts; both the node auditor
            # and the doctor must flag them.
            victim = drivers["node-a"]
            victim.state.cdi.create_claim_spec_file("uid-orphan", {}, {})
            ckpt_path = victim.state.checkpoint.path
            with open(ckpt_path) as f:
                torn = f.read()
            with open(ckpt_path, "w") as f:
                f.write(torn[: len(torn) // 2])
            node_findings = victim.auditor.run_once()
            if not any(f.check == "cdi" for f in node_findings):
                failures.append("auditor missed the orphaned CDI spec")
            if not any(f.check == "checkpoint" for f in node_findings):
                failures.append("auditor missed the corrupt checkpoint")
            report2, findings2, status2 = doctor.run(
                urls, kube_client=client,
            )
            if status2 != 1 or not any(
                f.check == "node-audit" for f in findings2
            ):
                failures.append(
                    f"drift phase: doctor did not flag the injected "
                    f"drift (status={status2}, findings="
                    f"{[str(f) for f in findings2]})"
                )

            # Phase 3: "why won't my claim schedule?" -- a selector no
            # published device satisfies must surface the SAME terminal
            # reason in the AllocationError, the /debug/allocations
            # record, and the doctor's explain finding (hint included).
            bad = claim_obj("sim-uid-unsat", "wl-unsat")
            bad["spec"]["devices"]["requests"][0]["selectors"] = [{
                "cel": {"expression":
                        "device.attributes['tpu.google.com'].type == "
                        "'optical-interconnect'"},
            }]
            try:
                alloc.allocate(bad)
                failures.append("explain phase: unsat claim allocated")
            except AllocationError as e:
                if e.reason != "request-cel":
                    failures.append(
                        f"explain phase: terminal reason {e.reason!r}, "
                        "want 'request-cel'"
                    )
            client.create(RESOURCE_CLAIMS, bad, namespace="sim")
            report3, findings3, status3 = doctor.run(
                urls, kube_client=client,
            )
            hint = RUNBOOK_HINTS["request-cel"]
            if status3 == 0 or not any(
                f.check == "explain" for f in findings3
            ):
                failures.append(
                    f"explain phase: doctor did not flag the "
                    f"unallocatable claim (status={status3}, findings="
                    f"{[str(f) for f in findings3]})"
                )
            elif hint not in report3:
                failures.append(
                    "explain phase: runbook hint missing from the "
                    "doctor report"
                )
        finally:
            mgr.stop(cleanup=False)
            for name in drivers:
                servers[name].stop()
                drivers[name].shutdown()
    if failures:
        print(json.dumps(failures, indent=2), file=sys.stderr)
        print(f"doctor sim gate: {len(failures)} failure(s)",
              file=sys.stderr)
        return 1
    print("doctor sim gate: clean fleet diagnosed clean, injected drift "
          "caught, unallocatable claim explained", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
