#!/usr/bin/env python3
"""Cross-check a REAL cluster's DRA allocation against the port's sim.

Twin of ``tools/sim_check_allocation.py`` over
``k8s_dra_driver_tpu_torch``'s allocator: the same inputs, the same
printed lines, the same verdict and exit codes (0 agreement, 1 a
disagreement or empty input, 2 usage). It imports nothing of JAX.

Feeds the real API server's ResourceSlices (kubectl get -o json) into
the ReferenceAllocator and allocates the same claim spec the real
scheduler just placed. Passing means the sim and the real structured-
parameters allocator agree this claim is satisfiable from these slices
— the seam the kind e2e gate closes (a malformed attribute name or pool
shape would satisfy the sim's own publications but never a real
scheduler, or vice versa).

Usage:
  kubectl get resourceslices -o json > /tmp/slices.json
  kubectl -n tpu-test1 get resourceclaim -o json > /tmp/claims.json
  python tools/sim_check_allocation_torch.py /tmp/slices.json /tmp/claims.json
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from k8s_dra_driver_tpu_torch.kube import RESOURCE_SLICES, FakeKubeClient  # noqa: E402
from k8s_dra_driver_tpu_torch.kube.allocator import ReferenceAllocator  # noqa: E402
from k8s_dra_driver_tpu_torch.utils.metrics import Registry  # noqa: E402


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    slices = json.load(open(sys.argv[1]))["items"]
    claims = json.load(open(sys.argv[2]))["items"]
    if not slices:
        print("FAIL: no ResourceSlices in input", file=sys.stderr)
        return 1
    client = FakeKubeClient()
    published_devices = set()
    for s in slices:
        s.setdefault("metadata", {}).pop("resourceVersion", None)
        client.create(RESOURCE_SLICES, s)
        for d in s.get("spec", {}).get("devices", []):
            published_devices.add(d["name"])
    registry = Registry()
    alloc = ReferenceAllocator(client, registry=registry)

    checked = 0
    for claim in claims:
        name = claim["metadata"]["name"]
        real = (claim.get("status") or {}).get("allocation")
        # Re-allocate through the sim from a clean claim copy.
        sim_claim = {
            "metadata": {
                "name": name,
                "namespace": claim["metadata"].get("namespace", ""),
                "uid": f'sim-{claim["metadata"].get("uid", name)}',
            },
            "spec": claim["spec"],
        }
        alloc.allocate(sim_claim)
        sim_devices = [
            r["device"]
            for r in sim_claim["status"]["allocation"]["devices"]["results"]
        ]
        print(f"claim {name}: sim allocates {sim_devices}")
        if real:
            real_devices = [
                r["device"] for r in real["devices"]["results"]
            ]
            print(f"claim {name}: real scheduler allocated {real_devices}")
            missing = [d for d in real_devices if d not in published_devices]
            if missing:
                print(f"FAIL: real allocation names unknown devices "
                      f"{missing}", file=sys.stderr)
                return 1
        checked += 1
    if not checked:
        print("FAIL: no claims in input", file=sys.stderr)
        return 1
    backtracks = alloc._m_backtracks.value()
    print(f"OK: sim agrees all {checked} claim(s) are satisfiable from "
          f"the real cluster's slices ({backtracks:g} solver backtracks)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
