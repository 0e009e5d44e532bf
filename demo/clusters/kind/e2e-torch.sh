#!/usr/bin/env bash
# The kind e2e gate on the PyTorch port's driver: helm-install its image
# (values-h100.yaml, fake H100s) into a real kind cluster, wait for the
# real API server to carry its tpu.google.com ResourceSlices, schedule
# tpu-test1 (one whole GPU through the chip class) with the real
# structured-parameters scheduler, check that the pod saw the
# driver-injected CUDA_VISIBLE_DEVICES, and cross-check the allocation
# against the port's sim allocator (tools/sim_check_allocation_torch.py).
# Twin of e2e.sh.
#
# Requires: docker, kind, kubectl, helm. Exits 3 ("skip") when one is
# absent. A transcript is written next to this script.
set -euo pipefail
for tool in docker kind kubectl helm; do
  if ! command -v "$tool" >/dev/null 2>&1; then
    echo "SKIP: $tool not available; the kind e2e gate needs docker+kind+kubectl+helm" >&2
    exit 3
  fi
done
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_ROOT="$(cd "${SCRIPT_DIR}/../../.." && pwd)"
export CLUSTER_NAME="${CLUSTER_NAME:-tpu-dra-e2e-torch}"
export FAKE_TOPOLOGY="${FAKE_TOPOLOGY:-2x1x1}"
KEEP_CLUSTER="${KEEP_CLUSTER:-0}"
WORK="$(mktemp -d)"

TRANSCRIPT="${SCRIPT_DIR}/e2e-torch-transcript-$(date +%Y%m%d-%H%M%S).log"
exec > >(tee "${TRANSCRIPT}") 2>&1
echo "=== kind e2e gate (the port's driver); transcript: ${TRANSCRIPT}"

cleanup() {
  rm -rf "${WORK}"
  if [ "${KEEP_CLUSTER}" != "1" ]; then
    "${SCRIPT_DIR}/delete-cluster.sh" || true
  fi
}
trap cleanup EXIT

echo "=== 1/5 create cluster (DRA feature gates + CDI)"
"${SCRIPT_DIR}/create-cluster.sh"

echo "=== 2/5 build + load + install the port's driver (fake H100s)"
"${SCRIPT_DIR}/install-dra-driver-torch.sh"

echo "=== 3/5 wait for ResourceSlices from the real API server"
want="${FAKE_TOPOLOGY%%x*}"
deadline=$(( $(date +%s) + 180 ))
while true; do
  count="$(kubectl get resourceslices -o json 2>/dev/null \
    | python3 -c 'import json,sys; d=json.load(sys.stdin); print(sum(len(s["spec"].get("devices",[])) for s in d["items"] if s["spec"].get("driver")=="tpu.google.com"))' \
    || echo 0)"
  if [ "${count}" -ge "${want}" ]; then
    echo "real API server carries ${count} tpu.google.com devices"
    break
  fi
  if [ "$(date +%s)" -ge "${deadline}" ]; then
    echo "FAIL: no tpu.google.com ResourceSlices appeared" >&2
    kubectl get resourceslices -o yaml || true
    kubectl -n tpu-dra get pods -o wide || true
    kubectl -n tpu-dra logs -l app=tpu-dra-plugin --tail=50 || true
    exit 1
  fi
  sleep 3
done
kubectl get resourceslices -o wide

echo "=== 4/5 schedule tpu-test1 (one GPU) through the real scheduler"
kubectl apply -f - <<'YAML'
apiVersion: v1
kind: Namespace
metadata:
  name: tpu-test1
---
apiVersion: resource.k8s.io/v1alpha3
kind: ResourceClaimTemplate
metadata:
  namespace: tpu-test1
  name: single-chip
spec:
  spec:
    devices:
      requests:
        - name: chip
          deviceClassName: tpu.google.com
---
apiVersion: v1
kind: Pod
metadata:
  namespace: tpu-test1
  name: single-gpu
  labels:
    app: tpu-test1
spec:
  restartPolicy: Never
  containers:
    - name: check
      image: python:3.12
      command: ["python", "-c"]
      args:
        - |
          import os
          seen = os.environ.get("CUDA_VISIBLE_DEVICES", "")
          print("CUDA_VISIBLE_DEVICES =", seen)
          assert len([u for u in seen.split(",") if u]) == 1, seen
          print("OK: one GPU")
      resources:
        claims:
          - name: gpu
  resourceClaims:
    - name: gpu
      resourceClaimTemplateName: single-chip
YAML
kubectl -n tpu-test1 wait pod --all \
  --for=jsonpath='{.status.phase}'=Succeeded --timeout=180s
kubectl -n tpu-test1 logs single-gpu

echo "=== 5/5 cross-check the real allocation against the port's sim allocator"
kubectl get resourceslices -o json > "${WORK}/slices.json"
kubectl -n tpu-test1 get resourceclaim -o json > "${WORK}/claims.json"
python3 "${REPO_ROOT}/tools/sim_check_allocation_torch.py" \
  "${WORK}/slices.json" "${WORK}/claims.json"

echo "=== e2e-kind-torch PASSED"
