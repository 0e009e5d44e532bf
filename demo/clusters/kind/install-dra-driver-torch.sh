#!/usr/bin/env bash
# Build the PyTorch port's driver image (deployments/container/
# Dockerfile.torch), load it into kind, and install the unchanged chart
# with values-h100.yaml and a fake H100 topology, so that the DRA path
# (ResourceSlices -> scheduler -> NodePrepareResources -> CDI) runs the
# port's plugin without GPUs. Twin of install-dra-driver.sh.
#
# Requires: docker, kind, kubectl, helm (the chart carries the H100
# overlay; the raw manifests name the TPU image). Exits 3 ("skip") when
# one is absent.
set -euo pipefail
for tool in docker kind kubectl helm; do
  if ! command -v "$tool" >/dev/null 2>&1; then
    echo "SKIP: $tool not available; installing the port's driver needs docker+kind+kubectl+helm" >&2
    exit 3
  fi
done
SCRIPT_DIR="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
REPO_ROOT="$(cd "${SCRIPT_DIR}/../../.." && pwd)"
CHART="${REPO_ROOT}/deployments/helm/tpu-dra-driver"

CLUSTER_NAME="${CLUSTER_NAME:-tpu-dra}"
IMAGE="${IMAGE:-tpu-dra-driver-torch}"
TAG="${TAG:-latest}"
# Two fake H100s on the node (the fake backend's GPUs take a 1-D
# topology: N x 1 x 1).
FAKE_TOPOLOGY="${FAKE_TOPOLOGY:-2x1x1}"

docker build -t "${IMAGE}:${TAG}" \
  -f "${REPO_ROOT}/deployments/container/Dockerfile.torch" "${REPO_ROOT}"
kind load docker-image --name "${CLUSTER_NAME}" "${IMAGE}:${TAG}"

# values-h100.yaml selects GPU nodes by the label NVIDIA's GPU Feature
# Discovery sets; kind's workers (labelled for the plugin by
# create-cluster.sh) carry it here by hand.
for node in $(kubectl get nodes -l tpu.google.com/chips=true -o name); do
  kubectl label "${node}" nvidia.com/gpu.present=true --overwrite
done

helm upgrade --install tpu-dra-driver "${CHART}" \
  -f "${CHART}/values-h100.yaml" \
  --set image.repository="${IMAGE}" \
  --set image.tag="${TAG}" \
  --set plugin.fakeTopology="${FAKE_TOPOLOGY}" \
  --set plugin.fakeGeneration=h100

kubectl -n tpu-dra rollout status daemonset/tpu-dra-plugin --timeout=180s
echo "the port's driver installed; GPUs published:"
kubectl get resourceslices -o wide
