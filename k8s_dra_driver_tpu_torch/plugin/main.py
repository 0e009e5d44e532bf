"""tpu-dra-plugin entrypoint.

CLI analog of the reference's plugin main (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/main.go:69-206): every flag has an env-var mirror,
directories are created up front, and the process serves until SIGINT/SIGTERM.

Run on a GPU host (the chips come from NVML):
    python -m k8s_dra_driver_tpu_torch.plugin.main --node-name=$NODE_NAME

Run hermetically (no hardware, no cluster) for development:
    python -m k8s_dra_driver_tpu_torch.plugin.main --node-name=dev \
        --fake-topology=2x2x1 --fake-generation=v5p --no-kube

The port's copy of the reference module: the same flags and the same
``main``. Without a ``--fake-*`` flag the chips come from NVML
(``RealChipLib``), and an NVML failure stops the plugin: it never falls
back to the fake. The kubelet reaches the services on the two unix
sockets (``--plugin-root``'s ``dra.sock`` and ``--registrar-root``'s
``<driver>-dra.sock``), served by ``grpc_uds`` without ``grpcio``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional

from ..kube.client import NODES
from ..tpulib.chiplib import ChipLib, ChipLibConfig, FakeChipLib, RealChipLib
from ..utils.cli import env as _env
from ..utils.cli import add_kube_client_flags, install_signal_stop, make_kube_client
from .driver import Driver, DriverConfig

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-dra-plugin",
        description="TPU DRA kubelet plugin (node agent)",
    )
    from ..version import version_string

    p.add_argument("--version", action="version",
                   version=version_string())
    p.add_argument("--node-name", default=_env("NODE_NAME"),
                   help="name of the node this plugin runs on [NODE_NAME]")
    p.add_argument("--driver-name", default=_env("DRIVER_NAME", "tpu.google.com"),
                   help="DRA driver name [DRIVER_NAME]")
    p.add_argument("--cdi-root", default=_env("CDI_ROOT", "/var/run/cdi"),
                   help="directory for CDI spec files [CDI_ROOT]")
    p.add_argument("--plugin-root",
                   default=_env("PLUGIN_ROOT", "/var/lib/kubelet/plugins/tpu.google.com"),
                   help="kubelet plugin dir (DRA socket) [PLUGIN_ROOT]")
    p.add_argument("--registrar-root",
                   default=_env("REGISTRAR_ROOT", "/var/lib/kubelet/plugins_registry"),
                   help="kubelet plugin-watcher dir [REGISTRAR_ROOT]")
    p.add_argument("--state-root", default=_env("STATE_ROOT", "/var/lib/tpu-dra"),
                   help="driver state dir (checkpoint, sharing) [STATE_ROOT]")
    p.add_argument("--device-classes",
                   default=_env("DEVICE_CLASSES", "chip,tensorcore,ici"),
                   help="comma-separated device classes to serve [DEVICE_CLASSES]")
    p.add_argument("--plugin-api-versions",
                   default=_env("PLUGIN_API_VERSIONS", "auto"),
                   help="versions advertised to the kubelet plugin "
                        "watcher: 'auto' probes the node's kubeletVersion "
                        "(1.31 -> '1.0.0', 1.32+ -> 'v1beta1.DRAPlugin'); "
                        "or a comma-separated explicit list (both DRA gRPC "
                        "services are always served) [PLUGIN_API_VERSIONS]")
    p.add_argument("--dev-root", default=_env("DEV_ROOT", ""),
                   help="host root containing /dev; defaults to the driver "
                        "root when that is a dev root, else / [DEV_ROOT]")
    p.add_argument("--sysfs-root", default=_env("SYSFS_ROOT", "/sys"),
                   help="sysfs mount [SYSFS_ROOT]")
    p.add_argument("--driver-root", default=_env("DRIVER_ROOT", "/"),
                   help="HOST path of the driver installation (libcuda, "
                        "libnvidia-ml, nvidia-smi); "
                        "emitted in CDI hostPath fields [DRIVER_ROOT]")
    p.add_argument("--driver-root-ctr-path",
                   default=_env("DRIVER_ROOT_CTR_PATH", ""),
                   help="where --driver-root is mounted inside THIS "
                        "container (the layered search runs here); default: "
                        "same as --driver-root [DRIVER_ROOT_CTR_PATH]")
    p.add_argument("--kubeconfig", default=_env("KUBECONFIG", ""),
                   help="kubeconfig path (default: in-cluster) [KUBECONFIG]")
    add_kube_client_flags(p)
    p.add_argument("--no-kube", action="store_true",
                   help="run without a Kubernetes API server (dev mode)")
    p.add_argument("--fake-topology", default=_env("FAKE_TOPOLOGY", ""),
                   help="serve a fake chip backend with this topology, e.g. 2x2x1")
    p.add_argument("--fake-generation", default=_env("FAKE_GENERATION", "v5p"))
    p.add_argument("--fake-hosts", type=int,
                   default=int(_env("FAKE_HOSTS", "1") or 1),
                   help="hosts the fake slice spans; each node's position "
                        "comes from its tpu.google.com/fake-host-id label "
                        "(multi-node kind, the nvkind analog) [FAKE_HOSTS]")
    p.add_argument("--http-port", type=int, default=int(_env("HTTP_PORT", "0")),
                   help="metrics/health endpoint port; 0 disables [HTTP_PORT]")
    p.add_argument("--audit-interval", type=float,
                   default=float(_env("AUDIT_INTERVAL", "300") or 300),
                   help="seconds between state-drift audit passes "
                        "(checkpoint vs CDI vs ResourceSlices vs chip "
                        "inventory); 0 disables [AUDIT_INTERVAL]")
    p.add_argument("--rebalance-interval", type=float,
                   default=float(_env("REBALANCE_INTERVAL", "60") or 60),
                   help="seconds between dynamic-sharing rebalance passes "
                        "(SLO-aware share moves between ProcessShared "
                        "co-tenants); 0 disables [REBALANCE_INTERVAL]")
    p.add_argument("--defrag-execute", action="store_true",
                   default=_env("DEFRAG_EXECUTE", "") == "1",
                   help="execute defrag migration plans instead of "
                        "serving them advisory-only; takes effect once "
                        "an allocator-wired executor is attached via "
                        "Driver.enable_defrag_execution "
                        "[DEFRAG_EXECUTE=1]")
    p.add_argument("--log-level", default=_env("LOG_LEVEL", ""),
                   help="log level; empty falls back to TPU_DRA_LOG_LEVEL "
                        "then INFO [LOG_LEVEL]")
    p.add_argument("--log-json", action="store_true",
                   help="structured JSON logs (TPU_DRA_LOG_FORMAT=json "
                        "is the env equivalent) [LOG_JSON]")
    return p


def resolve_roots(args):
    """Driver-root layering (root.go:64-81 analog): the search runs at the
    container-visible mount; an unset --dev-root falls back to the driver
    root when that contains dev/, else /. Logs what was discovered so a
    misconfigured mount is visible at startup."""
    from ..tpulib.driverroot import DriverRoot, DriverRootError

    ctr = args.driver_root_ctr_path or args.driver_root
    droot = DriverRoot(root=ctr, host_root=args.driver_root)
    dev_root = args.dev_root or droot.dev_root()
    libs = droot.driver_libraries()
    try:
        smi = droot.find_binary("nvidia-smi")
    except DriverRootError:
        smi = None
    logger.info(
        "driver root %s (at %s): libraries=%s nvidia-smi=%s dev_root=%s",
        args.driver_root, ctr, sorted(libs.values()) or "<none>",
        smi or "<none>", dev_root,
    )
    return dev_root, ctr


FAKE_HOST_ID_LABEL = "tpu.google.com/fake-host-id"


def make_chiplib(args, dev_root: str, fake_host_id: int = 0) -> ChipLib:
    if args.fake_topology:
        return FakeChipLib(
            generation=args.fake_generation,
            topology=args.fake_topology,
            host_id=fake_host_id,
            hosts_per_slice=max(args.fake_hosts, 1),
        )
    return RealChipLib(
        ChipLibConfig(dev_root=dev_root, sysfs_root=args.sysfs_root)
    )


def resolve_registration_versions(
    spec: str, node: Optional[dict], node_name: str
) -> tuple:
    """Registration version strings to advertise on the kubelet plugin
    watcher socket.

    "auto" probes the node's kubeletVersion (from the Node object the
    plugin fetched at startup anyway — no extra API round-trip) and
    picks the scheme that generation understands: 1.31 semver-parses
    the list so it gets exactly ("1.0.0",); 1.32+ selects the DRA gRPC
    service by name so it gets ("v1beta1.DRAPlugin", "1.0.0"). Removes
    the deploy-time foot-gun where helm plugin.apiVersions had to be
    flipped by hand per cluster generation (registration fails outright
    when held wrong). Probe failures fall back to the 1.31-safe list,
    loudly.
    """
    versions = tuple(v.strip() for v in spec.split(",") if v.strip())
    if versions != ("auto",):
        return versions
    fallback = ("1.0.0",)
    try:
        raw = node["status"]["nodeInfo"]["kubeletVersion"]  # e.g. "v1.32.1"
        major, minor = raw.lstrip("v").split(".")[:2]
        new_scheme = (int(major), int(minor)) >= (1, 32)
    except Exception:
        logger.warning(
            "could not probe kubeletVersion for %s; advertising the "
            "k8s 1.31 scheme %s", node_name, fallback,
        )
        return fallback
    chosen = ("v1beta1.DRAPlugin", "1.0.0") if new_scheme else fallback
    logger.info(
        "kubelet %s on %s: advertising registration versions %s",
        raw, node_name, chosen,
    )
    return chosen


def fetch_node(client, node_name: str) -> Optional[dict]:
    """The plugin's own Node object, fetched ONCE at startup; uid,
    kubeletVersion, and fake-host labels all derive from it (three
    separate GETs would triple the API load of a DaemonSet rollout)."""
    if client is None:
        return None
    try:
        return client.get(NODES, node_name)
    except Exception:
        logger.warning("could not fetch node %s", node_name)
        return None


def lookup_node_uid(node: Optional[dict], node_name: str) -> str:
    if node is None:
        logger.warning("could not resolve node UID for %s", node_name)
        return ""
    return node["metadata"].get("uid", "")


def lookup_fake_host_id(
    node: Optional[dict], node_name: str, fake_hosts: int = 1
) -> int:
    """This node's position in a multi-node fake slice, from its node
    label (a DaemonSet cannot vary env per node; the real backend reads
    TPU_WORKER_ID from the platform instead). Absent label = host 0 —
    loudly, because two unlabeled nodes would both publish host 0's
    coordinate block (duplicate devices, missing remainder)."""
    if node is None:
        if fake_hosts > 1:
            logger.warning(
                "--fake-hosts=%d but node %s could not be read (no kube "
                "client, or the fetch failed); defaulting to host 0 — "
                "every such node publishes host 0's coordinate block "
                "(duplicate devices, missing remainder)",
                fake_hosts, node_name,
            )
        return 0
    labels = node["metadata"].get("labels") or {}
    if FAKE_HOST_ID_LABEL not in labels:
        logger.warning(
            "--fake-hosts > 1 but node %s carries no %s label; "
            "defaulting to host 0 — label each worker 0..N-1 or the "
            "published slice will be wrong",
            node_name, FAKE_HOST_ID_LABEL,
        )
        return 0
    try:
        return int(labels[FAKE_HOST_ID_LABEL] or 0)
    except ValueError:
        logger.warning("malformed %s on %s; using host 0",
                       FAKE_HOST_ID_LABEL, node_name)
        return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils import faults
    from ..utils.logging import setup_logging
    from ..utils.metrics import Registry

    # None lets the TPU_DRA_LOG_* env overrides apply; an explicit flag wins.
    setup_logging(level=args.log_level or None,
                  json_format=True if args.log_json else None)
    # Chaos arm point: no-op unless TPU_DRA_FAULTS is set (never in
    # production manifests; here so failure drills run on a real binary).
    faults.arm_from_env()
    if not args.node_name:
        logger.error("--node-name (or NODE_NAME) is required")
        return 2

    registry = Registry()
    kube_client = None
    node_obj = None
    node_uid = ""
    if not args.no_kube:
        kube_client = make_kube_client(
            args.kubeconfig, qps=args.kube_api_qps, burst=args.kube_api_burst,
            registry=registry,
        )
        node_obj = fetch_node(kube_client, args.node_name)
        node_uid = lookup_node_uid(node_obj, args.node_name)

    dev_root, driver_root_ctr = resolve_roots(args)
    fake_host_id = 0
    if args.fake_topology and args.fake_hosts > 1:
        from ..tpulib.topology import MeshShape

        n_chips = MeshShape.parse(args.fake_topology).num_chips
        if n_chips % args.fake_hosts != 0:
            logger.error(
                "--fake-hosts=%d does not divide the %d chips of "
                "--fake-topology=%s; the remainder would silently "
                "vanish from the published slice",
                args.fake_hosts, n_chips, args.fake_topology,
            )
            return 2
        fake_host_id = lookup_fake_host_id(
            node_obj, args.node_name, args.fake_hosts
        )
    config = DriverConfig(
        node_name=args.node_name,
        chiplib=make_chiplib(args, dev_root, fake_host_id),
        kube_client=kube_client,
        driver_name=args.driver_name,
        cdi_root=args.cdi_root,
        plugin_root=args.plugin_root,
        registrar_root=args.registrar_root,
        state_root=args.state_root,
        driver_root=args.driver_root,
        driver_root_ctr_path=driver_root_ctr,
        device_classes=frozenset(args.device_classes.split(",")),
        node_uid=node_uid,
        registration_versions=resolve_registration_versions(
            args.plugin_api_versions, node_obj, args.node_name
        ),
        audit_interval_seconds=args.audit_interval,
        rebalance_interval_seconds=args.rebalance_interval,
        defrag_execute=args.defrag_execute,
    )
    driver = Driver(config, registry=registry)
    driver.start()
    metrics = None
    if args.http_port:
        from ..utils.metrics import MetricsServer

        metrics = MetricsServer(driver.registry, port=args.http_port,
                                tracer=driver.tracer)
        for name, check in driver.readiness_checks().items():
            metrics.add_readiness_check(name, check)
        # Non-critical: these failing reads "degraded" (200), not dead —
        # an apiserver outage must not flip the DaemonSet readinessProbe.
        for name, check in driver.degraded_checks().items():
            metrics.add_readiness_check(name, check, critical=False)
        metrics.set_usage_provider(driver.usage.snapshot)
        metrics.set_rebalance_provider(driver.rebalancer.snapshot)
        metrics.start()
        logger.info("metrics on :%d/metrics (+/readyz, /debug/traces, "
                    "/debug/usage, /debug/rebalance)", metrics.port)
    logger.info(
        "tpu-dra-plugin started: node=%s devices=%d",
        args.node_name,
        len(driver.state.allocatable),
    )

    stop = install_signal_stop()
    stop.wait()
    if metrics is not None:
        metrics.stop()
    driver.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
