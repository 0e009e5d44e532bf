"""tpu-dra-controller entrypoint.

CLI analog of the reference's controller main (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-controller/main.go:73-241): metrics + health HTTP endpoint and
the ICI slice manager, started only when the ``ici`` device class is enabled
(main.go:171-176 analog).
"""

from __future__ import annotations

import argparse
import logging
import sys

from ..kube.events import EventRecorder
from ..utils.cli import env as _env
from ..utils.cli import add_kube_client_flags, install_signal_stop, make_kube_client
from ..utils.metrics import Gauge, MetricsServer, Registry
from ..utils.tracing import Tracer
from .slice_manager import IciSliceManager

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-dra-controller",
        description="TPU DRA cluster controller (ICI channel publisher)",
    )
    from ..version import version_string

    p.add_argument("--version", action="version",
                   version=version_string())
    p.add_argument("--driver-name", default=_env("DRIVER_NAME", "tpu.google.com"))
    p.add_argument("--pod-name", default=_env("POD_NAME", ""),
                   help="controller pod name, for slice ownerReferences [POD_NAME]")
    p.add_argument("--pod-uid", default=_env("POD_UID", ""))
    p.add_argument("--namespace", default=_env("NAMESPACE", "default"))
    p.add_argument("--device-classes",
                   default=_env("DEVICE_CLASSES", "chip,tensorcore,ici"))
    p.add_argument("--http-port", type=int,
                   default=int(_env("HTTP_PORT", "8080")),
                   help="metrics/health endpoint port; 0 disables")
    p.add_argument("--kubeconfig", default=_env("KUBECONFIG", ""))
    add_kube_client_flags(p)
    p.add_argument("--cleanup-on-exit", action="store_true",
                   help="delete published ResourceSlices on shutdown. Only "
                        "for decommissioning: a rolling restart must NOT "
                        "clean up, or channel offsets lose their recovery "
                        "source and domains get renumbered under live claims")
    p.add_argument("--log-level", default=_env("LOG_LEVEL", ""),
                   help="log level; empty falls back to TPU_DRA_LOG_LEVEL "
                        "then INFO [LOG_LEVEL]")
    p.add_argument("--log-json", action="store_true",
                   help="structured JSON logs (TPU_DRA_LOG_FORMAT=json "
                        "is the env equivalent) [LOG_JSON]")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils import faults
    from ..utils.logging import setup_logging

    # None lets the TPU_DRA_LOG_* env overrides apply; an explicit flag wins.
    setup_logging(level=args.log_level or None,
                  json_format=True if args.log_json else None)
    faults.arm_from_env()  # chaos drills only; no-op unless TPU_DRA_FAULTS

    registry = Registry()
    tracer = Tracer()
    domains_gauge = Gauge(
        "tpu_dra_ici_domains", "Known ICI slice domains", registry
    )
    ici_enabled = "ici" in args.device_classes.split(",")

    # Liveness must be served BEFORE any API-server round-trip: dialect
    # discovery / the manager's seed list can stall for minutes against a
    # slow apiserver, and a dead /healthz during that window crash-loops
    # the pod. Readiness reports "starting" until the manager is up.
    managed = {"manager": None}

    def _slice_manager_ready():
        if managed["manager"] is None:
            return False, "slice manager starting"
        return managed["manager"].healthy()

    metrics = None
    if args.http_port:
        metrics = MetricsServer(registry, port=args.http_port, tracer=tracer)
        if ici_enabled:
            metrics.add_readiness_check("slice-manager", _slice_manager_ready)
        metrics.start()
        logger.info("metrics on :%d/metrics (+/readyz, /debug/traces)",
                    metrics.port)

    client = make_kube_client(
        args.kubeconfig, qps=args.kube_api_qps, burst=args.kube_api_burst,
        registry=registry,
    )

    manager = None
    if ici_enabled:
        owner = None
        if args.pod_name and args.pod_uid:
            owner = {
                "apiVersion": "v1",
                "kind": "Pod",
                "name": args.pod_name,
                "uid": args.pod_uid,
            }
        recorder = EventRecorder(
            client, component="tpu-dra-controller",
            namespace=args.namespace, registry=registry,
        )
        manager = IciSliceManager(
            client, args.driver_name, owner=owner,
            registry=registry, tracer=tracer, events=recorder,
        )
        manager.start()
        managed["manager"] = manager
        logger.info("ICI slice manager started")

    stop = install_signal_stop()
    import time as _time

    # Channel-occupancy refresh is a full cluster-wide claims LIST, so
    # it runs on its own gentle cadence, not the 10s status tick — its
    # consumers (Prometheus, the doctor) sample far slower than that.
    occupancy_interval = 60.0
    next_occupancy = 0.0
    while not stop.wait(timeout=10):
        if manager is not None:
            domains_gauge.set(len(manager.domains()))
            now = _time.monotonic()
            if now >= next_occupancy:
                manager.refresh_channel_occupancy()
                next_occupancy = now + occupancy_interval
    if manager is not None:
        manager.stop(cleanup=args.cleanup_on_exit)
    if metrics is not None:
        metrics.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
