"""Shared CLI plumbing for the plugin and controller entrypoints.

Role of the reference's pkg/flags (lengrongfu/k8s-dra-driver,
pkg/flags/{kubeclient,logging}.go): the env-mirrored flag helpers, kube
client bootstrap, and signal wiring both binaries share.
"""

from __future__ import annotations

import os
import signal
import threading


def env(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def make_kube_client(kubeconfig: str = "", qps: float = 5.0, burst: int = 10,
                     registry=None):
    """In-cluster config unless a kubeconfig is given
    (NewClientSets analog, pkg/flags/kubeclient.go:70-106; QPS/burst
    defaults mirror kubeclient.go:49-64). ``registry`` receives the
    client's API-request/retry counters when given."""
    from ..kube.client import RealKubeClient, RestConfig

    cfg = (
        RestConfig.from_kubeconfig(kubeconfig)
        if kubeconfig
        else RestConfig.auto()
    )
    return RealKubeClient(cfg, qps=qps, burst=burst, registry=registry)


def add_kube_client_flags(parser) -> None:
    """--kube-api-qps/--kube-api-burst with env mirrors (the reference's
    kube-client flag block, pkg/flags/kubeclient.go:40-68)."""
    parser.add_argument(
        "--kube-api-qps",
        type=float,
        default=float(env("KUBE_API_QPS", "5")),
        help="client-side QPS limit toward the API server (<=0 disables)",
    )
    parser.add_argument(
        "--kube-api-burst",
        type=int,
        default=int(env("KUBE_API_BURST", "10")),
        help="client-side burst allowance toward the API server",
    )


def install_signal_stop() -> threading.Event:
    """SIGINT/SIGTERM → Event (signal loop analog, plugin main.go:177-205)."""
    stop = threading.Event()

    def handle(signum, frame):
        import logging

        logging.getLogger(__name__).info(
            "received signal %d; shutting down", signum
        )
        stop.set()

    signal.signal(signal.SIGINT, handle)
    signal.signal(signal.SIGTERM, handle)
    return stop
