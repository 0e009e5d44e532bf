"""The DRA node service and the kubelet registration service, without
``grpc``.

The port's twin of the reference's ``plugin/grpc_services.py``. The card's
machine has neither ``grpcio`` nor ``protobuf``, so this module keeps only
what does not need them: the service names, the per-RPC span and call
logging (``_traced``), and the servicer bases the Driver and the
registration service implement. The reference's ``add_*_to_server``
functions and its client stubs have no twin here: a servicer is reached
through the transport the ``KubeletPlugin`` is given
(``kubeletplugin.LocalTransport``, in process). A kubelet socket (gRPC
over HTTP/2 on a unix socket, written by hand over ``kube/protos/wire.py``)
is ROADMAP item A15f. The served APIs are wire-compatible with what
kubelet speaks to the reference driver (lengrongfu/k8s-dra-driver
vendor/k8s.io/kubelet/pkg/apis/dra/v1alpha4/api.proto and
pluginregistration/v1/api.proto).
"""

from __future__ import annotations

import logging

from ..utils.tracing import Span, Tracer

logger = logging.getLogger(__name__)

DRA_SERVICE_NAME = "v1alpha3.Node"
# k8s 1.32 moved the DRA gRPC service to v1beta1.DRAPlugin
# (k8s.io/kubelet/pkg/apis/dra/v1beta1). The message wire format is
# field-identical — protobuf carries no type names on the wire — so one
# implementation serves both names and either kubelet generation connects.
DRA_SERVICE_NAME_V1BETA1 = "v1beta1.DRAPlugin"
DRA_SERVICE_NAMES = (DRA_SERVICE_NAME, DRA_SERVICE_NAME_V1BETA1)
REGISTRATION_SERVICE_NAME = "pluginregistration.Registration"


def _claim_uids(request) -> str:
    """Claim UIDs carried by a DRA request, for the per-RPC log line."""
    claims = getattr(request, "claims", None)
    if not claims:
        return "-"
    return ",".join(c.uid for c in claims)


def _traced(service: str, method: str, fn, tracer: Tracer | None = None):
    """Per-RPC root span + call logging at debug verbosity: method, claim
    UIDs, and latency — the signal needed to debug a misbehaving kubelet.
    The vendored reference framework logs every DRA RPC the same way at
    verbosity >=4 (vendor/k8s.io/dynamic-resource-allocation/
    kubeletplugin/draplugin.go:89-94); here the timing is span-backed so
    the same interval feeds logs, traces, and latency histograms. Without
    a tracer the span is a no-op that still measures duration."""

    def wrapper(request, context):
        uids = _claim_uids(request)
        logger.debug("gRPC %s/%s called: claims=%s", service, method, uids)
        span = (
            tracer.span(f"rpc/{method}",
                        claim_uid=uids if uids != "-" else "",
                        tags={"service": service})
            if tracer is not None
            else Span(None, f"rpc/{method}")
        )
        try:
            with span:
                response = fn(request, context)
        except Exception as e:
            logger.debug("gRPC %s/%s failed after %.1fms: %s",
                         service, method, span.duration * 1e3, e)
            raise
        logger.debug("gRPC %s/%s succeeded in %.1fms",
                     service, method, span.duration * 1e3)
        return response

    return wrapper


# ---------------------------------------------------------------------------
# DRA Node service
# ---------------------------------------------------------------------------


class NodeServicer:
    """Service interface (implemented by plugin.driver.Driver)."""

    def NodePrepareResources(self, request, context):
        raise NotImplementedError

    def NodeUnprepareResources(self, request, context):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Kubelet plugin registration service
# ---------------------------------------------------------------------------


class RegistrationServicer:
    """Served by the plugin on the registration UDS
    (registrationserver.go:37-54 analog)."""

    def GetInfo(self, request, context):
        raise NotImplementedError

    def NotifyRegistrationStatus(self, request, context):
        raise NotImplementedError
