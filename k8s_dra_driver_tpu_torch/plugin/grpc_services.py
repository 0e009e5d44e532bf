"""The DRA node service and the kubelet registration service, without
``grpc``.

The port's twin of the reference's ``plugin/grpc_services.py``. The card's
machine has neither ``grpcio`` nor ``protobuf``, so this module keeps what
does not need them: the service names, the per-RPC span and call logging
(``_traced``), the servicer bases the Driver and the registration service
implement, and the client stubs :class:`NodeStub` and
:class:`RegistrationStub`. Where the reference registers servicers on a
``grpc.server`` (``add_*_to_server``), the port's ``KubeletPlugin`` hands
``kubeletplugin.method_table`` to its transport: ``grpc_uds``'s gRPC over
HTTP/2 on the two unix sockets, written by hand over
``kube/protos/wire.py``, or ``kubeletplugin.LocalTransport`` in process.
A stub takes any channel with ``call(method_path, request_bytes,
timeout)``: ``grpc_uds.Channel`` on a socket, or a transport itself. The
served APIs are wire-compatible with what kubelet speaks to the reference
driver (lengrongfu/k8s-dra-driver
vendor/k8s.io/kubelet/pkg/apis/dra/v1alpha4/api.proto and
pluginregistration/v1/api.proto).
"""

from __future__ import annotations

import logging
from typing import Optional

from ..kube.protos import dra_v1alpha4 as drapb
from ..kube.protos import pluginregistration_v1 as regpb
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
# A stub call's deadline unless the caller gives one.
CALL_TIMEOUT_S = 30.0


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


class _UnaryUnary:
    """One method of a stub: the request encoded by the wire codec, sent
    through ``channel.call``, the reply decoded."""

    def __init__(self, channel, method_path: str, reply_cls):
        self.channel = channel
        self.method_path = method_path
        self.reply_cls = reply_cls

    def __call__(self, request, timeout: Optional[float] = CALL_TIMEOUT_S):
        return self.reply_cls.FromString(self.channel.call(
            self.method_path, request.SerializeToString(), timeout))


class NodeStub:
    """Client stub (a kubelet's side). ``service_name`` selects the
    kubelet generation to impersonate: the v1alpha3 Node service (k8s
    1.31) or v1beta1.DRAPlugin (1.32+)."""

    def __init__(self, channel, service_name: str = DRA_SERVICE_NAME):
        self.NodePrepareResources = _UnaryUnary(
            channel, f"/{service_name}/NodePrepareResources",
            drapb.NodePrepareResourcesResponse)
        self.NodeUnprepareResources = _UnaryUnary(
            channel, f"/{service_name}/NodeUnprepareResources",
            drapb.NodeUnprepareResourcesResponse)


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


class RegistrationStub:
    """Client stub (role of kubelet's plugin watcher)."""

    def __init__(self, channel):
        self.GetInfo = _UnaryUnary(
            channel, f"/{REGISTRATION_SERVICE_NAME}/GetInfo",
            regpb.PluginInfo)
        self.NotifyRegistrationStatus = _UnaryUnary(
            channel, f"/{REGISTRATION_SERVICE_NAME}/NotifyRegistrationStatus",
            regpb.RegistrationStatusResponse)
