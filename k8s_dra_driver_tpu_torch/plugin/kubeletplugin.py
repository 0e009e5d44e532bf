"""Kubelet-plugin framework: the registration and DRA node services behind
a transport, plus ResourceSlice publication.

The port's twin of the reference's ``plugin/kubeletplugin.py``, itself a
re-implementation of the vendored framework the reference builds on
(lengrongfu/k8s-dra-driver, vendor/k8s.io/dynamic-resource-allocation/
kubeletplugin/draplugin.go:263-420, registrationserver.go). It serves

1. the **registration service**, ``pluginregistration.Registration``
   (GetInfo/NotifyRegistrationStatus);
2. the **DRA node service**, ``v1alpha3.Node`` and ``v1beta1.DRAPlugin``
   (NodePrepareResources/NodeUnprepareResources);

plus lazy ResourceSlice publication via ``publish_resources``
(draplugin.go:376-420 analog).

Where the reference starts two ``grpc.server``s on unix sockets, the
port hands both services (:func:`method_table`) to a transport, since the
machine with the card has no ``grpcio``:

- ``grpc_uds.SocketTransport``, the default, serves them as gRPC over
  HTTP/2 on the two unix sockets, written by hand: the DRA node methods
  on ``plugin_socket``, the registration methods on
  ``registrar_socket``, as the reference splits them;
- :class:`LocalTransport` dispatches them in process: a gRPC full method
  name and the request's bytes (``kube/protos/wire.py``) in, the reply's
  bytes out. Callers that run many plugins in one process (the fleet
  soak, the doctor's simulated fleet) take it.

Both answer ``call(method_path, request_bytes)``; the socket transport
goes through its own client over the real socket.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..kube.client import KubeClient
from ..kube.protos import dra_v1alpha4 as drapb
from ..kube.protos import pluginregistration_v1 as regpb
from ..kube.resourceslice import DriverResources, ResourceSliceController
from .grpc_services import (
    DRA_SERVICE_NAMES,
    REGISTRATION_SERVICE_NAME,
    NodeServicer,
    RegistrationServicer,
    _traced,
)
from .grpc_uds import SocketTransport

logger = logging.getLogger(__name__)

# Version strings advertised on the registration socket. A k8s 1.31 kubelet
# SEMVER-parses these (plugin-API version; the reference framework
# advertises "1.0.0", vendor kubeletplugin/noderegistrar.go:40) and then
# dials the v1alpha3 Node service; a 1.32+ kubelet selects the DRA gRPC
# service BY NAME from this list ("v1beta1.DRAPlugin"). The two schemes are
# mutually unintelligible — a non-semver entry can fail 1.31 registration
# outright — so the advertised list is a deploy-time choice
# (KubeletPlugin(registration_versions=...), helm: plugin.apiVersions);
# the plugin itself always serves BOTH service names on the socket
# (grpc_services.DRA_SERVICE_NAMES — the 1.32+ scheme's version string IS
# grpc_services.DRA_SERVICE_NAME_V1BETA1).
REGISTRATION_VERSION = "1.0.0"


def method_table(plugin: "KubeletPlugin") -> dict:
    """``{gRPC full method name: (request class, handler, response
    class)}`` for every method the plugin serves; each handler is the
    servicer's method wrapped in ``_traced`` (the DRA methods with the
    plugin's tracer), taking ``(request, context)``."""
    node = plugin.node_server
    table = {}
    for service in DRA_SERVICE_NAMES:
        table[f"/{service}/NodePrepareResources"] = (
            drapb.NodePrepareResourcesRequest,
            _traced(service, "NodePrepareResources",
                    node.NodePrepareResources, plugin.tracer),
            drapb.NodePrepareResourcesResponse,
        )
        table[f"/{service}/NodeUnprepareResources"] = (
            drapb.NodeUnprepareResourcesRequest,
            _traced(service, "NodeUnprepareResources",
                    node.NodeUnprepareResources, plugin.tracer),
            drapb.NodeUnprepareResourcesResponse,
        )
    reg = _RegistrationService(plugin)
    table[f"/{REGISTRATION_SERVICE_NAME}/GetInfo"] = (
        regpb.InfoRequest,
        _traced(REGISTRATION_SERVICE_NAME, "GetInfo", reg.GetInfo),
        regpb.PluginInfo,
    )
    table[f"/{REGISTRATION_SERVICE_NAME}/NotifyRegistrationStatus"] = (
        regpb.RegistrationStatus,
        _traced(REGISTRATION_SERVICE_NAME, "NotifyRegistrationStatus",
                reg.NotifyRegistrationStatus),
        regpb.RegistrationStatusResponse,
    )
    return table


class UnknownMethodError(LookupError):
    """A method name the plugin does not serve (gRPC's UNIMPLEMENTED)."""


class LocalTransport:
    """The plugin's services in this process: ``call(method_path,
    request_bytes) -> response_bytes`` decodes the request with the wire
    codec, runs the traced handler and encodes the reply, as a gRPC
    server does for a kubelet's call. Answers only between ``start`` and
    ``stop``."""

    detail = "in-process transport (no socket)"

    def __init__(self):
        self._methods: Optional[dict] = None

    def start(self, plugin: "KubeletPlugin") -> None:
        self._methods = method_table(plugin)

    def stop(self) -> None:
        self._methods = None

    @property
    def serving(self) -> bool:
        return self._methods is not None

    def call(self, method_path: str, request: bytes) -> bytes:
        methods = self._methods
        if methods is None:
            raise RuntimeError("transport not serving")
        try:
            request_cls, handler, _ = methods[method_path]
        except KeyError:
            raise UnknownMethodError(
                f"unknown method {method_path!r}") from None
        return handler(request_cls.FromString(request),
                       None).SerializeToString()


class _RegistrationService(RegistrationServicer):
    """registrationserver.go:37-54 analog."""

    def __init__(self, plugin: "KubeletPlugin"):
        self.plugin = plugin

    def GetInfo(self, request, context):
        return regpb.PluginInfo(
            type="DRAPlugin",
            name=self.plugin.driver_name,
            endpoint=self.plugin.plugin_socket,
            supported_versions=list(self.plugin.registration_versions),
        )

    def NotifyRegistrationStatus(self, request, context):
        logger.info(
            "kubelet registration status: registered=%s error=%r",
            request.plugin_registered,
            request.error,
        )
        self.plugin._registration_status = {
            "pluginRegistered": request.plugin_registered,
            "error": request.error,
        }
        return regpb.RegistrationStatusResponse()


class KubeletPlugin:
    """DRAPlugin analog (draplugin.go:39-67): owns the transport (by
    default both unix sockets) and the slice controller; exposes Stop /
    PublishResources / RegistrationStatus."""

    def __init__(
        self,
        node_server: NodeServicer,
        driver_name: str,
        node_name: str,
        plugin_socket: str,
        registrar_socket: str,
        kube_client: Optional[KubeClient] = None,
        node_uid: str = "",
        registration_versions: Optional[list[str]] = None,
        resource_api=None,
        tracer=None,
        transport=None,
    ):
        self.node_server = node_server
        self.driver_name = driver_name
        self.node_name = node_name
        self.plugin_socket = plugin_socket
        self.registrar_socket = registrar_socket
        self.kube_client = kube_client
        self.node_uid = node_uid
        # Served resource.k8s.io dialect (ResourceApi.discover at startup);
        # None = the pinned default, for kube-less dev mode.
        self.resource_api = resource_api
        self.registration_versions = list(
            registration_versions or [REGISTRATION_VERSION]
        )
        self.tracer = tracer  # root spans for every DRA RPC when set
        self.transport = transport if transport is not None \
            else SocketTransport()
        self._serving = False
        self._slice_controller: Optional[ResourceSliceController] = None
        self._slice_controller_attached = False
        self._registration_status: Optional[dict] = None
        self._lock = threading.Lock()

    # -- lifecycle (draplugin.go:263-362 analog) ---------------------------

    def start(self) -> None:
        self.transport.start(self)
        self._serving = True
        logger.info("kubelet plugin serving: %s", self.transport.detail)

    def stop(self, delete_slices: bool = False) -> None:
        if self._slice_controller is not None:
            self._slice_controller.stop(delete_slices=delete_slices)
            self._slice_controller = None
        if self._serving:
            self.transport.stop()
        self._serving = False

    # -- resource publication (draplugin.go:376-420 analog) ----------------

    def attach_slice_controller(self, controller) -> None:
        """Inject a pre-built slice controller instead of the lazily
        started one. The controller is used as-is — in particular, it is
        NOT started, so a caller that never calls ``start()`` on it owns
        the sync cadence via ``sync_once()``. The deterministic fleet
        soak (fleetsim/) uses this to drive slice publication on its
        virtual clock with no reconciler thread."""
        with self._lock:
            if self._slice_controller is not None:
                raise RuntimeError("slice controller already attached")
            self._slice_controller = controller
            self._slice_controller_attached = True

    def publish_resources(self, resources: DriverResources) -> None:
        if self.kube_client is None:
            raise RuntimeError("publish_resources requires a kube client")
        with self._lock:
            if self._slice_controller is None:
                owner = None
                if self.node_uid:
                    owner = {
                        "apiVersion": "v1",
                        "kind": "Node",
                        "name": self.node_name,
                        "uid": self.node_uid,
                    }
                self._slice_controller = ResourceSliceController(
                    self.kube_client,
                    self.driver_name,
                    scope=self.node_name,
                    owner=owner,
                    api=self.resource_api,
                )
                self._slice_controller.start()
            self._slice_controller.update(resources)

    def sync_slices(self) -> None:
        """Reconcile the published slices now, on the caller's thread,
        for a caller about to read what it just published: the lazily
        started controller otherwise syncs later, on its own thread. An
        attached controller owns its cadence and is left alone. Raises
        what the reconcile raises."""
        ctrl = self._slice_controller
        if ctrl is not None and not self._slice_controller_attached:
            ctrl.sync_once()

    @property
    def serving(self) -> bool:
        """Whether the DRA services are up (readiness input): true only
        between ``start()`` and ``stop()``."""
        return self._serving and self.transport.serving

    def slice_sync_health(self):
        """(ok, detail) for the slice publisher — degraded-readiness
        input. True before the first publish (nothing to sync yet)."""
        ctrl = self._slice_controller
        if ctrl is None:
            return True, "no slices published yet"
        return ctrl.sync_health()

    def slice_sync_success_at(self) -> float:
        """Monotonic time of the last successful slice reconcile (0.0 if
        none yet) — evidence of apiserver reachability that claim-fetch
        recovery can key on."""
        ctrl = self._slice_controller
        return ctrl.last_success_monotonic if ctrl is not None else 0.0

    def registration_status(self) -> Optional[dict]:
        return self._registration_status
