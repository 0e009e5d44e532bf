"""The kubelet's DRA node service messages (``dra_v1alpha4.proto``,
package ``v1alpha3``; k8s 1.32's ``v1beta1.DRAPlugin`` carries the same
fields), as :mod:`.wire` dataclasses: the port's twin of the
reference's generated ``dra_v1alpha4_pb2``, with the same class and field
names and the same bytes. A map field is a ``dict``: where the reference
writes ``response.claims[uid].CopyFrom(x)``, the port writes
``response.claims[uid] = x``."""

from __future__ import annotations

import dataclasses

from .wire import MAP, MESSAGE, STRING, Field, Message



@dataclasses.dataclass
class Claim(Message):
    namespace: str = ""
    uid: str = ""
    name: str = ""

    FIELDS = (Field(1, "namespace", STRING), Field(2, "uid", STRING),
              Field(3, "name", STRING))


@dataclasses.dataclass
class Device(Message):
    request_names: list = dataclasses.field(default_factory=list)
    pool_name: str = ""
    device_name: str = ""
    cdi_device_ids: list = dataclasses.field(default_factory=list)

    FIELDS = (Field(1, "request_names", STRING, repeated=True),
              Field(2, "pool_name", STRING), Field(3, "device_name", STRING),
              Field(4, "cdi_device_ids", STRING, repeated=True))

    def __post_init__(self):
        # The generated classes copy what they are given.
        self.request_names = list(self.request_names)
        self.cdi_device_ids = list(self.cdi_device_ids)


@dataclasses.dataclass
class NodePrepareResourcesRequest(Message):
    claims: list = dataclasses.field(default_factory=list)

    FIELDS = (Field(1, "claims", MESSAGE, repeated=True, message=Claim),)


@dataclasses.dataclass
class NodePrepareResourceResponse(Message):
    devices: list = dataclasses.field(default_factory=list)
    error: str = ""

    FIELDS = (Field(1, "devices", MESSAGE, repeated=True, message=Device),
              Field(2, "error", STRING))


@dataclasses.dataclass
class NodePrepareResourcesResponse(Message):
    claims: dict = dataclasses.field(default_factory=dict)

    FIELDS = (Field(1, "claims", MAP, message=NodePrepareResourceResponse),)


@dataclasses.dataclass
class NodeUnprepareResourcesRequest(Message):
    claims: list = dataclasses.field(default_factory=list)

    FIELDS = (Field(1, "claims", MESSAGE, repeated=True, message=Claim),)


@dataclasses.dataclass
class NodeUnprepareResourceResponse(Message):
    error: str = ""

    FIELDS = (Field(1, "error", STRING),)


@dataclasses.dataclass
class NodeUnprepareResourcesResponse(Message):
    claims: dict = dataclasses.field(default_factory=dict)

    FIELDS = (Field(1, "claims", MAP,
                    message=NodeUnprepareResourceResponse),)


MESSAGES = (Claim, Device, NodePrepareResourcesRequest,
            NodePrepareResourcesResponse, NodePrepareResourceResponse,
            NodeUnprepareResourcesRequest, NodeUnprepareResourcesResponse,
            NodeUnprepareResourceResponse)
