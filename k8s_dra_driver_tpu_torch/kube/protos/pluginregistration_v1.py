"""The kubelet's plugin-registration messages
(``pluginregistration_v1.proto``, package ``pluginregistration``) as
:mod:`.wire` dataclasses: the port's twin of the reference's generated
``pluginregistration_v1_pb2``, with the same names and bytes."""

from __future__ import annotations

import dataclasses

from .wire import BOOL, STRING, Field, Message



@dataclasses.dataclass
class PluginInfo(Message):
    type: str = ""
    name: str = ""
    endpoint: str = ""
    supported_versions: list = dataclasses.field(default_factory=list)

    FIELDS = (Field(1, "type", STRING), Field(2, "name", STRING),
              Field(3, "endpoint", STRING),
              Field(4, "supported_versions", STRING, repeated=True))

    def __post_init__(self):
        self.supported_versions = list(self.supported_versions)


@dataclasses.dataclass
class InfoRequest(Message):
    pass


@dataclasses.dataclass
class RegistrationStatus(Message):
    plugin_registered: bool = False
    error: str = ""

    FIELDS = (Field(1, "plugin_registered", BOOL), Field(2, "error", STRING))


@dataclasses.dataclass
class RegistrationStatusResponse(Message):
    pass


MESSAGES = (PluginInfo, InfoRequest, RegistrationStatus,
            RegistrationStatusResponse)
