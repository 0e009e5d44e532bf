"""Prepared-claim model: the JSON-serializable record of what Prepare did.

Role of the reference's prepared.go (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/prepared.go:1-205): mirrors each allocation into a
checkpointable structure carrying both the kubelet-facing Device handles
(pool/device/CDI ids) and enough driver-side state (device type, uuids,
sharing strategy, created channel paths) for Unprepare to undo everything
after a restart. (The port's copy of the reference module.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class KubeletDevice:
    """drapbv1.Device analog (api.proto Device message)."""

    request_names: list[str]
    pool_name: str
    device_name: str
    cdi_device_ids: list[str]

    def to_dict(self) -> dict:
        return {
            "requestNames": self.request_names,
            "poolName": self.pool_name,
            "deviceName": self.device_name,
            "cdiDeviceIDs": self.cdi_device_ids,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "KubeletDevice":
        return cls(
            request_names=list(d.get("requestNames", [])),
            pool_name=d.get("poolName", ""),
            device_name=d.get("deviceName", ""),
            cdi_device_ids=list(d.get("cdiDeviceIDs", [])),
        )


@dataclasses.dataclass
class PreparedDevice:
    """One prepared allocatable device (PreparedDevice analog,
    prepared.go:27-60's Gpu/Mig/Imex variants flattened with a type tag)."""

    type: str                      # "chip" | "tensorcore" | "ici"
    name: str                      # canonical device name, e.g. "tpu-0"
    uuids: list[str]
    kubelet_device: KubeletDevice
    chip_index: Optional[int] = None
    core_index: Optional[int] = None
    channel: Optional[int] = None
    channel_path: str = ""         # device node created at prepare time

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "type": self.type,
            "name": self.name,
            "uuids": self.uuids,
            "device": self.kubelet_device.to_dict(),
        }
        if self.chip_index is not None:
            out["chipIndex"] = self.chip_index
        if self.core_index is not None:
            out["coreIndex"] = self.core_index
        if self.channel is not None:
            out["channel"] = self.channel
        if self.channel_path:
            out["channelPath"] = self.channel_path
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "PreparedDevice":
        return cls(
            type=d["type"],
            name=d["name"],
            uuids=list(d.get("uuids", [])),
            kubelet_device=KubeletDevice.from_dict(d.get("device", {})),
            chip_index=d.get("chipIndex"),
            core_index=d.get("coreIndex"),
            channel=d.get("channel"),
            channel_path=d.get("channelPath", ""),
        )


@dataclasses.dataclass
class PreparedDeviceGroup:
    """Devices prepared under one resolved config
    (PreparedDeviceGroup analog, prepared.go:62-75)."""

    devices: list[PreparedDevice]
    config: dict                   # normalized opaque config (wire form)

    def to_dict(self) -> dict:
        return {
            "devices": [d.to_dict() for d in self.devices],
            "config": self.config,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PreparedDeviceGroup":
        return cls(
            devices=[PreparedDevice.from_dict(x) for x in d.get("devices", [])],
            config=d.get("config", {}),
        )

    def uuids(self) -> list[str]:
        out: list[str] = []
        for dev in self.devices:
            out.extend(dev.uuids)
        return sorted(out)


@dataclasses.dataclass
class PreparedClaim:
    """Everything prepared for one ResourceClaim
    (PreparedDevices list + claim identity, prepared.go:77-120)."""

    claim_uid: str
    namespace: str = ""
    name: str = ""
    groups: list[PreparedDeviceGroup] = dataclasses.field(default_factory=list)
    # Epoch seconds when the prepare completed. 0.0 on records written
    # before this field existed; the chaos invariant checker uses it to
    # order prepares against chip-health transitions (a claim may sit on
    # a chip that degraded AFTER it prepared — never before).
    prepared_at: float = 0.0

    def to_dict(self) -> dict:
        return {
            "claimUID": self.claim_uid,
            "namespace": self.namespace,
            "name": self.name,
            "groups": [g.to_dict() for g in self.groups],
            "preparedAt": self.prepared_at,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PreparedClaim":
        return cls(
            claim_uid=d["claimUID"],
            namespace=d.get("namespace", ""),
            name=d.get("name", ""),
            groups=[PreparedDeviceGroup.from_dict(g) for g in d.get("groups", [])],
            prepared_at=d.get("preparedAt", 0.0),
        )

    def get_devices(self) -> list[KubeletDevice]:
        """Flattened kubelet Device handles (prepared.go:122 analog)."""
        return [dev.kubelet_device for g in self.groups for dev in g.devices]

    def uuids(self) -> list[str]:
        out: list[str] = []
        for g in self.groups:
            out.extend(g.uuids())
        return sorted(out)
