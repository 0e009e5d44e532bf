"""Opaque device-config types for tpu.google.com/v1alpha1.

Analog of the reference's config API group (lengrongfu/k8s-dra-driver,
api/nvidia.com/resource/gpu/v1alpha1/{gpuconfig,migconfig,imexchannelconfig}.go):
three kinds, one per allocatable device type, each implementing the
``Interface`` contract (api.go:37-40) — Normalize() then Validate() — and a
strict decoder keyed on (apiVersion, kind).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .sharing import (
    EXCLUSIVE,
    PROCESS_SHARED,
    TIME_SHARED,
    TpuSharing,
    _reject_unknown,
)

GROUP = "tpu.google.com"
VERSION = "v1alpha1"
API_VERSION = f"{GROUP}/{VERSION}"

TPU_CHIP_CONFIG_KIND = "TpuChipConfig"
TENSORCORE_CONFIG_KIND = "TensorCoreConfig"
ICI_CHANNEL_CONFIG_KIND = "IciChannelConfig"


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class TpuChipConfig:
    """Whole-chip opaque config (GpuConfig analog, gpuconfig.go:25-34)."""

    sharing: Optional[TpuSharing] = None

    kind = TPU_CHIP_CONFIG_KIND

    @classmethod
    def default(cls) -> "TpuChipConfig":
        """Default for unconfigured chip allocations.

        The reference defaults GPUs to TimeSlicing (gpuconfig.go:36-49)
        because CUDA contexts always time-share; on TPU the runtime grabs the
        whole chip, so the right default is Exclusive.
        """
        return cls(sharing=TpuSharing(strategy=EXCLUSIVE))

    @classmethod
    def from_dict(cls, d: dict) -> "TpuChipConfig":
        _reject_unknown(d, {"apiVersion", "kind", "sharing"}, cls.kind)
        c = cls()
        if d.get("sharing") is not None:
            c.sharing = TpuSharing.from_dict(d["sharing"])
        return c

    def to_dict(self) -> dict:
        out = {"apiVersion": API_VERSION, "kind": self.kind}
        if self.sharing is not None:
            out["sharing"] = self.sharing.to_dict()
        return out

    def normalize(self) -> None:
        if self.sharing is None:
            self.sharing = TpuSharing(strategy=EXCLUSIVE)
        self.sharing.normalize()

    def validate(self) -> None:
        if self.sharing is None:
            raise ConfigError("no sharing strategy set")
        self.sharing.validate()


@dataclasses.dataclass
class TensorCoreConfig:
    """Sub-chip core-partition config (MigDeviceConfig analog, migconfig.go).

    Core partitions are single-TensorCore devices and are Exclusive-only: a
    core already IS the finest-grained compute unit, so neither TimeShared
    quanta nor ProcessShared fan-out applies below it — mirror of
    MigDeviceSharing restricting strategies (sharing.go:69-73), tightened
    one step further for TPU.
    """

    sharing: Optional[TpuSharing] = None

    kind = TENSORCORE_CONFIG_KIND

    @classmethod
    def default(cls) -> "TensorCoreConfig":
        return cls(sharing=TpuSharing(strategy=EXCLUSIVE))

    @classmethod
    def from_dict(cls, d: dict) -> "TensorCoreConfig":
        _reject_unknown(d, {"apiVersion", "kind", "sharing"}, cls.kind)
        c = cls()
        if d.get("sharing") is not None:
            c.sharing = TpuSharing.from_dict(d["sharing"])
        return c

    def to_dict(self) -> dict:
        out = {"apiVersion": API_VERSION, "kind": self.kind}
        if self.sharing is not None:
            out["sharing"] = self.sharing.to_dict()
        return out

    def normalize(self) -> None:
        if self.sharing is None:
            self.sharing = TpuSharing(strategy=EXCLUSIVE)
        self.sharing.normalize()

    def validate(self) -> None:
        if self.sharing is None:
            raise ConfigError("no sharing strategy set")
        if self.sharing.strategy in (TIME_SHARED, PROCESS_SHARED):
            raise ConfigError(
                f"TensorCore partitions support only {EXCLUSIVE} sharing; "
                f"got {self.sharing.strategy}"
            )
        self.sharing.validate()


@dataclasses.dataclass
class IciChannelConfig:
    """Interconnect-channel config (ImexChannelConfig analog,
    imexchannelconfig.go:25-49 — an empty marker type today; fields land
    here when per-channel QoS knobs exist)."""

    kind = ICI_CHANNEL_CONFIG_KIND

    @classmethod
    def default(cls) -> "IciChannelConfig":
        return cls()

    @classmethod
    def from_dict(cls, d: dict) -> "IciChannelConfig":
        _reject_unknown(d, {"apiVersion", "kind"}, cls.kind)
        return cls()

    def to_dict(self) -> dict:
        return {"apiVersion": API_VERSION, "kind": self.kind}

    def normalize(self) -> None:
        pass

    def validate(self) -> None:
        pass


_KINDS = {
    TPU_CHIP_CONFIG_KIND: TpuChipConfig,
    TENSORCORE_CONFIG_KIND: TensorCoreConfig,
    ICI_CHANNEL_CONFIG_KIND: IciChannelConfig,
}


def decode_config(raw: dict):
    """Strict decoder (role of the runtime-scheme Decoder, api.go:43-71).

    Rejects unknown apiVersion/kind and unknown fields anywhere in the tree.
    """
    if not isinstance(raw, dict):
        raise ConfigError(f"opaque config must be an object, got {type(raw)!r}")
    api_version = raw.get("apiVersion", "")
    kind = raw.get("kind", "")
    if api_version != API_VERSION:
        raise ConfigError(
            f"unknown config apiVersion: {api_version!r} (want {API_VERSION})"
        )
    cls = _KINDS.get(kind)
    if cls is None:
        raise ConfigError(
            f"unknown config kind: {kind!r} (want one of {sorted(_KINDS)})"
        )
    return cls.from_dict(raw)
