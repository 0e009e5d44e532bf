"""Sharing configuration types for TPU devices.

TPU-native redesign of the reference's sharing API
(lengrongfu/k8s-dra-driver, api/nvidia.com/resource/gpu/v1alpha1/sharing.go):

- GPU ``TimeSlicing``   → ``TimeShared``: the TPU runtime multiplexes whole
  programs; the interval names map to scheduler quanta hints.
- GPU ``MPS``           → ``ProcessShared``: multiple processes address one
  chip simultaneously by splitting its TensorCores/HBM between processes
  (realised via TPU runtime env — TPU_PROCESS_BOUNDS / per-process HBM
  limits — rather than a control daemon).
- new ``Exclusive``: single-process ownership, the TPU default.

Same contract as the reference's `Sharing` interface (sharing.go:43-48):
strategy getters + per-strategy config accessors that error if the active
strategy differs, plus Normalize/Validate.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from .quantity import InvalidQuantityError, parse_quantity, to_mebibytes_string
from .slo import SloConfig

# Strategies (sharing.go:28-31 analog).
EXCLUSIVE = "Exclusive"
TIME_SHARED = "TimeShared"
PROCESS_SHARED = "ProcessShared"

STRATEGIES = (EXCLUSIVE, TIME_SHARED, PROCESS_SHARED)

# Time-share interval names → scheduler quantum hints (sharing.go:33-39).
DEFAULT_INTERVAL = "Default"
SHORT_INTERVAL = "Short"
MEDIUM_INTERVAL = "Medium"
LONG_INTERVAL = "Long"

INTERVALS = {DEFAULT_INTERVAL: 0, SHORT_INTERVAL: 1,
             MEDIUM_INTERVAL: 2, LONG_INTERVAL: 3}


class ErrInvalidDeviceSelector(ValueError):
    """A per-chip limit key did not resolve to an allocated device."""


class ErrInvalidLimit(ValueError):
    """A per-chip limit value is not a valid positive quantity."""


_UUID_RE = re.compile(r"^TPU-[0-9a-f]+(-core-\d+)?$")
_INDEX_RE = re.compile(r"^\d+(:\d+)?$")  # "0" or "0:1" (chip:core)


@dataclasses.dataclass
class TimeSharedConfig:
    """Config for TimeShared (TimeSlicingConfig analog, sharing.go:75-79)."""

    interval: str = DEFAULT_INTERVAL

    @classmethod
    def from_dict(cls, d: dict) -> "TimeSharedConfig":
        _reject_unknown(d, {"interval"}, "timeSharedConfig")
        return cls(interval=d.get("interval", DEFAULT_INTERVAL))

    def to_dict(self) -> dict:
        return {"interval": self.interval}

    def normalize(self) -> None:
        if not self.interval:
            self.interval = DEFAULT_INTERVAL

    def validate(self) -> None:
        if self.interval not in INTERVALS:
            raise ValueError(
                f"unknown time-share interval: {self.interval!r} "
                f"(want one of {sorted(INTERVALS)})"
            )

    def quantum_level(self) -> int:
        return INTERVALS[self.interval]


@dataclasses.dataclass
class PerChipHbmLimit:
    """Per-chip HBM limits keyed by index or UUID
    (MpsPerDevicePinnedMemoryLimit analog, sharing.go:91-96, :190-273)."""

    limits: dict[str, str] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "PerChipHbmLimit":
        return cls(limits=dict(d))

    def to_dict(self) -> dict:
        return dict(self.limits)

    def validate(self) -> None:
        for key, val in self.limits.items():
            if not (_UUID_RE.match(key) or _INDEX_RE.match(key)):
                raise ErrInvalidDeviceSelector(
                    f"invalid per-chip limit selector: {key!r}"
                )
            try:
                n = parse_quantity(val)
            except InvalidQuantityError as e:
                raise ErrInvalidLimit(str(e)) from e
            if n <= 0:
                raise ErrInvalidLimit(f"limit must be positive: {key}={val!r}")

    def normalize(
        self,
        uuids: list[str],
        default_limit: Optional[str] = None,
    ) -> dict[str, str]:
        """Resolve to {uuid: "<N>Mi"} over the allocated devices.

        Mirrors the reference's Normalize (sharing.go:190-273): a default
        applies to every allocated device; index keys resolve positionally
        into ``uuids``; UUID keys must name an allocated device; explicit
        entries override the default.
        """
        out: dict[str, str] = {}
        if default_limit is not None:
            n = parse_quantity(default_limit)
            for u in uuids:
                out[u] = to_mebibytes_string(n)
        for key, val in self.limits.items():
            n = parse_quantity(val)
            if n <= 0:
                raise ErrInvalidLimit(f"limit must be positive: {key}={val!r}")
            if _INDEX_RE.match(key):
                idx = int(key.split(":")[0])
                if idx >= len(uuids):
                    raise ErrInvalidDeviceSelector(
                        f"index {key!r} out of range for {len(uuids)} devices"
                    )
                out[uuids[idx]] = to_mebibytes_string(n)
            elif key in uuids:
                out[key] = to_mebibytes_string(n)
            else:
                raise ErrInvalidDeviceSelector(
                    f"selector {key!r} matches no allocated device"
                )
        return out


@dataclasses.dataclass
class ProcessSharedConfig:
    """Config for ProcessShared (MpsConfig analog, sharing.go:81-89).

    ``max_processes``: how many processes may bind the chip concurrently
    (cf. MPS client limit). ``default_active_core_percentage``: portion of
    the chip's TensorCores each process may occupy (activeThreadPercentage
    analog). HBM limits cap per-process HBM (pinned-memory-limit analog) and
    surface as per-process TPU runtime memory-fraction env.
    """

    max_processes: Optional[int] = None
    default_active_core_percentage: Optional[int] = None
    default_hbm_limit: Optional[str] = None
    per_chip_hbm_limit: Optional[PerChipHbmLimit] = None
    # Dynamic-sharing contract (slo.py): min/burst shares, latency
    # class, priority — what the rebalancer is allowed to do to the
    # static grants above, and what it owes the claim.
    slo: Optional[SloConfig] = None

    FIELDS = {
        "maxProcesses": "max_processes",
        "defaultActiveCorePercentage": "default_active_core_percentage",
        "defaultHbmLimit": "default_hbm_limit",
        "perChipHbmLimit": "per_chip_hbm_limit",
        "slo": "slo",
    }

    @classmethod
    def from_dict(cls, d: dict) -> "ProcessSharedConfig":
        _reject_unknown(d, set(cls.FIELDS), "processSharedConfig")
        kwargs = {}
        for wire, attr in cls.FIELDS.items():
            if wire in d:
                kwargs[attr] = d[wire]
        if "per_chip_hbm_limit" in kwargs and kwargs["per_chip_hbm_limit"] is not None:
            kwargs["per_chip_hbm_limit"] = PerChipHbmLimit.from_dict(
                kwargs["per_chip_hbm_limit"]
            )
        if kwargs.get("slo") is not None:
            kwargs["slo"] = SloConfig.from_dict(kwargs["slo"])
        return cls(**kwargs)

    def to_dict(self) -> dict:
        out: dict = {}
        if self.max_processes is not None:
            out["maxProcesses"] = self.max_processes
        if self.default_active_core_percentage is not None:
            out["defaultActiveCorePercentage"] = self.default_active_core_percentage
        if self.default_hbm_limit is not None:
            out["defaultHbmLimit"] = self.default_hbm_limit
        if self.per_chip_hbm_limit is not None:
            out["perChipHbmLimit"] = self.per_chip_hbm_limit.to_dict()
        if self.slo is not None:
            out["slo"] = self.slo.to_dict()
        return out

    def normalize(self) -> None:
        if self.max_processes is None:
            self.max_processes = 2
        if self.slo is not None:
            self.slo.normalize()

    def validate(self) -> None:
        if self.max_processes is not None and not (1 <= self.max_processes <= 64):
            raise ValueError(
                f"maxProcesses must be in [1, 64], got {self.max_processes}"
            )
        pct = self.default_active_core_percentage
        if pct is not None and not (0 < pct <= 100):
            raise ValueError(
                f"defaultActiveCorePercentage must be in (0, 100], got {pct}"
            )
        if self.default_hbm_limit is not None:
            try:
                if parse_quantity(self.default_hbm_limit) <= 0:
                    raise ErrInvalidLimit(
                        f"defaultHbmLimit must be positive: {self.default_hbm_limit!r}"
                    )
            except InvalidQuantityError as e:
                raise ErrInvalidLimit(str(e)) from e
        if self.per_chip_hbm_limit is not None:
            self.per_chip_hbm_limit.validate()
        if self.slo is not None:
            self.slo.validate()


@dataclasses.dataclass
class TpuSharing:
    """Sharing selection for a whole chip (GpuSharing analog, sharing.go:63-67)."""

    strategy: str = EXCLUSIVE
    time_shared_config: Optional[TimeSharedConfig] = None
    process_shared_config: Optional[ProcessSharedConfig] = None

    @classmethod
    def from_dict(cls, d: dict) -> "TpuSharing":
        _reject_unknown(
            d, {"strategy", "timeSharedConfig", "processSharedConfig"}, "sharing"
        )
        s = cls(strategy=d.get("strategy", EXCLUSIVE))
        if d.get("timeSharedConfig") is not None:
            s.time_shared_config = TimeSharedConfig.from_dict(d["timeSharedConfig"])
        if d.get("processSharedConfig") is not None:
            s.process_shared_config = ProcessSharedConfig.from_dict(
                d["processSharedConfig"]
            )
        return s

    def to_dict(self) -> dict:
        out: dict = {"strategy": self.strategy}
        if self.time_shared_config is not None:
            out["timeSharedConfig"] = self.time_shared_config.to_dict()
        if self.process_shared_config is not None:
            out["processSharedConfig"] = self.process_shared_config.to_dict()
        return out

    # -- Sharing interface (sharing.go:43-48 analog) -----------------------

    def is_exclusive(self) -> bool:
        return self.strategy == EXCLUSIVE

    def is_time_shared(self) -> bool:
        return self.strategy == TIME_SHARED

    def is_process_shared(self) -> bool:
        return self.strategy == PROCESS_SHARED

    def get_time_shared_config(self) -> TimeSharedConfig:
        if not self.is_time_shared():
            raise ValueError(
                f"strategy is {self.strategy}, not {TIME_SHARED}"
            )
        return self.time_shared_config or TimeSharedConfig()

    def get_process_shared_config(self) -> ProcessSharedConfig:
        if not self.is_process_shared():
            raise ValueError(
                f"strategy is {self.strategy}, not {PROCESS_SHARED}"
            )
        return self.process_shared_config or ProcessSharedConfig()

    def normalize(self) -> None:
        """Fill strategy-specific sub-config (gpuconfig.go:52-67 analog)."""
        if not self.strategy:
            self.strategy = EXCLUSIVE
        if self.is_time_shared():
            if self.time_shared_config is None:
                self.time_shared_config = TimeSharedConfig()
            self.time_shared_config.normalize()
        if self.is_process_shared():
            if self.process_shared_config is None:
                self.process_shared_config = ProcessSharedConfig()
            self.process_shared_config.normalize()

    def validate(self) -> None:
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown sharing strategy: {self.strategy!r} "
                f"(want one of {STRATEGIES})"
            )
        if self.is_time_shared() and self.time_shared_config is not None:
            self.time_shared_config.validate()
        if self.is_process_shared() and self.process_shared_config is not None:
            self.process_shared_config.validate()
        if self.is_exclusive() and (
            self.time_shared_config or self.process_shared_config
        ):
            raise ValueError("Exclusive sharing takes no sub-config")


def _reject_unknown(d: dict, allowed: set[str], where: str) -> None:
    """Strict decoding (role of serializer strict mode, api.go:57-62)."""
    unknown = set(d) - allowed
    if unknown:
        raise ValueError(f"unknown field(s) in {where}: {sorted(unknown)}")
