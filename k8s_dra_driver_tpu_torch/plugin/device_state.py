"""DeviceState: the idempotent Prepare/Unprepare engine.

Analog of the reference's device_state.go (lengrongfu/k8s-dra-driver,
cmd/nvidia-dra-plugin/device_state.go:57-558): holds the allocatable map, CDI
handler, sharing managers and checkpoint manager; resolves opaque configs
with class<claim precedence + per-type defaults; applies sharing / channel
configs; and records everything in a checkpoint so kubelet retries and
plugin restarts are safe.

The claim objects handled here are resource.k8s.io/v1alpha3 ResourceClaims
in wire (dict) form with ``status.allocation.devices.results`` and
``status.allocation.devices.config``.

The port's copy of the reference module, unchanged but for this
paragraph: what a claim tells the chips' runtime comes from ``cdi/`` and
``plugin/sharing.py`` (``cdi/runtime.py``), so a GPU node prepares
through the same code.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

from ..api.v1alpha1 import (
    IciChannelConfig,
    TensorCoreConfig,
    TpuChipConfig,
    decode_config,
)
from ..cdi.spec import (
    CDIHandler,
    ContainerEdits,
    claim_visibility_env,
    ici_channel_launch_env,
)
from ..tpulib.chiplib import (
    HEALTH_GONE,
    SHARING_EXCLUSIVE,
    ChipLib,
    HealthStatus,
)
from ..tpulib.deviceinfo import (
    AllocatableDevice,
    AllocatableDevices,
    ChipDeviceType,
    IciChannelDeviceType,
    MigDeviceInfo,
    TensorCoreDeviceType,
)
from .checkpoint import CheckpointManager
from .prepared import (
    KubeletDevice,
    PreparedClaim,
    PreparedDevice,
    PreparedDeviceGroup,
)
from .sharing import ProcessShareManager, SharingStateStore, TimeShareManager

logger = logging.getLogger(__name__)


class PrepareError(RuntimeError):
    pass


class UnhealthyDeviceError(PrepareError):
    """Typed refusal: the claim landed on a chip the health poll marked
    degraded/gone. Kubelet retries surface this in-band; the scheduler
    should re-place once the republished slices reflect the chip state."""


class GangResizeError(PrepareError):
    """Typed failure of the gang-resize protocol: the claim is not
    prepared here, the target devices are unavailable/unhealthy, or the
    claim's sharing mode cannot be resized in place (time/process
    sharing carries per-claim runtime sessions a rewrite cannot move).
    The claim's prepared state is left as it was."""


class LimitResizeError(PrepareError):
    """Typed failure of the limits-resize protocol (the rebalancer's
    apply path): the claim is not prepared here, is not a single-group
    ProcessShared claim, or the requested limits do not validate. The
    claim's prepared state is left as it was."""


# Sentinel for resize_claim_limits: REMOVE the limit (back to uncapped)
# rather than keep it (None) or set it. Maps to a null in the
# checkpointed intent, which _apply_limits_intent pops from the config.
CLEAR_LIMIT = "__clear-limit__"

# Which config kind governs which device type (role of the type-compatibility
# switch in device_state.go:225-259).
_CONFIG_TYPE_FOR_DEVICE = {
    ChipDeviceType: TpuChipConfig,
    TensorCoreDeviceType: TensorCoreConfig,
    IciChannelDeviceType: IciChannelConfig,
}


class OpaqueDeviceConfig:
    """A decoded opaque config + the requests it applies to."""

    def __init__(self, requests: list[str], config: Any, source: str):
        self.requests = requests
        self.config = config
        self.source = source  # "default" | "FromClass" | "FromClaim"

    def applies_to(self, request: str) -> bool:
        return not self.requests or request in self.requests


class DeviceState:
    """NewDeviceState analog (device_state.go:57-126)."""

    def __init__(
        self,
        chiplib: ChipLib,
        cdi: CDIHandler,
        checkpoint: CheckpointManager,
        driver_name: str,
        pool_name: str,
        state_dir: str,
        device_classes: Optional[set[str]] = None,
    ):
        self.chiplib = chiplib
        self.cdi = cdi
        self.checkpoint = checkpoint
        self.driver_name = driver_name
        self.pool_name = pool_name
        self.device_classes = device_classes or {"chip", "tensorcore", "ici"}
        self._lock = threading.Lock()
        # Utilization accounting (plugin/accounting.py), attached by the
        # Driver after construction; None keeps direct DeviceState users
        # (tests, inspector) hook-free.
        self.accountant = None

        # Startup checkpoint recovery FIRST: a corrupt checkpoint must not
        # crash-loop the DaemonSet (every later step below reads it). The
        # corrupt file is parked at <path>.corrupt for forensics and the
        # plugin continues from empty state — prepared claims re-prepare
        # idempotently on kubelet's next retry.
        from .checkpoint import CorruptCheckpointError

        self.checkpoint.create_if_missing()
        try:
            startup_records = self.checkpoint.read()
        except CorruptCheckpointError as e:
            quarantined = self.checkpoint.quarantine()
            logger.error(
                "checkpoint corrupt at startup (%s); quarantined to %s, "
                "continuing from empty state", e, quarantined,
            )
            self.checkpoint.write({})
            startup_records = {}
        # The view recovered above, kept for consumers that seed from the
        # startup state (usage-accounting rebuild): they must see the
        # SAME records recovery saw, not a second read's.
        self.startup_prepared_records: dict[str, dict] = startup_records

        self.chiplib.init()
        # Per-chip health (uuid -> HealthStatus) and the transition log the
        # driver drains for Events/metrics. Health is polled together with
        # every inventory refresh; `gone` chips are dropped from
        # allocatable, unhealthy ones stay published with healthy=false.
        self.chip_health: dict[str, HealthStatus] = {}
        self._health_transitions: list[tuple[str, str, HealthStatus]] = []
        chips, lib_health = self.chiplib.snapshot()
        health = self._merge_gone(lib_health)
        self._record_transitions(health)
        self.chip_health = health
        self.allocatable: AllocatableDevices = self._stamp_health(
            self.chiplib.enumerate_all_possible_devices(
                self.device_classes, chips=chips
            ),
            health,
        )
        # What the base CDI spec currently contains — a superset of
        # allocatable while prepared claims pin entries for transiently
        # absent devices (refresh_allocatable).
        self._base_spec_devices: AllocatableDevices = dict(self.allocatable)
        self.cdi.create_standard_device_spec_file(self.allocatable)

        share_state = SharingStateStore(f"{state_dir}/sharing")
        self.ts_manager = TimeShareManager(
            self.chiplib, share_state, f"{state_dir}/time-share"
        )
        self.ps_manager = ProcessShareManager(
            self.chiplib, share_state, f"{state_dir}/process-share"
        )
        self.share_state = share_state

        # Gang-resize crash consistency: a resize intent checkpointed by
        # a previous incarnation rolls forward now that the sharing
        # store is up (resize_claim documents the two-phase protocol).
        self._recover_resize_intents()

    # ------------------------------------------------------------------
    # Health
    # ------------------------------------------------------------------

    def _merge_gone(
        self, fresh: dict[str, HealthStatus]
    ) -> dict[str, HealthStatus]:
        """Extend a library health report with gone-markers for chips WE
        remember that the library no longer reports at all — a backend
        without memory still yields correct gone-detection."""
        import time as _time

        now = _time.time()
        for uuid in self.chip_health:
            if uuid not in fresh:
                fresh[uuid] = HealthStatus(
                    HEALTH_GONE, "disappeared from inventory", now
                )
        return fresh

    def _record_transitions(self, fresh: dict[str, HealthStatus]) -> None:
        """Append (uuid, old_state, new_status) for every state change
        against ``self.chip_health``. A chip first seen in a non-healthy
        state counts as a transition from healthy — it must still produce
        an Event/metric, or a chip that boots sick is invisible."""
        from ..tpulib.chiplib import HEALTH_HEALTHY

        for uuid, status in fresh.items():
            prev = self.chip_health.get(uuid)
            prev_state = prev.state if prev is not None else HEALTH_HEALTHY
            if status.state != prev_state:
                self._health_transitions.append(
                    (uuid, prev_state, status)
                )

    @staticmethod
    def _device_chip(dev: AllocatableDevice):
        """The ChipInfo whose health governs this device (None for ICI
        channels, which have no node-local hardware to sicken)."""
        if dev.chip is not None:
            return dev.chip
        if dev.tensorcore is not None:
            return dev.tensorcore.parent
        return None

    def _stamp_health(
        self, devices: AllocatableDevices, health: dict[str, HealthStatus]
    ) -> AllocatableDevices:
        """Drop devices of ``gone`` chips and stamp the healthy flag (the
        published tpu.google.com/healthy attribute) onto the rest. Chip
        and tensorcore devices share one ChipInfo instance, so stamping
        once covers both renderings."""
        out: AllocatableDevices = {}
        for name, dev in devices.items():
            chip = self._device_chip(dev)
            if chip is None:
                out[name] = dev
                continue
            status = health.get(chip.uuid)
            if status is not None and status.is_gone():
                continue
            chip.healthy = status is None or status.is_healthy()
            chip.health_reason = "" if status is None else status.reason
            out[name] = dev
        return out

    def drain_health_transitions(self):
        """Hand the accumulated health transitions to the caller (the
        driver's watch loop) exactly once each."""
        with self._lock:
            out = self._health_transitions
            self._health_transitions = []
        return out

    def health_of_device(self, name: str) -> Optional[HealthStatus]:
        chip = None
        dev = self.allocatable.get(name)
        if dev is not None:
            chip = self._device_chip(dev)
        if chip is None:
            return None
        return self.chip_health.get(chip.uuid)

    # ------------------------------------------------------------------
    # Prepare
    # ------------------------------------------------------------------

    def prepare(self, claim: dict) -> list[KubeletDevice]:
        """Idempotent prepare (device_state.go:128-159)."""
        claim_uid = claim["metadata"]["uid"]
        with self._lock:
            prepared_claims = self.checkpoint.read()
            if claim_uid in prepared_claims:
                cached = PreparedClaim.from_dict(prepared_claims[claim_uid])
                if self.accountant is not None:
                    self.accountant.note_prepared(cached)  # idempotent
                return cached.get_devices()
            prepared = self._prepare_devices(claim)
            prepared_claims[claim_uid] = prepared.to_dict()
            self.checkpoint.write(prepared_claims)
            if self.accountant is not None:
                self.accountant.note_prepared(prepared)
            return prepared.get_devices()

    def _allocation_results(self, claim: dict) -> list[dict]:
        alloc = ((claim.get("status") or {}).get("allocation") or {})
        results = ((alloc.get("devices") or {}).get("results")) or []
        return [r for r in results if r.get("driver", self.driver_name) == self.driver_name]

    def get_opaque_device_configs(self, claim: dict) -> list[OpaqueDeviceConfig]:
        """Decode class/claim opaque configs, lowest→highest precedence
        (GetOpaqueDeviceConfigs analog, device_state.go:457-510)."""
        alloc = ((claim.get("status") or {}).get("allocation") or {})
        raw_configs = ((alloc.get("devices") or {}).get("config")) or []
        from_class: list[OpaqueDeviceConfig] = []
        from_claim: list[OpaqueDeviceConfig] = []
        for rc in raw_configs:
            opaque = rc.get("opaque")
            if not opaque or opaque.get("driver") != self.driver_name:
                continue
            params = opaque.get("parameters")
            if params is None:
                raise PrepareError("opaque config with no parameters")
            cfg = decode_config(params)
            entry = OpaqueDeviceConfig(
                list(rc.get("requests", [])), cfg, rc.get("source", "FromClaim")
            )
            if rc.get("source") == "FromClass":
                from_class.append(entry)
            else:
                from_claim.append(entry)
        defaults = [
            OpaqueDeviceConfig([], TpuChipConfig.default(), "default"),
            OpaqueDeviceConfig([], TensorCoreConfig.default(), "default"),
            OpaqueDeviceConfig([], IciChannelConfig.default(), "default"),
        ]
        # Precedence: defaults < FromClass < FromClaim (device_state.go:210-221).
        return defaults + from_class + from_claim

    def _resolve_config(
        self, configs: list[OpaqueDeviceConfig], request: str, device_type: str
    ) -> OpaqueDeviceConfig:
        """Highest-precedence type-compatible config for one allocation
        result (device_state.go:225-259)."""
        want_cls = _CONFIG_TYPE_FOR_DEVICE[device_type]
        for c in reversed(configs):
            if isinstance(c.config, want_cls) and c.applies_to(request):
                return c
        raise PrepareError(
            f"no config applies to request {request!r} ({device_type})"
        )

    def _prepare_devices(self, claim: dict) -> PreparedClaim:
        """device_state.go:192-348 analog."""
        claim_uid = claim["metadata"]["uid"]
        results = self._allocation_results(claim)
        if not results:
            raise PrepareError(
                f"claim {claim_uid} has no allocation for driver {self.driver_name}"
            )
        configs = self.get_opaque_device_configs(claim)

        # adminAccess requests (claim spec, types.go:448-456) get device
        # access WITHOUT sharing acquisition: a monitoring pod must not
        # conflict with — or evict — the workload holding the chip.
        admin_reqs = {
            r["name"]
            for r in (
                (claim.get("spec", {}).get("devices", {}) or {})
                .get("requests") or []
            )
            if r.get("adminAccess")
        }

        # Group allocation results by their resolved config instance.
        grouped: dict[int, tuple[OpaqueDeviceConfig, list[tuple[str, AllocatableDevice]]]] = {}
        admin_members: list[tuple[str, AllocatableDevice]] = []
        for r in results:
            name = r["device"]
            dev = self.allocatable.get(name)
            if dev is None:
                raise PrepareError(f"allocated device {name!r} is not allocatable here")
            if r.get("request", "") in admin_reqs:
                # adminAccess is deliberately NOT health-gated: draining a
                # degraded chip is exactly when a monitoring pod needs on.
                admin_members.append((r.get("request", ""), dev))
                continue
            self._ensure_device_healthy(name, dev)
            cfg = self._resolve_config(configs, r.get("request", ""), dev.type())
            key = id(cfg)
            grouped.setdefault(key, (cfg, []))[1].append((r.get("request", ""), dev))

        groups: list[PreparedDeviceGroup] = []
        claim_device_edits: dict[str, ContainerEdits] = {}
        # (strategy, uuids) per applied group, for rollback on partial failure.
        applied: list[tuple[str, list[str]]] = []
        try:
            for cfg, members in grouped.values():
                config = cfg.config
                config.normalize()
                config.validate()
                devices = [d for _, d in members]
                group_edits = self._apply_config(claim_uid, config, devices)
                applied.append(
                    (
                        self._config_strategy(config.to_dict()),
                        [u for d in devices for u in d.impl.uuids()],
                    )
                )

                prepared_devices = []
                for request, dev in members:
                    name = dev.canonical_name()
                    cdi_ids = [self.cdi.get_standard_device(name)]
                    per_dev = self._device_edits(dev, group_edits)
                    if per_dev is not None:
                        claim_device_edits[name] = per_dev
                        cdi_ids.append(self.cdi.get_claim_device(claim_uid, name))
                    prepared_devices.append(
                        self._make_prepared_device(
                            request, dev, cdi_ids,
                            channel_path=group_edits.channel_paths.get(
                                name, ""
                            ),
                        )
                    )
                groups.append(
                    PreparedDeviceGroup(devices=prepared_devices, config=config.to_dict())
                )

            if admin_members:
                # No sharing acquisition, no opaque config: device access +
                # an env marker so the pod-side tooling knows it observes.
                # Strategy "" in the recorded config makes unprepare a
                # no-op release (_config_strategy).
                admin_devices = []
                for request, dev in admin_members:
                    name = dev.canonical_name()
                    cdi_ids = [self.cdi.get_standard_device(name)]
                    admin_edit = ContainerEdits(env={"TPU_DRA_ADMIN": "1"})
                    existing = claim_device_edits.get(name)
                    # The same device may carry a workload group's edits
                    # (admin ignores ordinary allocations): merge, never
                    # clobber the workload's sharing env/mounts.
                    claim_device_edits[name] = (
                        existing.merge(admin_edit) if existing else admin_edit
                    )
                    cdi_ids.append(self.cdi.get_claim_device(claim_uid, name))
                    admin_devices.append(
                        self._make_prepared_device(request, dev, cdi_ids)
                    )
                groups.append(
                    PreparedDeviceGroup(
                        devices=admin_devices,
                        config={"adminAccess": True},
                    )
                )

            # Visibility env over the WHOLE claim (all groups), so multi-group
            # allocations present every chip to libtpu. Inside the try block:
            # if the claim-spec write fails (e.g. disk full) the sharing
            # acquisitions above must be rolled back too, or they leak —
            # the claim is never checkpointed, so unprepare would no-op.
            all_devices = [
                d for _, (_, ms) in grouped.items() for _, d in ms
            ] + [d for _, d in admin_members]
            common_env = self._claim_common_env(all_devices)
            self.cdi.create_claim_spec_file(claim_uid, claim_device_edits, common_env)
        except BaseException:
            # Roll back acquisitions from already-applied groups; otherwise a
            # half-prepared claim that kubelet never retries (pod deleted)
            # would pin chips in a stale sharing mode forever.
            for strategy, uuids in applied:
                try:
                    self._release_group(claim_uid, strategy, uuids)
                except Exception:
                    logger.exception(
                        "rollback of claim %s (%s) failed", claim_uid, strategy
                    )
            raise

        import time as _time

        return PreparedClaim(
            claim_uid=claim_uid,
            namespace=claim["metadata"].get("namespace", ""),
            name=claim["metadata"].get("name", ""),
            groups=groups,
            prepared_at=_time.time(),
        )

    def _claim_common_env(
        self, all_devices: list[AllocatableDevice]
    ) -> dict[str, str]:
        """Claim-wide container env: chip/tensorcore visibility plus —
        for ICI claims — ONE rendezvous named by the lowest claimed
        channel across all config groups, so gang members never dial
        different ports. Shared by prepare and gang-resize so the two
        writers of a claim spec cannot drift."""
        common_env = claim_visibility_env(
            [d.chip for d in all_devices if d.chip is not None],
            [d.tensorcore for d in all_devices if d.tensorcore is not None],
        )
        channels = [
            d.ici_channel.channel for d in all_devices
            if d.ici_channel is not None
        ]
        if channels:
            host_id = next(
                (d.chip.host_id for d in self.allocatable.values()
                 if d.chip is not None),
                None,
            )
            common_env.update(
                ici_channel_launch_env(
                    self.chiplib.worker_hostnames(), min(channels),
                    host_id,
                )
            )
        return common_env

    def _ensure_device_healthy(self, name: str, dev: AllocatableDevice) -> None:
        """Refuse to prepare onto a chip the health poll marked unhealthy.

        The allocation raced the hardware: the scheduler picked from slices
        published before the chip sickened. A typed error (vs a generic
        PrepareError) lets callers and tests distinguish 'health race' from
        'bad claim', and the republished slices steer the retry elsewhere.
        """
        chip = self._device_chip(dev)
        if chip is None:
            return
        status = self.chip_health.get(chip.uuid)
        if status is not None and not status.is_healthy():
            raise UnhealthyDeviceError(
                f"device {name} (chip {chip.uuid}) is {status.state}: "
                f"{status.reason or 'no reason recorded'}"
            )

    def _make_prepared_device(
        self,
        request: str,
        dev: AllocatableDevice,
        cdi_ids: list[str],
        channel_path: str = "",
    ) -> PreparedDevice:
        """One PreparedDevice record (shared by the ordinary and admin
        group builders, so their wiring cannot drift)."""
        name = dev.canonical_name()
        return PreparedDevice(
            type=dev.type(),
            name=name,
            uuids=dev.impl.uuids(),
            kubelet_device=KubeletDevice(
                request_names=[request] if request else [],
                pool_name=self.pool_name,
                device_name=name,
                cdi_device_ids=cdi_ids,
            ),
            chip_index=(dev.chip.index if dev.chip else
                        dev.tensorcore.parent.index if dev.tensorcore
                        else None),
            core_index=(dev.tensorcore.core_index if dev.tensorcore
                        else None),
            channel=(dev.ici_channel.channel if dev.ici_channel else None),
            channel_path=channel_path,
        )

    class _GroupEdits:
        """Edits produced by applying one config to its devices."""

        def __init__(self):
            self.shared: ContainerEdits = ContainerEdits()
            self.channel_paths: dict[str, str] = {}

    def _apply_config(
        self, claim_uid: str, config, devices: list[AllocatableDevice]
    ) -> "_GroupEdits":
        """applyConfig dispatch (device_state.go:261-297)."""
        out = DeviceState._GroupEdits()
        if isinstance(config, (TpuChipConfig, TensorCoreConfig)):
            out.shared = self._apply_sharing_config(claim_uid, config, devices)
        elif isinstance(config, IciChannelConfig):
            out.channel_paths = self._apply_ici_channel_config(devices)
        else:
            raise PrepareError(f"unknown config type: {type(config)!r}")
        return out

    def _apply_sharing_config(
        self, claim_uid: str, config, devices: list[AllocatableDevice]
    ) -> ContainerEdits:
        """applySharingConfig analog (device_state.go:380-428)."""
        sharing = config.sharing
        if sharing.is_time_shared():
            return self.ts_manager.set_time_share(
                claim_uid, devices, sharing.get_time_shared_config()
            )
        if sharing.is_process_shared():
            session = self.ps_manager.new_session(
                claim_uid, devices, sharing.get_process_shared_config()
            )
            session.start()
            return session.container_edits()
        # Exclusive: acquire so a concurrent shared claim on the same chip
        # (via adminAccess or scheduler bug) is detected, not silently run.
        for d in devices:
            for u in d.impl.uuids():
                self.share_state.acquire(u, claim_uid, SHARING_EXCLUSIVE)
        return ContainerEdits(env={"TPU_DRA_SHARING": "exclusive"})

    def _apply_ici_channel_config(
        self, devices: list[AllocatableDevice]
    ) -> dict[str, str]:
        """applyImexChannelConfig analog (device_state.go:430-444)."""
        paths: dict[str, str] = {}
        for d in devices:
            ch = d.ici_channel
            if ch is None:
                raise PrepareError(
                    f"IciChannelConfig applied to non-channel device {d.canonical_name()}"
                )
            paths[d.canonical_name()] = self.chiplib.create_ici_channel_device(
                ch.channel
            )
        return paths

    def _device_edits(
        self, dev: AllocatableDevice, group_edits: "_GroupEdits"
    ) -> Optional[ContainerEdits]:
        """Claim-spec edits for one device, or None if nothing beyond the
        base spec is needed."""
        edits = ContainerEdits(
            env=dict(group_edits.shared.env),
            mounts=list(group_edits.shared.mounts),
        )
        path = group_edits.channel_paths.get(dev.canonical_name())
        if path:
            edits.device_nodes.append(path)
        if not (edits.env or edits.mounts or edits.device_nodes):
            return None
        return edits

    # ------------------------------------------------------------------
    # Unprepare
    # ------------------------------------------------------------------

    def unprepare(self, claim_uid: str) -> None:
        """Idempotent unprepare (device_state.go:161-190)."""
        with self._lock:
            prepared_claims = self.checkpoint.read()
            if claim_uid not in prepared_claims:
                logger.info("claim %s not in checkpoint; nothing to unprepare", claim_uid)
                return
            prepared = PreparedClaim.from_dict(prepared_claims[claim_uid])
            self._unprepare_devices(claim_uid, prepared)
            self.cdi.delete_claim_spec_file(claim_uid)
            del prepared_claims[claim_uid]
            self.checkpoint.write(prepared_claims)
            if self.accountant is not None:
                self.accountant.note_unprepared(claim_uid)

    @staticmethod
    def _config_strategy(config_dict: dict) -> str:
        """Sharing strategy recorded in a group's wire-form config
        ("" for channel configs)."""
        if config_dict.get("kind") == "IciChannelConfig":
            return ""
        return (config_dict.get("sharing") or {}).get("strategy", "")

    def _release_group(self, claim_uid: str, strategy: str, uuids: list[str]) -> None:
        """Undo one group's sharing acquisition (shared by unprepare and
        prepare-rollback)."""
        if strategy == "ProcessShared":
            self.ps_manager.stop_session(claim_uid, uuids)
        elif strategy == "TimeShared":
            self.ts_manager.reset(claim_uid, uuids)
        elif strategy:
            for u in uuids:
                self.share_state.release(u, claim_uid)
        # ICI channel device nodes are shared across claims on the node
        # and cheap; they are left in place (mirrors the reference, which
        # never removes IMEX channel nodes it mknod'ed).

    def _unprepare_devices(self, claim_uid: str, prepared: PreparedClaim) -> None:
        """unprepareDevices analog (device_state.go:350-365)."""
        for group in prepared.groups:
            self._release_group(
                claim_uid,
                self._config_strategy(group.config),
                [u for d in group.devices for u in d.uuids],
            )

    # ------------------------------------------------------------------
    # Gang resize (the elastic-training protocol)
    # ------------------------------------------------------------------

    def resize_claim(
        self,
        claim_uid: str,
        results: list[dict],
        desired: Optional[int] = None,
    ) -> list[KubeletDevice]:
        """Crash-consistent rewrite of a prepared claim's device set.

        ``results`` is the claim's NEW allocation (the elastic re-solve
        output, same wire shape as ``status.allocation.devices.results``)
        — devices absent from it are released, new ones are acquired and
        added, and the CDI claim spec is rewritten so the container's
        visibility env matches the surviving gang. ``desired`` records
        the gang size the claim WANTS (set on the first shrink so a later
        chip recovery knows how far to grow back).

        The two-phase checkpoint protocol makes this crash-safe: a
        ``resize`` intent is checkpointed FIRST, then holds/CDI are
        rewritten, then the finalized record replaces the intent. A crash
        anywhere in between leaves the intent on disk; startup recovery
        rolls it forward idempotently (releases tolerate absent holds,
        same-claim acquires are re-entrant, the CDI write is a whole-file
        replace), and an intent that CANNOT complete surfaces as a
        ``resize`` audit finding instead of silent corruption.
        """
        with self._lock:
            prepared_claims = self.checkpoint.read()
            original_rec = prepared_claims.get(claim_uid)
            if original_rec is None:
                raise GangResizeError(
                    f"claim {claim_uid} is not prepared on this node"
                )
            new_names = [
                r["device"] for r in results
                if r.get("driver", self.driver_name) == self.driver_name
            ]
            if not new_names:
                raise GangResizeError(
                    f"resize of claim {claim_uid} to an empty device set "
                    "— unprepare the claim instead"
                )
            rec = dict(original_rec)
            self._check_resizable(rec)
            import time as _time

            rec["resize"] = {
                "to": new_names,
                "requests": {
                    r["device"]: r.get("request", "") for r in results
                },
                "startedAt": _time.time(),
            }
            if desired is not None:
                elastic = dict(rec.get("elastic") or {})
                elastic["desired"] = desired
                rec["elastic"] = elastic
            # Phase 1: intent on disk. From here a crash rolls FORWARD.
            prepared_claims[claim_uid] = rec
            self.checkpoint.write(prepared_claims)
            # Phase 2: apply (holds + CDI), then finalize. A NON-crash
            # failure here (e.g. the added spare sickened between
            # re-solve and apply) rolls the intent BACK — the caller
            # reports the resize as failed, so the claim must read
            # exactly as before, not as perpetual 'resize' audit drift.
            try:
                new_rec = self._apply_resize(claim_uid, rec)
            except BaseException:
                self._rollback_resize(
                    claim_uid, original_rec, rec["resize"],
                    prepared_claims,
                )
                raise
            prepared_claims[claim_uid] = new_rec
            self.checkpoint.write(prepared_claims)
            new_pc = PreparedClaim.from_dict(new_rec)
            if self.accountant is not None:
                # Rebuild the claim's occupancy holds around the new
                # device set (hold duration restarts — the resize is a
                # new placement as far as per-chip accounting goes).
                self.accountant.note_unprepared(claim_uid)
                self.accountant.note_prepared(new_pc)
            return new_pc.get_devices()

    def _rollback_resize(
        self,
        claim_uid: str,
        original_rec: dict,
        failed_intent: dict,
        prepared_claims: dict,
    ) -> None:
        """Undo a FAILED live resize: restore sharing holds and the CDI
        claim spec to the original gang and drop the checkpointed
        intent.

        Hold reconciliation is explicit — the partial apply may have
        released removed-device holds and acquired added-spare holds
        before failing, and re-applying the original device set alone
        would not see either (every original device reads as "kept").
        So: release holds for the failed intent's additions, re-acquire
        every original gang hold (idempotent; we still hold the lock, so
        nothing can have taken them), then re-apply the original record
        to rewrite checkpoint + CDI. If any of that fails, the intent is
        left on disk for the auditor's ``resize`` check — loud, never
        silent. Caller re-raises the original error."""
        work_groups = [
            g for g in original_rec.get("groups", [])
            if not (g.get("config") or {}).get("adminAccess")
        ]
        original_names = [
            d["name"] for g in work_groups for d in g.get("devices", [])
        ]
        try:
            # Holds the partial apply acquired for added spares: leaked
            # unless released here (unprepare only releases group
            # devices, and the spare never made it into a group).
            for name in failed_intent.get("to", []):
                if name in original_names:
                    continue
                dev = self._resolve_claimed_device(name)
                if dev is None:
                    continue
                for u in dev.impl.uuids():
                    self.share_state.release(u, claim_uid)
            # Holds the partial apply released for removed devices: the
            # checkpoint still records them in the gang, so they must be
            # held again (or another claim could double-book the chip).
            for g in work_groups:
                for d in g.get("devices", []):
                    for u in d.get("uuids", []):
                        self.share_state.acquire(
                            u, claim_uid, SHARING_EXCLUSIVE
                        )
            restored = self._apply_resize(claim_uid, {
                **original_rec,
                "resize": {"to": original_names, "requests": {}},
            })
            # A rollback is not a resize: keep the original elastic
            # metadata (no generation bump, no implied desired size).
            if "elastic" in original_rec:
                restored["elastic"] = original_rec["elastic"]
            else:
                restored.pop("elastic", None)
            prepared_claims[claim_uid] = restored
            self.checkpoint.write(prepared_claims)
        except Exception:
            logger.exception(
                "rollback of failed resize of claim %s also failed; "
                "leaving the intent for the state auditor", claim_uid,
            )

    @staticmethod
    def _check_resizable(rec: dict) -> None:
        """Refuse claims the resize protocol cannot rewrite in place."""
        work_groups = 0
        for group in rec.get("groups", []):
            if (group.get("config") or {}).get("adminAccess"):
                continue
            work_groups += 1
            strategy = DeviceState._config_strategy(
                group.get("config") or {}
            )
            if strategy in ("TimeShared", "ProcessShared"):
                raise GangResizeError(
                    f"claim uses {strategy} sharing; gang resize only "
                    "supports exclusive gangs (sharing sessions carry "
                    "runtime state a rewrite cannot move)"
                )
            for dev in group.get("devices", []):
                if dev.get("channel") is not None:
                    raise GangResizeError(
                        "ICI channel devices cannot be gang-resized; "
                        "re-prepare the claim instead"
                    )
        if work_groups > 1:
            # Distinct groups mean distinct resolved configs; rebuilding
            # them as one group would silently drop every config but the
            # first. Refuse loudly instead.
            raise GangResizeError(
                f"claim has {work_groups} device groups with distinct "
                "configs; gang resize only supports single-group "
                "exclusive gangs"
            )

    def _resolve_claimed_device(
        self, name: str
    ) -> Optional[AllocatableDevice]:
        """An already-claimed device's AllocatableDevice view: prefer the
        live allocatable map, fall back to the base-spec pin (a kept
        device may be transiently absent mid-rebind without invalidating
        the claim that holds it)."""
        return self.allocatable.get(name) or self._base_spec_devices.get(
            name
        )

    def _apply_resize(self, claim_uid: str, rec: dict) -> dict:
        """Roll a checkpointed ``resize`` intent forward; returns the
        finalized record (intent dropped). Idempotent — both the live
        resize path and startup crash recovery run it, any number of
        times. Dispatches on the intent's shape: ``limits`` intents are
        the rebalancer's per-claim share rewrites, ``to`` intents the
        elastic gang's device-set rewrites."""
        intent = rec["resize"]
        if "limits" in intent:
            return self._apply_limits_intent(claim_uid, rec)
        target: list[str] = list(intent["to"])
        target_set = set(target)
        request_names: dict[str, str] = dict(intent.get("requests") or {})
        groups = [
            PreparedDeviceGroup.from_dict(g) for g in rec.get("groups", [])
        ]
        admin_groups = [
            g for g in groups if (g.config or {}).get("adminAccess")
        ]
        work_groups = [
            g for g in groups if not (g.config or {}).get("adminAccess")
        ]
        if not work_groups:
            raise GangResizeError(
                f"claim {claim_uid} has no resizable device group"
            )
        kept = {
            d.name: d for g in work_groups for d in g.devices
            if d.name in target_set
        }
        removed = [
            d for g in work_groups for d in g.devices
            if d.name not in target_set
        ]
        added_names = [n for n in target if n not in kept]

        # Validate additions BEFORE touching any state: a spare that
        # sickened between re-solve and apply must fail the whole resize.
        added: list[tuple[str, AllocatableDevice]] = []
        for name in added_names:
            dev = self.allocatable.get(name)
            if dev is None:
                raise GangResizeError(
                    f"added device {name!r} is not allocatable here"
                )
            self._ensure_device_healthy(name, dev)
            added.append((request_names.get(name, ""), dev))

        # Release removed holds / acquire added ones (both idempotent).
        for d in removed:
            for u in d.uuids:
                self.share_state.release(u, claim_uid)
        for _, dev in added:
            for u in dev.impl.uuids():
                self.share_state.acquire(u, claim_uid, SHARING_EXCLUSIVE)

        # Rebuild the work group in target order and rewrite the claim
        # spec: per-device sharing env plus claim-wide visibility env
        # over the post-resize gang (admin edits are preserved).
        base_config = work_groups[0].config
        shared_env = {"TPU_DRA_SHARING": "exclusive"}
        new_devices: list[PreparedDevice] = []
        claim_device_edits: dict[str, ContainerEdits] = {}
        visible: list[AllocatableDevice] = []
        for name in target:
            if name in kept:
                # Kept devices KEEP their checkpointed request name: the
                # re-solve's synthetic request name must never overwrite
                # the claim-spec name kubelet matches devices against.
                pd = kept[name]
                request = (
                    pd.kubelet_device.request_names[0]
                    if pd.kubelet_device.request_names else ""
                )
            else:
                request = request_names.get(name, "")
            dev = self._resolve_claimed_device(name)
            if dev is None:
                raise GangResizeError(
                    f"device {name!r} of claim {claim_uid} is neither "
                    "allocatable nor pinned in the base spec"
                )
            visible.append(dev)
            cdi_ids = [
                self.cdi.get_standard_device(name),
                self.cdi.get_claim_device(claim_uid, name),
            ]
            claim_device_edits[name] = ContainerEdits(env=dict(shared_env))
            new_devices.append(
                self._make_prepared_device(request, dev, cdi_ids)
            )
        for g in admin_groups:
            for pd in g.devices:
                dev = self._resolve_claimed_device(pd.name)
                if dev is None:
                    continue
                visible.append(dev)
                admin_edit = ContainerEdits(env={"TPU_DRA_ADMIN": "1"})
                existing = claim_device_edits.get(pd.name)
                claim_device_edits[pd.name] = (
                    existing.merge(admin_edit) if existing else admin_edit
                )
        common_env = self._claim_common_env(visible)
        self.cdi.create_claim_spec_file(
            claim_uid, claim_device_edits, common_env
        )

        new_pc = PreparedClaim(
            claim_uid=claim_uid,
            namespace=rec.get("namespace", ""),
            name=rec.get("name", ""),
            groups=[
                PreparedDeviceGroup(devices=new_devices, config=base_config)
            ] + admin_groups,
            prepared_at=rec.get("preparedAt", 0.0),
        )
        new_rec = new_pc.to_dict()
        elastic = dict(rec.get("elastic") or {})
        elastic["generation"] = int(elastic.get("generation", 0)) + 1
        elastic.setdefault(
            "desired",
            len([d for g in work_groups for d in g.devices]),
        )
        new_rec["elastic"] = elastic
        logger.info(
            "gang resize of claim %s applied: %d kept, %d removed, "
            "%d added (generation %d)",
            claim_uid, len(kept), len(removed), len(added),
            elastic["generation"],
        )
        return new_rec

    def _recover_resize_intents(self) -> None:
        """Startup roll-forward of resize intents a crash left behind.

        Each intent is re-applied idempotently; one that cannot complete
        (e.g. its added device vanished while the plugin was down) is
        LEFT IN PLACE — the state auditor's ``resize`` check reports it
        as drift so the condition is operator-visible rather than
        silently discarded.
        """
        try:
            recs = self.checkpoint.read()
        except Exception:
            return
        dirty = False
        for uid, rec in list(recs.items()):
            if "resize" not in rec:
                continue
            logger.warning(
                "claim %s carries an in-flight resize intent (crash "
                "mid-resize); rolling forward", uid,
            )
            try:
                recs[uid] = self._apply_resize(uid, dict(rec))
                dirty = True
            except Exception:
                logger.exception(
                    "resize roll-forward of claim %s failed; leaving the "
                    "intent for the auditor", uid,
                )
        if dirty:
            self.checkpoint.write(recs)
            # Consumers seeding from the startup state (the usage
            # accountant's rebuild) must see the ROLLED-FORWARD gangs,
            # not the pre-crash ones — stale records would count a
            # released device as occupied for the claim's whole life.
            self.startup_prepared_records = recs

    # ------------------------------------------------------------------
    # Limits resize (the dynamic-sharing rebalance protocol)
    # ------------------------------------------------------------------

    @staticmethod
    def _limits_group_index(rec: dict) -> int:
        """Index of the single ProcessShared work group a limits resize
        may rewrite; typed refusal for every other claim shape (the
        rebalancer must never touch exclusive/time-shared/channel
        claims, and multi-group claims carry configs a single limits
        rewrite would silently conflate)."""
        idx: Optional[int] = None
        for i, group in enumerate(rec.get("groups", [])):
            cfg = group.get("config") or {}
            if cfg.get("adminAccess"):
                continue
            strategy = DeviceState._config_strategy(cfg)
            if strategy != "ProcessShared":
                raise LimitResizeError(
                    "limits resize requires ProcessShared sharing; "
                    f"claim group uses {strategy or 'a channel config'}"
                )
            for dev in group.get("devices", []):
                if dev.get("channel") is not None:
                    raise LimitResizeError(
                        "ICI channel devices carry no per-claim limits"
                    )
            if idx is not None:
                raise LimitResizeError(
                    "claim has multiple device groups with distinct "
                    "configs; limits resize only supports single-group "
                    "claims"
                )
            idx = i
        if idx is None:
            raise LimitResizeError(
                "claim has no ProcessShared device group"
            )
        return idx

    def resize_claim_limits(
        self,
        claim_uid: str,
        tensorcore_percent: Any = None,
        hbm_limit: Any = None,
    ) -> dict:
        """Crash-consistent rewrite of a prepared ProcessShared claim's
        per-claim limits — the rebalancer's apply path.

        Reuses the gang-resize two-phase protocol verbatim, extended
        from device-set changes to limit changes: a ``resize`` intent
        carrying the new ``limits`` is checkpointed FIRST, then the
        sharing session re-renders (store meta + generation-stamped
        limits file) and the CDI claim spec env is rewritten, then the
        finalized record (updated config, bumped ``sharing.generation``)
        replaces the intent. A crash anywhere between intent and
        finalize rolls forward at startup (``_recover_resize_intents``
        dispatches limits intents too); a NON-crash apply failure rolls
        the intent back, restoring the original limits under a further
        generation bump so workloads that glimpsed the half-applied
        limits re-apply the restored ones. The device set, holds, and
        running workload processes are untouched throughout — this is
        the hitless half of a rebalance.

        Each limit is one of: None (keep as is), a value (set), or
        :data:`CLEAR_LIMIT` (remove — back to uncapped).

        Returns ``{"generation": G, ...applied limits...}``.
        """
        if tensorcore_percent is None and hbm_limit is None:
            raise LimitResizeError("no limit changes requested")
        with self._lock:
            prepared_claims = self.checkpoint.read()
            original_rec = prepared_claims.get(claim_uid)
            if original_rec is None:
                raise LimitResizeError(
                    f"claim {claim_uid} is not prepared on this node"
                )
            rec = dict(original_rec)
            self._limits_group_index(rec)  # typed shape refusal, early
            limits: dict[str, Any] = {}
            if tensorcore_percent == CLEAR_LIMIT:
                limits["tensorcorePercent"] = None
            elif tensorcore_percent is not None:
                limits["tensorcorePercent"] = int(tensorcore_percent)
            if hbm_limit == CLEAR_LIMIT:
                limits["hbmLimit"] = None
            elif hbm_limit is not None:
                limits["hbmLimit"] = hbm_limit
            import time as _time

            rec["resize"] = {"limits": limits, "startedAt": _time.time()}
            # Phase 1: intent on disk. From here a crash rolls FORWARD.
            prepared_claims[claim_uid] = rec
            self.checkpoint.write(prepared_claims)
            # Phase 2: apply (session re-render + CDI env), then
            # finalize. A non-crash failure rolls the intent BACK.
            try:
                new_rec = self._apply_limits_intent(claim_uid, rec)
            except BaseException:
                self._rollback_limits_resize(
                    claim_uid, original_rec, prepared_claims
                )
                raise
            prepared_claims[claim_uid] = new_rec
            self.checkpoint.write(prepared_claims)
            generation = (new_rec.get("sharing") or {}).get("generation")
            logger.info(
                "limits resize of claim %s applied: %s (generation %s)",
                claim_uid, limits, generation,
            )
            return {"generation": generation, **limits}

    def _apply_limits_intent(self, claim_uid: str, rec: dict) -> dict:
        """Roll a checkpointed limits intent forward; returns the
        finalized record. Idempotent — the live path, rollback, and
        startup crash recovery all run it, any number of times. The
        generation is derived from the PRE-finalize record (or the
        intent's explicit override, used by rollback), so replays land
        on the same number."""
        import json as _json

        intent = rec["resize"]
        limits = intent["limits"]
        gi = self._limits_group_index(rec)
        groups = rec.get("groups", [])
        group = groups[gi]
        config = _json.loads(_json.dumps(group.get("config") or {}))
        psc = config.setdefault("sharing", {}).setdefault(
            "processSharedConfig", {}
        )
        for wire, key in (("tensorcorePercent",
                           "defaultActiveCorePercentage"),
                          ("hbmLimit", "defaultHbmLimit")):
            if wire not in limits:
                continue
            if limits[wire] is None:
                psc.pop(key, None)
            else:
                psc[key] = limits[wire]
        cfg = decode_config(config)
        cfg.normalize()
        cfg.validate()
        generation = int(
            intent.get("generation")
            or int((rec.get("sharing") or {}).get("generation", 1)) + 1
        )

        devices: list[AllocatableDevice] = []
        for d in group.get("devices", []):
            dev = self._resolve_claimed_device(d["name"])
            if dev is None:
                raise LimitResizeError(
                    f"device {d['name']!r} of claim {claim_uid} is "
                    "neither allocatable nor pinned in the base spec"
                )
            devices.append(dev)
        session = self.ps_manager.new_session(
            claim_uid, devices, cfg.sharing.get_process_shared_config()
        )
        # Never render a generation at or below one already on disk: a
        # dead incarnation (an aborted rollback, a crash mid-apply) may
        # have rendered a HIGHER generation with different limits, and
        # workloads pinned past ours would silently ignore this render.
        on_disk = session.current_generation()
        if on_disk is not None and on_disk >= generation:
            generation = on_disk + 1
        # The hitless re-render: store meta + limits file, no process
        # restart, no hold churn.
        session.resize(generation)

        # Rewrite the CDI claim spec so containers STARTED after this
        # resize see the new env too (running processes get the limits
        # file); admin-group edits are preserved, as in _apply_resize.
        edits = session.container_edits()
        claim_device_edits: dict[str, ContainerEdits] = {}
        visible: list[AllocatableDevice] = list(devices)
        for d in group.get("devices", []):
            claim_device_edits[d["name"]] = ContainerEdits(
                env=dict(edits.env), mounts=list(edits.mounts)
            )
        for g in groups:
            if not (g.get("config") or {}).get("adminAccess"):
                continue
            for pd in g.get("devices", []):
                dev = self._resolve_claimed_device(pd["name"])
                if dev is None:
                    continue
                visible.append(dev)
                admin_edit = ContainerEdits(env={"TPU_DRA_ADMIN": "1"})
                existing = claim_device_edits.get(pd["name"])
                claim_device_edits[pd["name"]] = (
                    existing.merge(admin_edit) if existing else admin_edit
                )
        common_env = self._claim_common_env(visible)
        self.cdi.create_claim_spec_file(
            claim_uid, claim_device_edits, common_env
        )

        new_rec = {k: v for k, v in rec.items() if k != "resize"}
        new_groups = list(groups)
        new_groups[gi] = {**group, "config": config}
        new_rec["groups"] = new_groups
        new_rec["sharing"] = {
            **(rec.get("sharing") or {}), "generation": generation,
        }
        return new_rec

    def _rollback_limits_resize(
        self, claim_uid: str, original_rec: dict, prepared_claims: dict
    ) -> None:
        """Undo a FAILED limits resize by resizing back to the ORIGINAL
        limits — same machinery, original values, generation bumped by
        TWO (the aborted apply may already have rendered generation G+1
        into the limits file, and workloads must re-apply the restored
        limits, not ignore them as stale). If the rollback itself fails,
        the intent is left on disk for the auditor's ``resize`` check —
        loud, never silent. Caller re-raises the original error."""
        try:
            gen = int(
                (original_rec.get("sharing") or {}).get("generation", 1)
            )
            gi = self._limits_group_index(original_rec)
            psc = (
                ((original_rec["groups"][gi].get("config") or {})
                 .get("sharing") or {}).get("processSharedConfig") or {}
            )
            rollback_rec = dict(original_rec)
            rollback_rec["resize"] = {
                "limits": {
                    "tensorcorePercent": psc.get(
                        "defaultActiveCorePercentage"
                    ),
                    "hbmLimit": psc.get("defaultHbmLimit"),
                },
                "generation": gen + 2,
            }
            restored = self._apply_limits_intent(claim_uid, rollback_rec)
            prepared_claims[claim_uid] = restored
            self.checkpoint.write(prepared_claims)
        except Exception:
            logger.exception(
                "rollback of failed limits resize of claim %s also "
                "failed; leaving the intent for the state auditor",
                claim_uid,
            )

    @staticmethod
    def _gang_view_of(claim_uid: str, rec: dict) -> Optional[dict]:
        """Record → elastic-coordinator view (see gang_view)."""
        from ..tpulib.deviceinfo import chip_uuid_of_device_uuid

        devices: list[tuple[str, str]] = []
        device_types: set[str] = set()
        request_names: set[str] = set()
        for group in rec.get("groups", []):
            if (group.get("config") or {}).get("adminAccess"):
                continue
            for dev in group.get("devices", []):
                if dev.get("channel") is not None:
                    continue
                uuids = dev.get("uuids") or [""]
                devices.append(
                    (dev["name"], chip_uuid_of_device_uuid(uuids[0]))
                )
                device_types.add(dev.get("type", ""))
                for rn in (dev.get("device") or {}).get(
                    "requestNames", []
                ):
                    request_names.add(rn)
        if not devices:
            return None
        elastic = rec.get("elastic") or {}
        return {
            "claim_uid": claim_uid,
            "namespace": rec.get("namespace", ""),
            "name": rec.get("name", ""),
            "devices": devices,
            # The CHECKPOINTED device types (PreparedDevice.type) — the
            # re-solve's DeviceClass must come from here, never from
            # re-parsing device names (deviceinfo owns those forms).
            "device_types": sorted(device_types),
            # Claim-spec request names the gang was prepared under — the
            # re-solve must reuse these, never invent its own.
            "request_names": sorted(request_names),
            "desired": elastic.get("desired"),
            "generation": int(elastic.get("generation", 0)),
        }

    def gang_view(self, claim_uid: str) -> Optional[dict]:
        """The elastic coordinator's view of one checkpointed claim:
        non-admin chip/tensorcore device names in allocation order with
        their governing chip uuids and checkpointed device types, plus
        the claim's elastic metadata. None when the claim is unknown (or
        holds nothing resizable)."""
        with self._lock:
            rec = self.checkpoint.read().get(claim_uid)
        if rec is None:
            return None
        return self._gang_view_of(claim_uid, rec)

    def gangs_on_chip(self, chip_uuid: str) -> list[dict]:
        """gang_view for every checkpointed claim holding this chip
        (directly or via a core partition) — the shrink scan's input,
        built from ONE checkpoint read."""
        with self._lock:
            recs = self.checkpoint.read()
        views = []
        for uid, rec in recs.items():
            uuids = [
                u
                for g in rec.get("groups", [])
                for d in g.get("devices", [])
                for u in d.get("uuids", [])
            ]
            if not any(
                u == chip_uuid or u.startswith(f"{chip_uuid}-")
                for u in uuids
            ):
                continue
            v = self._gang_view_of(uid, rec)
            if v is not None:
                views.append(v)
        return views

    def elastic_claims(self) -> list[dict]:
        """gang_view for every claim carrying elastic metadata (i.e. that
        has been gang-resized at least once) — the grow scan. ONE
        checkpoint read for the whole scan."""
        with self._lock:
            recs = self.checkpoint.read()
        views = []
        for uid, rec in recs.items():
            if not rec.get("elastic"):
                continue
            v = self._gang_view_of(uid, rec)
            if v is not None:
                views.append(v)
        return views

    # ------------------------------------------------------------------
    # Publication
    # ------------------------------------------------------------------

    def refresh_allocatable(self) -> bool:
        """Re-enumerate inventory AND poll chip health; True when either
        changed the published view.

        The consumer is the driver's device-watch loop: chip hot-plug /
        vfio rebind must reach the published ResourceSlices, a path the
        reference lacks entirely (NVML enumeration happens once at
        startup, nvlib.go:111-136). Health transitions ride the same
        change detection — a flipped healthy attribute (or a dropped gone
        chip) alters the rendered devices, so the caller republishes; the
        transition log feeds Events/metrics via
        ``drain_health_transitions``. Prepared claims are unaffected —
        they carry their own device snapshots through the checkpoint.
        """
        with self._lock:
            # ONE hardware probe per tick (ChipLib.snapshot): chips and
            # health observe the same instant — a chip can never
            # enumerate present while the same refresh reports it gone —
            # and the lock (shared with Prepare RPCs) is held for a
            # single walk, not two.
            chips, lib_health = self.chiplib.snapshot()
            health = self._merge_gone(lib_health)
            self._record_transitions(health)
            self.chip_health = health
            fresh = self._stamp_health(
                self.chiplib.enumerate_all_possible_devices(
                    self.device_classes, chips=chips
                ),
                health,
            )
            changed = (
                {n: d.get_device() for n, d in fresh.items()}
                != {n: d.get_device() for n, d in self.allocatable.items()}
            )
            if changed:
                # The base CDI spec must keep entries that prepared claims'
                # recorded cdi_device_ids still point at (a mid-rebind
                # enumeration must not break a container about to start);
                # the allocatable map and published slices track the fresh
                # truth only, so a vanished chip cannot be newly prepared.
                # Retention reads the PREVIOUS spec contents, not
                # allocatable, so the pin survives any number of unrelated
                # inventory changes until the claim unprepares.
                spec_devices = dict(fresh)
                for name in self._prepared_device_names():
                    if (name not in spec_devices
                            and name in self._base_spec_devices):
                        spec_devices[name] = self._base_spec_devices[name]
                self.allocatable = fresh
                self._base_spec_devices = spec_devices
                self.cdi.create_standard_device_spec_file(spec_devices)
        return changed

    def _prepared_device_names(self) -> set:
        """Device names referenced by any checkpointed prepared claim."""
        names = set()
        for rec in self.checkpoint.read().values():
            for group in rec.get("groups", []):
                for dev in group.get("devices", []):
                    if dev.get("name"):
                        names.add(dev["name"])
        return names

    def cached_devices(self, claim_uid: str) -> Optional[list[KubeletDevice]]:
        """The checkpointed prepare result for a claim, or None.

        Degraded-mode seam: when the apiserver is unreachable the driver
        serves kubelet retries of ALREADY-PREPARED claims from this — the
        checkpoint is the ground truth the idempotent-prepare contract
        rests on, and a pod restart must not hinge on apiserver health.
        """
        with self._lock:
            recs = self.checkpoint.read()
            rec = recs.get(claim_uid)
            if rec is None:
                return None
            return PreparedClaim.from_dict(rec).get_devices()

    def parent_uuid_of_mig(self, name: str) -> Optional[str]:
        """The GPU uuid of the MIG device ``name`` in the base spec, or
        None for any other device: a MIG uuid names no parent, so the
        parent is found by device name."""
        dev = self._base_spec_devices.get(name)
        if dev is not None and isinstance(dev.tensorcore, MigDeviceInfo):
            return dev.tensorcore.parent.uuid
        return None

    def prepared_claims_on_chip(self, chip_uuid: str) -> list[PreparedClaim]:
        """Checkpointed claims holding this chip (directly or via one of
        its core partitions, whose uuids are prefixed by the chip's, or
        one of its MIG devices, named by the base spec) — the Event
        targets when a carrying chip degrades."""
        with self._lock:
            recs = self.checkpoint.read()
            partitions = {name for name in self._base_spec_devices
                          if self.parent_uuid_of_mig(name) == chip_uuid}
        out = []
        for rec in recs.values():
            pc = PreparedClaim.from_dict(rec)
            uuids = [
                u for g in pc.groups for d in g.devices for u in d.uuids
            ]
            names = {d.name for g in pc.groups for d in g.devices}
            if any(u == chip_uuid or u.startswith(f"{chip_uuid}-")
                   for u in uuids) or names & partitions:
                out.append(pc)
        return out

    def usage_inventory(self) -> dict[str, Any]:
        """Capacity + chip-health view for the utilization accountant.

        Deliberately lock-free: ``allocatable`` and ``chip_health`` are
        replaced wholesale (atomic reference assignment) by
        ``refresh_allocatable``, so grabbing the references and iterating
        them is consistent — and the accountant's render hook can call
        this from the scrape thread without ordering against the
        DeviceState lock held by an in-flight prepare.
        """
        alloc = self.allocatable
        health = self.chip_health
        capacity: dict[str, int] = {}
        for dev in alloc.values():
            capacity[dev.type()] = capacity.get(dev.type(), 0) + 1
        return {
            "capacity": capacity,
            "chips": {
                uuid: {
                    "state": st.state,
                    "since": st.since,
                    "reason": st.reason,
                }
                for uuid, st in health.items()
            },
        }

    def published_resources(self) -> dict[str, Any]:
        """DriverResources (pool spec) for the ResourceSlice controller —
        node-local devices only, ICI channels are published by the cluster
        controller (driver.go:69-80 excludes IMEX likewise)."""
        from ..tpulib.deviceinfo import counter_sets

        devices = []
        for name, dev in sorted(self.allocatable.items()):
            if dev.ici_channel is not None:
                continue
            devices.append(dev.get_device())
        return {
            "devices": devices,
            "sharedCounters": counter_sets(self.allocatable),
        }
