"""resource.k8s.io API-version negotiation and wire conversion.

The reference pins a single API generation at build time (go.mod:5 pins
k8s.io/api with resource/v1alpha3; the vendored kubeletplugin hardcodes the
matching gRPC service, vendor/k8s.io/dynamic-resource-allocation/
kubeletplugin/draplugin.go:320-335) and so never faces version skew: a
cluster either serves exactly that generation or the driver does not work.
This driver instead discovers the served ``resource.k8s.io`` version at
startup and speaks it on the wire, because the clusters it targets straddle
THREE boundaries: k8s 1.31 serves only ``v1alpha3``, 1.32 serves
``v1beta1`` (and typically not v1alpha3 at all), 1.33 adds ``v1beta2``
with a reshaped Device and claim-request schema, and 1.34 GAs that shape
as ``v1``.

Design: every object INSIDE the driver uses one canonical shape — the
v1beta1 one, where device capacities are ``{"value": "<quantity>"}``
(DeviceCapacity) rather than v1alpha3's bare quantity strings. Conversion
happens only at the wire boundary:

- ``slice_to_wire``   canonical ResourceSlice -> served dialect
- ``slice_from_wire`` served dialect -> canonical (tolerant: accepts either
  shape, so mixed-version transcripts and already-canonical fakes both work)
- ``claim_to_wire`` / ``claim_from_wire`` — restamp for v1alpha3/v1beta1
  (identical claim structure); wrap/unwrap the ``exactly`` request
  nesting for v1beta2/v1. DeviceClass is identical everywhere.

``sharedCounters`` / ``consumesCounters`` (the partitionable-devices
extension this driver publishes for sub-chip TensorCore exclusivity) carry
``{"value": ...}`` counters in EVERY dialect: the older generations never
defined them upstream — they are the 1.33-era shape, passed through
untouched so the allocator sees one form.
"""

from __future__ import annotations

import dataclasses
import logging
import time

from .client import GVR, KubeClient

logger = logging.getLogger(__name__)

GROUP = "resource.k8s.io"

# Dialects this driver can speak, newest (preferred) first. The deltas:
#
# - v1alpha3 (k8s 1.31): device capacities are BARE quantity strings
#   (types.go:220); devices wrap their payload in ``basic``.
# - v1beta1 (k8s 1.32): capacities become DeviceCapacity
#   ``{"value": ...}``; ``basic`` wrapper retained. This is the
#   CANONICAL in-memory shape.
# - v1beta2 (k8s 1.33): the ``basic`` wrapper is REMOVED (attributes/
#   capacity/consumesCounters live directly on the Device), and claim
#   requests nest their payload under ``exactly`` (ExactDeviceRequest)
#   to make room for ``firstAvailable`` prioritized-list requests.
# - v1 (k8s 1.34, DRA GA): structurally v1beta2 — the GA promotion kept
#   the flattened Device and exactly-nested request shapes.
SUPPORTED_VERSIONS = ("v1", "v1beta2", "v1beta1", "v1alpha3")

# Dialects whose wire shape is the flattened/exactly-nested one.
_FLAT_DEVICE_VERSIONS = ("v1", "v1beta2")

# Canonical apiVersion stamp for in-memory objects.
CANONICAL_VERSION = "v1beta1"

# The version assumed when discovery is impossible (no client, or the
# group is absent): the oldest supported one, matching the clusters the
# original deploy scripts targeted.
DEFAULT_VERSION = "v1alpha3"


@dataclasses.dataclass(frozen=True)
class ResourceApi:
    """One served dialect of the resource.k8s.io group."""

    version: str = DEFAULT_VERSION

    def __post_init__(self):
        if self.version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported resource.k8s.io version {self.version!r}; "
                f"supported: {SUPPORTED_VERSIONS}"
            )

    # -- addressing --------------------------------------------------------

    @property
    def api_version(self) -> str:
        return f"{GROUP}/{self.version}"

    @property
    def slices(self) -> GVR:
        return GVR(self.api_version, "resourceslices")

    @property
    def claims(self) -> GVR:
        return GVR(self.api_version, "resourceclaims", namespaced=True)

    @property
    def device_classes(self) -> GVR:
        return GVR(self.api_version, "deviceclasses")

    # -- discovery ---------------------------------------------------------

    @classmethod
    def discover(
        cls,
        client: KubeClient | None,
        retries: int = 2,
        retry_delay: float = 1.0,
    ) -> "ResourceApi":
        """Pick the newest supported dialect the server serves.

        GET ``/apis/resource.k8s.io`` (k8s API group discovery). Transient
        failures (the apiserver is routinely unreachable for a beat during
        node bring-up) are retried; only then does it fall back to
        ``DEFAULT_VERSION`` — loudly — so a driver pointed at a broken
        server still starts and surfaces the real failure on first write.
        Long outages are covered by the NotFound-triggered re-discovery in
        the slice controller and claim fetch path, so a wrong fallback is
        corrected without a pod restart.
        """
        if client is None:
            return cls(DEFAULT_VERSION)
        attempt = 0
        while True:
            try:
                served = client.api_group_versions(GROUP)
                break
            except Exception as e:
                if attempt >= retries:
                    logger.warning(
                        "discovery of /apis/%s failed after %d attempts "
                        "(%s); assuming %s",
                        GROUP, attempt + 1, e, DEFAULT_VERSION,
                    )
                    return cls(DEFAULT_VERSION)
                attempt += 1
                time.sleep(retry_delay)
        return cls._pick(served)

    @classmethod
    def try_discover(cls, client: KubeClient | None) -> "ResourceApi | None":
        """Discovery with NO fallback: a positive answer or None.

        For the NotFound-triggered re-discovery paths, where the fallback
        semantics of ``discover`` would be actively harmful — a transient
        discovery failure must not masquerade as "the server moved to
        v1alpha3" and re-target a correctly-negotiated driver onto a
        dialect the server never served."""
        if client is None:
            return None
        try:
            served = client.api_group_versions(GROUP)
        except Exception as e:
            logger.warning("re-discovery of /apis/%s failed (%s)", GROUP, e)
            return None
        for v in SUPPORTED_VERSIONS:
            if v in served:
                return cls(v)
        return None

    @classmethod
    def _pick(cls, served: list) -> "ResourceApi":
        for v in SUPPORTED_VERSIONS:
            if v in served:
                api = cls(v)
                logger.info(
                    "resource.k8s.io served versions %s; speaking %s",
                    served, api.api_version,
                )
                return api
        logger.warning(
            "server serves resource.k8s.io versions %s, none of which this "
            "driver supports (%s); assuming %s",
            served, SUPPORTED_VERSIONS, DEFAULT_VERSION,
        )
        return cls(DEFAULT_VERSION)

    # -- ResourceSlice conversion ------------------------------------------

    def slice_to_wire(self, obj: dict) -> dict:
        """Canonical slice -> the served dialect.

        v1beta1 IS the canonical shape, so only the apiVersion is
        stamped; v1alpha3 additionally unwraps device capacities to bare
        quantity strings (v1alpha3 types.go:220); v1beta2 removes the
        ``basic`` device wrapper (attributes/capacity/consumesCounters
        inline on the Device).
        """
        out = dict(obj)
        out["apiVersion"] = self.api_version
        if self.version == "v1alpha3":
            out["spec"] = _map_device_capacity(obj.get("spec", {}), _unwrap)
        elif self.version in _FLAT_DEVICE_VERSIONS:
            out["spec"] = _map_devices(obj.get("spec", {}), _flatten_device)
        return out

    def slice_from_wire(self, obj: dict) -> dict:
        """Served dialect -> canonical. Tolerant of every dialect's shape
        (idempotent on already-canonical objects), so fakes and mixed
        transcripts need no special-casing."""
        out = dict(obj)
        out["apiVersion"] = f"{GROUP}/{CANONICAL_VERSION}"
        spec = _map_devices(obj.get("spec", {}), _nest_device)
        out["spec"] = _map_device_capacity(spec, _wrap)
        return out

    # -- ResourceClaim / DeviceClass conversion ----------------------------

    def claim_to_wire(self, obj: dict) -> dict:
        """Canonical claim -> the served dialect. v1alpha3/v1beta1 share
        the claim structure (restamp only); v1beta2 nests each request's
        payload under ``exactly`` (ExactDeviceRequest), the shape that
        makes room for prioritized-list requests."""
        out = dict(obj)
        out["apiVersion"] = self.api_version
        if self.version in _FLAT_DEVICE_VERSIONS:
            out["spec"] = _map_requests(obj.get("spec"), _wrap_exactly)
        return out

    def class_to_wire(self, obj: dict) -> dict:
        """DeviceClass is structurally identical across all three
        dialects; restamp the apiVersion only."""
        out = dict(obj)
        out["apiVersion"] = self.api_version
        return out

    def claim_from_wire(self, obj: dict) -> dict:
        """Wire claim -> canonical: flatten v1beta2 ``exactly`` wrappers
        (tolerant; ``firstAvailable`` prioritized lists pass through
        untouched — no older dialect can express them)."""
        out = dict(obj)
        out["apiVersion"] = f"{GROUP}/{CANONICAL_VERSION}"
        out["spec"] = _map_requests(obj.get("spec"), _unwrap_exactly)
        return out


def _wrap(value) -> dict:
    """Bare quantity -> DeviceCapacity. Idempotent on wrapped values."""
    if isinstance(value, dict):
        return value
    return {"value": str(value)}


def _unwrap(value):
    """DeviceCapacity -> bare quantity string. Idempotent on bare values."""
    if isinstance(value, dict):
        return value.get("value", "")
    return value


def _flatten_device(dev: dict) -> dict:
    """Canonical device -> v1beta2: hoist the ``basic`` payload onto the
    Device itself. Idempotent on already-flat devices."""
    basic = dev.get("basic")
    if not isinstance(basic, dict):
        return dev
    out = {k: v for k, v in dev.items() if k != "basic"}
    out.update(basic)
    return out


_BASIC_FIELDS = ("attributes", "capacity", "consumesCounters")


def _nest_device(dev: dict) -> dict:
    """v1beta2 device -> canonical: re-nest the payload under ``basic``.
    Idempotent on devices that already carry the wrapper."""
    if "basic" in dev or not any(f in dev for f in _BASIC_FIELDS):
        return dev
    out = {k: v for k, v in dev.items() if k not in _BASIC_FIELDS}
    out["basic"] = {f: dev[f] for f in _BASIC_FIELDS if f in dev}
    return out


def _map_devices(spec: dict, fn) -> dict:
    devices = spec.get("devices")
    if not devices or not isinstance(devices, list):
        return spec
    new_devices = [fn(d) if isinstance(d, dict) else d for d in devices]
    if new_devices == devices:
        return spec
    out = dict(spec)
    out["devices"] = new_devices
    return out


def _wrap_exactly(req: dict) -> dict:
    """Canonical flat request -> v1beta2 {name, exactly: {...}}.
    Requests already in v1beta2 form (exactly/firstAvailable) pass
    through."""
    if "exactly" in req or "firstAvailable" in req:
        return req
    payload = {k: v for k, v in req.items() if k != "name"}
    out = {"name": req.get("name", "")}
    if payload:
        out["exactly"] = payload
    return out


def _unwrap_exactly(req: dict) -> dict:
    """v1beta2 {name, exactly: {...}} -> canonical flat request."""
    exactly = req.get("exactly")
    if not isinstance(exactly, dict):
        return req
    out = {k: v for k, v in req.items() if k != "exactly"}
    out.update(exactly)
    return out


def _map_requests(spec, fn) -> dict:
    spec = spec if isinstance(spec, dict) else {}
    devices = spec.get("devices")
    if not isinstance(devices, dict):
        return spec
    requests = devices.get("requests")
    if not requests or not isinstance(requests, list):
        return spec
    new_requests = [fn(r) if isinstance(r, dict) else r for r in requests]
    if new_requests == requests:
        return spec
    out = dict(spec)
    out["devices"] = dict(devices)
    out["devices"]["requests"] = new_requests
    return out


def _map_device_capacity(spec: dict, fn) -> dict:
    """Rewrite every ``devices[].basic.capacity`` value through ``fn``,
    copying only the paths touched (slices are shared with callers)."""
    devices = spec.get("devices")
    if not devices:
        return spec
    new_devices = []
    changed = False
    for dev in devices:
        basic = dev.get("basic") or {}
        cap = basic.get("capacity")
        if not cap:
            new_devices.append(dev)
            continue
        new_cap = {k: fn(v) for k, v in cap.items()}
        if new_cap == cap:
            new_devices.append(dev)
            continue
        changed = True
        new_basic = dict(basic)
        new_basic["capacity"] = new_cap
        new_dev = dict(dev)
        new_dev["basic"] = new_basic
        new_devices.append(new_dev)
    if not changed:
        return spec
    out = dict(spec)
    out["devices"] = new_devices
    return out
