"""Structural validation for resource.k8s.io objects (apiserver analog).

Without a real API server, nothing would apply its validation to the
objects this driver emits: FakeKubeClient would store any shape. This
module encodes the upstream validation contract for the
object kinds the driver touches, in every served dialect (v1alpha3
through v1), so the fake can reject what a real apiserver would reject.

Rules and limits are transcribed from the reference's vendored API types
(lengrongfu/k8s-dra-driver, vendor/k8s.io/api/resource/v1alpha3/types.go):

- QualifiedName: C identifier, optionally ``<dns-subdomain>/`` prefixed;
  domain <= 63, identifier <= 32 (types.go:226-248)
- DeviceAttribute: exactly one of int/bool/string/version; string and
  version values <= 64 chars (types.go:251-283)
- ResourceSliceMaxDevices = 128, ResourceSliceMaxSharedCapacity = 128,
  ResourceSliceMaxAttributesAndCapacitiesPerDevice = 32,
  PoolNameMaxLength = 253 (types.go:184-224)
- exactly one of spec.nodeName / nodeSelector / allNodes (types.go:120-160)
- DeviceRequestsMaxSize / DeviceConstraintsMaxSize / DeviceConfigMaxSize /
  DeviceSelectorsMaxSize / AllocationResultsMaxSize /
  ResourceClaimReservedForMaxSize = 32 (types.go:374-376,460,660,737)

Dialect deltas (kube/resourceapi.py): v1alpha3 capacities are bare
quantity strings; v1beta1 wraps them as DeviceCapacity ``{"value": ...}``;
v1beta2/v1 inline the device payload (no ``basic``) and nest claim-request
payloads under ``exactly``.
``sharedCounters``/``consumesCounters`` (this driver's partitionable-
devices extension) always use the wrapped Counter form.
"""

from __future__ import annotations

import re

# -- limits (types.go references above) --------------------------------------

MAX_DEVICES_PER_SLICE = 128
MAX_SHARED_COUNTERS = 128
MAX_ATTRS_AND_CAPS_PER_DEVICE = 32
MAX_DOMAIN_LEN = 63
MAX_ID_LEN = 32
MAX_ATTR_VALUE_LEN = 64
MAX_POOL_NAME_LEN = 253
MAX_REQUESTS = 32
MAX_SELECTORS = 32
MAX_CONSTRAINTS = 32
MAX_CONFIGS = 32
MAX_ALLOCATION_RESULTS = 32
MAX_RESERVED_FOR = 32

_DNS_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_C_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
# k8s resource.Quantity surface syntax (decimal, optional SI/binary suffix).
_QUANTITY = re.compile(
    r"^[+-]?([0-9]+|[0-9]*\.[0-9]+)([eE][+-]?[0-9]+|[kKMGTPE]i?|m|u|n)?$"
)
# semver-ish (semver.org 2.0.0 core, optional pre-release/build).
_VERSION = re.compile(
    r"^[0-9]+\.[0-9]+\.[0-9]+(-[0-9A-Za-z.-]+)?(\+[0-9A-Za-z.-]+)?$"
)

SUPPORTED_VERSIONS = ("v1alpha3", "v1beta1", "v1beta2", "v1")

# Dialects with the flattened-Device / exactly-nested-request shape.
_FLAT_VERSIONS = ("v1beta2", "v1")


class SchemaError(ValueError):
    """One or more violations a real API server would reject with 422."""

    def __init__(self, kind: str, issues: list[str]):
        self.kind = kind
        self.issues = issues
        super().__init__(
            f"{kind} fails validation ({len(issues)} issue(s)): "
            + "; ".join(issues[:10])
        )


# -- primitive validators ----------------------------------------------------


def _is_int(value) -> bool:
    """True for int64-shaped values. bool is a subclass of int in
    Python; a JSON true is NOT an integer to the apiserver."""
    return isinstance(value, int) and not isinstance(value, bool)


def _dict_items(value, path, issues):
    """Iterate a list-of-objects field defensively: a non-list value or a
    non-dict element is a schema issue (422), never a Python crash out of
    the validator."""
    if value is None:
        return []
    if not isinstance(value, list):
        issues.append(f"{path}: must be a list")
        return []
    out = []
    for i, el in enumerate(value):
        if isinstance(el, dict):
            out.append((i, el))
        else:
            issues.append(f"{path}[{i}]: must be an object")
    return out


def _map_items(value, path, issues):
    if value is None:
        return {}
    if not isinstance(value, dict):
        issues.append(f"{path}: must be a map")
        return {}
    return value


def _dns_label(value, path, issues, max_len=63):
    if not isinstance(value, str) or not value:
        issues.append(f"{path}: required DNS-1123 label, got {value!r}")
        return
    if len(value) > max_len or not _DNS_LABEL.match(value):
        issues.append(f"{path}: invalid DNS-1123 label {value!r}")


def _dns_subdomain(value, path, issues, max_len=253):
    if not isinstance(value, str) or not value:
        issues.append(f"{path}: required DNS-1123 subdomain, got {value!r}")
        return
    if len(value) > max_len:
        issues.append(f"{path}: {value!r} exceeds {max_len} chars")
        return
    for part in value.split("."):
        if not _DNS_LABEL.match(part):
            issues.append(f"{path}: invalid DNS-1123 subdomain {value!r}")
            return


def _qualified_name(name, path, issues):
    """C identifier with an optional DNS-subdomain/ prefix
    (types.go:226-248)."""
    if not isinstance(name, str) or not name:
        issues.append(f"{path}: empty qualified name")
        return
    domain, slash, ident = name.rpartition("/")
    if slash and not domain:
        issues.append(f"{path}: {name!r} has an empty domain")
        return
    if domain:
        _dns_subdomain(domain, f"{path} (domain of {name!r})", issues,
                       max_len=MAX_DOMAIN_LEN)
    if len(ident) > MAX_ID_LEN:
        issues.append(
            f"{path}: identifier of {name!r} exceeds {MAX_ID_LEN} chars"
        )
    elif not _C_IDENT.match(ident):
        issues.append(f"{path}: {name!r} is not a C identifier")


def _quantity(value, path, issues):
    if not isinstance(value, (str, int)):
        issues.append(f"{path}: quantity must be a string, got {type(value).__name__}")
        return
    if not _QUANTITY.match(str(value)):
        issues.append(f"{path}: invalid quantity {value!r}")


def _counter_map(counters, path, issues):
    """Counter maps (sharedCounters[].counters / consumesCounters[].counters):
    qualified names -> {"value": quantity} in both dialects."""
    if not isinstance(counters, dict):
        issues.append(f"{path}: must be a map")
        return
    for cname, cval in counters.items():
        _qualified_name(cname, f"{path}[{cname!r}]", issues)
        if not isinstance(cval, dict) or set(cval) != {"value"}:
            issues.append(
                f"{path}[{cname!r}]: counter must be {{'value': <quantity>}}"
            )
            continue
        _quantity(cval["value"], f"{path}[{cname!r}].value", issues)


def _attribute(value, path, issues):
    """DeviceAttribute: exactly one of int/bool/string/version
    (types.go:251-283)."""
    if not isinstance(value, dict):
        issues.append(f"{path}: attribute must be a value union, got "
                      f"{type(value).__name__}")
        return
    fields = set(value) & {"int", "bool", "string", "version"}
    if len(set(value)) != 1 or len(fields) != 1:
        issues.append(
            f"{path}: exactly one of int/bool/string/version required, "
            f"got {sorted(value)}"
        )
        return
    (field,) = fields
    v = value[field]
    # bool is a subclass of int in Python; a JSON true is NOT an int64.
    if field == "int" and (isinstance(v, bool) or not isinstance(v, int)):
        issues.append(f"{path}.int: not an integer: {v!r}")
    if field == "bool" and not isinstance(v, bool):
        issues.append(f"{path}.bool: not a boolean: {v!r}")
    if field in ("string", "version"):
        if not isinstance(v, str):
            issues.append(f"{path}.{field}: not a string: {v!r}")
        elif len(v) > MAX_ATTR_VALUE_LEN:
            issues.append(
                f"{path}.{field}: value exceeds {MAX_ATTR_VALUE_LEN} chars"
            )
        elif field == "version" and not _VERSION.match(v):
            issues.append(f"{path}.version: not a semver value: {v!r}")


def _node_selector(sel, path, issues):
    if not isinstance(sel, dict):
        issues.append(f"{path}: must be a v1.NodeSelector object")
        return
    terms = sel.get("nodeSelectorTerms")
    if not isinstance(terms, list) or not terms:
        issues.append(f"{path}.nodeSelectorTerms: required non-empty list")
        return
    for i, term in _dict_items(terms, f"{path}.nodeSelectorTerms", issues):
        for j, expr in _dict_items(
            term.get("matchExpressions"),
            f"{path}.nodeSelectorTerms[{i}].matchExpressions", issues,
        ):
            p = f"{path}.nodeSelectorTerms[{i}].matchExpressions[{j}]"
            if not expr.get("key"):
                issues.append(f"{p}.key: required")
            if expr.get("operator") not in (
                "In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"
            ):
                issues.append(f"{p}.operator: invalid {expr.get('operator')!r}")


def _cel_selectors(selectors, path, issues):
    if selectors is None:
        return
    if not isinstance(selectors, list):
        issues.append(f"{path}: must be a list")
        return
    if len(selectors) > MAX_SELECTORS:
        issues.append(f"{path}: more than {MAX_SELECTORS} selectors")
    for i, sel in _dict_items(selectors, path, issues):
        cel = sel.get("cel")
        if not isinstance(cel, dict) or not isinstance(
            cel.get("expression"), str
        ) or not cel["expression"].strip():
            issues.append(
                f"{path}[{i}]: exactly 'cel' with a non-empty expression "
                "is required"
            )


# -- object validators -------------------------------------------------------


def _check_type_meta(obj, kind, issues):
    api_version = obj.get("apiVersion", "")
    group, _, version = api_version.partition("/")
    if group != "resource.k8s.io" or version not in SUPPORTED_VERSIONS:
        issues.append(
            f"apiVersion: {api_version!r} is not a supported "
            f"resource.k8s.io dialect {SUPPORTED_VERSIONS}"
        )
        version = None
    if obj.get("kind") != kind:
        issues.append(f"kind: {obj.get('kind')!r} != {kind!r}")
    name = (obj.get("metadata") or {}).get("name", "")
    if name:
        _dns_subdomain(name, "metadata.name", issues)
    elif not (obj.get("metadata") or {}).get("generateName"):
        issues.append("metadata.name: required")
    return version


def validate_resource_slice(obj: dict) -> None:
    """Apply upstream ResourceSlice validation (both dialects; the
    capacity shape checked is the one the object's apiVersion declares)."""
    issues: list[str] = []
    version = _check_type_meta(obj, "ResourceSlice", issues)
    spec = obj.get("spec")
    if not isinstance(spec, dict):
        raise SchemaError("ResourceSlice", issues + ["spec: required"])
    _dns_subdomain(spec.get("driver", ""), "spec.driver", issues)

    pool = spec.get("pool")
    if not isinstance(pool, dict):
        issues.append("spec.pool: required")
    else:
        pname = pool.get("name", "")
        if not pname or len(pname) > MAX_POOL_NAME_LEN:
            issues.append(f"spec.pool.name: required, <= {MAX_POOL_NAME_LEN}")
        else:
            for seg in pname.split("/"):
                _dns_subdomain(seg, "spec.pool.name segment", issues)
        if not _is_int(pool.get("generation")):
            issues.append("spec.pool.generation: required integer")
        if not _is_int(pool.get("resourceSliceCount")) or (
            pool["resourceSliceCount"] < 1
        ):
            issues.append("spec.pool.resourceSliceCount: required, >= 1")

    node_fields = [
        f for f in ("nodeName", "nodeSelector", "allNodes")
        if spec.get(f)
    ]
    if len(node_fields) != 1:
        issues.append(
            "spec: exactly one of nodeName/nodeSelector/allNodes is "
            f"required, got {node_fields or 'none'}"
        )
    if spec.get("nodeName"):
        _dns_subdomain(spec["nodeName"], "spec.nodeName", issues)
    if spec.get("nodeSelector") is not None:
        _node_selector(spec["nodeSelector"], "spec.nodeSelector", issues)

    devices = _dict_items(spec.get("devices"), "spec.devices", issues)
    if len(devices) > MAX_DEVICES_PER_SLICE:
        issues.append(
            f"spec.devices: {len(devices)} devices exceeds "
            f"{MAX_DEVICES_PER_SLICE}"
        )
    seen_devices = set()
    for i, dev in devices:
        p = f"spec.devices[{i}]"
        _dns_label(dev.get("name", ""), f"{p}.name", issues)
        if dev.get("name") in seen_devices:
            issues.append(f"{p}.name: duplicate {dev.get('name')!r}")
        seen_devices.add(dev.get("name"))
        if version in _FLAT_VERSIONS:
            # v1beta2/v1 removed the wrapper: the payload lives on the
            # Device itself, and a lingering 'basic' is wrong-dialect.
            if "basic" in dev:
                issues.append(
                    f"{p}.basic: not a {version} field (device payload "
                    "is inline)"
                )
                continue
            basic = dev
        else:
            basic = dev.get("basic")
            if not isinstance(basic, dict):
                issues.append(f"{p}.basic: required")
                continue
        attrs = _map_items(basic.get("attributes"), f"{p}.attributes", issues)
        caps = _map_items(basic.get("capacity"), f"{p}.capacity", issues)
        if len(attrs) + len(caps) > MAX_ATTRS_AND_CAPS_PER_DEVICE:
            issues.append(
                f"{p}: {len(attrs)}+{len(caps)} attributes+capacities "
                f"exceeds {MAX_ATTRS_AND_CAPS_PER_DEVICE}"
            )
        for aname, aval in attrs.items():
            _qualified_name(aname, f"{p}.attributes", issues)
            _attribute(aval, f"{p}.attributes[{aname!r}]", issues)
        for cname, cval in caps.items():
            _qualified_name(cname, f"{p}.capacity", issues)
            cp = f"{p}.capacity[{cname!r}]"
            if version == "v1alpha3":
                # Bare resource.Quantity (types.go:220).
                if isinstance(cval, dict):
                    issues.append(
                        f"{cp}: v1alpha3 capacity must be a bare quantity "
                        "string, got an object"
                    )
                else:
                    _quantity(cval, cp, issues)
            else:
                # v1beta1 DeviceCapacity {"value": quantity}.
                if not isinstance(cval, dict) or set(cval) != {"value"}:
                    issues.append(
                        f"{cp}: v1beta1 capacity must be "
                        "{'value': <quantity>}"
                    )
                else:
                    _quantity(cval["value"], f"{cp}.value", issues)
        for j, cc in _dict_items(
            basic.get("consumesCounters"), f"{p}.consumesCounters", issues
        ):
            cp = f"{p}.consumesCounters[{j}]"
            _dns_label(cc.get("counterSet", ""), f"{cp}.counterSet", issues,
                       max_len=253)
            _counter_map(cc.get("counters"), f"{cp}.counters", issues)

    shared = _dict_items(
        spec.get("sharedCounters"), "spec.sharedCounters", issues
    )
    if len(shared) > MAX_SHARED_COUNTERS:
        issues.append(
            f"spec.sharedCounters: {len(shared)} exceeds "
            f"{MAX_SHARED_COUNTERS}"
        )
    declared = set()
    for i, cs in shared:
        p = f"spec.sharedCounters[{i}]"
        _dns_label(cs.get("name", ""), f"{p}.name", issues, max_len=253)
        declared.add(cs.get("name"))
        _counter_map(cs.get("counters"), f"{p}.counters", issues)
    for i, dev in devices:
        basic = dev if version in _FLAT_VERSIONS else dev.get("basic")
        if not isinstance(basic, dict):
            continue
        for j, cc in _dict_items(
            basic.get("consumesCounters"),
            f"spec.devices[{i}].consumesCounters", [],
        ):
            if cc.get("counterSet") not in declared:
                issues.append(
                    f"spec.devices[{i}].consumesCounters[{j}]: counterSet "
                    f"{cc.get('counterSet')!r} not declared in "
                    "spec.sharedCounters"
                )
    if issues:
        raise SchemaError("ResourceSlice", issues)


_FLAT_REQUEST_FIELDS = (
    "deviceClassName", "selectors", "allocationMode", "count", "adminAccess",
)


def _validate_claim_spec(spec, path, issues, version=None):
    devices = _map_items(spec.get("devices"), f"{path}.devices", issues)
    requests = _dict_items(
        devices.get("requests"), f"{path}.devices.requests", issues
    )
    if len(requests) > MAX_REQUESTS:
        issues.append(f"{path}.devices.requests: exceeds {MAX_REQUESTS}")
    req_names = set()
    for i, req in requests:
        p = f"{path}.devices.requests[{i}]"
        _dns_label(req.get("name", ""), f"{p}.name", issues)
        if req.get("name") in req_names:
            issues.append(f"{p}.name: duplicate {req.get('name')!r}")
        req_names.add(req.get("name"))
        if version in _FLAT_VERSIONS:
            # v1beta2/v1 nest the payload: exactly one of exactly /
            # firstAvailable; flat fields on the request itself are the
            # older dialects' shape.
            flat = [f for f in _FLAT_REQUEST_FIELDS if f in req]
            if flat:
                issues.append(
                    f"{p}: fields {flat} must nest under 'exactly' in "
                    f"{version}"
                )
            nested = [f for f in ("exactly", "firstAvailable") if f in req]
            if len(nested) != 1:
                issues.append(
                    f"{p}: exactly one of exactly/firstAvailable required"
                )
                continue
            if nested == ["firstAvailable"]:
                for j, sub in _dict_items(
                    req["firstAvailable"], f"{p}.firstAvailable", issues
                ):
                    _dns_label(sub.get("name", ""),
                               f"{p}.firstAvailable[{j}].name", issues)
                    _dns_subdomain(
                        sub.get("deviceClassName", ""),
                        f"{p}.firstAvailable[{j}].deviceClassName", issues,
                    )
                    # Allocations from a prioritized list record
                    # '<request>/<subrequest>' — those are the legal
                    # names for status results / config references.
                    req_names.add(f"{req.get('name')}/{sub.get('name')}")
                continue
            req = req["exactly"]
            if not isinstance(req, dict):
                issues.append(f"{p}.exactly: must be an object")
                continue
            p = f"{p}.exactly"
        _dns_subdomain(
            req.get("deviceClassName", ""), f"{p}.deviceClassName", issues
        )
        mode = req.get("allocationMode", "")
        if mode not in ("", "ExactCount", "All"):
            issues.append(f"{p}.allocationMode: invalid {mode!r}")
        count = req.get("count")
        if count is not None:
            if not _is_int(count) or count < 1:
                issues.append(f"{p}.count: must be a positive integer")
            if mode == "All":
                issues.append(f"{p}.count: must be unset with "
                              "allocationMode=All")
        if "adminAccess" in req and not isinstance(
            req["adminAccess"], bool
        ):
            issues.append(f"{p}.adminAccess: must be a boolean")
        _cel_selectors(req.get("selectors"), f"{p}.selectors", issues)
    constraints = _dict_items(
        devices.get("constraints"), f"{path}.devices.constraints", issues
    )
    if len(constraints) > MAX_CONSTRAINTS:
        issues.append(f"{path}.devices.constraints: exceeds {MAX_CONSTRAINTS}")
    for i, con in constraints:
        p = f"{path}.devices.constraints[{i}]"
        ma = con.get("matchAttribute")
        if not ma:
            issues.append(f"{p}.matchAttribute: required")
            continue
        _qualified_name(ma, f"{p}.matchAttribute", issues)
        if "/" not in str(ma):
            issues.append(
                f"{p}.matchAttribute: {ma!r} must be fully qualified "
                "(domain/name)"
            )
        for rname in con.get("requests") or []:
            if rname not in req_names:
                issues.append(
                    f"{p}.requests: {rname!r} names no request"
                )
    configs = _dict_items(
        devices.get("config"), f"{path}.devices.config", issues
    )
    if len(configs) > MAX_CONFIGS:
        issues.append(f"{path}.devices.config: exceeds {MAX_CONFIGS}")
    for i, cfg in configs:
        p = f"{path}.devices.config[{i}]"
        opaque = cfg.get("opaque")
        if opaque is not None:
            _dns_subdomain(
                opaque.get("driver", ""), f"{p}.opaque.driver", issues
            )
            if "parameters" not in opaque:
                issues.append(f"{p}.opaque.parameters: required")
        for rname in cfg.get("requests") or []:
            if rname not in req_names:
                issues.append(f"{p}.requests: {rname!r} names no request")
    return req_names


def validate_resource_claim(obj: dict) -> None:
    issues: list[str] = []
    version = _check_type_meta(obj, "ResourceClaim", issues)
    spec = obj.get("spec")
    if not isinstance(spec, dict):
        raise SchemaError("ResourceClaim", issues + ["spec: required"])
    req_names = _validate_claim_spec(spec, "spec", issues, version)

    status = _map_items(obj.get("status"), "status", issues)
    alloc = _map_items(status.get("allocation"), "status.allocation", issues)
    results = _dict_items(
        _map_items(
            alloc.get("devices"), "status.allocation.devices", issues
        ).get("results"),
        "status.allocation.devices.results", issues,
    )
    if len(results) > MAX_ALLOCATION_RESULTS:
        issues.append(
            f"status.allocation.devices.results: exceeds "
            f"{MAX_ALLOCATION_RESULTS}"
        )
    for i, res in results:
        p = f"status.allocation.devices.results[{i}]"
        if res.get("request") not in req_names:
            issues.append(
                f"{p}.request: {res.get('request')!r} names no spec request"
            )
        _dns_subdomain(res.get("driver", ""), f"{p}.driver", issues)
        if not res.get("pool"):
            issues.append(f"{p}.pool: required")
        _dns_label(res.get("device", ""), f"{p}.device", issues)
    reserved = status.get("reservedFor") or []
    if len(reserved) > MAX_RESERVED_FOR:
        issues.append(f"status.reservedFor: exceeds {MAX_RESERVED_FOR}")
    if issues:
        raise SchemaError("ResourceClaim", issues)


def validate_resource_claim_template(obj: dict) -> None:
    issues: list[str] = []
    version = _check_type_meta(obj, "ResourceClaimTemplate", issues)
    inner = (obj.get("spec") or {}).get("spec")
    if not isinstance(inner, dict):
        raise SchemaError(
            "ResourceClaimTemplate", issues + ["spec.spec: required"]
        )
    _validate_claim_spec(inner, "spec.spec", issues, version)
    if issues:
        raise SchemaError("ResourceClaimTemplate", issues)


def validate_device_class(obj: dict) -> None:
    issues: list[str] = []
    _check_type_meta(obj, "DeviceClass", issues)
    spec = obj.get("spec")
    if not isinstance(spec, dict):
        raise SchemaError("DeviceClass", issues + ["spec: required"])
    _cel_selectors(spec.get("selectors"), "spec.selectors", issues)
    for i, cfg in _dict_items(spec.get("config"), "spec.config", issues):
        opaque = cfg.get("opaque")
        if opaque is not None:
            # DeviceConfiguration is shared between claim and class
            # config upstream: driver AND parameters are required.
            _dns_subdomain(
                opaque.get("driver", ""), f"spec.config[{i}].opaque.driver",
                issues,
            )
            if "parameters" not in opaque:
                issues.append(f"spec.config[{i}].opaque.parameters: required")
    if issues:
        raise SchemaError("DeviceClass", issues)


VALIDATORS = {
    "ResourceSlice": validate_resource_slice,
    "ResourceClaim": validate_resource_claim,
    "ResourceClaimTemplate": validate_resource_claim_template,
    "DeviceClass": validate_device_class,
}

# REST collection name -> kind: a real apiserver decodes the payload as
# the kind the request PATH addresses, so dispatch must not trust the
# object's self-declared kind (an object omitting ``kind`` would
# otherwise bypass validation entirely).
RESOURCE_KINDS = {
    "resourceslices": "ResourceSlice",
    "resourceclaims": "ResourceClaim",
    "resourceclaimtemplates": "ResourceClaimTemplate",
    "deviceclasses": "DeviceClass",
}


def _checked(kind: str, obj: dict) -> None:
    """Run a validator with a structural safety net: whatever shape the
    caller hands in, the outcome is SchemaError (the 422 analog), never
    a bare TypeError/AttributeError from inside the validator."""
    try:
        VALIDATORS[kind](obj if isinstance(obj, dict) else {})
    except SchemaError:
        raise
    except Exception as e:
        raise SchemaError(
            kind, [f"malformed object structure ({type(e).__name__}: {e})"]
        )


def validate(obj: dict) -> None:
    """Dispatch on the object's kind; unknown kinds pass (the fake stores
    plenty of core-group objects this module does not model)."""
    kind = (obj or {}).get("kind", "")
    if kind in VALIDATORS:
        _checked(kind, obj)


def validate_for_resource(resource: str, obj: dict) -> None:
    """Dispatch on the REST collection (apiserver semantics): the path,
    not the payload, decides which schema applies."""
    kind = RESOURCE_KINDS.get(resource)
    if kind is not None:
        _checked(kind, obj)
